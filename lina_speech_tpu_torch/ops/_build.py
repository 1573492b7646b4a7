"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles every source under ``csrc/`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes``. The file
name carries a hash of the sources and flags, so an edited source rebuilds
and a built library is reused. Nothing here runs at import time:
the package imports on a machine without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run
build_log: str = ""  # nvcc / ptxas output of the build (registers, spills)


def build_dir() -> Path:
    """``build/torch_kernels`` beside the package (the repository root in a
    checkout)."""
    return CSRC.parents[1] / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    hdrs = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for p in srcs + hdrs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return srcs, digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds, build_log
    srcs, digest = _sources()
    out = build_dir() / f"libgla_kernels_{digest}.so"
    if out.exists():
        log = out.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    objs = [out.parent / f"{s.stem}.{tag}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    build_seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gla_chunk_conv_fwd.argtypes = [p] * 20 + [i] * 5 + [f, i, i, i, i, p]
    lib.gla_chunk_conv_fwd.restype = i
    lib.gla_chunk_conv_bwd.argtypes = [p] * 35 + [i] * 5 + [f, i, i, i, p]
    lib.gla_chunk_conv_bwd.restype = i
    lib.gla_decode_conv_step.argtypes = [p] * 15 + [i] * 4 + [f, i, i, i, p]
    lib.gla_decode_conv_step.restype = i
    lib.gla_chunk_fwd.argtypes = [p] * 17 + [i] * 5 + [f, i, i, i, i, p]
    lib.gla_chunk_fwd.restype = i
    lib.gla_chunk_bwd.argtypes = [p] * 29 + [i] * 5 + [f, i, i, i, p]
    lib.gla_chunk_bwd.restype = i
    lib.gla_decode_step.argtypes = [p] * 6 + [i] * 4 + [f, i, i, i, p]
    lib.gla_decode_step.restype = i
    lib.gla_decode_lazy_conv_step.argtypes = [p] * 21 + [i] * 6 + [f, i, i, i, p]
    lib.gla_decode_lazy_conv_step.restype = i
    lib.gla_fold_window.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.gla_fold_window.restype = i
    lib.gla_fold_q_window.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.gla_fold_q_window.restype = i
    lib.int8_linear_fwd.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.int8_linear_fwd.restype = i
    lib.fused_ffn_int8_fwd.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.fused_ffn_int8_fwd.restype = i
    lib.rwkv6_chunk_fwd.argtypes = [p] * 18 + [i] * 9 + [p]
    lib.rwkv6_chunk_fwd.restype = i
    lib.rwkv6_chunk_bwd.argtypes = [p] * 33 + [i] * 8 + [p]
    lib.rwkv6_chunk_bwd.restype = i
    lib.rwkv6_decode_step.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.rwkv6_decode_step.restype = i
    lib.mamba_scan_fwd.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.mamba_scan_fwd.restype = i
    lib.mamba_scan_bwd.argtypes = [p] * 26 + [i] * 6 + [p]
    lib.mamba_scan_bwd.restype = i
    _lib = lib
    return lib
