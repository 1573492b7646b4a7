"""Where the time of ``int8_linear``'s tensor-core body goes, on the card.

Builds ``csrc/int8_linear.cu`` a second time with ``-DQ8_TIMELINE`` into a
library of its own (the kernels then note ``%globaltimer`` in thread 0 of
every block at six points), runs the wrapper on that library at a few
shapes, and prints for each point the median and the latest block, in µs
after the first block started:

    0 start   1 first stage landed   2 loop done   3 first cluster barrier
    4 sums written   5 second cluster barrier (the block leaves)

The weight is new for every call, as a decode step finds it. The rows of m
up to 8 take the GEMV body, which notes nothing. ``%globaltimer`` ticks in
steps of a few hundred ns on an H100, so read the medians, not single
values. Run it on the machine with the card::

    python -m lina_speech_tpu_torch.utils.int8_timeline [--shape m,k,n,mode ...]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from lina_speech_tpu_torch.ops import _build, qlinear
from lina_speech_tpu_torch.utils.quantize import QKEY, SKEY, quantize_leaf

STAMPS = ("start", "first stage", "loop done", "barrier 1", "sums written", "barrier 2")
BLOCKS = 4096  # kTimelineBlocks in the source
SHAPES = ("16,1024,2048,wonly", "64,1024,2048,wonly", "128,1024,2048,wonly",
          "64,1024,2048,w8a8")


def build_library() -> ctypes.CDLL:
    src = _build.CSRC / "int8_linear.cu"
    out = _build.build_dir() / "libint8_timeline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DQ8_TIMELINE", "-I", str(_build.CSRC),
           "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_linear_fwd.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.int8_linear_fwd.restype = i
    lib.int8_linear_timeline.argtypes = [p]
    lib.int8_linear_timeline.restype = i
    return lib


def timeline(lib: ctypes.CDLL, m: int, k: int, n: int, mode: str,
             calls: int = 5) -> Dict[str, Tuple[float, float]]:
    """{point: (median µs, latest µs)} of the last of ``calls`` calls, each on a
    weight of its own."""
    weights = []
    for seed in range(calls):
        g = torch.Generator(device="cuda").manual_seed(seed)
        pair = quantize_leaf(torch.randn(n, k, generator=g, device="cuda") * k ** -0.5)
        weights.append((qlinear.pack_int8_weight(pair[QKEY]), pair[SKEY].reshape(-1)))
    x = torch.randn(m, k, device="cuda").to(torch.bfloat16)
    stamps = np.zeros((BLOCKS, len(STAMPS)), dtype=np.uint64)
    saved = _build._lib
    _build._lib = lib
    try:
        for q, s in weights:
            lib.int8_linear_timeline(stamps.ctypes.data)  # clears the earlier call's
            qlinear.int8_linear(x, q, s, mode=mode)
            torch.cuda.synchronize()
    finally:
        _build._lib = saved
    err = lib.int8_linear_timeline(stamps.ctypes.data)
    if err != 0:
        raise RuntimeError(f"reading the stamps failed with CUDA error {err}")
    noted = stamps[stamps[:, 0] > 0].astype(np.float64)
    if not len(noted):
        return {}
    us = (noted - noted[:, 0].min()) / 1e3
    return {name: (float(np.median(us[:, i])), float(us[:, i].max()))
            for i, name in enumerate(STAMPS)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", action="append",
                        help="m,k,n,mode (default: the flagship's 1024 -> 2048 at m 16, 64, "
                             "128 and w8a8 at m 64)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_timeline: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "nvidia-smi failed")
    lib = build_library()
    for spec in args.shape or SHAPES:
        m, k, n, mode = spec.split(",")
        m, k, n = int(m), int(k), int(n)
        plan = qlinear.int8_linear_plan(m, k, n)
        points = timeline(lib, m, k, n, mode)
        cells = "; ".join(f"{name} {med:.2f}/{top:.2f}" for name, (med, top) in points.items())
        print(f"int8_linear {mode} m{m} K{k} N{n} plan {plan}: µs after the first block's "
              f"start, median/latest block: {cells or 'no stamps (the GEMV body)'}")


if __name__ == "__main__":
    main()
