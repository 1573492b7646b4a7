"""Where the time of the lazy-window decode step's cluster route
(``gla_decode_lazy_conv``) goes, on the card.

Builds ``csrc/gla_decode_lazy_conv.cu`` a second time with
``-DLAZY_TIMELINE`` into a library of its own (the cluster route's kernel
then notes ``%globaltimer`` in thread 0 of every block at seven points),
runs the wrapper's launcher forced onto that route on that library at the
flagship's head (h4, dk 256, dv 512, bf16 IO, a window of 16) and prints
for each point the median and the latest block, in µs after the first
block started:

    0 start   1 rows formed (q, k, cc)   2 score parts pushed   3 state slab
    landed   4 readout parts pushed   5 every part received   6 done

Each call reads a state of its own, as a decode step finds it cold.
``%globaltimer`` ticks in steps of a few hundred ns on an H100, so read the
medians, not single values. It is the one view inside a call of this
kernel where no kernel profiler runs: rerun it after a change to the
cluster route's body. Run it on the machine with the card::

    python -m lina_speech_tpu_torch.utils.lazy_timeline [--shape b,p,state ...]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from lina_speech_tpu_torch.ops import _build, gla_cuda

STAMPS = ("start", "rows", "scores pushed", "slab landed", "readout pushed", "received",
          "done")
BLOCKS = 8192  # kTimelineBlocks in the source
H, DK, DV, WINDOW = 4, 256, 512, 16
SHAPES = ("8,0,bfloat16", "8,15,bfloat16", "64,15,bfloat16", "8,15,float32")


def build_library() -> ctypes.CDLL:
    src = _build.CSRC / "gla_decode_lazy_conv.cu"
    out = _build.build_dir() / "liblazy_timeline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DLAZY_TIMELINE", "-I", str(_build.CSRC),
           "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gla_decode_lazy_conv_step.argtypes = [p] * 21 + [i] * 6 + [f, i, i, i, p]
    lib.gla_decode_lazy_conv_step.restype = i
    lib.gla_decode_lazy_conv_timeline.argtypes = [p]
    lib.gla_decode_lazy_conv_timeline.restype = i
    return lib


def timeline(lib: ctypes.CDLL, b: int, p: int, state: str,
             calls: int = 5) -> Dict[str, Tuple[float, float]]:
    """{point: (median µs, latest µs)} of the last of ``calls`` calls, each on a
    state of its own."""
    g = torch.Generator(device="cuda").manual_seed(b + p)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf = torch.bfloat16
    tok = (r(b, H, DK).to(bf), r(b, H, DK).to(bf), r(b, H, DV).to(bf),
           torch.nn.functional.logsigmoid(r(b, H, DK)) / 16)
    taps = [(r(4, H, d) * 0.5).to(bf) for d in (DK, DK, DV)]
    rings = [r(4, b, H, d).to(bf) for d in (DK, DK, DV)]
    bufs = [r(WINDOW, b, H, DK).to(bf), r(WINDOW, b, H, DV).to(bf),
            torch.zeros(WINDOW, b, H, DK, device="cuda"), torch.zeros(b, H, DK, device="cuda")]
    states = [r(b, H, DK, DV).to(getattr(torch, state)) for _ in range(calls)]
    stamps = np.zeros((BLOCKS, len(STAMPS)), dtype=np.uint64)
    saved = _build._lib
    _build._lib = lib
    try:
        for s in states:
            lib.gla_decode_lazy_conv_timeline(stamps.ctypes.data)  # clears the earlier call's
            gla_cuda._lazy_launch(*tok, *taps, *rings, s, *bufs, p, route="cluster")
            torch.cuda.synchronize()
    finally:
        _build._lib = saved
    err = lib.gla_decode_lazy_conv_timeline(stamps.ctypes.data)
    if err != 0:
        raise RuntimeError(f"reading the stamps failed with CUDA error {err}")
    noted = stamps[stamps[:, 0] > 0].astype(np.float64)
    us = (noted - noted[:, 0].min()) / 1e3
    return {name: (float(np.median(us[:, i])), float(us[:, i].max()))
            for i, name in enumerate(STAMPS)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", action="append",
                        help="b,p,state with an f32 or bf16 state (default: b8 p0, b8 and "
                             "b64 p15 bf16, b8 p15 f32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lazy_timeline: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0 else "nvidia-smi failed")
    lib = build_library()
    for spec in args.shape or SHAPES:
        b, p, state = spec.split(",")
        points = timeline(lib, int(b), int(p), state)
        cells = "; ".join(f"{name} {med:.2f}/{top:.2f}" for name, (med, top) in points.items())
        print(f"gla_decode_lazy_conv b{b} p{p} {state} state: µs after the first block's "
              f"start, median/latest block: {cells}")


if __name__ == "__main__":
    main()
