"""Device time of the lazy-window decode step, ``gla_decode_lazy_conv``, and
of the two window folds, ``gla_fold`` and ``gla_fold_q``, of one checkout on
the GPU, to set two checkouts' kernels side by side.

Each run imports ``lina_speech_tpu_torch`` from the checkout ``--tree``
(builds its kernels there) and prints one JSON line. Compare two checkouts
on one card by alternating their runs in one call, each in a fresh process:

  python scripts/torch_lazy_ab.py --tree parent_checkout --label parent
  python scripts/torch_lazy_ab.py --tree . --label change
  python scripts/torch_lazy_ab.py --tree . --label change
  python scripts/torch_lazy_ab.py --tree parent_checkout --label parent

What it measures, at the flagship's head (h4, dk 256, dv 512, bf16 IO, a
window of 16), on the step's inputs as ``chip_smoke.py:lazy_case`` makes
them and with its timing (``device_ms``, ``cold_rotation``): device µs of
one step from CUDA-graph replay on a rotation of cold states (twice the 50
MB L2 cache, as 25 layers' states are), for f32, bf16 and int8 states at
b1, b8 and b64, window positions p 0, 7 and 15 (``sweep``), each beside its
bound (the bytes the step must move over 3.35 TB/s; its operations take a
hundredth of that), and ``host_us``: the host µs from a call of the wrapper
to its return, the card idle before each (median of 200), at b8 p7 on each
state type. Each checkout runs the route its own plan picks; the two
routes of one checkout are timed against each other by ``chip_smoke.py``.

The folds (``folds``; ``--folds-only`` times them alone): device µs of one
full window's fold through the public wrappers, on the inputs of
``chip_smoke.py:fold_case`` and a rotation of cold states, at the flagship's
head at b1, b8 and b64 on f32, bf16 and int8 states and at simple-GLA's
(h4 dk256 dv256, f32 state) at b8 -- the shapes the driven paths fold on
among them -- each beside its bound (``fold_work``'s bytes over 3.35 TB/s).
"""
import argparse
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

H, DK, DV, WINDOW = 4, 256, 512, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py (not the compared tree's), for its
    inputs and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(torch, smoke, gla_cuda, shape, seed, n=200):
    """Median host µs of one step's call at ``shape``, the card idle before
    each call."""
    p = shape[-1]
    tok, taps, rings, state, s_scale, bufs = smoke.lazy_case(torch, shape, seed)
    out = []
    for _ in range(n + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, state, *bufs, p, s_scale=s_scale)
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out[5:])


def time_shape(torch, smoke, gla_cuda, shape, seed):
    """(device µs, bound µs) of one step at ``shape`` on cold states (mean of
    two graph replays of 50 calls), on the route the checkout's plan picks."""
    p = shape[-1]
    tok, taps, rings, state, s_scale, bufs = smoke.lazy_case(torch, shape, seed)
    rotation = smoke.cold_rotation(*((state,) if s_scale is None else (state, s_scale)))

    def step():
        s, *sc = rotation()
        return gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, s, *bufs, p,
                                             s_scale=sc[0] if sc else None)

    out = step()
    moved, _ = smoke.lazy_step_work(tok, taps, rings, state, s_scale, bufs, out, p)
    us = (smoke.device_ms(step, 50) + smoke.device_ms(step, 50)) / 2 * 1e3
    return us, moved / smoke.PEAK_BYTES * 1e6


# (name, (b, h, dk, dv, state dtype)) of the folds' cases, bf16 IO, a window of 16
FOLD_CASES = [(f"{st} b{b}", (b, H, DK, DV, st)) for st in ("float32", "bfloat16", "int8")
              for b in (1, 8, 64)] + [("simple-GLA float32 b8", (8, H, DK, 256, "float32"))]


def time_fold(torch, smoke, gla_cuda, shape, seed):
    """(device µs, bound µs) of one fold at ``shape`` (fold_case's) on cold
    states (mean of two graph replays of 50 calls), in the bands the
    checkout's plan picks."""
    state, s_scale, bufs = smoke.fold_case(torch, shape, seed)
    if s_scale is None:
        rotation = smoke.cold_rotation(state)
        step = lambda: gla_cuda.gla_fold(rotation()[0], *bufs)
    else:
        rotation = smoke.cold_rotation(state, s_scale)
        step = lambda: gla_cuda.gla_fold_q(*rotation(), *bufs)
    step()
    us = (smoke.device_ms(step, 50) + smoke.device_ms(step, 50)) / 2 * 1e3
    return us, smoke.fold_work(state, s_scale, bufs)[0] / smoke.PEAK_BYTES * 1e6


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="checkout whose package is timed")
    parser.add_argument("--label", required=True)
    parser.add_argument("--folds-only", action="store_true", help="time the two folds alone")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_lazy_ab: needs a CUDA device")
    from lina_speech_tpu_torch.ops import gla_cuda

    smoke = smoke_module()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
    res = {"label": args.label, "tree": args.tree, "card": card, "sweep": {}, "bound": {},
           "folds": {}, "fold_bound": {}}
    for i, (name, (b, h, dk, dv, st)) in enumerate(FOLD_CASES):
        shape = (b, h, dk, dv, torch.bfloat16, dtypes[st], WINDOW)
        res["folds"][name], res["fold_bound"][name] = time_fold(torch, smoke, gla_cuda, shape, 40 + i)
    if args.folds_only:
        print(json.dumps(res))
        return
    for st, b, p in itertools.product(dtypes, (1, 8, 64), (0, 7, 15)):
        shape = (b, H, DK, DV, torch.bfloat16, dtypes[st], WINDOW, p)
        us, bound_us = time_shape(torch, smoke, gla_cuda, shape, seed=b * 100 + p)
        res["sweep"][f"{st} b{b} p{p}"], res["bound"][f"{st} b{b} p{p}"] = us, bound_us
    res["host_us"] = {f"{st} b8 p7": host_us(
        torch, smoke, gla_cuda, (8, H, DK, DV, torch.bfloat16, dtypes[st], WINDOW, 7), 7)
        for st in dtypes}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
