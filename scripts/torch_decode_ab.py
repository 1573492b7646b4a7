"""Device time of the classic decode step, ``gla_decode_conv``,
``gla_decode`` and ``rwkv6_decode``, of one checkout on the GPU, to set two
checkouts' kernels side by side.

Each run imports ``lina_speech_tpu_torch`` from the checkout ``--tree``
(builds its kernels there) and prints one JSON line. Compare two checkouts
on one card by alternating their runs in one call, each in a fresh process:

  python scripts/torch_decode_ab.py --tree parent_checkout --label parent
  python scripts/torch_decode_ab.py --tree . --label change
  python scripts/torch_decode_ab.py --tree . --label change
  python scripts/torch_decode_ab.py --tree parent_checkout --label parent

What it measures, on the step's inputs as ``chip_smoke.py:decode_case``
makes them and with its timing (``device_ms``, ``cold_pool``): device µs of
one step through the public wrapper (the route the checkout's own plan
picks) from CUDA-graph replay on a rotation of cold states (twice the 50 MB
L2 cache, as 25 layers' states are), mean of two replays of 50 calls, each
beside its bound (the bytes the step must move over 3.35 TB/s): the
flagship's conv step (h4 dk256 dv512, bf16 IO) at b1, b2, b8 and b64 on bf16
and f32 states, simple-GLA's step (h4 dk256 dv256, bf16 IO) at b8 and b64
and Mamba-2's (h32 dk64 dv64, f32 IO) at b8, on f32 states, RWKV6's step
(h4 dk256 dv256, bf16 IO, f32 w and u) at b1, b8 and b64 on bf16 and f32
states; and
``host_us``: the host µs from a call of the flagship's wrapper to its
return at b8, the card idle before each (median of 200).

With ``--routes`` it times instead every body the checkout has
(``ops/gla_cuda.py:_DECODE_ROUTE_CODE``), each forced, in turns (medians
of six replays of 50 calls, ``chip_smoke.py:time_routes``), at the
flagship's head (b 1 to 128), simple-GLA's and RWKV6's (b 1 to 64) and
Mamba-2's (b1, b2, b8, b64) on bf16 and f32 states: where the plan's rules
come from.
``chip_smoke.py`` times the planned route against the tile body.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py (not the compared tree's), for its
    inputs and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(torch, smoke):
    """(kernel, (b, h, dk, dv, IO dtype, state dtype)) of every timed step."""
    bf, f32 = torch.bfloat16, torch.float32
    out = [("gla_decode_conv", (b, smoke.H, smoke.DK, smoke.DV, bf, st))
           for st in (bf, f32) for b in (1, 2, 8, 64)]
    out += [("gla_decode", (b, *smoke.SIMPLE_HEAD, bf, f32)) for b in (8, 64)]
    out += [("gla_decode", (8, *smoke.MAMBA_HEAD, f32, f32))]
    out += [("rwkv6_decode", (b, *smoke.RWKV6_HEAD, bf, st))
            for st in (bf, f32) for b in (1, 8, 64)]
    return out


def route_shapes(torch, smoke):
    """(kernel, shape) of the ``--routes`` sweep."""
    bf, f32 = torch.bfloat16, torch.float32
    out = [("gla_decode_conv", (b, smoke.H, smoke.DK, smoke.DV, bf, st))
           for st in (bf, f32) for b in (1, 2, 4, 6, 8, 16, 64, 128)]
    out += [("gla_decode", (b, *smoke.SIMPLE_HEAD, bf, st))
            for st in (bf, f32) for b in (1, 2, 4, 8, 16, 64)]
    out += [("gla_decode", (b, *smoke.MAMBA_HEAD, f32, st)) for st in (bf, f32) for b in (1, 2, 8, 64)]
    out += [("rwkv6_decode", (b, *smoke.RWKV6_HEAD, bf, st))
            for st in (bf, f32) for b in (1, 2, 4, 8, 16, 64)]
    return out


def kernel_module(name):
    """The checkout's module of the classic step ``name``."""
    if name == "rwkv6_decode":
        from lina_speech_tpu_torch.ops import rwkv6_cuda

        return rwkv6_cuda
    from lina_speech_tpu_torch.ops import gla_cuda

    return gla_cuda


def time_routes(torch, smoke, name, shape, seed):
    """{route: device µs} of every body of the checkout at ``shape``, each
    forced, in turns on cold states."""
    mod = kernel_module(name)
    launch = mod._decode_conv_launch if name == "gla_decode_conv" else mod._decode_launch
    args, state = smoke.decode_case(torch, name, shape, seed)
    rotation = smoke.cold_pool(state)
    steps = {r: (lambda r=r: launch(*args, rotation(), route=r)) for r in mod._DECODE_ROUTE_CODE}
    return {r: ms * 1e3 for r, ms in smoke.time_routes(steps)[0].items()}


def time_shape(torch, smoke, name, shape, seed):
    """(device µs, bound µs) of one step of ``name`` at ``shape`` through
    its public wrapper on cold states."""
    wrapper = getattr(kernel_module(name), name)
    args, state = smoke.decode_case(torch, name, shape, seed)
    rotation = smoke.cold_pool(state)
    step = lambda: wrapper(*args, rotation())
    out = step()
    moved, _ = smoke.decode_work(name, args, state, out)
    us = (smoke.device_ms(step, 50) + smoke.device_ms(step, 50)) / 2 * 1e3
    return us, moved / smoke.PEAK_BYTES * 1e6


def host_us(torch, smoke, gla_cuda, shape, n=200):
    """Median host µs of one call of the flagship's wrapper at ``shape``,
    the card idle before each call."""
    args, state = smoke.decode_case(torch, "gla_decode_conv", shape, seed=7)
    out = []
    for _ in range(n + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gla_cuda.gla_decode_conv(*args, state)
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out[5:])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="checkout whose package is timed")
    parser.add_argument("--label", required=True)
    parser.add_argument("--routes", action="store_true",
                        help="time every body of the checkout, forced, in turns")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_decode_ab: needs a CUDA device")
    from lina_speech_tpu_torch.ops import gla_cuda

    smoke = smoke_module()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "tree": args.tree, "card": card, "us": {}, "bound_us": {}}
    if args.routes:
        for i, (name, shape) in enumerate(route_shapes(torch, smoke)):
            key = f"{name} {smoke.decode_tag(name, shape).split(' ', 1)[1]}"
            res["us"][key] = time_routes(torch, smoke, name, shape, seed=100 + i)
            args_, state = smoke.decode_case(torch, name, shape, seed=0)
            plain = getattr(kernel_module(name), f"{name}_plain")
            res["bound_us"][key] = smoke.decode_work(
                name, args_, state, plain(*args_, state))[0] / smoke.PEAK_BYTES * 1e6
        print(json.dumps(res))
        return
    for i, (name, shape) in enumerate(shapes(torch, smoke)):
        key = f"{name} {smoke.decode_tag(name, shape).split(' ', 1)[1]}"
        res["us"][key], res["bound_us"][key] = time_shape(torch, smoke, name, shape,
                                                          seed=100 + i)
    res["host_us"] = host_us(torch, smoke, gla_cuda,
                             (8, smoke.H, smoke.DK, smoke.DV, torch.bfloat16, torch.bfloat16))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
