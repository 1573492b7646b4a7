"""The prefill and training forwards of one checkout on the GPU --
``gla_chunk_conv``, ``gla_chunk`` and ``rwkv6_chunk`` through their public
wrappers -- to set two checkouts' kernels side by side: the bits of their
outputs and their device time.

Each run imports ``lina_speech_tpu_torch`` from the checkout ``--tree``
(builds its kernels there) and prints one JSON line. Compare two checkouts
on one card by alternating their runs in one call, each in a fresh process:

  python scripts/torch_fwd_ab.py --tree parent_checkout --label parent
  python scripts/torch_fwd_ab.py --tree . --label change
  python scripts/torch_fwd_ab.py --tree . --label change
  python scripts/torch_fwd_ab.py --tree parent_checkout --label parent

What it prints, for each case on inputs made from a seed with this
checkout's ``chip_smoke.py`` (``kernel_inputs``, ``qkv_inputs``,
``rwkv6_inputs``), so that both checkouts see the same numbers: ``sha256``,
a digest of the bytes of o and of the final state (two checkouts whose
kernels compute the same arithmetic give equal digests), and ``us``, the
device µs of one call from CUDA-graph replay (mean of two replays of 10
calls, ``chip_smoke.py:device_ms``) beside ``bound_us`` (the bytes it must
move over 3.35 TB/s, or its operations over the bf16 peak). Cases: the
flagship's conv forward (h4 dk256 dv512, bf16 IO) at b8 t512 (no initial
state), b8 t151 and b1 t128 (bf16 and f32 initial states); ``gla_chunk`` at
the same head at b8 t151 and b1 t128 and at simple-GLA's (h4 dk256 dv256)
at b8 t512; ``rwkv6_chunk`` at RWKV6's (h4 dk256 dv256; f32 decays and
bonus) at b8 t512 (no initial state), b8 t151 and b1 t128 (f32). Each
checkout takes its own plan's route; ``routes`` names it.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py (not the compared tree's), for its
    inputs and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cases(torch, smoke, gla_cuda, rwkv6_cuda):
    """(name, call, its inputs, its operations, the route of the checkout's
    plan) of every case."""
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for b, t, st in ((8, 512, None), (8, 151, bf), (8, 151, f32), (1, 128, bf), (1, 128, f32)):
        x = smoke.kernel_inputs(torch, b, t, st, seed=500 + t + b)
        args = smoke.fwd_args(x, True)
        out.append((f"gla_chunk_conv b{b} t{t} {smoke.dtype_name(st)}",
                    lambda args=args, s0=x["s0"]: gla_cuda.gla_chunk_conv(*args, initial_state=s0),
                    (*args, x["s0"]), smoke.scan_flops(b, t, True),
                    gla_cuda.gla_chunk_fwd_plan(bf, b, smoke.H, t, smoke.DV)))
    for b, t, (h, dk, dv), st in ((8, 151, (smoke.H, smoke.DK, smoke.DV), bf),
                                  (1, 128, (smoke.H, smoke.DK, smoke.DV), bf),
                                  (8, 512, smoke.SIMPLE_HEAD, None)):
        x = smoke.qkv_inputs(torch, b, h, t, dk, dv, bf, st, seed=510 + t + b)
        args = smoke.fwd_args(x, False)
        out.append((f"gla_chunk b{b} {smoke.head_name(h, dk, dv)} t{t} {smoke.dtype_name(st)}",
                    lambda args=args, s0=x["s0"]: gla_cuda.gla_chunk(*args, initial_state=s0),
                    (*args, x["s0"]), smoke.plain_qkv_flops(b, h, t, dk, dv),
                    gla_cuda.gla_chunk_fwd_plan(bf, b, h, t, dv)))
    h, dk, dv = smoke.RWKV6_HEAD
    plan = getattr(rwkv6_cuda, "rwkv6_chunk_fwd_plan", None)  # a checkout of one route has none
    for b, t, st in ((8, 512, None), (8, 151, f32), (1, 128, f32)):
        x = smoke.rwkv6_inputs(torch, b, h, t, dk, dv, bf, st, seed=520 + t + b)
        args = tuple(x[n] for n in smoke.RWKV6_LEAVES[:5])
        out.append((f"rwkv6_chunk b{b} t{t} {smoke.dtype_name(st)}",
                    lambda args=args, s0=x["s0"]: rwkv6_cuda.rwkv6_chunk(*args, initial_state=s0),
                    (*args, x["s0"]), smoke.rwkv6_flops(b, h, t, dk, dv),
                    plan(bf, b, h, t, dv) if plan else "recurrent"))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="checkout whose package is timed")
    parser.add_argument("--label", required=True)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_ab: needs a CUDA device")
    from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda

    smoke = smoke_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "tree": args.tree, "card": card, "sha256": {}, "us": {},
           "bound_us": {}, "routes": {}}
    with torch.no_grad():
        for name, call, inputs, flops, route in cases(torch, smoke, gla_cuda, rwkv6_cuda):
            out = call()
            torch.cuda.synchronize()
            res["sha256"][name] = digest(torch, *out)
            res["us"][name] = (smoke.device_ms(call, 10) + smoke.device_ms(call, 10)) / 2 * 1e3
            res["bound_us"][name] = smoke.roofline(smoke.nbytes(*inputs, *out), flops,
                                                   torch.bfloat16)[0] * 1e3
            res["routes"][name] = route
    print(json.dumps(res))


if __name__ == "__main__":
    main()
