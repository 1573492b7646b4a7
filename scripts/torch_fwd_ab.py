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
bonus) at b8 t512 (no initial state), b8 t151 and b1 t128 (f32);
``mamba_scan`` at the Mamba mixer's width (d 2048 n16, bf16 x, B, C) at b8
t151 and b1 t128, t64, t32 and t16 (f32 initial state), b8 t512 (none, a
reset mask), training's b8 and b4 t511 and the gradient check's f32-IO b2
t319 (none).
Each checkout takes its own plan's route; ``routes`` names it.

With ``--backward`` the cases are the three training backwards at the
shapes the driven paths launch them on, through their public wrappers
(each checkout's plan), the digest over every gradient that comes back:
``gla_chunk_conv_bwd`` at the flagship's head at b8 and b4 t511 (training,
one and two micro-batches, no initial state) and b2 t512 (S0 tuning, bf16
initial state); ``gla_chunk_bwd`` at simple-GLA's head at the same three
shapes (f32 initial state for tuning) and at Mamba-2's (h32 dk64 dv64, f32
IO, scale 1) at b8 t511; ``rwkv6_chunk_bwd`` at RWKV6's head at b8 and b4
t511 and the gradient check's b2 (its digests part between checkouts whose
plans take other routes); ``mamba_scan_bwd`` at b8 t512 (no initial state,
with and without a reset mask; and forced into two chunks of 256 steps),
b2 t319 (f32 initial state) and at the shapes the driven paths launch it on
(bf16 IO at b8 and b4 t511, f32 IO at the gradient check's b2 t319; no
initial state), the one-chunk body where a checkout has no chunk plan.
``--only PREFIX`` keeps the cases whose name starts with it.
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
    from lina_speech_tpu_torch.ops import mamba_cuda

    plan = getattr(mamba_cuda, "mamba_scan_plan", None)  # a checkout of one route has none
    for b, t, st, io in ((8, 151, f32, bf), (1, 128, f32, bf), (8, 512, None, bf),
                         (1, 64, f32, bf), (1, 32, f32, bf), (1, 16, f32, bf),
                         (8, 511, None, bf), (4, 511, None, bf), (2, 319, None, f32)):
        x = smoke.mamba_inputs(torch, b, t, io, st, t == 512, seed=560 + t + b)
        args = tuple(x[n] for n in smoke.MAMBA_LEAVES[:6])
        out.append((f"mamba_scan b{b} t{t} IO {smoke.dtype_name(io)} {smoke.dtype_name(st)}"
                    f"{' reset' if t == 512 else ''}",
                    lambda args=args, x=x: mamba_cuda.mamba_scan(
                        *args, initial_state=x["s0"], reset_mask=x["reset"]),
                    (*args, x["s0"]), smoke.mamba_work(b, t),
                    mamba_cuda.bwd_route(t, plan(b, t, smoke.MAMBA_D)) if plan else "one_chunk"))
    return out


def backward_cases(torch, smoke, gla_cuda, rwkv6_cuda):
    """cases() of the three training backwards (--backward); the route a
    checkout of one route has no plan for is "recurrent"."""
    bf, f32 = torch.bfloat16, torch.float32
    shapes = ((8, 511, None), (4, 511, None), (2, 512, "tuning"))
    out = []
    for b, t, st in shapes:
        st = bf if st else None
        x = smoke.kernel_inputs(torch, b, t, st, seed=530 + t + b)
        g = torch.Generator(device=smoke.DEVICE).manual_seed(531 + t + b)
        do = torch.randn(b, smoke.H, t, smoke.DV, generator=g, device=smoke.DEVICE).to(bf)
        dsf = torch.randn(b, smoke.H, smoke.DK, smoke.DV, generator=g,
                          device=smoke.DEVICE).to(st or f32)
        args = (*smoke.fwd_args(x, True), x["s0"], do, dsf)
        out.append((f"gla_chunk_conv_bwd b{b} t{t} {smoke.dtype_name(st)}",
                    lambda args=args: [g for g in gla_cuda.gla_chunk_conv_bwd(*args)
                                       if g is not None],
                    args, smoke.bwd_flops(b, t), gla_cuda.gla_chunk_conv_bwd_plan(bf)))
    heads = [(smoke.SIMPLE_HEAD, bf, None, shape) for shape in shapes]
    heads.append((smoke.MAMBA_HEAD, f32, 1.0, (8, 511, None)))
    for (h, dk, dv), io, scale, (b, t, st) in heads:
        st = f32 if st else None
        x, do, dsf = smoke.bwd_inputs(torch, b, h, t, dk, dv, io, st, seed=540 + t + b)
        args = (x["q"], x["k"], x["v"], x["gk"], x["s0"], do, dsf, scale)
        out.append((f"gla_chunk_bwd b{b} {smoke.head_name(h, dk, dv)} t{t} IO "
                    f"{smoke.dtype_name(io)} {smoke.dtype_name(st)}",
                    lambda args=args: [g for g in gla_cuda.gla_chunk_bwd(*args) if g is not None],
                    args[:-1], smoke.plain_qkv_flops(b, h, t, dk, dv, backward=True),
                    gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)))
    h, dk, dv = smoke.RWKV6_HEAD
    plan = getattr(rwkv6_cuda, "rwkv6_chunk_bwd_plan", None)  # a checkout of one route has none
    for b, t, st in ((8, 511, None), (4, 511, None), (2, 512, f32)):
        x = smoke.rwkv6_inputs(torch, b, h, t, dk, dv, bf, st, seed=550 + t + b)
        g = torch.Generator(device=smoke.DEVICE).manual_seed(551 + t + b)
        do = torch.randn(b, h, t, dv, generator=g, device=smoke.DEVICE).to(bf)
        dsf = torch.randn(b, h, dk, dv, generator=g, device=smoke.DEVICE).to(st or f32)
        args = (*(x[n] for n in smoke.RWKV6_LEAVES), do, dsf)
        out.append((f"rwkv6_chunk_bwd b{b} t{t} {smoke.dtype_name(st)}",
                    lambda args=args: [g for g in rwkv6_cuda.rwkv6_chunk_bwd(*args)
                                       if g is not None],
                    args, smoke.rwkv6_flops(b, h, t, dk, dv, backward=True),
                    plan(bf, b, h, t, dv) if plan else "recurrent"))
    from lina_speech_tpu_torch.ops import mamba_cuda

    plan = getattr(mamba_cuda, "mamba_scan_bwd_plan", None)  # a checkout of one body has none
    for b, t, st, reset, io in ((8, 512, None, False, bf), (8, 512, None, True, bf),
                                (2, 319, f32, False, bf), (8, 511, None, False, bf),
                                (4, 511, None, False, bf), (2, 319, None, False, f32)):
        x = smoke.mamba_inputs(torch, b, t, io, st, reset, seed=570 + t + b)
        g = torch.Generator(device=smoke.DEVICE).manual_seed(571 + t + b)
        dy = torch.randn(b, t, smoke.MAMBA_D, generator=g, device=smoke.DEVICE).to(io)
        dsf = torch.randn(b, smoke.MAMBA_D, smoke.MAMBA_N, generator=g, device=smoke.DEVICE)
        args = (*(x[n] for n in smoke.MAMBA_LEAVES), x["reset"], dy, dsf)
        route = mamba_cuda.bwd_route(t, plan(b, t, smoke.MAMBA_D)) if plan else "one_chunk"
        out.append((f"mamba_scan_bwd b{b} t{t} {smoke.dtype_name(st)}"
                    f"{' reset' if reset else ''}{' IO float32' if io == f32 else ''}",
                    lambda args=args: [g for g in mamba_cuda.mamba_scan_bwd(*args)
                                       if g is not None],
                    args[:7] + args[8:], smoke.mamba_work(b, t, backward=True), route))
        if (b, t, reset) == (8, 512, False):  # the chunked route in two chunks, where there is one
            call = ((lambda args=args: [g for g in mamba_cuda._bwd_launch(*args, chunk=256)
                                        if g is not None]) if plan else out[-1][1])
            out.append((f"mamba_scan_bwd b{b} t{t} none, two chunks", call, args[:7] + args[8:],
                        smoke.mamba_work(b, t, backward=True), "chunked" if plan else "one_chunk"))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="checkout whose package is timed")
    parser.add_argument("--label", required=True)
    parser.add_argument("--backward", action="store_true",
                        help="the three training backwards instead of the forwards")
    parser.add_argument("--only", default="", help="time only the cases whose name starts "
                        "with this")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_ab: needs a CUDA device")
    from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda

    smoke = smoke_module()
    smoke.SFU_RATE = smoke.sfu_rate(torch)  # the Mamba scan's bound counts its exponentials
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "tree": args.tree, "card": card, "sha256": {}, "us": {},
           "bound_us": {}, "routes": {}}
    which = backward_cases if args.backward else cases
    with torch.no_grad():
        for name, call, inputs, flops, route in which(torch, smoke, gla_cuda, rwkv6_cuda):
            if not name.startswith(args.only):
                continue
            out = call()
            torch.cuda.synchronize()
            res["sha256"][name] = digest(torch, *out)
            res["us"][name] = (smoke.device_ms(call, 10) + smoke.device_ms(call, 10)) / 2 * 1e3
            io = next(a.dtype for a in inputs if isinstance(a, torch.Tensor))
            if isinstance(flops, tuple):  # the Mamba scan: f32 operations and exponentials
                flops, exps, io = *flops, torch.float32
            else:
                exps = 0
            res["bound_us"][name] = smoke.roofline(smoke.nbytes(*inputs, *out), flops, io,
                                                   exps)[0] * 1e3
            res["routes"][name] = route
    print(json.dumps(res))


if __name__ == "__main__":
    main()
