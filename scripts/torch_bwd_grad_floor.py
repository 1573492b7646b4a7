"""How far apart two accurate backwards put a variant's parameter
gradients in bf16 compute, on the GPU: the floor under chip_smoke.py's
check of a backward's chunked route against its recurrent body at the
model level (``bwd_route_grad_check``).

Run from the repository root on a machine with a CUDA card:

  python scripts/torch_bwd_grad_floor.py               # simple-GLA
  python scripts/torch_bwd_grad_floor.py --kind rwkv6  # RWKV6

simple-GLA without convs at the flagship's width (chip_smoke.py's
``variant_cfg("simple_gla", use_short_conv=False)``: 4 heads, dk 256, dv
256, bf16 compute), or RWKV6 at the flagship's width (``variant_cfg("rwkv6")``
with chip_smoke.py's perturbed bonus, ddlerp mixes and decays), random
weights from seed 0, takes its parameter gradients on a batch of 2
(synthetic, seed 1) three times, the forward the same each time and every
backward (gla_chunk_bwd, or rwkv6_chunk_bwd) taken by:

- ``chunked``: the backward on its planned route (bf16 operands on the
  tensor cores, f32 sums);
- ``recurrent``: the backward forced onto the recurrent sweeps (f32);
- ``plain``: autograd through the plain version (gla_chunk_plain,
  rwkv6_chunk_plain) in f32, the kernel left out.

Each pair is compared leaf by leaf, the error as a share of the leaf's own
max (the leaves zero in exact arithmetic left out, as chip_smoke.py's
``zero_gradient_mask``), and the worst leaves are printed with the count
over ``TOL_PARAM_GRAD``. First on the model as built, then (simple-GLA
only) after chip_smoke.py's training phase (five optimizer steps at b8).
The card's name and power limit come first.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from lina_speech_tpu_torch.config import build_model  # noqa: E402
from lina_speech_tpu_torch.models.rwkv6 import perturb_rwkv6_params_  # noqa: E402
from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda  # noqa: E402
from lina_speech_tpu_torch.train.harness import batch_to_device  # noqa: E402

BACKWARDS = ("chunked", "recurrent", "plain")


def plain_bwd(q, k, v, gk, s0, do, dsf, scale=None, need_ds0=True):
    """gla_chunk_bwd's outputs from autograd through gla_chunk_plain in f32."""
    with torch.enable_grad():
        xs = [x.detach().float().requires_grad_(True) for x in (q, k, v, gk)]
        s = None if s0 is None else s0.detach().float().requires_grad_(True)
        o, sf = gla_cuda.gla_chunk_plain(*xs, s, scale)
        loss = (o * do.float()).sum() + (sf * dsf.float()).sum()
        g = torch.autograd.grad(loss, xs + ([s] if s is not None else []))
    ds0 = g[4].to(s0.dtype) if s0 is not None and need_ds0 else None
    return g[0].to(q.dtype), g[1].to(k.dtype), g[2].to(v.dtype), g[3], ds0


def rwkv6_plain_bwd(r, k, v, w, u, s0, do, dsf, need_ds0=True):
    """rwkv6_chunk_bwd's outputs from autograd through rwkv6_chunk_plain in
    f32."""
    with torch.enable_grad():
        xs = [x.detach().float().requires_grad_(True) for x in (r, k, v, w, u)]
        s = None if s0 is None else s0.detach().float().requires_grad_(True)
        o, sf = rwkv6_cuda.rwkv6_chunk_plain(*xs, initial_state=s)
        loss = (o * do.float()).sum() + (sf * dsf.float()).sum()
        g = torch.autograd.grad(loss, xs + ([s] if s is not None else []))
    ds0 = g[5].to(s0.dtype) if s0 is not None and need_ds0 else None
    return g[0].to(r.dtype), g[1].to(k.dtype), g[2].to(v.dtype), g[3], g[4], ds0


# per kind: (the ops module, its backward wrapper's name, the plain backward)
KINDS = {"simple_gla": (gla_cuda, "gla_chunk_bwd", plain_bwd),
         "rwkv6": (rwkv6_cuda, "rwkv6_chunk_bwd", rwkv6_plain_bwd)}


def grads(model, batch, backward, kind):
    """{name: gradient} with every backward of ``kind`` taken by
    ``backward``."""
    ops, bwd, plain = KINDS[kind]
    smoke.reset_counts()
    if backward == "recurrent":
        with smoke.forced_bwd_route(ops, f"{bwd}_plan", "recurrent"):
            return smoke.model_grads(torch, model, batch)[1]
    if backward == "plain":
        launch = getattr(ops, bwd)
        setattr(ops, bwd, plain)  # what the autograd Function's backward calls
        try:
            return smoke.model_grads(torch, model, batch)[1]
        finally:
            setattr(ops, bwd, launch)
    return smoke.model_grads(torch, model, batch)[1]


def compare(label, model, cfg, kind):
    model.eval()
    batch = batch_to_device(smoke.check_batch(cfg), "cuda")
    g = {b: grads(model, batch, b, kind) for b in BACKWARDS}
    shares = {}
    for a, b in (("chunked", "recurrent"), ("plain", "recurrent"), ("chunked", "plain")):
        rows = []
        for name, ref in g[b].items():
            got, ref = g[a][name].float(), ref.float()
            mask = smoke.zero_gradient_mask(torch, name, ref)
            if bool(mask.all()):
                continue
            got, ref = got[~mask], ref[~mask]
            ref_max, err = float(ref.abs().max()), float((got - ref).abs().max())
            rows.append((err / max(ref_max, 1e-30), err, ref_max, name))
        rows.sort(reverse=True)
        over = sum(r[0] > smoke.TOL_PARAM_GRAD for r in rows)
        print(f"{label}: {a} vs {b}: {over} of {len(rows)} leaves over "
              f"{smoke.TOL_PARAM_GRAD:g} of their own max")
        for share, err, ref_max, name in rows[:6]:
            print(f"  {name}: relative {share:.3e} (max_abs_err {err:.3e}, max {ref_max:.3e})")
        shares[a, b] = {name: share for share, _, _, name in rows}
    cr, pr = shares["chunked", "recurrent"], shares["plain", "recurrent"]
    over = sorted((n for n in cr if max(cr[n], pr[n]) > smoke.TOL_PARAM_GRAD),
                  key=lambda n: -pr[n])
    print(f"{label}: the {len(over)} leaves over {smoke.TOL_PARAM_GRAD:g} in either pair, "
          "chunked vs recurrent beside plain vs recurrent (the floor):")
    for name in over:
        print(f"  {name}: {cr[name]:.3e} beside {pr[name]:.3e}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kind", choices=tuple(KINDS), default="simple_gla")
    kind = parser.parse_args().kind
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_grad_floor.py: no CUDA device; it runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = smoke.card()
    print(card_line)
    smoke.SFU_RATE = smoke.sfu_rate(torch)
    if kind == "rwkv6":
        cfg = smoke.variant_cfg("rwkv6")
        model = build_model(cfg, device="cuda", seed=0)
        perturb_rwkv6_params_(model, torch.Generator().manual_seed(0))
        compare("RWKV6 as built (seed 0)", model, cfg, kind)
        return
    cfg = smoke.variant_cfg("simple_gla", use_short_conv=False)
    model = build_model(cfg, device="cuda", seed=0)
    compare("simple-GLA as built (seed 0)", model, cfg, kind)
    del model
    torch.cuda.empty_cache()
    model, _, _, _ = smoke.training_phase(
        torch, np, gla_cuda, card_line, cfg, "gla_chunk", "gla_chunk_bwd",
        smoke.VARIANT_TRAIN_STEPS["simple_gla"])
    compare("simple-GLA after the training phase", model, cfg, kind)


if __name__ == "__main__":
    main()
