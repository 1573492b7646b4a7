"""How far apart two accurate backwards of gla_chunk put simple-GLA's
parameter gradients in bf16 compute, on the GPU: the floor under
chip_smoke.py's check of gla_chunk_bwd's chunked route against its
recurrent body at the model level.

Run from the repository root on a machine with a CUDA card:

  python scripts/torch_bwd_grad_floor.py

simple-GLA without convs at the flagship's width (chip_smoke.py's
``variant_cfg("simple_gla", use_short_conv=False)``: 4 heads, dk 256, dv
256, bf16 compute), random weights from seed 0, takes its parameter
gradients on a batch of 2 (synthetic, seed 1) three times, the forward the
same each time and every gla_chunk backward taken by:

- ``chunked``: gla_chunk_bwd on its planned route (bf16 operands on the
  tensor cores, f32 sums);
- ``recurrent``: gla_chunk_bwd forced onto the recurrent sweeps (f32);
- ``plain``: autograd through gla_chunk_plain in f32, the kernel left out.

Each pair is compared leaf by leaf, the error as a share of the leaf's own
max (the leaves zero in exact arithmetic left out, as chip_smoke.py's
``zero_gradient_mask``), and the worst leaves are printed with the count
over ``TOL_PARAM_GRAD``. First on the model as built, then after
chip_smoke.py's training phase (five optimizer steps at b8). The card's
name and power limit come first.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from lina_speech_tpu_torch.config import build_model  # noqa: E402
from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches  # noqa: E402
from lina_speech_tpu_torch.ops import gla_cuda  # noqa: E402
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


def grads(model, batch, backward):
    """{name: gradient} with every gla_chunk backward taken by ``backward``."""
    smoke.reset_counts()
    if backward == "recurrent":
        with smoke.forced_bwd_route(gla_cuda, "recurrent"):
            return smoke.model_grads(torch, model, batch)[1]
    if backward == "plain":
        launch = gla_cuda.gla_chunk_bwd
        gla_cuda.gla_chunk_bwd = plain_bwd  # what _GLAChunk.backward calls
        try:
            return smoke.model_grads(torch, model, batch)[1]
        finally:
            gla_cuda.gla_chunk_bwd = launch
    return smoke.model_grads(torch, model, batch)[1]


def compare(label, model, cfg):
    model.eval()
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
        min_audio_len=smoke.MIN_AUDIO, max_audio_len=smoke.MAX_AUDIO, seed=1)), "cuda")
    g = {b: grads(model, batch, b) for b in BACKWARDS}
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_grad_floor.py: no CUDA device; it runs on a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = smoke.card()
    print(card_line)
    smoke.SFU_RATE = smoke.sfu_rate(torch)
    cfg = smoke.variant_cfg("simple_gla", use_short_conv=False)
    model = build_model(cfg, device="cuda", seed=0)
    compare("simple-GLA as built (seed 0)", model, cfg)
    del model
    torch.cuda.empty_cache()
    model, _, _, _ = smoke.training_phase(
        torch, np, gla_cuda, card_line, cfg, "gla_chunk", "gla_chunk_bwd",
        smoke.VARIANT_TRAIN_STEPS["simple_gla"])
    compare("simple-GLA after the training phase", model, cfg)


if __name__ == "__main__":
    main()
