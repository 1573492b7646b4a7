"""Example: a few train steps of the PyTorch port on synthetic batches.

The batches are the synthetic TTS data of ``data/synthetic.py`` (structured:
the audio codes are a function of the text, so the loss falls); the model is
the tiny config, a small config for the GPU or the flagship Lina-GLA, with
random weights from a seed. Runs on the GPU unless --cpu is given; on the
GPU every GLA layer trains through the hand-written CUDA forward and
backward kernels where they take its heads (head key dims 64, 128 and 256):
the tiny config (d_model 64, 2 heads, head key dim 32) trains on the GPU
through the plain versions, and ``small`` (d_model 256, 4 heads, head key
dim 64) through the kernels.

  python examples/train_torch.py --cpu --steps 4
  python examples/train_torch.py --config small --steps 4
  python examples/train_torch.py --config flagship --steps 4 --batch 8
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--config", choices=("tiny", "small", "flagship"), default="tiny")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--min-len", type=int, default=32)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import torch

    from lina_speech_tpu_torch.config import build_model, lina_gla_169m, lina_gla_tiny
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    if args.config == "flagship":
        cfg = lina_gla_169m(compute_dtype="float32" if args.cpu else "bfloat16")
    else:
        cfg = lina_gla_tiny()
        if args.config == "small":
            cfg = dataclasses.replace(cfg, d_model=256, backbone=dataclasses.replace(
                cfg.backbone, d_model=256, heads=4),
                text_encoder=dataclasses.replace(cfg.text_encoder, dim=256))
    model = build_model(cfg, device="cpu" if args.cpu else None, seed=args.seed)
    device = next(model.parameters()).device
    state = create_train_state(model, TrainConfig(
        learning_rate=args.lr, n_warmup_steps=args.warmup, n_training_steps=max(args.steps, 10),
        grad_accum_steps=args.grad_accum))
    step = make_train_step(model, grad_accum_steps=args.grad_accum)
    batches = synthetic_tts_batches(
        batch_size=args.batch, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
        min_audio_len=args.min_len, max_audio_len=args.max_len, seed=args.seed,
        structured=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    print(f"{sum(p.numel() for p in model.parameters()):,} parameters on {device}")
    for i in range(args.steps):
        batch = batch_to_device(next(batches), device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator)
        loss = float(metrics["loss"])  # a host read: the step has finished
        dt = time.perf_counter() - t0
        print(f"step {i}: loss {loss:.4f} grad_norm {float(metrics['grad_norm']):.4f} "
              f"acc_0 {float(metrics['acc_0']):.3f} lr {state.schedule(i):.2e} {dt:.2f}s")


if __name__ == "__main__":
    main()
