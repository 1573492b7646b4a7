"""Codec (vocoder) GAN training CLI of the port:
``python -m lina_speech_tpu_torch.train.codec_cli fit``.

Counterpart of ``lina_speech_tpu/train/codec_cli.py`` (the reference's
VocosExp workload, decoder/experiment.py:447-456): alternating
discriminator and generator steps (``codec/gan.py``) over audio crops, on
one device, the card unless ``--device cpu`` is given. ``--filelist``
reads WAVs through ``data/audio_loader.py``'s native loader; without it the
crops are synthetic noise from ``--seed`` (a pipeline smoke). Every
``--val-every`` steps the batch's copy synthesis is scored
(``codec/metrics.py``: SI-SNR, LSD, mel L1, and UTMOS / PESQ where their
assets exist). With ``--ckpt-dir`` the generator's weights are saved at the
end (``utils/checkpoint.py``, ``<dir>/step_<steps>``). ``--dp`` above 1
raises ``NotImplementedError`` (multi-GPU is ROADMAP.md Queue 1 item 11);
JAX's ``--platform`` has no counterpart.
"""
from __future__ import annotations

import argparse
import itertools
import os
from typing import Iterator

import numpy as np
import torch


def audio_batches(args) -> Iterator[np.ndarray]:
    """(batch, crop_len) f32 crops: from ``--filelist`` (one path a line) or
    seeded noise (normal x 0.1, the JAX CLI's)."""
    if args.filelist:
        from lina_speech_tpu_torch.data.audio_loader import make_audio_loader

        with open(args.filelist) as fh:
            paths = [line.strip() for line in fh if line.strip()]
        return iter(make_audio_loader(paths, args.crop_len, args.batch_size, seed=args.seed))
    rng = np.random.default_rng(args.seed)

    def gen():
        while True:
            yield rng.normal(size=(args.batch_size, args.crop_len)).astype(np.float32) * 0.1

    return gen()


def codec_config(tiny: bool):
    """WavTokenizerConfig(): the 320_24k codec; ``tiny``: the JAX CLI's
    smoke config."""
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig

    if not tiny:
        return WavTokenizerConfig()
    return WavTokenizerConfig(ratios=(4, 2), n_filters=2, latent_dim=16, bins=64,
                              backbone_dim=32, backbone_intermediate_dim=64, backbone_layers=1,
                              n_fft=32, hop_length=8)


def fit(args):
    """Train as the arguments say; returns the final ``CodecGanState``."""
    from lina_speech_tpu_torch.codec.discriminators import (
        MultiPeriodDiscriminator, MultiResolutionDiscriminator,
    )
    from lina_speech_tpu_torch.codec.gan import (
        CodecGanConfig, create_codec_gan, make_codec_gan_steps,
    )
    from lina_speech_tpu_torch.codec.metrics import external_metric_hooks, quality_metrics
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizer
    from lina_speech_tpu_torch.utils.checkpoint import save_checkpoint
    from lina_speech_tpu_torch.utils.profiling import MetricsLogger, StepTimer

    if args.dp > 1:
        raise NotImplementedError(f"--dp {args.dp}: multi-GPU codec training is not ported yet "
                                  "(ROADMAP.md Queue 1 item 11)")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("codec_cli fit: no CUDA device; pass --device cpu to train on the CPU")
    device = torch.device(args.device or "cuda")
    gan_cfg = CodecGanConfig(pretrain_mel_steps=args.pretrain_mel_steps)
    wavtok = WavTokenizer(codec_config(args.tiny)).to(device)
    mpd, mrd = MultiPeriodDiscriminator().to(device), MultiResolutionDiscriminator().to(device)
    state, gen_sched, disc_sched = create_codec_gan(
        torch.Generator().manual_seed(args.seed), wavtok, mpd, mrd, gan_cfg)
    disc_step, gen_step = make_codec_gan_steps(gen_sched, disc_sched, gan_cfg)
    hooks = external_metric_hooks(utmos_path=args.utmos_ckpt, sample_rate=gan_cfg.sample_rate)
    n_params = sum(p.numel() for m in (wavtok, mpd, mrd) for p in m.parameters())
    print(f"{n_params:,} parameters (generator, MPD, MRD) on {device}; "
          f"metric hooks: {sorted(hooks) or 'none'}")

    data = audio_batches(args)
    logger = MetricsLogger(args.log_file, print_every=args.log_every)
    timer = StepTimer()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for i, batch in enumerate(itertools.islice(data, args.steps)):
        audio = torch.from_numpy(np.asarray(batch, np.float32)).to(device)
        with timer:
            state, dmetrics = disc_step(state, audio)
            state, gmetrics = gen_step(state, audio)
            sync()
        if i % args.log_every == 0:
            logger.log(i, {**dmetrics, **gmetrics, "step_time_s": timer.last})
        if args.val_every and i > 0 and i % args.val_every == 0:
            with torch.no_grad():
                recon = wavtok(audio)[:, :audio.shape[-1]]
                qm = quality_metrics(recon, audio, gan_cfg.sample_rate, hooks)
            logger.log(i, {f"val_{k}": v for k, v in qm.items()})
    logger.close()
    if args.ckpt_dir:
        path = save_checkpoint(os.path.abspath(args.ckpt_dir),
                               {"model": wavtok.state_dict(), "step": state.step}, step=args.steps)
        print(f"checkpoint: {path}")
    print(f"done: {args.steps} steps, mean step {timer.mean * 1e3:.1f} ms")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="lina_speech_tpu_torch.train.codec_cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fit")
    f.add_argument("--filelist", type=str, default=None)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--batch-size", type=int, default=2)
    f.add_argument("--crop-len", type=int, default=24000)
    f.add_argument("--pretrain-mel-steps", type=int, default=0)
    f.add_argument("--tiny", action="store_true")
    f.add_argument("--dp", type=int, default=1, help="above 1: not ported (multi-GPU)")
    f.add_argument("--val-every", type=int, default=0,
                   help="run quality metrics every N steps (0 = off)")
    f.add_argument("--utmos-ckpt", type=str, default=None,
                   help="TorchScript UTMOS MOS-predictor path (optional)")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--ckpt-dir", type=str, default=None)
    f.add_argument("--log-every", type=int, default=10)
    f.add_argument("--log-file", type=str, default=None)
    f.add_argument("--device", type=str, default=None,
                   help="default: the CUDA device (raises without one); 'cpu' to train "
                        "on the CPU")
    args = p.parse_args(argv)
    if args.cmd == "fit":
        return fit(args)


if __name__ == "__main__":
    main()
