"""Codec (vocoder) GAN training: dual-optimizer discriminator and generator
steps (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/gan.py`` (reference
decoder/experiment.py:86-218): an AdamW for the discriminators and one for
the generator, hinge losses on MPD + MRD, feature matching, mel-L1 x 45,
and a ``pretrain_mel_steps`` gate that trains the generator on mel alone
first. The JAX package's behaviour is kept as it is:

- both optimizers are optax's ``adamw``: weight decay 1e-4 (torch's default
  is 1e-2) on every leaf, eps 1e-8, betas (0.8, 0.9), the learning rate
  from ``train/harness.py:cosine_schedule_with_warmup`` at each optimizer's
  own count of updates;
- the generator is the WavTokenizer's copy synthesis, so its gradient
  reaches the codebook, the backbone and the head but not the SEANet
  encoder (the codes come from an argmax). optax decays a leaf whose
  gradient is zero; torch's AdamW skips a parameter without a gradient, so
  each step gives such parameters a zero gradient first;
- ``commit_coeff`` is declared and not used (the EMA codebook update is not
  part of these steps);
- the discriminator step takes the generated audio without its gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn as nn

from lina_speech_tpu_torch.codec.discriminators import (
    MultiPeriodDiscriminator, MultiResolutionDiscriminator, init_discriminator_params,
)
from lina_speech_tpu_torch.codec.losses import (
    disc_hinge_loss, feature_matching_loss, gen_hinge_loss, mel_loss,
)
from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizer, init_wavtokenizer_params
from lina_speech_tpu_torch.train.harness import cosine_schedule_with_warmup

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
ADAMW_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class CodecGanConfig:
    lr_gen: float = 2e-4
    lr_disc: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.9)
    mel_coeff: float = 45.0
    commit_coeff: float = 1000.0
    fm_coeff: float = 1.0
    pretrain_mel_steps: int = 0
    sample_rate: int = 24000
    # cosine mel-coefficient decay (reference experiment.py:324-335)
    decay_mel_coeff: bool = False
    num_warmup_steps: int = 0
    max_steps: int = 1_000_000


def mel_coeff_at(config: CodecGanConfig, step: int) -> float:
    """The mel loss's coefficient at generator step ``step``: the base, or
    with ``decay_mel_coeff`` 1 during warmup and then base x a cosine decay
    (experiment.py's mel_loss_coeff_decay)."""
    if not config.decay_mel_coeff:
        return config.mel_coeff
    if step < config.num_warmup_steps:
        return 1.0 * config.mel_coeff
    progress = (step - config.num_warmup_steps) / max(1, config.max_steps - config.num_warmup_steps)
    decay = max(0.0, 0.5 * (1.0 + math.cos(math.pi * min(max(progress, 0.0), 1.0))))
    return decay * config.mel_coeff


@dataclasses.dataclass
class CodecGanState:
    """The three networks (their parameters), the two optimizers and the
    counts of generator and discriminator updates taken."""

    gen: WavTokenizer
    disc_mpd: MultiPeriodDiscriminator
    disc_mrd: MultiResolutionDiscriminator
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    step: int = 0
    disc_step: int = 0


def _adamw(params: Iterable[nn.Parameter], lr: float, config: CodecGanConfig):
    return torch.optim.AdamW(list(params), lr=lr, betas=config.betas, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def create_codec_gan(generator: Optional[torch.Generator], wavtok: WavTokenizer,
                     mpd: MultiPeriodDiscriminator, mrd: MultiResolutionDiscriminator,
                     config: CodecGanConfig):
    """The train state over ``wavtok``, ``mpd`` and ``mrd`` as modules (their
    parameters are the state's), with random parameters drawn from
    ``generator`` -- or, with ``generator=None``, the parameters they hold
    (weights carried in). Returns (state, gen_schedule, disc_schedule), each
    schedule ``step -> learning rate``."""
    if generator is not None:
        with torch.no_grad():
            init_wavtokenizer_params(wavtok, generator)
            init_discriminator_params(mpd, generator)
            init_discriminator_params(mrd, generator)
    gen_sched = cosine_schedule_with_warmup(config.lr_gen, config.num_warmup_steps,
                                            config.max_steps)
    disc_sched = cosine_schedule_with_warmup(config.lr_disc, config.num_warmup_steps,
                                             config.max_steps)
    state = CodecGanState(
        gen=wavtok, disc_mpd=mpd, disc_mrd=mrd,
        gen_opt=_adamw(wavtok.parameters(), gen_sched(0), config),
        disc_opt=_adamw(list(mpd.parameters()) + list(mrd.parameters()), disc_sched(0), config))
    return state, gen_sched, disc_sched


@contextlib.contextmanager
def _frozen(*modules: nn.Module):
    """No gradient for the parameters of ``modules`` inside the block."""
    params = [p for m in modules for p in m.parameters()]
    before = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, r in zip(params, before):
            p.requires_grad_(r)


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor, lr: float) -> None:
    """One optax-style AdamW update: every parameter of ``opt`` takes part,
    a zero gradient where the loss does not reach it (optax decays it)."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        group["lr"] = lr
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_codec_gan_steps(gen_schedule: Callable[[int], float],
                         disc_schedule: Callable[[int], float], config: CodecGanConfig):
    """Returns (disc_step, gen_step), each ``state, audio (B, T) -> state,
    metrics`` (metrics 0-dim tensors, read without a device sync)."""

    def disc_step(state: CodecGanState, audio: torch.Tensor):
        mpd, mrd = state.disc_mpd, state.disc_mrd
        with torch.no_grad():
            y_hat = state.gen(audio)
        loss = (disc_hinge_loss(mpd(audio)[0], mpd(y_hat)[0])
                + disc_hinge_loss(mrd(audio)[0], mrd(y_hat)[0]))
        _update(state.disc_opt, loss, disc_schedule(state.disc_step))
        state.disc_step += 1
        return state, {"disc_loss": loss.detach()}

    def gen_step(state: CodecGanState, audio: torch.Tensor):
        mpd, mrd = state.disc_mpd, state.disc_mrd
        with _frozen(mpd, mrd):
            y_hat = state.gen(audio)
            n = min(y_hat.shape[-1], audio.shape[-1])
            y_hat_c, y_c = y_hat[..., :n], audio[..., :n]
            l_mel = mel_loss(y_hat_c, y_c, sample_rate=config.sample_rate)
            f_mpd, fm_f_mpd = mpd(y_hat_c)
            f_mrd, fm_f_mrd = mrd(y_hat_c)
            with torch.no_grad():  # the real audio's maps: constants for the generator
                fm_r_mpd, fm_r_mrd = mpd(y_c)[1], mrd(y_c)[1]
            l_gen = gen_hinge_loss(f_mpd) + gen_hinge_loss(f_mrd)
            l_fm = (feature_matching_loss(fm_r_mpd, fm_f_mpd)
                    + feature_matching_loss(fm_r_mrd, fm_f_mrd))
            pretrain = state.step < config.pretrain_mel_steps
            adv = 0.0 * l_gen if pretrain else l_gen + config.fm_coeff * l_fm
            total = adv + mel_coeff_at(config, state.step) * l_mel
            _update(state.gen_opt, total, gen_schedule(state.step))
        state.step += 1
        return state, {"mel_loss": l_mel.detach(), "gen_adv": l_gen.detach(),
                       "fm_loss": l_fm.detach(), "gen_loss": total.detach()}

    return disc_step, gen_step

