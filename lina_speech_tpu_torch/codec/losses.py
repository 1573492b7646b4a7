"""Codec training losses: mel reconstruction, hinge / least-squares GAN,
feature matching (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/losses.py`` (reference
decoder/loss.py). The mel filterbank is the port's own numpy copy (the same
triangles, built once per shape); the STFT is a reflect-padded periodic-Hann
framing through ``torch.fft.rfft``. Audio is (B, T) f32, as in JAX.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------- mel
def _hz_to_mel(f, htk: bool = True):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # log(0) where f is 0: the other branch's
        return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m, htk: bool = True):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = True) -> np.ndarray:
    """Triangular mel filterbank (n_freqs, n_mels) f32, torchaudio-compatible
    (HTK scale, no area normalization: torchaudio's norm=None default)."""
    fmax = fmax or sr / 2
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    fb = np.zeros((n_freqs, n_mels))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def _hann(n_fft: int, device) -> torch.Tensor:
    """np.hanning(n_fft + 1)[:-1] (a periodic Hann window), f32."""
    return torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(device)


def stft_frames(audio: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """(B, T) -> (B, frames, n_freqs) complex STFT, Hann window, reflect
    padding of n_fft // 2 on each side when ``center``."""
    if center:
        audio = torch.nn.functional.pad(audio[:, None], (n_fft // 2, n_fft // 2),
                                        mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop) * _hann(n_fft, audio.device)
    return torch.fft.rfft(frames, dim=-1)


def stft_mag(audio: torch.Tensor, n_fft: int, hop: int, center: bool = True,
             power: float = 1.0) -> torch.Tensor:
    """(B, T) -> (B, n_freqs, frames) magnitude ** power."""
    mag = stft_frames(audio, n_fft, hop, center).abs()
    if power != 1.0:
        mag = mag ** power
    return mag.transpose(1, 2)


def safe_log(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=eps))


def log_mel(audio: torch.Tensor, sample_rate: int, n_fft: int, hop: int,
            n_mels: int) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) safe-log mel magnitude."""
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(audio.device)
    return safe_log(torch.einsum("bft,fm->bmt", stft_mag(audio, n_fft, hop), fb))


def mel_loss(y_hat: torch.Tensor, y: torch.Tensor, sample_rate: int = 24000,
             n_fft: int = 1024, hop: int = 256, n_mels: int = 100) -> torch.Tensor:
    """log-mel L1 (reference MelSpecReconstructionLoss, loss.py:12-39)."""
    return (log_mel(y_hat, sample_rate, n_fft, hop, n_mels)
            - log_mel(y, sample_rate, n_fft, hop, n_mels)).abs().mean()


# --------------------------------------------------------------- GAN
def disc_hinge_loss(real_outs: Sequence[torch.Tensor],
                    fake_outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hinge discriminator loss (loss.py:42-67), averaged over the
    sub-discriminators."""
    loss = 0.0
    for r, f in zip(real_outs, fake_outs):
        loss = loss + torch.relu(1.0 - r).mean() + torch.relu(1.0 + f).mean()
    return loss / max(len(real_outs), 1)


def gen_hinge_loss(fake_outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hinge generator loss (loss.py:70-94)."""
    loss = 0.0
    for f in fake_outs:
        loss = loss + torch.relu(1.0 - f).mean()
    return loss / max(len(fake_outs), 1)


def feature_matching_loss(fmaps_real, fmaps_fake) -> torch.Tensor:
    """Mean L1 over all discriminator feature maps (loss.py:97-116)."""
    total, count = 0.0, 0
    for fr, ff in zip(fmaps_real, fmaps_fake):
        for a, b in zip(fr, ff):
            total = total + (a - b).abs().mean()
            count += 1
    return total / max(count, 1)


def lsgan_disc_loss(real_outs, fake_outs) -> torch.Tensor:
    """Least-squares GAN discriminator loss (DACGANLoss, loss.py:118-158)."""
    loss = 0.0
    for r, f in zip(real_outs, fake_outs):
        loss = loss + ((1.0 - r) ** 2).mean() + (f ** 2).mean()
    return loss


def lsgan_gen_loss(fake_outs) -> torch.Tensor:
    loss = 0.0
    for f in fake_outs:
        loss = loss + ((1.0 - f) ** 2).mean()
    return loss
