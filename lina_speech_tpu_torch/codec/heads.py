"""Vocoder heads (PyTorch port of ``lina_speech_tpu/codec/heads.py``).

Reference decoder/heads.py:24-157. :class:`ISTFTHead`: a Linear d -> n_fft+2,
split into log-magnitude and phase, ``min(exp(mag), 1e2)``, the (real,
imag) pair ``mag * (cos p, sin p)`` and the "same"-padding ISTFT, all in f32
whatever the compute dtype. The two IMDCT heads predict MDCT coefficients
instead. Input (B, T, dim), output the (B, samples) waveform.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from lina_speech_tpu_torch.codec.mdct import imdct
from lina_speech_tpu_torch.codec.spectral import istft_same
from lina_speech_tpu_torch.models.base_blocks import Linear


class ISTFTHead(nn.Module):
    def __init__(self, dim: int, n_fft: int, hop_length: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.out = Linear(dim, n_fft + 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, dim) -> waveform (B, T*hop)."""
        h = self.out(x).float().transpose(1, 2)  # (B, n_fft+2, T)
        mag, p = h.chunk(2, dim=1)
        mag = torch.exp(mag).clamp(max=1e2)
        return istft_same((mag * torch.cos(p), mag * torch.sin(p)), self.n_fft, self.hop_length)


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


class IMDCTSymExpHead(nn.Module):
    """MDCT coefficients through a symmetric exponential (reference
    decoder/heads.py:70-120)."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 clip_audio: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding, self.clip_audio = padding, clip_audio
        self.out = Linear(dim, mdct_frame_len // 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = symexp(self.out(x).float()).clamp(-1e2, 1e2)
        audio = imdct(h, padding=self.padding)
        return audio.clamp(-1.0, 1.0) if self.clip_audio else audio


class IMDCTCosHead(nn.Module):
    """MDCT coefficients = exp(m) * cos(p) (reference decoder/heads.py:123-157)."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 clip_audio: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding, self.clip_audio = padding, clip_audio
        self.out = Linear(dim, mdct_frame_len, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, p = self.out(x).float().chunk(2, dim=-1)
        audio = imdct(torch.exp(m).clamp(max=1e2) * torch.cos(p), padding=self.padding)
        return audio.clamp(-1.0, 1.0) if self.clip_audio else audio
