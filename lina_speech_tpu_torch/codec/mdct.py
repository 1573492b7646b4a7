"""MDCT / IMDCT with TDAC sine windows (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/mdct.py`` (reference
decoder/spectral_ops.py:78-192): the same cosine-basis matmuls, frames cut
with ``unfold`` and overlap-added with ``F.fold``. The Princen-Bradley sine
window gives perfect reconstruction under 50% overlap.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _basis(frame_len: int) -> np.ndarray:
    """(2N, N) cosine basis: C[n, k] = cos(pi/N (n + 0.5 + N/2)(k + 0.5))."""
    n_half = frame_len // 2
    n = np.arange(2 * n_half)[:, None]
    k = np.arange(n_half)[None, :]
    return np.cos(np.pi / n_half * (n + 0.5 + n_half / 2) * (k + 0.5))


def _window(frame_len: int) -> np.ndarray:
    n = np.arange(frame_len)
    return np.sin(np.pi / frame_len * (n + 0.5))


def _f32(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(like.device)


def mdct(audio: torch.Tensor, frame_len: int, padding: str = "same") -> torch.Tensor:
    """(B, T) -> (B, L, N) MDCT coefficients; hop = N = frame_len / 2."""
    n_half = frame_len // 2
    if padding == "same":
        audio = F.pad(audio, (n_half // 2, n_half // 2))
    elif padding == "center":
        audio = F.pad(audio, (n_half, n_half))
    frames = audio.unfold(-1, frame_len, n_half) * _f32(_window(frame_len), audio)
    return frames @ _f32(_basis(frame_len) * np.sqrt(2.0 / n_half), audio)


def imdct(coeffs: torch.Tensor, padding: str = "same") -> torch.Tensor:
    """(B, L, N) -> (B, (L+1) N) waveform by windowed overlap-add, less the
    padding ``mdct`` added ("same": N/2 a side; "center": N)."""
    b, n_frames, n_half = coeffs.shape
    frame_len = 2 * n_half
    # analysis scale x synthesis scale = 2/N, the TDAC reconstruction
    basis = _f32(_basis(frame_len).T * np.sqrt(2.0 / n_half), coeffs)
    frames = (coeffs @ basis) * _f32(_window(frame_len), coeffs)  # (B, L, 2N)
    out_len = (n_frames - 1) * n_half + frame_len
    y = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
               kernel_size=(1, frame_len), stride=(1, n_half)).reshape(b, out_len)
    if padding == "same":
        return y[:, n_half // 2:out_len - n_half // 2]
    if padding == "center":
        return y[:, n_half:out_len - n_half]
    return y
