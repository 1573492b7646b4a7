"""Rotary position embedding (``rotary_embedding_torch`` semantics).

Counterpart of ``lina_speech_tpu/ops/rotary.py``: only the first
``rot_dim`` channels rotate, and channel pairs (0, 1), (2, 3), ... rotate
together (interleaved rotate-half).
"""
from __future__ import annotations

import torch


def rotary_freqs(rot_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """(rot_dim // 2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32)
                            / rot_dim))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, rot_dim: int,
                 theta: float = 10000.0, freqs: torch.Tensor = None
                 ) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of ``x`` (..., n, d).

    ``positions`` broadcasts to (..., n); ``freqs`` overrides the analytic
    inverse frequencies (a loaded checkpoint's ``rotary.freqs``).
    """
    if freqs is None:
        freqs = rotary_freqs(rot_dim, theta)
    angles = positions[..., None].float() * freqs.float().to(x.device)
    angles = angles.repeat_interleave(2, dim=-1)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x_rot = x_rot * angles.cos() + _rotate_half_interleaved(x_rot) * angles.sin()
    return torch.cat([x_rot.to(x.dtype), x_pass], dim=-1)


class RotaryEmbedding:
    """Holder of ``rot_dim`` and ``theta`` in the reference's module-style
    use: rotates ``x`` (..., n, d) at positions ``arange(n) + offset``."""

    def __init__(self, rot_dim: int, theta: float = 10000.0):
        self.rot_dim = rot_dim
        self.theta = theta

    def __call__(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        positions = torch.arange(x.shape[-2], device=x.device) + offset
        return apply_rotary(x, positions, self.rot_dim, self.theta)
