"""Text and speaker encoders (reference model/encoder.py; JAX models/encoder.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.base_blocks import (
    Linear, MixingBlock, SelfAttention, SwiGLU,
)


class TextEncoder(nn.Module):
    """Rotary self-attention transformer over text embeddings.

    The (b, n, m) padding mask is OR'd with the identity so fully padded
    rows still attend to themselves (encoder.py:36-38).
    """

    def __init__(self, dim: int, heads: int, n_layers: int = 4,
                 dropout: float = 0.1, rotary: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sa = nn.ModuleList(
            MixingBlock(dim, SelfAttention(dim, heads, rotary=rotary, dtype=dtype),
                        SwiGLU(dim, dtype=dtype), dropout=dropout)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            eye = torch.eye(mask.shape[-1], dtype=torch.bool,
                            device=mask.device)[None, None]
            mask = mask[:, None] | eye
        for block in self.sa:
            x = block(x, mask=mask)
        return x


class SimpleSpeakerEncoder(nn.Module):
    """Windowed self-attention pooling to one speaker vector
    (encoder.py:45-84): ``min(window_length, n)`` frames from
    ``window_start`` (clamped so that the window stays inside, as JAX's
    ``dynamic_slice_in_dim``), ``in_proj`` to ``dim_inner``, ``n_layers``
    blocks of rotary self-attention and SwiGLU, and ``out_proj`` of the
    first frame. ``window_start`` replaces the reference's in-forward random
    crop: a caller that wants one draws it outside the module."""

    def __init__(self, dim: int, dim_inner: int, heads: int, n_layers: int = 6,
                 dropout: float = 0.1, rotary: bool = True, window_length: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_length = window_length
        self.sa = nn.ModuleList(
            MixingBlock(dim_inner, SelfAttention(dim_inner, heads, rotary=rotary, dtype=dtype),
                        SwiGLU(dim_inner, dtype=dtype), dropout=dropout)
            for _ in range(n_layers))
        self.in_proj = Linear(dim, dim_inner, dtype=dtype)
        self.out_proj = Linear(dim_inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, window_start: int = 0) -> torch.Tensor:
        """x: (b, n, dim) -> (b, dim)."""
        n = x.shape[1]
        length = min(self.window_length, n)
        start = max(0, min(int(window_start), n - length))
        x = self.in_proj(x[:, start:start + length])
        for block in self.sa:
            x = block(x)
        return self.out_proj(x[:, 0])
