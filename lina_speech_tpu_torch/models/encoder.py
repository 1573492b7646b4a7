"""Text encoder (reference model/encoder.py; JAX models/encoder.py)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.base_blocks import (
    MixingBlock, SelfAttention, SwiGLU,
)


class TextEncoder(nn.Module):
    """Rotary self-attention transformer over text embeddings.

    The (b, n, m) padding mask is OR'd with the identity so fully padded
    rows still attend to themselves (encoder.py:36-38).
    """

    def __init__(self, dim: int, heads: int, n_layers: int = 4,
                 rotary: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sa = nn.ModuleList(
            MixingBlock(dim, SelfAttention(dim, heads, rotary=rotary, dtype=dtype),
                        SwiGLU(dim, dtype=dtype))
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
