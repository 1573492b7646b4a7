"""Stacked per-quantizer embedding (reference model/multiembed.py).

Counterpart of ``lina_speech_tpu/models/multiembed.py``: one
(n_level, n_emb, d) weight; ``padding_idx`` rows start at zero and get no
special treatment at lookup.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class MultiEmbedding(nn.Module):
    def __init__(self, n_level: int, n_emb: int, d_emb: int,
                 padding_idx: Optional[int] = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding_idx = padding_idx
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(n_level, n_emb, d_emb))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """idx: (q, ...) ids per quantizer level -> (q, ..., d)."""
        w = self.weight.to(self.dtype)
        return torch.stack([w[i][idx[i]] for i in range(idx.shape[0])])

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied logits: (b, n, d) -> (b, n, q, l) against the embedding."""
        return torch.einsum("bnd,qld->bnql", x, self.weight.to(self.dtype))
