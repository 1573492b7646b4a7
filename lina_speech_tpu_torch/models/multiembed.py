"""Stacked per-quantizer embedding (reference model/multiembed.py).

Counterpart of ``lina_speech_tpu/models/multiembed.py``: one
(n_level, n_emb, d) weight; ``padding_idx`` rows start at zero and get no
special treatment at lookup.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, n, d) x (q, l, d) -> (b, n, q, l) in the promoted dtype of the two,
    as ``jnp.einsum`` promotes: with f32 parameters and bf16 compute the
    hidden stream leaves the last LayerNorm in f32, and the head then runs in
    f32 on the bf16-rounded weight."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum("bnd,qld->bnql", x.to(dtype), w.to(dtype))


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
        return head_logits(x, self.weight.to(self.dtype))
