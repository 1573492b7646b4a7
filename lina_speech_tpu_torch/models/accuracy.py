"""Top-k accuracy ignoring special indices (reference model/accuracy.py).

Counterpart of ``lina_speech_tpu/models/accuracy.py``. The harness uses
top_k=10, ignore_index=[0, 1] (train_lina.py:57-61).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def topk_accuracy(logits: torch.Tensor, target: torch.Tensor, top_k: int = 10,
                  ignore_index: Sequence[int] = (0, 1),
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (..., l); target: (...) int. Returns the scalar accuracy.

    "Target in top-k" is rank by comparison: the count of logits ranked
    ahead of the target's is < k. Ties go to the lower index, as in the JAX
    package (which follows ``lax.top_k``); it matters for bf16 logits, where
    value ties are common over a 4099-way vocabulary.
    """
    tgt = target[..., None]
    tgt_logit = logits.gather(-1, tgt)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    ahead = (logits > tgt_logit) | ((logits == tgt_logit) & (idx < tgt))
    hit = ahead.sum(-1) < top_k
    valid = torch.ones_like(target, dtype=torch.bool)
    for ig in ignore_index:
        valid &= target != ig
    if mask is not None:
        valid &= mask
    return (hit & valid).sum() / valid.sum().clamp(min=1)
