"""RVQ delay pattern helpers (reference model/tools.py:46-67).

Counterpart of ``delay_rvq`` / ``undelay_rvq`` in
``lina_speech_tpu/ops/tools.py``, on torch tensors or numpy arrays.
"""
from __future__ import annotations

import torch


def delay_rvq(code: torch.Tensor, head_token: int = -2,
              tail_token: int = -3) -> torch.Tensor:
    """(q, n) codes -> (q, n + q + 1) delayed codes (int64)."""
    code = torch.as_tensor(code)
    q, _ = code.shape
    head = torch.tril(torch.ones(q, q + 1)) * head_token
    tail = torch.tril(torch.ones(q + 1, q), -1).T * tail_token
    extension = torch.flip(head + tail, dims=[1])
    extended = torch.cat([code, extension.to(code.dtype)], dim=1)
    rows = [torch.roll(extended[i], i + 1) for i in range(q)]
    return torch.stack(rows).long()


def undelay_rvq(extended_code: torch.Tensor) -> torch.Tensor:
    """Invert :func:`delay_rvq` on a (q, b, n) tensor -> (q, b, n - q - 1)."""
    extended_code = torch.as_tensor(extended_code)
    q = extended_code.shape[0]
    rows = [torch.roll(extended_code[i], -(i + 1), dims=1) for i in range(q)]
    return torch.stack(rows, dim=0)[:, :, :-(q + 1)]
