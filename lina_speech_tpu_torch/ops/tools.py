"""RVQ delay pattern, masking and padding helpers (reference
model/tools.py:8-77).

Counterpart of ``lina_speech_tpu/ops/tools.py``: ``delay_rvq`` /
``undelay_rvq`` and ``sequence_mask`` on torch tensors; the host-side
helpers that build masks from Python length lists (``packmask_2d``,
``packed_reset_mask``, ``pad_2d_sequence``) return numpy arrays, as they
run in the input pipeline.
"""
from __future__ import annotations

from itertools import accumulate
from typing import List, Optional, Sequence

import numpy as np
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


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(b,) lengths -> (b, max_len) bool mask; True where position < length."""
    lengths = torch.as_tensor(lengths)
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids < lengths[:, None]


def packmask_2d(xlen: Sequence[int], ylen: Sequence[int], offset: int = 0) -> np.ndarray:
    """Block-diagonal cross-attention mask for sequence-packed batches.

    Row block ``i`` (of height ``xlen[i]``) may attend to column span ``i``
    (of width ``ylen[i]``), optionally widened by ``offset`` on both sides
    (tools.py:17-35). Takes Python ints, returns a numpy bool array of shape
    (sum(xlen), sum(ylen)).
    """
    ybound = [0] + list(accumulate(ylen))
    lb, hb = [], []
    for n, lo, hi in zip(xlen, ybound[:-1], ybound[1:]):
        lb += [lo] * n
        hb += [hi] * n
    lb = np.asarray(lb) - offset
    hb = np.asarray(hb) + offset
    rge = np.arange(ybound[-1])
    return (rge[None, :] >= lb[:, None]) & (rge[None, :] < hb[:, None])


def packed_reset_mask(ylen: Sequence[int], total: Optional[int] = None) -> np.ndarray:
    """True at the first position of every packed segment: the GLA
    ``reset_mask`` (gla.py:182-184 in the reference), which forces the decay
    gate to ~0 there so that no state leaks across segment boundaries."""
    total = total if total is not None else int(sum(ylen))
    mask = np.zeros((total,), dtype=bool)
    pos = 0
    for n in ylen:
        if pos < total:
            mask[pos] = True
        pos += n
    return mask


def pad_2d_sequence(seqs: List[np.ndarray], padding_value: int = 0) -> np.ndarray:
    """Pad a list of 2D arrays to a common shape and stack (tools.py:8-15)."""
    max_x = max(s.shape[0] for s in seqs)
    max_y = max(s.shape[1] for s in seqs)
    out = np.full((len(seqs), max_x, max_y), padding_value, dtype=np.asarray(seqs[0]).dtype)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0], : s.shape[1]] = s
    return out
