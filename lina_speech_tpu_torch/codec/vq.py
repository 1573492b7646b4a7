"""Vector quantization, the inference half (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/vq.py:30-82`` (reference
encoder/quantization/vq.py, core_vq.py): nearest-neighbour encode as one
matmul and an argmax, decode as a sum of codebook gathers, and true residual
VQ. The codebooks live in a :class:`VectorQuantizer` laid out as the
reference's ``vq.layers.{i}._codebook.embed`` (bins, dim), so a reference
state_dict loads as is. The training half (k-means init, dead-code expiry,
the EMA update) is ROADMAP.md Queue 1 item 10.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


class _Codebook(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(bins, dim))


class _Layer(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(bins, dim)


class VectorQuantizer(nn.Module):
    """Stacked codebooks: ``embed[i]`` is layer i's (bins, dim) f32 table."""

    def __init__(self, n_q: int, bins: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(bins, dim) for _ in range(n_q)])

    @property
    def n_q(self) -> int:
        return len(self.layers)

    @property
    def embed(self) -> Tuple[torch.Tensor, ...]:
        return tuple(layer._codebook.embed for layer in self.layers)


def _nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x: (..., d); codebook: (bins, d) -> (...) int64 indices.

    argmin |x - e|^2 == argmax (2 x.e - |e|^2): |x|^2 is the same for every
    code. The first index wins a tie, as in JAX.
    """
    score = 2.0 * x @ codebook.T - (codebook * codebook).sum(-1)
    return score.argmax(-1)


def vq_encode(x: torch.Tensor, quantizer: VectorQuantizer,
              n_q: Optional[int] = None) -> torch.Tensor:
    """x: (B, T, d) latents -> codes (n_q, B, T); every layer quantizes the
    same input (the reference's language VQ, core_vq.py:367-401)."""
    n_q = n_q if n_q is not None else quantizer.n_q
    return torch.stack([_nearest(x, quantizer.embed[i]) for i in range(n_q)])


def vq_decode(codes: torch.Tensor, quantizer: VectorQuantizer) -> torch.Tensor:
    """codes: (n_q, B, T) -> (B, T, d), the sum of the codebook vectors."""
    out = quantizer.embed[0][codes[0]]
    for i in range(1, codes.shape[0]):
        out = out + quantizer.embed[i][codes[i]]
    return out


def residual_vq_encode(x: torch.Tensor, quantizer: VectorQuantizer,
                       n_q: Optional[int] = None) -> torch.Tensor:
    """True residual VQ: each layer quantizes what the earlier ones left
    (core_vq.py's RVQ, stock EnCodec's path)."""
    n_q = n_q if n_q is not None else quantizer.n_q
    codes, residual = [], x
    for i in range(n_q):
        idx = _nearest(residual, quantizer.embed[i])
        residual = residual - quantizer.embed[i][idx]
        codes.append(idx)
    return torch.stack(codes)
