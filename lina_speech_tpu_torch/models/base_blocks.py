"""Core residual blocks: layers, attention, pre-norm mixing block, SwiGLU.

Counterpart of ``lina_speech_tpu/models/base_blocks.py`` with the
reference's torch module names (``norm1``, ``tmix``, ``cmix``, ``p_in``,
``qkv``, ``rotary.freqs`` ...), so a reference state_dict loads as is.

dtype flow (as the JAX package's flax modules): parameters are stored f32
and cast to the compute dtype ``dtype`` at each matmul; norms take f32
statistics and return the promoted dtype of input and weight.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.ops.rotary import apply_rotary, rotary_freqs


class Linear(nn.Module):
    """``y = x W^T + b`` in the compute dtype; weight (out, in) f32."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Embedding(nn.Module):
    """Table lookup returning the compute dtype; weight (n, d) f32."""

    def __init__(self, n: int, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics; output in promote(x, weight) dtype
    (flax ``nn.LayerNorm`` with its default ``dtype=None``)."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def sdpa(q, k, v, mask=None, return_weights: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Softmax attention over (b, h, n, d); boolean mask True = keep.

    Written as plain tensor ops mirroring the JAX ``sdpa``: f32 logits and
    softmax, masked logits set to ``-finfo(f32).max`` (not ``-inf``, so a
    fully masked row stays finite).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -torch.finfo(torch.float32).max)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", w.to(v.dtype), v)
    return out, (w if return_weights else None)


class Dropout(nn.Module):
    """Inverted dropout drawn from an explicit ``torch.Generator``.

    Active in training mode only. The generator is not a constructor
    argument: the owner of the model hands one to every Dropout with
    :func:`set_dropout_generator` (it must live on the device of the
    activations). Training with ``p > 0`` and no generator raises.
    """

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training mode needs a generator: "
                               "call set_dropout_generator(model, generator)")
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every :class:`Dropout` of ``model``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class SwiGLU(nn.Module):
    """SwiGLU MLP, hidden d*4//3, gate first (reference base_blocks.py:42-50)."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = d_model * 4 // 3
        self.p_in = Linear(d_model, 2 * hidden, dtype=dtype)
        self.p_out = Linear(hidden, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, h = self.p_in(x).chunk(2, dim=-1)
        return self.p_out(F.silu(gate) * h)


class Rotary(nn.Module):
    """Holds ``freqs`` as the reference's ``rotary_embedding_torch`` module
    does (a state_dict entry), initialized to the analytic values."""

    def __init__(self, rot_dim: int):
        super().__init__()
        self.rot_dim = rot_dim
        self.register_buffer("freqs", rotary_freqs(rot_dim))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_rotary(x, positions, self.rot_dim, freqs=self.freqs)


class SelfAttention(nn.Module):
    """Rotary multi-head self-attention, no output projection
    (reference base_blocks.py:9-40)."""

    def __init__(self, dim: int, heads: int, rotary: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.rotary = Rotary((dim // heads) // 2) if rotary else None

    def forward(self, x: torch.Tensor, mask=None, time_step: int = 0):
        b, n, _ = x.shape
        d_head = self.dim // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        split = lambda t: t.reshape(b, n, self.heads, d_head).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        if self.rotary is not None:
            pos = torch.arange(n, device=x.device)
            q = self.rotary(q, pos + time_step)
            k = self.rotary(k, pos)
        y, _ = sdpa(q, k, v, mask=mask)
        return y.transpose(1, 2).reshape(b, n, self.dim)


class MixingBlock(nn.Module):
    """Pre-norm residual block: x += tmix(ln(x)); x += cmix(ln(x)); dropout.

    ``tmix`` may return (y, aux) (GLA returning its state); aux goes back
    to the caller. ``step`` runs one decode token through a stateful tmix.
    Reference base_blocks.py:56-69.
    """

    def __init__(self, d: int, tmix: nn.Module, cmix: nn.Module, dropout: float = 0.0):
        super().__init__()
        self.tmix, self.cmix = tmix, cmix
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.drop = Dropout(dropout) if dropout > 0.0 else None

    def forward(self, x: torch.Tensor, **tmix_kwargs):
        out = self.tmix(self.norm1(x), **tmix_kwargs)
        aux = None
        if isinstance(out, tuple):
            out, aux = out[0], out[1:]
        x = out + x
        x = self.cmix(self.norm2(x)) + x
        if self.drop is not None:
            x = self.drop(x)
        return (x, *aux) if aux is not None else x

    def step(self, x_t: torch.Tensor, state, lazy_p: Optional[int] = None):
        """One decode token; ``lazy_p`` (the window position) takes the
        tmix's lazy-window step instead of its classic one."""
        if lazy_p is None:
            y, state = self.tmix.step(self.norm1(x_t), state)
        else:
            y, state = self.tmix.step_lazy(self.norm1(x_t), state, lazy_p)
        x = y + x_t
        return self.cmix(self.norm2(x)) + x, state
