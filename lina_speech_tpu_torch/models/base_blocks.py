"""Core residual blocks: layers, attention, pre-norm mixing block, SwiGLU.

Counterpart of ``lina_speech_tpu/models/base_blocks.py`` with the
reference's torch module names (``norm1``, ``tmix``, ``cmix``, ``p_in``,
``qkv``, ``rotary.freqs`` ...), so a reference state_dict loads as is.

dtype flow (as the JAX package's flax modules): parameters are stored f32
and cast to the compute dtype ``dtype`` at each matmul; norms take f32
statistics and return the promoted dtype of input and weight.

Quantized route (the JAX package's ``QDense`` and its fused ``SwiGLU``): a
:class:`Linear` may hold an int8 copy of its weight with per-output-channel
scales beside (or, once :meth:`Linear.drop_float_weight_` is called, in place
of) the float weight. While ``use_int8`` is set its forward goes through
``ops/qlinear.py:int8_linear``; a :class:`SwiGLU` whose two layers are both
switched on in weight-only mode runs ``fused_ffn_int8`` instead. The switch
is per module so that a caller can run the token loop on the int8 weights
and prefill on the float ones (:func:`use_int8_weights`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.ops import qlinear
from lina_speech_tpu_torch.ops.rotary import apply_rotary, rotary_freqs


class Linear(nn.Module):
    """``y = x W^T + b`` in the compute dtype; weight (out, in) f32.

    The quantized route: :meth:`set_int8` attaches an int8 weight and its
    scales (plain attributes, not parameters or buffers: they are derived
    from the weight, stay out of the state_dict and live where the weight
    lived when they were made). With ``use_int8`` set, ``forward`` computes
    ``int8_linear(x, q, s)`` in the compute dtype and adds the bias after it,
    in the output dtype. ``quant_mode`` is ``"wonly"`` (the default) or
    ``"w8a8"``; ``kernel_mode="chunk"`` takes the plain version of the int8
    product on every device.
    """

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None
        self.dtype = dtype
        self.int8_q: Optional[torch.Tensor] = None  # (out, in padded to 16) int8
        self.int8_s: Optional[torch.Tensor] = None  # (out,) f32
        self.use_int8 = False
        self.quant_mode = "wonly"
        self.kernel_mode = "auto"

    def set_int8(self, q: torch.Tensor, s: torch.Tensor) -> None:
        """Attach the int8 weight ``q`` (out, in) and its scales ``s`` (out
        elements), as ``utils/quantize.py:quantize_leaf`` makes them."""
        self.int8_q = qlinear.pack_int8_weight(q)
        self.int8_s = s.reshape(-1).float().contiguous()

    def drop_float_weight_(self) -> None:
        """Keep only the int8 weight resident; the layer then always takes
        the quantized route."""
        if self.int8_q is None:
            raise RuntimeError("no int8 weight to keep")
        self.weight = None
        self.use_int8 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(self.dtype) if self.bias is not None else None
        if self.use_int8:
            fn = (qlinear.int8_linear_plain if self.kernel_mode == "chunk"
                  else qlinear.int8_linear)
            y = fn(x, self.int8_q, self.int8_s, out_dtype=self.dtype, mode=self.quant_mode)
            return y if b is None else y + b
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


@contextlib.contextmanager
def use_int8_weights(model: nn.Module, on: bool = True):
    """Within the block every module of ``model`` that holds an int8 weight
    takes its quantized route (``on=False``: leaves things as they are).
    Layers whose float weight was dropped stay quantized outside it too."""
    holders = [m for m in model.modules()
               if on and getattr(m, "int8_q", None) is not None and not m.use_int8]
    for m in holders:
        m.use_int8 = True
    try:
        yield
    finally:
        for m in holders:
            m.use_int8 = False


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


def sdpa(q, k, v, mask=None, is_causal: bool = False, return_weights: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Softmax attention over (b, h, n, d); boolean mask True = keep.

    Written as plain tensor ops mirroring the JAX ``sdpa``: f32 logits and
    softmax, masked logits set to ``-finfo(f32).max`` (not ``-inf``, so a
    fully masked row stays finite). ``is_causal`` keeps ``tril(ones(n, m),
    m - n)``: query i sees the keys up to m - n + i (the last n keys are
    the queries' own).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k).float() * scale
    fill = -torch.finfo(torch.float32).max
    if is_causal:
        n, m = logits.shape[-2:]
        causal = torch.ones(n, m, dtype=torch.bool, device=logits.device).tril(m - n)
        logits = logits.masked_fill(~causal, fill)
    if mask is not None:
        logits = logits.masked_fill(~mask, fill)
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
    """SwiGLU MLP, hidden d*4//3, gate first (reference base_blocks.py:42-50).

    When both of its layers take the quantized route in weight-only mode the
    whole FFN is one ``fused_ffn_int8`` call (the hidden activation stays out
    of device memory), as the JAX ``SwiGLU`` does by default. Under ``w8a8``
    it is two quantized :class:`Linear` calls, so that the whole quantized
    forward keeps one numerics class.
    """

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = d_model * 4 // 3
        self.hidden, self.dtype = hidden, dtype
        self.p_in = Linear(d_model, 2 * hidden, dtype=dtype)
        self.p_out = Linear(hidden, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p_in, p_out = self.p_in, self.p_out
        if (p_in.use_int8 and p_out.use_int8
                and p_in.quant_mode == p_out.quant_mode == "wonly"):
            fn = (qlinear.fused_ffn_int8_plain if p_in.kernel_mode == "chunk"
                  else qlinear.fused_ffn_int8)
            return fn(x, p_in.int8_q, p_in.int8_s, p_in.bias, p_out.int8_q,
                      p_out.int8_s, p_out.bias, out_dtype=self.dtype)
        gate, h = p_in(x).chunk(2, dim=-1)
        return p_out(F.silu(gate) * h)


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
