"""Softmax-transformer backbone (PyTorch port).

Counterpart of ``lina_speech_tpu/models/transformer.py`` (reference
model/transformer.py): causal rotary self-attention blocks with a vanilla
cross-attention after the layers of ``cross_att_layers``. Decode carries
*fixed-size* KV buffers of ``max_seqlen`` positions in an explicit
:class:`TransformerState`, with one valid length ``t`` per layer shared by
the whole batch, so rows at different progress cannot share a batch
(``DecodeServer`` refuses the backbone for that reason).

Attention is the port's plain ``sdpa`` (f32 logits, the JAX package's
masking): the JAX backbone reaches no Pallas kernel. On int8 weights the
``qkv`` Linear, the cross-attentions' projections and the SwiGLU FFN take
``int8_linear`` and ``fused_ffn_int8`` as everywhere else.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.models.attentive_rnn import InterleavedCrossAtt
from lina_speech_tpu_torch.models.base_blocks import (
    Linear, MixingBlock, Rotary, SwiGLU, sdpa,
)


@dataclasses.dataclass
class KVState:
    """Fixed-size KV cache of one self-attention layer."""

    k: torch.Tensor  # (b, h, max_seqlen, d_head)
    v: torch.Tensor
    t: int  # valid length, shared by the batch


@dataclasses.dataclass
class TransformerState:
    layers: Tuple[KVState, ...]


class CausalSelfAttention(torch.nn.Module):
    """Rotary causal self-attention (rotary on the first ``d_head // 2``
    channels of a head, at absolute positions) with a fixed-buffer decode
    step. No output projection, as the reference."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.rotary = Rotary((dim // heads) // 2)

    def _split(self, z: torch.Tensor) -> torch.Tensor:
        b, n, _ = z.shape
        return z.reshape(b, n, self.heads, self.dim // self.heads).transpose(1, 2)

    def forward(self, x: torch.Tensor, mask=None, return_kv: bool = False,
                kv_state: Optional[KVState] = None, time_offset: int = 0):
        """``kv_state`` continues a stream: this chunk's keys and values are
        written into the state's buffers at ``kv_state.t`` (in place) and the
        queries attend over the whole valid prefix; returns (y, the state
        with ``t`` advanced). Otherwise causal attention within ``x`` at
        positions from ``time_offset``; ``return_kv`` also returns the
        rotated (k, v)."""
        b, n, _ = x.shape
        q, k, v = (self._split(z) for z in self.qkv(x).chunk(3, dim=-1))
        if kv_state is not None:
            t0 = kv_state.t
            pos = torch.arange(n, device=x.device) + t0
            q, k = self.rotary(q, pos), self.rotary(k, pos)
            k_buf, v_buf = kv_state.k, kv_state.v
            k_buf[:, :, t0:t0 + n] = k.to(k_buf.dtype)
            v_buf[:, :, t0:t0 + n] = v.to(v_buf.dtype)
            jpos = torch.arange(k_buf.shape[2], device=x.device)
            valid = jpos[None, :] <= pos[:, None]  # (n, S)
            y, _ = sdpa(q, k_buf, v_buf, mask=valid[None, None])
            y = y.transpose(1, 2).reshape(b, n, self.dim)
            return y, KVState(k=k_buf, v=v_buf, t=t0 + n)
        pos = torch.arange(n, device=x.device) + time_offset
        q, k = self.rotary(q, pos), self.rotary(k, pos)
        y, _ = sdpa(q, k, v, mask=mask, is_causal=True)
        y = y.transpose(1, 2).reshape(b, n, self.dim)
        return (y, (k, v)) if return_kv else y

    def step(self, x_t: torch.Tensor, state: KVState) -> Tuple[torch.Tensor, KVState]:
        """One token (b, d) at position ``state.t``: its key and value are
        written into the buffers in place (the state passed in is consumed;
        the one returned shares its buffers) and every position above ``t``
        is masked."""
        b = x_t.shape[0]
        q, k, v = (z.reshape(b, self.heads, 1, self.dim // self.heads)
                   for z in self.qkv(x_t).chunk(3, dim=-1))
        t = state.t
        pos = torch.full((1,), t, device=x_t.device)
        q, k = self.rotary(q, pos), self.rotary(k, pos)
        state.k[:, :, t] = k[:, :, 0].to(state.k.dtype)
        state.v[:, :, t] = v[:, :, 0].to(state.v.dtype)
        valid = (torch.arange(state.k.shape[2], device=x_t.device) <= t)[None, None, None, :]
        y, _ = sdpa(q, state.k, state.v, mask=valid)
        return y.reshape(b, self.dim), KVState(k=state.k, v=state.v, t=t + 1)


class TransformerCrossAtt(InterleavedCrossAtt):
    """``n_layer`` pre-norm blocks of :class:`CausalSelfAttention` and
    SwiGLU, with a rotary CrossAttention of ``cross_att_heads`` heads after
    each layer of ``cross_att_layers`` (named ``cross_att_<i>``, as the
    interleaved scaffold names them). ``dropout_att`` is taken for the JAX
    signature and unused, as there."""

    def __init__(self, d_model: int, n_layer: int, cross_att_layers: Sequence[int] = (),
                 heads: int = 4, cross_att_heads: int = 2, dropout_att: float = 0.1,
                 cross_att_rotary: bool = True, max_seqlen: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, cross_att_layers, heads, cross_att_heads,
                         rotary=cross_att_rotary, dtype=dtype)
        self.dropout_att, self.max_seqlen = dropout_att, max_seqlen
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return MixingBlock(d, CausalSelfAttention(d, self.heads, dtype=self.dtype),
                           SwiGLU(d, dtype=self.dtype))

    def forward(self, x, ctx, mask=None, init_state: Optional[TransformerState] = None,
                return_att: bool = False, output_final_state: bool = False,
                conv_history: bool = False, time_offset: int = 0,
                crossatt_pos_valid: Optional[torch.Tensor] = None,
                reset_mask: Optional[torch.Tensor] = None,
                crossatt_pos: Optional[torch.Tensor] = None):
        """x: (b, n, d); ctx: (b, m, d). Returns (y, att) or, with
        ``output_final_state`` or ``conv_history``, (y, att, state).

        ``output_final_state`` pads each layer's keys and values to
        ``max_seqlen`` with ``t = n`` (``init_state`` is not read).
        ``conv_history`` (the name of the recurrent backbones' mid-stream
        contract) continues from ``init_state``'s buffers: this chunk lands
        at position ``t`` and its rotary and cross-attention positions start
        at ``time_offset``. ``crossatt_pos_valid``, ``reset_mask`` and
        ``crossatt_pos`` are taken for the common signature and unused, as
        in the JAX package."""
        if conv_history and init_state is None:
            raise ValueError("conv_history=True requires init_state")
        b, n, _ = x.shape
        atts, finals = [], []
        for i, blk in enumerate(self.blocks):
            if conv_history:
                x, st = blk(x, kv_state=init_state.layers[i], time_offset=time_offset)
                finals.append(st)
            elif output_final_state:
                x, (k, v) = blk(x, return_kv=True, time_offset=time_offset)
                pad = lambda z: F.pad(z, (0, 0, 0, self.max_seqlen - n))
                finals.append(KVState(k=pad(k), v=pad(v), t=n))
            else:
                x = blk(x)
            ca = self._cross_att(i)
            if ca is not None:
                v, att = ca(x, ctx, mask=mask, time_step=time_offset, return_weights=return_att)
                x = x + v
                if att is not None:
                    atts.append(att)
        att = torch.cat(atts, dim=1) if atts else None
        if output_final_state or conv_history:
            return x, att, TransformerState(layers=tuple(finals))
        return x, att

    def step(self, y_embd, x_enc, state: TransformerState, mask=None, time_step=None,
             lazy_p: Optional[int] = None, crossatt_pos_valid: Optional[torch.Tensor] = None):
        """One token. The cross-attention's query position is the KV clock
        ``state.layers[0].t``, not ``time_step``, as in the JAX package."""
        if lazy_p is not None:
            raise NotImplementedError(
                "lazy decode applies to linear-attention backbones; the "
                "transformer baseline uses a KV cache")
        layers, atts = list(state.layers), []
        t = state.layers[0].t
        for i, blk in enumerate(self.blocks):
            y_embd, layers[i] = blk.step(y_embd, layers[i])
            ca = self._cross_att(i)
            if ca is not None:
                v, att = ca(y_embd[:, None], x_enc, mask=mask, time_step=t,
                            return_weights=True)
                y_embd = y_embd + v[:, 0]
                atts.append(att[:, :, 0])
        att = torch.cat(atts, dim=1) if atts else None
        return y_embd, att, TransformerState(layers=tuple(layers))

    def empty_state(self, batch_size: int, device=None) -> TransformerState:
        """Zero buffers in the compute dtype, ``t = 0`` in every layer."""
        shape = (batch_size, self.heads, self.max_seqlen, self.d_model // self.heads)
        return TransformerState(layers=tuple(
            KVState(k=torch.zeros(shape, dtype=self.dtype, device=device),
                    v=torch.zeros(shape, dtype=self.dtype, device=device), t=0)
            for _ in range(self.n_layer)))
