"""Attentive-RNN backbone: GLA encoder -> cross-attention -> GLA decoder.

Counterpart of ``lina_speech_tpu/models/attentive_rnn.py``
(``EncoderCrossDecoder`` / ``AttentiveGLA``, reference gla.py:252-365) with
the state an explicit :class:`BackboneState` threaded by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.base_blocks import MixingBlock, SwiGLU
from lina_speech_tpu_torch.models.crossatt import BlindCrossAttention, CrossAttention
from lina_speech_tpu_torch.models.gla_layer import (
    GatedLinearAttention, GLAState, gla_add_lazy_buffers,
)


@dataclasses.dataclass
class BackboneState:
    """Per-block mixer states (encoder blocks, then decoder blocks) plus
    the blind cross-attention's pos_net state."""

    layers: Tuple[GLAState, ...]
    pos_net: Optional[GLAState] = None


def map_state(fn: Callable, state: BackboneState, *others: BackboneState
              ) -> BackboneState:
    """``fn(leaf, *other_leaves)`` over every tensor of ``state`` (and the
    tensors at the same place in ``others``); fields that are None stay
    None. The result replaces each tensor with what ``fn`` returns."""
    def one(st, *os):
        if st is None:
            return None
        return GLAState(**{
            f.name: None if getattr(st, f.name) is None
            else fn(getattr(st, f.name), *(getattr(o, f.name) for o in os))
            for f in dataclasses.fields(GLAState)})

    return BackboneState(
        layers=tuple(one(st, *(o.layers[i] for o in others))
                     for i, st in enumerate(state.layers)),
        pos_net=one(state.pos_net, *(o.pos_net for o in others)))


def add_lazy_buffers(state: BackboneState, window: int,
                     dtype: torch.dtype = torch.bfloat16) -> BackboneState:
    """Attach zeroed lazy-window buffers to every GLA layer state."""
    one = lambda st: gla_add_lazy_buffers(st, window, dtype)
    return BackboneState(
        layers=tuple(one(st) for st in state.layers),
        pos_net=one(state.pos_net) if state.pos_net is not None else None)


class AttentiveGLA(nn.Module):
    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 use_short_conv: bool = False, expand_k: float = 1.0,
                 expand_v: float = 2.0, pos_type: str = "sinusoidal",
                 chunk_size: int = 64, dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32,
                 kernel_mode: str = "auto"):
        super().__init__()
        if cross_att_pp and not blind:
            raise NotImplementedError(
                "CrossAttentionPP is not ported yet (ROADMAP.md Queue 1 item 3)")
        self.d_model, self.n_layer, self.heads = d_model, n_layer, heads
        self.blind = blind
        self.d_blind = d_model if d_blind is None else d_blind
        self.dtype, self.state_dtype = dtype, state_dtype

        def block(d):
            return MixingBlock(d, GatedLinearAttention(
                hidden_size=d, num_heads=heads, use_short_conv=use_short_conv,
                expand_k=expand_k, expand_v=expand_v, chunk_size=chunk_size,
                kernel_mode=kernel_mode, dtype=dtype), SwiGLU(d, dtype=dtype))

        self.encoder = nn.ModuleList(block(d_model) for _ in range(n_layer))
        self.decoder = nn.ModuleList(block(d_model) for _ in range(n_layer))
        if blind:
            self.cross_att = BlindCrossAttention(
                d_model, d_model, d_model, pos_net=block(self.d_blind),
                pos_dim=self.d_blind, pos_type=pos_type, dtype=dtype)
        else:
            self.cross_att = CrossAttention(d_model, d_model, d_model, heads,
                                            rotary=rotary, dtype=dtype)

    def gla_layers(self):
        """Every GatedLinearAttention of the backbone (25 in the flagship)."""
        return [m for m in self.modules() if isinstance(m, GatedLinearAttention)]

    def forward(self, x, ctx, mask=None, init_state: Optional[BackboneState] = None,
                return_att: bool = False, output_final_state: bool = False,
                conv_history: bool = False, time_offset=0,
                crossatt_pos_valid: Optional[torch.Tensor] = None):
        """x: (b, t, d) audio embeddings; ctx: (b, m, d) text encoding.
        Returns (y, att) or (y, att, final_state).

        ``conv_history`` makes every mixer consume ``init_state``'s conv
        rings as causal history and ``time_offset`` offsets the rotary
        cross-attention's query positions: together they make a prefill
        chunk that continues a stream exact (serving runs a prompt as a
        few power-of-two chunks). ``crossatt_pos_valid`` ((b, m) bool)
        makes ConvPos padding-exact.
        """
        use_state = init_state is not None or output_final_state
        if init_state is None and use_state:
            init_state = self.empty_state(x.shape[0], device=x.device)

        def run(blk, x, st):
            if use_state:
                return blk(x, initial_state=st, output_final_state=True,
                           conv_history=conv_history)
            return blk(x), None

        finals = []
        for i, blk in enumerate(self.encoder):
            x, st = run(blk, x, init_state.layers[i] if use_state else None)
            finals.append(st)
        ca_final = None
        if self.blind:
            v, att, ca_final = self.cross_att(
                x, ctx, mask=mask,
                pos_net_state=init_state.pos_net if use_state else None,
                return_weights=return_att, conv_history=conv_history,
                pos_valid=crossatt_pos_valid)
        else:
            v, att = self.cross_att(x, ctx, mask=mask, time_step=time_offset,
                                    return_weights=return_att)
        x = x + v
        for i, blk in enumerate(self.decoder):
            st = init_state.layers[self.n_layer + i] if use_state else None
            x, st = run(blk, x, st)
            finals.append(st)
        if output_final_state:
            return x, att, BackboneState(layers=tuple(finals), pos_net=ca_final)
        return x, att

    def step(self, y_embd, x_enc, state: BackboneState, mask=None,
             time_step=None, lazy_p: Optional[int] = None,
             crossatt_pos_valid: Optional[torch.Tensor] = None):
        """y_embd: (b, d) current token embedding; x_enc: (b, m, d).
        Returns (y (b, d), att, new_state). Mirrors gla.py:358-365.

        ``lazy_p`` (the window position, a host int) switches every mixer
        to the lazy-window step: the states must carry the window buffers
        (:func:`add_lazy_buffers`) and the caller folds once per window
        (:meth:`fold_lazy_state`). ``time_step`` is an int or a (b,) tensor
        of per-row positions.
        """
        layers = list(state.layers)
        for i, blk in enumerate(self.encoder):
            y_embd, layers[i] = blk.step(y_embd, layers[i], lazy_p)
        if self.blind:
            v, att, pos_net_state = self.cross_att.step(
                y_embd, x_enc, state.pos_net, mask=mask, lazy_p=lazy_p,
                pos_valid=crossatt_pos_valid)
        else:
            v, att = self.cross_att(y_embd[:, None], x_enc, mask=mask,
                                    time_step=time_step, return_weights=True)
            v, att, pos_net_state = v[:, 0], att[:, :, 0], None
        y_embd = y_embd + v
        for i, blk in enumerate(self.decoder):
            j = self.n_layer + i
            y_embd, layers[j] = blk.step(y_embd, layers[j], lazy_p)
        return y_embd, att, BackboneState(layers=tuple(layers), pos_net=pos_net_state)

    def fold_lazy_state(self, state: BackboneState) -> BackboneState:
        """Fold every layer's buffered window into its base state, each
        through its own layer's ``kernel_mode``. Full windows only."""
        blocks = list(self.encoder) + list(self.decoder)
        pos_net = (self.cross_att.pos_net.tmix.fold_lazy_state(state.pos_net)
                   if state.pos_net is not None else None)
        return BackboneState(
            layers=tuple(blk.tmix.fold_lazy_state(st)
                         for blk, st in zip(blocks, state.layers)),
            pos_net=pos_net)

    def empty_state(self, batch_size: int, device=None) -> BackboneState:
        """Zero state for all 2*n_layer blocks (+ pos_net); gla.py:302-313."""
        mk = lambda blk: blk.tmix.empty_state(
            batch_size, state_dtype=self.state_dtype, device=device)
        layers = tuple(mk(b) for b in list(self.encoder) + list(self.decoder))
        pos_net = mk(self.cross_att.pos_net) if self.blind else None
        return BackboneState(layers=layers, pos_net=pos_net)
