"""Attentive-RNN backbone: GLA encoder -> cross-attention -> GLA decoder.

Counterpart of ``lina_speech_tpu/models/attentive_rnn.py``
(``EncoderCrossDecoder`` / ``AttentiveGLA``, reference gla.py:252-365) with
the state an explicit :class:`BackboneState` threaded by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.base_blocks import MixingBlock, SwiGLU
from lina_speech_tpu_torch.models.crossatt import BlindCrossAttention, CrossAttention
from lina_speech_tpu_torch.models.gla_layer import GatedLinearAttention, GLAState


@dataclasses.dataclass
class BackboneState:
    """Per-block mixer states (encoder blocks, then decoder blocks) plus
    the blind cross-attention's pos_net state."""

    layers: Tuple[GLAState, ...]
    pos_net: Optional[GLAState] = None


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
                return_att: bool = False, output_final_state: bool = False):
        """x: (b, t, d) audio embeddings; ctx: (b, m, d) text encoding.
        Returns (y, att) or (y, att, final_state)."""
        use_state = init_state is not None or output_final_state
        if init_state is None and use_state:
            init_state = self.empty_state(x.shape[0], device=x.device)

        def run(blk, x, st):
            if use_state:
                return blk(x, initial_state=st, output_final_state=True)
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
                return_weights=return_att)
        else:
            v, att = self.cross_att(x, ctx, mask=mask, return_weights=return_att)
        x = x + v
        for i, blk in enumerate(self.decoder):
            st = init_state.layers[self.n_layer + i] if use_state else None
            x, st = run(blk, x, st)
            finals.append(st)
        if output_final_state:
            return x, att, BackboneState(layers=tuple(finals), pos_net=ca_final)
        return x, att

    def step(self, y_embd, x_enc, state: BackboneState, mask=None,
             time_step=None):
        """y_embd: (b, d) current token embedding; x_enc: (b, m, d).
        Returns (y (b, d), att, new_state). Mirrors gla.py:358-365."""
        layers = list(state.layers)
        for i, blk in enumerate(self.encoder):
            y_embd, layers[i] = blk.step(y_embd, layers[i])
        if self.blind:
            v, att, pos_net_state = self.cross_att.step(y_embd, x_enc,
                                                        state.pos_net, mask=mask)
        else:
            v, att = self.cross_att(y_embd[:, None], x_enc, mask=mask,
                                    time_step=time_step, return_weights=True)
            v, att, pos_net_state = v[:, 0], att[:, :, 0], None
        y_embd = y_embd + v
        for i, blk in enumerate(self.decoder):
            j = self.n_layer + i
            y_embd, layers[j] = blk.step(y_embd, layers[j])
        return y_embd, att, BackboneState(layers=tuple(layers), pos_net=pos_net_state)

    def empty_state(self, batch_size: int, device=None) -> BackboneState:
        """Zero state for all 2*n_layer blocks (+ pos_net); gla.py:302-313."""
        mk = lambda blk: blk.tmix.empty_state(
            batch_size, state_dtype=self.state_dtype, device=device)
        layers = tuple(mk(b) for b in list(self.encoder) + list(self.decoder))
        pos_net = mk(self.cross_att.pos_net) if self.blind else None
        return BackboneState(layers=layers, pos_net=pos_net)
