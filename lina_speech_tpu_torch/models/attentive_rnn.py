"""Attentive-RNN backbones: recurrent encoder -> cross-attention -> decoder.

Counterpart of ``lina_speech_tpu/models/attentive_rnn.py`` with the state
an explicit :class:`BackboneState` threaded by the caller.
:class:`EncoderCrossDecoder` is the shared scaffold (JAX
``EncoderCrossDecoder``): n_layer mixer blocks, ONE cross-attention (blind,
PP or vanilla), n_layer mixer blocks; a concrete backbone gives it its
mixer block (``_block``) and that block's empty state (``_layer_state``).
:class:`AttentiveGLA` (reference gla.py:252-365), ``AttentiveMamba`` and
``AttentiveMamba2`` (``models/mamba.py``) and ``AttentiveRWKV6``
(``models/rwkv6.py``) plug into it. :class:`InterleavedCrossAtt` is the
interleaved scaffold (JAX ``InterleavedCrossAtt``): a single stack with a
vanilla CrossAttention after the listed layers, per-layer states and no
pos_net; :class:`CrossAttGLA` (reference gla.py:367-420) and
``CrossAttMamba`` (``models/mamba.py``) plug into it.

Rematerialization (``remat``, JAX ``nn.remat`` per block): in training
mode, without an initial state, each encoder and decoder block of an
:class:`AttentiveGLA` runs under :func:`checkpoint_block`, which drops its
activations after the forward and recomputes them in the backward (the
cross-attention and its pos_net are not rematerialized, as in JAX).

Context parallelism: with ``cp_group`` set (``build_model`` sets it on the
backbone and on every mixer) ``x`` is this rank's time shard; the mixers
run their context-parallel paths, and the query positions of a rotary or
PP cross-attention are offset by the shard's start (the shards are of
equal length). The cross-attentions need nothing else: the text is whole
on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from lina_speech_tpu_torch.models.base_blocks import Dropout, MixingBlock, SwiGLU
from lina_speech_tpu_torch.models.crossatt import (
    BlindCrossAttention, CrossAttention, CrossAttentionPP,
)
from lina_speech_tpu_torch.models.gla_layer import (
    GatedLinearAttention, GLAState, gla_add_lazy_buffers,
)
from lina_speech_tpu_torch.parallel.collectives import group_rank


@dataclasses.dataclass
class BackboneState:
    """Per-block mixer states (encoder blocks, then decoder blocks) plus
    the state of the cross-attention's pos_net / inter_net block, if any."""

    layers: Tuple
    pos_net: Optional[object] = None


def map_state(fn: Callable, state, *others):
    """``fn(leaf, *other_leaves)`` over every leaf of ``state`` (and the
    leaves at the same place in ``others``); fields that are None stay
    None. The result replaces each leaf with what ``fn`` returns. The
    layer states may be of any dataclass (``GLAState``, ``MambaState``,
    ``RWKV6State``, the transformer's ``KVState``, whose clock ``t`` is a
    leaf too), and ``state`` a ``BackboneState`` or any dataclass of
    ``layers`` (``TransformerState``)."""
    def one(st, *os):
        if st is None:
            return None
        return type(st)(**{
            f.name: None if getattr(st, f.name) is None
            else fn(getattr(st, f.name), *(getattr(o, f.name) for o in os))
            for f in dataclasses.fields(st)})

    kw = dict(layers=tuple(one(st, *(o.layers[i] for o in others))
                           for i, st in enumerate(state.layers)))
    if hasattr(state, "pos_net"):
        kw["pos_net"] = one(state.pos_net, *(o.pos_net for o in others))
    return type(state)(**kw)


def add_lazy_buffers(state: BackboneState, window: int,
                     dtype: torch.dtype = torch.bfloat16,
                     state_quant: Optional[str] = None) -> BackboneState:
    """Attach zeroed lazy-window buffers to every GLA layer state;
    ``state_quant="int8"`` or ``"int4"`` also row-quantizes the LAYER base
    states (the bulk of the bytes a decode step reads); the one pos_net
    state stays full precision, as in the JAX package. A state of another mixer
    (Mamba, Mamba-2, RWKV6) has no lazy window: ``TypeError``, as in JAX."""
    def one(st, quant):
        if not isinstance(st, GLAState):
            raise TypeError(f"lazy decode unsupported for {type(st).__name__}")
        return gla_add_lazy_buffers(st, window, dtype, quant)

    return BackboneState(
        layers=tuple(one(st, state_quant) for st in state.layers),
        pos_net=one(state.pos_net, None) if state.pos_net is not None else None)


def checkpoint_block(block: nn.Module, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """``block(x, **kwargs)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the block's activations are dropped after the forward and recomputed in
    the backward, with the same gradients.

    The recompute must draw the dropout masks the forward drew. The block's
    :class:`Dropout` modules draw from an explicit ``torch.Generator``, and
    checkpoint's ``preserve_rng_state`` restores only the global CPU and
    CUDA generators, so the state of each of those generators is taken
    before the forward, set back for the recompute and returned to where
    the backward found it afterwards."""
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    before = [g.get_state() for g in gens]
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(True)
            return block(x, **kwargs)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            return block(x, **kwargs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


def _gla_block(d: int, heads: int, use_short_conv: bool, expand_k: float, expand_v: float,
               dropout: float, chunk_size: int, dtype: torch.dtype, scalar_gate: bool,
               kernel_mode: str) -> MixingBlock:
    return MixingBlock(d, GatedLinearAttention(
        hidden_size=d, num_heads=heads, use_short_conv=use_short_conv,
        expand_k=expand_k, expand_v=expand_v, chunk_size=chunk_size,
        scalar_gate=scalar_gate, kernel_mode=kernel_mode, dtype=dtype),
        SwiGLU(d, dtype=dtype), dropout=dropout)


class EncoderCrossDecoder(nn.Module):
    """Shared scaffold: n_layer mixer blocks -> ONE cross-attention -> n_layer
    mixer blocks, with an explicit state threading through all of it. A
    subclass sets its own attributes after ``super().__init__`` and then
    calls :meth:`_build`, which asks its ``_block`` for every mixer block
    (the blind cross-attention's pos_net and the PP inter_net included)."""

    remat = False  # a backbone that takes it sets it in its constructor
    cp_group = None  # the cp process group of a time-sharded forward

    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 dropout: float = 0.0, d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 pos_type: str = "sinusoidal", dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_layer, self.heads = d_model, n_layer, heads
        self.dropout, self.blind, self.cross_att_pp = dropout, blind, cross_att_pp
        self.rotary, self.pos_type = rotary, pos_type
        self.d_blind = d_model if d_blind is None else d_blind
        self.dtype, self.state_dtype = dtype, state_dtype

    # ---- subclass hooks ----
    def _block(self, d: int) -> MixingBlock:
        raise NotImplementedError

    def _layer_state(self, block: MixingBlock, batch_size: int, device):
        raise NotImplementedError

    # ---- construction ----
    def _build(self) -> None:
        self.encoder = nn.ModuleList(self._block(self.d_model) for _ in range(self.n_layer))
        self.decoder = nn.ModuleList(self._block(self.d_model) for _ in range(self.n_layer))
        d = self.d_model
        if self.blind:
            self.cross_att = BlindCrossAttention(
                d, d, d, pos_net=self._block(self.d_blind), pos_dim=self.d_blind,
                pos_type=self.pos_type, dtype=self.dtype)
        elif self.cross_att_pp:
            self.cross_att = CrossAttentionPP(d, inter_net=self._block(d), ca_heads=1,
                                              dtype=self.dtype)
        else:
            self.cross_att = CrossAttention(d, d, d, self.heads, rotary=self.rotary,
                                            dtype=self.dtype)

    def _stateful_block(self) -> Optional[MixingBlock]:
        """The cross-attention's own mixer block (blind pos_net or PP
        inter_net), whose state rides in ``BackboneState.pos_net``."""
        if self.blind:
            return self.cross_att.pos_net
        return self.cross_att.inter_net if self.cross_att_pp else None

    def gla_layers(self):
        """Every GatedLinearAttention of the backbone (25 in the flagship)."""
        return [m for m in self.modules() if isinstance(m, GatedLinearAttention)]

    def forward(self, x, ctx, mask=None, init_state: Optional[BackboneState] = None,
                return_att: bool = False, output_final_state: bool = False,
                conv_history: bool = False, time_offset=0,
                crossatt_pos_valid: Optional[torch.Tensor] = None,
                reset_mask: Optional[torch.Tensor] = None,
                crossatt_pos: Optional[torch.Tensor] = None):
        """x: (b, t, d) audio embeddings; ctx: (b, m, d) text encoding.
        Returns (y, att) or (y, att, final_state).

        ``reset_mask`` ((b, t) bool) wipes every mixer's state where it is
        True (the first token of each packed segment) and ``crossatt_pos``
        gives the blind cross-attention its text positions (training on
        packed batches).

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
        if self.cp_group is not None:
            time_offset = time_offset + group_rank(self.cp_group) * x.shape[1]

        def run(blk, x, st):
            if use_state:
                return blk(x, initial_state=st, output_final_state=True,
                           conv_history=conv_history, reset_mask=reset_mask)
            if self.remat and self.training:
                return checkpoint_block(blk, x, reset_mask=reset_mask), None
            return blk(x, reset_mask=reset_mask), None

        finals = []
        for i, blk in enumerate(self.encoder):
            x, st = run(blk, x, init_state.layers[i] if use_state else None)
            finals.append(st)
        ca_state = init_state.pos_net if use_state else None
        ca_final = None
        if self.blind:
            v, att, ca_final = self.cross_att(
                x, ctx, mask=mask, pos_net_state=ca_state, return_weights=return_att,
                conv_history=conv_history, pos_valid=crossatt_pos_valid, pos=crossatt_pos,
                reset_mask=reset_mask)
        elif self.cross_att_pp:
            v, att, ca_final = self.cross_att(
                x, ctx, mask=mask, pos_net_state=ca_state, return_weights=return_att,
                conv_history=conv_history, reset_mask=reset_mask, time_step=time_offset)
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
        elif self.cross_att_pp:
            v, att, pos_net_state = self.cross_att.step(
                y_embd, x_enc, state.pos_net, mask=mask, lazy_p=lazy_p, time_step=time_step)
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
        pos_net = (self._stateful_block().tmix.fold_lazy_state(state.pos_net)
                   if state.pos_net is not None else None)
        return BackboneState(
            layers=tuple(blk.tmix.fold_lazy_state(st)
                         for blk, st in zip(blocks, state.layers)),
            pos_net=pos_net)

    def empty_state(self, batch_size: int, device=None) -> BackboneState:
        """Zero state for all 2*n_layer blocks (+ pos_net); gla.py:302-313."""
        blocks = list(self.encoder) + list(self.decoder)
        ca = self._stateful_block()
        return BackboneState(
            layers=tuple(self._layer_state(b, batch_size, device) for b in blocks),
            pos_net=None if ca is None else self._layer_state(ca, batch_size, device))


class AttentiveGLA(EncoderCrossDecoder):
    """The GLA backbone (the flagship; with ``scalar_gate`` simple-GLA)."""

    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 dropout: float = 0.0,
                 d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 use_short_conv: bool = False, expand_k: float = 1.0,
                 expand_v: float = 2.0, pos_type: str = "sinusoidal",
                 chunk_size: int = 64, scalar_gate: bool = False, remat: bool = False,
                 dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32,
                 kernel_mode: str = "auto"):
        super().__init__(d_model, n_layer, heads, dropout, d_blind, blind, cross_att_pp,
                         rotary, pos_type, dtype, state_dtype)
        self.use_short_conv, self.expand_k, self.expand_v = use_short_conv, expand_k, expand_v
        self.chunk_size, self.scalar_gate, self.kernel_mode = chunk_size, scalar_gate, kernel_mode
        self.remat = remat
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return _gla_block(d, self.heads, self.use_short_conv, self.expand_k, self.expand_v,
                          self.dropout, self.chunk_size, self.dtype, self.scalar_gate,
                          self.kernel_mode)

    def _layer_state(self, block: MixingBlock, batch_size: int, device) -> GLAState:
        return block.tmix.empty_state(batch_size, state_dtype=self.state_dtype, device=device)

    # ---------- initial-state tuning (speaker adaptation) ----------
    def _layer_dims(self) -> Tuple[int, int]:
        key_dim = int(self.d_model * self.expand_k)
        value_dim = int(self.d_model * self.expand_v)
        return key_dim // self.heads, value_dim // self.heads

    def init_state_tuning_params(self, generator: torch.Generator,
                                 rank: Optional[int] = 1, scale: float = 0.02) -> List:
        """Per-block LoRA-factorized S0 params (reference gla.py:336-356),
        drawn from ``generator`` on its device.

        Each of the 2*n_layer blocks gets (k: (1, r, h, d_k, 1),
        v: (1, r, h, 1, d_v)); with rank=None a full (1, h, d_k, d_v)."""
        dk, dv = self._layer_dims()
        randn = lambda *s: torch.randn(*s, generator=generator, device=generator.device)
        params = []
        for _ in range(2 * self.n_layer):
            if rank is not None:
                params.append((randn(1, rank, self.heads, dk, 1),
                               randn(1, rank, self.heads, 1, dv) * scale))
            else:
                params.append(randn(1, self.heads, dk, dv) * scale)
        return params

    def state_from_params(self, params: List, batch_size: int,
                          scale: float = 0.02) -> BackboneState:
        """Materialize tuning params into a BackboneState (gla.py:315-325):
        f32 states on the params' device, differentiable w.r.t. them."""
        first = params[0][0] if isinstance(params[0], tuple) else params[0]
        state = self.empty_state(batch_size, device=first.device)
        layers = list(state.layers)
        for i, p in enumerate(params):
            if isinstance(p, tuple):
                s = torch.einsum("brhko,brhov->bhkv", p[0], p[1]) * scale
            else:
                s = p
            s = s.expand(batch_size, *s.shape[1:]).float().contiguous()
            layers[i] = dataclasses.replace(layers[i], s=s)
        return dataclasses.replace(state, layers=tuple(layers))


class InterleavedCrossAtt(nn.Module):
    """A single stack of ``n_layer`` mixer blocks with a vanilla
    CrossAttention (``cross_att_heads`` heads) after each layer of
    ``cross_att_layers`` (JAX ``InterleavedCrossAtt``, reference
    gla.py:367-477 and mamba.py:115-257). The attention maps of those layers
    are concatenated over the head axis. The cross-attentions are named
    ``cross_att_<i>``, as the JAX package's ``torch_key_for`` names them. A
    subclass gives its mixer block (``_block``; ``_layer_state`` is the
    block's own empty state unless it says otherwise), sets its own
    attributes after ``super().__init__`` and then calls :meth:`_build`; the
    states are per layer, with no pos_net."""

    blind = cross_att_pp = False
    cp_group = None  # the cp process group of a time-sharded forward

    def __init__(self, d_model: int, n_layer: int, cross_att_layers: Sequence[int],
                 heads: int, cross_att_heads: int = 1, dropout: float = 0.0,
                 rotary: bool = False, dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_layer, self.heads = d_model, n_layer, heads
        self.cross_att_layers = tuple(cross_att_layers)
        self.cross_att_heads, self.dropout, self.rotary = cross_att_heads, dropout, rotary
        self.dtype, self.state_dtype = dtype, state_dtype

    # ---- subclass hooks ----
    def _block(self, d: int) -> MixingBlock:
        raise NotImplementedError

    def _layer_state(self, block: MixingBlock, batch_size: int, device):
        return block.tmix.empty_state(batch_size, state_dtype=self.state_dtype, device=device)

    def _build(self) -> None:
        d = self.d_model
        self.blocks = nn.ModuleList(self._block(d) for _ in range(self.n_layer))
        for i, _ in enumerate(self.cross_att_layers):
            setattr(self, f"cross_att_{i}", CrossAttention(
                d, d, d, self.cross_att_heads, rotary=self.rotary, dtype=self.dtype))

    def _cross_att(self, layer: int) -> Optional[CrossAttention]:
        if layer not in self.cross_att_layers:
            return None
        return getattr(self, f"cross_att_{self.cross_att_layers.index(layer)}")

    def gla_layers(self):
        return [m for m in self.modules() if isinstance(m, GatedLinearAttention)]

    def forward(self, x, ctx, mask=None, init_state: Optional[BackboneState] = None,
                return_att: bool = False, output_final_state: bool = False,
                conv_history: bool = False, time_offset=0,
                crossatt_pos_valid: Optional[torch.Tensor] = None,
                reset_mask: Optional[torch.Tensor] = None,
                crossatt_pos: Optional[torch.Tensor] = None):
        """As :meth:`EncoderCrossDecoder.forward`; ``crossatt_pos_valid`` and
        ``crossatt_pos`` are taken for the same signature and unused (the
        vanilla CrossAttention has no positional values)."""
        use_state = init_state is not None or output_final_state
        if init_state is None and use_state:
            init_state = self.empty_state(x.shape[0], device=x.device)
        if self.cp_group is not None:
            time_offset = time_offset + group_rank(self.cp_group) * x.shape[1]
        atts, finals = [], []
        for i, blk in enumerate(self.blocks):
            if use_state:
                x, st = blk(x, initial_state=init_state.layers[i], output_final_state=True,
                            conv_history=conv_history, reset_mask=reset_mask)
            else:
                x, st = blk(x, reset_mask=reset_mask), None
            finals.append(st)
            ca = self._cross_att(i)
            if ca is not None:
                v, att = ca(x, ctx, mask=mask, time_step=time_offset, return_weights=return_att)
                x = x + v
                if att is not None:
                    atts.append(att)
        att = torch.cat(atts, dim=1) if atts else None
        if output_final_state:
            return x, att, BackboneState(layers=tuple(finals))
        return x, att

    def step(self, y_embd, x_enc, state: BackboneState, mask=None, time_step=None,
             lazy_p: Optional[int] = None, crossatt_pos_valid: Optional[torch.Tensor] = None):
        layers, atts = list(state.layers), []
        for i, blk in enumerate(self.blocks):
            y_embd, layers[i] = blk.step(y_embd, layers[i], lazy_p)
            ca = self._cross_att(i)
            if ca is not None:
                v, att = ca(y_embd[:, None], x_enc, mask=mask, time_step=time_step,
                            return_weights=True)
                y_embd = y_embd + v[:, 0]
                atts.append(att[:, :, 0])
        att = torch.cat(atts, dim=1) if atts else None
        return y_embd, att, BackboneState(layers=tuple(layers))

    def fold_lazy_state(self, state: BackboneState) -> BackboneState:
        return BackboneState(layers=tuple(blk.tmix.fold_lazy_state(st)
                                          for blk, st in zip(self.blocks, state.layers)))

    def empty_state(self, batch_size: int, device=None) -> BackboneState:
        return BackboneState(layers=tuple(self._layer_state(blk, batch_size, device)
                                          for blk in self.blocks))


class CrossAttGLA(InterleavedCrossAtt):
    """The interleaved backbone with GLA blocks (JAX ``CrossAttGLA``,
    reference gla.py:367-477)."""

    def __init__(self, d_model: int, n_layer: int, cross_att_layers: Sequence[int],
                 heads: int, cross_att_heads: int = 1, dropout: float = 0.0,
                 rotary: bool = False, use_short_conv: bool = False, expand_k: float = 1.0,
                 expand_v: float = 2.0, chunk_size: int = 64, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, cross_att_layers, heads, cross_att_heads, dropout,
                         rotary, dtype, state_dtype)
        self.use_short_conv, self.expand_k, self.expand_v = use_short_conv, expand_k, expand_v
        self.chunk_size, self.kernel_mode = chunk_size, kernel_mode
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return _gla_block(d, self.heads, self.use_short_conv, self.expand_k, self.expand_v,
                          self.dropout, self.chunk_size, self.dtype, False, self.kernel_mode)
