"""Mamba token mixers and their backbones (PyTorch port): Mamba (v1) and
Mamba-2 (SSD).

Counterpart of ``lina_speech_tpu/models/mamba.py`` (``MambaState``,
``mamba_empty_state``, ``MambaMixer``, ``AttentiveMamba``,
``CrossAttMamba``, ``Mamba2Mixer``, ``mamba2_empty_state``,
``AttentiveMamba2``; reference model/mamba.py, layers of the external
``mamba_ssm``).

Mamba (v1): in_proj -> [x | z]; a causal depthwise conv with bias and silu
on x; x_proj -> [dt | B | C]; dt = softplus(dt_proj(dt)) in f32; the
selective scan (``ops/mamba_cuda.py``: the ``mamba_scan`` kernel for the
prefill and the training forward, its hand-written backward for training;
their plain versions on the CPU, under ``kernel_mode="chunk"`` and for
shapes the kernels do not take); y * silu(z); out_proj. A decode token
runs the plain ``selective_step``, as in JAX. A = -exp(A_log) and D are
cast to f32 before the scan, as the JAX op does. The state is the SSM state
(b, d_inner, d_state) and the conv ring. The JAX mixer's docstring speaks of
a reset as a large dt A decay; the op it calls zeroes the decay, and so
does the port.

Mamba-2: the SSD recurrence is scalar-per-head-decay linear attention: a
state of (d_state, headdim) per head, decayed by exp(-exp(A_log) dt_t),
with C_t as queries, B_t as keys and x_t dt_t as values, at scale 1.0. So
it runs on the GLA kernels of ``ops/gla_cuda.py``: the prefill and training
on ``gla_chunk`` (and its hand-written backward), the decode token on
``gla_decode``. The JAX package calls the plain ``ops/gla.py`` scans here;
they compute the same function, and on the card the port runs the kernels
(plain versions on the CPU, under ``kernel_mode="chunk"``, and for heads
the kernels do not take).

Structure: in_proj -> [z | x | B | C | dt]; a depthwise causal conv with
bias and silu on (x, B, C); the scan, plus the D skip; a per-head RMSNorm
gated by silu(z); out_proj. B and C are shared by the heads and broadcast
to them before the kernels (autograd sums their gradient over the heads).

Dtypes: in the JAX package the scan's values x dt are f32 by promotion
while C and B stay in the compute dtype. The kernels take one IO dtype, so
the port calls them with f32 q, k and v: casting bf16 C and B up is exact,
so no rounding is added that JAX lacks. The scan's output is then rounded to
the compute dtype, the dtype of JAX's ``o`` (q's). With bf16 compute the
JAX chunked scan also runs its matmuls in bf16; the port's f32 scan is the
more exact of the two (the tests compare in f32). The recurrent state keeps
the JAX layout (b, heads * d_state, headdim) in :class:`MambaState` and is
viewed as (b, heads, d_state, headdim) around each kernel call.

Neither mixer has a lazy-window decode or initial-state tuning, as in JAX.

Context parallelism (``cp_group``, set by ``build_model`` from the mesh's
cp group): a time shard's causal conv takes the previous rank's last
``d_conv - 1`` conv inputs (``parallel/collectives.py:halo_exchange``);
Mamba's scan runs ``ops/mamba_cp.py:selective_scan_cp`` over ``mamba_scan``,
Mamba-2's ``ops/gla_cp.py:gla_chunk_cp`` over ``gla_chunk``. A final state
is the whole sequence's, its conv ring the last rank's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.attentive_rnn import (
    EncoderCrossDecoder, InterleavedCrossAtt,
)
from lina_speech_tpu_torch.models.base_blocks import Linear, MixingBlock, SwiGLU
from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda
from lina_speech_tpu_torch.ops.gla_cp import gla_chunk_cp
from lina_speech_tpu_torch.ops.mamba import selective_step
from lina_speech_tpu_torch.ops.mamba_cp import selective_scan_cp
from lina_speech_tpu_torch.ops.short_conv import causal_depthwise_conv, short_conv_step
from lina_speech_tpu_torch.parallel.collectives import from_last, halo_exchange


@dataclasses.dataclass
class MambaState:
    # Mamba: h (b, d_inner, d_state), conv (d_conv, b, d_inner); Mamba-2: h
    # (b, heads * d_state, headdim), conv (d_conv, b, d_inner + 2 d_state).
    # h in the state dtype; conv is a time-major ring of the conv inputs
    h: torch.Tensor
    conv: torch.Tensor


def mamba_empty_state(batch_size: int, d_model: int, expand: int = 2, d_state: int = 16,
                      d_conv: int = 4, dtype: torch.dtype = torch.float32,
                      state_dtype: torch.dtype = torch.float32, device=None) -> MambaState:
    d_inner = expand * d_model
    return MambaState(
        h=torch.zeros(batch_size, d_inner, d_state, dtype=state_dtype, device=device),
        conv=torch.zeros(d_conv, batch_size, d_inner, dtype=dtype, device=device))


def _conv_tail(xs: torch.Tensor, initial_state: Optional[MambaState], use_hist: bool,
               w: int) -> torch.Tensor:
    """The conv ring after this chunk: its last ``w`` conv inputs, time-major
    (w, b, dim), the carried ring in front where ``use_hist``, zeros in front
    of a chunk shorter than ``w`` without it."""
    if use_hist:
        full = torch.cat([initial_state.conv.transpose(0, 1).to(xs.dtype), xs], 1)
    else:
        full = F.pad(xs, (0, 0, max(0, w - xs.shape[1]), 0))
    return full[:, -w:].transpose(0, 1).contiguous()


def _conv_with_history(xs: torch.Tensor, initial_state: Optional[MambaState],
                       conv_history: bool, taps, w: int, cp=None):
    """The causal conv (with silu) of ``xs`` (b, t, dim); with
    ``conv_history`` the carried ring of ``initial_state`` is its history,
    under ``cp`` (a process group) the previous rank's last w - 1 inputs.
    Returns (conv output, whether the carried ring was used)."""
    if conv_history and initial_state is None:
        raise ValueError("conv_history=True requires initial_state")
    if cp is not None:
        if conv_history:
            raise ValueError("a time-sharded forward (cp_group) takes no conv_history")
        hist = halo_exchange(xs, w - 1, cp)
    elif conv_history:
        hist = initial_state.conv.transpose(0, 1)[:, 1:]  # (b, w - 1, dim)
    else:
        return causal_depthwise_conv(xs, *taps), False
    out = causal_depthwise_conv(torch.cat([hist.to(xs.dtype), xs], dim=1), *taps)
    return out[:, w - 1:], conv_history


class MambaMixer(nn.Module):
    """Mamba (v1) token mixer; parameter names and layouts as the JAX
    module's (``in_proj``, ``conv_kernel`` (d_inner, d_conv), ``conv_bias``,
    ``x_proj``, ``dt_proj`` (with bias), ``A_log`` (d_inner, d_state), ``D``,
    ``out_proj``). ``kernel_mode``: "auto" (the ``mamba_scan`` wrapper) or
    "chunk" / "scan" (its plain version, a time loop, on every device)."""

    cp_group = None  # the cp process group of a time-sharded forward

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 dt_rank: Optional[int] = None, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_mode not in ("auto", "chunk", "scan"):
            raise NotImplementedError(
                f"kernel_mode={kernel_mode!r} is not ported; the port has 'auto' "
                "(kernels on CUDA) and 'chunk' / 'scan' (plain PyTorch)")
        self.d_model, self.d_state, self.d_conv, self.expand = d_model, d_state, d_conv, expand
        self.d_inner = expand * d_model
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.kernel_mode, self.dtype = kernel_mode, dtype
        d_in = self.d_inner
        self.in_proj = Linear(d_model, 2 * d_in, bias=False, dtype=dtype)
        self.conv_kernel = nn.Parameter(torch.empty(d_in, d_conv))
        self.conv_bias = nn.Parameter(torch.zeros(d_in))
        self.x_proj = Linear(d_in, self.dt_rank + 2 * d_state, bias=False, dtype=dtype)
        self.dt_proj = Linear(self.dt_rank, d_in, bias=True, dtype=dtype)
        self.A_log = nn.Parameter(torch.empty(d_in, d_state))
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = Linear(d_in, d_model, bias=False, dtype=dtype)

    def empty_state(self, batch_size: int, state_dtype=torch.float32, device=None) -> MambaState:
        return mamba_empty_state(batch_size, self.d_model, self.expand, self.d_state,
                                 self.d_conv, self.dtype, state_dtype, device)

    def _conv_taps(self):
        return self.conv_kernel.to(self.dtype), self.conv_bias.to(self.dtype)

    def _ssm_inputs(self, x_conv: torch.Tensor):
        """(dt f32, A, B, C) from the conv output; A = -exp(A_log) in the
        parameter's dtype, as the JAX mixer computes it."""
        dt, B, C = self.x_proj(x_conv).split([self.dt_rank, self.d_state, self.d_state], -1)
        dt = F.softplus(self.dt_proj(dt).float())
        return dt, -torch.exp(self.A_log), B, C

    def _scan(self, x_conv, dt, A, B, C, s0, reset_mask):
        """The scan through the ``mamba_scan`` wrapper under "auto" where the
        kernels take the shape, else its plain version; A and D in f32."""
        state_dtype = torch.float32 if s0 is None else s0.dtype
        takes = mamba_cuda.kernel_takes(self.d_inner, self.d_state, x_conv.dtype, state_dtype)
        fn = mamba_cuda.mamba_scan if self.kernel_mode == "auto" and takes else \
            mamba_cuda.mamba_scan_plain
        if self.cp_group is not None:
            fn = functools.partial(selective_scan_cp, group=self.cp_group, local=fn)
        if reset_mask is not None:  # the model passes a slice of the batch's mask
            reset_mask = reset_mask.contiguous()
        return fn(x_conv, dt, A.float(), B.contiguous(), C.contiguous(), self.D.float(),
                  initial_state=s0, reset_mask=reset_mask)

    def forward(self, x: torch.Tensor, initial_state: Optional[MambaState] = None,
                output_final_state: bool = False, conv_history: bool = False,
                reset_mask: Optional[torch.Tensor] = None):
        """x: (b, t, d) -> (b, t, d) [, MambaState if output_final_state].
        ``conv_history`` consumes ``initial_state.conv`` as the causal history
        of this chunk; ``reset_mask`` ((b, t) bool) zeroes the scan's decay
        where it is True (the conv is not reset, as in JAX)."""
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        cp = self.cp_group
        x_conv, use_hist = _conv_with_history(xs, initial_state, conv_history,
                                              self._conv_taps(), self.d_conv, cp)
        dt, A, B, C = self._ssm_inputs(x_conv)
        s0 = initial_state.h if initial_state is not None else None
        y, h_final = self._scan(x_conv, dt, A, B, C, s0, reset_mask)
        out = self.out_proj(y * F.silu(z))
        if not output_final_state:
            return out
        ring = _conv_tail(xs, initial_state, use_hist, self.d_conv)
        return out, MambaState(h=h_final, conv=ring if cp is None else from_last(ring, cp))

    def step(self, x_t: torch.Tensor, state: MambaState):
        """x_t: (b, d) one token -> (out (b, d), new state): the plain
        ``selective_step``."""
        xs, z = self.in_proj(x_t).chunk(2, dim=-1)
        x_conv, conv = short_conv_step(xs, state.conv, *self._conv_taps())
        dt, A, B, C = self._ssm_inputs(x_conv)
        y, h = selective_step(x_conv, dt, A, B, C, self.D, state.h)
        return self.out_proj(y * F.silu(z)), MambaState(h=h, conv=conv)


def mamba2_empty_state(batch_size: int, d_model: int, expand: int = 2, d_state: int = 64,
                       d_conv: int = 4, headdim: int = 64, dtype: torch.dtype = torch.float32,
                       state_dtype: torch.dtype = torch.float32, device=None) -> MambaState:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return MambaState(
        h=torch.zeros(batch_size, n_heads * d_state, headdim, dtype=state_dtype, device=device),
        conv=torch.zeros(d_conv, batch_size, d_inner + 2 * d_state, dtype=dtype, device=device))


class Mamba2Mixer(nn.Module):
    """Mamba-2 token mixer; parameter names as the JAX module's (``in_proj``,
    ``conv_kernel`` (conv_dim, d_conv), ``conv_bias``, ``A_log``,
    ``dt_bias``, ``D``, ``norm_weight``, ``out_proj``)."""

    cp_group = None  # the cp process group of a time-sharded forward

    def __init__(self, d_model: int, d_state: int = 64, d_conv: int = 4, expand: int = 2,
                 headdim: int = 64, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.expand, self.headdim = expand, headdim
        self.d_inner = expand * d_model
        self.n_heads = self.d_inner // headdim
        self.kernel_mode, self.dtype = kernel_mode, dtype
        conv_dim = self.d_inner + 2 * d_state
        self.in_proj = Linear(d_model, 2 * self.d_inner + 2 * d_state + self.n_heads,
                              bias=False, dtype=dtype)
        self.conv_kernel = nn.Parameter(torch.empty(conv_dim, d_conv))
        self.conv_bias = nn.Parameter(torch.zeros(conv_dim))
        self.A_log = nn.Parameter(torch.empty(self.n_heads))
        self.dt_bias = nn.Parameter(torch.zeros(self.n_heads))
        self.D = nn.Parameter(torch.ones(self.n_heads))
        self.norm_weight = nn.Parameter(torch.ones(self.d_inner))
        self.out_proj = Linear(self.d_inner, d_model, bias=False, dtype=dtype)

    def empty_state(self, batch_size: int, state_dtype=torch.float32, device=None) -> MambaState:
        return mamba2_empty_state(batch_size, self.d_model, self.expand, self.d_state,
                                  self.d_conv, self.headdim, self.dtype, state_dtype, device)

    def _kernel(self, name: str, state_dtype: torch.dtype):
        """The wrapper ``ops.gla_cuda.<name>`` (f32 IO), or its plain version
        under ``kernel_mode`` "chunk" / "scan" or for heads the kernels do
        not take."""
        takes = gla_cuda.kernel_takes(self.d_state, self.headdim, torch.float32, state_dtype)
        if self.kernel_mode != "auto" or not takes:
            name += "_plain"
        return getattr(gla_cuda, name)

    def _split(self, zxbcdt: torch.Tensor):
        d_in, n = self.d_inner, self.d_state
        return zxbcdt.split([d_in, d_in + 2 * n, self.n_heads], dim=-1)  # z, xbc, dt

    def _conv_taps(self):
        return self.conv_kernel.to(self.dtype), self.conv_bias.to(self.dtype)

    def _gated_norm(self, o: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        of = o.float()
        oh = of.reshape(*of.shape[:-1], self.n_heads, self.headdim)
        oh = oh * torch.rsqrt((oh * oh).mean(-1, keepdim=True) + 1e-5)
        of = oh.reshape(of.shape) * self.norm_weight
        return (of * F.silu(z.float())).to(o.dtype)

    def forward(self, x: torch.Tensor, initial_state: Optional[MambaState] = None,
                output_final_state: bool = False, conv_history: bool = False,
                reset_mask: Optional[torch.Tensor] = None):
        """x: (b, t, d) -> (b, t, d) [, MambaState if output_final_state].
        ``conv_history`` consumes ``initial_state.conv`` as the causal history
        of this chunk; ``reset_mask`` ((b, t) bool) sets the log-decay to -20
        where it is True."""
        b, t, _ = x.shape
        h, p, n, w = self.n_heads, self.headdim, self.d_state, self.d_conv
        z, xbc_pre, dt = self._split(self.in_proj(x))
        cp = self.cp_group
        xbc, use_hist = _conv_with_history(xbc_pre, initial_state, conv_history,
                                           self._conv_taps(), w, cp)
        xs, B, C = xbc.split([self.d_inner, n, n], dim=-1)
        xh = xs.reshape(b, t, h, p).transpose(1, 2)  # (b, h, t, p)
        dtf = F.softplus(dt.float() + self.dt_bias)  # (b, t, h)
        gk = (-torch.exp(self.A_log) * dtf).transpose(1, 2)[..., None].expand(b, h, t, n)
        if reset_mask is not None:
            gk = gk.masked_fill(reset_mask[:, None, :, None], -20.0)
        heads = lambda m: m.float()[:, None].expand(b, h, t, n).contiguous()
        v = (xh * dtf.transpose(1, 2)[..., None]).contiguous()  # f32 by promotion
        s0 = None
        if initial_state is not None:
            s0 = initial_state.h.reshape(b, h, n, p)
        state_dtype = torch.float32 if s0 is None else s0.dtype
        scan = self._kernel("gla_chunk", state_dtype)
        if cp is not None:
            scan = functools.partial(gla_chunk_cp, group=cp, local=scan)
        o, s_final = scan(heads(C), heads(B), v, gk.contiguous(), initial_state=s0, scale=1.0)
        o = o.to(self.dtype) + self.D[None, :, None, None] * xh  # D skip
        o = o.transpose(1, 2).reshape(b, t, self.d_inner)
        out = self.out_proj(self._gated_norm(o, z))
        if not output_final_state:
            return out
        ring = _conv_tail(xbc_pre, initial_state, use_hist, w)
        return out, MambaState(h=s_final.reshape(b, h * n, p),
                               conv=ring if cp is None else from_last(ring, cp))

    def step(self, x_t: torch.Tensor, state: MambaState):
        """x_t: (b, d) one token -> (out (b, d), new state). On CUDA the
        kernel updates ``state.h`` in place."""
        b = x_t.shape[0]
        h, p, n = self.n_heads, self.headdim, self.d_state
        z, xbc, dt = self._split(self.in_proj(x_t))
        xbc, conv = short_conv_step(xbc, state.conv, *self._conv_taps())
        xs, B, C = xbc.split([self.d_inner, n, n], dim=-1)
        xh = xs.reshape(b, h, p)
        dtf = F.softplus(dt.float() + self.dt_bias)  # (b, h)
        gk = (-torch.exp(self.A_log) * dtf)[..., None].expand(b, h, n).contiguous()
        heads = lambda m: m.float()[:, None].expand(b, h, n).contiguous()
        v = (xh * dtf[..., None]).contiguous()
        s = state.h.reshape(b, h, n, p)
        o, s = self._kernel("gla_decode", s.dtype)(heads(C), heads(B), v, gk, s, scale=1.0)
        o = o.to(self.dtype) + self.D[None, :, None] * xh
        out = self.out_proj(self._gated_norm(o.reshape(b, self.d_inner), z))
        return out, MambaState(h=s.reshape(b, h * n, p), conv=conv)


class AttentiveMamba2(EncoderCrossDecoder):
    """Mamba-2/SSD backbone (the reference's version=2 default,
    mamba.py:36-44): the attentive-RNN scaffold with Mamba-2 mixer blocks,
    the blind cross-attention's pos_net included. It has no lazy-window
    decode and no initial-state tuning, as in the JAX package."""

    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 dropout: float = 0.0, d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 pos_type: str = "sinusoidal", d_state: int = 64, d_conv: int = 4,
                 expand: int = 2, headdim: int = 64, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, heads, dropout, d_blind, blind, cross_att_pp,
                         rotary, pos_type, dtype, state_dtype)
        self.d_state, self.d_conv, self.expand, self.headdim = d_state, d_conv, expand, headdim
        self.kernel_mode = kernel_mode
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return MixingBlock(d, Mamba2Mixer(d, self.d_state, self.d_conv, self.expand,
                                          self.headdim, self.kernel_mode, self.dtype),
                           SwiGLU(d, dtype=self.dtype), dropout=self.dropout)

    def _layer_state(self, block: MixingBlock, batch_size: int, device) -> MambaState:
        return block.tmix.empty_state(batch_size, state_dtype=self.state_dtype, device=device)


class AttentiveMamba(EncoderCrossDecoder):
    """Encoder -> cross-attention -> decoder with Mamba (v1) mixers
    (reference model/mamba.py:20-113), the blind cross-attention's pos_net
    included."""

    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 dropout: float = 0.0, d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 pos_type: str = "sinusoidal", d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, heads, dropout, d_blind, blind, cross_att_pp,
                         rotary, pos_type, dtype, state_dtype)
        self.d_state, self.d_conv, self.expand = d_state, d_conv, expand
        self.kernel_mode = kernel_mode
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return _mamba_block(d, self.d_state, self.d_conv, self.expand, self.kernel_mode,
                            self.dtype, self.dropout)

    def _layer_state(self, block: MixingBlock, batch_size: int, device) -> MambaState:
        return block.tmix.empty_state(batch_size, state_dtype=self.state_dtype, device=device)


class CrossAttMamba(InterleavedCrossAtt):
    """A single Mamba (v1) stack with interleaved cross-attention (reference
    model/mamba.py:115-257, CrossAttMamba / CrossAttMambaV2)."""

    def __init__(self, d_model: int, n_layer: int, cross_att_layers, heads: int,
                 cross_att_heads: int = 1, dropout: float = 0.0, rotary: bool = False,
                 d_state: int = 16, d_conv: int = 4, expand: int = 2,
                 kernel_mode: str = "auto", dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, cross_att_layers, heads, cross_att_heads, dropout,
                         rotary, dtype, state_dtype)
        self.d_state, self.d_conv, self.expand = d_state, d_conv, expand
        self.kernel_mode = kernel_mode
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return _mamba_block(d, self.d_state, self.d_conv, self.expand, self.kernel_mode,
                            self.dtype, self.dropout)


def _mamba_block(d: int, d_state: int, d_conv: int, expand: int, kernel_mode: str,
                 dtype: torch.dtype, dropout: float) -> MixingBlock:
    return MixingBlock(d, MambaMixer(d, d_state, d_conv, expand, kernel_mode=kernel_mode,
                                     dtype=dtype),
                       SwiGLU(d, dtype=dtype), dropout=dropout)


@torch.no_grad()
def perturb_mamba_params_(model: nn.Module, generator: torch.Generator) -> None:
    """Move the parameters of every Mamba (v1) mixer of ``model`` that
    initialize to constants (or to the same row in every channel) off them,
    so that a check sees channels that differ: ``A_log`` = log U(1, 16),
    ``D`` ~ U(0.5, 1.5), and ``dt_proj``'s bias the inverse softplus of a
    step drawn log-uniform in [1e-3, 1e-1] (the reference Mamba's dt
    init), drawn on the CPU from ``generator``."""
    draw = lambda p, v: p.copy_(v)
    for m in model.modules():
        if isinstance(m, MambaMixer):
            u = lambda s: torch.rand(s, generator=generator)
            draw(m.A_log, torch.log(1.0 + 15.0 * u(m.A_log.shape)))
            draw(m.D, 0.5 + u(m.D.shape))
            dt = torch.exp(math.log(1e-3) + u(m.dt_proj.bias.shape) * math.log(100.0))
            draw(m.dt_proj.bias, dt + torch.log(-torch.expm1(-dt)))
