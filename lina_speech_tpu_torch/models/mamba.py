"""Mamba-2 (SSD) token mixer and the AttentiveMamba2 backbone (PyTorch port).

Counterpart of the Mamba-2 half of ``lina_speech_tpu/models/mamba.py``
(``MambaState``, ``Mamba2Mixer``, ``mamba2_empty_state``,
``AttentiveMamba2``; reference layer mamba_ssm Mamba2, model/mamba.py:40-44).
The SSD recurrence is scalar-per-head-decay linear attention: a state of
(d_state, headdim) per head, decayed by exp(-exp(A_log) dt_t), with C_t as
queries, B_t as keys and x_t dt_t as values, at scale 1.0. So it runs on
the GLA kernels of ``ops/gla_cuda.py``: the prefill and training on
``gla_chunk`` (and its hand-written backward), the decode token on
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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.attentive_rnn import EncoderCrossDecoder
from lina_speech_tpu_torch.models.base_blocks import Linear, MixingBlock, SwiGLU
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.short_conv import causal_depthwise_conv, short_conv_step


@dataclasses.dataclass
class MambaState:
    h: torch.Tensor     # (b, heads * d_state, headdim) in the state dtype
    conv: torch.Tensor  # (d_conv, b, d_inner + 2 d_state) time-major ring


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
        use_hist = conv_history and initial_state is not None
        if conv_history and initial_state is None:
            raise ValueError("conv_history=True requires initial_state")
        z, xbc_pre, dt = self._split(self.in_proj(x))
        conv_in = xbc_pre
        if use_hist:
            ring = initial_state.conv.transpose(0, 1).to(xbc_pre.dtype)  # (b, w, conv_dim)
            conv_in = torch.cat([ring[:, 1:], xbc_pre], dim=1)
        xbc = causal_depthwise_conv(conv_in, *self._conv_taps())
        if use_hist:
            xbc = xbc[:, w - 1:]
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
        o, s_final = self._kernel("gla_chunk", state_dtype)(
            heads(C), heads(B), v, gk.contiguous(), initial_state=s0, scale=1.0)
        o = o.to(self.dtype) + self.D[None, :, None, None] * xh  # D skip
        o = o.transpose(1, 2).reshape(b, t, self.d_inner)
        out = self.out_proj(self._gated_norm(o, z))
        if not output_final_state:
            return out
        if use_hist:
            full = torch.cat([initial_state.conv.transpose(0, 1).to(xbc_pre.dtype), xbc_pre], 1)
        else:
            full = F.pad(xbc_pre, (0, 0, max(0, w - t), 0))
        return out, MambaState(h=s_final.reshape(b, h * n, p),
                               conv=full[:, -w:].transpose(0, 1).contiguous())

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
