"""RWKV-6 (Finch) token mixer and the AttentiveRWKV6 backbone (PyTorch port).

Counterpart of ``lina_speech_tpu/models/rwkv6.py`` (``RWKV6State``,
``rwkv6_empty_state``, ``RWKV6Attention``, ``AttentiveRWKV6``): a
data-dependent token-shift interpolation (ddlerp) feeding r, k, v, g and a
low-rank per-channel decay, the bonus ``u`` on the current token, a
per-head GroupNorm and the silu output gate. The recurrence runs on the
kernels of ``ops/rwkv6_cuda.py``: ``rwkv6_chunk`` for the prefill and the
training forward (its backward a hand-written kernel too), ``rwkv6_decode``
for a decode token; their plain versions on the CPU, under
``kernel_mode="chunk"``, and for heads the kernels do not take.

``kernel_mode`` is explicit: "auto" (the wrappers), "chunk" (the plain
chunked scan on every device) or "scan" (the O(T) recurrence for the
prefill). The JAX layer picks its Pallas kernels from the default backend
under "auto"; here the wrappers launch for CUDA tensors and take their
plain versions for CPU tensors.

Parameters keep the JAX package's names and layouts: the raw ones
(``x_maa`` (d,), ``maa`` (5, d), ``maa_w1`` (d, 160), ``maa_w2`` (5, 32,
d), ``decay_w1`` (d, 64), ``decay_w2`` (64, key_dim), ``time_decay``
(key_dim,), ``time_faaaa`` (h, dk), ``ln_x_scale``, ``ln_x_bias``) are
used as ``x @ W``; the five projections are the port's :class:`Linear`, so
``weight_quant="int8"`` reaches them.

Dtypes follow the JAX promotion: the raw parameters are f32 (or the
compute dtype in the cast copies that generation runs on), so the ddlerp
mixes are computed in the promoted dtype, the projections cast to the
compute dtype, and the log-decay is f32. An empty state holds an f32 shift
(as ``rwkv6_empty_state``'s default), so the first token's shift
difference is exact; the final shift is the block input's last token.
The decode state is the recurrent (b, h, dk, dv) state plus the one-token
shift buffer (b, d); neither has a lazy window, so lazy decode and int8
states raise ``TypeError``, and there is no initial-state tuning, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.attentive_rnn import EncoderCrossDecoder
from lina_speech_tpu_torch.models.base_blocks import Linear, MixingBlock, SwiGLU
from lina_speech_tpu_torch.ops import rwkv6_cuda
from lina_speech_tpu_torch.ops.rwkv6 import rwkv6_scan_ref


@dataclasses.dataclass
class RWKV6State:
    s: torch.Tensor      # (b, h, dk, dv) recurrent state, in the state dtype
    shift: torch.Tensor  # (b, d) the previous token's input


def rwkv6_empty_state(batch_size: int, hidden_size: int, num_heads: int,
                      expand_k: float = 1.0, expand_v: float = 1.0,
                      dtype: torch.dtype = torch.float32,
                      state_dtype: torch.dtype = torch.float32, device=None) -> RWKV6State:
    dk = int(hidden_size * expand_k) // num_heads
    dv = int(hidden_size * expand_v) // num_heads
    return RWKV6State(
        s=torch.zeros(batch_size, num_heads, dk, dv, dtype=state_dtype, device=device),
        shift=torch.zeros(batch_size, hidden_size, dtype=dtype, device=device))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as jnp's matmul."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


class RWKV6Attention(nn.Module):
    """RWKV6 token mixer (expand_k = expand_v = 1 in the backbone)."""

    def __init__(self, hidden_size: int, num_heads: int = 4, expand_k: float = 1.0,
                 expand_v: float = 1.0, proj_low_rank_dim: int = 32,
                 decay_low_rank_dim: int = 64, kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_mode not in ("auto", "chunk", "scan"):
            raise NotImplementedError(
                f"kernel_mode={kernel_mode!r} is not ported; the port has 'auto' "
                "(kernels on CUDA), 'chunk' (plain PyTorch) and 'scan' (plain PyTorch "
                "with the O(T) recurrence for the prefill)")
        d = hidden_size
        self.hidden_size, self.num_heads = d, num_heads
        self.key_dim, self.value_dim = int(d * expand_k), int(d * expand_v)
        self.head_k_dim = self.key_dim // num_heads
        self.head_v_dim = self.value_dim // num_heads
        self.proj_low_rank_dim = proj_low_rank_dim
        self.kernel_mode, self.dtype = kernel_mode, dtype
        self.x_maa = nn.Parameter(torch.zeros(d))
        self.maa = nn.Parameter(torch.zeros(5, d))
        self.maa_w1 = nn.Parameter(torch.empty(d, 5 * proj_low_rank_dim))
        self.maa_w2 = nn.Parameter(torch.empty(5, proj_low_rank_dim, d))
        dense = lambda o: Linear(d, o, bias=False, dtype=dtype)
        self.r_proj = dense(self.key_dim)
        self.k_proj = dense(self.key_dim)
        self.v_proj = dense(self.value_dim)
        self.g_proj = dense(self.value_dim)
        self.o_proj = Linear(self.value_dim, d, bias=False, dtype=dtype)
        self.decay_w1 = nn.Parameter(torch.empty(d, decay_low_rank_dim))
        self.decay_w2 = nn.Parameter(torch.empty(decay_low_rank_dim, self.key_dim))
        self.time_decay = nn.Parameter(torch.full((self.key_dim,), -6.0))
        self.time_faaaa = nn.Parameter(torch.zeros(num_heads, self.head_k_dim))
        self.ln_x_scale = nn.Parameter(torch.ones(self.value_dim))
        self.ln_x_bias = nn.Parameter(torch.zeros(self.value_dim))

    def empty_state(self, batch_size: int, state_dtype=torch.float32, device=None) -> RWKV6State:
        return rwkv6_empty_state(batch_size, self.hidden_size, self.num_heads,
                                 self.key_dim / self.hidden_size,
                                 self.value_dim / self.hidden_size,
                                 state_dtype=state_dtype, device=device)

    def _kernels(self, state_dtype: torch.dtype) -> bool:
        """Whether this layer runs the CUDA wrappers (``kernel_mode="auto"``
        and heads the kernels take with this IO dtype and ``state_dtype``)
        or the plain versions."""
        return self.kernel_mode == "auto" and rwkv6_cuda.kernel_takes(
            self.head_k_dim, self.head_v_dim, self.dtype, state_dtype)

    # ---- pieces ----
    def _ddlerp(self, x: torch.Tensor, sx: torch.Tensor):
        """Data-dependent lerp -> [xw, xk, xv, xr, xg]."""
        xxx = x + sx * self.x_maa
        z = torch.tanh(_mm(xxx, self.maa_w1))
        z = z.reshape(*z.shape[:-1], 5, self.proj_low_rank_dim)
        dt = torch.promote_types(z.dtype, self.maa_w2.dtype)
        deltas = torch.einsum("...fp,fpd->...fd", z.to(dt), self.maa_w2.to(dt))
        mix = self.maa + deltas
        return [x + sx * mix[..., i, :] for i in range(5)]

    def _wrkvg(self, x: torch.Tensor, sx: torch.Tensor):
        xw, xk, xv, xr, xg = self._ddlerp(x, sx)
        r, k, v = self.r_proj(xr), self.k_proj(xk), self.v_proj(xv)
        g = F.silu(self.g_proj(xg))
        w_logit = self.time_decay + _mm(torch.tanh(_mm(xw.float(), self.decay_w1)), self.decay_w2)
        return r, k, v, g, -torch.exp(w_logit)  # log-decay <= 0, f32

    def _group_norm(self, o: torch.Tensor) -> torch.Tensor:
        """Per-head LayerNorm over the value channels (RWKV's ln_x
        GroupNorm): population variance, eps 1e-5, f32 statistics; the
        result in o's dtype."""
        shp = o.shape
        of = o.float().reshape(*shp[:-1], self.num_heads, shp[-1] // self.num_heads)
        mean = of.mean(-1, keepdim=True)
        var = of.var(-1, keepdim=True, correction=0)
        of = ((of - mean) * torch.rsqrt(var + 1e-5)).reshape(shp)
        return (of * self.ln_x_scale + self.ln_x_bias).to(o.dtype)

    def _heads(self, z: torch.Tensor, dh: int) -> torch.Tensor:
        b, t, _ = z.shape
        return z.reshape(b, t, self.num_heads, dh).transpose(1, 2).contiguous()

    # ---- full sequence ----
    def forward(self, x: torch.Tensor, initial_state: Optional[RWKV6State] = None,
                output_final_state: bool = False, conv_history: bool = False,
                reset_mask: Optional[torch.Tensor] = None, reset_val: float = -20.0):
        """x: (b, t, d) -> (b, t, d) [, RWKV6State if output_final_state].

        The one-token shift buffer is always consumed from ``initial_state``
        (zeros without one), so a chunk that continues a stream is exact
        with or without ``conv_history``, which is taken for the interface
        the GLA layers share. ``reset_mask`` ((b, t) bool) sets the
        log-decay to ``reset_val`` where it is True."""
        b, t, d = x.shape
        if initial_state is not None:
            prev = initial_state.shift[:, None]
        else:
            prev = torch.zeros(b, 1, d, dtype=x.dtype, device=x.device)
        cdt = torch.promote_types(prev.dtype, x.dtype)
        sx = torch.cat([prev.to(cdt), x[:, :-1].to(cdt)], dim=1) - x
        r, k, v, g, lw = self._wrkvg(x, sx)
        if reset_mask is not None:
            lw = lw.masked_fill(reset_mask[..., None], reset_val)
        dk, dv = self.head_k_dim, self.head_v_dim
        s0 = initial_state.s if initial_state is not None else None
        state_dtype = torch.float32 if s0 is None else s0.dtype
        if self.kernel_mode == "scan":
            fn = rwkv6_scan_ref
        else:
            fn = rwkv6_cuda.rwkv6_chunk if self._kernels(state_dtype) else \
                rwkv6_cuda.rwkv6_chunk_plain
        o, s_final = fn(self._heads(r, dk), self._heads(k, dk), self._heads(v, dv),
                        self._heads(lw, dk), self.time_faaaa.float(), initial_state=s0)
        o = o.transpose(1, 2).reshape(b, t, self.value_dim)
        out = self.o_proj(self._group_norm(o) * g)
        if output_final_state:
            return out, RWKV6State(s=s_final, shift=x[:, -1].contiguous())
        return out

    # ---- one decode token ----
    def step(self, x_t: torch.Tensor, state: RWKV6State, lazy_p: Optional[int] = None):
        """x_t: (b, d) one token -> (out (b, d), new state). On CUDA the
        kernel updates ``state.s`` in place. ``lazy_p`` must be None: RWKV6
        has no lazy-window decode."""
        if lazy_p is not None:
            raise TypeError("lazy decode unsupported for RWKV6State")
        b = x_t.shape[0]
        sx = state.shift - x_t
        r, k, v, g, lw = self._wrkvg(x_t, sx)
        h, dk, dv = self.num_heads, self.head_k_dim, self.head_v_dim
        fn = rwkv6_cuda.rwkv6_decode if self._kernels(state.s.dtype) else \
            rwkv6_cuda.rwkv6_decode_plain
        o, s = fn(r.reshape(b, h, dk), k.reshape(b, h, dk), v.reshape(b, h, dv),
                  lw.reshape(b, h, dk), self.time_faaaa.float(), state.s)
        out = self.o_proj(self._group_norm(o.reshape(b, self.value_dim)) * g)
        return out, RWKV6State(s=s, shift=x_t)

    def step_lazy(self, x_t: torch.Tensor, state: RWKV6State, p: int):
        return self.step(x_t, state, lazy_p=p)


class AttentiveRWKV6(EncoderCrossDecoder):
    """The attentive-RNN scaffold with RWKV6 mixer blocks (reference
    model/rwkv6.py:16-73), the blind cross-attention's pos_net included."""

    def __init__(self, d_model: int = 1024, n_layer: int = 12, heads: int = 4,
                 dropout: float = 0.0, d_blind: Optional[int] = None, blind: bool = False,
                 cross_att_pp: bool = False, rotary: bool = False,
                 pos_type: str = "sinusoidal", kernel_mode: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 state_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, n_layer, heads, dropout, d_blind, blind, cross_att_pp,
                         rotary, pos_type, dtype, state_dtype)
        self.kernel_mode = kernel_mode
        self._build()

    def _block(self, d: int) -> MixingBlock:
        return MixingBlock(d, RWKV6Attention(d, self.heads, kernel_mode=self.kernel_mode,
                                             dtype=self.dtype),
                           SwiGLU(d, dtype=self.dtype), dropout=self.dropout)

    def _layer_state(self, block: MixingBlock, batch_size: int, device) -> RWKV6State:
        return block.tmix.empty_state(batch_size, state_dtype=self.state_dtype, device=device)


@torch.no_grad()
def init_rwkv6_params_(layer: RWKV6Attention, generator: torch.Generator) -> None:
    """The JAX initializers of the raw parameters: ``maa_w*`` and
    ``decay_w*`` normal with std 1e-2, ``x_maa``, ``maa`` and ``time_faaaa``
    zero, ``time_decay`` -6, ``ln_x_scale`` one, ``ln_x_bias`` zero; the
    projections normal with std 1/sqrt(fan_in) (lecun)."""
    for p in (layer.maa_w1, layer.maa_w2, layer.decay_w1, layer.decay_w2):
        p.copy_(torch.randn(p.shape, generator=generator) * 1e-2)
    for p in (layer.x_maa, layer.maa, layer.time_faaaa, layer.ln_x_bias):
        p.zero_()
    layer.time_decay.fill_(-6.0)
    layer.ln_x_scale.fill_(1.0)
    for proj in (layer.r_proj, layer.k_proj, layer.v_proj, layer.g_proj, layer.o_proj):
        w = proj.weight
        w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)


@torch.no_grad()
def perturb_rwkv6_params_(model: nn.Module, generator: torch.Generator) -> None:
    """Move the parameters that initialize to constants off them, so that a
    check exercises the bonus, the ddlerp and distinct decays: ``time_faaaa``
    ~ N(0, 0.5), ``maa`` and ``x_maa`` ~ U(0, 1), ``time_decay`` ~ U(-8, 1),
    drawn on the CPU from ``generator`` for every RWKV6 layer of ``model``."""
    draw = lambda p, fn: p.copy_(fn(p.shape, generator=generator))
    for m in model.modules():
        if isinstance(m, RWKV6Attention):
            draw(m.time_faaaa, lambda s, generator: torch.randn(s, generator=generator) * 0.5)
            draw(m.maa, torch.rand)
            draw(m.x_maa, torch.rand)
            draw(m.time_decay, lambda s, generator: torch.rand(s, generator=generator) * 9 - 8)
