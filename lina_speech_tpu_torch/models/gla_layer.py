"""Gated Linear Attention token-mixer layer (PyTorch port).

Counterpart of ``lina_speech_tpu/models/gla_layer.py`` (reference
model/gla.py:44-247) for the flagship's form of the layer: q/k/v/g
projections, low-rank log-decay gate ``gk = logsigmoid(W2 W1 x + b) / 16``
in f32, width-4 depthwise causal short convs on q/k/v, RMSNorm-swish output
gate. Each path runs a wrapper of ``ops/gla_cuda.py`` -- the CUDA kernel
for CUDA tensors, its plain version for CPU tensors -- unless
``kernel_mode="chunk"`` asks for the plain versions on every device:

- a prefill from the start of a stream: ``gla_chunk_conv`` (convs fused);
- a prefill chunk that continues a stream (``conv_history=True``): the
  convs run here on the carried rings, then ``gla_chunk``;
- a classic decode token (``step``): ``gla_decode_conv``;
- a lazy-window decode token (``step_lazy``): ``gla_decode_lazy_conv``, the
  state read only, and once per window ``gla_fold`` (``fold_lazy_state``).

A layer without short convs prefills through ``gla_chunk`` too, but its
decode steps run the plain ``gla_decode_step`` / ``gla_decode_lazy_step``
on the CPU only: their kernel (``gla_decode_fused``) is not ported yet, so
on CUDA they raise. Context parallelism, the scalar gate, the shared conv,
quantized states and the folded projection layout have no switch in the
port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import Linear
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.gla import gla_decode_lazy_step, gla_decode_step
from lina_speech_tpu_torch.ops.short_conv import causal_depthwise_conv


@dataclasses.dataclass
class GLAState:
    """Per-layer decode state: recurrent matrix + conv ring buffers."""

    s: torch.Tensor  # (b, h, dk, dv) in the state dtype
    conv_q: Optional[torch.Tensor] = None  # (w, b, key_dim) time-major ring
    conv_k: Optional[torch.Tensor] = None  # (w, b, key_dim)
    conv_v: Optional[torch.Tensor] = None  # (w, b, value_dim)
    # lazy-window decode buffers (ops/gla.py:gla_decode_lazy_step), present
    # only in lazy mode; ``s`` is then the base state as of the last fold
    # (read only between folds)
    kbuf: Optional[torch.Tensor] = None  # (L, b, h, dk)
    vbuf: Optional[torch.Tensor] = None  # (L, b, h, dv)
    cbuf: Optional[torch.Tensor] = None  # (L, b, h, dk) f32 gate cumsums
    cc: Optional[torch.Tensor] = None    # (b, h, dk) f32 cumsum since fold


def gla_add_lazy_buffers(state: GLAState, window: int,
                         dtype: torch.dtype = torch.bfloat16) -> GLAState:
    """Attach zeroed lazy-decode window buffers sized from ``state.s``."""
    b, h, dk, dv = state.s.shape
    dev = state.s.device
    return dataclasses.replace(
        state,
        kbuf=torch.zeros(window, b, h, dk, dtype=dtype, device=dev),
        vbuf=torch.zeros(window, b, h, dv, dtype=dtype, device=dev),
        cbuf=torch.zeros(window, b, h, dk, dtype=torch.float32, device=dev),
        cc=torch.zeros(b, h, dk, dtype=torch.float32, device=dev))


def gla_fold_lazy_state(state: GLAState, plain: bool = False) -> GLAState:
    """Fold the buffered window into the base state and reset ``cc``.

    Call it on a FULL window only. The buffers stay stale on purpose (no
    zeroing writes): the lazy step masks slots ``> p`` and rewrites every
    slot before the next fold reads it. ``plain`` takes the plain version
    on every device; otherwise a CUDA state is folded in place by the
    ``gla_fold`` kernel.
    """
    fold = gla_cuda.gla_fold_plain if plain else gla_cuda.gla_fold
    s = fold(state.s, state.kbuf, state.vbuf, state.cbuf, state.cc)
    return dataclasses.replace(state, s=s, cc=torch.zeros_like(state.cc))


def gla_empty_state(batch_size: int, hidden_size: int, num_heads: int,
                    expand_k: float = 1.0, expand_v: float = 2.0,
                    use_short_conv: bool = False, conv_size: int = 4,
                    dtype: torch.dtype = torch.float32,
                    state_dtype: torch.dtype = torch.float32,
                    device=None) -> GLAState:
    """Zero decode state for one GLA layer (reference gla.py:229-240).

    Rings are zeros in the compute dtype ``dtype`` (the dtype the prefill
    leaves them in), so the decode kernel can start from an empty state.
    """
    key_dim = int(hidden_size * expand_k)
    value_dim = int(hidden_size * expand_v)
    s = torch.zeros(batch_size, num_heads, key_dim // num_heads,
                    value_dim // num_heads, dtype=state_dtype, device=device)
    if not use_short_conv:
        return GLAState(s=s)
    z = lambda d: torch.zeros(conv_size, batch_size, d, dtype=dtype, device=device)
    return GLAState(s=s, conv_q=z(key_dim), conv_k=z(key_dim), conv_v=z(value_dim))


class ShortConvolution(nn.Module):
    """Depthwise causal conv taps, weight (dim, 1, size) as torch Conv1d
    (FLA ShortConvolution); the conv itself runs inside the GLA kernels."""

    def __init__(self, dim: int, size: int = 4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, size))

    def taps(self, dtype: torch.dtype) -> torch.Tensor:
        """(dim, size) in ``dtype``, tap 0 oldest."""
        return self.weight[:, 0, :].to(dtype).contiguous()


class RMSNormSwishGate(nn.Module):
    """y = RMSNorm(x) * silu(g), per head-channel weight (FLA fused op)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(x.dtype) * F.silu(g)


class GatedLinearAttention(nn.Module):
    def __init__(self, hidden_size: int = 1024, expand_k: float = 1.0,
                 expand_v: float = 2.0, num_heads: int = 4,
                 use_short_conv: bool = False, conv_size: int = 4,
                 gate_logit_normalizer: int = 16, gate_low_rank_dim: int = 16,
                 layernorm_eps: float = 1e-5, chunk_size: int = 64,
                 kernel_mode: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_mode not in ("auto", "chunk"):
            raise NotImplementedError(
                f"kernel_mode={kernel_mode!r} is not ported; the port has "
                "'auto' (kernels on CUDA) and 'chunk' (plain PyTorch)")
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.key_dim = int(hidden_size * expand_k)
        self.value_dim = int(hidden_size * expand_v)
        self.head_qk_dim = self.key_dim // num_heads
        self.head_v_dim = self.value_dim // num_heads
        self.expand_k, self.expand_v = expand_k, expand_v
        self.use_short_conv, self.conv_size = use_short_conv, conv_size
        self.gate_logit_normalizer = gate_logit_normalizer
        self.chunk_size, self.kernel_mode, self.dtype = chunk_size, kernel_mode, dtype

        dense = lambda i, o, bias=False: Linear(i, o, bias=bias, dtype=dtype)
        self.q_proj = dense(hidden_size, self.key_dim)
        self.k_proj = dense(hidden_size, self.key_dim)
        self.v_proj = dense(hidden_size, self.value_dim)
        self.g_proj = dense(hidden_size, self.value_dim)
        self.gk_proj = nn.ModuleList([dense(hidden_size, gate_low_rank_dim),
                                      dense(gate_low_rank_dim, self.key_dim, True)])
        self.o_proj = dense(self.value_dim, hidden_size)
        self.g_norm_swish_gate = RMSNormSwishGate(self.head_v_dim, layernorm_eps)
        if use_short_conv:
            self.q_conv1d = ShortConvolution(self.key_dim, conv_size)
            self.k_conv1d = ShortConvolution(self.key_dim, conv_size)
            self.v_conv1d = ShortConvolution(self.value_dim, conv_size)

    # ---------- kernels ----------
    def _kernel(self, name: str):
        """The wrapper ``ops.gla_cuda.<name>``, or its plain version under
        ``kernel_mode="chunk"``."""
        if self.kernel_mode == "chunk":
            name += "_plain"
        return getattr(gla_cuda, name)

    def _no_conv_on_cpu(self, x: torch.Tensor) -> None:
        if x.is_cuda and self.kernel_mode != "chunk":
            raise NotImplementedError(
                "a GLA decode step without short convs needs the "
                "gla_decode_fused kernel, not ported yet (ROADMAP.md Queue 2)")

    # ---------- state ----------
    def empty_state(self, batch_size: int, state_dtype=torch.float32,
                    device=None) -> GLAState:
        return gla_empty_state(batch_size, self.hidden_size, self.num_heads,
                               self.expand_k, self.expand_v, self.use_short_conv,
                               self.conv_size, self.dtype, state_dtype, device)

    # ---------- shared math ----------
    def _gates(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gk_proj[1](self.gk_proj[0](x))
        return F.logsigmoid(g.float()) / self.gate_logit_normalizer

    def _heads(self, z: torch.Tensor, d: int) -> torch.Tensor:
        """(b, t, h*d) -> contiguous (b, h, t, d)."""
        b, t, _ = z.shape
        return z.reshape(b, t, self.num_heads, d).transpose(1, 2).contiguous()

    def _output(self, o_heads: torch.Tensor, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, t, dv = o_heads.shape
        o = o_heads.transpose(1, 2)
        g = (self.g_proj(x) if g is None else g).reshape(b, t, h, dv)
        o = self.g_norm_swish_gate(o, g)
        return self.o_proj(o.reshape(b, t, h * dv))

    # ---------- full sequence (prefill) ----------
    def forward(self, x: torch.Tensor, initial_state: Optional[GLAState] = None,
                output_final_state: bool = False, conv_history: bool = False):
        """x: (b, t, d) -> (b, t, d) [, GLAState if output_final_state].

        By default the conv rings are zero at sequence start (causal
        padding) and ``initial_state.s`` seeds the recurrence.
        ``conv_history=True`` also consumes ``initial_state``'s conv rings
        as the causal history of this chunk: an exact continuation of a
        stream (serving prefills a prompt as a few power-of-two chunks).
        """
        use_hist = conv_history and self.use_short_conv
        if use_hist and initial_state is None:
            raise ValueError("conv_history=True requires initial_state")
        s0 = initial_state.s if initial_state is not None else None
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        gh = self._heads(self._gates(x), self.head_qk_dim)
        if self.use_short_conv and not use_hist:
            o, s_final = self._kernel("gla_chunk_conv")(
                self._heads(q, self.head_qk_dim), self._heads(k, self.head_qk_dim),
                self._heads(v, self.head_v_dim), gh,
                self.q_conv1d.taps(self.dtype), self.k_conv1d.taps(self.dtype),
                self.v_conv1d.taps(self.dtype), initial_state=s0,
                chunk_size=self.chunk_size)
        else:
            qc, kc, vc = q, k, v
            if use_hist:
                w = self.conv_size

                def conv_hist(conv, z, ring):
                    # ring (w, b, dim) holds the last w conv inputs, newest
                    # last; this chunk's first token needs the last w - 1
                    full = torch.cat([ring[1:].transpose(0, 1).to(z.dtype), z], dim=1)
                    return causal_depthwise_conv(full, conv.taps(self.dtype))[:, w - 1:]

                qc = conv_hist(self.q_conv1d, q, initial_state.conv_q)
                kc = conv_hist(self.k_conv1d, k, initial_state.conv_k)
                vc = conv_hist(self.v_conv1d, v, initial_state.conv_v)
            o, s_final = self._kernel("gla_chunk")(
                self._heads(qc, self.head_qk_dim), self._heads(kc, self.head_qk_dim),
                self._heads(vc, self.head_v_dim), gh, initial_state=s0,
                chunk_size=self.chunk_size)
        out = self._output(o, x)
        if not output_final_state:
            return out
        state = GLAState(s=s_final)
        if self.use_short_conv:
            w = self.conv_size

            def tail(z, ring):
                # new ring = the last w conv inputs: a chunk shorter than w
                # keeps the tail of the incoming history when it continues
                # a stream, and is zero-padded on the left otherwise
                if use_hist:
                    z = torch.cat([ring.transpose(0, 1).to(z.dtype), z], dim=1)
                else:
                    z = F.pad(z, (0, 0, max(0, w - z.shape[1]), 0))
                return z[:, -w:, :].transpose(0, 1).contiguous()

            rq, rk, rv = ((initial_state.conv_q, initial_state.conv_k,
                           initial_state.conv_v) if use_hist else (None,) * 3)
            state = GLAState(s=s_final, conv_q=tail(q, rq), conv_k=tail(k, rk),
                             conv_v=tail(v, rv))
        return out, state

    def fold_lazy_state(self, state: GLAState) -> GLAState:
        """:func:`gla_fold_lazy_state` through this layer's ``kernel_mode``."""
        return gla_fold_lazy_state(state, plain=self.kernel_mode == "chunk")

    # ---------- single-token decode ----------
    def step(self, x_t: torch.Tensor, state: GLAState
             ) -> Tuple[torch.Tensor, GLAState]:
        """x_t: (b, d) one token -> (o_t (b, d), new state). On CUDA the
        kernel updates ``state.s`` in place."""
        return self._step(x_t, state, None)

    def step_lazy(self, x_t: torch.Tensor, state: GLAState, p: int
                  ) -> Tuple[torch.Tensor, GLAState]:
        """Lazy-window decode step: ``state.s`` is only read, the token
        lands in slot ``p`` (a host int) of the window buffers -- in place
        on CUDA -- and the caller folds once per full window
        (:meth:`fold_lazy_state`)."""
        return self._step(x_t, state, p)

    def _step(self, x_t, state: GLAState, lazy_p: Optional[int]):
        b = x_t.shape[0]
        h, dk, dv = self.num_heads, self.head_qk_dim, self.head_v_dim
        qp, kp, vp, gp = (self.q_proj(x_t), self.k_proj(x_t),
                          self.v_proj(x_t), self.g_proj(x_t))
        gk = self._gates(x_t).reshape(b, h, dk)
        hsplit = lambda z, d: z.reshape(b, h, d)
        lazy = lazy_p is not None
        window = (state.kbuf, state.vbuf, state.cbuf, state.cc)
        if self.use_short_conv:
            w = self.conv_size
            # taps (dim, w) -> (w, h, head_dim), tap 0 oldest
            tsplit = lambda m, d: m.taps(self.dtype).reshape(h, d, w).permute(2, 0, 1).contiguous()
            csplit = lambda z, d: z.reshape(w, b, h, d)
            args = (hsplit(qp, dk), hsplit(kp, dk), hsplit(vp, dv), gk,
                    tsplit(self.q_conv1d, dk), tsplit(self.k_conv1d, dk),
                    tsplit(self.v_conv1d, dv), csplit(state.conv_q, dk),
                    csplit(state.conv_k, dk), csplit(state.conv_v, dv), state.s)
            if lazy:
                o, cq, ck, cv, *window = self._kernel("gla_decode_lazy_conv")(
                    *args, *window, lazy_p)
                s = state.s
            else:
                o, s, cq, ck, cv = self._kernel("gla_decode_conv")(*args)
            merge = lambda z: z.reshape(w, b, -1)
            rings = dict(conv_q=merge(cq), conv_k=merge(ck), conv_v=merge(cv))
        else:
            self._no_conv_on_cpu(x_t)
            qkvg = (hsplit(qp, dk), hsplit(kp, dk), hsplit(vp, dv), gk)
            if lazy:
                o, *window = gla_decode_lazy_step(*qkvg, state.s, *window, lazy_p)
                s = state.s
            else:
                o, s = gla_decode_step(*qkvg, state.s)
            rings = {}
        kbuf, vbuf, cbuf, cc = window
        state = GLAState(s=s, kbuf=kbuf, vbuf=vbuf, cbuf=cbuf, cc=cc, **rings)
        out = self._output(o[:, :, None, :], x_t[:, None, :], g=gp[:, None])[:, 0]
        return out, state
