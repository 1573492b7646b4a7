"""Gated Linear Attention token-mixer layer (PyTorch port).

Counterpart of ``lina_speech_tpu/models/gla_layer.py`` (reference
model/gla.py:44-247): q/k/v/g projections, the log-decay gate
``gk = logsigmoid(W2 W1 x + b) / 16`` in f32 (or, with ``scalar_gate``, one
decay per head, ``logsigmoid(W x + b) / 16`` repeated over the head's key
channels: simple-GLA), optionally floored at ``clamp_min``, optional
width-4 depthwise causal short convs (one per projection, or with
``share_conv_kernel`` one on the hidden stream), RMSNorm-swish output gate.
Each path runs a wrapper of ``ops/gla_cuda.py`` -- the CUDA kernel for CUDA
tensors, its plain version for CPU tensors -- unless ``kernel_mode`` asks
for the plain versions on every device (``"chunk"``; ``"scan"`` also takes
the O(T) recurrence ``gla_scan_ref`` for the prefill) or the kernels do not
take the layer's heads (``gla_cuda.kernel_takes``: a head key dim outside
64/128/256 or a value dim that is no multiple of 32 goes to the plain
version, as the JAX layer takes XLA where its Pallas kernels do not fit):

- a prefill from the start of a stream, and the training forward, with
  per-projection convs: ``gla_chunk_conv`` (convs fused), differentiable on
  the card through its hand-written backward;
- every other prefill and training forward (a chunk that continues a stream
  with ``conv_history=True``, the convs then running here on the carried
  rings; the shared conv; no conv): ``gla_chunk``, differentiable on the
  card through its hand-written backward;
- a classic decode token (``step``): ``gla_decode_conv`` with per-projection
  convs, ``gla_decode`` otherwise (any batch size and state dtype: the TPU
  routing of tiny batches and f32 states to XLA follows from the TPU's
  block shape and VMEM budget and has no reason on the card);
- a lazy-window decode token (``step_lazy``): ``gla_decode_lazy_conv`` with
  per-projection convs, the state read only, and once per window
  ``gla_fold`` (``fold_lazy_state``); with an int8 base state
  (``state_quant="int8"``: ``GLAState.s`` int8 and its row scales in
  ``GLAState.s_scale``) the step passes ``s_scale`` and the fold is
  ``gla_fold_q``; an int4 one (``state_quant="int4"``: ``s`` int8 of last
  dim dv / 2, two nibbles a byte, told from int8 as in JAX by
  ``s.shape[-1] != vbuf.shape[-1]``) takes the int4 bodies of the same two
  kernels. Without per-projection convs the lazy step is the plain
  ``ops/gla.py:gla_decode_lazy_step`` (``_q``, ``_q4``) on every device, as
  in the JAX package (no TPU kernel exists for it); its fold keeps the
  kernels.

Context parallelism and the folded projection layout have no switch in the
port yet. The JAX layer merges q|k|v|g into one projection per
decode step; the port launches one per projection (column-independent, the
same numbers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import Linear
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.gla import (
    gla_decode_lazy_step, gla_decode_lazy_step_q, gla_decode_lazy_step_q4, gla_scan_ref,
    quantize_state_rows, quantize_state_rows_int4,
)
from lina_speech_tpu_torch.ops.short_conv import causal_depthwise_conv, short_conv_step


@dataclasses.dataclass
class GLAState:
    """Per-layer decode state: recurrent matrix + conv ring buffers."""

    s: torch.Tensor  # (b, h, dk, dv) in the state dtype
    conv_q: Optional[torch.Tensor] = None  # (w, b, key_dim) time-major ring
    conv_k: Optional[torch.Tensor] = None  # (w, b, key_dim)
    conv_v: Optional[torch.Tensor] = None  # (w, b, value_dim)
    conv_h: Optional[torch.Tensor] = None  # (w, b, hidden) with share_conv_kernel
    # lazy-window decode buffers (ops/gla.py:gla_decode_lazy_step), present
    # only in lazy mode; ``s`` is then the base state as of the last fold
    # (read only between folds)
    kbuf: Optional[torch.Tensor] = None  # (L, b, h, dk)
    vbuf: Optional[torch.Tensor] = None  # (L, b, h, dv)
    cbuf: Optional[torch.Tensor] = None  # (L, b, h, dk) f32 gate cumsums
    cc: Optional[torch.Tensor] = None    # (b, h, dk) f32 cumsum since fold
    # int8 / int4 state quantization (state_quant="int8" / "int4"): the f32
    # scale of each (b, h, dk) row; ``s`` is then int8
    # (ops/gla.py:quantize_state_rows), or int4 packed two a byte into an
    # int8 (b, h, dk, dv // 2) (ops/gla.py:quantize_state_rows_int4)
    s_scale: Optional[torch.Tensor] = None


def check_state_quant(state_quant: Optional[str]) -> None:
    """``None``, ``"int8"`` and ``"int4"``; anything else raises."""
    if state_quant not in (None, "int8", "int4"):
        raise ValueError(f"unknown state_quant {state_quant!r}")


def gla_add_lazy_buffers(state: GLAState, window: int,
                         dtype: torch.dtype = torch.bfloat16,
                         state_quant: Optional[str] = None) -> GLAState:
    """Attach zeroed lazy-decode window buffers sized from ``state.s``.

    ``state_quant="int8"`` also row-quantizes the base state: decode at
    many slots reads every state once per token, and int8 halves those
    bytes (an opt-in quality knob; the scale rides the readout's query).
    ``"int4"`` quarters them: two values a byte along the value dim's
    halves, ``s`` then (b, h, dk, dv // 2) int8 (the fold and the step
    tell it from int8 by that width)."""
    check_state_quant(state_quant)
    b, h, dk, dv = state.s.shape
    dev = state.s.device
    state = dataclasses.replace(
        state,
        kbuf=torch.zeros(window, b, h, dk, dtype=dtype, device=dev),
        vbuf=torch.zeros(window, b, h, dv, dtype=dtype, device=dev),
        cbuf=torch.zeros(window, b, h, dk, dtype=torch.float32, device=dev),
        cc=torch.zeros(b, h, dk, dtype=torch.float32, device=dev))
    if state_quant is not None:
        quantize = quantize_state_rows if state_quant == "int8" else quantize_state_rows_int4
        s_q, sc = quantize(state.s)
        state = dataclasses.replace(state, s=s_q, s_scale=sc)
    return state


def gla_fold_lazy_state(state: GLAState, plain: bool = False) -> GLAState:
    """Fold the buffered window into the base state and reset ``cc``.

    Call it on a FULL window only. The buffers stay stale on purpose (no
    zeroing writes): the lazy step masks slots ``> p`` and rewrites every
    slot before the next fold reads it. ``plain`` takes the plain version
    on every device; otherwise a CUDA state is folded in place by the
    ``gla_fold`` kernel, or an int8 or int4 one (``s_scale`` present), with
    its scales, by ``gla_fold_q`` -- or by the plain version where the
    kernels do not take its heads (``gla_cuda.kernel_takes``).
    """
    dk, dv = state.kbuf.shape[-1], state.vbuf.shape[-1]
    plain = plain or not gla_cuda.kernel_takes(dk, dv, state.kbuf.dtype, state.s.dtype)
    window = (state.kbuf, state.vbuf, state.cbuf, state.cc)
    if state.s_scale is not None:
        fold = gla_cuda.gla_fold_q_plain if plain else gla_cuda.gla_fold_q
        s, sc = fold(state.s, state.s_scale, *window)
        return dataclasses.replace(state, s=s, s_scale=sc, cc=torch.zeros_like(state.cc))
    fold = gla_cuda.gla_fold_plain if plain else gla_cuda.gla_fold
    s = fold(state.s, *window)
    return dataclasses.replace(state, s=s, cc=torch.zeros_like(state.cc))


def gla_empty_state(batch_size: int, hidden_size: int, num_heads: int,
                    expand_k: float = 1.0, expand_v: float = 2.0,
                    use_short_conv: bool = False, share_conv_kernel: bool = False,
                    conv_size: int = 4, dtype: torch.dtype = torch.float32,
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
    if share_conv_kernel:
        return GLAState(s=s, conv_h=z(hidden_size))
    return GLAState(s=s, conv_q=z(key_dim), conv_k=z(key_dim), conv_v=z(value_dim))


class ShortConvolution(nn.Module):
    """Depthwise causal conv taps, weight (dim, 1, size) as torch Conv1d
    (FLA ShortConvolution). The per-projection convs run inside the GLA
    kernels; the shared conv runs here (``ops/short_conv.py``), as in the
    JAX package."""

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
    """``scalar_gate=True`` gives the simple-GLA variant (reference
    model/simple_gla.py via FLA SimpleGatedLinearAttention): one decay per
    head per step instead of per key channel, repeated over the head's key
    channels before the kernels (they take it like any gate)."""

    def __init__(self, hidden_size: int = 1024, expand_k: float = 1.0,
                 expand_v: float = 2.0, num_heads: int = 4,
                 use_short_conv: bool = False, conv_size: int = 4,
                 share_conv_kernel: bool = False,
                 gate_logit_normalizer: int = 16, gate_low_rank_dim: int = 16,
                 clamp_min: Optional[float] = None,
                 layernorm_eps: float = 1e-5, chunk_size: int = 64,
                 scalar_gate: bool = False,
                 kernel_mode: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_mode not in ("auto", "chunk", "scan"):
            raise NotImplementedError(
                f"kernel_mode={kernel_mode!r} is not ported; the port has "
                "'auto' (kernels on CUDA), 'chunk' (plain PyTorch) and 'scan' "
                "(plain PyTorch with the O(T) recurrence for the prefill)")
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.key_dim = int(hidden_size * expand_k)
        self.value_dim = int(hidden_size * expand_v)
        self.head_qk_dim = self.key_dim // num_heads
        self.head_v_dim = self.value_dim // num_heads
        self.expand_k, self.expand_v = expand_k, expand_v
        self.use_short_conv, self.conv_size = use_short_conv, conv_size
        self.share_conv_kernel = share_conv_kernel
        self.gate_logit_normalizer, self.clamp_min = gate_logit_normalizer, clamp_min
        self.scalar_gate = scalar_gate
        self.chunk_size, self.kernel_mode, self.dtype = chunk_size, kernel_mode, dtype

        dense = lambda i, o, bias=False: Linear(i, o, bias=bias, dtype=dtype)
        self.q_proj = dense(hidden_size, self.key_dim)
        self.k_proj = dense(hidden_size, self.key_dim)
        self.v_proj = dense(hidden_size, self.value_dim)
        self.g_proj = dense(hidden_size, self.value_dim)
        if scalar_gate:
            self.gk_proj = dense(hidden_size, num_heads, True)
        else:
            self.gk_proj = nn.ModuleList([dense(hidden_size, gate_low_rank_dim),
                                          dense(gate_low_rank_dim, self.key_dim, True)])
        self.o_proj = dense(self.value_dim, hidden_size)
        self.g_norm_swish_gate = RMSNormSwishGate(self.head_v_dim, layernorm_eps)
        if use_short_conv and share_conv_kernel:
            self.h_conv1d = ShortConvolution(hidden_size, conv_size)
        elif use_short_conv:
            self.q_conv1d = ShortConvolution(self.key_dim, conv_size)
            self.k_conv1d = ShortConvolution(self.key_dim, conv_size)
            self.v_conv1d = ShortConvolution(self.value_dim, conv_size)

    @property
    def _conv_per_projection(self) -> bool:
        return self.use_short_conv and not self.share_conv_kernel

    # ---------- kernels ----------
    def _kernel(self, name: str, state_dtype: torch.dtype):
        """The wrapper ``ops.gla_cuda.<name>``, or its plain version under
        ``kernel_mode`` "chunk" / "scan" or for heads the kernels do not
        take with this layer's IO dtype and ``state_dtype``."""
        takes = gla_cuda.kernel_takes(self.head_qk_dim, self.head_v_dim, self.dtype, state_dtype)
        if self.kernel_mode != "auto" or not takes:
            name += "_plain"
        return getattr(gla_cuda, name)

    # ---------- state ----------
    def empty_state(self, batch_size: int, state_dtype=torch.float32,
                    device=None) -> GLAState:
        return gla_empty_state(batch_size, self.hidden_size, self.num_heads,
                               self.expand_k, self.expand_v, self.use_short_conv,
                               self.share_conv_kernel, self.conv_size, self.dtype,
                               state_dtype, device)

    # ---------- shared math ----------
    def _gates(self, x: torch.Tensor, reset_mask: Optional[torch.Tensor] = None,
               reset_val: float = -20.0) -> torch.Tensor:
        """Log-decay gates (..., key_dim) in f32; with ``scalar_gate`` the
        (..., heads) gate repeated head-major over each head's key channels
        (JAX ``jnp.repeat``)."""
        if self.scalar_gate:
            g = self.gk_proj(x)
            gk = F.logsigmoid(g.float()) / self.gate_logit_normalizer
            gk = gk[..., None].expand(*gk.shape, self.head_qk_dim).flatten(-2)
        else:
            g = self.gk_proj[1](self.gk_proj[0](x))
            gk = F.logsigmoid(g.float()) / self.gate_logit_normalizer
        if self.clamp_min is not None:
            gk = gk.clamp(min=self.clamp_min)
        if reset_mask is not None:
            # reset_mask broadcasts over the gate feature dim (gla.py:182-184)
            gk = gk.masked_fill(reset_mask[..., None], reset_val)
        return gk

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
                output_final_state: bool = False, conv_history: bool = False,
                reset_mask: Optional[torch.Tensor] = None, reset_val: float = -20.0):
        """x: (b, t, d) -> (b, t, d) [, GLAState if output_final_state].

        By default the conv rings are zero at sequence start (causal
        padding) and ``initial_state.s`` seeds the recurrence (generation
        prefill, initial-state tuning). ``reset_mask`` ((b, t) bool) sets
        the log-gates to ``reset_val`` where it is True, which wipes the
        state at the first token of each packed segment.
        ``conv_history=True`` also consumes ``initial_state``'s conv rings
        as the causal history of this chunk: an exact continuation of a
        stream (serving prefills a prompt as a few power-of-two chunks).
        With the shared conv the gates and the output gate read the conv's
        output, as the reference rebinds the hidden stream (gla.py:150).
        """
        use_hist = conv_history and self.use_short_conv
        if use_hist and initial_state is None:
            raise ValueError("conv_history=True requires initial_state")
        s0 = initial_state.s if initial_state is not None else None
        state_dtype = torch.float32 if s0 is None else s0.dtype
        w = self.conv_size

        def conv(mod, z, ring):
            # the conv outside the kernels; on a continued stream the ring
            # (w, b, dim) holds the last w conv inputs, newest last, and
            # this chunk's first token needs the last w - 1 of them
            if not use_hist:
                return causal_depthwise_conv(z, mod.taps(self.dtype))
            full = torch.cat([ring[1:].transpose(0, 1).to(z.dtype), z], dim=1)
            return causal_depthwise_conv(full, mod.taps(self.dtype))[:, w - 1:]

        h = x
        if self.use_short_conv and self.share_conv_kernel:
            h = conv(self.h_conv1d, x, initial_state.conv_h if use_hist else None)
        q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        gh = self._heads(self._gates(h, reset_mask, reset_val), self.head_qk_dim)
        if self._conv_per_projection and not use_hist and self.kernel_mode != "scan":
            o, s_final = self._kernel("gla_chunk_conv", state_dtype)(
                self._heads(q, self.head_qk_dim), self._heads(k, self.head_qk_dim),
                self._heads(v, self.head_v_dim), gh,
                self.q_conv1d.taps(self.dtype), self.k_conv1d.taps(self.dtype),
                self.v_conv1d.taps(self.dtype), initial_state=s0,
                chunk_size=self.chunk_size)
        else:
            qc, kc, vc = q, k, v
            if self._conv_per_projection:
                rings = ((initial_state.conv_q, initial_state.conv_k, initial_state.conv_v)
                         if use_hist else (None,) * 3)
                qc, kc, vc = (conv(mod, z, ring) for mod, z, ring in zip(
                    (self.q_conv1d, self.k_conv1d, self.v_conv1d), (q, k, v), rings))
            args = (self._heads(qc, self.head_qk_dim), self._heads(kc, self.head_qk_dim),
                    self._heads(vc, self.head_v_dim), gh)
            if self.kernel_mode == "scan":
                o, s_final = gla_scan_ref(*args, initial_state=s0)
            else:
                o, s_final = self._kernel("gla_chunk", state_dtype)(
                    *args, initial_state=s0, chunk_size=self.chunk_size)
        out = self._output(o, h)
        if not output_final_state:
            return out
        state = GLAState(s=s_final)
        if self.use_short_conv:

            def tail(z, ring):
                # new ring = the last w conv inputs: a chunk shorter than w
                # keeps the tail of the incoming history when it continues
                # a stream, and is zero-padded on the left otherwise
                if use_hist:
                    z = torch.cat([ring.transpose(0, 1).to(z.dtype), z], dim=1)
                else:
                    z = F.pad(z, (0, 0, max(0, w - z.shape[1]), 0))
                return z[:, -w:, :].transpose(0, 1).contiguous()

            if self.share_conv_kernel:
                state = GLAState(s=s_final, conv_h=tail(
                    x, initial_state.conv_h if use_hist else None))
            else:
                rq, rk, rv = ((initial_state.conv_q, initial_state.conv_k,
                               initial_state.conv_v) if use_hist else (None,) * 3)
                state = GLAState(s=s_final, conv_q=tail(q, rq), conv_k=tail(k, rk),
                                 conv_v=tail(v, rv))
        return out, state

    def fold_lazy_state(self, state: GLAState) -> GLAState:
        """:func:`gla_fold_lazy_state` through this layer's ``kernel_mode``."""
        return gla_fold_lazy_state(state, plain=self.kernel_mode != "auto")

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
        on CUDA with per-projection convs -- and the caller folds once per
        full window (:meth:`fold_lazy_state`)."""
        return self._step(x_t, state, p)

    def _step(self, x_t, state: GLAState, lazy_p: Optional[int]):
        b = x_t.shape[0]
        h, dk, dv = self.num_heads, self.head_qk_dim, self.head_v_dim
        lazy = lazy_p is not None
        window = (state.kbuf, state.vbuf, state.cbuf, state.cc)
        rings = {}
        h_t = x_t
        if self.use_short_conv and self.share_conv_kernel:
            h_t, rings["conv_h"] = short_conv_step(x_t, state.conv_h,
                                                   self.h_conv1d.taps(self.dtype))
        qp, kp, vp, gp = (self.q_proj(h_t), self.k_proj(h_t),
                          self.v_proj(h_t), self.g_proj(h_t))
        gk = self._gates(h_t).reshape(b, h, dk)
        hsplit = lambda z, d: z.reshape(b, h, d)
        if self._conv_per_projection:
            w = self.conv_size
            # taps (dim, w) -> (w, h, head_dim), tap 0 oldest
            tsplit = lambda m, d: m.taps(self.dtype).reshape(h, d, w).permute(2, 0, 1).contiguous()
            csplit = lambda z, d: z.reshape(w, b, h, d)
            args = (hsplit(qp, dk), hsplit(kp, dk), hsplit(vp, dv), gk,
                    tsplit(self.q_conv1d, dk), tsplit(self.k_conv1d, dk),
                    tsplit(self.v_conv1d, dv), csplit(state.conv_q, dk),
                    csplit(state.conv_k, dk), csplit(state.conv_v, dv), state.s)
            if lazy:
                o, cq, ck, cv, *window = self._kernel("gla_decode_lazy_conv", state.s.dtype)(
                    *args, *window, lazy_p, s_scale=state.s_scale)
                s = state.s
            else:
                o, s, cq, ck, cv = self._kernel("gla_decode_conv", state.s.dtype)(*args)
            merge = lambda z: z.reshape(w, b, -1)
            rings = dict(conv_q=merge(cq), conv_k=merge(ck), conv_v=merge(cv))
        else:
            qkvg = (hsplit(qp, dk), hsplit(kp, dk), hsplit(vp, dv), gk)
            if lazy and state.s_scale is not None:
                int4 = gla_cuda.is_int4(state.s, state.vbuf)
                step = gla_decode_lazy_step_q4 if int4 else gla_decode_lazy_step_q
                o, *window = step(*qkvg, state.s, state.s_scale, *window, lazy_p)
                s = state.s
            elif lazy:
                o, *window = gla_decode_lazy_step(*qkvg, state.s, *window, lazy_p)
                s = state.s
            else:
                o, s = self._kernel("gla_decode", state.s.dtype)(*qkvg, state.s)
        kbuf, vbuf, cbuf, cc = window
        state = GLAState(s=s, kbuf=kbuf, vbuf=vbuf, cbuf=cbuf, cc=cc,
                         s_scale=state.s_scale, **rings)
        out = self._output(o[:, :, None, :], h_t[:, None, :], g=gp[:, None])[:, 0]
        return out, state
