"""Gated Linear Attention token-mixer layer (PyTorch port).

Counterpart of ``lina_speech_tpu/models/gla_layer.py`` (reference
model/gla.py:44-247) for the flagship's form of the layer: q/k/v/g
projections, low-rank log-decay gate ``gk = logsigmoid(W2 W1 x + b) / 16``
in f32, width-4 depthwise causal short convs on q/k/v, RMSNorm-swish output
gate. Prefill runs :func:`ops.gla_cuda.gla_chunk_conv` and each decode
token :func:`ops.gla_cuda.gla_decode_conv` -- the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors -- unless
``kernel_mode="chunk"`` asks for the plain versions on every device.

A layer without short convs runs the plain ``gla_chunk`` /
``gla_decode_step`` on the CPU only: its kernels (``gla_chunk_pallas``,
``gla_decode_fused``) are not ported yet, so on CUDA it raises. Not ported
here: lazy-window decode (``step_lazy``) and conv history raise if asked;
context parallelism, the scalar gate, the shared conv and the folded
projection layout have no switch in the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import Linear
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.gla import gla_chunk, gla_decode_step


@dataclasses.dataclass
class GLAState:
    """Per-layer decode state: recurrent matrix + conv ring buffers."""

    s: torch.Tensor  # (b, h, dk, dv) in the state dtype
    conv_q: Optional[torch.Tensor] = None  # (w, b, key_dim) time-major ring
    conv_k: Optional[torch.Tensor] = None  # (w, b, key_dim)
    conv_v: Optional[torch.Tensor] = None  # (w, b, value_dim)


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
    def _chunk_fn(self):
        return (gla_cuda.gla_chunk_conv_plain if self.kernel_mode == "chunk"
                else gla_cuda.gla_chunk_conv)

    def _decode_fn(self):
        return (gla_cuda.gla_decode_conv_plain if self.kernel_mode == "chunk"
                else gla_cuda.gla_decode_conv)

    def _no_conv_on_cpu(self, x: torch.Tensor) -> None:
        if x.is_cuda and self.kernel_mode != "chunk":
            raise NotImplementedError(
                "GLA without short convs needs the gla_chunk_pallas / "
                "gla_decode_fused kernels, not ported yet (ROADMAP.md Queue 2)")

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

        Conv rings are zero at sequence start (causal padding);
        ``initial_state.s`` seeds the recurrence.
        """
        if conv_history:
            raise NotImplementedError(
                "conv_history prefill needs gla_chunk_pallas, not ported yet "
                "(ROADMAP.md, next PRs item 1)")
        s0 = initial_state.s if initial_state is not None else None
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        gh = self._heads(self._gates(x), self.head_qk_dim)
        qh, kh = self._heads(q, self.head_qk_dim), self._heads(k, self.head_qk_dim)
        vh = self._heads(v, self.head_v_dim)
        if self.use_short_conv:
            o, s_final = self._chunk_fn()(
                qh, kh, vh, gh, self.q_conv1d.taps(self.dtype),
                self.k_conv1d.taps(self.dtype), self.v_conv1d.taps(self.dtype),
                initial_state=s0, chunk_size=self.chunk_size)
        else:
            self._no_conv_on_cpu(x)
            o, s_final = gla_chunk(qh, kh, vh, gh, s0, chunk_size=self.chunk_size)
        out = self._output(o, x)
        if not output_final_state:
            return out
        state = GLAState(s=s_final)
        if self.use_short_conv:
            w = self.conv_size

            def tail(z):
                # new ring = the last w conv inputs, zero-padded on the left
                # for a prompt shorter than w
                z = F.pad(z, (0, 0, max(0, w - z.shape[1]), 0))
                return z[:, -w:, :].transpose(0, 1).contiguous()

            state = GLAState(s=s_final, conv_q=tail(q), conv_k=tail(k),
                             conv_v=tail(v))
        return out, state

    def step_lazy(self, x_t, state, p):
        raise NotImplementedError(
            "lazy-window decode is not ported yet (ROADMAP.md, next PRs item 2)")

    # ---------- single-token decode ----------
    def step(self, x_t: torch.Tensor, state: GLAState
             ) -> Tuple[torch.Tensor, GLAState]:
        """x_t: (b, d) one token -> (o_t (b, d), new state). On CUDA the
        kernel updates ``state.s`` in place."""
        b = x_t.shape[0]
        h, dk, dv = self.num_heads, self.head_qk_dim, self.head_v_dim
        qp, kp, vp, gp = (self.q_proj(x_t), self.k_proj(x_t),
                          self.v_proj(x_t), self.g_proj(x_t))
        gk = self._gates(x_t).reshape(b, h, dk)
        hsplit = lambda z, d: z.reshape(b, h, d)
        if self.use_short_conv:
            w = self.conv_size
            # taps (dim, w) -> (w, h, head_dim), tap 0 oldest
            tsplit = lambda m, d: m.taps(self.dtype).reshape(h, d, w).permute(2, 0, 1).contiguous()
            csplit = lambda z, d: z.reshape(w, b, h, d)
            o, s, cq, ck, cv = self._decode_fn()(
                hsplit(qp, dk), hsplit(kp, dk), hsplit(vp, dv), gk,
                tsplit(self.q_conv1d, dk), tsplit(self.k_conv1d, dk),
                tsplit(self.v_conv1d, dv), csplit(state.conv_q, dk),
                csplit(state.conv_k, dk), csplit(state.conv_v, dv), state.s)
            merge = lambda z: z.reshape(w, b, -1)
            state = GLAState(s=s, conv_q=merge(cq), conv_k=merge(ck), conv_v=merge(cv))
        else:
            self._no_conv_on_cpu(x_t)
            o, s = gla_decode_step(hsplit(qp, dk), hsplit(kp, dk),
                                   hsplit(vp, dv), gk, state.s)
            state = GLAState(s=s)
        out = self._output(o[:, :, None, :], x_t[:, None, :], g=gp[:, None])[:, 0]
        return out, state
