"""Int8 weight-streaming linear layers of the decode loop: CUDA wrappers and
their plain versions.

- :func:`int8_linear` replaces ``int8_linear`` (lina_speech_tpu/ops/
  qlinear.py:127; bodies ``_qlin_kernel`` :54 and ``_qlin_kernel_i8`` :64):
  ``x @ dequant(q, s)`` with the weight read as int8. Kernel:
  ``csrc/int8_linear.cu``. Two modes: ``"wonly"`` (activations rounded to
  bf16, f32 accumulation, the per-channel scale in the epilogue) and
  ``"w8a8"`` (each activation row quantized to int8 on the fly, int8 x int8
  products summed in int32, then ``* sx * s``).
- :func:`fused_ffn_int8` replaces ``fused_ffn_int8`` (qlinear.py:241, body
  ``_ffn_kernel`` :156): a whole SwiGLU FFN over int8 weights whose hidden
  activation never reaches device memory. Kernel: ``csrc/fused_ffn_int8.cu``.

Weight layout. PyTorch's ``(out, in)`` with the contraction axis contiguous
is what a one-warp-per-output-channel kernel wants, so the int8 weight is
held as ``(N, Kp)``: ``Kp`` is ``K`` rounded up to a multiple of 16 with
zeros beyond ``K`` (:func:`pack_int8_weight`, once, at quantization time), so
that every row starts on a 16-byte boundary. ``K`` is read from ``x``. The
fused FFN takes its second weight hidden-major, ``(H, d)``, so that a block
that owns a few hidden units reads whole contiguous rows of it.

Each wrapper runs its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises; there is no fallback. Each counts its launches
in a plain int attribute and notes the shapes it was launched on
(:func:`launch_shapes`), so that a check that drives a path can hold the
kernels at exactly those shapes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.ops import _build

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODES = ("wonly", "w8a8")
_FFN_CHUNK = 16  # hidden units per block of the fused FFN (kChunk in the source)


def _wrappers():
    return (int8_linear, fused_ffn_int8)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
        fn.shapes = set()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What each wrapper was launched on since the last reset:
    ``int8_linear``: (m, K, N, mode, x dtype, out dtype);
    ``fused_ffn_int8``: (m, d, hidden, x dtype, out dtype)."""
    return {fn.__name__: set(fn.shapes) for fn in _wrappers()}


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def pack_int8_weight(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 -> (N, Kp) int8, Kp = K rounded up to a multiple of 16,
    zeros beyond K: the row stride the kernels' 16-byte loads need."""
    pad = (-q.shape[-1]) % 16
    return F.pad(q, (0, pad)).contiguous() if pad else q.contiguous()


def quantize_rows(x: torch.Tensor):
    """Dynamic symmetric int8 quantization of each row of ``x`` (..., K):
    ``sx = max(max|x|, 1e-12) / 127``, ``xq = clip(round(x / sx), +-127)``.
    Returns (xq int8, sx f32 (..., 1))."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


# ------------------------------------------------------------- int8 linear
def int8_linear_plain(x, q, s, *, out_dtype=torch.bfloat16, mode: str = "wonly"):
    """Plain version of :func:`int8_linear` (same signature), the
    counterpart of ``int8_linear_ref``. The w8a8 sum is taken in float64,
    which holds it exactly (|sum| <= 127 * 127 * K)."""
    _check("int8_linear", mode in _MODES, f"mode {mode!r} not in {_MODES}")
    k = x.shape[-1]
    qk = q[:, :k]
    s2 = s.reshape(-1).float()
    if mode == "w8a8":
        xq, sx = quantize_rows(x)
        acc = (xq.double() @ qk.double().T).float()
        return (acc * sx * s2).to(out_dtype)
    acc = x.to(torch.bfloat16).float() @ qk.float().T
    return (acc * s2).to(out_dtype)


def int8_linear(x, q, s, *, out_dtype=torch.bfloat16, mode: str = "wonly"):
    """``x @ dequant(q, s).T`` with the int8 weight streamed as it is.

    x: (..., K) activations, f32 or bf16; q: (N, Kp) int8 with Kp >= K a
    multiple of 16 and zeros beyond K (:func:`pack_int8_weight`; for a K
    that is a multiple of 16 simply (N, K)); s: N per-output-channel scales
    (any shape with N elements), f32. Returns (..., N) in ``out_dtype``
    (f32 or bf16).
    """
    if not x.is_cuda:
        return int8_linear_plain(x, q, s, out_dtype=out_dtype, mode=mode)
    name = "int8_linear"
    _check(name, mode in _MODES, f"mode {mode!r} not in {_MODES}")
    k = x.shape[-1]
    n, kp = q.shape
    _check(name, q.dtype == torch.int8 and q.is_contiguous() and q.device == x.device,
           "q must be a contiguous int8 tensor on x's device")
    _check(name, kp % 16 == 0 and k <= kp < k + 16,
           f"q must be (N, {k} rounded up to a multiple of 16), got {tuple(q.shape)}")
    _check(name, x.dtype in _X_CODE and out_dtype in _X_CODE,
           f"x dtype {x.dtype} / out dtype {out_dtype} not in f32/bf16")
    s1 = s.reshape(-1)
    _check(name, s1.numel() == n and s1.dtype == torch.float32 and s1.is_contiguous()
           and s1.device == x.device, f"s must hold {n} contiguous f32 scales on x's device")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    _check(name, m >= 1, "needs at least one row")
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    xq = sx = None
    if mode == "w8a8":  # scratch of the row quantization pre-pass
        xq = torch.empty(m, kp, dtype=torch.int8, device=x.device)
        sx = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int8_linear_fwd(_ptr(x2), _ptr(q), _ptr(s1), _ptr(out), _ptr(xq), _ptr(sx),
                              m, k, kp, n, _X_CODE[x.dtype], _X_CODE[out_dtype],
                              _MODES.index(mode), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    int8_linear.launches += 1
    int8_linear.shapes.add((m, k, n, mode, x.dtype, out_dtype))
    return out.reshape(*x.shape[:-1], n)


int8_linear.launches, int8_linear.shapes = 0, set()


# --------------------------------------------------------- fused SwiGLU FFN
def fused_ffn_int8_plain(x, q_in, s_in, b_in, q_out, s_out, b_out, *,
                         out_dtype=torch.bfloat16):
    """Plain version of :func:`fused_ffn_int8` (same signature), with the
    rounding points of the TPU kernel's body: the bias joins g and h in f32,
    g is rounded to bf16, silu is taken in f32 and rounded to bf16, the
    product with bf16(h) is a bf16 product, and the second contraction
    accumulates in f32."""
    bf = torch.bfloat16
    d = x.shape[-1]
    hidden = q_out.shape[0]
    xb = x.reshape(-1, d).to(bf).float()
    gh = (xb @ q_in[:, :d].float().T) * s_in.reshape(-1).float()
    if b_in is not None:
        gh = gh + b_in.reshape(-1).float()
    g, h = gh[:, :hidden], gh[:, hidden:]
    g_bf = g.to(bf).float()
    u = (g_bf * (1.0 / (1.0 + torch.exp(-g_bf)))).to(bf) * h.to(bf)
    y = (u.float() @ q_out.float()) * s_out.reshape(-1).float()
    if b_out is not None:
        y = y + b_out.reshape(-1).float()
    return y.to(out_dtype).reshape(*x.shape[:-1], q_out.shape[1])


def fused_ffn_int8(x, q_in, s_in, b_in, q_out, s_out, b_out, *,
                   out_dtype=torch.bfloat16):
    """SwiGLU FFN over int8 weights in one call: ``(silu(g) * h) @
    dequant(q_out) + b_out`` with ``g, h = split(x @ dequant(q_in).T + b_in)``,
    gate first.

    x: (..., d), f32 or bf16, d a multiple of 16; q_in: (2H, d) int8 (rows
    0..H-1 the gate, H..2H-1 the values); s_in: 2H f32 scales; b_in: 2H
    biases in any float dtype or None; q_out: (H, d) int8, HIDDEN-MAJOR
    (the transpose of a Linear's (d, H) weight); s_out: d f32 scales; b_out:
    d biases or None. Returns (..., d) in ``out_dtype``.

    On CUDA one call launches the two kernels of ``csrc/fused_ffn_int8.cu``
    (the per-chunk FFN, then the fixed-order sum of its parts) and counts
    as one launch; its scratch (ceil(H / 16) * m * d f32 values) is freed
    when the call returns.
    """
    if not x.is_cuda:
        return fused_ffn_int8_plain(x, q_in, s_in, b_in, q_out, s_out, b_out,
                                    out_dtype=out_dtype)
    name = "fused_ffn_int8"
    d = x.shape[-1]
    hidden = q_out.shape[0]
    dev = x.device
    _check(name, d % 16 == 0, f"model width {d} must be a multiple of 16")
    _check(name, x.dtype in _X_CODE and out_dtype in _X_CODE,
           f"x dtype {x.dtype} / out dtype {out_dtype} not in f32/bf16")
    for t, shape, what in ((q_in, (2 * hidden, d), "q_in"), (q_out, (hidden, d), "q_out")):
        _check(name, t.dtype == torch.int8 and tuple(t.shape) == shape and t.is_contiguous()
               and t.device == dev, f"{what} must be contiguous int8 {shape} on x's device")
    s_in, s_out = s_in.reshape(-1), s_out.reshape(-1)
    for t, n_el, what in ((s_in, 2 * hidden, "s_in"), (s_out, d, "s_out")):
        _check(name, t.numel() == n_el and t.dtype == torch.float32 and t.is_contiguous()
               and t.device == dev, f"{what} must hold {n_el} contiguous f32 scales")
    # the biases are read as f32 (2H + d values: a copy of a few KB)
    b_in = None if b_in is None else b_in.reshape(-1).float().contiguous()
    b_out = None if b_out is None else b_out.reshape(-1).float().contiguous()
    _check(name, b_in is None or (b_in.numel() == 2 * hidden and b_in.device == dev),
           "b_in size or device")
    _check(name, b_out is None or (b_out.numel() == d and b_out.device == dev),
           "b_out size or device")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    _check(name, m >= 1, "needs at least one row")
    n_chunks = -(-hidden // _FFN_CHUNK)
    parts = torch.empty(n_chunks, m, d, dtype=torch.float32, device=dev)
    out = torch.empty(m, d, dtype=out_dtype, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_ffn_int8_fwd(_ptr(x2), _ptr(q_in), _ptr(s_in), _ptr(b_in), _ptr(q_out),
                                 _ptr(s_out), _ptr(b_out), _ptr(parts), _ptr(out), m, d,
                                 hidden, _X_CODE[x.dtype], _X_CODE[out_dtype],
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    fused_ffn_int8.launches += 1
    fused_ffn_int8.shapes.add((m, d, hidden, x.dtype, out_dtype))
    return out.reshape(*x.shape[:-1], d)


fused_ffn_int8.launches, fused_ffn_int8.shapes = 0, set()
