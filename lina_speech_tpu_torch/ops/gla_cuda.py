"""The GLA kernels of the generate and serving paths: CUDA wrappers and
their plain versions.

- :func:`gla_chunk_conv` replaces ``gla_chunk_conv_pallas``
  (lina_speech_tpu/ops/gla_pallas.py:1289), the prefill of every GLA layer
  with the q/k/v short convs fused in. Kernel: ``csrc/gla_chunk_conv.cu``.
- :func:`gla_chunk` replaces ``gla_chunk_pallas`` (gla_pallas.py:699), the
  same scan on post-conv q/k/v: the prefill chunks that continue a stream
  from carried conv rings. Kernel: ``csrc/gla_chunk.cu``.
- :func:`gla_decode_conv` replaces ``gla_decode_conv_fused``
  (gla_pallas.py:1641), one decode token with the conv ring updates fused
  in. Kernel: ``csrc/gla_decode_conv.cu``.
- :func:`gla_decode_lazy_conv` replaces ``gla_decode_lazy_conv_fused``
  (gla_pallas.py:2197), one lazy-window decode token: ring updates, append
  to the window buffers, readout from a read-only state. Kernel:
  ``csrc/gla_decode_lazy_conv.cu``.
- :func:`gla_fold` replaces ``gla_fold_fused`` (gla_pallas.py:2232), the
  fold of a full window into the state. Kernel: ``csrc/gla_fold.cu``.

Each wrapper takes the JAX function's arguments in the JAX layout. For a
CPU tensor it runs the plain PyTorch version (``*_plain``); for a CUDA
tensor it launches the kernel or raises -- there is no fallback. Each
counts its launches in a plain int attribute (``gla_chunk_conv.launches``).
The plain versions follow the Pallas kernels' conv rounding points: the f32
tap sum is rounded to the IO dtype before an f32 silu.

What bounds each kernel on the H100 and what its design does about it is
noted at the top of its ``.cu`` source.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.ops import _build
from lina_speech_tpu_torch.ops import gla as gla_ops

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CONV_WIDTH = 4
_DK_SUPPORTED = (64, 128, 256)
_BV = 32  # value columns per block (csrc/gla_common.cuh:kBV)


def _wrappers():
    return (gla_chunk_conv, gla_chunk, gla_decode_conv, gla_decode_lazy_conv,
            gla_fold)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_cuda_args(name, tensors, io_dtype, dk, dv, state_dtype):
    device = tensors[0].device
    for t in tensors:
        _check(name, t.device == device, f"all tensors must be on {device}")
        _check(name, t.is_contiguous(), "tensors must be contiguous")
    _check(name, io_dtype in _DTYPE_CODE, f"IO dtype {io_dtype} not in f32/bf16")
    _check(name, state_dtype in _DTYPE_CODE,
           f"state dtype {state_dtype} not in f32/bf16")
    _check(name, dk in _DK_SUPPORTED, f"head key dim {dk} not in {_DK_SUPPORTED}")
    _check(name, dv % _BV == 0, f"head value dim {dv} not a multiple of {_BV}")


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ------------------------------------------------------------ prefill kernel
def _silu_conv_rounded(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of (b, h, t, d) with taps (h, d, w), tap 0
    oldest: f32 tap sum, rounded to x's dtype, silu in f32 -> f32."""
    t, w = x.shape[2], taps.shape[-1]
    xp = F.pad(x.float(), (0, 0, w - 1, 0))
    tf = taps.float()
    z = 0.0
    for i in range(w):
        z = z + xp[:, :, i:i + t, :] * tf[None, :, None, :, i]
    zr = z.to(x.dtype).float()
    return zr * torch.sigmoid(zr)


def gla_chunk_conv_plain(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                         initial_state=None, scale=None, chunk_size: int = 64
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gla_chunk_conv` (same signature)."""
    b, h, t, dk = xq.shape
    dv = xv.shape[-1]
    w = conv_q_w.shape[-1]
    hs = lambda m, d: m.reshape(h, d, w)
    q = _silu_conv_rounded(xq, hs(conv_q_w, dk))
    k = _silu_conv_rounded(xk, hs(conv_k_w, dk))
    v = _silu_conv_rounded(xv, hs(conv_v_w, dv)).to(xv.dtype).float()
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    s0 = None if initial_state is None else initial_state.float()
    o, sf = gla_ops.gla_chunk(q, k, v, gk.float(), s0, scale=scale,
                              chunk_size=chunk_size)
    return o.to(xq.dtype), sf.to(state_dtype)


def gla_chunk_conv(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                   initial_state=None, scale=None, chunk_size: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA prefill with the q/k/v short convs fused in.

    xq, xk: (b, h, t, dk) and xv: (b, h, t, dv) PRE-conv projections in the
    IO dtype; gk: (b, h, t, dk) f32 log-gates; conv_*_w: (h * d, 4) taps in
    the IO dtype, tap 0 oldest, conv history zero at t = 0;
    initial_state: (b, h, dk, dv) or None (zeros, f32). Returns o (b, h, t,
    dv) in the IO dtype and the final state in the initial state's dtype.
    ``chunk_size`` shapes the plain version only; the kernel is recurrent.
    """
    if not xq.is_cuda:
        return gla_chunk_conv_plain(xq, xk, xv, gk, conv_q_w, conv_k_w,
                                    conv_v_w, initial_state, scale, chunk_size)
    name = "gla_chunk_conv"
    b, h, t, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    st = torch.float32 if initial_state is None else initial_state.dtype
    tensors = [xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w]
    if initial_state is not None:
        tensors.append(initial_state)
    _check_cuda_args(name, tensors, io, dk, dv, st)
    _check(name, xk.shape == xq.shape and xk.dtype == io, "xk must match xq")
    _check(name, xv.shape == (b, h, t, dv) and xv.dtype == io, "xv shape/dtype")
    _check(name, gk.shape == xq.shape and gk.dtype == torch.float32,
           "gk must be f32 of xq's shape")
    for wt, d in ((conv_q_w, dk), (conv_k_w, dk), (conv_v_w, dv)):
        _check(name, wt.shape == (h * d, _CONV_WIDTH) and wt.dtype == io,
               f"taps must be ({h * d}, {_CONV_WIDTH}) in {io}")
    if initial_state is not None:
        _check(name, initial_state.shape == (b, h, dk, dv), "state shape")
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, t, dv, dtype=io, device=xq.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=xq.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.gla_chunk_conv_fwd(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(conv_q_w), _ptr(conv_k_w),
        _ptr(conv_v_w), _ptr(initial_state), _ptr(o), _ptr(sf),
        b, h, t, dk, dv, float(scale), _DTYPE_CODE[io], _DTYPE_CODE[st],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_conv.launches += 1
    return o, sf


gla_chunk_conv.launches = 0


# ------------------------------------------------------------- decode kernel
def _ring_conv(x, taps, ring):
    """x (b, h, d); taps (w, h, d); ring (w, b, h, d) -> (f32 silu output,
    new ring): f32 tap sum, rounded to x's dtype, silu in f32."""
    new = torch.cat([ring[1:], x[None].to(ring.dtype)], dim=0)
    y = (new.float() * taps.float()[:, None]).sum(0)
    y = y.to(x.dtype).float()
    return y * torch.sigmoid(y), new


def gla_decode_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                          scale=None):
    """Plain version of :func:`gla_decode_conv` (same signature; returns
    new tensors and leaves ``state`` untouched)."""
    scale = xq.shape[-1] ** -0.5 if scale is None else scale
    q, cq2 = _ring_conv(xq, wq, cq)
    k, ck2 = _ring_conv(xk, wk, ck)
    v, cv2 = _ring_conv(xv, wv, cv)
    io = xq.dtype
    qf, kf, vf = (q.to(io).float() * scale, k.to(io).float(), v.to(io).float())
    s = gk.float().exp()[..., None] * state.float() + kf[..., None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", qf, s)
    return o.to(xq.dtype), s.to(state.dtype), cq2, ck2, cv2


def gla_decode_conv(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                    scale=None):
    """One GLA decode token with the q/k/v conv ring updates fused in.

    xq, xk: (b, h, dk) and xv: (b, h, dv) PRE-conv projections in the IO
    dtype; gk: (b, h, dk) f32 log-gates; wq, wk: (w, h, dk), wv: (w, h, dv)
    taps, tap 0 oldest; cq, ck: (w, b, h, dk), cv: (w, b, h, dv) time-major
    rings (index -1 newest) in the IO dtype; state (b, h, dk, dv).
    Returns (o (b, h, dv), state, cq, ck, cv).

    On CUDA the kernel updates ``state`` IN PLACE and returns the same
    tensor (as the JAX kernel aliases its state buffer); the rings come
    back as new tensors.
    """
    if not xq.is_cuda:
        return gla_decode_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv,
                                     state, scale)
    name = "gla_decode_conv"
    b, h, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    _check_cuda_args(name, [xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state],
                     io, dk, dv, state.dtype)
    _check(name, xk.shape == xq.shape and xk.dtype == io, "xk must match xq")
    _check(name, xv.shape == (b, h, dv) and xv.dtype == io, "xv shape/dtype")
    _check(name, gk.shape == xq.shape and gk.dtype == torch.float32,
           "gk must be f32 of xq's shape")
    for wt, ring, d in ((wq, cq, dk), (wk, ck, dk), (wv, cv, dv)):
        _check(name, wt.shape == (_CONV_WIDTH, h, d) and wt.dtype == io,
               f"taps must be ({_CONV_WIDTH}, {h}, {d}) in {io}")
        _check(name, ring.shape == (_CONV_WIDTH, b, h, d) and ring.dtype == io,
               f"rings must be ({_CONV_WIDTH}, {b}, {h}, {d}) in {io}")
    _check(name, state.shape == (b, h, dk, dv), "state shape")
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, dv, dtype=io, device=xq.device)
    cq2, ck2, cv2 = torch.empty_like(cq), torch.empty_like(ck), torch.empty_like(cv)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.gla_decode_conv_step(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(wq), _ptr(wk), _ptr(wv),
        _ptr(cq), _ptr(ck), _ptr(cv), _ptr(state), _ptr(o), _ptr(cq2),
        _ptr(ck2), _ptr(cv2), b, h, dk, dv, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[state.dtype], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_decode_conv.launches += 1
    return o, state, cq2, ck2, cv2


gla_decode_conv.launches = 0


# ------------------------------------------- prefill kernel, convs outside
def gla_chunk_plain(q, k, v, gk, initial_state=None, scale=None,
                    chunk_size: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gla_chunk` (same signature): the chunked
    scan of ``ops/gla.py`` on f32 operands, o rounded to the IO dtype and
    the final state to the initial state's dtype."""
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    s0 = None if initial_state is None else initial_state.float()
    o, sf = gla_ops.gla_chunk(q.float(), k.float(), v.float(), gk.float(), s0,
                              scale=scale, chunk_size=chunk_size)
    return o.to(q.dtype), sf.to(state_dtype)


def gla_chunk(q, k, v, gk, initial_state=None, scale=None, chunk_size: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA prefill on post-conv q, k, v.

    q, k: (b, h, t, dk) and v: (b, h, t, dv) in the IO dtype; gk: (b, h, t,
    dk) f32 log-gates; initial_state: (b, h, dk, dv) or None (zeros, f32).
    Returns o (b, h, t, dv) in the IO dtype and the final state in the
    initial state's dtype. ``chunk_size`` shapes the plain version only;
    the kernel is recurrent and takes any t >= 1.
    """
    if not q.is_cuda:
        return gla_chunk_plain(q, k, v, gk, initial_state, scale, chunk_size)
    name = "gla_chunk"
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    io = q.dtype
    st = torch.float32 if initial_state is None else initial_state.dtype
    tensors = [q, k, v, gk] + ([] if initial_state is None else [initial_state])
    _check_cuda_args(name, tensors, io, dk, dv, st)
    _check(name, t >= 1, "needs at least one step")
    _check(name, k.shape == q.shape and k.dtype == io, "k must match q")
    _check(name, v.shape == (b, h, t, dv) and v.dtype == io, "v shape/dtype")
    _check(name, gk.shape == q.shape and gk.dtype == torch.float32,
           "gk must be f32 of q's shape")
    if initial_state is not None:
        _check(name, initial_state.shape == (b, h, dk, dv), "state shape")
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, t, dv, dtype=io, device=q.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_chunk_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(initial_state), _ptr(o),
        _ptr(sf), b, h, t, dk, dv, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk.launches += 1
    return o, sf


gla_chunk.launches = 0


# -------------------------------------------------- lazy-window decode kernel
def gla_decode_lazy_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                               kbuf, vbuf, cbuf, cc, p: int, scale=None):
    """Plain version of :func:`gla_decode_lazy_conv` (same signature;
    returns new tensors and leaves every input untouched)."""
    q, cq2 = _ring_conv(xq, wq, cq)
    k, ck2 = _ring_conv(xk, wk, ck)
    v, cv2 = _ring_conv(xv, wv, cv)
    o, kbuf, vbuf, cbuf, cc = gla_ops.gla_decode_lazy_step(
        q, k.to(kbuf.dtype), v.to(vbuf.dtype), gk, state, kbuf, vbuf, cbuf, cc,
        p, scale=scale)
    return o.to(xq.dtype), cq2, ck2, cv2, kbuf, vbuf, cbuf, cc


def gla_decode_lazy_conv(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                         kbuf, vbuf, cbuf, cc, p: int, scale=None):
    """One lazy-window GLA decode token with the conv ring updates fused in.

    Arguments as :func:`gla_decode_conv`, plus the window buffers kbuf (L,
    b, h, dk) and vbuf (L, b, h, dv) in the IO dtype, cbuf (L, b, h, dk) and
    cc (b, h, dk) in f32, and the window position ``p`` (a host int, 0 <= p
    < L). ``state`` is only read. Slots ``j > p`` of the buffers may hold
    anything. Returns (o (b, h, dv), cq, ck, cv, kbuf, vbuf, cbuf, cc).

    On CUDA the kernel writes slot ``p`` of kbuf, vbuf and cbuf IN PLACE and
    returns the same tensors (as the JAX kernel aliases them); the rings
    and cc come back as new tensors.
    """
    if not xq.is_cuda:
        return gla_decode_lazy_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck,
                                          cv, state, kbuf, vbuf, cbuf, cc, p,
                                          scale)
    name = "gla_decode_lazy_conv"
    b, h, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    _check_cuda_args(name, [xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                            kbuf, vbuf, cbuf, cc], io, dk, dv, state.dtype)
    _check(name, xk.shape == xq.shape and xk.dtype == io, "xk must match xq")
    _check(name, xv.shape == (b, h, dv) and xv.dtype == io, "xv shape/dtype")
    _check(name, gk.shape == xq.shape and gk.dtype == torch.float32,
           "gk must be f32 of xq's shape")
    for wt, ring, d in ((wq, cq, dk), (wk, ck, dk), (wv, cv, dv)):
        _check(name, wt.shape == (_CONV_WIDTH, h, d) and wt.dtype == io,
               f"taps must be ({_CONV_WIDTH}, {h}, {d}) in {io}")
        _check(name, ring.shape == (_CONV_WIDTH, b, h, d) and ring.dtype == io,
               f"rings must be ({_CONV_WIDTH}, {b}, {h}, {d}) in {io}")
    _check(name, state.shape == (b, h, dk, dv), "state shape")
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, io)
    _check(name, isinstance(p, int) and 0 <= p < L,
           f"p must be an int in [0, {L}), got {p!r}")
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, dv, dtype=io, device=xq.device)
    cq2, ck2, cv2 = torch.empty_like(cq), torch.empty_like(ck), torch.empty_like(cv)
    cc2 = torch.empty_like(cc)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.gla_decode_lazy_conv_step(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(wq), _ptr(wk), _ptr(wv),
        _ptr(cq), _ptr(ck), _ptr(cv), _ptr(state), _ptr(kbuf), _ptr(vbuf),
        _ptr(cbuf), _ptr(cc), _ptr(o), _ptr(cq2), _ptr(ck2), _ptr(cv2),
        _ptr(cc2), b, h, dk, dv, L, p, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[state.dtype], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_decode_lazy_conv.launches += 1
    return o, cq2, ck2, cv2, kbuf, vbuf, cbuf, cc2


gla_decode_lazy_conv.launches = 0


def _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, buf_dtype) -> int:
    """Shapes and dtypes of the lazy window buffers; returns the window L."""
    L = kbuf.shape[0]
    _check(name, L >= 1 and kbuf.shape == (L, b, h, dk) and kbuf.dtype == buf_dtype,
           f"kbuf must be (L, {b}, {h}, {dk}) in {buf_dtype}")
    _check(name, vbuf.shape == (L, b, h, dv) and vbuf.dtype == buf_dtype,
           f"vbuf must be ({L}, {b}, {h}, {dv}) in {buf_dtype}")
    _check(name, cbuf.shape == (L, b, h, dk) and cbuf.dtype == torch.float32,
           f"cbuf must be ({L}, {b}, {h}, {dk}) in f32")
    _check(name, cc.shape == (b, h, dk) and cc.dtype == torch.float32,
           f"cc must be ({b}, {h}, {dk}) in f32")
    return L


# ------------------------------------------------------- window fold kernel
def gla_fold_plain(state, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """Plain version of :func:`gla_fold` (returns a new tensor)."""
    return gla_ops.gla_decode_lazy_fold(state, kbuf, vbuf, cbuf, cc)


def gla_fold(state, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """Fold a FULL lazy window into the recurrent state.

    state (b, h, dk, dv); kbuf (L, b, h, dk), vbuf (L, b, h, dv) in one
    float dtype; cbuf (L, b, h, dk) and cc (b, h, dk) in f32. Returns the
    new state; the buffers are left as they are (stale by contract) and the
    caller resets ``cc``. On CUDA the kernel updates ``state`` IN PLACE and
    returns the same tensor.
    """
    if not state.is_cuda:
        return gla_fold_plain(state, kbuf, vbuf, cbuf, cc)
    name = "gla_fold"
    b, h, dk, dv = state.shape
    _check_cuda_args(name, [state, kbuf, vbuf, cbuf, cc], kbuf.dtype, dk, dv,
                     state.dtype)
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, kbuf.dtype)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.gla_fold_window(
        _ptr(state), _ptr(kbuf), _ptr(vbuf), _ptr(cbuf), _ptr(cc), b, h, dk,
        dv, L, _DTYPE_CODE[kbuf.dtype], _DTYPE_CODE[state.dtype],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_fold.launches += 1
    return state


gla_fold.launches = 0
