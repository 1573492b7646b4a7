"""The GLA kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`gla_chunk_conv` replaces ``gla_chunk_conv_pallas``
  (lina_speech_tpu/ops/gla_pallas.py:1289), the prefill and the training
  forward of every GLA layer with the q/k/v short convs fused in. Kernel:
  ``csrc/gla_chunk_conv.cu``. It is differentiable: when autograd records,
  it runs through a ``torch.autograd.Function`` whose backward is
  :func:`gla_chunk_conv_bwd` (``csrc/gla_chunk_conv_bwd.cu``, replacing
  ``_conv_bwd_kernel``, gla_pallas.py:861). The plain backward is autograd
  through :func:`gla_chunk_conv_plain`.
- :func:`gla_chunk` replaces ``gla_chunk_pallas`` (gla_pallas.py:699), the
  same scan on post-conv q/k/v: the prefill chunks that continue a stream
  from carried conv rings, and the prefill and training of the layers
  without per-projection convs (simple-GLA, the shared conv, Mamba-2).
  Kernel: ``csrc/gla_chunk.cu``. It is differentiable: when autograd
  records, its backward is :func:`gla_chunk_bwd` (``csrc/gla_chunk_bwd.cu``,
  replacing ``_bwd_kernel``, gla_pallas.py:210).
- :func:`gla_decode_conv` replaces ``gla_decode_conv_fused``
  (gla_pallas.py:1641), one decode token with the conv ring updates fused
  in. Kernel: ``csrc/gla_decode_conv.cu``.
- :func:`gla_decode` replaces ``gla_decode_fused`` (gla_pallas.py:1709),
  one decode token on q/k/v as they are, the state updated in place.
  Kernel: ``csrc/gla_decode.cu``.
- :func:`gla_decode_lazy_conv` replaces ``gla_decode_lazy_conv_fused``
  (gla_pallas.py:2197), one lazy-window decode token: ring updates, append
  to the window buffers, readout from a read-only state, which may be int8
  with a row scale (``s_scale``). Kernel: ``csrc/gla_decode_lazy_conv.cu``.
- :func:`gla_fold` replaces ``gla_fold_fused`` (gla_pallas.py:2232), the
  fold of a full window into the state. Kernel: ``csrc/gla_fold.cu``.
- :func:`gla_fold_q` replaces ``gla_fold_fused_q`` (gla_pallas.py:2097), the
  same fold on an int8 state with a fresh requantization of every row.
  Kernel: ``csrc/gla_fold_q.cu``.

Each wrapper takes the JAX function's arguments in the JAX layout. For a
CPU tensor it runs the plain PyTorch version (``*_plain``); for a CUDA
tensor it launches the kernel or raises -- there is no fallback. Each
counts its launches in a plain int attribute (``gla_chunk_conv.launches``);
the training kernels and ``gla_decode`` also note the shapes they were
launched on (:func:`launch_shapes`). Which heads the kernels take is one
predicate, :func:`kernel_takes`: a layer asks it before it calls a wrapper
and takes the plain version for a head the kernels do not take, as the JAX
layer takes XLA where its Pallas kernels do not fit; a wrapper called on
such a head raises.
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
_INT8_CODE = 2  # a row-quantized state (the lazy step only)
_CONV_WIDTH = 4
_DK_SUPPORTED = (64, 128, 256)
_BV = 32  # value columns per block (csrc/gla_common.cuh:kBV)
_BWD_SEG = 64  # time steps per thread of the backward's finishing kernels (kFinishSeg)
_FOLD_Q_DV = (128, 256, 512)  # value widths the int8 fold kernel is built for


def _wrappers():
    return (gla_chunk_conv, gla_chunk_conv_bwd, gla_chunk, gla_chunk_bwd, gla_decode_conv,
            gla_decode, gla_decode_lazy_conv, gla_fold, gla_fold_q)


def _shape_noters():
    return (gla_chunk_conv, gla_chunk_conv_bwd, gla_chunk, gla_chunk_bwd, gla_decode)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
    gla_decode_lazy_conv.q_launches = 0
    for fn in _shape_noters():
        fn.shapes = set()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What the kernels that note their shapes were launched on since the
    last reset, a set of tuples each. ``gla_chunk_conv``: every launch as (b,
    t, dtype of the initial state or None); ``gla_chunk_conv_bwd``: the same
    with (need_ds0, need_taps) appended. ``gla_chunk``: every launch as (b,
    h, t, dk, dv, IO dtype, initial state dtype or None, scale);
    ``gla_chunk_bwd``: the same with need_ds0 appended. ``gla_decode``: (b, h, dk, dv, IO dtype, state dtype). A check
    that drives a path reads it to hold the kernels at those shapes."""
    return {fn.__name__: set(fn.shapes) for fn in _shape_noters()}


def kernel_takes(dk: int, dv: int, io: torch.dtype, state_dtype: torch.dtype) -> bool:
    """Whether the GLA kernels take a head of key dim ``dk`` and value dim
    ``dv`` with IO dtype ``io`` and state dtype ``state_dtype`` (int8: a
    row-quantized lazy-window state, which the int8 readout and
    ``gla_fold_q`` take at value widths of 128, 256 and 512). Decided from
    shapes and dtypes alone, before any launch; the wrappers raise on what
    it refuses."""
    if io not in _DTYPE_CODE or dk not in _DK_SUPPORTED or dv % _BV:
        return False
    return dv in _FOLD_Q_DV if state_dtype == torch.int8 else state_dtype in _DTYPE_CODE


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
    scale = xq.shape[-1] ** -0.5 if scale is None else scale
    tensors = [xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w]
    if initial_state is not None:
        tensors.append(initial_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GLAChunkConv.apply(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                                   initial_state, scale)
    return _chunk_conv_launch(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                              initial_state, scale)


def _check_chunk_conv_args(name, xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                           initial_state, *more):
    """What the conv-fused prefill kernels take (``more``: further tensors
    that must be contiguous on the same device); returns (b, h, t, dk, dv,
    IO dtype, state dtype)."""
    b, h, t, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    st = torch.float32 if initial_state is None else initial_state.dtype
    tensors = [xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w, *more]
    if initial_state is not None:
        tensors.append(initial_state)
    _check_cuda_args(name, tensors, io, dk, dv, st)
    _check(name, t >= 1, "needs at least one step")
    _check(name, xk.shape == xq.shape and xk.dtype == io, "xk must match xq")
    _check(name, xv.shape == (b, h, t, dv) and xv.dtype == io, "xv shape/dtype")
    _check(name, gk.shape == xq.shape and gk.dtype == torch.float32,
           "gk must be f32 of xq's shape")
    for wt, d in ((conv_q_w, dk), (conv_k_w, dk), (conv_v_w, dv)):
        _check(name, wt.shape == (h * d, _CONV_WIDTH) and wt.dtype == io,
               f"taps must be ({h * d}, {_CONV_WIDTH}) in {io}")
    if initial_state is not None:
        _check(name, initial_state.shape == (b, h, dk, dv), "state shape")
    return b, h, t, dk, dv, io, st


def _chunk_conv_launch(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                       initial_state, scale):
    """Check the arguments and launch the forward kernel (CUDA tensors)."""
    name = "gla_chunk_conv"
    b, h, t, dk, dv, io, st = _check_chunk_conv_args(
        name, xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w, initial_state)
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
    gla_chunk_conv.shapes.add((b, t, None if initial_state is None else st))
    return o, sf


gla_chunk_conv.launches, gla_chunk_conv.shapes = 0, set()


def gla_chunk_conv_bwd(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                       initial_state, do, dsf, scale=None,
                       need_ds0: bool = True, need_taps: bool = True):
    """Backward of :func:`gla_chunk_conv` on CUDA tensors.

    Inputs as the forward's, plus ``do`` (b, h, t, dv) in the IO dtype and
    ``dsf`` (b, h, dk, dv) in the state dtype, the gradients of its two
    outputs. Returns (dxq, dxk, dxv, dg, dwq, dwk, dwv, ds0): dx* in the IO
    dtype, dg f32, the tap gradients (h * d, 4) in the IO dtype summed over
    batch and time (None without ``need_taps``), ds0 in the state dtype
    (None without ``need_ds0`` or without an initial state).

    One call launches the five kernels of ``csrc/gla_chunk_conv_bwd.cu`` and
    counts as one launch. Its scratch (the per-tile parts of dq and dk, 2 *
    dv/32 * b*h*t*dk f32 values) is freed when the call returns.
    """
    name = "gla_chunk_conv_bwd"
    _check(name, xq.is_cuda, "runs on CUDA tensors only; on the CPU take "
           "autograd through gla_chunk_conv_plain")
    b, h, t, dk, dv, io, st = _check_chunk_conv_args(
        name, xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w, initial_state, do, dsf)
    _check(name, do.shape == xv.shape and do.dtype == io, "do must match xv")
    _check(name, dsf.shape == (b, h, dk, dv) and dsf.dtype == st,
           f"dsf must be ({b}, {h}, {dk}, {dv}) in {st}")
    scale = dk ** -0.5 if scale is None else scale
    dev = xq.device
    f32 = dict(dtype=torch.float32, device=dev)
    dxq, dxk, dxv = torch.empty_like(xq), torch.empty_like(xk), torch.empty_like(xv)
    dg = torch.empty_like(gk)
    ds0 = (torch.empty_like(initial_state)
           if need_ds0 and initial_state is not None else None)
    n_ch = h * (2 * dk + dv)
    dw = torch.empty(n_ch, _CONV_WIDTH, dtype=io, device=dev) if need_taps else None
    n_seg = -(-t // _BWD_SEG)
    dwp = torch.empty(b * n_seg, n_ch, _CONV_WIDTH, **f32) if need_taps else None
    dgt = torch.empty(n_seg, b, h, dk, **f32)
    tiles = dv // _BV
    dqp = torch.empty(tiles, b, h, t, dk, **f32)
    dkp = torch.empty(tiles, b, h, t, dk, **f32)
    dsgp = torch.empty(tiles, b, h, dk, **f32)
    dvf = torch.empty(b, h, t, dv, **f32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gla_chunk_conv_bwd(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(conv_q_w), _ptr(conv_k_w),
        _ptr(conv_v_w), _ptr(initial_state), _ptr(do), _ptr(dsf), _ptr(dxq),
        _ptr(dxk), _ptr(dxv), _ptr(dg), _ptr(ds0), _ptr(dw), _ptr(dqp),
        _ptr(dkp), _ptr(dsgp), _ptr(dvf), _ptr(dgt), _ptr(dwp), b, h, t, dk, dv,
        float(scale), _DTYPE_CODE[io], _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_conv_bwd.launches += 1
    gla_chunk_conv_bwd.shapes.add((b, t, None if initial_state is None else st,
                                   ds0 is not None, need_taps))
    if dw is None:
        return dxq, dxk, dxv, dg, None, None, None, ds0
    dwq, dwk, dwv = dw.split([h * dk, h * dk, h * dv])
    return dxq, dxk, dxv, dg, dwq, dwk, dwv, ds0


gla_chunk_conv_bwd.launches, gla_chunk_conv_bwd.shapes = 0, set()


class _GLAChunkConv(torch.autograd.Function):
    """:func:`gla_chunk_conv` on CUDA tensors under autograd: the forward
    kernel, and :func:`gla_chunk_conv_bwd` as its backward. Nothing is saved
    but the inputs: the backward recomputes the states from ``s0``."""

    @staticmethod
    def forward(ctx, xq, xk, xv, gk, wq, wk, wv, s0, scale):
        o, sf = _chunk_conv_launch(xq, xk, xv, gk, wq, wk, wv, s0, scale)
        ctx.save_for_backward(xq, xk, xv, gk, wq, wk, wv, s0)
        ctx.scale = scale
        return o, sf

    @staticmethod
    def backward(ctx, do, dsf):
        *inputs, s0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = gla_chunk_conv_bwd(
            *inputs, s0, do.contiguous(), dsf.contiguous(), ctx.scale,
            need_ds0=need[7], need_taps=any(need[4:7]))
        return (*grads, None)


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
    the kernel is recurrent and takes any t >= 1. Differentiable: when
    autograd records it runs through a ``torch.autograd.Function`` whose
    backward is :func:`gla_chunk_bwd`.
    """
    if not q.is_cuda:
        return gla_chunk_plain(q, k, v, gk, initial_state, scale, chunk_size)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    tensors = [q, k, v, gk] + ([] if initial_state is None else [initial_state])
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return _GLAChunk.apply(q, k, v, gk, initial_state, scale)
    return _chunk_launch(q, k, v, gk, initial_state, scale)


def _check_chunk_args(name, q, k, v, gk, initial_state, *more):
    """What the prefill kernels on post-conv q, k, v take (``more``: further
    tensors that must be contiguous on the same device); returns (b, h, t,
    dk, dv, IO dtype, state dtype)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    io = q.dtype
    st = torch.float32 if initial_state is None else initial_state.dtype
    tensors = [q, k, v, gk, *more] + ([] if initial_state is None else [initial_state])
    _check_cuda_args(name, tensors, io, dk, dv, st)
    _check(name, t >= 1, "needs at least one step")
    _check(name, k.shape == q.shape and k.dtype == io, "k must match q")
    _check(name, v.shape == (b, h, t, dv) and v.dtype == io, "v shape/dtype")
    _check(name, gk.shape == q.shape and gk.dtype == torch.float32,
           "gk must be f32 of q's shape")
    if initial_state is not None:
        _check(name, initial_state.shape == (b, h, dk, dv), "state shape")
    return b, h, t, dk, dv, io, st


def _chunk_launch(q, k, v, gk, initial_state, scale):
    """Check the arguments and launch the forward kernel (CUDA tensors)."""
    name = "gla_chunk"
    b, h, t, dk, dv, io, st = _check_chunk_args(name, q, k, v, gk, initial_state)
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
    gla_chunk.shapes.add((b, h, t, dk, dv, io, None if initial_state is None else st,
                          float(scale)))
    return o, sf


gla_chunk.launches, gla_chunk.shapes = 0, set()


def gla_chunk_bwd(q, k, v, gk, initial_state, do, dsf, scale=None, need_ds0: bool = True):
    """Backward of :func:`gla_chunk` on CUDA tensors.

    Inputs as the forward's, plus ``do`` (b, h, t, dv) in the IO dtype and
    ``dsf`` (b, h, dk, dv) in the state dtype, the gradients of its two
    outputs. Returns (dq, dk, dv, dg, ds0): dq, dk, dv in the IO dtype, dg
    f32, ds0 in the state dtype (None without ``need_ds0`` or without an
    initial state).

    One call launches the four kernels of ``csrc/gla_chunk_bwd.cu`` and
    counts as one launch. Its scratch (the per-tile parts of dq and dk, 2 *
    dv/32 * b*h*t*dk f32 values) is freed when the call returns.
    """
    name = "gla_chunk_bwd"
    _check(name, q.is_cuda, "runs on CUDA tensors only; on the CPU take "
           "autograd through gla_chunk_plain")
    b, h, t, dk, dv, io, st = _check_chunk_args(name, q, k, v, gk, initial_state, do, dsf)
    _check(name, do.shape == v.shape and do.dtype == io, "do must match v")
    _check(name, dsf.shape == (b, h, dk, dv) and dsf.dtype == st,
           f"dsf must be ({b}, {h}, {dk}, {dv}) in {st}")
    scale = dk ** -0.5 if scale is None else scale
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg = torch.empty_like(gk)
    ds0 = (torch.empty_like(initial_state)
           if need_ds0 and initial_state is not None else None)
    tiles = dv // _BV
    dqp = torch.empty(tiles, b, h, t, dk, **f32)
    dkp = torch.empty(tiles, b, h, t, dk, **f32)
    dsgp = torch.empty(tiles, b, h, dk, **f32)
    dgt = torch.empty(-(-t // _BWD_SEG), b, h, dk, **f32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_chunk_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(initial_state), _ptr(do), _ptr(dsf),
        _ptr(dq), _ptr(dk_), _ptr(dv_), _ptr(dg), _ptr(ds0), _ptr(dqp), _ptr(dkp),
        _ptr(dsgp), _ptr(dgt), b, h, t, dk, dv, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_bwd.launches += 1
    gla_chunk_bwd.shapes.add((b, h, t, dk, dv, io, None if initial_state is None else st,
                              float(scale), ds0 is not None))
    return dq, dk_, dv_, dg, ds0


gla_chunk_bwd.launches, gla_chunk_bwd.shapes = 0, set()


class _GLAChunk(torch.autograd.Function):
    """:func:`gla_chunk` on CUDA tensors under autograd: the forward kernel,
    and :func:`gla_chunk_bwd` as its backward. Nothing is saved but the
    inputs: the backward recomputes the states from ``s0``."""

    @staticmethod
    def forward(ctx, q, k, v, gk, s0, scale):
        o, sf = _chunk_launch(q, k, v, gk, s0, scale)
        ctx.save_for_backward(q, k, v, gk, s0)
        ctx.scale = scale
        return o, sf

    @staticmethod
    def backward(ctx, do, dsf):
        *inputs, s0 = ctx.saved_tensors
        grads = gla_chunk_bwd(*inputs, s0, do.contiguous(), dsf.contiguous(), ctx.scale,
                              need_ds0=ctx.needs_input_grad[4])
        return (*grads, None)


# ----------------------------------------------- decode kernel, convs outside
def gla_decode_plain(q, k, v, gk, state, scale=None):
    """Plain version of :func:`gla_decode` (same signature; returns new
    tensors and leaves ``state`` untouched): ``ops/gla.py:gla_decode_step``."""
    return gla_ops.gla_decode_step(q, k, v, gk, state, scale=scale)


def gla_decode(q, k, v, gk, state, scale=None):
    """One GLA decode token on q, k, v as they are: S <- diag(e^g) S + k^T v,
    o = (scale q) S.

    q, k: (b, h, dk) and v: (b, h, dv) in the IO dtype; gk: (b, h, dk) f32
    log-gates; state (b, h, dk, dv) in f32 or bf16. Returns (o (b, h, dv) in
    the IO dtype, state). On CUDA the kernel updates ``state`` IN PLACE and
    returns the same tensor (as the JAX kernel aliases its state buffer).
    """
    if not q.is_cuda:
        return gla_decode_plain(q, k, v, gk, state, scale)
    name = "gla_decode"
    b, h, dk = q.shape
    dv = v.shape[-1]
    io = q.dtype
    _check_cuda_args(name, [q, k, v, gk, state], io, dk, dv, state.dtype)
    _check(name, k.shape == q.shape and k.dtype == io, "k must match q")
    _check(name, v.shape == (b, h, dv) and v.dtype == io, "v shape/dtype")
    _check(name, gk.shape == q.shape and gk.dtype == torch.float32,
           "gk must be f32 of q's shape")
    _check(name, state.shape == (b, h, dk, dv), "state shape")
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, dv, dtype=io, device=q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_decode_step(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(state), _ptr(o), b, h, dk, dv,
        float(scale), _DTYPE_CODE[io], _DTYPE_CODE[state.dtype], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_decode.launches += 1
    gla_decode.shapes.add((b, h, dk, dv, io, state.dtype))
    return o, state


gla_decode.launches, gla_decode.shapes = 0, set()


# -------------------------------------------------- lazy-window decode kernel
def gla_decode_lazy_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                               kbuf, vbuf, cbuf, cc, p: int, scale=None,
                               s_scale=None):
    """Plain version of :func:`gla_decode_lazy_conv` (same signature;
    returns new tensors and leaves every input untouched)."""
    q, cq2 = _ring_conv(xq, wq, cq)
    k, ck2 = _ring_conv(xk, wk, ck)
    v, cv2 = _ring_conv(xv, wv, cv)
    _check_state_scale("gla_decode_lazy_conv", state, s_scale)
    base = (state,) if s_scale is None else (state, s_scale)
    step = gla_ops.gla_decode_lazy_step if s_scale is None else gla_ops.gla_decode_lazy_step_q
    o, kbuf, vbuf, cbuf, cc = step(
        q, k.to(kbuf.dtype), v.to(vbuf.dtype), gk, *base, kbuf, vbuf, cbuf, cc,
        p, scale=scale)
    return o.to(xq.dtype), cq2, ck2, cv2, kbuf, vbuf, cbuf, cc


def _check_state_scale(name, state, s_scale) -> None:
    """An int8 state comes with its f32 row scales (b, h, dk), a float
    state without."""
    if state.dtype == torch.int8:
        _check(name, s_scale is not None, "an int8 state needs s_scale")
        _check(name, s_scale.shape == state.shape[:-1] and s_scale.dtype == torch.float32,
               f"s_scale must be {tuple(state.shape[:-1])} in f32")
    else:
        _check(name, s_scale is None, "s_scale goes with an int8 state only")


def gla_decode_lazy_conv(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                         kbuf, vbuf, cbuf, cc, p: int, scale=None, s_scale=None):
    """One lazy-window GLA decode token with the conv ring updates fused in.

    Arguments as :func:`gla_decode_conv`, plus the window buffers kbuf (L,
    b, h, dk) and vbuf (L, b, h, dv) in the IO dtype, cbuf (L, b, h, dk) and
    cc (b, h, dk) in f32, and the window position ``p`` (a host int, 0 <= p
    < L). ``state`` is only read. Slots ``j > p`` of the buffers may hold
    anything. Returns (o (b, h, dv), cq, ck, cv, kbuf, vbuf, cbuf, cc).

    ``state`` is f32 or bf16 with ``s_scale=None``, or int8 with its row
    scales ``s_scale`` (b, h, dk) in f32 (``ops/gla.py:quantize_state_rows``):
    the readout is then ``(q e^{cc} s_scale) S_q``.

    On CUDA the kernel writes slot ``p`` of kbuf, vbuf and cbuf IN PLACE and
    returns the same tensors (as the JAX kernel aliases them); the rings
    and cc come back as new tensors.
    """
    if not xq.is_cuda:
        return gla_decode_lazy_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck,
                                          cv, state, kbuf, vbuf, cbuf, cc, p,
                                          scale, s_scale)
    name = "gla_decode_lazy_conv"
    b, h, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    _check_state_scale(name, state, s_scale)
    quant = s_scale is not None
    tensors = [xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf, cbuf, cc]
    _check_cuda_args(name, tensors + ([s_scale] if quant else []), io, dk, dv,
                     torch.float32 if quant else state.dtype)
    _check(name, not quant or dv % (4 * _BV) == 0,
           f"with an int8 state the head value dim {dv} must be a multiple of {4 * _BV}")
    state_code = _INT8_CODE if quant else _DTYPE_CODE[state.dtype]
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
        _ptr(cq), _ptr(ck), _ptr(cv), _ptr(state), _ptr(s_scale), _ptr(kbuf),
        _ptr(vbuf), _ptr(cbuf), _ptr(cc), _ptr(o), _ptr(cq2), _ptr(ck2),
        _ptr(cv2), _ptr(cc2), b, h, dk, dv, L, p, float(scale), _DTYPE_CODE[io],
        state_code, ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_decode_lazy_conv.launches += 1
    if quant:
        gla_decode_lazy_conv.q_launches += 1
    return o, cq2, ck2, cv2, kbuf, vbuf, cbuf, cc2


# q_launches: how many of the launches read an int8 state
gla_decode_lazy_conv.launches = gla_decode_lazy_conv.q_launches = 0


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


# --------------------------------------------- window fold of an int8 state

def gla_fold_q_plain(state_q, s_scale, kbuf, vbuf, cbuf, cc):
    """Plain version of :func:`gla_fold_q` (returns new tensors)."""
    return gla_ops.gla_decode_lazy_fold_q(state_q, s_scale, kbuf, vbuf, cbuf, cc)


def gla_fold_q(state_q, s_scale, kbuf, vbuf, cbuf, cc):
    """Fold a FULL lazy window into an int8 recurrent state and requantize
    every row: ``S = (e^{cc} s_scale) S_q + sum_j (k_j e^{min(cc - c_j,
    0)})^T v_j``, then ``sc = max(max_v |S|, 1e-30) / 127`` and ``S_q =
    clip(round(S / sc), +-127)``.

    state_q (b, h, dk, dv) int8; s_scale (b, h, dk) f32; the window buffers
    as :func:`gla_fold`. Returns (state_q, s_scale); the buffers are left as
    they are and the caller resets ``cc``. On CUDA the kernel updates
    ``state_q`` and ``s_scale`` IN PLACE and returns the same tensors.
    """
    if not state_q.is_cuda:
        return gla_fold_q_plain(state_q, s_scale, kbuf, vbuf, cbuf, cc)
    name = "gla_fold_q"
    b, h, dk, dv = state_q.shape
    _check(name, state_q.dtype == torch.int8, "the state must be int8")
    _check_state_scale(name, state_q, s_scale)
    _check_cuda_args(name, [state_q, s_scale, kbuf, vbuf, cbuf, cc], kbuf.dtype, dk, dv,
                     torch.float32)
    _check(name, dv in _FOLD_Q_DV, f"head value dim {dv} not in {_FOLD_Q_DV}")
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, kbuf.dtype)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(state_q.device).cuda_stream
    err = lib.gla_fold_q_window(
        _ptr(state_q), _ptr(s_scale), _ptr(kbuf), _ptr(vbuf), _ptr(cbuf), _ptr(cc),
        b, h, dk, dv, L, _DTYPE_CODE[kbuf.dtype], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_fold_q.launches += 1
    return state_q, s_scale


gla_fold_q.launches = 0
