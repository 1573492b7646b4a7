"""The RWKV-6 kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`rwkv6_chunk` replaces ``rwkv6_chunk_pallas``
  (lina_speech_tpu/ops/rwkv6_pallas.py:565), the prefill and the training
  forward of every RWKV6 layer. Kernel: ``csrc/rwkv6_chunk.cu``. It is
  differentiable: when autograd records, it runs through a
  ``torch.autograd.Function`` whose backward is :func:`rwkv6_chunk_bwd`
  (``csrc/rwkv6_chunk_bwd.cu``, replacing ``_bwd_kernel``,
  rwkv6_pallas.py:137). The plain backward is autograd through
  :func:`rwkv6_chunk_plain`.
- :func:`rwkv6_decode` replaces ``rwkv6_decode_fused``
  (lina_speech_tpu/ops/gla_pallas.py:1728), one decode token, the state
  updated in place. Kernel: ``csrc/rwkv6_decode.cu``. The JAX layer sends
  batches with fewer than 8 (batch * head) rows to XLA
  (models/rwkv6.py:225-236): the Pallas kernel's 8-row block is TPU tuning,
  and this kernel takes every batch size.

Each wrapper takes the JAX function's arguments in the JAX layout: r, k, w
(b, h, t, dk) (no t for the decode token), v (b, h, t, dv), u (h, dk) and
an optional initial state (b, h, dk, dv). r, k and v are in the IO dtype
(f32 or bf16), w and u in f32, the state in f32 or bf16. For a CPU tensor a
wrapper runs its plain version (``*_plain``, over ``ops/rwkv6.py``); for a
CUDA tensor it launches the kernel or raises -- there is no fallback. Each
counts its launches (``rwkv6_chunk.launches``) and notes the shapes it was
launched on (:func:`launch_shapes`). Which heads the kernels take is
:func:`kernel_takes`, decided from shapes and dtypes before any launch; a
layer asks it and takes the plain version for a head it refuses, and a
wrapper called on such a head raises.

The kernels compute in f32 throughout. The plain chunked form rounds the
operands of its matmuls to bf16 for bf16 IO (the JAX package's rounding
points), so the two agree to a share of the output's magnitude, not bit for
bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lina_speech_tpu_torch.ops import _build
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops import rwkv6 as rwkv6_ops
from lina_speech_tpu_torch.ops.gla_cuda import _DTYPE_CODE, _check, _check_cuda_args, _ptr, _raise_on

_BV = gla_cuda._BV
_FINISH_SEG = gla_cuda._BWD_SEG  # time steps per thread of the finishing kernel


def _wrappers():
    return (rwkv6_chunk, rwkv6_chunk_bwd, rwkv6_decode)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
        fn.shapes = set()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What each kernel was launched on since the last reset, a set of
    tuples each: ``rwkv6_chunk`` (b, h, t, dk, dv, IO dtype, initial state
    dtype or None); ``rwkv6_chunk_bwd`` the same with need_ds0 appended;
    ``rwkv6_decode`` (b, h, dk, dv, IO dtype, state dtype)."""
    return {fn.__name__: set(fn.shapes) for fn in _wrappers()}


def kernel_takes(dk: int, dv: int, io: torch.dtype, state_dtype: torch.dtype) -> bool:
    """Whether the RWKV6 kernels take a head of key dim ``dk`` and value dim
    ``dv`` with IO dtype ``io`` (r, k, v) and a float state of
    ``state_dtype``: the GLA kernels' shapes and dtypes, with no int8 state."""
    return state_dtype != torch.int8 and gla_cuda.kernel_takes(dk, dv, io, state_dtype)


def _check_args(name, r, k, v, w, u, state, *more, step: bool = False):
    """What the kernels take (``more``: further tensors that must be
    contiguous on the same device); returns (b, h, t, dk, dv, IO dtype,
    state dtype), t = 1 for the decode token (``step``)."""
    if step:
        b, h, dk = r.shape
        t = 1
        v_shape = (b, h, v.shape[-1])
    else:
        b, h, t, dk = r.shape
        v_shape = (b, h, t, v.shape[-1])
    dv = v.shape[-1]
    io = r.dtype
    st = torch.float32 if state is None else state.dtype
    tensors = [r, k, v, w, u, *more] + ([] if state is None else [state])
    _check_cuda_args(name, tensors, io, dk, dv, st)
    _check(name, t >= 1, "needs at least one step")
    _check(name, k.shape == r.shape and k.dtype == io, "k must match r")
    _check(name, v.shape == v_shape and v.dtype == io, "v shape/dtype")
    _check(name, w.shape == r.shape and w.dtype == torch.float32, "w must be f32 of r's shape")
    _check(name, u.shape == (h, dk) and u.dtype == torch.float32, f"u must be ({h}, {dk}) in f32")
    if state is not None:
        _check(name, state.shape == (b, h, dk, dv), "state shape")
    return b, h, t, dk, dv, io, st


# ------------------------------------------------------------ prefill kernel
def rwkv6_chunk_plain(r, k, v, w, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rwkv6_chunk` (same signature):
    ``ops/rwkv6.py:rwkv6_chunk``."""
    return rwkv6_ops.rwkv6_chunk(r, k, v, w, u, initial_state)


def rwkv6_chunk(r, k, v, w, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 scan over a chunk of tokens: o_t = r_t (S_{t-1} + diag(u)
    k_t^T v_t), S_t = diag(e^{w_t}) S_{t-1} + k_t^T v_t.

    Returns o (b, h, t, dv) in the IO dtype and the final state in the
    initial state's dtype (f32 with none). The kernel is recurrent and takes
    any t >= 1. Differentiable: when autograd records it runs through a
    ``torch.autograd.Function`` whose backward is :func:`rwkv6_chunk_bwd`.
    """
    if not r.is_cuda:
        return rwkv6_chunk_plain(r, k, v, w, u, initial_state)
    tensors = [r, k, v, w, u] + ([] if initial_state is None else [initial_state])
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return _RWKV6Chunk.apply(r, k, v, w, u, initial_state)
    return _chunk_launch(r, k, v, w, u, initial_state)


def _chunk_launch(r, k, v, w, u, initial_state):
    """Check the arguments and launch the forward kernel (CUDA tensors)."""
    name = "rwkv6_chunk"
    b, h, t, dk, dv, io, st = _check_args(name, r, k, v, w, u, initial_state)
    o = torch.empty(b, h, t, dv, dtype=io, device=r.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=r.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_chunk_fwd(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(initial_state), _ptr(o), _ptr(sf),
        b, h, t, dk, dv, _DTYPE_CODE[io], _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_chunk.launches += 1
    rwkv6_chunk.shapes.add((b, h, t, dk, dv, io, None if initial_state is None else st))
    return o, sf


rwkv6_chunk.launches, rwkv6_chunk.shapes = 0, set()


def rwkv6_chunk_bwd(r, k, v, w, u, initial_state, do, dsf, need_ds0: bool = True):
    """Backward of :func:`rwkv6_chunk` on CUDA tensors.

    Inputs as the forward's, plus ``do`` (b, h, t, dv) in the IO dtype and
    ``dsf`` (b, h, dk, dv) in the state dtype, the gradients of its two
    outputs. Returns (dr, dk, dv, dw, du, ds0): dr, dk, dv in the IO dtype,
    dw f32, du (h, dk) f32 summed over batch and time in a fixed order, ds0
    in the state dtype (None without ``need_ds0`` or without an initial
    state).

    One call launches the five kernels of ``csrc/rwkv6_chunk_bwd.cu`` and
    counts as one launch. Its scratch (the per-tile parts of dr and dk, 2 *
    dv/32 * b*h*t*dk f32 values) is freed when the call returns.
    """
    name = "rwkv6_chunk_bwd"
    _check(name, r.is_cuda, "runs on CUDA tensors only; on the CPU take autograd "
           "through rwkv6_chunk_plain")
    b, h, t, dk, dv, io, st = _check_args(name, r, k, v, w, u, initial_state, do, dsf)
    _check(name, do.shape == v.shape and do.dtype == io, "do must match v")
    _check(name, dsf.shape == (b, h, dk, dv) and dsf.dtype == st,
           f"dsf must be ({b}, {h}, {dk}, {dv}) in {st}")
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk_, dv_ = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du = torch.empty_like(w), torch.empty_like(u)
    ds0 = torch.empty_like(initial_state) if need_ds0 and initial_state is not None else None
    tiles, n_seg = dv // _BV, -(-t // _FINISH_SEG)
    drp = torch.empty(tiles, b, h, t, dk, **f32)
    dkp = torch.empty(tiles, b, h, t, dk, **f32)
    vdop = torch.empty(tiles, b, h, t, **f32)
    dsgp = torch.empty(tiles, b, h, dk, **f32)
    dwt = torch.empty(n_seg, b, h, dk, **f32)
    dup = torch.empty(n_seg, b, h, dk, **f32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_chunk_bwd(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(initial_state), _ptr(do), _ptr(dsf),
        _ptr(dr), _ptr(dk_), _ptr(dv_), _ptr(dw), _ptr(du), _ptr(ds0), _ptr(drp), _ptr(dkp),
        _ptr(vdop), _ptr(dsgp), _ptr(dwt), _ptr(dup), b, h, t, dk, dv, _DTYPE_CODE[io],
        _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_chunk_bwd.launches += 1
    rwkv6_chunk_bwd.shapes.add((b, h, t, dk, dv, io, None if initial_state is None else st,
                                ds0 is not None))
    return dr, dk_, dv_, dw, du, ds0


rwkv6_chunk_bwd.launches, rwkv6_chunk_bwd.shapes = 0, set()


class _RWKV6Chunk(torch.autograd.Function):
    """:func:`rwkv6_chunk` on CUDA tensors under autograd: the forward
    kernel, and :func:`rwkv6_chunk_bwd` as its backward. Nothing is saved
    but the inputs: the backward recomputes the states from ``s0``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        o, sf = _chunk_launch(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, sf

    @staticmethod
    def backward(ctx, do, dsf):
        *inputs, s0 = ctx.saved_tensors
        return rwkv6_chunk_bwd(*inputs, s0, do.contiguous(), dsf.contiguous(),
                               need_ds0=ctx.needs_input_grad[5])


# ------------------------------------------------------------- decode kernel
def rwkv6_decode_plain(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rwkv6_decode` (same signature; returns new
    tensors and leaves ``state`` untouched): ``ops/rwkv6.py:rwkv6_decode_step``."""
    return rwkv6_ops.rwkv6_decode_step(r, k, v, w, u, state)


def rwkv6_decode(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RWKV6 decode token: o = r (S + diag(u) k^T v), S <- diag(e^w) S +
    k^T v.

    r, k: (b, h, dk) and v: (b, h, dv) in the IO dtype; w: (b, h, dk) and
    u: (h, dk) in f32; state (b, h, dk, dv) in f32 or bf16. Returns (o (b,
    h, dv) in the IO dtype, state). On CUDA the kernel updates ``state`` IN
    PLACE and returns the same tensor (as the JAX kernel aliases its state
    buffer).
    """
    if not r.is_cuda:
        return rwkv6_decode_plain(r, k, v, w, u, state)
    name = "rwkv6_decode"
    b, h, _, dk, dv, io, st = _check_args(name, r, k, v, w, u, state, step=True)
    o = torch.empty(b, h, dv, dtype=io, device=r.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_decode_step(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(state), _ptr(o), b, h, dk, dv,
        _DTYPE_CODE[io], _DTYPE_CODE[st], ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_decode.launches += 1
    rwkv6_decode.shapes.add((b, h, dk, dv, io, st))
    return o, state


rwkv6_decode.launches, rwkv6_decode.shapes = 0, set()
