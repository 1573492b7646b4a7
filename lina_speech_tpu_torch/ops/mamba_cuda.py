"""The Mamba (v1) kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`mamba_scan` replaces ``mamba_scan_pallas``
  (lina_speech_tpu/ops/mamba_pallas.py:468), the prefill and the training
  forward of every Mamba-1 mixer. Kernel: ``csrc/mamba_scan.cu``. It is
  differentiable: when autograd records, it runs through a
  ``torch.autograd.Function`` whose backward is :func:`mamba_scan_bwd`
  (``csrc/mamba_scan_bwd.cu``, replacing ``_bwd_kernel``,
  mamba_pallas.py:86). The plain backward is autograd through
  :func:`mamba_scan_plain`.

A decode token runs the plain ``ops/mamba.py:selective_step``, as in the
JAX package: no Pallas kernel serves it.

The wrappers take the JAX function's arguments in its public layout: x and
dt (b, t, d), A (d, n), B and C (b, t, n), D (d), an optional initial state
(b, d, n) and an optional reset mask (b, t) bool. x, B and C are in the IO
dtype (f32 or bf16); dt, A, D and the state in f32. For a CPU tensor a
wrapper runs its plain version; for a CUDA tensor it launches the kernel or
raises -- there is no fallback. Each counts its launches
(``mamba_scan.launches``) and notes the shapes it was launched on
(:func:`launch_shapes`). Which shapes the kernels take is
:func:`kernel_takes`, decided from shapes and dtypes before any launch; a
layer asks it and takes the plain version for a shape it refuses, and a
wrapper called on such a shape raises.

Both the kernels and the plain versions compute in f32; they differ by the
order of f32 sums and by the exponential (the kernels' exp2f of dt A
log2 e), not by rounding points.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lina_speech_tpu_torch.ops import _build
from lina_speech_tpu_torch.ops import mamba as mamba_ops
from lina_speech_tpu_torch.ops.gla_cuda import _DTYPE_CODE, _check, _ptr, _raise_on

_N = 16  # state size the kernels are built for (csrc/mamba_common.cuh:kN)
_CHANNELS = 32  # channels per block (kChannels)
_SEG = 16  # steps per checkpoint of the backward (kTile)


def _wrappers():
    return (mamba_scan, mamba_scan_bwd)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
        fn.shapes = set()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What each kernel was launched on since the last reset, a set of
    tuples each: ``mamba_scan`` (b, t, d, n, IO dtype, initial state dtype
    or None, whether a reset mask was given); ``mamba_scan_bwd`` the same
    with need_ds0 appended."""
    return {fn.__name__: set(fn.shapes) for fn in _wrappers()}


def kernel_takes(d: int, n: int, io: torch.dtype, state_dtype: torch.dtype) -> bool:
    """Whether the Mamba kernels take ``d`` channels of state size ``n``
    with IO dtype ``io`` (x, B, C) and an initial state of ``state_dtype``:
    n 16, d a multiple of 32, f32 or bf16 IO, an f32 state (dt, A and D are
    f32 too, as the mixer makes them)."""
    return (io in _DTYPE_CODE and n == _N and d % _CHANNELS == 0
            and state_dtype == torch.float32)


def _check_args(name, x, dt, A, B, C, D, s0, reset, *more):
    """What the kernels take (``more``: further tensors that must be
    contiguous on the same device); returns (b, t, d, n, IO dtype)."""
    b, t, d = x.shape
    n = A.shape[-1]
    io = x.dtype
    tensors = [x, dt, A, B, C, D, *more] + [v for v in (s0, reset) if v is not None]
    for v in tensors:
        _check(name, v.device == x.device, f"all tensors must be on {x.device}")
        _check(name, v.is_contiguous(), "tensors must be contiguous")
    _check(name, kernel_takes(d, n, io, torch.float32 if s0 is None else s0.dtype),
           f"takes n {_N}, d a multiple of {_CHANNELS}, f32/bf16 IO and an f32 state; "
           f"got d {d}, n {n}, IO {io}, state {None if s0 is None else s0.dtype}")
    _check(name, t >= 1, "needs at least one step")
    _check(name, dt.shape == x.shape and dt.dtype == torch.float32, "dt must be f32 of x's shape")
    _check(name, A.shape == (d, n) and A.dtype == torch.float32, f"A must be ({d}, {n}) f32")
    for m, v in (("B", B), ("C", C)):
        _check(name, v.shape == (b, t, n) and v.dtype == io, f"{m} must be ({b}, {t}, {n}) in {io}")
    _check(name, D.shape == (d,) and D.dtype == torch.float32, f"D must be ({d},) f32")
    if s0 is not None:
        _check(name, s0.shape == (b, d, n), "initial state shape")
    if reset is not None:
        _check(name, reset.shape == (b, t) and reset.dtype == torch.bool,
               f"reset_mask must be ({b}, {t}) bool")
    return b, t, d, n, io


def _shape(b, t, d, n, io, s0, reset):
    return (b, t, d, n, io, None if s0 is None else s0.dtype, reset is not None)


# ------------------------------------------------------------ prefill kernel
def mamba_scan_plain(x, dt, A, B, C, D, initial_state=None, reset_mask=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mamba_scan` (same signature):
    ``ops/mamba.py:selective_scan``."""
    return mamba_ops.selective_scan(x, dt, A, B, C, D, initial_state, reset_mask)


def mamba_scan(x, dt, A, B, C, D, initial_state=None, reset_mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over a chunk of tokens: h_t = exp(dt_t A) h_{t-1}
    + dt_t x_t B_t (the decay zeroed where ``reset_mask`` is set), y_t = C_t
    . h_t + D x_t.

    Returns y (b, t, d) in x's dtype and the final state (b, d, n) in f32.
    The kernel is recurrent and takes any t >= 1. Differentiable: when
    autograd records it runs through a ``torch.autograd.Function`` whose
    backward is :func:`mamba_scan_bwd`.
    """
    if not x.is_cuda:
        return mamba_scan_plain(x, dt, A, B, C, D, initial_state, reset_mask)
    tensors = [x, dt, A, B, C, D] + ([] if initial_state is None else [initial_state])
    if torch.is_grad_enabled() and any(v.requires_grad for v in tensors):
        return _MambaScan.apply(x, dt, A, B, C, D, initial_state, reset_mask)
    return _scan_launch(x, dt, A, B, C, D, initial_state, reset_mask)


def _scan_launch(x, dt, A, B, C, D, s0, reset):
    """Check the arguments and launch the forward kernel (CUDA tensors)."""
    name = "mamba_scan"
    b, t, d, n, io = _check_args(name, x, dt, A, B, C, D, s0, reset)
    y = torch.empty_like(x)
    sf = torch.empty(b, d, n, dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mamba_scan_fwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(s0), _ptr(reset), _ptr(y),
        _ptr(sf), b, t, d, n, _DTYPE_CODE[io], ctypes.c_void_p(stream))
    _raise_on(name, err)
    mamba_scan.launches += 1
    mamba_scan.shapes.add(_shape(b, t, d, n, io, s0, reset))
    return y, sf


mamba_scan.launches, mamba_scan.shapes = 0, set()


def mamba_scan_bwd(x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf,
                   need_ds0: bool = True):
    """Backward of :func:`mamba_scan` on CUDA tensors.

    Inputs as the forward's, plus ``dy`` (b, t, d) in the IO dtype and
    ``dsf`` (b, d, n) f32, the gradients of its two outputs. Returns (dx,
    ddt, dA, dB, dC, dD, ds0) in the order of the forward's arguments: dx,
    dB and dC in the IO dtype, ddt f32, dA (d, n) and dD (d) f32 summed over
    the batch in a fixed order, ds0 f32 (None without ``need_ds0`` or
    without an initial state). The reset mask gets no gradient.

    One call launches the kernels of ``csrc/mamba_scan_bwd.cu`` and counts
    as one launch. Its scratch (the segment checkpoints, b * ceil(t/16) * d
    * n f32 values, and the per-block parts of dB and dC, 2 * d/32 * b * t *
    n) is freed when the call returns.
    """
    name = "mamba_scan_bwd"
    _check(name, x.is_cuda, "runs on CUDA tensors only; on the CPU take autograd "
           "through mamba_scan_plain")
    b, t, d, n, io = _check_args(name, x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf)
    _check(name, dy.shape == x.shape and dy.dtype == io, "dy must match x")
    _check(name, dsf.shape == (b, d, n) and dsf.dtype == torch.float32,
           f"dsf must be ({b}, {d}, {n}) f32")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt, dA, dD = torch.empty_like(dt), torch.empty_like(A), torch.empty_like(D)
    ds0 = torch.empty_like(initial_state) if need_ds0 and initial_state is not None else None
    ck = torch.empty(b, -(-t // _SEG), d, n, **f32)
    dBp = torch.empty(d // _CHANNELS, b, t, n, **f32)
    dCp = torch.empty_like(dBp)
    dAb = torch.empty(b, d, n, **f32)
    dDb = torch.empty(b, d, **f32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mamba_scan_bwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(initial_state),
        _ptr(reset_mask), _ptr(dy), _ptr(dsf), _ptr(dx), _ptr(ddt), _ptr(dB), _ptr(dC),
        _ptr(dA), _ptr(dD), _ptr(ds0), _ptr(ck), _ptr(dBp), _ptr(dCp), _ptr(dAb), _ptr(dDb),
        b, t, d, n, _DTYPE_CODE[io], ctypes.c_void_p(stream))
    _raise_on(name, err)
    mamba_scan_bwd.launches += 1
    mamba_scan_bwd.shapes.add((*_shape(b, t, d, n, io, initial_state, reset_mask),
                               ds0 is not None))
    return dx, ddt, dA, dB, dC, dD, ds0


mamba_scan_bwd.launches, mamba_scan_bwd.shapes = 0, set()


class _MambaScan(torch.autograd.Function):
    """:func:`mamba_scan` on CUDA tensors under autograd: the forward kernel,
    and :func:`mamba_scan_bwd` as its backward. Nothing is saved but the
    inputs: the backward recomputes the states from ``s0``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, s0, reset):
        y, sf = _scan_launch(x, dt, A, B, C, D, s0, reset)
        ctx.save_for_backward(x, dt, A, B, C, D, s0, reset)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dsf):
        *inputs, s0, reset = ctx.saved_tensors
        grads = mamba_scan_bwd(*inputs, s0, reset, dy.contiguous(), dsf.contiguous(),
                               need_ds0=ctx.needs_input_grad[6])
        return (*grads, None)
