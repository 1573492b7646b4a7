"""The RWKV-6 kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`rwkv6_chunk` replaces ``rwkv6_chunk_pallas``
  (lina_speech_tpu/ops/rwkv6_pallas.py:565), the prefill and the training
  forward of every RWKV6 layer. Kernel: ``csrc/rwkv6_chunk.cu``, two routes
  chosen by :func:`rwkv6_chunk_fwd_plan`: for bf16 IO from a length on,
  64-row chunks on the tensor cores (``csrc/rwkv6_chunked_fwd.cuh``, the GLA
  forward's chunk walk with the readout decayed at the exclusive gate sum
  and the bonus on the diagonal; its plain version is
  :func:`rwkv6_chunk_chunked_plain`), else the recurrent body. It is
  differentiable: when autograd records, it runs through a
  ``torch.autograd.Function`` whose backward is :func:`rwkv6_chunk_bwd`
  (``csrc/rwkv6_chunk_bwd.cu``, replacing ``_bwd_kernel``,
  rwkv6_pallas.py:137), two routes chosen by :func:`rwkv6_chunk_bwd_plan`:
  for bf16 IO from a length on, 64-row chunks on the tensor cores
  (``csrc/rwkv6_chunked_bwd.cuh``, the GLA backward's chunk walk with the
  exclusive readout decay, strict pairs and the bonus; its plain version is
  :func:`rwkv6_chunk_bwd_chunked_plain`), else the recurrent sweeps. The
  plain backward is autograd through :func:`rwkv6_chunk_plain`.
- :func:`rwkv6_decode` replaces ``rwkv6_decode_fused``
  (lina_speech_tpu/ops/gla_pallas.py:1728), one decode token, the state
  updated in place. Kernel: ``csrc/rwkv6_decode.cu``, the classic GLA
  step's template (``csrc/gla_decode.cuh``) in its RWKV6 mode, on the body
  :func:`rwkv6_decode_plan` picks (the wide column-tile body above 512 KiB
  of state, the tile body below: ``gla_cuda.gla_decode_plan``'s rule). The
  JAX layer sends batches with fewer than 8 (batch * head) rows to XLA
  (models/rwkv6.py:225-236): the Pallas kernel's 8-row block is TPU tuning,
  and this kernel takes every batch size.

Each wrapper takes the JAX function's arguments in the JAX layout: r, k, w
(b, h, t, dk) (no t for the decode token), v (b, h, t, dv), u (h, dk) and
an optional initial state (b, h, dk, dv). r, k and v are in the IO dtype
(f32 or bf16), w and u in f32, the state in f32 or bf16. For a CPU tensor a
wrapper runs its plain version (``*_plain``, over ``ops/rwkv6.py``); for a
CUDA tensor it launches the kernel or raises -- there is no fallback. Each
counts its launches (``rwkv6_chunk.launches``; ``rwkv6_chunk.routes``,
``rwkv6_chunk_bwd.routes`` and ``rwkv6_decode.routes`` by route) and notes
the shapes it was launched on (:func:`launch_shapes`).
Which heads the kernels take is :func:`kernel_takes`, decided from shapes
and dtypes before any launch; a layer asks it and takes the plain version
for a head it refuses, and a wrapper called on such a head raises.

The recurrent kernels compute in f32 throughout; the chunked routes round
their products' operands to bf16, as the TPU kernels round them to their IO
dtype (the backward's products that feed dr and dk, whose difference gives
dw, and dv in two bf16 parts). The plain chunked form rounds the operands
of its matmuls to bf16 for bf16 IO (the JAX package's rounding points), so
kernel and plain version agree to a share of the output's magnitude, not
bit for bit.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
        fn.shapes = Counter()
    for fn in (rwkv6_chunk, rwkv6_chunk_bwd):
        fn.routes = dict.fromkeys(_ROUTE_CODE, 0)
    rwkv6_decode.routes = dict.fromkeys(_DECODE_ROUTE_CODE, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What each kernel was launched on since the last reset, a set of
    tuples each: ``rwkv6_chunk`` (b, h, t, dk, dv, IO dtype, initial state
    dtype or None, route); ``rwkv6_chunk_bwd`` (b, h, t, dk, dv, IO dtype,
    initial state dtype or None, need_ds0, route); ``rwkv6_decode`` (b, h,
    dk, dv, IO dtype, state dtype, route)."""
    return {fn.__name__: set(fn.shapes) for fn in _wrappers()}


def launch_shape_counts() -> dict:
    """:func:`launch_shapes` with the number of launches on each shape."""
    return {fn.__name__: Counter(fn.shapes) for fn in _wrappers()}


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
_ROUTE_CODE = gla_cuda._ROUTE_CODE
# bf16 inputs shorter than these keep the recurrent body, whose one launch
# beat the chunked route's three or four below them in chip_smoke.py's route
# sweep on an H100 (PERF.md §6; h4 dk256 dv256, f32 initial state, medians
# of six turns; us, the recurrent body against the chunked route): at b1
# and b2 (4 and 8 heads) the two tied at t64 (45.3 against 45.5 at b1, 45.0
# against 47.3 at b2) and the chunked route won from t96 (66.2 against 47.9
# at b1); above 8 heads in flight they tied at t96 (b4 66.7 against 65.1,
# b8 94.5 against 100.7) and the chunked route won from t128 (b8 126.1
# against 101.3). Shapes the sweep did not reach take the rule of the
# nearest it did.
_FWD_CHUNKED_MIN_T = 96
_FWD_CHUNKED_MIN_T_MANY_HEADS = 128  # more than 8 heads in flight


def rwkv6_chunk_fwd_plan(io: torch.dtype, b: int, h: int, t: int, dv: int) -> str:
    """The body a :func:`rwkv6_chunk` launch of IO dtype ``io`` on (b, h, t)
    heads of value dim ``dv`` runs, decided from these alone before the
    launch: ``"chunked"`` for bf16 IO from ``_FWD_CHUNKED_MIN_T`` tokens on
    (``_FWD_CHUNKED_MIN_T_MANY_HEADS`` above 8 heads in flight; 64-row
    chunks, products on the tensor cores with bf16 operands and f32 sums, as
    the TPU kernel rounds its products' operands to the IO dtype), else
    ``"recurrent"`` (the time loop in f32, which an f32 caller expects and
    which is faster on a few tokens). ``dv`` does not move the measured
    thresholds (RWKV6's heads are dv 256 on every driven path)."""
    min_t = _FWD_CHUNKED_MIN_T_MANY_HEADS if b * h > 8 else _FWD_CHUNKED_MIN_T
    return "chunked" if io == torch.bfloat16 and t >= min_t else "recurrent"


def rwkv6_chunk_plain(r, k, v, w, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rwkv6_chunk` (same signature):
    ``ops/rwkv6.py:rwkv6_chunk``."""
    return rwkv6_ops.rwkv6_chunk(r, k, v, w, u, initial_state)


def rwkv6_chunk_chunked_plain(r, k, v, w, u, initial_state=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked route of :func:`rwkv6_chunk` written with tensors (same
    arguments and outputs): ``gla_cuda._chunked_fwd_plain`` on r in u's
    place (no scale) with the bonus u, every product operand rounded to the
    IO dtype. In 64-row chunks and 16-row sub-chunks, with in-chunk
    inclusive gate sums b and exclusive ones bx (bx_t = b_{t-1}, the
    readout's decay): the query factor r e^{bx} against the chunk's start
    state (bf16); the pairs s < t of a sub-chunk at e^{bx_t - b_s} and the
    diagonal as the bonus sum_d r_t u k_t, in f32; the pairs across
    sub-chunks as (r_t e^{bx_t - b_rho}) (k_s e^{b_rho - b_s}), rho the row
    before t's sub-chunk, both factors rounded; the states' decayed key k
    e^{btot - b} in two rounded parts. Used by the tests, on the CPU against
    the Pallas kernel and on the card against the kernels."""
    io = r.dtype
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    o, sf = gla_cuda._chunked_fwd_plain(
        r.float(), k.float(), v.float(), w.float(),
        None if initial_state is None else initial_state.float(),
        lambda x: x.to(io).float(), bonus=u.float())
    return o.to(io), sf.to(state_dtype)


def rwkv6_chunk(r, k, v, w, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 scan over a chunk of tokens: o_t = r_t (S_{t-1} + diag(u)
    k_t^T v_t), S_t = diag(e^{w_t}) S_{t-1} + k_t^T v_t.

    Returns o (b, h, t, dv) in the IO dtype and the final state in the
    initial state's dtype (f32 with none). Takes any t >= 1, on the route
    :func:`rwkv6_chunk_fwd_plan` gives the shape (counted in
    ``rwkv6_chunk.routes``). Differentiable: when autograd records it runs
    through a ``torch.autograd.Function`` whose backward is
    :func:`rwkv6_chunk_bwd`.
    """
    if not r.is_cuda:
        return rwkv6_chunk_plain(r, k, v, w, u, initial_state)
    tensors = [r, k, v, w, u] + ([] if initial_state is None else [initial_state])
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return _RWKV6Chunk.apply(r, k, v, w, u, initial_state)
    return _chunk_launch(r, k, v, w, u, initial_state)


def _chunk_launch(r, k, v, w, u, initial_state, route=None):
    """Check the arguments and launch the forward kernel (CUDA tensors) on
    ``route`` (None: the plan's; the card's checks force either)."""
    name = "rwkv6_chunk"
    b, h, t, dk, dv, io, st = _check_args(name, r, k, v, w, u, initial_state)
    route = gla_cuda._fwd_route(name, io, b, h, t, dv, route, plan=rwkv6_chunk_fwd_plan)
    o = torch.empty(b, h, t, dv, dtype=io, device=r.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=r.device)
    chunked = route == "chunked"
    split = gla_cuda.fwd_out_split(b, h, t, dv, gla_cuda.sm_count(r.device)) if chunked else 1
    buf, scratch = (gla_cuda._scratch(gla_cuda._chunked_fwd_sizes(b, h, t, dk, dv, split),
                                      r.device) if chunked else (None, [None] * 10))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_chunk_fwd(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(initial_state), _ptr(o), _ptr(sf),
        *scratch, b, h, t, dk, dv, _DTYPE_CODE[io], _DTYPE_CODE[st], _ROUTE_CODE[route], split,
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_chunk.launches += 1
    rwkv6_chunk.routes[route] += 1
    rwkv6_chunk.shapes[(b, h, t, dk, dv, io, None if initial_state is None else st, route)] += 1
    return o, sf


rwkv6_chunk.launches, rwkv6_chunk.shapes = 0, Counter()
rwkv6_chunk.routes = dict.fromkeys(_ROUTE_CODE, 0)


# bf16 inputs shorter than these keep the recurrent sweeps, whose two
# launches beat the chunked route's seven below them in chip_smoke.py's
# backward route sweep on an H100 (PERF.md §6; h4 dk256 dv256, no initial
# state, medians of six turns; us, the recurrent sweeps against the chunked
# route): up to 16 heads in flight the recurrent sweeps won at t64 (b1 149.2
# against 156.3, b4 158.4 against 175.4) and the chunked route from t96 (b1
# 189.7 against 164.8, b4 236.6 against 205.7); at 32 heads the recurrent
# sweeps won at t48 (178.6 against 192.6) and the chunked route from t64
# (243.4 against 209.9). Shapes the sweep did not reach take the rule of
# the nearest it did.
_BWD_CHUNKED_MIN_T = 96
_BWD_CHUNKED_MIN_T_MANY_HEADS = 64  # more than 16 heads in flight


def rwkv6_chunk_bwd_plan(io: torch.dtype, b: int, h: int, t: int, dv: int) -> str:
    """The body a :func:`rwkv6_chunk_bwd` launch of IO dtype ``io`` on (b,
    h, t) heads of value dim ``dv`` runs, decided from these alone before
    the launch: ``"chunked"`` for bf16 IO from ``_BWD_CHUNKED_MIN_T`` tokens
    on (``_BWD_CHUNKED_MIN_T_MANY_HEADS`` above 16 heads in flight; 64-row
    chunks, products on the tensor cores with bf16 operands, two parts for
    those that feed dr, dk and dv, and f32 sums), else ``"recurrent"`` (the
    two time sweeps in f32, which an f32 caller expects and which are
    faster on a few tokens). ``dv`` does not move the measured thresholds
    (RWKV6's heads are dv 256 on every driven path)."""
    min_t = _BWD_CHUNKED_MIN_T_MANY_HEADS if b * h > 16 else _BWD_CHUNKED_MIN_T
    return "chunked" if io == torch.bfloat16 and t >= min_t else "recurrent"


def _chunk_bwd_sizes(b, h, t, dk, dv, route):
    """Bytes of :func:`rwkv6_chunk_bwd`'s scratch arrays on ``route``, in the
    C entry point's order: the parts of drS and dkS (the state and pair
    parts of dr and dk) and of vdo = do . v (dv/32 each on the recurrent
    route, one on the chunked), the parts of the dsf . S_final term (dv/32,
    or ceil(dv/64) + 1), each segment's dw total and du share; then the
    chunked route's own arrays (``gla_cuda._chunked_bwd_sizes``, r in q's
    place; 0, not allocated, on the recurrent route)."""
    bh = b * h
    chunked = route == "chunked"
    parts, n_sg = (1, -(-dv // gla_cuda._CHUNK) + 1) if chunked else (dv // _BV, dv // _BV)
    own = gla_cuda._chunked_bwd_sizes(b, h, t, dk, dv) if chunked else [0] * 13
    return ([4 * parts * bh * t * dk] * 2 + [4 * parts * bh * t, 4 * n_sg * bh * dk]
            + [4 * -(-t // _FINISH_SEG) * bh * dk] * 2 + own)


def chunk_bwd_scratch_bytes(b: int, h: int, t: int, dk: int, dv: int, route: str) -> int:
    """Bytes of scratch one :func:`rwkv6_chunk_bwd` call on ``route`` takes
    beside its outputs, in one allocation."""
    return gla_cuda._scratch_total(_chunk_bwd_sizes(b, h, t, dk, dv, route))


def rwkv6_chunk_bwd_chunked_plain(r, k, v, w, u, initial_state, do, dsf,
                                  operand_dtype: Optional[torch.dtype] = None):
    """The chunked route of :func:`rwkv6_chunk_bwd` written with tensors
    (same arguments and outputs, ds0 wherever there is an initial state), in
    f32; with ``operand_dtype`` every operand of a product is rounded to it
    first, as the kernels round theirs to bf16, those of the products that
    feed dr, dk and dv in two rounded parts. The GLA backward's chunk walk
    (``gla_cuda._chunked_bwd_plain`` with the bonus u: r in u's place, no
    scale, the readout decayed at the exclusive gate sum, strict pairs)
    gives drS and dkS, the state and pair parts of dr and dk, and dv (the
    bonus on the diagonal of its scores); then the finishing pass: with
    vdo_t = do_t . v_t, dr = drS + u k vdo, dk = dkS + u r vdo, du = sum over
    batch and time of r k vdo, and dw_j = sum_{t>=j} (-k_t dkS_t) + sum_{t>j}
    r_t drS_t + dsf . S_final (a decay reaches the inclusive sums of the
    keys and the final state at its own step, the exclusive ones of the
    readout only after it). Used by the tests, on the CPU against the
    Pallas backward and on the card against the kernels."""
    io = r.dtype
    rnd, two = gla_cuda._operand_rounding(operand_dtype)
    rf, kf, vf, uf, dof = r.float(), k.float(), v.float(), u.float(), do.float()
    drs, dks, dv, dsg, ds = gla_cuda._chunked_bwd_plain(
        rf, kf, vf, w.float(), None if initial_state is None else initial_state.float(), dof,
        dsf.float(), 1.0, rnd, two, bonus=uf)
    vdo = (rnd(dof) * rnd(vf)).sum(-1, keepdim=True)
    ub = uf[:, None, :]
    dr = drs + ub * kf * vdo
    dk = dks + ub * rf * vdo
    du = (rf * kf * vdo).sum((0, 2))
    rev = lambda x: x.flip(2).cumsum(2).flip(2)  # sums over s >= t
    dw = rev(-kf * dks) + F.pad(rev(rf * drs)[:, :, 1:], (0, 0, 0, 1)) + dsg[:, :, None]
    ds0 = None if initial_state is None else ds.to(initial_state.dtype)
    return dr.to(io), dk.to(io), dv.to(io), dw, du, ds0


def rwkv6_chunk_bwd(r, k, v, w, u, initial_state, do, dsf, need_ds0: bool = True):
    """Backward of :func:`rwkv6_chunk` on CUDA tensors.

    Inputs as the forward's, plus ``do`` (b, h, t, dv) in the IO dtype and
    ``dsf`` (b, h, dk, dv) in the state dtype, the gradients of its two
    outputs. Returns (dr, dk, dv, dw, du, ds0): dr, dk, dv in the IO dtype,
    dw f32, du (h, dk) f32 summed over batch and time in a fixed order, ds0
    in the state dtype (None without ``need_ds0`` or without an initial
    state).

    One call counts as one launch, and once more under its route in
    ``rwkv6_chunk_bwd.routes`` (:func:`rwkv6_chunk_bwd_plan`). Both routes
    end in the finishing pass of ``csrc/rwkv6_chunk_bwd.cu`` (the parts of
    dr and dk added with the bonus's, rounded to the IO dtype, dw summed in
    reverse in its inclusive and exclusive parts, its segments' carry, du).
    Their scratch, one allocation freed when the call returns
    (:func:`chunk_bwd_scratch_bytes`):

    - ``"recurrent"`` (f32 IO, and short bf16 inputs): the two time sweeps;
      the per-tile parts of drS, dkS and vdo (2 * dv/32 * b*h*t*dk f32
      values and more: 268 MB at b8 h4 t512 dk256 dv256);
    - ``"chunked"`` (bf16 IO from 96 tokens, 64 above 16 heads): the four
      kernels of ``csrc/rwkv6_chunked_bwd.cuh``, 64-row chunks on the tensor
      cores, dv written in bf16 by the last; every chunk's start state and
      end-state cotangent in two bf16 parts; drS, dkS and vdo once in f32.
    """
    return _chunk_bwd_launch(r, k, v, w, u, initial_state, do, dsf, need_ds0)


def _chunk_bwd_launch(r, k, v, w, u, initial_state, do, dsf, need_ds0=True, route=None):
    """Check the arguments and launch :func:`rwkv6_chunk_bwd`'s kernels (CUDA
    tensors) on ``route`` (None: the plan's; the card's checks force either
    body of bf16 IO)."""
    name = "rwkv6_chunk_bwd"
    _check(name, r.is_cuda, "runs on CUDA tensors only; on the CPU take autograd "
           "through rwkv6_chunk_plain")
    b, h, t, dk, dv, io, st = _check_args(name, r, k, v, w, u, initial_state, do, dsf)
    _check(name, do.shape == v.shape and do.dtype == io, "do must match v")
    _check(name, dsf.shape == (b, h, dk, dv) and dsf.dtype == st,
           f"dsf must be ({b}, {h}, {dk}, {dv}) in {st}")
    route = gla_cuda._fwd_route(name, io, b, h, t, dv, route, plan=rwkv6_chunk_bwd_plan)
    dr, dk_, dv_ = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du = torch.empty_like(w), torch.empty_like(u)
    ds0 = torch.empty_like(initial_state) if need_ds0 and initial_state is not None else None
    buf, scratch = gla_cuda._scratch(_chunk_bwd_sizes(b, h, t, dk, dv, route), r.device)
    if route == "chunked" and do.data_ptr() % 16:  # rows of do are copied 16 bytes at a time
        do = do.clone()
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_chunk_bwd(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(initial_state), _ptr(do), _ptr(dsf),
        _ptr(dr), _ptr(dk_), _ptr(dv_), _ptr(dw), _ptr(du), _ptr(ds0), *scratch, b, h, t, dk, dv,
        _DTYPE_CODE[io], _DTYPE_CODE[st], _ROUTE_CODE[route], ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_chunk_bwd.launches += 1
    rwkv6_chunk_bwd.routes[route] += 1
    rwkv6_chunk_bwd.shapes[(b, h, t, dk, dv, io, None if initial_state is None else st,
                            ds0 is not None, route)] += 1
    return dr, dk_, dv_, dw, du, ds0


rwkv6_chunk_bwd.launches, rwkv6_chunk_bwd.shapes = 0, Counter()
rwkv6_chunk_bwd.routes = dict.fromkeys(_ROUTE_CODE, 0)


class _RWKV6Chunk(torch.autograd.Function):
    """:func:`rwkv6_chunk` on CUDA tensors under autograd: the forward
    kernel on its planned route, and :func:`rwkv6_chunk_bwd` on its planned
    route as its backward. Nothing is saved but the inputs: the backward
    recomputes the states from ``s0``."""

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
_DECODE_ROUTE_CODE = gla_cuda._DECODE_ROUTE_CODE


def rwkv6_decode_plan(b: int, h: int, dk: int, dv: int, state_dtype: torch.dtype) -> str:
    """The body an :func:`rwkv6_decode` launch on (b, h) heads of key dim
    ``dk`` and value dim ``dv`` over a state of ``state_dtype`` runs, decided
    from these alone before the launch: the classic GLA step's rule
    (``gla_cuda.gla_decode_plan``; the two share the kernel's bodies and
    their memory traffic), ``"tile"`` for a state of at most 512 KiB, else
    the wide route ``gla_cuda.decode_wide_route`` gives."""
    return gla_cuda.gla_decode_plan(b, h, dk, dv, state_dtype)


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
    buffer). It runs the body :func:`rwkv6_decode_plan` picks;
    ``rwkv6_decode.routes`` counts each.
    """
    if not r.is_cuda:
        return rwkv6_decode_plain(r, k, v, w, u, state)
    return _decode_launch(r, k, v, w, u, state)


def _decode_launch(r, k, v, w, u, state, route=None):
    """:func:`rwkv6_decode` on CUDA tensors, on ``route`` if given (the
    card's checks force either body), else on the plan's."""
    name = "rwkv6_decode"
    b, h, _, dk, dv, io, st = _check_args(name, r, k, v, w, u, state, step=True)
    route = gla_cuda._decode_route(name, b, h, dk, dv, state, route)  # rwkv6_decode_plan's
    o = torch.empty(b, h, dv, dtype=io, device=r.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.rwkv6_decode_step(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(state), _ptr(o), b, h, dk, dv,
        _DTYPE_CODE[io], _DTYPE_CODE[st], _DECODE_ROUTE_CODE[route], ctypes.c_void_p(stream))
    _raise_on(name, err)
    rwkv6_decode.launches += 1
    rwkv6_decode.routes[route] += 1
    rwkv6_decode.shapes[(b, h, dk, dv, io, st, route)] += 1
    return o, state


rwkv6_decode.launches, rwkv6_decode.shapes = 0, Counter()
rwkv6_decode.routes = dict.fromkeys(_DECODE_ROUTE_CODE, 0)
