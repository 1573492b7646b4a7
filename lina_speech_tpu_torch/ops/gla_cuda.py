"""The GLA kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`gla_chunk_conv` replaces ``gla_chunk_conv_pallas``
  (lina_speech_tpu/ops/gla_pallas.py:1289), the prefill and the training
  forward of every GLA layer with the q/k/v short convs fused in. Kernel:
  ``csrc/gla_chunk_conv.cu``, two routes chosen by :func:`gla_chunk_fwd_plan`
  (64-row chunks on the tensor cores for bf16 IO, ``csrc/gla_chunked_fwd.cuh``;
  the recurrent body for f32 IO and short bf16 inputs). It is
  differentiable: when autograd records,
  it runs through a ``torch.autograd.Function`` whose backward is
  :func:`gla_chunk_conv_bwd` (``csrc/gla_chunk_conv_bwd.cu``, replacing
  ``_conv_bwd_kernel``, gla_pallas.py:861). The plain backward is autograd
  through :func:`gla_chunk_conv_plain`.
- :func:`gla_chunk` replaces ``gla_chunk_pallas`` (gla_pallas.py:699), the
  same scan on post-conv q/k/v: the prefill chunks that continue a stream
  from carried conv rings, and the prefill and training of the layers
  without per-projection convs (simple-GLA, the shared conv, Mamba-2).
  Kernel: ``csrc/gla_chunk.cu``, the same two routes. It is differentiable:
  when autograd
  records, its backward is :func:`gla_chunk_bwd` (``csrc/gla_chunk_bwd.cu``,
  replacing ``_bwd_kernel``, gla_pallas.py:210), two routes chosen by
  :func:`gla_chunk_bwd_plan` (the chunked kernels of
  ``csrc/gla_chunked_bwd.cuh`` for bf16 IO, the recurrent sweeps for f32).
- :func:`gla_decode_conv` replaces ``gla_decode_conv_fused``
  (gla_pallas.py:1641), one decode token with the conv ring updates fused
  in. Kernel: ``csrc/gla_decode_conv.cu``, two routes chosen by
  :func:`gla_decode_plan` (``csrc/gla_decode.cuh``).
- :func:`gla_decode` replaces ``gla_decode_fused`` (gla_pallas.py:1709),
  one decode token on q/k/v as they are, the state updated in place.
  Kernel: ``csrc/gla_decode.cu``, the same template and routes.
- :func:`gla_decode_lazy_conv` replaces ``gla_decode_lazy_conv_fused``
  (gla_pallas.py:2197), one lazy-window decode token: ring updates, append
  to the window buffers, readout from a read-only state, which may be int8
  with a row scale (``s_scale``), or int4 packed two values a byte with its
  row scale (the JAX package's XLA step ``gla_decode_lazy_step_q4``,
  ops/gla.py:301, which has no TPU kernel). Kernel:
  ``csrc/gla_decode_lazy_conv.cu``, two routes chosen by
  :func:`gla_decode_lazy_plan`.
- :func:`gla_fold` replaces ``gla_fold_fused`` (gla_pallas.py:2232), the
  fold of a full window into the state. Kernel: ``csrc/gla_fold.cu`` (+
  ``gla_fold.cuh``), bands of key rows chosen by :func:`gla_fold_plan`.
- :func:`gla_fold_q` replaces ``gla_fold_fused_q`` (gla_pallas.py:2097), the
  same fold on an int8 state with a fresh requantization of every row, and
  on an int4 one (JAX's XLA ``gla_decode_lazy_fold_q4``, ops/gla.py:326).
  Kernel: ``csrc/gla_fold_q.cuh`` (``gla_fold_q.cu`` the int8 body,
  ``gla_fold_q4.cu`` the int4 one; + ``gla_fold.cuh``), bands chosen by
  :func:`gla_fold_q_plan`.

An int4 state is an int8 tensor of last dim dv / 2 (byte j: column j in
the low nibble, dv / 2 + j in the high one, ``ops/gla.py:
quantize_state_rows_int4``); the wrappers tell it from an int8 state by that
width, as the JAX layer does, and note its launches under the state label
:data:`INT4` and in ``.q4_launches``.

Each wrapper takes the JAX function's arguments in the JAX layout. For a
CPU tensor it runs the plain PyTorch version (``*_plain``); for a CUDA
tensor it launches the kernel or raises -- there is no fallback. Each
counts its launches in a plain int attribute (``gla_chunk_conv.launches``);
the training kernels and the three decode steps also note the shapes they
were launched on (:func:`launch_shapes`). Which heads the kernels take is
one predicate, :func:`kernel_takes`: a layer asks it before
it calls a wrapper and takes the plain version for a head the kernels do
not take, as the JAX layer takes XLA where its Pallas kernels do not fit; a
wrapper called on such a head raises.
The plain versions follow the Pallas kernels' conv rounding points: the f32
tap sum is rounded to the IO dtype before an f32 silu.

What bounds each kernel on the H100 and what its design does about it is
noted at the top of its ``.cu`` source.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.ops import _build
from lina_speech_tpu_torch.ops import gla as gla_ops

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT8_CODE = 2  # a row-quantized state (the lazy step only)
_INT4_CODE = 3  # ... int4, two values a byte (the lazy step and the int8 fold's C entry)
INT4 = "int4"  # the state dtype slot of an int4 launch's shape (launch_shapes)
_CONV_WIDTH = 4
_DK_SUPPORTED = (64, 128, 256)
_BV = 32  # value columns per block (csrc/gla_common.cuh:kBV)
_BWD_SEG = 64  # time steps per thread of the backward's finishing kernels (kFinishSeg)
_CHUNK = 64  # rows of a chunk of the chunked routes (csrc/gla_chunked_bwd.cuh:kC)
_SUB = 16  # rows of a sub-chunk within it (kSub)
_FOLD_Q_DV = (128, 256, 512)  # value widths the int8 fold kernel is built for


def _wrappers():
    return (gla_chunk_conv, gla_chunk_conv_bwd, gla_chunk, gla_chunk_bwd, gla_decode_conv,
            gla_decode, gla_decode_lazy_conv, gla_fold, gla_fold_q)


def _shape_noters():
    return (gla_chunk_conv, gla_chunk_conv_bwd, gla_chunk, gla_chunk_bwd, gla_decode_conv,
            gla_decode, gla_decode_lazy_conv, gla_fold, gla_fold_q)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
    for fn in (gla_chunk_conv, gla_chunk_conv_bwd, gla_chunk, gla_chunk_bwd):
        fn.routes = dict.fromkeys(_ROUTE_CODE, 0)
    for fn in (gla_decode_conv, gla_decode):
        fn.routes = dict.fromkeys(_DECODE_ROUTE_CODE, 0)
    gla_decode_lazy_conv.routes = dict.fromkeys(_LAZY_ROUTE_CODE, 0)
    gla_decode_lazy_conv.q_launches = gla_decode_lazy_conv.q4_launches = 0
    gla_fold_q.q4_launches = 0
    for fn in _shape_noters():
        fn.shapes = Counter()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What the kernels that note their shapes were launched on since the
    last reset, a set of tuples each. ``gla_chunk_conv``: every launch as (b,
    t, dtype of the initial state or None, route); ``gla_chunk_conv_bwd``:
    (b, t, dtype of the initial state or None, need_ds0, need_taps).
    ``gla_chunk``: every launch as (b, h, t, dk, dv, IO dtype, initial state
    dtype or None, scale, route); ``gla_chunk_bwd``: the same with need_ds0
    in the route's place. ``gla_decode_conv`` and ``gla_decode``: (b, h,
    dk, dv, IO dtype, state dtype, route); ``gla_decode_lazy_conv``: (b, h,
    dk, dv, IO dtype, state dtype, window length, p, route); ``gla_fold``
    and ``gla_fold_q``: (b, h, dk, dv, IO dtype, state dtype, window
    length). An int4 state's dtype slot holds :data:`INT4`. A check that
    drives a path reads it to hold the kernels at those shapes."""
    return {fn.__name__: set(fn.shapes) for fn in _shape_noters()}


def launch_shape_counts() -> dict:
    """:func:`launch_shapes` with the number of launches on each shape."""
    return {fn.__name__: Counter(fn.shapes) for fn in _shape_noters()}


def kernel_takes(dk: int, dv: int, io: torch.dtype, state_dtype: torch.dtype) -> bool:
    """Whether the GLA kernels take a head of key dim ``dk`` and value dim
    ``dv`` with IO dtype ``io`` and state dtype ``state_dtype`` (int8: a
    row-quantized lazy-window state, int8 or int4 packed two a byte, which
    the quantized readouts and ``gla_fold_q`` take at value widths of 128,
    256 and 512 either way). Decided from shapes and dtypes alone, before
    any launch; the wrappers raise on what it refuses."""
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
_ROUTE_CODE = {"recurrent": 0, "chunked": 1}
# bf16 inputs shorter than these keep the recurrent body, whose one launch
# beat the chunked route's three or four below them in chip_smoke.py's route
# sweep on an H100 (PERF.md §6): from 64 tokens the chunked route won at b1
# and b2 (4 heads) for dv 256 and 512 and at b8 for dv 512, where the
# recurrent body's b*h*dv/32 blocks take two waves of the card; at b8 dv
# 256, one wave, the two tied at t96 and the chunked route won from 128.
# Shapes the sweep did not reach take the rule of the nearest it did.
_FWD_CHUNKED_MIN_T = 64
_FWD_CHUNKED_MIN_T_ONE_WAVE = 128  # more than 8 heads in flight, dv below 512


def gla_chunk_fwd_plan(io: torch.dtype, b: int, h: int, t: int, dv: int) -> str:
    """The body a :func:`gla_chunk_conv` or :func:`gla_chunk` launch of IO
    dtype ``io`` on (b, h, t) heads of value dim ``dv`` runs, decided from
    these alone before the launch: ``"chunked"`` for bf16 IO from
    ``_FWD_CHUNKED_MIN_T`` tokens on (``_FWD_CHUNKED_MIN_T_ONE_WAVE`` above 8
    heads in flight with dv below 512; 64-row chunks, products on the tensor
    cores with bf16 operands and f32 sums, as the TPU kernel rounds its
    products' operands to the IO dtype), else ``"recurrent"`` (the time loop
    in f32, which an f32 caller expects and which is faster on a few
    tokens)."""
    one_wave = b * h > 8 and dv < 512
    min_t = _FWD_CHUNKED_MIN_T_ONE_WAVE if one_wave else _FWD_CHUNKED_MIN_T
    return "chunked" if io == torch.bfloat16 and t >= min_t else "recurrent"


def fwd_out_split(b: int, h: int, t: int, dv: int, sms: int) -> int:
    """Value-tile groups of the chunked forward's output kernel on a card
    of ``sms`` SMs: 1 where its ceil(t/64) * b*h blocks, each forming its
    chunk's score matrix A itself, make two a SM or more; else as many
    groups as keep the blocks within two a SM, at most one a 64-wide value
    tile, each group summing A from the key tiles' parts that a scores
    kernel writes first (those parts are scratch only then)."""
    blocks = -(-t // _CHUNK) * b * h
    return max(1, min(2 * sms // blocks, -(-dv // _CHUNK)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_ALIGN = 256  # bytes: where each array of a shared scratch buffer starts


def _scratch_total(sizes) -> int:
    """Bytes of one buffer holding arrays of ``sizes`` bytes (:func:`_scratch`)."""
    return sum(-(-n // _ALIGN) * _ALIGN for n in sizes)


def _scratch(sizes, device):
    """One uint8 buffer on ``device`` for arrays of ``sizes`` bytes, each
    starting on an ``_ALIGN``-byte boundary: (buffer, a pointer for each
    array, null where its size is 0). One allocation instead of one an
    array, as the chunked routes take ten or more; the buffer must be held
    until the launch is queued."""
    buf = torch.empty(_scratch_total(sizes), dtype=torch.uint8, device=device)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(ctypes.c_void_p(at if n else None))
        at += -(-n // _ALIGN) * _ALIGN
    return buf, ptrs


def _chunked_fwd_sizes(b, h, t, dk, dv, split):
    """Bytes of the chunked forward's scratch arrays, in the C entry point's
    order: on t rounded up to whole chunks u = scale q, k and the in-chunk
    gate sums in f32; the decayed k, its low part and the decayed u in
    bf16; every chunk's start state in bf16; v in bf16; e^{btot} per chunk
    in f32; with ``split`` above 1 each key tile's part of the chunk's
    score matrix in f32 (else 0: not allocated)."""
    nc = -(-t // _CHUNK)
    tp, bh = nc * _CHUNK, b * h
    return ([4 * bh * tp * dk] * 3 + [2 * bh * tp * dk] * 3
            + [2 * bh * nc * dk * dv, 2 * bh * tp * dv, 4 * bh * nc * dk,
               4 * bh * nc * dk * _CHUNK if split > 1 else 0])


def chunked_fwd_scratch_bytes(b: int, h: int, t: int, dk: int, dv: int, sms: int) -> int:
    """Bytes of scratch one chunked :func:`gla_chunk_conv` or :func:`gla_chunk`
    call takes beside its outputs on a card of ``sms`` SMs."""
    return _scratch_total(_chunked_fwd_sizes(b, h, t, dk, dv, fwd_out_split(b, h, t, dv, sms)))


def _fwd_route(name, io, b, h, t, dv, route, plan=None):
    """The route a forward launch takes: ``route`` if given (the card's
    checks force either body), else the plan's (``plan``, by default
    :func:`gla_chunk_fwd_plan`)."""
    route = (plan or gla_chunk_fwd_plan)(io, b, h, t, dv) if route is None else route
    _check(name, route in _ROUTE_CODE, f"route {route!r} not in {tuple(_ROUTE_CODE)}")
    _check(name, route == "recurrent" or io == torch.bfloat16,
           "the chunked route takes bf16 IO only")
    return route


def _conv_pre_rounded(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of (b, h, t, d) with taps (h, d, w), tap 0
    oldest: the f32 tap sum rounded to x's dtype, as f32."""
    t, w = x.shape[2], taps.shape[-1]
    xp = F.pad(x.float(), (0, 0, w - 1, 0))
    tf = taps.float()
    z = 0.0
    for i in range(w):
        z = z + xp[:, :, i:i + t, :] * tf[None, :, None, :, i]
    return z.to(x.dtype).float()


def _silu_conv_rounded(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """silu in f32 of :func:`_conv_pre_rounded` -> f32."""
    zr = _conv_pre_rounded(x, taps)
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


def _chunked_fwd_plain(u, k, v, gk, s0, rnd, bonus=None):
    """The chunked forward route with tensors: u = scale q, k, v (b, h, t, d)
    and gk in f32, s0 f32 or None; ``rnd`` rounds a product's operand. In
    64-row chunks (a ragged last one padded with zeros and zero gates), with
    in-chunk gate sums bc and their total btot:

    1. chunk states: S <- e^{btot} S + kd_hi^T v + kd_lo^T v from s0, kd = k
       e^{btot - bc} in two rounded parts, kd_hi = rnd(kd) and kd_lo =
       rnd(kd - kd_hi), keeping each chunk's start state;
    2. o = rnd(u e^{bc}) rnd(S_start) + rnd(A) v with A from
       :func:`_chunk_scores`.

    With ``bonus`` (h, dk) it is RWKV6's forward (u = r): the readout decays
    at the exclusive sums bx (bx_t = bc_{t-1}, 0 on a chunk's first row),
    o = rnd(u e^{bx}) rnd(S_start) + rnd(A) v, and A takes the bonus on its
    diagonal (:func:`_chunk_scores`). Returns (o, final state), both f32."""
    b, h, t, _ = u.shape
    C = _CHUNK
    nc = -(-t // C)

    def chunks(x):
        x = F.pad(x, (0, 0, 0, nc * C - t))
        return x.reshape(b, h, nc, C, x.shape[-1])

    uc, kc, vc = chunks(u), chunks(k), chunks(v)
    bc = chunks(gk).cumsum(3)
    btot = bc[:, :, :, -1:]
    kd = kc * torch.exp(btot - bc)
    hi = rnd(kd)
    lo = rnd(kd - hi)
    s = u.new_zeros(b, h, u.shape[-1], v.shape[-1]) if s0 is None else s0
    states = []
    for c in range(nc):
        states.append(s)
        s = (torch.exp(btot[:, :, c, 0, :, None]) * s + hi[:, :, c].transpose(-1, -2) @ vc[:, :, c]
             + lo[:, :, c].transpose(-1, -2) @ vc[:, :, c])
    bq = bc if bonus is None else _exclusive(bc)
    bonus = None if bonus is None else bonus[:, None, None, :]
    o = (rnd(uc * torch.exp(bq)) @ rnd(torch.stack(states, 2))
         + rnd(_chunk_scores(uc, kc, bc, rnd, bonus)) @ vc)
    return o.reshape(b, h, nc * C, -1)[:, :, :t], s


def gla_chunk_conv_chunked_plain(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                                 initial_state=None, scale=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked route of :func:`gla_chunk_conv` written with tensors (same
    arguments and outputs): the convs as :func:`gla_chunk_conv_plain` takes
    them, then :func:`_chunked_fwd_plain` with every product operand rounded
    to the IO dtype, as the kernels round theirs to bf16 (f32 IO: none).
    Used by the tests, on the CPU against the Pallas kernel and on the card
    against the kernels."""
    b, h, t, dk = xq.shape
    dv, w, io = xv.shape[-1], conv_q_w.shape[-1], xq.dtype
    scale = dk ** -0.5 if scale is None else scale
    q = _silu_conv_rounded(xq, conv_q_w.reshape(h, dk, w))
    k = _silu_conv_rounded(xk, conv_k_w.reshape(h, dk, w))
    v = _silu_conv_rounded(xv, conv_v_w.reshape(h, dv, w)).to(io).float()
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    o, sf = _chunked_fwd_plain(q * scale, k, v, gk.float(),
                               None if initial_state is None else initial_state.float(),
                               lambda x: x.to(io).float())
    return o.to(io), sf.to(state_dtype)


def gla_chunk_conv(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                   initial_state=None, scale=None, chunk_size: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA prefill with the q/k/v short convs fused in.

    xq, xk: (b, h, t, dk) and xv: (b, h, t, dv) PRE-conv projections in the
    IO dtype; gk: (b, h, t, dk) f32 log-gates; conv_*_w: (h * d, 4) taps in
    the IO dtype, tap 0 oldest, conv history zero at t = 0;
    initial_state: (b, h, dk, dv) or None (zeros, f32). Returns o (b, h, t,
    dv) in the IO dtype and the final state in the initial state's dtype.
    ``chunk_size`` shapes the plain version only. On CUDA tensors the
    kernel runs the body :func:`gla_chunk_fwd_plan` names. One call counts
    as one launch, and once more under its route in
    ``gla_chunk_conv.routes``.
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
                       initial_state, scale, route=None):
    """Check the arguments and launch the forward kernel (CUDA tensors) on
    ``route`` (None: the plan's; the card's checks force either)."""
    name = "gla_chunk_conv"
    b, h, t, dk, dv, io, st = _check_chunk_conv_args(
        name, xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w, initial_state)
    route = _fwd_route(name, io, b, h, t, dv, route)
    o = torch.empty(b, h, t, dv, dtype=io, device=xq.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=xq.device)
    split = fwd_out_split(b, h, t, dv, sm_count(xq.device)) if route == "chunked" else 1
    buf, scratch = (_scratch(_chunked_fwd_sizes(b, h, t, dk, dv, split), xq.device)
                    if route == "chunked" else (None, [None] * 10))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.gla_chunk_conv_fwd(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(conv_q_w), _ptr(conv_k_w),
        _ptr(conv_v_w), _ptr(initial_state), _ptr(o), _ptr(sf), *scratch,
        b, h, t, dk, dv, float(scale), _DTYPE_CODE[io], _DTYPE_CODE[st], _ROUTE_CODE[route],
        split, ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_conv.launches += 1
    gla_chunk_conv.routes[route] += 1
    gla_chunk_conv.shapes[(b, t, None if initial_state is None else st, route)] += 1
    return o, sf


gla_chunk_conv.launches, gla_chunk_conv.shapes = 0, Counter()
gla_chunk_conv.routes = dict.fromkeys(_ROUTE_CODE, 0)


def gla_chunk_conv_bwd_plan(io: torch.dtype) -> str:
    """The body a :func:`gla_chunk_conv_bwd` launch with IO dtype ``io``
    runs, decided before the launch: ``"chunked"`` for bf16 IO at every
    shape (64-row chunks, products on the tensor cores in bf16 with f32
    sums, as the TPU kernel rounds its products' operands to the IO dtype),
    else ``"recurrent"`` (the two time sweeps in f32, which an f32 caller
    expects). Each IO dtype has this one body in the C entry point."""
    return "chunked" if io == torch.bfloat16 else "recurrent"


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

    One call counts as one launch, and once more under its route in
    ``gla_chunk_conv_bwd.routes`` (:func:`gla_chunk_conv_bwd_plan`). Both
    routes end in the conv's finishing pass of ``csrc/gla_chunk_conv_bwd.cu``.
    Their scratch, freed when the call returns:

    - ``"recurrent"`` (f32 IO): the per-tile parts of dq and dk, 2 * dv/32 *
      b*h*t*dk f32 values (537 MB at b8 h4 t512 dk256 dv512);
    - ``"chunked"`` (bf16 IO, ``csrc/gla_chunked_bwd.cuh``): every chunk's
      start state and end-state cotangent in two bf16 parts (4 * b*h*nc*dk*dv,
      nc = ceil(t/64)); on t rounded up to whole chunks the post-conv u =
      scale q, k and the in-chunk gate sums in f32, the decayed k and u in
      two bf16 parts each and v in bf16; dq and dk once in f32
      (:func:`chunked_bwd_scratch_bytes`).
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
    route = gla_chunk_conv_bwd_plan(io)
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
    dvf = torch.empty(b, h, t, dv, **f32)
    buf, chunked = None, [None] * 13  # the chunked route's scratch, in the C entry point's order
    if route == "chunked":
        dqp = torch.empty(1, b, h, t, dk, **f32)
        dkp = torch.empty(1, b, h, t, dk, **f32)
        dsgp = torch.empty(-(-dv // _CHUNK) + 1, b, h, dk, **f32)
        buf, chunked = _scratch(_chunked_bwd_sizes(b, h, t, dk, dv), dev)
        if do.data_ptr() % 16:  # the chunked kernels copy rows of do 16 bytes at a time
            do = do.clone()
    else:
        tiles = dv // _BV
        dqp = torch.empty(tiles, b, h, t, dk, **f32)
        dkp = torch.empty(tiles, b, h, t, dk, **f32)
        dsgp = torch.empty(tiles, b, h, dk, **f32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gla_chunk_conv_bwd(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(conv_q_w), _ptr(conv_k_w),
        _ptr(conv_v_w), _ptr(initial_state), _ptr(do), _ptr(dsf), _ptr(dxq),
        _ptr(dxk), _ptr(dxv), _ptr(dg), _ptr(ds0), _ptr(dw), _ptr(dqp),
        _ptr(dkp), _ptr(dsgp), _ptr(dvf), _ptr(dgt), _ptr(dwp),
        *chunked, b, h, t, dk, dv,
        float(scale), _DTYPE_CODE[io], _DTYPE_CODE[st], _ROUTE_CODE[route],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_conv_bwd.launches += 1
    gla_chunk_conv_bwd.routes[route] += 1
    gla_chunk_conv_bwd.shapes[(b, t, None if initial_state is None else st,
                               ds0 is not None, need_taps)] += 1
    if dw is None:
        return dxq, dxk, dxv, dg, None, None, None, ds0
    dwq, dwk, dwv = dw.split([h * dk, h * dk, h * dv])
    return dxq, dxk, dxv, dg, dwq, dwk, dwv, ds0


gla_chunk_conv_bwd.launches, gla_chunk_conv_bwd.shapes = 0, Counter()
gla_chunk_conv_bwd.routes = dict.fromkeys(_ROUTE_CODE, 0)


def _chunked_bwd_sizes(b, h, t, dk, dv):
    """Bytes of the chunked backward's own scratch arrays, in the C entry
    point's order: on t rounded up to whole chunks u, k and the in-chunk
    gate sums in f32; k and u decayed, each in two bf16 parts; the chunk
    states and their cotangents, each in two bf16 parts; v in bf16;
    e^{btot} per chunk in f32."""
    nc = -(-t // _CHUNK)
    tp, bh = nc * _CHUNK, b * h
    return ([4 * bh * tp * dk] * 3 + [2 * bh * tp * dk] * 4 + [2 * bh * nc * dk * dv] * 4
            + [2 * bh * tp * dv, 4 * bh * nc * dk])


def chunked_bwd_scratch_bytes(b: int, h: int, t: int, dk: int, dv: int) -> int:
    """Bytes of scratch one chunked :func:`gla_chunk_conv_bwd` call takes
    beside its outputs (the tap parts, which both routes take, left out)."""
    bh = b * h
    return (_scratch_total(_chunked_bwd_sizes(b, h, t, dk, dv)) + 4 * bh * t * (2 * dk + dv)
            + 4 * (-(-dv // _CHUNK) + 1) * bh * dk + 4 * -(-t // _BWD_SEG) * bh * dk)


def _conv_bwd_plain(dy, zr, x, taps):
    """Backward of y = silu(zr), zr the rounded conv of x (b, h, t, d) with
    taps (h, d, w): dx in f32 and the tap gradient (h, d, w) summed over
    batch and time."""
    t, w = x.shape[2], taps.shape[-1]
    sig = torch.sigmoid(zr)
    dz = dy * sig * (1 + zr * (1 - sig))
    dzp = F.pad(dz, (0, 0, 0, w - 1))
    tf = taps.float()
    dx = sum(tf[None, :, None, :, w - 1 - j] * dzp[:, :, j:j + t] for j in range(w))
    xp = F.pad(x.float(), (0, 0, w - 1, 0))
    dw = torch.stack([(dz * xp[:, :, i:i + t]).sum((0, 2)) for i in range(w)], -1)
    return dx, dw


def _diag_decay(bc, rows):
    """e^{b_t - b_s} (..., L, L, d) of the sub-chunk ``rows``, t >= s, 0 above
    the diagonal (where the exponent is clamped to 0 before the mask)."""
    L = rows.stop - rows.start
    tri = torch.ones(L, L, dtype=torch.bool, device=bc.device).tril()[..., None]
    b_i = bc[..., rows, :]
    return torch.exp((b_i[..., :, None, :] - b_i[..., None, :, :]).clamp(max=0)) * tri


def _exclusive(bc):
    """The exclusive in-chunk sums of (..., C, d) inclusive ones: bc_{t-1},
    0 on the first row."""
    return F.pad(bc, (0, 0, 1, 0))[..., :-1, :]


def _strict_decay(bc, bq, rows):
    """e^{bq_t - b_s} (..., L, L, d) of the sub-chunk ``rows`` for s < t, 0
    on and above the diagonal: RWKV6's pairs, bq the exclusive sums."""
    L = rows.stop - rows.start
    strict = torch.ones(L, L, dtype=torch.bool, device=bc.device).tril(-1)[..., None]
    return torch.exp((bq[..., rows, None, :] - bc[..., None, rows, :]).clamp(max=0)) * strict


def _chunk_scores(u, k, bc, rnd, bonus=None):
    """A (..., C, C) = sum_d u_t k_s e^{b_t - b_s} (t >= s, else 0) on (..., C,
    d) chunks. Within a 16-row sub-chunk summed directly in f32; for a pair
    of sub-chunks I > J the decay splits at the row before I, so that both
    factors' exponents are <= 0 and the product runs on operands rounded by
    ``rnd`` with f32 sums.

    With ``bonus`` (broadcast against the chunks' (..., 1, d)), RWKV6's
    scores: the readout side decays at the exclusive sums bx_t = b_{t-1},
    A[t, s] = sum_d u_t k_s e^{bx_t - b_s} for s < t (every exponent still
    <= 0, the split's too), and the diagonal is the bonus, A[t, t] = sum_d
    u_t bonus_d k_t."""
    C, L = u.shape[-2], _SUB
    bq = bc if bonus is None else _exclusive(bc)
    A = torch.zeros(*u.shape[:-1], C, dtype=u.dtype, device=u.device)
    for i in range(C // L):
        rows = slice(L * i, L * (i + 1))
        if bonus is None:
            decay = _diag_decay(bc, rows)
        else:
            eye = torch.eye(L, dtype=torch.bool, device=bc.device)[..., None]
            decay = torch.where(eye, bonus[..., None, :], _strict_decay(bc, bq, rows))
        A[..., rows, rows] = torch.einsum("...td,...tsd,...sd->...ts", u[..., rows, :],
                                          decay, k[..., rows, :])
        if i:
            ref, early = bc[..., L * i - 1:L * i, :], slice(0, L * i)
            kx = rnd(k[..., early, :] * torch.exp(ref - bc[..., early, :]))
            A[..., rows, early] = (rnd(u[..., rows, :] * torch.exp(bq[..., rows, :] - ref))
                                   @ kx.transpose(-1, -2))
    return A


def _intra_chunk(u, k, bc, da, rnd, two, bonus=None):
    """The intra-chunk terms of the chunked backward on (..., C, d) chunks:
    G (C, dk) = sum_{s<=t} dA[t,s] k_s e^{b_t - b_s}, H (C, dk) = sum_{t>=s}
    dA[t,s] u_t e^{b_t - b_s} and A (C, C) = sum_d u_t k_s e^{b_t - b_s}
    (t >= s; :func:`_chunk_scores`). Within a 16-row sub-chunk the terms are
    summed directly; a pair of sub-chunks I > J splits the decay at a row
    between them, so that both factors' exponents are <= 0 and the product
    runs on rounded operands with f32 sums: G at the row before I, H at J's
    last row, dA and the decayed k and u taken by ``two`` (the kernels' two
    bf16 parts); A as :func:`_chunk_scores` with ``rnd``.

    With ``bonus`` (as :func:`_chunk_scores` takes it), RWKV6's terms: the
    pairs are strict and the readout side decays at the exclusive sums bx,
    G[t] = sum_{s<t} dA[t,s] k_s e^{bx_t - b_s}, H[s] = sum_{t>s} dA[t,s] u_t
    e^{bx_t - b_s}, and A carries the bonus on its diagonal."""
    C, L = u.shape[-2], _SUB
    bq = bc if bonus is None else _exclusive(bc)
    G, H = torch.zeros_like(k), torch.zeros_like(k)
    for i in range(C // L):
        rows = slice(L * i, L * (i + 1))
        b_i = bc[..., rows, :]
        e = _diag_decay(bc, rows) if bonus is None else _strict_decay(bc, bq, rows)
        da_ii = da[..., rows, rows]
        G[..., rows, :] += torch.einsum("...ts,...tsd,...sd->...td", da_ii, e, k[..., rows, :])
        H[..., rows, :] += torch.einsum("...ts,...tsd,...td->...sd", da_ii, e, u[..., rows, :])
        if i:
            ref, early = bc[..., L * i - 1:L * i, :], slice(0, L * i)
            up = torch.exp(bq[..., rows, :] - ref)
            kx = two(k[..., early, :] * torch.exp(ref - bc[..., early, :]))
            G[..., rows, :] += up * (two(da[..., rows, early]) @ kx)
        if i < C // L - 1:
            ref, late = bc[..., L * i + L - 1:L * (i + 1), :], slice(L * (i + 1), C)
            ux = two(u[..., late, :] * torch.exp(bq[..., late, :] - ref))
            H[..., rows, :] += torch.exp(ref - b_i) * (
                two(da[..., late, rows]).transpose(-1, -2) @ ux)
    return G, H, _chunk_scores(u, k, bc, rnd, bonus)


def _operand_rounding(operand_dtype):
    """(rnd, two) of the chunked backward's plain versions: ``rnd`` rounds a
    product's operand to ``operand_dtype`` (None: leaves it), ``two`` gives
    it as the kernels' two rounded parts, x_hi = rnd(x) and x_lo = rnd(x -
    x_hi), summed."""
    rnd = (lambda x: x) if operand_dtype is None else (lambda x: x.to(operand_dtype).float())
    return rnd, lambda x: rnd(x) + rnd(x - rnd(x))


def _chunked_bwd_plain(u, k, v, gk, s0, do, dsf, scale, rnd, two, bonus=None):
    """The chunk walk of the chunked backward route with tensors, on u =
    scale q, k, v (b, h, t, d; post-conv where the layer has convs), gk, do
    and dsf in f32, s0 f32 or None. ``rnd`` rounds a product's operand and
    ``two`` gives it in two rounded parts (:func:`_operand_rounding`): those
    marked (2), the products that feed dq and dk, whose difference q dq - k
    dk gives dg after a cancellation that bf16 operands would leave noisy.
    Chunks of 64 rows (a ragged last one padded with zeros and zero gates),
    in-chunk gate sums bc and their total btot:

    1. chunk states: S <- e^{btot} S + (k e^{btot - bc})^T (2) v from s0,
       keeping each chunk's start state;
    2. chunk cotangents: dS <- e^{btot} dS + (u e^{bc})^T (2) do in reverse
       from dsf, keeping each chunk's end-state cotangent; the last dS is
       s0's cotangent;
    3. per chunk: dq = scale (e^{bc} (do S^T (2)) + G), dk = e^{btot - bc}
       (v dS^T (2)) + H, dv = (k e^{btot - bc}) dS + A^T do with dA = do
       v^T, G and H (dA and factors (2)) and A from :func:`_intra_chunk`;
       dsf . S_final summed over dv, as the last chunk's e^{btot} S . dsf plus
       sum_t k_t e^{btot - bc_t} (v_t dsf^T) from the values that enter dk.

    With ``bonus`` (h, dk) it is RWKV6's chunk walk (u = r, scale 1): the
    readout decays at the exclusive sums bx, so the cotangents walk on (u
    e^{bx})^T do, dq = e^{bx} (do S^T) + G, the pairs of G and H are strict
    and A takes the bonus on its diagonal (:func:`_intra_chunk`); dq and dk
    are then the state and pair parts alone, without the bonus's; dv's
    operands, the decayed k, dS and A, are taken by ``two`` too.

    Returns (dq, dk, dv, the dsf . S_final term (b, h, dk), s0's
    cotangent), all f32."""
    b, h, t, dk = u.shape
    dv = v.shape[-1]
    C = _CHUNK
    nc = -(-t // C)

    def chunks(x):
        x = F.pad(x, (0, 0, 0, nc * C - t))
        return x.reshape(b, h, nc, C, x.shape[-1])

    uc, kc, vc, dO = chunks(u), chunks(k), chunks(v), chunks(do)
    bc = chunks(gk).cumsum(3)
    bq = bc if bonus is None else _exclusive(bc)
    btot = bc[:, :, :, -1:]
    ktil = kc * torch.exp(btot - bc)
    s = u.new_zeros(b, h, dk, dv) if s0 is None else s0
    states = []
    for c in range(nc):
        states.append(s)
        s = (torch.exp(btot[:, :, c, 0, :, None]) * s
             + two(ktil[:, :, c]).transpose(-1, -2) @ rnd(vc[:, :, c]))
    ul = uc * torch.exp(bq)
    ds, dstates = dsf, [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = ds
        ds = (torch.exp(btot[:, :, c, 0, :, None]) * ds
              + two(ul[:, :, c]).transpose(-1, -2) @ rnd(dO[:, :, c]))
    s_in, ds_end = torch.stack(states, 2), torch.stack(dstates, 2)
    da = rnd(dO) @ rnd(vc).transpose(-1, -2)
    G, H, A = _intra_chunk(uc, kc, bc, da, rnd, two,
                           None if bonus is None else bonus[:, None, None, :])
    dq = scale * (torch.exp(bq) * (rnd(dO) @ two(s_in).transpose(-1, -2)) + G)
    dk_inter = torch.exp(btot - bc) * (rnd(vc) @ two(ds_end).transpose(-1, -2))
    dk_ = dk_inter + H
    dsg = ((dsf * torch.exp(btot[:, :, -1, 0, :, None]) * states[-1]).sum(-1)
           + (kc[:, :, -1] * dk_inter[:, :, -1]).sum(-2))
    dv_ = (rnd(ktil) @ rnd(ds_end) + rnd(A).transpose(-1, -2) @ rnd(dO) if bonus is None
           else two(ktil) @ two(ds_end) + two(A).transpose(-1, -2) @ rnd(dO))
    dq, dk_, dv_ = (x.reshape(b, h, nc * C, -1)[:, :, :t] for x in (dq, dk_, dv_))
    return dq, dk_, dv_, dsg, ds


def _gate_grad(q, k, dq, dk, dsg):
    """dg_t = sum_{s>=t} (q_s dq_s - k_s dk_s) + dsf . S_final (``dsg``)."""
    return (q * dq - k * dk).flip(2).cumsum(2).flip(2) + dsg[:, :, None]


def gla_chunk_conv_bwd_chunked_plain(xq, xk, xv, gk, conv_q_w, conv_k_w, conv_v_w,
                                     initial_state, do, dsf, scale=None,
                                     operand_dtype: Optional[torch.dtype] = None):
    """The chunked route of :func:`gla_chunk_conv_bwd` written with tensors
    (same arguments and outputs, every gradient wanted), in f32; with
    ``operand_dtype`` every operand of a product is rounded to it first, as
    the kernels round theirs to bf16, those of the products that feed dq
    and dk in two rounded parts (:func:`_chunked_bwd_plain`). The convs as
    the forward takes them, the chunk walk on their outputs, then the conv's
    finishing pass: dg (:func:`_gate_grad`), silu', the transposed conv and
    the tap sums. Used by the tests, on the CPU against the Pallas backward
    and on the card against the kernels."""
    b, h, t, dk = xq.shape
    dv, w = xv.shape[-1], conv_q_w.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    io = xq.dtype
    rnd, two = _operand_rounding(operand_dtype)
    taps = [m.reshape(h, d, w) for m, d in ((conv_q_w, dk), (conv_k_w, dk), (conv_v_w, dv))]
    zq, zk, zv = (_conv_pre_rounded(x, tp) for x, tp in zip((xq, xk, xv), taps))
    q, k = zq * torch.sigmoid(zq), zk * torch.sigmoid(zk)
    v = (zv * torch.sigmoid(zv)).to(io).float()
    dq, dk_, dv_, dsg, ds = _chunked_bwd_plain(
        q * scale, k, v, gk.float(), None if initial_state is None else initial_state.float(),
        do.float(), dsf.float(), scale, rnd, two)
    dg = _gate_grad(q, k, dq, dk_, dsg)
    grads = [_conv_bwd_plain(dy, z, x, tp)
             for dy, z, x, tp in zip((dq, dk_, dv_), (zq, zk, zv), (xq, xk, xv), taps)]
    ds0 = None if initial_state is None else ds.to(initial_state.dtype)
    return (*(dx.to(io) for dx, _ in grads), dg,
            *(dw_.reshape(-1, w).to(io) for _, dw_ in grads), ds0)


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


# The classic step's two bodies (csrc/gla_decode.cuh), chosen by
# gla_decode_plan: "tile", the first body, a block per 32-column tile
# that forms the head's q and k itself and loads the state after them;
# "wide<T>", a block per column tile T threads across (16-byte words: T x 8
# bf16 or T x 4 f32 columns) that loads its state words first. The code of a
# wide route is its T.
_DECODE_ROUTE_CODE = {"tile": 0, "wide4": 4, "wide8": 8, "wide16": 16}
_WIDE_THREADS = 256  # threads of a wide-route block (csrc/gla_common.cuh:kThreads)


def _decode_split(q, k, v, gk, state, io, route):
    """S' = e^g S + k^T v and o = q S' (f32 q, k, v; q scaled) as the wide
    route ``route`` splits the readout: thread row phase p of a block (its
    256 / T threads down a column tile) sums the key rows i = p, p + 256 /
    T, ...; the block adds the phases' parts in order. Returns (o in the IO
    dtype, S' in the state's dtype)."""
    phases = _WIDE_THREADS // _DECODE_ROUTE_CODE[route]
    s = gk.float().exp()[..., None] * state.float() + k[..., None] * v[..., None, :]
    o = _sum_in_order([torch.einsum("bhk,bhkv->bhv", q[..., p::phases], s[..., p::phases, :])
                       for p in range(phases)])
    return o.to(io), s.to(state.dtype)


def gla_decode_conv_split_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                                scale=None, route: str = "wide16"):
    """:func:`gla_decode_conv_plain` computed as the CUDA kernel's wide route
    ``route`` splits it (tests only): a block of 256 threads per column
    tile, T of them across a row; a thread updates its columns of the key
    rows of its row phase and sums their part of the readout; the block
    adds the 256 / T phases' parts in order. Same signature and returns,
    plus the route; leaves ``state`` untouched."""
    _check("gla_decode_conv", state.dtype in _DTYPE_CODE, "the wide routes take an f32 or "
           "bf16 state")
    scale = xq.shape[-1] ** -0.5 if scale is None else scale
    io = xq.dtype
    (q, cq2), (k, ck2), (v, cv2) = (_ring_conv(x, w, c) for x, w, c in
                                    ((xq, wq, cq), (xk, wk, ck), (xv, wv, cv)))
    o, s = _decode_split(q.to(io).float() * scale, k.to(io).float(), v.to(io).float(), gk,
                         state, io, route)
    return o, s, cq2, ck2, cv2


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
    back as new tensors. It runs the body :func:`gla_decode_plan` picks;
    ``gla_decode_conv.routes`` counts each.
    """
    if not xq.is_cuda:
        return gla_decode_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv,
                                     state, scale)
    return _decode_conv_launch(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, scale)


def _decode_route(name, b, h, dk, dv, state, route):
    """The route a classic step takes: ``route`` if given (the card's checks
    force any body), else the plan's; checked against what the wide routes
    take."""
    route = gla_decode_plan(b, h, dk, dv, state.dtype) if route is None else route
    _check(name, route in _DECODE_ROUTE_CODE,
           f"route {route!r} not in {tuple(_DECODE_ROUTE_CODE)}")
    _check(name, route == "tile" or state.data_ptr() % 16 == 0,
           f"the {route} route takes a state on a 16-byte boundary (16-byte words)")
    return route


def _count_decode(fn, route, shape) -> None:
    fn.launches += 1
    fn.routes[route] += 1
    fn.shapes[(*shape, route)] += 1


def _decode_conv_launch(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, scale=None,
                        route=None):
    """:func:`gla_decode_conv` on CUDA tensors, on ``route`` if given, else
    on the plan's."""
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
    route = _decode_route(name, b, h, dk, dv, state, route)
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, dv, dtype=io, device=xq.device)
    cq2, ck2, cv2 = torch.empty_like(cq), torch.empty_like(ck), torch.empty_like(cv)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.gla_decode_conv_step(
        _ptr(xq), _ptr(xk), _ptr(xv), _ptr(gk), _ptr(wq), _ptr(wk), _ptr(wv),
        _ptr(cq), _ptr(ck), _ptr(cv), _ptr(state), _ptr(o), _ptr(cq2),
        _ptr(ck2), _ptr(cv2), b, h, dk, dv, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[state.dtype], _DECODE_ROUTE_CODE[route], ctypes.c_void_p(stream))
    _raise_on(name, err)
    _count_decode(gla_decode_conv, route, (b, h, dk, dv, io, state.dtype))
    return o, state, cq2, ck2, cv2


gla_decode_conv.launches, gla_decode_conv.shapes = 0, Counter()
gla_decode_conv.routes = dict.fromkeys(_DECODE_ROUTE_CODE, 0)


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


def gla_chunk_chunked_plain(q, k, v, gk, initial_state=None, scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked route of :func:`gla_chunk` written with tensors (same
    arguments and outputs): :func:`_chunked_fwd_plain` on q, k, v as they
    are, every product operand rounded to the IO dtype."""
    io = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    o, sf = _chunked_fwd_plain(q.float() * scale, k.float(), v.float(), gk.float(),
                               None if initial_state is None else initial_state.float(),
                               lambda x: x.to(io).float())
    return o.to(io), sf.to(state_dtype)


def gla_chunk(q, k, v, gk, initial_state=None, scale=None, chunk_size: int = 64
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA prefill on post-conv q, k, v.

    q, k: (b, h, t, dk) and v: (b, h, t, dv) in the IO dtype; gk: (b, h, t,
    dk) f32 log-gates; initial_state: (b, h, dk, dv) or None (zeros, f32).
    Returns o (b, h, t, dv) in the IO dtype and the final state in the
    initial state's dtype. ``chunk_size`` shapes the plain version only;
    the kernel takes any t >= 1. The route and the counts as
    :func:`gla_chunk_conv`'s (``gla_chunk.routes``). Differentiable: when
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


def _chunk_launch(q, k, v, gk, initial_state, scale, route=None):
    """Check the arguments and launch the forward kernel (CUDA tensors) on
    ``route`` (None: the plan's; the card's checks force either)."""
    name = "gla_chunk"
    b, h, t, dk, dv, io, st = _check_chunk_args(name, q, k, v, gk, initial_state)
    route = _fwd_route(name, io, b, h, t, dv, route)
    o = torch.empty(b, h, t, dv, dtype=io, device=q.device)
    sf = torch.empty(b, h, dk, dv, dtype=st, device=q.device)
    split = fwd_out_split(b, h, t, dv, sm_count(q.device)) if route == "chunked" else 1
    buf, scratch = (_scratch(_chunked_fwd_sizes(b, h, t, dk, dv, split), q.device)
                    if route == "chunked" else (None, [None] * 10))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_chunk_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(initial_state), _ptr(o),
        _ptr(sf), *scratch, b, h, t, dk, dv, float(scale), _DTYPE_CODE[io],
        _DTYPE_CODE[st], _ROUTE_CODE[route], split, ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk.launches += 1
    gla_chunk.routes[route] += 1
    gla_chunk.shapes[(b, h, t, dk, dv, io, None if initial_state is None else st,
                      float(scale), route)] += 1
    return o, sf


gla_chunk.launches, gla_chunk.shapes = 0, Counter()
gla_chunk.routes = dict.fromkeys(_ROUTE_CODE, 0)


# bf16 inputs shorter than this keep the recurrent sweeps: in chip_smoke.py's
# backward route sweep on an H100 (PERF.md §6; h4 dk256 dv256) the
# recurrent body won at t16 and t32 at b1, b2 and b8 (87-127 us against the
# chunked route's 106-139 at t32: its six launches cost about 95 us at any
# short length) and lost from t48 on at every batch (at t48 125-195 against
# 113-156). Lengths the sweep did not reach take the rule of the nearest it
# did.
_BWD_CHUNKED_MIN_T = 48


def gla_chunk_bwd_plan(io: torch.dtype, b: int, h: int, t: int, dv: int) -> str:
    """The body a :func:`gla_chunk_bwd` launch of IO dtype ``io`` on (b, h,
    t) heads of value dim ``dv`` runs, decided from these alone before the
    launch: ``"chunked"`` for bf16 IO from ``_BWD_CHUNKED_MIN_T`` tokens on
    (64-row chunks, products on the tensor cores in bf16 with f32 sums, as
    the TPU kernel rounds its products' operands to the IO dtype), else
    ``"recurrent"`` (the two time sweeps in f32, which an f32 caller
    expects and which are faster on a few tokens)."""
    return "chunked" if io == torch.bfloat16 and t >= _BWD_CHUNKED_MIN_T else "recurrent"


def _chunk_bwd_sizes(b, h, t, dk, dv, route):
    """Bytes of :func:`gla_chunk_bwd`'s scratch arrays on ``route``, in the C
    entry point's order: the parts of dq and dk (dv/32 each on the
    recurrent route, one on the chunked), the parts of the dsf . S_final
    term (dv/32, or ceil(dv/64) + 1), each segment's dg total; then the
    chunked route's own arrays (:func:`_chunked_bwd_sizes`; 0, not
    allocated, on the recurrent route)."""
    bh = b * h
    chunked = route == "chunked"
    parts, n_sg = (1, -(-dv // _CHUNK) + 1) if chunked else (dv // _BV, dv // _BV)
    own = _chunked_bwd_sizes(b, h, t, dk, dv) if chunked else [0] * 13
    return ([4 * parts * bh * t * dk] * 2 + [4 * n_sg * bh * dk, 4 * -(-t // _BWD_SEG) * bh * dk]
            + own)


def chunk_bwd_scratch_bytes(b: int, h: int, t: int, dk: int, dv: int, route: str) -> int:
    """Bytes of scratch one :func:`gla_chunk_bwd` call on ``route`` takes
    beside its outputs, in one allocation."""
    return _scratch_total(_chunk_bwd_sizes(b, h, t, dk, dv, route))


def gla_chunk_bwd(q, k, v, gk, initial_state, do, dsf, scale=None, need_ds0: bool = True):
    """Backward of :func:`gla_chunk` on CUDA tensors.

    Inputs as the forward's, plus ``do`` (b, h, t, dv) in the IO dtype and
    ``dsf`` (b, h, dk, dv) in the state dtype, the gradients of its two
    outputs. Returns (dq, dk, dv, dg, ds0): dq, dk, dv in the IO dtype, dg
    f32, ds0 in the state dtype (None without ``need_ds0`` or without an
    initial state).

    One call counts as one launch, and once more under its route in
    ``gla_chunk_bwd.routes`` (:func:`gla_chunk_bwd_plan`). Both routes end in
    the finishing pass of ``csrc/gla_chunk_bwd.cu`` (the parts of dq and dk
    added, rounded to the IO dtype, dg summed in reverse, its segments'
    carry). Their scratch, one allocation freed when the call returns
    (:func:`chunk_bwd_scratch_bytes`):

    - ``"recurrent"`` (f32 IO, and bf16 IO below 48 tokens): the two time
      sweeps of ``csrc/gla_chunk_bwd.cuh``; the per-tile parts of dq and
      dk, 2 * dv/32 * b*h*t*dk f32 values (268 MB at b8 h4 t512 dk256
      dv256);
    - ``"chunked"`` (bf16 IO from 48 tokens): the four kernels of
      ``csrc/gla_chunked_bwd.cuh`` without convs, 64-row chunks on the
      tensor cores, dv written in bf16 by the last; every chunk's start
      state and end-state cotangent in two bf16 parts (4 * b*h*nc*dk*dv, nc
      = ceil(t/64)); on t rounded up to whole chunks u = scale q, k and the
      in-chunk gate sums in f32, the decayed k and u in two bf16 parts each
      and v in bf16; dq and dk once in f32.
    """
    return _chunk_bwd_launch(q, k, v, gk, initial_state, do, dsf, scale, need_ds0)


def _chunk_bwd_launch(q, k, v, gk, initial_state, do, dsf, scale=None, need_ds0=True,
                      route=None):
    """Check the arguments and launch :func:`gla_chunk_bwd`'s kernels (CUDA
    tensors) on ``route`` (None: the plan's; the card's checks force
    either body of bf16 IO)."""
    name = "gla_chunk_bwd"
    _check(name, q.is_cuda, "runs on CUDA tensors only; on the CPU take "
           "autograd through gla_chunk_plain")
    b, h, t, dk, dv, io, st = _check_chunk_args(name, q, k, v, gk, initial_state, do, dsf)
    _check(name, do.shape == v.shape and do.dtype == io, "do must match v")
    _check(name, dsf.shape == (b, h, dk, dv) and dsf.dtype == st,
           f"dsf must be ({b}, {h}, {dk}, {dv}) in {st}")
    route = gla_chunk_bwd_plan(io, b, h, t, dv) if route is None else route
    _check(name, route in _ROUTE_CODE, f"route {route!r} not in {tuple(_ROUTE_CODE)}")
    _check(name, route == "recurrent" or io == torch.bfloat16,
           "the chunked route takes bf16 IO only")
    scale = dk ** -0.5 if scale is None else scale
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dg = torch.empty_like(gk)
    ds0 = (torch.empty_like(initial_state)
           if need_ds0 and initial_state is not None else None)
    buf, scratch = _scratch(_chunk_bwd_sizes(b, h, t, dk, dv, route), q.device)
    if route == "chunked" and do.data_ptr() % 16:  # rows of do are copied 16 bytes at a time
        do = do.clone()
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_chunk_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(initial_state), _ptr(do), _ptr(dsf),
        _ptr(dq), _ptr(dk_), _ptr(dv_), _ptr(dg), _ptr(ds0), *scratch, b, h, t, dk, dv,
        float(scale), _DTYPE_CODE[io], _DTYPE_CODE[st], _ROUTE_CODE[route],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_chunk_bwd.launches += 1
    gla_chunk_bwd.routes[route] += 1
    gla_chunk_bwd.shapes[(b, h, t, dk, dv, io, None if initial_state is None else st,
                          float(scale), ds0 is not None)] += 1
    return dq, dk_, dv_, dg, ds0


gla_chunk_bwd.launches, gla_chunk_bwd.shapes = 0, Counter()
gla_chunk_bwd.routes = dict.fromkeys(_ROUTE_CODE, 0)


def gla_chunk_bwd_chunked_plain(q, k, v, gk, initial_state, do, dsf, scale=None,
                                operand_dtype: Optional[torch.dtype] = None):
    """The chunked route of :func:`gla_chunk_bwd` written with tensors (same
    arguments and outputs, ds0 wherever there is an initial state), in f32,
    with ``operand_dtype`` rounding as in
    :func:`gla_chunk_conv_bwd_chunked_plain`: the chunk walk
    (:func:`_chunked_bwd_plain`) on q, k, v as they are, then dg
    (:func:`_gate_grad`). Used by the tests, on the CPU against the Pallas
    backward and on the card against the kernels."""
    io = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    rnd, two = _operand_rounding(operand_dtype)
    qf, kf = q.float(), k.float()
    dq, dk, dv, dsg, ds = _chunked_bwd_plain(
        qf * scale, kf, v.float(), gk.float(),
        None if initial_state is None else initial_state.float(), do.float(), dsf.float(), scale,
        rnd, two)
    ds0 = None if initial_state is None else ds.to(initial_state.dtype)
    return dq.to(io), dk.to(io), dv.to(io), _gate_grad(qf, kf, dq, dk, dsg), ds0


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


def gla_decode_split_plain(q, k, v, gk, state, scale=None, route: str = "wide16"):
    """:func:`gla_decode_plain` computed as the CUDA kernel's wide route
    ``route`` splits it (tests only; :func:`gla_decode_conv_split_plain`
    without the convs: q, k and v taken as they are). Same signature and
    returns, plus the route; leaves ``state`` untouched."""
    _check("gla_decode", state.dtype in _DTYPE_CODE, "the wide routes take an f32 or bf16 "
           "state")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _decode_split(q.float() * scale, k.float(), v.float(), gk, state, q.dtype, route)


def gla_decode(q, k, v, gk, state, scale=None):
    """One GLA decode token on q, k, v as they are: S <- diag(e^g) S + k^T v,
    o = (scale q) S.

    q, k: (b, h, dk) and v: (b, h, dv) in the IO dtype; gk: (b, h, dk) f32
    log-gates; state (b, h, dk, dv) in f32 or bf16. Returns (o (b, h, dv) in
    the IO dtype, state). On CUDA the kernel updates ``state`` IN PLACE and
    returns the same tensor (as the JAX kernel aliases its state buffer). It
    runs the body :func:`gla_decode_plan` picks; ``gla_decode.routes``
    counts each.
    """
    if not q.is_cuda:
        return gla_decode_plain(q, k, v, gk, state, scale)
    return _decode_launch(q, k, v, gk, state, scale)


def _decode_launch(q, k, v, gk, state, scale=None, route=None):
    """:func:`gla_decode` on CUDA tensors, on ``route`` if given, else on
    the plan's."""
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
    route = _decode_route(name, b, h, dk, dv, state, route)
    scale = dk ** -0.5 if scale is None else scale
    o = torch.empty(b, h, dv, dtype=io, device=q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.gla_decode_step(
        _ptr(q), _ptr(k), _ptr(v), _ptr(gk), _ptr(state), _ptr(o), b, h, dk, dv,
        float(scale), _DTYPE_CODE[io], _DTYPE_CODE[state.dtype], _DECODE_ROUTE_CODE[route],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    _count_decode(gla_decode, route, (b, h, dk, dv, io, state.dtype))
    return o, state


gla_decode.launches, gla_decode.shapes = 0, Counter()
gla_decode.routes = dict.fromkeys(_DECODE_ROUTE_CODE, 0)


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
    if s_scale is None:
        step = gla_ops.gla_decode_lazy_step
    elif is_int4(state, xv):
        step = gla_ops.gla_decode_lazy_step_q4
    else:
        step = gla_ops.gla_decode_lazy_step_q
    o, kbuf, vbuf, cbuf, cc = step(
        q, k.to(kbuf.dtype), v.to(vbuf.dtype), gk, *base, kbuf, vbuf, cbuf, cc,
        p, scale=scale)
    return o.to(xq.dtype), cq2, ck2, cv2, kbuf, vbuf, cbuf, cc


_LAZY_ROWS = 32  # key rows a block of the lazy step's cluster route owns (kRB)
_LAZY_SLAB = 65536  # most state bytes a block stages (kSlabBytes)


def _lazy_slab_width(dk: int, dv: int, state: torch.Tensor) -> int:
    """Columns of a lazy-step block's slab (the kernel's slab_width): dv cut
    into the fewest equal tiles whose columns are a multiple of R = dk / 32
    times the kernel's loads (4 values) and whose slab is at most
    _LAZY_SLAB bytes."""
    quantum = dk // _LAZY_ROWS * 4
    for t in range(1, dv // quantum + 1):
        w = dv // t
        if dv % t == 0 and w % quantum == 0 and _LAZY_ROWS * w * state.element_size() <= _LAZY_SLAB:
            return w
    return quantum


def gla_decode_lazy_conv_split_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state,
                                     kbuf, vbuf, cbuf, cc, p: int, scale=None):
    """:func:`gla_decode_lazy_conv_plain` computed as the CUDA kernel's
    cluster route splits it (tests only), on a float state as that route
    takes it. A cluster of R ranks per head, each owning 32 key rows: rank r
    forms its part of every window score and of the base readout at every
    column of a tile (:func:`_lazy_slab_width` columns), over its rows; the
    block that owns a column slice (tile width / R) adds the R parts in rank
    order, then the slice's window terms. Same signature (without
    ``s_scale``) and returns."""
    _check("gla_decode_lazy_conv", state.dtype in _DTYPE_CODE,
           "the cluster route takes an f32 or bf16 state")
    b, h, dk = xq.shape
    dv = xv.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    q, cq2 = _ring_conv(xq, wq, cq)
    k, ck2 = _ring_conv(xk, wk, ck)
    v, cv2 = _ring_conv(xv, wv, cv)
    cc2 = cc + gk.float()
    kbuf, vbuf, cbuf = kbuf.clone(), vbuf.clone(), cbuf.clone()
    kbuf[p], vbuf[p], cbuf[p] = k.to(kbuf.dtype), v.to(vbuf.dtype), cc2
    q = q * scale
    qe = q * cc2.exp()
    ranks = [slice(r * _LAZY_ROWS, (r + 1) * _LAZY_ROWS) for r in range(dk // _LAZY_ROWS)]
    # rank r's part of every score a_j (j <= p; slot p's exp argument is 0)
    keys = kbuf[:p + 1].float() * (cc2[None] - cbuf[:p + 1]).clamp(max=0.0).exp()
    a = _sum_in_order([(q[None, ..., rw] * keys[..., rw]).sum(-1) for rw in ranks])
    vals = vbuf[:p + 1].float()
    sf = state.float()
    w = _lazy_slab_width(dk, dv, state)
    o = torch.empty(b, h, dv, dtype=torch.float32, device=xq.device)
    for c0 in range(0, dv, w):
        cols = slice(c0, c0 + w)
        base = _sum_in_order([torch.einsum("bhk,bhkv->bhv", qe[..., rw], sf[..., rw, cols])
                              for rw in ranks])
        o[..., cols] = base + (a[..., None] * vals[..., cols]).sum(0)
    return o.to(xq.dtype), cq2, ck2, cv2, kbuf, vbuf, cbuf, cc2


def _sum_in_order(parts):
    """parts[0] + parts[1] + ..., left to right."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def is_int4(state, v) -> bool:
    """Whether an int8 ``state`` is int4 nibble-packed: its last dim is
    half of the value dim of ``v`` (a token's v or the window's vbuf)."""
    return state.dtype == torch.int8 and state.shape[-1] != v.shape[-1]


def _check_state_scale(name, state, s_scale) -> None:
    """An int8 or int4 state comes with its f32 row scales (b, h, dk), a
    float state without."""
    if state.dtype == torch.int8:
        _check(name, s_scale is not None, "an int8 state needs s_scale")
        _check(name, s_scale.shape == state.shape[:-1] and s_scale.dtype == torch.float32,
               f"s_scale must be {tuple(state.shape[:-1])} in f32")
    else:
        _check(name, s_scale is None, "s_scale goes with an int8 state only")


# The lazy step's two bodies (csrc/gla_decode_lazy_conv.cu). "cluster": a
# thread block cluster per head that reads the state in bulk and forms every
# per-head term once, for f32 and bf16 states; "tile": the PR 3 / PR 5 body,
# a block per 32-column tile (128 over an int8 state) that forms the head's
# q, k and scores itself, the only body for an int8 state. chip_smoke.py's
# route sweep on an H100 (PERF.md §6, PR 14; h4 dk256 dv512, window 16, p 0,
# 7 and 15, b 1 to 16) set the threshold: the tile route won at 4, 8 and 16
# heads in flight, by 10-40%; the cluster route from 24 heads, but for ties
# (within 1%) at 24 heads on an f32 state and at 32 on a bf16 state at p 0,
# and an f32 state at 32 heads and p 0 (9% slower: the plan does not split
# by p). Head counts between 16 and 24 were not measured.
_LAZY_ROUTE_CODE = {"tile": 0, "cluster": 1}
_LAZY_CLUSTER_MIN_HEADS = 24  # b * h from which a float state takes the cluster route


def gla_decode_lazy_plan(b: int, h: int, state_dtype) -> str:
    """The body a :func:`gla_decode_lazy_conv` launch on (b, h) heads over a
    state of ``state_dtype`` (a torch dtype, or :data:`INT4`) runs, decided
    from these alone before the launch: ``"cluster"`` for an f32 or bf16
    state from ``_LAZY_CLUSTER_MIN_HEADS`` heads in flight, else ``"tile"``
    (an int8 or int4 state's only body)."""
    float_state = state_dtype in _DTYPE_CODE
    return "cluster" if float_state and b * h >= _LAZY_CLUSTER_MIN_HEADS else "tile"


# The classic step's plan, from scripts/torch_decode_ab.py --routes on an H100
# (PERF.md §6; h4 dk256 dv512 and dv256 bf16 IO, h32 dk64 dv64 f32
# IO, b 1 to 128, bf16 and f32 states): the tile body won or tied only on
# states of at most 512 KiB (Mamba-2's at b1, simple-GLA's bf16 one at b1);
# above, a wide route won, the fastest being the one with the fewest threads
# across a row (the most blocks) whose grid stayed within about three
# blocks an SM, and the widest tile that fits the head once no grid did.
# chip_smoke.py's decode_route_sweep holds the plan to the tile body.
_DECODE_TILE_MAX_BYTES = 1 << 19  # states up to 512 KiB take the tile body
_DECODE_WIDE_MAX_BLOCKS = 400  # blocks of a wide grid the plan aims within


def decode_wide_route(b: int, h: int, dv: int, state_dtype: torch.dtype) -> str:
    """The wide route a classic step on (b, h) heads of value dim ``dv``
    over a state of ``state_dtype`` takes: the fewest threads across a row,
    T of 4, 8 and 16 (a block's tile T x 16 bytes of a row, no wider than
    dv), whose grid of b h ceil(dv / tile) blocks is at most
    ``_DECODE_WIDE_MAX_BLOCKS``; else the widest that fits."""
    per_word = 16 // state_dtype.itemsize
    fits = [t for t in (4, 8, 16) if t * per_word <= dv] or [4]
    for t in fits:
        if b * h * -(-dv // (t * per_word)) <= _DECODE_WIDE_MAX_BLOCKS:
            return f"wide{t}"
    return f"wide{fits[-1]}"


@functools.lru_cache(maxsize=None)
def gla_decode_plan(b: int, h: int, dk: int, dv: int, state_dtype: torch.dtype) -> str:
    """The body a :func:`gla_decode_conv` or :func:`gla_decode` launch on
    (b, h) heads of key dim ``dk`` and value dim ``dv`` over a state of
    ``state_dtype`` runs, decided from these alone before the launch:
    ``"tile"`` for a state of at most ``_DECODE_TILE_MAX_BYTES``, else
    :func:`decode_wide_route`."""
    if b * h * dk * dv * state_dtype.itemsize <= _DECODE_TILE_MAX_BYTES:
        return "tile"
    return decode_wide_route(b, h, dv, state_dtype)


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
    the readout is then ``(q e^{cc} s_scale) S_q``; or int4, an int8 (b, h,
    dk, dv // 2) with its row scales (``ops/gla.py:
    quantize_state_rows_int4``): the readout is then ``concat(w lo, w hi)``
    over the packed bytes' low and high nibbles, ``w = q e^{cc} s_scale``.

    On CUDA the kernel writes slot ``p`` of kbuf, vbuf and cbuf IN PLACE and
    returns the same tensors (as the JAX kernel aliases them); the rings
    and cc come back as new tensors. It runs the body
    :func:`gla_decode_lazy_plan` picks; ``gla_decode_lazy_conv.routes``
    counts each; ``.q_launches`` counts the launches on an int8 or int4
    state and ``.q4_launches`` those on an int4 one.
    """
    if not xq.is_cuda:
        return gla_decode_lazy_conv_plain(xq, xk, xv, gk, wq, wk, wv, cq, ck,
                                          cv, state, kbuf, vbuf, cbuf, cc, p,
                                          scale, s_scale)
    return _lazy_launch(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf, cbuf,
                        cc, p, scale, s_scale)


def _lazy_launch(xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf, cbuf, cc,
                 p, scale=None, s_scale=None, route=None):
    """:func:`gla_decode_lazy_conv` on CUDA tensors, on ``route`` if given
    (the card's checks force either body), else on the plan's."""
    name = "gla_decode_lazy_conv"
    b, h, dk = xq.shape
    dv = xv.shape[-1]
    io = xq.dtype
    _check_state_scale(name, state, s_scale)
    quant = s_scale is not None
    int4 = quant and is_int4(state, xv)
    tensors = [xq, xk, xv, gk, wq, wk, wv, cq, ck, cv, state, kbuf, vbuf, cbuf, cc]
    _check_cuda_args(name, tensors + ([s_scale] if quant else []), io, dk, dv,
                     torch.float32 if quant else state.dtype)
    _check(name, not quant or dv % (4 * _BV) == 0,
           f"with an int8 or int4 state the head value dim {dv} must be a multiple of "
           f"{4 * _BV}")
    state_code = _INT4_CODE if int4 else _INT8_CODE if quant else _DTYPE_CODE[state.dtype]
    _check(name, xk.shape == xq.shape and xk.dtype == io, "xk must match xq")
    _check(name, xv.shape == (b, h, dv) and xv.dtype == io, "xv shape/dtype")
    _check(name, gk.shape == xq.shape and gk.dtype == torch.float32,
           "gk must be f32 of xq's shape")
    for wt, ring, d in ((wq, cq, dk), (wk, ck, dk), (wv, cv, dv)):
        _check(name, wt.shape == (_CONV_WIDTH, h, d) and wt.dtype == io,
               f"taps must be ({_CONV_WIDTH}, {h}, {d}) in {io}")
        _check(name, ring.shape == (_CONV_WIDTH, b, h, d) and ring.dtype == io,
               f"rings must be ({_CONV_WIDTH}, {b}, {h}, {d}) in {io}")
    _check(name, state.shape == (b, h, dk, dv // 2 if int4 else dv), "state shape")
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, io)
    _check(name, isinstance(p, int) and 0 <= p < L,
           f"p must be an int in [0, {L}), got {p!r}")
    label = INT4 if int4 else state.dtype
    route = gla_decode_lazy_plan(b, h, label) if route is None else route
    _check(name, route in _LAZY_ROUTE_CODE,
           f"route {route!r} not in {tuple(_LAZY_ROUTE_CODE)}")
    _check(name, route == "tile" or not quant,
           "the cluster route takes no int8 state, nor an int4 one")
    _check(name, route == "tile" or state.data_ptr() % 16 == 0,
           "the cluster route takes a state on a 16-byte boundary (it is copied in bulk)")
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
        state_code, _LAZY_ROUTE_CODE[route], ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_decode_lazy_conv.launches += 1
    gla_decode_lazy_conv.routes[route] += 1
    if quant:
        gla_decode_lazy_conv.q_launches += 1
    if int4:
        gla_decode_lazy_conv.q4_launches += 1
    gla_decode_lazy_conv.shapes[(b, h, dk, dv, io, label, L, p, route)] += 1
    return o, cq2, ck2, cv2, kbuf, vbuf, cbuf, cc2


# q_launches: how many of the launches read an int8 or int4 state;
# q4_launches: an int4 one
gla_decode_lazy_conv.launches = gla_decode_lazy_conv.q_launches = 0
gla_decode_lazy_conv.q4_launches = 0
gla_decode_lazy_conv.routes = dict.fromkeys(_LAZY_ROUTE_CODE, 0)
gla_decode_lazy_conv.shapes = Counter()


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
# The two folds (csrc/gla_fold.cu, csrc/gla_fold_q.cu; the update on the tensor
# cores in csrc/gla_fold.cuh): a block a band of key rows of one head in 1, 2
# or 4 sub-bands of whole 16-row warp tiles. A warp takes 64 value columns of
# an int8 row (a row stays in one block: dv / 64 warps across) or of a float
# one (32 where the head has an odd number of 32-column groups; a float head
# wider than a block's warps splits its columns across blocks). The launch's
# route is the band height, "band{R}".
_FOLD_MAX_WARPS = {"gla_fold": 16, "gla_fold_q": 8}  # warps of a block (kMaxWarps)
# The plans' rule, from chip_smoke.py's fold_route_sweep on an H100 (PERF.md
# §6): the fastest band at b1, b8 and b64 on the flagship's head (bf16
# and int8 states) and at b8 on simple-GLA's (f32) and Mamba-2's was the
# smallest whose grid stayed within about one wave of 16 warps an SM (2,048
# warps on 132 SMs), blocks of one warp lost, and at b64, where no band
# stays within it, the tallest won. On the flagship's head with an f32 state,
# which no path folds, the smallest band beat the plan's at b8.
_FOLD_GRID_WARPS = 2048


def _fold_kernel(state_dtype: torch.dtype) -> str:
    return "gla_fold_q" if state_dtype == torch.int8 else "gla_fold"


def _fold_warps(dk: int, dv: int, state_dtype: torch.dtype, r: int):
    """(warps across a block, warps down a sub-band, sub-bands, column
    blocks of a head) of a band of ``r`` rows (``band_shape`` in the
    sources): as many warps down as the block has room for and divide the
    band's 16-row tiles."""
    cap = _FOLD_MAX_WARPS[_fold_kernel(state_dtype)]
    if state_dtype == torch.int8:
        across, col_blocks = dv // 64, 1
    else:
        groups = dv // 32
        warps_head = groups // (2 if groups % 2 == 0 else 1)
        across = min(warps_head, cap)
        col_blocks = -(-warps_head // across)
    down = min(cap // across, r // 16)
    while r // 16 % down:
        down -= 1
    return across, down, r // (16 * down), col_blocks


def fold_band_heights(dk: int, dv: int, state_dtype: torch.dtype) -> Tuple[int, ...]:
    """The band heights the fold of a head of key dim ``dk`` and value dim
    ``dv`` over a state of ``state_dtype`` (int8: :func:`gla_fold_q`, else
    :func:`gla_fold`) can take: whole 16-row warp tiles dividing dk, in 1, 2
    or 4 sub-bands."""
    return tuple(r for r in range(16, dk + 1, 16)
                 if dk % r == 0 and _fold_warps(dk, dv, state_dtype, r)[2] in (1, 2, 4))


def _fold_plan(b: int, h: int, dk: int, dv: int, state_dtype: torch.dtype) -> str:
    def grid(r):
        across, down, _, col_blocks = _fold_warps(dk, dv, state_dtype, r)
        return across * down, b * h * (dk // r) * col_blocks * across * down

    heights = [r for r in fold_band_heights(dk, dv, state_dtype) if grid(r)[0] >= 2]
    fits = [r for r in heights if grid(r)[1] <= _FOLD_GRID_WARPS]
    return f"band{min(fits) if fits else max(heights)}"


@functools.lru_cache(maxsize=None)
def gla_fold_plan(b: int, h: int, dk: int, dv: int, state_dtype: torch.dtype) -> str:
    """The band a :func:`gla_fold` launch on (b, h) heads of key dim ``dk``
    and value dim ``dv`` over a float state of ``state_dtype`` takes,
    decided from these alone before the launch: ``"band{R}"``, R the
    smallest height of :func:`fold_band_heights` whose blocks have two
    warps or more and whose grid at most ``_FOLD_GRID_WARPS`` warps, else
    the tallest."""
    return _fold_plan(b, h, dk, dv, state_dtype)


@functools.lru_cache(maxsize=None)
def gla_fold_q_plan(b: int, h: int, dk: int, dv: int) -> str:
    """The band a :func:`gla_fold_q` launch on (b, h) int8 or int4 heads of
    value dim ``dv`` takes, by the rule of :func:`gla_fold_plan`. The int4
    body's blocks are the int8 body's (whole rows, dv / 64 warps across,
    each thread's 16 columns of a row from 8 packed bytes), so the two take
    the same bands."""
    return _fold_plan(b, h, dk, dv, torch.int8)


def _fold_rows(name: str, route: str, dk: int, dv: int, state_dtype) -> int:
    """The band height of ``route``; raises for another name or a height
    the fold cannot cut this head into."""
    heights = fold_band_heights(dk, dv, state_dtype)
    _check(name, isinstance(route, str) and route.startswith("band") and route[4:].isdigit()
           and int(route[4:]) in heights,
           f"route {route!r} not in {tuple(f'band{r}' for r in heights)}")
    return int(route[4:])


def _check_fold_words(name: str, state, vbuf) -> None:
    """The folds read the state and v in 16-byte words."""
    _check(name, state.data_ptr() % 16 == 0 and vbuf.data_ptr() % 16 == 0,
           "the state and vbuf must lie on 16-byte boundaries (the fold reads them in "
           "16-byte words)")


def gla_fold_plain(state, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """Plain version of :func:`gla_fold` (returns a new tensor)."""
    return gla_ops.gla_decode_lazy_fold(state, kbuf, vbuf, cbuf, cc)


def _bf16_parts(x: torch.Tensor, n: int):
    """x (f32) as n bf16 parts, each the rounding of what the parts before
    it left (``split_bf16`` in csrc/gla_fold.cuh), held as f32."""
    parts, rest = [], x
    for _ in range(n):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def _fold_update_parts(kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """The folds' rank-L update as their tensor-core kernels take it: the
    decayed keys in three bf16 parts, v in three (f32 buffers) or one (bf16,
    exact), the products of parts a and b with a + b < 3 summed in f32."""
    kd = kbuf.float() * (cc[None] - cbuf.float()).clamp(max=0.0).exp()
    kp = _bf16_parts(kd, 3)
    vp = _bf16_parts(vbuf.float(), 3 if vbuf.dtype == torch.float32 else 1)
    return sum(torch.einsum("lbhk,lbhv->bhkv", kp[a], vp[b])
               for a in range(3) for b in range(len(vp)) if a + b < 3)


def gla_fold_parts_plain(state, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """:func:`gla_fold_plain` with the kernel's decomposition of the update
    into bf16 parts (:func:`_fold_update_parts`): the mirror the card holds
    the kernel against, and the CPU holds against the Pallas kernel."""
    s = cc.exp()[..., None] * state.float() + _fold_update_parts(kbuf, vbuf, cbuf, cc)
    return s.to(state.dtype)


def gla_fold(state, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """Fold a FULL lazy window into the recurrent state.

    state (b, h, dk, dv); kbuf (L, b, h, dk), vbuf (L, b, h, dv) in one
    float dtype; cbuf (L, b, h, dk) and cc (b, h, dk) in f32. Returns the
    new state; the buffers are left as they are (stale by contract) and the
    caller resets ``cc``. On CUDA the kernel updates ``state`` IN PLACE, in
    the bands :func:`gla_fold_plan` picks, and returns the same tensor.
    """
    if not state.is_cuda:
        return gla_fold_plain(state, kbuf, vbuf, cbuf, cc)
    return _fold_launch(state, kbuf, vbuf, cbuf, cc)


def _fold_launch(state, kbuf, vbuf, cbuf, cc, route=None) -> torch.Tensor:
    """:func:`gla_fold` on CUDA tensors, in the bands of ``route`` if given
    (the card's checks time every height), else of the plan's."""
    name = "gla_fold"
    b, h, dk, dv = state.shape
    _check_cuda_args(name, [state, kbuf, vbuf, cbuf, cc], kbuf.dtype, dk, dv,
                     state.dtype)
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, kbuf.dtype)
    route = gla_fold_plan(b, h, dk, dv, state.dtype) if route is None else route
    rows = _fold_rows(name, route, dk, dv, state.dtype)
    _check_fold_words(name, state, vbuf)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.gla_fold_window(
        _ptr(state), _ptr(kbuf), _ptr(vbuf), _ptr(cbuf), _ptr(cc), b, h, dk,
        dv, L, _DTYPE_CODE[kbuf.dtype], _DTYPE_CODE[state.dtype], rows,
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_fold.launches += 1
    gla_fold.shapes[(b, h, dk, dv, kbuf.dtype, state.dtype, L)] += 1
    return state


gla_fold.launches = 0
gla_fold.shapes = Counter()


# --------------------------------------------- window fold of an int8 state

def gla_fold_q_plain(state_q, s_scale, kbuf, vbuf, cbuf, cc):
    """Plain version of :func:`gla_fold_q` (returns new tensors), on an
    int8 or an int4 state."""
    fold = (gla_ops.gla_decode_lazy_fold_q4 if is_int4(state_q, vbuf)
            else gla_ops.gla_decode_lazy_fold_q)
    return fold(state_q, s_scale, kbuf, vbuf, cbuf, cc)


def gla_fold_q_parts_plain(state_q, s_scale, kbuf, vbuf, cbuf, cc):
    """:func:`gla_fold_q_plain` with the kernel's decomposition of the
    update (:func:`_fold_update_parts`); the requantization as the plain
    version's (the kernel's quotient is the true division's, bit for bit),
    on an int8 or an int4 state."""
    if is_int4(state_q, vbuf):
        s = cc.exp()[..., None] * gla_ops.dequantize_state_int4(state_q, s_scale)
        return gla_ops.quantize_state_rows_int4(s + _fold_update_parts(kbuf, vbuf, cbuf, cc))
    s = (cc.exp() * s_scale)[..., None] * state_q.float()
    return gla_ops.quantize_state_rows(s + _fold_update_parts(kbuf, vbuf, cbuf, cc))


def gla_fold_q(state_q, s_scale, kbuf, vbuf, cbuf, cc):
    """Fold a FULL lazy window into an int8 recurrent state and requantize
    every row: ``S = (e^{cc} s_scale) S_q + sum_j (k_j e^{min(cc - c_j,
    0)})^T v_j``, then ``sc = max(max_v |S|, 1e-30) / 127`` and ``S_q =
    clip(round(S / sc), +-127)``.

    state_q (b, h, dk, dv) int8; s_scale (b, h, dk) f32; the window buffers
    as :func:`gla_fold`. Returns (state_q, s_scale); the buffers are left as
    they are and the caller resets ``cc``. On CUDA the kernel updates
    ``state_q`` and ``s_scale`` IN PLACE, in the bands
    :func:`gla_fold_q_plan` picks, and returns the same tensors.

    An int4 state (b, h, dk, dv // 2), two values a byte
    (``ops/gla.py:quantize_state_rows_int4``), is unpacked, folded and
    requantized to int4 (``/ 7``, ``+-7``) and packed again, by the
    kernel's int4 body; ``.q4_launches`` counts those launches.
    """
    if not state_q.is_cuda:
        return gla_fold_q_plain(state_q, s_scale, kbuf, vbuf, cbuf, cc)
    return _fold_q_launch(state_q, s_scale, kbuf, vbuf, cbuf, cc)


def _fold_q_launch(state_q, s_scale, kbuf, vbuf, cbuf, cc, route=None):
    """:func:`gla_fold_q` on CUDA tensors, in the bands of ``route`` if
    given (the card's checks time every height), else of the plan's."""
    name = "gla_fold_q"
    _check(name, state_q.dtype == torch.int8 and state_q.dim() == 4,
           "the state must be int8 (b, h, dk, dv), or int4 (b, h, dk, dv // 2)")
    b, h, dk, dv = *state_q.shape[:3], vbuf.shape[-1]
    int4 = is_int4(state_q, vbuf)
    _check(name, state_q.shape[-1] == (dv // 2 if int4 else dv),
           f"the state's last dim must be dv {dv} (int8) or dv / 2 (int4)")
    _check_state_scale(name, state_q, s_scale)
    _check_cuda_args(name, [state_q, s_scale, kbuf, vbuf, cbuf, cc], kbuf.dtype, dk, dv,
                     torch.float32)
    _check(name, dv in _FOLD_Q_DV, f"head value dim {dv} not in {_FOLD_Q_DV}")
    L = _check_window(name, kbuf, vbuf, cbuf, cc, b, h, dk, dv, kbuf.dtype)
    route = gla_fold_q_plan(b, h, dk, dv) if route is None else route
    rows = _fold_rows(name, route, dk, dv, torch.int8)
    _check_fold_words(name, state_q, vbuf)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(state_q.device).cuda_stream
    err = lib.gla_fold_q_window(
        _ptr(state_q), _ptr(s_scale), _ptr(kbuf), _ptr(vbuf), _ptr(cbuf), _ptr(cc),
        b, h, dk, dv, L, _DTYPE_CODE[kbuf.dtype], _INT4_CODE if int4 else _INT8_CODE, rows,
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    gla_fold_q.launches += 1
    if int4:
        gla_fold_q.q4_launches += 1
    gla_fold_q.shapes[(b, h, dk, dv, kbuf.dtype, INT4 if int4 else torch.int8, L)] += 1
    return state_q, s_scale


# q4_launches: how many of the launches folded an int4 state
gla_fold_q.launches = gla_fold_q.q4_launches = 0
gla_fold_q.shapes = Counter()
