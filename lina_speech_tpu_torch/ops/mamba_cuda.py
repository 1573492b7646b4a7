"""The Mamba (v1) kernels of the generate, serving and training paths: CUDA
wrappers and their plain versions.

- :func:`mamba_scan` replaces ``mamba_scan_pallas``
  (lina_speech_tpu/ops/mamba_pallas.py:468), the prefill and the training
  forward of every Mamba-1 mixer. Kernel: ``csrc/mamba_scan.cu``, the
  backward's time walk (``csrc/mamba_common.cuh``) writing y, over the
  whole length or, where :func:`mamba_scan_plan` cuts time into chunks
  (small batches), in chunks of L steps that run in parallel (chunk
  summaries, the carry, each chunk's walk from its start state); its plain
  version is :func:`mamba_scan_chunked_plain`. It is
  differentiable: when autograd records, it runs through a
  ``torch.autograd.Function`` whose backward is :func:`mamba_scan_bwd`
  (``csrc/mamba_scan_bwd.cu``, replacing ``_bwd_kernel``,
  mamba_pallas.py:86): time cut into chunks of L steps that run in
  parallel (chunk summaries, a carry across chunks, the segment walk inside
  each chunk), L from :func:`mamba_scan_bwd_plan`, one chunk for short
  inputs; its plain version is :func:`mamba_scan_bwd_chunked_plain`. The
  plain backward is autograd through :func:`mamba_scan_plain`.

A decode token runs the plain ``ops/mamba.py:selective_step``, as in the
JAX package: no Pallas kernel serves it.

The wrappers take the JAX function's arguments in its public layout: x and
dt (b, t, d), A (d, n), B and C (b, t, n), D (d), an optional initial state
(b, d, n) and an optional reset mask (b, t) bool. x, B and C are in the IO
dtype (f32 or bf16); dt, A, D and the state in f32. For a CPU tensor a
wrapper runs its plain version; for a CUDA tensor it launches the kernel or
raises -- there is no fallback. Each counts its launches
(``mamba_scan.launches``; ``mamba_scan.routes`` and
``mamba_scan_bwd.routes`` by route) and notes the shapes it was launched on
(:func:`launch_shapes`). Which shapes the
kernels take is :func:`kernel_takes`, decided from shapes and dtypes before
any launch; a layer asks it and takes the plain version for a shape it
refuses, and a wrapper called on such a shape raises.

Both the kernels and the plain versions compute in f32; they differ by the
order of f32 sums and by the exponential (the kernels' exp2f of dt A
log2 e), not by rounding points.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.ops import _build
from lina_speech_tpu_torch.ops import mamba as mamba_ops
from lina_speech_tpu_torch.ops.gla_cuda import (
    _DTYPE_CODE, _check, _ptr, _raise_on, _scratch, _scratch_total,
)

_N = 16  # state size the kernels are built for (csrc/mamba_common.cuh:kN)
_CHANNELS = 32  # the granularity of d (csrc/mamba_common.cuh:kChannels)
_BLOCK_CHANNELS = 64  # channels per block of both walks (kCh)
_SEG = 16  # steps per segment of the walks and per checkpoint of the backward (kSeg)
_ROUTES = ("one_chunk", "chunked")


def _wrappers():
    return (mamba_scan, mamba_scan_bwd)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
        fn.shapes = Counter()
        fn.routes = dict.fromkeys(_ROUTES, 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launch_shapes() -> dict:
    """What each kernel was launched on since the last reset, a set of
    tuples each: ``mamba_scan`` (b, t, d, n, IO dtype, initial state dtype
    or None, whether a reset mask was given, the chunk length L, which names
    the route: :func:`bwd_route`); ``mamba_scan_bwd`` the same with need_ds0
    before L."""
    return {fn.__name__: set(fn.shapes) for fn in _wrappers()}


def launch_shape_counts() -> dict:
    """:func:`launch_shapes` with the number of launches on each shape."""
    return {fn.__name__: Counter(fn.shapes) for fn in _wrappers()}


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
# Where and how the forward cuts t into chunks, from chip_smoke.py's
# chunk-length sweep on an H100 (PERF.md §6; d 2048, bf16 IO, no initial
# state, medians of six turns; us). One chunk of 64-channel blocks walks
# about 0.13 us a step whatever the batch up to b4 (t512: 69.2 at b1, 69.5
# at b4), so chunks pay only where one chunk's blocks leave most SMs idle:
# at b4 (128 blocks) one chunk was the fastest at every length (t512 69.5
# against 71.9 at L64), at b8 too; at b1 and b2 (32 and 64 blocks) the
# fastest cut gave about 500 to 1,000 blocks in all, in chunks of a
# power-of-two number of segments (b1 t512 L32 23.6 against 69.2 in one
# chunk; b2 t512 L64 40.2, L32 40.7, L48 45.6; b2 t319 L32 28.4, L48 32.1;
# b1 t128 L16 10.9 against 18.8). One chunk won up to 48 steps at b1 (t48
# 8.4 against 9.2 at L16; L16 won at t64, 9.5 against 10.5) and up to 64
# at b2 (t64 10.5 against 11.0 at L16; L16 won at t96, 13.3 against 14.7):
# the summaries, the carry and two more launches cost more with more
# blocks.
_FWD_CHUNKED_MAX_BLOCKS = 64  # blocks of one chunk up to which chunks are cut
_FWD_BLOCKS = 6 * 132  # walk blocks of all chunks the plan aims at: six an SM
_FWD_ONE_CHUNK_MAX_T = 32  # plus half the blocks of a chunk: 48 steps at b1, 64 at b2


def _whole_segments(t: int) -> int:
    return -(-t // _SEG) * _SEG


@functools.lru_cache(maxsize=None)
def mamba_scan_plan(b: int, t: int, d: int) -> int:
    """The chunk length L a :func:`mamba_scan` launch on (b, t, d) takes,
    decided from these alone before the launch: a multiple of the 16-step
    segment; L >= t is one chunk (route ``"one_chunk"``: one walk from s0
    over the whole length), below t the ``"chunked"`` route (the chunk
    summaries, the carry, every chunk's walk from its start state in
    parallel). One chunk where its b * ceil(d / 64) blocks are more than
    ``_FWD_CHUNKED_MAX_BLOCKS`` or t is at most ``_FWD_ONE_CHUNK_MAX_T``
    plus half those blocks; else the shortest chunk of a power-of-two
    number of segments that cuts t into no more chunks than
    ``_FWD_BLOCKS`` blocks fill."""
    blocks = b * -(-d // _BLOCK_CHANNELS)
    if blocks > _FWD_CHUNKED_MAX_BLOCKS or t <= _FWD_ONE_CHUNK_MAX_T + blocks // 2:
        return _whole_segments(t)
    n_chunk, chunk = round(_FWD_BLOCKS / blocks), _SEG
    while chunk * n_chunk < t:
        chunk *= 2
    return chunk


def _fwd_sizes(b, t, d, chunk):
    """Bytes of :func:`mamba_scan`'s scratch arrays, in the C entry point's
    order, f32: the chunk summaries h_loc (the chunks' start states after
    the carry) and P (chunked route only; 0: not allocated)."""
    nc = -(-t // chunk)
    return [4 * b * nc * d * _N] * 2 if nc > 1 else [0, 0]


def mamba_scan_plain(x, dt, A, B, C, D, initial_state=None, reset_mask=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mamba_scan` (same signature):
    ``ops/mamba.py:selective_scan``."""
    return mamba_ops.selective_scan(x, dt, A, B, C, D, initial_state, reset_mask)


def _chunked_walk(x, dt, A, B, reset_mask, L):
    """The pieces of a walk over time cut into chunks of L steps, the last
    padded with steps that change nothing (dt 0: a decay of 1 and no
    input): ``chunks`` cuts a (b, t, .) tensor into (b, chunks, L, .) in
    f32; ``keep`` (b, chunks, L) is 0 at a reset step; ``decay(j)`` and
    ``inp(j)`` are exp(dt A) keep and dt x B of step j of every chunk, (b,
    chunks, d, n)."""
    b, t, _ = x.shape
    nc = -(-t // L)
    pad = nc * L - t
    chunks = lambda v: F.pad(v.float(), (0, 0, 0, pad)).reshape(b, nc, L, v.shape[-1])
    xs, dts, Bs = chunks(x), chunks(dt), chunks(B)
    keep = (torch.ones(b, t, device=x.device) if reset_mask is None
            else (~reset_mask.bool()).float())
    keep = F.pad(keep, (0, pad), value=1.0).reshape(b, nc, L)
    Af = A.float()
    decay = lambda j: torch.exp(dts[:, :, j, :, None] * Af) * keep[:, :, j, None, None]
    inp = lambda j: (dts[:, :, j] * xs[:, :, j])[..., None] * Bs[:, :, j, None, :]
    return chunks, keep, decay, inp


def mamba_scan_chunked_plain(x, dt, A, B, C, D, initial_state=None, reset_mask=None,
                             chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan`'s chunked route written with tensors, in f32, for
    any chunk length ``chunk`` (None: the plan's). Same arguments and
    outputs. Time is cut into chunks, the last padded with steps that
    change nothing, and every chunk walked at once:

    1. summaries: each chunk's walk from zero (chunk 0 from s0), its end
       state h_loc and its decay product P (0 where a step resets);
    2. carry: H_c = P_{c-1} H_{c-1} + h_loc_{c-1} from H_1 = h_loc_0;
    3. each chunk's walk again from H_c (chunk 0 from s0), y_t = C_t . h_t +
       D x_t at every step; the last chunk's end state is the final state.

    With one chunk it is the walk from s0 over the whole length. Used by
    the tests, on the CPU against the Pallas kernel and
    :func:`mamba_scan_plain`, and on the card against the kernels."""
    b, t, d = x.shape
    n = A.shape[-1]
    L = mamba_scan_plan(b, t, d) if chunk is None else chunk
    nc = -(-t // L)
    chunks, _, decay, inp = _chunked_walk(x, dt, A, B, reset_mask, L)
    xs, Cs = chunks(x), chunks(C)
    s0 = (torch.zeros(b, d, n, device=x.device) if initial_state is None
          else initial_state.float())
    # 1. summaries
    h = torch.zeros(b, nc, d, n, device=x.device)
    h[:, 0] = s0
    q = torch.ones_like(h)
    for j in range(L):
        a = decay(j)
        h = a * h + inp(j)
        q = q * a
    # 2. carry
    H = [s0] + [h[:, 0]] * (nc > 1)
    for c in range(2, nc):
        H.append(q[:, c - 1] * H[c - 1] + h[:, c - 1])
    # 3. every chunk's walk from its start state
    h = torch.stack(H, 1)
    ys = []
    for j in range(L):
        h = decay(j) * h + inp(j)
        ys.append(torch.einsum("bcdn,bcn->bcd", h, Cs[:, :, j]))
    y = torch.stack(ys, 2) + xs * D.float()
    return y.reshape(b, nc * L, d)[:, :t].to(x.dtype), h[:, -1]


def mamba_scan(x, dt, A, B, C, D, initial_state=None, reset_mask=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over a chunk of tokens: h_t = exp(dt_t A) h_{t-1}
    + dt_t x_t B_t (the decay zeroed where ``reset_mask`` is set), y_t = C_t
    . h_t + D x_t.

    Returns y (b, t, d) in x's dtype and the final state (b, d, n) in f32.
    Takes any t >= 1, with the chunk length :func:`mamba_scan_plan` gives
    (one call counts as one launch, and once more under its route in
    ``mamba_scan.routes``: ``"one_chunk"``, one walk, or ``"chunked"``, the
    summaries, the carry and the chunks' walks, three kernels; its scratch
    the chunk summaries, 2 b ceil(t/L) d n f32 values, one allocation freed
    when the call returns). Differentiable: when autograd records it runs
    through a ``torch.autograd.Function`` whose backward is
    :func:`mamba_scan_bwd`.
    """
    if not x.is_cuda:
        return mamba_scan_plain(x, dt, A, B, C, D, initial_state, reset_mask)
    tensors = [x, dt, A, B, C, D] + ([] if initial_state is None else [initial_state])
    if torch.is_grad_enabled() and any(v.requires_grad for v in tensors):
        return _MambaScan.apply(x, dt, A, B, C, D, initial_state, reset_mask)
    return _scan_launch(x, dt, A, B, C, D, initial_state, reset_mask)


def _check_chunk(name, chunk):
    _check(name, chunk > 0 and chunk % _SEG == 0,
           f"the chunk length must be a positive multiple of {_SEG}; got {chunk}")


def _scan_launch(x, dt, A, B, C, D, s0=None, reset=None, chunk=None):
    """Check the arguments and launch the forward kernels (CUDA tensors)
    with chunk length ``chunk`` (None: the plan's; the card's checks force
    either route)."""
    name = "mamba_scan"
    b, t, d, n, io = _check_args(name, x, dt, A, B, C, D, s0, reset)
    chunk = mamba_scan_plan(b, t, d) if chunk is None else chunk
    _check_chunk(name, chunk)
    x, dt, B, C = (_aligned(v) for v in (x, dt, B, C))
    y = torch.empty_like(x)
    sf = torch.empty(b, d, n, dtype=torch.float32, device=x.device)
    buf, scratch = _scratch(_fwd_sizes(b, t, d, chunk), x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mamba_scan_fwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(s0), _ptr(reset), _ptr(y),
        _ptr(sf), *scratch, b, t, d, n, chunk, _DTYPE_CODE[io], ctypes.c_void_p(stream))
    _raise_on(name, err)
    mamba_scan.launches += 1
    mamba_scan.routes[bwd_route(t, chunk)] += 1
    mamba_scan.shapes[(*_shape(b, t, d, n, io, s0, reset), chunk)] += 1
    return y, sf


mamba_scan.launches, mamba_scan.shapes = 0, Counter()
mamba_scan.routes = dict.fromkeys(_ROUTES, 0)


# ----------------------------------------------------------- the backward
# How many chunks the backward cuts t into: enough that the chunk body's
# blocks (64 channels of one batch row and chunk, 256 threads, two an SM)
# fill the card's 132 SMs once, _BWD_BLOCKS in all; chunks of whole
# 16-step segments, at least one segment long. From chip_smoke.py's
# chunk-length sweep on an H100 (PERF.md §6; d 2048, bf16 IO, no initial
# state, medians of six turns; us): at b8 one chunk was the fastest at every
# length (t512: 325.5 against 367.8 in two chunks and 397.2 at L64); at b4
# two chunks from t64 (t512 L256 190.3, one chunk 239.0), at b2 four (t512
# L128 102.9, one chunk 233.7), at b1 eight (t512 L64 58.0, one chunk
# 222.8), none shorter than 16 steps; where two chunks or fewer are
# planned, one chunk up to 48 steps (b4 t48: 30.9 against 36.1 at L16 and
# 37.7 at L32).
_BWD_BLOCKS = 2 * 132
_BWD_ONE_CHUNK_MAX_T = 48  # where two chunks or fewer are planned


@functools.lru_cache(maxsize=None)
def mamba_scan_bwd_plan(b: int, t: int, d: int) -> int:
    """The chunk length L a :func:`mamba_scan_bwd` launch on (b, t, d)
    takes, decided from these alone before the launch: a multiple of the
    16-step segment; L >= t is one chunk (route ``"one_chunk"``: the
    checkpoint pass from s0 and the segment walk over the whole length),
    below t the ``"chunked"`` route (chunk summaries, the carry, the segment
    walk of every chunk in parallel). The chunk count is what fills the card
    with the chunk body's blocks, ``_BWD_BLOCKS`` / (b * ceil(d / 64))
    rounded; one chunk where that is 1, or 2 and t is at most
    ``_BWD_ONE_CHUNK_MAX_T``; else ceil(t / that count) rounded up to whole
    segments, the shortest whole segments that give no more chunks than
    that: a ragged t takes the count of the next whole length (t511 at b4
    takes two chunks of 256, not three of 240), or fewer where rounding a
    short chunk up to 16 steps leaves the last chunks empty."""
    n_chunk = round(_BWD_BLOCKS / (b * -(-d // _BLOCK_CHANNELS)))
    if n_chunk <= 1 or (n_chunk <= 2 and t <= _BWD_ONE_CHUNK_MAX_T):
        return _whole_segments(t)
    return _whole_segments(-(-t // n_chunk))


def bwd_route(t: int, chunk: int) -> str:
    """``"one_chunk"`` for a chunk length ``chunk`` >= t, else ``"chunked"``."""
    return "one_chunk" if chunk >= t else "chunked"


def _bwd_sizes(b, t, d, chunk):
    """Bytes of :func:`mamba_scan_bwd`'s scratch arrays, in the C entry
    point's order, all f32: the segment checkpoints ck (none for one chunk
    of one segment), the in-chunk dt sums cdt and the chunk summaries h_loc,
    g_loc and P (chunked route only; 0: not allocated), the parts of dB and
    dC (one a 64-channel group), of dA and of dD (one a batch row and
    chunk)."""
    nc, ns = -(-t // chunk), -(-t // _SEG)
    groups = -(-d // _BLOCK_CHANNELS)
    chunked = nc > 1
    ck = 4 * b * ns * d * _N if chunked or ns > 1 else 0
    own = [4 * b * ns * d] + [4 * b * nc * d * _N] * 3 if chunked else [0] * 4
    return ([ck] + own + [4 * groups * b * t * _N] * 2 + [4 * b * nc * d * _N, 4 * b * nc * d])


def bwd_scratch_bytes(b: int, t: int, d: int, chunk: int) -> int:
    """Bytes of scratch one :func:`mamba_scan_bwd` call with chunk length
    ``chunk`` takes beside its outputs, in one allocation."""
    return _scratch_total(_bwd_sizes(b, t, d, chunk))


def mamba_scan_bwd_chunked_plain(x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf,
                                 need_ds0: bool = True, chunk: Optional[int] = None,
                                 segment: int = _SEG):
    """:func:`mamba_scan_bwd`'s decomposition written with tensors, in f32,
    for any chunk length ``chunk`` (None: the plan's) and segment length
    ``segment`` (the kernels': 16). Same arguments and outputs; ``dsf`` may
    be None (zeros). Time is cut into chunks, the last padded with steps
    that change nothing (dt 0, no input, no cotangent), and every chunk
    walked at once:

    1. summaries: each chunk's forward from zero (chunk 0 from s0), with
       the state and the dt sum at every segment start (ck, cdt), its end
       state h_loc, its decay product P and g_loc = sum_t (prod_{s<=t} a_s)
       C_t dy_t, the reverse scan of g from zero at its end;
    2. carry: H_c = P_{c-1} H_{c-1} + h_loc_{c-1} from H_1 = h_loc_0, and
       G_c = P_{c+1} G_{c+1} + g_loc_{c+1} from G_last = dsf;
    3. body: every segment, last first, from ck + exp(A cdt) H_c (H_c's
       term dropped after a reset in the chunk), its states recomputed, then
       walked back with g from G_c (the reverse walk of ``_bwd_kernel``);
    4. sums: dB and dC over channels, dA and dD over batch and chunk.

    Used by the tests, on the CPU against the Pallas backward and autograd
    through :func:`mamba_scan_plain`, and on the card against the kernels."""
    b, t, d = x.shape
    n = A.shape[-1]
    L = mamba_scan_bwd_plan(b, t, d) if chunk is None else chunk
    nc = -(-t // L)
    chunks, keep, decay, inp = _chunked_walk(x, dt, A, B, reset_mask, L)
    xs, dts, Bs, Cs, dys = (chunks(v) for v in (x, dt, B, C, dy))
    Af, Df = A.float(), D.float()

    # 1. summaries
    h = torch.zeros(b, nc, d, n, device=x.device)
    if initial_state is not None:
        h[:, 0] = initial_state.float()
    q, gl, cum = torch.ones_like(h), torch.zeros_like(h), torch.zeros(b, nc, d, device=x.device)
    ck, cdt = {}, {}
    for j in range(L):
        if j % segment == 0:
            ck[j], cdt[j] = h, cum
        a = decay(j)
        h = a * h + inp(j)
        q = q * a
        gl = gl + q * (Cs[:, :, j, None, :] * dys[:, :, j, :, None])
        cum = cum + dts[:, :, j]
    # 2. carry
    H, G = [torch.zeros_like(h[:, 0])] * nc, [None] * nc
    if nc > 1:
        H[1] = h[:, 0]
        for c in range(2, nc):
            H[c] = q[:, c - 1] * H[c - 1] + h[:, c - 1]
    g = torch.zeros_like(h[:, 0]) if dsf is None else dsf.float()
    for c in reversed(range(nc)):
        G[c] = g
        g = q[:, c] * g + gl[:, c]
    H, g = torch.stack(H, 1), torch.stack(G, 1)
    # 3. body
    steps = torch.arange(L, device=x.device)
    first_reset = torch.where(keep == 0, steps, L).amin(-1)  # (b, nc); L: none
    dx, ddt = torch.zeros(b, nc, L, d, device=x.device), torch.zeros(b, nc, L, d, device=x.device)
    dB, dC = torch.zeros(b, nc, L, n, device=x.device), torch.zeros(b, nc, L, n, device=x.device)
    dA, dD = torch.zeros_like(h), torch.zeros(b, nc, d, device=x.device)
    for j0 in reversed(range(0, L, segment)):
        sees_h = (first_reset >= j0).float()[..., None, None]
        hck = ck[j0] + sees_h * torch.exp(Af * cdt[j0][..., None]) * H
        hs = [hck]
        for j in range(j0, min(j0 + segment, L)):
            hs.append(decay(j) * hs[-1] + inp(j))
        for j in reversed(range(j0, min(j0 + segment, L))):
            a, h_t, h_prev = decay(j), hs[j - j0 + 1], hs[j - j0]
            dyj, xj, dtj = dys[:, :, j], xs[:, :, j], dts[:, :, j]
            dC[:, :, j] = torch.einsum("bcdn,bcd->bcn", h_t, dyj)
            dD += dyj * xj
            g = g + Cs[:, :, j, None, :] * dyj[..., None]
            e = g * h_prev * a
            dA += e * dtj[..., None]
            u = (g * Bs[:, :, j, None, :]).sum(-1)
            ddt[:, :, j] = (e * Af).sum(-1) + u * xj
            dx[:, :, j] = u * dtj + Df * dyj
            dB[:, :, j] = torch.einsum("bcdn,bcd->bcn", g, dtj * xj)
            g = a * g
    ds0 = g[:, 0] if need_ds0 and initial_state is not None else None
    # 4. sums; the padding steps dropped
    whole = lambda v: v.reshape(b, nc * L, v.shape[-1])[:, :t]
    return (whole(dx).to(x.dtype), whole(ddt), dA.sum((0, 1)), whole(dB).to(B.dtype),
            whole(dC).to(C.dtype), dD.sum((0, 1)), ds0)


def mamba_scan_bwd(x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf,
                   need_ds0: bool = True):
    """Backward of :func:`mamba_scan` on CUDA tensors.

    Inputs as the forward's, plus ``dy`` (b, t, d) in the IO dtype and
    ``dsf`` (b, d, n) f32, the gradients of its two outputs. Returns (dx,
    ddt, dA, dB, dC, dD, ds0) in the order of the forward's arguments: dx,
    dB and dC in the IO dtype, ddt f32, dA (d, n) and dD (d) f32 summed over
    the batch in a fixed order, ds0 f32 (None without ``need_ds0`` or
    without an initial state). The reset mask gets no gradient.

    One call launches the kernels of ``csrc/mamba_scan_bwd.cu`` with the
    chunk length :func:`mamba_scan_bwd_plan` gives and counts as one launch,
    and once more under its route in ``mamba_scan_bwd.routes``: ``"chunked"``
    (chunk summaries, the carry, the chunks' segment walks in parallel) or
    ``"one_chunk"``. Its scratch, one allocation freed when the call
    returns (:func:`bwd_scratch_bytes`): the segment checkpoints (b *
    ceil(t/16) * d * n f32 values), the chunk summaries, the per-group parts
    of dB and dC (2 * d/64 * b * t * n) and the per-chunk parts of dA and
    dD.
    """
    return _bwd_launch(x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf, need_ds0)


def _aligned(v):
    """``v``, copied if its data is not on a 16-byte boundary (the backward
    copies x, dt, dy, B and C 16 bytes at a time)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _bwd_launch(x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf, need_ds0=True,
                chunk=None):
    """Check the arguments and launch :func:`mamba_scan_bwd`'s kernels (CUDA
    tensors) with chunk length ``chunk`` (None: the plan's; the card's
    checks force either route)."""
    name = "mamba_scan_bwd"
    _check(name, x.is_cuda, "runs on CUDA tensors only; on the CPU take autograd "
           "through mamba_scan_plain")
    b, t, d, n, io = _check_args(name, x, dt, A, B, C, D, initial_state, reset_mask, dy, dsf)
    _check(name, dy.shape == x.shape and dy.dtype == io, "dy must match x")
    _check(name, dsf.shape == (b, d, n) and dsf.dtype == torch.float32,
           f"dsf must be ({b}, {d}, {n}) f32")
    chunk = mamba_scan_bwd_plan(b, t, d) if chunk is None else chunk
    _check_chunk(name, chunk)
    x, dt, dy, B, C = (_aligned(v) for v in (x, dt, dy, B, C))
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt, dA, dD = torch.empty_like(dt), torch.empty_like(A), torch.empty_like(D)
    ds0 = torch.empty_like(initial_state) if need_ds0 and initial_state is not None else None
    buf, scratch = _scratch(_bwd_sizes(b, t, d, chunk), x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mamba_scan_bwd(
        _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(initial_state),
        _ptr(reset_mask), _ptr(dy), _ptr(dsf), _ptr(dx), _ptr(ddt), _ptr(dB), _ptr(dC),
        _ptr(dA), _ptr(dD), _ptr(ds0), *scratch, b, t, d, n, chunk, _DTYPE_CODE[io],
        ctypes.c_void_p(stream))
    _raise_on(name, err)
    mamba_scan_bwd.launches += 1
    mamba_scan_bwd.routes[bwd_route(t, chunk)] += 1
    mamba_scan_bwd.shapes[(*_shape(b, t, d, n, io, initial_state, reset_mask),
                           ds0 is not None, chunk)] += 1
    return dx, ddt, dA, dB, dC, dD, ds0


mamba_scan_bwd.launches, mamba_scan_bwd.shapes = 0, Counter()
mamba_scan_bwd.routes = dict.fromkeys(_ROUTES, 0)


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
