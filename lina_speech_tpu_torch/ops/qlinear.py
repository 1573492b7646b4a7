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

Weight layout. Every int8 weight is held as PyTorch's ``(out, in)`` with the
contraction axis contiguous, ``(N, Kp)``: ``Kp`` is ``K`` rounded up to a
multiple of 16 with zeros beyond ``K`` (:func:`pack_int8_weight`, once, at
quantization time), so that every row starts on a 16-byte boundary. ``K`` is
read from ``x``. The kernels take the weight as the A operand of the tensor
cores, whose rows want exactly that layout; the fused FFN reads its second
weight as the output Linear holds it, ``(d, Hp)``.

The launch plans (:func:`int8_linear_plan`, :func:`fused_ffn_plan`) are
pure functions of the shapes: the rows of an m-tile and, for
``int8_linear``, how many blocks of a cluster split K.

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
_SMS = 132  # of an H100: sizes the plans, nothing else
_GEMV_MAX_M = 8  # int8_linear: rows up to which the GEMV body is the faster one
_LIN_KT, _MAX_CLUSTER = 64, 8  # int8_linear.cu: kKT, kMaxCluster
_LIN_BN = {16: 32, 32: 64}  # channels a block of the tensor-core body by m-tile (Tile<NT>::BN)
_FFN_UNITS, _FFN_RANKS = 64, 8  # fused_ffn_int8.cu: kU, kRanks
_tickets = {}  # (device, stream) -> the fused FFN's ticket counters, left zero by each call


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


def int8_linear_plan(m: int, k: int, n: int):
    """(route, rows of an m-tile, blocks of a cluster along K) of an
    ``int8_linear`` launch of ``m`` rows, ``K = k``, ``N = n``.

    Up to 8 rows the GEMV body (route ``"gemv"``: a warp per output channel
    on the CUDA cores, an m-tile of 1, 2, 4 or 8 rows) measures faster than
    the tensor-core body, whose fixed cost (a cluster barrier and the sums
    through distributed shared memory) the few rows do not repay. Above it
    the tensor-core body (route ``"mma"``): an m-tile of 16 rows (blocks of
    32 channels) or 32 rows (64 channels), K split across up to 8 blocks of a
    cluster in stages of 64 columns until about 2 (16-row tiles) or 4
    (32-row tiles) blocks an SM run, no block of a cluster without a
    stage."""
    if m <= _GEMV_MAX_M:
        return "gemv", next(t for t in (1, 2, 4, 8) if m <= t), 1
    mt = 16 if m <= 16 else 32
    fill = (2 if mt == 16 else 4) * _SMS
    stages = -(-k // _LIN_KT)
    tiles = -(-m // mt) * -(-n // _LIN_BN[mt])
    ks = min(_MAX_CLUSTER, stages, max(1, -(-fill // tiles)))
    per = -(-stages // ks)
    return "mma", mt, -(-stages // per)


def fused_ffn_plan(m: int) -> int:
    """Rows of an m-tile of a ``fused_ffn_int8`` launch of ``m`` rows: 8 up
    to 16 rows, else 16. A cluster of 8 blocks owns 64 hidden units for one
    m-tile, so a launch runs ``8 * ceil(hidden / 64) * ceil(m / mt)`` blocks;
    and the last block of each (m-tile, channel slice) adds that many
    chunks' parts, so a smaller tile spreads the sums over more blocks."""
    return 8 if m <= 16 else 16


def _copies_as_is(x2: torch.Tensor) -> bool:
    """Whether the kernels copy the rows of ``x2`` into shared memory as they
    are (bf16 rows of whole 16-byte pieces on a 16-byte boundary) rather than
    through registers with a conversion."""
    return (x2.dtype == torch.bfloat16 and x2.shape[-1] % 8 == 0
            and x2.data_ptr() % 16 == 0)


def quantize_rows(x: torch.Tensor):
    """Dynamic symmetric int8 quantization of each row of ``x`` (..., K):
    ``sx = max(max|x|, 1e-12) / 127``, ``xq = clip(round(x / sx), +-127)``.
    Returns (xq int8, sx f32 (..., 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    # a true division, as the JAX package and the kernel take it (PyTorch's
    # CUDA division by a Python number multiplies by its reciprocal instead,
    # which moves sx by one ulp now and then)
    sx = amax / torch.full_like(amax, 127.0)
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
    route, mt, ks = int8_linear_plan(m, k, n)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.int8_linear_fwd(_ptr(x2), _ptr(q), _ptr(s1), _ptr(out), _ptr(xq), _ptr(sx),
                              m, k, kp, n, _X_CODE[x.dtype], _X_CODE[out_dtype],
                              _MODES.index(mode), int(route == "gemv"), mt, ks,
                              int(route == "mma" and mode == "wonly" and _copies_as_is(x2)),
                              ctypes.c_void_p(stream))
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
    hidden = q_in.shape[0] // 2
    xb = x.reshape(-1, d).to(bf).float()
    gh = (xb @ q_in[:, :d].float().T) * s_in.reshape(-1).float()
    if b_in is not None:
        gh = gh + b_in.reshape(-1).float()
    g, h = gh[:, :hidden], gh[:, hidden:]
    g_bf = g.to(bf).float()
    u = (g_bf * (1.0 / (1.0 + torch.exp(-g_bf)))).to(bf) * h.to(bf)
    y = (u.float() @ q_out[:, :hidden].float().T) * s_out.reshape(-1).float()
    if b_out is not None:
        y = y + b_out.reshape(-1).float()
    return y.to(out_dtype).reshape(*x.shape[:-1], q_out.shape[0])


def _ffn_tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The fused FFN's ticket counters for calls on ``stream``: zero when
    made, and every call leaves the ones it used at zero again."""
    key = (dev, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
    return t


def fused_ffn_int8(x, q_in, s_in, b_in, q_out, s_out, b_out, *,
                   out_dtype=torch.bfloat16):
    """SwiGLU FFN over int8 weights in one call: ``(silu(g) * h) @
    dequant(q_out).T + b_out`` with ``g, h = split(x @ dequant(q_in).T +
    b_in)``, gate first.

    x: (..., d), f32 or bf16, d a multiple of 16; q_in: (2H, d) int8 (rows
    0..H-1 the gate, H..2H-1 the values); s_in: 2H f32 scales; b_in: 2H
    biases in any float dtype or None; q_out: (d, Hp) int8, the output
    Linear's own packed weight (:func:`pack_int8_weight` of its (d, H)
    weight: Hp is H rounded up to a multiple of 16, zeros beyond H); s_out: d
    f32 scales; b_out: d biases or None. Returns (..., d) in ``out_dtype``.

    On CUDA one call is one launch of ``csrc/fused_ffn_int8.cu``; its scratch
    (ceil(H / 64) * m * d f32 values) is freed when the call returns.
    """
    if not x.is_cuda:
        return fused_ffn_int8_plain(x, q_in, s_in, b_in, q_out, s_out, b_out,
                                    out_dtype=out_dtype)
    name = "fused_ffn_int8"
    d = x.shape[-1]
    hidden = q_in.shape[0] // 2
    hp = q_out.shape[-1]
    dev = x.device
    _check(name, d % 16 == 0, f"model width {d} must be a multiple of 16")
    _check(name, x.dtype in _X_CODE and out_dtype in _X_CODE,
           f"x dtype {x.dtype} / out dtype {out_dtype} not in f32/bf16")
    _check(name, q_in.shape[0] % 2 == 0 and hp % 16 == 0 and hidden <= hp < hidden + 16,
           f"q_out must be (d, {hidden} rounded up to a multiple of 16), got "
           f"{tuple(q_out.shape)}")
    for t, shape, what in ((q_in, (2 * hidden, d), "q_in"), (q_out, (d, hp), "q_out")):
        _check(name, t.dtype == torch.int8 and tuple(t.shape) == shape and t.is_contiguous()
               and t.device == dev, f"{what} must be contiguous int8 {shape} on x's device")
    s_in, s_out = s_in.reshape(-1), s_out.reshape(-1)
    for t, n_el, what in ((s_in, 2 * hidden, "s_in"), (s_out, d, "s_out")):
        _check(name, t.numel() == n_el and t.dtype == torch.float32 and t.is_contiguous()
               and t.device == dev, f"{what} must hold {n_el} contiguous f32 scales")
    # the kernel reads both biases as f32 or both as bf16, as given; any other
    # mix is cast to f32 (2H + d values: a copy of a few KB)
    biases = [b.reshape(-1) for b in (b_in, b_out) if b is not None]
    b_dtype = biases[0].dtype if biases else torch.float32
    if b_dtype not in _X_CODE or any(b.dtype != b_dtype for b in biases):
        b_dtype = torch.float32
    cast = lambda b: None if b is None else b.reshape(-1).to(b_dtype).contiguous()
    b_in, b_out = cast(b_in), cast(b_out)
    _check(name, b_in is None or (b_in.numel() == 2 * hidden and b_in.device == dev),
           "b_in size or device")
    _check(name, b_out is None or (b_out.numel() == d and b_out.device == dev),
           "b_out size or device")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if x2.dtype == torch.bfloat16 and not _copies_as_is(x2):
        x2 = x2.clone()  # a fresh allocation starts on a 16-byte boundary
    m = x2.shape[0]
    _check(name, m >= 1, "needs at least one row")
    mt = fused_ffn_plan(m)
    parts = torch.empty(-(-hidden // _FFN_UNITS), m, d, dtype=torch.float32, device=dev)
    out = torch.empty(m, d, dtype=out_dtype, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _ffn_tickets(dev, stream, -(-m // mt) * _FFN_RANKS)
    err = lib.fused_ffn_int8_fwd(_ptr(x2), _ptr(q_in), _ptr(s_in), _ptr(b_in), _ptr(q_out),
                                 _ptr(s_out), _ptr(b_out), _ptr(parts), _ptr(tickets),
                                 _ptr(out), m, d, hidden, hp, _X_CODE[x.dtype],
                                 _X_CODE[out_dtype], _X_CODE[b_dtype], mt,
                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    fused_ffn_int8.launches += 1
    fused_ffn_int8.shapes.add((m, d, hidden, x.dtype, out_dtype))
    return out.reshape(*x.shape[:-1], d)


fused_ffn_int8.launches, fused_ffn_int8.shapes = 0, set()
