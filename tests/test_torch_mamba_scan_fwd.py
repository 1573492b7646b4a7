"""The chunked decomposition of the Mamba (v1) forward, on the CPU.

``mamba_scan_chunked_plain`` is the plain version of the CUDA forward's
chunked route (``csrc/mamba_scan.cu``): every chunk's walk from zero (chunk
0 from s0) for its end state and decay product, the carry of the state
across chunks, and every chunk's walk again from its start state, writing
y. Here it runs at chunk lengths 16, 32 and 64 on inputs made with numpy
from a seed, against two references:

- ``mamba_scan_pallas`` in interpret mode, the TPU kernel (as
  tests/test_torch_mamba.py runs it);
- ``ops/mamba.py:selective_scan``, the port's time loop (``mamba_scan_plain``,
  held against the JAX op in tests/test_torch_mamba.py).

y and the final state are held to each one's own max|ref|: 1e-5 in f32
(the decomposition and the references multiply the decays in other
orders); with bf16 x, B and C, y to 1e-2 (it comes back in bf16) and the
f32 state to 1e-5. Cases: t = 1, 15, 16, 17, 63 and 130 (ragged last
chunks, one chunk and several); with and without an initial state; resets
on the first step of a chunk at every length (step 64, and step 16 or 32
where that is a chunk's start) and inside one (step 40).

Then the route plan ``mamba_scan_plan``: pure, a length of whole 16-step
segments, one chunk on a few steps and wherever one chunk's blocks fill
more than half the card, otherwise a power-of-two number of segments and
no more chunks than its block target; and the forward's launcher refusing
a chunk length that is no positive multiple of 16.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.mamba_pallas import mamba_scan_pallas
from lina_speech_tpu_torch.ops import mamba_cuda

B_, D_, N_ = 2, 64, 16
T_CASES = (1, 15, 16, 17, 63, 130)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reset_mask(t):
    """Row 0: resets on the first step of a chunk of 16 and of 64 steps and
    inside every chunk length (step 40); row 1: on the first step of a
    chunk of 32."""
    m = np.zeros((B_, t), bool)
    for row, step in ((0, 16), (0, 40), (0, 64), (1, 32)):
        if step < t:
            m[row, step] = True
    return m


@functools.lru_cache(maxsize=None)
def _case(t, s0, bf16):
    """The inputs (numpy) of a case, dt = softplus(N(-1, 1)) and A =
    -exp(0.3 N) as tests/test_mamba_pallas.py draws them, and its two
    references (y, final state) in f32: the Pallas kernel in interpret mode
    and the port's time loop, computed once for the three chunk lengths."""
    rng = np.random.default_rng(200 + t + 2 * s0 + 4 * bf16)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    v = dict(x=f(B_, t, D_), dt=np.log1p(np.exp(f(B_, t, D_) - 1.0)).astype(np.float32),
             A=-np.exp(f(D_, N_) * 0.3).astype(np.float32), B=f(B_, t, N_), C=f(B_, t, N_),
             D=f(D_), s0=f(B_, D_, N_) if s0 else None, reset=_reset_mask(t))
    if bf16:
        for n in ("x", "B", "C"):
            v[n] = torch.from_numpy(v[n]).bfloat16().float().numpy()
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    args = [jnp.asarray(v[n], jdt if n in ("x", "B", "C") else jnp.float32)
            for n in ("x", "dt", "A", "B", "C", "D")]
    s0_ = None if v["s0"] is None else jnp.asarray(v["s0"])
    reset = jnp.asarray(v["reset"])
    pallas = mamba_scan_pallas(*args, initial_state=s0_, reset_mask=reset, interpret=True)
    targs, ts0, treset = _torch_args(v, bf16)
    loop = mamba_cuda.mamba_scan_plain(*targs, ts0, treset)
    return v, [tuple(np.asarray(a.astype(jnp.float32)) for a in pallas),
               tuple(a.float().numpy() for a in loop)]


def _torch_args(v, bf16):
    io = torch.bfloat16 if bf16 else torch.float32
    args = [torch.from_numpy(v[n]).to(io if n in ("x", "B", "C") else torch.float32)
            for n in ("x", "dt", "A", "B", "C", "D")]
    s0 = None if v["s0"] is None else torch.from_numpy(v["s0"])
    return args, s0, torch.from_numpy(v["reset"])


def _hold(got, ref, tol):
    got = got.float().numpy()
    assert got.shape == ref.shape
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert np.isfinite(got).all() and scale > 0 and err <= tol * scale, (err, scale)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("s0", [True, False])
@pytest.mark.parametrize("t", T_CASES)
def test_chunked_forward_matches_pallas_and_the_time_loop(t, s0, chunk):
    """The decomposition at chunk length ``chunk`` against the Pallas
    kernel in interpret mode and the port's time loop (mamba_scan_plain):
    y and the final state within 1e-5 of their own max|ref| in f32."""
    v, refs = _case(t, s0, False)
    args, s0_, reset = _torch_args(v, False)
    y, sf = mamba_cuda.mamba_scan_chunked_plain(*args, s0_, reset, chunk=chunk)
    assert y.dtype == torch.float32 and sf.dtype == torch.float32
    assert y.shape == (B_, t, D_) and sf.shape == (B_, D_, N_)
    for ref in refs:
        _hold(y, ref[0], 1e-5)
        _hold(sf, ref[1], 1e-5)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_forward_bf16_io(chunk):
    """bf16 x, B and C: y comes back in bf16 within 1e-2 of the references'
    max (one bf16 rounding of an f32 sum taken in another order), the f32
    final state within 1e-5."""
    v, refs = _case(130, True, True)
    args, s0_, reset = _torch_args(v, True)
    y, sf = mamba_cuda.mamba_scan_chunked_plain(*args, s0_, reset, chunk=chunk)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    for ref in refs:
        _hold(y, ref[0], 1e-2)
        _hold(sf, ref[1], 1e-5)


def test_a_chunk_of_resets_cuts_the_carry():
    """Where every step of a chunk resets, its decay product is an exact
    zero, so nothing before the chunk reaches y from the chunk on: scaling
    x before it leaves those y bits unchanged, and they are the bits of a
    run from the chunk's first step alone."""
    L, t = 16, 48
    v, _ = _case(t, True, False)
    v = dict(v, reset=np.zeros((B_, t), bool), x=v["x"].copy())
    v["reset"][:, L:2 * L] = True
    args, s0_, reset = _torch_args(v, False)
    y, sf = mamba_cuda.mamba_scan_chunked_plain(*args, s0_, reset, chunk=L)
    v["x"][:, :L] *= 3.0
    args2, _, _ = _torch_args(v, False)
    y2, sf2 = mamba_cuda.mamba_scan_chunked_plain(*args2, s0_, reset, chunk=L)
    np.testing.assert_array_equal(y[:, L:].numpy(), y2[:, L:].numpy())
    np.testing.assert_array_equal(sf.numpy(), sf2.numpy())
    assert not np.array_equal(y[:, :L].numpy(), y2[:, :L].numpy())


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_plan_is_pure_and_cuts_whole_segments(b):
    """mamba_scan_plan: the same answer from the same shapes (cached), a
    chunk length of whole 16-step segments at every length; one chunk
    wherever one chunk's 64-channel blocks are more than 64 (b4 and b8 at d
    2048) and up to 32 steps plus half those blocks (48 at b1, 64 at b2);
    elsewhere a power-of-two number of segments, the fewest that cut t into
    no more chunks than _FWD_BLOCKS blocks fill; the lengths of shapes the
    driven paths launch."""
    d = 2048
    blocks = b * d // 64
    target = round(mamba_cuda._FWD_BLOCKS / blocks)
    for t in range(1, 700):
        chunk = mamba_cuda.mamba_scan_plan(b, t, d)
        assert chunk == mamba_cuda.mamba_scan_plan(b, t, d)
        assert chunk > 0 and chunk % 16 == 0, (t, chunk)
        count = -(-t // chunk)
        if (blocks > mamba_cuda._FWD_CHUNKED_MAX_BLOCKS
                or t <= mamba_cuda._FWD_ONE_CHUNK_MAX_T + blocks // 2):
            assert count == 1, (t, chunk)
            continue
        segments = chunk // 16
        assert segments & (segments - 1) == 0, (t, chunk)
        assert 1 < count <= target, (t, chunk, count)
        assert chunk == 16 or -(-t // (chunk // 2)) > target, (t, chunk)
    assert mamba_cuda.mamba_scan_plan.cache_info().hits > 0
    assert [mamba_cuda.mamba_scan_plan(b, t, d) >= t for t in (48, 64, 96)] == {
        1: [True, False, False], 2: [True, True, False], 4: [True] * 3, 8: [True] * 3}[b]
    launched = {1: (128, 16), 2: (319, 32), 4: (511, 512), 8: (151, 160)}
    t, chunk = launched[b]
    assert mamba_cuda.mamba_scan_plan(b, t, d) == chunk


def test_launcher_refuses_a_chunk_length_it_does_not_take():
    """The forward's launcher raises on a chunk length that is no positive
    multiple of 16 before anything is built or launched; the wrapper on CPU
    tensors runs the plain version and counts nothing."""
    v, _ = _case(17, True, False)
    args, s0_, reset = _torch_args(v, False)
    mamba_cuda.reset_launch_counts()
    for chunk in (0, 24, -16):
        with pytest.raises(ValueError, match="multiple of 16"):
            mamba_cuda._scan_launch(*args, s0_, reset, chunk=chunk)
    y, sf = mamba_cuda.mamba_scan(*args, s0_, reset)
    ref = mamba_cuda.mamba_scan_plain(*args, s0_, reset)
    assert torch.equal(y, ref[0]) and torch.equal(sf, ref[1])
    assert mamba_cuda.launch_counts() == {"mamba_scan": 0, "mamba_scan_bwd": 0}
    assert mamba_cuda.mamba_scan.routes == {"one_chunk": 0, "chunked": 0}
