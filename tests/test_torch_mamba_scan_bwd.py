"""The chunked decomposition of the Mamba (v1) backward, on the CPU.

``mamba_scan_bwd_chunked_plain`` is the plain version of the CUDA
backward's chunked route (``csrc/mamba_scan_bwd.cu``): chunk summaries
from zero, the carry of the state and its cotangent across chunks, and the
segment walk of every chunk from its checkpoints, each corrected by
exp(A cdt) times the chunk's start state. Here it runs at chunk length 8
with segments of 4 (two segments a chunk, so the correction is exercised)
and at segments of 16 (one a chunk), on inputs made with numpy from a
seed, against two references:

- ``jax.grad`` through ``mamba_scan_pallas`` in interpret mode, whose VJP
  is the TPU kernel ``_bwd_kernel`` (as tests/test_torch_mamba.py runs it);
- autograd through the port's ``mamba_scan_plain`` (the time loop).

All seven leaves (dx, ddt, dA, dB, dC, dD, ds0) are held to each leaf's
own max|ref|: 1e-4 in f32 (the decomposition and the references sum in
other orders, and exp(A sum dt) stands for a product of exponentials);
2e-2 with bf16 x, B, C and dy (dx, dB and dC come back in bf16).
Cases: t = 1, L - 1, L and 2L + 3 (a ragged last chunk); with and without
an initial state; without a final-state cotangent; without ds0; a reset on
a chunk's first step and a chunk in which every step resets.

Then the route plan ``mamba_scan_bwd_plan``: pure, one chunk up to 16
steps, a length of whole 16-step segments, no more chunks than fill the
card once (a ragged length as many as the whole length above it), and the
scratch of a call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.mamba_pallas import mamba_scan_pallas
from lina_speech_tpu_torch.ops import mamba_cuda

L = 8
B_, D_, N_ = 2, 64, 16
LEAVES = ("x", "dt", "A", "B", "C", "D", "s0")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _reset_mask(t):
    """Row 0: resets on the first step of the second chunk and at step 2L+1;
    row 1: every step of the second chunk resets."""
    m = np.zeros((B_, t), bool)
    m[0, L] = True
    m[0, 2 * L + 1] = True
    m[1, L:2 * L] = True
    return m


def _inputs(seed, t, s0, reset):
    """x, dt, A, B, C, D, s0, the reset mask and the cotangents dy, dsf as
    numpy arrays: dt = softplus(N(-1, 1)), A = -exp(0.3 N) (decays of about
    e^-0.3 to e^-3 a step), as tests/test_mamba_pallas.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B_, t, D_), dt=np.log1p(np.exp(f(B_, t, D_) - 1.0)).astype(np.float32),
                A=-np.exp(f(D_, N_) * 0.3).astype(np.float32), B=f(B_, t, N_), C=f(B_, t, N_),
                D=f(D_), s0=f(B_, D_, N_) if s0 else None,
                reset=_reset_mask(t) if reset else None, dy=f(B_, t, D_), dsf=f(B_, D_, N_))


def _bf16(a):
    """numpy f32 values rounded to bf16 (and back to f32)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_grads(v, io, dsf, need_ds0):
    """jax.grad of sum(y dy) (+ sum(sf dsf)) through mamba_scan_pallas in
    interpret mode; the leaves in LEAVES order (ds0 only where wanted)."""
    jdt = jnp.bfloat16 if io == torch.bfloat16 else jnp.float32
    reset = None if v["reset"] is None else jnp.asarray(v["reset"])
    names = list(LEAVES[:6]) + (["s0"] if v["s0"] is not None and need_ds0 else [])
    cast = lambda n: jnp.asarray(v[n], jdt if n in ("x", "B", "C") else jnp.float32)

    def loss(*a):
        kw = dict(zip(names, a))
        args = [kw.get(n, cast(n)) for n in LEAVES[:6]]
        s0 = kw.get("s0", None if v["s0"] is None else jnp.asarray(v["s0"]))
        y, sf = mamba_scan_pallas(*args, initial_state=s0, reset_mask=reset, interpret=True)
        out = jnp.sum(y.astype(jnp.float32) * jnp.asarray(v["dy"]))
        return out + (jnp.sum(sf * jnp.asarray(v["dsf"])) if dsf else 0.0)

    inputs = [cast(n) if n != "s0" else jnp.asarray(v["s0"]) for n in names]
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*inputs)
    return {n: np.asarray(g.astype(jnp.float32)) for n, g in zip(names, grads)}


def _torch_args(v, io):
    cast = lambda n: torch.from_numpy(v[n]).to(io if n in ("x", "B", "C") else torch.float32)
    return [cast(n) for n in LEAVES[:6]]


def _plain_grads(v, io, dsf, need_ds0):
    """Autograd through mamba_scan_plain, the same loss."""
    names = list(LEAVES[:6]) + (["s0"] if v["s0"] is not None and need_ds0 else [])
    args = dict(zip(LEAVES[:6], _torch_args(v, io)))
    args["s0"] = None if v["s0"] is None else torch.from_numpy(v["s0"])
    for n in names:
        args[n] = args[n].requires_grad_(True)
    reset = None if v["reset"] is None else torch.from_numpy(v["reset"])
    y, sf = mamba_cuda.mamba_scan_plain(*(args[n] for n in LEAVES[:6]), args["s0"], reset)
    loss = (y.float() * torch.from_numpy(v["dy"])).sum()
    if dsf:
        loss = loss + (sf * torch.from_numpy(v["dsf"])).sum()
    grads = torch.autograd.grad(loss, [args[n] for n in names])
    return {n: g.float().numpy() for n, g in zip(names, grads)}


def _chunked(v, io, dsf, need_ds0, segment):
    reset = None if v["reset"] is None else torch.from_numpy(v["reset"])
    s0 = None if v["s0"] is None else torch.from_numpy(v["s0"])
    dy = torch.from_numpy(v["dy"]).to(io)
    out = mamba_cuda.mamba_scan_bwd_chunked_plain(
        *_torch_args(v, io), s0, reset, dy, torch.from_numpy(v["dsf"]) if dsf else None,
        need_ds0=need_ds0, chunk=L, segment=segment)
    assert out[0].dtype == io and out[3].dtype == io and out[4].dtype == io
    assert all(o.dtype == torch.float32 for o in (out[1], out[2], out[5]))
    return dict(zip(LEAVES, out))


CASES = [  # t, initial state, reset mask, final-state cotangent, need_ds0, IO dtype
    (1, True, False, True, True, torch.float32),
    (L - 1, False, False, True, True, torch.float32),
    (L, True, False, False, True, torch.float32),
    (2 * L + 3, True, False, True, False, torch.float32),
    (2 * L + 3, False, True, True, True, torch.float32),
    (2 * L + 3, True, True, False, True, torch.float32),
    (2 * L + 3, True, True, True, True, torch.bfloat16),
]


@functools.lru_cache(maxsize=None)
def _case(t, s0, reset, dsf, need_ds0, io):
    """The inputs of a case and its two references, computed once for both
    segment lengths (a Pallas gradient in interpret mode takes seconds)."""
    v = _inputs(100 + t + 2 * s0 + 4 * reset, t, s0, reset)
    if io == torch.bfloat16:
        v["dy"] = _bf16(v["dy"])
    return v, (_jax_grads(v, io, dsf, need_ds0), _plain_grads(v, io, dsf, need_ds0))


@pytest.mark.parametrize("segment", [4, 16])
@pytest.mark.parametrize("t,s0,reset,dsf,need_ds0,io", CASES, ids=str)
def test_chunked_backward_matches_pallas_vjp_and_autograd(t, s0, reset, dsf, need_ds0, io,
                                                          segment):
    """The decomposition at chunk length 8 against jax.grad through the
    Pallas kernel (interpret mode) and autograd through the plain loop: each
    leaf within 1e-4 (f32) or 2e-2 (bf16 IO) of its own max|ref|; ds0 None
    without an initial state or without need_ds0."""
    v, refs = _case(t, s0, reset, dsf, need_ds0, io)
    tol = 2e-2 if io == torch.bfloat16 else 1e-4
    got = _chunked(v, io, dsf, need_ds0, segment)
    assert (got["s0"] is None) == (not s0 or not need_ds0)
    for ref in refs:
        assert set(ref) == {n for n in LEAVES if got[n] is not None}
        for name, r in ref.items():
            g = got[name].float().numpy()
            assert g.shape == r.shape, name
            err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
            assert np.isfinite(g).all() and scale > 0 and err <= tol * scale, (name, err, scale)


def test_a_chunk_of_resets_cuts_the_carry():
    """Where every step of a chunk resets, its decay product and its g_loc
    are exact zeros, so the carry passes nothing across it: scaling x before
    the chunk leaves dx, ddt, dB and dC from the chunk on the same bits, and
    scaling dy from the chunk on leaves them, and ds0, the same bits before
    it."""
    t = 3 * L
    v = _inputs(7, t, True, False)
    v["reset"] = np.zeros((B_, t), bool)
    v["reset"][:, L:2 * L] = True
    f32 = torch.float32
    ref = _chunked(v, f32, True, True, 4)
    w = dict(v, x=v["x"].copy())
    w["x"][:, :L] *= 3.0
    later = _chunked(w, f32, True, True, 4)
    w = dict(v, dy=v["dy"].copy())
    w["dy"][:, L:] *= -2.0
    earlier = _chunked(w, f32, True, True, 4)
    for name in ("x", "dt", "B", "C"):
        np.testing.assert_array_equal(ref[name][:, L:].numpy(), later[name][:, L:].numpy())
        np.testing.assert_array_equal(ref[name][:, :L].numpy(), earlier[name][:, :L].numpy())
    np.testing.assert_array_equal(ref["s0"].numpy(), earlier["s0"].numpy())
    assert not np.array_equal(ref["dt"][:, :L].numpy(), later["dt"][:, :L].numpy())
    assert not np.array_equal(ref["x"][:, L:].numpy(), earlier["x"][:, L:].numpy())


@pytest.mark.parametrize("b", [1, 2, 8])
def test_plan_is_pure_and_cuts_whole_segments(b):
    """mamba_scan_bwd_plan: the same answer from the same shapes (cached),
    one chunk up to 16 steps, and a chunk length of whole 16-step segments
    at every length; the route follows from it."""
    for t in range(1, 700):
        chunk = mamba_cuda.mamba_scan_bwd_plan(b, t, 2048)
        assert chunk == mamba_cuda.mamba_scan_bwd_plan(b, t, 2048)
        assert chunk > 0 and chunk % 16 == 0, (t, chunk)
        if t <= 16:
            assert chunk >= t, (t, chunk)
        assert mamba_cuda.bwd_route(t, chunk) == ("one_chunk" if chunk >= t else "chunked")
    assert mamba_cuda.mamba_scan_bwd_plan.cache_info().hits > 0


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_plan_chunk_count(b):
    """The chunked route cuts t into no more chunks than fill the card once
    (264 body blocks of 64 channels, d 2048) and into as many as whole
    segments allow: one segment shorter would give more. A ragged length
    takes the chunk count of the whole length above it (training's t511,
    the check batch's t319)."""
    d = 2048
    target = round(264 / (b * d // 64))
    for t in range(49, 700):
        chunk = mamba_cuda.mamba_scan_bwd_plan(b, t, d)
        count = -(-t // chunk)
        if target <= 1:
            assert count == 1, (t, chunk)
            continue
        assert count <= target, (t, chunk, count)
        assert chunk == 16 or -(-t // (chunk - 16)) > target, (t, chunk)
        if t % (16 * target) == 0:
            assert count == target, (t, chunk, count)
    launched = {8: (511, 1), 4: (511, 2), 2: (319, 4), 1: (511, 8)}
    t, want = launched[b]
    assert -(-t // mamba_cuda.mamba_scan_bwd_plan(b, t, d)) == want


def test_scratch_of_one_call():
    """The scratch one call takes, in bytes: one chunk of one segment takes
    only the parts; the chunked route adds the summaries."""
    b, d, n = 8, 2048, 16
    parts = 4 * (2 * (d // 64) * b * 16 * n + b * d * n + b * d)
    assert mamba_cuda.bwd_scratch_bytes(b, 16, d, 16) >= parts
    one = mamba_cuda.bwd_scratch_bytes(b, 512, d, 512)
    chunked = mamba_cuda.bwd_scratch_bytes(b, 512, d, 64)
    ck = 4 * b * 32 * d * n
    assert ck < one < ck + 4 * (2 * 32 * b * 512 * n + b * d * n + b * d) + 6 * 256
    summaries = 3 * 4 * b * 8 * d * n + 4 * b * 32 * d
    assert chunked > one + summaries
