"""PyTorch port ops vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and cross between frameworks as
numpy arrays. The port's plain kernel versions are held against the JAX
Pallas kernels in interpret mode (as tests/test_gla_pallas.py runs them).
Tolerances: f32 results differ only in summation order (1e-4 on O(1)
values); bf16 results may differ by one bf16 ulp where a 4-tap f32 sum is
rounded (2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops import gla as jgla
from lina_speech_tpu.ops import short_conv as jconv
from lina_speech_tpu.ops import rotary as jrot
from lina_speech_tpu.ops import tools as jtools
from lina_speech_tpu.ops.gla_pallas import (
    gla_chunk_conv_pallas, gla_chunk_pallas, gla_decode_conv_fused,
)
from lina_speech_tpu_torch.ops import gla as tgla
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops import rotary as trot
from lina_speech_tpu_torch.ops import short_conv as tconv
from lina_speech_tpu_torch.ops import tools as ttools
from lina_speech_tpu_torch.ops.sampling import topk_sampling

F32_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _gla_inputs(seed, b=2, h=2, t=37, dk=16, dv=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t, dk)).astype(np.float32)
    k = rng.normal(size=(b, h, t, dk)).astype(np.float32)
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    # log-gates <= 0 with a spread of decays
    gk = np.log(1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(b, h, t, dk))))).astype(np.float32)
    s0 = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    return q, k, v, gk, s0


def _close(torch_val, jax_val, tol):
    np.testing.assert_allclose(torch_val.float().numpy(),
                               np.asarray(jax_val, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [37, 64])
def test_gla_scan_ref_and_chunk_match_jax(t):
    q, k, v, gk, s0 = _gla_inputs(0, t=t)
    jo, js = jgla.gla_scan_ref(*map(jnp.asarray, (q, k, v, gk)), initial_state=jnp.asarray(s0))
    to, ts = tgla.gla_scan_ref(*map(torch.from_numpy, (q, k, v, gk)), torch.from_numpy(s0))
    _close(to, jo, F32_TOL)
    _close(ts, js, F32_TOL)
    jo, js = jgla.gla_chunk(*map(jnp.asarray, (q, k, v, gk)), initial_state=jnp.asarray(s0),
                            chunk_size=32)
    to, ts = tgla.gla_chunk(*map(torch.from_numpy, (q, k, v, gk)), torch.from_numpy(s0),
                            chunk_size=32)
    _close(to, jo, F32_TOL)
    _close(ts, js, F32_TOL)


def test_gla_decode_step_matches_jax():
    q, k, v, gk, s0 = _gla_inputs(1, t=1)
    args = [x[:, :, 0] for x in (q, k, v, gk)]
    jo, js = jgla.gla_decode_step(*map(jnp.asarray, args), jnp.asarray(s0))
    to, ts = tgla.gla_decode_step(*map(torch.from_numpy, args), torch.from_numpy(s0))
    _close(to, jo, F32_TOL)
    _close(ts, js, F32_TOL)


def test_short_conv_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    ring = rng.normal(size=(4, 2, 12)).astype(np.float32)
    _close(tconv.causal_depthwise_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jconv.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w)), F32_TOL)
    ty, tr = tconv.short_conv_step(torch.from_numpy(x[:, 0]), torch.from_numpy(ring),
                                   torch.from_numpy(w))
    jy, jr = jconv.short_conv_step(jnp.asarray(x[:, 0]), jnp.asarray(ring), jnp.asarray(w))
    _close(ty, jy, F32_TOL)
    _close(tr, jr, 0.0)


def test_rotary_and_delay_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    pos = np.arange(5) + 7
    _close(trot.apply_rotary(torch.from_numpy(x), torch.from_numpy(pos), 8),
           jrot.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 8), 1e-5)
    code = rng.integers(0, 50, size=(2, 6))
    d_t = ttools.delay_rvq(torch.from_numpy(code))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(jtools.delay_rvq(jnp.asarray(code))))
    ext = np.stack([d_t.numpy()] * 3, axis=1)
    np.testing.assert_array_equal(ttools.undelay_rvq(torch.from_numpy(ext)).numpy(),
                                  np.asarray(jtools.undelay_rvq(jnp.asarray(ext))))


def test_topk_sampling_greedy_and_support():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(64, 30)).astype(np.float32))
    np.testing.assert_array_equal(topk_sampling(None, logits, k=1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)))
    gen = torch.Generator().manual_seed(0)
    ids = topk_sampling(gen, logits, k=3, temp=0.7)
    top3 = torch.topk(logits, 3).indices
    assert bool((ids[:, None] == top3).any(-1).all())
    with pytest.raises(NotImplementedError):
        topk_sampling(gen, logits, k=3, approx=True)


@pytest.mark.parametrize("state_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("random_s0", [False, True])
def test_chunk_conv_plain_matches_pallas(state_dtype, random_s0):
    xq, xk, xv, gk, s0 = _gla_inputs(5, b=2, h=2, t=37, dk=16, dv=32)
    rng = np.random.default_rng(6)
    wq = rng.normal(size=(32, 4)).astype(np.float32) * 0.5
    wk = rng.normal(size=(32, 4)).astype(np.float32) * 0.5
    wv = rng.normal(size=(64, 4)).astype(np.float32) * 0.5
    if not random_s0:
        s0 = np.zeros_like(s0)
    js0 = jnp.asarray(s0).astype(state_dtype)
    jo, js = gla_chunk_conv_pallas(*map(jnp.asarray, (xq, xk, xv, gk, wq, wk, wv)),
                                   initial_state=js0, chunk_size=16, interpret=True)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(
        torch.bfloat16 if state_dtype == jnp.bfloat16 else torch.float32)
    to, ts = gla_cuda.gla_chunk_conv(*map(torch.from_numpy, (xq, xk, xv, gk, wq, wk, wv)),
                                     initial_state=ts0, chunk_size=16)
    assert ts.dtype == ts0.dtype and to.dtype == torch.float32
    _close(to, jo, F32_TOL)
    _close(ts, js, F32_TOL if state_dtype == jnp.float32 else BF16_TOL)


@pytest.mark.parametrize("state_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("t", [37, 16, 2, 1])
def test_chunk_plain_matches_pallas(state_dtype, t):
    """gla_chunk (post-conv q, k, v) with a non-zero initial state and a
    ragged t, down to a single token."""
    q, k, v, gk, s0 = _gla_inputs(9, b=2, h=2, t=t, dk=16, dv=32)
    js0 = jnp.asarray(s0).astype(state_dtype)
    jo, js = gla_chunk_pallas(*map(jnp.asarray, (q, k, v, gk)), initial_state=js0,
                              chunk_size=16, interpret=True)
    ts0 = torch.from_numpy(np.array(js0.astype(jnp.float32))).to(
        torch.bfloat16 if state_dtype == jnp.bfloat16 else torch.float32)
    to, ts = gla_cuda.gla_chunk(*map(torch.from_numpy, (q, k, v, gk)), initial_state=ts0,
                                chunk_size=16)
    assert ts.dtype == ts0.dtype and to.dtype == torch.float32
    _close(to, jo, F32_TOL)
    _close(ts, js, F32_TOL if state_dtype == jnp.float32 else BF16_TOL)
    o0, s_zero = gla_cuda.gla_chunk(*map(torch.from_numpy, (q, k, v, gk)))
    assert s_zero.dtype == torch.float32
    _close(o0, gla_chunk_pallas(*map(jnp.asarray, (q, k, v, gk)), chunk_size=16,
                                interpret=True)[0], F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_conv_plain_matches_pallas(dtype):
    b, h, dk, dv, w = 2, 2, 16, 32, 4
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    gk = np.log(1.0 / (1.0 + np.exp(-f(b, h, dk)))).astype(np.float32)
    io = [f(b, h, dk), f(b, h, dk), f(b, h, dv)]
    taps = [f(w, h, dk) * 0.5, f(w, h, dk) * 0.5, f(w, h, dv) * 0.5]
    rings = [f(w, b, h, dk), f(w, b, h, dk), f(w, b, h, dv)]
    state = f(b, h, dk, dv)
    jx = [jnp.asarray(a).astype(dtype) for a in io + taps + rings]
    jout = gla_decode_conv_fused(*jx[:3], jnp.asarray(gk), *jx[3:], jnp.asarray(state),
                                 interpret=True, donate=False)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jx]
    tout = gla_cuda.gla_decode_conv(*tx[:3], torch.from_numpy(gk), *tx[3:],
                                    torch.from_numpy(state))
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    for name, a, j in zip(("o", "state", "cq", "ck", "cv"), tout, jout):
        assert a.shape == j.shape, name
        _close(a, j, tol)


def test_wrappers_count_no_launch_on_cpu():
    gla_cuda.reset_launch_counts()
    xq, xk, xv, gk, s0 = _gla_inputs(8, t=5)
    w = torch.ones(32, 4)
    gla_cuda.gla_chunk_conv(*map(torch.from_numpy, (xq, xk, xv, gk)), w, w,
                            torch.ones(64, 4))
    assert gla_cuda.launch_counts() == dict.fromkeys(
        ("gla_chunk_conv", "gla_chunk", "gla_decode_conv", "gla_decode_lazy_conv",
         "gla_fold"), 0)
