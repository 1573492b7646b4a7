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
    gla_chunk_conv_pallas, gla_chunk_pallas, gla_decode_conv_fused, gla_decode_fused,
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
    q, k, v, _, s0 = (torch.from_numpy(a) for a in _gla_inputs(9, t=3))
    gla_cuda.gla_decode(q[:, :, 0], k[:, :, 0], v[:, :, 0], -torch.ones(2, 2, 16), s0)
    gla_cuda.gla_chunk(q.requires_grad_(True), k, v, -torch.ones(2, 2, 3, 16))
    assert gla_cuda.launch_counts() == dict.fromkeys(
        ("gla_chunk_conv", "gla_chunk_conv_bwd", "gla_chunk", "gla_chunk_bwd",
         "gla_decode_conv", "gla_decode", "gla_decode_lazy_conv", "gla_fold", "gla_fold_q"), 0)
    assert all(not shapes for shapes in gla_cuda.launch_shapes().values())
    assert gla_cuda.gla_decode_lazy_conv.q_launches == 0


# ------------------------------------------------ gla_chunk_conv gradients
_LEAVES = ("xq", "xk", "xv", "gk", "wq", "wk", "wv", "s0")


def _conv_grad_inputs(seed, t, b=2, h=2, dk=16, dv=32):
    xq, xk, xv, gk, s0 = _gla_inputs(seed, b=b, h=h, t=t, dk=dk, dv=dv)
    rng = np.random.default_rng(seed + 1)
    taps = [rng.normal(size=(h * d, 4)).astype(np.float32) * 0.5 for d in (dk, dk, dv)]
    return dict(zip(_LEAVES, (xq, xk, xv, gk, *taps, s0)))


def _torch_conv_grads(x, loss_of):
    leaves = [torch.from_numpy(x[n]).requires_grad_(True) for n in _LEAVES]
    o, sf = gla_cuda.gla_chunk_conv(*leaves[:7], initial_state=leaves[7], chunk_size=16)
    return torch.autograd.grad(loss_of(o, sf), leaves)


@pytest.mark.parametrize("t", [40, 7])
def test_chunk_conv_gradients_match_pallas_backward(t):
    """All eight gradient leaves of the plain version under autograd against
    jax.grad through the Pallas kernel's hand-written backward (interpret
    mode, f32 residuals), f32 IO, non-zero s0, loss sum(o^2) + sum(sf^2);
    each leaf within 2e-3 of max(1, max|ref|), as tests/test_gla_pallas.py
    holds the Pallas backward itself."""
    x = _conv_grad_inputs(20 + t, t)

    def loss_jax(*a):
        o, s = gla_chunk_conv_pallas(*a[:7], initial_state=a[7], chunk_size=16,
                                     interpret=True, residual_dtype=jnp.float32)
        return jnp.sum(o ** 2) + jnp.sum(s ** 2)

    g_jax = jax.grad(loss_jax, argnums=tuple(range(8)))(*(jnp.asarray(x[n]) for n in _LEAVES))
    g_torch = _torch_conv_grads(x, lambda o, sf: (o ** 2).sum() + (sf ** 2).sum())
    for name, a, r in zip(_LEAVES, g_torch, g_jax):
        r = np.asarray(r, np.float32).reshape(a.shape)
        assert float(np.abs(r).max()) > 0, name
        err = float(np.abs(a.numpy() - r).max())
        assert err <= 2e-3 * max(1.0, float(np.abs(r).max())), (name, err)


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1 + z * (1 - s))


def _recurrent_backward(x, do, dsf, tile=8):
    """The CUDA backward's algorithm (csrc/gla_chunk_conv_bwd.cu) written
    with tensors: a forward sweep that recomputes S_t and emits dq and the
    dsf . S_final term, a reverse sweep that carries the decayed dS and emits
    dk, dv and ds0 -- both per tile of ``tile`` value columns, dq and dk
    summed over the tiles afterwards --, then the running sum for dg, silu'
    and the transposed conv with the tap sums."""
    xq, xk, xv, gk, wq, wk, wv, s0 = (torch.from_numpy(x[n]) for n in _LEAVES)
    b, h, t, dk = xq.shape
    dv = xv.shape[-1]
    scale = dk ** -0.5

    def pre(xx, w):  # conv pre-activation (b, h, t, d); tap 0 oldest
        xp = torch.nn.functional.pad(xx, (0, 0, 3, 0))
        wh = w.reshape(h, -1, 4)
        return sum(xp[:, :, i:i + t] * wh[None, :, None, :, i] for i in range(4))

    zq, zk, zv = pre(xq, wq), pre(xk, wk), pre(xv, wv)
    q, k, v = (z * torch.sigmoid(z) for z in (zq, zk, zv))
    eg = gk.exp()
    dq, dk_ = torch.zeros_like(q), torch.zeros_like(k)
    dvv, ds0 = torch.zeros_like(v), torch.zeros_like(s0)
    dsg = torch.zeros(b, h, dk)
    for c0 in range(0, dv, tile):
        cols = slice(c0, c0 + tile)
        S = s0[..., cols].clone()
        for i in range(t):
            S = eg[:, :, i, :, None] * S + k[:, :, i, :, None] * v[:, :, i, None, cols]
            dq[:, :, i] += scale * (S * do[:, :, i, None, cols]).sum(-1)
        dsg += (dsf[..., cols] * S).sum(-1)
        carry = dsf[..., cols].clone()
        for i in reversed(range(t)):
            dS = carry + scale * q[:, :, i, :, None] * do[:, :, i, None, cols]
            dk_[:, :, i] += (dS * v[:, :, i, None, cols]).sum(-1)
            dvv[:, :, i, cols] = (k[:, :, i, :, None] * dS).sum(-2)
            carry = eg[:, :, i, :, None] * dS
        ds0[..., cols] = carry
    dg = torch.flip(torch.cumsum(torch.flip(q * dq - k * dk_, [2]), 2), [2]) + dsg[:, :, None]

    def conv_bwd(dy, z, xx, w):
        dz = dy * _silu_grad(z)
        wh = w.reshape(h, -1, 4)
        dzp = torch.nn.functional.pad(dz, (0, 0, 0, 3))
        dx = sum(wh[None, :, None, :, 3 - j] * dzp[:, :, j:j + t] for j in range(4))
        xp = torch.nn.functional.pad(xx, (0, 0, 3, 0))
        dw = torch.stack([(dz * xp[:, :, i:i + t]).sum((0, 2)) for i in range(4)], -1)
        return dx, dw.reshape(w.shape)

    dxq, dwq = conv_bwd(dq, zq, xq, wq)
    dxk, dwk = conv_bwd(dk_, zk, xk, wk)
    dxv, dwv = conv_bwd(dvv, zv, xv, wv)
    return dxq, dxk, dxv, dg, dwq, dwk, dwv, ds0


@pytest.mark.parametrize("t", [40, 7, 1])
def test_recurrent_backward_algorithm_matches_autograd(t):
    """The identities the CUDA backward rests on, on the CPU in f32: the
    recurrent formulas with random do and dsf give autograd's gradients of
    the plain version (1e-4 of max(1, max|ref|): summation order only)."""
    x = _conv_grad_inputs(30 + t, t)
    rng = np.random.default_rng(t)
    do = torch.from_numpy(rng.normal(size=x["xv"].shape).astype(np.float32))
    dsf = torch.from_numpy(rng.normal(size=x["s0"].shape).astype(np.float32))
    ref = _torch_conv_grads(x, lambda o, sf: (o * do).sum() + (sf * dsf).sum())
    got = _recurrent_backward(x, do, dsf)
    for name, a, r in zip(_LEAVES, got, ref):
        err = float((a - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (name, err)


# ------------------------------------------------- gla_decode, gla_chunk grads
@pytest.mark.parametrize("state_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_gla_decode_plain_matches_fused_decode_and_step(state_dtype, scale):
    """gla_decode's plain version (ops/gla.py:gla_decode_step) against the
    Pallas gla_decode_fused in interpret mode and the JAX plain step: eight
    tokens threading the state, o and the state in the state's dtype."""
    q, k, v, gk, s0 = _gla_inputs(20, t=8, dk=32, dv=64)
    jdt = jnp.dtype(state_dtype)
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    j_pal = j_step = jnp.asarray(s0).astype(jdt)
    t_st = torch.from_numpy(s0).to(tdt)
    tol = F32_TOL if jdt == jnp.float32 else BF16_TOL
    for i in range(8):
        tok = [a[:, :, i] for a in (q, k, v, gk)]
        o_pal, j_pal = gla_decode_fused(*map(jnp.asarray, tok), j_pal, scale=scale,
                                        interpret=True, donate=False)
        o_step, j_step = jgla.gla_decode_step(*map(jnp.asarray, tok), j_step, scale=scale)
        o_t, t_st = gla_cuda.gla_decode_plain(*map(torch.from_numpy, tok), t_st, scale=scale)
        assert t_st.dtype == tdt
        for ref_o, ref_s in ((o_pal, j_pal), (o_step, j_step)):
            _close(o_t, ref_o, tol)
            _close(t_st, ref_s, tol)
    o_w, s_w = gla_cuda.gla_decode(*(torch.from_numpy(a[:, :, 0]) for a in (q, k, v, gk)),
                                   t_st, scale=scale)
    o_p, s_p = gla_cuda.gla_decode_plain(*(torch.from_numpy(a[:, :, 0]) for a in (q, k, v, gk)),
                                         t_st, scale=scale)
    assert torch.equal(o_w, o_p) and torch.equal(s_w, s_p)


def _chunk_grads_torch(args, s0, do, dsf, scale, scalar_gate):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    q, k, v, g = leaves
    if scalar_gate:
        g = g.expand(*g.shape[:-1], q.shape[-1]).contiguous()
    s0_t = None if s0 is None else torch.from_numpy(s0).requires_grad_(True)
    o, sf = gla_cuda.gla_chunk(q, k, v, g, initial_state=s0_t, scale=scale, chunk_size=16)
    loss = (o * torch.from_numpy(do)).sum() + (sf * torch.from_numpy(dsf)).sum()
    wanted = leaves + ([] if s0_t is None else [s0_t])
    return [t.numpy() for t in torch.autograd.grad(loss, wanted)]


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("scalar_gate", [False, True])
@pytest.mark.parametrize("scale", [None, 1.0])
def test_chunk_plain_gradients_match_pallas_backward(with_s0, scalar_gate, scale):
    """Autograd through gla_chunk's plain version (what the hand-written
    backward is held against on the card) against jax.grad of
    gla_chunk_pallas in interpret mode, the Pallas backward with f32
    residuals, at tests/test_gla_pallas.py's gradient shape (b2 h2 t60 dk16
    dv16, chunk 16): with and without s0, with a per-head gate broadcast
    over dk (simple-GLA, Mamba-2) and with scale 1.0 (Mamba-2). Each
    gradient within 1e-3 of its own max|ref|."""
    q, k, v, gk, s0 = _gla_inputs(21, b=2, h=2, t=60, dk=16, dv=16)
    if scalar_gate:
        gk = gk[..., :1].copy()
    rng = np.random.default_rng(22)
    do = rng.normal(size=v.shape).astype(np.float32)
    dsf = rng.normal(size=s0.shape).astype(np.float32)
    s0 = s0 if with_s0 else None

    def loss(q, k, v, g, *s):
        if scalar_gate:
            g = jnp.broadcast_to(g, q.shape)
        o, sf = gla_chunk_pallas(q, k, v, g, initial_state=s[0] if s else None, scale=scale,
                                 chunk_size=16, interpret=True, residual_dtype=jnp.float32)
        return jnp.sum(o * do) + jnp.sum(sf * dsf)

    args = (q, k, v, gk)
    jargs = [jnp.asarray(a) for a in args] + ([] if s0 is None else [jnp.asarray(s0)])
    ref = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    got = _chunk_grads_torch(args, s0, do, dsf, scale, scalar_gate)
    assert len(got) == len(ref)
    for name, a, r in zip(("dq", "dk", "dv", "dg", "ds0"), got, ref):
        r = np.asarray(r)
        assert a.shape == r.shape, name
        assert float(np.abs(a - r).max()) <= 1e-3 * float(np.abs(r).max()), name


def test_kernel_takes_is_decided_from_shapes_and_dtypes():
    """The routing predicate: head key dims 64/128/256, value dims in
    multiples of 32, f32/bf16 IO and states; int8 states at value widths the
    int8 kernels are built for. Nothing is launched to decide."""
    bf, f32 = torch.bfloat16, torch.float32
    takes = gla_cuda.kernel_takes
    for dk in (64, 128, 256):
        assert takes(dk, 64, bf, bf) and takes(dk, 512, f32, f32) and takes(dk, 96, bf, f32)
    assert not takes(32, 64, f32, f32)      # lina_gla_tiny: head key dim 32
    assert not takes(48, 64, bf, bf)
    assert not takes(64, 16, f32, f32)      # Mamba-2 at tiny width: headdim 16
    assert not takes(64, 64, torch.float16, f32)
    assert not takes(64, 64, bf, torch.float16)
    assert takes(256, 512, bf, torch.int8) and not takes(256, 96, bf, torch.int8)
    assert not takes(64, 64, bf, torch.int8)
