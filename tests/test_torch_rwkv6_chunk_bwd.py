"""The chunked decomposition of the RWKV6 backward, on the CPU.

``rwkv6_chunk_bwd_chunked_plain`` (ops/rwkv6_cuda.py) is the chunked route
of the CUDA backward written with tensors: the GLA backward's chunk walk
(``gla_cuda._chunked_bwd_plain``) with r in u's place, the readout decayed
at the exclusive gate sum, strict pairs in the intra-chunk terms and the
bonus u on the diagonal of dv's scores, then the finishing pass (the bonus's
parts of dr and dk, du, and dw in its inclusive and exclusive parts). Here
its six leaves (dr, dk, dv, dw, du, ds0) are held against jax.grad through
``rwkv6_chunk_pallas``'s hand-written backward (interpret mode, f32
residuals, as tests/test_rwkv6_pallas.py runs it) and against autograd
through ``rwkv6_chunk_plain``, on the same inputs made with numpy from a
seed: in f32 each within 1e-4 of its own max|ref| (summation order), with
bf16 operands within 2e-2 (the kernels' tolerance on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.rwkv6_pallas import rwkv6_chunk_pallas
from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda

F32, BF16 = torch.float32, torch.bfloat16
LEAVES = ("r", "k", "v", "w", "u", "s0")
TOL_F32, TOL_BF16 = 1e-4, 2e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, t, b=2, h=2, dk=16, dv=32, adversarial=False):
    """r, k, v, f32 log-decays -exp(N(-2, 0.5)) as a trained layer's, the
    bonus u, an initial state and the cotangents do and dsf, f32 numpy.
    ``adversarial``: every sixth key channel decays by 6 to 8 a step (a
    64-row chunk's gate sum there falls below -384, so e^{-b} would overflow
    f32) and 5% of the steps reset with -20, as a packed batch's segment
    starts do (models/rwkv6.py)."""
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.normal(size=(b, h, t, dk)) * 0.5 - 2.0)
    if adversarial:
        w[..., ::6] = -6.0 - 2.0 * rng.random(size=w[..., ::6].shape)
        w = np.where(rng.random(size=(b, 1, t, 1)) < 0.05, -20.0, w)
    x = dict(r=rng.normal(size=(b, h, t, dk)), k=rng.normal(size=(b, h, t, dk)),
             v=rng.normal(size=(b, h, t, dv)), w=w, u=rng.normal(size=(h, dk)) * 0.5,
             s0=rng.normal(size=(b, h, dk, dv)), do=rng.normal(size=(b, h, t, dv)),
             dsf=rng.normal(size=(b, h, dk, dv)))
    return {n: np.ascontiguousarray(a, dtype=np.float32) for n, a in x.items()}


def _torch(x, with_s0, io=F32):
    """(the backward's arguments, r, k, v in ``io``) from _inputs."""
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    for n in ("r", "k", "v", "do"):
        t[n] = t[n].to(io)
    return (t["r"], t["k"], t["v"], t["w"], t["u"], t["s0"] if with_s0 else None, t["do"],
            t["dsf"])


def _pallas_grads(x, with_s0):
    """jax.grad of sum(o * do) + sum(sf * dsf) through the Pallas kernel's
    hand-written backward, w.r.t. r, k, v, w, u and s0 (a zero s0 without
    one)."""
    def loss(*a):
        o, sf = rwkv6_chunk_pallas(*a[:5], initial_state=a[5], chunk_size=16, interpret=True,
                                   residual_dtype=jnp.float32)
        return jnp.sum(o * x["do"]) + jnp.sum(sf * x["dsf"])

    s0 = x["s0"] if with_s0 else np.zeros_like(x["s0"])
    args = [jnp.asarray(x[n]) for n in LEAVES[:5]] + [jnp.asarray(s0)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=tuple(range(6)))(*args)]


def _autograd_grads(x, with_s0):
    """Autograd of the same loss through rwkv6_chunk_plain (the JAX
    package's chunked form, in f32)."""
    args = list(_torch(x, with_s0))
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    s0 = args[5].clone().requires_grad_(True) if with_s0 else None
    o, sf = rwkv6_cuda.rwkv6_chunk_plain(*leaves, initial_state=s0)
    loss = (o * args[6]).sum() + (sf * args[7]).sum()
    grads = torch.autograd.grad(loss, leaves + ([s0] if with_s0 else []))
    return [g.numpy() for g in grads]


def _hold(got, ref, x, with_s0, tol, what):
    """Every leaf of ``got`` finite, of ``ref``'s shape and within ``tol`` of
    its own max|ref|. dw one step from a zero state is 0 in exact arithmetic
    (dsf . S_final and k . dkS, two equal terms, cancel): held to the size
    of those terms, max|k dk|."""
    assert (got[5] is None) == (not with_s0)
    for name, a, r in zip(LEAVES, got, ref):
        if a is None:
            continue
        a = a.float().numpy()
        assert a.shape == r.shape, (what, name)
        assert np.isfinite(a).all(), (what, name)
        scale = float(np.abs(r).max())
        if name == "w" and x["r"].shape[2] == 1 and not with_s0:
            scale = float(np.abs(x["k"] * ref[1]).max())
        assert scale > 0, (what, name)
        err = float(np.abs(a - r).max())
        assert err <= tol * scale, (what, name, err, tol * scale)


# (t, with an f32 initial state): ragged last chunks (1, 63, 65, 130) and a
# whole one (64), with and without an initial state
CASES = [(t, s0) for t in (1, 63, 64, 65, 130) for s0 in (True, False)]


@pytest.mark.parametrize("t,with_s0", CASES, ids=str)
def test_chunked_backward_matches_pallas_and_autograd(t, with_s0):
    """All six leaves against the Pallas kernel's backward and against
    autograd through rwkv6_chunk_plain, in f32."""
    x = _inputs(40 + t, t)
    got = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*_torch(x, with_s0))
    _hold(got, _pallas_grads(x, with_s0), x, with_s0, TOL_F32, "pallas")
    _hold(got, _autograd_grads(x, with_s0), x, with_s0, TOL_F32, "autograd")


@pytest.mark.parametrize("t,with_s0", [(65, False), (130, True)], ids=str)
def test_chunked_backward_is_finite_under_adversarial_gates(t, with_s0):
    """Decays of 6 to 8 a step in every sixth key channel and -20 resets: no
    factor of the decomposition overflows (every exponent <= 0 through the
    16-row split, the exclusive readout sums included), and every leaf
    matches both references."""
    x = _inputs(70 + t, t, adversarial=True)
    assert float(x["w"][..., ::6].sum(2).max()) < -300 * (t // 64)
    got = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*_torch(x, with_s0))
    _hold(got, _pallas_grads(x, with_s0), x, with_s0, TOL_F32, "pallas")
    _hold(got, _autograd_grads(x, with_s0), x, with_s0, TOL_F32, "autograd")


@pytest.mark.parametrize("with_s0", [True, False])
def test_bf16_operands_move_each_leaf_by_rounding_only(with_s0):
    """bf16 IO with the kernels' rounding points (every product operand in
    bf16, those that feed dr and dk in two parts): each leaf within 2e-2 of
    its own max of the f32 decomposition on the same values, and moved
    (the rounding is there) but du, whose r k (do . v) takes no rounded
    product operand: the same bits."""
    x = _inputs(5, 70, dk=32, dv=64)
    args = _torch(x, with_s0, BF16)
    exact = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*args)
    rounded = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*args, operand_dtype=BF16)
    assert [g is None for g in rounded] == [g is None for g in exact]
    for name, a, r in zip(LEAVES, rounded, exact):
        if r is None:
            continue
        assert a.dtype == r.dtype, name
        err = float((a.float() - r.float()).abs().max())
        assert (err == 0) == (name == "u"), (name, err)
        assert err <= TOL_BF16 * float(r.float().abs().max()), (name, err)


def test_rounded_decomposition_cancels_the_decay_gradient_of_one_step():
    """One step from a zero state: the exact dw is 0. The dsf . S_final term
    is summed from the very values that enter dkS, so with bf16 operands the
    two sides of dw still cancel to f32 rounding."""
    x = _inputs(9, 1)
    got = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*_torch(x, False, BF16), operand_dtype=BF16)
    assert float(got[3].abs().max()) <= 1e-5 * float(got[1].float().abs().max())


def _decay_grad_sums(args, one_part):
    """dw of the chunked plain summed over batch and time (what a decay's
    parameter sees), in f32 and with bf16 operands: two parts (the kernels')
    or, with ``one_part``, every operand rounded once."""
    exact = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*args)[3].sum((0, 2))
    rounding = gla_cuda._operand_rounding
    if one_part:  # the products that feed dr and dk on once-rounded operands
        gla_cuda._operand_rounding = lambda dtype: (rounding(dtype)[0],) * 2
    try:
        got = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*args, operand_dtype=BF16)[3].sum((0, 2))
    finally:
        gla_cuda._operand_rounding = rounding
    return float((got - exact).abs().max()) / float(exact.abs().max())


@pytest.mark.parametrize("seed", [0, 3])
def test_two_part_operands_keep_the_decay_gradient(seed):
    """dw is sum_{s>=t} (-k dkS) + sum_{s>t} r drS + dsf . S_final, a
    difference of near-equal sums. The products that feed drS and dkS take
    their operands in two bf16 parts, so with bf16 operands dw summed over
    batch and time stays within 3e-3 of its max of the f32 decomposition;
    with those operands rounded once it moves past that."""
    x = _inputs(seed, 192, b=2, dk=64, dv=64)
    x["w"] /= 4  # slow decays: the state keeps many steps, as a trained layer's
    args = _torch(x, True, BF16)
    two, one = _decay_grad_sums(args, False), _decay_grad_sums(args, True)
    assert two <= 3e-3 < one, (two, one)


# (IO dtype, b, t) of the launches the driven paths give rwkv6_chunk_bwd at
# the flagship's RWKV6 heads (h4 dk256 dv256): the training at b8 (audio
# 128-512, so t up to 576 with the text; the last step's two micro-batches
# at b4), the gradient check at b2, the f32-compute copy's f32 IO, and the
# route sweep's b1 to b8 from 16 tokens, on either side of the threshold
_PLAN_SHAPES = [(io, b, t) for io in (BF16, F32) for b in (1, 2, 4, 8)
                for t in (1, 16, 48, 63, 64, 95, 96, 128, 317, 512, 576)]


@pytest.mark.parametrize("io,b,t", _PLAN_SHAPES, ids=str)
def test_backward_plan_routes_by_io_dtype_and_length(io, b, t):
    """rwkv6_chunk_bwd_plan: bf16 IO from 96 tokens (64 above 16 heads in
    flight) takes the chunked body (every training launch), shorter bf16
    inputs and f32 IO the recurrent sweeps, which the card's route sweep
    found faster below those lengths."""
    want = "chunked" if io == BF16 and t >= (64 if b * 4 > 16 else 96) else "recurrent"
    assert rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, 4, t, 256) == want


def test_chunked_backward_scratch_at_the_training_shape():
    """At the training shape (b8 h4 t512 dk256 dv256) the chunked route's
    whole scratch is GLA's chunked backward's at the same head (260.7 MB)
    plus the one part of vdo and RWKV6's du shares, below the recurrent
    route's 269 MB; the recurrent route's is its dv/32 parts of drS, dkS and
    vdo, the dsf term's and the segments' dw totals and du shares."""
    b, h, t, dk, dv = 8, 4, 512, 256, 256
    chunked = rwkv6_cuda.chunk_bwd_scratch_bytes(b, h, t, dk, dv, "chunked")
    recurrent = rwkv6_cuda.chunk_bwd_scratch_bytes(b, h, t, dk, dv, "recurrent")
    gla = gla_cuda.chunk_bwd_scratch_bytes(b, h, t, dk, dv, "chunked")
    assert chunked == gla + 4 * b * h * t + 4 * (t // 64) * b * h * dk
    assert recurrent == 2 * (dv // 32) * b * h * t * dk * 4 + (dv // 32) * b * h * (t + dk) * 4 \
        + 2 * (t // 64) * b * h * dk * 4
    assert chunked < recurrent
    sizes = rwkv6_cuda._chunk_bwd_sizes(b, h, t, dk, dv, "recurrent")
    assert sizes[6:] == [0] * 13  # the chunked route's arrays: not allocated


def test_cpu_backward_raises_and_reset_clears_its_routes():
    """The backward wrapper runs on CUDA tensors only (on the CPU autograd
    through rwkv6_chunk_plain is the backward); reset_launch_counts clears
    its routes and its shapes' launch counts."""
    x = _inputs(2, 8)
    rwkv6_cuda.rwkv6_chunk_bwd.routes["chunked"] = 2
    rwkv6_cuda.reset_launch_counts()
    assert rwkv6_cuda.rwkv6_chunk_bwd.routes == {"recurrent": 0, "chunked": 0}
    assert rwkv6_cuda.launch_shape_counts()["rwkv6_chunk_bwd"] == {}
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6_cuda.rwkv6_chunk_bwd(*_torch(x, True))
    assert rwkv6_cuda.launch_counts()["rwkv6_chunk_bwd"] == 0
