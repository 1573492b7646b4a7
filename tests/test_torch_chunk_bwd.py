"""The chunked decomposition of the two GLA backwards, on the CPU.

``gla_chunk_conv_bwd_chunked_plain`` and ``gla_chunk_bwd_chunked_plain``
(ops/gla_cuda.py) are the chunked routes of the CUDA backwards of
``gla_chunk_conv`` and ``gla_chunk`` written with tensors: chunk states,
chunk cotangents, and the intra/inter gradients with the 16-row sub-chunk
factorisation (one chunk walk, ``_chunked_bwd_plain``, shared by the two),
followed by the conv's finishing pass or, without convs, the gate gradient
alone. Here every gradient leaf of each is held against jax.grad through
the Pallas kernel's hand-written backward (``gla_chunk_conv_pallas`` and
``gla_chunk_pallas``, interpret mode, f32 residuals), each within 2e-3 of
max(1, max|ref|) as tests/test_gla_pallas.py holds the Pallas backward
itself. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.gla_pallas import gla_chunk_conv_pallas, gla_chunk_pallas
from lina_speech_tpu_torch.ops import gla_cuda

LEAVES = ("xq", "xk", "xv", "gk", "wq", "wk", "wv", "s0")
# gla_chunk_bwd's leaves: q, k, v as _inputs makes xq, xk, xv
QKV_LEAVES = ("xq", "xk", "xv", "gk", "s0")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, t, b=2, h=2, dk=16, dv=32, adversarial=False):
    rng = np.random.default_rng(seed)
    x = dict(
        xq=rng.normal(size=(b, h, t, dk)), xk=rng.normal(size=(b, h, t, dk)),
        xv=rng.normal(size=(b, h, t, dv)),
        gk=np.log(1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(b, h, t, dk))))),
        wq=rng.normal(size=(h * dk, 4)) * 0.5, wk=rng.normal(size=(h * dk, 4)) * 0.5,
        wv=rng.normal(size=(h * dv, 4)) * 0.5, s0=rng.normal(size=(b, h, dk, dv)))
    if adversarial:
        # every sixth key channel decays by 6 to 8 a step: a 64-row chunk's
        # gate sum there falls below -384, so e^{-bcum} would overflow f32
        x["gk"][..., ::6] = -6.0 - 2.0 * rng.random(size=x["gk"][..., ::6].shape)
    ct = dict(do=rng.normal(size=(b, h, t, dv)), dsf=rng.normal(size=(b, h, dk, dv)))
    return ({n: a.astype(np.float32) for n, a in x.items()},
            {n: a.astype(np.float32) for n, a in ct.items()})


def _pallas_grads(x, ct, with_s0):
    """jax.grad of sum(o * do) + sum(sf * dsf) through the Pallas kernel."""
    def loss(*a):
        o, sf = gla_chunk_conv_pallas(*a[:7], initial_state=a[7], chunk_size=16,
                                      interpret=True, residual_dtype=jnp.float32)
        return jnp.sum(o * ct["do"]) + jnp.sum(sf * ct["dsf"])

    s0 = x["s0"] if with_s0 else np.zeros_like(x["s0"])
    args = [jnp.asarray(x[n]) for n in LEAVES[:7]] + [jnp.asarray(s0)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=tuple(range(8)))(*args)]


def _pallas_qkv_grads(x, ct, with_s0, scale):
    """jax.grad of sum(o * do) + sum(sf * dsf) through gla_chunk_pallas."""
    def loss(*a):
        o, sf = gla_chunk_pallas(*a[:4], initial_state=a[4], scale=scale, chunk_size=16,
                                 interpret=True, residual_dtype=jnp.float32)
        return jnp.sum(o * ct["do"]) + jnp.sum(sf * ct["dsf"])

    s0 = x["s0"] if with_s0 else np.zeros_like(x["s0"])
    args = [jnp.asarray(x[n]) for n in QKV_LEAVES[:4]] + [jnp.asarray(s0)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=tuple(range(5)))(*args)]


def _hold(x, ct, with_s0, kind="conv", scale=None):
    """``kind`` "conv": gla_chunk_conv_bwd_chunked_plain against the conv
    kernel's Pallas backward; "qkv": gla_chunk_bwd_chunked_plain (q, k, v
    taken as _inputs makes xq, xk, xv) against gla_chunk_pallas's, at
    ``scale`` (None: dk^-0.5)."""
    tx = {n: torch.from_numpy(a) for n, a in x.items()}
    do, dsf = torch.from_numpy(ct["do"]), torch.from_numpy(ct["dsf"])
    s0 = tx["s0"] if with_s0 else None
    if kind == "conv":
        leaves = LEAVES
        got = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*(tx[n] for n in LEAVES[:7]), s0, do, dsf)
        ref = _pallas_grads(x, ct, with_s0)
    else:
        leaves = QKV_LEAVES
        got = gla_cuda.gla_chunk_bwd_chunked_plain(*(tx[n] for n in QKV_LEAVES[:4]), s0, do, dsf,
                                                   scale=scale)
        ref = _pallas_qkv_grads(x, ct, with_s0, scale)
    assert (got[-1] is None) == (not with_s0)
    for name, a, r in zip(leaves, got, ref):
        if name == "s0" and not with_s0:
            continue
        r = r.reshape(a.shape)
        assert bool(torch.isfinite(a).all()), name
        assert float(np.abs(r).max()) > 0, name
        err = float(np.abs(a.numpy() - r).max())
        assert err <= 2e-3 * max(1.0, float(np.abs(r).max())), (name, err)


def _cases(ts, s0s=None):
    """(kind, t, with_s0, scale) cases, (kind, t, scale) where ``s0s`` is
    None: the conv-fused backward's keep their ids (t, then with_s0);
    gla_chunk_bwd's run at dk^-0.5 (simple-GLA) and 1.0 (Mamba-2)."""
    tag = lambda *parts: "-".join(str(p) for p in parts if p is not None)
    cases = []
    for kind, scales in (("conv", (None,)), ("qkv", (None, 1.0))):
        for t in ts:
            for s0 in (None,) if s0s is None else s0s:
                for scale in scales:
                    args = (kind, t) + (() if s0s is None else (s0,)) + (scale,)
                    label = tag("qkv" if kind == "qkv" else None, t, s0,
                                f"scale{scale}" if kind == "qkv" else None)
                    cases.append(pytest.param(*args, id=label))
    return cases


@pytest.mark.parametrize("kind,t,with_s0,scale", _cases([1, 15, 16, 17, 64, 65, 130], (True, False)))
def test_chunked_backward_matches_pallas_backward(kind, t, with_s0, scale):
    """Ragged chunks (t 1, 65, 130) and ragged sub-chunks (15, 17), with and
    without an initial state; gla_chunk_bwd's at both scales."""
    x, ct = _inputs(40 + t, t)
    _hold(x, ct, with_s0, kind, scale)


@pytest.mark.parametrize("kind,t,scale", _cases([130, 64]))
def test_chunked_backward_is_finite_under_adversarial_gates(kind, t, scale):
    """Gates of -6 to -8 a step in every sixth key channel: no factor of the
    decomposition overflows, and every leaf matches."""
    x, ct = _inputs(70 + t, t, adversarial=True)
    assert float(x["gk"][..., ::6].sum(2).max()) < -300 * (t // 64)
    _hold(x, ct, True, kind, scale)


def test_chunked_backward_rounds_only_product_operands():
    """With bf16 operand rounding the decomposition moves by bf16 rounding of
    the products' operands only: within 2e-2 of each leaf's own max of the
    f32 version (the kernel's tolerance on the card)."""
    x, ct = _inputs(5, 70, dk=32, dv=64)
    tx = [torch.from_numpy(x[n]) for n in LEAVES]
    args = (*tx, torch.from_numpy(ct["do"]), torch.from_numpy(ct["dsf"]))
    exact = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*args)
    rounded = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*args, operand_dtype=torch.bfloat16)
    for name, a, r in zip(LEAVES, rounded, exact):
        err = float((a - r).abs().max())
        assert 0 < err <= 2e-2 * float(r.abs().max()), (name, err)


def test_rounded_decomposition_cancels_the_gate_gradient_of_one_step():
    """One step from a zero state: the exact gate gradient is 0. The dsf .
    S_final term is summed from the very values that enter dk, so with bf16
    operands the two sides of dg still cancel to f32 rounding (a term taken
    from the bf16-rounded state would leave bf16 rounding behind, of the
    size of the dx leaves themselves)."""
    x, ct = _inputs(9, 1)
    tx = [torch.from_numpy(x[n]) for n in LEAVES[:7]]
    got = gla_cuda.gla_chunk_conv_bwd_chunked_plain(
        *tx, None, torch.from_numpy(ct["do"]), torch.from_numpy(ct["dsf"]),
        operand_dtype=torch.bfloat16)
    assert float(got[3].abs().max()) <= 1e-5 * float(got[0].abs().max())


def test_backward_plan_routes_by_io_dtype():
    """bf16 IO takes the chunked body, f32 IO the recurrent sweeps."""
    assert gla_cuda.gla_chunk_conv_bwd_plan(torch.bfloat16) == "chunked"
    assert gla_cuda.gla_chunk_conv_bwd_plan(torch.float32) == "recurrent"


def test_chunked_scratch_is_below_the_recurrent_parts():
    """At the flagship's training shape (b8 h4 t512 dk256 dv512) the chunked
    route's scratch is below the 537 MB of the recurrent route's dq/dk parts."""
    parts = 2 * (512 // 32) * 8 * 4 * 512 * 256 * 4
    assert parts == 536_870_912
    assert gla_cuda.chunked_bwd_scratch_bytes(8, 4, 512, 256, 512) < parts


@pytest.mark.parametrize("shape", [(1, 2, 320, 64, 128), (2, 2, 192, 64, 64)], ids=str)
@pytest.mark.parametrize("seed", [0, 3])
def test_two_part_operands_keep_the_gate_gradient(shape, seed):
    """dg is sum_{s>=t} (q dq - k dk), a difference of near-equal terms. The
    products that feed dq and dk take their operands in two bf16 parts, so
    with bf16 operands the gate gradient summed over batch and time (what a
    gate's bias sees) stays within 3e-3 of its max of the f32 decomposition;
    with those operands rounded once it moved by 6e-3 to 4e-2 here."""
    b, h, t, dk, dv = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bf = torch.bfloat16
    args = [f(b, h, t, dk).to(bf), f(b, h, t, dk).to(bf), f(b, h, t, dv).to(bf),
            torch.nn.functional.logsigmoid(f(b, h, t, dk)) / 16, (f(h * dk, 4) * 0.5).to(bf),
            (f(h * dk, 4) * 0.5).to(bf), (f(h * dv, 4) * 0.5).to(bf), None, f(b, h, t, dv).to(bf),
            torch.zeros(b, h, dk, dv)]
    ref = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*args)[3].sum((0, 2))
    got = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*args, operand_dtype=bf)[3].sum((0, 2))
    assert float((got - ref).abs().max()) <= 3e-3 * float(ref.abs().max())


@pytest.mark.parametrize("scale", [None, 1.0])
def test_rounded_qkv_decomposition_cancels_the_gate_gradient_of_one_step(scale):
    """gla_chunk_bwd's chunked route, one step from a zero state: the exact
    gate gradient is 0, and with bf16 operands the two sides of dg still
    cancel to f32 rounding, at either scale (the scale folds into u = scale
    q and dq carries it back)."""
    x, ct = _inputs(11, 1)
    tx = [torch.from_numpy(x[n]) for n in QKV_LEAVES[:4]]
    args = (*tx, None, torch.from_numpy(ct["do"]), torch.from_numpy(ct["dsf"]))
    exact = gla_cuda.gla_chunk_bwd_chunked_plain(*args, scale=scale)
    got = gla_cuda.gla_chunk_bwd_chunked_plain(*args, scale=scale, operand_dtype=torch.bfloat16)
    assert float(exact[3].abs().max()) <= 1e-5 * float(exact[0].abs().max())
    assert float(got[3].abs().max()) <= 1e-5 * float(got[0].abs().max())
    for name, a, r in zip(QKV_LEAVES[:3], got, exact):
        err = float((a - r).abs().max())
        assert 0 < err <= 2e-2 * float(r.abs().max()), (name, err)


# (IO dtype, b, h, t, dv) of the launches the driven paths give gla_chunk_bwd:
# simple-GLA's training and S0 tuning in bf16 (b8, b2; audio 128-512, so
# t up to 576 with the text), its f32-compute gradient check at b2, Mamba-2's
# training and check in f32 (h32, dv64), and the route sweep's b1 to b8 from
# 16 tokens, on either side of the threshold
_BWD_PLAN_SHAPES = [(io, b, h, t, dv)
                    for io, heads in ((torch.bfloat16, ((4, 256),)),
                                      (torch.float32, ((4, 256), (32, 64))))
                    for h, dv in heads for b in (1, 2, 8)
                    for t in (1, 16, 47, 48, 128, 317, 512, 576)]


@pytest.mark.parametrize("io,b,h,t,dv", _BWD_PLAN_SHAPES, ids=str)
def test_chunk_backward_plan_routes_by_io_dtype_and_length(io, b, h, t, dv):
    """gla_chunk_bwd_plan: bf16 IO from 48 tokens takes the chunked body
    (every training and tuning launch: t >= 128), shorter bf16 inputs and
    f32 IO the recurrent sweeps, which the card's route sweep found faster
    at 32 tokens and below."""
    want = "chunked" if io == torch.bfloat16 and t >= 48 else "recurrent"
    assert gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv) == want


def test_chunk_bwd_chunked_scratch_is_below_the_recurrent_parts():
    """At simple-GLA's training shape (b8 h4 t512 dk256 dv256) the chunked
    route's whole scratch, its one part of dq and dk included, is below the
    268 MB of the recurrent route's per-tile dq/dk parts alone."""
    parts = 2 * (256 // 32) * 8 * 4 * 512 * 256 * 4
    assert parts == 268_435_456
    chunked = gla_cuda.chunk_bwd_scratch_bytes(8, 4, 512, 256, 256, "chunked")
    assert chunked < parts < gla_cuda.chunk_bwd_scratch_bytes(8, 4, 512, 256, 256, "recurrent")
