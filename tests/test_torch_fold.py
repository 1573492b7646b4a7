"""The two lazy-window folds of the PyTorch port on the CPU: the plain
mirror of their CUDA kernels' arithmetic against the JAX package's Pallas
folds, and the band plans.

The CUDA kernels (csrc/gla_fold.cu, csrc/gla_fold_q.cu) take the rank-L
update on the tensor cores from the decayed keys in three bf16 parts and v
in three (f32 buffers) or one (bf16) part. ``gla_fold_parts_plain`` and
``gla_fold_q_parts_plain`` mirror that decomposition; the card holds the
kernels against them (tests/test_torch_gpu.py). Here they are held against
``gla_fold_fused`` / ``gla_fold_fused_q`` in interpret mode, which round the
decayed keys to bf16 (2e-2 of the state's largest magnitude, the tolerance
tests/test_torch_lazy.py holds the plain fold to), and against the f32
plain folds, which the three parts should meet to f32 summation order (1e-5
of the state's largest magnitude; int8 states by integers, at most one step
apart, and by scales to 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops import gla as jgla
from lina_speech_tpu.ops.gla_pallas import gla_fold_fused, gla_fold_fused_q
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.gla import quantize_state_rows

PALLAS_TOL = 2e-2
PARTS_TOL = 1e-5


def _window(seed, L, b=2, h=2, dk=16, dv=32, scale_k=9.0):
    """A full window as a main path leaves it: cumsums of log-gates in cbuf,
    cc the last; k and v of a few units."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    gates = np.log(1.0 / (1.0 + np.exp(-f(L, b, h, dk)))) / 4
    cums = np.cumsum(gates, axis=0).astype(np.float32)
    return f(b, h, dk, dv), [f(L, b, h, dk) * scale_k, f(L, b, h, dv) * 3, cums, cums[-1].copy()]


def _both(a, jd, td):
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1.0, float(np.abs(ref).max())))


def _types(io):
    return (jnp.float32, torch.float32) if io == "float32" else (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("L", [1, 16, 40])
@pytest.mark.parametrize("st", ["float32", "bfloat16"])
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_fold_parts_mirror_matches_pallas_and_f32(io, st, L):
    state, bufs = _window(L, L)
    jdt, tdt = _types(io)
    jst, tst = _types(st)
    js, ts = _both(state, jst, tst)
    jb, tb = map(list, zip(*(_both(a, d, t) for a, d, t in zip(
        bufs, (jdt, jdt, jnp.float32, jnp.float32), (tdt, tdt, torch.float32, torch.float32)))))
    got = gla_cuda.gla_fold_parts_plain(ts, *tb)
    assert got.dtype == tst and got.shape == ts.shape
    ref = gla_fold_fused(js, *jb, interpret=True, donate=False)
    assert _rel_err(got.float().numpy(), ref) <= PALLAS_TOL
    exact = gla_cuda.gla_fold_plain(ts, *tb)
    tol = PARTS_TOL if st == "float32" else 2.0 ** -7  # a bf16 state: one rounding step
    assert _rel_err(got.float().numpy(), exact.float().numpy()) <= tol


@pytest.mark.parametrize("L", [1, 16, 40])
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_fold_q_parts_mirror_matches_pallas_and_f32(io, L):
    state, bufs = _window(100 + L, L, dv=64)
    jdt, tdt = _types(io)
    jq, jsc = jgla.quantize_state_rows(jnp.asarray(state * 0.1))
    tq, tsc = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jsc))
    jb, tb = map(list, zip(*(_both(a, d, t) for a, d, t in zip(
        bufs, (jdt, jdt, jnp.float32, jnp.float32), (tdt, tdt, torch.float32, torch.float32)))))
    q, sc = gla_cuda.gla_fold_q_parts_plain(tq, tsc, *tb)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    eq, esc = gla_cuda.gla_fold_q_plain(tq, tsc, *tb)
    # the Pallas fold rounds the decayed keys to bf16, so its integers sit a
    # step off the f32 fold's in places; the mirror's sit no further off it
    kq, ksc = gla_fold_fused_q(jq, jsc, *jb, interpret=True, donate=False)
    kq = np.asarray(kq, np.int32)
    steps = np.abs(q.numpy().astype(np.int32) - kq)
    pallas_off = float((np.abs(eq.numpy().astype(np.int32) - kq) > 0).mean())
    assert steps.max() <= 1 and (steps > 0).mean() <= pallas_off + 1e-3, (steps.max(), pallas_off)
    np.testing.assert_allclose(sc.numpy(), np.asarray(ksc), rtol=5e-3, atol=1e-7)
    steps = (q.int() - eq.int()).abs()
    assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3
    assert float(((sc - esc).abs() / esc).max()) <= PARTS_TOL


def test_fold_parts_split_is_exact_to_f32():
    """Three bf16 parts hold an f32 value to about 2^-24 of itself, where
    two leave 2^-16 (which moves an int8 row's scale by more than 1e-5)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 7
    three = sum(gla_cuda._bf16_parts(x, 3))
    two = sum(gla_cuda._bf16_parts(x, 2))
    assert float(((three - x).abs() / x.abs()).max()) <= 2.0 ** -23
    assert float(((two - x).abs() / x.abs()).max()) > 2.0 ** -20


# (b, h, dk, dv, state dtype) -> the band each plan picks: the driven paths'
# folds (the flagship's bf16 and int8 states at b8, simple-GLA's f32 state),
# the flagship's head at b1 and b64, Mamba-2's head and the odd widths the
# card tests take
PLANS = [
    ((8, 4, 256, 512, torch.bfloat16), "band64"),
    ((1, 4, 256, 512, torch.bfloat16), "band16"),
    ((64, 4, 256, 512, torch.bfloat16), "band128"),
    ((8, 4, 256, 256, torch.float32), "band16"),
    ((8, 32, 64, 64, torch.float32), "band32"),
    ((8, 4, 256, 512, torch.int8), "band32"),
    ((1, 4, 256, 512, torch.int8), "band16"),
    ((64, 4, 256, 512, torch.int8), "band64"),
    ((1, 5, 128, 32, torch.float32), "band32"),
    ((3, 3, 64, 96, torch.bfloat16), "band16"),
]


@pytest.mark.parametrize("shape,plan", PLANS)
def test_fold_plans_at_driven_shapes(shape, plan):
    b, h, dk, dv, st = shape
    got = (gla_cuda.gla_fold_q_plan(b, h, dk, dv) if st == torch.int8
           else gla_cuda.gla_fold_plan(b, h, dk, dv, st))
    assert got == plan
    assert int(got[4:]) in gla_cuda.fold_band_heights(dk, dv, st)


@pytest.mark.parametrize("dk", [64, 128, 256])
@pytest.mark.parametrize("dv,st", [(32, torch.float32), (96, torch.bfloat16),
                                   (512, torch.bfloat16), (2048, torch.float32),
                                   (128, torch.int8), (256, torch.int8), (512, torch.int8)])
def test_fold_band_heights_cut_the_head(dk, dv, st):
    """Every height is whole 16-row warp tiles dividing dk, in 1, 2 or 4
    sub-bands of at most the block's warps; an int8 row stays in one block;
    the plan always finds one."""
    heights = gla_cuda.fold_band_heights(dk, dv, st)
    assert heights
    cap = gla_cuda._FOLD_MAX_WARPS["gla_fold_q" if st == torch.int8 else "gla_fold"]
    for r in heights:
        assert dk % r == 0 and r % 16 == 0
        across, down, subs, col_blocks = gla_cuda._fold_warps(dk, dv, st, r)
        assert subs in (1, 2, 4) and across * down <= cap and r == 16 * down * subs
        assert st != torch.int8 or col_blocks == 1
    for b in (1, 8, 64):
        plan = (gla_cuda.gla_fold_q_plan(b, 4, dk, dv) if st == torch.int8
                else gla_cuda.gla_fold_plan(b, 4, dk, dv, st))
        assert int(plan[4:]) in heights


def test_fold_route_names_and_cpu_plain():
    """A route off the band heights raises; a CPU tensor takes the plain
    version (which returns a new tensor and leaves its input as it was)."""
    with pytest.raises(ValueError, match="route"):
        gla_cuda._fold_rows("gla_fold", "tile", 256, 512, torch.bfloat16)
    with pytest.raises(ValueError, match="route"):
        gla_cuda._fold_rows("gla_fold_q", "band48", 256, 512, torch.int8)
    assert gla_cuda._fold_rows("gla_fold", "band64", 256, 512, torch.bfloat16) == 64
    state, bufs = _window(5, 16)
    ts, tb = torch.from_numpy(state), [torch.from_numpy(a) for a in bufs]
    kept = ts.clone()
    out = gla_cuda.gla_fold(ts, *tb)
    assert torch.equal(ts, kept) and torch.equal(out, gla_cuda.gla_fold_plain(kept, *tb))
    q, sc = quantize_state_rows(ts * 0.1)
    nq, nsc = gla_cuda.gla_fold_q(q, sc, *tb)
    rq, rsc = gla_cuda.gla_fold_q_plain(q, sc, *tb)
    assert torch.equal(nq, rq) and torch.equal(nsc, rsc)
