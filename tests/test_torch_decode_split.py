"""The classic decode step as the CUDA kernels' wide routes split it, and
the plan that picks the route, on the CPU.

``gla_decode_conv_split_plain`` and ``gla_decode_split_plain``
(ops/gla_cuda.py) are those routes' decomposition in plain PyTorch: a block
of 256 threads per column tile, T of them across a row (T = 4, 8, 16, the
routes wide4, wide8, wide16); a thread updates the key rows of its row
phase and sums their part of the readout; the block adds the 256 / T
phases' parts in order. They are held, on every wide route, against the
Pallas kernels ``gla_decode_conv_fused`` and ``gla_decode_fused`` in
interpret mode over two chained steps (scale None, then 1.0; gates down to
-8 a step), at every key width the kernels take and value widths of one,
three and sixteen 32-column tiles, with f32 and bf16 IO and states.
Tolerances: against the Pallas kernels 2e-2 (the tolerance of
tests/test_gla_pallas.py), against the port's plain versions 1e-5 in f32
IO and 1e-2 in bf16 (summation order, then one bf16 rounding of o); the
rings equal, and the state equal to the plain version's bit for bit (the
same f32 expression).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.gla_pallas import gla_decode_conv_fused, gla_decode_fused
from lina_speech_tpu_torch.ops import gla_cuda

PALLAS_TOL = 2e-2
OPS_TOL = 1e-5
SCALES = (None, 1.0)  # the two chained steps
WIDE = ("wide4", "wide8", "wide16")

# (dk, dv): every key width of the kernels at value widths of one, three and
# sixteen 32-column tiles
SHAPES = [(64, 96), (128, 32), (256, 512)]
# (IO dtype, state dtype)
DTYPES = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
          ("bfloat16", "bfloat16")]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _both(a, kind):
    """One array for JAX and its torch twin, equal values in dtype ``kind``."""
    j = jnp.asarray(a).astype(getattr(jnp, kind))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, kind))


@pytest.mark.parametrize("io,st", DTYPES)
@pytest.mark.parametrize("dk,dv", SHAPES)
@pytest.mark.parametrize("conv", [True, False], ids=["conv", "noconv"])
def test_split_step_matches_pallas(conv, dk, dv, io, st):
    b, h = 1, 2
    rng = np.random.default_rng(dk + dv + 7 * conv)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    js, ts = _both(f(b, h, dk, dv), st)
    if conv:
        jt, tt = zip(*(_both(f(4, h, d) * 0.5, io) for d in (dk, dk, dv)))
        jr, tr = map(list, zip(*(_both(f(4, b, h, d), io) for d in (dk, dk, dv))))
    for scale in SCALES:
        jx, tx = zip(*(_both(f(b, h, d), io) for d in (dk, dk, dv)))
        g = (-rng.uniform(0.0, 8.0, size=(b, h, dk))).astype(np.float32)
        jg, tg = jnp.asarray(g), torch.from_numpy(g)
        if conv:
            jo, js, *jr = gla_decode_conv_fused(*jx, jg, *jt, *jr, js, scale=scale,
                                                interpret=True, donate=False)
            po, ps, *pr = gla_cuda.gla_decode_conv_plain(*tx, tg, *tt, *tr, ts, scale)
            split = {r: gla_cuda.gla_decode_conv_split_plain(*tx, tg, *tt, *tr, ts, scale, r)
                     for r in WIDE}
            for a, j in zip(pr, jr):  # rings
                _close(a, j, 0.0)
            for out in split.values():
                assert all(torch.equal(a, r) for a, r in zip(out[2:], pr))
            tr = pr
        else:
            jo, js = gla_decode_fused(*jx, jg, js, scale=scale, interpret=True, donate=False)
            po, ps = gla_cuda.gla_decode_plain(*tx, tg, ts, scale)
            split = {r: gla_cuda.gla_decode_split_plain(*tx, tg, ts, scale, r) for r in WIDE}
        tol = OPS_TOL if io == "float32" else 1e-2
        for so, s_new, *_ in split.values():
            assert so.dtype == getattr(torch, io) and s_new.dtype == getattr(torch, st)
            assert torch.isfinite(so.float()).all() and torch.isfinite(s_new.float()).all()
            _close(so, jo, PALLAS_TOL)
            _close(s_new, js, PALLAS_TOL)
            _close(so, po.float().numpy(), tol)
            assert torch.equal(s_new, ps)  # the same f32 expression
        ts = ps


@pytest.mark.parametrize("b,h,dk,dv,state,route", [
    (8, 4, 256, 512, torch.bfloat16, "wide8"),    # the flagship's generate and server
    (1, 4, 256, 512, torch.bfloat16, "wide4"),    # one request (the int8-weight generate)
    (2, 4, 256, 512, torch.float32, "wide4"),     # the interleaved and PP backbones
    (64, 4, 256, 512, torch.bfloat16, "wide16"),  # 64 slots
    (8, 4, 256, 256, torch.float32, "wide8"),     # simple-GLA
    (8, 32, 64, 64, torch.float32, "wide16"),     # Mamba-2
    (1, 32, 64, 64, torch.float32, "tile"),       # Mamba-2, one request: 512 KiB
    (1, 4, 256, 256, torch.bfloat16, "tile"),     # 512 KiB
    (2, 2, 64, 64, torch.float32, "tile"),        # the tiny configs of the CPU tests
    (4, 4, 256, 512, torch.float32, "wide8"),
    (64, 32, 64, 64, torch.bfloat16, "wide8"),    # no grid within 400: the widest tile in dv
])
def test_decode_plan_routes(b, h, dk, dv, state, route):
    """gla_decode_plan, from shapes and dtypes alone, at the shapes the
    driven paths give it: the tile body for a state of at most 512 KiB,
    else the wide route of the fewest threads across a row whose grid is at
    most 400 blocks."""
    assert gla_cuda.gla_decode_plan(b, h, dk, dv, state) == route


@pytest.mark.parametrize("b,h,dv,state,route", [
    (6, 4, 512, torch.bfloat16, "wide4"),   # 384 blocks of 32 columns
    (8, 4, 512, torch.bfloat16, "wide8"),   # 512 of 32 would be too many: 256 of 64
    (16, 4, 512, torch.bfloat16, "wide16"),
    (1, 4, 512, torch.float32, "wide4"),    # 128 blocks of 16 f32 columns
    (8, 4, 512, torch.float32, "wide16"),   # 256 blocks of 64
    (3, 3, 96, torch.bfloat16, "wide4"),    # 128 bf16 columns would not fit in 96
    (64, 32, 64, torch.float32, "wide16"),  # 2048 blocks at best: the widest
])
def test_decode_wide_route(b, h, dv, state, route):
    """The wide route's threads across a row, from the grid's size."""
    assert gla_cuda.decode_wide_route(b, h, dv, state) == route


def test_decode_wrappers_on_cpu_count_no_route():
    """On CPU tensors both wrappers run their plain versions: no launch,
    no route, no shape counted (the counters reset with the launch
    counts)."""
    gla_cuda.reset_launch_counts()
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    b, h, dk, dv = 1, 2, 64, 32
    tok = (t(b, h, dk), t(b, h, dk), t(b, h, dv), -t(b, h, dk).abs())
    conv = (*tok, t(4, h, dk), t(4, h, dk), t(4, h, dv), t(4, b, h, dk), t(4, b, h, dk),
            t(4, b, h, dv), t(b, h, dk, dv))
    out = gla_cuda.gla_decode_conv(*conv)
    ref = gla_cuda.gla_decode_conv_plain(*conv)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    out = gla_cuda.gla_decode(*tok, conv[-1])
    ref = gla_cuda.gla_decode_plain(*tok, conv[-1])
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    for fn in (gla_cuda.gla_decode_conv, gla_cuda.gla_decode):
        assert fn.launches == 0 and fn.routes == dict.fromkeys(gla_cuda._DECODE_ROUTE_CODE, 0)
        assert not gla_cuda.launch_shapes()[fn.__name__]


def test_split_plain_refuses_an_int8_state():
    """The wide routes take an f32 or bf16 state only, and so does their
    decomposition."""
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    state = torch.zeros(1, 2, 64, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gla_cuda.gla_decode_split_plain(t(1, 2, 64), t(1, 2, 64), t(1, 2, 32), t(1, 2, 64), state)
