"""The lazy-window step as the CUDA kernel's cluster route splits it, and
the plan that picks the route, on the CPU.

``gla_decode_lazy_conv_split_plain`` (ops/gla_cuda.py) is that route's
decomposition in plain PyTorch: a cluster of blocks a head, each owning 32
key rows and forming its part of every window score and of the readout at
every column over them; the owner of a column slice adds the parts in rank
order and the slice's window terms. It is held against the Pallas kernel
``gla_decode_lazy_conv_fused`` in interpret mode over a whole window (p = 0
to L - 1) whose every slot starts as stale garbage (cbuf 200 would overflow
an unclamped exp), at every key width the kernel takes and value widths of
one, three, eight and sixteen 32-column tiles (and 640 f32 columns: two
slabs), with f32 and bf16 states: the cluster route takes no int8 state
(the tile route is its only body). Tolerances: against the Pallas kernel 2e-2 (it rounds its matmul
operands to bf16; the tolerance of tests/test_gla_pallas.py), against the
port's plain version 1e-5 in f32 IO and 1e-2 in bf16 (summation order,
then one bf16 rounding of o), the rings, live window slots and cc equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.gla_pallas import gla_decode_lazy_conv_fused
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.ops.gla import quantize_state_rows

PALLAS_TOL = 2e-2
OPS_TOL = 1e-5
L = 4

# (dk, dv, state): every key width of the kernel; value widths of one, three,
# eight and sixteen 32-column tiles, and 640 f32 columns (two slabs of 512)
CASES = [(64, 96, "float32"), (128, 32, "bfloat16"), (256, 512, "bfloat16"),
         (256, 32, "float32"), (64, 640, "float32"), (128, 256, "bfloat16")]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk,dv,state_kind", CASES)
def test_split_step_matches_pallas_over_a_window(dk, dv, state_kind, io):
    b, h = 1, 2
    rng = np.random.default_rng(dk + dv)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if io == "float32" else (jnp.bfloat16, torch.bfloat16)

    def both(a, jd, td):
        j = jnp.asarray(a).astype(jd)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)

    jt, tt = zip(*(both(f(4, h, d) * 0.5, jdt, tdt) for d in (dk, dk, dv)))
    jr, tr = map(list, zip(*(both(f(4, b, h, d), jdt, tdt) for d in (dk, dk, dv))))
    js, ts = both(f(b, h, dk, dv), getattr(jnp, state_kind), getattr(torch, state_kind))
    garbage = [f(L, b, h, dk) * 9, f(L, b, h, dv) * 9, np.full((L, b, h, dk), 200.0, np.float32),
               np.zeros((b, h, dk), np.float32)]
    jb, tb = map(list, zip(*(both(a, d, t) for a, d, t in zip(
        garbage, (jdt, jdt, jnp.float32, jnp.float32),
        (tdt, tdt, torch.float32, torch.float32)))))
    pb = [t.clone() for t in tb]
    for p in range(L):
        x = [f(b, h, dk), f(b, h, dk), f(b, h, dv)]
        g = (-np.abs(f(b, h, dk)) * 0.3).astype(np.float32)
        jx, tx = zip(*(both(a, jdt, tdt) for a in x))
        jo, *jrest = gla_decode_lazy_conv_fused(
            *jx, jnp.asarray(g), *jt, *jr, js, *jb, jnp.int32(p), interpret=True,
            donate=False)
        so, *srest = gla_cuda.gla_decode_lazy_conv_split_plain(
            *tx, torch.from_numpy(g), *tt, *tr, ts, *tb, p)
        po, *prest = gla_cuda.gla_decode_lazy_conv_plain(
            *tx, torch.from_numpy(g), *tt, *tr, ts, *pb, p)
        assert so.dtype == tdt and torch.isfinite(so.float()).all()
        _close(so, jo, PALLAS_TOL)
        _close(so, po.float().numpy(), OPS_TOL if io == "float32" else 1e-2)
        for a, j, r in zip(srest[:3], jrest[:3], prest[:3]):  # rings
            _close(a, j, 0.0)
            assert torch.equal(a, r)
        for a, r in zip(srest[3:6], prest[3:6]):  # live slots of the window
            assert torch.equal(a[:p + 1], r[:p + 1])
        assert torch.equal(srest[6], prest[6])  # cc
        _close(srest[6], jrest[6], OPS_TOL)
        jr, jb, tr, tb, pb = jrest[:3], jrest[3:], srest[:3], srest[3:], prest[3:]


@pytest.mark.parametrize("b,h,state,route", [
    (8, 4, torch.bfloat16, "cluster"),   # generate_batch(lazy_window=16), the lazy server
    (64, 4, torch.bfloat16, "cluster"),  # 64 slots
    (8, 4, torch.float32, "cluster"),
    (8, 4, torch.int8, "tile"),          # the int8-state generate and server
    (64, 4, torch.int8, "tile"),
    (1, 4, torch.bfloat16, "tile"),      # one request
    (2, 2, torch.float32, "tile"),       # the tiny configs of the CPU tests
    (4, 4, torch.bfloat16, "tile"),      # 16 heads: the tile route won in the sweep
    (6, 4, torch.bfloat16, "cluster"),   # 24 heads: the cluster route won
    (6, 4, torch.int8, "tile"),
])
def test_lazy_plan_routes(b, h, state, route):
    """gla_decode_lazy_plan, from shapes and dtypes alone: the cluster route
    for a float state from 24 heads in flight, the tile route otherwise."""
    assert gla_cuda.gla_decode_lazy_plan(b, h, state) == route


def test_lazy_wrapper_on_cpu_counts_no_route():
    """On CPU tensors the wrapper runs the plain version: no launch, no
    route, no shape counted (the counters reset with the launch counts)."""
    gla_cuda.reset_launch_counts()
    args = _cpu_step_args(1, 2, 64, 32, 3)
    out = gla_cuda.gla_decode_lazy_conv(*args, 0)
    ref = gla_cuda.gla_decode_lazy_conv_plain(*args, 0)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert gla_cuda.gla_decode_lazy_conv.launches == 0
    assert gla_cuda.gla_decode_lazy_conv.routes == {"tile": 0, "cluster": 0}
    assert not gla_cuda.launch_shapes()["gla_decode_lazy_conv"]


def _cpu_step_args(b, h, dk, dv, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (t(b, h, dk), t(b, h, dk), t(b, h, dv), -t(b, h, dk).abs(), t(4, h, dk), t(4, h, dk),
            t(4, h, dv), t(4, b, h, dk), t(4, b, h, dk), t(4, b, h, dv), t(b, h, dk, dv),
            t(L, b, h, dk), t(L, b, h, dv), torch.zeros(L, b, h, dk), torch.zeros(b, h, dk))


def test_cluster_route_refuses_an_int8_state():
    """The cluster route has no int8 body: the launcher raises on an int8
    state forced onto it (before any library is loaded), and the split
    plain version, that route's decomposition, takes none either."""
    args = list(_cpu_step_args(1, 2, 64, 128, 4))
    state, s_scale = quantize_state_rows(args[10])
    args[10] = state
    with pytest.raises(ValueError, match="no int8 state"):
        gla_cuda._lazy_launch(*args, 0, s_scale=s_scale, route="cluster")
    with pytest.raises(ValueError, match="f32 or bf16"):
        gla_cuda.gla_decode_lazy_conv_split_plain(*args, 0)
