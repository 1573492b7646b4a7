"""Context-parallel chunk scans of the port under gloo, against the JAX
package, on the CPU.

``ops/gla_cp.py:gla_chunk_cp`` / ``rwkv6_chunk_cp`` and
``ops/mamba_cp.py:selective_scan_cp`` run at cp 4 in four processes
(tests/torch_dist_cases.py, one world for the module): each rank its time
shard of the same numpy inputs, the loss sum(out do) plus the final state
against a cotangent that differs from rank to rank (under cp it arrives
from every rank). The shards' outputs, put back in order, and the final
state are held against the JAX single-device ``gla_chunk`` /
``rwkv6_chunk`` / ``selective_scan`` within 1e-4 of max|ref|, and the
gradient of every input (s0, u, A and D summed over the ranks) against
``jax.grad`` within rtol 3e-4 / atol 3e-4 (tests/test_mamba_cp.py's
bound); with and without resets, on a length that divides over 4 and one
that does not (zero padding at the end). One case of each op is also held
against JAX's own ``*_cp`` on the conftest's virtual CPU mesh. The
in-process form that runs all shards through the same functions
(``*_cp_shards``, what the card's check runs) is held against the
single-device plain versions of the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lina_speech_tpu.ops.gla import gla_chunk as jax_gla_chunk
from lina_speech_tpu.ops.gla_cp import gla_chunk_cp as jax_gla_chunk_cp
from lina_speech_tpu.ops.gla_cp import rwkv6_chunk_cp as jax_rwkv6_chunk_cp
from lina_speech_tpu.ops.mamba import selective_scan as jax_selective_scan
from lina_speech_tpu.ops.mamba_cp import selective_scan_cp as jax_selective_scan_cp
from lina_speech_tpu.ops.rwkv6 import rwkv6_chunk as jax_rwkv6_chunk
from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda, rwkv6_cuda
from lina_speech_tpu_torch.ops.gla_cp import gla_chunk_cp_shards, rwkv6_chunk_cp_shards
from lina_speech_tpu_torch.ops.mamba_cp import selective_scan_cp_shards
from torch_dist_cases import World

CP = 4
TOL_OUT = 1e-4  # of max|ref|
TOL_GRAD = 3e-4  # rtol and atol


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
B, H, DK, DV, D, N = 2, 2, 16, 24, 24, 8
LEAVES = {"gla": ("q", "k", "v", "gk", "s0"), "rwkv6": ("r", "k", "v", "w", "u", "s0"),
          "mamba": ("x", "dt", "A", "B", "C", "D", "s0")}
TIMED = {"gla": ("q", "k", "v", "gk"), "rwkv6": ("r", "k", "v", "w"),
         "mamba": ("x", "dt", "B", "C")}
# (op, time steps, resets): 32 divides over 4, 37 does not
CASES = {f"{kind}-t{t}{'-resets' if resets else ''}": (kind, t, resets)
         for kind in ("gla", "rwkv6", "mamba") for t, resets in ((32, False), (37, True))}


def _inputs(kind, t, resets, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    reset = np.zeros((B, t), bool)
    if resets:
        reset[:, [5, 21]] = True
        reset[1, 30] = True
    if kind == "mamba":
        x = dict(x=f(B, t, D), dt=np.log1p(np.exp(f(B, t, D) - 1.0)).astype(np.float32),
                 A=-np.exp(f(D, N) * 0.5).astype(np.float32), B=f(B, t, N), C=f(B, t, N),
                 D=f(D) * 0.5, s0=f(B, D, N) * 0.3, do=f(B, t, D))
        if resets:
            x["reset"] = reset
        return x, f(CP, B, D, N)
    gate = (-np.exp(f(B, H, t, DK)) * 0.1).astype(np.float32)
    gate = np.where(reset[:, None, :, None], np.float32(-20.0), gate)  # resets fold into gates
    x = {"gla": "q", "rwkv6": "r"}
    x = {x[kind]: f(B, H, t, DK), "k": f(B, H, t, DK), "v": f(B, H, t, DV),
         ("gk" if kind == "gla" else "w"): gate, "s0": f(B, H, DK, DV) * 0.3,
         "do": f(B, H, t, DV)}
    if kind == "rwkv6":
        x["u"] = f(H, DK) * 0.5
    return x, f(CP, B, H, DK, DV)


@pytest.fixture(scope="module")
def world():
    """Every case's inputs, its JAX single-device reference (computed here
    while the world runs) and the four ranks' results, one world."""
    inputs = {name: _inputs(kind, t, resets, seed=i)
              for i, (name, (kind, t, resets)) in enumerate(CASES.items())}
    running = World(CP, {name: ("cp_op", (CASES[name][0], *inputs[name])) for name in CASES})
    refs = {name: _jax_reference(CASES[name][0], *inputs[name]) for name in CASES}
    return inputs, refs, running.results()


def _jax_reference(kind, x, dsf_all):
    """(out, final state, gradients by leaf) of the single-device JAX op for
    the loss sum(out do) + sum(s_final sum_r dsf_r)."""
    dsf = jnp.asarray(dsf_all.sum(0))
    names = LEAVES[kind]
    if kind == "mamba":
        reset = None if "reset" not in x else jnp.asarray(x["reset"])
        fn = lambda xx, dt, A, Bm, C, Dv, s0: jax_selective_scan(
            xx, dt, A, Bm, C, Dv, initial_state=s0, reset_mask=reset, mode="scan")
    elif kind == "gla":
        fn = lambda q, k, v, gk, s0: jax_gla_chunk(q, k, v, gk, initial_state=s0)
    else:
        fn = lambda r, k, v, w, u, s0: jax_rwkv6_chunk(r, k, v, w, u, initial_state=s0)

    def loss(*args):
        o, s = fn(*args)
        return (o * jnp.asarray(x["do"])).sum() + (s * dsf).sum(), (o, s)

    grads, (o, s) = jax.jit(jax.grad(loss, argnums=tuple(range(len(names))), has_aux=True))(
        *(jnp.asarray(x[n]) for n in names))
    return np.asarray(o), np.asarray(s), dict(zip(names, map(np.asarray, grads)))


def _close(got, ref, tol=TOL_OUT):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert scale > 0 and err <= tol * scale, (err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_cp4_matches_the_jax_single_device_op(world, case):
    kind, t, _ = CASES[case]
    _, refs, results = world
    ranks = [r[case] for r in results]
    t_dim = 1 if kind == "mamba" else 2
    cat = lambda key: np.concatenate([r[key] for r in ranks], t_dim).take(range(t), t_dim)
    o, s, grads = refs[case]
    _close(cat("o"), o)
    for r in ranks:  # the final state of the whole sequence on every rank
        _close(r["s_final"], s)
    for name in LEAVES[kind]:
        got = cat(f"d{name}") if name in TIMED[kind] else sum(r[f"d{name}"] for r in ranks)
        np.testing.assert_allclose(got, grads[name], rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=f"{case}: d{name}")


@pytest.mark.parametrize("kind", ["gla", "rwkv6", "mamba"])
def test_cp4_matches_the_jax_cp_op(world, kind):
    """The reset case on a length that does not divide over 4, against
    JAX's own context-parallel op on a virtual CPU mesh of 4 devices (which
    pads the time axis itself): the gloo ranks' outputs, put back in order,
    and their final state."""
    inputs, _, results = world
    case = f"{kind}-t37-resets"
    x, _ = inputs[case]
    mesh = Mesh(np.array(jax.devices()[:CP]).reshape(1, CP), ("dp", "cp"))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if kind == "mamba":
        y, s = jax.jit(functools.partial(jax_selective_scan_cp, mesh=mesh))(
            j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"], initial_state=j["s0"],
            reset_mask=j["reset"])
    elif kind == "gla":
        y, s = jax.jit(functools.partial(jax_gla_chunk_cp, mesh=mesh))(
            *(j[k] for k in TIMED[kind]), initial_state=j["s0"])
    else:
        y, s = jax.jit(functools.partial(jax_rwkv6_chunk_cp, mesh=mesh))(
            *(j[k] for k in TIMED[kind]), j["u"], initial_state=j["s0"])
    ranks = [r[case] for r in results]
    t_dim = 1 if kind == "mamba" else 2
    assert all(r["o"].shape[t_dim] == 10 for r in ranks)  # 37 padded to 40, over 4
    got = np.concatenate([r["o"] for r in ranks], t_dim).take(range(37), t_dim)
    _close(got, np.asarray(y))
    _close(ranks[-1]["s_final"], np.asarray(s))


@pytest.mark.parametrize("kind", ["gla", "rwkv6", "mamba"])
def test_in_process_shards_match_the_single_device_plain_op(kind):
    """``*_cp_shards`` (all n shards in one process through the per-shard
    body, the combine over the stacked pairs and the correction: the form
    the card's check runs on the kernels) equals the port's single-device
    plain op, forward and every gradient, at n 3 on a length of 37."""
    x, dsf_all = _inputs(kind, 37, True, seed=11)
    names = LEAVES[kind]
    leaves = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in names}
    do, dsf = torch.from_numpy(x["do"]), torch.from_numpy(dsf_all[0])
    if kind == "mamba":
        reset = torch.from_numpy(x["reset"])
        args = [leaves[k] for k in ("x", "dt", "A", "B", "C", "D")]
        single = mamba_cuda.mamba_scan_plain(*args, leaves["s0"], reset)
        shards = selective_scan_cp_shards(*args, leaves["s0"], reset, n=3)
    elif kind == "gla":
        args = [leaves[k] for k in TIMED[kind]]
        single = gla_cuda.gla_chunk_plain(*args, leaves["s0"])
        shards = gla_chunk_cp_shards(*args, leaves["s0"], n=3)
    else:
        args = [leaves[k] for k in TIMED[kind]] + [leaves["u"]]
        single = rwkv6_cuda.rwkv6_chunk_plain(*args, leaves["s0"])
        shards = rwkv6_chunk_cp_shards(*args, leaves["s0"], n=3)
    loss = lambda o, s: (o * do).sum() + (s * dsf).sum()
    ref = torch.autograd.grad(loss(*single), list(leaves.values()))
    got = torch.autograd.grad(loss(*shards), list(leaves.values()))
    _close(shards[0].detach().numpy(), single[0].detach().numpy())
    _close(shards[1].detach().numpy(), single[1].detach().numpy())
    for name, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=f"d{name}")
