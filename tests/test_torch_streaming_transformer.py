"""The port's streaming transformer (``codec/streaming_transformer.py``)
against the JAX package's, on the CPU.

The port's encoder is drawn from a seed, every LayerNorm moved off its ones
and zeros, and carried to the JAX module by ``utils/convert.py``'s LM key
map. The same seeded inputs go through both: the whole sequence, the same
sequence in chunks through the KV rings (in both packages), a first call at
an offset above 0, and sequences longer than ``past_context``. Outputs and
rings are held to ``TOL`` of their own max|ref| (f32 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.codec import streaming_transformer as jst
from lina_speech_tpu_torch.codec import streaming_transformer as st
from lina_speech_tpu_torch.codec.lm import init_encodec_lm_params
from lina_speech_tpu_torch.utils import convert

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def held(out, ref, tol=TOL):
    """max|out - ref| within ``tol`` of max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def perturb_vectors(module, seed):
    """Move every 1-D parameter (norm weights, biases) off its init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))


def pair(dim, heads, n_layers, past_context, seed=0):
    """(port encoder, JAX encoder, JAX params) with the same weights."""
    port = st.StreamingTransformerEncoder(dim, heads, n_layers, past_context)
    init_encodec_lm_params(port, torch.Generator().manual_seed(seed))
    perturb_vectors(port, seed + 1)
    sd = {f"transformer.{k}": v for k, v in port.state_dict().items()}
    params = {"params": convert.encodec_lm_state_dict_to_jax(sd)["params"]["transformer"]}
    enc = jst.StreamingTransformerEncoder(dim=dim, heads=heads, n_layers=n_layers,
                                          past_context=past_context)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, dim)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    return port.eval(), enc, params


def inputs(b, t, dim, seed):
    return np.random.default_rng(seed).normal(size=(b, t, dim)).astype(np.float32)


def run_port(port, x, chunks, offset=0):
    states, outs = None, []
    with torch.no_grad():
        for c in np.split(x, np.cumsum(chunks)[:-1], axis=1):
            y, states, offset = port(torch.from_numpy(c), states, offset)
            outs.append(y.numpy())
    return np.concatenate(outs, 1), states, offset


def run_jax(enc, params, x, chunks, offset=0):
    apply = jax.jit(enc.apply)
    states, outs = None, []
    for c in np.split(x, np.cumsum(chunks)[:-1], axis=1):
        y, states, offset = apply(params, jnp.asarray(c), states, offset)
        outs.append(np.asarray(y))
    return np.concatenate(outs, 1), states, int(offset)


@pytest.mark.parametrize("dim", [8, 16, 32, 200])
def test_sin_embedding_equals_jax(dim):
    pos = np.arange(0, 700, 7)
    got = st.create_sin_embedding(torch.from_numpy(pos), dim).numpy()
    held(got, np.asarray(jst.create_sin_embedding(jnp.asarray(pos), dim)), 1e-5)


def test_full_sequence_equals_jax():
    port, enc, params = pair(32, 2, 2, 64)
    x = inputs(2, 24, 32, 0)
    got, _, off = run_port(port, x, [24])
    ref, _, ref_off = run_jax(enc, params, x, [24])
    held(got, ref)
    assert off == ref_off == 24


@pytest.mark.parametrize("chunks", [[8, 8, 8], [1] * 12, [5, 1, 3, 3]])
def test_chunks_through_the_ring_equal_jax(chunks):
    """The same sequence fed in chunks through the rings, in both packages;
    the port's chunked output also equals its whole-sequence output."""
    port, enc, params = pair(32, 4, 2, 32, seed=1)
    x = inputs(1, sum(chunks), 32, 1)
    got, states, off = run_port(port, x, chunks)
    ref, ref_states, _ = run_jax(enc, params, x, chunks)
    held(got, ref)
    held(got, run_port(port, x, [sum(chunks)])[0])
    for (k, v), (rk, rv) in zip(states, ref_states):
        held(k.numpy(), rk)
        held(v.numpy(), rv)
    assert off == sum(chunks)


@pytest.mark.parametrize("offset", [5, 300])
def test_offset_above_zero_equals_jax(offset):
    """A fresh stream's first call at an offset: the positions move and the
    unwritten ring slots stay masked out."""
    port, enc, params = pair(32, 2, 1, 16, seed=2)
    x = inputs(1, 4, 32, 2)
    got, _, off = run_port(port, x, [4], offset)
    ref, _, _ = run_jax(enc, params, x, [4], offset)
    held(got, ref)
    assert off == offset + 4
    assert np.abs(got - run_port(port, x, [4], 0)[0]).max() > 1e-3


@pytest.mark.parametrize("chunks", [[4] * 6, [1] * 20, [7, 9, 8]])
def test_longer_than_past_context_equals_jax(chunks):
    """A sequence several windows long: the rings keep the newest
    past_context keys, and queries see at most past_context back."""
    port, enc, params = pair(32, 4, 2, 6, seed=3)
    x = inputs(2, sum(chunks), 32, 3)
    got, states, _ = run_port(port, x, chunks)
    ref, ref_states, _ = run_jax(enc, params, x, chunks)
    held(got, ref)
    for (k, v), (rk, rv) in zip(states, ref_states):
        assert k.shape == (2, 4, 6, 8)
        held(k.numpy(), rk)
        held(v.numpy(), rv)


def test_init_state_shapes():
    states = st.init_streaming_state(3, 32, 4, 2, 10)
    assert len(states) == 2 and all(k.shape == v.shape == (3, 4, 10, 8) for k, v in states)
    ref = jst.init_streaming_state(3, 32, 4, 2, 10)
    assert [tuple(k.shape) for k, _ in states] == [k.shape for k, _ in ref]
