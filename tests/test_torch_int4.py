"""int4 lazy-window states of the PyTorch port vs the JAX package, on the CPU.

``ops/gla.py`` ``*_int4`` / ``*_q4`` (nibble-packed base states, one f32
scale per row), the int4 dispatch of the GLA layer, ``ops/gla_cuda.py``'s
plain versions and plans for an int4 state, and the whole slice through
``generate_batch`` and ``DecodeServer``. Inputs are numpy arrays from a seed;
weights and states cross through ``utils/convert.py``. On the CPU the port
runs its plain versions; the JAX side computes int4 in XLA (it has no Pallas
kernel for it).

Tolerances. The packed bytes and scales are bit for bit: the same f32
division and round-half-to-even. f32 sums taken in another order: 1e-5 of
the output's max. A fold requantizes: a value on a rounding boundary may
land one step apart, so nibbles agree within one step and at most 1e-2 of
them may differ; scales to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.generate import generate_batch as jax_generate
from lina_speech_tpu.models.attentive_rnn import add_lazy_buffers as jax_add_buffers
from lina_speech_tpu.models.attentive_rnn import fold_lazy_state as jax_fold
from lina_speech_tpu.models.lina import LinaModel as JaxLina
from lina_speech_tpu.ops import gla as jgla
from lina_speech_tpu.serving import DecodeServer as JaxServer
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.ops import gla as tgla
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, load_jax_params,
)

SUM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _with_convs(cfg, convs: bool):
    """The tiny config with the flagship's per-projection short convs, or
    without any (the layer's plain lazy step on every device)."""
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, pos_type="convolutional", use_short_conv=convs))


def _pair(convs: bool):
    cfg = _with_convs(lina_gla_tiny(), convs)
    jm = jax_build(cfg)
    b, m, n = 2, 7, 9
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32),
        jnp.ones((b, n, cfg.n_quant), jnp.int32), jnp.ones((b, m, m), bool),
        jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    tm = load_jax_params(torch_build(_with_convs(torch_tiny(), convs), device="cpu"), params)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model with the same weights): the tiny
    config in the flagship's architecture, f32."""
    return _pair(True)


@pytest.fixture(scope="module")
def pair_no_conv():
    """The same without the short convs."""
    return _pair(False)


def _int_steps(a, b):
    """(largest difference, share of elements that differ) of two integer arrays."""
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return int(d.max()), float((d > 0).mean())


def _nibbles(packed):
    """The (lo, hi) values of a packed int4 state as int arrays, the JAX
    package's unpacking."""
    lo, hi = jgla.unpack_state_int4(jnp.asarray(np.asarray(packed)))
    return np.concatenate([np.asarray(lo), np.asarray(hi)], axis=-1)


# ---------------------------------------------------------------- ops/gla.py
def test_unpack_state_int4_every_byte_matches_jax():
    """All 256 byte values: the sign-extended low and high nibbles equal
    JAX's ``(x << 4) >> 4`` and ``x >> 4`` on int8."""
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 1, 16, 16)
    jlo, jhi = jgla.unpack_state_int4(jnp.asarray(every))
    tlo, thi = tgla.unpack_state_int4(torch.from_numpy(every))
    assert tlo.dtype == thi.dtype == torch.int8
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert int(tlo.min()) == int(thi.min()) == -8 and int(tlo.max()) == int(thi.max()) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_state_rows_int4_matches_jax(dtype):
    s = np.random.default_rng(0).normal(size=(2, 3, 16, 32)).astype(np.float32)
    s[0, 0, 3] = 0.0  # an all-zero row takes the 1e-30 floor
    s[1, 2, 5, :4] = [0.5, -0.5, 1.5, 7.0]  # halves on a row whose scale is 1: round to even
    s[1, 2, 5, 4:] = 0.0
    jq, jsc = jgla.quantize_state_rows_int4(jnp.asarray(s).astype(getattr(jnp, dtype)))
    tq, tsc = tgla.quantize_state_rows_int4(torch.from_numpy(s).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and tq.shape == (2, 3, 16, 16)
    assert tsc.dtype == torch.float32 and tsc.shape == (2, 3, 16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))  # packed bytes, bit for bit
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tgla.dequantize_state_int4(tq, tsc).numpy(),
                                  np.asarray(jgla.dequantize_state_int4(jq, jsc)))
    if dtype == "float32":
        np.testing.assert_array_equal(_nibbles(tq.numpy())[1, 2, 5, :4], [0, 0, 2, 7])


def _window(seed, L, b=2, h=2, dk=16, dv=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    toks = [(f(b, h, dk), f(b, h, dk), f(b, h, dv),
             (-np.abs(f(b, h, dk)) * 0.3).astype(np.float32)) for _ in range(L)]
    bufs = [f(L, b, h, dk) * 5, f(L, b, h, dv) * 5,
            np.full((L, b, h, dk), 150.0, np.float32), np.zeros((b, h, dk), np.float32)]
    return toks, f(b, h, dk, dv) * 0.1, bufs


@pytest.mark.parametrize("L", [4, 7])
def test_lazy_step_q4_and_fold_q4_match_jax(L):
    """A whole window of int4 lazy steps over stale buffers, then the fold:
    outputs and cc within 1e-5, the new nibbles within one step (at most
    1e-2 of them apart), the new scales to 1e-6."""
    toks, state, bufs = _window(1, L)
    jq, jsc = jgla.quantize_state_rows_int4(jnp.asarray(state))
    tq, tsc = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jsc))
    jb, tb = [jnp.asarray(a) for a in bufs], [torch.from_numpy(a) for a in bufs]
    for p, tok in enumerate(toks):
        jo, *jb = jgla.gla_decode_lazy_step_q4(*map(jnp.asarray, tok), jq, jsc, *jb,
                                               jnp.int32(p))
        to, *tb = tgla.gla_decode_lazy_step_q4(*map(torch.from_numpy, tok), tq, tsc, *tb, p)
        jo = np.asarray(jo)
        np.testing.assert_allclose(to.numpy(), jo, rtol=SUM_TOL, atol=SUM_TOL * np.abs(jo).max())
        np.testing.assert_allclose(tb[3].numpy(), np.asarray(jb[3]), rtol=SUM_TOL, atol=SUM_TOL)
        for a, r in zip(tb[:3], jb[:3]):
            np.testing.assert_array_equal(a[:p + 1].numpy(), np.asarray(r)[:p + 1])
    rq, rsc = jgla.gla_decode_lazy_fold_q4(jq, jsc, *jb)
    fq, fsc = tgla.gla_decode_lazy_fold_q4(tq, tsc, *tb)
    assert fq.dtype == torch.int8 and fq.shape == tq.shape and fsc.dtype == torch.float32
    worst, share = _int_steps(_nibbles(fq.numpy()), _nibbles(rq))
    assert worst <= 1 and share <= 1e-2, (worst, share)
    np.testing.assert_allclose(fsc.numpy(), np.asarray(rsc), rtol=1e-6)
    assert not np.array_equal(fq.numpy(), np.asarray(jq))  # the fold moved the state


def test_fold_q_parts_plain_int4_matches_plain():
    """The mirror of the int4 fold kernel's update (three-part bf16 operands
    on the tensor cores) against the plain int4 fold: nibbles within one
    step, scales to 1e-6 of themselves."""
    toks, state, bufs = _window(2, 16, b=2, h=2, dk=64, dv=128)
    q, sc = tgla.quantize_state_rows_int4(torch.from_numpy(state))
    tb = [torch.from_numpy(a) for a in bufs]
    tb[2] = -torch.rand(tb[2].shape, generator=torch.Generator().manual_seed(3)) * 2
    tb[3] = tb[2][-1] - 0.1
    for buf_dtype in (torch.float32, torch.bfloat16):
        kv = [tb[0].to(buf_dtype), tb[1].to(buf_dtype), tb[2], tb[3]]
        pq, psc = gla_cuda.gla_fold_q_parts_plain(q, sc, *kv)
        rq, rsc = gla_cuda.gla_fold_q_plain(q, sc, *kv)
        worst, share = _int_steps(_nibbles(pq.numpy()), _nibbles(rq.numpy()))
        assert worst <= 1 and share <= 1e-2, (buf_dtype, worst, share)
        np.testing.assert_allclose(psc.numpy(), rsc.numpy(), rtol=1e-6)


def test_lazy_conv_plain_takes_the_int4_step():
    """``gla_decode_lazy_conv_plain`` on an int4 state equals the same step on
    the float state it dequantizes to (the scale riding the query instead),
    and the wrappers' CPU route is the plain version."""
    rng = np.random.default_rng(4)
    b, h, dk, dv, L, p = 2, 2, 64, 128, 4, 2
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    tok = (f(b, h, dk), f(b, h, dk), f(b, h, dv), -f(b, h, dk).abs() * 0.1)
    taps = [f(4, h, d) * 0.5 for d in (dk, dk, dv)]
    rings = [f(4, b, h, d) for d in (dk, dk, dv)]
    cums = -torch.rand(L, b, h, dk, generator=torch.Generator().manual_seed(1)).cumsum(0)
    bufs = [f(L, b, h, dk), f(L, b, h, dv), cums, cums[p - 1].clone()]
    q, sc = tgla.quantize_state_rows_int4(f(b, h, dk, dv) * 0.1)
    out = gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, q, *bufs, p, s_scale=sc)
    ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *rings,
                                              tgla.dequantize_state_int4(q, sc), *bufs, p)
    o = ref[0].numpy()
    np.testing.assert_allclose(out[0].numpy(), o, rtol=SUM_TOL, atol=SUM_TOL * np.abs(o).max())
    for a, r in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
    s, s_sc = gla_cuda.gla_fold_q(q, sc, *out[4:])
    assert s.shape == q.shape and s_sc.shape == sc.shape
    with pytest.raises(ValueError, match="s_scale"):
        gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *rings, q, *bufs, p)


def test_int4_plans_and_kernel_takes():
    """An int4 state takes the lazy step's tile route (its only body) and is
    told from an int8 one by its width; the kernels take its heads where
    they take an int8 one (the fold's bands are the int8 body's,
    ``gla_fold_q_plan``)."""
    for b in (1, 8, 64):
        assert gla_cuda.gla_decode_lazy_plan(b, 4, gla_cuda.INT4) == "tile"
    packed, sc = tgla.quantize_state_rows_int4(torch.zeros(2, 4, 16, 64))
    assert gla_cuda.is_int4(packed, torch.zeros(3, 2, 4, 64))
    assert not gla_cuda.is_int4(tgla.quantize_state_rows(torch.zeros(2, 4, 16, 64))[0],
                                torch.zeros(3, 2, 4, 64))
    assert gla_cuda.kernel_takes(256, 512, torch.bfloat16, torch.int8)
    assert not gla_cuda.kernel_takes(256, 96, torch.bfloat16, torch.int8)


# ------------------------------------------------------------------- layers
def test_model_int4_state_lazy_steps_match_jax(pair):
    """The JAX model prefills, quantizes its states to int4 and takes one
    lazy step; the state crosses into the port; both finish the window and
    fold. Logits, scales and nibbles agree; the pos_net's state stays float."""
    jm, params, tm = pair
    L = 4
    rng = np.random.default_rng(3)
    text, codes = rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, 6 + L))

    def jprefill(m, text, codes):
        x_enc, y = m.encode_text(text), m.embed_tokens(codes)
        return x_enc, y, m.prefill(y[:, :6], x_enc, m.empty_state(2))[2]

    x_enc, y, jst = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jprefill)
    jst = jax_add_buffers(jst, L, dtype=jnp.float32, state_quant="int4")
    jstep = lambda st, p: jm.apply(params, y[:, 6 + p], x_enc, st, lazy_p=p,
                                   method=JaxLina.decode_step)
    _, _, jst = jstep(jst, 0)
    tst = backbone_state_from_arrays(jst)
    layer = tst.layers[0]
    assert layer.s.dtype == torch.int8 and gla_cuda.is_int4(layer.s, layer.vbuf)
    assert 2 * layer.s.shape[-1] == layer.vbuf.shape[-1]
    assert layer.s_scale.shape == layer.s.shape[:-1]
    assert tst.pos_net.s_scale is None and tst.pos_net.s.dtype == torch.float32
    tx, ty = torch.from_numpy(np.asarray(x_enc)), torch.from_numpy(np.asarray(y))
    with torch.no_grad():
        for p in range(1, L):
            jl, _, jst = jstep(jst, p)
            tl, _, tst = tm.decode_step(ty[:, 6 + p], tx, tst, lazy_p=p)
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
        jst, tst = jax_fold(jst), tm.fold_lazy_state(tst)
    ours = backbone_state_to_arrays(tst)
    theirs = backbone_state_to_arrays(backbone_state_from_arrays(jst))
    assert set(ours) == set(theirs) and "layers/0/s_scale" in ours
    for name in ours:
        field = name.rsplit("/", 1)[-1]
        if field == "s" and ours[name].dtype == np.int8:
            worst, share = _int_steps(_nibbles(ours[name]), _nibbles(theirs[name]))
            assert worst <= 1 and share < 0.02, (name, worst, share)
        elif field in ("s", "s_scale", "conv_q", "conv_k", "conv_v", "cc"):
            np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-4,
                                       atol=1e-4 * np.abs(theirs[name]).max(), err_msg=name)


# ---------------------------------------------------------- the whole slice
@pytest.mark.parametrize("convs", [True, False], ids=["convs", "no-convs"])
def test_generate_int4_matches_jax(pair, pair_no_conv, convs):
    """Greedy tokens of generate_batch(lazy_window=4, state_quant="int4"),
    token for token, with per-projection convs (the lazy conv step) and
    without (the layer's plain step)."""
    jm, params, tm = pair if convs else pair_no_conv
    rng = np.random.default_rng(5)
    x = rng.integers(3, 256, size=(2, 9))
    prompt = rng.integers(0, 50, size=(1, 2, 6))
    kw = dict(max_seqlen=19, first_greedy_quant=0, force_max_seqlen=True, lazy_window=4,
              state_quant="int4")
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert tres.n_steps == int(jres.n_steps) == 19


SERVE_TEXTS = [[5, 9, 3, 17, 8], [12, 4, 33, 7, 19, 21, 6], [40, 41], [3, 18, 27, 9],
               [25, 26, 27, 28, 29, 30]]


def _serve(server, max_len, prompts):
    rids = [server.submit(np.asarray(t), prompt=p, max_len=max_len)
            for t, p in zip(SERVE_TEXTS, prompts)]
    done = {c.rid: c for c in server.run()}
    assert set(done) == set(rids)
    return [done[r] for r in rids]


def test_server_int4_matches_jax_server_and_generate(pair):
    """Five requests through two recycled slots of a lazy int4 server: the
    JAX server's tokens, and each request's own generate_batch tokens; the
    slot container's ``s`` is the packed state (dv / 2 bytes a row)."""
    jm, params, tm = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 50, size=(1, p)) if p else None for p in (0, 5, 0, 2, 0)]
    max_len, kw = 14, dict(lazy=True, state_quant="int4")
    jdone = _serve(JaxServer(jm, params, n_slots=2, max_text_len=12, chunk=4, **kw), max_len,
                   prompts)
    srv = DecodeServer(tm, n_slots=2, max_text_len=12, chunk=4, **kw)
    done = _serve(srv, max_len, prompts)
    for c, j, text, prm in zip(done, jdone, SERVE_TEXTS, prompts):
        np.testing.assert_array_equal(c.tokens, j.tokens)
        assert (c.length, c.stopped) == (j.length, j.stopped)
        ref = generate_batch(tm, torch.tensor([text]),
                             prompt=None if prm is None else torch.from_numpy(prm)[:, None, :],
                             max_seqlen=max_len, k=1, force_max_seqlen=True, lazy_window=4,
                             state_quant="int4")
        np.testing.assert_array_equal(c.tokens, ref.tokens[:, 0, :].T.numpy()[:c.length])
    for st in srv._state.layers:
        assert st.s.dtype == torch.int8 and 2 * st.s.shape[-1] == st.vbuf.shape[-1]
        assert st.s_scale.shape == st.s.shape[:-1] and st.s_scale.dtype == torch.float32
    assert srv._state.pos_net.s.dtype == torch.float32 and srv._state.pos_net.s_scale is None
