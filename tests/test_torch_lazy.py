"""Lazy-window decode of the PyTorch port vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and cross between frameworks as
numpy arrays; model weights and decode states are carried across through
``utils/convert.py``. Tolerances: the plain f32 ops differ from the JAX
ops only in summation order (1e-5); the JAX Pallas lazy kernels (interpret
mode) round their matmul operands to bf16, which the port's functions do
not, so those compare at rtol = atol = 2e-2 (the tolerance of
tests/test_gla_pallas.py for the same kernels against their f32 oracle).
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
from lina_speech_tpu.ops.gla_pallas import gla_decode_lazy_conv_fused, gla_fold_fused
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.attentive_rnn import add_lazy_buffers
from lina_speech_tpu_torch.ops import gla as tgla
from lina_speech_tpu_torch.ops import gla_cuda
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, load_jax_params,
)

OPS_TOL = 1e-5
PALLAS_TOL = 2e-2
MODEL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _window_inputs(seed, L, b=2, h=2, dk=16, dv=32, w=4):
    """L tokens of pre-conv q/k/v and log-gates, taps, rings, a state, and
    window buffers whose every slot holds stale garbage (a large positive
    cbuf would overflow an unclamped exp)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    toks = [(f(b, h, dk), f(b, h, dk), f(b, h, dv),
             (-np.abs(f(b, h, dk)) * 0.3).astype(np.float32)) for _ in range(L)]
    taps = [f(w, h, dk) * 0.5, f(w, h, dk) * 0.5, f(w, h, dv) * 0.5]
    rings = [f(w, b, h, dk), f(w, b, h, dk), f(w, b, h, dv)]
    state = f(b, h, dk, dv)
    bufs = [f(L, b, h, dk) * 5, f(L, b, h, dv) * 5,
            np.full((L, b, h, dk), 150.0, np.float32), np.zeros((b, h, dk), np.float32)]
    return toks, taps, rings, state, bufs


@pytest.mark.parametrize("L", [4, 7])
def test_lazy_step_and_fold_match_jax(L):
    toks, _, _, state, bufs = _window_inputs(0, L)
    jb = [jnp.asarray(a) for a in bufs]
    tb = [torch.from_numpy(a) for a in bufs]
    js, ts = jnp.asarray(state), torch.from_numpy(state)
    for p, tok in enumerate(toks):
        jo, *jb = jgla.gla_decode_lazy_step(*map(jnp.asarray, tok), js, *jb, jnp.int32(p))
        before = [t.clone() for t in tb]
        to, *tb_new = tgla.gla_decode_lazy_step(*map(torch.from_numpy, tok), ts, *tb, p)
        for old, kept in zip(before, tb):  # the inputs are left untouched
            assert torch.equal(old, kept)
        tb = tb_new
        _close(to, jo, OPS_TOL)
        for t_buf, j_buf in zip(tb[:3], jb[:3]):
            _close(t_buf[:p + 1], j_buf[:p + 1], OPS_TOL)
        _close(tb[3], jb[3], OPS_TOL)
    _close(tgla.gla_decode_lazy_fold(ts, *tb), jgla.gla_decode_lazy_fold(js, *jb), OPS_TOL)


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [4, 8])
def test_lazy_conv_plain_window_matches_pallas(L, io):
    """A full window through gla_decode_lazy_conv_plain and gla_fold_plain
    against the Pallas kernels in interpret mode, with a bf16 state."""
    toks, taps, rings, state, bufs = _window_inputs(1, L)
    jdt, tdt = (jnp.float32, torch.float32) if io == "float32" else (jnp.bfloat16, torch.bfloat16)
    bufs = [np.zeros_like(a) for a in bufs]  # the JAX test's start: an empty window

    def both(a, jd, td):
        j = jnp.asarray(a).astype(jd)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)

    jt, tt = zip(*(both(a, jdt, tdt) for a in taps))
    jr, tr = map(list, zip(*(both(a, jdt, tdt) for a in rings)))
    js, ts = both(state, jnp.bfloat16, torch.bfloat16)
    jb, tb = map(list, zip(*(both(a, d, t) for a, d, t in zip(
        bufs, (jdt, jdt, jnp.float32, jnp.float32), (tdt, tdt, torch.float32, torch.float32)))))
    for p, tok in enumerate(toks):
        jx, tx = zip(*(both(a, jdt, tdt) for a in tok[:3]))
        jo, *jrest = gla_decode_lazy_conv_fused(
            *jx, jnp.asarray(tok[3]), *jt, *jr, js, *jb, jnp.int32(p),
            interpret=True, donate=False)
        to, *trest = gla_cuda.gla_decode_lazy_conv(
            *tx, torch.from_numpy(tok[3]), *tt, *tr, ts, *tb, p)
        jr, jb, tr, tb = jrest[:3], jrest[3:], trest[:3], trest[3:]
        assert to.dtype == tdt
        _close(to, jo, PALLAS_TOL)
        for a, j in zip(tr, jr):
            _close(a, j, 0.0)
        for a, j in zip(tb[:3], jb[:3]):
            _close(a[:p + 1], j[:p + 1], PALLAS_TOL)
        _close(tb[3], jb[3], OPS_TOL)
    t_new = gla_cuda.gla_fold(ts, *tb)
    assert t_new.dtype == torch.bfloat16
    _close(t_new, gla_fold_fused(js, *jb, interpret=True, donate=False), PALLAS_TOL)


@pytest.mark.parametrize("L", [4, 16])
def test_lazy_window_equals_classic_steps(L):
    """L lazy steps and one fold are L classic steps: the same outputs,
    rings and final state (f32, 1e-5), whatever the stale slots hold."""
    toks, taps, rings, state, bufs = _window_inputs(2, L)
    tt = [torch.from_numpy(a) for a in taps]
    lazy_rings = classic_rings = [torch.from_numpy(a) for a in rings]
    tb = [torch.from_numpy(a) for a in bufs]
    s0 = torch.from_numpy(state)
    s_classic = s0.clone()
    for p, tok in enumerate(toks):
        tok = [torch.from_numpy(a) for a in tok]
        o_l, *rest = gla_cuda.gla_decode_lazy_conv_plain(*tok, *tt, *lazy_rings, s0, *tb, p)
        lazy_rings, tb = rest[:3], rest[3:]
        o_c, s_classic, *classic_rings = gla_cuda.gla_decode_conv_plain(
            *tok, *tt, *classic_rings, s_classic)
        _close(o_l, o_c.numpy(), OPS_TOL)
        for a, c in zip(lazy_rings, classic_rings):
            assert torch.equal(a, c)
    _close(gla_cuda.gla_fold_plain(s0, *tb), s_classic.numpy(), OPS_TOL)


# ------------------------------------------------------------------ the model
def _flagship_like(cfg):
    """The tiny config in the flagship's architecture: ConvPos blind
    cross-attention and short convs."""
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, pos_type="convolutional", use_short_conv=True))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model with the same weights)."""
    cfg = _flagship_like(lina_gla_tiny())
    jm = jax_build(cfg)
    b, m, n = 2, 7, 9
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32),
        jnp.ones((b, n, cfg.n_quant), jnp.int32), jnp.ones((b, m, m), bool),
        jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    tm = load_jax_params(torch_build(_flagship_like(torch_tiny()), device="cpu"), params)
    return jm, params, tm.eval()


def test_model_lazy_steps_match_jax_from_a_carried_state(pair):
    """The JAX model prefills and takes two lazy steps; its state (window
    buffers included) crosses into the port; both then finish the window
    and fold. Logits and every state leaf agree."""
    jm, params, tm = pair
    L = 4
    rng = np.random.default_rng(3)
    text = rng.integers(3, 256, size=(2, 7))
    codes = rng.integers(3, 53, size=(1, 2, 6 + L))

    def jprefill(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        _, _, st = m.prefill(y[:, :6], x_enc, m.empty_state(2))
        return x_enc, y, st

    x_enc, y, jst = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jprefill)
    jst = jax_add_buffers(jst, L, dtype=jnp.float32)
    jstep = lambda st, p: jm.apply(params, y[:, 6 + p], x_enc, st, lazy_p=p,
                                   method=JaxLina.decode_step)
    for p in range(2):
        _, _, jst = jstep(jst, p)
    tst = backbone_state_from_arrays(jst)
    assert tst.layers[0].kbuf.shape == (L, 2, 2, 32) and tst.pos_net.cc is not None
    tx, ty = torch.from_numpy(np.asarray(x_enc)), torch.from_numpy(np.asarray(y))
    with torch.no_grad():
        for p in range(2, L):
            jl, jatt, jst = jstep(jst, p)
            tl, tatt, tst = tm.decode_step(ty[:, 6 + p], tx, tst, lazy_p=p)
            _close(tl, jl, MODEL_TOL)
            _close(tatt, jatt, MODEL_TOL)
        jst, tst = jax_fold(jst), tm.fold_lazy_state(tst)
    ours = backbone_state_to_arrays(tst)
    theirs = backbone_state_to_arrays(backbone_state_from_arrays(jst))
    assert set(ours) == set(theirs)
    for name in ours:
        if name.rsplit("/", 1)[-1] in ("s", "conv_q", "conv_k", "conv_v", "cc"):
            np.testing.assert_allclose(ours[name], theirs[name], rtol=MODEL_TOL,
                                       atol=MODEL_TOL, err_msg=name)


def test_model_lazy_window_equals_classic_steps(pair):
    _, _, tm = pair
    L = 4
    rng = np.random.default_rng(4)
    text = torch.from_numpy(rng.integers(3, 256, size=(2, 5)))
    codes = torch.from_numpy(rng.integers(3, 53, size=(1, 2, 3 + L)))
    with torch.no_grad():
        x_enc = tm.encode_text(text)
        y = tm.embed_tokens(codes)
        _, _, st = tm.prefill(y[:, :3], x_enc)
        lazy = add_lazy_buffers(st, L, dtype=torch.float32)
        for p in range(L):
            lc, _, st = tm.decode_step(y[:, 3 + p], x_enc, st)
            ll, _, lazy = tm.decode_step(y[:, 3 + p], x_enc, lazy, lazy_p=p)
            _close(ll, lc.numpy(), MODEL_TOL)
        lazy = tm.fold_lazy_state(lazy)
    for a, c in zip(lazy.layers + (lazy.pos_net,), st.layers + (st.pos_net,)):
        _close(a.s, c.s.numpy(), MODEL_TOL)
        assert float(a.cc.abs().max()) == 0.0


@pytest.mark.parametrize("max_seqlen,prompt_len", [(19, 6), (12, 0)])
def test_generate_lazy_window_matches_jax_and_classic(pair, max_seqlen, prompt_len):
    """Greedy tokens of generate_batch(lazy_window=4): equal to the JAX
    package's token for token, and to the port's classic loop. max_seqlen
    is not a whole number of windows past the prefill (overshoot room)."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    x = rng.integers(3, 256, size=(2, 9))
    prompt = rng.integers(0, 50, size=(1, 2, prompt_len)) if prompt_len else None
    kw = dict(max_seqlen=max_seqlen, first_greedy_quant=0, force_max_seqlen=True)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=None if prompt is None else jnp.asarray(prompt),
                        lazy_window=4, **kw)
    tp = None if prompt is None else torch.from_numpy(prompt)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=tp, lazy_window=4, **kw)
    classic = generate_batch(tm, torch.from_numpy(x), prompt=tp, **kw)
    assert tres.tokens.shape == (1, 2, max_seqlen)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    assert tres.n_steps == int(jres.n_steps) == max_seqlen
    assert torch.equal(tres.tokens, classic.tokens)


def test_generate_lazy_stops_at_window_granularity(pair):
    """Without force_max_seqlen a lazy run ends on a window boundary once
    every row has stopped; here no row stops, so it runs to max_seqlen."""
    _, _, tm = pair
    x = torch.from_numpy(np.random.default_rng(6).integers(3, 256, size=(1, 4)))
    res = generate_batch(tm, x, max_seqlen=10, first_greedy_quant=0, lazy_window=4,
                         return_att=True)
    stopped = bool(res.stop_mask.any())
    assert res.n_steps == 10 or (stopped and (res.n_steps - 1) % 4 == 0)
    assert res.att.shape[:2] == (1, 10)
