"""Quantized serving of the PyTorch port vs the JAX package, on the CPU.

int8 weights (``utils/quantize.py``, ``ops/qlinear.py``, the quantized
``Linear`` / ``SwiGLU`` / logits head) and int8 lazy-window states
(``ops/gla.py`` ``*_q``, ``GLAState.s_scale``), from the pure functions up
to ``generate_batch`` and ``DecodeServer``. Inputs are numpy arrays from a
seed; weights, quantized trees and states cross through ``utils/convert.py``.
On the CPU the port runs its plain versions; the JAX side runs as its own
tests run it: ``int8_linear_ref``, the Pallas kernels in interpret mode, and
the plain ``ops/gla.py`` ``_q`` functions.

Tolerances. f32 sums taken in another order: 1e-5. The w8a8 product is an
exact int32 sum, so only the two f32 scale multiplications remain: 1e-6. The
fused FFN rounds to bf16 three times on the way, and a sum that differs in
its last f32 bit can round the other way: one bf16 step (2**-7) of the
output's own magnitude. int8 states: a value that sits on a rounding
boundary may land one step apart, so integers agree within one step and only
a few may differ; scales to 1e-6 (5e-3 against the Pallas fold, which
rounds the decayed keys to bf16 for its matrix unit).
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
from lina_speech_tpu.ops import qlinear as jql
from lina_speech_tpu.ops.gla_pallas import gla_fold_fused_q
from lina_speech_tpu.serving import DecodeServer as JaxServer
from lina_speech_tpu.utils import quantize as jquant
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.base_blocks import Linear, SwiGLU, use_int8_weights
from lina_speech_tpu_torch.ops import gla as tgla
from lina_speech_tpu_torch.ops import qlinear as tql
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils import quantize as tquant
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, flax_path_for, load_jax_params,
    quantized_tree_from_jax,
)

MIN_SIZE = 1 << 8  # so that the tiny config's 64-wide layers qualify
SUM_TOL, W8A8_TOL, BF16_STEP = 1e-5, 1e-6, 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flagship_like(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, pos_type="convolutional", use_short_conv=True))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model with the same weights): the tiny
    config in the flagship's architecture, f32."""
    cfg = _flagship_like(lina_gla_tiny())
    jm = jax_build(cfg)
    b, m, n = 2, 7, 9
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32),
        jnp.ones((b, n, cfg.n_quant), jnp.int32), jnp.ones((b, m, m), bool),
        jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    tm = load_jax_params(torch_build(_flagship_like(torch_tiny()), device="cpu"), params)
    return jm, params, tm.eval()


def _np(t):
    return t.detach().float().numpy()


def _int_steps(a, b):
    """(largest difference, share of elements that differ) of two int8 arrays."""
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return int(d.max()), float((d > 0).mean())


# ------------------------------------------------------- utils/quantize.py
def test_quantize_dense_params_matches_jax(pair):
    """The same leaves are chosen as in the JAX tree (by name, through the
    naming map), q and s are equal bit for bit, the rest passes through."""
    _, params, tm = pair
    jtree = jquant.quantize_dense_params(params, min_size=MIN_SIZE)
    theirs = quantized_tree_from_jax(jtree)
    named = dict(tm.named_parameters())
    ours = tquant.quantize_dense_params(named, min_size=MIN_SIZE)
    chosen = {k for k, v in ours.items() if tquant.is_quantized_leaf(v)}
    assert chosen == set(theirs) and len(chosen) >= 40
    for name in chosen:
        assert ours[name][tquant.QKEY].dtype == torch.int8
        assert torch.equal(ours[name][tquant.QKEY], theirs[name][tquant.QKEY]), name
        assert torch.equal(ours[name][tquant.SKEY], theirs[name][tquant.SKEY]), name
    assert ours["logits_head.weight"][tquant.SKEY].shape == (1, 53, 1)
    tmix = "attentive_rnn.encoder.0.tmix."
    assert ours[tmix + "q_proj.weight"][tquant.SKEY].shape == (64, 1)
    # passes through untouched: a narrow projection (16 outputs), conv taps,
    # biases and norms (1-D), embeddings
    for name in (tmix + "gk_proj.0.weight", tmix + "q_conv1d.weight", tmix + "gk_proj.1.bias",
                 "attentive_rnn.encoder.0.norm1.weight", "txt_embed.weight", "rvq_embed.weight",
                 "attentive_rnn.cross_att.pos_embed.embed.weight"):
        assert ours[name] is named[name], name
    # min_size counts elements: 64 x 64 = 4096 stays float at 8192
    big = tquant.quantize_dense_params(named, min_size=8192)
    assert not tquant.is_quantized_leaf(big[tmix + "q_proj.weight"])
    assert tquant.is_quantized_leaf(big[tmix + "v_proj.weight"])  # 128 x 64


def test_quantize_exclude_dequantize_and_bytes_match_jax(pair):
    _, params, tm = pair
    named = dict(tm.named_parameters())
    jtree = jquant.quantize_dense_params(params, min_size=MIN_SIZE,
                                         exclude=lambda path: "cmix" in path)
    ours = tquant.quantize_dense_params(named, min_size=MIN_SIZE,
                                        exclude=lambda name: "cmix" in name)
    chosen = {k for k, v in ours.items() if tquant.is_quantized_leaf(v)}
    assert chosen == set(quantized_tree_from_jax(jtree)) and not any("cmix" in k for k in chosen)
    assert tquant.quantized_bytes(ours) == jquant.quantized_bytes(jtree)
    assert tquant.quantized_bytes(named) == jquant.quantized_bytes(params)
    deq = tquant.dequantize_params(ours, torch.float32)
    jdeq = jquant.dequantize_params(jtree, jnp.float32)["params"]
    name = "attentive_rnn.decoder.1.tmix.o_proj.weight"
    j_leaf = jdeq
    for part in flax_path_for(name).split("/"):
        j_leaf = j_leaf[part]
    np.testing.assert_array_equal(_np(deq[name]), np.asarray(j_leaf).T)
    assert deq["txt_embed.weight"] is named["txt_embed.weight"]


# ----------------------------------------------------------- ops/qlinear.py
def _quantized_weight(rng, k, n):
    """(JAX q (k, n), JAX s (1, n), port q packed (n, kp), port s (n,))."""
    w = rng.normal(size=(k, n)).astype(np.float32)
    ql = jquant._quantize_leaf(jnp.asarray(w))
    tq = tquant.quantize_leaf(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq[tquant.QKEY].numpy(), np.asarray(ql[jquant.QKEY]).T)
    np.testing.assert_array_equal(tq[tquant.SKEY].numpy(), np.asarray(ql[jquant.SKEY]).T)
    return (ql[jquant.QKEY], ql[jquant.SKEY], tql.pack_int8_weight(tq[tquant.QKEY]),
            tq[tquant.SKEY].reshape(-1))


@pytest.mark.parametrize("mode", ["wonly", "w8a8"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 512), (3, 384, 300), (4, 85, 130), (5, 341, 64)])
def test_int8_linear_plain_matches_jax_ref(mode, m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    jq, js, tq, ts = _quantized_weight(rng, k, n)
    assert tq.shape == (n, -(-k // 16) * 16) and not tq[:, k:].any()
    x = rng.normal(size=(2, m, k)).astype(np.float32)  # leading dims are kept
    ref = jql.int8_linear_ref(jnp.asarray(x), jq, js, out_dtype=jnp.float32, mode=mode)
    out = tql.int8_linear(torch.from_numpy(x), tq, ts, out_dtype=torch.float32, mode=mode)
    assert out.shape == (2, m, n) and out.dtype == torch.float32
    tol = SUM_TOL if mode == "wonly" else W8A8_TOL
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max())
    if mode == "w8a8":  # the integer sum itself is exact
        xq, sx = tql.quantize_rows(torch.from_numpy(x))
        acc = xq.to(torch.int32).reshape(-1, k) @ tq[:, :k].to(torch.int32).T
        jxq = jnp.clip(jnp.round(jnp.asarray(x) / np.asarray(sx)), -127, 127).astype(jnp.int8)
        jacc = jax.lax.dot_general(jxq.reshape(-1, k), jq, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # bf16 in and out, as the flagship runs it
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ob = tql.int8_linear(xb, tq, ts, out_dtype=torch.bfloat16, mode=mode)
    rb = jql.int8_linear_ref(jnp.asarray(x).astype(jnp.bfloat16), jq, js, mode=mode)
    rb = np.asarray(rb, np.float32)
    np.testing.assert_allclose(_np(ob), rb, rtol=BF16_STEP, atol=BF16_STEP * np.abs(rb).max())


def test_int8_linear_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    jq, js, tq, ts = _quantized_weight(rng, 256, 384)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    for mode in ("wonly", "w8a8"):
        ref = np.asarray(jql.int8_linear(jnp.asarray(x), jq, js, out_dtype=jnp.float32,
                                         mode=mode, interpret=True))
        out = tql.int8_linear_plain(torch.from_numpy(x), tq, ts, out_dtype=torch.float32,
                                    mode=mode)
        np.testing.assert_allclose(out.numpy(), ref, rtol=SUM_TOL, atol=SUM_TOL * np.abs(ref).max())


def _ffn_out_weight(q_hd):
    """The JAX package's hidden-major (H, d) int8 output weight as the port's
    fused FFN takes it: the output Linear's packed (d, Hp) weight."""
    return tql.pack_int8_weight(torch.from_numpy(np.array(q_hd)).T)


@pytest.mark.parametrize("m,d,hidden", [(1, 64, 85), (4, 256, 341), (1, 128, 512)])
def test_fused_ffn_plain_matches_pallas_interpret(m, d, hidden):
    """The three shapes of the JAX package's own test: a single full block,
    a masked edge chunk, an exact split."""
    rng = np.random.default_rng(hidden)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    win, wout = f(d, 2 * hidden) * 0.05, f(hidden, d) * 0.05
    b_in, b_out, x = f(2 * hidden) * 0.01, f(d) * 0.01, f(m, d)
    qi, qo = jquant._quantize_leaf(jnp.asarray(win)), jquant._quantize_leaf(jnp.asarray(wout))
    ref = jql.fused_ffn_int8(jnp.asarray(x).astype(jnp.bfloat16), qi[jquant.QKEY],
                             qi[jquant.SKEY], jnp.asarray(b_in), qo[jquant.QKEY],
                             qo[jquant.SKEY], jnp.asarray(b_out), interpret=True)
    ti = tquant.quantize_leaf(torch.from_numpy(win.T.copy()))
    to = tquant.quantize_leaf(torch.from_numpy(wout.T.copy()))
    q_out = _ffn_out_weight(qo[jquant.QKEY])
    assert q_out.shape == (d, -(-hidden // 16) * 16)
    assert torch.equal(q_out, tql.pack_int8_weight(to[tquant.QKEY]))
    out = tql.fused_ffn_int8(
        torch.from_numpy(x).to(torch.bfloat16), ti[tquant.QKEY], ti[tquant.SKEY],
        torch.from_numpy(b_in), q_out, to[tquant.SKEY], torch.from_numpy(b_out))
    assert out.dtype == torch.bfloat16 and out.shape == (m, d)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(out), ref, rtol=BF16_STEP, atol=BF16_STEP * np.abs(ref).max())
    # no biases, f32 out
    ref = np.asarray(jql.fused_ffn_int8(
        jnp.asarray(x), qi[jquant.QKEY], qi[jquant.SKEY], None, qo[jquant.QKEY],
        qo[jquant.SKEY], None, out_dtype=jnp.float32, interpret=True))
    out = tql.fused_ffn_int8(torch.from_numpy(x), ti[tquant.QKEY], ti[tquant.SKEY], None,
                             q_out, to[tquant.SKEY], None, out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=BF16_STEP,
                               atol=BF16_STEP * np.abs(ref).max())


@pytest.mark.parametrize("m,k,n,plan", [
    (1, 1024, 2048, ("gemv", 1, 1)), (8, 1024, 2048, ("gemv", 8, 1)),
    (3, 85, 130, ("gemv", 4, 1)), (5, 4100, 40, ("gemv", 8, 1)),
    (9, 1024, 2048, ("mma", 16, 4)), (16, 1024, 2048, ("mma", 16, 4)),
    (64, 1024, 2048, ("mma", 32, 8)), (128, 1024, 2048, ("mma", 32, 4)),
    (64, 1365, 1024, ("mma", 32, 8)), (64, 1024, 2730, ("mma", 32, 6)),
    (67, 1365, 1024, ("mma", 32, 8)), (19, 341, 67, ("mma", 32, 6))])
def test_int8_linear_plan(m, k, n, plan):
    """The launch plan of int8_linear: the GEMV body up to 8 rows (the
    smallest m-tile of 1, 2, 4, 8 that holds m), else the tensor-core body
    with an m-tile of 16 or 32 rows and K split over a cluster until about
    264 or 528 blocks run, at most 8 blocks a cluster, every block of a
    cluster with a stage of 64 columns of K (so a cluster may stay a little
    under its target)."""
    assert tql.int8_linear_plan(m, k, n) == plan
    route, mt, ks = plan
    if route == "gemv":
        assert m <= 8 and ks == 1 and mt >= m
        return
    stages = -(-k // 64)
    per = -(-stages // ks)
    assert (ks - 1) * per < stages <= ks * per  # no rank without a stage
    blocks = ks * -(-m // mt) * -(-n // (2 * mt))  # 32 channels a block at mt 16, 64 at 32
    assert blocks >= 132 or ks == min(8, stages) or per == 1  # the card is filled


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 67, 128])
def test_fused_ffn_plan(m):
    """fused_ffn_int8 at the flagship's width (d 1024, hidden 1365): m-tiles
    of 8 rows up to 16, else 16; at least 132 blocks at every m, and the
    chunk parts' traffic each way under twice the 4.2 MB of int8 weights up
    to m 64."""
    mt = tql.fused_ffn_plan(m)
    assert mt == (8 if m <= 16 else 16)
    chunks = -(-1365 // 64)
    assert 8 * chunks * -(-m // mt) >= 132
    if m <= 64:
        assert chunks * m * 1024 * 4 < 2 * 4.2e6


def test_rows_copied_as_is():
    """The kernels copy x into shared memory as it is only for bf16 rows of
    whole 16-byte pieces on a 16-byte boundary."""
    x = torch.zeros(4, 1024, dtype=torch.bfloat16)
    assert tql._copies_as_is(x)
    assert not tql._copies_as_is(x.float())
    assert not tql._copies_as_is(torch.zeros(4, 1365, dtype=torch.bfloat16))
    assert not tql._copies_as_is(x.reshape(-1)[4:1028].reshape(1, 1024))


def test_quantized_linear_and_swiglu_routes():
    """Linear: the int8 product, then the bias in the output dtype. SwiGLU:
    the fused call when both layers are weight only, two Linear calls under
    w8a8; nothing changes while ``use_int8`` is off."""
    gen = torch.Generator().manual_seed(0)
    lin = Linear(48, 40, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(40, 48, generator=gen))
        lin.bias.copy_(torch.randn(40, generator=gen))
    x = torch.randn(3, 48, generator=gen)
    with torch.no_grad():
        plain = lin(x)
        pairq = tquant.quantize_leaf(lin.weight)
        lin.set_int8(pairq[tquant.QKEY], pairq[tquant.SKEY])
        assert lin.int8_q.shape == (40, 48) and torch.equal(lin(x), plain)
        for mode in ("wonly", "w8a8"):
            lin.quant_mode = mode
            with use_int8_weights(lin):
                y = lin(x)
            want = tql.int8_linear_plain(x, lin.int8_q, lin.int8_s, mode=mode) \
                + lin.bias.to(torch.bfloat16)
            assert y.dtype == torch.bfloat16 and torch.equal(y, want)
            assert not lin.use_int8
        ffn = SwiGLU(64, dtype=torch.bfloat16)
        for p in ffn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for layer in (ffn.p_in, ffn.p_out):
            pq = tquant.quantize_leaf(layer.weight)
            layer.set_int8(pq[tquant.QKEY], pq[tquant.SKEY])
        assert ffn.p_out.int8_q.shape == (64, 96)  # hidden 85 padded to 96
        xs = torch.randn(2, 5, 64, generator=gen)
        with use_int8_weights(ffn):
            fused = ffn(xs)
            want = tql.fused_ffn_int8_plain(
                xs, ffn.p_in.int8_q, ffn.p_in.int8_s, ffn.p_in.bias,
                ffn.p_out.int8_q, ffn.p_out.int8_s, ffn.p_out.bias)
            assert torch.equal(fused, want)
            ffn.p_in.quant_mode = ffn.p_out.quant_mode = "w8a8"
            two = ffn(xs)
            gate, h = ffn.p_in(xs).chunk(2, dim=-1)
            assert torch.equal(two, ffn.p_out(torch.nn.functional.silu(gate) * h))
        rel = float((fused.float() - two.float()).abs().max() / two.float().abs().max())
        assert 0 < rel < 0.1  # another numerics class, the same function
        lin.drop_float_weight_()
        assert lin.weight is None and lin.use_int8 and lin(x).dtype == torch.bfloat16


# --------------------------------------------------------------- ops/gla.py
def _window(seed, L, b=2, h=2, dk=16, dv=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    toks = [(f(b, h, dk), f(b, h, dk), f(b, h, dv),
             (-np.abs(f(b, h, dk)) * 0.3).astype(np.float32)) for _ in range(L)]
    bufs = [f(L, b, h, dk) * 5, f(L, b, h, dv) * 5,
            np.full((L, b, h, dk), 150.0, np.float32), np.zeros((b, h, dk), np.float32)]
    return toks, f(b, h, dk, dv) * 0.1, bufs


def test_quantize_state_rows_matches_jax():
    s = np.random.default_rng(0).normal(size=(2, 2, 16, 32)).astype(np.float32)
    s[0, 0, 3] = 0.0  # an all-zero row takes the 1e-30 floor
    jq, jsc = jgla.quantize_state_rows(jnp.asarray(s))
    tq, tsc = tgla.quantize_state_rows(torch.from_numpy(s))
    assert tq.dtype == torch.int8 and tsc.shape == (2, 2, 16) and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tgla.dequantize_state_rows(tq, tsc).numpy(),
                                  np.asarray(jgla.dequantize_state_rows(jq, jsc)))
    # bf16 states quantize from their f32 values
    sb = torch.from_numpy(s).to(torch.bfloat16)
    tqb, _ = tgla.quantize_state_rows(sb)
    jqb, _ = jgla.quantize_state_rows(jnp.asarray(s).astype(jnp.bfloat16))
    np.testing.assert_array_equal(tqb.numpy(), np.asarray(jqb))


@pytest.mark.parametrize("L", [4, 7])
def test_lazy_step_q_and_fold_q_match_jax(L):
    toks, state, bufs = _window(1, L)
    jq, jsc = jgla.quantize_state_rows(jnp.asarray(state))
    tq, tsc = torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(jsc))
    jb, tb = [jnp.asarray(a) for a in bufs], [torch.from_numpy(a) for a in bufs]
    for p, tok in enumerate(toks):
        jo, *jb = jgla.gla_decode_lazy_step_q(*map(jnp.asarray, tok), jq, jsc, *jb, jnp.int32(p))
        to, *tb = tgla.gla_decode_lazy_step_q(*map(torch.from_numpy, tok), tq, tsc, *tb, p)
        jo = np.asarray(jo)
        np.testing.assert_allclose(to.numpy(), jo, rtol=SUM_TOL, atol=SUM_TOL * np.abs(jo).max())
        np.testing.assert_allclose(tb[3].numpy(), np.asarray(jb[3]), rtol=SUM_TOL, atol=SUM_TOL)
    rq, rsc = jgla.gla_decode_lazy_fold_q(jq, jsc, *jb)
    fq, fsc = tgla.gla_decode_lazy_fold_q(tq, tsc, *tb)
    assert fq.dtype == torch.int8 and fsc.dtype == torch.float32
    worst, share = _int_steps(fq.numpy(), rq)
    assert worst <= 1 and share < 0.01, (worst, share)
    np.testing.assert_allclose(fsc.numpy(), np.asarray(rsc), rtol=1e-6)
    # the Pallas fold in interpret mode, as the JAX package's own test holds it
    kq, ksc = gla_fold_fused_q(jq, jsc, jb[0].astype(jnp.bfloat16), jb[1].astype(jnp.bfloat16),
                               jb[2], jb[3], interpret=True, donate=False)
    bq, bsc = tgla.gla_decode_lazy_fold_q(tq, tsc, tb[0].to(torch.bfloat16),
                                          tb[1].to(torch.bfloat16), tb[2], tb[3])
    worst, _ = _int_steps(bq.numpy(), kq)
    assert worst <= 1
    np.testing.assert_allclose(bsc.numpy(), np.asarray(ksc), rtol=5e-3, atol=1e-7)


# ------------------------------------------------------------------- layers
def _quantized_pair(pair):
    """The JAX quantized tree and the port model holding the same int8
    weights, carried across (not requantized)."""
    jm, params, tm = pair
    jtree = jquant.quantize_dense_params(params, min_size=MIN_SIZE)
    tm.load_int8_(quantized_tree_from_jax(jtree))
    return jm, jtree, tm


def test_quantized_swiglu_matches_jax_module(pair):
    jm, jtree, tm = _quantized_pair(pair)
    x = np.random.default_rng(2).normal(size=(2, 3, 64)).astype(np.float32)
    ref = jm.apply(jtree, jnp.asarray(x),
                   method=lambda m, v: m.attentive_rnn.decoder[0].cmix(v))
    with torch.no_grad(), use_int8_weights(tm):
        out = tm.attentive_rnn.decoder[0].cmix(torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=BF16_STEP, atol=BF16_STEP * np.abs(ref).max())
    assert not tm.attentive_rnn.decoder[0].cmix.p_in.use_int8


def test_model_int8_state_lazy_steps_match_jax(pair):
    """The JAX model prefills, quantizes its states and takes one lazy step
    on the quantized tree; the state crosses into the port; both finish the
    window on int8 weights and fold. Logits, scales and int8 states agree."""
    jm, jtree, tm = _quantized_pair(pair)
    _, params, _ = pair
    L = 4
    rng = np.random.default_rng(3)
    text, codes = rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, 6 + L))

    def jprefill(m, text, codes):
        x_enc, y = m.encode_text(text), m.embed_tokens(codes)
        return x_enc, y, m.prefill(y[:, :6], x_enc, m.empty_state(2))[2]

    x_enc, y, jst = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jprefill)
    jst = jax_add_buffers(jst, L, dtype=jnp.float32, state_quant="int8")
    jstep = lambda st, p: jm.apply(jtree, y[:, 6 + p], x_enc, st, lazy_p=p,
                                   method=JaxLina.decode_step)
    _, _, jst = jstep(jst, 0)
    tst = backbone_state_from_arrays(jst)
    assert tst.layers[0].s.dtype == torch.int8 and tst.layers[3].s_scale.shape == (2, 2, 32)
    assert tst.pos_net.s_scale is None and tst.pos_net.s.dtype == torch.float32  # stays float
    tx, ty = torch.from_numpy(np.asarray(x_enc)), torch.from_numpy(np.asarray(y))
    with torch.no_grad(), use_int8_weights(tm):
        for p in range(1, L):
            jl, _, jst = jstep(jst, p)
            tl, _, tst = tm.decode_step(ty[:, 6 + p], tx, tst, lazy_p=p)
            jl = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-3, atol=1e-3 * np.abs(jl).max())
        jst, tst = jax_fold(jst), tm.fold_lazy_state(tst)
    ours = backbone_state_to_arrays(tst)
    theirs = backbone_state_to_arrays(backbone_state_from_arrays(jst))
    assert set(ours) == set(theirs) and "layers/0/s_scale" in ours
    for name in ours:
        field = name.rsplit("/", 1)[-1]
        if field == "s":
            worst, share = _int_steps(ours[name], theirs[name])
            assert worst <= 1 and share < 0.02, (name, worst, share)
        elif field in ("s_scale", "conv_q", "conv_k", "conv_v", "cc"):
            np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-3,
                                       atol=1e-3 * np.abs(theirs[name]).max(), err_msg=name)


# ---------------------------------------------------------- the whole slice
@pytest.mark.parametrize("kw", [
    dict(weight_quant="int8"),
    dict(lazy_window=4, state_quant="int8"),
    dict(lazy_window=4, state_quant="int8", weight_quant="int8"),
], ids=["weights", "states", "both"])
def test_generate_quantized_matches_jax(pair, kw):
    """Greedy tokens of the quantized generate_batch, token for token."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    x = rng.integers(3, 256, size=(2, 9))
    prompt = rng.integers(0, 50, size=(1, 2, 6))
    common = dict(max_seqlen=19, first_greedy_quant=0, force_max_seqlen=True)
    if "weight_quant" in kw:
        common["quant_min_size"] = MIN_SIZE
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **common, **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt),
                          **common, **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert tres.n_steps == int(jres.n_steps) == 19
    # the quantization acts, and is switched off again after the loop
    plain = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt),
                           lazy_window=kw.get("lazy_window", 0), **{
                               k: v for k, v in common.items() if k != "quant_min_size"})
    assert not any(getattr(m, "use_int8", False) for m in tm.modules())
    assert plain.tokens.shape == tres.tokens.shape


SERVE_TEXTS = [[5, 9, 3, 17, 8], [12, 4, 33, 7, 19, 21, 6], [40, 41], [3, 18, 27, 9],
               [25, 26, 27, 28, 29, 30]]


def _serve(server, max_len, prompts=None):
    prompts = prompts or [None] * len(SERVE_TEXTS)
    rids = [server.submit(np.asarray(t), prompt=p, max_len=max_len)
            for t, p in zip(SERVE_TEXTS, prompts)]
    done = {c.rid: c for c in server.run()}
    assert set(done) == set(rids)
    return [done[r] for r in rids]


@pytest.mark.parametrize("kw", [
    dict(weight_quant="int8", quant_min_size=MIN_SIZE),
    dict(lazy=True, state_quant="int8"),
], ids=["weights", "lazy-int8-states"])
def test_server_quantized_matches_jax_server_and_generate(pair, kw):
    """Five requests through two recycled slots: the JAX server's tokens,
    and each request's own generate_batch tokens."""
    jm, params, tm = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 50, size=(1, p)) if p else None for p in (0, 5, 0, 2, 0)]
    max_len = 14
    jdone = _serve(JaxServer(jm, params, n_slots=2, max_text_len=12, chunk=4, **kw), max_len,
                   prompts)
    srv = DecodeServer(tm, n_slots=2, max_text_len=12, chunk=4, **kw)
    done = _serve(srv, max_len, prompts)
    gen_kw = {k: v for k, v in kw.items() if k != "lazy"}
    for c, j, text, prm in zip(done, jdone, SERVE_TEXTS, prompts):
        np.testing.assert_array_equal(c.tokens, j.tokens)
        assert (c.length, c.stopped) == (j.length, j.stopped)
        ref = generate_batch(tm, torch.tensor([text]),
                             prompt=None if prm is None else torch.from_numpy(prm)[:, None, :],
                             max_seqlen=max_len, k=1, force_max_seqlen=True,
                             lazy_window=4 if kw.get("lazy") else 0, **gen_kw)
        np.testing.assert_array_equal(c.tokens, ref.tokens[:, 0, :].T.numpy()[:c.length])
    if "state_quant" in kw:
        for st in srv._state.layers:
            assert st.s.dtype == torch.int8 and st.s_scale.dtype == torch.float32
            assert st.s_scale.shape == st.s.shape[:-1]
        assert srv._state.pos_net.s.dtype == torch.float32 and srv._state.pos_net.s_scale is None


def test_server_int8_prefill_through_the_quantized_weights():
    """int8_prefill_full_precision=False: the float weights of the quantized
    layers leave the model, prefill and text encoding run through the int8
    route, and the server still serves; bf16 compute, both quantizations."""
    cfg = _flagship_like(torch_tiny(compute_dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                state_dtype="bfloat16"))
    tm = torch_build(cfg, device="cpu", seed=4).eval()
    before = tquant.quantized_bytes(dict(tm.named_parameters()))
    srv = DecodeServer(tm, n_slots=2, max_text_len=12, chunk=4, lazy=True, state_quant="int8",
                       weight_quant="int8", quant_min_size=MIN_SIZE,
                       int8_prefill_full_precision=False)
    assert tm.attentive_rnn.encoder[0].tmix.q_proj.weight is None
    assert tm.logits_head.weight is None and tm.txt_encoder.sa[0].cmix.p_in.use_int8
    # the float parameters left (the layers not quantized) stay f32 in the
    # caller's model; the server computes on its bf16 copies of them
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert sum(c.numel() * c.element_size() for c in srv._params.values()) < before // 4
    prompts = [None, np.random.default_rng(8).integers(0, 50, size=(1, 5)), None, None, None]
    for c, text, prm in zip(_serve(srv, 11, prompts), SERVE_TEXTS, prompts):
        assert c.length <= 11 and (c.stopped or c.length == 11)
        # the model's quantized layers now take the int8 route in every call,
        # so generate_batch runs the same numbers with no weight_quant asked
        ref = generate_batch(tm, torch.tensor([text]),
                             prompt=None if prm is None else torch.from_numpy(prm)[:, None, :],
                             max_seqlen=11, k=1, force_max_seqlen=True, lazy_window=4,
                             state_quant="int8")
        np.testing.assert_array_equal(c.tokens, ref.tokens[:, 0, :].T.numpy()[:c.length])
    assert srv._state.layers[0].s.dtype == torch.int8
    assert srv._state.layers[0].kbuf.dtype == torch.bfloat16


def test_quant_option_errors():
    tm = torch_build(torch_tiny(), device="cpu")
    x = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="state_quant requires lazy_window"):
        generate_batch(tm, x, max_seqlen=4, state_quant="int8")
    with pytest.raises(ValueError, match="state_quant requires lazy"):
        DecodeServer(tm, n_slots=2, state_quant="int8")
    for bad in (dict(weight_quant="int4"), dict(state_quant="fp8", lazy_window=4)):
        with pytest.raises(ValueError, match="unknown"):
            generate_batch(tm, x, max_seqlen=4, **bad)
    with pytest.raises(ValueError, match="unknown weight_quant"):
        DecodeServer(tm, n_slots=2, weight_quant="fp8")
    # int4 states run (tests/test_torch_int4.py holds them against JAX); they
    # need a lazy window too
    res = generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=4, state_quant="int4",
                         force_max_seqlen=True)
    assert res.tokens.shape == (tm.n_quant, 1, 6)
    with pytest.raises(ValueError, match="state_quant requires lazy_window"):
        generate_batch(tm, x, max_seqlen=4, state_quant="int4")
    srv = DecodeServer(tm, n_slots=2, lazy=True, chunk=4, state_quant="int4")
    srv.submit(x[0].numpy(), max_len=6)
    (c,) = srv.run()
    assert 1 <= c.length <= 6
    st = srv._state.layers[0]  # the slot container's s is the packed state: dv / 2 bytes
    assert st.s.dtype == torch.int8 and 2 * st.s.shape[-1] == st.vbuf.shape[-1]
