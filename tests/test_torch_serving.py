"""DecodeServer of the PyTorch port vs the JAX package, on the CPU.

The tiny config in the flagship's architecture (ConvPos blind
cross-attention, short convs), weights initialized by JAX and carried
across through ``utils/convert.py``. Greedy decoding (k=1): the port's
server must give the JAX server's tokens, and each request's own
``generate_batch`` tokens, token for token -- in classic and in lazy mode,
with mixed text and prompt lengths, recycled slots and a request that ends
at its prefill. The JAX servers run once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.serving import DecodeServer as JaxServer
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.attentive_rnn import map_state
from lina_speech_tpu_torch.serving import (
    Completion, DecodeServer, _batch_axis, _pow2_chunks,
)
from lina_speech_tpu_torch.utils.convert import load_jax_params

CHUNK, SLOTS, MAX_TEXT = 4, 2, 12
# (text ids, prompt length, max_len): mixed lengths; the third ends at its
# prefill (max_len <= forced tokens), the others recycle the two slots
REQUESTS = [
    ([5, 9, 3, 17, 8], 0, 14),
    ([12, 4, 33, 7, 19, 21, 6], 12, 22),
    ([40, 41], 5, 4),
    ([3, 18, 27, 9], 2, 9),
    ([25, 26, 27, 28, 29, 30], 6, 16),
]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flagship_like(cfg, **backbone):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, pos_type="convolutional", use_short_conv=True, **backbone))


def _prompts(n_quant):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 50, size=(n_quant, p)) if p else None
            for _, p, _ in REQUESTS]


def _serve(server, prompts):
    rids = [server.submit(np.asarray(text), prompt=prm, max_len=max_len)
            for (text, _, max_len), prm in zip(REQUESTS, prompts)]
    done = {c.rid: c for c in server.run()}
    assert set(done) == set(rids)
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def setup():
    """JAX model and params, the port's model with the same weights, the
    requests' prompts, and the JAX server's completions in both modes."""
    cfg = _flagship_like(lina_gla_tiny())
    jm = jax_build(cfg)
    params = jm.init(
        jax.random.PRNGKey(2), jnp.ones((1, 10), jnp.int32),
        jnp.ones((1, 8, cfg.n_quant), jnp.int32), jnp.ones((1, 10, 10), bool),
        jnp.ones((1, 8, 10), bool), jnp.ones((1, 8), bool))
    tm = load_jax_params(torch_build(_flagship_like(torch_tiny()), device="cpu"),
                         params).eval()
    prompts = _prompts(cfg.n_quant)
    jax_done = {lazy: _serve(JaxServer(jm, params, n_slots=SLOTS, max_text_len=MAX_TEXT,
                                       chunk=CHUNK, lazy=lazy), prompts)
                for lazy in (False, True)}
    return tm, prompts, jax_done


@pytest.mark.parametrize("lazy", [False, True], ids=["classic", "lazy"])
def test_server_matches_jax_server_and_generate(setup, lazy):
    tm, prompts, jax_done = setup
    srv = DecodeServer(tm, n_slots=SLOTS, max_text_len=MAX_TEXT, chunk=CHUNK, lazy=lazy)
    done = _serve(srv, prompts)
    assert srv.active == 0 and srv.partials() == {}
    assert srv.prefill_chunk_sizes <= {1, 2, 4, 8}
    for c, j, (text, p_len, max_len), prm in zip(done, jax_done[lazy], REQUESTS, prompts):
        assert isinstance(c, Completion)
        np.testing.assert_array_equal(c.tokens, j.tokens)
        assert (c.length, c.stopped) == (j.length, j.stopped)
        ref = generate_batch(
            tm, torch.tensor([text]),
            prompt=None if prm is None else torch.from_numpy(prm)[:, None, :],
            max_seqlen=max(max_len, p_len + 1), k=1, force_max_seqlen=True,
            lazy_window=CHUNK if lazy else 0)
        ref_toks = ref.tokens[:, 0, :].T.numpy()  # (steps, q)
        np.testing.assert_array_equal(c.tokens, ref_toks[:c.length])
        if not c.stopped:
            assert c.length == max_len
    assert done[2].length == 4  # ended at its prefill: 6 forced tokens, max_len 4


def test_prefill_chunks_thread_the_state_exactly(setup):
    """The server's binary-decomposed prefill (8 + 4 + 1, conv_history and
    the carried rings) against one-shot prefill: logits and every state
    leaf."""
    tm, _, _ = setup
    rng = np.random.default_rng(12)
    text = torch.from_numpy(rng.integers(3, 256, size=(1, 7)))
    codes = torch.from_numpy(rng.integers(3, 53, size=(1, 1, 13)))
    with torch.no_grad():
        x_enc = tm.encode_text(text)
        y = tm.embed_tokens(codes)
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(1))
        st, off, parts = tm.empty_state(1), 0, []
        for c in _pow2_chunks(13):
            lg, _, st = tm.prefill(y[:, off:off + c], x_enc, st, conv_history=off > 0,
                                   time_offset=off)
            parts.append(lg)
            off += c
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), rtol=3e-4, atol=3e-4)
    map_state(lambda a, b: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                                      atol=3e-4), st, st_full)


def test_streaming_partials_and_max_chunks(setup):
    tm, _, _ = setup
    srv = DecodeServer(tm, n_slots=2, max_text_len=MAX_TEXT, chunk=CHUNK)
    a = srv.submit(np.asarray([5, 9, 3]), max_len=12)
    b = srv.submit(np.asarray([7, 8]), max_len=7)
    assert srv.run(max_chunks=1) == [] and srv.active == 2
    parts = srv.partials()
    assert parts[a].shape == (1 + CHUNK, tm.n_quant) and parts[b].shape == (1 + CHUNK, tm.n_quant)
    done = srv.run(max_chunks=1)
    assert [c.rid for c in done] == [b] and done[0].length == 7
    np.testing.assert_array_equal(done[0].tokens[:1 + CHUNK], parts[b])
    rest = srv.run()
    assert [c.rid for c in rest] == [a] and rest[0].length == 12


def test_queue_drains_when_requests_end_at_prefill(setup):
    tm, _, _ = setup
    srv = DecodeServer(tm, n_slots=1, max_text_len=MAX_TEXT, chunk=CHUNK, lazy=True)
    for i in range(3):
        srv.submit(np.asarray([5 + i, 9]), max_len=1)
    done = srv.run()
    assert [c.length for c in done] == [1, 1, 1]
    with pytest.raises(ValueError):
        srv.submit(np.arange(3, 3 + MAX_TEXT + 1), max_len=4)
        srv.run()


@pytest.mark.parametrize("lazy,squant", [(False, None), (True, None), (True, "int8")],
                         ids=["classic", "lazy", "lazy-int8"])
def test_bf16_server_keeps_prefill_dtypes(lazy, squant):
    """A bf16 compute/state config: the slot container takes the dtypes a
    prefill produces (bf16 states, rings and window buffers; f32 gate
    cumsums; with state_quant="int8" the layers' states int8 with f32 row
    scales, quantized from the bf16 final state, and the pos_net's still
    bf16), and the server equals generate_batch."""
    cfg = _flagship_like(torch_tiny(compute_dtype="bfloat16"), state_dtype="bfloat16")
    tm = torch_build(cfg, device="cpu", seed=4).eval()
    srv = DecodeServer(tm, n_slots=2, max_text_len=MAX_TEXT, chunk=CHUNK, lazy=lazy,
                       state_quant=squant)
    texts = [[5, 9, 3, 17, 8], [12, 4, 33, 7]]
    rids = [srv.submit(np.asarray(t), max_len=11) for t in texts]
    done = {c.rid: c for c in srv.run()}
    for st in srv._state.layers + (srv._state.pos_net,):
        quant = squant is not None and st is not srv._state.pos_net
        assert st.s.dtype == (torch.int8 if quant else torch.bfloat16)
        assert (st.s_scale is not None) == quant
        if quant:
            assert st.s_scale.dtype == torch.float32 and bool(st.s.any())
        for name in ("conv_q", "conv_k", "conv_v") + (("kbuf", "vbuf") if lazy else ()):
            assert getattr(st, name).dtype == torch.bfloat16, name
        if lazy:
            assert st.cbuf.dtype == st.cc.dtype == torch.float32
    for rid, text in zip(rids, texts):
        ref = generate_batch(tm, torch.tensor([text]), max_seqlen=11, k=1,
                             force_max_seqlen=True, lazy_window=CHUNK if lazy else 0,
                             state_quant=squant)
        np.testing.assert_array_equal(done[rid].tokens,
                                      ref.tokens[:, 0, :].T.numpy()[:done[rid].length])


def test_rotary_backbone_serves_with_per_slot_time_steps():
    """The non-blind backbone: rotary query positions follow each slot's
    own time step (slots sit at different positions after recycling)."""
    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, blind=False, rotary=True, use_short_conv=True))
    tm = torch_build(cfg, device="cpu", seed=5).eval()
    srv = DecodeServer(tm, n_slots=2, max_text_len=MAX_TEXT, chunk=CHUNK)
    assert not srv._pos_needs_valid
    prompts = _prompts(cfg.n_quant)
    for c, (text, p_len, max_len), prm in zip(_serve(srv, prompts), REQUESTS, prompts):
        ref = generate_batch(
            tm, torch.tensor([text]),
            prompt=None if prm is None else torch.from_numpy(prm)[:, None, :],
            max_seqlen=max(max_len, p_len + 1), k=1, force_max_seqlen=True)
        np.testing.assert_array_equal(c.tokens, ref.tokens[:, 0, :].T.numpy()[:c.length])


@pytest.mark.parametrize("n,chunks", [(1, [1]), (13, [8, 4, 1]), (151, [128, 16, 4, 2, 1]),
                                      (64, [64])])
def test_pow2_chunks(n, chunks):
    assert _pow2_chunks(n) == chunks


def test_batch_axis():
    assert _batch_axis((4, 8, 64), (4, 1, 64), 8) == 1      # conv ring (w, b, dim)
    assert _batch_axis((8, 2, 16, 32), (1, 2, 16, 32), 8) == 0
    assert _batch_axis((4, 4, 2, 16), (4, 1, 2, 16), 4) == 1  # window == n_slots
    with pytest.raises(ValueError):
        _batch_axis((8, 3), (1, 4), 8)


@pytest.mark.parametrize("kw", [{"weight_quant": "int4"}, {"state_quant": "int4", "lazy": True},
                                {"cfg_coef": 1.5}, {"mesh": object()}],
                         ids=lambda kw: next(iter(kw)))
def test_unported_server_options_raise(kw):
    """int8 weights and int8 and int4 states are ported
    (tests/test_torch_quant.py, tests/test_torch_int4.py): an int4 lazy
    server runs. A mesh is not ported, and there is no int4 weight. CFG is
    ported (tests/test_torch_cfg.py) and raises ValueError here, as the JAX
    server does, because this model has no mask token (mask_text_p 0)."""
    tm = torch_build(torch_tiny(), device="cpu")
    if kw.get("state_quant") == "int4":
        srv = DecodeServer(tm, n_slots=2, chunk=4, **kw)
        srv.submit(np.asarray([5, 9, 3, 17, 8]), max_len=6)
        (c,) = srv.run()
        assert 1 <= c.length <= 6 and srv._state.layers[0].s.dtype == torch.int8
        return
    error = ValueError if {"weight_quant", "cfg_coef"} & set(kw) else NotImplementedError
    with pytest.raises(error):
        DecodeServer(tm, n_slots=2, **kw)


def test_build_model_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        model = torch_build(torch_tiny())
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            torch_build(torch_tiny())
