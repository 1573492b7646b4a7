"""The port's softmax-transformer backbone and speaker encoder vs the JAX
package, on the CPU.

``lina_gla_tiny`` with ``kind="transformer"`` (2 blocks at d 64, 2 heads,
the cross-attention after block 1, KV buffers of 2,048 positions) and the
tiny GLA model with a small ``SimpleSpeakerEncoder``; each JAX model is
initialized by JAX and its params cross into the port through
``utils/convert.py``; inputs are numpy arrays from a seed. Both sides
compute in f32 and differ only in summation order: every output within 1e-4
of its own max|reference| (3e-4 where a decode loop or a chunked prefill is
held against a one-shot prefill, as tests/test_variants.py), gradients
within 1e-4 of each leaf's max plus 1e-7 (the leaves that are zero in exact
arithmetic, such as a softmax key's bias, are held to that), the KV clocks
exactly, greedy tokens token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu.config import SpeakerEncoderConfig as JaxSpkConfig
from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.generate import generate_batch as jax_generate
from lina_speech_tpu.serving import DecodeServer as JaxServer
from lina_speech_tpu.train import harness as jharness
from lina_speech_tpu_torch.config import SpeakerEncoderConfig
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.data import synthetic
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.encoder import SimpleSpeakerEncoder
from lina_speech_tpu_torch.models.transformer import KVState, TransformerCrossAtt
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.train import harness
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, load_jax_params, named_tensors_to_jax,
)
from test_torch_model import _train_batch

TOL = 1e-4
TOL_LOOP = 3e-4
SPK = dict(dim_inner=32, heads=2, n_layers=2, window_length=8)
MODELS = {
    "transformer": (dict(kind="transformer"), {}),
    "spk": ({}, dict(spk_encoder=SPK)),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(base, name, spk_cls):
    backbone, top = MODELS[name]
    top = {k: spk_cls(**v) for k, v in top.items()}
    return dataclasses.replace(base, backbone=dataclasses.replace(base.backbone, **backbone),
                               **top)


_PAIRS = {}


def _pair(name):
    """(jax model, jax params, port model with the same weights), once per
    model and module."""
    if name not in _PAIRS:
        jm = jax_build(_cfg(lina_gla_tiny(), name, JaxSpkConfig))
        b, m, n = 2, 7, 9
        params = jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32), jnp.ones((b, n, 1), jnp.int32),
            jnp.ones((b, m, m), bool), jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
        tm = load_jax_params(torch_build(_cfg(torch_tiny(), name, SpeakerEncoderConfig),
                                         device="cpu"), params)
        _PAIRS[name] = (jm, params, tm.eval())
    return _PAIRS[name]


def _close(t, j, tol=TOL):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    err, ref = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert ref > 0 and err <= tol * ref, (err, ref)


def _jax_state_arrays(state):
    """A JAX TransformerState -> {"layers/i/k": array, ...}, as the port's
    ``backbone_state_to_arrays`` names them."""
    return {f"layers/{i}/{f.name}": np.asarray(getattr(st, f.name), np.float32)
            for i, st in enumerate(state.layers) for f in dataclasses.fields(st)}


def _hold_states(got, ref, tol):
    """KV buffers within ``tol`` of their own max (the rows past the clock
    zero on both sides), the clocks equal."""
    got, ref = backbone_state_to_arrays(got), _jax_state_arrays(ref)
    assert set(got) == set(ref) and any(k.endswith("/t") for k in ref)
    for key in ref:
        if key.endswith("/t"):
            assert got[key] == ref[key], key
        else:
            t = int(ref[key.rsplit("/", 1)[0] + "/t"])
            _close(got[key][:, :, :t], ref[key][:, :, :t], tol)
            assert not got[key][:, :, t:].any() and not ref[key][:, :, t:].any(), key


def _text_codes(seed, n=10):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, n))


# -------------------------------------------------------------- the models
@pytest.mark.parametrize("name", list(MODELS))
def test_build_matches_jax_parameter_for_parameter(name):
    """build_model builds the JAX structure: every JAX param has its port
    parameter of the same shape and values, and back (strict loading): the
    blocks' ``tmix.qkv``, ``cross_att_0``, the speaker encoder's ``sa.<i>``,
    ``in_proj`` and ``out_proj``."""
    _, params, tm = _pair(name)
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    got = named_tensors_to_jax(tm.named_parameters())
    assert set(got) == set(flat)
    for path, val in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(val), err_msg=path)
    if name == "transformer":
        rnn = tm.attentive_rnn
        assert isinstance(rnn, TransformerCrossAtt) and rnn.cross_att_layers == (1,)
        assert rnn.cross_att_0.heads == 2 and rnn.cross_att_0.rotary and rnn.max_seqlen == 2048
    else:
        assert isinstance(tm.spk_encoder, SimpleSpeakerEncoder) and len(tm.spk_encoder.sa) == 2


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_logits_loss_and_gradients_match_jax(name):
    """The training forward on a padded batch with a logits_mask (the
    speaker encoder replacing the first audio embedding): logits, loss and
    the gradient of every parameter by name against jax.value_and_grad."""
    jm, params, tm = _pair(name)
    batch = _train_batch("padded")
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")

    def loss_fn(p):
        logits, loss, _ = jm.apply(p, *(jnp.asarray(batch[k]) for k in keys),
                                   logits_mask=jnp.asarray(batch["y_mask"]))
        return loss, logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    logits, loss, _ = tm(*(tb[k] for k in keys), logits_mask=tb["y_mask"])
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    loss.backward()
    got = named_tensors_to_jax({n: p.grad for n, p in tm.named_parameters()})
    ref = traverse_util.flatten_dict(jgrads["params"], sep="/")
    assert set(got) == set(ref)
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        err = float(np.abs(got[path] - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (path, err, float(np.abs(r).max()))
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("window_start", [0, 3, 10])
def test_speaker_encoder_matches_jax(window_start):
    """SimpleSpeakerEncoder alone on 12 frames with a window of 8: the
    window from ``window_start`` (10 is clamped to 4, as JAX's
    dynamic_slice_in_dim clamps) pooled to one vector."""
    jm, params, tm = _pair("spk")
    e = np.random.default_rng(window_start).normal(size=(2, 12, 64)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(e),
                    method=lambda m, x: m.spk_encoder(x, window_start=window_start))
    with torch.no_grad():
        got = tm.spk_encoder(torch.from_numpy(e), window_start=window_start)
    _close(got, want)
    if window_start == 10:
        with torch.no_grad():
            assert torch.equal(got, tm.spk_encoder(torch.from_numpy(e), window_start=4))


def test_prefill_decode_and_states_match_jax():
    """Prefill logits and KV caches against the JAX prefill; one decode step
    from that state against JAX's (the cross-attention at the KV clock, not
    at ``time_step``); the JAX state crosses into the port and steps the
    same; the port's token-by-token decode from an empty state against its
    own prefill (tests/test_variants.py's parity)."""
    jm, params, tm = _pair("transformer")
    text, codes = _text_codes(6)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        logits, _, st = m.prefill(y[:, :-1], x_enc, m.empty_state(text.shape[0]))
        logits_t, _, st_t = m.decode_step(y[:, -1], x_enc, st, time_step=3)
        return logits, st, logits_t, st_t

    jl, jst, jl_t, jst_t = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=jrun))(
        params, jnp.asarray(text), jnp.asarray(codes))
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        tl, _, st = tm.prefill(y[:, :-1], x_enc, tm.empty_state(2))
        _close(tl, jl)
        _hold_states(st, jst, TOL)
        assert isinstance(st.layers[0], KVState) and st.layers[0].t == 9
        tl_t, _, st_t = tm.decode_step(y[:, -1], x_enc, st, time_step=3)
        _close(tl_t, jl_t)
        _hold_states(st_t, jst_t, TOL)
        tl_j, _, _ = tm.decode_step(y[:, -1], x_enc, backbone_state_from_arrays(jst), time_step=3)
        _close(tl_j, jl_t)
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, steps = tm.empty_state(2), []
        for t in range(y.shape[1]):
            lg, _, st = tm.decode_step(y[:, t], x_enc, st, time_step=t)
            steps.append(lg)
    _close(torch.stack(steps, 1), full.numpy(), TOL_LOOP)
    for key, a in backbone_state_to_arrays(st_full).items():
        np.testing.assert_allclose(backbone_state_to_arrays(st)[key], a, rtol=TOL_LOOP,
                                   atol=TOL_LOOP, err_msg=key)


def test_chunked_prefill_matches_one_shot_and_jax():
    """A prefill as [8, 4, 1] chunks (from the second on ``conv_history``:
    the chunk continues the KV buffers at ``t``, with ``time_offset``)
    equals the one-shot prefill, logits and KV caches, and the JAX package
    run over the same chunks (tests/test_variants.py:146)."""
    jm, params, tm = _pair("transformer")
    text, codes = _text_codes(7, n=13)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        st, off, outs = m.empty_state(text.shape[0]), 0, []
        for i, c in enumerate([8, 4, 1]):
            lg, _, st = m.prefill(y[:, off:off + c], x_enc, st, conv_history=i > 0,
                                  time_offset=off)
            outs.append(lg)
            off += c
        return jnp.concatenate(outs, axis=1), st

    jl, jst = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=jrun))(
        params, jnp.asarray(text), jnp.asarray(codes))
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, off, outs = tm.empty_state(2), 0, []
        for i, c in enumerate([8, 4, 1]):
            lg, _, st = tm.prefill(y[:, off:off + c], x_enc, st, conv_history=i > 0,
                                   time_offset=off)
            outs.append(lg)
            off += c
    chunked = torch.cat(outs, 1)
    _close(chunked, jl)
    _close(chunked, full.numpy(), TOL_LOOP)
    _hold_states(st, jst, TOL)
    for key, a in backbone_state_to_arrays(st_full).items():
        np.testing.assert_allclose(backbone_state_to_arrays(st)[key], a, rtol=TOL_LOOP,
                                   atol=TOL_LOOP, err_msg=key)


# ------------------------------------------------------------- generation
@pytest.mark.parametrize("name,quant", [("transformer", False), ("transformer", True),
                                        ("spk", False)])
def test_greedy_generate_matches_jax(name, quant):
    """Greedy generate_batch with a prompt, token for token against the JAX
    package: the transformer on float weights and on int8 copies (``qkv``,
    the cross-attention's projections and the FFN as JAX's QDense, with
    ``quant_min_size`` lowered so that the tiny widths qualify), and the GLA
    model whose speaker encoder replaces the prompt's first embedding."""
    jm, params, tm = _pair(name)
    rng = np.random.default_rng(3)
    x = rng.integers(3, 256, size=(2, 8))
    prompt = rng.integers(0, 50, size=(1, 2, 9))
    kw = dict(max_seqlen=20, first_greedy_quant=0, force_max_seqlen=True)
    if quant:
        kw.update(weight_quant="int8", quant_min_size=1 << 8)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    if quant:
        blk = tm.attentive_rnn.blocks[0]
        assert blk.tmix.qkv.int8_q is not None and blk.cmix.p_in.int8_q is not None
    if name == "spk":  # the speaker vector does reach the tokens
        tm.spk_encoder, held = None, tm.spk_encoder
        try:
            plain = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt),
                                   **kw)
        finally:
            tm.spk_encoder = held
        assert not torch.equal(plain.tokens, tres.tokens)


def test_train_step_matches_jax():
    """One optimizer step of make_train_step on the transformer against the
    JAX step: loss, grad_norm and acc_0 within 1e-4 relative, and every
    parameter after the step within 1e-4 of its own max|ref| plus 1e-3 of
    the learning rate (tests/test_torch_train.py's bound); the softmax
    key-side biases, whose gradient is zero in exact arithmetic where no
    rotation reaches them, to the learning rate."""
    jm, params, tm = _pair("transformer")
    cfg = dict(learning_rate=5e-4, n_warmup_steps=1, n_training_steps=10)
    lr = 5e-4
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = next(synthetic.synthetic_tts_batches(
        batch_size=2, n_quant=1, n_codebook=50, min_audio_len=8, max_audio_len=14,
        pad_to_multiple=8, seed=0, structured=True))
    jstate = jharness.create_train_state(jm, params, jharness.TrainConfig(**cfg))
    jstate, jmet = jharness.make_train_step(jm, donate=False)(jstate, batch,
                                                              jax.random.PRNGKey(0))
    tstate = harness.create_train_state(tm, harness.TrainConfig(**cfg))
    try:
        tstate, tmet = harness.make_train_step(tm)(tstate, harness.batch_to_device(batch, "cpu"))
        for k in ("loss", "grad_norm", "acc_0"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
        got = named_tensors_to_jax(tm.named_parameters())
        ref = traverse_util.flatten_dict(jstate.params["params"], sep="/")
        assert set(got) == set(ref)
        for path, r in ref.items():
            r = np.asarray(r, np.float32)
            err = np.abs(got[path] - r)
            noise = np.zeros(r.shape, bool)
            if path.endswith("ln_k/bias"):
                noise[:] = True
            elif path.endswith("qkv/bias"):
                noise[r.shape[0] // 3:2 * r.shape[0] // 3] = True
            assert float(err[noise].max(initial=0.0)) <= lr * 1.001, path
            if not noise.all():
                tol = 1e-4 * float(np.abs(r[~noise]).max()) + 1e-3 * lr
                assert float(err[~noise].max()) <= tol, (path, float(err[~noise].max()), tol)
    finally:
        tm.load_state_dict({**tm.state_dict(), **start})
        tm.eval()


def test_transformer_refuses_the_server_and_the_lazy_window():
    """As in the JAX package: DecodeServer raises ValueError for a state with
    a clock the batch shares (the KV cache), JAX's server too; the lazy
    window has no meaning for a KV cache (TypeError from generate_batch,
    NotImplementedError from the backbone's step)."""
    jm, params, tm = _pair("transformer")
    with pytest.raises(ValueError, match="per-slot state"):
        DecodeServer(tm, n_slots=2, max_text_len=8, chunk=4)
    with pytest.raises(ValueError, match="per-slot state"):
        JaxServer(jm, params, n_slots=2, max_text_len=8, chunk=4)
    x = torch.randint(3, 256, (1, 5), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="KVState"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="KV cache"):
        tm.decode_step(torch.zeros(1, 64), tm.encode_text(x), tm.empty_state(1), lazy_p=0)
