"""Classifier-free guidance in the port vs the JAX package, on the CPU.

The tiny config in the flagship's architecture (ConvPos blind
cross-attention, short convs) trained with ``mask_text_p=0.1``, so that the
text vocabulary has its mask token; weights initialized by JAX and carried
across through ``utils/convert.py``. Greedy decoding: ``cfg_coef=1`` gives
the unguided tokens exactly, and a guided run gives the JAX package's
tokens token for token -- classic, in lazy windows, from a tuned initial
state, on int8 weights and int8 lazy states, through the server and through
the TTS pipeline on the tiny codec (waveforms within 1e-4 of their own
max, as tests/test_torch_pipeline.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.codec.wavtokenizer import WavTokenizer as JaxWavTokenizer
from lina_speech_tpu.codec.wavtokenizer import WavTokenizerConfig as JaxCodecConfig
from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.data.tokenizer import TextTokenizer as JaxTextTokenizer
from lina_speech_tpu.generate import generate_batch as jax_generate
from lina_speech_tpu.pipeline import TTSPipeline as JaxTTSPipeline
from lina_speech_tpu.serving import DecodeServer as JaxServer
from lina_speech_tpu_torch.codec.wavtokenizer import (
    WavTokenizerConfig, build_wavtokenizer, vocode_streaming,
)
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.pipeline import TTSPipeline, undelay_stream
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils import convert

TOL = 1e-4
TOL_WAVE = 1e-4
TINY_CODEC = dict(ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
                  backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8)
GREEDY = dict(max_seqlen=16, first_greedy_quant=0, force_max_seqlen=True)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _masked(cfg, **top):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, pos_type="convolutional", use_short_conv=True), mask_text_p=0.1, **top)


@functools.lru_cache(maxsize=None)
def _pair():
    """(jax model, jax params, port model with the same weights)."""
    jm = jax_build(_masked(lina_gla_tiny()))
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(2), jnp.ones((1, 10), jnp.int32), jnp.ones((1, 8, 1), jnp.int32),
        jnp.ones((1, 10, 10), bool), jnp.ones((1, 8, 10), bool), jnp.ones((1, 8), bool))
    tm = convert.load_jax_params(torch_build(_masked(torch_tiny()), device="cpu"), params)
    return jm, params, tm.eval()


def _inputs(seed=3, b=2, prompt_len=5):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=(b, 8)), rng.integers(0, 50, size=(1, b, prompt_len))


def _both(x, prompt, init=None, jinit=None, **kw):
    """(port result, JAX result) of greedy generate_batch on the same inputs."""
    jm, params, tm = _pair()
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), init_state=jinit, **GREEDY, **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt),
                          init_state=init, **GREEDY, **kw)
    return tres, jres


@pytest.mark.parametrize("prompt_len", [0, 5])
def test_cfg_coef_one_is_exactly_unguided(prompt_len):
    """cfg_coef=1 reduces to the conditional logits, so the doubled batch
    gives the unguided run's tokens exactly (tests/test_generate.py:120);
    a real coefficient moves some token."""
    _, _, tm = _pair()
    x, prompt = _inputs(prompt_len=max(prompt_len, 1))
    prompt = torch.from_numpy(prompt) if prompt_len else None
    x = torch.from_numpy(x)
    r0 = generate_batch(tm, x, prompt=prompt, **GREEDY)
    r1 = generate_batch(tm, x, prompt=prompt, cfg_coef=1.0, **GREEDY)
    r3 = generate_batch(tm, x, prompt=prompt, cfg_coef=3.0, **GREEDY)
    assert torch.equal(r0.tokens, r1.tokens) and torch.equal(r0.lengths, r1.lengths)
    assert r3.tokens.shape == r0.tokens.shape and not torch.equal(r3.tokens, r0.tokens)


@pytest.mark.parametrize("mode", ["classic", "lazy", "int8"])
def test_cfg_tokens_match_jax(mode):
    """cfg_coef=2.5 with a prompt, token for token against the JAX package:
    the classic loop (with the conditional rows' attention maps), lazy
    windows of 4, and int8 weights with int8 lazy-window states."""
    kw = dict(cfg_coef=2.5)
    if mode == "classic":
        kw.update(return_att=True)
    elif mode == "lazy":
        kw.update(lazy_window=4)
    else:
        kw.update(lazy_window=4, weight_quant="int8", quant_min_size=256, state_quant="int8")
    x, prompt = _inputs()
    tres, jres = _both(x, prompt, **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    if mode == "classic":
        assert tres.att.shape == jres.att.shape == (2, 16, 2, 8)
        err = float(np.abs(tres.att.numpy() - np.asarray(jres.att)).max())
        assert err <= TOL * float(np.abs(np.asarray(jres.att)).max()), err


def test_cfg_composes_with_lazy_window():
    """CFG tiles the state before the lazy buffers attach: windows of 4
    give the classic guided run's tokens (tests/test_generate.py:168)."""
    _, _, tm = _pair()
    x, prompt = (torch.from_numpy(a) for a in _inputs(seed=4))
    classic = generate_batch(tm, x, prompt=prompt, cfg_coef=2.5, **GREEDY)
    lazy = generate_batch(tm, x, prompt=prompt, cfg_coef=2.5, lazy_window=4, **GREEDY)
    assert torch.equal(classic.tokens, lazy.tokens)


def test_cfg_from_a_tuned_initial_state_matches_jax():
    """A given ``init_state`` (as S0 tuning gives one: recurrent states off
    zero in every layer and the pos_net) is tiled along each leaf's batch
    axis, the time-major conv rings' axis 1 included: the same tokens as
    the JAX package from the same state."""
    jm, params, _ = _pair()
    rng = np.random.default_rng(8)
    jst = jm.apply(params, method=lambda m: m.empty_state(2))
    nudge = lambda st: st.replace(s=jnp.asarray(rng.normal(size=st.s.shape), jnp.float32),
                                  conv_k=jnp.asarray(rng.normal(size=st.conv_k.shape),
                                                     jnp.float32))
    jst = jst.replace(layers=tuple(nudge(st) for st in jst.layers), pos_net=nudge(jst.pos_net))
    x, prompt = _inputs(seed=5)
    tres, jres = _both(x, prompt, init=convert.backbone_state_from_arrays(jst), jinit=jst,
                       cfg_coef=2.5)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    plain = generate_batch(_pair()[2], torch.from_numpy(x), prompt=torch.from_numpy(prompt),
                           cfg_coef=2.5, **GREEDY)
    assert not torch.equal(plain.tokens, tres.tokens)


def test_cfg_requires_mask_token():
    """Without the mask token (mask_text_p == 0) cfg_coef raises
    ValueError in generate_batch and in the server, as in the JAX
    package."""
    tm = torch_build(torch_tiny(), device="cpu")
    x = torch.randint(3, 256, (1, 6), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mask_text_p"):
        generate_batch(tm, x, max_seqlen=4, cfg_coef=2.0)
    with pytest.raises(ValueError, match="mask_text_p"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, cfg_coef=2.0)


REQUESTS = [([5, 9, 3, 17, 8], 0, 14), ([12, 4, 33], 6, 13), ([40, 41, 42, 7], 2, 11)]


@pytest.mark.parametrize("lazy", [False, True], ids=["classic", "lazy"])
def test_server_cfg_matches_generate_and_jax(lazy):
    """DecodeServer(cfg_coef=2.5), two slots (four device rows) recycled by
    three requests of mixed text and prompt lengths: each completion equals
    the request's own guided generate_batch, and (classic) the JAX server's
    completion, token for token (tests/test_serving.py:292)."""
    jm, params, tm = _pair()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 50, size=(1, p)) if p else None for _, p, _ in REQUESTS]

    def serve(srv):
        rids = [srv.submit(np.asarray(t), prompt=p, max_len=n)
                for (t, _, n), p in zip(REQUESTS, prompts)]
        done = {c.rid: c for c in srv.run()}
        return [done[r] for r in rids]

    kw = dict(n_slots=2, max_text_len=12, chunk=4, cfg_coef=2.5)
    done = serve(DecodeServer(tm, lazy=lazy, **kw))
    for c, (text, _, max_len), prompt in zip(done, REQUESTS, prompts):
        ref = generate_batch(tm, torch.tensor([text]),
                             prompt=None if prompt is None else torch.from_numpy(prompt)[:, None],
                             max_seqlen=max_len, k=1, force_max_seqlen=True, cfg_coef=2.5,
                             lazy_window=4 if lazy else 0)
        np.testing.assert_array_equal(c.tokens, ref.tokens[:, 0].T.numpy()[:c.length])
    if not lazy:
        for c, jc in zip(done, serve(JaxServer(jm, params, **kw))):
            assert c.length == jc.length and c.stopped == jc.stopped
            np.testing.assert_array_equal(c.tokens, jc.tokens)


@functools.lru_cache(maxsize=None)
def _pipes():
    """(port pipeline, JAX pipeline) with the same weights: the tiny model
    with its mask token (n_codebook 32) and the tiny codec."""
    model = torch_build(torch_tiny(n_codebook=32, mask_text_p=0.1), device="cpu", seed=2)
    params = {"params": convert._nest(convert.named_tensors_to_jax(model.named_parameters()))}
    wavtok = build_wavtokenizer(WavTokenizerConfig(**TINY_CODEC), device="cpu", seed=3)
    wt_params = convert.wavtokenizer_state_dict_to_jax(wavtok.state_dict())
    jax_model = jax_build(lina_gla_tiny(n_codebook=32, mask_text_p=0.1))
    jax_pipe = JaxTTSPipeline(jax_model, params, JaxWavTokenizer(JaxCodecConfig(**TINY_CODEC)),
                              wt_params, JaxTextTokenizer())
    return TTSPipeline(model, wavtok, TextTokenizer()), jax_pipe


def test_synthesize_with_cfg_matches_jax():
    """TTSPipeline.synthesize(cfg_coef=2.0), greedy, at batch 2: the JAX
    pipeline's tokens, and each waveform within TOL_WAVE of its own max."""
    pipe, jax_pipe = _pipes()
    kw = dict(max_seqlen=24, k=1, batch_size=2, cfg_coef=2.0)
    jax_waves, jax_res = jax_pipe.synthesize("hello there", jax.random.PRNGKey(4), **kw)
    waves, res = pipe.synthesize("hello there", **kw)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jax_res.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jax_res.lengths))
    assert len(waves) == len(jax_waves) == 2
    for wav, ref in zip(waves, jax_waves):
        assert wav.shape == ref.shape and wav.size > 0
        err, scale = np.abs(wav - ref).max(), np.abs(ref).max()
        assert scale > 0 and err <= TOL_WAVE * scale, (err, scale)


def test_stream_synthesize_with_cfg():
    """stream_synthesize(cfg_coef=2.0): the one-slot guided server's
    completion has the guided generate_batch tokens of the request, and the
    chunks, concatenated, equal ``vocode_streaming`` on its final codes."""
    pipe, _ = _pipes()
    gen = pipe.stream_synthesize("hello there", max_seqlen=24, k=1, window=4, context=2,
                                 chunk=4, cfg_coef=2.0)
    chunks = []
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            done = stop.value
            break
    ids = torch.tensor([pipe.tokenizer.encode("hello there")])
    ref = generate_batch(pipe.model, ids, max_seqlen=24, k=1, force_max_seqlen=True,
                         cfg_coef=2.0)
    np.testing.assert_array_equal(done.tokens, ref.tokens[:, 0].T.numpy()[:done.length])
    codes = undelay_stream(done.tokens, 1, stopped=done.stopped)
    want = torch.cat(list(vocode_streaming(pipe.wavtok, torch.from_numpy(codes)[:, None],
                                           window=4, context=2)), dim=-1)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=-1), want.numpy())
