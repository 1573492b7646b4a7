"""PyTorch port of the TTS pipeline vs the JAX package, on the CPU.

The JAX ``TTSPipeline`` and the port's run the tiny Lina-GLA (n_codebook 32)
and the JAX tests' tiny codec (tests/test_pipeline.py) with the same
weights, carried from the port to the JAX package by ``utils/convert.py``.
Greedy (k=1) synthesis must give the same tokens, token for token, and each
waveform within ``TOL_WAVE`` of its own max|ref|, with and without a
voice-clone prompt. Where a row is only a few frames long, the JAX codec's
f32 norms lose precision the port keeps, and there the port's waveform is
held to the JAX codec run in float64. The streaming path, the stream
helpers and the example are checked on the port alone.
"""
import dataclasses
import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.codec.wavtokenizer import WavTokenizer as JaxWavTokenizer
from lina_speech_tpu.codec.wavtokenizer import WavTokenizerConfig as JaxConfig
from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny as jax_tiny
from lina_speech_tpu.data.tokenizer import TextTokenizer as JaxTextTokenizer
from lina_speech_tpu.pipeline import TTSPipeline as JaxTTSPipeline
from lina_speech_tpu.pipeline import undelay_stream as jax_undelay_stream
from lina_speech_tpu.pipeline import write_wav as jax_write_wav
from lina_speech_tpu_torch import pipeline as pipeline_mod
from lina_speech_tpu_torch.codec.wavtokenizer import (
    WavTokenizerConfig, build_wavtokenizer, vocode_streaming,
)
from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
from lina_speech_tpu_torch.generate import GenerateResult, cut_outputs
from lina_speech_tpu_torch.pipeline import TTSPipeline, undelay_stream, write_wav
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_WAVE = 1e-4
TINY_CODEC = dict(ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
                  backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8)
PROMPT_AUDIO = np.random.default_rng(0).normal(size=(1, 64)).astype(np.float32)
STREAM = dict(max_seqlen=40, k=5, window=8, context=6, chunk=4, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def make_pipes(model_seed):
    """(port pipeline, JAX pipeline) with the same weights: the model from
    ``model_seed``, the codec from seed 3."""
    model = build_model(lina_gla_tiny(n_codebook=32), device="cpu", seed=model_seed)
    params = {"params": convert._nest(convert.named_tensors_to_jax(model.named_parameters()))}
    wavtok = build_wavtokenizer(WavTokenizerConfig(**TINY_CODEC), device="cpu", seed=3)
    wt_params = convert.wavtokenizer_state_dict_to_jax(wavtok.state_dict())
    jax_model = jax_build(dataclasses.replace(jax_tiny(), n_codebook=32))
    jax_pipe = JaxTTSPipeline(jax_model, params, JaxWavTokenizer(JaxConfig(**TINY_CODEC)),
                              wt_params, JaxTextTokenizer())
    return TTSPipeline(model, wavtok, TextTokenizer()), jax_pipe


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(2)


def greedy_pair(pipe, jax_pipe, prompt):
    """Greedy ``synthesize`` of the port and of JAX on the same text; the
    tokens, stop masks and lengths must be equal. Returns (port waves, JAX
    waves, the port's result)."""
    kw = dict(max_seqlen=24, k=1,
              prompt_audio=PROMPT_AUDIO if prompt == "audio" else None)
    jax_waves, jax_res = jax_pipe.synthesize("hello there", jax.random.PRNGKey(4), **kw)
    waves, res = pipe.synthesize("hello there", **kw)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jax_res.tokens))
    np.testing.assert_array_equal(res.stop_mask.numpy(), np.asarray(jax_res.stop_mask))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jax_res.lengths))
    assert len(waves) == len(jax_waves) == 1
    for wav, ref in zip(waves, jax_waves):
        assert wav.dtype == np.float32 and wav.shape == ref.shape and wav.size > 0
        assert wav.size % TINY_CODEC["hop_length"] == 0
    return waves, jax_waves, res


@pytest.mark.parametrize("prompt", [None, "audio"])
def test_greedy_synthesize_matches_jax(pipes, prompt):
    waves, jax_waves, _ = greedy_pair(*pipes, prompt)
    for wav, ref in zip(waves, jax_waves):
        err, scale = np.abs(wav - ref).max(), np.abs(ref).max()
        assert scale > 0 and err <= TOL_WAVE * scale, (err, scale)


def test_greedy_synthesize_of_a_short_row_is_held_to_float64():
    """The model from seed 7 decodes 3 frames after the prompt. The tiny
    codec's pos_net GroupNorm has one channel a group, so its groups hold 3
    values, and flax's variance E[x^2] - E[x]^2 cancels on them in f32 (the
    JAX package's waveform lands about 2e-3 of its max from the float64
    decode); the port takes torch's variance. The tokens still equal JAX's,
    and the port's waveform is held within ``TOL_WAVE`` to the JAX codec run
    in float64 on the same codes."""
    pipe, jax_pipe = make_pipes(7)
    waves, jax_waves, res = greedy_pair(pipe, jax_pipe, "audio")
    codes = cut_outputs(res, 1)[0][0]
    assert codes.shape == (1, 1, 3)
    codec64 = JaxWavTokenizer(JaxConfig(**TINY_CODEC), dtype=jnp.float64)
    with jax.enable_x64(True):
        params64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                convert.wavtokenizer_state_dict_to_jax(pipe.wavtok.state_dict()))
        ref = np.asarray(codec64.apply(params64, jnp.asarray(codes),
                                       method=codec64.codes_to_audio))[0]
    scale = np.abs(ref).max()
    err, jax_err = np.abs(waves[0] - ref).max(), np.abs(jax_waves[0] - ref).max()
    assert scale > 0 and err <= TOL_WAVE * scale, (err, scale)
    assert jax_err > 10 * TOL_WAVE * scale, (jax_err, scale)  # the cancellation, as stated


def test_prompt_codes_repeat_over_the_batch(pipes):
    """One row of prompt codes serves every row of the batch, and the
    clone path equals passing the prompt's codes."""
    pipe, _ = pipes
    codes = pipe.tokenize_audio(PROMPT_AUDIO)
    assert codes.shape == (1, 1, 64 // 8) and codes.dtype == torch.long
    waves, res = pipe.synthesize("hi", batch_size=2, prompt_codes=codes, max_seqlen=20, k=1)
    assert torch.equal(res.tokens[:, 0], res.tokens[:, 1])
    np.testing.assert_array_equal(waves[0], waves[1])
    clone, _ = pipe.synthesize("hi", prompt_audio=PROMPT_AUDIO, max_seqlen=20, k=1)
    np.testing.assert_array_equal(clone[0], waves[0])


def test_a_row_cut_to_nothing_gives_an_empty_wave(pipes, monkeypatch):
    pipe, _ = pipes
    n = 12
    tokens = torch.full((1, 2, n), 9, dtype=torch.long)
    tokens[:, 1, 1] = 2  # row 1 stops at its first decoded step
    stop = tokens[0] == 2

    def fake_generate(model, x, generator, **kw):
        lengths = torch.tensor([n, 2])
        return GenerateResult(tokens, stop, lengths, None, n)

    monkeypatch.setattr(pipeline_mod, "generate_batch", fake_generate)
    waves, _ = pipe.synthesize("x", batch_size=2, max_seqlen=n, k=1)
    assert waves[1].shape == (0,) and waves[1].dtype == np.float32
    assert waves[0].shape == ((n - 2) * 8,)  # undelaying drops q + 1 = 2 steps


def test_stream_synthesize_equals_vocode_streaming(pipes, monkeypatch):
    """The chunks, concatenated, equal ``vocode_streaming`` on the final
    codes of an identical server run, some come out while the server is
    still decoding, and the generator returns that run's completion."""
    pipe, _ = pipes
    calls = {"n": 0}
    run = DecodeServer.run

    def counted_run(self, max_chunks=None):
        calls["n"] += 1
        return run(self, max_chunks=max_chunks)

    monkeypatch.setattr(DecodeServer, "run", counted_run)
    yielded_at, chunks = [], []
    gen = pipe.stream_synthesize("stream me", **STREAM)
    while True:
        try:
            chunks.append(next(gen))
        except StopIteration as stop:
            returned = stop.value
            break
        yielded_at.append(calls["n"])
    monkeypatch.setattr(DecodeServer, "run", run)
    assert sum(1 for y in yielded_at if y < calls["n"]) >= 2, yielded_at
    stream = np.concatenate(chunks, axis=-1)

    srv = DecodeServer(pipe.model, n_slots=1, max_text_len=64, chunk=STREAM["chunk"],
                       k=STREAM["k"], seed=STREAM["seed"])
    rid = srv.submit(np.asarray(pipe.tokenizer.encode("stream me")),
                     max_len=STREAM["max_seqlen"])
    c = {cc.rid: cc for cc in srv.run()}[rid]
    assert (returned.length, returned.stopped) == (c.length, c.stopped)
    np.testing.assert_array_equal(returned.tokens, c.tokens)
    codes = undelay_stream(c.tokens, 1, stopped=c.stopped)
    want = torch.cat(list(vocode_streaming(pipe.wavtok, torch.from_numpy(codes)[:, None],
                                           window=STREAM["window"],
                                           context=STREAM["context"])), dim=-1)
    assert stream.shape == (1, codes.shape[1] * 8)
    np.testing.assert_array_equal(stream, want.numpy())


@pytest.mark.parametrize("stopped", [False, True])
@pytest.mark.parametrize("q", [1, 3])
def test_undelay_stream_matches_jax(q, stopped):
    rng = np.random.default_rng(q)
    for steps in (1, q, q + 1, 17):
        tokens = rng.integers(0, 40, size=(steps, q))
        want = jax_undelay_stream(tokens, q, stopped=stopped)
        got = undelay_stream(tokens, q, stopped=stopped)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_write_wav_bytes_match_jax(tmp_path):
    audio = np.concatenate([np.linspace(-1.5, 1.5, 301),
                            np.random.default_rng(1).normal(size=99)]).astype(np.float32)
    for rate in (24000, 16000):
        write_wav(str(tmp_path / "port.wav"), audio, rate)
        jax_write_wav(str(tmp_path / "jax.wav"), audio, rate)
        assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_cfg_coef_still_raises(pipes):
    """The pipelines' model was trained without text masking, so it has no
    mask token: cfg_coef reaches generate_batch and the server, which raise
    ValueError, as the JAX package does (tests/test_torch_cfg.py drives CFG
    on a model that has one)."""
    pipe, _ = pipes
    with pytest.raises(ValueError, match="mask_text_p"):
        pipe.synthesize("x", max_seqlen=8, k=1, cfg_coef=1.5)
    with pytest.raises(ValueError, match="mask_text_p"):
        next(pipe.stream_synthesize("x", max_seqlen=8, k=1, cfg_coef=1.5))


@pytest.mark.parametrize("name,argv", [
    ("synthesize_torch", ["--cpu", "--max-seqlen", "10", "--text", "hi"]),
    ("stream_torch", ["--cpu", "--max-len", "24"]),
])
def test_example_runs_on_the_cpu(name, argv, tmp_path, monkeypatch, capsys):
    out = tmp_path / "out.wav"
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv, "--out", str(out)])
    example.main()
    assert out.stat().st_size > 44
    assert "on cpu" in capsys.readouterr().out
