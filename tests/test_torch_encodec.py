"""The port's compression stack (``codec/encodec.py``, ``codec/lm.py``)
against the JAX package's, on the CPU.

Sizes are the JAX tests' (tests/test_encodec_segmented.py,
tests/test_lm_compress.py): ``EncodecModel(dimension=16, n_filters=2,
ratios=(4, 2), n_q=2, bins=17)`` and ``EncodecLM(n_q=2, card=17, dim=32,
heads=4)``. JAX's weights are drawn by ``init`` and carried into the port by
``utils/convert.py``'s EnCodec and LM bridges. Codes are held equal and the
container header byte for byte; waveforms, scales and LM probabilities to
``TOL`` of their own max|ref| (f32 on both sides).

A blob is only as portable as its pdfs (README.md, the port's section): the
quantized cdfs change when an f32 pdf moves by an ulp. So the cross-package
bitstream tests inject one side's probabilities into the other side's coder
path, and the share of steps whose cdfs differ when each package uses its
own pdfs is printed, not asserted.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.codec import ac as jax_ac
from lina_speech_tpu.codec import encodec as jax_encodec
from lina_speech_tpu.codec import lm as jax_lm
from lina_speech_tpu_torch.codec import ac, encodec, lm
from lina_speech_tpu_torch.utils import convert

TOL = 1e-5
TINY = dict(dimension=16, n_filters=2, ratios=(4, 2), n_q=2, bins=17)


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


def perturb_biases(params, seed):
    """JAX params with every 1-D leaf (biases, norm scales) moved off its
    constant init, so the bridges carry something there."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32) if a.ndim == 1 else a,
        params)


def codec_pair(residual, seed=0):
    """(JAX model, JAX params, port model) with the same weights."""
    jm = jax_encodec.EncodecModel(residual=residual, **TINY)
    params = perturb_biases(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 160))), seed)
    port = encodec.EncodecModel(residual=residual, **TINY)
    port.load_state_dict(convert.encodec_state_dict_from_jax(params), strict=True)
    return jm, params, port.eval()


def use_coders(m, native):
    """Route ``codec/lm.py``'s coder pair to the native one (the default)
    or to the Python one, through the monkeypatch context ``m``."""
    m.setattr(lm, "make_coder", lambda: ac.make_coder(native))
    m.setattr(lm, "make_decoder", lambda data: ac.make_decoder(data, native))


def lm_pair(n_layers=1, past_context=8, card=17, n_q=2, seed=3):
    kw = dict(n_q=n_q, card=card, dim=32, heads=4, n_layers=n_layers, past_context=past_context)
    jm = jax_lm.EncodecLM(**kw)
    params = perturb_biases(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, n_q, 4), jnp.int32)),
                            seed)
    port = lm.EncodecLM(**kw)
    port.load_state_dict(convert.encodec_lm_state_dict_from_jax(params), strict=True)
    return jm, params, port.eval()


def audio(t, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(1, t)) * scale).astype(np.float32)


# ------------------------------------------------------------------ bridges
@pytest.mark.parametrize("residual", [False, True])
def test_encodec_bridge_round_trips(residual):
    jm, params, port = codec_pair(residual)
    back = convert.encodec_state_dict_to_jax(port.state_dict())
    flat, want = convert._flatten(back), convert._flatten(params)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    again = convert.encodec_state_dict_from_jax(back)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())


@pytest.mark.parametrize("n_layers", [1, 2])
def test_lm_bridge_round_trips(n_layers):
    jm, params, port = lm_pair(n_layers)
    back = convert.encodec_lm_state_dict_to_jax(port.state_dict())
    flat, want = convert._flatten(back), convert._flatten(params)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    again = convert.encodec_lm_state_dict_from_jax(back)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())


def test_bridges_raise_on_unknown_or_missing_leaves():
    _, params, _ = lm_pair()
    extra = {"params": {**params["params"], "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError):
        convert.encodec_lm_state_dict_from_jax(extra)
    inner = dict(params["params"])
    inner["transformer"] = {k: v for k, v in inner["transformer"].items() if k != "norm_out"}
    with pytest.raises(KeyError):
        convert.encodec_lm_state_dict_from_jax({"params": inner})
    _, cparams, port = codec_pair(False)
    sd = dict(port.state_dict())
    sd.pop("decoder.model.0.conv.conv.bias")
    with pytest.raises(KeyError):
        convert.encodec_state_dict_to_jax(sd)


def test_build_functions_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encodec.build_encodec_model(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.build_encodec_lm(2, 17)
    assert lm.build_encodec_lm(2, 17, device="cpu", dim=32, heads=4).device.type == "cpu"


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("t", [160, 163])
def test_encode_decode_equal_jax(residual, t):
    """Codes equal, the waveform of the same codes within TOL."""
    jm, params, port = codec_pair(residual)
    x = audio(t, 1)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), method=jax_encodec.EncodecModel.encode))
    with torch.no_grad():
        codes = port.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(codes.numpy(), ref)
        wav = port.decode(codes)
    held(wav.numpy(), np.asarray(jm.apply(params, jnp.asarray(ref),
                                          method=jax_encodec.EncodecModel.decode)))
    assert port.hop_length == jm.hop_length == 8


@pytest.mark.parametrize("overlap,normalize,t", [(0.0, False, 420), (0.01, True, 420),
                                                 (0.5, True, 320), (0.0, True, 250)])
def test_segmented_equal_jax(overlap, normalize, t):
    """encode_segmented: codes equal, scales within 1e-6; decode_segmented of
    the same frames within TOL."""
    jm, params, port = codec_pair(True)
    x = audio(t, 2, 0.3)
    ref = jax_encodec.encode_segmented(jm, params, jnp.asarray(x), 160, overlap, normalize)
    got = encodec.encode_segmented(port, torch.from_numpy(x), 160, overlap, normalize)
    assert len(got) == len(ref)
    for (c, s), (rc, rs) in zip(got, ref):
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        if normalize:
            np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
        else:
            assert s is None and rs is None
    wav = encodec.decode_segmented(port, got, 160, overlap, normalize)
    held(wav.numpy(), np.asarray(jax_encodec.decode_segmented(jm, params, ref, 160, overlap,
                                                              normalize)))


@pytest.mark.parametrize("lengths,stride", [((8, 8), 4), ((10, 10, 7), 6), ((5,), 5),
                                            ((12, 12, 3), 11)])
def test_linear_overlap_add_equals_jax(lengths, stride):
    rng = np.random.default_rng(len(lengths) + stride)
    frames = [rng.normal(size=(2, n)).astype(np.float32) for n in lengths]
    got = encodec.linear_overlap_add([torch.from_numpy(f) for f in frames], stride)
    ref = jax_encodec.linear_overlap_add([jnp.asarray(f) for f in frames], stride)
    held(got.numpy(), np.asarray(ref), 1e-6)


def test_linear_overlap_add_crossfades():
    """Two constant frames overlapping by half: flat regions pass through,
    the overlap rises monotonically from one value to the other."""
    out = encodec.linear_overlap_add([torch.full((1, 8), 2.0), torch.full((1, 8), 4.0)], 4)
    assert out.shape == (1, 12)
    np.testing.assert_allclose(out[0, 1:4].numpy(), 2.0, atol=1e-6)
    np.testing.assert_allclose(out[0, 8:-1].numpy(), 4.0, atol=1e-6)
    mid = out[0, 4:8].numpy()
    assert np.all(np.diff(mid) > 0) and mid[0] > 2.0 and mid[-1] < 4.0


def test_segmented_tail_is_padded_and_trimmed():
    """ceil(420 / 160) = 3 segments; the last, 100 valid samples zero-padded
    to 160, keeps ceil(100 / 8) = 13 code frames, and its codes are those of
    the padded segment."""
    _, _, port = codec_pair(True)
    x = torch.from_numpy(audio(420, 0))
    frames = encodec.encode_segmented(port, x, 160, overlap=0.0)
    assert [c.shape for c, _ in frames] == [(2, 1, 20), (2, 1, 20), (2, 1, 13)]
    padded = torch.nn.functional.pad(x[:, 320:], (0, 60))
    with torch.no_grad():
        np.testing.assert_array_equal(frames[-1][0].numpy(), port.encode(padded)[..., :13].numpy())
    wav = encodec.decode_segmented(port, frames, 160, overlap=0.0)
    assert wav.shape == (1, 2 * 160 + 13 * 8)


def test_loudness_normalization_scale_invariance():
    """normalize=True: codes do not change with the loudness, and the scale
    brings the amplitude back on decode (2.0 / 0.05 = 40x)."""
    _, _, port = codec_pair(True)
    base = audio(160, 2)
    quiet, loud = (torch.from_numpy(base * s) for s in (0.05, 2.0))
    f_quiet = encodec.encode_segmented(port, quiet, 160, 0.0, normalize=True)
    f_loud = encodec.encode_segmented(port, loud, 160, 0.0, normalize=True)
    assert torch.equal(f_quiet[0][0], f_loud[0][0])
    w_quiet = encodec.decode_segmented(port, f_quiet, 160, 0.0, normalize=True)
    w_loud = encodec.decode_segmented(port, f_loud, 160, 0.0, normalize=True)
    assert 30.0 < float(w_loud.abs().mean() / w_quiet.abs().mean().clamp(min=1e-9)) < 50.0


def test_loudness_scale_uses_valid_samples_only():
    """The final segment's scale is the RMS over its 90 valid samples, not
    diluted by the zero padding."""
    _, _, port = codec_pair(True)
    x = audio(250, 5)
    frames = encodec.encode_segmented(port, torch.from_numpy(x), 160, 0.0, normalize=True)
    want = np.sqrt(np.mean(x[0, 160:250].astype(np.float64) ** 2)) + 1e-8
    np.testing.assert_allclose(float(frames[1][1][0, 0]), want, rtol=1e-5)


# ----------------------------------------------------------------------- LM
def jax_step_probs(jm, params, codes):
    """JAX's per-step probabilities (T, K, card) while ``codes`` are fed back
    one token a call through its own single-step function."""
    step = jax_lm._step_fn(jm)
    states, offset = jax_lm._init_stream(jm)
    tok = jnp.zeros((1, codes.shape[0], 1), jnp.int32)
    out = []
    for t in range(codes.shape[1]):
        probs, states, offset = step(params, tok, states, offset)
        out.append(np.asarray(probs[0, :, 0], np.float64))
        tok = jnp.asarray(codes[:, t], jnp.int32)[None, :, None] + 1
    return np.stack(out)


@pytest.mark.parametrize("n_layers,past_context,t", [(1, 8, 6), (2, 16, 6), (2, 4, 11)])
def test_lm_probs_and_rings_equal_jax(n_layers, past_context, t):
    """The whole sequence and the same sequence step by step: probabilities
    and KV rings within TOL of JAX's; the rows sum to 1."""
    jm, params, port = lm_pair(n_layers, past_context)
    x = np.random.default_rng(t).integers(0, 18, (1, 2, t))
    ref, ref_states, _ = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        probs, states, off = port(torch.from_numpy(x))
    held(probs.numpy(), np.asarray(ref))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    for (k, v), (rk, rv) in zip(states, ref_states):
        held(k.numpy(), np.asarray(rk))
        held(v.numpy(), np.asarray(rv))
    assert off == t
    codes = x[0, :, 1:] - 1  # the shifted ids as codes, the last one unused
    codes = np.concatenate([np.clip(codes, 0, 16), np.zeros((2, 1), np.int64)], 1)
    got = lm.lm_pdfs(port, codes)
    held(got, jax_step_probs(jm, params, codes))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("n_q,card,t", [(2, 17, 20), (3, 32, 40)])
def test_compress_decompress_round_trip(monkeypatch, native, n_q, card, t):
    """Codes back through either decoder, equal bytes from either coder, and
    the stream within a few bytes of the codes' cross-entropy under the
    LM's pdfs."""
    _, _, port = lm_pair(2, 8, card=card, n_q=n_q)
    codes = np.random.default_rng(t).integers(0, card, (n_q, t))
    with monkeypatch.context() as m:
        use_coders(m, native)
        data = lm.compress(port, codes)
    with monkeypatch.context() as m:
        use_coders(m, not native)
        np.testing.assert_array_equal(lm.decompress(port, data, n_q, t), codes)
        assert data == lm.compress(port, codes)
    pdfs = lm.lm_pdfs(port, codes)
    bits = -np.log2(np.take_along_axis(pdfs, codes.T[..., None], -1)).sum()
    assert len(data) * 8 <= bits + 16


def test_jax_blob_decodes_in_the_port_on_jax_probabilities(monkeypatch):
    """JAX's blob decodes in the port to JAX's codes when the port's step is
    fed JAX's recorded probabilities; and JAX's Python coder gives the port's
    bytes on the port's probabilities. Printed: the share of steps whose
    quantized cdfs differ when each package uses its own pdfs."""
    jm, params, port = lm_pair(2, 8, card=17, n_q=2)
    codes = np.random.default_rng(1).integers(0, 17, (2, 30))
    blob = jax_lm.compress(jm, params, codes)
    recorded = jax_step_probs(jm, params, codes)

    def replay(lm_model):
        calls = iter(recorded)

        def step(tok, states, offset):
            p = torch.from_numpy(next(calls).astype(np.float32))[None, :, None]
            return p, states, offset + 1

        return step

    with monkeypatch.context() as m:
        m.setattr(lm, "_step_fn", replay)
        np.testing.assert_array_equal(lm.decompress(port, blob, 2, 30), codes)
    with monkeypatch.context() as m:
        m.setattr(lm, "_step_fn", replay)
        use_coders(m, False)
        np.testing.assert_array_equal(lm.decompress(port, blob, 2, 30), codes)

    pdfs = lm.lm_pdfs(port, codes)
    ref = jax_ac.ArithmeticCoder()
    for t in range(codes.shape[1]):
        for k in range(codes.shape[0]):
            ref.push(int(codes[k, t]), jax_ac.build_stable_quantized_cdf(pdfs[t, k]))
    assert ref.flush() == lm.compress(port, codes)

    differ = np.mean([any(not np.array_equal(jax_ac.build_stable_quantized_cdf(a),
                                             lm.step_cdfs(b[None])[0])
                          for a, b in zip(recorded[t], pdfs[t])) for t in range(len(pdfs))])
    print(f"steps whose quantized cdfs differ, JAX's pdfs vs the port's: {differ:.3f} "
          f"of {len(pdfs)}")


# ---------------------------------------------------------------- container
def test_container_header_equals_jax():
    """For the same frames the container's header bytes are JAX's, and each
    frame record's code count and scale match; JAX's container parses."""
    jm, params, port = codec_pair(True)
    jl, lparams, plm = lm_pair()
    x = audio(420, 4)
    blob = encodec.compress_audio(port, plm, torch.from_numpy(x), 160, 0.01, normalize=True)
    ref = jax_encodec.compress_audio(jm, params, jl, lparams, jnp.asarray(x), 160, 0.01,
                                     normalize=True)
    n = 4 + struct.calcsize("<IIIBIf")
    assert blob[:n] == ref[:n] == b"LSTC" + struct.pack("<IIIBIf", 420, 160, 3, 1, 8, 0.01)
    header, frames = encodec.read_container(blob)
    ref_header, ref_frames = encodec.read_container(ref)
    assert header == ref_header
    for (tf, _, s), (rtf, _, rs) in zip(frames, ref_frames):
        assert tf == rtf
        np.testing.assert_allclose(s, rs, rtol=1e-6)


@pytest.mark.parametrize("normalize,overlap", [(True, 0.0), (False, 0.01), (True, 0.3)])
def test_compress_audio_round_trip(monkeypatch, normalize, overlap):
    """The container returns encode_segmented's codes bit for bit and
    decode_segmented's waveform (the same operations on the CPU), both at
    the overlap the header holds (an f32: 0.3 at 160 samples cuts at a
    stride of 111, where the float64 0.3 gives 112)."""
    _, _, port = codec_pair(True)
    _, _, plm = lm_pair()
    x = torch.from_numpy(audio(420, 4))
    blob = encodec.compress_audio(port, plm, x, 160, overlap, normalize)
    header, back = encodec.decompress_codes(port, plm, blob)
    overlap = header["overlap"]
    frames = encodec.encode_segmented(port, x, 160, overlap, normalize)
    assert header["length"] == 420 and len(back) == len(frames)
    for (c, s), (rc, rs) in zip(back, frames):
        assert torch.equal(c, rc)
        assert (s is None) == (rs is None) and (s is None or torch.equal(s, rs))
    with monkeypatch.context() as m:
        use_coders(m, False)
        wav = encodec.decompress_audio(port, plm, blob)
        assert encodec.compress_audio(port, plm, x, 160, overlap, normalize) == blob
    want = encodec.decode_segmented(port, frames, 160, overlap, normalize)[..., :420]
    assert wav.shape == (1, 420) and torch.equal(wav, want)


def test_decompress_rejects_a_mismatched_hop():
    _, _, port = codec_pair(True)
    _, _, plm = lm_pair()
    blob = encodec.compress_audio(port, plm, torch.from_numpy(audio(200, 6)), 160, 0.0)
    other = encodec.EncodecModel(**{**TINY, "ratios": (2, 2)})
    with pytest.raises(ValueError, match="container hop 8 != model hop 4"):
        encodec.decompress_audio(other, plm, blob)
    with pytest.raises(ValueError, match="magic"):
        encodec.decompress_audio(port, plm, b"XXXX" + blob[4:])
