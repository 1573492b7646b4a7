"""PyTorch port of the WavTokenizer codec vs the JAX package, on the CPU.

The same seeded numpy inputs go through each JAX module and its port, with
the JAX weights carried across by ``utils/convert.py``'s WavTokenizer bridge
(or, for the modules outside a WavTokenizer, by their own few names). Each
tensor is held to a share of its own max|ref|: ``TOL_OP`` for single ops and
heads, ``TOL_DEEP`` through the backbone, the encoder and the waveform.
Codes are held equal. Two codecs: the JAX tests' tiny one
(tests/test_pipeline.py) and one at the flagship's widths (latent 512,
4,096 bins, backbone 768 / 2304, n_fft 1280, hop 320) with 2 ConvNeXt
layers on a few frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.codec import heads as jax_heads
from lina_speech_tpu.codec import mdct as jax_mdct
from lina_speech_tpu.codec import seanet as jax_seanet
from lina_speech_tpu.codec import vocos as jax_vocos
from lina_speech_tpu.codec import vq as jax_vq
from lina_speech_tpu.codec.spectral import istft_same as jax_istft_same
from lina_speech_tpu.codec.wavtokenizer import WavTokenizer as JaxWavTokenizer
from lina_speech_tpu.codec.wavtokenizer import WavTokenizerConfig as JaxConfig
from lina_speech_tpu.codec.wavtokenizer import vocode_streaming as jax_vocode_streaming
from lina_speech_tpu.utils.convert_wavtokenizer import convert_torch_wavtokenizer
from lina_speech_tpu_torch.codec import heads, mdct, seanet, vocos, vq
from lina_speech_tpu_torch.codec.spectral import istft_same
from lina_speech_tpu_torch.codec.wavtokenizer import (
    WavTokenizerConfig, build_wavtokenizer, vocode_streaming,
)
from lina_speech_tpu_torch.utils import convert

TOL_OP = 1e-5
TOL_DEEP = 1e-4
TINY = dict(ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
            backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8)
FLAGSHIP_WIDTHS = dict(backbone_layers=2)  # WavTokenizerConfig()'s widths, 2 ConvNeXt layers


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def held(out, ref, tol):
    """max|out - ref| within ``tol`` of max|ref| (no floor)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class Codec:
    """The port's codec, random weights with every 1-D parameter (biases,
    norm weights, layer scales) moved off its constant init, and the JAX
    WavTokenizer with the same weights carried across by the bridge."""

    def __init__(self, kw, seed):
        self.cfg = WavTokenizerConfig(**kw)
        self.jax = JaxWavTokenizer(JaxConfig(**kw))
        self.port = build_wavtokenizer(self.cfg, device="cpu", seed=seed)
        perturb_vectors(self.port, seed)
        self.params = convert.wavtokenizer_state_dict_to_jax(self.port.state_dict())
        # the tree has the JAX module's structure, shapes and dtypes
        shapes = jax.eval_shape(self.jax.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4 * self.cfg.hop)))
        assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(self.params)
        for (path, s), (_, v) in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                     jax.tree_util.tree_leaves_with_path(self.params)):
            assert (s.shape, s.dtype) == (v.shape, v.dtype), path

    def sub(self, name):
        return {"params": self.params["params"][name]}

    def apply(self, *args, method=None):
        out = jax.jit(lambda p, *a: self.jax.apply(p, *a, method=method))(self.params, *args)
        return jax.tree_util.tree_map(np.asarray, out)


def perturb_vectors(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)


@pytest.fixture(scope="module")
def tiny():
    return Codec(TINY, seed=3)


@pytest.fixture(scope="module")
def wide():
    return Codec(FLAGSHIP_WIDTHS, seed=5)


@pytest.fixture(params=["tiny", "flagship_widths"])
def codec(request):
    return request.getfixturevalue("tiny" if request.param == "tiny" else "wide")


@pytest.mark.parametrize("n_fft,hop,frames", [(16, 8, 7), (1280, 320, 4)])
def test_istft_same_matches_jax(n_fft, hop, frames):
    rng = np.random.default_rng(n_fft)
    re, im = (rng.normal(size=(2, n_fft // 2 + 1, frames)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_istft_same((jnp.asarray(re), jnp.asarray(im)), n_fft, hop))
    out = istft_same((t(re), t(im)), n_fft, hop)
    assert out.shape == (2, frames * hop)
    held(out, ref, TOL_OP)
    # a complex spectrogram takes the same path
    held(istft_same(torch.complex(t(re), t(im)), n_fft, hop), ref, TOL_OP)


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_and_imdct_match_jax(padding):
    rng = np.random.default_rng(1)
    audio = rng.normal(size=(2, 96)).astype(np.float32)
    ref = np.asarray(jax_mdct.mdct(jnp.asarray(audio), 16, padding))
    held(mdct.mdct(t(audio), 16, padding), ref, TOL_OP)
    coeffs = rng.normal(size=(2, 11, 8)).astype(np.float32)
    held(mdct.imdct(t(coeffs), padding), np.asarray(jax_mdct.imdct(jnp.asarray(coeffs), padding)),
         TOL_OP)


@pytest.mark.parametrize("kind", ["istft", "imdct_symexp", "imdct_cos"])
def test_heads_match_jax(kind):
    dim = 24
    jax_head, port_head = {
        "istft": (jax_heads.ISTFTHead(dim, 32, 8), heads.ISTFTHead(dim, 32, 8)),
        "imdct_symexp": (jax_heads.IMDCTSymExpHead(dim, 16, clip_audio=True),
                         heads.IMDCTSymExpHead(dim, 16, clip_audio=True)),
        "imdct_cos": (jax_heads.IMDCTCosHead(dim, 16, padding="center"),
                      heads.IMDCTCosHead(dim, 16, padding="center")),
    }[kind]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, dim)).astype(np.float32)
    n_out = port_head.out.weight.shape[0]
    w = (rng.normal(size=(n_out, dim)) * dim ** -0.5).astype(np.float32)
    b = (rng.normal(size=n_out) * 0.1).astype(np.float32)
    port_head.load_state_dict({"out.weight": t(w), "out.bias": t(b)})
    params = {"params": {"out": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)}}}
    ref = np.asarray(jax_head.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        held(port_head(t(x)), ref, TOL_OP)


@pytest.mark.parametrize("frames", [13, 1])
def test_vocos_backbone_matches_jax(codec, frames):
    c = codec.cfg
    x = np.random.default_rng(4).normal(size=(2, frames, c.latent_dim)).astype(np.float32)
    backbone = jax_vocos.VocosBackbone(c.latent_dim, c.backbone_dim, c.backbone_intermediate_dim,
                                       c.backbone_layers)
    ref = np.asarray(jax.jit(backbone.apply)(codec.sub("backbone"), jnp.asarray(x)))
    with torch.no_grad():
        held(codec.port.backbone(t(x)), ref, TOL_DEEP)


def test_ada_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    scale, shift = (rng.normal(size=(3, 32)).astype(np.float32) for _ in range(2))
    params = {"params": {"scale": {"embedding": jnp.asarray(scale)},
                         "shift": {"embedding": jnp.asarray(shift)}}}
    port = vocos.AdaLayerNorm(3, 32)
    port.load_state_dict({"scale.weight": t(scale), "shift.weight": t(shift)})
    ref = np.asarray(jax_vocos.AdaLayerNorm(3, 32).apply(params, jnp.asarray(x), jnp.asarray(2)))
    with torch.no_grad():
        held(port(t(x), torch.tensor(2)), ref, TOL_OP)


@pytest.mark.parametrize("frames,short", [(6, 0), (6, 3), (1, 5)])
def test_seanet_encoder_matches_jax(codec, frames, short):
    """Lengths a multiple of the hop, and not (``short`` samples fewer;
    the tiny codec's shortest input reflects past its ends)."""
    c = codec.cfg
    n = frames * c.hop - short
    audio = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    encoder = jax_seanet.SEANetEncoder(dimension=c.latent_dim, n_filters=c.n_filters,
                                       ratios=c.ratios)
    ref = np.asarray(jax.jit(encoder.apply)(codec.sub("encoder"), jnp.asarray(audio)))
    with torch.no_grad():
        out = codec.port.encoder(t(audio))
    assert out.shape == (2, frames, c.latent_dim)
    held(out, ref, TOL_DEEP)


def test_lstm_layers_match_jax(tiny):
    c = tiny.cfg
    dim = c.n_filters * 2 ** len(c.ratios)
    x = np.random.default_rng(7).normal(size=(2, 11, dim)).astype(np.float32)
    lstm = jax_seanet.LSTMLayers(dim, 2)
    ref = np.asarray(jax.jit(lstm.apply)({"params": tiny.params["params"]["encoder"]["lstm"]},
                                         jnp.asarray(x)))
    port = next(m for m in tiny.port.encoder.model if isinstance(m, seanet.LSTMLayers))
    with torch.no_grad():
        held(port(t(x)), ref, TOL_OP)


def test_seanet_decoder_matches_jax():
    """The decoder, its transposed convs included, with the port's weights
    carried to the JAX module by the SEANet key map."""
    kw = dict(dimension=16, n_filters=2, ratios=(4, 2))
    z = np.random.default_rng(8).normal(size=(2, 5, 16)).astype(np.float32)
    torch.manual_seed(0)
    port = seanet.SEANetDecoder(**kw)
    perturb_vectors(port, 8)
    pairs = convert._seanet_pairs(2, decoder=True)
    params = {"params": convert._nest(convert._pairs_to_jax(port.model.state_dict(), pairs))}
    dec = jax_seanet.SEANetDecoder(**kw)
    shapes = jax.eval_shape(dec.init, jax.random.PRNGKey(0), jnp.asarray(z))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    ref = np.asarray(jax.jit(dec.apply)(params, jnp.asarray(z)))
    with torch.no_grad():
        out = port(t(z))
    assert out.shape == (2, 5 * 8)
    held(out, ref, TOL_DEEP)
    flat = {k: v for k, v in convert._flatten(params).items()}
    back = convert._pairs_from_jax({k.split("params/", 1)[1]: v for k, v in flat.items()}, pairs)
    assert all(torch.equal(back[k], v) for k, v in port.model.state_dict().items())


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_reflect_pad_is_numpy_reflect(n):
    x = np.arange(2 * n, dtype=np.float32).reshape(1, 2, n)
    for left, right in ((0, 0), (n - 1, n - 1), (n, 1), (3 * n + 2, 2 * n + 5)):
        want = np.pad(x, ((0, 0), (0, 0), (left, right)), mode="reflect")
        np.testing.assert_array_equal(seanet.reflect_pad(t(x), left, right).numpy(), want)


def test_vq_ops_match_jax():
    rng = np.random.default_rng(9)
    embed = rng.uniform(-1, 1, size=(2, 32, 8)).astype(np.float32)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    jq = jax_vq.VectorQuantizer(embed=jnp.asarray(embed), cluster_size=jnp.zeros((2, 32)),
                                embed_avg=jnp.asarray(embed))
    q = vq.VectorQuantizer(2, 32, 8)
    for i, e in enumerate(q.embed):
        e.data.copy_(t(embed[i]))
    for fn, port_fn in ((jax_vq.vq_encode, vq.vq_encode),
                        (jax_vq.residual_vq_encode, vq.residual_vq_encode)):
        for n_q in (None, 1):
            ref = np.asarray(fn(jnp.asarray(x), jq, n_q))
            np.testing.assert_array_equal(port_fn(t(x), q, n_q).numpy(), ref)
    codes = rng.integers(0, 32, size=(2, 3, 5))
    held(vq.vq_decode(t(codes), q).detach(), np.asarray(jax_vq.vq_decode(jnp.asarray(codes), jq)),
         TOL_OP)


def test_vq_planted_tie_takes_the_first_index():
    """Integer codebooks and latents make every score exact: rows 2, 5 and
    6 tie for the nearest code of the first latent, and row 2 must win."""
    embed = np.zeros((1, 8, 4), np.float32)
    embed[0, :, 0] = np.arange(8)
    embed[0, [2, 5, 6]] = [[1, 2, 0, 0], [1, 2, 0, 0], [2, 1, 0, 0]]
    x = np.array([[[3, 3, 0, 0], [7, 0, 0, 0]]], np.float32)  # scores 2x.e - |e|^2
    jq = jax_vq.VectorQuantizer(embed=jnp.asarray(embed), cluster_size=jnp.zeros((1, 8)),
                                embed_avg=jnp.asarray(embed))
    q = vq.VectorQuantizer(1, 8, 4)
    q.embed[0].data.copy_(t(embed[0]))
    ref = np.asarray(jax_vq.vq_encode(jnp.asarray(x), jq))
    np.testing.assert_array_equal(ref, [[[2, 7]]])
    np.testing.assert_array_equal(vq.vq_encode(t(x), q).numpy(), ref)


def test_wavtokenizer_matches_jax(codec):
    """encode (features and codes), decode and codes_to_audio; the port's
    own copy synthesis is decode(encode)."""
    c = codec.cfg
    audio = np.random.default_rng(10).normal(size=(2, 5 * c.hop)).astype(np.float32)
    codes = np.random.default_rng(11).integers(0, c.bins, size=(1, 2, 9))
    jf, jc = codec.apply(jnp.asarray(audio), method=JaxWavTokenizer.encode)
    with torch.no_grad():
        features, port_codes = codec.port.encode(t(audio))
        np.testing.assert_array_equal(port_codes.numpy(), jc)
        held(features, jf, TOL_OP)
        wav = codec.port.codes_to_audio(t(codes))
        assert wav.shape == (2, 9 * c.hop_length)
        held(wav, codec.apply(jnp.asarray(codes), method=JaxWavTokenizer.codes_to_audio),
             TOL_DEEP)
        decoded = codec.port.decode(features)
        held(decoded, codec.apply(jnp.asarray(jf), method=JaxWavTokenizer.decode), TOL_DEEP)
        assert torch.equal(codec.port(t(audio)), decoded)


def test_vocode_streaming_matches_jax(tiny):
    codes = np.random.default_rng(12).integers(0, tiny.cfg.bins, size=(1, 2, 41))
    ref = list(jax_vocode_streaming(tiny.jax, tiny.params, jnp.asarray(codes), window=8,
                                    context=6))
    out = list(vocode_streaming(tiny.port, t(codes), window=8, context=6))
    assert [o.shape[-1] for o in out] == [r.shape[-1] for r in ref] == [64] * 5 + [8]
    for o, r in zip(out, ref):
        held(o, np.asarray(r), TOL_DEEP)


def test_state_dict_is_what_the_reference_converter_reads(tiny):
    """The port's state_dict, as numpy arrays, rebuilds the JAX tree through
    the JAX package's reference-checkpoint converter with strict=True, and
    every key is read by it (without any one of them it raises); the
    bridge's two directions invert each other."""
    sd = {k: v.numpy() for k, v in tiny.port.state_dict().items()}
    n_ratios = len(tiny.cfg.ratios)
    template = jax.tree_util.tree_map(np.zeros_like, tiny.params)
    back = convert_torch_wavtokenizer(sd, template, n_ratios=n_ratios, strict=True)
    want = dict(jax.tree_util.tree_leaves_with_path(tiny.params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), want[path])
    for key in sd:
        with pytest.raises((KeyError, ValueError)):
            convert_torch_wavtokenizer({k: v for k, v in sd.items() if k != key}, template,
                                       n_ratios=n_ratios, strict=True)
    again = convert.wavtokenizer_state_dict_from_jax(tiny.params)
    assert set(again) == set(sd)
    assert all(np.array_equal(again[k].numpy(), v) for k, v in sd.items())


def test_reference_checkpoint_loads_strict(tiny):
    """A reference-style state_dict -- weight-normed SEANet convs, the VQ's
    EMA statistics, the ISTFT window buffer, decoder and discriminator keys
    -- loads into a fresh codec with strict=True and gives the same weights;
    a missing codec key still raises."""
    rng = np.random.default_rng(13)
    want = tiny.port.state_dict()
    ref = {}
    for key, val in want.items():
        v = val.numpy()
        if key.startswith("feature_extractor.encodec.encoder") and key.endswith("conv.weight"):
            g = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
            ref[key[:-len("weight")] + "weight_g"] = g
            ref[key[:-len("weight")] + "weight_v"] = v * rng.uniform(0.5, 2.0, size=(v.shape[0], 1, 1))
        else:
            ref[key] = v
    vq_prefix = "feature_extractor.encodec.quantizer.vq.layers.0._codebook."
    ref.update({vq_prefix + "inited": np.ones(1), vq_prefix + "cluster_size": np.ones(32),
                vq_prefix + "embed_avg": ref[vq_prefix + "embed"],
                "head.istft.window": np.hanning(17)[:-1],
                "feature_extractor.encodec.decoder.model.0.conv.conv.weight_g": np.ones((4, 1, 1)),
                "feature_extractor.encodec.decoder.model.0.conv.conv.weight_v": np.ones((4, 2, 7)),
                "multiperioddisc.discriminators.0.convs.0.bias": np.zeros(3)})
    fresh = build_wavtokenizer(tiny.cfg, device="cpu", seed=99)
    convert.load_wavtokenizer_state_dict(fresh, ref)
    for key, val in fresh.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7)
    del ref["backbone.norm.bias"]
    with pytest.raises(RuntimeError, match="backbone.norm.bias"):
        convert.load_wavtokenizer_state_dict(fresh, ref)


def test_build_wavtokenizer_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = WavTokenizerConfig(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_wavtokenizer(cfg)
    assert build_wavtokenizer(cfg, device="cpu").device == torch.device("cpu")


def test_group_norm_variance_is_accurate_where_flax_cancels():
    """A group whose spread is small beside its mean (one channel a group
    over 3 frames, mean 0.9, std 0.005): the port's GroupNorm (torch's, the
    reference Vocos's) stays within 1e-4 of the float64 normalization, where
    flax's E[x^2] - E[x]^2 variance cancels and misses by about 3e-2. On
    such groups the port is held to float64, not to JAX."""
    import flax.linen as nn

    x = (0.9 + 0.005 * np.random.default_rng(0).normal(size=(1, 3, 32))).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(1, keepdims=True)
    want = (x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(1, keepdims=True) + 1e-6)
    with torch.no_grad():
        port = vocos.GroupNorm(32)(t(x).transpose(1, 2)).transpose(1, 2)
    held(port, want, 1e-4)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-6)
    flax_out = np.asarray(gn.apply(gn.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    assert np.abs(flax_out - want).max() > 1e-2 * np.abs(want).max()


def test_bf16_compute_decodes_to_f32():
    """The JAX ``dtype`` field: convs and Linears in bf16, norms and the
    ISTFT head in f32; the waveform stays near the f32 decode."""
    cfg = WavTokenizerConfig(**TINY)
    codes = t(np.random.default_rng(14).integers(0, cfg.bins, size=(1, 2, 12)))
    f32 = build_wavtokenizer(cfg, device="cpu", seed=4)
    bf16 = build_wavtokenizer(cfg, device="cpu", seed=4, dtype=torch.bfloat16)
    with torch.no_grad():
        ref, out = f32.codes_to_audio(codes), bf16.codes_to_audio(codes)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    held(out, ref.numpy(), 0.1)
