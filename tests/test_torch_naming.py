"""Conversion hardening: synthetic state_dict with the reference's EXACT
torch module names/shapes (derived structurally from the reference source,
NOT from torch_key_for — so a wrong mapping rule fails here, today, instead
of the day the released 169M file arrives).

Name derivations (all /root/reference/):
- LinaModel attrs txt_embed / rvq_embed / logits_head / txt_encoder /
  attentive_rnn: modeling_lina.py:38-59. Lightning root "model.":
  train_lina.py:31 (self.model = LinaModel(...)).
- AttentiveGLA: encoder/decoder nn.ModuleList -> "encoder.{i}." names,
  cross_att: gla.py:273-285.
- MixingBlock attrs tmix/cmix/norm1/norm2: base_blocks.py:57-63.
- GatedLinearAttention projections q/k/v/g/o_proj, gk_proj =
  nn.Sequential(Linear, Linear) -> gk_proj.0/gk_proj.1, q/k/v_conv1d
  (FLA ShortConvolution subclasses nn.Conv1d: weight (d, 1, size)),
  g_norm_swish_gate.weight: gla.py:91-116.
- SwiGLU p_in/p_out (nn.Linear, default bias=True): base_blocks.py:43-47.
- SelfAttention qkv (bias=True) + rotary (rotary_embedding_torch stores
  freqs as an nn.Parameter -> present in state_dict, ignorable):
  base_blocks.py:10-16.
- BlindCrossAttention q/k/v (bias=True), ln_q/ln_k/ln_v, pos_net
  (a full GLA MixingBlock, gla.py:281), pos_embed = ConvPos(embed +
  dw_conv, kernel 31, max_seq_len 2000): crossatt.py:21-32, 76-99.
- TextEncoder sa ModuleList: encoder.py:25-33.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from lina_speech_tpu.config import build_model, lina_gla_tiny
from lina_speech_tpu.utils.checkpoint import convert_torch_lina


def _reference_state_dict(rng, *, d, n_layer, heads, n_quant, n_codebook,
                          n_special_in, n_special_out, n_txt_vocab,
                          te_layers, te_dim):
    """Synthesize the released-architecture state_dict (convblind +
    short-conv + ConvPos, text encoder rotary): every key name and torch
    shape written out independently of the converter's mapping rules."""
    sd = {}

    def add(key, *shape):
        sd["model." + key] = rng.normal(size=shape).astype(np.float32) * 0.02

    key_dim = d            # expand_k = 1.0 (gla.py:51)
    value_dim = 2 * d      # expand_v = 2.0 (gla.py:52)
    head_v = value_dim // heads
    low_rank = 16          # gate_low_rank_dim (gla.py:60)
    conv = 4               # conv_size (gla.py:53)
    hidden_swiglu = d * 4 // 3  # base_blocks.py:45-46

    def gla_block(prefix):
        # GatedLinearAttention (gla.py:91-116); all Linears bias=False
        add(f"{prefix}.tmix.q_proj.weight", key_dim, d)
        add(f"{prefix}.tmix.k_proj.weight", key_dim, d)
        add(f"{prefix}.tmix.v_proj.weight", value_dim, d)
        add(f"{prefix}.tmix.g_proj.weight", value_dim, d)
        add(f"{prefix}.tmix.gk_proj.0.weight", low_rank, d)
        add(f"{prefix}.tmix.gk_proj.1.weight", key_dim, low_rank)
        add(f"{prefix}.tmix.gk_proj.1.bias", key_dim)
        add(f"{prefix}.tmix.o_proj.weight", d, value_dim)
        # ShortConvolution = nn.Conv1d(groups=dim) -> (dim, 1, size)
        add(f"{prefix}.tmix.q_conv1d.weight", key_dim, 1, conv)
        add(f"{prefix}.tmix.k_conv1d.weight", key_dim, 1, conv)
        add(f"{prefix}.tmix.v_conv1d.weight", value_dim, 1, conv)
        add(f"{prefix}.tmix.g_norm_swish_gate.weight", head_v)
        # MixingBlock (base_blocks.py:57-63): LayerNorm weight/bias
        add(f"{prefix}.norm1.weight", d)
        add(f"{prefix}.norm1.bias", d)
        add(f"{prefix}.norm2.weight", d)
        add(f"{prefix}.norm2.bias", d)
        # SwiGLU (base_blocks.py:43-47): nn.Linear default bias=True
        add(f"{prefix}.cmix.p_in.weight", hidden_swiglu * 2, d)
        add(f"{prefix}.cmix.p_in.bias", hidden_swiglu * 2)
        add(f"{prefix}.cmix.p_out.weight", d, hidden_swiglu)
        add(f"{prefix}.cmix.p_out.bias", d)

    # --- LinaModel roots (modeling_lina.py:42-59)
    add("txt_embed.weight", n_txt_vocab, d)
    add("rvq_embed.weight", n_quant, n_codebook + n_special_in, d)
    add("logits_head.weight", n_quant, n_codebook + n_special_out, d)

    # --- TextEncoder (encoder.py:25-33): MixingBlock(SelfAttention, SwiGLU)
    for i in range(te_layers):
        p = f"txt_encoder.sa.{i}"
        add(f"{p}.tmix.qkv.weight", 3 * te_dim, te_dim)
        add(f"{p}.tmix.qkv.bias", 3 * te_dim)
        # rotary_embedding_torch RotaryEmbedding((dim//heads)//2): freqs is
        # an nn.Parameter of dim/2 entries -> in the state_dict, ignorable
        add(f"{p}.tmix.rotary.freqs", ((te_dim // heads) // 2) // 2)
        add(f"{p}.norm1.weight", te_dim)
        add(f"{p}.norm1.bias", te_dim)
        add(f"{p}.norm2.weight", te_dim)
        add(f"{p}.norm2.bias", te_dim)
        h = te_dim * 4 // 3
        add(f"{p}.cmix.p_in.weight", h * 2, te_dim)
        add(f"{p}.cmix.p_in.bias", h * 2)
        add(f"{p}.cmix.p_out.weight", te_dim, h)
        add(f"{p}.cmix.p_out.bias", te_dim)

    # --- AttentiveGLA (gla.py:273-285)
    for i in range(n_layer):
        gla_block(f"attentive_rnn.encoder.{i}")
    for i in range(n_layer):
        gla_block(f"attentive_rnn.decoder.{i}")

    # --- BlindCrossAttention (crossatt.py:76-99), nn.Linear bias=True
    ca = "attentive_rnn.cross_att"
    for name in ("q", "k", "v"):
        add(f"{ca}.{name}.weight", d, d)
        add(f"{ca}.{name}.bias", d)
    for name in ("ln_q", "ln_k", "ln_v"):
        add(f"{ca}.{name}.weight", d)
        add(f"{ca}.{name}.bias", d)
    # pos_net: a full GLA MixingBlock (gla.py:281)
    gla_block(f"{ca}.pos_net")
    # ConvPos (crossatt.py:21-25): embed(2000, d) + depthwise Conv1d k=31
    add(f"{ca}.pos_embed.embed.weight", 2000, d)
    add(f"{ca}.pos_embed.dw_conv.weight", d, 1, 31)
    add(f"{ca}.pos_embed.dw_conv.bias", d)
    return sd


@pytest.fixture(scope="module")
def released_arch():
    """Tiny model in the released checkpoint's architecture: blind
    cross-attention, convolutional positions, short conv (README.md:34-37
    ckpt `..._convblind_shortconv_...`)."""
    cfg = lina_gla_tiny()
    cfg = dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(
            cfg.backbone, pos_type="convolutional", use_short_conv=True
        ),
    )
    model = build_model(cfg)
    b, m, n = 2, 7, 17
    x = jnp.ones((b, m), jnp.int32)
    y = jnp.ones((b, n, cfg.n_quant), jnp.int32)
    batch = (x, y, jnp.ones((b, m, m), bool), jnp.ones((b, n, m), bool),
             jnp.ones((b, n), bool))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *batch)
    return cfg, model, params, batch


def test_convert_reference_named_state_dict(released_arch):
    cfg, model, params, batch = released_arch
    rng = np.random.default_rng(7)
    sd = _reference_state_dict(
        rng,
        d=cfg.backbone.d_model,
        n_layer=cfg.backbone.n_layer,
        heads=cfg.backbone.heads,
        n_quant=cfg.n_quant,
        n_codebook=cfg.n_codebook,
        n_special_in=cfg.n_special_token_in,
        n_special_out=cfg.n_special_token_out,
        n_txt_vocab=cfg.n_txt_vocab,
        te_layers=cfg.text_encoder.n_layers,
        te_dim=cfg.text_encoder.dim,
    )

    # strict: every flax param must match a torch key AND every torch key
    # (except rotary freqs) must be consumed
    out = convert_torch_lina(sd, params, strict=True)

    # spot-check layout rules against hand-computed expectations
    flat = traverse_util.flatten_dict(out, sep="/")
    np.testing.assert_allclose(
        flat["params/attentive_rnn/encoder_0/tmix/q_proj/kernel"],
        sd["model.attentive_rnn.encoder.0.tmix.q_proj.weight"].T,
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        flat["params/attentive_rnn/decoder_1/tmix/v_conv1d/kernel"],
        sd["model.attentive_rnn.decoder.1.tmix.v_conv1d.weight"][:, 0, :],
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        flat["params/attentive_rnn/cross_att/pos_embed/conv_kernel"],
        sd["model.attentive_rnn.cross_att.pos_embed.dw_conv.weight"]
        .transpose(2, 1, 0),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        flat["params/attentive_rnn/cross_att/ln_q/scale"],
        sd["model.attentive_rnn.cross_att.ln_q.weight"],
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        flat["params/logits_weight"], sd["model.logits_head.weight"], rtol=1e-6
    )

    # converted params must run: forward + loss finite (golden-decode
    # stand-in until the real ckpt file is available)
    logits, loss, _ = model.apply(out, *batch)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(logits, np.float32)).all()


def test_strict_flags_renamed_torch_key(released_arch):
    cfg, model, params, _ = released_arch
    rng = np.random.default_rng(8)
    sd = _reference_state_dict(
        rng,
        d=cfg.backbone.d_model,
        n_layer=cfg.backbone.n_layer,
        heads=cfg.backbone.heads,
        n_quant=cfg.n_quant,
        n_codebook=cfg.n_codebook,
        n_special_in=cfg.n_special_token_in,
        n_special_out=cfg.n_special_token_out,
        n_txt_vocab=cfg.n_txt_vocab,
        te_layers=cfg.text_encoder.n_layers,
        te_dim=cfg.text_encoder.dim,
    )
    # simulate a naming drift: one module saved under an unexpected name
    sd["model.attentive_rnn.encoder.0.tmix.gk_proj_a.weight"] = sd.pop(
        "model.attentive_rnn.encoder.0.tmix.gk_proj.0.weight"
    )
    with pytest.raises(KeyError):
        convert_torch_lina(sd, params, strict=True)


def _transformer_spk_state_dict(rng, *, d, n_layer, heads, cross_att_layers, n_codebook,
                                n_txt_vocab, te_layers, spk_inner, spk_heads, spk_layers):
    """Reference-named state_dict of a Lina model with the softmax
    transformer backbone and a SimpleSpeakerEncoder, every key and torch
    shape written out by hand:
    - TransformerCrossAtt (reference model/transformer.py): ``blocks``
      ModuleList of MixingBlock(CausalSelfAttention: ``qkv`` Linear with
      bias and a rotary embedding of (d // heads) // 2 channels, SwiGLU)
      and one vanilla CrossAttention ``cross_att_<i>`` per cross-attention
      layer (q/k/v Linears with bias, ln_q/ln_k/ln_v);
    - SimpleSpeakerEncoder (encoder.py:45-84): ``sa`` ModuleList of
      MixingBlock(SelfAttention, SwiGLU) at ``dim_inner``, ``in_proj``
      d -> dim_inner and ``out_proj`` dim_inner -> d, Linears with bias."""
    sd = {}

    def add(key, *shape):
        sd["model." + key] = rng.normal(size=shape).astype(np.float32) * 0.02

    def attention_block(prefix, dim, n_heads):
        add(f"{prefix}.tmix.qkv.weight", 3 * dim, dim)
        add(f"{prefix}.tmix.qkv.bias", 3 * dim)
        add(f"{prefix}.tmix.rotary.freqs", ((dim // n_heads) // 2) // 2)
        for norm in ("norm1", "norm2"):
            add(f"{prefix}.{norm}.weight", dim)
            add(f"{prefix}.{norm}.bias", dim)
        h = dim * 4 // 3
        add(f"{prefix}.cmix.p_in.weight", 2 * h, dim)
        add(f"{prefix}.cmix.p_in.bias", 2 * h)
        add(f"{prefix}.cmix.p_out.weight", dim, h)
        add(f"{prefix}.cmix.p_out.bias", dim)

    add("txt_embed.weight", n_txt_vocab, d)
    add("rvq_embed.weight", 1, n_codebook + 3, d)
    add("logits_head.weight", 1, n_codebook + 3, d)
    for i in range(te_layers):
        attention_block(f"txt_encoder.sa.{i}", d, heads)
    for i in range(n_layer):
        attention_block(f"attentive_rnn.blocks.{i}", d, heads)
    for j in range(len(cross_att_layers)):
        for name in ("q", "k", "v"):
            add(f"attentive_rnn.cross_att_{j}.{name}.weight", d, d)
            add(f"attentive_rnn.cross_att_{j}.{name}.bias", d)
        for name in ("ln_q", "ln_k", "ln_v"):
            add(f"attentive_rnn.cross_att_{j}.{name}.weight", d)
            add(f"attentive_rnn.cross_att_{j}.{name}.bias", d)
    for i in range(spk_layers):
        attention_block(f"spk_encoder.sa.{i}", spk_inner, spk_heads)
    add("spk_encoder.in_proj.weight", spk_inner, d)
    add("spk_encoder.in_proj.bias", spk_inner)
    add("spk_encoder.out_proj.weight", d, spk_inner)
    add("spk_encoder.out_proj.bias", d)
    return sd


def test_transformer_and_speaker_encoder_names_load_both_ways():
    """The transformer's (``blocks.<i>.tmix.qkv``, ``cross_att_<i>``) and
    the speaker encoder's (``spk_encoder.sa.<i>``, ``in_proj``,
    ``out_proj``) reference names: the port's model loads the hand-written
    state_dict with ``strict=True``; the JAX converter consumes the same
    file strictly; the port's ``jax_params_to_state_dict`` of the JAX params
    gives back the file's keys; and the two models on those weights give
    the same logits."""
    import torch

    from lina_speech_tpu.config import SpeakerEncoderConfig
    from lina_speech_tpu_torch.config import SpeakerEncoderConfig as TorchSpkConfig
    from lina_speech_tpu_torch.config import build_model as torch_build
    from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
    from lina_speech_tpu_torch.utils.convert import jax_params_to_state_dict

    spk = dict(dim_inner=32, heads=2, n_layers=2, window_length=8)

    def cfg_of(tiny, spk_cls):
        cfg = tiny()
        return dataclasses.replace(
            cfg, spk_encoder=spk_cls(**spk),
            backbone=dataclasses.replace(cfg.backbone, kind="transformer", n_layer=3,
                                         cross_att_layers=(0, 2)))

    cfg = cfg_of(lina_gla_tiny, SpeakerEncoderConfig)
    sd = _transformer_spk_state_dict(
        np.random.default_rng(9), d=cfg.d_model, n_layer=3, heads=cfg.backbone.heads,
        cross_att_layers=(0, 2), n_codebook=cfg.n_codebook, n_txt_vocab=cfg.n_txt_vocab,
        te_layers=cfg.text_encoder.n_layers, spk_inner=32, spk_heads=2, spk_layers=2)
    tm = torch_build(cfg_of(torch_tiny, TorchSpkConfig), device="cpu")
    tm.load_state_dict({k.removeprefix("model."): torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    model = build_model(cfg)
    b, m, n = 2, 7, 9
    x = np.random.default_rng(1).integers(3, cfg.n_txt_vocab, size=(b, m))
    y = np.random.default_rng(2).integers(3, cfg.n_codebook + 3, size=(b, n, 1))
    batch = (jnp.asarray(x), jnp.asarray(y), jnp.ones((b, m, m), bool),
             jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *batch)
    out = convert_torch_lina(sd, params, strict=True)
    back = jax_params_to_state_dict(out)
    assert set(back) == {k.removeprefix("model.") for k in sd
                         if not k.endswith("rotary.freqs")}
    np.testing.assert_array_equal(back["attentive_rnn.blocks.1.tmix.qkv.weight"].numpy(),
                                  sd["model.attentive_rnn.blocks.1.tmix.qkv.weight"])
    jlogits = np.asarray(model.apply(out, *batch)[0])
    with torch.no_grad():
        logits = tm(*(torch.from_numpy(np.array(a)) for a in batch))[0].numpy()
    assert np.abs(logits - jlogits).max() <= 1e-4 * np.abs(jlogits).max()
