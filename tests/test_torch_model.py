"""PyTorch port modules vs the JAX package on the tiny config, on the CPU.

One JAX LinaModel per variant (the tiny config with SinPos, its ConvPos +
short-conv variant in the released checkpoint's architecture, and a
non-blind variant with rotary CrossAttention) is initialized by JAX; its params cross into the port through
``utils/convert.py``. Inputs are numpy arrays from a seed. Tolerance: 1e-4
of each output's own max|reference|; both sides compute in f32 and differ
only in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.models.lina import LinaModel as JaxLina
from lina_speech_tpu.utils.checkpoint import convert_torch_lina
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.utils.convert import (
    jax_params_to_state_dict, load_jax_params,
)
from test_torch_naming import _reference_state_dict

TOL = 1e-4


def _variant(cfg, pos_type):
    """pos_type "sinusoidal" / "convolutional" (blind cross-attention), or
    "rotary": the vanilla multi-head CrossAttention with rotary queries."""
    if pos_type == "rotary":
        bb = dict(blind=False, rotary=True, use_short_conv=True)
    else:
        bb = dict(pos_type=pos_type, use_short_conv=True)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **bb))


def _torch_cfg(pos_type):
    return _variant(torch_tiny(), pos_type)


def _make_pair(pos_type):
    cfg = _variant(lina_gla_tiny(), pos_type)
    jm = jax_build(cfg)
    b, m, n = 2, 7, 9
    x = jnp.ones((b, m), jnp.int32)
    y = jnp.ones((b, n, cfg.n_quant), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x, y, jnp.ones((b, m, m), bool),
                              jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
    tm = load_jax_params(torch_build(_torch_cfg(pos_type), device="cpu"), params)
    return jm, params, tm.eval()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["sinusoidal", "convolutional"])
def pair(request):
    """(jax model, jax params, port model with the same weights)."""
    return _make_pair(request.param)


def _close(t, j, tol=TOL):
    """``t`` within ``tol`` of its reference's own size, max|j|, with no
    floor: a GLA layer's output is ~1e-5 at initialization, so an absolute
    tolerance of 1e-4 on it would prove nothing."""
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    err, ref = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert ref > 0 and err <= tol * ref, (err, ref)


def _rng_inputs(seed, b=2, m=7, t=11, d=64):
    rng = np.random.default_rng(seed)
    text = rng.integers(3, 256, size=(b, m))
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    return text, x


def test_weight_bridge_round_trip(pair):
    _, params, _ = pair
    flat = {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    back = convert_torch_lina(jax_params_to_state_dict(flat), params, strict=True)
    for path, val in traverse_util.flatten_dict(back, sep="/").items():
        np.testing.assert_array_equal(np.asarray(val), flat[path], err_msg=path)


def test_reference_state_dict_loads_strict():
    cfg = _torch_cfg("convolutional")
    model = torch_build(cfg, device="cpu")
    sd = _reference_state_dict(
        np.random.default_rng(7), d=64, n_layer=cfg.backbone.n_layer,
        heads=cfg.backbone.heads, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
        n_special_in=cfg.n_special_token_in, n_special_out=cfg.n_special_token_out,
        n_txt_vocab=cfg.n_txt_vocab, te_layers=cfg.text_encoder.n_layers,
        te_dim=cfg.text_encoder.dim)
    sd = {k.removeprefix("model."): torch.from_numpy(v) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    key = "attentive_rnn.cross_att.pos_embed.dw_conv.weight"
    assert torch.equal(model.state_dict()[key], sd[key])


def test_text_encoder_matches_jax(pair):
    jm, params, tm = pair
    text, _ = _rng_inputs(1)
    j = jm.apply(params, jnp.asarray(text), method=JaxLina.encode_text)
    with torch.no_grad():
        _close(tm.encode_text(torch.from_numpy(text)), j)


def test_gla_layer_prefill_and_step_match_jax(pair):
    jm, params, tm = pair
    _, x = _rng_inputs(2)
    x_t = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)

    def jrun(m, x, x_t):
        tmix = m.attentive_rnn.encoder[1].tmix
        st0 = tmix.empty_state(x.shape[0])
        out, st = tmix(x, initial_state=st0, output_final_state=True)
        out_t, st_t = tmix.step(x_t, st)
        return out, st, out_t, st_t

    jo, js, jo_t, js_t = jm.apply(params, jnp.asarray(x), jnp.asarray(x_t), method=jrun)
    tmix = tm.attentive_rnn.encoder[1].tmix
    with torch.no_grad():
        to, ts = tmix(torch.from_numpy(x), initial_state=tmix.empty_state(2),
                      output_final_state=True)
        to_t, ts_t = tmix.step(torch.from_numpy(x_t), ts)
    _close(to, jo)
    _close(to_t, jo_t)
    for name in ("s", "conv_q", "conv_k", "conv_v"):
        _close(getattr(ts, name), getattr(js, name))
        _close(getattr(ts_t, name), getattr(js_t, name))


@pytest.mark.parametrize("split", [[8, 4, 1], [2, 1, 10], [13]], ids=str)
def test_gla_layer_chunked_prefill_matches_one_shot_and_jax(pair, split):
    """forward() over chunks that thread the state, with conv_history from
    the second chunk on (a chunk shorter than the conv width keeps the
    tail of the incoming rings): equal to the one-shot forward, and to the
    JAX layer run over the same chunks."""
    jm, params, tm = pair
    _, x = _rng_inputs(10, t=13)

    def jrun(m, x):
        tmix = m.attentive_rnn.encoder[0].tmix
        st, off, outs = tmix.empty_state(x.shape[0]), 0, []
        for i, c in enumerate(split):
            o, st = tmix(x[:, off:off + c], initial_state=st, output_final_state=True,
                         conv_history=i > 0)
            outs.append(o)
            off += c
        return jnp.concatenate(outs, axis=1), st

    jo, js = jm.apply(params, jnp.asarray(x), method=jrun)
    tmix = tm.attentive_rnn.encoder[0].tmix
    tx = torch.from_numpy(x)
    with torch.no_grad():
        full, st_full = tmix(tx, initial_state=tmix.empty_state(2), output_final_state=True)
        st, off, outs = tmix.empty_state(2), 0, []
        for i, c in enumerate(split):
            o, st = tmix(tx[:, off:off + c], initial_state=st, output_final_state=True,
                         conv_history=i > 0)
            outs.append(o)
            off += c
    out = torch.cat(outs, dim=1)
    _close(out, jo)
    _close(out, full.numpy())
    for name in ("s", "conv_q", "conv_k", "conv_v"):
        _close(getattr(st, name), getattr(js, name))
        _close(getattr(st, name), getattr(st_full, name).numpy())


@pytest.mark.parametrize("pair", ["convolutional"], indirect=True)
def test_conv_pos_valid_makes_padding_exact(pair):
    """ConvPos(valid=...): a padded run equals the unpadded run at the valid
    positions, and the JAX module's padded run."""
    jm, params, tm = pair
    pos_embed = tm.attentive_rnn.cross_att.pos_embed
    m, mlen = 12, 7
    valid = np.arange(m)[None] < mlen
    with torch.no_grad():
        unpadded = pos_embed(torch.arange(mlen)[None])
        padded = pos_embed(torch.arange(m)[None])
        masked = pos_embed(torch.arange(m)[None], valid=torch.from_numpy(valid))
    assert not np.allclose(padded[:, :mlen].numpy(), unpadded.numpy(), atol=1e-6)
    _close(masked[:, :mlen], unpadded.numpy(), 1e-6)
    jmasked = jm.apply(params, jnp.arange(m)[None], jnp.asarray(valid),
                       method=lambda mod, p, v: mod.attentive_rnn.cross_att.pos_embed(p, valid=v))
    _close(masked, jmasked)


def test_blind_cross_attention_matches_jax(pair):
    jm, params, tm = pair
    _, x = _rng_inputs(4)
    ctx = np.random.default_rng(5).normal(size=(2, 7, 64)).astype(np.float32)

    def jrun(m, x, ctx):
        ca = m.attentive_rnn.cross_att
        st0 = ca.pos_net.tmix.empty_state(x.shape[0])
        v, att, st = ca(x, ctx, pos_net_state=st0, return_weights=True)
        v_t, att_t, st_t = ca.step(x[:, 0], ctx, st)
        return v, att, st, v_t, att_t, st_t

    jv, jatt, js, jv_t, jatt_t, js_t = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx),
                                                method=jrun)
    ca = tm.attentive_rnn.cross_att
    with torch.no_grad():
        tv, tatt, ts = ca(torch.from_numpy(x), torch.from_numpy(ctx),
                          pos_net_state=ca.pos_net.tmix.empty_state(2),
                          return_weights=True)
        tv_t, tatt_t, ts_t = ca.step(torch.from_numpy(x[:, 0]), torch.from_numpy(ctx), ts)
    for t_val, j_val in ((tv, jv), (tatt, jatt), (ts.s, js.s), (tv_t, jv_t),
                         (tatt_t, jatt_t), (ts_t.s, js_t.s)):
        _close(t_val, j_val)


def _prefill_decode_logits_match(jm, params, tm):
    text, _ = _rng_inputs(6)
    codes = np.random.default_rng(7).integers(3, 53, size=(1, 2, 10))

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        logits, _, st = m.prefill(y[:, :-1], x_enc, m.empty_state(text.shape[0]))
        logits_t, _, _ = m.decode_step(y[:, -1], x_enc, st, time_step=9)
        return logits, logits_t

    jl, jl_t = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jrun)
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        tl, _, st = tm.prefill(y[:, :-1], x_enc, tm.empty_state(2))
        tl_t, _, _ = tm.decode_step(y[:, -1], x_enc, st, time_step=9)
    assert tl.shape == jl.shape and tl_t.shape == jl_t.shape
    _close(tl, jl)
    _close(tl_t, jl_t)


def test_lina_prefill_and_decode_logits_match_jax(pair):
    _prefill_decode_logits_match(*pair)


def test_rotary_cross_attention_model_matches_jax():
    """The non-blind backbone: vanilla CrossAttention with rotary queries
    offset by the decode time step."""
    _prefill_decode_logits_match(*_make_pair("rotary"))


def test_unported_options_raise():
    from lina_speech_tpu_torch.models.gla_layer import GatedLinearAttention

    with pytest.raises(NotImplementedError):
        GatedLinearAttention(hidden_size=32, num_heads=2, kernel_mode="chunk_pallas")
    layer = GatedLinearAttention(hidden_size=32, num_heads=2, use_short_conv=True)
    with pytest.raises(ValueError):  # a continuation needs the rings it continues
        layer(torch.zeros(1, 3, 32), conv_history=True)
    # context parallelism is ported (tests/test_torch_cp.py): a cp_axis needs
    # a mesh carrying it
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        torch_build(dataclasses.replace(torch_tiny(), backbone=dataclasses.replace(
            torch_tiny().backbone, cp_axis="cp")), device="cpu")
    # remat is ported (tests/test_torch_remat.py): it builds
    assert torch_build(dataclasses.replace(torch_tiny(), backbone=dataclasses.replace(
        torch_tiny().backbone, remat=True)), device="cpu").attentive_rnn.remat


def test_decode_continues_prefill(pair):
    """Prefill of t tokens then one step == prefill of t + 1 tokens."""
    _, _, tm = pair
    text, _ = _rng_inputs(8)
    codes = torch.from_numpy(np.random.default_rng(9).integers(3, 53, size=(1, 2, 8)))
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(codes)
        full, _, _ = tm.prefill(y, x_enc)
        _, _, st = tm.prefill(y[:, :-1], x_enc)
        last, _, _ = tm.decode_step(y[:, -1], x_enc, st)
    _close(last, full[:, -1].numpy())


# ------------------------------------------------------------ training path
def test_gla_layer_and_backbone_reset_mask_match_jax(pair):
    """reset_mask through one GLA layer and through the whole AttentiveGLA
    (every mixer and the blind cross-attention's pos_net), against JAX."""
    jm, params, tm = pair
    _, x = _rng_inputs(11, t=13)
    ctx = np.random.default_rng(12).normal(size=(2, 7, 64)).astype(np.float32)
    reset = np.zeros((2, 13), bool)
    reset[:, 0] = reset[0, 5] = reset[1, 9] = True

    def jrun(m, x, ctx, reset):
        layer = m.attentive_rnn.encoder[0].tmix(x, reset_mask=reset)
        y, _ = m.attentive_rnn(x, ctx, reset_mask=reset)
        return layer, y

    jl, jy = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(reset), method=jrun)
    with torch.no_grad():
        tx, tr = torch.from_numpy(x), torch.from_numpy(reset)
        tl = tm.attentive_rnn.encoder[0].tmix(tx, reset_mask=tr)
        ty, _ = tm.attentive_rnn(tx, torch.from_numpy(ctx), reset_mask=tr)
        plain = tm.attentive_rnn.encoder[0].tmix(tx)
    # the mixer's output is small at initialization: hold it to its own size
    for t_val, j_val in ((tl, jl), (ty, jy)):
        j_val = np.asarray(j_val)
        assert float(np.abs(t_val.numpy() - j_val).max()) <= TOL * float(np.abs(j_val).max())
    # the mask acts
    assert float((tl - plain).abs().max()) > 0.1 * float(plain.abs().max())


def _train_batch(kind, n_quant=1):
    from lina_speech_tpu_torch.data.collate import collate_tts, packed_collate_tts
    from lina_speech_tpu_torch.data.tokenizer import TextTokenizer

    rng = np.random.default_rng(13)
    items = [{"audio_token": rng.integers(0, 50, (n_quant, n)), "text": text}
             for n, text in ((12, "pack one"), (9, "two"), (7, "and three"))]
    if kind == "packed":
        return packed_collate_tts(items, TextTokenizer())
    batch = collate_tts(items, TextTokenizer())
    batch["y_mask"][0, 4:6] = False  # a logits_mask that is not just padding
    return batch


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_lina_forward_loss_and_gradients_match_jax(pair, kind):
    """LinaModel.forward in eval mode: logits, loss and the gradient of
    every parameter by name against jax.value_and_grad of the JAX model, on
    a padded batch with a logits_mask and on a packed batch with reset_mask
    and crossatt_pos. Each gradient leaf within 1e-4 of its own max|ref|
    (plus 1e-7 for leaves whose gradient is zero in exact arithmetic, such
    as the attention's key bias)."""
    from lina_speech_tpu_torch.utils.convert import named_tensors_to_jax

    jm, params, tm = pair
    batch = _train_batch(kind)
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")

    def loss_fn(p):
        logits, loss, _ = jm.apply(
            p, *(jnp.asarray(batch[k]) for k in keys), logits_mask=jnp.asarray(batch["y_mask"]),
            reset_mask=None if kind == "padded" else jnp.asarray(batch["reset_mask"]),
            crossatt_pos=None if kind == "padded" else jnp.asarray(batch["crossatt_pos"]))
        return loss, logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    logits, loss, att = tm(*(tb[k] for k in keys), logits_mask=tb["y_mask"],
                           reset_mask=tb.get("reset_mask"), crossatt_pos=tb.get("crossatt_pos"))
    loss.backward()
    assert att is None
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = named_tensors_to_jax({n: p.grad for n, p in tm.named_parameters()})
    ref = traverse_util.flatten_dict(jgrads["params"], sep="/")
    assert set(got) == set(ref)
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        assert got[path].shape == r.shape, path
        err = float(np.abs(got[path] - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (path, err, float(np.abs(r).max()))
    tm.zero_grad(set_to_none=True)


def test_training_mode_dropout_is_reproducible_and_absent_in_eval():
    """Dropout (text encoder blocks) and the text masking draw from the
    model's generator: the same seed gives the same loss, another seed
    another loss, eval mode ignores the generator, and training without a
    generator raises."""
    cfg = torch_tiny(mask_text_p=0.3)
    cfg = dataclasses.replace(cfg, text_encoder=dataclasses.replace(cfg.text_encoder, dropout=0.2),
                              backbone=dataclasses.replace(cfg.backbone, dropout=0.1))
    model = torch_build(cfg, device="cpu", seed=1)
    assert not model.training
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _train_batch("padded").items()}
    args = (batch["text_token"], batch["audio_token"], batch["encoder_mask"],
            batch["crossatt_mask"], batch["y_mask"])

    def loss(seed):
        model.set_generator(None if seed is None else torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return float(model(*args)[1])

    eval_loss = loss(None)
    assert loss(5) == eval_loss
    model.train()
    a, b, c = loss(5), loss(5), loss(6)
    assert a == b and a != c and a != eval_loss
    with pytest.raises(RuntimeError, match="generator"):
        loss(None)
    model.eval()
