"""The port's GLA-family variants vs the JAX package, on the CPU.

Backbones built by ``build_model`` at the tiny config: simple-GLA with and
without short convs, Mamba-2, the interleaved CrossAttGLA
(``cross_att_layers=(1,)``) and ``cross_att_pp``; and the GLA layer's own
options (scalar gate, clamp_min, the shared conv, kernel_mode="scan"). Each
JAX model is initialized by JAX and its params cross into the port through
``utils/convert.py``; inputs are numpy arrays from a seed. Both sides
compute in f32 and differ only in summation order: every output is held to
1e-4 of its own max|reference| (3e-4 where a decode loop or a chunked
prefill is held against a one-shot prefill, as tests/test_variants.py
does), gradients to 1e-4 of each leaf's max|ref|. Greedy tokens token for
token. Also the repairs of the port's open faults: the kernels' routing
predicate (F1) and a caller's model left unchanged by generation and
serving (F2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.generate import generate_batch as jax_generate
from lina_speech_tpu.models.gla_layer import GatedLinearAttention as JaxGLA
from lina_speech_tpu.models.lina import LinaModel as JaxLina
from lina_speech_tpu_torch.config import SpeakerEncoderConfig
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.gla_layer import GatedLinearAttention
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_to_arrays, jax_params_to_state_dict, load_jax_params, named_tensors_to_jax,
)
from test_torch_model import _train_batch

TOL = 1e-4
TOL_LOOP = 3e-4

VARIANTS = {
    "simple_gla": dict(kind="simple_gla"),
    "simple_gla_noconv": dict(kind="simple_gla", use_short_conv=False),
    "mamba2": dict(kind="mamba2"),
    "interleaved": dict(kind="gla", cross_att_layers=(1,), blind=False),
    "pp": dict(kind="gla", cross_att_pp=True, blind=False),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(base, name, **top):
    return dataclasses.replace(base, backbone=dataclasses.replace(
        base.backbone, **VARIANTS[name]), **top)


_PAIRS = {}


def _pair(name):
    """(jax model, jax params, port model with the same weights), once per
    variant and module."""
    if name not in _PAIRS:
        jm = jax_build(_cfg(lina_gla_tiny(), name))
        b, m, n = 2, 7, 9
        params = jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32), jnp.ones((b, n, 1), jnp.int32),
            jnp.ones((b, m, m), bool), jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
        tm = load_jax_params(torch_build(_cfg(torch_tiny(), name), device="cpu"), params)
        _PAIRS[name] = (jm, params, tm.eval())
    return _PAIRS[name]


def _close(t, j, tol=TOL):
    """``t`` within ``tol`` of its reference's own max|j| (no floor)."""
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    err, ref = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert ref > 0 and err <= tol * ref, (err, ref)


def _jax_state_arrays(state):
    """A JAX BackboneState -> {"layers/i/field": array}, as the port's
    ``backbone_state_to_arrays`` names them."""
    out = {}
    named = [(f"layers/{i}", st) for i, st in enumerate(state.layers)]
    named.append(("pos_net", state.pos_net))
    for prefix, st in named:
        if st is None:
            continue
        for f in dataclasses.fields(st):
            val = getattr(st, f.name)
            if val is not None:
                out[f"{prefix}/{f.name}"] = np.asarray(val, np.float32)
    return out


def _hold_states(got, ref, tol):
    got, ref = backbone_state_to_arrays(got), _jax_state_arrays(ref)
    assert set(got) == set(ref)
    for key in ref:
        if np.abs(ref[key]).max() > 0:
            _close(got[key], ref[key], tol)
        else:
            assert np.abs(got[key]).max() == 0, key


def _text_codes(seed, n=10):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, n))


# -------------------------------------------------------------- the models
@pytest.mark.parametrize("name", list(VARIANTS))
def test_build_matches_jax_parameter_for_parameter(name):
    """build_model builds the JAX package's structure: every JAX param has
    its port parameter of the same shape, and back (strict loading)."""
    jm, params, tm = _pair(name)
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    got = named_tensors_to_jax(tm.named_parameters())
    assert set(got) == set(flat)
    for path, val in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(val), err_msg=path)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_logits_and_loss_match_jax(name):
    """The training forward on a padded batch with a logits_mask: logits
    and loss. For simple-GLA without convs and Mamba-2 also the gradient of
    every parameter by name against jax.value_and_grad (the key-side bias
    of each softmax attention, whose gradient is zero in exact arithmetic,
    is held to 1e-7 absolute, as in tests/test_torch_model.py)."""
    jm, params, tm = _pair(name)
    batch = _train_batch("padded")
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")
    grads = name in ("simple_gla_noconv", "mamba2")

    def loss_fn(p):
        logits, loss, _ = jm.apply(p, *(jnp.asarray(batch[k]) for k in keys),
                                   logits_mask=jnp.asarray(batch["y_mask"]))
        return loss, logits

    if grads:
        (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    else:
        jloss, jlogits = loss_fn(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    logits, loss, _ = tm(*(tb[k] for k in keys), logits_mask=tb["y_mask"])
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    if not grads:
        return
    loss.backward()
    got = named_tensors_to_jax({n: p.grad for n, p in tm.named_parameters()})
    ref = traverse_util.flatten_dict(jgrads["params"], sep="/")
    assert set(got) == set(ref)
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        err = float(np.abs(got[path] - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (path, err, float(np.abs(r).max()))
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_decode_and_states_match_jax(name):
    """Prefill logits and final states against the JAX prefill; one decode
    step from that state against JAX's; and the port's token-by-token decode
    from an empty state against its own prefill (tests/test_variants.py's
    decode-vs-prefill parity)."""
    jm, params, tm = _pair(name)
    text, codes = _text_codes(6)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        logits, _, st = m.prefill(y[:, :-1], x_enc, m.empty_state(text.shape[0]))
        logits_t, _, st_t = m.decode_step(y[:, -1], x_enc, st, time_step=9)
        return logits, st, logits_t, st_t

    jl, jst, jl_t, jst_t = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jrun)
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        tl, _, st = tm.prefill(y[:, :-1], x_enc, tm.empty_state(2))
        _close(tl, jl)
        _hold_states(st, jst, TOL)
        tl_t, _, st_t = tm.decode_step(y[:, -1], x_enc, st, time_step=9)
        _close(tl_t, jl_t)
        _hold_states(st_t, jst_t, TOL_LOOP)
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, steps = tm.empty_state(2), []
        for t in range(y.shape[1]):
            lg, _, st = tm.decode_step(y[:, t], x_enc, st, time_step=t)
            steps.append(lg)
    _close(torch.stack(steps, 1), full.numpy(), TOL_LOOP)
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL_LOOP, atol=TOL_LOOP)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_chunked_prefill_matches_one_shot_and_jax(name):
    """A prefill as [8, 4, 1] chunks (conv_history and time_offset from the
    second on) equals the one-shot prefill, logits and final state, and the
    JAX package run over the same chunks (tests/test_variants.py)."""
    jm, params, tm = _pair(name)
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

    jl, jst = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jrun)
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
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL_LOOP, atol=TOL_LOOP)


# ------------------------------------------------------------- generation
@pytest.mark.parametrize("name,lazy", [("simple_gla_noconv", 0), ("simple_gla_noconv", 4),
                                       ("mamba2", 0)])
def test_greedy_generate_matches_jax(name, lazy):
    """Greedy generate_batch with a prompt, token for token against the JAX
    package: classic for simple-GLA without convs and Mamba-2, and lazy
    windows of 4 for simple-GLA."""
    jm, params, tm = _pair(name)
    rng = np.random.default_rng(3)
    x = rng.integers(3, 256, size=(2, 8))
    prompt = rng.integers(0, 50, size=(1, 2, 5))
    kw = dict(max_seqlen=18, first_greedy_quant=0, force_max_seqlen=True, lazy_window=lazy)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))


@pytest.mark.parametrize("lazy", [False, True], ids=["classic", "lazy"])
def test_simple_gla_server_matches_generate(lazy):
    """DecodeServer on simple-GLA without convs, two slots recycled by
    three requests: each completion equals the request's own greedy
    generate_batch, token for token (lazy: windows of the chunk)."""
    _, _, tm = _pair("simple_gla_noconv")
    srv = DecodeServer(tm, n_slots=2, max_text_len=10, chunk=4, lazy=lazy)
    reqs = [([5, 9, 3, 17], np.array([[7, 8, 9]]), 13), ([12, 4, 33, 7, 19], None, 10),
            ([40, 41, 42], np.array([[3, 4]]), 9)]
    rids = [srv.submit(np.asarray(t), prompt=p, max_len=n) for t, p, n in reqs]
    done = {c.rid: c for c in srv.run()}
    assert set(done) == set(rids)
    for rid, (text, prompt, max_len) in zip(rids, reqs):
        ref = generate_batch(tm, torch.tensor([text]),
                             prompt=None if prompt is None else torch.from_numpy(prompt)[:, None],
                             max_seqlen=max_len, k=1, force_max_seqlen=True,
                             lazy_window=4 if lazy else 0)
        toks = ref.tokens[:, 0].T.numpy()
        np.testing.assert_array_equal(done[rid].tokens, toks[:done[rid].length])


def test_mamba2_has_no_lazy_window_and_no_s0_tuning():
    """As in the JAX package: lazy decode (and so state_quant) raises
    TypeError for Mamba-2 states, in generate_batch and in the server, and
    initial-state tuning takes the AttentiveGLA backbones only."""
    from lina_speech_tpu_torch.train.initial_state import train_initial_state

    _, _, tm = _pair("mamba2")
    x = torch.randint(3, 256, (1, 5), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="MambaState"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2)
    with pytest.raises(TypeError, match="MambaState"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, lazy=True, state_quant="int8")
    with pytest.raises(TypeError, match="AttentiveGLA"):
        train_initial_state(tm, [])


def test_unported_kinds_still_raise():
    """A ``cp_axis`` without a mesh carrying it raises ``ValueError``
    (context parallelism is ported: tests/test_torch_cp.py).
    Rematerialization builds and trains one step (its gradients:
    tests/test_torch_remat.py). Every backbone kind of the JAX package and
    the speaker encoder build."""
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, cp_axis="cp"))
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        torch_build(cfg, device="cpu")
    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, remat=True))
    model = torch_build(cfg, device="cpu")
    assert model.attentive_rnn.remat
    state = create_train_state(model, TrainConfig(n_warmup_steps=1, n_training_steps=4))
    state, metrics = make_train_step(model)(state, batch_to_device(_train_batch("padded"), "cpu"))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    cfg = torch_tiny(spk_encoder=SpeakerEncoderConfig(dim_inner=32, heads=2, n_layers=1))
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, kind="transformer"))
    model = torch_build(cfg, device="cpu")
    assert model.spk_encoder is not None and type(model.attentive_rnn).__name__ == \
        "TransformerCrossAtt"


# ---------------------------------------------------- the layer's options
LAYER_OPTIONS = {
    "scalar_gate": dict(scalar_gate=True, expand_v=1.0),
    "clamp_min": dict(clamp_min=-0.05, use_short_conv=True),
    "share_conv_kernel": dict(use_short_conv=True, share_conv_kernel=True),
    "scan": dict(kernel_mode="scan", use_short_conv=True),
}


def _layer_pair(name):
    kw = dict(hidden_size=32, num_heads=2, **LAYER_OPTIONS[name])
    jl = JaxGLA(**kw)
    x = np.random.default_rng(30).normal(size=(2, 13, 32)).astype(np.float32)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # the layer's params under a backbone path, so that the JAX package's
    # naming rules (re-stated in utils/convert.py) apply to them
    flat = {f"attentive_rnn/encoder_0/tmix/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}
    sd = {k.removeprefix("attentive_rnn.encoder.0.tmix."): v
          for k, v in jax_params_to_state_dict(flat).items()}
    tl = GatedLinearAttention(**kw)
    tl.load_state_dict(sd, strict=True)
    return jl, params, tl, x


@pytest.mark.parametrize("name", list(LAYER_OPTIONS))
def test_layer_option_matches_jax(name):
    """One GLA layer with the option on: the prefill from an empty state,
    a decode step from its final state, and the same input as chunks [5, 2,
    6] threading the state with conv_history (the shared conv's
    continuation), against the JAX layer; the chunks also against the
    one-shot prefill."""
    jl, params, tl, x = _layer_pair(name)
    x_t = np.random.default_rng(31).normal(size=(2, 32)).astype(np.float32)
    split = [5, 2, 6]

    def jrun(m, x, x_t):
        out, st = m(x, initial_state=m.empty_state(x.shape[0]), output_final_state=True)
        out_t, st_t = m.step(x_t, st)
        st_c, off, outs = m.empty_state(x.shape[0]), 0, []
        for i, c in enumerate(split):
            o, st_c = m(x[:, off:off + c], initial_state=st_c, output_final_state=True,
                        conv_history=i > 0)
            outs.append(o)
            off += c
        return out, st, out_t, st_t, jnp.concatenate(outs, axis=1), st_c

    jo, js, jo_t, js_t, jo_c, js_c = jl.apply(params, jnp.asarray(x), jnp.asarray(x_t),
                                              method=jrun)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        to, ts = tl(tx, initial_state=tl.empty_state(2), output_final_state=True)
        to_t, ts_t = tl.step(torch.from_numpy(x_t), ts)
        st, off, outs = tl.empty_state(2), 0, []
        for i, c in enumerate(split):
            o, st = tl(tx[:, off:off + c], initial_state=st, output_final_state=True,
                       conv_history=i > 0)
            outs.append(o)
            off += c
    to_c = torch.cat(outs, 1)
    for t_val, j_val in ((to, jo), (to_t, jo_t), (to_c, jo_c)):
        _close(t_val, j_val)
    _close(to_c, to.numpy(), TOL_LOOP)
    fields = [f.name for f in dataclasses.fields(ts) if getattr(ts, f.name) is not None]
    assert ("conv_h" in fields) == (name == "share_conv_kernel")
    for field in fields:
        for t_st, j_st in ((ts, js), (ts_t, js_t), (st, js_c)):
            _close(getattr(t_st, field), getattr(j_st, field))


def test_scan_mode_reaches_the_recurrence():
    """kernel_mode="scan" takes gla_scan_ref for the prefill and refuses
    modes the port has not (chunk_pallas is TPU machinery)."""
    from unittest import mock

    from lina_speech_tpu_torch.models import gla_layer

    _, _, tl, x = _layer_pair("scan")
    with mock.patch.object(gla_layer, "gla_scan_ref", wraps=gla_layer.gla_scan_ref) as scan:
        tl(torch.from_numpy(x))
    assert scan.call_count == 1
    with pytest.raises(NotImplementedError):
        GatedLinearAttention(hidden_size=32, num_heads=2, kernel_mode="chunk_pallas")


# ------------------------------------------------------ repairs: F1, F2
def test_layers_route_heads_the_kernels_do_not_take_to_the_plain_version():
    """F1: a layer asks ``kernel_takes`` before it calls a wrapper. The tiny
    config's heads (key dim 32) get the plain versions under
    kernel_mode="auto"; heads the kernels take get the wrappers."""
    from lina_speech_tpu_torch.ops import gla_cuda

    small = GatedLinearAttention(hidden_size=64, num_heads=2, use_short_conv=True)
    wide = GatedLinearAttention(hidden_size=256, num_heads=2, use_short_conv=True)
    for name in ("gla_chunk_conv", "gla_chunk", "gla_decode_conv", "gla_decode",
                 "gla_decode_lazy_conv"):
        assert small._kernel(name, torch.float32) is getattr(gla_cuda, name + "_plain")
        assert wide._kernel(name, torch.float32) is getattr(gla_cuda, name)
    wide.kernel_mode = "chunk"
    assert wide._kernel("gla_decode", torch.float32) is gla_cuda.gla_decode_plain


def _bf16_model(seed=2, **backbone):
    cfg = torch_tiny(compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **backbone))
    return torch_build(cfg, device="cpu", seed=seed)


def test_generate_and_serving_leave_the_callers_model_unchanged():
    """F2: with f32 parameters and bf16 compute, generate_batch and
    DecodeServer run on cast copies. The model's parameters keep their
    dtype and values, the text encodes the same before and after, and two
    generate_batch calls in a row give the same tokens, as do int8 weights
    quantized twice (from the same cast weights)."""
    tm = _bf16_model()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    x = torch.randint(3, 256, (2, 6), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        x_enc = tm.encode_text(x)
    kw = dict(max_seqlen=12, first_greedy_quant=0, force_max_seqlen=True)
    first = generate_batch(tm, x, **kw)
    with torch.no_grad():
        assert torch.equal(tm.encode_text(x), x_enc)
    second = generate_batch(tm, x, **kw)
    assert torch.equal(first.tokens, second.tokens)
    srv = DecodeServer(tm, n_slots=1, max_text_len=8, chunk=4)
    srv.submit(x[0].numpy(), max_len=8)
    assert len(srv.run()) == 1
    q1 = generate_batch(tm, x, weight_quant="int8", quant_min_size=256, **kw)
    head_q = tm.logits_head.int8_q.clone()
    q2 = generate_batch(tm, x, weight_quant="int8", quant_min_size=256, **kw)
    assert torch.equal(q1.tokens, q2.tokens) and torch.equal(tm.logits_head.int8_q, head_q)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n


def test_generated_tokens_match_jax_twice_in_bf16():
    """F2 against the JAX package: the JAX generate_batch encodes the text
    with the caller's f32 params and decodes on a cast copy; two port calls
    in a row give its greedy tokens both times (bf16 compute)."""
    cfg = lina_gla_tiny(compute_dtype="bfloat16")
    jm = jax_build(cfg)
    x = np.random.default_rng(5).integers(3, 256, size=(2, 6))
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.ones((2, 9, 1), jnp.int32),
        jnp.ones((2, 6, 6), bool), jnp.ones((2, 9, 6), bool), jnp.ones((2, 9), bool))
    kw = dict(max_seqlen=10, first_greedy_quant=0, force_max_seqlen=True)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0), **kw)
    jx_enc = jm.apply(params, jnp.asarray(x), method=JaxLina.encode_text)
    tm = load_jax_params(torch_build(torch_tiny(compute_dtype="bfloat16"), device="cpu"), params)
    for _ in range(2):
        res = generate_batch(tm, torch.from_numpy(x), **kw)
        np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
        with torch.no_grad():
            _close(tm.encode_text(torch.from_numpy(x)), jx_enc, 2e-2)


def test_training_after_generation_trains_f32_parameters():
    """F2: a train step after generate_batch (bf16 compute) updates f32
    parameters from f32 gradients, and its loss is the loss of the same
    step on a model that never generated."""
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_codebook=50, min_audio_len=8, max_audio_len=8, pad_to_multiple=8)),
        "cpu")
    losses = []
    for generate_first in (True, False):
        tm = _bf16_model(seed=6, kind="simple_gla", use_short_conv=False)
        if generate_first:
            generate_batch(tm, batch["text_token"], max_seqlen=6, first_greedy_quant=0)
        state = create_train_state(tm, TrainConfig(n_warmup_steps=1, n_training_steps=4))
        state, metrics = make_train_step(tm)(state, batch)
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1]
