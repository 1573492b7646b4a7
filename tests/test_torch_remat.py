"""Rematerialization (``backbone.remat``) in the port, on the CPU.

Each encoder and decoder block of the GLA and simple-GLA backbones runs
under ``models/attentive_rnn.py:checkpoint_block`` in training mode
without an initial state. With dropout 0.1 in the blocks (and in the text
encoder, with text masking on) the gradients equal, bit for bit, those of
the same model without remat; ``torch.utils.checkpoint`` alone would
recompute each block with other dropout masks, and a control shows that it
does. With dropout 0 the remat model trains as the JAX package's
``nn.remat`` model does, at the tolerance of
``test_torch_train.py::test_three_train_steps_match_jax``. The kinds the
JAX package gives no ``remat`` to ignore it here too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu import config as jconfig
from lina_speech_tpu.train import harness as jharness
from lina_speech_tpu_torch import config as tconfig
from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
from lina_speech_tpu_torch.models import attentive_rnn
from lina_speech_tpu_torch.train import harness
from lina_speech_tpu_torch.utils.convert import load_jax_params, named_tensors_to_jax

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(remat, dropout=0.1, **backbone):
    cfg = tconfig.lina_gla_tiny(mask_text_p=0.2 if dropout else 0.0)
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, remat=remat, dropout=dropout,
                                          use_short_conv=True, pos_type="convolutional",
                                          **backbone),
        text_encoder=dataclasses.replace(cfg.text_encoder, dropout=dropout))


def _batch(seed=0, batch_size=3):
    return harness.batch_to_device(next(synthetic_tts_batches(
        batch_size=batch_size, n_codebook=50, min_audio_len=9, max_audio_len=21, pad_to_multiple=8,
        seed=seed, structured=True)), "cpu")


def _grads(model, batch, seed=3):
    """Loss and every parameter's gradient of one training forward, its
    dropout and text masking drawn from a generator seeded with ``seed``."""
    model.train()
    model.set_generator(torch.Generator().manual_seed(seed))
    model.zero_grad(set_to_none=True)
    loss = model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
                 batch["crossatt_mask"], logits_mask=batch["y_mask"])[1]
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.eval()
    return float(loss.detach()), grads


@pytest.fixture
def count_checkpoints(monkeypatch):
    calls = []
    real = attentive_rnn.checkpoint_block

    def counted(block, x, **kw):
        calls.append(block)
        return real(block, x, **kw)

    monkeypatch.setattr(attentive_rnn, "checkpoint_block", counted)
    return calls


@pytest.mark.parametrize("kind", [dict(), dict(kind="simple_gla"),
                                  dict(blind=False, cross_att_pp=True)],
                         ids=["gla", "simple_gla", "gla_pp"])
def test_remat_gradients_equal_bit_for_bit_with_dropout(kind, count_checkpoints):
    batch = _batch()
    loss, ref = _grads(tconfig.build_model(_cfg(False, **kind), device="cpu"), batch)
    assert not count_checkpoints
    model = tconfig.build_model(_cfg(True, **kind), device="cpu")
    got_loss, got = _grads(model, batch)
    assert len(count_checkpoints) == 2 * model.attentive_rnn.n_layer
    assert got_loss == loss and got.keys() == ref.keys()
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    assert all(bool(g.abs().max() > 0) for n, g in got.items() if "drop" not in n)


def test_checkpoint_alone_draws_other_dropout_masks(monkeypatch):
    """The control: ``torch.utils.checkpoint`` without the generator's state
    set back recomputes the blocks with other masks, and the gradients move
    (which is what the test above would catch)."""
    batch = _batch()
    _, ref = _grads(tconfig.build_model(_cfg(False), device="cpu"), batch)
    monkeypatch.setattr(attentive_rnn, "checkpoint_block", lambda blk, x, **kw:
                        torch.utils.checkpoint.checkpoint(lambda x: blk(x, **kw), x,
                                                          use_reentrant=False))
    _, naive = _grads(tconfig.build_model(_cfg(True), device="cpu"), batch)
    differ = [n for n in ref if not torch.equal(naive[n], ref[n])]
    assert len(differ) > len(ref) // 2


def test_remat_only_in_training_without_an_initial_state(count_checkpoints):
    """Eval forwards, forwards that carry a state (S0 tuning, prefill) and a
    train step with two micro-batches: checkpoints only where JAX takes
    them, and the step equals the non-remat step bit for bit."""
    model = tconfig.build_model(_cfg(True), device="cpu")
    batch = _batch(1)
    args = (batch["text_token"], batch["audio_token"], batch["encoder_mask"],
            batch["crossatt_mask"])
    with torch.no_grad():
        model(*args, logits_mask=batch["y_mask"])
        x = model.embed_tokens(batch["audio_token"].permute(2, 0, 1))
        ctx = model.encode_text(batch["text_token"], batch["encoder_mask"])
        model.train()
        model.set_generator(torch.Generator().manual_seed(0))
        model.attentive_rnn(x, ctx, mask=batch["crossatt_mask"], output_final_state=True)
        model.eval()
    assert not count_checkpoints
    plain = tconfig.build_model(_cfg(False), device="cpu")
    states = [harness.create_train_state(m, harness.TrainConfig(n_warmup_steps=1,
                                                                grad_accum_steps=2))
              for m in (plain, model)]
    metrics = [harness.make_train_step(m, grad_accum_steps=2)(
        s, _batch(2, batch_size=4), torch.Generator().manual_seed(4))[1] for m, s in zip((plain, model),
                                                                              states)]
    assert len(count_checkpoints) == 2 * 2 * model.attentive_rnn.n_layer
    assert float(metrics[0]["loss"]) == float(metrics[1]["loss"])
    for (n, p), q in zip(plain.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("kind", [dict(kind="mamba2"), dict(kind="rwkv6"), dict(kind="mamba"),
                                  dict(cross_att_layers=(1,), blind=False)],
                         ids=["mamba2", "rwkv6", "mamba", "crossatt_gla"])
def test_kinds_without_remat_ignore_it(kind, count_checkpoints):
    """As in the JAX package, which passes ``remat`` to the GLA and
    simple-GLA backbones only: the others build and train without it."""
    batch = _batch()
    loss, ref = _grads(tconfig.build_model(_cfg(False, dropout=0.0, **kind), device="cpu"),
                       batch)
    got_loss, got = _grads(tconfig.build_model(_cfg(True, dropout=0.0, **kind), device="cpu"),
                           batch)
    assert not count_checkpoints
    assert got_loss == loss and all(torch.equal(got[n], ref[n]) for n in ref)


def test_remat_trains_as_the_jax_remat_model():
    """The tiny config with ConvPos and short convs (the flagship's
    architecture, as in test_three_train_steps_match_jax), ``remat=True``
    and no dropout: JAX's model (its blocks under ``nn.remat``) and the
    port's from the same params, three steps of each package's train step on
    that test's batch: loss, grad_norm and acc_0 within 1e-4 relative each
    step, and every parameter after the third within 1e-4 of its own max|ref|
    plus 1e-3 of the sum of the learning rates (the zero-gradient key-side
    biases within that sum), that test's tolerance."""
    bb = dict(pos_type="convolutional", use_short_conv=True, remat=True)
    jcfg = jconfig.lina_gla_tiny()
    jm = jconfig.build_model(dataclasses.replace(
        jcfg, backbone=dataclasses.replace(jcfg.backbone, **bb)))
    assert jm.attentive_rnn.remat
    b0 = next(synthetic_tts_batches(batch_size=4, n_quant=1, n_codebook=50, min_audio_len=8,
                                    max_audio_len=14, pad_to_multiple=8, structured=True))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), b0["text_token"], b0["audio_token"],
                              b0["encoder_mask"], b0["crossatt_mask"], b0["y_mask"])
    tcfg = tconfig.lina_gla_tiny()
    tm = load_jax_params(tconfig.build_model(dataclasses.replace(
        tcfg, backbone=dataclasses.replace(tcfg.backbone, **bb)), device="cpu"), params)
    batches = [b0] * 3
    train = dict(learning_rate=5e-4, n_warmup_steps=2, n_training_steps=10)
    lr_sum = 2.5e-4 + 5e-4
    jstate = jharness.create_train_state(jm, params, jharness.TrainConfig(**train))
    jstep = jharness.make_train_step(jm, donate=False)
    tstate = harness.create_train_state(tm, harness.TrainConfig(**train))
    tstep = harness.make_train_step(tm)
    for i, b in enumerate(batches):
        jstate, jmet = jstep(jstate, b, jax.random.PRNGKey(1))
        tstate, tmet = tstep(tstate, harness.batch_to_device(b, "cpu"),
                             torch.Generator().manual_seed(1))
        for k in ("loss", "grad_norm", "acc_0"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                       err_msg=f"{k} {i}")
    got = named_tensors_to_jax(tm.named_parameters())
    ref = traverse_util.flatten_dict(jstate.params["params"], sep="/")
    assert set(got) == set(ref)
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        err = np.abs(got[path] - r)
        noise = np.zeros(r.shape, bool)  # elements whose gradient is zero
        if path.endswith("ln_k/bias"):
            noise[:] = True
        elif path.endswith("qkv/bias"):
            noise[r.shape[0] // 3:2 * r.shape[0] // 3] = True
        assert float(err[noise].max(initial=0.0)) <= lr_sum * 1.001, path
        if not noise.all():
            tol = 1e-4 * float(np.abs(r[~noise]).max()) + 1e-3 * lr_sum
            assert float(err[~noise].max()) <= tol, (path, float(err[~noise].max()), tol)
