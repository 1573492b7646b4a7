"""The port's training path vs the JAX package, on the CPU (tiny config).

The JAX model is initialized by JAX and its params cross into the port
(``utils/convert.py``); batches are numpy arrays from the port's own data
pipeline, which is first shown to equal the JAX package's array by array.
Both sides compute in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu import data as jdata
from lina_speech_tpu.models.accuracy import topk_accuracy as jax_topk
from lina_speech_tpu.ops import tools as jtools
from lina_speech_tpu.train import harness as jharness
from lina_speech_tpu_torch.data import collate as tcollate
from lina_speech_tpu_torch.data import synthetic as tsynth
from lina_speech_tpu_torch.data.tokenizer import ByteTokenizer, TextTokenizer
from lina_speech_tpu_torch.models.accuracy import topk_accuracy
from lina_speech_tpu_torch.ops import tools as ttools
from lina_speech_tpu_torch.train import harness
from lina_speech_tpu_torch.utils.convert import named_tensors_to_jax
from test_torch_model import _make_pair


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model with the same weights): the tiny
    config with ConvPos and short convs, the flagship's architecture."""
    return _make_pair("convolutional")


def _batch(seed=0, batch_size=4):
    return next(tsynth.synthetic_tts_batches(
        batch_size=batch_size, n_quant=1, n_codebook=50, min_audio_len=8, max_audio_len=14,
        pad_to_multiple=8, seed=seed, structured=True))


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(), dict(structured=True, speaker=3),
                                dict(n_quant=2, pad_to_multiple=1)], ids=str)
def test_synthetic_batches_equal_the_jax_package(kw):
    args = dict(batch_size=3, n_codebook=50, min_audio_len=5, max_audio_len=20, seed=7, **kw)
    ours, theirs = tsynth.synthetic_tts_batches(**args), jdata.synthetic_tts_batches(**args)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_collate_and_packed_collate_equal_the_jax_package():
    rng = np.random.default_rng(0)
    items = [{"audio_token": rng.integers(0, 50, (2, n)), "text": t}
             for n, t in ((10, "ab"), (6, "abcd"), (3, "x y z"))]
    pairs = [(tcollate.collate_tts(items, TextTokenizer(), pad_to_multiple=4),
              jdata.collate_tts(items, jdata.TextTokenizer(), pad_to_multiple=4)),
             (tcollate.packed_collate_tts(items, TextTokenizer(), offset=1),
              jdata.packed_collate_tts(items, jdata.TextTokenizer(), offset=1))]
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tok = ByteTokenizer()
    assert tok.encode("hé") == jdata.ByteTokenizer().encode("hé")
    assert tok.decode(tok.encode("hello world")) == "hello world"


def test_mask_helpers_equal_the_jax_package():
    np.testing.assert_array_equal(ttools.packmask_2d([3, 2], [4, 1], offset=1),
                                  jtools.packmask_2d([3, 2], [4, 1], offset=1))
    np.testing.assert_array_equal(ttools.packed_reset_mask([3, 2, 4], total=8),
                                  jtools.packed_reset_mask([3, 2, 4], total=8))
    seqs = [np.ones((2, 3), np.int64), np.ones((4, 1), np.int64)]
    np.testing.assert_array_equal(ttools.pad_2d_sequence(seqs, 7), jtools.pad_2d_sequence(seqs, 7))
    np.testing.assert_array_equal(
        ttools.sequence_mask(torch.tensor([1, 3]), 4).numpy(),
        np.asarray(jtools.sequence_mask(jnp.asarray([1, 3]), 4)))


def test_topk_accuracy_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    logits = np.round(rng.normal(size=(3, 9, 40)), 1).astype(np.float32)  # ties
    target = rng.integers(0, 40, size=(3, 9))
    mask = rng.random((3, 9)) > 0.3
    for k, m in ((10, mask), (1, None), (3, mask)):
        ours = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(target), top_k=k,
                             mask=None if m is None else torch.from_numpy(m))
        theirs = jax_topk(jnp.asarray(logits), jnp.asarray(target), top_k=k,
                          mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_cosine_schedule_matches_jax():
    ours = harness.cosine_schedule_with_warmup(5e-4, 3, 20)
    theirs = jharness.cosine_schedule_with_warmup(5e-4, 3, 20)
    assert ours(0) == 0.0  # the first warmup step runs at lr 0, as in optax
    for step in (0, 1, 2, 3, 4, 11, 20, 25):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5, atol=1e-12)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_three_train_steps_match_jax(pair, grad_clip):
    """Three optimizer steps of make_train_step against the JAX step (the
    tiny config has no dropout): loss and grad_norm per step within 1e-4
    relative, and every parameter after the third step within 1e-4 of its
    own max|ref| plus 1e-3 of the sum of the learning rates (lr 5e-4, warmup
    2: the steps run at 0, 2.5e-4 and 5e-4). The second term is Adam's: it
    turns a relative error of a gradient element into an absolute error of
    the step of up to the learning rate, and an element whose gradient is
    small beside its own rounding noise carries such an error. Each leaf is
    also required to have moved by more than its tolerance.

    The key-side biases of the softmax attentions (``ln_k/bias`` and the key
    third of the text encoder's ``qkv/bias``) have a gradient that is zero
    in exact arithmetic, so what reaches Adam is rounding noise, which Adam
    normalizes to steps of the learning rate's size: those elements are held
    to the sum of the learning rates, which bounds any Adam walk."""
    jm, params, tm = pair
    cfg = dict(learning_rate=5e-4, n_warmup_steps=2, n_training_steps=10, grad_clip=grad_clip)
    lr_sum = 2.5e-4 + 5e-4
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jstate = jharness.create_train_state(jm, params, jharness.TrainConfig(**cfg))
    jstep = jharness.make_train_step(jm, donate=False)
    tstate = harness.create_train_state(tm, harness.TrainConfig(**cfg))
    tstep = harness.make_train_step(tm)
    batch = _batch()
    try:
        for i in range(3):
            jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(0))
            tstate, tmet = tstep(tstate, harness.batch_to_device(batch, "cpu"))
            assert tmet.keys() == jmet.keys()
            for k in ("loss", "grad_norm", "acc_0"):
                np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=f"{k} {i}")
        assert tstate.step == int(jstate.step) == 3
        got = named_tensors_to_jax(tm.named_parameters())
        before = named_tensors_to_jax(start)
        ref = traverse_util.flatten_dict(jstate.params["params"], sep="/")
        assert set(got) == set(ref)
        for path, r in ref.items():
            r = np.asarray(r, np.float32)
            err = np.abs(got[path] - r)
            noise = np.zeros(r.shape, bool)  # zero-gradient elements
            if path.endswith("ln_k/bias"):
                noise[:] = True
            elif path.endswith("qkv/bias"):
                noise[r.shape[0] // 3:2 * r.shape[0] // 3] = True
            assert float(err[noise].max(initial=0.0)) <= lr_sum * 1.001, path
            if noise.all():
                continue
            tol = 1e-4 * float(np.abs(r[~noise]).max()) + 1e-3 * lr_sum
            assert float(err[~noise].max()) <= tol, (path, float(err[~noise].max()), tol)
            assert float(np.abs(before[path] - r)[~noise].max()) > tol, path
    finally:
        tm.load_state_dict({**tm.state_dict(), **start})
        tm.eval()


def test_grad_accum_matches_full_batch(pair):
    """grad_accum_steps=2 over a batch of equal lengths equals the
    full-batch step (tests/test_data_and_tuning.py holds the JAX step to the
    same)."""
    _, _, tm = pair
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = next(tsynth.synthetic_tts_batches(batch_size=4, n_quant=1, n_codebook=50,
                                              min_audio_len=8, max_audio_len=8, pad_to_multiple=8))
    batch = harness.batch_to_device(batch, "cpu")
    cfg = harness.TrainConfig(n_warmup_steps=2, n_training_steps=10)
    try:
        _, m1 = harness.make_train_step(tm)(harness.create_train_state(tm, cfg), batch)
        tm.load_state_dict({**tm.state_dict(), **start})
        _, m2 = harness.make_train_step(tm, grad_accum_steps=2)(
            harness.create_train_state(tm, cfg), batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-3)
    finally:
        tm.load_state_dict({**tm.state_dict(), **start})
        tm.eval()


def test_eval_step_and_packed_batch_train(pair):
    """make_eval_step leaves the model untouched and agrees with the JAX
    eval step; a packed batch (reset_mask, crossatt_pos) goes through the
    train step."""
    jm, params, tm = pair
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = _batch(seed=3)
    cfg = dict(n_warmup_steps=1, n_training_steps=10)
    jmet = jharness.make_eval_step(jm)(
        jharness.create_train_state(jm, params, jharness.TrainConfig(**cfg)), batch)
    state = harness.create_train_state(tm, harness.TrainConfig(**cfg))
    tmet = harness.make_eval_step(tm)(state, harness.batch_to_device(batch, "cpu"))
    for k in ("loss", "acc_0"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4)
    assert all(torch.equal(p, start[n]) for n, p in tm.named_parameters())
    rng = np.random.default_rng(0)
    items = [{"audio_token": rng.integers(0, 50, (1, n)), "text": t}
             for n, t in ((12, "pack one"), (9, "pack two"))]
    packed = tcollate.packed_collate_tts(items, TextTokenizer())
    try:
        _, met = harness.make_train_step(tm)(state, harness.batch_to_device(packed, "cpu"))
        assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    finally:
        tm.load_state_dict({**tm.state_dict(), **start})
        tm.eval()


def test_bf16_compute_train_and_tuning_steps_run():
    """f32 parameters with bf16 compute, the flagship's training dtypes: the
    hidden stream leaves the LayerNorms in f32, so the logits head sees an
    f32 stream and a bf16 weight and must promote as jnp.einsum does. One
    train step and one tuning step give finite numbers, gradients arrive in
    f32, and the logits come back in f32."""
    import dataclasses

    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.train.initial_state import (
        InitialStateTuningConfig, train_initial_state,
    )

    cfg = lina_gla_tiny(compute_dtype="bfloat16")
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, pos_type="convolutional"),
        text_encoder=dataclasses.replace(cfg.text_encoder, dropout=0.1))
    model = build_model(cfg, device="cpu", seed=2)
    batch = harness.batch_to_device(_batch(seed=5, batch_size=2), "cpu")
    with torch.no_grad():
        logits = model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
                       batch["crossatt_mask"], logits_mask=batch["y_mask"])[0]
    assert logits.dtype == torch.float32
    state = harness.create_train_state(model, harness.TrainConfig(n_warmup_steps=1))
    state, metrics = harness.make_train_step(model)(state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _, losses = train_initial_state(model, [batch], InitialStateTuningConfig(grad_acc=1))
    assert np.isfinite(losses[0])
