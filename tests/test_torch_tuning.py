"""Initial-state (S0) tuning of the port vs the JAX package, on the CPU.

The tuning params are drawn by JAX and cross into the port as arrays
(``utils/convert.py``), so both sides differentiate the same function of the
same numbers; f32 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.train import initial_state as jtuning
from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
from lina_speech_tpu_torch.train import initial_state as tuning
from lina_speech_tpu_torch.train.harness import batch_to_device
from lina_speech_tpu_torch.utils.convert import (
    tuning_params_from_arrays, tuning_params_to_arrays,
)
from test_torch_model import _make_pair


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    return _make_pair("convolutional")


def _batch(seed=7):
    return next(synthetic_tts_batches(batch_size=2, n_quant=1, n_codebook=50, min_audio_len=8,
                                      max_audio_len=12, pad_to_multiple=8, seed=seed))


@pytest.mark.parametrize("rank", [1, None], ids=["rank1", "full"])
def test_tuning_gradients_and_update_match_jax(pair, rank):
    """Loss and the gradient of every S0 param against jax.value_and_grad of
    the JAX tuning loss (each leaf within 1e-4 of its own max|ref|); the
    model's parameters take no gradient; after ``grad_acc`` = 2 micro-steps
    the Adam update (lr 0.1) matches the JAX tuning step's (rank 1 only;
    1e-3 of the learning rate: Adam's first step is lr * sign(g), whatever
    g's size)."""
    jm, params, tm = pair
    cfg = dict(lr=0.1, rank=rank, scale=0.02, grad_acc=2)
    jtune = jm.attentive_rnn.init_state_tuning_params(jax.random.PRNGKey(3), rank=rank, scale=0.02)
    batch = _batch()

    def loss_fn(tp):
        init = jm.attentive_rnn.state_from_params(tp, 2, scale=0.02)
        return jm.apply(params, batch["text_token"], batch["audio_token"], batch["encoder_mask"],
                        batch["crossatt_mask"], logits_mask=batch["y_mask"], init_state=init)[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jtune)
    ttune = tuning_params_from_arrays(jtune)
    leaves = tuning.tuning_leaves(ttune)
    assert len(leaves) == (8 if rank else 4)
    for t in leaves:
        t.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=0.1)
    step = tuning.make_tuning_step(tm, tuning.InitialStateTuningConfig(**cfg), ttune, optimizer)
    tb = batch_to_device(batch, "cpu")
    loss = step(0, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = tuning_params_to_arrays([tuple(t.grad for t in p) if isinstance(p, tuple) else p.grad
                                   for p in ttune])
    flat = lambda ps: [a for p in ps for a in (p if isinstance(p, tuple) else (p,))]
    for i, (a, r) in enumerate(zip(flat(got), flat(jgrads))):
        r = np.asarray(r)
        assert float(np.abs(r).max()) > 0, i
        assert float(np.abs(a - r).max()) <= 1e-4 * float(np.abs(r).max()), i
    assert all(p.grad is None and p.requires_grad for p in tm.parameters())

    if rank is None:
        return
    # the second micro-step triggers the update; the JAX step does the same
    # (it donates its arguments, so it gets copies)
    import optax

    start = jax.tree_util.tree_map(np.asarray, jtune)
    jtune = jax.tree_util.tree_map(jnp.array, start)

    jopt = optax.adam(0.1)
    jstep = jtuning.make_tuning_step(jm, jtuning.InitialStateTuningConfig(**cfg), jopt)
    jstate = (jtune, jopt.init(jtune), jax.tree_util.tree_map(jnp.zeros_like, jtune))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        tp, opt_state, acc, _ = jstep(params, *jstate, jnp.asarray(i), jb)
        jstate = (tp, opt_state, acc)
    step(1, tb)
    assert all(t.grad is None for t in leaves)
    for a, r, start in zip(flat(tuning_params_to_arrays(ttune)), flat(jstate[0]), flat(start)):
        assert float(np.abs(a - np.asarray(r)).max()) <= 1e-3 * 0.1
        assert float(np.abs(np.asarray(start) - np.asarray(r)).max()) > 0.05


def test_initial_state_tuning_loop_reduces_loss(pair):
    """tests/test_data_and_tuning.py's loop on the port: overfitting S0 on
    one fixed batch lowers the loss, the model does not move, and the tuned
    params survive speaker_state_dict / parse_speaker_state."""
    _, _, tm = pair
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    fixed = batch_to_device(_batch(), "cpu")
    cfg = tuning.InitialStateTuningConfig(lr=0.5, rank=1, grad_acc=1, batch_size=2)
    tuned, losses = tuning.train_initial_state(
        tm, [fixed] * 10, cfg, generator=torch.Generator().manual_seed(0))
    assert len(losses) == 10
    assert losses[-1] < losses[0]
    assert all(torch.equal(p, before[n]) for n, p in tm.named_parameters())
    assert len(tuned) == 4 and tuned[0][0].shape == (1, 1, 2, 32, 1)
    back = tuning.parse_speaker_state(tuning.speaker_state_dict(tuned))
    for (a_k, a_v), (b_k, b_v) in zip(tuned, back):
        assert torch.equal(a_k.detach(), b_k) and torch.equal(a_v.detach(), b_v)
    snaps, _ = tuning.train_initial_state(
        tm, [fixed] * 4, tuning.InitialStateTuningConfig(rank=None, grad_acc=2),
        save_every_k_steps=1)
    assert len(snaps) == 3 and snaps[0][0].shape == (1, 2, 32, 64)
    full = tuning.parse_speaker_state(tuning.speaker_state_dict(snaps[-1]))
    assert len(full) == 4 and full[0].shape == (1, 2, 32, 64)
