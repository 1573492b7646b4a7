"""PyTorch port generate_batch vs the JAX package, on the CPU.

Greedy decoding only: the torch generator and JAX keys give different
random numbers, so sampled streams are not comparable token for token.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.generate import cut_outputs as jax_cut, generate_batch as jax_generate
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import cut_outputs, generate_batch
from lina_speech_tpu_torch.utils.convert import load_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden", "tiny.json")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_tiny(seed):
    """The scripts/golden_tokens.py setup: tiny config, params from seed+2."""
    model = jax_build(lina_gla_tiny())
    b, m = 2, 11
    x = jax.random.randint(jax.random.PRNGKey(seed), (b, m), 3, 256)
    y = jax.random.randint(jax.random.PRNGKey(seed + 1), (b, 9, 1), 3, 53)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(seed + 2), x, y, jnp.ones((b, m, m), bool),
        jnp.ones((b, 9, m), bool), jnp.ones((b, 9), bool))
    return model, params, np.array(x)


def test_golden_tiny_reproduced():
    golden = json.load(open(GOLDEN))
    _, params, x = _jax_tiny(golden["seed"])
    tm = load_jax_params(torch_build(torch_tiny(), device="cpu"), params)
    res = generate_batch(tm, torch.from_numpy(x), max_seqlen=golden["steps"],
                         first_greedy_quant=0, force_max_seqlen=True)
    assert res.tokens.tolist() == golden["tokens"]


def test_greedy_generate_with_prompt_matches_jax():
    jm, params, x = _jax_tiny(77)
    prompt = np.random.default_rng(3).integers(0, 50, size=(1, 2, 6))
    kw = dict(max_seqlen=20, first_greedy_quant=0, return_att=True)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **kw)
    tm = load_jax_params(torch_build(torch_tiny(), device="cpu"), params)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.stop_mask.numpy(), np.asarray(jres.stop_mask))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    assert tres.n_steps == int(jres.n_steps)
    np.testing.assert_allclose(tres.att.numpy(), np.asarray(jres.att), rtol=1e-4, atol=1e-4)
    for (tc, ta), (jc, ja) in zip(cut_outputs(tres, 1), jax_cut(jres, 1)):
        np.testing.assert_array_equal(tc, jc)
        assert ta.shape == ja.shape


def test_sampled_generate_and_unported_options():
    tm = torch_build(torch_tiny(), device="cpu", seed=1)
    x = torch.randint(3, 256, (3, 5), generator=torch.Generator().manual_seed(0))
    res = generate_batch(tm, x, torch.Generator().manual_seed(1), max_seqlen=9, k=5,
                         force_max_seqlen=True)
    assert res.tokens.shape == (1, 3, 9) and res.n_steps == 9
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < tm.n_target_vocab
    # int8 weights and states are ported (tests/test_torch_quant.py), and so
    # is CFG (tests/test_torch_cfg.py): without a mask token (mask_text_p 0)
    # it raises ValueError, as the JAX package does
    for kw in ({"state_quant": "int4", "lazy_window": 4}, {"approx_topk": True}):
        with pytest.raises(NotImplementedError):
            generate_batch(tm, x, max_seqlen=4, **kw)
    with pytest.raises(ValueError, match="mask_text_p"):
        generate_batch(tm, x, max_seqlen=4, cfg_coef=1.5)
    with pytest.raises(ValueError):
        generate_batch(tm, x, max_seqlen=4, state_quant="int8")  # needs lazy_window
