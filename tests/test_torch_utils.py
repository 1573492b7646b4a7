"""The port's ``utils/viz.py``, ``utils/quantize.py:quantize_params`` and
``ops/rotary.py:RotaryEmbedding`` against the JAX package's, on the CPU.

Figures: every axis's image array, title and labels equal to the JAX
package's for the same input (numpy or a tensor), and importing the port's
module loads no matplotlib. ``quantize_params``: on every leaf of tiny GLA
(short and positional convs), Mamba, Mamba-2, RWKV6 and transformer
backbones, the int8 values
and scales equal to JAX's once carried to the JAX layout by
``utils/convert.py``'s layout rules, so the dequantized leaves are equal
too. ``RotaryEmbedding``: the rotated tensors at offsets 0 and 7 within
1e-6 of max|ref|.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.rotary import RotaryEmbedding as JaxRotaryEmbedding
from lina_speech_tpu.utils import quantize as jax_quantize
from lina_speech_tpu.utils import viz as jax_viz
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.ops import RotaryEmbedding
from lina_speech_tpu_torch.utils import convert, viz
from lina_speech_tpu_torch.utils.quantize import QKEY, SKEY, dequantize_params, quantize_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ figures
def same_figure(fig, ref):
    import matplotlib.pyplot as plt

    try:
        assert len(fig.axes) == len(ref.axes)
        np.testing.assert_array_equal(fig.get_size_inches(), ref.get_size_inches())
        for ax, rax in zip(fig.axes, ref.axes):
            assert len(ax.images) == len(rax.images) == 1
            np.testing.assert_array_equal(np.asarray(ax.images[0].get_array()),
                                          np.asarray(rax.images[0].get_array()))
            assert ax.images[0].origin == rax.images[0].origin
            assert (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()) == \
                (rax.get_title(), rax.get_xlabel(), rax.get_ylabel())
    finally:
        plt.close(fig)
        plt.close(ref)


@pytest.mark.parametrize("shape", [(3, 7, 5), (6, 4)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_attention_figure_equals_jax(shape, as_tensor):
    att = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    got = viz.attention_figure(torch.from_numpy(att) if as_tensor else att, "align")
    same_figure(got, jax_viz.attention_figure(att, "align"))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_mel_figure_equals_jax(as_tensor):
    mel = np.random.default_rng(3).normal(size=(20, 33)).astype(np.float32)
    got = viz.mel_figure(torch.from_numpy(mel) if as_tensor else mel, "log-mel")
    same_figure(got, jax_viz.mel_figure(mel, "log-mel"))


def test_save_attention_writes_a_png(tmp_path):
    path = tmp_path / "att.png"
    viz.save_attention(torch.rand(2, 5, 4), str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_viz_import_loads_no_matplotlib():
    code = ("import sys, lina_speech_tpu_torch.utils.viz; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; print('OK')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


# ----------------------------------------------------------- quantize_params
BACKBONES = {
    "gla_conv": dict(kind="gla", use_short_conv=True, pos_type="convolutional"),
    "mamba": dict(kind="mamba"),
    "mamba2": dict(kind="mamba2"),
    "rwkv6": dict(kind="rwkv6"),
    "transformer": dict(kind="transformer"),
}


def backbone_params(name):
    cfg = torch_tiny()
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                **BACKBONES[name]))
    return dict(torch_build(cfg, device="cpu", seed=3).named_parameters())


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_quantize_params_equals_jax(name):
    """Every leaf of a tiny backbone (Linears, the short convs' (d, 1, w),
    the positional conv, Mamba's and Mamba-2's conv_kernel, RWKV6's raw
    matrices, the attention projections, the embeddings, the logits head): the same leaves quantized as by JAX's
    quantize_params on the bridge's JAX tree, and their int8 values, scales
    and dequantized leaves equal once carried to the JAX layout."""
    params = backbone_params(name)
    got = quantize_params(params, min_size=64)
    ref = {path: jax_quantize.quantize_params({"w": jnp.asarray(leaf)}, min_size=64)["w"]
           for path, leaf in convert.named_tensors_to_jax(params).items()}
    quantized = {k for k, v in got.items() if isinstance(v, dict)}
    assert {convert.flax_path_for(k) for k in quantized} == \
        {p for p, v in ref.items() if isinstance(v, dict)}
    assert any(k.endswith("q_conv1d.weight") for k in quantized) or name != "gla_conv"
    assert any(k.endswith("conv_kernel") for k in quantized) or name != "mamba"
    deq = dequantize_params(got, torch.float32)
    for key in quantized:
        path = convert.flax_path_for(key)
        to_jax = lambda t: np.asarray(convert._to_flax(t.numpy(), path))
        np.testing.assert_array_equal(to_jax(got[key][QKEY]), np.asarray(ref[path][QKEY]))
        np.testing.assert_array_equal(to_jax(got[key][SKEY]), np.asarray(ref[path][SKEY]))
        np.testing.assert_array_equal(
            to_jax(deq[key]),
            np.asarray(jax_quantize.dequantize_params({"w": ref[path]}, jnp.float32)["w"]))


def test_quantize_params_passes_small_1d_and_int_leaves_through():
    params = backbone_params("gla_conv")
    params["count"] = torch.ones(64, 64, dtype=torch.int32)
    for min_size in (64, 1 << 16):
        got = quantize_params(params, min_size=min_size)
        for name, v in params.items():
            kept = v.ndim < 2 or v.numel() < min_size or name == "count"
            assert (got[name] is v) == kept, name


# ------------------------------------------------------------------- rotary
@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("rot_dim", [8, 16])
def test_rotary_embedding_equals_jax(offset, rot_dim):
    x = np.random.default_rng(offset).normal(size=(2, 3, 10, 16)).astype(np.float32)
    got = RotaryEmbedding(rot_dim)(torch.from_numpy(x), offset).numpy()
    ref = np.asarray(JaxRotaryEmbedding(rot_dim)(jnp.asarray(x), offset))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_array_equal(got[..., rot_dim:], x[..., rot_dim:])
