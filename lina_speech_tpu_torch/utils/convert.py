"""JAX param tree <-> reference-named torch state_dict.

The inverse of ``lina_speech_tpu/utils/checkpoint.py:convert_torch_lina``
(its ``torch_key_for`` / ``_to_flax`` rules, re-stated here so this module
imports no JAX). The port's modules carry the reference torch names, so
the result loads with ``load_state_dict(strict=True)`` -- and so does the
released reference checkpoint, after stripping its Lightning ``model.``
root. :func:`named_tensors_to_jax` goes the other way, for gradients and
updated parameters: tensors by torch name -> the JAX tree's paths and
layouts, so that a training step compares leaf by leaf. Decode states
(GLA states with their conv rings, shared or per projection, and int8 ones
with their row scales; Mamba, Mamba-2 and RWKV6 states), the S0 tuning params and
the JAX package's int8-quantized weight tree cross as arrays too. Names the
JAX package's ``torch_key_for`` leaves as they are stay so here too:
Mamba-2's ``conv_kernel``, ``A_log``, ``dt_bias``, ``D`` and
``norm_weight``; Mamba's ``conv_kernel`` (d_inner, d_conv), ``conv_bias``,
``A_log`` (d_inner, d_state) and ``D`` (its four Dense kernels, ``in_proj``,
``x_proj``, ``dt_proj`` with its bias and ``out_proj``, are transposed like
every Linear); RWKV6's
raw parameters ``x_maa``, ``maa``, ``maa_w1``, ``maa_w2``, ``decay_w1``,
``decay_w2``, ``time_decay``, ``time_faaaa``, ``ln_x_scale`` and
``ln_x_bias``, used as ``x @ W`` in both packages and so not transposed
(only its five projections' Dense kernels are); the interleaved backbones'
``cross_att_<i>`` (CrossAttGLA and CrossAttMamba), CrossAttentionPP's
``ca_0``, ``ca_1`` and ``inter_net`` (its ``pos_emb`` table maps like an
embedding).
"""
from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

_CONV = r"(q_conv1d|k_conv1d|v_conv1d|h_conv1d)"


def torch_key_for(flax_path: str) -> Optional[str]:
    """Slash-joined flax param path (no ``params/`` root) -> reference
    state_dict key (no ``model.`` root), or None if it has none."""
    p = re.sub(r"(encoder|decoder|sa|blocks|convnext)_(\d+)", r"\1.\2", flax_path)
    for pat, rep in ((r"^txt_embed/embedding$", "txt_embed.weight"),
                     (r"^rvq_embed/weight$", "rvq_embed.weight"),
                     (r"^logits_weight$", "logits_head.weight"),
                     (r"^txt_encoder/", "txt_encoder."),
                     (r"^attentive_rnn/", "attentive_rnn."),
                     (r"^spk_encoder/", "spk_encoder.")):
        p = re.sub(pat, rep, p)
    if p == flax_path and "/" in p:
        return None
    p = p.replace("/", ".")
    p = re.sub(r"\.gk_proj_1\.", ".gk_proj.0.", p)
    p = re.sub(r"\.gk_proj_2\.", ".gk_proj.1.", p)
    p = re.sub(rf"\.{_CONV}\.kernel$", r".\1.weight", p)
    p = re.sub(r"\.pos_embed\.embed\.embedding$", ".pos_embed.embed.weight", p)
    p = re.sub(r"\.pos_embed\.conv_kernel$", ".pos_embed.dw_conv.weight", p)
    p = re.sub(r"\.pos_embed\.conv_bias$", ".pos_embed.dw_conv.bias", p)
    p = re.sub(r"\.(norm1|norm2|ln_q|ln_k|ln_v)\.scale$", r".\1.weight", p)
    p = re.sub(r"\.kernel$", ".weight", p)
    p = re.sub(r"\.embedding$", ".weight", p)
    return p


def _to_torch(value: np.ndarray, flax_path: str) -> np.ndarray:
    v = np.asarray(value)
    if re.search(rf"{_CONV}/kernel$", flax_path):
        return v[:, None, :]  # (d, w) -> Conv1d (d, 1, w)
    if flax_path.endswith("pos_embed/conv_kernel"):
        return v.transpose(2, 1, 0)  # lax HIO (k, 1, d) -> Conv1d (d, 1, k)
    if flax_path.endswith("/kernel") and v.ndim == 2:
        return v.T  # flax (in, out) -> Linear (out, in)
    return v


def flax_path_for(torch_key: str) -> str:
    """Reference state_dict key -> slash-joined flax param path: the
    inverse of :func:`torch_key_for` on the port's parameter names."""
    top = {"txt_embed.weight": "txt_embed/embedding", "rvq_embed.weight": "rvq_embed/weight",
           "logits_head.weight": "logits_weight"}
    if torch_key in top:
        return top[torch_key]
    p = re.sub(r"\.gk_proj\.0\.", ".gk_proj_1.", torch_key)
    p = re.sub(r"\.gk_proj\.1\.", ".gk_proj_2.", p)
    p = re.sub(r"\.(encoder|decoder|sa|blocks|convnext)\.(\d+)", r".\1_\2", p)
    p = re.sub(rf"\.{_CONV}\.weight$", r".\1.kernel", p)
    p = re.sub(r"\.pos_embed\.embed\.weight$", ".pos_embed.embed.embedding", p)
    p = re.sub(r"\.pos_emb\.weight$", ".pos_emb.embedding", p)  # CrossAttentionPP
    p = re.sub(r"\.pos_embed\.dw_conv\.weight$", ".pos_embed.conv_kernel", p)
    p = re.sub(r"\.pos_embed\.dw_conv\.bias$", ".pos_embed.conv_bias", p)
    p = re.sub(r"\.(norm1|norm2|ln_q|ln_k|ln_v)\.weight$", r".\1.scale", p)
    if not p.endswith(".g_norm_swish_gate.weight"):
        p = re.sub(r"\.weight$", ".kernel", p)
    return p.replace(".", "/")


def _to_flax(value: np.ndarray, flax_path: str) -> np.ndarray:
    """Inverse of :func:`_to_torch`."""
    v = np.asarray(value)
    if re.search(rf"{_CONV}/kernel$", flax_path):
        return v[:, 0, :]  # Conv1d (d, 1, w) -> (d, w)
    if flax_path.endswith("pos_embed/conv_kernel"):
        return v.transpose(2, 1, 0)  # Conv1d (d, 1, k) -> lax HIO (k, 1, d)
    if flax_path.endswith("/kernel") and v.ndim == 2:
        return v.T  # Linear (out, in) -> flax (in, out)
    return v


def named_tensors_to_jax(named) -> Dict[str, np.ndarray]:
    """Tensors by torch parameter name (``named_parameters()``, or their
    ``.grad``s) -> {flax path: f32 array in the JAX layout}."""
    out = {}
    for key, val in dict(named).items():
        path = flax_path_for(key)
        out[path] = np.ascontiguousarray(
            _to_flax(val.detach().float().cpu().numpy(), path))
    return out


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def jax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """JAX params (nested, or flat with slash-joined paths; values numpy or
    anything ``np.asarray`` takes) -> torch state_dict (CPU tensors)."""
    flat = _flatten(params) if any(isinstance(v, Mapping) for v in params.values()) \
        else dict(params)
    sd = {}
    for path, val in flat.items():
        rel = re.sub(r"^params/", "", path)
        key = torch_key_for(rel)
        if key is None:
            raise KeyError(f"no torch name for JAX param {path!r}")
        sd[key] = torch.tensor(np.ascontiguousarray(
            _to_torch(np.asarray(val, np.float32), rel)))
    return sd


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load JAX params into a port model with ``strict=True``.

    The rotary ``freqs`` buffers have no JAX counterpart (JAX computes them
    analytically, as the buffers hold), so the model keeps its own.
    """
    sd = jax_params_to_state_dict(params)
    for key, val in model.state_dict().items():
        if key.endswith("rotary.freqs"):
            sd[key] = val
    model.load_state_dict(sd, strict=True)
    return model


# ------------------------------------------------------------ decode states
_STATE_FIELDS = ("s", "conv_q", "conv_k", "conv_v", "conv_h", "kbuf", "vbuf", "cbuf", "cc",
                 "s_scale")
_MAMBA_FIELDS = ("h", "conv")
_RWKV6_FIELDS = ("s", "shift")


def backbone_state_from_arrays(state, device=None):
    """A JAX ``BackboneState`` given as arrays -> the port's.

    ``state`` is any object with ``layers`` (a sequence) and ``pos_net``,
    each entry carrying a layer state's fields as numpy-convertible arrays
    or None: a GLA state (``s``, the conv rings and, in lazy mode, the
    window buffers), a Mamba state (``h`` (b, d_inner, d_state), ``conv``
    (d_conv, b, d_inner)), a Mamba-2 state (``h`` (b, heads * d_state,
    headdim), ``conv``) or an RWKV6 state (``s`` (b, h, dk, dv), ``shift``
    (b, d)); the JAX package's state dataclasses fit as they
    are. Layouts are the same on both sides. bfloat16 arrays stay bfloat16,
    everything else keeps its numpy dtype: an int8 state ``s`` stays int8
    and brings its f32 row scales ``s_scale``.
    """
    from lina_speech_tpu_torch.models.attentive_rnn import BackboneState
    from lina_speech_tpu_torch.models.gla_layer import GLAState
    from lina_speech_tpu_torch.models.mamba import MambaState
    from lina_speech_tpu_torch.models.rwkv6 import RWKV6State

    def leaf(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes; numpy has no bf16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device) if device is not None else t

    def one(st):
        if st is None:
            return None
        if hasattr(st, "h") and hasattr(st, "conv"):
            return MambaState(**{f: leaf(getattr(st, f)) for f in _MAMBA_FIELDS})
        if hasattr(st, "shift"):
            return RWKV6State(**{f: leaf(getattr(st, f)) for f in _RWKV6_FIELDS})
        return GLAState(**{f: leaf(getattr(st, f, None)) for f in _STATE_FIELDS})

    return BackboneState(layers=tuple(one(st) for st in state.layers),
                         pos_net=one(state.pos_net))


def backbone_state_to_arrays(state) -> Dict[str, np.ndarray]:
    """The port's ``BackboneState`` -> {"layers/3/conv_q": f32 array, ...}
    (``pos_net/...`` for the cross-attention's block), for comparison with
    the JAX package's state leaf by leaf."""
    out = {}
    named = [(f"layers/{i}", st) for i, st in enumerate(state.layers)]
    named.append(("pos_net", state.pos_net))
    for prefix, st in named:
        if st is None:
            continue
        for f in dataclasses.fields(st):
            val = getattr(st, f.name)
            if val is not None:
                out[f"{prefix}/{f.name}"] = val.detach().float().cpu().numpy()
    return out


# ------------------------------------------------------- int8 weight trees
def quantized_tree_from_jax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The int8 leaves of the JAX package's quantized params tree (nested,
    values numpy-convertible; a quantized leaf is an ``{int8_q, int8_s}``
    mapping, in the JAX layout: a Dense kernel's q (in, out) and s (1,
    out)) -> ``{torch parameter name: {int8_q, int8_s}}`` in the port's
    layout (q (out, in), s (out, 1); the logits head's (q, l, d) and (q, l,
    1) as they are), which ``LinaModel.load_int8_`` takes. Float leaves are
    left out."""
    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping) and "int8_q" in v:
                rel = re.sub(r"^params/", "", path)
                key = torch_key_for(rel)
                if key is None:
                    raise KeyError(f"no torch name for JAX param {path!r}")
                q, sc = np.asarray(v["int8_q"]), np.asarray(v["int8_s"], np.float32)
                if q.ndim == 2:
                    q, sc = q.T, sc.T
                out[key] = {"int8_q": torch.from_numpy(np.array(q)),  # writable copies
                            "int8_s": torch.from_numpy(np.array(sc))}
            elif isinstance(v, Mapping):
                out.update(walk(v, path))
        return out

    return walk(tree, "")


# ------------------------------------------------------- S0 tuning params
def tuning_params_from_arrays(params, device=None):
    """The JAX package's S0 tuning params (a list with, per block, a
    ``(k, v)`` pair of arrays or one full-state array) -> the port's: the
    same list of f32 tensors on ``device``."""
    leaf = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return [tuple(leaf(a) for a in p) if isinstance(p, (tuple, list)) else leaf(p)
            for p in params]


def tuning_params_to_arrays(params):
    """The port's S0 tuning params (or their gradients, in the same
    structure) -> the same list with numpy arrays."""
    leaf = lambda t: t.detach().float().cpu().numpy()
    return [tuple(leaf(t) for t in p) if isinstance(p, tuple) else leaf(p) for p in params]
