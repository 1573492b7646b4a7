"""JAX param tree -> reference-named torch state_dict.

The inverse of ``lina_speech_tpu/utils/checkpoint.py:convert_torch_lina``
(its ``torch_key_for`` / ``_to_flax`` rules, re-stated here so this module
imports no JAX). The port's modules carry the reference torch names, so
the result loads with ``load_state_dict(strict=True)`` -- and so does the
released reference checkpoint, after stripping its Lightning ``model.``
root.
"""
from __future__ import annotations

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
_STATE_FIELDS = ("s", "conv_q", "conv_k", "conv_v", "kbuf", "vbuf", "cbuf", "cc")


def backbone_state_from_arrays(state, device=None):
    """A JAX ``BackboneState`` given as arrays -> the port's.

    ``state`` is any object with ``layers`` (a sequence) and ``pos_net``,
    each entry carrying the GLA state fields (``s``, the conv rings and,
    in lazy mode, the window buffers) as numpy-convertible arrays or None;
    the JAX package's state dataclasses fit as they are. Layouts are the
    same on both sides. bfloat16 arrays stay bfloat16, everything else
    keeps its numpy dtype. Quantized states (``s_scale``) are not ported.
    """
    from lina_speech_tpu_torch.models.attentive_rnn import BackboneState
    from lina_speech_tpu_torch.models.gla_layer import GLAState

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
        if getattr(st, "s_scale", None) is not None:
            raise NotImplementedError("quantized states are not ported "
                                      "(ROADMAP.md Queue 1 item 8)")
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
        for f in _STATE_FIELDS:
            val = getattr(st, f)
            if val is not None:
                out[f"{prefix}/{f}"] = val.detach().float().cpu().numpy()
    return out
