"""Weight-only int8 quantization for the decode loop.

Counterpart of ``lina_speech_tpu/utils/quantize.py``. Decode at batch 1
reads every weight once per token, so storing the large matrices as int8
with per-output-channel scales halves the bytes the token loop streams.
Opt-in quality knob: ``generate_batch(weight_quant="int8")`` and
``DecodeServer(weight_quant="int8")``; prefill and text encoding run at
full precision unless the server is told otherwise.

Scheme: symmetric int8, one scale per output channel, ``max|w| / 127``
floored at 1e-12, round half to even, clip to +-127. The functions work on
a flat mapping ``{parameter name: tensor}`` in the port's own (PyTorch)
names and layouts: a Linear weight is ``(out, in)``, so its scale reduces
over axis 1 and has the broadcast shape ``(out, 1)``; leaves with three or
more axes (the per-quantizer logits head ``(q, l, d)``) reduce over the
last axis. Dequantization is uniformly ``q * s``. The JAX package holds the
same numbers transposed (``(in, out)`` and ``(1, out)``);
``utils/convert.py:quantized_tree_from_jax`` carries one into the other.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Optional

import torch

from lina_speech_tpu_torch.utils.convert import flax_path_for

QKEY = "int8_q"
SKEY = "int8_s"


def quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{int8_q, int8_s}`` of one float leaf in the port's layout."""
    wf = w.float()
    s = wf.abs().amax(dim=-1, keepdim=True) / 127.0
    s = s.clamp(min=1e-12)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {QKEY: q, SKEY: s}


def is_quantized_leaf(node) -> bool:
    return isinstance(node, Mapping) and QKEY in node


def _is_dense_weight(name: str, v: torch.Tensor) -> bool:
    """A Linear weight (the JAX tree's 2-D ``kernel`` leaves with at least
    32 output features; conv taps and embeddings are not) or the 3-D logits
    head."""
    if name == "logits_head.weight":
        return v.ndim == 3
    return (v.ndim == 2 and v.shape[0] >= 32
            and flax_path_for(name).endswith("/kernel"))


def quantize_dense_params(params: Mapping, min_size: int = 1 << 16,
                          exclude: Optional[Callable[[str], bool]] = None) -> dict:
    """Replace every Linear weight with at least ``min_size`` elements and
    at least 32 output features, and the 3-D ``logits_head.weight``, by its
    ``{int8_q, int8_s}`` pair; everything else passes through (norms,
    biases, conv taps, embeddings, the narrow low-rank gate projections).

    ``params``: ``{parameter name: tensor}`` as ``named_parameters()`` or a
    state_dict gives it. ``exclude``: optional ``fn(parameter name) ->
    bool``; matching leaves stay full precision.
    """
    out = {}
    for name, v in params.items():
        take = (torch.is_tensor(v) and v.is_floating_point()
                and _is_dense_weight(name, v) and v.numel() >= min_size
                and not (exclude is not None and exclude(name)))
        out[name] = quantize_leaf(v.detach()) if take else v
    return out


def dequantize_params(tree: Mapping, dtype: torch.dtype) -> dict:
    """Every int8 pair of ``tree`` becomes ``q.to(dtype) * s.to(dtype)``."""
    return {name: v[QKEY].to(dtype) * v[SKEY].to(dtype) if is_quantized_leaf(v) else v
            for name, v in tree.items()}


def quantized_bytes(tree: Mapping) -> int:
    """Total stored bytes of a (possibly partially) quantized mapping."""
    total = 0
    for v in tree.values():
        if isinstance(v, Mapping):
            total += quantized_bytes(v)
        elif torch.is_tensor(v):
            total += v.numel() * v.element_size()
    return total
