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
the JAX package's int8-quantized weight tree cross as arrays too, and so
do the transformer's KV caches (``TransformerState`` with its scalar
clocks). Names the
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

The WavTokenizer codec has a bridge of its own (the key map of
``lina_speech_tpu/utils/convert_wavtokenizer.py`` run both ways):
:func:`wavtokenizer_state_dict_from_jax` and its inverse, and
:func:`load_wavtokenizer_state_dict` for a reference checkpoint, with its
weight-normed convs folded.
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


def _to_torch(value, flax_path: str):
    """One leaf in the JAX layout -> the port's (numpy arrays, or tensors
    as they are)."""
    v = value if torch.is_tensor(value) else np.asarray(value)
    if re.search(rf"{_CONV}/kernel$", flax_path):
        return v[:, None, :]  # (d, w) -> Conv1d (d, 1, w)
    if flax_path.endswith("pos_embed/conv_kernel"):
        return v.swapaxes(0, 2)  # lax HIO (k, 1, d) -> Conv1d (d, 1, k)
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


def _to_flax(value, flax_path: str):
    """Inverse of :func:`_to_torch`."""
    v = value if torch.is_tensor(value) else np.asarray(value)
    if re.search(rf"{_CONV}/kernel$", flax_path):
        return v[:, 0, :]  # Conv1d (d, 1, w) -> (d, w)
    if flax_path.endswith("pos_embed/conv_kernel"):
        return v.swapaxes(0, 2)  # Conv1d (d, 1, k) -> lax HIO (k, 1, d)
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
    are. A state whose layers are KV caches (``k``, ``v`` (b, h, max_seqlen,
    d_head) and the scalar clock ``t``), with no ``pos_net``, becomes the
    transformer's ``TransformerState`` with ``t`` a host int. Layouts are
    the same on both sides. bfloat16 arrays stay bfloat16,
    everything else keeps its numpy dtype: an int8 state ``s`` stays int8
    and brings its f32 row scales ``s_scale``.
    """
    from lina_speech_tpu_torch.models.attentive_rnn import BackboneState
    from lina_speech_tpu_torch.models.gla_layer import GLAState
    from lina_speech_tpu_torch.models.mamba import MambaState
    from lina_speech_tpu_torch.models.rwkv6 import RWKV6State
    from lina_speech_tpu_torch.models.transformer import KVState, TransformerState

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
        if hasattr(st, "t"):
            return KVState(k=leaf(st.k), v=leaf(st.v), t=int(np.asarray(st.t)))
        if hasattr(st, "h") and hasattr(st, "conv"):
            return MambaState(**{f: leaf(getattr(st, f)) for f in _MAMBA_FIELDS})
        if hasattr(st, "shift"):
            return RWKV6State(**{f: leaf(getattr(st, f)) for f in _RWKV6_FIELDS})
        return GLAState(**{f: leaf(getattr(st, f, None)) for f in _STATE_FIELDS})

    if not hasattr(state, "pos_net"):
        return TransformerState(layers=tuple(one(st) for st in state.layers))
    return BackboneState(layers=tuple(one(st) for st in state.layers),
                         pos_net=one(state.pos_net))


def backbone_state_to_arrays(state) -> Dict[str, np.ndarray]:
    """The port's ``BackboneState`` -> {"layers/3/conv_q": f32 array, ...}
    (``pos_net/...`` for the cross-attention's block), for comparison with
    the JAX package's state leaf by leaf; a ``TransformerState`` gives
    ``layers/i/k``, ``layers/i/v`` and the clock ``layers/i/t`` as a 0-d
    array."""
    out = {}
    named = [(f"layers/{i}", st) for i, st in enumerate(state.layers)]
    named.append(("pos_net", getattr(state, "pos_net", None)))
    for prefix, st in named:
        if st is None:
            continue
        for f in dataclasses.fields(st):
            val = getattr(st, f.name)
            if isinstance(val, int):
                out[f"{prefix}/{f.name}"] = np.asarray(val, np.float32)
            elif val is not None:
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


# ------------------------------------------------------------ WavTokenizer
# The JAX WavTokenizer's params <-> the port's state_dict, which carries the
# reference checkpoint's names: the key map of
# lina_speech_tpu/utils/convert_wavtokenizer.py:42-158 run both ways. Kinds:
# "conv" lax HIO (k, in, out) <-> Conv1d (out, in, k); "convtr" HIO <->
# ConvTranspose1d (in, out, k) with the taps reversed (lax.conv_transpose
# does not flip its kernel, torch's transposed conv does); "dense" flax
# (in, out) <-> (out, in), also the LSTM's (in, 4H) <-> (4H, in); "plain"
# as is (norm scales become ``weight``).
_ENCODER = "feature_extractor.encodec.encoder.model."
_CODEBOOK = "feature_extractor.encodec.quantizer.vq.layers.{}._codebook.embed"


def _seanet_pairs(n_ratios: int, n_residual_layers: int = 1, lstm: int = 2,
                  decoder: bool = False):
    """(JAX path under the SEANet module, key under its ``model``
    Sequential, kind) for every parameter of a SEANet encoder / decoder."""
    pairs = []

    def conv(jax_name, key, kind="conv"):
        sub = "convtr.convtr" if kind == "convtr" else "conv.conv"
        pairs.extend([(f"{jax_name}/kernel", f"{key}.{sub}.weight", kind),
                      (f"{jax_name}/bias", f"{key}.{sub}.bias", "plain")])

    def res_blocks(i, idx):
        for j in range(n_residual_layers):
            for name, sub in (("conv1", "block.1"), ("conv2", "block.3"),
                              ("shortcut", "shortcut")):
                conv(f"res_{i}_{j}/{name}", f"{idx + j}.{sub}")

    def lstm_layers(idx):
        for n in range(lstm):
            for w in ("ih", "hh"):
                pairs.extend([(f"lstm/w_{w}_{n}", f"{idx}.lstm.weight_{w}_l{n}", "dense"),
                              (f"lstm/b_{w}_{n}", f"{idx}.lstm.bias_{w}_l{n}", "plain")])

    conv("conv_in", 0)
    idx = 1
    if decoder:  # [conv_in, LSTM, (ELU, up, res blocks) per ratio, ELU, conv_out]
        if lstm:
            lstm_layers(idx)
            idx += 1
        for i in range(n_ratios):
            conv(f"up_{i}", idx + 1, "convtr")
            res_blocks(i, idx + 2)
            idx += 2 + n_residual_layers
    else:  # [conv_in, (res blocks, ELU, down) per ratio, LSTM, ELU, conv_out]
        for i in range(n_ratios):
            res_blocks(i, idx)
            conv(f"down_{i}", idx + n_residual_layers + 1)
            idx += n_residual_layers + 2
        if lstm:
            lstm_layers(idx)
            idx += 1
    conv("conv_out", idx + 1)
    return pairs


def _vocos_pairs(num_layers: int):
    """(JAX path under the VocosBackbone, key under it, kind)."""
    pairs = []

    def conv(jax_name, key):
        pairs.extend([(f"{jax_name}/kernel", f"{key}.weight", "conv"),
                      (f"{jax_name}/bias", f"{key}.bias", "plain")])

    def norm(jax_name, key):
        pairs.extend([(f"{jax_name}/scale", f"{key}.weight", "plain"),
                      (f"{jax_name}/bias", f"{key}.bias", "plain")])

    conv("embed", "embed")
    for i in (0, 1, 3, 4):
        for sub in ("norm1", "conv1", "norm2", "conv2"):
            (norm if sub.startswith("norm") else conv)(f"pos_net_{i}/{sub}", f"pos_net.{i}.{sub}")
    norm("pos_net_2/norm", "pos_net.2.norm")
    for sub in ("q", "k", "v", "proj_out"):
        conv(f"pos_net_2/{sub}", f"pos_net.2.{sub}")
    norm("pos_net_5", "pos_net.5")
    norm("norm", "norm")
    for i in range(num_layers):
        conv(f"convnext_{i}/dwconv", f"convnext.{i}.dwconv")
        norm(f"convnext_{i}/norm", f"convnext.{i}.norm")
        for sub in ("pwconv1", "pwconv2"):
            pairs.extend([(f"convnext_{i}/{sub}/kernel", f"convnext.{i}.{sub}.weight", "dense"),
                          (f"convnext_{i}/{sub}/bias", f"convnext.{i}.{sub}.bias", "plain")])
        pairs.append((f"convnext_{i}/gamma", f"convnext.{i}.gamma", "plain"))
    norm("final_layer_norm", "final_layer_norm")
    return pairs


def _wavtokenizer_pairs(n_ratios: int, n_q: int, num_layers: int):
    """Every parameter of a WavTokenizer with ``n_ratios`` downsampling
    stages, ``n_q`` codebooks and ``num_layers`` ConvNeXt blocks: (JAX path,
    state_dict key, kind); the codebook's layers as ``codebook/{i}``."""
    return ([(f"encoder/{p}", _ENCODER + k, kind) for p, k, kind in _seanet_pairs(n_ratios)]
            + [(f"codebook/{i}", _CODEBOOK.format(i), "plain") for i in range(n_q)]
            + [(f"backbone/{p}", f"backbone.{k}", kind) for p, k, kind in _vocos_pairs(num_layers)]
            + [("head/out/kernel", "head.out.weight", "dense"),
               ("head/out/bias", "head.out.bias", "plain")])


def _jax_to_torch_layout(v: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return v.transpose(2, 1, 0)
    if kind == "convtr":
        return v.transpose(1, 2, 0)[..., ::-1]
    return v.T if kind == "dense" else v


def _torch_to_jax_layout(v: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return v.transpose(2, 1, 0)
    if kind == "convtr":
        return v[..., ::-1].transpose(2, 0, 1)
    return v.T if kind == "dense" else v


def _pairs_from_jax(flat: Dict[str, np.ndarray], pairs) -> Dict[str, torch.Tensor]:
    """Flat JAX params (slash paths) -> state_dict by ``pairs``; every
    param must be named by exactly one pair."""
    want = {p for p, _, _ in pairs}
    if set(flat) != want:
        raise KeyError(f"JAX params without a pair: {sorted(set(flat) - want)[:8]}; "
                       f"pairs without a param: {sorted(want - set(flat))[:8]}")
    return {key: torch.tensor(np.ascontiguousarray(
        _jax_to_torch_layout(np.asarray(flat[path], np.float32), kind)))
        for path, key, kind in pairs}


def _pairs_to_jax(state_dict, pairs) -> Dict[str, np.ndarray]:
    """state_dict -> flat JAX params (slash paths) by ``pairs``; every key
    must be named by exactly one pair."""
    want = {k for _, k, _ in pairs}
    if set(state_dict) != want:
        raise KeyError(f"keys without a pair: {sorted(set(state_dict) - want)[:8]}; "
                       f"pairs without a key: {sorted(want - set(state_dict))[:8]}")
    return {path: np.ascontiguousarray(_torch_to_jax_layout(
        torch.as_tensor(state_dict[key]).detach().float().cpu().numpy(), kind))
        for path, key, kind in pairs}


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _count(keys, pattern: str) -> int:
    """Distinct values of ``pattern``'s group over ``keys``."""
    return len({m.group(1) for k in keys if (m := re.match(pattern, k))})


def wavtokenizer_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's WavTokenizer params (nested, with or without the
    ``params`` root; values numpy or anything ``np.asarray`` takes) -> the
    port's state_dict (CPU f32 tensors, reference key names). The depth
    (downsampling stages, ConvNeXt blocks, codebooks) is read off the
    params."""
    flat = {re.sub(r"^params/", "", k): np.asarray(v) for k, v in _flatten(params).items()}
    codebook = flat.pop("codebook")
    flat.update({f"codebook/{i}": c for i, c in enumerate(codebook)})
    pairs = _wavtokenizer_pairs(_count(flat, r"encoder/down_(\d+)/"), len(codebook),
                                _count(flat, r"backbone/convnext_(\d+)/"))
    return _pairs_from_jax(flat, pairs)


def wavtokenizer_state_dict_to_jax(state_dict) -> dict:
    """Inverse of :func:`wavtokenizer_state_dict_from_jax`: the port's
    state_dict -> ``{"params": ...}`` numpy tree of the JAX WavTokenizer."""
    n_q = _count(state_dict, r"feature_extractor\.encodec\.quantizer\.vq\.layers\.(\d+)\.")
    # the encoder's plain convs: conv_in, one down conv a stage, conv_out
    n_ratios = _count(state_dict, re.escape(_ENCODER) + r"(\d+)\.conv\.conv\.weight$") - 2
    pairs = _wavtokenizer_pairs(n_ratios, n_q, _count(state_dict, r"backbone\.convnext\.(\d+)\."))
    flat = _pairs_to_jax(state_dict, pairs)
    flat["codebook"] = np.stack([flat.pop(f"codebook/{i}") for i in range(n_q)])
    return {"params": _nest(flat)}


_WN_LEAVES = ("v", "g", "bias")  # a WNConv's parameters (codec/discriminators.py)


def discriminator_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's discriminator params (``MultiPeriodDiscriminator``,
    ``MultiResolutionDiscriminator``, ``MultiScaleSTFTDiscriminator`` or
    ``DACDiscriminator``; nested, with or without the ``params`` root) -> the
    port's state_dict of the same class (CPU f32 tensors). The modules carry
    the JAX names, so ``period_2/conv_0/v`` is ``period_2.conv_0.v``; a
    weight-normed kernel ``v`` goes from HWIO to OIHW, ``g`` and ``bias`` as
    they are."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"^params/", "", path)
        leaf = path.rsplit("/", 1)[-1]
        if leaf not in _WN_LEAVES:
            raise KeyError(f"{path}: not a weight-normed conv's parameter")
        v = np.asarray(value, np.float32)
        out[path.replace("/", ".")] = torch.tensor(np.ascontiguousarray(
            v.transpose(3, 2, 0, 1) if leaf == "v" else v))
    return out


def discriminator_state_dict_to_jax(state_dict) -> dict:
    """Inverse of :func:`discriminator_state_dict_from_jax`: the port's
    discriminator state_dict -> ``{"params": ...}`` numpy tree."""
    flat = {}
    for key, value in state_dict.items():
        v = torch.as_tensor(value).detach().float().cpu().numpy()
        flat[key.replace(".", "/")] = np.ascontiguousarray(
            v.transpose(2, 3, 1, 0) if key.endswith(".v") else v)
    return {"params": _nest(flat)}


def fold_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray) -> np.ndarray:
    """Fold torch weight_norm (g, v) into a plain weight: w = g v / ||v||,
    the norm over every dim but the first (torch's default)."""
    v, g = np.asarray(weight_v), np.asarray(weight_g)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / norm


# the VQ's EMA statistics: codec training state (ROADMAP.md Queue 1 item 10)
_VQ_TRAINING = re.compile(r"\._codebook\.(inited|cluster_size|embed_avg)$")


def load_wavtokenizer_state_dict(wavtok: torch.nn.Module, state_dict):
    """Load a reference WavTokenizer checkpoint's state_dict (tensors or
    arrays, no Lightning ``state_dict`` wrapper) into the port's codec.

    Weight-normed convs (``weight_g`` / ``weight_v``) are folded into
    ``weight`` (:func:`fold_weight_norm`). Keys of modules the port does not
    have (the EnCodec decoder, the discriminators and losses, the ISTFT's
    window buffer) and the VQ's EMA statistics are not read; everything else
    loads with ``load_state_dict(strict=True)``, so a missing or unknown
    leaf of a ported module raises.
    """
    sd = {k: np.asarray(v.detach().float().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    for key in [k for k in sd if k.endswith(".weight_g")]:
        base = key[:-len("_g")]
        sd[base] = fold_weight_norm(sd.pop(key), sd.pop(base + "_v"))
    modules = dict(wavtok.named_modules())
    keep = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()
            if k.rpartition(".")[0] in modules and not _VQ_TRAINING.search(k)}
    wavtok.load_state_dict(keep, strict=True)
    return wavtok


# ------------------------------------------------- EnCodec and its LM
# The JAX EncodecModel's params <-> the port's state_dict: the SEANet
# encoder and decoder by their key maps (``encoder.model.*``,
# ``decoder.model.*``), the stacked codebook (n_q, bins, dim) as the
# quantizer's layers. The JAX EncodecLM's: ``emb_{k}`` -> ``emb.{k}``,
# ``head_{k}`` -> ``linears.{k}``, ``transformer/layers_{i}/...`` ->
# ``transformer.layers.{i}....``, Dense kernels transposed.
def _encodec_pairs(n_ratios: int, n_q: int):
    return ([(f"encoder/{p}", f"encoder.model.{k}", kind) for p, k, kind in _seanet_pairs(n_ratios)]
            + [(f"decoder/{p}", f"decoder.model.{k}", kind)
               for p, k, kind in _seanet_pairs(n_ratios, decoder=True)]
            + [(f"codebook/{i}", f"quantizer.layers.{i}._codebook.embed", "plain")
               for i in range(n_q)])


def encodec_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncodecModel`` params (nested, with or without
    the ``params`` root) -> the port's state_dict (CPU f32 tensors). The
    depth is read off the params; a param without a key, or a key without
    a param, raises ``KeyError``."""
    flat = {re.sub(r"^params/", "", k): np.asarray(v) for k, v in _flatten(params).items()}
    codebook = flat.pop("codebook")
    flat.update({f"codebook/{i}": c for i, c in enumerate(codebook)})
    return _pairs_from_jax(flat, _encodec_pairs(_count(flat, r"encoder/down_(\d+)/"),
                                                len(codebook)))


def encodec_state_dict_to_jax(state_dict) -> dict:
    """Inverse of :func:`encodec_state_dict_from_jax`: ``{"params": ...}``."""
    n_q = _count(state_dict, r"quantizer\.layers\.(\d+)\.")
    n_ratios = _count(state_dict, r"encoder\.model\.(\d+)\.conv\.conv\.weight$") - 2
    flat = _pairs_to_jax(state_dict, _encodec_pairs(n_ratios, n_q))
    flat["codebook"] = np.stack([flat.pop(f"codebook/{i}") for i in range(n_q)])
    return {"params": _nest(flat)}


def _encodec_lm_pairs(n_q: int, n_layers: int):
    pairs = []

    def dense(jax_name, key):
        pairs.extend([(f"{jax_name}/kernel", f"{key}.weight", "dense"),
                      (f"{jax_name}/bias", f"{key}.bias", "plain")])

    def norm(jax_name, key):
        pairs.extend([(f"{jax_name}/scale", f"{key}.weight", "plain"),
                      (f"{jax_name}/bias", f"{key}.bias", "plain")])

    for k in range(n_q):
        pairs.append((f"emb_{k}/embedding", f"emb.{k}.weight", "plain"))
        dense(f"head_{k}", f"linears.{k}")
    for i in range(n_layers):
        for sub in ("norm1", "norm2"):
            norm(f"transformer/layers_{i}/{sub}", f"transformer.layers.{i}.{sub}")
        for sub in ("qkv", "out", "fc1", "fc2"):
            dense(f"transformer/layers_{i}/{sub}", f"transformer.layers.{i}.{sub}")
    norm("transformer/norm_in", "transformer.norm_in")
    norm("transformer/norm_out", "transformer.norm_out")
    return pairs


def encodec_lm_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncodecLM`` params (nested, with or without the
    ``params`` root) -> the port's state_dict (CPU f32 tensors); unknown or
    missing leaves raise ``KeyError``."""
    flat = {re.sub(r"^params/", "", k): np.asarray(v) for k, v in _flatten(params).items()}
    return _pairs_from_jax(flat, _encodec_lm_pairs(_count(flat, r"emb_(\d+)/"),
                                                   _count(flat, r"transformer/layers_(\d+)/")))


def encodec_lm_state_dict_to_jax(state_dict) -> dict:
    """Inverse of :func:`encodec_lm_state_dict_from_jax`: ``{"params": ...}``."""
    pairs = _encodec_lm_pairs(_count(state_dict, r"emb\.(\d+)\."),
                              _count(state_dict, r"transformer\.layers\.(\d+)\."))
    return {"params": _nest(_pairs_to_jax(state_dict, pairs))}
