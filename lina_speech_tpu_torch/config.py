"""Config dataclasses, presets and the model builder (PyTorch port).

Field for field the same as ``lina_speech_tpu/config.py`` so a YAML config
or a preset means the same model in both packages; only ``build_model``
differs, building the PyTorch modules. The port covers every backbone kind
of the JAX package: the GLA family, ``kind="gla"`` (with ``cross_att_pp``,
and with ``cross_att_layers`` the interleaved CrossAttGLA),
``"simple_gla"`` and ``"mamba2"``; ``"rwkv6"``; ``"mamba"`` (Mamba v1,
with ``cross_att_layers`` the interleaved CrossAttMamba); the softmax
``"transformer"``. It builds the speaker encoder too. ``remat`` is taken
by the kinds the JAX package gives it to (``"gla"`` without
``cross_att_layers``, and ``"simple_gla"``) and ignored by the others, as
there; ``cp_axis`` raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    kind: str = "gla"  # gla | simple_gla | rwkv6 | mamba | transformer
    d_model: int = 1024
    n_layer: int = 12
    heads: int = 4
    dropout_att: float = 0.0
    dropout: float = 0.0
    blind: bool = True
    cross_att_pp: bool = False
    d_blind: Optional[int] = None
    rotary: bool = False
    use_short_conv: bool = True
    expand_k: float = 1.0
    expand_v: float = 2.0
    pos_type: str = "convolutional"
    chunk_size: int = 64
    remat: bool = False
    cross_att_layers: Tuple[int, ...] = ()
    state_dtype: str = "float32"  # "bfloat16" halves decode state traffic
    # auto  -- the CUDA kernels for CUDA tensors, their plain PyTorch
    #          versions for CPU tensors and for heads the kernels do not
    #          take (ops/gla_cuda.py:kernel_takes);
    # chunk -- the plain PyTorch versions on every device (the reference
    #          path the kernels are held against on the card);
    # scan  -- as chunk, with the O(T) recurrence for the GLA prefill.
    kernel_mode: str = "auto"
    cp_axis: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    dim: int = 1024
    heads: int = 4
    n_layers: int = 4
    dropout: float = 0.1
    rotary: bool = True


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    dim_inner: int = 256
    heads: int = 4
    n_layers: int = 6
    window_length: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = BackboneConfig()
    text_encoder: TextEncoderConfig = TextEncoderConfig()
    spk_encoder: Optional[SpeakerEncoderConfig] = None
    d_model: int = 1024
    quant_layer: Tuple[int, ...] = (0,)
    n_codebook: int = 4096
    n_special_token_in: int = 3
    n_special_token_out: int = 3
    n_txt_vocab: int = 256
    tie_embed: bool = False
    mask_text_p: float = 0.0
    compute_dtype: str = "float32"  # float32 | bfloat16

    @property
    def n_quant(self) -> int:
        return len(self.quant_layer)


def lina_gla_169m(**overrides) -> ModelConfig:
    """The released flagship, Lina-GLA "169M" (359,302,978 parameters at
    the reference's own defaults; see lina_speech_tpu/config.py)."""
    return dataclasses.replace(ModelConfig(), **overrides)


def lina_gla_tiny(**overrides) -> ModelConfig:
    """Small config for tests / smoke runs."""
    cfg = ModelConfig(
        backbone=BackboneConfig(d_model=64, n_layer=2, heads=2, chunk_size=16,
                                pos_type="sinusoidal"),
        text_encoder=TextEncoderConfig(dim=64, heads=2, n_layers=2, dropout=0.0),
        d_model=64,
        n_codebook=50,
    )
    return dataclasses.replace(cfg, **overrides)


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """Construct the LinaModel with f32 parameters initialized from a
    ``torch.Generator`` seeded with ``seed`` (models/lina.py:init_params).

    The model is built on the GPU: ``device=None`` means ``"cuda"`` and
    raises without one. The CPU is used only when the caller asks for it
    (``device="cpu"``). It comes back in eval mode (no dropout).
    """
    from lina_speech_tpu_torch.models.attentive_rnn import AttentiveGLA, CrossAttGLA
    from lina_speech_tpu_torch.models.encoder import SimpleSpeakerEncoder, TextEncoder
    from lina_speech_tpu_torch.models.lina import LinaModel, init_params
    from lina_speech_tpu_torch.models.mamba import AttentiveMamba, AttentiveMamba2, CrossAttMamba
    from lina_speech_tpu_torch.models.rwkv6 import AttentiveRWKV6
    from lina_speech_tpu_torch.models.simple_gla import AttentiveSimpleGLA
    from lina_speech_tpu_torch.models.transformer import TransformerCrossAtt

    b = cfg.backbone
    if b.kind not in ("gla", "simple_gla", "mamba2", "rwkv6", "mamba", "transformer"):
        raise ValueError(f"unknown backbone kind {b.kind}")
    if b.cp_axis is not None:
        raise NotImplementedError(
            "context parallelism is not ported yet (ROADMAP.md Queue 1 item 11)")

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device; pass device=\"cpu\" to build "
                "the model on the CPU")
        device = "cuda"

    # as the JAX package's build_model (config.py:132-226): only the
    # AttentiveGLA of kind "gla" takes state_dtype, it and simple-GLA take
    # remat, simple-GLA takes use_short_conv but not expand_k / expand_v,
    # RWKV6 and Mamba none of the three; the interleaved stacks take no
    # blind / PP options; the transformer takes its width, heads,
    # cross_att_layers (default the middle layer) and dropout_att, and
    # nothing of kernel_mode
    dtype = torch_dtype(cfg.compute_dtype)
    common = dict(d_model=b.d_model, n_layer=b.n_layer, heads=b.heads, dropout=b.dropout,
                  kernel_mode=b.kernel_mode, dtype=dtype)
    stack = dict(d_blind=b.d_blind, blind=b.blind, cross_att_pp=b.cross_att_pp,
                 rotary=b.rotary, pos_type=b.pos_type)
    if b.kind == "gla" and b.cross_att_layers:
        rnn = CrossAttGLA(cross_att_layers=b.cross_att_layers, rotary=b.rotary,
                          use_short_conv=b.use_short_conv, expand_k=b.expand_k,
                          expand_v=b.expand_v, chunk_size=b.chunk_size, **common)
    elif b.kind == "gla":
        rnn = AttentiveGLA(use_short_conv=b.use_short_conv, expand_k=b.expand_k,
                           expand_v=b.expand_v, chunk_size=b.chunk_size, remat=b.remat,
                           state_dtype=torch_dtype(b.state_dtype), **stack, **common)
    elif b.kind == "simple_gla":
        rnn = AttentiveSimpleGLA(use_short_conv=b.use_short_conv, chunk_size=b.chunk_size,
                                 remat=b.remat, **stack, **common)
    elif b.kind == "rwkv6":
        rnn = AttentiveRWKV6(**stack, **common)
    elif b.kind == "mamba" and b.cross_att_layers:
        rnn = CrossAttMamba(cross_att_layers=b.cross_att_layers, rotary=b.rotary, **common)
    elif b.kind == "mamba":
        rnn = AttentiveMamba(**stack, **common)
    elif b.kind == "transformer":
        rnn = TransformerCrossAtt(
            d_model=b.d_model, n_layer=b.n_layer, heads=b.heads,
            cross_att_layers=tuple(b.cross_att_layers) or (b.n_layer // 2,),
            dropout_att=b.dropout_att, dtype=dtype)
    else:
        rnn = AttentiveMamba2(headdim=64 if (2 * b.d_model) % 64 == 0 else 16,
                              **stack, **common)
    te = cfg.text_encoder
    txt_encoder = TextEncoder(dim=te.dim, heads=te.heads, n_layers=te.n_layers,
                              dropout=te.dropout, rotary=te.rotary, dtype=dtype)
    spk_encoder = None
    if cfg.spk_encoder is not None:
        se = cfg.spk_encoder
        spk_encoder = SimpleSpeakerEncoder(
            dim=cfg.d_model, dim_inner=se.dim_inner, heads=se.heads,
            n_layers=se.n_layers, window_length=se.window_length, dtype=dtype)
    model = LinaModel(
        attentive_rnn=rnn,
        d_model=cfg.d_model,
        n_quant=cfg.n_quant,
        n_codebook=cfg.n_codebook,
        n_special_token_in=cfg.n_special_token_in,
        n_special_token_out=cfg.n_special_token_out,
        n_txt_vocab_base=cfg.n_txt_vocab,
        tie_embed=cfg.tie_embed,
        txt_encoder=txt_encoder,
        spk_encoder=spk_encoder,
        mask_text_p=cfg.mask_text_p,
        dtype=dtype,
    )
    init_params(model, torch.Generator().manual_seed(seed))
    # inference mode, as the JAX package's ``deterministic=True`` default:
    # the train step switches dropout on (``model.train()``)
    return model.to(device).eval()


_NESTED_CONFIGS = {
    "backbone": BackboneConfig,
    "text_encoder": TextEncoderConfig,
    "spk_encoder": SpeakerEncoderConfig,
}


def _dataclass_from_dict(cls, d: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        if isinstance(v, dict) and k in _NESTED_CONFIGS:
            kwargs[k] = _dataclass_from_dict(_NESTED_CONFIGS[k], v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config: ``{"model": ModelConfig, "train": TrainConfig,
    "data": dict}``, with ``data.quant_layer`` overriding
    ``model.quant_layer`` (reference train_lina.py:125-127), as in the JAX
    package."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    model_d = raw.get("model", {})
    data_d = raw.get("data", {})
    if "quant_layer" in data_d:
        model_d["quant_layer"] = data_d["quant_layer"]
    from lina_speech_tpu_torch.train.harness import TrainConfig

    return {"model": _dataclass_from_dict(ModelConfig, model_d),
            "train": _dataclass_from_dict(TrainConfig, raw.get("train", {})), "data": data_d}
