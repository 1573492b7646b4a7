"""WavTokenizer: the neural audio codec's inference API (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/wavtokenizer.py`` (reference
decoder/pretrained.py:96-239):

- :meth:`WavTokenizer.encode` -- audio -> SEANet latents -> VQ codes;
- :meth:`WavTokenizer.codes_to_features` -- codes -> summed codebook rows;
- :meth:`WavTokenizer.decode` -- features -> VocosBackbone -> ISTFT head
  -> waveform;
- :func:`vocode_streaming` -- the same decode over clamped windows, yielded
  as codes arrive.

The modules carry the reference checkpoint's names (``feature_extractor.
encodec.encoder.model.*``, ``feature_extractor.encodec.quantizer.vq.
layers.{i}._codebook.embed``, ``backbone.*``, ``head.out``), so
``utils/convert.py`` moves weights from the JAX package and from a
reference checkpoint by name. Public tensors keep the JAX layouts: audio
(B, T), features (B, T', d), codes (n_q, B, T').

Flagship = WavTokenizer medium-speech "320_24k": hop 320 (75 Hz at 24 kHz),
one 4096-entry codebook of dim 512, backbone 768 / 2304 x 12, n_fft 1280.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn

from lina_speech_tpu_torch.codec.heads import ISTFTHead
from lina_speech_tpu_torch.codec.seanet import SEANetEncoder, _Holder
from lina_speech_tpu_torch.codec.vocos import VocosBackbone
from lina_speech_tpu_torch.codec.vq import VectorQuantizer, vq_decode, vq_encode
from lina_speech_tpu_torch.models.base_blocks import Linear


@dataclasses.dataclass(frozen=True)
class WavTokenizerConfig:
    sample_rate: int = 24000
    # encoder
    ratios: Tuple[int, ...] = (8, 5, 4, 2)  # hop = prod = 320 -> 75 Hz
    n_filters: int = 32
    latent_dim: int = 512
    # quantizer
    n_q: int = 1
    bins: int = 4096
    # vocoder
    backbone_dim: int = 768
    backbone_intermediate_dim: int = 2304
    backbone_layers: int = 12
    n_fft: int = 1280
    hop_length: int = 320

    @property
    def hop(self) -> int:
        return math.prod(self.ratios)


class WavTokenizer(nn.Module):
    def __init__(self, config: WavTokenizerConfig = WavTokenizerConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.feature_extractor = _Holder(encodec=_Holder(
            encoder=SEANetEncoder(dimension=c.latent_dim, n_filters=c.n_filters,
                                  ratios=c.ratios, dtype=dtype),
            quantizer=_Holder(vq=VectorQuantizer(c.n_q, c.bins, c.latent_dim))))
        self.backbone = VocosBackbone(c.latent_dim, c.backbone_dim,
                                      c.backbone_intermediate_dim, c.backbone_layers,
                                      dtype=dtype)
        self.head = ISTFTHead(c.backbone_dim, c.n_fft, c.hop_length, dtype=dtype)

    @property
    def encoder(self) -> SEANetEncoder:
        return self.feature_extractor.encodec.encoder

    @property
    def quantizer(self) -> VectorQuantizer:
        return self.feature_extractor.encodec.quantizer.vq

    @property
    def device(self) -> torch.device:
        return self.head.out.weight.device

    def encode(self, audio: torch.Tensor, n_q: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio (B, T) -> (features (B, T', d), codes (n_q, B, T'))."""
        codes = vq_encode(self.encoder(audio), self.quantizer, n_q or self.config.n_q)
        return vq_decode(codes, self.quantizer), codes

    def codes_to_features(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (n_q, B, T) -> (B, T, d) summed codebook rows."""
        return vq_decode(codes, self.quantizer)

    def decode(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, T, d) -> waveform (B, T*hop), f32."""
        return self.head(self.backbone(features))

    def codes_to_audio(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (n_q, B, T) -> waveform (B, T*hop): one-shot synthesis."""
        return self.decode(self.codes_to_features(codes))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """Copy synthesis (decoder/pretrained.py:160-175)."""
        return self.decode(self.encode(audio)[0])


def init_wavtokenizer_params(wavtok: WavTokenizer, generator: torch.Generator) -> WavTokenizer:
    """Random initialization from ``generator`` after the JAX package's
    initializers: conv, Linear and LSTM weights normal with std
    1/sqrt(fan_in) (lecun normal, untruncated), their biases zero,
    codebooks uniform in [-1, 1); norm weights (one) and the layer scales
    (1/num_layers) keep their constructed values."""
    normal = lambda p, fan_in: p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    with torch.no_grad():
        for module in wavtok.modules():
            if isinstance(module, (nn.Conv1d, Linear)):
                normal(module.weight, module.weight[0].numel())
                module.bias.zero_()
            elif isinstance(module, nn.LSTM):
                for name, p in module.named_parameters():
                    normal(p, p.shape[1]) if name.startswith("weight") else p.zero_()
            elif isinstance(module, VectorQuantizer):
                for e in module.embed:
                    e.copy_(torch.rand(e.shape, generator=generator) * 2.0 - 1.0)
    return wavtok


def build_wavtokenizer(cfg: WavTokenizerConfig = WavTokenizerConfig(), device=None,
                       seed: int = 0, dtype: torch.dtype = torch.float32) -> WavTokenizer:
    """The codec with f32 parameters drawn from a ``torch.Generator``
    seeded with ``seed``, in eval mode.

    Built on the GPU: ``device=None`` means ``"cuda"`` and raises without
    one. The CPU is used only when the caller asks for it (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_wavtokenizer: no CUDA device; pass device=\"cpu\" to "
                               "build the codec on the CPU")
        device = "cuda"
    wavtok = init_wavtokenizer_params(WavTokenizer(cfg, dtype), torch.Generator().manual_seed(seed))
    return wavtok.to(device).eval()


def vocode_streaming(wavtok: WavTokenizer, codes: torch.Tensor, window: int = 60,
                     context: int = 64) -> Iterator[torch.Tensor]:
    """Yield ``window``-frame waveform chunks of ``codes`` (n_q, B, T).

    Each chunk is decoded from a ``window + 2*context`` frame slice, clamped
    into range (edge windows borrow extra real context instead of padding),
    and its centre ``window`` frames are emitted: (B, window*hop) chunks,
    (B, rem*hop) for the last. Approximate by architecture: the backbone is
    time-global (pos_net attention, GroupNorm statistics over all frames),
    so ``context`` trades lookahead for fidelity to the one-shot decode
    (the JAX package's docstring gives the measured trade).
    """
    _, _, t = codes.shape
    hop = wavtok.config.hop_length
    full = min(t, window + 2 * context)
    with torch.no_grad():
        for start in range(0, t, window):
            take = min(window, t - start)
            s0 = min(max(0, start - context), t - full)
            wav = wavtok.codes_to_audio(codes[:, :, s0:s0 + full])
            off = (start - s0) * hop
            yield wav[:, off:off + take * hop]
