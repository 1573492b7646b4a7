"""EnCodec-style model: SEANet encoder, VQ, SEANet decoder, with segmented
encode and decode and the compression container (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/encodec.py`` (reference
encoder/model.py:122-187, utils.py:17-56):

- :class:`EncodecModel` on the port's ``codec/seanet.py`` and
  ``codec/vq.py`` (``residual`` picks true residual VQ over the
  WavTokenizer language VQ);
- :func:`encode_segmented`: fixed ``segment_length`` segments at a stride
  of ``(1 - overlap)`` of it, each with its own loudness scale;
  :func:`linear_overlap_add` and :func:`decode_segmented` put the decoded
  segments back together;
- :func:`compress_audio` / :func:`decompress_audio`: segmented encode, each
  segment's codes entropy-coded by the LM (``codec/lm.py``), the scales and
  the overlap in an ``LSTC`` container whose bytes are the JAX package's.

The JAX package's fixed shapes are kept because they are part of the
result: the final segment is zero-padded to ``segment_length`` before it is
encoded and its codes trimmed to ceil(valid / hop); short code frames are
zero-padded to ``segment_length // hop`` before decoding and the waveform
trimmed after; the loudness RMS divides by the valid samples, not by
``segment_length``.
"""
from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.codec.seanet import LSTMLayers, SEANetDecoder, SEANetEncoder
from lina_speech_tpu_torch.codec.vq import (
    VectorQuantizer, residual_vq_encode, vq_decode, vq_encode,
)


class EncodecModel(nn.Module):
    def __init__(self, dimension: int = 512, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_q: int = 1, bins: int = 4096,
                 residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_q, self.residual, self.ratios = n_q, residual, tuple(ratios)
        self.encoder = SEANetEncoder(dimension, n_filters, ratios, dtype=dtype)
        self.decoder = SEANetDecoder(dimension, n_filters, ratios, dtype=dtype)
        self.quantizer = VectorQuantizer(n_q, bins, dimension)

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    @property
    def device(self) -> torch.device:
        return self.quantizer.embed[0].device

    def encode(self, audio: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
        """(B, T) -> codes (n_q, B, ceil(T / hop))."""
        enc = residual_vq_encode if self.residual else vq_encode
        return enc(self.encoder(audio), self.quantizer, n_q or self.n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (n_q, B, T') -> waveform (B, T' * hop)."""
        return self.decoder(vq_decode(codes, self.quantizer))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(audio))


def init_encodec_params(model: EncodecModel, generator: torch.Generator) -> EncodecModel:
    """Random weights from ``generator`` after the JAX package's
    initializers: conv, transposed-conv and LSTM weights normal with std
    1/sqrt(fan_in) (lecun normal, untruncated), their biases zero,
    codebooks uniform in [-1, 1)."""
    normal = lambda p, fan_in: p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                w = module.weight  # Conv1d (out, in, k), ConvTranspose1d (in, out, k)
                normal(w, (w.shape[1] if isinstance(module, nn.Conv1d) else w.shape[0])
                       * w.shape[2])
                module.bias.zero_()
            elif isinstance(module, LSTMLayers):
                for name, p in module.lstm.named_parameters():
                    normal(p, p.shape[1]) if name.startswith("weight") else p.zero_()
            elif isinstance(module, VectorQuantizer):
                for e in module.embed:
                    e.copy_(torch.rand(e.shape, generator=generator) * 2.0 - 1.0)
    return model


def build_encodec_model(device=None, seed: int = 0, **kw) -> EncodecModel:
    """An :class:`EncodecModel` (``kw`` its widths) with f32 weights drawn
    from a ``torch.Generator`` seeded with ``seed``, in eval mode. Built on
    the GPU: ``device=None`` means ``"cuda"`` and raises without one; the
    CPU only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_encodec_model: no CUDA device; pass device=\"cpu\" to "
                               "build the codec on the CPU")
        device = "cuda"
    model = init_encodec_params(EncodecModel(**kw), torch.Generator().manual_seed(seed))
    return model.to(device).eval()


# --------------------------------------------------------------- segmented
EncodedFrame = Tuple[torch.Tensor, Optional[torch.Tensor]]  # codes (n_q, B, Tf), scale (B, 1)


def _stride(segment_length: int, overlap: float) -> int:
    return max(1, int((1 - overlap) * segment_length))


@torch.no_grad()
def encode_segmented(model: EncodecModel, audio: torch.Tensor, segment_length: int,
                     overlap: float = 0.01, normalize: bool = False) -> List[EncodedFrame]:
    """Segment-and-stride encode of (B, T) audio (reference model.py:122-145):
    a list of (codes (n_q, B, Tf), scale (B, 1)) frames, the scale None when
    ``normalize`` is False. With ``normalize`` each segment is divided by
    1e-8 + its RMS over its valid samples (model.py:152-157)."""
    _, T = audio.shape
    audio = audio.to(model.device)
    hop = model.hop_length
    frames: List[EncodedFrame] = []
    for off in range(0, T, _stride(segment_length, overlap)):
        seg = audio[:, off:off + segment_length]
        valid = seg.shape[-1]
        if valid < segment_length:
            seg = F.pad(seg, (0, segment_length - valid))
        scale = None
        if normalize:
            sq = (seg.float() ** 2).sum(-1, keepdim=True)
            scale = 1e-8 + torch.sqrt(sq / float(valid))
            seg = (seg / scale).to(seg.dtype)
        codes = model.encode(seg)
        frames.append((codes[..., :min(-(-valid // hop), codes.shape[-1])], scale))
    return frames


def linear_overlap_add(frames: List[torch.Tensor], stride: int) -> torch.Tensor:
    """Triangle-weighted overlap-add (reference utils.py:17-56): each frame
    weighted by a triangle peaking mid-frame, the sum divided by the summed
    weights, so lone regions pass through and overlaps cross-fade
    linearly."""
    assert frames
    dev = frames[0].device
    total = stride * (len(frames) - 1) + frames[-1].shape[-1]
    out = torch.zeros(frames[0].shape[:-1] + (total,), dtype=torch.float32, device=dev)
    sum_w = torch.zeros(total, dtype=torch.float32, device=dev)
    n = frames[0].shape[-1]
    t = torch.arange(1, n + 1, dtype=torch.float32, device=dev) / (n + 1)  # jnp.linspace's
    weight = 0.5 - (t - 0.5).abs()
    for i, fr in enumerate(frames):
        ln = fr.shape[-1]
        out[..., i * stride:i * stride + ln] += weight[:ln] * fr.float()
        sum_w[i * stride:i * stride + ln] += weight[:ln]
    return out / sum_w


@torch.no_grad()
def decode_segmented(model: EncodecModel, frames: List[EncodedFrame], segment_length: int,
                     overlap: float = 0.01, normalize: bool = False) -> torch.Tensor:
    """Decode :func:`encode_segmented`'s frames with linear overlap-add
    (reference model.py:167-187): short frames zero-padded to
    ``segment_length // hop`` codes, decoded, trimmed; with ``normalize``
    each segment multiplied by its scale."""
    hop = model.hop_length
    seg_frames = segment_length // hop
    outs = []
    for codes, scale in frames:
        codes = codes.to(model.device)
        nf = codes.shape[-1]
        if nf < seg_frames:
            codes = F.pad(codes, (0, seg_frames - nf))
        wav = model.decode(codes)
        if normalize:
            wav = wav * (torch.ones(codes.shape[1], 1, device=wav.device) if scale is None
                         else scale.to(wav.device))
        outs.append(wav[..., :nf * hop])
    return linear_overlap_add(outs, _stride(segment_length, overlap))


# ----------------------------------------------- entropy-coded compression
_MAGIC = b"LSTC"  # the container of the JAX package, byte for byte
_HEADER = "<IIIBIf"  # T, segment_length, frames, normalize, hop, overlap
_FRAME = "<IIf"  # code frames, bytes, scale


def compress_audio(model: EncodecModel, lm, audio: torch.Tensor, segment_length: int,
                   overlap: float = 0.01, normalize: bool = False) -> bytes:
    """(1, T) audio -> the ``LSTC`` container: segmented encode, each
    segment's codes coded by :func:`codec.lm.compress`, the scales and the
    overlap in the header (decode must overlap-add at the stride the
    encoder segmented with).

    The header holds the overlap as an f32, so the segments are cut at the
    stride of that f32 (a difference by design: the JAX package cuts at the
    stride of the float64 it was given, and where the two strides differ,
    0.3 at 160 samples among them, its container decodes at the wrong
    offsets). At the default 0.01 and the usual segment lengths they agree.
    """
    from lina_speech_tpu_torch.codec.lm import compress

    B, T = audio.shape
    assert B == 1, "the compression container is single-stream"
    overlap = struct.unpack("<f", struct.pack("<f", overlap))[0]
    frames = encode_segmented(model, audio, segment_length, overlap, normalize)
    blob = [_MAGIC, struct.pack(_HEADER, T, segment_length, len(frames),
                                1 if normalize else 0, model.hop_length, overlap)]
    for codes, scale in frames:
        c = codes[:, 0].cpu().numpy()  # (n_q, Tf)
        data = compress(lm, c)
        s = float(scale[0, 0]) if scale is not None else 1.0
        blob += [struct.pack(_FRAME, c.shape[1], len(data), s), data]
    return b"".join(blob)


def read_container(blob: bytes):
    """The ``LSTC`` container -> (header dict, [(code frames, data, scale)])."""
    if blob[:4] != _MAGIC:
        raise ValueError("bad container magic")
    T, segment_length, n_frames, norm, hop, overlap = struct.unpack_from(_HEADER, blob, 4)
    off = 4 + struct.calcsize(_HEADER)
    frames = []
    for _ in range(n_frames):
        tf, nbytes, s = struct.unpack_from(_FRAME, blob, off)
        off += struct.calcsize(_FRAME)
        frames.append((tf, blob[off:off + nbytes], s))
        off += nbytes
    header = dict(length=T, segment_length=segment_length, normalize=bool(norm), hop=hop,
                  overlap=overlap)
    return header, frames


def decompress_codes(model: EncodecModel, lm, blob: bytes) -> Tuple[dict, List[EncodedFrame]]:
    """The container -> (header, frames as :func:`encode_segmented` gave
    them). Raises ``ValueError`` when the container's hop is not the
    model's."""
    from lina_speech_tpu_torch.codec.lm import decompress

    header, coded = read_container(blob)
    if header["hop"] != model.hop_length:
        raise ValueError(f"container hop {header['hop']} != model hop {model.hop_length}: "
                         "this blob was encoded with a different codec config")
    frames = []
    for tf, data, s in coded:
        codes = decompress(lm, data, n_q=model.n_q, length=tf)
        frames.append((torch.from_numpy(codes)[:, None, :].to(model.device),
                       torch.full((1, 1), s, dtype=torch.float32, device=model.device)
                       if header["normalize"] else None))
    return header, frames


def decompress_audio(model: EncodecModel, lm, blob: bytes) -> torch.Tensor:
    """Inverse of :func:`compress_audio` -> (1, T) waveform. The overlap
    comes from the header, and a container whose hop is not the model's
    raises ``ValueError``."""
    header, frames = decompress_codes(model, lm, blob)
    wav = decode_segmented(model, frames, header["segment_length"], header["overlap"],
                           normalize=header["normalize"])
    return wav[..., :header["length"]]
