"""GAN discriminators for codec training (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/discriminators.py`` (reference
decoder/discriminators.py: HiFi-GAN's multi-period discriminator, periods
(2, 3, 5, 7, 11), :20-98; UnivNet's multi-resolution discriminator over
STFT magnitudes at 1024/2048/512, :101-202; EnCodec's MS-STFT and DAC's
multi-band discriminators). Every conv carries the reference's weight norm
(:class:`WNConv`).

Layout: the JAX package runs NHWC activations and HWIO kernels, the port
NCHW and OIHW. Modules carry the JAX package's names (``period_2.conv_0.v``
for ``period_2/conv_0/v``), so ``utils/convert.py`` moves their weights by
name. Each discriminator returns (scores, feature maps) per
sub-discriminator: a score (B, n) flattened as JAX flattens it (one channel,
so NHWC and NCHW give one order), feature maps NCHW (``.permute(0, 2, 3,
1)`` gives JAX's).

XLA's "SAME" padding puts ``total // 2`` on the low side and the rest on
the high side, stride or not; torch's ``padding="same"`` refuses a stride
above 1, so the convs pad explicitly (:func:`same_pads`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.codec.losses import stft_frames, stft_mag

Outs = Tuple[List[torch.Tensor], List[List[torch.Tensor]]]


def same_pads(n: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for an input of ``n`` along one
    axis: the output has ceil(n / stride) positions."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class WNConv(nn.Module):
    """2D conv with torch-style weight normalization (dim 0): weight = g v /
    ||v||, the norm per OUTPUT channel over (in, kh, kw) with 1e-12 inside
    the square root; ``g`` starts at ||v||, so the initial function is a
    plain conv's. XLA "SAME" padding (what the reference discriminators
    use). ``v`` is OIHW, the JAX package's HWIO kernel transposed."""

    def __init__(self, in_channels: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), kernel_dilation: Tuple[int, int] = (1, 1),
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides, self.dilation, self.dtype = tuple(strides), tuple(kernel_dilation), dtype
        self.v = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        self.g = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def norm(self) -> torch.Tensor:
        return torch.sqrt((self.v * self.v).sum(dim=(1, 2, 3)) + 1e-12)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """v normal with std 1/sqrt(fan_in) (flax's lecun normal, untruncated),
        g = ||v||, bias zero."""
        with torch.no_grad():
            fan_in = self.v[0].numel()
            self.v.copy_(torch.randn(self.v.shape, generator=generator) * fan_in ** -0.5)
            self.g.copy_(self.norm())
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = (self.v * (self.g / self.norm())[:, None, None, None]).to(self.dtype)
        kh, kw = self.v.shape[2:]
        (ph0, ph1), (pw0, pw1) = (same_pads(x.shape[2], kh, self.strides[0], self.dilation[0]),
                                  same_pads(x.shape[3], kw, self.strides[1], self.dilation[1]))
        y = F.conv2d(F.pad(x.to(self.dtype), (pw0, pw1, ph0, ph1)), weight, stride=self.strides,
                     dilation=self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class _PeriodDisc(nn.Module):
    def __init__(self, period: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        for i in range(4):
            setattr(self, f"conv_{i}", WNConv(chans[i], chans[i + 1], (5, 1), strides=(3, 1),
                                              dtype=dtype))
        self.conv_4 = WNConv(1024, 1024, (5, 1), dtype=dtype)
        self.conv_post = WNConv(1024, 1, (3, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T) -> score (B, n), feature maps: reflect-padded to a
        multiple of the period, viewed as (B, 1, T / p, p)."""
        b, t = x.shape
        p = self.period
        pad = (-t) % p
        x = F.pad(x[:, None], (0, pad), mode="reflect" if t > 1 else "constant")
        h = x.reshape(b, 1, -1, p)
        fmaps = []
        for i in range(5):
            h = _lrelu(getattr(self, f"conv_{i}")(h))
            fmaps.append(h)
        h = self.conv_post(h)
        fmaps.append(h)
        return h.reshape(b, -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            setattr(self, f"period_{p}", _PeriodDisc(p, dtype))

    def forward(self, x: torch.Tensor) -> Outs:
        outs, fmaps = [], []
        for p in self.periods:
            o, f = getattr(self, f"period_{p}")(x)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


class _ResolutionDisc(nn.Module):
    SPECS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
             ((3, 3), (1, 1)))

    def __init__(self, n_fft: int, hop: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        for i, (kern, stride) in enumerate(self.SPECS):
            setattr(self, f"conv_{i}", WNConv(1 if i == 0 else 32, 32, kern, strides=stride,
                                              dtype=dtype))
        self.conv_post = WNConv(32, 1, (3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = stft_mag(x, self.n_fft, self.hop).transpose(1, 2)[:, None]  # (B, 1, T', F)
        fmaps = []
        for i in range(len(self.SPECS)):
            h = _lrelu(getattr(self, f"conv_{i}")(h))
            fmaps.append(h)
        h = self.conv_post(h)
        fmaps.append(h)
        return h.reshape(x.shape[0], -1), fmaps


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions: Sequence[Tuple[int, int]] = ((1024, 256), (2048, 512),
                                                                 (512, 128)),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolutions = tuple(tuple(r) for r in resolutions)
        for n_fft, hop in self.resolutions:
            setattr(self, f"res_{n_fft}", _ResolutionDisc(n_fft, hop, dtype))

    def forward(self, x: torch.Tensor) -> Outs:
        outs, fmaps = [], []
        for n_fft, _ in self.resolutions:
            o, f = getattr(self, f"res_{n_fft}")(x)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


def _complex_stft_chw(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, 2, frames, freq): real and imaginary parts as channels."""
    spec = stft_frames(x, n_fft, hop)
    return torch.stack([spec.real, spec.imag], dim=1)


class _STFTDisc(nn.Module):
    """One scale of EnCodec's MS-STFT discriminator (msstftd.py): the complex
    STFT as 2 input channels, then a dilated conv2d stack."""

    def __init__(self, n_fft: int, hop: int, filters: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.conv_pre = WNConv(2, filters, (3, 9), dtype=dtype)
        for i, dil in enumerate((1, 2, 4)):
            setattr(self, f"conv_{i}", WNConv(filters, filters, (3, 9), strides=(1, 2),
                                              kernel_dilation=(dil, 1), dtype=dtype))
        self.conv_post = WNConv(filters, 1, (3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = self.conv_pre(_complex_stft_chw(x, self.n_fft, self.hop))
        fmaps = [h]
        for i in range(3):
            h = getattr(self, f"conv_{i}")(_lrelu(h))
            fmaps.append(h)
        h = self.conv_post(_lrelu(h))
        fmaps.append(h)
        return h.reshape(x.shape[0], -1), fmaps


class MultiScaleSTFTDiscriminator(nn.Module):
    """EnCodec's MS-STFT discriminator (encoder/msstftd.py)."""

    def __init__(self, scales: Sequence[Tuple[int, int]] = ((1024, 256), (2048, 512), (512, 128)),
                 filters: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scales = tuple(tuple(s) for s in scales)
        for n_fft, hop in self.scales:
            setattr(self, f"stft_{n_fft}", _STFTDisc(n_fft, hop, filters, dtype))

    def forward(self, x: torch.Tensor) -> Outs:
        outs, fmaps = [], []
        for n_fft, _ in self.scales:
            o, f = getattr(self, f"stft_{n_fft}")(x)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


class _BandDisc(nn.Module):
    """Multi-band complex-STFT sub-discriminator (DAC,
    decoder/discriminator_dac.py): each frequency band through its own conv
    stack, the bands concatenated along frequency for the head."""

    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, n_fft: int, hop: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        for bi in range(len(self.BANDS)):
            for i in range(3):
                setattr(self, f"band{bi}_conv{i}", WNConv(
                    2 if i == 0 else 32, 32, (3, 9), strides=(1, 2) if i else (1, 1), dtype=dtype))
        self.conv_post = WNConv(32, 1, (3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        spec = _complex_stft_chw(x, self.n_fft, self.hop)  # (B, 2, T', F)
        n_freq = spec.shape[3]
        fmaps, band_outs = [], []
        for bi, (lo, hi) in enumerate(self.BANDS):
            h = spec[..., int(lo * n_freq):int(hi * n_freq)]
            for i in range(3):
                h = _lrelu(getattr(self, f"band{bi}_conv{i}")(h))
                fmaps.append(h)
            band_outs.append(h)
        h = self.conv_post(torch.cat(band_outs, dim=3))
        fmaps.append(h)
        return h.reshape(x.shape[0], -1), fmaps


class DACDiscriminator(nn.Module):
    """DAC: multi-period + multi-band complex STFT
    (decoder/discriminator_dac.py:36-249), paired with the least-squares
    losses (``losses.lsgan_*``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 stft_resolutions: Sequence[Tuple[int, int]] = ((2048, 512), (1024, 256),
                                                                (512, 128)),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        self.stft_resolutions = tuple(tuple(r) for r in stft_resolutions)
        for p in self.periods:
            setattr(self, f"period_{p}", _PeriodDisc(p, dtype))
        for n_fft, hop in self.stft_resolutions:
            setattr(self, f"band_{n_fft}", _BandDisc(n_fft, hop, dtype))

    def forward(self, x: torch.Tensor) -> Outs:
        outs, fmaps = [], []
        subs = [f"period_{p}" for p in self.periods] + [
            f"band_{n_fft}" for n_fft, _ in self.stft_resolutions]
        for name in subs:
            o, f = getattr(self, name)(x)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


def init_discriminator_params(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random initialization of every :class:`WNConv` of ``disc`` from
    ``generator``, in module order (the JAX package's ``jax.random`` stream
    cannot be matched: a test carries weights across instead)."""
    for module in disc.modules():
        if isinstance(module, WNConv):
            module.reset_parameters(generator)
    return disc
