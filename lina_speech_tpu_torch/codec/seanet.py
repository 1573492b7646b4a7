"""SEANet convolutional audio encoder and decoder (EnCodec-style), PyTorch port.

Counterpart of ``lina_speech_tpu/codec/seanet.py`` (reference
encoder/modules/seanet.py:66-238, conv padding from
encoder/modules/conv.py:54-253) with the reference's module layout: one
``model`` Sequential (encoder: ``[conv_in, (res blocks, ELU, down) per
ratio, LSTM, ELU, conv_out]``), each conv at ``{i}.conv.conv`` (or
``{i}.convtr.convtr``), residual blocks as ``block.{1,3}`` and
``shortcut``, the LSTM as ``{i}.lstm`` (``nn.LSTM``'s own
``weight_ih_l{n}`` keys). Weight norm is folded into plain weights when a
checkpoint is loaded (``utils/convert.py:load_wavtokenizer_state_dict``).

:class:`SEANetEncoder`, :class:`SEANetDecoder` and :class:`LSTMLayers` take
and return the JAX package's (B, T[, C]) layouts; the conv blocks run in
torch's (B, C, T). Convs pad as the JAX ``SConv1d``: an asymmetric 'same'
reflect pad with an extra right pad so the last window is full, reflected
as ``numpy.pad(mode="reflect")`` does, also where a pad reaches past the
input (short inputs), which ``F.pad`` refuses.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pad_amounts(length: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(left, right) 'same' padding, the right one extended so that the
    last window is full (encoder/modules/conv.py:54-105)."""
    padding_total = (k - 1) * dilation - (stride - 1)
    n_frames = (length - k + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k - padding_total)
    right = padding_total // 2
    return padding_total - right, right + ideal - length


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis as ``numpy.pad(mode="reflect")``: the
    signal repeats with period 2(n - 1), so pads of any size are defined."""
    n = x.shape[-1]
    if left < n and right < n:
        return F.pad(x, (left, right), mode="reflect")
    if n == 1:
        return x.expand(*x.shape[:-1], n + left + right)
    period = 2 * (n - 1)
    idx = torch.arange(-left, n + right, device=x.device).remainder(period)
    return x[..., torch.where(idx >= n, period - idx, idx)]


class _Holder(nn.Module):
    """A named container, for the reference's nesting of module names."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class SConv1d(nn.Module):
    """Conv1d with EnCodec's 'same' asymmetric reflect padding; (B, C, T)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _Holder(conv=nn.Conv1d(c_in, c_out, kernel_size, stride=stride,
                                           dilation=dilation, groups=groups))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, dt = self.conv.conv, self.compute_dtype
        left, right = _same_pad_amounts(x.shape[-1], conv.kernel_size[0], conv.stride[0],
                                        conv.dilation[0])
        x = reflect_pad(x.to(dt), left, right)
        return F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride,
                        dilation=conv.dilation, groups=conv.groups)


class SConvTranspose1d(nn.Module):
    """ConvTranspose1d with EnCodec's trim of k - stride samples, the odd
    one on the left (conv.py:175-253); (B, C, T) -> (B, C', T * stride) for
    k = 2 stride."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convtr = _Holder(convtr=nn.ConvTranspose1d(c_in, c_out, kernel_size, stride=stride))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, dt = self.convtr.convtr, self.compute_dtype
        y = F.conv_transpose1d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                               stride=conv.stride)
        padding_total = conv.kernel_size[0] - conv.stride[0]
        right = padding_total // 2
        return y[..., padding_total - right:y.shape[-1] - right]


class SEANetResnetBlock(nn.Module):
    """ELU / conv k -> ELU / conv 1, plus a 1x1-conv shortcut
    (encoder/modules/seanet.py:21-63, true_skip=False); (B, C, T)."""

    def __init__(self, dim: int, kernel_size: int = 3, compress: int = 2, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = dim // compress
        self.block = nn.Sequential(
            nn.ELU(), SConv1d(dim, hidden, kernel_size, dilation=dilation, dtype=dtype),
            nn.ELU(), SConv1d(hidden, dim, 1, dtype=dtype))
        self.shortcut = SConv1d(dim, dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class LSTMLayers(nn.Module):
    """N-layer unidirectional LSTM over time plus a skip
    (encoder/modules/lstm.py:31-39), in f32; (B, T, C) -> (B, T, C)."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.float())
        return y.to(x.dtype) + x


def _run(model: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """The Sequential on (B, C, T), the LSTM on (B, T, C)."""
    for layer in model:
        x = layer(x.transpose(1, 2)).transpose(1, 2) if isinstance(layer, LSTMLayers) else layer(x)
    return x


class SEANetEncoder(nn.Module):
    """Audio (B, T) -> latents (B, ceil(T / hop), dimension)."""

    def __init__(self, dimension: int = 512, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 kernel_size: int = 7, last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, compress: int = 2, lstm: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mult = 1
        layers = [SConv1d(1, n_filters, kernel_size, dtype=dtype)]
        for ratio in reversed(list(ratios)):  # decoder order; the encoder reverses
            dim = mult * n_filters
            layers += [SEANetResnetBlock(dim, residual_kernel_size, compress,
                                         dilation_base ** j, dtype)
                       for j in range(n_residual_layers)]
            layers += [nn.ELU(), SConv1d(dim, dim * 2, ratio * 2, stride=ratio, dtype=dtype)]
            mult *= 2
        if lstm:
            layers.append(LSTMLayers(mult * n_filters, lstm))
        layers += [nn.ELU(), SConv1d(mult * n_filters, dimension, last_kernel_size, dtype=dtype)]
        self.model = nn.Sequential(*layers)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return _run(self.model, audio[:, None]).transpose(1, 2)


class SEANetDecoder(nn.Module):
    """Latents (B, T', dimension) -> audio (B, T' * hop): conv_in -> LSTM
    -> per ratio [ELU, transposed upsample, residual blocks] -> ELU ->
    conv_out to one channel (seanet.py:147-238)."""

    def __init__(self, dimension: int = 512, n_filters: int = 32,
                 ratios: Sequence[int] = (8, 5, 4, 2), n_residual_layers: int = 1,
                 kernel_size: int = 7, last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, compress: int = 2, lstm: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mult = 2 ** len(ratios)
        layers = [SConv1d(dimension, mult * n_filters, kernel_size, dtype=dtype)]
        if lstm:
            layers.append(LSTMLayers(mult * n_filters, lstm))
        for ratio in ratios:
            dim = mult * n_filters // 2
            layers += [nn.ELU(), SConvTranspose1d(mult * n_filters, dim, ratio * 2,
                                                  stride=ratio, dtype=dtype)]
            layers += [SEANetResnetBlock(dim, residual_kernel_size, compress,
                                         dilation_base ** j, dtype)
                       for j in range(n_residual_layers)]
            mult //= 2
        layers += [nn.ELU(), SConv1d(n_filters, 1, last_kernel_size, dtype=dtype)]
        self.model = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return _run(self.model, z.transpose(1, 2))[:, 0]
