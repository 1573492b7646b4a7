"""Vocos-style vocoder backbone (ConvNeXt + pos_net attention), PyTorch port.

Counterpart of ``lina_speech_tpu/codec/vocos.py`` (reference
decoder/models.py:152-235, decoder/modules.py:8-79) with the reference's
module names (``embed``, ``pos_net.{0..5}``, ``norm``, ``convnext.{i}``
with ``dwconv`` / ``norm`` / ``pwconv1`` / ``pwconv2`` / ``gamma``,
``final_layer_norm``), so a reference state_dict loads as is.

:class:`VocosBackbone` takes and returns the JAX package's (B, T, C)
layout; inside, the blocks run in torch's (B, C, T) and transpose around
the LayerNorm and the pointwise Linears, as the reference does. As in the
JAX modules: LayerNorm and GroupNorm (32 groups over contiguous channels)
have eps 1e-6, take f32 statistics and return f32; convs and Linears cast
to the compute dtype ``dtype``; GELU is exact; the layer scale ``gamma``
starts at 1/num_layers; the pos_net attention takes its scores in f32 at
scale dim^-0.5. Inference only: the ResnetBlock's dropout is off.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import LayerNorm, Linear


class Conv1d(nn.Conv1d):
    """Stride-1 'same' conv (odd kernel, padding k//2) in the compute dtype;
    weight (out, in/groups, k) f32."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, kernel_size, padding=kernel_size // 2, groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding, groups=self.groups)


class GroupNorm(nn.GroupNorm):
    """32 groups, eps 1e-6, over (B, C, T); f32 statistics and output.

    A group of one value (one frame of a 32-wide backbone) is exactly its
    mean, so it normalizes to the bias, as in JAX; ``F.group_norm`` refuses
    it, and its fused kernel would return rounding noise scaled by
    eps^-1/2."""

    def __init__(self, dim: int):
        super().__init__(32, dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        if c // self.num_groups * t == 1:
            return self.bias.float().view(1, c, 1).expand(b, c, t)
        return super().forward(x.float())


class AdaLayerNorm(nn.Module):
    """Per-class scale / shift LayerNorm (decoder/modules.py:63-79)."""

    def __init__(self, num_embeddings: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Embedding(num_embeddings, dim)
        self.shift = nn.Embedding(num_embeddings, dim)
        nn.init.ones_(self.scale.weight)
        nn.init.zeros_(self.shift.weight)

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.float(), x.shape[-1:], eps=self.eps)
        return x * self.scale(cond_id) + self.shift(cond_id)


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv -> LN -> MLP -> layer scale, residual; (B, C, T)."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float = 0.0,
                 adanorm_num_embeddings: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, groups=dim, dtype=dtype)
        self.norm = (AdaLayerNorm(adanorm_num_embeddings, dim) if adanorm_num_embeddings
                     else LayerNorm(dim, eps=1e-6))
        self.pwconv1 = Linear(dim, intermediate_dim, dtype=dtype)
        self.pwconv2 = Linear(intermediate_dim, dim, dtype=dtype)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor, cond_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.dwconv(x).transpose(1, 2)  # (B, T, C)
        h = self.norm(h, cond_id) if isinstance(self.norm, AdaLayerNorm) else self.norm(h)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        if self.gamma is not None:
            h = h * self.gamma.to(h.dtype)
        return x + h.transpose(1, 2)


class ResnetBlock(nn.Module):
    """GroupNorm / swish / conv3, twice, residual (decoder/models.py:19-78)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(dim)
        self.conv1 = Conv1d(dim, dim, 3, dtype=dtype)
        self.norm2 = GroupNorm(dim)
        self.conv2 = Conv1d(dim, dim, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over time (decoder/models.py:80-127)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.norm = GroupNorm(dim)
        self.q, self.k, self.v, self.proj_out = (Conv1d(dim, dim, 1, dtype=dtype)
                                                 for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)  # (B, C, T)
        w = torch.einsum("bct,bcs->bts", q, k).float() * self.dim ** -0.5
        w = torch.softmax(w, dim=-1).to(v.dtype)
        return x + self.proj_out(torch.einsum("bts,bcs->bct", w, v))


class VocosBackbone(nn.Module):
    """embed conv -> pos_net (resnet, resnet, attention, resnet, resnet,
    GroupNorm) -> LN -> N ConvNeXt blocks -> final LN.
    Input (B, T, C_in); output (B, T, dim)."""

    def __init__(self, input_channels: int, dim: int, intermediate_dim: int, num_layers: int,
                 layer_scale_init_value: Optional[float] = None,
                 adanorm_num_embeddings: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        lsiv = layer_scale_init_value or 1.0 / num_layers
        self.embed = Conv1d(input_channels, dim, 7, dtype=dtype)
        self.pos_net = nn.ModuleList([
            ResnetBlock(dim, dtype), ResnetBlock(dim, dtype), AttnBlock(dim, dtype),
            ResnetBlock(dim, dtype), ResnetBlock(dim, dtype), GroupNorm(dim)])
        self.norm = (AdaLayerNorm(adanorm_num_embeddings, dim) if adanorm_num_embeddings
                     else LayerNorm(dim, eps=1e-6))
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(dim, intermediate_dim, lsiv, adanorm_num_embeddings, dtype)
            for _ in range(num_layers)])
        self.final_layer_norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor, cond_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(x.transpose(1, 2))
        for block in self.pos_net:
            x = block(x)
        x = x.transpose(1, 2)
        x = self.norm(x, cond_id) if isinstance(self.norm, AdaLayerNorm) else self.norm(x)
        x = x.transpose(1, 2)
        for block in self.convnext:
            x = block(x, cond_id)
        return self.final_layer_norm(x.transpose(1, 2))
