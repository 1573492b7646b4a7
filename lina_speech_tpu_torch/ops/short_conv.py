"""Depthwise causal short convolution with decode-time ring state.

Counterpart of ``lina_speech_tpu/ops/short_conv.py``: a width-``w``
depthwise causal conv followed by SiLU in the IO dtype. The decode state is
the last ``w`` inputs per channel in a time-major ``(w, b, dim)`` ring
(index -1 newest), the JAX package's layout.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          activation: str = "silu") -> torch.Tensor:
    """x: (b, t, d); weight: (d, w) taps, tap 0 oldest -> (b, t, d)."""
    d, w = weight.shape
    t = x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = 0.0
    for i in range(w):
        out = out + xp[:, i:i + t, :] * weight[:, i]
    if bias is not None:
        out = out + bias
    if activation == "silu":
        out = out * torch.sigmoid(out)
    return out


def short_conv_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                    weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    activation: str = "silu"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (b, d); conv_state: (w, b, d) ring -> (y_t (b, d), new ring)."""
    new_state = torch.cat([conv_state[1:], x_t[None].to(conv_state.dtype)], 0)
    out = torch.einsum("wbd,dw->bd", new_state, weight)
    if bias is not None:
        out = out + bias
    if activation == "silu":
        out = out * torch.sigmoid(out)
    return out, new_state
