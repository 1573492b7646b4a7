"""Simple-GLA backbone: the GLA recurrence with a scalar-per-head decay gate.

Counterpart of ``lina_speech_tpu/models/simple_gla.py`` (reference
model/simple_gla.py:117-180, built on FLA's SimpleGatedLinearAttention):
the same :class:`AttentiveGLA` with ``scalar_gate=True`` on every token
mixer, so the kernels, the decode steps, the states and initial-state
tuning are the GLA backbone's. FLA's simple layer defaults ``expand_v`` to
1.0.
"""
from __future__ import annotations

from typing import Optional

import torch

from lina_speech_tpu_torch.models.attentive_rnn import AttentiveGLA


def AttentiveSimpleGLA(d_model: int, n_layer: int, heads: int, dropout: float = 0.0,
                       d_blind: Optional[int] = None, blind: bool = False,
                       cross_att_pp: bool = False, rotary: bool = False,
                       use_short_conv: bool = False, expand_k: float = 1.0,
                       expand_v: float = 1.0, pos_type: str = "sinusoidal",
                       chunk_size: int = 64, remat: bool = False, kernel_mode: str = "auto",
                       dtype: torch.dtype = torch.float32) -> AttentiveGLA:
    return AttentiveGLA(
        d_model=d_model, n_layer=n_layer, heads=heads, dropout=dropout, d_blind=d_blind,
        blind=blind, cross_att_pp=cross_att_pp, rotary=rotary,
        use_short_conv=use_short_conv, expand_k=expand_k, expand_v=expand_v,
        pos_type=pos_type, chunk_size=chunk_size, scalar_gate=True, remat=remat,
        kernel_mode=kernel_mode, dtype=dtype)
