"""Streaming causal transformer with bounded past context (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/streaming_transformer.py`` (EnCodec's
``StreamingTransformerEncoder``, reference encoder/modules/transformer.py,
used by the compression LM): a ``norm_in`` LayerNorm on the input,
sinusoidal positions added at ``offset``, causal self-attention limited to
``past_context`` keys back (delta <= past_context), pre-norm layers with a
tanh-approximated GELU MLP (flax's ``nn.gelu``), a ``norm_out`` LayerNorm.

The streaming state is the JAX package's: a fixed-shape KV ring of
``past_context`` slots a layer, oldest first, rolled after every call; a
slot's validity comes from ``offset`` (a slot that was never written holds
zeros and is masked out). Attention is the port's ``sdpa``, masked logits
at ``-finfo(f32).max``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import LayerNorm, Linear, sdpa

KVState = Tuple[torch.Tensor, torch.Tensor]


def create_sin_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding (reference transformer.py:16-27),
    ``positions.shape + (dim,)``, f32. The exponent's denominator is
    ``half - 1``, as the reference has it."""
    assert dim % 2 == 0
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=positions.device)
    phase = positions.float()[..., None] / (max_period ** (adim / (half - 1)))
    return torch.cat([phase.cos(), phase.sin()], dim=-1)


def init_streaming_state(batch: int, dim: int, heads: int, n_layers: int, past_context: int,
                         dtype: torch.dtype = torch.float32, device=None) -> List[KVState]:
    """Fixed-shape zero KV rings (b, h, past_context, dim // heads), one
    (k, v) pair a layer."""
    z = torch.zeros(batch, heads, past_context, dim // heads, dtype=dtype, device=device)
    return [(z, z) for _ in range(n_layers)]


class StreamingTransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden_scale: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        hidden = int(dim * hidden_scale)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.out = Linear(dim, dim, dtype=dtype)
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, kv_state: KVState
                ) -> Tuple[torch.Tensor, KVState]:
        """x (b, t, d); ``kv_state`` the (b, h, P, d_head) rings of the
        earlier keys and values. Returns the output and the rolled rings
        (the newest P keys and values)."""
        b, t, _ = x.shape
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        split = lambda z: z.reshape(b, t, self.heads, self.dim // self.heads).transpose(1, 2)
        kcat = torch.cat([kv_state[0], split(k)], dim=2)
        vcat = torch.cat([kv_state[1], split(v)], dim=2)
        y, _ = sdpa(split(q), kcat, vcat, mask=mask)
        x = x + self.out(y.transpose(1, 2).reshape(b, t, self.dim))
        x = x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        P = kv_state[0].shape[2]
        return x, (kcat[:, :, -P:], vcat[:, :, -P:])


class StreamingTransformerEncoder(nn.Module):
    def __init__(self, dim: int, heads: int = 8, n_layers: int = 5, past_context: int = 1000,
                 max_period: float = 10000.0, norm_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.past_context = dim, heads, past_context
        self.max_period, self.dtype = max_period, dtype
        self.layers = nn.ModuleList(
            StreamingTransformerLayer(dim, heads, dtype=dtype) for _ in range(n_layers))
        self.norm_in = LayerNorm(dim) if norm_input else None
        self.norm_out = LayerNorm(dim)

    def init_state(self, batch: int, device=None) -> List[KVState]:
        return init_streaming_state(batch, self.dim, self.heads, len(self.layers),
                                    self.past_context, self.dtype, device)

    def forward(self, x: torch.Tensor, states: Optional[List[KVState]] = None,
                offset: int = 0) -> Tuple[torch.Tensor, List[KVState], int]:
        """x (b, t, d); ``states`` the per-layer rings (None: a fresh
        stream); ``offset`` the tokens already consumed. Returns (y,
        new_states, offset + t)."""
        b, t, _ = x.shape
        dev = x.device
        if states is None:
            states = self.init_state(b, dev)
        P = states[0][0].shape[2]
        if self.norm_in is not None:
            x = self.norm_in(x)
        new = torch.arange(t, device=dev) + offset
        x = x + create_sin_embedding(new, self.dim, self.max_period)[None].to(x.dtype)
        # keys: [P ring slots | t new tokens]; ring slot i holds position
        # offset - (P - i), valid once written (>= 0) and within the window
        ring = torch.arange(P, device=dev) - P + offset
        delta = new[:, None] - torch.cat([ring, new])[None, :]
        written = torch.cat([ring >= 0, torch.ones(t, dtype=torch.bool, device=dev)])
        mask = ((delta >= 0) & (delta <= self.past_context) & written[None, :])[None, None]
        new_states = []
        for layer, st in zip(self.layers, states):
            x, st = layer(x, mask, st)
            new_states.append(st)
        return self.norm_out(x), new_states, offset + t
