"""Cross-attention: vanilla, "blind" two-pass and PP (PyTorch port).

Counterpart of ``lina_speech_tpu/models/crossatt.py`` (reference
model/crossatt.py) with the reference's torch names (``q``, ``ln_q``,
``pos_net``, ``pos_embed.embed``, ``pos_embed.dw_conv`` ...) and, for
:class:`CrossAttentionPP`, the names the JAX package's
``utils/checkpoint.py:torch_key_for`` gives it (``ca_0``, ``ca_1``,
``pos_emb``, ``inter_net``). The stateful ``pos_net`` / ``inter_net``
blocks thread their state through the caller, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lina_speech_tpu_torch.models.base_blocks import (
    Embedding, LayerNorm, Linear, sdpa,
)
from lina_speech_tpu_torch.ops.rotary import apply_rotary


class SinPos(nn.Module):
    """(b, p) positions -> (b, p, dim): first half sin, second half cos."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        exp = torch.arange(self.dim // 2, dtype=torch.float32,
                           device=pos.device) * 2.0 / self.dim
        angle = pos[..., None].float() * torch.pow(10000.0, -exp)
        return torch.sin(torch.cat([angle, angle + math.pi / 2], dim=-1))


class ConvPos(nn.Module):
    """Learned positions + 31-tap depthwise SAME conv (crossatt.py:21-32).

    The conv is a grouped ``F.conv1d``; on a GPU cuDNN runs f32 in TF32
    unless ``torch.backends.cudnn.allow_tf32`` is False.

    ``valid`` ((b, p) bool, optional) zeroes the conv INPUT at padded
    positions, so for any valid prefix the SAME-padded conv output equals
    an unpadded run of that length exactly. Slot-based serving mixes text
    lengths in one padded batch; without this the non-causal 31-tap window
    sees learned embeddings of positions past the text tail.
    """

    def __init__(self, dim: int, max_seq_len: int = 2000, kernel_size: int = 31,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = Embedding(max_seq_len, dim, dtype=dtype)
        self.dw_conv = nn.Conv1d(dim, dim, kernel_size, padding=kernel_size // 2,
                                 groups=dim)
        self.dtype = dtype

    def forward(self, pos: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.embed(pos)  # (b, p, d)
        if valid is not None:
            emb = torch.where(valid[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                                 device=emb.device))
        out = F.conv1d(emb.transpose(1, 2), self.dw_conv.weight.to(self.dtype),
                       None, padding=self.dw_conv.padding,
                       groups=self.dw_conv.groups)
        return out.transpose(1, 2) + self.dw_conv.bias.to(self.dtype)


class CrossAttention(nn.Module):
    """LN(projections) -> multi-head SDPA; no output projection."""

    def __init__(self, q_dim: int, k_dim: int, att_dim: int, heads: int,
                 rotary: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att_dim, self.heads, self.rotary = att_dim, heads, rotary
        self.q = Linear(q_dim, att_dim, dtype=dtype)
        self.k = Linear(k_dim, att_dim, dtype=dtype)
        self.v = Linear(k_dim, att_dim, dtype=dtype)
        self.ln_q, self.ln_k, self.ln_v = (LayerNorm(att_dim) for _ in range(3))

    def forward(self, q, k, v=None, mask=None, time_step=None,
                return_weights: bool = False):
        if v is None:
            v = k
        q = self.ln_q(self.q(q))
        vv = self.ln_v(self.v(v))
        kk = self.ln_k(self.k(k))
        b, n, _ = q.shape
        m = kk.shape[1]
        d_head = self.att_dim // self.heads
        split = lambda t: t.reshape(b, -1, self.heads, d_head).transpose(1, 2)
        qh, kh, vh = split(q), split(kk), split(vv)
        if self.rotary:
            rot = d_head // 2
            off = 0 if time_step is None else time_step
            if isinstance(off, torch.Tensor) and off.ndim == 1:
                # per-row decode offsets (slot-based serving: each slot sits
                # at its own position) -> (b, 1, 1) over (b, h, n, rot)
                off = off[:, None, None]
            qh = apply_rotary(qh, torch.arange(n, device=q.device) + off, rot)
            kh = apply_rotary(kh, torch.arange(m, device=q.device), rot)
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]
        x, att = sdpa(qh, kh, vh, mask=mask, return_weights=return_weights)
        return x.transpose(1, 2).reshape(b, n, self.att_dim), att


class BlindCrossAttention(nn.Module):
    """Two-pass "blind" cross-attention with a stateful pos_net block.

    Pass 1 attends from the audio stream to the text and retrieves
    positional embeddings; the pos_net GLA block (carrying its own state)
    transforms them; pass 2 attends from that onto the positions and
    fetches the content values (crossatt.py:76-155).
    """

    def __init__(self, q_dim: int, k_dim: int, att_dim: int, pos_net: nn.Module,
                 pos_dim: int = 1024, pos_type: str = "sinusoidal",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q = Linear(q_dim, att_dim, dtype=dtype)
        self.k = Linear(k_dim, att_dim, dtype=dtype)
        self.v = Linear(k_dim, att_dim, dtype=dtype)
        self.ln_q, self.ln_k, self.ln_v = (LayerNorm(att_dim) for _ in range(3))
        self.pos_net = pos_net
        if pos_type == "sinusoidal":
            self.pos_embed = SinPos(pos_dim)
        elif pos_type == "convolutional":
            self.pos_embed = ConvPos(pos_dim, dtype=dtype)
        else:
            raise ValueError(f"unknown pos_type {pos_type}")

    def _proj_and_pos(self, q, k, pos_valid=None, pos=None):
        qh = self.ln_q(self.q(q))[:, None]  # single head: (b, 1, n, d)
        vh = self.ln_v(self.v(k))[:, None]
        kh = self.ln_k(self.k(k))[:, None]
        b, _, j, _ = kh.shape
        if pos is None:
            pos = torch.arange(j, device=k.device)[None, :]
        # pos_valid only matters for ConvPos: the sinusoidal embedding is
        # per position, hence padding-invariant
        if pos_valid is not None and isinstance(self.pos_embed, ConvPos):
            pos_emb = self.pos_embed(pos, valid=pos_valid)
        else:
            pos_emb = self.pos_embed(pos)
        pe = pos_emb.to(qh.dtype)[:, None].expand(b, 1, j, pos_emb.shape[-1])
        return qh, kh, vh, pe

    def forward(self, q, k, mask=None, pos_net_state=None,
                return_weights: bool = False, conv_history: bool = False,
                pos_valid: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                reset_mask: Optional[torch.Tensor] = None):
        """Full sequence. Returns (out, att, pos_net_final_state).

        ``conv_history`` makes the pos_net consume its incoming conv rings
        as causal history (see GatedLinearAttention.forward); ``pos_valid``
        ((b, j) bool) makes ConvPos padding-exact for mixed text lengths.
        ``pos`` ((1 or b, j) int) replaces the text positions 0..j-1 (a
        packed batch restarts them per segment) and ``reset_mask`` ((b, n)
        bool) wipes the pos_net's state at segment starts.
        """
        qh, kh, vh, pe = self._proj_and_pos(q, k, pos_valid, pos)
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]
        x, att1 = sdpa(qh, kh, pe, mask=mask, return_weights=return_weights)
        x = x[:, 0]
        if pos_net_state is not None:
            x, pos_net_final = self.pos_net(x, initial_state=pos_net_state,
                                            output_final_state=True,
                                            conv_history=conv_history,
                                            reset_mask=reset_mask)
        else:
            x, pos_net_final = self.pos_net(x, reset_mask=reset_mask), None
        x, att2 = sdpa(x[:, None], pe, vh, mask=mask,
                       return_weights=return_weights)
        att = torch.cat([att1, att2], dim=1) if att1 is not None else None
        return x[:, 0], att, pos_net_final

    def step(self, q_t, k, pos_net_state, mask=None,
             lazy_p: Optional[int] = None,
             pos_valid: Optional[torch.Tensor] = None):
        """One decode token. q_t: (b, d); k: (b, j, d). Returns
        (out (b, d), att (b, 2, j), new_pos_net_state). ``lazy_p`` takes
        the pos_net's lazy-window step."""
        qh, kh, vh, pe = self._proj_and_pos(q_t[:, None], k, pos_valid)
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]
        x, att1 = sdpa(qh, kh, pe, mask=mask, return_weights=True)
        x, pos_net_state = self.pos_net.step(x[:, 0, 0], pos_net_state, lazy_p)
        x, att2 = sdpa(x[:, None, None], pe, vh, mask=mask, return_weights=True)
        att = torch.cat([att1, att2], dim=1)[:, :, 0]
        return x[:, 0, 0], att, pos_net_state


class CrossAttentionPP(nn.Module):
    """Two single-head CrossAttentions around a stateful ``inter_net`` block,
    with learned absolute positions added to the keys (crossatt.py:50-72;
    JAX ``CrossAttentionPP``): pass 1 reads the text with position-aware
    values, the inter_net block (a recurrent mixer carrying its own state)
    transforms the result, pass 2 attends with it onto the position-aware
    keys and fetches the text."""

    def __init__(self, dim: int, inter_net: nn.Module, ca_heads: int = 1,
                 max_seqlen: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ca_0 = CrossAttention(dim, dim, dim, ca_heads, dtype=dtype)
        self.ca_1 = CrossAttention(dim, dim, dim, ca_heads, dtype=dtype)
        self.pos_emb = Embedding(max_seqlen, dim, dtype=dtype)
        self.inter_net = inter_net

    def _k_pos(self, k):
        return k + self.pos_emb(torch.arange(k.shape[1], device=k.device))[None]

    def forward(self, q, k, mask=None, pos_net_state=None, return_weights: bool = False,
                conv_history: bool = False, reset_mask: Optional[torch.Tensor] = None,
                time_step=None):
        """Full sequence. Returns (out, att, inter_net_final_state);
        ``conv_history`` makes the inter_net consume its incoming conv rings
        as causal history, ``reset_mask`` wipes its state at segment starts."""
        k_pos = self._k_pos(k)
        y, att1 = self.ca_0(q, k, k_pos, mask=mask, time_step=time_step,
                            return_weights=return_weights)
        if pos_net_state is not None:
            y, final = self.inter_net(y, initial_state=pos_net_state, output_final_state=True,
                                      conv_history=conv_history, reset_mask=reset_mask)
        else:
            y, final = self.inter_net(y, reset_mask=reset_mask), None
        y, att2 = self.ca_1(y, k_pos, k, mask=mask, time_step=time_step,
                            return_weights=return_weights)
        att = torch.cat([att1, att2], dim=1) if att1 is not None else None
        return y, att, final

    def step(self, q_t, k, pos_net_state, mask=None, lazy_p: Optional[int] = None,
             time_step=None):
        """One decode token. q_t: (b, d); k: (b, j, d). Returns (out (b, d),
        att (b, 2 heads, j), new_inter_net_state)."""
        k_pos = self._k_pos(k)
        if mask is not None and mask.ndim == 3:
            mask = mask[:, None]
        y, att1 = self.ca_0(q_t[:, None], k, k_pos, mask=mask, time_step=time_step,
                            return_weights=True)
        y, pos_net_state = self.inter_net.step(y[:, 0], pos_net_state, lazy_p)
        y, att2 = self.ca_1(y[:, None], k_pos, k, mask=mask, return_weights=True)
        att = torch.cat([att1, att2], dim=1)[:, :, 0]
        return y[:, 0], att, pos_net_state
