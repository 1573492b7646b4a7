"""LinaModel: embeddings, text encoder, backbone and logits head (port).

Counterpart of ``lina_speech_tpu/models/lina.py`` (reference
model/modeling_lina.py) for generation: ``embed_tokens``, ``encode_text``,
the chunk-parallel ``prefill`` and the one-token ``decode_step``. The
training forward and loss come with the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.attentive_rnn import AttentiveGLA, BackboneState
from lina_speech_tpu_torch.models.base_blocks import Embedding
from lina_speech_tpu_torch.models.multiembed import MultiEmbedding


class LogitsHead(nn.Module):
    """EinMix "b n d -> b n q l" with weight (q, l, d), no bias
    (modeling_lina.py:51-57)."""

    def __init__(self, n_quant: int, n_vocab: int, d_model: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_quant, n_vocab, d_model))


class LinaModel(nn.Module):
    def __init__(self, attentive_rnn: AttentiveGLA, d_model: int, n_quant: int,
                 n_codebook: int, n_special_token_in: int,
                 n_special_token_out: int, n_txt_vocab_base: int,
                 tie_embed: bool = False, txt_encoder: Optional[nn.Module] = None,
                 mask_text_p: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_quant, self.n_codebook = d_model, n_quant, n_codebook
        self.n_special_token_in = n_special_token_in
        self.n_special_token_out = n_special_token_out
        self.n_txt_vocab = n_txt_vocab_base + int(mask_text_p > 0.0)
        self.mask_text_p, self.tie_embed, self.dtype = mask_text_p, tie_embed, dtype
        self.txt_embed = Embedding(self.n_txt_vocab, d_model, dtype=dtype)
        self.rvq_embed = MultiEmbedding(n_quant, n_codebook + n_special_token_in,
                                        d_model, padding_idx=0, dtype=dtype)
        if not tie_embed:
            self.logits_head = LogitsHead(n_quant, self.n_target_vocab, d_model)
        self.txt_encoder = txt_encoder
        self.attentive_rnn = attentive_rnn

    @property
    def n_target_vocab(self) -> int:
        return self.n_codebook + self.n_special_token_out

    def _head(self, y_hat: torch.Tensor) -> torch.Tensor:
        if self.tie_embed:
            return self.rvq_embed.attend(y_hat)
        return torch.einsum("bnd,qld->bnql", y_hat,
                            self.logits_head.weight.to(self.dtype))

    def embed_tokens(self, y: torch.Tensor) -> torch.Tensor:
        """(q, b, n) token ids -> (b, n, d) summed quantizer embeddings."""
        return self.rvq_embed(y).sum(dim=0)

    def encode_text(self, x: torch.Tensor,
                    encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_embd = self.txt_embed(x)
        if self.txt_encoder is None:
            return x_embd
        return self.txt_encoder(x_embd, mask=encoder_mask)

    def prefill(self, y_embd, x_enc, state: Optional[BackboneState] = None,
                return_att: bool = False, crossatt_mask=None,
                conv_history: bool = False, time_offset=0,
                crossatt_pos_valid: Optional[torch.Tensor] = None):
        """Chunk-parallel prefill of (b, t, d) forced embeddings. Returns
        (logits (b, t, q, l), att, final_state). ``conv_history`` and
        ``time_offset`` make a chunk that continues a stream exact (see
        AttentiveGLA.forward)."""
        y_hat, att, final_state = self.attentive_rnn(
            y_embd, x_enc, mask=crossatt_mask, init_state=state,
            return_att=return_att, output_final_state=True,
            conv_history=conv_history, time_offset=time_offset,
            crossatt_pos_valid=crossatt_pos_valid)
        return self._head(y_hat), att, final_state

    def decode_step(self, y_embd, x_enc, state: BackboneState, time_step=None,
                    crossatt_mask=None, lazy_p: Optional[int] = None,
                    crossatt_pos_valid: Optional[torch.Tensor] = None):
        """One AR token: (b, d) -> (logits (b, q, l), att, new_state).

        ``lazy_p`` selects the lazy-window decode step (read-only recurrent
        states + window buffers; see generate.py ``lazy_window``).
        ``crossatt_mask`` (b, 1, m) hides padded text positions and
        ``crossatt_pos_valid`` (b, m) makes ConvPos padding-exact
        (slot-based serving mixes text lengths in one batch).
        """
        y, att, state = self.attentive_rnn.step(
            y_embd, x_enc, state, mask=crossatt_mask, time_step=time_step,
            lazy_p=lazy_p, crossatt_pos_valid=crossatt_pos_valid)
        return self._head(y[:, None])[:, 0], att, state

    def fold_lazy_state(self, state: BackboneState) -> BackboneState:
        return self.attentive_rnn.fold_lazy_state(state)

    def empty_state(self, batch_size: int, device=None) -> BackboneState:
        return self.attentive_rnn.empty_state(batch_size, device=device)

    def cast_float_params_(self, dtype: torch.dtype) -> None:
        """Cast every f32 parameter to ``dtype`` in place (the JAX
        generate_batch's one-time pre-cast; norms keep f32 statistics)."""
        if dtype == torch.float32:
            return
        for p in self.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)


@torch.no_grad()
def init_params(model: LinaModel, generator: torch.Generator) -> LinaModel:
    """Random initialization from ``generator``, after the JAX package's
    initializers by parameter name: GLA projections xavier-uniform with
    gain 2**-2.5 (gla.py:122-129), other Linear / head / conv weights
    normal with std 1/sqrt(fan_in), embeddings normal(1) (ConvPos table
    1/sqrt(d)), biases zero, norm weights one, the rvq padding row zero."""
    gla_proj = ("q_proj", "k_proj", "v_proj", "g_proj", "o_proj", "gk_proj")

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "bias":
            p.zero_()
        elif any(n in parts for n in ("norm1", "norm2", "ln_q", "ln_k", "ln_v",
                                      "g_norm_swish_gate")):
            p.fill_(1.0)
        elif name in ("txt_embed.weight", "rvq_embed.weight"):
            normal(p, 1.0)
        elif "pos_embed" in parts and "embed" in parts:
            normal(p, p.shape[-1] ** -0.5)
        elif "tmix" in parts and any(n in parts for n in gla_proj):
            fan_avg = (p.shape[0] + p.shape[1]) / 2
            bound = math.sqrt(3 * 2.0 ** -5 / fan_avg)
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif p.ndim == 3 and parts[-2].endswith("conv1d"):  # (d, 1, w) taps
            normal(p, p.shape[0] ** -0.5)
        elif "dw_conv" in parts:  # (d, 1, k) ConvPos taps
            normal(p, p.shape[-1] ** -0.5)
        else:  # Linear (out, in) and the (q, l, d) logits head
            normal(p, p.shape[-1] ** -0.5)
    model.rvq_embed.weight[:, 0] = 0.0
    return model
