"""LinaModel: embeddings, text encoder, backbone and logits head (port).

Counterpart of ``lina_speech_tpu/models/lina.py`` (reference
model/modeling_lina.py): the training ``forward`` with its masked
cross-entropy, and for generation ``embed_tokens``, ``encode_text``, the
chunk-parallel ``prefill`` and the one-token ``decode_step``.

Dropout and the classifier-free text masking act in training mode only
(``model.train()``) and draw from the generator handed to
:meth:`LinaModel.set_generator`.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from lina_speech_tpu_torch.models.attentive_rnn import BackboneState
from lina_speech_tpu_torch.models.base_blocks import (
    Embedding, SwiGLU, set_dropout_generator,
)
from lina_speech_tpu_torch.models.multiembed import MultiEmbedding, head_logits
from lina_speech_tpu_torch.utils.quantize import (
    QKEY, SKEY, is_quantized_leaf, quantize_dense_params,
)


class LogitsHead(nn.Module):
    """EinMix "b n d -> b n q l" with weight (q, l, d), no bias
    (modeling_lina.py:51-57). Like a Linear it may hold an int8 copy of its
    weight with (q, l, 1) scales; with ``use_int8`` set the head dequantizes
    it in the compute dtype before the einsum (plain tensor code in the JAX
    package too: no kernel)."""

    def __init__(self, n_quant: int, n_vocab: int, d_model: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_quant, n_vocab, d_model))
        self.int8_q: Optional[torch.Tensor] = None  # (q, l, d) int8
        self.int8_s: Optional[torch.Tensor] = None  # (q, l, 1) f32
        self.use_int8 = False

    def set_int8(self, q: torch.Tensor, s: torch.Tensor) -> None:
        self.int8_q, self.int8_s = q.contiguous(), s.float().contiguous()

    def drop_float_weight_(self) -> None:
        if self.int8_q is None:
            raise RuntimeError("no int8 weight to keep")
        self.weight = None
        self.use_int8 = True

    def matrix(self, dtype: torch.dtype) -> torch.Tensor:
        if self.use_int8:
            return self.int8_q.to(dtype) * self.int8_s.to(dtype)
        return self.weight.to(dtype)


class LinaModel(nn.Module):
    def __init__(self, attentive_rnn: nn.Module, d_model: int, n_quant: int,
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
        self.generator: Optional[torch.Generator] = None

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator (on the model's device) that dropout and the text
        masking draw from in training mode."""
        self.generator = generator
        set_dropout_generator(self, generator)

    @property
    def n_target_vocab(self) -> int:
        return self.n_codebook + self.n_special_token_out

    def _head(self, y_hat: torch.Tensor) -> torch.Tensor:
        if self.tie_embed:
            return self.rvq_embed.attend(y_hat)
        return head_logits(y_hat, self.logits_head.matrix(self.dtype))

    def embed_tokens(self, y: torch.Tensor) -> torch.Tensor:
        """(q, b, n) token ids -> (b, n, d) summed quantizer embeddings."""
        return self.rvq_embed(y).sum(dim=0)

    def encode_text(self, x: torch.Tensor,
                    encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_embd = self.txt_embed(x)
        if self.txt_encoder is None:
            return x_embd
        return self.txt_encoder(x_embd, mask=encoder_mask)

    def forward(self, x, y, encoder_mask=None, crossatt_mask=None, logits_mask=None,
                reset_mask=None, init_state: Optional[BackboneState] = None,
                crossatt_pos=None, return_att: bool = False):
        """The training forward. x: (b, m) text ids; y: (b, n, q) delayed
        codec ids. Returns (logits (b, n-1, q, l), loss, att).

        The loss is the cross-entropy of y[:, 1:] in f32, ignoring target 1
        (modeling_lina.py:106) and positions outside ``logits_mask`` (b, n),
        averaged over the positions that count (at least 1).
        """
        if self.mask_text_p > 0.0 and self.training:
            if self.generator is None:
                raise RuntimeError("text masking in training mode needs a "
                                   "generator: call model.set_generator(generator)")
            drop = torch.rand(x.shape[0], generator=self.generator,
                              device=x.device) < self.mask_text_p
            x = torch.where(drop[:, None], self.n_txt_vocab - 1, x)

        y_embd = self.embed_tokens(y.permute(2, 0, 1))  # (b, n, d)
        x_enc = self.encode_text(x, encoder_mask)
        ca_mask = crossatt_mask[:, :-1] if crossatt_mask is not None else None
        # the backbone consumes y[:, :-1]; align per-position masks with it
        if reset_mask is not None and reset_mask.shape[1] == y.shape[1]:
            reset_mask = reset_mask[:, :-1]
        y_hat, att = self.attentive_rnn(
            y_embd[:, :-1], x_enc, mask=ca_mask, reset_mask=reset_mask,
            init_state=init_state, crossatt_pos=crossatt_pos,
            return_att=return_att)[:2]

        logits = self._head(y_hat)
        target = y[:, 1:]  # (b, n-1, q)
        logf = logits.float()
        ce = torch.logsumexp(logf, dim=-1) - logf.gather(-1, target[..., None])[..., 0]
        valid = target != 1
        if logits_mask is not None:
            valid = valid & logits_mask[:, 1:, None]
        loss = (ce * valid).sum() / valid.sum().clamp(min=1)
        return logits, loss, att

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

    # ---------- int8 weights ----------
    def quantize_weights_(self, min_size: int = 1 << 16, exclude=None) -> dict:
        """Make int8 copies of the Linear weights (and the logits head) that
        ``utils/quantize.py:quantize_dense_params`` selects, from the weights
        as they are now, and attach them to their modules.
        Nothing runs on them until ``use_int8`` is switched on
        (``base_blocks.use_int8_weights``). Returns the quantized mapping
        ``{parameter name: tensor or {int8_q, int8_s}}``. The serving paths
        call it inside :meth:`using_params` of the compute-dtype copies, as
        the JAX package quantizes its pre-cast tree."""
        tree = quantize_dense_params(dict(self.named_parameters()), min_size, exclude)
        self.load_int8_({k: v for k, v in tree.items() if is_quantized_leaf(v)})
        return tree

    def load_int8_(self, pairs) -> None:
        """Attach ``{parameter name: {int8_q, int8_s}}`` (the port's layout:
        a Linear's q (out, in), s (out, 1)) to the modules that own those
        parameters; an int8 weight a module held before beside its float
        weight is dropped."""
        for m in self.modules():
            # a module that gave up its float weight keeps its int8 one
            if getattr(m, "int8_q", None) is not None and m.weight is not None:
                m.int8_q = m.int8_s = None
        for name, pair in pairs.items():
            owner = self.get_submodule(name.rsplit(".", 1)[0])
            owner.set_int8(pair[QKEY], pair[SKEY])
        for m in self.modules():
            if isinstance(m, SwiGLU):
                m.prepare_fused_()

    def drop_float_weights_(self) -> None:
        """Keep only the int8 copy of every weight that has one: those
        layers then take the quantized route in every call."""
        for m in self.modules():
            if getattr(m, "int8_q", None) is not None:
                m.drop_float_weight_()

    def set_kernel_mode(self, mode: str) -> None:
        """``"auto"`` (kernels on CUDA tensors) or ``"chunk"`` (the plain
        PyTorch versions on every device) for every module that launches a
        kernel: the GLA layers and the quantized Linears."""
        if mode not in ("auto", "chunk"):
            raise ValueError(f"kernel_mode {mode!r} not in ('auto', 'chunk')")
        for m in self.modules():
            if hasattr(m, "kernel_mode"):
                m.kernel_mode = mode

    def cast_param_copies(self) -> Dict[nn.Parameter, torch.Tensor]:
        """Copies of the f32 parameters cast to the compute dtype, by
        parameter (none for f32 compute): the JAX generate_batch's one-time
        pre-cast of its param tree, made for the decode loop without
        touching the model. Norms keep f32 statistics either way."""
        if self.dtype == torch.float32:
            return {}
        return {p: p.detach().to(self.dtype) for p in self.parameters()
                if p.dtype == torch.float32}

    @contextlib.contextmanager
    def using_params(self, copies: Dict[nn.Parameter, torch.Tensor]):
        """Within the block each parameter of ``copies`` holds its copy
        (:meth:`cast_param_copies`); its own tensor comes back after, so the
        caller's model leaves the block as it entered it."""
        saved = [(p, p.data) for p in copies]
        try:
            for p, copy in copies.items():
                p.data = copy
            yield
        finally:
            for p, data in saved:
                p.data = data


@torch.no_grad()
def init_params(model: LinaModel, generator: torch.Generator) -> LinaModel:
    """Random initialization from ``generator``, after the JAX package's
    initializers by parameter name: GLA projections xavier-uniform with
    gain 2**-2.5 (gla.py:122-129), other Linear / head / conv weights
    normal with std 1/sqrt(fan_in), embeddings normal(1) (ConvPos table
    1/sqrt(d)), biases zero, norm weights one, the rvq padding row zero;
    Mamba-2: ``A_log`` = log U(1, 16), ``D`` and ``norm_weight`` one, the
    conv taps (conv_dim, d_conv) normal with std 1/sqrt(conv_dim); RWKV6
    layers: ``models/rwkv6.py:init_rwkv6_params_``."""
    from lina_speech_tpu_torch.models.rwkv6 import RWKV6Attention, init_rwkv6_params_

    gla_proj = ("q_proj", "k_proj", "v_proj", "g_proj", "o_proj", "gk_proj")
    rwkv6 = [m for m in model.modules() if isinstance(m, RWKV6Attention)]
    rwkv6_params = {id(p) for m in rwkv6 for p in m.parameters()}

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for name, p in model.named_parameters():
        parts = name.split(".")
        if id(p) in rwkv6_params:
            continue
        if parts[-1] in ("bias", "conv_bias", "dt_bias"):
            p.zero_()
        elif parts[-1] == "A_log":
            p.copy_(torch.log(1.0 + 15.0 * torch.rand(p.shape, generator=generator)))
        elif parts[-1] == "conv_kernel":
            normal(p, p.shape[0] ** -0.5)
        elif parts[-1] in ("D", "norm_weight") or any(
                n in parts for n in ("norm1", "norm2", "ln_q", "ln_k", "ln_v",
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
    for m in rwkv6:
        init_rwkv6_params_(m, generator)
    model.rvq_embed.weight[:, 0] = 0.0
    return model
