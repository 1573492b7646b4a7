"""EnCodec-style language model over codec tokens, and the compression API
(PyTorch port).

Counterpart of ``lina_speech_tpu/codec/lm.py`` (the reference's ``LMModel``,
encoder/model.py:27-65, whose entropy-coding path is dead code there): a
streaming transformer predicts each codebook's distribution over the next
code from the SUM of all codebooks' embeddings at the earlier positions
(inputs shifted by one, initial token 0, code c entering as c + 1); the
arithmetic coder (``codec/ac.py``) turns the distributions into bytes.

:func:`compress` and :func:`decompress` drive the same step function, one
token a call at batch 1, so the encoder and the decoder compute their pdfs
by the same operations on the same inputs. That is what makes a blob
decodable: the quantized cdfs are only equal when the f32 pdfs agree to the
bit, so compress must not run one teacher-forced forward over all T even
though it knows every code in advance, and a blob decodes only with the
model on the device (and package) that made it (README.md, the port's
section, gives the measured share of steps whose cdfs differ between the
card and the CPU).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from lina_speech_tpu_torch.codec.ac import build_stable_quantized_cdf, make_coder, make_decoder
from lina_speech_tpu_torch.codec.streaming_transformer import KVState, StreamingTransformerEncoder
from lina_speech_tpu_torch.models.base_blocks import Embedding, Linear


class EncodecLM(nn.Module):
    """LM over (b, K, t) codes; returns each codebook's next-code probs."""

    def __init__(self, n_q: int, card: int, dim: int = 128, heads: int = 8, n_layers: int = 4,
                 past_context: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_q, self.card = n_q, card
        self.emb = nn.ModuleList(Embedding(card + 1, dim, dtype) for _ in range(n_q))
        self.transformer = StreamingTransformerEncoder(dim, heads, n_layers, past_context,
                                                       dtype=dtype)
        self.linears = nn.ModuleList(Linear(dim, card, dtype=dtype) for _ in range(n_q))

    @property
    def device(self) -> torch.device:
        return self.linears[0].weight.device

    def forward(self, codes: torch.Tensor, states: Optional[List[KVState]] = None,
                offset: int = 0) -> Tuple[torch.Tensor, List[KVState], int]:
        """codes (b, K, t): SHIFTED input ids in [0, card]. Returns (probs
        (b, K, t, card) f32, new_states, new_offset)."""
        x = sum(emb(codes[:, k]) for k, emb in enumerate(self.emb))
        y, states, offset = self.transformer(x, states, offset)
        logits = torch.stack([lin(y) for lin in self.linears], dim=1)
        return torch.softmax(logits.float(), dim=-1), states, offset


def init_encodec_lm_params(lm: EncodecLM, generator: torch.Generator) -> EncodecLM:
    """Random weights from ``generator`` after the JAX package's
    initializers: Linear weights normal with std 1/sqrt(fan_in) and zero
    biases, embeddings normal with std 1/sqrt(dim); LayerNorms keep ones
    and zeros."""
    with torch.no_grad():
        for module in lm.modules():
            if isinstance(module, Linear):
                w = module.weight
                w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)
                module.bias.zero_()
            elif isinstance(module, Embedding):
                w = module.weight
                w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)
    return lm


def build_encodec_lm(n_q: int, card: int, device=None, seed: int = 0, **kw) -> EncodecLM:
    """An :class:`EncodecLM` with f32 weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode. Built on the
    GPU: ``device=None`` means ``"cuda"`` and raises without one; the CPU
    only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_encodec_lm: no CUDA device; pass device=\"cpu\" to build "
                               "the LM on the CPU")
        device = "cuda"
    lm = init_encodec_lm_params(EncodecLM(n_q, card, **kw), torch.Generator().manual_seed(seed))
    return lm.to(device).eval()


def _step_fn(lm: EncodecLM):
    """The one streaming step of ``lm`` that :func:`compress` and
    :func:`decompress` both call: (tok (1, K, 1) shifted ids, states,
    offset) -> (probs (1, K, 1, card), states, offset), without autograd."""

    def step(tok, states, offset):
        with torch.no_grad():
            return lm(tok, states, offset)

    return step


def step_cdfs(pdfs: np.ndarray, total_range_bits: int = 24) -> np.ndarray:
    """One step's (K, card) pdfs -> (K, card + 1) int64 quantized cdfs."""
    return np.stack([build_stable_quantized_cdf(p, total_range_bits) for p in pdfs])


def _stream_pdfs(lm: EncodecLM, codes: np.ndarray) -> Iterator[np.ndarray]:
    """Each step's (K, card) float64 pdfs while ``codes`` (K, T) are fed
    back one token a call, as :func:`decompress` feeds its decoded codes."""
    step = _step_fn(lm)
    K, T = codes.shape
    tok = torch.zeros(1, K, 1, dtype=torch.long, device=lm.device)  # the initial token
    states, offset = None, 0
    for t in range(T):
        probs, states, offset = step(tok, states, offset)
        yield probs[0, :, 0].cpu().numpy().astype(np.float64)
        tok = torch.from_numpy(np.asarray(codes[:, t], np.int64) + 1).view(1, K, 1).to(lm.device)


def lm_pdfs(lm: EncodecLM, codes: np.ndarray) -> np.ndarray:
    """(T, K, card) float64: the pdfs :func:`compress` codes ``codes`` (K, T)
    with, step by step."""
    return np.stack(list(_stream_pdfs(lm, codes)))


def compress(lm: EncodecLM, codes: np.ndarray, total_range_bits: int = 24) -> bytes:
    """codes (K, T) ints in [0, card) -> entropy-coded bytes (the native
    coder)."""
    coder = make_coder()
    for t, pdfs in enumerate(_stream_pdfs(lm, codes)):
        coder.push_many(codes[:, t], step_cdfs(pdfs, total_range_bits))
    return coder.flush()


def decompress(lm: EncodecLM, data: bytes, n_q: int, length: int,
               total_range_bits: int = 24) -> np.ndarray:
    """Inverse of :func:`compress` -> (n_q, length) int64 codes."""
    step = _step_fn(lm)
    dec = make_decoder(data)
    tok = torch.zeros(1, n_q, 1, dtype=torch.long, device=lm.device)
    states, offset = None, 0
    out = np.zeros((n_q, length), np.int64)
    for t in range(length):
        probs, states, offset = step(tok, states, offset)
        pdfs = probs[0, :, 0].cpu().numpy().astype(np.float64)
        out[:, t] = dec.pull_many(step_cdfs(pdfs, total_range_bits))
        tok = torch.from_numpy(out[:, t] + 1).view(1, n_q, 1).to(lm.device)
    return out
