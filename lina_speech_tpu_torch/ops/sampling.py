"""Top-k / temperature sampling with an explicit ``torch.Generator``.

Counterpart of ``lina_speech_tpu/ops/sampling.py`` (reference
model/tools.py:38-44), exact top-k only: ``approx=True`` asks for the TPU
op ``jax.lax.approx_max_k`` and raises here. The generator gives other
random numbers than a JAX key of the same seed, so JAX parity holds under
greedy decoding (``k == 1``) only.
"""
from __future__ import annotations

from typing import Optional

import torch


def topk_sampling(generator: Optional[torch.Generator], logits: torch.Tensor,
                  k: int = 1, temp: float = 1.0,
                  reference_compat: bool = False,
                  approx: bool = False) -> torch.Tensor:
    """(..., vocab) logits -> (...,) int64 ids sampled from the top k."""
    if k == 1:
        return logits.argmax(dim=-1)
    if reference_compat and temp > 1.0:
        raise ValueError(
            "reference_compat sampling is only reference-faithful for "
            f"temp <= 1 (got temp={temp}); use the default formulation")
    if approx and not reference_compat:
        raise NotImplementedError(
            "approx top-k is the TPU op jax.lax.approx_max_k; the port "
            "samples from the exact top k")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if reference_compat:
        scaled = logits / temp
        masked = torch.where(scaled < kth, neg_inf, scaled)
    else:
        masked = torch.where(logits < kth, neg_inf, logits / temp)
    probs = torch.softmax(masked.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1])
