"""Synthetic TTS data for smoke training and benchmarks (no external data).

The reference has no in-tree datamodule (its LightningCLI points at an
external class, SURVEY.md preamble); this module provides a deterministic
stand-in with the same batch schema so the training harness is runnable
end-to-end out of the box.

The port's own copy of ``lina_speech_tpu/data/synthetic.py``: the same
batches for the same seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from lina_speech_tpu_torch.data.collate import collate_tts
from lina_speech_tpu_torch.data.tokenizer import TextTokenizer


_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
          "speech", "tokens", "linear", "attention", "cloning", "voice"]


def synthetic_tts_batches(
    batch_size: int = 4,
    n_quant: int = 1,
    n_codebook: int = 4096,
    min_audio_len: int = 64,
    max_audio_len: int = 256,
    seed: int = 0,
    tokenizer: Optional[TextTokenizer] = None,
    pad_to_multiple: int = 64,
    structured: bool = False,
    speaker: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless iterator of collated batches.

    ``structured=False``: random codes — loss plateaus at ln(n_codebook);
    use for throughput benchmarks. ``structured=True``: audio tokens are a
    deterministic function of the text (each text token maps to a cycle of
    3 codes, read via cross-attention), so training loss actually
    converges — use for end-to-end learning validation on hardware.
    ``speaker`` shifts the structured text->code mapping by a constant
    (speaker * 977 mod n_codebook): a stand-in for speaker identity that a
    tuned initial state S0 can absorb (initial-state tuning end-to-end
    validation; reference initial_state.py:85-160).
    """
    rng = np.random.default_rng(seed)
    tokenizer = tokenizer or TextTokenizer()
    while True:
        items = []
        for _ in range(batch_size):
            n = int(rng.integers(min_audio_len, max_audio_len + 1))
            n_words = int(rng.integers(3, 10))
            text = " ".join(rng.choice(_WORDS, n_words))
            if structured:
                ids = np.asarray(tokenizer.encode(text), np.int64)
                pos = np.arange(n)
                src = ids[(pos // 3) % len(ids)]
                q = np.arange(n_quant)[:, None]
                audio = (src[None, :] * 131 + pos[None, :] % 3 * 47
                         + q * 29 + speaker * 977) % n_codebook
            else:
                audio = rng.integers(0, n_codebook, (n_quant, n))
            items.append({"audio_token": audio, "text": text})
        yield collate_tts(items, tokenizer, pad_to_multiple=pad_to_multiple)
