"""Byte-level text tokenizer with the reference's special-token layout.

The port's own copy of ``lina_speech_tpu/data/tokenizer.py:ByteTokenizer``
(the package imports nothing of the JAX package): vocab 256, [PAD]=0
[BOS]=1 [EOS]=2, bytes at 3+. It stands in for the reference's 256-entry
BPE where no tokenizer file is at hand.
"""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    """Bytes >= 253 fold back into range (rare for normal text)."""

    vocab_size = 256
    pad_id, bos_id, eos_id = 0, 1, 2

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [3 + (b % 253) for b in text.encode("utf-8")]
        if add_special:
            return [self.bos_id] + ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", errors="replace")
