"""Text tokenization: HF-tokenizers BPE (the reference ships a 256-vocab BPE
with [PAD]=0 [BOS]=1 [EOS]=2, bpe256.json) or a byte-level fallback with the
same special-token layout for from-scratch training without external assets.

The port's own copy of ``lina_speech_tpu/data/tokenizer.py`` (the package
imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """Byte-level fallback, vocab 256: [PAD]=0 [BOS]=1 [EOS]=2, bytes at 3+.

    Bytes >= 253 fold back into range (rare for normal text)."""

    vocab_size = 256
    pad_id, bos_id, eos_id = 0, 1, 2

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [3 + (b % 253) for b in text.encode("utf-8")]
        if add_special:
            return [self.bos_id] + ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", errors="replace")


class TextTokenizer:
    """HF-tokenizers wrapper matching the reference's "[BOS]" + text + "[EOS]"
    convention (initial_state.py:63). Falls back to :class:`ByteTokenizer`
    when no tokenizer file is given."""

    def __init__(self, tokenizer_file: Optional[str] = None):
        self._hf = None
        if tokenizer_file is not None:
            from tokenizers import Tokenizer

            self._hf = Tokenizer.from_file(tokenizer_file)
        self._byte = ByteTokenizer()

    @property
    def vocab_size(self) -> int:
        return self._hf.get_vocab_size() if self._hf is not None else self._byte.vocab_size

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        if self._hf is None:
            return self._byte.encode(text, add_special)
        if add_special:
            text = "[BOS]" + text + "[EOS]"
        return self._hf.encode(text).ids

    def decode(self, ids: List[int]) -> str:
        if self._hf is None:
            return self._byte.decode(ids)
        return self._hf.decode(ids)
