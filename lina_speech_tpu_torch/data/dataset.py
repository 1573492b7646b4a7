"""File-backed TTS dataset and a length-bucketed dynamic batch sampler.

The port's own copy of ``lina_speech_tpu/data/dataset.py`` (numpy, on the
port's ``data/collate.py``): the same items, batches and epochs for the
same seed. The reference delegates this to an external LightningCLI
datamodule whose batch schema train_lina.py:73-78 implies, with a dynamic
batch sampler re-seeded per epoch (train_lina.py:67-69).

- :class:`TokenizedTTSDataset`: pre-tokenized utterances from ``.npz``
  shards (``{"audio_token_<i>": (q, n) ints, "text_<i>": str}``, as
  ``scripts/prepare_dataset_torch.py`` writes them) or an in-memory list;
- :class:`LengthBucketSampler`: utterances of similar length grouped into
  batches under a token budget, batch order shuffled per epoch
  (``set_epoch``);
- :func:`tts_data_loader`: the endless epoch loop of collated batches.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class TokenizedTTSDataset:
    def __init__(self, items: Optional[List[Dict]] = None,
                 npz_paths: Optional[Sequence[str]] = None):
        self.items: List[Dict] = list(items or [])
        for path in npz_paths or []:
            with np.load(path) as data:
                idx = 0
                while f"audio_token_{idx}" in data:
                    self.items.append({"audio_token": data[f"audio_token_{idx}"],
                                       "text": str(data[f"text_{idx}"])})
                    idx += 1

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        return self.items[i]

    def lengths(self) -> np.ndarray:
        return np.asarray([it["audio_token"].shape[-1] for it in self.items])

    @staticmethod
    def save_npz(path: str, items: Sequence[Dict]) -> None:
        arrays = {}
        for i, it in enumerate(items):
            arrays[f"audio_token_{i}"] = np.asarray(it["audio_token"])
            arrays[f"text_{i}"] = np.asarray(it["text"])
        np.savez(path, **arrays)


class LengthBucketSampler:
    """Yields lists of indices: batches built greedily from length-sorted
    items under ``max_tokens`` (longest item x batch size) and
    ``max_batch_size``, shuffled within coarse length bins, batch order
    shuffled per epoch (``set_epoch`` re-seeds with ``seed + epoch``)."""

    def __init__(self, lengths: np.ndarray, max_tokens: int = 8192,
                 max_batch_size: int = 64, seed: int = 0, shuffle: bool = True):
        self.lengths = np.asarray(lengths)
        self.max_tokens = max_tokens
        self.max_batch_size = max_batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _build_batches(self, rng: np.random.Generator) -> List[List[int]]:
        order = np.argsort(self.lengths, kind="stable")
        if self.shuffle:
            # shuffle within coarse length bins to vary batch composition
            # (array_split's pieces are views: the shuffles reorder ``order``)
            nbins = max(1, len(order) // (self.max_batch_size * 4))
            for chunk in np.array_split(order, nbins):
                rng.shuffle(chunk)
        batches, cur, cur_max = [], [], 0
        for i in order:
            n = int(self.lengths[i])
            new_max = max(cur_max, n)
            if cur and (new_max * (len(cur) + 1) > self.max_tokens
                        or len(cur) >= self.max_batch_size):
                batches.append(cur)
                cur, new_max = [], n
            cur.append(int(i))
            cur_max = new_max
        if cur:
            batches.append(cur)
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = self._build_batches(rng)
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self) -> int:
        return len(self._build_batches(np.random.default_rng(self.seed + self.epoch)))


def tts_data_loader(dataset: TokenizedTTSDataset, tokenizer, sampler,
                    n_special: int = 3, pad_to_multiple: int = 64):
    """Endless epoch-looping iterator of collated batches."""
    from lina_speech_tpu_torch.data.collate import collate_tts

    epoch = 0
    while True:
        sampler.set_epoch(epoch)
        for idx in sampler:
            yield collate_tts([dataset[i] for i in idx], tokenizer,
                              n_special=n_special, pad_to_multiple=pad_to_multiple)
        epoch += 1
