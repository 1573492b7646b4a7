"""Batch collation for TTS training (host-side numpy).

The port's own copy of ``lina_speech_tpu/data/collate.py``: the same
batches, array by array.

Produces the batch schema the training harness consumes (mirrors the
reference's implied schema, train_lina.py:73-78, and the collate in
initial_state.py:51-82):

    text_token (b, m)  audio_token (b, n, q)  encoder_mask (b, m, m)
    crossatt_mask (b, n, m)  y_mask (b, n)  [crossatt_pos, reset_mask]

Audio codes get the RVQ delay pattern with +n_special offset, head token 1,
tail token 2; crossatt_mask column 0 is forced True so every audio step can
attend at least the BOS text position (initial_state.py:70).

``packed_collate_tts`` implements the reference's long-batch trick
(SURVEY §2.4): several utterances packed into one row with block-diagonal
cross-attention (tools.py:17-35) + a reset_mask that wipes GLA state at
segment starts (gla.py:182-184).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lina_speech_tpu_torch.data.tokenizer import TextTokenizer


def _delay_np(code: np.ndarray, n_special: int = 3) -> np.ndarray:
    """(q, n) raw codes -> (n + q + 1, q) delayed, offset, head=1/tail=2."""
    q, n = code.shape
    code = code + n_special
    head = np.tril(np.ones((q, q + 1))) * 1
    tail = np.tril(np.ones((q + 1, q)), -1).T * 2
    ext = np.flip(head + tail, axis=1)
    extended = np.concatenate([code, ext.astype(code.dtype)], axis=1)
    for i in range(q):
        extended[i] = np.roll(extended[i], i + 1)
    return extended.T.astype(np.int64)


def collate_tts(
    items: Sequence[Dict],
    tokenizer: TextTokenizer,
    n_special: int = 3,
    pad_to_multiple: int = 1,
) -> Dict[str, np.ndarray]:
    """items: [{"audio_token": (q, n) raw codes, "text": str}, ...].

    ``pad_to_multiple`` rounds padded lengths up (the JAX package buckets
    shapes with it; kept so that both packages collate the same batches)."""
    delayed = [_delay_np(np.asarray(it["audio_token"]), n_special) for it in items]
    text = [np.asarray(tokenizer.encode(it["text"])) for it in items]

    def rnd(x: int) -> int:
        m = pad_to_multiple
        return -(-x // m) * m

    m = rnd(max(t.shape[0] for t in text))
    n = rnd(max(d.shape[0] for d in delayed))
    b = len(items)
    q = delayed[0].shape[1]

    text_token = np.zeros((b, m), np.int64)
    audio_token = np.zeros((b, n, q), np.int64)
    x_mask = np.zeros((b, m), bool)
    y_mask = np.zeros((b, n), bool)
    for i, (t, d) in enumerate(zip(text, delayed)):
        text_token[i, : len(t)] = t
        audio_token[i, : d.shape[0]] = d
        x_mask[i, : len(t)] = True
        y_mask[i, : d.shape[0]] = True

    encoder_mask = x_mask[:, :, None] & x_mask[:, None, :]
    crossatt_mask = y_mask[:, :, None] & x_mask[:, None, :]
    crossatt_mask[:, :, 0] = True
    return {
        "text_token": text_token,
        "audio_token": audio_token,
        "encoder_mask": encoder_mask,
        "crossatt_mask": crossatt_mask,
        "y_mask": y_mask,
    }


def packed_collate_tts(
    items: Sequence[Dict],
    tokenizer: TextTokenizer,
    n_special: int = 3,
    offset: int = 0,
) -> Dict[str, np.ndarray]:
    """Pack ALL items into batch rows of one concatenated sequence each...
    here: a single row (b=1) per call; callers can stack rows of similar
    total length. Returns reset_mask wiping recurrent state at segment
    starts."""
    delayed = [_delay_np(np.asarray(it["audio_token"]), n_special) for it in items]
    text = [np.asarray(tokenizer.encode(it["text"])) for it in items]

    xlen = [len(t) for t in text]
    ylen = [d.shape[0] for d in delayed]
    text_token = np.concatenate(text)[None, :]
    audio_token = np.concatenate(delayed, axis=0)[None, :, :]

    from lina_speech_tpu_torch.ops.tools import packmask_2d, packed_reset_mask

    # block-diagonal masks: audio rows attend only their own text segment
    crossatt = packmask_2d(ylen, xlen, offset=offset)  # (sum_y, sum_x)
    encoder = packmask_2d(xlen, xlen)
    reset = packed_reset_mask(ylen)
    # positional ids restart per packed text segment (feeds the blind
    # cross-attention's pos embedding, the batch's crossatt_pos column,
    # train_lina.py:76)
    crossatt_pos = np.concatenate([np.arange(n) for n in xlen])[None, :]

    return {
        "text_token": text_token,
        "audio_token": audio_token,
        "encoder_mask": encoder[None],
        "crossatt_mask": crossatt[None],
        "y_mask": np.ones((1, audio_token.shape[1]), bool),
        "reset_mask": reset[None],
        "crossatt_pos": crossatt_pos,
    }
