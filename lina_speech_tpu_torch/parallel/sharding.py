"""Which part of a batch each rank holds, and parameter replication
(PyTorch port).

Counterpart of ``lina_speech_tpu/parallel/sharding.py``. In JAX a batch is
one global array placed with a ``PartitionSpec``: rows over ``dp`` and,
on a cp mesh, the audio-time axis of the TTS keys over ``cp``. A torch
rank holds only its part, so :func:`shard_batch` cuts it out of the global
batch every rank built from the same seed:

- rows: this rank's dp block of every micro-batch (with
  ``micro_batches`` > 1 the rows of micro-batch m are dp-sharded inside m,
  as JAX shards each (M, B/M) slice, so every micro-batch's loss is over
  the same rows as there);
- time, under cp: the keys of :data:`TTS_TIME_AXIS` are cut as the
  *shifted* pair. The model reads inputs ``y[:, :-1]`` and targets ``y[:,
  1:]``; the n - 1 input positions are padded at the end to a multiple of
  cp (masked positions, as the JAX CLI's ``_pad_cp``, train/cli.py:111-133)
  and rank j takes the t + 1 frames from j t, one overlapping the next
  rank's first, so its inputs are positions j t .. j t + t - 1 and its
  targets the frames after them: no shard's last position loses its
  target. Every rank holds the same t, which the collectives need.

``crossatt_pos`` stays whole on every cp rank (JAX lists it among the time
keys, but it indexes the text, data/collate.py:115). Parameters are
replicated by one broadcast from rank 0 (:func:`replicate_params`); the
tensor-parallel rules table waits for ROADMAP.md Queue 1 item 11b.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from lina_speech_tpu_torch.parallel.collectives import broadcast_params_
from lina_speech_tpu_torch.parallel.mesh import Mesh

# audio-time axis of each TTS batch key (data/collate.py layout)
TTS_TIME_AXIS = {"audio_token": 1, "y_mask": 1, "reset_mask": 1, "crossatt_mask": 1}


def _pad_time(key: str, x: np.ndarray, extra: int) -> np.ndarray:
    """``x`` with ``extra`` masked positions after its last: zeros (tokens
    0, masks False), and for ``crossatt_mask`` rows that see text position
    0 only, as data/collate.py pads a short row."""
    widths = [(0, 0)] * x.ndim
    widths[1] = (0, extra)
    out = np.pad(x, widths)
    if key == "crossatt_mask":
        out[:, x.shape[1]:, 0] = True
    return out


def _rows(batch_size: int, dp: int, index: int, micro_batches: int) -> np.ndarray:
    per = batch_size // (dp * micro_batches)
    micro = batch_size // micro_batches
    return np.concatenate([np.arange(m * micro + index * per, m * micro + (index + 1) * per)
                           for m in range(micro_batches)])


def shard_batch(batch: Dict[str, Any], mesh: Mesh, micro_batches: int = 1) -> Dict[str, Any]:
    """This rank's part of a global collated batch (numpy arrays): its dp
    rows and, on a cp mesh, its time shard of the TTS keys (module
    docstring). The global batch size must divide by dp x micro_batches
    (``ValueError``). Under cp a batch without ``y_mask`` gets one (all real
    positions), so the padding stays out of the loss."""
    dp, cp = mesh.size("dp"), mesh.size("cp")
    b = batch["text_token"].shape[0]
    if b % (dp * micro_batches):
        raise ValueError(f"batch of {b} rows does not divide over dp={dp} x "
                         f"{micro_batches} micro-batches")
    rows = _rows(b, dp, mesh.index("dp"), micro_batches)
    out = {k: (np.asarray(v)[rows] if np.asarray(v).shape[0] == b else np.asarray(v))
           for k, v in batch.items()}
    if cp == 1:
        return out
    n = out["audio_token"].shape[1]
    if "y_mask" not in out:
        out["y_mask"] = np.ones(out["audio_token"].shape[:2], bool)
    t = -(-(n - 1) // cp)  # input positions a rank: n - 1 rounded up to a multiple of cp
    start = mesh.index("cp") * t
    for key in TTS_TIME_AXIS:
        if key in out:
            x = _pad_time(key, out[key], cp * t + 1 - n)
            out[key] = x[:, start:start + t + 1]
    return out


def time_shard(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    """Shard ``index`` of ``n`` of ``x`` along ``dim``, ``x`` zero-padded at
    the end to a multiple of n first. For the chunk scans a zero step
    changes nothing (GLA and RWKV6: k = 0 adds nothing and gk = 0 decays
    nothing; Mamba: dt = 0), so real outputs and the final state are
    exact. Contiguous, as the kernels take it."""
    t = x.shape[dim]
    per = -(-t // n)
    pad = [0, 0] * (x.ndim - dim - 1) + [0, per * n - t]
    return F.pad(x, pad).narrow(dim, index * per, per).contiguous()


def replicate_params(model: torch.nn.Module, group) -> None:
    """Every parameter of ``model`` set to the group's first rank's values:
    one broadcast a dtype."""
    broadcast_params_([p.data for p in model.parameters()], group)
