"""Checkpoints of the port: save, restore, find the latest, average.

Counterpart of the orbax half of ``lina_speech_tpu/utils/checkpoint.py``
(``save_checkpoint`` / ``restore_checkpoint`` / ``average_checkpoints``) in
torch's own format. A checkpoint is a directory holding one ``state.pt``;
with ``step`` it is ``<path>/step_<n>/``, the layout the training CLI's
``--resume`` scans, as orbax's is in the JAX package. The state is any
nest of dicts, lists, numbers and tensors (the CLI saves ``{"model":
model.state_dict(), "optimizer": optimizer.state_dict(), "step": n}``).

A checkpoint is written under a temporary name in the same directory and
renamed into place, so a run killed while saving leaves the previous
checkpoint and no half-written one. The weight bridge to and from the JAX
package (``torch_key_for``, ``load_jax_params``, ``fold_weight_norm``)
lives in ``utils/convert.py``.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d+)$")


def checkpoint_path(path: str, step: Optional[int] = None) -> str:
    return path if step is None else os.path.join(path, f"step_{step}")


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Write ``state`` to ``path`` (``<path>/step_<step>`` with ``step``),
    replacing a checkpoint already there; returns the directory."""
    final = os.path.abspath(checkpoint_path(path, step))
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp_{os.path.basename(final)}_{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            old = os.path.join(parent, f".old_{os.path.basename(final)}_{os.getpid()}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The state saved at ``path``, its tensors on ``map_location`` (default:
    where they were saved). Loads with ``weights_only=True``: tensors and
    plain containers only, no pickled code."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def checkpoint_steps(path: str) -> List[int]:
    """The steps of the ``step_<n>`` checkpoints under ``path``, ascending
    ([] when there is none or no such directory)."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(path))
                  if m and os.path.isfile(os.path.join(path, m.group(0), STATE_FILE)))


def latest_checkpoint(path: str) -> Optional[str]:
    """The directory of the highest ``step_<n>`` under ``path``, or None."""
    steps = checkpoint_steps(path)
    return checkpoint_path(path, steps[-1]) if steps else None


def average_checkpoints(state_dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Average several state_dicts key by key, in f64, each result in its
    first tensor's dtype (the reference averages the best-3 vocoder
    checkpoints by validation loss, decoder/pretrained.py:117-156)."""
    if not state_dicts:
        raise ValueError("no state_dict to average")
    n = len(state_dicts)
    return {k: (sum(sd[k].double() for sd in state_dicts) / n).to(v.dtype)
            for k, v in state_dicts[0].items()}
