"""Distributed-consistency guards (PyTorch port).

Counterpart of ``lina_speech_tpu/parallel/checks.py`` (reference
``_check_number_of_params``, encoder/distrib.py:41-52):

- :func:`param_count_fingerprint`: the parameter count and a hash of the
  names, shapes and dtypes, to compare across ranks and restarts;
- :func:`assert_replicated`: every parameter equal on every rank of a
  group; it gathers each one and raises naming the first that diverges.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch
import torch.distributed as dist

from lina_speech_tpu_torch.parallel.collectives import group_rank, group_size


def param_count_fingerprint(model: torch.nn.Module) -> Tuple[int, str]:
    """(total parameter count, stable structure hash)."""
    params = list(model.named_parameters())
    total = int(sum(p.numel() for _, p in params))
    desc = "|".join(f"{name}:{tuple(p.shape)}:{p.dtype}" for name, p in params)
    return total, hashlib.sha256(desc.encode()).hexdigest()[:16]


@torch.no_grad()
def assert_replicated(model: torch.nn.Module, group, atol: float = 0.0) -> None:
    """Every parameter of ``model`` within ``atol`` of group rank 0's copy
    on every rank of ``group``; ``AssertionError`` on every rank naming the
    first parameter that differs, the rank and the largest difference. A
    None group (one process) passes."""
    n = group_size(group)
    if n == 1:
        return
    for name, p in model.named_parameters():
        x = p.detach().contiguous()
        gathered = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(gathered, x, group=group)
        for r in range(1, n):
            diff = float((gathered[r].float() - gathered[0].float()).abs().max())
            if diff > atol:
                raise AssertionError(
                    f"replicated parameter {name} diverges between group ranks 0 and {r} "
                    f"(max diff {diff}; this is group rank {group_rank(group)})")
