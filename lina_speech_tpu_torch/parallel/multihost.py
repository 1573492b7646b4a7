"""Starting the ``torch.distributed`` world, the multi-node rank layout and
the rows of a batch each process loads (PyTorch port).

Counterpart of ``lina_speech_tpu/parallel/multihost.py``:

- :func:`distributed_init` starts the world once per process, from
  torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` or an explicit
  coordinator address, on NCCL for a CUDA device and gloo for the CPU (a
  failure to start NCCL raises; nothing falls back to gloo). A plain single
  process is a no-op;
- :func:`make_multihost_mesh` keeps JAX's layout rules on (host, id)
  records: ranks ordered host-major (:func:`device_order`), the tensor
  parallel axis innermost and never across a host
  (:func:`validate_tp_intra_host`), data parallel across hosts;
- :func:`process_batch_slice`, the rows of the global batch a rank loads.
  ``globalize_batch`` has no counterpart: it assembles per-process rows
  into one global ``jax.Array``, and a torch rank only ever holds its own
  rows.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from lina_speech_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh, rank_grid


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def backend_for(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device) -> torch.device:
    """The device of this process: ``cuda:<LOCAL_RANK>`` for a CUDA device
    (torchrun's local rank, 0 without one), else ``device`` as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return device


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Start the ``torch.distributed`` world once; returns True when it
    holds more than one process.

    A second call is a no-op. ``coordinator_address`` (``host:port``) with
    ``num_processes`` and ``process_id`` -- each read from ``WORLD_SIZE`` /
    ``RANK`` where not given -- starts a TCP rendezvous there; without it
    the world starts from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) where ``WORLD_SIZE`` is set,
    and otherwise nothing happens (a plain single process). The backend
    follows ``device`` (:func:`backend_for`); for CUDA the process's card
    (:func:`local_device`) is made current first.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and world is None:
        return False
    if world is None or rank is None:
        raise ValueError("distributed_init: a coordinator needs the world size and this "
                         "process's rank (num_processes / process_id, or WORLD_SIZE / RANK)")
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return world > 1


def device_order(devices: Sequence[Any]) -> list:
    """Host-major (then slice-major, then id) order of records with
    ``process_index`` (the host), optional ``slice_index`` and ``id``
    (the global rank), so a reshape to (dp, tp) puts tp inside a host."""
    return sorted(devices, key=lambda d: (d.process_index,
                                          getattr(d, "slice_index", 0) or 0, d.id))


def validate_tp_intra_host(ordered: Sequence[Any], tp: int) -> None:
    """Every contiguous group of ``tp`` records (after :func:`device_order`)
    must sit on one host: ``ValueError`` where one straddles hosts."""
    for i in range(0, len(ordered), tp):
        group = ordered[i:i + tp]
        procs = {d.process_index for d in group}
        if len(procs) > 1:
            hosts = max(1, len({d.process_index for d in ordered}))
            raise ValueError(
                f"tp={tp} would straddle hosts {sorted(procs)} (ranks {i}..{i + tp - 1}); pick "
                f"tp dividing the per-host rank count ({len(ordered) // hosts})")


@dataclasses.dataclass(frozen=True)
class RankRecord:
    """One rank of the world: its host (``process_index``, the JAX field's
    name), and its global rank ``id``."""

    process_index: int
    id: int
    slice_index: int = 0


def world_records(world: int, per_host: Optional[int] = None) -> list:
    """The :class:`RankRecord` of every rank of a world of ``world`` ranks,
    ``per_host`` to a host (torchrun's ``LOCAL_WORLD_SIZE``; all on one
    host without it)."""
    per_host = per_host or _env_int("LOCAL_WORLD_SIZE") or world
    return [RankRecord(process_index=r // per_host, id=r) for r in range(world)]


def make_multihost_mesh(config: Optional[MeshConfig] = None,
                        devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The dp (outer, across hosts) x tp (inner, one host) [x cp] mesh of
    the world: ranks ordered host-major, tp checked to stay inside a host.
    ``devices`` (records of :func:`world_records`'s kind) default to the
    current world's. A single process gets the plain ``make_mesh`` mesh."""
    config = config or MeshConfig()
    if devices is None:
        devices = world_records(dist.get_world_size() if dist.is_initialized() else 1)
    ordered = device_order(devices)
    grid = rank_grid([d.id for d in ordered], config)
    validate_tp_intra_host(ordered, grid.shape[1])
    names = ("dp", "tp", "cp") if grid.ndim == 3 else ("dp", "tp")
    return build_mesh(grid, names)


def process_batch_slice(global_batch_size: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """Rows of the global batch process ``process_index`` of
    ``process_count`` loads: a contiguous block (defaults: this rank of the
    world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    pc = process_count if process_count is not None else world
    pi = process_index if process_index is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pc} processes")
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)
