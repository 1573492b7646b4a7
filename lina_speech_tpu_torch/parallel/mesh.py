"""The rank grid of data and context parallel training, and its process
groups (PyTorch port).

Counterpart of ``lina_speech_tpu/parallel/mesh.py``. The JAX package lays
its devices out in one ``jax.sharding.Mesh`` with axes ``dp`` (batch rows),
``tp`` (tensor parallel) and, when ``cp > 1``, ``cp`` (audio time), and XLA
inserts the collectives. Here every rank is one process holding one
device; :func:`make_mesh` lays the ranks of the current
``torch.distributed`` world out in the same dp x tp x cp grid, cp
innermost as in JAX (``mesh.py:69-78``), and makes one process group for
each line of ranks along an axis (and for the dp x cp plane, the ranks a
batch is spread over). The collectives are called by hand
(``parallel/collectives.py``).

Tensor parallelism (``tp > 1``) is not ported: ROADMAP.md Queue 1 item
11b. ``ensure_virtual_cpu_devices`` has no counterpart: it sets the XLA flag
that splits one CPU into virtual devices, and a CPU world here is N
processes on gloo (``torchrun --nproc-per-node N`` or
``torch.multiprocessing``).

A process group of this module is ``None`` where there is no
``torch.distributed`` world (a plain single process): the collectives of
``parallel/collectives.py`` are then the identity.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

TP_NOT_PORTED = "tensor parallelism is not ported yet (ROADMAP.md Queue 1 item 11b)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: all remaining ranks
    tp: int = 1
    # context parallel: audio TIME sharded over this many ranks; a "cp"
    # axis is added to the mesh only when cp > 1, as in JAX
    cp: int = 1


def mesh_shape(config: MeshConfig, world: int) -> Tuple[int, int, int]:
    """(dp, tp, cp) of ``config`` over ``world`` ranks: dp -1 takes what
    tp x cp leave. ``ValueError`` naming the world size where the grid does
    not cover it; ``NotImplementedError`` for ``tp > 1``."""
    tp, cp = config.tp, config.cp
    if tp > 1:
        raise NotImplementedError(f"tp={tp}: {TP_NOT_PORTED}")
    if tp < 1 or cp < 1:
        raise ValueError(f"mesh axes must be >= 1: tp={tp}, cp={cp}")
    dp = config.dp if config.dp != -1 else world // (tp * cp)
    if dp < 1 or dp * tp * cp != world:
        raise ValueError(
            f"mesh dp={dp} x tp={tp} x cp={cp} != world size {world}; launch "
            f"{max(dp, 1) * tp * cp} processes (torchrun --nproc-per-node) or change the axes")
    return dp, tp, cp


class Mesh:
    """The dp x tp [x cp] grid of global ranks (``ranks``, a numpy array of
    the axes' sizes, named ``axis_names``), this process's ``rank`` and one
    process group per line of the grid this rank lies on."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...], rank: int,
                 groups: Dict[Tuple[str, ...], Optional[object]]):
        self.ranks, self.axis_names, self.rank = ranks, axis_names, rank
        self._groups = groups

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have (cp 1)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def group(self, *axes: str):
        """The process group of this rank's line (or plane) along ``axes``:
        ``group("cp")`` the ranks holding the other time shards of its rows,
        ``group("dp", "cp")`` the ranks its batch is spread over. Axes the
        mesh does not have are dropped (cp 1); None without a
        ``torch.distributed`` world."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(key)


def _lines(ranks: np.ndarray, axis_names: Tuple[str, ...], axes: Tuple[str, ...]):
    """Every line (or plane) of ``ranks`` along ``axes``, in a fixed order:
    the other axes' coordinates vary slowest."""
    keep = [axis_names.index(a) for a in axes]
    other = [i for i in range(ranks.ndim) if i not in keep]
    moved = np.transpose(ranks, other + keep)
    return [sorted(int(r) for r in moved[idx].ravel())
            for idx in itertools.product(*(range(ranks.shape[i]) for i in other))]


def build_mesh(ranks: np.ndarray, axis_names: Tuple[str, ...]) -> Mesh:
    """A :class:`Mesh` over the rank grid ``ranks``. With a
    ``torch.distributed`` world every rank must call it, with the same
    grid: each group is made by ``dist.new_group`` on every rank in one
    order. A line of the whole world is the default group (so a world of
    one rank still runs its collectives), a line of one rank in a larger
    world is None (nothing to reduce), and a line met twice is made once."""
    if not dist.is_initialized():
        if ranks.size != 1:
            raise ValueError(f"a mesh of {ranks.size} ranks needs a torch.distributed world "
                             "of that size (parallel/multihost.py:distributed_init)")
        return Mesh(ranks, axis_names, 0, {})
    rank, world = dist.get_rank(), dist.get_world_size()
    if sorted(ranks.ravel().tolist()) != list(range(world)):
        raise ValueError(f"the mesh's {ranks.size} ranks are not the world's {world}")
    made, groups = {}, {}
    for n in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, n):
            for line in _lines(ranks, axis_names, axes):
                key = tuple(line)
                if key not in made:
                    made[key] = (dist.group.WORLD if len(line) == world
                                 else None if len(line) == 1 else dist.new_group(line))
                if rank in line:
                    groups[axes] = made[key]
    return Mesh(ranks, axis_names, rank, groups)


def make_mesh(config: Optional[MeshConfig] = None, world: Optional[int] = None) -> Mesh:
    """The dp x tp [x cp] mesh over the current world (one rank without a
    ``torch.distributed`` world), ranks in order with cp innermost."""
    config = config or MeshConfig()
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    dp, tp, cp = mesh_shape(config, world)
    if cp > 1:
        return build_mesh(np.arange(world).reshape(dp, tp, cp), ("dp", "tp", "cp"))
    return build_mesh(np.arange(world).reshape(dp, tp), ("dp", "tp"))


def rank_grid(ordered: Sequence[int], config: MeshConfig) -> np.ndarray:
    """``ordered`` global ranks laid out as the (dp, tp[, cp]) grid of
    ``config``."""
    dp, tp, cp = mesh_shape(config, len(ordered))
    shape = (dp, tp, cp) if cp > 1 else (dp, tp)
    return np.asarray(list(ordered)).reshape(shape)
