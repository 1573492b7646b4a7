"""The collectives of data and context parallel training, called by hand.

The port's own module: the JAX package has no such file, because XLA
inserts these collectives itself from the shardings (the all_gather of
``ops/gla_cp.py`` and its transpose, the halo exchange of a time-sharded
convolution, the global sums of a loss over a sharded batch). Here they
are written out:

- :func:`all_gather_grad`: the tensors of every rank of a group, stacked;
  its backward hands each rank the SUM over all ranks of the gradient of
  its own slot (a reduce-scatter on NCCL; gloo has no
  ``reduce_scatter_tensor``, so there an all_reduce and a slice);
- :func:`halo_exchange`: rank r gets the last frames of rank r - 1's time
  shard (rank 0 a given history, zeros by default); their gradient goes
  back to rank r - 1's tail;

Every rank must run the same collectives in the same order, the backward's
too. A gathered tensor is therefore kept in every rank's graph even where
a rank does not need its value (rank 0's halo, its entering state): the
caller selects with :func:`select`, as JAX's ``_cp_exchange`` selects with
``jnp.where``, and the gather's backward runs everywhere;
- :func:`from_last`: the last rank's tensor on every rank (the tail of a
  time-sharded stream, no gradient);
- :func:`all_reduce_sum` (no gradient) and :func:`all_reduce_grads_`: the
  global sums of a loss, its counts and its metrics, and the gradient sum,
  over the ranks a batch is spread over; :func:`broadcast_params_`, the
  replication of parameters from the first rank.

A group of ``None`` stands for a single process: every function is then
the identity (with one slot where it stacks).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


class _AllGather(torch.autograd.Function):
    """(n, *x.shape): slot j holds rank j's ``x``; backward: this rank's
    slot of the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((group_size(group), *x.shape))
        if _nccl(group):
            dist.all_gather_into_tensor(out, x, group=group)
        else:
            dist.all_gather(list(out.unbind(0)), x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        grad = grad.contiguous()
        if _nccl(group):
            out = grad.new_empty(grad.shape[1:])
            dist.reduce_scatter_tensor(out, grad, group=group)
            return out, None
        grad = grad.clone()
        dist.all_reduce(grad, group=group)
        return grad[group_rank(group)], None


def select(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``cond`` else ``b``, both kept in the autograd graph (the
    other one's gradient is zero), as ``jnp.where`` keeps both branches; a
    blend by the host bool, so no condition tensor is copied to the device
    (it runs inside a CUDA graph capture)."""
    keep = float(cond)
    return a * keep + b * (1.0 - keep)


def all_gather_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape and dtype on every rank), stacked
    over a new leading axis in group-rank order; differentiable."""
    if group is None:
        return x[None]
    return _AllGather.apply(x, group)


def halo_exchange(x: torch.Tensor, width: int, group,
                  first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``width`` frames before this rank's time shard ``x`` (b, t, ...):
    the last ``width`` frames of the previous rank's shard, ``first`` (b,
    width, ...) on rank 0 (zeros where None). Differentiable in both: the
    gradient of the frames received returns to the previous rank's tail.
    One all_gather of every rank's tail (b * width * features values a
    rank, small beside the state pairs of ``ops/gla_cp.py``)."""
    if width > x.shape[1]:
        raise ValueError(f"halo_exchange: a shard of {x.shape[1]} frames cannot give {width}")
    if first is None:
        first = x.new_zeros((x.shape[0], width, *x.shape[2:]))
    r = group_rank(group)
    if group_size(group) == 1:
        return first
    tails = all_gather_grad(x[:, x.shape[1] - width:], group)
    # rank 0 selects ``first`` rather than branching: the gathered tails stay
    # in its graph, so it runs the gather's backward collective with the others
    return select(r == 0, first.to(x.dtype), tails[max(r - 1, 0)])


def from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last rank's ``x`` on every rank (no gradient): the tail of a
    stream that is sharded over the group in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.detach().contiguous().clone()
    dist.broadcast(x, src=dist.get_global_rank(group, n - 1), group=group)
    return x


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, a new tensor without gradient."""
    x = x.detach().clone()
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def all_reduce_grads_(grads: Sequence[torch.Tensor], group) -> None:
    """Sum ``grads`` over the group in place, through one flat buffer per
    dtype: one all_reduce a dtype, whatever the number of tensors. Every
    rank must pass the same shapes in the same order."""
    if group is None:
        return
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def broadcast_params_(tensors: List[torch.Tensor], group) -> None:
    """Every tensor set to the group's first rank's copy, in place, through
    one flat buffer per dtype (the replication of parameters)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
