"""Context-parallel (time-sharded) GLA and RWKV6 chunk scans (PyTorch port).

Counterpart of ``lina_speech_tpu/ops/gla_cp.py``. A GLA state after a span
is affine in the state before it, S_out = diag(D) S_in + B, with D the
span's decay exp(sum g) and B its contribution from a zero state, and the
pairs compose associatively:

    (D1, B1) then (D2, B2) == (D1 D2, D2 B1 + B2).

So each rank runs the chunk kernel on its own time shard from a ZERO state
(:func:`gla_cp_shard`: the local output and the (D, B) pair), the pairs of
all ranks come together in one gradient-carrying all_gather
(``parallel/collectives.py:all_gather_grad``), every rank composes them
(:func:`cp_combine`, the same small loop on every rank, JAX's associative
scan) into the state entering its shard and the global final state
(:func:`cp_states`), and adds the closed-form
term of the state entering its shard (:func:`gla_cp_correct`):

    o_t += (scale q_t exp(b_t)) S_in,

b_t the inclusive in-shard gate sum (GLA's readout sees the state after
the update). RWKV6's readout sees the state before it: the exclusive sum,
no scale, and the bonus u stays inside the local run (JAX :255-268).
Matmul operands follow the IO dtype (bf16 rounded, f32 accumulation), as
JAX's einsum at :150-154. Resets fold into the gates (-20), so D kills the
state across a reset as the local scan does.

The three pieces are separate functions so that a single process can run
all n shards through them (:func:`gla_chunk_cp_shards`,
:func:`rwkv6_chunk_cp_shards`: the card's check holds them against the
single-device kernels); :func:`gla_chunk_cp` and :func:`rwkv6_chunk_cp`
are the distributed ops, each rank passing its own shard and the cp
process group. The per-shard kernel is ``local``: the CUDA wrapper
(``ops/gla_cuda.py:gla_chunk``, ``ops/rwkv6_cuda.py:rwkv6_chunk``, their
plain versions on CPU tensors) unless a caller passes the plain version.
Every rank must hold the same (b, h) heads; shard lengths may differ, the
pairs do not depend on them.

The final state is returned on every rank; its gradient is the sum of the
cotangents the ranks give it (each rank's use of it is local to that rank).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from lina_speech_tpu_torch.parallel.collectives import all_gather_grad, group_rank, select
from lina_speech_tpu_torch.parallel.sharding import time_shard


def _operand(x: torch.Tensor, io: torch.dtype) -> torch.Tensor:
    """A matmul operand at the IO dtype's precision in f32: bf16 IO rounds
    it to bf16 (a product of two bf16 values is exact in f32, so this is
    JAX's bf16 operands with f32 accumulation up to summation order)."""
    return x.to(torch.bfloat16).float() if io == torch.bfloat16 else x


def cp_combine(d: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive prefix compositions of n consecutive shards' pairs.

    d: (n, ...) decays, with one axis fewer than s where a decay is shared
    by the state's last axis (GLA's (b, h, dk) against (b, h, dk, dv)), or
    s's shape (Mamba); s: (n, ...) contributions from a zero state. Returns
    (d_inc, s_inc): shards 0..j as one pair, for every j (f32)."""
    expand = (lambda x: x[..., None]) if d.ndim < s.ndim else (lambda x: x)
    d_inc, s_inc = [d[0]], [s[0]]
    for j in range(1, s.shape[0]):
        d_inc.append(d_inc[-1] * d[j])
        s_inc.append(expand(d[j]) * s_inc[-1] + s[j])
    return torch.stack(d_inc), torch.stack(s_inc)


def cp_states(d_inc: torch.Tensor, s_inc: torch.Tensor, s0: Optional[torch.Tensor], j: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the state entering shard j, the final state) from the prefixes of
    :func:`cp_combine`; s0 enters shard 0 (zeros where None). Shard 0's
    entering state is selected rather than branched to, as JAX's
    ``_cp_exchange`` selects it: the prefixes stay in every rank's graph,
    so every rank runs the gather's backward collective."""
    expand = (lambda x: x[..., None]) if d_inc.ndim < s_inc.ndim else (lambda x: x)
    prev = max(j - 1, 0)
    s_prev = select(j == 0, torch.zeros_like(s_inc[0]), s_inc[prev])
    s_final = s_inc[-1]
    if s0 is None:
        return s_prev, s_final
    s0 = s0.float()
    d_prev = select(j == 0, torch.ones_like(d_inc[0]), d_inc[prev])
    return expand(d_prev) * s0 + s_prev, expand(d_inc[-1]) * s0 + s_final


def cp_exchange(d_loc: torch.Tensor, s_loc: torch.Tensor, s0: Optional[torch.Tensor], group
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(state entering this rank's shard, global final state): this rank's
    pair gathered with every rank's in one all_gather (decay and
    contribution packed in one f32 row) and composed on every rank."""
    nd = d_loc.numel()
    packed = all_gather_grad(torch.cat([d_loc.reshape(-1), s_loc.reshape(-1)]), group)
    d = packed[:, :nd].reshape(-1, *d_loc.shape)
    s = packed[:, nd:].reshape(-1, *s_loc.shape)
    return cp_states(*cp_combine(d, s), s0, group_rank(group))


def _shards_exchange(runs, s0):
    """(entering states of every shard, final state) of the in-process
    shards' runs (o_loc, decay, contribution)."""
    prefixes = cp_combine(torch.stack([r[1] for r in runs]), torch.stack([r[2] for r in runs]))
    states = [cp_states(*prefixes, s0, j) for j in range(len(runs))]
    return [st[0] for st in states], states[-1][1]


def _default_local_gla():
    from lina_speech_tpu_torch.ops.gla_cuda import gla_chunk

    return gla_chunk


def _default_local_rwkv6():
    from lina_speech_tpu_torch.ops.rwkv6_cuda import rwkv6_chunk

    return rwkv6_chunk


def gla_cp_shard(q, k, v, gk, scale: float, local: Optional[Callable] = None):
    """One shard's run from a zero state: (o_loc in the IO dtype, decay D
    (b, h, dk) f32, contribution B (b, h, dk, dv) f32)."""
    local = local or _default_local_gla()
    o_loc, s_loc = local(q, k, v, gk, initial_state=None, scale=scale)
    return o_loc, torch.exp(gk.float().sum(2)), s_loc.float()


def gla_cp_correct(q, gk, o_loc, s_in, scale: float = 1.0, exclusive: bool = False):
    """o_loc plus the readout of the state ``s_in`` entering the shard
    through the in-shard decay: inclusive gate sums (GLA) or exclusive ones
    (RWKV6); q scaled by ``scale``. In q's dtype."""
    gf = gk.float()
    bc = gf.cumsum(2)
    if exclusive:
        bc = bc - gf
    io = q.dtype
    qdec = q.float() * scale * bc.exp()
    corr = torch.matmul(_operand(qdec, io), _operand(s_in, io))
    return (o_loc.float() + corr).to(io)


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def gla_chunk_cp(q, k, v, gk, initial_state=None, scale=None, *, group,
                 local: Optional[Callable] = None):
    """Context-parallel ``gla_chunk`` over the ranks of ``group``, each
    passing its time shard q, k, gk (b, h, t, dk), v (b, h, t, dv), in rank
    order; ``initial_state`` (b, h, dk, dv), the same on every rank, enters
    rank 0's shard. Returns (o, final state): o this shard's output in the
    IO dtype, the final state of the whole sequence on every rank, in the
    initial state's dtype (f32 without one). Differentiable in every input."""
    scale = _scale(q, scale)
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    o_loc, d, s = gla_cp_shard(q, k, v, gk, scale, local)
    s_in, s_final = cp_exchange(d, s, initial_state, group)
    return gla_cp_correct(q, gk, o_loc, s_in, scale), s_final.to(state_dtype)


def _run_shards(n: int, xs, dim: int, shard_fn):
    """Pad and cut every tensor of ``xs`` into n time shards and run
    ``shard_fn(*shard)`` on each: the list of its results."""
    cut = [[time_shard(x, n, j, dim) for x in xs] for j in range(n)]
    return cut, [shard_fn(*c) for c in cut]


def gla_chunk_cp_shards(q, k, v, gk, initial_state=None, scale=None, *, n: int,
                        local: Optional[Callable] = None):
    """The distributed op's arithmetic in one process: the whole sequence
    (b, h, t, .) cut into n time shards (zero-padded at the end,
    ``parallel/sharding.py:time_shard``), each run by :func:`gla_cp_shard`,
    the pairs stacked and composed by :func:`cp_combine`, each shard
    corrected by :func:`gla_cp_correct`. Same outputs as ``gla_chunk``."""
    scale = _scale(q, scale)
    t = q.shape[2]
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    cut, runs = _run_shards(n, (q, k, v, gk), 2,
                            lambda *a: gla_cp_shard(*a, scale, local))
    s_in, s_final = _shards_exchange(runs, initial_state)
    o = torch.cat([gla_cp_correct(c[0], c[3], r[0], s_in[j], scale)
                   for j, (c, r) in enumerate(zip(cut, runs))], 2)
    return o[:, :, :t], s_final.to(state_dtype)


def rwkv6_cp_shard(r, k, v, w, u, local: Optional[Callable] = None):
    """One RWKV6 shard's run from a zero state: (o_loc, decay, contribution)."""
    local = local or _default_local_rwkv6()
    o_loc, s_loc = local(r, k, v, w, u, initial_state=None)
    return o_loc, torch.exp(w.float().sum(2)), s_loc.float()


def rwkv6_chunk_cp(r, k, v, w, u, initial_state=None, *, group,
                   local: Optional[Callable] = None):
    """Context-parallel ``rwkv6_chunk``: as :func:`gla_chunk_cp` with RWKV6
    operands (r, k, w (b, h, t, dk), v (b, h, t, dv) this rank's shard; the
    bonus u (h, dk) and ``initial_state`` the same on every rank)."""
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    o_loc, d, s = rwkv6_cp_shard(r, k, v, w, u, local)
    s_in, s_final = cp_exchange(d, s, initial_state, group)
    return gla_cp_correct(r, w, o_loc, s_in, exclusive=True), s_final.to(state_dtype)


def rwkv6_chunk_cp_shards(r, k, v, w, u, initial_state=None, *, n: int,
                          local: Optional[Callable] = None):
    """:func:`gla_chunk_cp_shards` for RWKV6: same outputs as ``rwkv6_chunk``."""
    t = r.shape[2]
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    cut, runs = _run_shards(n, (r, k, v, w), 2, lambda *a: rwkv6_cp_shard(*a, u, local))
    s_in, s_final = _shards_exchange(runs, initial_state)
    o = torch.cat([gla_cp_correct(c[0], c[3], x[0], s_in[j], exclusive=True)
                   for j, (c, x) in enumerate(zip(cut, runs))], 2)
    return o[:, :, :t], s_final.to(state_dtype)
