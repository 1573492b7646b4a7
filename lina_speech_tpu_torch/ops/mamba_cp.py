"""Context-parallel (time-sharded) Mamba selective scan (PyTorch port).

Counterpart of ``lina_speech_tpu/ops/mamba_cp.py``, with the strategy of
``ops/gla_cp.py``: h_t = dA_t h_{t-1} + dBx_t is affine in the state, so a
shard is a (D, S) pair, D = prod dA (full rank over (d, n): exp(sum dt A))
and S its zero-state contribution. Each rank runs the ``mamba_scan``
kernel on its shard from a zero state (:func:`mamba_cp_shard`), the pairs
come together in one gradient-carrying all_gather and compose
(``ops/gla_cp.py:cp_combine``, ``cp_states``), and each rank adds the readout of the state
entering its shard (:func:`mamba_cp_correct`):

    y_t += alive_t sum_n exp(cumsum(dt)_t[d] A[d, n]) S_in[d, n] C_t[n]

with the inclusive cumsum (the readout sees the state after the update).
A reset zeroes the decay at its step (``ops/mamba.py``): a row with a
reset in the shard has D = 0, and ``alive`` kills the correction from the
first reset on (JAX ``mamba_cp.py:80-99``).

The correction's factor exp(cumsum(dt) A) is (b, t, d, n): at the
flagship Mamba width (d 2048, n 16), b 8 and a 128-step shard 134 MB in
f32 a layer, which autograd would keep for the backward. It is computed
in pieces of time under ``torch.utils.checkpoint``, so no piece is kept
and the backward recomputes each one.

:func:`selective_scan_cp` is the distributed op; :func:`selective_scan_cp_shards`
runs all n shards in one process through the same functions.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from lina_speech_tpu_torch.ops.gla_cp import _shards_exchange, cp_exchange
from lina_speech_tpu_torch.parallel.sharding import time_shard

_PIECE_ELEMENTS = 1 << 23  # f32 values of exp(cumsum(dt) A) a piece: 32 MiB


def _default_local():
    from lina_speech_tpu_torch.ops.mamba_cuda import mamba_scan

    return mamba_scan


def mamba_cp_shard(x, dt, A, B, C, D, reset=None, local: Optional[Callable] = None):
    """One shard's scan from a zero state: (y_loc in x's dtype, decay (b, d,
    n) f32 -- 0 for a row with a reset in the shard --, contribution (b, d,
    n) f32). ``reset`` (b, t) bool or None."""
    local = local or _default_local()
    y_loc, s_loc = local(x, dt, A, B, C, D, initial_state=None, reset_mask=reset)
    decay = torch.exp(torch.einsum("bd,dn->bdn", dt.float().sum(1), A.float()))
    if reset is not None:
        decay = decay * (~reset.bool().any(1)).float()[:, None, None]
    return y_loc, decay, s_loc.float()


def _correction_piece(cd, C, alive, A, s_in):
    e = torch.exp(cd[..., None] * A)  # (b, piece, d, n)
    return torch.einsum("btdn,bdn,btn->btd", e, s_in, C) * alive[..., None]


def mamba_cp_correct(dt, A, C, y_loc, s_in, reset=None):
    """y_loc plus the readout of the state ``s_in`` (b, d, n) entering the
    shard (module docstring), in y_loc's dtype. The (b, t, d, n) factor
    lives one piece of time at a time, recomputed in the backward."""
    b, t, d = dt.shape
    cd = dt.float().cumsum(1)
    alive = (torch.ones(b, t, device=dt.device) if reset is None
             else 1.0 - reset.float().cummax(1).values)
    Af, Cf = A.float(), C.float()
    piece = max(1, _PIECE_ELEMENTS // (b * d * A.shape[-1]))
    parts = []
    for i in range(0, t, piece):
        args = (cd[:, i:i + piece], Cf[:, i:i + piece], alive[:, i:i + piece], Af, s_in)
        if torch.is_grad_enabled():
            parts.append(torch.utils.checkpoint.checkpoint(_correction_piece, *args,
                                                           use_reentrant=False))
        else:
            parts.append(_correction_piece(*args))
    return (y_loc.float() + torch.cat(parts, 1)).to(y_loc.dtype)


def selective_scan_cp(x, dt, A, B, C, D, initial_state=None, reset_mask=None, *, group,
                      local: Optional[Callable] = None):
    """Context-parallel ``selective_scan`` over the ranks of ``group``, each
    passing its time shard x, dt (b, t, d), B, C (b, t, n) and
    ``reset_mask`` (b, t) bool or None, in rank order; A (d, n), D (d,) and
    ``initial_state`` (b, d, n) the same on every rank. Returns (y this
    shard's output in x's dtype, the final state on every rank in the
    initial state's dtype, f32 without one). Differentiable in every input
    but the reset mask."""
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    y_loc, dec, s = mamba_cp_shard(x, dt, A, B, C, D, reset_mask, local)
    s_in, s_final = cp_exchange(dec, s, initial_state, group)
    return mamba_cp_correct(dt, A, C, y_loc, s_in, reset_mask), s_final.to(state_dtype)


def selective_scan_cp_shards(x, dt, A, B, C, D, initial_state=None, reset_mask=None, *,
                             n: int, local: Optional[Callable] = None):
    """The distributed op's arithmetic in one process, the whole sequence
    cut into n time shards (zero-padded at the end: dt 0 changes nothing):
    same outputs as ``selective_scan``."""
    t = x.shape[1]
    state_dtype = torch.float32 if initial_state is None else initial_state.dtype
    shard = lambda z, j: time_shard(z, n, j, 1)
    resets = [None if reset_mask is None else shard(reset_mask.float(), j).bool()
              for j in range(n)]
    cut = [[shard(z, j) for z in (x, dt, B, C)] for j in range(n)]
    runs = [mamba_cp_shard(xs, dts, A, Bs, Cs, D, resets[j], local)
            for j, (xs, dts, Bs, Cs) in enumerate(cut)]
    s_in, s_final = _shards_exchange(runs, initial_state)
    y = torch.cat([mamba_cp_correct(c[1], A, c[3], r[0], s_in[j], resets[j])
                   for j, (c, r) in enumerate(zip(cut, runs))], 1)
    return y[:, :t], s_final.to(state_dtype)
