"""Gated linear attention (GLA) scans in plain PyTorch.

Counterpart of ``lina_speech_tpu/ops/gla.py``. Per head, with log-gates
``gk <= 0`` and an f32 state ``S`` of shape (d_k, d_v):

    S_t = diag(exp(gk_t)) S_{t-1} + k_t^T v_t,    o_t = (scale q_t) S_t

- :func:`gla_scan_ref` -- the O(T) recurrence, the correctness oracle;
- :func:`gla_chunk` -- the chunk-parallel form (every ``exp`` argument is
  <= 0, so it is stable under hard resets);
- :func:`gla_decode_step` -- one token, update and readout;
- :func:`gla_decode_lazy_step` / :func:`gla_decode_lazy_fold` -- the same
  recurrence with a read-only state between folds: a window of L tokens
  rides small buffers and is folded into the state once per window.

These are the plain versions; the CUDA kernels of the main path live in
``ops/gla_cuda.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


def _initial_state(q, v, initial_state):
    b, h, _, dk = q.shape
    if initial_state is None:
        return torch.float32, torch.zeros(b, h, dk, v.shape[-1],
                                          dtype=torch.float32, device=q.device)
    return initial_state.dtype, initial_state.float()


def gla_scan_ref(q, k, v, gk, initial_state=None, scale=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, gk: (b, h, t, dk); v: (b, h, t, dv) -> (o in q's dtype,
    final state in the initial state's dtype, f32 by default)."""
    scale = _default_scale(q, scale)
    state_dtype, S = _initial_state(q, v, initial_state)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, gk))
    outs = []
    for t in range(q.shape[2]):
        S = gf[:, :, t, :, None].exp() * S + kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, :, t] * scale, S))
    o = torch.stack(outs, dim=2) if outs else vf[:, :, :0]
    return o.to(q.dtype), S.to(state_dtype)


def gla_decode_step(q, k, v, gk, state, scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. q, k, gk: (b, h, dk); v: (b, h, dv); state (b, h, dk, dv)
    in any float dtype, math in f32 -> (o in q's dtype, state's dtype)."""
    scale = _default_scale(q, scale)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, gk))
    eg = gf.exp()
    sf = state.float()
    new_state = eg[..., None] * sf + kf[..., None] * vf[..., None, :]
    # readout from the pre-update state: q.S' = (q.eg).S + (q.k) v exactly
    o = (torch.einsum("bhk,bhkv->bhv", qf * scale * eg, sf)
         + (qf * scale * kf).sum(-1, keepdim=True) * vf)
    return o.to(q.dtype), new_state.to(state.dtype)


def gla_decode_lazy_step(q, k, v, gk, s_base, kbuf, vbuf, cbuf, cc, p: int,
                         scale=None):
    """Lazy-window decode step: the base state is only read.

    q, k, gk: (b, h, dk); v: (b, h, dv); s_base: (b, h, dk, dv) state as of
    the last fold; kbuf: (L, b, h, dk), vbuf: (L, b, h, dv) window token
    buffers; cbuf: (L, b, h, dk) f32 gate cumsums at each buffered token;
    cc: (b, h, dk) f32 gate cumsum since the last fold; p: position in the
    window (0-based).

    Returns (o, kbuf, vbuf, cbuf, cc) with the token appended at slot ``p``
    (new tensors; the inputs are left untouched). Slots ``j > p`` may hold
    stale tokens of the previous window: they are masked, and the clamp
    keeps every exp argument <= 0 whatever they hold (cc is non-increasing,
    and cc <= cbuf[j] for the live slots j <= p).
    """
    scale = _default_scale(q, scale)
    L = kbuf.shape[0]
    qf, gf = q.float(), gk.float()
    cc = cc + gf
    kbuf, vbuf, cbuf = kbuf.clone(), vbuf.clone(), cbuf.clone()
    kbuf[p], vbuf[p], cbuf[p] = k.to(kbuf.dtype), v.to(vbuf.dtype), cc.to(cbuf.dtype)

    o = torch.einsum("bhk,bhkv->bhv", qf * scale * cc.exp(), s_base.float())
    live = (torch.arange(L, device=q.device) <= p).float()[:, None, None, None]
    w = (cc[None] - cbuf.float()).clamp(max=0.0).exp() * live
    a = torch.einsum("bhk,lbhk->lbh", qf * scale, kbuf.float() * w)
    o = o + torch.einsum("lbh,lbhv->bhv", a, vbuf.float())
    return o.to(q.dtype), kbuf, vbuf, cbuf, cc


def gla_decode_lazy_fold(s_base, kbuf, vbuf, cbuf, cc) -> torch.Tensor:
    """Fold a FULL window of buffered tokens into the base state:
    S = exp(cc) * S + sum_j (k_j * exp(min(cc - c_j, 0)))^T v_j, the
    chunk-scan state update. Returns the new state only (a new tensor in
    the base state's dtype); the buffers stay stale by contract and the
    caller resets ``cc`` to zero."""
    dec = (cc[None] - cbuf.float()).clamp(max=0.0).exp()
    s = cc.exp()[..., None] * s_base.float() + torch.einsum(
        "lbhk,lbhv->bhkv", kbuf.float() * dec, vbuf.float())
    return s.to(s_base.dtype)


def gla_chunk(q, k, v, gk, initial_state=None, scale=None,
              chunk_size: int = 64, subchunk_size: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel GLA, shapes as :func:`gla_scan_ref`.

    ``t`` is padded to a multiple of ``chunk_size`` with k = 0, gk = 0, so
    outputs and the final state are exact. Matmul operands follow the IO
    dtype (bf16 inputs give bf16 products accumulated in f32); gates,
    cumsums and the state stay f32.
    """
    scale = _default_scale(q, scale)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    C, S = chunk_size, subchunk_size
    if C % S:
        raise ValueError(f"chunk_size {C} must be a multiple of {S}")
    ns = C // S
    pad = (-t) % C
    if pad:
        q, k, v, gk = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, gk))
    T = t + pad
    nc = T // C
    state_dtype, state = _initial_state(q, v, initial_state)
    mm = q.dtype if q.dtype == torch.bfloat16 else torch.float32

    def ein(spec, *ops):
        return torch.einsum(spec, *(o.to(mm) for o in ops)).float()

    dev = q.device
    tri = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    ij = torch.tril(torch.ones(ns, ns, dtype=torch.bool, device=dev), -1)
    qc = (q.float() * scale).reshape(b, h, nc, C, dk)
    kc = k.float().reshape(b, h, nc, C, dk)
    vc = v.float().reshape(b, h, nc, C, dv)
    gc = gk.float().reshape(b, h, nc, C, dk)
    outs = []
    for c in range(nc):
        qf, kf, vf, gf = qc[:, :, c], kc[:, :, c], vc[:, :, c], gc[:, :, c]
        bc = gf.cumsum(dim=2)
        b_total = bc[:, :, -1]
        o_inter = ein("bhsk,bhkv->bhsv", qf * bc.exp(), state)
        k_to_end = kf * (b_total[:, :, None] - bc).exp()
        state = b_total.exp()[..., None] * state + ein("bhsk,bhsv->bhkv", k_to_end, vf)

        shp = (b, h, ns, S, dk)
        qs, ks, bs = qf.reshape(shp), kf.reshape(shp), bc.reshape(shp)
        vs = vf.reshape(b, h, ns, S, dv)
        beta = bs[..., -1, :]
        beta_prev = torch.cat([torch.zeros_like(beta[..., :1, :]), beta[..., :-1, :]], -2)
        pair = bs[..., :, None, :] - bs[..., None, :, :]
        pair = torch.where(tri[..., None], pair, float("-inf"))
        a_diag = torch.einsum("bhitd,bhisd,bhitsd->bhits", qs, ks, pair.exp())
        o_intra = ein("bhits,bhisv->bhitv", a_diag, vs)
        q_anch = qs * (bs - beta_prev[..., None, :]).exp()
        k_anch = ks * (beta[..., None, :] - bs).exp()
        cross = beta_prev[..., :, None, :] - beta[..., None, :, :]
        cross = torch.where(ij[..., None], cross, float("-inf"))
        a_off = ein("bhitd,bhijd,bhjsd->bhijts", q_anch, cross.exp(), k_anch)
        o_intra = o_intra + ein("bhijts,bhjsv->bhitv", a_off, vs)
        outs.append(o_inter + o_intra.reshape(b, h, C, dv))
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(q.dtype), state.to(state_dtype)
