"""RWKV-6 (Finch) recurrence in plain PyTorch: scan oracle, stable chunked
form, decode step.

Counterpart of ``lina_speech_tpu/ops/rwkv6.py``. Per head, with a state S
of shape (d_k, d_v), per-channel log-decays w_t <= 0 and a per-channel
bonus u:

    o_t = r_t @ (S_{t-1} + (u * k_t)^T v_t)
    S_t = diag(exp(w_t)) @ S_{t-1} + k_t^T v_t

Unlike GLA the readout sees the PRE-update state plus a u-weighted bonus
for the current token, and r is not scaled by 1/sqrt(d_k).

- :func:`rwkv6_scan_ref` -- the O(T) recurrence, the correctness oracle;
- :func:`rwkv6_chunk` -- the chunk-parallel form of the JAX package (chunk
  64, sub-chunk 16; every exp argument <= 0), with its rounding points: for
  bf16 IO the matmul operands are rounded to bf16 and accumulated in f32;
- :func:`rwkv6_decode_step` -- one token.

These are the plain versions; the CUDA kernels of the main path live in
``ops/rwkv6_cuda.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _initial_state(r, v, initial_state):
    b, h, _, dk = r.shape
    if initial_state is None:
        return torch.float32, torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32,
                                          device=r.device)
    return initial_state.dtype, initial_state.float()


def rwkv6_scan_ref(r, k, v, w, u, initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive O(T) scan. r, k, w: (b, h, t, dk); v: (b, h, t, dv); u: (h,
    dk) -> (o in r's dtype, final state in the initial state's dtype, f32
    by default)."""
    state_dtype, S = _initial_state(r, v, initial_state)
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], S + uf * kv))
        S = wf[:, :, t, :, None].exp() * S + kv
    o = torch.stack(outs, dim=2) if outs else vf[:, :, :0]
    return o.to(r.dtype), S.to(state_dtype)


def rwkv6_decode_step(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r, k, w: (b, h, dk); v: (b, h, dv); u: (h, dk); state (b,
    h, dk, dv) in any float dtype, math in f32 -> (o in r's dtype, state in
    its own dtype)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    sf = state.float()
    kv = kf[..., None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf, sf + u.float()[None, :, :, None] * kv)
    return o.to(r.dtype), (wf.exp()[..., None] * sf + kv).to(state.dtype)


def rwkv6_chunk(r, k, v, w, u, initial_state=None, chunk_size: int = 64,
                subchunk_size: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel RWKV6, stable (the JAX package's two-level form).

    The readout decay is the exclusive cumsum bx_t = sum_{i<t} w_i, so the
    pairwise factor for s < t is exp(bx_t - b_s) <= 0 and the diagonal s ==
    t term is the u bonus. Arguments and results as :func:`rwkv6_scan_ref`.
    """
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    C, S = chunk_size, subchunk_size
    assert C % S == 0
    ns = C // S
    # bf16 operands with f32 accumulation for bf16 IO: a product of two
    # bf16 values is exact in f32, so rounding the operands and multiplying
    # in f32 is JAX's preferred_element_type=f32 up to summation order
    mm = (lambda x: x.to(torch.bfloat16).float()) if r.dtype == torch.bfloat16 else (lambda x: x)
    ein = lambda spec, *ops: torch.einsum(spec, *(mm(o) for o in ops))

    pad = (-t) % C
    pz = lambda x: F.pad(x.float(), (0, 0, 0, pad))
    rf, kf, vf, wf = pz(r), pz(k), pz(v), pz(w)
    T = t + pad
    nc = T // C
    state_dtype, state = _initial_state(r, v, initial_state)
    uf = u.float()
    tri = torch.tril(torch.ones(S, S, dtype=torch.bool, device=r.device), -1)
    ij = torch.tril(torch.ones(ns, ns, dtype=torch.bool, device=r.device), -1)

    outs = []
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, wc = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], wf[:, :, sl]
        bc = torch.cumsum(wc, dim=2)  # inclusive
        bx = bc - wc                  # exclusive
        b_total = bc[:, :, -1]

        o_inter = ein("bhsk,bhkv->bhsv", rc * bx.exp(), state)
        k_to_end = kc * (b_total[:, :, None] - bc).exp()
        chunk_kv = ein("bhsk,bhsv->bhkv", k_to_end, vc)
        state = b_total.exp()[..., None] * state + chunk_kv

        shp = (b, h, ns, S, dk)
        rs, ks, vs = rc.reshape(shp), kc.reshape(shp), vc.reshape(b, h, ns, S, dv)
        bcs, bxs = bc.reshape(shp), bx.reshape(shp)
        beta = bcs[..., -1, :]
        beta_prev = torch.cat([torch.zeros_like(beta[..., :1, :]), beta[..., :-1, :]], dim=-2)

        # strictly-lower pairs within a sub-chunk: exp(bx_t - b_s), s < t
        pair = bxs[..., :, None, :] - bcs[..., None, :, :]
        pair = pair.masked_fill(~tri[..., None], float("-inf"))
        a_diag = torch.einsum("bhitd,bhisd,bhitsd->bhits", rs, ks, pair.exp())
        o_intra = ein("bhits,bhisv->bhitv", a_diag, vs)
        # u bonus (s == t)
        bonus = torch.einsum("bhitd,hd->bhit", rs * ks, uf)
        o_intra = o_intra + bonus[..., None] * vs

        # across sub-chunks (j < i), anchored factors all <= 0
        r_anch = rs * (bxs - beta_prev[..., None, :]).exp()
        k_anch = ks * (beta[..., None, :] - bcs).exp()
        cross = beta_prev[..., :, None, :] - beta[..., None, :, :]
        cross = cross.masked_fill(~ij[..., None], float("-inf"))
        a_off = torch.einsum("bhitd,bhijd,bhjsd->bhijts", mm(r_anch), cross.exp(), mm(k_anch))
        o_intra = o_intra + ein("bhijts,bhjsv->bhitv", a_off, vs)
        outs.append(o_inter + o_intra.reshape(b, h, C, dv))

    o = torch.cat(outs, dim=2)[:, :, :t] if outs else vf[:, :, :0]
    return o.to(r.dtype), state.to(state_dtype)
