"""Selective SSM (Mamba v1) scan in plain PyTorch.

Counterpart of ``lina_speech_tpu/ops/mamba.py``. Per channel d, with a
state h of n values, negative rates A (d, n), positive steps dt_t and the
input-dependent B_t, C_t (n):

    h_t = exp(dt_t A) * h_{t-1} + dt_t x_t B_t
    y_t = C_t . h_t + D x_t

The readout sees the state AFTER the update. A reset at t zeroes the decay
exp(dt_t A) there and keeps the input term, so the state restarts from
dt_t x_t B_t (the JAX op's semantics, not a large negative dt A).

- :func:`selective_step` -- one token;
- :func:`selective_scan` -- a time loop over the same f32 step. It is exact
  (the JAX package's associative scan builds (b, t, d, n) intermediates,
  which the loop does not need), and autograd through it is the plain
  backward.

These are the plain versions; the CUDA kernels of the main path live in
``ops/mamba_cuda.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _update(h, x, dt, A, B, C, keep=None):
    """One f32 step from the f32 state ``h`` (b, d, n): x, dt (b, d); A (d,
    n); B, C (b, n); ``keep`` (b,) bool or None: False zeroes the decay.
    Returns (C . h_new (b, d) without the D term, h_new)."""
    decay = torch.exp(dt[..., None] * A)
    if keep is not None:
        decay = torch.where(keep[:, None, None], decay, torch.zeros_like(decay))
    h = decay * h + (dt * x)[..., None] * B[:, None, :]
    return torch.einsum("bdn,bn->bd", h, C), h


def selective_step(x, dt, A, B, C, D, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. x, dt: (b, d); A: (d, n); B, C: (b, n); D: (d,); state
    (b, d, n) in any float dtype, math in f32 -> (y in x's dtype, state in
    its own dtype)."""
    f = lambda v: v.float()
    y, h = _update(state.float(), f(x), f(dt), f(A), f(B), f(C))
    return (y + f(x) * f(D)).to(x.dtype), h.to(state.dtype)


def selective_scan(x, dt, A, B, C, D, initial_state: Optional[torch.Tensor] = None,
                   reset_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (b, t, d); A: (d, n); B, C: (b, t, n); D: (d,);
    ``initial_state`` (b, d, n); ``reset_mask`` (b, t) bool, True zeroes the
    decay at that step. Returns (y (b, t, d) in x's dtype, final state (b,
    d, n): f32 without an initial state, else in its dtype)."""
    b, t, d = x.shape
    n = A.shape[-1]
    xf, dtf, Af, Bf, Cf = (v.float() for v in (x, dt, A, B, C))
    if initial_state is None:
        state_dtype = torch.float32
        h = torch.zeros(b, d, n, dtype=torch.float32, device=x.device)
    else:
        state_dtype, h = initial_state.dtype, initial_state.float()
    keep = None if reset_mask is None else ~reset_mask.bool()
    ys = []
    for i in range(t):
        y, h = _update(h, xf[:, i], dtf[:, i], Af, Bf[:, i], Cf[:, i],
                       None if keep is None else keep[:, i])
        ys.append(y)
    y = torch.stack(ys, 1) if ys else xf[:, :0]
    return (y + xf * D.float()).to(x.dtype), h.to(state_dtype)
