"""Mamba-style diagonal selective SSM (Hymba's SSM heads) — the
counterpart of `selective_scan` and `selective_step` in
`repro.models.ssm`, in plain PyTorch (JAX's are jnp, not Pallas kernels).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * u_t ;   y_t = h_t . C_t

JAX runs `jax.lax.associative_scan` within chunks of 256 (the whole
sequence as one chunk when S % 256 != 0).  Here the chunk only bounds
memory: a Python loop carries h from chunk to chunk, and inside a chunk
a Hillis-Steele doubling scan combines the (a, b) pairs of the
recurrence in ceil(log2 c) elementwise passes, so that the (B, c, I, N)
f32 intermediates stay at a chosen size whatever the prompt's length.
The recurrence is the same; the order of the products differs from
JAX's tree, within f32 rounding.

`selective_scan_ref` is the per-timestep loop, the tests' oracle.
The mLSTM and sLSTM cells of the reference module are xLSTM's and are
not ported yet (ROADMAP.md A7).
"""
from __future__ import annotations

from typing import Tuple

import torch

# (B, c, I, N) f32 at Hymba's I = 1600, N = 16 and 8 rows: 210 MB a buffer
CHUNK = 256


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): afterwards b_t is h_t for
    h_{-1} = 0 and a_t the product a_0 ... a_t."""
    c = a.shape[1]
    d = 1
    while d < c:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_new = a[:, d:] * a_prev
        b_new = b_prev * a[:, d:] + b[:, d:]
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d <<= 1
    return a, b


def selective_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_t: torch.Tensor, C_t: torch.Tensor, h0: torch.Tensor,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, S, I); A: (I, N); B_t, C_t: (B, S, N); h0: (B, I, N).
    Returns (y (B, S, I), h_final (B, I, N)); the skip term is the
    caller's."""
    s = u.shape[1]
    h = h0
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        dtc = dt[:, sl]
        dA = torch.exp(dtc[..., None] * A)                       # (B,c,I,N)
        dBu = (dtc * u[:, sl])[..., None] * B_t[:, sl, None, :]
        a_cum, b_cum = _doubling_scan(dA, dBu)
        h_all = b_cum + a_cum * h[:, None]
        ys.append(torch.einsum("bcin,bcn->bci", h_all, C_t[:, sl]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def selective_step(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_t: torch.Tensor, C_t: torch.Tensor, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  u, dt: (B, I); B_t, C_t: (B, N); h: (B, I, N).
    Returns (y (B, I), h_new (B, I, N))."""
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * u)[..., None] * B_t[:, None, :]
    h_new = dA * h + dBu
    return torch.einsum("bin,bn->bi", h_new, C_t), h_new


def selective_scan_ref(u, dt, A, B_t, C_t, h0):
    """The recurrence one timestep at a time (the oracle)."""
    h = h0
    ys = []
    for t in range(u.shape[1]):
        y, h = selective_step(u[:, t], dt[:, t], A, B_t[:, t], C_t[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h
