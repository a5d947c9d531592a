"""State-space and recurrent cores in plain PyTorch — the counterpart of
`repro.models.ssm` (JAX's are jnp, not Pallas kernels).

- ``selective_scan`` / ``selective_step`` — the Mamba-style diagonal
  selective SSM of Hymba's SSM heads.
- ``mlstm_*`` — xLSTM's matrix-memory cell: the parallel (quadratic)
  form, the chunkwise form (prefill: the outputs and the final state)
  and the recurrent form (decode), all with the max-stabiliser and its
  ``exp(-m)`` floor on the normaliser.
- ``slstm_step`` / ``slstm_scan`` — xLSTM's scalar-memory cell, strictly
  sequential.

The selective SSM:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * u_t ;   y_t = h_t . C_t

JAX runs `jax.lax.associative_scan` within chunks of 256 (the whole
sequence as one chunk when S % 256 != 0).  Here the chunk only bounds
memory: a Python loop carries h from chunk to chunk, and inside a chunk
a Hillis-Steele doubling scan combines the (a, b) pairs of the
recurrence in ceil(log2 c) elementwise passes, so that the (B, c, I, N)
f32 intermediates stay at a chosen size whatever the prompt's length.
The recurrence is the same; the order of the products differs from
JAX's tree, within f32 rounding.  `selective_scan_ref` is the
per-timestep loop, the tests' oracle.

`mlstm_chunkwise` keeps JAX's chunking rule: chunks of 256, or one chunk
of the whole length when S % 256 != 0; a Python loop carries (C, n, m)
from chunk to chunk where JAX scans.  `slstm_scan` is a Python loop over
time: the caller hoists the input projections (as JAX does), and each
step is one batched product of h with the block-diagonal recurrent
weights, laid out head-major as (H, hd, 4 hd) once per scan, plus the
elementwise gates (`SLSTM_STEP_OPS` operations a step).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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


# --------------------------------------------------------------------- #
# mLSTM (xLSTM's matrix memory)

class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, H, hd, hd) f32
    n: torch.Tensor      # (B, H, hd) f32
    m: torch.Tensor      # (B, H) f32


def mlstm_init_state(b: int, h: int, hd: int,
                     device: torch.device) -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((b, h, hd, hd), **f32),
                      n=torch.zeros((b, h, hd), **f32),
                      m=torch.full((b, h), -1e30, **f32))


def _mlstm_inputs(q, k, v, i_raw, f_raw):
    """(q, k / sqrt(hd), v) as (B, H, S, hd) f32 and (log_f, log_i) as
    (B, H, S) f32."""
    hd = q.shape[-1]
    qf = q.float().transpose(1, 2)
    kf = (k.float() / (hd ** 0.5)).transpose(1, 2)
    vf = v.float().transpose(1, 2)
    log_f = F.logsigmoid(f_raw.float()).transpose(1, 2)
    log_i = i_raw.float().transpose(1, 2)
    return qf, kf, vf, log_f, log_i


def _decay(lcum: torch.Tensor, log_i: torch.Tensor) -> torch.Tensor:
    """The causal log-decay matrix D[t, s] = lcum[t] - lcum[s] + log_i[s]
    for s <= t, -inf above the diagonal.  (B, H, c, c)."""
    c = lcum.shape[-1]
    dlog = lcum[..., :, None] - lcum[..., None, :] + log_i[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool,
                        device=lcum.device).tril()
    return dlog.masked_fill(~causal, float("-inf"))


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_raw: torch.Tensor, f_raw: torch.Tensor) -> torch.Tensor:
    """The stabilised parallel (quadratic) form.  q, k, v: (B, S, H, hd);
    i_raw, f_raw: (B, S, H).  Returns (B, S, H, hd) in q's dtype."""
    qf, kf, vf, log_f, log_i = _mlstm_inputs(q, k, v, i_raw, f_raw)
    dlog = _decay(log_f.cumsum(-1), log_i)
    m = dlog.amax(-1)                                         # (B,H,S)
    scores = (qf @ kf.transpose(-1, -2)) * torch.exp(dlog - m[..., None])
    denom = torch.maximum(scores.sum(-1).abs(), torch.exp(-m))
    out = (scores @ vf) / denom[..., None]
    return out.transpose(1, 2).to(q.dtype)


def mlstm_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """One step.  q, k, v: (B, H, hd); gates (B, H).  Returns (out (B, H,
    hd) in q's dtype, the new state)."""
    hd = q.shape[-1]
    qf, kf, vf = q.float(), k.float() / (hd ** 0.5), v.float()
    log_f = F.logsigmoid(f_raw.float())
    log_i = i_raw.float()
    m_new = torch.maximum(log_f + state.m, log_i)
    f_s = torch.exp(log_f + state.m - m_new)[..., None]
    i_s = torch.exp(log_i - m_new)[..., None]
    C = f_s[..., None] * state.C + i_s[..., None] * (
        vf[..., :, None] * kf[..., None, :])
    n = f_s * state.n + i_s * kf
    num = (C @ qf[..., None])[..., 0]
    den = torch.maximum((n * qf).sum(-1).abs(), torch.exp(-m_new))[..., None]
    return (num / den).to(q.dtype), MLSTMState(C=C, n=n, m=m_new)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    state: MLSTMState, chunk: int = CHUNK
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """The chunked linear-memory form: parallel within a chunk, the
    recurrent state across chunks, with consistent max-stabilisers; from
    the init state it equals `mlstm_parallel`.  Chunks of `chunk`, or one
    chunk of the whole length when S % chunk != 0 (JAX's rule).  Returns
    (out (B, S, H, hd) in q's dtype, the state at the end)."""
    s = q.shape[1]
    if s % chunk:
        chunk = s
    qf, kf, vf, log_f, log_i = _mlstm_inputs(q, k, v, i_raw, f_raw)
    C_p, n_p, m_p = state.C.float(), state.n.float(), state.m.float()
    outs = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        qc, kc, vc, li = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            log_i[:, :, sl]
        lcum = log_f[:, :, sl].cumsum(-1)                     # (B,H,c)
        g = lcum[..., -1]                                     # total decay
        dlog = _decay(lcum, li)
        m_inter = m_p[..., None] + lcum
        m_c = torch.maximum(dlog.amax(-1), m_inter)
        sc = (qc @ kc.transpose(-1, -2)) * torch.exp(dlog - m_c[..., None])
        w_inter = torch.exp(m_inter - m_c)[..., None]         # (B,H,c,1)
        num = sc @ vc + w_inter * (qc @ C_p.transpose(-1, -2))
        den_vec = sc.sum(-1) + w_inter[..., 0] * (qc @ n_p[..., None])[..., 0]
        den = torch.maximum(den_vec.abs(), torch.exp(-m_c))
        outs.append(num / den[..., None])
        # the state at the end of the chunk
        tail = g[..., None] - lcum + li
        m_new = torch.maximum(m_p + g, tail.amax(-1))
        decay_s = torch.exp(tail - m_new[..., None])          # (B,H,c)
        carry = torch.exp(m_p + g - m_new)
        C_p = carry[..., None, None] * C_p \
            + (vc * decay_s[..., None]).transpose(-1, -2) @ kc
        n_p = carry[..., None] * n_p + (decay_s[..., None] * kc).sum(-2)
        m_p = m_new
    out = torch.cat(outs, dim=2).transpose(1, 2)
    return out.to(q.dtype), MLSTMState(C=C_p, n=n_p, m=m_p)


# --------------------------------------------------------------------- #
# sLSTM (xLSTM's scalar memory): strictly sequential

class SLSTMState(NamedTuple):
    c: torch.Tensor      # (B, H, hd) f32, as n, m and h
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def slstm_init_state(b: int, h: int, hd: int,
                     device: torch.device) -> SLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((b, h, hd), **f32)
    return SLSTMState(c=z, n=z, m=torch.full((b, h, hd), -1e30, **f32), h=z)


def _slstm_cell(z_pre, i_pre, f_pre, o_pre, c, n, m):
    """The gates and the state update from the pre-activations (f32):
    returns (c, n, m, h)."""
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    a = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(a, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(a - m_new)
    c = torch.addcmul(f_s * c, i_s, z)
    n = torch.addcmul(i_s, f_s, n)
    return c, n, m_new, o * c / n.clamp_min(1e-6)


def slstm_step(xw: torch.Tensor, r: torch.Tensor,
               state: SLSTMState) -> SLSTMState:
    """One timestep.  xw: (B, 4, H, hd) the precomputed input projections
    (z, i, f, o); r: (4, H, hd, hd) the block-diagonal recurrent
    weights."""
    pre = xw.float() + torch.einsum("bhk,ghkl->bghl", state.h, r.float())
    c, n, m, h = _slstm_cell(pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3],
                             state.c, state.n, state.m)
    return SLSTMState(c=c, n=n, m=m, h=h)


# aten operations one step of `slstm_scan` issues (held by a test)
SLSTM_STEP_OPS = 16


def slstm_scan(xw_seq: torch.Tensor, r: torch.Tensor, state: SLSTMState
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """xw_seq: (B, S, 4, H, hd).  Returns (h_seq (B, S, H, hd) f32, the
    final state).  Head-major inside: each step is one batched product
    (H, B, hd) @ (H, hd, 4 hd) added to that step's projections."""
    b, s, _, h, hd = xw_seq.shape
    xw = xw_seq.float().permute(1, 3, 0, 2, 4).reshape(s, h, b, 4 * hd)
    r2 = r.float().permute(1, 2, 0, 3).reshape(h, hd, 4 * hd)
    c, n, m, hh = (x.transpose(0, 1) for x in state)           # (H,B,hd)
    hs = []
    for t in range(s):
        pre = torch.baddbmm(xw[t], hh, r2).view(h, b, 4, hd)
        c, n, m, hh = _slstm_cell(pre[:, :, 0], pre[:, :, 1], pre[:, :, 2],
                                  pre[:, :, 3], c, n, m)
        hs.append(hh)
    final = SLSTMState(*(x.transpose(0, 1) for x in (c, n, m, hh)))
    return torch.stack(hs).permute(2, 0, 1, 3), final
