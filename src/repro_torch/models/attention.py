"""Attention cores in plain PyTorch: the visibility mask, the GQA fold and
the reference full attention.  The model's prefill attention goes
through `kernels.ops.flash_attention` (the hand-written kernel on the
card); `full_attention` is its plain counterpart and the oracle of the
flash kernel's plain version.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: int, prefix: int):
    """Boolean (Q, S) visibility mask from absolute positions, or None when
    not causal.  Prefix tokens (kv_pos < prefix) are exempt from the window
    but still causal."""
    if not causal:
        return None
    m = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        inwin = kv_pos[None, :] > q_pos[:, None] - window
        if prefix > 0:
            inwin = inwin | (kv_pos < prefix)[None, :]
        m = m & inwin
    return m


def _gqa_fold(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Q, H, hd) -> (B, Q, K, G, hd), kv-major."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   prefix: int = 0) -> torch.Tensor:
    """Reference attention, queries and keys both from position 0.
    q: (B, Q, H, hd); k, v: (B, S, K, hd).  Scores divide by sqrt(hd)
    after the product, in f32."""
    b, qlen, h, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    qf = _gqa_fold(q, nkv).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / (hd ** 0.5)
    m = _mask(torch.arange(qlen, device=q.device),
              torch.arange(s, device=q.device), causal=causal,
              window=window, prefix=prefix)
    if m is not None:
        scores = torch.where(m[None, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, qlen, h, hd).to(q.dtype)
