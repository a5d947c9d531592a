"""Attention cores in plain PyTorch: the visibility mask, the GQA fold, the
reference full attention, the chunked online-softmax attention, the
suffix attention and the reference decode attention.  The model's
attention goes through `kernels.ops` (the hand-written kernels on the
card); `full_attention` and `decode_attention` are the plain
counterparts of `repro.models.attention`'s and the oracles of the flash
and decode kernels' plain versions; `attention` is JAX's `impl="auto"`
dispatch (full, or chunked past 2048 keys), which training
differentiates with autograd.  `suffix_attention` is the prefix-cache
admission's attention, plain PyTorch on every device as it is jnp on
every backend in JAX.
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


def suffix_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor
                     ) -> torch.Tensor:
    """Q new tokens per row at per-row absolute positions `q_pos` (B, Q)
    against caches (B, S, K, hd) that are dense from position 0 and hold
    the new tokens' KV already; q (B, Q, H, hd).  Causal by absolute
    position, with `full_attention`'s op sequence (f32 scores divided
    after the product, `where` to NEG_INF, softmax), so a cached-prefix
    suffix pass stays aligned with a full prefill.  Cache rows past a
    query's position are masked with `where`: they may hold anything."""
    b, qlen, h, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    qf = _gqa_fold(q, nkv).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf,
                          k_cache.float()) / (hd ** 0.5)
    m = torch.arange(s, device=q.device)[None, None, :] \
        <= q_pos.long()[:, :, None]                              # (B,Q,S)
    scores = torch.where(m[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.float())
    return out.reshape(b, qlen, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0, prefix: int = 0,
                     slot_pos=None) -> torch.Tensor:
    """One new token per row against a cache.  q: (B, 1, H, hd); caches
    (B, S, K, hd); pos: (B,) int, the index of the current token (cache
    slots past it are invalid).  slot_pos: (B, S) absolute position of
    each cache slot (ring-buffer caches); defaults to 0..S-1."""
    b, _, h, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    qf = _gqa_fold(q, nkv).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf,
                          k_cache.float()) / (hd ** 0.5)
    if slot_pos is None:
        slot_pos = torch.arange(s, device=q.device).expand(b, s)
    pos = pos.long()
    valid = slot_pos <= pos[:, None]
    if window > 0:
        vis = slot_pos > (pos[:, None] - window)
        if prefix > 0:
            vis = vis | (slot_pos < prefix)
        valid = valid & vis
    scores = torch.where(valid[:, None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", w, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, prefix: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks of `chunk` (one block of the
    whole length when S % chunk != 0), as JAX's `chunked_attention`: the
    queries scaled by 1/sqrt(hd) before the product, a running max, sum
    and accumulator in f32 carried from block to block.  Plain PyTorch
    and differentiable: the long-sequence attention of training."""
    b, qlen, h, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    if s % chunk:
        chunk = s
    g = h // nkv
    qf = _gqa_fold(q, nkv).float() / (hd ** 0.5)
    q_pos = torch.arange(qlen, device=q.device)
    m_run = torch.full((b, nkv, g, qlen), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((b, nkv, g, qlen, hd), dtype=torch.float32,
                      device=q.device)
    for t0 in range(0, s, chunk):
        k_blk = k[:, t0:t0 + chunk].float()
        v_blk = v[:, t0:t0 + chunk].float()
        scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k_blk)
        msk = _mask(q_pos, t0 + torch.arange(chunk, device=q.device),
                    causal=causal, window=window, prefix=prefix)
        if msk is not None:
            scores = torch.where(msk[None, None, None], scores,
                                 torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m_run, scores.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   v_blk)
        m_run = m_new
    out = acc / l_run[..., None].clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, qlen, h, hd).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, prefix: int = 0,
              chunk_threshold: int = 2048) -> torch.Tensor:
    """JAX's `attention(impl="auto")`, the attention of its training
    forward: `full_attention` up to `chunk_threshold` keys,
    `chunked_attention` past it."""
    if k.shape[1] <= chunk_threshold:
        return full_attention(q, k, v, causal=causal, window=window,
                              prefix=prefix)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             prefix=prefix)
