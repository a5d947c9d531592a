"""Paged decode attention: one new query token per slot attends to its KV
pages through the slot's page table — no gathered logical view.

The kernel is `csrc/paged_decode_attention.cu`, launched through
`kernels.ops.paged_decode_attention`.  This module holds its plain
PyTorch version: the same page-at-a-time online softmax (m, l, acc) in
f32 as `repro.kernels.paged_attention.paged_decode_attention_ref`.  It is
the CPU path of the wrapper and the oracle the kernel is held against on
the card.

The kernel splits the page table's columns into chunks of pages, one
CTA each, and merges the chunks' f32 partials in chunk order.
`paged_lse_partials_ref` and `split_paged_ref` spell that composition
out in plain PyTorch for the tests (the paged counterparts of
`decode_attention.lse_partials_ref` and `split_decode_ref`, merged by the
same `merge_lse_ref`); nothing on the card path calls them.

`paged_suffix_attention_ref` is the speculative verify's multi-query
paged attention: plain PyTorch on every device, as its JAX counterpart is
jnp on every backend (it is not a Pallas kernel).

Layouts (the JAX package's): q (B, K, G, hd) grouped queries; pools
(P, ps, K, hd) physical pages of one layer; page_table (B, pps) int32
with sentinel == P for unmapped entries; pos (B,) int32, the index of the
current token.  Returns (B, K, G, hd).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import merge_lse_ref

NEG_INF = -1e30


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               pos: torch.Tensor, *, window: int = 0,
                               prefix: int = 0) -> torch.Tensor:
    b, nkv, g, hd = q.shape
    n_pages, ps = k_pool.shape[0], k_pool.shape[1]
    pps = page_table.shape[1]
    qf = q.float() * hd ** -0.5
    pos = pos.long()
    offs = torch.arange(ps, device=q.device)
    m = torch.full((b, nkv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, nkv, g, 1), device=q.device)
    acc = torch.zeros((b, nkv, g, hd), device=q.device)
    for j in range(pps):
        ids = page_table[:, j].long()                        # (B,)
        mapped = ids < n_pages
        safe = torch.where(mapped, ids, torch.zeros_like(ids))
        # sentinel entries read as zeros (JAX's mode="fill")
        fill = mapped[:, None, None, None]
        kp = torch.where(fill, k_pool[safe].float(), 0.0)    # (B,ps,K,hd)
        vp = torch.where(fill, v_pool[safe].float(), 0.0)
        s = torch.einsum("bkgd,bskd->bkgs", qf, kp)          # (B,K,G,ps)
        kv_pos = j * ps + offs
        mask = (kv_pos[None, :] <= pos[:, None]) & mapped[:, None]
        if window > 0:
            inwin = kv_pos[None, :] > (pos - window)[:, None]
            if prefix > 0:
                inwin = inwin | (kv_pos < prefix)[None, :]
            mask = mask & inwin
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgs,bskd->bkgd", p, vp)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_lse_partials_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cols: torch.Tensor,
                           pos: torch.Tensor, col0: int, *, window: int = 0,
                           prefix: int = 0) -> tuple:
    """Attention of q over the pages of `cols` (B, n), the table's
    columns col0 onwards, with explicit f32 partials: m, l (B, K, G) and
    the unnormalised sum num (B, K, G, hd).  Sentinel columns read as
    zeros and are masked, as are rows past pos and, with a window, rows
    outside it and the prefix."""
    b, nkv, g, hd = q.shape
    n_pages, ps = k_pool.shape[0], k_pool.shape[1]
    n = cols.shape[1]
    ids = cols.long()
    mapped = ids < n_pages                                   # (B, n)
    safe = torch.where(mapped, ids, torch.zeros_like(ids))
    fill = mapped[:, :, None, None, None]
    kp = torch.where(fill, k_pool[safe].float(), 0.0).reshape(
        b, n * ps, nkv, hd)
    vp = torch.where(fill, v_pool[safe].float(), 0.0).reshape(
        b, n * ps, nkv, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", q.float() * hd ** -0.5, kp)
    kv_pos = col0 * ps + torch.arange(n * ps, device=q.device)
    valid = (kv_pos[None, :] <= pos.long()[:, None]) \
        & mapped.repeat_interleave(ps, dim=1)
    if window > 0:
        vis = kv_pos[None, :] > (pos.long() - window)[:, None]
        if prefix > 0:
            vis = vis | (kv_pos < prefix)[None, :]
        valid = valid & vis
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, vp)


def split_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor, *, ppc: int, window: int = 0,
                    prefix: int = 0) -> torch.Tensor:
    """The split kernel's arithmetic: the partials of each chunk of `ppc`
    table columns, merged in chunk order (merge_lse_ref)."""
    parts = [paged_lse_partials_ref(q, k_pool, v_pool,
                                    page_table[:, c0:c0 + ppc], pos, c0,
                                    window=window, prefix=prefix)
             for c0 in range(0, page_table.shape[1], ppc)]
    return merge_lse_ref(parts, q.dtype)


def paged_suffix_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor,
                               q_pos: torch.Tensor) -> torch.Tensor:
    """Multi-query paged attention: Q tokens per slot at absolute
    positions `q_pos` (B, Q), causal by position, through the page table.
    q (B, Q, H, hd); pools (P, ps, K, hd); page_table (B, pps) with
    sentinel == P.  Returns (B, Q, H, hd).  The counterpart of
    `repro.kernels.paged_attention.paged_suffix_attention_ref`: all of a
    row's pages gathered at once instead of page by page, sentinel pages
    read as zeros and masked (`ids < P`), as are rows past each query's
    position (`kv_pos <= q_pos`); one softmax over them all."""
    b, qn, h, hd = q.shape
    n_pages, ps, nkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    pps = page_table.shape[1]
    ids = page_table.long()
    mapped = ids < n_pages                                   # (B, pps)
    safe = torch.where(mapped, ids, torch.zeros_like(ids))
    fill = mapped[:, :, None, None, None]
    kp = torch.where(fill, k_pool[safe].float(), 0.0).reshape(
        b, pps * ps, nkv, hd)
    vp = torch.where(fill, v_pool[safe].float(), 0.0).reshape(
        b, pps * ps, nkv, hd)
    qf = (q.float() * hd ** -0.5).reshape(b, qn, nkv, h // nkv, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, kp)
    kv_pos = torch.arange(pps * ps, device=q.device)
    mask = (kv_pos[None, None, :] <= q_pos.long()[:, :, None]) \
        & mapped.repeat_interleave(ps, dim=1)[:, None, :]    # (B, Q, S)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    # softmax, not exp(s - max) / sum: torch's CPU exp has been seen ~1e-4
    # off on its first call in a loaded process (ROADMAP C9)
    out = torch.einsum("bqkgs,bskd->bqkgd", torch.softmax(s, dim=-1), vp)
    return out.reshape(b, qn, h, hd).to(q.dtype)
