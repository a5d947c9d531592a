"""Paged decode attention: one new query token per slot attends to its KV
pages through the slot's page table — no gathered logical view.

The kernel is `csrc/paged_decode_attention.cu`, launched through
`kernels.ops.paged_decode_attention`.  This module holds its plain
PyTorch version: the same page-at-a-time online softmax (m, l, acc) in
f32 as `repro.kernels.paged_attention.paged_decode_attention_ref`.  It is
the CPU path of the wrapper and the oracle the kernel is held against on
the card.

Layouts (the JAX package's): q (B, K, G, hd) grouped queries; pools
(P, ps, K, hd) physical pages of one layer; page_table (B, pps) int32
with sentinel == P for unmapped entries; pos (B,) int32, the index of the
current token.  Returns (B, K, G, hd).
"""
from __future__ import annotations

import torch

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
