"""Decode attention over a contiguous cache: one new query token per row
attends to that row's first `pos + 1` cache positions.

The kernel is `csrc/decode_attention.cu`, launched through
`kernels.ops.decode_attention`.  This module holds its plain PyTorch
version, the counterpart of `repro.kernels.ref.decode_attention_ref`:
the reference decode attention of `models.attention` in the kernel's
layouts.  It is the CPU path of the wrapper and the oracle the kernel is
held against on the card.

The kernel splits each row's positions into chunks, one CTA each, and
merges the chunks' partials by a log-sum-exp rule.  `lse_partials_ref`
(the port's copy of the JAX package's `_lse_partials`) and
`split_decode_ref` (the chunks' partials merged in split order by
`merge_lse_ref`, as JAX's sequence-sharded combine merges its shards)
spell that composition out in plain PyTorch for the tests; nothing on
the card path calls them.

Layouts (the JAX package's): q (B, K, G, hd) grouped queries; caches
(B, K, S, hd); pos (B,) int32, the index of the current token.  Returns
(B, K, G, hd).  The caches may be any strided view whose last dim is
contiguous, such as `cache.permute(0, 2, 1, 3)` of a (B, S, K, hd)
cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import decode_attention


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor, *,
                         window: int = 0, prefix: int = 0) -> torch.Tensor:
    b, nkv, g, hd = q.shape
    # kv-major fold (K, G) -> H, as models.attention._gqa_fold expects
    out = decode_attention(q.reshape(b, 1, nkv * g, hd),
                           k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                           pos, window=window, prefix=prefix)
    return out[:, 0].reshape(b, nkv, g, hd)


def lse_partials_ref(q: torch.Tensor, k_chunk: torch.Tensor,
                     v_chunk: torch.Tensor, pos: torch.Tensor,
                     kv_offset: int, *, window: int = 0,
                     prefix: int = 0) -> tuple:
    """Attention of q over one chunk of cache rows, kv_offset onwards,
    with explicit f32 partials: m, l (B, K, G) and the unnormalised sum
    num (B, K, G, hd).  A copy of `repro.kernels.ops._lse_partials`."""
    hd = q.shape[-1]
    s = k_chunk.shape[2]
    qf = q.float() * hd ** -0.5
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k_chunk.float())
    slot = kv_offset + torch.arange(s, device=q.device)
    pos = pos.long()
    valid = slot[None, :] <= pos[:, None]
    if window > 0:
        vis = slot[None, :] > (pos[:, None] - window)
        if prefix > 0:
            vis = vis | (slot < prefix)[None, :]
        valid = valid & vis
    # a Python scalar: a tensor made of it on the card would be a blocking
    # upload every call (ROADMAP C19)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgs,bksd->bkgd", p, v_chunk.float())


def merge_lse_ref(parts: list, dtype: torch.dtype) -> torch.Tensor:
    """Merge f32 partials (m, l, num), in list order, by the rule of JAX's
    sequence-sharded combine: m_g = max m, corr = exp(m - m_g),
    out = sum(num corr) / max(sum(l corr), 1e-30), cast to `dtype`."""
    m_g = torch.stack([m for m, _, _ in parts]).amax(0)
    l_g = torch.zeros_like(m_g)
    num_g = torch.zeros_like(parts[0][2])
    for m, l, num in parts:
        corr = torch.exp(m - m_g)
        l_g = l_g + l * corr
        num_g = num_g + num * corr[..., None]
    return (num_g / l_g.clamp_min(1e-30)[..., None]).to(dtype)


def split_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     chunk: int, window: int = 0,
                     prefix: int = 0) -> torch.Tensor:
    """The split kernel's arithmetic: the partials of each chunk of
    `chunk` rows, merged in chunk order (merge_lse_ref)."""
    s = k_cache.shape[2]
    parts = [lse_partials_ref(q, k_cache[:, :, c0:c0 + chunk],
                              v_cache[:, :, c0:c0 + chunk], pos, c0,
                              window=window, prefix=prefix)
             for c0 in range(0, s, chunk)]
    return merge_lse_ref(parts, q.dtype)
