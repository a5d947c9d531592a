"""Decode attention over a contiguous cache: one new query token per row
attends to that row's first `pos + 1` cache positions.

The kernel is `csrc/decode_attention.cu`, launched through
`kernels.ops.decode_attention`.  This module holds its plain PyTorch
version, the counterpart of `repro.kernels.ref.decode_attention_ref`:
the reference decode attention of `models.attention` in the kernel's
layouts.  It is the CPU path of the wrapper and the oracle the kernel is
held against on the card.

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
