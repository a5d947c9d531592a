"""Flash attention for prefill: GQA (head h reads kv head h // G), causal
or not, optional sliding window and always-visible prefix.

The kernel is `csrc/flash_attention.cu`, launched through
`kernels.ops.flash_attention`.  This module holds its plain PyTorch
version, the counterpart of `repro.kernels.ref.flash_attention_ref`:
full attention over the `(B, H, S, hd)` layout.  It is the CPU path of
the wrapper and the oracle the kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import full_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        prefix: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd) -> (B, H, Sq, hd)."""
    out = full_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         prefix=prefix)
    return out.transpose(1, 2)
