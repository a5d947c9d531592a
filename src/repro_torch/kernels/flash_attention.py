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


def tile_edge_cases() -> list:
    """Shapes at the edges of the bf16 kernel's tiles, (name, B, H, K, Sq,
    Skv, hd, window, prefix, causal), for holding it to this plain version
    on the card: its CTA takes 128 query rows (192 without a causal mask
    at hd <= 64) and kv tiles of 128 rows (64 at hd 256).  At every head
    dim: Sq = Skv in {8, 100, 127, 129, 300} with G cycling through {1, 2,
    3, 5, 6}; a causal Sq < Skv (both count from 0); a non-causal 129 x
    300; windows of 127, 128 and 129; a window with a prefix of 130 that
    crosses a tile.  Then grids of 6 work items (below the H100's 132 SMs)
    and of 384 (above two waves).  A non-causal case carries no window:
    the window applies only under the causal mask."""
    cases = []
    gs = (1, 2, 3, 5, 6)
    for i, hd in enumerate((16, 32, 64, 128, 256)):
        for j, s in enumerate((8, 100, 127, 129, 300)):
            g = gs[(i + j) % len(gs)]
            cases.append((f"hd{hd}_s{s}_g{g}", 1, 2 * g, 2, s, s, hd, 0, 0,
                          True))
        cases += [
            (f"hd{hd}_sq100_skv300", 2, 4, 2, 100, 300, hd, 0, 0, True),
            (f"hd{hd}_noncausal_129x300", 1, 3, 1, 129, 300, hd, 0, 0,
             False)]
        cases += [(f"hd{hd}_window{w}", 1, 4, 2, 300, 300, hd, w, 0, True)
                  for w in (127, 128, 129)]
        cases.append((f"hd{hd}_window129_prefix130", 1, 4, 1, 300, 300, hd,
                      129, 130, True))
    return cases + [("grid6", 1, 2, 1, 300, 300, 128, 0, 0, True),
                    ("grid384", 2, 48, 8, 512, 512, 128, 0, 0, True)]
