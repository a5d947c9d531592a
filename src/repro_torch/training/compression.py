"""Error-feedback int8 gradient compression, the counterpart of
`repro.training.compression`: per-tensor absmax int8 with an error
accumulator, e_{t+1} = (g_t + e_t) - dequant(quant(g_t + e_t)), whose
error is re-injected next step.  `torch.round` rounds half to even, as
`jnp.round` does.

On one device nothing goes over a wire: the trainer applies the
dequantized gradients (`compress_tree`), which is what a data-parallel
reduction of the int8 payloads would deliver.  `wire_bytes` counts what
such a ring all-reduce moves per device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.training.tree import Tree, leaves, map_tree, unflatten


def init_error(params: Tree) -> Tree:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g: torch.Tensor, e: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor: returns (q int8, scale f32 0-d, new error f32)."""
    x = g.float() + e
    scale = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - decompress(q, scale)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Tree, err: Tree
                  ) -> Tuple[Dict[str, Tree], Tree, Tree]:
    """Returns ({"q", "scale"} trees, the dequantized grads, the new
    error tree)."""
    out = [compress(g, e) for g, e in zip(leaves(grads), leaves(err),
                                          strict=True)]
    q, scale, new_err = (unflatten(grads, (o[j] for o in out))
                         for j in range(3))
    return {"q": q, "scale": scale}, map_tree(decompress, q, scale), new_err


def wire_bytes(tree: Tree, compressed: bool) -> int:
    """Bytes a data-parallel ring all-reduce moves per device for this
    gradient tree: int8 payloads and one f32 scale a tensor, or f32."""
    total = 0
    for leaf in leaves(tree):
        total += leaf.numel() * (1 if compressed else 4) \
            + (4 if compressed else 0)
    return 2 * total          # ring all-reduce: 2x payload per device
