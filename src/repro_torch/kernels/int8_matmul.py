"""Dequantizing int8 matmul: x @ (w_q * scale), the weights int8 at rest.

The kernel is `csrc/int8_matmul.cu`, launched through
`kernels.ops.int8_matmul`.  This module holds its plain PyTorch version,
the counterpart of `repro.kernels.ref.int8_matmul_ref`: dequantize in
f32, multiply in f32, cast to `x.dtype`.  It is the CPU path of the
wrapper and the oracle the kernel is held against on the card.

Layouts: x (M, K) float; w_q (K, N) int8, any strides (the tied LM head
passes `embed_q.t()`, a transposed view); scale f32, either (1, N), one
per output channel as in the JAX kernel, or (K, 1), one per input
channel, which is how the tied head's per-d embedding scale reaches it.
"""
from __future__ import annotations

import torch


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    w = w_q.float() * scale.float()
    return (x.float() @ w).to(x.dtype)
