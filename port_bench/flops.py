"""The yardstick's own counts of operations and bytes, from a
configuration's `model` block and the lengths the benchmark knows, and
the card's published peaks.

A token's useful work is 2 x the matmul parameters it uses (a MoE layer:
the router and only its top-k experts) plus 4 x layers x heads x
head_dim x its visible context (QK^T and PV); the head counts only where
logits are needed (the last prompt token of a prefill, every decoded
token).  Padded rows and positions, cached prefix tokens and empty
expert slots count nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def layer_matmul_params(model: Dict) -> int:
    """Matmul parameters one token uses in one layer."""
    d, h, kv, hd = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    attn = d * (h + 2 * kv) * hd + h * hd * d
    moe = model.get("moe")
    if moe:
        ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d * model["d_ff"]
    else:
        ffn = 3 * d * model["d_ff"]
    return attn + ffn


def head_params(model: Dict) -> int:
    return model["d_model"] * model["vocab"]


def attn_flops(model: Dict, visible: int) -> float:
    """One token's attention work over `visible` positions."""
    return 4.0 * model["n_layers"] * model["n_heads"] * model["head_dim"] \
        * visible


def prefill_flops(model: Dict, prompt: int, cached: int = 0) -> float:
    """A prompt of `prompt` tokens whose first `cached` came from the
    prefix cache: each computed token at position p sees p + 1."""
    n = prompt - cached
    if n <= 0:
        return 0.0
    visible = (prompt * (prompt + 1) - cached * (cached + 1)) // 2
    return (2.0 * model["n_layers"] * layer_matmul_params(model) * n
            + 2.0 * head_params(model) + attn_flops(model, visible))


def decode_flops(model: Dict, visible: int) -> float:
    """One decoded token whose input sees `visible` positions."""
    return (2.0 * (model["n_layers"] * layer_matmul_params(model)
                   + head_params(model)) + attn_flops(model, visible))


def flash_bound_s(b: int, h: int, nkv: int, sq: int, skv: int, hd: int,
                  causal: bool, elt: int) -> float:
    """The least time of one flash launch: operations over the pairs the
    mask leaves visible (causal: each query i sees keys 0..i), Q, K, V
    read once and O written once."""
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    ops = 4.0 * b * h * hd * pairs
    nbytes = elt * hd * b * (2 * h * sq + 2 * nkv * skv)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def paged_decode_bound_s(model: Dict, rows: int, visible: Iterable[int],
                         page_size: int, elt: int) -> float:
    """The least time of one paged decode launch over `rows` slots, of
    which those listed in `visible` read that many K/V positions: the
    visible K and V rows, q and out of every slot, and each row's page
    ids."""
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    vis = list(visible)
    total = sum(vis)
    pages = sum(-(-v // page_size) for v in vis)
    nbytes = elt * (2 * kv * hd * total + 2 * rows * h * hd) + 4 * pages
    ops = 4.0 * h * hd * total
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def decode_block_bound_s(model: Dict, rows: int,
                         row_starts: Iterable[Tuple[int, int]], steps: int,
                         page_size: int, elt: int) -> float:
    """A fused decode block of `steps` steps, each launching the paged
    kernel once a layer; `row_starts` holds, for each slot that emitted,
    (visible positions at the block's first step, tokens emitted)."""
    rs = list(row_starts)
    total = 0.0
    for j in range(steps):
        vis = [v + j for v, n in rs if n > j]
        total += paged_decode_bound_s(model, rows, vis, page_size, elt)
    return model["n_layers"] * total
