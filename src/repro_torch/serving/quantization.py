"""Weight quantization — int8 (per-channel absmax) and packed int4, the
counterpart of `repro.serving.quantization`, with its exact rounding:
scale = max(absmax, 1e-8) / 127 (or / 7), q = clip(round_half_even(w /
scale)), in f32.

A quantized leaf is a dict `{"__q__": q, "scale": scale, "dtype": the
leaf's torch dtype, "bits": 8 or 4}`.  As in JAX, the absmax is taken
over every axis but the last, so a stacked `(L, ...)` leaf has one scale
per last-axis channel shared by all its layers, and `quantize_tree`
quantizes every >= 2-D float leaf, stacked norm scales `(L, d)` included
(ROADMAP C5).  int4 packs two values per int8 along the leading axis
when it is even (else it stays unpacked int8, as in JAX).

The engine serves int8 through the int8 matmul kernel: `int8_operands`
prepares, once, the per-column scales the flattened projections need.
The MoE experts stay int8 at rest and the model dequantizes them a layer
at a time where it runs them.  int4 has no kernel: the whole tree is
dequantized per dispatch through `dequant_tree`, as the JAX engine does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]
_QKEY = "__q__"


def quantize_array(w: torch.Tensor, bits: int = 8) -> Dict[str, Any]:
    """Per-last-dim-channel absmax quantization.  Returns a dict leaf."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}")
    qmax = 127.0 if bits == 8 else 7.0
    scale = amax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4 and q.shape[0] % 2 == 0:
        lo = q[0::2] & 0x0F
        hi = (q[1::2] & 0x0F) << 4
        return {_QKEY: lo | hi, "scale": scale, "dtype": w.dtype, "bits": 4}
    return {_QKEY: q, "scale": scale, "dtype": w.dtype, "bits": 8}


def dequantize_array(leaf: Dict[str, Any]) -> torch.Tensor:
    q, scale = leaf[_QKEY], leaf["scale"]
    if leaf["bits"] == 4:
        lo = (q << 4) >> 4              # sign-extend the low nibble
        hi = q >> 4
        q = torch.stack([lo, hi], dim=1).reshape(
            (q.shape[0] * 2,) + tuple(q.shape[1:]))
    return (q.float() * scale).to(leaf["dtype"])


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and _QKEY in x


def _map(fn, params: Params):
    if is_quantized_leaf(params) or not isinstance(params, dict):
        return fn(params)
    return {k: _map(fn, v) for k, v in params.items()}


def quantize_tree(params: Params, bits: int = 8) -> Params:
    """Quantize every >= 2-D float leaf (1-D leaves stay as they are)."""
    return _map(lambda x: quantize_array(x, bits)
                if x.dim() >= 2 and x.is_floating_point() else x, params)


def dequant_tree(params: Params) -> Params:
    return _map(lambda x: dequantize_array(x) if is_quantized_leaf(x)
                else x, params)


def tree_bytes(params: Params) -> int:
    """At-rest bytes of a (possibly quantized) tree: every tensor's."""
    total = 0

    def add(x):
        nonlocal total
        for t in (x.values() if is_quantized_leaf(x) else (x,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
        return x
    _map(add, params)
    return total


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(q) in f32: x (..., K); q (K, N) int8; scale (1, N)."""
    return torch.einsum("...k,kn->...n", x.float(), q.float() * scale)


# --------------------------------------------------------------------- #
# the int8 kernel path

# matmul weights, by path: the decoder's (Hymba's SSM input projection and
# its output projection too, an encoder-decoder's cross-attention and its
# encoder stack) and xLSTM's blocks'; other quantized leaves (stacked norm
# scales, the MoE router, Hymba's meta tokens and its small SSM leaves,
# xLSTM's f32 gate weights and biases) are dequantized once by
# `int8_operands`
_LINEARS = {(stack, sub, w) for stack in ("layers", "enc_layers")
            for sub, ws in (("attn", ("wq", "wk", "wv", "wo")),
                            ("mlp", ("wi", "wo"))) for w in ws} \
    | {("layers", "xattn", w) for w in ("wq", "wk", "wv", "wo")} \
    | {("layers", "ssm", "w_in"), ("layers", "wo_comb"), ("embed",),
       ("lm_head",)} \
    | {("pairs", "mlstm", w) for w in ("w_up", "wq", "wk", "wv", "w_down")} \
    | {("pairs", "slstm", "ffn_wi"), ("pairs", "slstm", "ffn_wo")}
# linears whose (L, d, G, n) leaf the model multiplies as (d, G * n): the
# per-n scale repeats over G in the kernel's per-column scale
_GROUPED = ("wq", "wk", "wv", "w_in", "w_up")
# the MoE experts: batched products off the kernel, kept int8 at rest
_EXPERTS = {("layers", "moe", "wi"), ("layers", "moe", "wo")}


def _col_scale(path, leaf) -> torch.Tensor:
    """The f32 (1, N) per-column scale of the 2-D matrix the model hands
    the kernel for this leaf (the embedding's stays per d: (1, d))."""
    scale = leaf["scale"]
    q = leaf[_QKEY]
    if path[-1] in _GROUPED:
        # (L, d, H, hd) -> (d, H*hd): the per-hd scale repeats over heads
        # (w_in's and w_up's per-inner scale over their two halves, u and
        # z)
        return scale.reshape(1, 1, -1).expand(1, q.shape[2], -1) \
            .reshape(1, -1).contiguous()
    return scale.reshape(1, -1).contiguous()


def int8_operands(params: Params) -> Params:
    """The tree the model runs under quantize="int8", built once: each
    int8 matmul leaf keeps its `q` (shared, not copied) and gains `col`,
    its scale laid out per column of the matrix the kernel multiplies
    (wq/wk/wv's per-hd scale repeated over heads); the MoE experts' int8
    leaves stay as they are (the model dequantizes one layer at a time);
    any other quantized leaf is dequantized here once, to the value JAX's
    per-step `dequant_tree` gives it."""
    def walk(node, path):
        if is_quantized_leaf(node):
            if path in _LINEARS and node["bits"] == 8:
                return {**node, "col": _col_scale(path, node)}
            if path in _EXPERTS and node["bits"] == 8:
                return node
            return dequantize_array(node)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node
    return walk(params, ())


def operand_bytes(params: Params) -> int:
    """Device bytes `int8_operands(params)` allocates beside the int8
    tree `params` itself: the leaves it dequantizes and the per-column
    scales it expands (wq, wk, wv, w_in, w_up); the other operands share the
    tree's storage (a grouped scale over one group is a view of it).  A
    function of shapes and dtypes only, so it also
    counts a tree built on the meta device (placement's count)."""
    total = 0

    def walk(node, path):
        nonlocal total
        if is_quantized_leaf(node):
            if path in _LINEARS and node["bits"] == 8:
                q = node[_QKEY]
                if path[-1] in _GROUPED and q.shape[2] > 1:
                    total += q.shape[2] * q.shape[3] * 4   # else a view
            elif not (path in _EXPERTS and node["bits"] == 8):
                total += node[_QKEY].numel() * torch.empty(
                    (), dtype=node["dtype"]).element_size()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
    walk(params, ())
    return total
