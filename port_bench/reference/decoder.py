"""Plain reference of the causal decoder that `configs/olmo-1b.json`
describes, with the MoE layer of `tests/granite-moe-3b-a800m.json` (a
configuration no cell runs yet; the tests hold it to the port): float32
PyTorch, one request at a time over its whole sequence, no cache, no
batching, no kernels.  It imports nothing of the program.

Per layer, from the embedding rows h (the tied embedding is also the
head):

    x = norm(h)             OLMo: LayerNorm without affine, eps 1e-5;
                            rms: x / rms(x) * (1 + s), eps 1e-6
    q, k, v = x Wq, x Wk, x Wv, RoPE (half-split, theta) on q and k
    a = softmax(q k^T / sqrt(hd), causal) v, query head i reading kv head
        i // (H / K)
    h = h + a Wo
    x = norm(h)
    h = h + FFN(x)          SwiGLU: (silu(x Wi0) * x Wi1) Wo
                            MoE: router softmax over E experts in f32, the
                            top k renormalised, each kept pair through its
                            expert's SwiGLU, weighted by its gate
    logits = norm(h) E^T

The MoE layer keeps the program's capacity rule, which the published
model does not have (it routes every pair): the prompt's pairs, taken
token by token and within a token by rank, fill each expert's
`capacity = max(int(bucket * k / E * factor), k)` slots in order and the
rest are dropped; `bucket` is the power-of-two prefill bucket the
prompt was admitted at (`bucket_of`).  A decoded token is routed alone
(capacity k: nothing drops).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def bucket_of(n: int, engine: Dict) -> int:
    """The engine's prefill bucket for an n-token prompt: the smallest
    power of two >= n, at least `prefill_bucket_min`, at most max_len."""
    b = int(engine["prefill_bucket_min"])
    while b < n:
        b <<= 1
    return min(b, int(engine["max_len"]))


def capacity(seq: int, moe: Dict) -> int:
    k, e = moe["top_k"], moe["num_experts"]
    return max(int(seq * k / e * moe["capacity_factor"]), k)


def _norm(x: torch.Tensor, scale, kind: str) -> torch.Tensor:
    if kind == "nonparam_ln":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5)
    y = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    return y * (1.0 + scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x: torch.Tensor, lp: Dict, i: int, model: Dict
               ) -> torch.Tensor:
    s = x.shape[0]
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    d = model["d_model"]
    wq = lp["wq"][i].float().reshape(d, h * hd)
    wk = lp["wk"][i].float().reshape(d, kv * hd)
    wv = lp["wv"][i].float().reshape(d, kv * hd)
    q = _rope((x @ wq).reshape(s, h, hd), model["rope_theta"])
    k = _rope((x @ wk).reshape(s, kv, hd), model["rope_theta"])
    v = (x @ wv).reshape(s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / hd ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    a = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return a.reshape(s, h * hd) @ lp["wo"][i].float().reshape(h * hd, d)


def _swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
            ) -> torch.Tensor:
    return (F.silu(x @ wi[0].float()) * (x @ wi[1].float())) @ wo.float()


def _moe(x: torch.Tensor, mp: Dict, i: int, moe: Dict, prompt_len: int,
         bucket: int) -> torch.Tensor:
    e, k = moe["num_experts"], moe["top_k"]
    probs = torch.softmax(x @ mp["router"][i].float(), dim=-1)
    top, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = top / top.sum(-1, keepdim=True)
    # the prompt's pairs fill each expert's slots in (token, rank) order
    keep = torch.ones_like(idx, dtype=torch.bool)
    pairs = idx[:prompt_len].reshape(-1)
    onehot = F.one_hot(pairs, e)
    rank = (onehot.cumsum(0) - 1).gather(1, pairs[:, None])[:, 0]
    keep[:prompt_len] = (rank < capacity(bucket, moe)).reshape(prompt_len, k)
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(x[tok], mp["wi"][i, ex], mp["wo"][i, ex])
        y.index_add_(0, tok, out * gates[tok, slot][:, None])
    return y


def served_logits(params: Dict, model: Dict, engine: Dict,
                  tokens: List[int], prompt_len: int) -> torch.Tensor:
    """Logits (n, V) float32 at positions prompt_len - 1 .. len(tokens) - 1
    of `tokens` (the prompt, then the served tokens but the last), the
    positions whose argmax the program served."""
    dev = params["embed"].device
    ids = torch.tensor(tokens, dtype=torch.long, device=dev)
    h = params["embed"].float()[ids]
    lp, moe = params["layers"], model.get("moe")
    bucket = bucket_of(prompt_len, engine)
    for i in range(model["n_layers"]):
        x = _norm(h, lp["ln1"][i] if "ln1" in lp else None, model["norm"])
        h = h + _attention(x, lp["attn"], i, model)
        x = _norm(h, lp["ln2"][i] if "ln2" in lp else None, model["norm"])
        if moe:
            h = h + _moe(x, lp["moe"], i, moe, prompt_len, bucket)
        else:
            h = h + _swiglu(x, lp["mlp"]["wi"][i], lp["mlp"]["wo"][i])
    last = _norm(h[prompt_len - 1:], params.get("final_norm"), model["norm"])
    return last @ params["embed"].float().t()
