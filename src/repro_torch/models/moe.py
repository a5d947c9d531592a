"""Mixture-of-Experts FFN with sort-based dispatch — the counterpart of
`repro.models.moe`, plain PyTorch on every device (JAX's is jnp on every
backend: its expert products are batched einsums outside any Pallas
kernel).

Each row's (token, expert) pairs are ranked within their expert by a
stable sort in s-major order (`s * k + j`), and the first `capacity(S)`
of each expert keep a slot of an (E, C, D) buffer; the rest are dropped
(they add nothing to their token's output).  The capacity comes from the
row length the layer sees, so one token's output depends on the tokens
before it in its row: a prefill sees its bucket, a decode step 1 (capacity
`top_k`: nothing drops), the speculative verify D + 1, a suffix admission
its suffix bucket.  With right padding a pad never takes a real token's
slot.  The dispatch is batched over rows (JAX's `vmap`) and makes a fixed
number of launches a layer, with nothing read back to the host.

The router product and softmax run in f32 on an f32 router; on the card
TF32 must stay off for it (`torch.backends.cuda.matmul.allow_tf32`),
since top-k routing is discontinuous in the logits.

`moe_ffn_ref` is the dense-masked oracle: every token through its top-k
experts by masking, no capacity.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import (clear_clashes, einsum_blocks,
                                              is_dtensor, local_map,
                                              mean_blocks, redistribute,
                                              rows_placements, select_blocks)
from repro_torch.models import layers as L

# the keep masks of every moe_ffn call inside `keep_masks()`, else None
_keep_log: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def keep_masks() -> Iterator[List[torch.Tensor]]:
    """Collect, in call order, the keep mask (B, S * k) bool of every
    `moe_ffn` call made inside the block (s-major pairs, on the device:
    nothing is read back).  For counting dropped pairs; one thread."""
    global _keep_log
    prev, _keep_log = _keep_log, []
    try:
        yield _keep_log
    finally:
        _keep_log = prev


def router_topk(x: torch.Tensor, router_w: torch.Tensor, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> gates (B, S, k) f32 (renormalised over the k),
    idx (B, S, k) int64 in descending probability, the load-balancing
    aux loss (a 0-d f32 tensor).  For DTensors the logits are each rank's
    rows with the experts whole (the product on the local blocks, a
    Partial one summed by `redistribute`) and the routing runs on the
    local blocks (`local_map`), its means by `mean_blocks`: DTensor's
    own softmax and top-k gradients would gather, and its means reduce,
    with the functional collectives."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe router: TF32 is on "
                           "(torch.backends.cuda.matmul.allow_tf32); the "
                           "router's f32 product must stay f32")
    if is_dtensor(x) and is_dtensor(router_w):
        logits = redistribute(
            einsum_blocks("bsd,de->bse", x.float(), router_w.float()),
            rows_placements(x))
    else:
        logits = x.float() @ router_w.float()
    probs, gates, idx = local_map(lambda lg: _route(lg, moe.top_k), logits,
                                  mapped=(True,))
    e = moe.num_experts
    density = mean_blocks(F.one_hot(idx[..., 0], e).float(), (0, 1))
    aux = e * (density * mean_blocks(probs, (0, 1))).sum()
    return gates, idx, aux


def _route(logits: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's probabilities, its top-k gates (renormalised) and
    their experts, from its f32 logits."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def capacity(seq: int, moe: MoEConfig) -> int:
    c = int(seq * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(c, moe.top_k)


def _dispatch(x: torch.Tensor, idx: torch.Tensor, e: int, c: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of every row at once.  x (B, S, D); idx
    (B, S, k).  Returns (expert_in (B, E, C, D), slot (B, S * k), keep
    (B, S * k)) with pairs in s-major order; a dropped pair's slot is
    its expert's last (masked by keep), slot `e * C + c` being expert
    e's c-th."""
    b, s, k = idx.shape
    n = s * k
    dev = x.device
    flat_e = idx.reshape(b, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    # rank within the expert's group = position - start of the group
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")
    rank = torch.arange(n, device=dev) - starts.gather(1, sorted_e)
    # back to s-major order
    slot = torch.empty_like(flat_e).scatter_(
        1, order, sorted_e * c + rank.clamp(max=c - 1))
    keep = torch.empty_like(flat_e, dtype=torch.bool).scatter_(
        1, order, rank < c)
    # kept pairs own distinct slots; dropped ones land in a dump row
    dest = torch.where(keep, slot, e * c)
    # each token's row k times (pair s * k + j is token s): an expand,
    # whose backward sums in a fixed order, where indexing's adds
    # atomically on the card
    pairs = x[:, :, None].expand(-1, -1, k, -1).reshape(b, n, x.shape[-1])
    expert_in = x.new_zeros((b, e * c + 1, x.shape[-1]))
    expert_in.scatter_(1, dest[..., None].expand(-1, -1, x.shape[-1]), pairs)
    return expert_in[:, :e * c].reshape(b, e, c, -1), slot, keep


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, moe: MoEConfig, act: str, sh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); wi (E, 2, D, F) swiglu / (E, D, F) gelu; wo (E, F, D).
    Returns (y (B, S, D), aux loss).  Every expert runs over all of its C
    slots (kept or empty), as in JAX.

    `sh` (`distributed.sharding`), as JAX's hook: x laid out with its
    sequence whole, the expert buffer as ("batch", "experts",
    "capacity", "embed"), the down-projection row-parallel onto
    "embed_rs".  The dispatch and the combine index within a row, so
    they run on each rank's rows (`local_map`), and every expert product
    runs on the local blocks (`_expert_products`)."""
    e, cap = moe.num_experts, capacity(x.shape[1], moe)
    if sh is not None:
        x = sh(x, ("batch", "seq_attn", "embed"))
    gates, idx, aux = router_topk(x, router_w, moe)
    ein, slot, keep = local_map(
        lambda x_, i_: _dispatch(x_, i_, e, cap), x, idx,
        mapped=(True, True))
    if _keep_log is not None:
        _keep_log.append(keep)
    eout = _expert_products(ein, wi, wo, act, sh)
    y = local_map(lambda o, sl, kp, g: _combine(o, sl, kp, g, moe.top_k),
                  eout, slot, keep, gates, mapped=(True,) * 4)
    return y, aux


_H_AXES = ("batch", "experts", "capacity", "mlp")


def _expert_products(ein: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                     act: str, sh=None) -> torch.Tensor:
    """ein (B, E, C, D) through every expert's FFN: (B, E, C, D).

    Under a sharder the up-projections run on the local blocks
    (`einsum_blocks`) and their results are laid out as _H_AXES: where
    ein's embed is sharded over a mesh dim that wi is replicated over
    (fsdp with the batch off "model"), each rank multiplies its slice of
    D by wi's rows for it and the partial sums are reduce-scattered onto
    F, so no rank multiplies more than its share.  Where ein and wi
    shard different indices over one mesh dim (the experts and F under
    fsdp_tp), ein is gathered there first (`clear_clashes`).  wi's halves
    are taken on the local blocks (`select_blocks`).  The
    down-projection is row-parallel (`layers.row_project`), whose
    fallback is the sharder's `einsum_blocks` and the "embed_rs"
    layout."""
    eq_up, eq_down = "becd,edf->becf", "becf,efd->becd"
    halves = [select_blocks(wi, 1, j) for j in range(2)] \
        if act == "swiglu" else [wi]
    if sh is None:
        h = [torch.einsum(eq_up, ein, w) for w in halves]
    else:
        ein = clear_clashes(eq_up, sh(ein, ("batch", "experts", "capacity",
                                            "embed")), halves[0])
        h = [sh(einsum_blocks(eq_up, ein, w), _H_AXES) for w in halves]
    h = L.swiglu(*h) if act == "swiglu" else L.gelu(h[0])
    if sh is None:
        return torch.einsum(eq_down, h, wo)
    return L.row_project(sh, h, wo, eq_down, _H_AXES,
                         ("experts", "mlp", "embed"),
                         ("batch", "experts", "capacity", "embed_rs"),
                         scatter_axis=3)


def _combine(eout: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, k: int) -> torch.Tensor:
    """Each pair's expert output (B, E, C, D) gathered back to its token
    (a dropped pair adds nothing), weighted by its gate, summed over the
    token's k pairs: (B, S, D)."""
    b, d = eout.shape[0], eout.shape[-1]
    eout = eout.reshape(b, -1, d)
    gathered = eout.gather(1, slot[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    weighted = gathered * gates.reshape(b, -1, 1).to(eout.dtype)
    return weighted.reshape(b, -1, k, d).sum(2)


def moe_ffn_ref(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor, moe: MoEConfig, act: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-masked oracle (equal to `moe_ffn` where no pair drops):
    every token through its top-k experts by masking."""
    gates, idx, aux = router_topk(x, router_w, moe)
    y = torch.zeros_like(x)
    for e_id in range(moe.num_experts):
        if act == "swiglu":
            h = L.swiglu(x @ wi[e_id, 0], x @ wi[e_id, 1])
        else:
            h = L.gelu(x @ wi[e_id])
        w = torch.where(idx == e_id, gates, 0.0).sum(-1, keepdim=True)
        y = y + (h @ wo[e_id]) * w.to(x.dtype)
    return y, aux
