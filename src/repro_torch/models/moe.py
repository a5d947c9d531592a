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
    aux loss (a 0-d f32 tensor)."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe router: TF32 is on "
                           "(torch.backends.cuda.matmul.allow_tf32); the "
                           "router's f32 product must stay f32")
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = moe.num_experts
    density = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (density * probs.mean(dim=(0, 1))).sum()
    return gates, idx, aux


def capacity(seq: int, moe: MoEConfig) -> int:
    c = int(seq * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(c, moe.top_k)


def _dispatch(x: torch.Tensor, idx: torch.Tensor, e: int, c: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of every row at once.  x (B, S, D); idx
    (B, S, k).  Returns (expert_in (B, E * C, D), slot (B, S * k), keep
    (B, S * k)) with pairs in s-major order; a dropped pair's slot is
    its expert's last (masked by keep)."""
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
    return expert_in[:, :e * c], slot, keep


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, moe: MoEConfig, act: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); wi (E, 2, D, F) swiglu / (E, D, F) gelu; wo (E, F, D).
    Returns (y (B, S, D), aux loss).  Every expert runs over all of its C
    slots (kept or empty), as in JAX."""
    b, s, d = x.shape
    e, cap = moe.num_experts, capacity(s, moe)
    gates, idx, aux = router_topk(x, router_w, moe)
    expert_in, slot, keep = _dispatch(x, idx, e, cap)
    if _keep_log is not None:
        _keep_log.append(keep)
    ein = expert_in.reshape(b, e, cap, d)
    if act == "swiglu":
        h = L.swiglu(torch.einsum("becd,edf->becf", ein, wi[:, 0]),
                     torch.einsum("becd,edf->becf", ein, wi[:, 1]))
    else:
        h = L.gelu(torch.einsum("becd,edf->becf", ein, wi))
    eout = torch.einsum("becf,efd->becd", h, wo).reshape(b, e * cap, d)
    gathered = eout.gather(1, slot[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0)
    weighted = gathered * gates.reshape(b, -1, 1).to(x.dtype)
    return weighted.reshape(b, s, moe.top_k, d).sum(2), aux


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
