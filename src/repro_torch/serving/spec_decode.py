"""On-device n-gram speculative decoding: the proposer tables and the
accept logic, as tensor ops on the slots' device — the counterpart of
`repro.serving.spec_decode`.

The proposer is a per-slot bigram suffix-hash table: an `(n_slots,
table_size)` int32 tensor mapping `hash(prev, last)` to the token that
followed that pair most recently in the slot's own emitted stream.
`propose` chains D lookups from the slot's last two tokens into a draft
(a missing entry yields -1, which never matches a real greedy token);
`record` learns one transition per emitted token.  Greedy verify accepts
the longest prefix of drafts equal to the verifier's own argmax, so the
emitted stream is identical to plain greedy decoding.

The hash multiplies as uint32 with wraparound in JAX.  Here it runs in
int64 and keeps the low 32 bits (`& 0xFFFFFFFF`), with the product split
so no intermediate leaves int64: the buckets equal JAX's bit for bit.
"""
from __future__ import annotations

import torch

_MUL_A = 2654435761      # Knuth multiplicative hash constants
_MUL_B = 40503
_SALT = 2654435769
_U32 = 0xFFFFFFFF


def init_tables(n_slots: int, table_size: int,
                device: torch.device = torch.device("cpu")):
    """Fresh proposer state: (table (n_slots, T) int32 = -1, prev
    (n_slots,) int32 = -1).  T must be a power of two."""
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"spec table size {table_size}: a power of two")
    return (torch.full((n_slots, table_size), -1, dtype=torch.int32,
                       device=device),
            torch.full((n_slots,), -1, dtype=torch.int32, device=device))


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and c < 2**32, in int64 with
    every partial product below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def ngram_hash(a: torch.Tensor, b: torch.Tensor,
               table_size: int) -> torch.Tensor:
    """Bigram bucket hash(a, b) & (T - 1) as int64.  a, b: int tensors
    (negative ids wrap to uint32, as JAX's astype does)."""
    ua = _mul_u32(a.long() & _U32, _MUL_A)
    ub = (_mul_u32(b.long() & _U32, _MUL_B) + _SALT) & _U32
    return (ua ^ ub) & (table_size - 1)


def propose(table: torch.Tensor, prev: torch.Tensor, last: torch.Tensor,
            n_draft: int) -> torch.Tensor:
    """Chain `n_draft` bigram lookups into drafts (B, n_draft) int32, -1
    for "no proposal".  table (B, T); prev, last (B,): the two most
    recent tokens (-1 when unknown)."""
    b, t = table.shape
    rows = torch.arange(b, device=table.device)
    drafts = []
    a, c = prev, last
    for _ in range(n_draft):
        nxt = table[rows, ngram_hash(a, c, t)]
        nxt = torch.where((a < 0) | (c < 0), torch.full_like(nxt, -1), nxt)
        drafts.append(nxt)
        a, c = c, nxt
    return torch.stack(drafts, dim=1)


def record(table: torch.Tensor, prev: torch.Tensor, last: torch.Tensor,
           nxt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Learn one transition per row, in place: table[hash(prev, last)] =
    nxt where `valid` and all three tokens are real.  Other rows write
    their bucket's own value back (JAX scatters them to column T and
    drops them); each row writes one bucket, so no two writes collide.
    Returns `table`."""
    b, t = table.shape
    rows = torch.arange(b, device=table.device)
    h = ngram_hash(prev, last, t)
    ok = valid & (prev >= 0) & (last >= 0) & (nxt >= 0)
    table[rows, h] = torch.where(ok, nxt.to(table.dtype), table[rows, h])
    return table


def accept_length(drafts: torch.Tensor, greedy: torch.Tensor
                  ) -> torch.Tensor:
    """Longest matching prefix length (B,) int32 in [0, D] of drafts
    (B, D) against the verifier's greedy tokens at the same positions."""
    match = (drafts == greedy).to(torch.int32)
    return match.cumprod(dim=1).sum(dim=1).to(torch.int32)
