"""Paged KV memory: the host page allocator and the device-side writes.

`PagedKVPool` is the host bookkeeping of `repro.serving.kv_cache`'s pool:
a free list of physical page ids, per-slot page lists and token lengths,
and a `(n_slots, pages_per_slot)` int32 page table mirrored on the
device (a torch tensor, re-uploaded only after host mutations).  Unused
entries hold the sentinel `n_pages`.  Slots may be oversubscribed against
the page budget; the engine admits page-aware and preempts on exhaustion.

The physical cache is a dict of flat pools, `{"k", "v": (L, n_pages + 1,
page_size, K, hd)}`: page `n_pages`, the sentinel's id, is a scratch page
that takes the writes JAX drops and that attention never reads.
`scatter_prefill_rows` lands freshly prefilled rows in their pages;
`gather_pages` / `scatter_pages` copy every slot's logical view out of
the pool and back (the gather decode mode); `write_slots` lands rows in
the contiguous per-slot strips (`paged=False`).  Page sharing between
slots (the prefix cache) and the host swap tier are not ported yet
(ROADMAP.md A4), so every page has one owner and the write table equals
the page table.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting on the device: a pinned
    staging copy and an asynchronous upload on the card (the pinned block
    is held until the copy has run), a plain copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


class PagedKVPool:
    """Page-granular KV allocator with a device-resident page table.
    `n_pages` defaults to the contiguous-equivalent budget
    (`n_slots * pages_per_slot`); fewer pages oversubscribe the slots."""

    def __init__(self, n_slots: int, max_len: int, page_size: int = 16,
                 n_pages: int = 0, device: torch.device = torch.device("cpu")):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.device = device
        self.pages_per_slot = -(-max_len // page_size)   # ceil
        self.n_pages = n_pages or n_slots * self.pages_per_slot
        if self.n_pages < self.pages_per_slot:
            raise ValueError(
                f"kv pool of {self.n_pages} pages cannot hold even one "
                f"max_len={max_len} sequence ({self.pages_per_slot} pages)")
        self.free_slots: List[int] = list(range(n_slots))[::-1]
        self.free_pages: List[int] = list(range(self.n_pages))[::-1]
        self.slot_pages: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}     # cache tokens written/held
        self.owners: Dict[int, int] = {}      # slot -> request_id
        self.preemptions = 0                  # engine-driven evictions
        self.grow_failures = 0                # page-exhaustion events
        # host mirror of the device page table; sentinel == self.n_pages
        self._table = np.full((n_slots, self.pages_per_slot), self.n_pages,
                              np.int32)
        self._table_dev: Optional[torch.Tensor] = None

    # ---- allocation ---------------------------------------------- #
    def pages_for_tokens(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.page_size), 1)

    def alloc(self, request_id: int, n_tokens: int,
              reserve_tokens: int = 0) -> Optional[int]:
        """Claim a slot plus pages covering `n_tokens` positions
        (`reserve_tokens`, when larger, widens the claim: the contiguous
        mode reserves the full `max_len` strip up front).  All-or-nothing:
        None (claiming nothing) when slots or pages run out."""
        total = self.pages_for_tokens(max(n_tokens, reserve_tokens))
        if not self.free_slots or n_tokens > self.max_len \
                or total > len(self.free_pages):
            return None
        slot = self.free_slots.pop()
        pages = [self.free_pages.pop() for _ in range(total)]
        self.slot_pages[slot] = pages
        self.lengths[slot] = n_tokens
        self.owners[slot] = request_id
        self._table[slot, :total] = pages
        self._table_dev = None
        return slot

    def grow(self, slot: int, upto_tokens: int) -> bool:
        """Extend `slot`'s pages to cover `upto_tokens` positions.
        All-or-nothing; False means the free list ran dry (the engine's
        preemption trigger)."""
        have = self.slot_pages.get(slot)
        if have is None:
            return False
        need = min(self.pages_for_tokens(upto_tokens),
                   self.pages_per_slot) - len(have)
        if need <= 0:
            return True
        if need > len(self.free_pages):
            self.grow_failures += 1
            return False
        new = [self.free_pages.pop() for _ in range(need)]
        self._table[slot, len(have):len(have) + need] = new
        have.extend(new)
        self._table_dev = None
        return True

    def advance(self, slot: int, n: int = 1):
        self.lengths[slot] = min(self.lengths[slot] + n, self.max_len)

    def release(self, slot: int):
        if slot not in self.lengths:
            return
        del self.lengths[slot]
        del self.owners[slot]
        self.free_pages.extend(reversed(self.slot_pages.pop(slot)))
        self._table[slot, :] = self.n_pages
        self._table_dev = None
        self.free_slots.append(slot)

    # ---- device view --------------------------------------------- #
    def page_table(self) -> torch.Tensor:
        """The `(n_slots, pages_per_slot)` int32 device page table, uploaded
        again only after host mutations (asynchronously)."""
        if self._table_dev is None:
            self._table_dev = to_device(self._table, self.device)
        return self._table_dev

    def write_table(self) -> torch.Tensor:
        """The table decode writes go through.  It masks cache-shared pages
        to the sentinel in the JAX engine; with no page sharing in this
        port yet it is the page table itself."""
        return self.page_table()

    def row_pages(self, slot: int, n_pages_row: int) -> np.ndarray:
        """Physical page ids backing `slot`, sentinel-padded to
        `n_pages_row` — the prefill row-scatter index."""
        out = np.full((n_pages_row,), self.n_pages, np.int32)
        pages = self.slot_pages.get(slot, ())
        k = min(len(pages), n_pages_row)
        out[:k] = pages[:k]
        return out

    # ---- metrics -------------------------------------------------- #
    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self.free_pages)

    def utilization(self) -> float:
        """Fraction of pool tokens holding live cache entries."""
        return sum(self.lengths.values()) / float(self.n_pages
                                                  * self.page_size)

    def page_occupancy(self) -> float:
        return self.pages_in_use / float(self.n_pages)

    def fragmentation(self) -> float:
        """Fraction of allocated page tokens not holding live entries."""
        if not self.pages_in_use:
            return 0.0
        used = sum(self.lengths.values())
        return 1.0 - used / float(self.pages_in_use * self.page_size)

    def page_stats(self) -> Dict[str, float]:
        return {
            "page_size": self.page_size,
            "kv_pages": self.n_pages,
            "pages_in_use": self.pages_in_use,
            "page_occupancy": self.page_occupancy(),
            "kv_page_utilization": self.utilization(),
            "page_fragmentation": self.fragmentation(),
            "preemptions": self.preemptions,
            "grow_failures": self.grow_failures,
        }


# --------------------------------------------------------------------- #
PAGED_LEAVES = ("k", "v")


def split_paged(cache: Dict) -> (Dict, Dict):
    """Partition a cache dict into (paged, resident) leaf sub-dicts."""
    paged = {k: v for k, v in cache.items() if k in PAGED_LEAVES}
    resident = {k: v for k, v in cache.items() if k not in PAGED_LEAVES}
    return paged, resident


def new_pools(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
              head_dim: int, dtype: torch.dtype,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed `{"k", "v": (L, n_pages + 1, page_size, K, hd)}` pools: the
    page budget plus the scratch page at the sentinel's id."""
    shape = (n_layers, n_pages + 1, page_size, n_kv_heads, head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name in ("k", "v")}


def scatter_prefill_rows(paged: Dict, rows: Dict, row_pages) -> None:
    """Land prefilled rows in the page pool, in place.  paged leaves
    (L, P + 1, ps, ...), the last page the scratch page; rows leaves
    (L, n_rows, S, ...); row_pages a host (n_rows, n_pages_row) array of
    physical ids, padded with the sentinel P.  Each row is zero-padded to
    a page multiple and cut into pages; the pages whose id is the
    sentinel (bucket padding past the row's allocation, padded batch
    rows) are dropped here on the host, where the ids are known, instead
    of JAX's mode="drop" on the device."""
    row_pages = np.asarray(row_pages, np.int64)
    n_rows, npr = row_pages.shape
    flat = row_pages.reshape(-1)
    first = next(iter(paged.values()))
    keep = np.nonzero(flat < first.shape[1] - 1)[0]
    if keep.size == 0:
        return
    src = to_device(keep, first.device)
    dst = to_device(flat[keep], first.device)
    for name, leaf in paged.items():
        ps = leaf.shape[2]
        r = rows[name]
        pad = npr * ps - r.shape[2]
        if pad > 0:
            r = torch.cat([r, r.new_zeros(r.shape[:2] + (pad,)
                                          + r.shape[3:])], dim=2)
        pages = r.reshape((leaf.shape[0], n_rows * npr, ps) + leaf.shape[3:])
        leaf[:, dst] = pages[:, src].to(leaf.dtype)


def gather_pages(paged: Dict, page_table: torch.Tensor) -> Dict:
    """Each slot's logical view out of the pool, one gather per leaf:
    leaves (L, P + 1, ps, ...) -> (L, n_slots, pps * ps, ...).  Sentinel
    entries read the scratch page (JAX fills zeros there): such rows lie
    past every slot's `pos` and attention masks them."""
    n_slots, pps = page_table.shape
    idx = page_table.reshape(-1).long()
    return {k: v.index_select(1, idx).reshape(
                (v.shape[0], n_slots, pps * v.shape[2]) + v.shape[3:])
            for k, v in paged.items()}


def scatter_pages(paged: Dict, view: Dict, page_table: torch.Tensor
                  ) -> Dict:
    """Write the logical views back into the pool in place, one scatter
    per leaf; sentinel entries land in the scratch page, which nothing
    reads (JAX drops them).  Returns `paged`."""
    n_slots, pps = page_table.shape
    idx = page_table.reshape(-1).long()
    for k, leaf in paged.items():
        rows = view[k].reshape((leaf.shape[0], n_slots * pps)
                               + leaf.shape[2:])
        leaf[:, idx] = rows.to(leaf.dtype)
    return paged


def write_slots(cache: Dict, rows: Dict, slots) -> None:
    """Land a batch of prefilled rows in the contiguous per-slot strips,
    in place.  cache leaves (L, n_slots, S, ...); rows leaves (L, n_rows,
    S_rows, ...) with S_rows <= S, written at positions [0, S_rows);
    `slots` a host array of n_rows slot ids, where ids >= n_slots (padded
    batch rows) are dropped here on the host, as JAX's mode="drop"
    scatter does on the device."""
    slots = np.asarray(slots, np.int64)
    first = next(iter(cache.values()))
    keep = np.nonzero(slots < first.shape[1])[0]
    if keep.size == 0:
        return
    src = to_device(keep, first.device)
    dst = to_device(slots[keep], first.device)
    for k, leaf in cache.items():
        r = rows[k]
        leaf[:, dst, :r.shape[2]] = r[:, src].to(leaf.dtype)


def cache_bytes(cache: Dict) -> int:
    return sum(x.numel() * x.element_size() for x in cache.values())
