"""Paged KV memory: the host page allocator and the device-side page moves.

`PagedKVPool` is the host bookkeeping of `repro.serving.kv_cache`'s pool:
a free list of physical page ids, per-slot page lists and token lengths,
per-page reference counts, and a `(n_slots, pages_per_slot)` int32 page
table mirrored on the device (a torch tensor, re-uploaded only after host
mutations).  Unused entries hold the sentinel `n_pages`.  Slots may be
oversubscribed against the page budget; the engine admits page-aware and
preempts on exhaustion.

Pages are refcounted, as in JAX: the prefix cache
(`serving.kv_hierarchy.PrefixCache`) `retain`s the pages of finished
requests and maps them into several slots' tables at once
(`alloc(shared_pages=...)`).  Shared pages (refs > 1) are read-only:
`write_table()`, a second cached device tensor beside `page_table()`,
holds the sentinel in their place.

The physical cache is a dict of flat pools, `{"k", "v": (L, n_pages + 1,
page_size, K, hd)}`: page `n_pages`, the sentinel's id, is a scratch page
that takes the writes JAX drops and that attention never reads.  So a
write through `write_table()` aimed at a shared page lands in scratch,
and a read through a sentinel entry reads scratch garbage where JAX reads
zeros: every read that a sentinel may reach is masked with `where`, never
weighted by a zero.  The page movers (`copy_pages`, `take_pages`,
`put_pages`) refuse the scratch id.

`scatter_prefill_rows` lands freshly prefilled rows in their pages;
`gather_pages` / `scatter_pages` copy logical views out of the pool and
back (the gather decode mode, and the prefix-cache suffix admission);
`write_slots` lands rows in the contiguous per-slot strips
(`paged=False`); `take_pages` / `put_pages` move pages to and from the
host swap tier.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Host array or CPU tensor -> device tensor without waiting on the
    device: a pinned staging copy (or the tensor itself when it is pinned
    already) and an asynchronous upload on the card, a plain copy on the
    CPU.  The staging block comes from torch's caching host allocator,
    which records the upload's event and hands the block out again only
    after the copy has run."""
    t = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.contiguous()
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.clone()


class PagedKVPool:
    """Page-granular, refcounted KV allocator with a device-resident page
    table.  `n_pages` defaults to the contiguous-equivalent budget
    (`n_slots * pages_per_slot`); fewer pages oversubscribe the slots.  A
    page returns to the free list when its last reference drops."""

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
        self.refs: Dict[int, int] = {}        # page -> reference count
        self.preemptions = 0                  # engine-driven evictions
        self.grow_failures = 0                # page-exhaustion events
        # host mirror of the device page table; sentinel == self.n_pages
        self._table = np.full((n_slots, self.pages_per_slot), self.n_pages,
                              np.int32)
        self._table_dev: Optional[torch.Tensor] = None
        self._wtable_dev: Optional[torch.Tensor] = None

    # ---- allocation ---------------------------------------------- #
    def pages_for_tokens(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.page_size), 1)

    def _claim(self, n: int) -> Optional[List[int]]:
        """Pop `n` fresh pages (refcount 1 each); None when short."""
        if n > len(self.free_pages):
            return None
        pages = [self.free_pages.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def alloc(self, request_id: int, n_tokens: int,
              reserve_tokens: int = 0, shared_pages=()) -> Optional[int]:
        """Claim a slot plus pages covering `n_tokens` positions
        (`reserve_tokens`, when larger, widens the claim: the contiguous
        mode reserves the full `max_len` strip up front).  `shared_pages`
        (a prefix-cache hit) are allocated pages mapped read-only at the
        front of the slot's table: their refcounts go up and only the
        rest is claimed fresh.  All-or-nothing: None (claiming nothing)
        when slots or pages run out."""
        total = self.pages_for_tokens(max(n_tokens, reserve_tokens))
        fresh = total - len(shared_pages)
        if not self.free_slots or n_tokens > self.max_len or fresh < 0 \
                or fresh > len(self.free_pages):
            return None
        slot = self.free_slots.pop()
        pages = list(shared_pages)
        for p in pages:
            self.refs[p] = self.refs.get(p, 0) + 1
        pages.extend(self._claim(fresh))
        self.slot_pages[slot] = pages
        self.lengths[slot] = n_tokens
        self.owners[slot] = request_id
        self._table[slot, :total] = pages
        self._mark_dirty()
        return slot

    def alloc_pages(self, n: int) -> Optional[List[int]]:
        """Claim `n` pages that no slot maps (a COW fork, a host-tier
        promotion, a swap-in); the caller owns one reference to each."""
        return self._claim(n)

    def attach(self, request_id: int, pages: List[int],
               n_tokens: int) -> Optional[int]:
        """Map an existing page list into a fresh slot (swap-in restore).
        The caller's references move to the slot: no refcount changes, no
        page is claimed.  None when every slot is busy (the caller keeps
        its references)."""
        if not self.free_slots or len(pages) > self.pages_per_slot:
            return None
        slot = self.free_slots.pop()
        self.slot_pages[slot] = list(pages)
        self.lengths[slot] = n_tokens
        self.owners[slot] = request_id
        self._table[slot, :len(pages)] = pages
        self._mark_dirty()
        return slot

    def detach(self, slot: int) -> List[int]:
        """Unmap `slot` without dropping its page references (swap-out):
        the caller now owns one reference to each returned page and must
        `free_page` or `attach` them."""
        if slot not in self.lengths:
            return []
        del self.lengths[slot]
        del self.owners[slot]
        pages = self.slot_pages.pop(slot)
        self._table[slot, :] = self.n_pages
        self._mark_dirty()
        self.free_slots.append(slot)
        return pages

    def retain(self, page: int):
        """One more reference to an allocated page (prefix-cache insert)."""
        if page not in self.refs:
            raise ValueError(f"retain of unallocated page {page}")
        self.refs[page] += 1
        self._wtable_dev = None

    def free_page(self, page: int):
        """Drop one reference; the page returns to the free list with its
        last reference."""
        r = self.refs.get(page)
        if r is None:
            raise ValueError(f"free of unallocated page {page}")
        if r > 1:
            self.refs[page] = r - 1
            self._wtable_dev = None
        else:
            del self.refs[page]
            self.free_pages.append(page)

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
        new = self._claim(need)
        if new is None:
            self.grow_failures += 1
            return False
        self._table[slot, len(have):len(have) + need] = new
        have.extend(new)
        self._mark_dirty()
        return True

    def cow_page(self, slot: int, i: int) -> Optional[tuple]:
        """Copy-on-write fork: when page `i` of `slot` is shared, replace
        it with a fresh private page and return `(old, new)` for the
        caller to copy (`copy_pages`); the slot's reference moves to the
        new page.  None when the page is private already or the pool is
        out of pages."""
        pages = self.slot_pages.get(slot)
        if pages is None or i >= len(pages):
            return None
        old = pages[i]
        if self.refs.get(old, 1) <= 1:
            return None
        claimed = self._claim(1)
        if claimed is None:
            return None
        new = claimed[0]
        self.free_page(old)        # drop the slot's shared reference
        pages[i] = new
        self._table[slot, i] = new
        self._mark_dirty()
        return old, new

    def advance(self, slot: int, n: int = 1):
        self.lengths[slot] = min(self.lengths[slot] + n, self.max_len)

    def release(self, slot: int):
        if slot not in self.lengths:
            return
        del self.lengths[slot]
        del self.owners[slot]
        for p in reversed(self.slot_pages.pop(slot)):
            self.free_page(p)
        self._table[slot, :] = self.n_pages
        self._mark_dirty()
        self.free_slots.append(slot)

    # ---- device view --------------------------------------------- #
    def _mark_dirty(self):
        self._table_dev = None
        self._wtable_dev = None

    def page_table(self) -> torch.Tensor:
        """The `(n_slots, pages_per_slot)` int32 device page table, uploaded
        again only after host mutations (asynchronously)."""
        if self._table_dev is None:
            self._table_dev = to_device(self._table, self.device)
        return self._table_dev

    def write_table(self) -> torch.Tensor:
        """The page table with every shared entry (refs > 1) masked to the
        sentinel: reads go through `page_table()`, writes through this
        one, so a write aimed at a cache-shared page lands in the scratch
        page instead of under another reader.  With no sharing it is
        `page_table()` itself (no second upload)."""
        if self._wtable_dev is None:
            shared = [p for p, r in self.refs.items() if r > 1]
            if not shared:
                self._wtable_dev = self.page_table()
            else:
                wt = self._table.copy()
                wt[np.isin(wt, np.asarray(shared, np.int32))] = self.n_pages
                self._wtable_dev = to_device(wt, self.device)
        return self._wtable_dev

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
    def n_active(self) -> int:
        return self.n_slots - len(self.free_slots)

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


# --------------------------------------------------------------------- #
# Page movement: COW forks and the host swap tier.  Page ids are host
# lists; the scratch page (id n_pages, the last of each leaf) is never a
# source or a destination.

def _page_index(paged: Dict, page_ids) -> torch.Tensor:
    ids = np.asarray(list(page_ids), np.int64)
    scratch = next(iter(paged.values())).shape[1] - 1
    if ids.size and (ids.min() < 0 or ids.max() >= scratch):
        raise ValueError(f"page ids {ids.tolist()} outside [0, {scratch})")
    return to_device(ids, next(iter(paged.values())).device)


def copy_pages(paged: Dict, src_ids, dst_ids) -> Dict:
    """Device-side page copy (the COW fork's data move), in place: pages
    `src_ids` are duplicated into `dst_ids`, leaf by leaf.  No host sync.
    Returns `paged`."""
    if len(src_ids) != len(dst_ids):
        raise ValueError("copy_pages: src and dst differ in length")
    if not len(src_ids):
        return paged
    src, dst = _page_index(paged, src_ids), _page_index(paged, dst_ids)
    for leaf in paged.values():
        leaf.index_copy_(1, dst, leaf.index_select(1, src))
    return paged


def take_pages(paged: Dict, page_ids) -> Dict[str, torch.Tensor]:
    """Swap-out data move: one gather of the pages on the device per
    leaf, then one `.cpu()` for the whole block set — the swap-out's
    single host sync.  Returns `{leaf: (L, n, page_size, ...)}` CPU
    tensors."""
    idx = _page_index(paged, page_ids)
    names = list(paged)
    blocks = torch.stack([paged[k].index_select(1, idx) for k in names])
    host = blocks.cpu()
    return {k: host[i] for i, k in enumerate(names)}


def put_pages(paged: Dict, page_ids, host_blocks: Dict) -> Dict:
    """Swap-in data move, in place: each leaf's host blocks (L, n,
    page_size, ...) are uploaded without blocking (from pinned memory on
    the card, `to_device`) and `index_copy_`'d into pages `page_ids`.
    No host sync.  Returns `paged`."""
    idx = _page_index(paged, page_ids)
    for k, leaf in paged.items():
        blk = to_device(host_blocks[k], leaf.device)
        leaf.index_copy_(1, idx, blk.to(leaf.dtype))
    return paged
