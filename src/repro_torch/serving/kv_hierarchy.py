"""Hierarchical KV memory: the refcounted prefix cache and the host swap
tier — the counterpart of `repro.serving.kv_hierarchy`.

* `PrefixCache` — cross-request prefix reuse.  Finished requests donate
  their page-aligned leading blocks into a chained-hash index (keyed per
  tenant-visibility salt); at admission the engine matches the longest
  cached prefix, maps the shared physical pages read-only into the new
  slot's page table (a refcount bump, no copy) and prefills only the
  suffix.  Unreferenced entries are evicted LRU first to feed the free
  list, demoted to the host tier when one is attached.
* `HostPagePool` — a bounded host-DRAM page tier over one pinned slab per
  leaf.  Swap-out gathers a victim's private pages on the device and
  lands them on the host with one `.cpu()`; swap-in uploads them without
  blocking and scatters them into fresh pages.  Preemption then moves
  O(pages) instead of recomputing O(context).  A slot-resident leaf (a
  recurrent state, Hymba's `ssm_h`) has no pages: its slot's row rides
  in the handle and is written into the new slot at swap-in.  JAX's
  handle leaves it behind, so a swapped Hymba request resumes there on
  whatever state its new slot holds (ROADMAP.md C16).

The host-side bookkeeping (chained keys, LRU, reclaim, flush, demotion
and promotion) is a close copy of the JAX module's.  Where JAX returns
updated cache dicts, the page movers here update the pools in place, so
`swap_in_slot` and `PrefixCache.match` return whether they moved pages
(the engine counts a dispatch for each such move).

Safety, as in JAX: only full page-aligned blocks are shared, and the
engine caps a match below the request's last prompt token, so decode
writes land in private pages; `PagedKVPool.write_table()` masks shared
pages as a second line of defence.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.kv_cache import (PagedKVPool, put_pages, take_pages,
                                          to_device)


# --------------------------------------------------------------------- #
class HostPagePool:
    """Bounded host-DRAM page store (tier 2).  Pages live in one slab per
    leaf of `like` (the device pools, `{leaf: (layers, P, page_size,
    ...)}`): `(layers, n_pages, page_size, ...)` CPU tensors, in pinned
    memory when `pin` (the engine pins on the card), allocated here, so
    that no swap-out pays for pinning them.  Host page ids are the slab's
    rows; the id space is disjoint from the device pool's (separate free
    lists).

    `get` copies the requested pages into a fresh staging tensor (pinned
    when `pin`), never a view of the slab: an asynchronous upload reads
    the staging block, which torch's caching host allocator hands out
    again only after that upload has run, so a later `put` into a freed
    slab row can never overwrite data still in flight."""

    def __init__(self, n_pages: int, like: Dict[str, torch.Tensor],
                 pin: bool = False):
        self.n_pages = int(n_pages)
        self.pin = pin
        self.free_ids: List[int] = list(range(self.n_pages))[::-1]
        self._held: set = set()
        self._slab = {k: torch.empty((v.shape[0], self.n_pages)
                                     + tuple(v.shape[2:]), dtype=v.dtype,
                                     pin_memory=pin)
                      for k, v in like.items()}
        self.swapped_out = 0          # pages landed host-side
        self.swapped_in = 0           # pages restored to device
        # chaos hook: a swap-tier outage refuses new swap-outs (the engine
        # falls back to recompute-preemption); parked pages stay readable
        self.fail_puts = False

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self.free_ids)

    def can_hold(self, n: int) -> bool:
        if self.fail_puts:
            return False
        return n <= len(self.free_ids)

    def put(self, blocks: Dict[str, torch.Tensor], n: int,
            force: bool = False) -> Optional[List[int]]:
        """Store `n` pages from stacked host blocks `{leaf: (layers, n,
        page_size, ...)}`.  All-or-nothing.  `force` bypasses the
        `fail_puts` hook (re-parking blocks whose host copies were already
        released)."""
        if (self.fail_puts and not force) or n > len(self.free_ids):
            return None
        ids = [self.free_ids.pop() for _ in range(n)]
        idx = torch.tensor(ids, dtype=torch.long)
        for k, slab in self._slab.items():
            slab.index_copy_(1, idx, blocks[k][:, :n].to(slab.dtype))
        self._held.update(ids)
        self.swapped_out += n
        return ids

    def get(self, ids: List[int]) -> Dict[str, torch.Tensor]:
        """Stored pages as stacked blocks `{leaf: (layers, n, ...)}` (the
        `put_pages` upload format), copied into a fresh staging tensor."""
        idx = torch.tensor(list(ids), dtype=torch.long)
        out = {}
        for k, slab in self._slab.items():
            stage = torch.empty((slab.shape[0], len(ids)) + slab.shape[2:],
                                dtype=slab.dtype, pin_memory=self.pin)
            out[k] = torch.index_select(slab, 1, idx, out=stage)
        return out

    def free(self, ids: List[int]):
        for hid in ids:
            if hid not in self._held:
                raise ValueError(f"free of unallocated host page {hid}")
            self._held.discard(hid)
            self.free_ids.append(hid)

    def release(self, ids: List[int], restored: bool = False):
        self.free(ids)
        if restored:
            self.swapped_in += len(ids)


# --------------------------------------------------------------------- #
@dataclasses.dataclass
class SwapHandle:
    """What rebuilds a parked slot's KV without a model forward: which
    table indices keep live device pages (shared prefix blocks the handle
    holds references on) and which moved to the host tier.  The engine
    rebuilds the decode state (last token, budget, position) host-side.
    `resident` holds the slot's rows of the slot-resident leaves, on the
    host."""
    request_id: int
    n_tokens: int                       # pool.lengths at detach
    kept: List[Tuple[int, int]]         # (table index, device page id)
    host: List[Tuple[int, int]]         # (table index, host page id)
    resident: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)           # leaf -> (L, ...) host row

    @property
    def n_pages(self) -> int:
        return len(self.kept) + len(self.host)


def _row_to_host(leaf: torch.Tensor, slot: int) -> torch.Tensor:
    """leaf[:, slot] copied into host memory (pinned on the card) without
    waiting: the swap-out's `.cpu()` that follows on the same stream
    completes it."""
    row = leaf[:, slot]
    if leaf.device.type != "cuda":
        return row.clone()
    out = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
    return out.copy_(row, non_blocking=True)


def swap_out_slot(pool: PagedKVPool, host: HostPagePool, paged: Dict,
                  slot: int, resident: Optional[Dict] = None
                  ) -> Optional[SwapHandle]:
    """Park `slot` off the device: detach its page-table row, keep device
    references on shared pages (refs > 1, the prefix-cache blocks other
    slots may read), and move the private pages to the host tier with one
    gather and one `.cpu()`; the slot's rows of the `resident` leaves
    ((L, n_slots, ...) each) go to the host ahead of them, in the same
    wait.  None, leaving the slot untouched, when the host pool cannot
    hold the private pages (the caller falls back to
    recompute-preemption)."""
    pages = pool.slot_pages.get(slot)
    if pages is None:
        return None
    n_tokens = pool.lengths[slot]
    request_id = pool.owners[slot]
    private = [(i, p) for i, p in enumerate(pages)
               if pool.refs.get(p, 1) == 1]
    if not host.can_hold(len(private)):
        return None
    rows = {k: _row_to_host(v, slot) for k, v in (resident or {}).items()}
    pages = pool.detach(slot)           # the handle now owns every reference
    kept = [(i, p) for i, p in enumerate(pages) if pool.refs.get(p, 1) > 1]
    priv = [(i, p) for i, p in enumerate(pages) if pool.refs.get(p, 1) == 1]
    host_ids: List[int] = []
    if priv:
        blocks = take_pages(paged, [p for _, p in priv])   # the one sync
        host_ids = host.put(blocks, len(priv))
        for _, p in priv:
            pool.free_page(p)
    elif rows and next(iter(rows.values())).is_pinned():
        torch.cuda.current_stream().synchronize()   # no page to wait on
    return SwapHandle(request_id=request_id, n_tokens=n_tokens, kept=kept,
                      host=[(i, h) for (i, _), h in zip(priv, host_ids)],
                      resident=rows)


def swap_in_slot(pool: PagedKVPool, host: HostPagePool, paged: Dict,
                 handle: SwapHandle, resident: Optional[Dict] = None
                 ) -> Optional[Tuple[int, bool]]:
    """Restore a parked slot: claim fresh device pages for the host-tier
    blocks, upload and scatter them in (no host sync), attach the full
    page list to a fresh slot and write the handle's resident rows into
    that slot of the `resident` leaves.  Returns `(slot, uploaded)`,
    `uploaded` when any page moved, or None (the handle intact) when
    slots or pages are short."""
    if not pool.free_slots:
        return None
    fresh = pool.alloc_pages(len(handle.host))
    if fresh is None:
        return None
    table: Dict[int, int] = dict(handle.kept)
    if handle.host:
        hids = [h for _, h in handle.host]
        put_pages(paged, fresh, host.get(hids))
        host.release(hids, restored=True)
        for (i, _), p in zip(handle.host, fresh):
            table[i] = p
    pages = [table[i] for i in sorted(table)]
    slot = pool.attach(handle.request_id, pages, handle.n_tokens)
    if slot is None:                    # raced out of slots: undo pages
        if handle.host:
            # host copies are gone; re-park the restored blocks
            blocks = take_pages(paged, fresh)
            hids = host.put(blocks, len(fresh), force=True)
            handle.host = [(i, h) for (i, _), h in zip(handle.host, hids)]
        for p in fresh:
            pool.free_page(p)
        return None
    for k, row in handle.resident.items():
        leaf = resident[k]
        leaf[:, slot] = to_device(row, leaf.device)
    return slot, bool(handle.host)


def drop_handle(pool: PagedKVPool, host: HostPagePool,
                handle: SwapHandle):
    """Abandon a parked request (cancel, failure): drop the handle's
    device references and host pages."""
    for _, p in handle.kept:
        pool.free_page(p)
    if handle.host:
        host.free([h for _, h in handle.host])
    handle.kept, handle.host = [], []


# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _Entry:
    key: tuple                          # (salt, parent id, block tokens)
    tokens: tuple                       # the block's token ids
    page: Optional[int]                 # device physical page (tier 1)
    host_id: Optional[int]              # host pool page (tier 2)
    parent: Optional["_Entry"]
    depth: int                          # block index from the root
    eid: int = 0
    users: int = 0                      # live request bindings
    children: int = 0
    dev_children: int = 0               # of which on the device tier
    tick: int = 0                       # LRU clock

    @property
    def tier(self) -> str:
        return "device" if self.page is not None else "host"


class PrefixCache:
    """Refcounted prefix index over page-aligned token blocks.  Entries
    form chains (each block keyed by its parent), so a lookup walks block
    by block from the root and a match is always a prefix of full pages.
    `users` counts live requests whose slots map the entry's page; only
    `users == 0` entries are evictable, LRU first — demoted to the host
    tier when one is attached, dropped otherwise.

    One departure from JAX: an entry whose children all sit on the host
    tier is evictable by demotion too.  In JAX only entries with no
    children at all are, so every demotion pins its parent's device page
    for good; a cache over a host tier then holds more and more of the
    pool that nothing can reclaim, and a slot that must grow is swapped
    out and back in forever (ROADMAP C8).  Demoting the parent keeps the
    chain whole: a match promotes it, then its children, in order."""

    def __init__(self, pool: PagedKVPool,
                 host: Optional[HostPagePool] = None,
                 max_device_pages: int = 0,
                 share_tenants: bool = False):
        self.pool = pool
        self.host = host
        self.page_size = pool.page_size
        # 0 => no explicit cap: bounded by the pool + demand reclaim
        self.max_device_pages = int(max_device_pages)
        self.share_tenants = share_tenants
        self._index: Dict[tuple, _Entry] = {}
        self._bound: Dict[int, List[_Entry]] = {}   # request -> entries
        self._ids = 0
        self._clock = 0
        # request-level counters (the engine's `cache_hit_rate`)
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0
        self.inserted_pages = 0
        self.evictions = 0
        self.demotions = 0
        self.promotions = 0

    # ---- keying --------------------------------------------------- #
    def _salt(self, tenant: str) -> str:
        return "" if self.share_tenants else (tenant or "")

    def _key(self, salt: str, parent: Optional[_Entry],
             block: tuple) -> tuple:
        return (salt, parent.eid if parent else -1, block)

    def _touch(self, e: _Entry):
        self._clock += 1
        e.tick = self._clock

    # ---- metrics -------------------------------------------------- #
    @property
    def device_pages(self) -> int:
        return sum(1 for e in self._index.values() if e.page is not None)

    @property
    def host_pages(self) -> int:
        return sum(1 for e in self._index.values()
                   if e.host_id is not None)

    def evictable_device_pages(self) -> int:
        """Device pages `reclaim` can hand back right now (unpinned
        entries with no child on the device, demoted when a host tier is
        attached) — what the admission budget and `page_pressure` net
        out.  Entries freed by cascade are a bonus, never a promise."""
        return len(self._evictable(self.host is not None))

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._index),
            "device_pages": self.device_pages,
            "host_pages": self.host_pages,
            "evictable_pages": self.evictable_device_pages(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate(),
            "matched_tokens": self.matched_tokens,
            "inserted_pages": self.inserted_pages,
            "evictions": self.evictions,
            "demotions": self.demotions,
            "promotions": self.promotions,
        }

    # ---- lookup / bind -------------------------------------------- #
    def peek(self, tenant: str, tokens, limit_tokens: int) -> int:
        """Match length in tokens without side effects (device tier only):
        no counters, no LRU touches, no promotions — the scheduler's page
        netting."""
        salt = self._salt(tenant)
        parent: Optional[_Entry] = None
        ps = self.page_size
        n = 0
        for b in range(max(limit_tokens, 0) // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            e = self._index.get(self._key(salt, parent, block))
            if e is None or e.tokens != block or e.page is None:
                break
            n += 1
            parent = e
        return n * ps

    def match(self, tenant: str, tokens, limit_tokens: int,
              paged: Optional[Dict] = None):
        """Longest cached prefix of `tokens`, in full page blocks, never
        past `limit_tokens`.  Device-tier entries map for free; host-tier
        entries are promoted back into device pages of `paged` when it is
        given and a page is claimable (an upload and a scatter, no sync),
        else the walk stops there.  Returns `(entries, matched_tokens,
        promoted)`, `promoted` when any page was uploaded."""
        self.lookups += 1
        salt = self._salt(tenant)
        out: List[_Entry] = []
        promoted = False
        parent: Optional[_Entry] = None
        ps = self.page_size
        for b in range(max(limit_tokens, 0) // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            e = self._index.get(self._key(salt, parent, block))
            if e is None or e.tokens != block:
                break
            if e.page is None:          # host tier: promote or stop
                if paged is None or self.host is None \
                        or not self._promote(e, paged):
                    break
                promoted = True
            self._touch(e)
            out.append(e)
            parent = e
        if out:
            self.hits += 1
            self.matched_tokens += len(out) * ps
        return out, len(out) * ps, promoted

    def _promote(self, e: _Entry, paged: Dict) -> bool:
        """Host -> device: claim a page (reclaiming LRU cache pages if the
        pool is dry), upload the stored block, rewrite the entry."""
        claimed = self.pool.alloc_pages(1)
        if claimed is None:
            if self.reclaim(1, paged) < 1:
                return False
            claimed = self.pool.alloc_pages(1)
            if claimed is None:
                return False
        page = claimed[0]
        put_pages(paged, [page], self.host.get([e.host_id]))
        self.host.release([e.host_id], restored=True)
        e.host_id, e.page = None, page
        if e.parent is not None:
            e.parent.dev_children += 1
        self.promotions += 1
        return True

    def bind(self, request_id: int, entries: List[_Entry]):
        """Pin `entries` for a live request (its slot maps their pages);
        pinned entries are not evictable."""
        if not entries:
            return
        for e in entries:
            e.users += 1
        self._bound[request_id] = list(entries)

    def unbind(self, request_id: int):
        for e in self._bound.pop(request_id, ()):
            e.users -= 1

    # ---- insert ---------------------------------------------------- #
    def insert(self, tenant: str, tokens, n_tokens: int,
               slot_pages: List[int]) -> int:
        """Donate a finishing slot's full page-aligned blocks: existing
        entries are refreshed, new blocks `retain` the slot's page (so the
        slot's release leaves the cache holding the last reference).
        Returns the pages newly cached."""
        salt = self._salt(tenant)
        ps = self.page_size
        parent: Optional[_Entry] = None
        added = 0
        for b in range(min(n_tokens // ps, len(slot_pages))):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            key = self._key(salt, parent, block)
            e = self._index.get(key)
            if e is None:
                if self.max_device_pages and \
                        self.device_pages >= self.max_device_pages and \
                        self.reclaim(1) < 1:
                    break               # cap reached, nothing evictable
                page = slot_pages[b]
                self.pool.retain(page)
                self._ids += 1
                e = _Entry(key=key, tokens=block, page=page, host_id=None,
                           parent=parent, depth=b, eid=self._ids)
                self._index[key] = e
                if parent is not None:
                    parent.children += 1
                    parent.dev_children += 1
                self.inserted_pages += 1
                added += 1
            self._touch(e)
            parent = e
        return added

    # ---- eviction -------------------------------------------------- #
    def _evictable(self, demote: bool) -> List[_Entry]:
        """Unpinned device entries with no child on the device, LRU first;
        those with host-tier children only when they will be demoted."""
        demote = demote and self.host is not None and self.host.can_hold(1)
        return sorted((e for e in self._index.values()
                       if e.users == 0 and e.page is not None
                       and e.dev_children == 0
                       and (e.children == 0 or demote)),
                      key=lambda e: e.tick)

    def _drop(self, e: _Entry, demote_paged: Optional[Dict]) -> bool:
        """Free one entry's device page: demote its block to the host tier
        when possible (a later match promotes it back), else drop the
        entry — unless children hang off it, which leaves it as it is.
        Returns whether the entry was demoted or dropped."""
        if e.page is not None:
            if demote_paged is not None and self.host is not None \
                    and self.host.can_hold(1):
                blocks = take_pages(demote_paged, [e.page])
                e.host_id = self.host.put(blocks, 1)[0]
                self.demotions += 1
                self.pool.free_page(e.page)
                e.page = None
                if e.parent is not None:
                    e.parent.dev_children -= 1
                return True             # the entry lives on, host tier
            if e.children:
                return False
            self.pool.free_page(e.page)
            e.page = None
            if e.parent is not None:
                e.parent.dev_children -= 1
        if e.children:
            return False
        if e.host_id is not None:
            self.host.free([e.host_id])
            e.host_id = None
        del self._index[e.key]
        if e.parent is not None:
            e.parent.children -= 1
        self.evictions += 1
        return True

    def reclaim(self, n_pages: int,
                demote_paged: Optional[Dict] = None) -> int:
        """Free up to `n_pages` device pages by evicting unpinned entries
        LRU first (cascading up chains as children go), demoting them to
        the host tier with `demote_paged`.  Returns the pages freed."""
        freed = 0
        while freed < n_pages:
            progressed = False
            for e in self._evictable(demote_paged is not None):
                if freed >= n_pages:
                    break
                if self._drop(e, demote_paged):
                    freed += 1
                    progressed = True
            if not progressed:
                break
        return freed

    def flush(self) -> Dict[str, int]:
        """Drop every unpinned entry of both tiers (the admin flush verb
        and the deterministic-test reset); pinned entries survive."""
        dropped = 0
        while True:
            leaves = [e for e in self._index.values()
                      if e.users == 0 and e.children == 0]
            if not leaves:
                break
            for e in leaves:
                self._drop(e, None)
                dropped += 1
        return {"flushed": dropped, "remaining": len(self._index)}
