"""Continuous-batching inference engine on the card — the counterpart of
`repro.serving.engine.InferenceEngine` for every family the port runs:
the causal decoders (dense or MoE), the Hymba hybrid, the
encoder-decoder and xLSTM.

Each `step()` issues at most two dispatches, each ending in exactly one
host sync:

* **bucketed prefill** — queued prompts are right-padded to a power-of-two
  length bucket and admitted as one batch (padded to a power-of-two row
  count).  The forward runs the flash kernel, every row's KV lands in its
  pages, the first token per row is sampled on the device, and the
  persistent per-slot state tensors are updated in place.  One `.cpu()`
  brings back the first tokens and done flags.
* **fused K-step decode** — `decode_block` decode+sample steps run back to
  back on the device, with per-slot sampling params and an on-device
  done mask (EOS, token budget, cache end).  Nothing in the K-step loop
  waits on the device; the (K, n_slots) token / emit / done blocks come
  back with one `.cpu()`.

Three decode modes, as in JAX:

* **gather** (`paged=True, paged_attention=False`, the default): one
  gather copies every slot's logical view out of the page pool, the K
  steps run `decode_step` (the decode kernel) on it, one scatter writes
  it back.
* **paged attention** (`paged_attention=True`): the K steps attend
  straight through the page table (the paged decode kernel) and write
  each token's KV into its page; no copy.
* **contiguous** (`paged=False`): per-slot `max_len` strips, written and
  read in place by `decode_step`; the page pool only books them.

`quantize="int8"` keeps the weights int8 at rest and runs every linear
layer and the tied head through the int8 matmul kernel;
`quantize="int4"` dequantizes the whole packed tree per dispatch, as the
JAX engine does for both.

A vision model's prefix tokens (`n_prefix_tokens`, fed zero embeddings
as in JAX) and Hymba's meta tokens take cache positions ahead of every
prompt: admission charges them, the bucket is capped at max_len less
them, and a prompt that fits only without them is refused at submit.

Hymba, as in JAX: its SSM state would absorb padding, so a prompt's
bucket is its exact length (an admission group holds rows of one
length, prefilled without `lengths`), and the prefix cache and
speculation stay off.  Its state `ssm_h` (L, n_slots, inner, N) f32 is
slot-resident beside the paged pools (or the strips); admission writes
the prefilled rows' states into their slots, the decode steps advance
it in place, and a preempted request resumes by recompute (prefill over
its prompt and output so far, at their exact length) or from the swap
tier, whose handle carries the slot's state (ROADMAP.md C16: JAX's does
not).

xLSTM, as in JAX: exact-length admission too; its state (seven f32
leaves, `models.xlstm.init_cache`) has no sequence axis, so there is
nothing to page: a paged or paged-attention config serves in the
contiguous mode (no host tier, no prefix cache, no speculation), the
pool only books the slots, and a slot decodes past `max_len` (the
position limit is 2**30).  A preempted request resumes by recompute.

The encoder-decoder, as in JAX: every admission feeds the encoder zero
frames of (rows, max_len, D) (`zero_src_embeds`; the encoder's output
and the cross K/V are then exactly 0, ROADMAP.md C17), and the cross
K/V "ck", "cv" (L, n_slots, max_len, K, hd) are slot-resident in all
three modes beside the pools or strips (the swap tier's handle carries
the slot's rows).  The prefix cache and speculation stay off.

A window or prefix tokens turn
the prefix cache and speculation off, as in JAX; a MoE FFN keeps both
on (its capacity then follows each dispatch's own length: the bucket,
the suffix bucket, 1 in decode, D + 1 in the verify).

Where JAX donates buffers to a jitted call, this engine updates the page
pools and the slot-state tensors in place.  Where JAX counts compiles
(`prefill_traces`, `decode_traces`), this engine counts the distinct
programs it ran: prefill shapes `(pad_n, bucket)` and decode modes.

KV memory is paged (`serving.kv_cache.PagedKVPool`); slots may be
oversubscribed against the page budget, admission is page-aware through
the two-level DWRR scheduler, page tables grow at decode-block
boundaries, and on exhaustion the engine preempts the lowest-deficit
tenant's slot, which later resumes by recomputing its context (prompt +
tokens so far) without re-emitting a token.

The hierarchical KV memory of `serving.kv_hierarchy`, as in JAX:

* **prefix cache** (`prefix_cache=True`): finished requests donate their
  page-aligned blocks; an admission that matches a cached prefix maps
  the shared pages read-only into its table and runs only its suffix
  (`_admit_suffix`: the rows' views gathered through their tables, the
  suffix forward in plain PyTorch, the views scattered back through the
  write tables, one dispatch and one host sync).
* **host swap tier** (`host_kv_pages > 0`): a preempted slot's private
  pages move to pinned host memory (one gather, one `.cpu()`), and its
  resume uploads them and restores the slot state with no prefill.

**Speculative decoding** (`speculative=True`, with paged attention): an
all-greedy batch takes one verify dispatch instead of the fused block:
the slot's bigram table proposes `spec_draft` tokens, one paged forward
scores them, and the longest greedy-matching prefix plus the verifier's
own next token are emitted, with one host sync.  A batch with a sampled
row takes the fused path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import (DeviceLike, generator_for, resolve_device,
                                torch_dtype)
from repro_torch.models import build
from repro_torch.models.transformer import (zero_prefix_embeds,
                                            zero_src_embeds)
from repro_torch.models.xlstm import init_cache as xlstm_cache
from repro_torch.params import Params
from repro_torch.serving import quantization as q_lib
from repro_torch.serving import spec_decode as spec_lib
from repro_torch.serving.kv_cache import (PagedKVPool, cache_bytes,
                                          gather_pages, new_pools,
                                          scatter_pages,
                                          scatter_prefill_rows, split_paged,
                                          to_device, write_slots)
from repro_torch.serving.kv_hierarchy import (HostPagePool, PrefixCache,
                                              drop_handle, swap_in_slot,
                                              swap_out_slot)
from repro_torch.serving.request import (CODE_ENGINE_FAILED,
                                         CODE_INVALID_REQUEST, Request,
                                         RequestState)
from repro_torch.serving.sampler import sample_batched
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_len: int = 128
    quantize: str = ""            # "", "int8", "int4"
    top_k: int = 0                # engine-wide default (per-request wins)
    top_p: float = 1.0
    seed: int = 0
    decode_block: int = 4         # K decode steps fused per dispatch
    prefill_bucket_min: int = 8   # smallest power-of-two prompt bucket
    page_size: int = 16           # KV tokens per physical page
    kv_pages: int = 0             # page budget; 0 => n_slots full strips
    paged: bool = True            # False => contiguous per-slot strips
    # hierarchical KV memory (kv_hierarchy): both tiers default off
    prefix_cache: bool = False    # cross-request prefix page reuse
    prefix_cache_pages: int = 0   # device pages the cache may pin; 0 => no cap
    host_kv_pages: int = 0        # host-DRAM swap-tier pages; 0 => off
    prefix_share_tenants: bool = False  # share prefix blocks across tenants
    # paged attention + on-device speculative decoding
    paged_attention: bool = False  # attend through the page table (no
    #                                per-dispatch gather/scatter copy)
    speculative: bool = False     # n-gram propose + batched greedy verify
    spec_draft: int = 4           # draft tokens proposed per verify
    spec_table: int = 512         # proposer hash-table buckets (pow2)


class EngineFailure(RuntimeError):
    pass


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _to(params: Params, device: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _unshared_bytes(tree: Params, base: Params) -> int:
    """Bytes of the storages in `tree` that no tensor of `base` uses."""
    seen = {t.untyped_storage().data_ptr() for t in _tensors(base)}
    total = 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


class InferenceEngine:
    """One model instance on one card (or on the CPU when `device="cpu"`
    is passed, through the kernels' plain versions)."""

    def __init__(self, cfg: ArchConfig, params: Params,
                 engine_cfg: EngineConfig,
                 scheduler: Optional[Scheduler] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if engine_cfg.quantize not in ("", "int8", "int4"):
            raise ValueError(f"quantize={engine_cfg.quantize!r}: "
                             "'', 'int8' or 'int4'")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.model = build(cfg, self.device)
        # meta / vision-prefix tokens occupy cache slots ahead of the prompt
        self._prefix_tokens = cfg.n_meta_tokens + cfg.n_prefix_tokens
        # a recurrent state folds right-pads in: exact-length prefills
        self._supports_bucket = cfg.block not in ("hymba", "xlstm")
        self.scheduler = scheduler or Scheduler(SchedulerConfig())
        self._dead = False
        self._gen = generator_for(self.device, engine_cfg.seed)
        # a constant-size state never runs out of cache positions
        self._pos_limit = (engine_cfg.max_len if cfg.block != "xlstm"
                           else 2 ** 30)
        # xlstm's state has no sequence axis: nothing to page
        self._paged = engine_cfg.paged and cfg.block != "xlstm"
        self._paged_attn = engine_cfg.paged_attention and self._paged
        self.pool = PagedKVPool(engine_cfg.n_slots, engine_cfg.max_len,
                                page_size=engine_cfg.page_size,
                                n_pages=(engine_cfg.kv_pages
                                         if self._paged else 0),
                                device=self.device)
        # page-aware admission: the scheduler charges each queued request
        # its projected page cost against the engine's free page budget
        self.scheduler.pages_for = self._pages_for
        # prefix reuse needs page-aligned bucketed prefill over a plain
        # causal decoder: recurrent state, enc-dec cross KV, windows and
        # prefix tokens break block sharing (JAX's predicate)
        self._prefix_ok = (self._paged and self._supports_bucket
                           and not cfg.is_encdec
                           and self._prefix_tokens == 0
                           and cfg.swa_window == 0)
        # speculation needs the paged-attention verify and the same
        # predicate as the prefix cache
        self._spec_ok = (engine_cfg.speculative and self._paged_attn
                         and self._prefix_ok)

        self._swapped: Dict[int, Any] = {}   # request_id -> SwapHandle
        # weights at rest: as given, or quantized (what memory_report
        # counts); int8 also builds its kernel operands here, once
        self.params = _to(params, self.device)
        self._int8 = None
        if engine_cfg.quantize:
            self.params = q_lib.quantize_tree(
                self.params, bits=8 if engine_cfg.quantize == "int8" else 4)
            if engine_cfg.quantize == "int8":
                self._int8 = q_lib.int8_operands(self.params)
        self.cache = self._init_cache()
        self.host_pool = (HostPagePool(engine_cfg.host_kv_pages,
                                       split_paged(self.cache)[0],
                                       pin=self.device.type == "cuda")
                          if engine_cfg.host_kv_pages > 0 and self._paged
                          else None)
        self.prefix_cache = (
            PrefixCache(self.pool, host=self.host_pool,
                        max_device_pages=engine_cfg.prefix_cache_pages,
                        share_tenants=engine_cfg.prefix_share_tenants)
            if engine_cfg.prefix_cache and self._prefix_ok else None)
        self.slot_req: Dict[int, Request] = {}
        # persistent per-slot device state, written in place on admission,
        # release and cancel, and by the fused decode
        ns, dev = engine_cfg.n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.pos = torch.zeros(ns, **i32)
        self.last_tok = torch.zeros(ns, **i32)
        self.active = torch.zeros(ns, dtype=torch.bool, device=dev)
        self.remaining = torch.zeros(ns, **i32)
        self.temps = torch.zeros(ns, dtype=torch.float32, device=dev)
        self.top_ks = torch.zeros(ns, **i32)
        self.top_ps = torch.ones(ns, dtype=torch.float32, device=dev)
        self.eos_ids = torch.full((ns,), -1, **i32)
        # the speculative proposer: a bigram table per slot and the token
        # before last_tok (the chain seed), wiped on admission and
        # release so a reused slot never proposes from another stream
        self.spec_table, self.spec_prev = spec_lib.init_tables(
            ns, engine_cfg.spec_table, dev)
        # logical KV bytes one fused dispatch moves: the gather mode
        # copies every slot's logical view out and back (2x view); the
        # paged-attention mode only writes K new tokens' KV in place
        self._view_bytes = 0
        self._write_token_bytes = 0     # all-slot KV write bytes, 1 step
        if self._paged:
            for leaf in split_paged(self.cache)[0].values():
                per_tok = (leaf.element_size() * leaf.shape[0]
                           * int(np.prod(leaf.shape[3:])))
                self._view_bytes += (per_tok * ns * self.pool.pages_per_slot
                                     * self.pool.page_size)
                self._write_token_bytes += per_tok * ns
        # decode-boundary page growth also covers a verify's D + 1 writes
        self._growth = (max(engine_cfg.decode_block,
                            engine_cfg.spec_draft + 1) if self._spec_ok
                        else engine_cfg.decode_block)
        # metrics
        self.total_tokens = 0
        self.total_steps = 0
        self.step_ewma_s = 0.0
        self.dispatches = 0       # device programs issued
        self.prefill_dispatches = 0   # of which full (flash) prefills
        self.decode_dispatches = 0    # of which decodes: fused or verify
        self.host_syncs = 0       # blocking device->host transfers
        self.prefill_traces = 0   # distinct prefill programs (pad_n, bucket)
        self.decode_traces = 0    # distinct decode programs (modes)
        self.suffix_traces = 0    # distinct suffix programs (pad_n, bucket)
        self.preemptions = 0      # slots evicted on page exhaustion
        self.prefill_dispatch_tokens = 0   # rows x bucket actually forwarded
        self.suffix_prefills = 0  # rows admitted through a cached prefix
        self.swap_outs = 0        # slots parked in the host tier
        self.swap_ins = 0         # slots restored with no prefill
        self.logical_bytes_moved = 0       # KV bytes copied/written
        self.spec_traces = 0      # distinct verify programs (one)
        self.spec_dispatches = 0  # verify dispatches issued
        self.spec_emitted = 0     # tokens the verifies emitted
        self.spec_slot_accepted = np.zeros((ns,), np.int64)  # drafts/slot
        self._prefill_programs: Set[Tuple[int, int]] = set()
        self._suffix_programs: Set[Tuple[int, int]] = set()
        self._decode_programs: Set[str] = set()

    def _init_cache(self) -> Dict[str, torch.Tensor]:
        """The physical cache: the KV page pools (or per-slot strips) and
        beside them the slot-resident leaves: Hymba's SSM state (f32, as
        in JAX), an encoder-decoder's cross K/V over max_len source
        positions; for xLSTM its state leaves alone."""
        cfg, ecfg, dev = self.cfg, self.ecfg, self.device
        ns, ml = ecfg.n_slots, ecfg.max_len
        if cfg.block == "xlstm":
            return xlstm_cache(cfg, ns, dev)
        dt = torch_dtype(cfg.dtype)
        if self._paged:
            cache = new_pools(cfg.n_layers, self.pool.n_pages,
                              self.pool.page_size, cfg.n_kv_heads,
                              cfg.head_dim, dt, dev)
        else:
            cache = {name: torch.zeros((cfg.n_layers, ns, ml, cfg.n_kv_heads,
                                        cfg.head_dim), dtype=dt, device=dev)
                     for name in ("k", "v")}
        if cfg.block == "hymba":
            cache["ssm_h"] = torch.zeros(
                (cfg.n_layers, ns, cfg.n_heads * cfg.head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=dev)
        if cfg.is_encdec:
            for name in ("ck", "cv"):
                cache[name] = torch.zeros((cfg.n_layers, ns, ml,
                                           cfg.n_kv_heads, cfg.head_dim),
                                          dtype=dt, device=dev)
        return cache

    def _pages_for(self, req: Request) -> int:
        """Projected page cost of admitting `req` now: its full context
        (prompt + tokens already generated + prefix tokens) plus one
        position of decode headroom, net of the prefix-cache pages it
        would map for free
        and, for a swap-parked request, of the shared pages its handle
        still holds on the device; a contiguous strip always costs
        `max_len`."""
        if not self._paged:
            return self.pool.pages_per_slot
        handle = self._swapped.get(req.request_id)
        if handle is not None:
            return max(len(handle.host), 1)
        eff0 = len(req.prompt) + len(req.output)
        eff = eff0 + self._prefix_tokens
        need = self.pool.pages_for_tokens(min(eff + 1, self.ecfg.max_len))
        if self.prefix_cache is not None:
            cached = self.prefix_cache.peek(
                req.tenant, list(req.prompt) + list(req.output),
                eff0 - 1) // self.pool.page_size
            need = max(need - cached, 1)
        return need

    def _bucket_of(self, prompt_len: int) -> int:
        """Power-of-two padded length bucket, capped so that bucket +
        prefix tokens never outgrow max_len; the exact length for a
        recurrent family, which cannot absorb pads."""
        if not self._supports_bucket:
            return prompt_len
        b = self.ecfg.prefill_bucket_min
        while b < prompt_len:
            b <<= 1
        return min(b, self.ecfg.max_len - self._prefix_tokens)

    # ------------------------------------------------------------- #
    def submit(self, req: Request) -> bool:
        if self._dead:
            req.finish(error="engine dead", code=CODE_ENGINE_FAILED)
            return False
        if len(req.prompt) + self._prefix_tokens > self.ecfg.max_len:
            # malformed input, not a capacity problem: reject at submit
            req.finish(
                error=(f"prompt length {len(req.prompt)} (+ "
                       f"{self._prefix_tokens} prefix tokens) exceeds "
                       f"engine max_len {self.ecfg.max_len}"),
                code=CODE_INVALID_REQUEST)
            return False
        return self.scheduler.submit(req)

    def fail(self):
        """Failure injection: node/instance crash."""
        self._dead = True
        doomed = list(self.slot_req.values())
        self.slot_req.clear()
        doomed += self.scheduler.close()
        for req in doomed:
            req.finish(error="engine crashed", code=CODE_ENGINE_FAILED)

    def cancel(self, request_id: int):
        """Abort a queued or in-flight request, freeing its slot and pages
        at the next dispatch boundary.  Returns "queued" when it never held
        a slot, "active" when it did, False when unknown."""
        if self.scheduler.cancel(request_id):
            handle = self._swapped.pop(request_id, None)
            if handle is not None:       # parked in the host swap tier
                drop_handle(self.pool, self.host_pool, handle)
            if self.prefix_cache is not None:
                self.prefix_cache.unbind(request_id)
            return "queued"
        for slot, req in list(self.slot_req.items()):
            if req.request_id == request_id:
                del self.slot_req[slot]
                if self.prefix_cache is not None:
                    self.prefix_cache.unbind(request_id)
                self.pool.release(slot)
                self._release_device_slot(slot)
                return "active"
        return False

    def _release_device_slot(self, slot: int):
        """Zero the slot's device state so the next dispatch can't decode
        or sample it with stale values, and wipe its proposer row and
        chain seed so no draft of this request reaches the slot's next
        one."""
        self.last_tok[slot] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        self.remaining[slot] = 0
        self.temps[slot] = 0.0
        self.spec_table[slot] = -1
        self.spec_prev[slot] = -1
        self.dispatches += 1

    @property
    def alive(self) -> bool:
        return not self._dead

    @property
    def n_active(self) -> int:
        return self.pool.n_active

    @property
    def load(self) -> float:
        """Active slots + queue pressure, for least-loaded routing."""
        return self.pool.n_active + self.scheduler.depth

    # ------------------------------------------------------------- #
    def step(self) -> int:
        """One engine iteration: admit one prefill bucket, then one fused
        K-step decode dispatch.  Returns the decode tokens emitted."""
        if self._dead:
            raise EngineFailure("engine is dead")
        t0 = time.monotonic()
        self._admit()
        emitted = self._decode_block() if self.slot_req else 0
        self.total_steps += 1
        dt = time.monotonic() - t0
        self.step_ewma_s = 0.9 * self.step_ewma_s + 0.1 * dt \
            if self.total_steps > 1 else dt
        return emitted

    # ---- admissions: one bucketed batch prefill dispatch ---------- #
    def _decode_page_debt(self) -> int:
        """Pages the in-flight slots need for their next decode block —
        held out of the admission budget so a fresh admit cannot starve
        running requests into preemption."""
        if not self._paged:
            return 0
        debt = 0
        for slot in self.slot_req:
            target = min(self.pool.lengths[slot] + self._growth,
                         self.ecfg.max_len)
            debt += max(self.pool.pages_for_tokens(target)
                        - len(self.pool.slot_pages[slot]), 0)
        return debt

    def _admit(self):
        budget = len(self.pool.free_pages) - self._decode_page_debt()
        if self.prefix_cache is not None:
            # LRU cache pages are reclaimable on demand: they count into
            # the admission budget, so the cache never blocks admission
            budget += self.prefix_cache.evictable_device_pages()
        group = self.scheduler.next_prefill_bucket(
            len(self.pool.free_slots), self._bucket_of,
            free_pages=max(budget, 0))
        want = 1
        while not group and not self.slot_req and self.scheduler.depth \
                and self.prefix_cache is not None:
            # idle with work queued: the budget counts only what the cache
            # can hand back at once, and no running slot will free a page,
            # so the cache gives back pages (LRU, twice as many each round)
            # until the head fits, and at last everything unpinned (the
            # JAX engine waits forever here; ROADMAP C8)
            if not self.prefix_cache.reclaim(want, self._demote_target()) \
                    and not self.prefix_cache.flush()["flushed"]:
                break
            want *= 2
            group = self.scheduler.next_prefill_bucket(
                len(self.pool.free_slots), self._bucket_of,
                free_pages=len(self.pool.free_pages)
                + self.prefix_cache.evictable_device_pages())
        if not group:
            return
        # partition: swap-parked resumes restore with no prefill, prefix-
        # cache hits prefill only their suffix, the rest take the full
        # bucketed prefill (up to three dispatches when mixed)
        swaps = [r for r in group if r.request_id in self._swapped]
        fresh = [r for r in group if r.request_id not in self._swapped]
        if swaps:
            self._admit_swapped(swaps)
        hits, plain = [], fresh
        if self.prefix_cache is not None and fresh:
            hits, plain = [], []
            paged, _ = split_paged(self.cache)
            for req in fresh:
                toks = list(req.prompt) + list(req.output)
                entries, matched, promoted = self.prefix_cache.match(
                    req.tenant, toks, len(toks) - 1, paged=paged)
                if promoted:                    # host-tier promotion
                    self.dispatches += 1
                if entries:
                    # pin at once: a later reclaim (another row's
                    # shortfall, a promotion) must not evict these before
                    # the suffix admission maps their pages
                    self.prefix_cache.bind(req.request_id, entries)
                    hits.append((req, entries, matched))
                else:
                    plain.append(req)
        if hits:
            self._admit_suffix(hits)
        if plain:
            self._admit_prefill(plain)

    def _reclaim_shortfall(self, want: int):
        """Feed the free list from LRU refcount-0 cache pages before an
        allocation would fail (demoting them to the host tier when one is
        attached)."""
        short = want - len(self.pool.free_pages)
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.reclaim(short, self._demote_target())

    def _demote_target(self) -> Optional[Dict]:
        """The pools evicted cache blocks are demoted from (to the host
        tier), or None to drop them when there is no host tier."""
        return split_paged(self.cache)[0] if self.host_pool else None

    def _admit_prefill(self, group: List[Request]):
        admitted: List[Tuple[int, Request]] = []
        for req in group:
            need = len(req.prompt) + len(req.output) + self._prefix_tokens
            self._reclaim_shortfall(
                self.pool.pages_for_tokens(need) if self._paged
                else self.pool.pages_per_slot)
            slot = self.pool.alloc(
                req.request_id, need,
                reserve_tokens=0 if self._paged else self.ecfg.max_len)
            if slot is None:                    # defensive; the admission
                self.scheduler.requeue(req)     # budget above bounds the
                continue                        # group — never drop it
            req.state = RequestState.PREFILLING
            admitted.append((slot, req))
        if not admitted:
            return
        ecfg = self.ecfg
        n = len(admitted)
        bucket = self._bucket_of(max(len(r.prompt) + len(r.output)
                                     for _, r in admitted))
        n_row_pages = self.pool.pages_for_tokens(bucket
                                                 + self._prefix_tokens)
        pad_n = _next_pow2(n)
        toks = np.zeros((pad_n, bucket), np.int64)
        lengths = np.ones((pad_n,), np.int32)
        row_pages = np.full((pad_n, n_row_pages), self.pool.n_pages,
                            np.int32)              # sentinel => dropped
        slots = np.zeros((n,), np.int64)
        r_i32, r_f32 = self._row_params(pad_n, admitted)
        for i, (slot, req) in enumerate(admitted):
            prompt = list(req.prompt) + list(req.output)   # resume ctx
            toks[i, :len(prompt)] = prompt
            lengths[i] = len(prompt)
            slots[i] = slot
            row_pages[i] = self.pool.row_pages(slot, n_row_pages)
        first, done0 = self._prefill_admit(toks, lengths, row_pages, slots,
                                           r_i32, r_f32)
        self.dispatches += 1
        self.prefill_dispatches += 1
        self.prefill_dispatch_tokens += pad_n * bucket
        host = torch.stack([first, done0.to(torch.int32)]).cpu().numpy()
        self.host_syncs += 1
        self._post_admit(admitted, host[0], host[1])

    def _row_params(self, pad_n: int, admitted: List[Tuple[int, Request]]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row admission params of a padded batch: r_i32 rows top_k,
        eos, budget and the chain seed (the context's last token, which
        precedes the first sampled one); r_f32 rows temperature, top_p.
        Padded rows: greedy, no eos, budget 1, no seed."""
        ecfg = self.ecfg
        r_i32 = np.zeros((4, pad_n), np.int32)
        r_f32 = np.zeros((2, pad_n), np.float32)
        r_f32[1] = 1.0
        r_i32[1] = -1
        r_i32[2] = 1
        r_i32[3] = -1
        for i, (_, req) in enumerate(admitted):
            s = req.sampling
            r_f32[0, i] = s.temperature
            r_f32[1, i] = s.top_p if s.top_p < 1.0 else ecfg.top_p
            r_i32[0, i] = s.top_k if s.top_k > 0 else ecfg.top_k
            r_i32[1, i] = s.eos_id
            r_i32[2, i] = s.max_tokens - len(req.output)
            r_i32[3, i] = (list(req.prompt) + list(req.output))[-1]
        return r_i32, r_f32

    def _prefill_admit(self, toks, lengths, row_pages, slots, r_i32, r_f32):
        """The admission program: forward, the rows' KV into their pages
        (or, contiguous, into the first `bucket` positions of their
        strips; positions past `pos` keep what was there, where JAX
        zeroes them, and are masked), a recurrent state into its slots,
        first-token sample and the slot-state update, all queued on the
        device.  Padded batch rows are dropped here on the host (`slots`
        holds only the admitted rows), where JAX scatters them to
        slot == n_slots with mode="drop".  Exact-length rows (a
        recurrent family) go in without `lengths`, as in JAX."""
        if toks.shape not in self._prefill_programs:
            self._prefill_programs.add(toks.shape)
            self.prefill_traces += 1
        dev = self.device
        tokens = to_device(toks, dev)
        # a vision model's prefix and an encoder-decoder's frames: zero
        # embeddings, as JAX's _extra_inputs
        logits, rows, pos1 = self.model.prefill(
            self._run_params(), tokens,
            lengths=(to_device(lengths, dev) if self._supports_bucket
                     else None),
            prefix_embeds=zero_prefix_embeds(self.cfg, toks.shape[0], dev),
            src_embeds=zero_src_embeds(self.cfg, toks.shape[0],
                                       self.ecfg.max_len, dev))
        if self._paged:
            pool_p, pool_r = split_paged(self.cache)
            rows_p, rows_r = split_paged(rows)
            scatter_prefill_rows(pool_p, rows_p, row_pages)
            if pool_r:
                write_slots(pool_r, rows_r, slots)
        else:
            write_slots(self.cache, rows, slots)
        return self._admit_rows(logits, pos1, slots, r_i32, r_f32)

    def _admit_rows(self, logits, pos1, slots, r_i32, r_f32):
        """The tail both admission programs share: sample each row's first
        token and write the admitted rows' slot state (sampling params,
        budget, a fresh proposer row seeded with the context's last
        token).  Returns (first, done0) of the padded batch."""
        dev = self.device
        ri = to_device(r_i32, dev)
        rf = to_device(r_f32, dev)
        r_topk, r_eos, r_budget, r_prev = ri[0], ri[1], ri[2], ri[3]
        r_temps, r_topp = rf[0], rf[1]
        first = sample_batched(logits, self._gen, r_temps, r_topk, r_topp)
        done0 = ((r_budget <= 1) | ((r_eos >= 0) & (first == r_eos))
                 # prompt fills the cache: no room to decode further
                 | (pos1 + 1 >= self._pos_limit))
        n = len(slots)
        idx = to_device(slots, dev)
        self.last_tok[idx] = first[:n]
        self.pos[idx] = pos1[:n] + 1
        self.active[idx] = ~done0[:n]
        self.remaining[idx] = r_budget[:n] - 1
        self.temps[idx] = r_temps[:n]
        self.top_ks[idx] = r_topk[:n]
        self.top_ps[idx] = r_topp[:n]
        self.eos_ids[idx] = r_eos[:n]
        # index_fill_, not `[idx] = -1`: a Python scalar stored through a
        # tensor index is a blocking upload on the card (ROADMAP C19)
        self.spec_table.index_fill_(0, idx, -1)
        self.spec_prev[idx] = r_prev[:n]
        return first, done0

    def _post_admit(self, admitted: List[Tuple[int, Request]],
                    first_h, done_h):
        """Emit each row's first sampled token, then park it in its slot
        (or finish it)."""
        for i, (slot, req) in enumerate(admitted):
            req.emit(int(first_h[i]))
            req.state = RequestState.DECODING
            self.total_tokens += 1
            if done_h[i]:
                req.finish()
                self._finish_slot(slot, req)
            else:
                self.slot_req[slot] = req

    def _finish_slot(self, slot: int, req: Request):
        """Free a finishing slot, donating its page-aligned blocks to the
        prefix cache first (the cache `retain`s them, so the release
        leaves the cache holding the last reference)."""
        if self.prefix_cache is not None:
            if not req.error and not req.cancelled:
                n = self.pool.lengths[slot]
                toks = (list(req.prompt) + list(req.output))[:n]
                self.prefix_cache.insert(req.tenant, toks, n,
                                         self.pool.slot_pages[slot])
            self.prefix_cache.unbind(req.request_id)
        self.pool.release(slot)

    # ---- prefix-cache hits: suffix-only bucketed prefill ---------- #
    def _admit_suffix(self, hits):
        pps = self.pool.pages_per_slot
        admitted: List[Tuple[int, Request]] = []
        matched_of: Dict[int, int] = {}
        for req, entries, matched in hits:
            eff = len(req.prompt) + len(req.output)
            shared = [e.page for e in entries]
            self._reclaim_shortfall(
                self.pool.pages_for_tokens(eff) - len(shared))
            slot = self.pool.alloc(req.request_id, eff,
                                   shared_pages=shared)
            if slot is None:            # entries were pinned at match
                self.prefix_cache.unbind(req.request_id)
                self.scheduler.requeue(req)
                continue
            req.state = RequestState.PREFILLING
            admitted.append((slot, req))
            matched_of[slot] = matched
        if not admitted:
            return
        bucket = self._bucket_of(max(
            (len(r.prompt) + len(r.output)) - matched_of[s]
            for s, r in admitted))
        n = len(admitted)
        pad_n = _next_pow2(n)
        toks = np.zeros((pad_n, bucket), np.int64)
        offsets = np.zeros((pad_n,), np.int32)
        lengths = np.ones((pad_n,), np.int32)
        slots = np.zeros((n,), np.int64)
        read_tables = np.full((pad_n, pps), self.pool.n_pages, np.int32)
        write_tables = np.full((pad_n, pps), self.pool.n_pages, np.int32)
        r_i32, r_f32 = self._row_params(pad_n, admitted)
        for i, (slot, req) in enumerate(admitted):
            prompt = list(req.prompt) + list(req.output)
            matched = matched_of[slot]
            suffix = prompt[matched:]
            toks[i, :len(suffix)] = suffix
            offsets[i] = matched
            lengths[i] = len(suffix)
            slots[i] = slot
            read_tables[i] = self.pool.row_pages(slot, pps)
            write_tables[i] = read_tables[i]
            # shared prefix blocks are read-only: writes there drop
            write_tables[i, :matched // self.pool.page_size] = \
                self.pool.n_pages
        first, done0 = self._suffix_admit(toks, offsets, lengths, slots,
                                          read_tables, write_tables,
                                          r_i32, r_f32)
        self.dispatches += 1
        # admission gathers and scatters one logical view a padded row
        self.logical_bytes_moved += \
            2 * (self._view_bytes // self.ecfg.n_slots) * pad_n
        self.prefill_dispatch_tokens += pad_n * bucket
        self.suffix_prefills += n
        host = torch.stack([first, done0.to(torch.int32)]).cpu().numpy()
        self.host_syncs += 1
        self._post_admit(admitted, host[0], host[1])

    def _suffix_admit(self, toks, offsets, lengths, slots, read_tables,
                      write_tables, r_i32, r_f32):
        """The suffix admission program: each row's logical view gathered
        through its full table (shared prefix and private pages), the
        suffix-only forward, the views scattered back through the write
        tables (shared pages masked to the sentinel, so their writes land
        in the scratch page), then `_admit_rows`.  Padded rows read and
        write only the scratch page."""
        if toks.shape not in self._suffix_programs:
            self._suffix_programs.add(toks.shape)
            self.suffix_traces += 1
        dev = self.device
        pool_p, _ = split_paged(self.cache)
        view = gather_pages(pool_p, to_device(read_tables, dev))
        logits, view, pos1 = self.model.prefill_suffix(
            self._run_params(), view, to_device(toks, dev),
            to_device(offsets, dev), to_device(lengths, dev))
        scatter_pages(pool_p, view, to_device(write_tables, dev))
        return self._admit_rows(logits, pos1, slots, r_i32, r_f32)

    # ---- swap-parked resumes: restore with no prefill ------------- #
    def _admit_swapped(self, swaps: List[Request]):
        paged, resident = split_paged(self.cache)
        restored: List[Tuple[int, Request]] = []
        for req in swaps:
            handle = self._swapped[req.request_id]
            self._reclaim_shortfall(len(handle.host))
            res = swap_in_slot(self.pool, self.host_pool, paged, handle,
                               resident)
            if res is None:
                # slots or pages short right now: fall back to the
                # recompute resume so progress never livelocks on swap
                del self._swapped[req.request_id]
                drop_handle(self.pool, self.host_pool, handle)
                self.scheduler.requeue(req)
                continue
            slot, uploaded = res
            if uploaded:
                self.dispatches += 1        # the swap-in scatter
            del self._swapped[req.request_id]
            self.swap_ins += 1
            restored.append((slot, req))
        if not restored:
            return
        ecfg = self.ecfg
        n = len(restored)
        slots = np.zeros((n,), np.int64)
        # rows: last token, pos, budget, top_k, eos, chain seed
        r_i32 = np.zeros((6, n), np.int32)
        r_f32 = np.zeros((2, n), np.float32)   # temperature, top_p
        for i, (slot, req) in enumerate(restored):
            s = req.sampling
            slots[i] = slot
            r_i32[:, i] = (req.output[-1], self.pool.lengths[slot],
                           s.max_tokens - len(req.output),
                           s.top_k if s.top_k > 0 else ecfg.top_k,
                           s.eos_id,
                           req.output[-2] if len(req.output) >= 2
                           else list(req.prompt)[-1])
            r_f32[:, i] = (s.temperature,
                           s.top_p if s.top_p < 1.0 else ecfg.top_p)
            req.state = RequestState.DECODING
            self.slot_req[slot] = req
        self._restore_slots(slots, r_i32, r_f32)
        self.dispatches += 1

    def _restore_slots(self, slots, r_i32, r_f32):
        """Swap-in resume: rebuild the slots' decode state known on the
        host at park time — no model forward.  Queued on the device."""
        dev = self.device
        idx = to_device(slots, dev)
        ri = to_device(r_i32, dev)
        rf = to_device(r_f32, dev)
        self.last_tok[idx] = ri[0]
        self.pos[idx] = ri[1]
        self.active.index_fill_(0, idx, True)     # no upload (C19)
        self.remaining[idx] = ri[2]
        self.temps[idx] = rf[0]
        self.top_ks[idx] = ri[3]
        self.top_ps[idx] = rf[1]
        self.eos_ids[idx] = ri[4]
        self.spec_table.index_fill_(0, idx, -1)
        self.spec_prev[idx] = ri[5]

    def _decode_mode(self) -> str:
        """The cheapest decode program the current batch permits: the host
        knows every slot's sampling params, so sorts and random draws
        stay out unless needed."""
        sampling = [r.sampling for r in self.slot_req.values()
                    if r.sampling.temperature > 0]
        if not sampling:
            return "greedy"
        ecfg = self.ecfg
        if any(s.top_k > 0 or s.top_p < 1.0 or ecfg.top_k > 0
               or ecfg.top_p < 1.0 for s in sampling):
            return "full"
        return "temp"

    # ---- preemption: page exhaustion at a decode-block boundary --- #
    def _pick_victim(self) -> Optional[int]:
        """The slot whose tenant holds the lowest DWRR deficit, ties toward
        the request with the least progress (cheapest resume)."""
        if not self.slot_req:
            return None
        return min(self.slot_req.items(),
                   key=lambda kv: (self.scheduler.deficit(kv[1].tenant),
                                   len(kv[1].output), -kv[0]))[0]

    def _preempt(self, slot: int):
        """Evict `slot`: park its private pages in the host swap tier when
        one is attached (O(pages) moved, no prefill on resume), else
        refund its pages for the recompute resume (prompt + tokens so
        far).  Either way the request keeps every token it emitted and
        re-enters the front of its tenant queue."""
        req = self.slot_req.pop(slot)
        swapped = False
        if self.host_pool is not None:
            paged, resident = split_paged(self.cache)
            handle = swap_out_slot(self.pool, self.host_pool, paged, slot,
                                   resident)
            if handle is not None:
                self._swapped[req.request_id] = handle
                self.swap_outs += 1
                self.dispatches += 1    # the page gather
                self.host_syncs += 1    # one .cpu() moves the blocks
                swapped = True
        if not swapped:
            if self.prefix_cache is not None:
                # the recompute resume matches and binds again at admission
                self.prefix_cache.unbind(req.request_id)
            self.pool.release(slot)
        self.pool.preemptions += 1
        self.preemptions += 1
        self._release_device_slot(slot)
        self.scheduler.requeue(req)

    def _ensure_decode_pages(self):
        """Grow every active slot's pages to cover the next fused block,
        preempting lowest-deficit slots until the growth fits.  A lone
        slot that cannot grow takes pages back from the prefix cache
        instead: preempting it would park it and restore it into the same
        shortage forever (the JAX engine does; ROADMAP C8)."""
        if not self._paged:
            return
        k = self._growth
        for slot in sorted(self.slot_req):
            if slot not in self.slot_req:      # evicted by a prior pass
                continue
            target = min(self.pool.lengths[slot] + k, self.ecfg.max_len)
            while slot in self.slot_req \
                    and not self.pool.grow(slot, target):
                if len(self.slot_req) == 1 and self.prefix_cache is not None \
                        and self.prefix_cache.evictable_device_pages():
                    self._reclaim_shortfall(
                        self.pool.pages_for_tokens(target)
                        - len(self.pool.slot_pages[slot]))
                    continue
                victim = self._pick_victim()
                if victim is None:
                    break
                self._preempt(victim)

    # ---- decode: one fused K-step dispatch, one host sync --------- #
    def _decode_block(self) -> int:
        self._ensure_decode_pages()
        if not self.slot_req:
            return 0
        mode = self._decode_mode()
        spec = self._spec_ok and mode == "greedy"
        if spec:
            # one verify proposes and checks D drafts and emits up to
            # D + 1 tokens a slot, with the fused path's single host sync
            toks, emits, dones = self._spec_decode()
            self.spec_dispatches += 1
            self.logical_bytes_moved += \
                (self.ecfg.spec_draft + 1) * self._write_token_bytes
        else:
            toks, emits, dones = self._fused_decode(mode)
            if self._paged_attn:
                # page-table-direct: only the block's new KV is written
                self.logical_bytes_moved += \
                    self.ecfg.decode_block * self._write_token_bytes
            elif self._paged:
                # gather + scatter move every slot's full logical view
                self.logical_bytes_moved += 2 * self._view_bytes
        self.dispatches += 1
        self.decode_dispatches += 1
        host = torch.stack([toks, emits.to(torch.int32),
                            dones.to(torch.int32)]).cpu().numpy()
        self.host_syncs += 1
        toks_h, emit_h, done_h = host[0], host[1].astype(bool), \
            host[2].astype(bool)
        emitted = 0
        for slot, req in list(self.slot_req.items()):
            col = emit_h[:, slot]
            if not col.any():
                continue
            block = toks_h[:, slot][col].tolist()
            req.emit_many(block)
            self.pool.advance(slot, len(block))
            emitted += len(block)
            self.total_tokens += len(block)
            if spec:
                self.spec_emitted += len(block)
                # tokens beyond the first came from accepted drafts
                self.spec_slot_accepted[slot] += max(len(block) - 1, 0)
            if done_h[:, slot].any():
                req.finish()
                del self.slot_req[slot]
                self._finish_slot(slot, req)
        return emitted

    def _spec_decode(self):
        """One speculative step, greedy only: propose `spec_draft` tokens
        from each slot's bigram table, verify [last_tok, drafts] in one
        paged forward, and emit the longest prefix of drafts equal to the
        verifier's argmax plus the verifier's own next token — the tokens
        sequential greedy decoding emits.  Missing proposals (-1) go in as
        token 0 and are never accepted.  Nothing here waits on the
        device.  Returns (D + 1, n_slots) token, emit and done tensors."""
        self.spec_traces = 1          # one program, whatever the batch
        d = self.ecfg.spec_draft
        drafts = spec_lib.propose(self.spec_table, self.spec_prev,
                                  self.last_tok, d)
        x = torch.cat([self.last_tok[:, None], drafts.clamp_min(0)], dim=1)
        logits, _ = self.model.verify_paged(
            self._run_params(), self.cache, x, self.pos,
            self.pool.page_table(), self.pool.write_table())
        greedy = logits.argmax(-1).to(torch.int32)              # (B, D+1)
        n_acc = spec_lib.accept_length(drafts, greedy[:, :d])
        last, prev, pos = self.last_tok, self.spec_prev, self.pos
        active, remaining = self.active, self.remaining
        eos = self.eos_ids
        toks, emits, dones = [], [], []
        for i in range(d + 1):
            emit = active & (i <= n_acc)
            tok = torch.where(emit, greedy[:, i], last)
            remaining = torch.where(emit, remaining - 1, remaining)
            pos = pos + emit.to(torch.int32)
            done = emit & (((eos >= 0) & (tok == eos)) | (remaining <= 0)
                           | (pos >= self._pos_limit))
            # the table learns each emitted transition on the device
            spec_lib.record(self.spec_table, prev, last, tok, emit)
            prev = torch.where(emit, last, prev)
            last = tok
            active = active & ~done
            toks.append(tok)
            emits.append(emit)
            dones.append(done)
        # rebound, not copied into: `emits[0]` reads the old `active`
        self.last_tok, self.spec_prev, self.pos = last, prev, pos
        self.active, self.remaining = active, remaining
        return torch.stack(toks), torch.stack(emits), torch.stack(dones)

    def _fused_decode(self, mode: str):
        """`decode_block` decode+sample steps queued back to back; no
        statement here waits on the device.  Returns (K, n_slots) token,
        emit and done tensors."""
        if mode not in self._decode_programs:
            self._decode_programs.add(mode)
            self.decode_traces += 1
        params = self._run_params()
        page_table = self.pool.page_table()
        write_table = self.pool.write_table()
        gather = self._paged and not self._paged_attn
        if gather:
            # one gather per dispatch materializes every slot's view; the
            # slot-resident leaves are their own view, advanced in place
            pool_p, pool_r = split_paged(self.cache)
            view = {**gather_pages(pool_p, page_table), **pool_r}
        else:
            view = self.cache
        last_tok, pos = self.last_tok, self.pos
        active, remaining = self.active, self.remaining
        eos = self.eos_ids
        toks, emits, dones = [], [], []
        for _ in range(self.ecfg.decode_block):
            if self._paged_attn:
                logits, _ = self.model.decode_paged(
                    params, view, last_tok, pos, page_table, write_table)
            else:
                logits, _ = self.model.decode(params, view, last_tok, pos)
            if mode == "greedy":
                sampled = logits.argmax(-1).to(torch.int32)
            else:
                sampled = sample_batched(
                    logits, self._gen, self.temps, self.top_ks, self.top_ps,
                    use_top_k=(mode == "full"), use_top_p=(mode == "full"))
            tok = torch.where(active, sampled, last_tok)
            emit = active
            remaining = torch.where(active, remaining - 1, remaining)
            pos = pos + active.to(torch.int32)
            done = active & (((eos >= 0) & (tok == eos))
                             | (remaining <= 0)
                             # out of cache positions: the next write
                             # would fall past max_len
                             | (pos >= self._pos_limit))
            active = active & ~done
            last_tok = tok
            toks.append(tok)
            emits.append(emit)
            dones.append(done)
        if gather:
            # one scatter per dispatch lands the block's writes back in
            # the pool, through the write table
            scatter_pages(pool_p, view, write_table)
        # the slot state stays on the device for the next dispatch; it is
        # rebound, not copied into, because `emits[0]` is the old `active`
        self.last_tok, self.pos = last_tok, pos
        self.active, self.remaining = active, remaining
        return torch.stack(toks), torch.stack(emits), torch.stack(dones)

    def _run_params(self) -> Params:
        """The params a dispatch runs with: as given, the int8 kernel
        operands built at init, or (int4) the whole tree dequantized, once
        per dispatch as in JAX."""
        if self._int8 is not None:
            return self._int8
        if self.ecfg.quantize:
            return q_lib.dequant_tree(self.params)
        return self.params

    def run_until_done(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.slot_req or self.scheduler.depth) and \
                steps < max_steps:
            self.step()
            steps += 1
        return steps

    # ---- hierarchical KV memory: admin / autoscaler surface ------- #
    def flush_prefix_cache(self) -> Dict[str, int]:
        """Drop every unpinned prefix-cache entry of both tiers."""
        if self.prefix_cache is None:
            return {"flushed": 0, "remaining": 0}
        return self.prefix_cache.flush()

    def page_pressure(self) -> float:
        """Fraction of the device page budget committed to live work:
        cache pages the engine could reclaim on demand are netted out, so
        a warm but evictable prefix cache never reads as pressure."""
        if not self._paged or self.pool.n_pages == 0:
            return 0.0
        in_use = self.pool.pages_in_use
        if self.prefix_cache is not None:
            in_use -= self.prefix_cache.evictable_device_pages()
        return max(in_use, 0) / self.pool.n_pages

    def memory_report(self) -> Dict[str, int]:
        """Device bytes the engine holds: the weights at rest, what the
        int8 kernel operands add beside them (storage the at-rest tree
        does not share: dequantized leaves, expanded scales), and the
        cache (page pools with their scratch page, or strips, and any
        slot-resident state).  Their sum is what placement charges
        (`cluster.node.instance_bytes`)."""
        return {"param_bytes": q_lib.tree_bytes(self.params),
                "operand_bytes": (_unshared_bytes(self._int8, self.params)
                                  if self._int8 is not None else 0),
                "cache_bytes": cache_bytes(self.cache)}

    def perf_stats(self) -> Dict[str, Any]:
        """Dispatch/sync discipline counters plus the paged-pool metrics."""
        t = max(self.total_tokens, 1)
        stats = {
            "tokens": self.total_tokens,
            "steps": self.total_steps,
            "dispatches": self.dispatches,
            "host_syncs": self.host_syncs,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "dispatches_per_token": self.dispatches / t,
            "host_syncs_per_token": self.host_syncs / t,
            "prefill_traces": self.prefill_traces,
            "prefill_shapes": sorted(self._prefill_programs),
            "decode_traces": self.decode_traces,
            "decode_block": self.ecfg.decode_block,
            "paged": self._paged,
            "paged_attention": self._paged_attn,
            "speculative": self._spec_ok,
            "logical_bytes_moved": self.logical_bytes_moved,
            "logical_bytes_moved_per_token": self.logical_bytes_moved / t,
            "spec_traces": self.spec_traces,
            "spec_dispatches": self.spec_dispatches,
            "spec_emitted": self.spec_emitted,
            "spec_accepted_per_dispatch": (
                self.spec_emitted / self.spec_dispatches
                if self.spec_dispatches else 0.0),
            "spec_slot_accepted": self.spec_slot_accepted.tolist(),
            "preemptions": self.preemptions,
            "queue_enqueued": self.scheduler.enqueued_total,
            "queue_dequeued": self.scheduler.dequeued_total,
            "queue_requeued": self.scheduler.requeued_total,
            "queue_rejected": self.scheduler.rejected,
            "pending_pages": self.scheduler.pending_pages,
            "suffix_traces": self.suffix_traces,
            "suffix_prefills": self.suffix_prefills,
            "prefill_dispatch_tokens": self.prefill_dispatch_tokens,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swapped_requests": len(self._swapped),
            "cache_hit_rate": (self.prefix_cache.hit_rate()
                               if self.prefix_cache is not None else 0.0),
            "host_pages": (self.host_pool.n_pages
                           if self.host_pool is not None else 0),
            "host_pages_in_use": (self.host_pool.in_use
                                  if self.host_pool is not None else 0),
        }
        if self.prefix_cache is not None:
            stats["prefix_cache"] = self.prefix_cache.stats()
        stats.update(self.pool.page_stats())
        return stats
