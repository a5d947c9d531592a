"""Continuous-batching inference engine on the card — the counterpart of
`repro.serving.engine.InferenceEngine` for dense causal decoders.

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
from repro_torch.params import Params
from repro_torch.serving import quantization as q_lib
from repro_torch.serving.kv_cache import (PagedKVPool, cache_bytes,
                                          gather_pages, new_pools,
                                          scatter_pages,
                                          scatter_prefill_rows, split_paged,
                                          to_device, write_slots)
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
    prefix_cache: bool = False    # not ported yet (ROADMAP.md A4)
    host_kv_pages: int = 0        # not ported yet (ROADMAP.md A4)
    paged_attention: bool = False  # attend through the page table (no
    #                                per-dispatch gather/scatter copy)
    speculative: bool = False     # not ported yet (ROADMAP.md A4)


class EngineFailure(RuntimeError):
    pass


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _unsupported(ecfg: EngineConfig) -> List[str]:
    out = []
    if ecfg.prefix_cache:
        out.append("prefix_cache")
    if ecfg.host_kv_pages:
        out.append("host_kv_pages")
    if ecfg.speculative:
        out.append("speculative")
    return out


def _to(params: Params, device: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


class InferenceEngine:
    """One model instance on one card (or on the CPU when `device="cpu"`
    is passed, through the kernels' plain versions)."""

    def __init__(self, cfg: ArchConfig, params: Params,
                 engine_cfg: EngineConfig,
                 scheduler: Optional[Scheduler] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        missing = _unsupported(engine_cfg)
        if missing:
            raise NotImplementedError(
                f"engine features not ported yet (ROADMAP.md A4): "
                f"{', '.join(missing)}")
        if engine_cfg.quantize not in ("", "int8", "int4"):
            raise ValueError(f"quantize={engine_cfg.quantize!r}: "
                             "'', 'int8' or 'int4'")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.model = build(cfg, self.device)
        self.scheduler = scheduler or Scheduler(SchedulerConfig())
        self._dead = False
        self._gen = generator_for(self.device, engine_cfg.seed)
        self._pos_limit = engine_cfg.max_len
        self._paged = engine_cfg.paged
        self._paged_attn = engine_cfg.paged_attention and self._paged
        self.pool = PagedKVPool(engine_cfg.n_slots, engine_cfg.max_len,
                                page_size=engine_cfg.page_size,
                                n_pages=(engine_cfg.kv_pages
                                         if self._paged else 0),
                                device=self.device)
        # page-aware admission: the scheduler charges each queued request
        # its projected page cost against the engine's free page budget
        self.scheduler.pages_for = self._pages_for
        # weights at rest: as given, or quantized (what memory_report
        # counts); int8 also builds its kernel operands here, once
        self.params = _to(params, self.device)
        self._int8 = None
        if engine_cfg.quantize:
            self.params = q_lib.quantize_tree(
                self.params, bits=8 if engine_cfg.quantize == "int8" else 4)
            if engine_cfg.quantize == "int8":
                self._int8 = q_lib.int8_operands(self.params)
        dt = torch_dtype(cfg.dtype)
        if self._paged:
            self.cache = new_pools(cfg.n_layers, self.pool.n_pages,
                                   self.pool.page_size, cfg.n_kv_heads,
                                   cfg.head_dim, dt, self.device)
        else:
            shape = (cfg.n_layers, engine_cfg.n_slots, engine_cfg.max_len,
                     cfg.n_kv_heads, cfg.head_dim)
            self.cache = {name: torch.zeros(shape, dtype=dt,
                                            device=self.device)
                          for name in ("k", "v")}
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
        # metrics
        self.total_tokens = 0
        self.total_steps = 0
        self.step_ewma_s = 0.0
        self.dispatches = 0       # device programs issued
        self.prefill_dispatches = 0   # of which bucketed prefills
        self.decode_dispatches = 0    # of which fused K-step decodes
        self.host_syncs = 0       # blocking device->host transfers
        self.prefill_traces = 0   # distinct prefill programs (pad_n, bucket)
        self.decode_traces = 0    # distinct decode programs (modes)
        self.preemptions = 0      # slots evicted on page exhaustion
        self.prefill_dispatch_tokens = 0   # rows x bucket actually forwarded
        self.logical_bytes_moved = 0       # KV bytes copied/written
        self._prefill_programs: Set[Tuple[int, int]] = set()
        self._decode_programs: Set[str] = set()

    def _pages_for(self, req: Request) -> int:
        """Projected page cost of admitting `req` now: its full context
        (prompt + tokens already generated) plus one position of decode
        headroom; a contiguous strip always costs `max_len`."""
        if not self._paged:
            return self.pool.pages_per_slot
        eff = len(req.prompt) + len(req.output)
        return self.pool.pages_for_tokens(min(eff + 1, self.ecfg.max_len))

    def _bucket_of(self, prompt_len: int) -> int:
        """Power-of-two padded length bucket, capped at max_len."""
        b = self.ecfg.prefill_bucket_min
        while b < prompt_len:
            b <<= 1
        return min(b, self.ecfg.max_len)

    # ------------------------------------------------------------- #
    def submit(self, req: Request) -> bool:
        if self._dead:
            req.finish(error="engine dead", code=CODE_ENGINE_FAILED)
            return False
        if len(req.prompt) > self.ecfg.max_len:
            # malformed input, not a capacity problem: reject at submit
            req.finish(
                error=(f"prompt length {len(req.prompt)} exceeds engine "
                       f"max_len {self.ecfg.max_len}"),
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
            return "queued"
        for slot, req in list(self.slot_req.items()):
            if req.request_id == request_id:
                del self.slot_req[slot]
                self.pool.release(slot)
                self._release_device_slot(slot)
                return "active"
        return False

    def _release_device_slot(self, slot: int):
        """Zero the slot's device state so the next fused dispatch can't
        decode or sample it with stale values."""
        self.last_tok[slot] = 0
        self.pos[slot] = 0
        self.active[slot] = False
        self.remaining[slot] = 0
        self.temps[slot] = 0.0
        self.dispatches += 1

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
            target = min(self.pool.lengths[slot] + self.ecfg.decode_block,
                         self.ecfg.max_len)
            debt += max(self.pool.pages_for_tokens(target)
                        - len(self.pool.slot_pages[slot]), 0)
        return debt

    def _admit(self):
        budget = len(self.pool.free_pages) - self._decode_page_debt()
        group = self.scheduler.next_prefill_bucket(
            len(self.pool.free_slots), self._bucket_of,
            free_pages=max(budget, 0))
        if group:
            self._admit_prefill(group)

    def _admit_prefill(self, group: List[Request]):
        admitted: List[Tuple[int, Request]] = []
        for req in group:
            slot = self.pool.alloc(
                req.request_id, len(req.prompt) + len(req.output),
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
        n_row_pages = self.pool.pages_for_tokens(bucket)
        pad_n = _next_pow2(n)
        toks = np.zeros((pad_n, bucket), np.int64)
        lengths = np.ones((pad_n,), np.int32)
        row_pages = np.full((pad_n, n_row_pages), self.pool.n_pages,
                            np.int32)              # sentinel => dropped
        slots = np.zeros((n,), np.int64)
        r_i32 = np.zeros((3, pad_n), np.int32)     # top_k, eos, budget
        r_f32 = np.zeros((2, pad_n), np.float32)   # temperature, top_p
        r_f32[1] = 1.0
        r_i32[1] = -1
        r_i32[2] = 1
        for i, (slot, req) in enumerate(admitted):
            prompt = list(req.prompt) + list(req.output)   # resume ctx
            toks[i, :len(prompt)] = prompt
            lengths[i] = len(prompt)
            slots[i] = slot
            row_pages[i] = self.pool.row_pages(slot, n_row_pages)
            s = req.sampling
            r_f32[0, i] = s.temperature
            r_f32[1, i] = s.top_p if s.top_p < 1.0 else ecfg.top_p
            r_i32[0, i] = s.top_k if s.top_k > 0 else ecfg.top_k
            r_i32[1, i] = s.eos_id
            r_i32[2, i] = s.max_tokens - len(req.output)
        first, done0 = self._prefill_admit(toks, lengths, row_pages, slots,
                                           r_i32, r_f32)
        self.dispatches += 1
        self.prefill_dispatches += 1
        self.prefill_dispatch_tokens += pad_n * bucket
        host = torch.stack([first, done0.to(torch.int32)]).cpu().numpy()
        self.host_syncs += 1
        self._post_admit(admitted, host[0], host[1])

    def _prefill_admit(self, toks, lengths, row_pages, slots, r_i32, r_f32):
        """The admission program: forward, the rows' KV into their pages
        (or, contiguous, into the first `bucket` positions of their
        strips; positions past `pos` keep what was there, where JAX
        zeroes them, and are masked), first-token sample and the
        slot-state update, all queued on the device.  Padded batch rows
        are dropped here on the host (`slots` holds only the admitted
        rows), where JAX scatters them to slot == n_slots with
        mode="drop"."""
        if toks.shape not in self._prefill_programs:
            self._prefill_programs.add(toks.shape)
            self.prefill_traces += 1
        dev = self.device
        tokens = to_device(toks, dev)
        ri = to_device(r_i32, dev)
        rf = to_device(r_f32, dev)
        r_topk, r_eos, r_budget = ri[0], ri[1], ri[2]
        r_temps, r_topp = rf[0], rf[1]
        logits, rows, pos1 = self.model.prefill(
            self._run_params(), tokens, lengths=to_device(lengths, dev))
        if self._paged:
            scatter_prefill_rows(self.cache, rows, row_pages)
        else:
            write_slots(self.cache, rows, slots)
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
        self.pool.release(slot)

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
        """Evict `slot`: refund its pages and requeue the request at the
        front of its tenant queue; it resumes by recomputing prompt +
        tokens so far, keeping every token it emitted."""
        req = self.slot_req.pop(slot)
        self.pool.release(slot)
        self.pool.preemptions += 1
        self.preemptions += 1
        self._release_device_slot(slot)
        self.scheduler.requeue(req)

    def _ensure_decode_pages(self):
        """Grow every active slot's pages to cover the next fused block,
        preempting lowest-deficit slots until the growth fits."""
        if not self._paged:
            return
        k = self.ecfg.decode_block
        for slot in sorted(self.slot_req):
            if slot not in self.slot_req:      # evicted by a prior pass
                continue
            target = min(self.pool.lengths[slot] + k, self.ecfg.max_len)
            while slot in self.slot_req \
                    and not self.pool.grow(slot, target):
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
            if done_h[:, slot].any():
                req.finish()
                del self.slot_req[slot]
                self._finish_slot(slot, req)
        return emitted

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
            # one gather per dispatch materializes every slot's view
            pool_p, _ = split_paged(self.cache)
            view = gather_pages(pool_p, page_table)
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

    # ------------------------------------------------------------- #
    def page_pressure(self) -> float:
        """Fraction of the device page budget committed to live work."""
        if not self._paged or self.pool.n_pages == 0:
            return 0.0
        return self.pool.pages_in_use / self.pool.n_pages

    def memory_report(self) -> Dict[str, int]:
        return {"param_bytes": q_lib.tree_bytes(self.params),
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
            "logical_bytes_moved": self.logical_bytes_moved,
            "logical_bytes_moved_per_token": self.logical_bytes_moved / t,
            "preemptions": self.preemptions,
            "queue_enqueued": self.scheduler.enqueued_total,
            "queue_dequeued": self.scheduler.dequeued_total,
            "queue_requeued": self.scheduler.requeued_total,
            "queue_rejected": self.scheduler.rejected,
            "pending_pages": self.scheduler.pending_pages,
            "prefill_dispatch_tokens": self.prefill_dispatch_tokens,
        }
        stats.update(self.pool.page_stats())
        return stats
