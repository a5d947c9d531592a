"""Continuous-batching inference engine on the card — the counterpart of
`repro.serving.engine.InferenceEngine` in its paged-attention mode.

Each `step()` issues at most two dispatches, each ending in exactly one
host sync:

* **bucketed prefill** — queued prompts are right-padded to a power-of-two
  length bucket and admitted as one batch (padded to a power-of-two row
  count).  The forward runs the flash kernel, every row's KV lands in its
  pages, the first token per row is sampled on the device, and the
  persistent per-slot state tensors are updated in place.  One `.cpu()`
  brings back the first tokens and done flags.
* **fused K-step decode** — `decode_block` decode+sample steps run back to
  back on the device against the paged pool (the paged decode kernel),
  with per-slot sampling params and an on-device done mask (EOS, token
  budget, cache end).  Nothing in the K-step loop waits on the device;
  the (K, n_slots) token / emit / done blocks come back with one `.cpu()`.

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
from repro_torch.params import Params, param_bytes
from repro_torch.serving.kv_cache import (PagedKVPool, cache_bytes,
                                          new_pools, scatter_prefill_rows,
                                          to_device)
from repro_torch.serving.request import (CODE_ENGINE_FAILED,
                                         CODE_INVALID_REQUEST, Request,
                                         RequestState)
from repro_torch.serving.sampler import sample_batched
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_len: int = 128
    quantize: str = ""            # not ported yet (ROADMAP.md A4)
    top_k: int = 0                # engine-wide default (per-request wins)
    top_p: float = 1.0
    seed: int = 0
    decode_block: int = 4         # K decode steps fused per dispatch
    prefill_bucket_min: int = 8   # smallest power-of-two prompt bucket
    page_size: int = 16           # KV tokens per physical page
    kv_pages: int = 0             # page budget; 0 => n_slots full strips
    paged: bool = True            # False (contiguous strips): ROADMAP A4
    prefix_cache: bool = False    # not ported yet (ROADMAP.md A4)
    host_kv_pages: int = 0        # not ported yet (ROADMAP.md A4)
    # True by default here (False in the JAX engine): attending straight
    # through the page table is the only decode mode this port has; the
    # gather mode, which copies each slot's view out and back per
    # dispatch, is queued in ROADMAP.md A4
    paged_attention: bool = True
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
    if ecfg.quantize:
        out.append(f"quantize={ecfg.quantize!r}")
    if not ecfg.paged:
        out.append("paged=False")
    if not ecfg.paged_attention:
        out.append("paged_attention=False (the gather decode mode)")
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
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.model = build(cfg, self.device)
        self.params = _to(params, self.device)
        self.scheduler = scheduler or Scheduler(SchedulerConfig())
        self._dead = False
        self._gen = generator_for(self.device, engine_cfg.seed)
        self._pos_limit = engine_cfg.max_len
        self.pool = PagedKVPool(engine_cfg.n_slots, engine_cfg.max_len,
                                page_size=engine_cfg.page_size,
                                n_pages=engine_cfg.kv_pages,
                                device=self.device)
        # page-aware admission: the scheduler charges each queued request
        # its projected page cost against the engine's free page budget
        self.scheduler.pages_for = self._pages_for
        self.cache = new_pools(cfg.n_layers, self.pool.n_pages,
                               self.pool.page_size, cfg.n_kv_heads,
                               cfg.head_dim, torch_dtype(cfg.dtype),
                               self.device)
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
        # all-slot KV bytes one decode step writes into the pool
        self._write_token_bytes = (2 * ns * cfg.n_layers * cfg.n_kv_heads
                                   * cfg.head_dim * self.cache["k"]
                                   .element_size())
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
        self.logical_bytes_moved = 0       # KV bytes written per decode
        self._prefill_programs: Set[Tuple[int, int]] = set()
        self._decode_programs: Set[str] = set()

    def _pages_for(self, req: Request) -> int:
        """Projected page cost of admitting `req` now: its full context
        (prompt + tokens already generated) plus one position of decode
        headroom."""
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
            slot = self.pool.alloc(req.request_id,
                                   len(req.prompt) + len(req.output))
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
        """The admission program: forward, page scatter, first-token
        sample and the slot-state update, all queued on the device.
        Padded batch rows are dropped here on the host (`slots` holds only
        the admitted rows), where JAX scatters them to slot == n_slots
        with mode="drop"."""
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
            self.params, tokens, lengths=to_device(lengths, dev))
        scatter_prefill_rows(self.cache, rows, row_pages)
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
        self.logical_bytes_moved += \
            self.ecfg.decode_block * self._write_token_bytes
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
        page_table = self.pool.page_table()
        write_table = self.pool.write_table()
        last_tok, pos = self.last_tok, self.pos
        active, remaining = self.active, self.remaining
        eos = self.eos_ids
        toks, emits, dones = [], [], []
        for _ in range(self.ecfg.decode_block):
            logits, _ = self.model.decode_paged(
                self.params, self.cache, last_tok, pos, page_table,
                write_table)
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
        # the slot state stays on the device for the next dispatch; it is
        # rebound, not copied into, because `emits[0]` is the old `active`
        self.last_tok, self.pos = last_tok, pos
        self.active, self.remaining = active, remaining
        return torch.stack(toks), torch.stack(emits), torch.stack(dones)

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
        if self.pool.n_pages == 0:
            return 0.0
        return self.pool.pages_in_use / self.pool.n_pages

    def memory_report(self) -> Dict[str, int]:
        return {"param_bytes": param_bytes(self.params),
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
            "paged": True,
            "paged_attention": True,
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
