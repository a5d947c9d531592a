"""Backend node agent — one heterogeneous Service-Backend node.

A node hosts multiple model *instances* (engines) packed into its HBM by the
SDAI controller.  Small models run REAL engines; large configs run in
`accounted` mode (exact byte accounting + analytic latency from the node's
capability vector) so thousand-node fleets stay simulable on one host.  Each
node also runs its own replica proxy (`NodeProxy` in core/frontend.py),
mirroring the paper's per-node HAProxy.

This file differs from `repro.cluster.node` in one place: `BackendNode`
takes the `device` its engines run on and passes it to `InferenceEngine`.
`None` means the card, as at every entry point of the port (it raises
where there is none); the CPU tests pass "cpu".  Every engine of a process
runs on the current stream of that device.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from repro_torch.cluster.hardware import (NODE_CLASSES,
                                          RUNTIME_RESERVE_FRACTION, NodeClass)
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.serving.engine import (EngineConfig, EngineFailure,
                                        InferenceEngine)
from repro_torch.serving.request import CODE_ENGINE_FAILED, Request

_inst_ids = itertools.count()


def kv_pool_bytes(cfg: ArchConfig, n_slots: int, max_len: int,
                  page_size: int = 0, kv_pages: int = 0) -> int:
    """KV/state bytes one instance's cache pool occupies.  With a page
    budget (`page_size` x `kv_pages`), the sequence-scaling KV term is
    charged per *page*, not per worst-case `n_slots x max_len` strip —
    the whole point of the paged pool; constant-size per-slot state
    (recurrent/ssm, encoder cross-attention) still scales with slots."""
    dense = cfg.cache_bytes(n_slots, max_len)
    if not (page_size and kv_pages) or cfg.block == "xlstm":
        return int(dense)
    eff = max_len if cfg.swa_window == 0 else min(max_len, cfg.swa_window)
    dense_kv = n_slots * eff * cfg.kv_bytes_per_token()
    paged_kv = kv_pages * page_size * cfg.kv_bytes_per_token()
    return int(dense - dense_kv + paged_kv)


@functools.lru_cache(maxsize=4096)
def instance_bytes(cfg: ArchConfig, quantize: str, n_slots: int,
                   max_len: int, page_size: int = 0,
                   kv_pages: int = 0) -> int:
    """Exact HBM bytes one instance occupies: weights at rest + KV pool
    (page-budget-sized when `page_size`/`kv_pages` are given).  This is
    the quantity placement charges — the paper's 'model capacity' panel
    (VRAM required per instance).  Cached: placement calls this per
    (bin x commit) across thousand-node fleets."""
    wdt = {"": cfg.dtype, "int8": "int8", "int4": "int4"}[quantize]
    w = cfg.param_bytes(wdt)
    kv = kv_pool_bytes(cfg, n_slots, max_len, page_size, kv_pages)
    return int(w + kv)


@dataclasses.dataclass
class Instance:
    instance_id: int
    model_name: str
    cfg: ArchConfig
    quantize: str
    n_slots: int
    max_len: int
    bytes: int
    engine: Optional[InferenceEngine] = None     # None => accounted mode
    page_size: int = 0
    kv_pages: int = 0
    # accounted-mode synthetic state
    sim_active: int = 0
    # per-instance step lock: the sharded pump executor steps instances
    # concurrently, so engine mutation (step/cancel/fail/retire) is
    # serialized here instead of on the whole-node lock
    lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    @property
    def alive(self) -> bool:
        return self.engine.alive if self.engine else True

    @property
    def load(self) -> float:
        return self.engine.load if self.engine else float(self.sim_active)


class BackendNode:
    def __init__(self, node_id: str, klass: str,
                 param_store=None, seed: int = 0,
                 device: DeviceLike = None):
        self.node_id = node_id
        self.device = device
        self.klass: NodeClass = NODE_CLASSES[klass]
        self.instances: Dict[int, Instance] = {}
        self.param_store = param_store          # model name -> params fn
        self._alive = True
        self._seed = seed
        self.last_heartbeat = time.monotonic()
        # chaos harness hook (repro.cluster.faults.FaultInjector); None
        # in production.  Consulted at the pump/submit/heartbeat
        # boundaries so faults land at exact, reproducible step counts.
        self.faults = None
        # `lock` guards node structure (the instances map, alive flag);
        # engine mutation is serialized per-instance on `Instance.lock`
        # (always acquired *after* the node lock, never before — no
        # ordering cycle).  `work_cv` is a *separate* light lock so
        # submitters can wake this node's pump thread without contending
        # on a running step — and, crucially, so a pump thread that
        # re-routes a dying request to another node mid-step never waits
        # on that node's big lock.
        self.lock = threading.RLock()
        self.work_cv = threading.Condition(threading.Lock())
        # sharded executor: created lazily the first time this node pumps
        # more than one live engine, so multi-instance nodes overlap
        # their fused-decode dispatches instead of stepping serially
        self._executor: Optional[ThreadPoolExecutor] = None
        self._executor_size = 0

    # ------------------------------------------------------------- #
    @property
    def hbm_budget(self) -> int:
        return int(self.klass.hbm_total * (1 - RUNTIME_RESERVE_FRACTION))

    @property
    def hbm_used(self) -> int:
        return sum(i.bytes for i in self.instances.values())

    @property
    def hbm_free(self) -> int:
        return self.hbm_budget - self.hbm_used

    @property
    def alive(self) -> bool:
        return self._alive

    def utilization(self) -> float:
        return self.hbm_used / float(self.hbm_budget)

    # ------------------------------------------------------------- #
    def discovery_payload(self) -> Dict:
        """What the node reports during the controller's discovery phase."""
        return {
            "node_id": self.node_id,
            "class": self.klass.name,
            "chips": self.klass.chips,
            "hbm_total": self.klass.hbm_total,
            "hbm_budget": self.hbm_budget,
            "flops_total": self.klass.flops_total,
            "toolkit": self.klass.toolkit,
            "year": self.klass.year,
            "legacy": self.klass.legacy,
            "preloaded": [i.model_name for i in self.instances.values()],
        }

    def heartbeat(self) -> Optional[Dict]:
        if not self._alive:
            return None
        if self.faults is not None \
                and self.faults.heartbeat_muted(self.node_id):
            # silent heartbeat loss: the process is up and serving, but
            # the control plane hears nothing — the zombie case the
            # controller must fence before re-routing
            return None
        self.last_heartbeat = time.monotonic()
        return {
            "node_id": self.node_id,
            "hbm_used": self.hbm_used,
            "instances": {
                i.instance_id: {"model": i.model_name, "alive": i.alive,
                                "load": i.load}
                for i in self.instances.values()},
            "ts": self.last_heartbeat,
        }

    # ------------------------------------------------------------- #
    def deploy(self, cfg: ArchConfig, *, quantize: str = "",
               n_slots: int = 4, max_len: int = 128,
               real: bool = True, decode_block: int = 4,
               page_size: int = 16, kv_pages: int = 0,
               paged: bool = True, prefix_cache: bool = False,
               prefix_cache_pages: int = 0, host_kv_pages: int = 0,
               prefix_share_tenants: bool = False,
               paged_attention: bool = False,
               speculative: bool = False,
               spec_draft: int = 4) -> Instance:
        """Launch one model instance (the controller's startup-script
        analogue).  `kv_pages` sizes the paged KV pool (0 => the
        contiguous-equivalent budget); HBM is charged by page budget, not
        worst-case strips.  Raises MemoryError when it would not fit —
        placement should never let that happen (property-tested)."""
        pages_per_slot = -(-max_len // page_size)
        eff_pages = kv_pages if (paged and cfg.block != "xlstm") \
            and kv_pages else n_slots * pages_per_slot
        need = instance_bytes(cfg, quantize, n_slots, max_len,
                              page_size, eff_pages)
        if need > self.hbm_free:
            raise MemoryError(
                f"{self.node_id}: {cfg.name} needs {need/2**30:.2f} GiB, "
                f"free {self.hbm_free/2**30:.2f} GiB")
        engine = None
        if real:
            params = self.param_store(cfg) if self.param_store else None
            if params is None:
                real = False
            else:
                engine = InferenceEngine(
                    cfg, params,
                    EngineConfig(n_slots=n_slots, max_len=max_len,
                                 quantize=quantize, seed=self._seed,
                                 decode_block=decode_block,
                                 page_size=page_size, kv_pages=kv_pages,
                                 paged=paged, prefix_cache=prefix_cache,
                                 prefix_cache_pages=prefix_cache_pages,
                                 host_kv_pages=host_kv_pages,
                                 prefix_share_tenants=prefix_share_tenants,
                                 paged_attention=paged_attention,
                                 speculative=speculative,
                                 spec_draft=spec_draft),
                    device=self.device)
        inst = Instance(next(_inst_ids), cfg.name, cfg, quantize, n_slots,
                        max_len, need, engine, page_size=page_size,
                        kv_pages=eff_pages)
        with self.lock:
            self.instances[inst.instance_id] = inst
        return inst

    def undeploy(self, instance_id: int):
        with self.lock:
            self.instances.pop(instance_id, None)

    # ------------------------------------------------------------- #
    def submit(self, instance_id: int, req: Request) -> bool:
        """Enqueue a request on one of this node's engines.  Deliberately
        lock-free on `self.lock`: real-engine submits only touch the
        engine's internally-locked scheduler queue, so a pump thread
        re-routing a request here mid-step can never deadlock across
        nodes.  Wakes this node's pump thread on success."""
        if not self._alive:
            req.finish(error=f"node {self.node_id} down",
                       code=CODE_ENGINE_FAILED)
            return False
        if self.faults is not None \
                and self.faults.submit_blocked(self.node_id):
            # transient submit flap (dropped RPC): refuse without dying,
            # the frontend's retry loop fails over to the next replica
            req.finish(error=f"node {self.node_id} dropped the submit",
                       code=CODE_ENGINE_FAILED)
            return False
        inst = self.instances.get(instance_id)
        if inst is None:
            req.finish(error="instance gone", code=CODE_ENGINE_FAILED)
            return False
        req.node = self.node_id
        req.replica = str(instance_id)
        if inst.engine:
            ok = inst.engine.submit(req)
            if ok:
                self.notify_work()
            return ok
        # accounted mode: synthetic tokens through the same emit/finish
        # streaming path as real engines, honoring sampling.max_tokens
        inst.sim_active += 1
        for t in range(max(req.sampling.max_tokens, 0)):
            tok = (req.request_id + t) % max(inst.cfg.vocab, 1)
            req.emit(tok)
            if req.sampling.eos_id >= 0 and tok == req.sampling.eos_id:
                break
        req.finish()
        inst.sim_active -= 1
        return True

    def cancel(self, instance_id: int, request_id: int):
        """Abort a request on one of this node's engines (frees its slot
        and pages).  Takes the instance lock: cancellation rewrites
        per-slot device state and must not interleave with that engine's
        fused-decode step.  Returns the engine's verdict — "queued"
        (never admitted; the gateway refunds the tenant's token-bucket
        charge), "active", or False."""
        inst = self.instances.get(instance_id)
        if inst is None or inst.engine is None:
            return False
        with inst.lock:
            return inst.engine.cancel(request_id)

    # ------------------------------------------------------------- #
    def has_work(self) -> bool:
        """Any engine with active slots or queued requests."""
        if not self._alive:
            return False
        return any(inst.engine is not None and inst.engine.alive
                   and (inst.engine.slot_req or inst.engine.scheduler.depth)
                   for inst in list(self.instances.values()))

    def notify_work(self):
        """Wake this node's pump thread (no-op without a runtime)."""
        with self.work_cv:
            self.work_cv.notify_all()

    def _step_instance(self, inst: Instance, max_steps: int) -> int:
        """Advance one engine under its own lock (the sharded executor's
        unit of work)."""
        emitted = 0
        with inst.lock:
            eng = inst.engine
            if eng is None or not eng.alive:
                return 0
            for _ in range(max_steps):
                if eng.slot_req or eng.scheduler.depth:
                    try:
                        emitted += eng.step()
                    except EngineFailure:
                        break            # failed under us mid-loop
        return emitted

    def _get_executor(self, n: int) -> ThreadPoolExecutor:
        # under the node lock: recover() tears the pool down concurrently
        want = min(max(n, 1), 4)
        with self.lock:
            if self._executor is not None and self._executor_size < want:
                # the node grew (elastic scale-up): re-size so new
                # instances actually overlap.  Safe: pump() waits on
                # every future, so the old pool is idle here.
                self._executor.shutdown(wait=False)
                self._executor = None
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=want,
                    thread_name_prefix=f"step-{self.node_id}")
                self._executor_size = want
            return self._executor

    def pump(self, max_steps: int = 1) -> int:
        """Advance all engines (the node's serving loop).  Multi-instance
        nodes step their engines concurrently through a small per-node
        thread pool (one fused dispatch per instance overlaps on device);
        single-instance nodes step inline, paying no executor overhead.
        Returns decode tokens emitted, so pump loops can tell progress
        from idling."""
        if not self._alive:
            return 0
        if self.faults is not None:
            # the chaos clock ticks at pump boundaries: due faults fire
            # here (crash, hang, slow, window transitions) so every
            # injected failure lands at an exact, reproducible step
            self.faults.on_step(self)
            if not self._alive:        # the due fault crashed this node
                return 0
        with self.lock:
            insts = [i for i in self.instances.values()
                     if i.engine is not None and i.engine.alive]
        if not insts:
            return 0
        if len(insts) == 1:
            return self._step_instance(insts[0], max_steps)
        ex = self._get_executor(len(insts))
        futs = [ex.submit(self._step_instance, i, max_steps)
                for i in insts]
        return sum(f.result() for f in futs)

    # ------------------------------------------------------------- #
    def fail(self):
        """Node-level outage (power/network loss)."""
        with self.lock:
            self._alive = False
            insts = list(self.instances.values())
        for inst in insts:
            if inst.engine:
                with inst.lock:    # not mid-step on the sharded executor
                    inst.engine.fail()
        self.notify_work()         # unblock the pump thread promptly

    def recover(self):
        """Node returns empty — models must be re-placed by the
        controller (the Ollama re-pull analogue)."""
        with self.lock:
            self._alive = True
            self.instances.clear()
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None
                self._executor_size = 0
        self.last_heartbeat = time.monotonic()
