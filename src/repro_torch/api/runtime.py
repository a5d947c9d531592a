"""Continuous serving runtime — background pumps + controller tick loop.

Before this module the Gateway hand-pumped the fleet from whichever caller
happened to block on `result()`/`stream()`.  `ServingRuntime` makes the
fleet *self-driving*:

* one **pump thread per backend node**, parked on the node's condition
  variable and woken by `submit()`/`cancel()` (plus a short timeout as a
  missed-wakeup backstop); each wakeup steps every live engine on the node
  until its queues drain,
* one **tick thread** that periodically measures per-model pressure
  (scheduler backlog + gateway in-flight over healthy replicas) and feeds
  it into `SDAIController.tick(load=...)` — heartbeat ingestion, failure
  reallocation, and load-driven scale-up all run off this loop,
* **clean drain on stop**: `stop()` (default `drain=True`) lets pumps
  finish in-flight work before joining every thread; `stop(drain=False)`
  parks immediately, leaving queued requests for a later `start()`.

Callers never pump: with the runtime started, `GenerationHandle.result()`
and `.stream()` just block on handle events that the pump threads signal.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.core.controller import ModelLoad
from repro_torch.core.events import NODE_SUSPECTED, WATCHDOG_FIRED

if TYPE_CHECKING:                      # avoid import cycle at runtime
    from repro_torch.api.gateway import Gateway


@dataclasses.dataclass
class RuntimeConfig:
    tick_interval_s: float = 0.05      # controller load/health cadence
    pump_idle_wait_s: float = 0.02     # cv wait backstop per pump loop
    drain_timeout_s: float = 30.0      # stop(drain=True) upper bound
    # pump watchdog: a single node.pump() call exceeding this wall-clock
    # deadline marks the node SUSPECT in the HealthMonitor, so weighted
    # routing demotes a hung/straggling engine before it stalls queued
    # work.  The mark clears as soon as the step completes.  <= 0 off.
    watchdog_step_timeout_s: float = 10.0


@dataclasses.dataclass
class RuntimeStats:
    ticks: int = 0
    pump_wakeups: int = 0
    tokens_pumped: int = 0
    watchdog_fired: int = 0


class _NodePump(threading.Thread):
    """One node's serving loop: wait for work, step engines, repeat."""

    def __init__(self, runtime: "ServingRuntime", node):
        super().__init__(name=f"pump-{node.node_id}", daemon=True)
        self.rt = runtime
        self.node = node
        # monotonic timestamp of the pump() call in flight (None when
        # idle); the tick loop's watchdog reads it cross-thread
        self.busy_since: Optional[float] = None

    def run(self):
        node, rt = self.node, self.rt
        while True:
            with node.work_cv:
                while not rt._stopping.is_set() and \
                        not node.has_work():
                    node.work_cv.wait(rt.cfg.pump_idle_wait_s)
            if rt._stopping.is_set():
                if not rt._drain or not node.alive:
                    return
                if not node.has_work():
                    return             # drained: exit
                if time.monotonic() > rt._drain_deadline:
                    return             # drain budget exhausted
            if not node.alive:
                # dead nodes idle until recover(); stop() still joins us
                time.sleep(rt.cfg.pump_idle_wait_s)
                continue
            self.busy_since = time.monotonic()
            try:
                emitted = node.pump()
            finally:
                self.busy_since = None
            with rt._stats_lock:       # N pump threads share these
                rt.stats.pump_wakeups += 1
                rt.stats.tokens_pumped += emitted


class _TickLoop(threading.Thread):
    """Controller heartbeat/reallocation/autoscale cadence."""

    def __init__(self, runtime: "ServingRuntime"):
        super().__init__(name="sdai-tick", daemon=True)
        self.rt = runtime

    def run(self):
        rt = self.rt
        while not rt._stopping.wait(rt.cfg.tick_interval_s):
            try:
                rt.tick_once()
            except Exception as e:     # keep the loop alive; surface it
                rt.gateway.c.bus.emit("tick_error", error=repr(e))


class ServingRuntime:
    """Drives a `Gateway`'s fleet from background threads.  Construct via
    `Gateway.start()` (which owns the lifecycle) or directly for finer
    control."""

    def __init__(self, gateway: "Gateway",
                 cfg: Optional[RuntimeConfig] = None):
        self.gateway = gateway
        self.cfg = cfg if cfg is not None else RuntimeConfig()
        self.stats = RuntimeStats()
        self._stats_lock = threading.Lock()
        self._pumps: Dict[str, _NodePump] = {}
        self._ticker: Optional[_TickLoop] = None
        self._stopping = threading.Event()
        self._drain = True
        self._drain_deadline = 0.0
        self._running = False
        self._suspected: set = set()   # nodes the watchdog has demoted

    # ------------------------------------------------------------- #
    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> "ServingRuntime":
        if self._running:
            return self
        self._stopping.clear()
        self._pumps = {}
        for node in self.gateway.c.fleet.nodes.values():
            pump = _NodePump(self, node)
            self._pumps[node.node_id] = pump
        self._ticker = _TickLoop(self)
        self._running = True           # set before threads observe state
        for pump in self._pumps.values():
            pump.start()
        self._ticker.start()
        return self

    def stop(self, drain: bool = True,
             timeout_s: Optional[float] = None) -> bool:
        """Stop all background threads.  With `drain=True` (default) pump
        threads first finish every queued/in-flight request (bounded by
        `timeout_s`/`drain_timeout_s`).  Returns True when every thread
        joined."""
        if not self._running:
            return True
        budget = timeout_s if timeout_s is not None \
            else self.cfg.drain_timeout_s
        self._drain = drain
        self._drain_deadline = time.monotonic() + budget
        self._stopping.set()
        self.wake_all()
        joined = True
        deadline = time.monotonic() + budget
        # join the ticker FIRST: it is the only thread that spawns new
        # pumps (elastic joins / autoscale), so once it is down the pump
        # map is stable and the join list below cannot miss a thread
        if self._ticker is not None:
            self._ticker.join(max(0.0, deadline - time.monotonic()) + 1.0)
            joined = joined and not self._ticker.is_alive()
        for t in list(self._pumps.values()):
            t.join(max(0.0, deadline - time.monotonic()) + 1.0)
            joined = joined and not t.is_alive()
        self._running = False
        self._drain = True
        return joined

    def wake_all(self):
        for node in self.gateway.c.fleet.nodes.values():
            node.notify_work()

    def threads(self) -> List[threading.Thread]:
        """Every runtime thread (tests assert they join on stop)."""
        out: List[threading.Thread] = list(self._pumps.values())
        if self._ticker is not None:
            out.append(self._ticker)
        return out

    # ------------------------------------------------------------- #
    def load_report(self) -> Dict[str, ModelLoad]:
        """Per-model pressure: scheduler backlog across live replicas +
        gateway in-flight, over healthy replica count."""
        gw = self.gateway
        c = gw.c
        out: Dict[str, ModelLoad] = {}
        for model in c.replicas.models():
            depth, head_wait, page_pressure = 0, 0.0, 0.0
            for info in c.replicas.for_model(model):
                node = c.fleet.nodes.get(info.key.node_id)
                if node is None or not node.alive:
                    continue
                inst = node.instances.get(info.key.instance_id)
                if inst is not None and inst.engine is not None:
                    sched = inst.engine.scheduler
                    depth += sched.depth
                    head_wait = max(head_wait, sched.head_wait_s())
                    # KV-page occupancy net of evictable prefix-cache
                    # pages: a nearly-exhausted pool means admitted work
                    # is about to preempt — VRAM pressure queue depth
                    # alone cannot see — but pages the cache will hand
                    # back on demand are not pressure, so a cache-warm
                    # idle engine does not trigger scale-up
                    page_pressure = max(
                        page_pressure,
                        inst.engine.page_pressure())
            out[model] = ModelLoad(
                queue_depth=depth,
                inflight=gw.inflight(model),
                replicas=len(c.frontend.healthy_replicas(model)),
                max_head_wait_s=head_wait,
                page_pressure=page_pressure)
        return out

    def _watchdog(self):
        """Demote nodes whose pump step blew its wall-clock deadline: a
        hung engine (driver stall, pathological compile, chaos-injected
        hang) would otherwise block its pump thread forever while the
        node keeps heartbeating HEALTHY.  The SUSPECT mark adds the
        frontend's `suspect_penalty` to every replica on the node, so
        new work routes around it; the mark clears when the step
        finally completes."""
        deadline = self.cfg.watchdog_step_timeout_s
        if deadline <= 0:
            return
        mon = self.gateway.c.monitor
        bus = self.gateway.c.bus
        now = time.monotonic()
        for node_id, pump in list(self._pumps.items()):
            since = pump.busy_since
            stalled = since is not None and (now - since) > deadline
            if stalled and node_id not in self._suspected:
                self._suspected.add(node_id)
                mon.mark_suspect(node_id)
                with self._stats_lock:
                    self.stats.watchdog_fired += 1
                bus.emit(WATCHDOG_FIRED, node=node_id,
                         stalled_s=now - since)
                bus.emit(NODE_SUSPECTED, node=node_id, reason="watchdog")
            elif not stalled and node_id in self._suspected:
                self._suspected.discard(node_id)
                mon.clear_suspect(node_id)

    def tick_once(self):
        """One controller iteration with fresh load feedback.  New nodes
        (elastic joins / autoscale targets) get pump threads here."""
        with self._stats_lock:         # pumps bump their counters too
            self.stats.ticks += 1
        self._watchdog()
        self.gateway.c.tick(load=self.load_report())
        if not self._stopping.is_set():
            for node in list(self.gateway.c.fleet.nodes.values()):
                if node.node_id not in self._pumps:
                    pump = _NodePump(self, node)
                    self._pumps[node.node_id] = pump
                    pump.start()
