"""Deterministic chaos harness — seeded fault injection at exact steps.

The paper's availability claim ("resilience against failures or workload
fluctuations") is only credible if failure handling is *exercised
continuously and reproducibly*, not assumed.  `FaultInjector` is a
single chaos clock wired into every `BackendNode`: the clock advances by
one at each `node.pump()` boundary (any node), and every scheduled
`FaultSpec` fires when the clock reaches its `at_step` — so a given
(seed, schedule) always produces the same failure sequence, and a chaos
soak that passes locally reproduces bit-for-bit in CI.

Fault kinds (all consulted at pump/submit/heartbeat boundaries — the
same boundaries real outages hit, never mid-dispatch):

* ``crash``          — node-level outage (`node.fail()`): every in-flight
                       request finishes ENGINE_FAILED and the gateway
                       migrates mid-stream victims to survivors.
* ``mute_heartbeat`` — silent heartbeat loss: the node keeps serving but
                       the control plane hears nothing (the zombie the
                       controller must fence before re-routing).
* ``hang`` / ``slow``— the node's pump stalls `stall_s` per step for the
                       window: `hang` (long stall) trips the runtime
                       watchdog; `slow` (short stall) makes a straggler.
* ``flap``           — submits to the node are refused for the window;
                       the frontend's retry loop fails over.
* ``swap_fail``      — the node's host swap tier refuses new puts for
                       the window; preemption falls back to recompute.

Windowed kinds (`mute_heartbeat`/`hang`/`slow`/`flap`/`swap_fail`) stay
active for `duration_steps` after firing (0 => until `uninstall()`).
Every firing is recorded in `fired` and emitted on the event bus as a
``fault_injected`` event when a bus is installed.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

FAULT_KINDS = ("crash", "mute_heartbeat", "hang", "slow", "flap",
               "swap_fail")
_WINDOWED = ("mute_heartbeat", "hang", "slow", "flap", "swap_fail")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: `kind` hits `node` when the global chaos
    clock reaches `at_step`."""
    kind: str
    node: str
    at_step: int
    duration_steps: int = 0      # windowed kinds: 0 => until uninstall
    stall_s: float = 0.0         # hang/slow: injected sleep per pump

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")


class FaultInjector:
    """Seeded, step-deterministic fault scheduler.

    Thread-safety: `on_step` is called from every node's pump thread and
    `submit_blocked` re-enters from migration resubmits on the same
    thread, so internal state sits behind an RLock; fault *application*
    (node.fail, sleeps, flag flips) happens outside it, so a crash
    cascade never holds the injector lock while it fans out."""

    def __init__(self, specs: Iterable[FaultSpec],
                 bus=None):
        self.specs: List[FaultSpec] = sorted(specs,
                                             key=lambda s: s.at_step)
        self.bus = bus
        self.fleet = None
        self.step = 0
        self.fired: List[Tuple[int, FaultSpec]] = []
        self._pending: List[FaultSpec] = list(self.specs)
        # node -> window-end step (None => until uninstall)
        self._mute: Dict[str, Optional[int]] = {}
        self._flap: Dict[str, Optional[int]] = {}
        self._swap: Dict[str, Optional[int]] = {}
        self._stall: Dict[str, Tuple[Optional[int], float]] = {}
        self._lock = threading.RLock()

    # ---------------------------------------------------------------- #
    def install(self, fleet, bus=None) -> "FaultInjector":
        """Wire this injector into every node of `fleet` (including the
        heartbeat/submit hooks) and start the chaos clock."""
        self.fleet = fleet
        if bus is not None:
            self.bus = bus
        for node in fleet.nodes.values():
            node.faults = self
        return self

    def uninstall(self):
        if self.fleet is not None:
            for node in self.fleet.nodes.values():
                if node.faults is self:
                    node.faults = None
        with self._lock:
            self._mute.clear()
            self._flap.clear()
            self._stall.clear()
            self._swap.clear()
        self._sync_swap_flags()

    # ---------------------------------------------------------------- #
    def _active(self, windows: Dict[str, Optional[int]],
                node_id: str) -> bool:
        end = windows.get(node_id, 0)
        if node_id not in windows:
            return False
        return end is None or self.step < end

    def heartbeat_muted(self, node_id: str) -> bool:
        with self._lock:
            return self._active(self._mute, node_id)

    def submit_blocked(self, node_id: str) -> bool:
        with self._lock:
            return self._active(self._flap, node_id)

    def swap_blocked(self, node_id: str) -> bool:
        with self._lock:
            return self._active(self._swap, node_id)

    # ---------------------------------------------------------------- #
    def _sync_swap_flags(self):
        """Mirror active swap_fail windows onto the target nodes' host
        pools (the engine-side hook is a plain flag so the swap path
        stays lock-free)."""
        if self.fleet is None:
            return
        targets = {s.node for s in self.specs if s.kind == "swap_fail"}
        for nid in targets:
            node = self.fleet.nodes.get(nid)
            if node is None:
                continue
            blocked = self.swap_blocked(nid)
            for inst in list(node.instances.values()):
                eng = inst.engine
                if eng is not None and eng.host_pool is not None:
                    eng.host_pool.fail_puts = blocked

    def on_step(self, node) -> None:
        """Advance the chaos clock by one pump boundary and apply every
        fault that just came due.  Crashes and sleeps run outside the
        injector lock."""
        with self._lock:
            self.step += 1
            now = self.step
            due = [s for s in self._pending if s.at_step <= now]
            if due:
                self._pending = [s for s in self._pending
                                 if s.at_step > now]
                for s in due:
                    self.fired.append((now, s))
                    end = (now + s.duration_steps
                           if s.duration_steps > 0 else None)
                    if s.kind == "mute_heartbeat":
                        self._mute[s.node] = end
                    elif s.kind == "flap":
                        self._flap[s.node] = end
                    elif s.kind == "swap_fail":
                        self._swap[s.node] = end
                    elif s.kind in ("hang", "slow"):
                        self._stall[s.node] = (end, s.stall_s)
            stall = self._stall.get(node.node_id)
            stall_s = 0.0
            if stall is not None:
                end, secs = stall
                if end is None or now < end:
                    stall_s = secs
                else:
                    del self._stall[node.node_id]
            swap_windows = bool(self._swap)
        # ---- apply outside the lock ---------------------------------- #
        if due:
            if self.bus is not None:
                for s in due:
                    self.bus.emit("fault_injected", fault=s.kind,
                                  node=s.node, at_step=now,
                                  duration_steps=s.duration_steps)
            self._sync_swap_flags()
            for s in due:
                if s.kind == "crash" and self.fleet is not None:
                    victim = self.fleet.nodes.get(s.node)
                    if victim is not None and victim.alive:
                        victim.fail()
        elif swap_windows:
            self._sync_swap_flags()    # windows also *expire* on steps
        if stall_s > 0:
            import time
            time.sleep(stall_s)

    # ---------------------------------------------------------------- #
    @classmethod
    def kill_schedule(cls, seed: int, node_ids: Sequence[str],
                      n_kills: int = 1, first_step: int = 8,
                      spacing: int = 16, bus=None) -> "FaultInjector":
        """Seeded kill schedule: `n_kills` distinct victims drawn with
        `random.Random(seed)`, crashed at `first_step`, `first_step +
        spacing`, ... — the reproducible soak CI runs."""
        rng = random.Random(seed)
        victims = rng.sample(list(node_ids),
                             min(n_kills, len(node_ids)))
        return cls([FaultSpec("crash", v, first_step + i * spacing)
                    for i, v in enumerate(victims)], bus=bus)
