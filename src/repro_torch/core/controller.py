"""SDAI Controller — the orchestration core (paper §3, §5).

Lifecycle:  discover() -> deploy(demands) -> tick() loop.

* discover: register every backend node's capability payload (GPU type,
  VRAM, preloaded models — the dashboard's agent cards).
* deploy: run VRAM-aware placement, start instances on nodes, provision
  frontend routes (the generated per-model HAProxy config).
* tick: ingest heartbeats, detect dead nodes, *dynamically reallocate* lost
  instances onto surviving VRAM, handle elastic joins, demote stragglers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.cluster.fleet import Fleet
from repro_torch.core.events import EventBus
from repro_torch.core.frontend import FrontendConfig, ServiceFrontend
from repro_torch.core.health import HealthConfig, HealthMonitor, NodeHealth
from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.placement import (ModelDemand, NodeSpec, PlacementPlan,
                                  place, place_cost_optimal,
                                  plan_utilization, reallocation_plan)
from repro_torch.core.registry import (ModelCatalog, NodeRegistry, ReplicaInfo,
                                 ReplicaKey, ReplicaRegistry)


@dataclasses.dataclass
class AutoscaleConfig:
    """Load-feedback elasticity policy (paper: reallocation under
    workload fluctuations), in both directions.

    Scale-up: a model is "hot" when its backlog-per-replica exceeds
    `queue_high`, OR its oldest queued request has waited longer than
    `head_wait_high_s` (a shallow-but-stale queue is still starvation),
    OR some replica's KV-page pool is nearly exhausted (`page_high`
    occupancy — admitted work is about to preempt, so VRAM pressure is
    real even when the queue looks shallow); `sustain_ticks` consecutive
    hot ticks place one more replica into free VRAM, then
    `cooldown_ticks` of hysteresis before the next growth step.

    Scale-down: a model is "idle" when it has zero backlog AND zero
    in-flight requests while holding more replicas than its demand's
    `min_replicas`; `idle_sustain_ticks` consecutive idle ticks retire
    one *surplus, work-free* replica (VRAM returns to the pool for other
    models), then `down_cooldown_ticks` of hysteresis.  Replicas with
    queued or decoding work are never retired, and the floor is always
    the demand's `min_replicas`."""
    enabled: bool = True
    queue_high: float = 2.0        # queued requests per healthy replica
    head_wait_high_s: float = 2.0  # oldest-queued-request age threshold
    page_high: float = 0.92        # KV-page occupancy pressure threshold
    sustain_ticks: int = 3
    cooldown_ticks: int = 10
    scale_down: bool = True
    idle_sustain_ticks: int = 20   # idle ticks before retiring a replica
    down_cooldown_ticks: int = 20


@dataclasses.dataclass
class ModelLoad:
    """One model's instantaneous pressure signal, fed into `tick()` by
    the serving runtime (or a test harness)."""
    queue_depth: int = 0           # scheduler backlog across replicas
    inflight: int = 0              # gateway-admitted, not yet settled
    replicas: int = 0              # healthy replicas serving the model
    max_head_wait_s: float = 0.0   # oldest queued request, any replica
    page_pressure: float = 0.0     # max KV-page occupancy, any replica


@dataclasses.dataclass
class ControllerConfig:
    real_param_threshold: int = 5_000_000   # params; above => accounted mode
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    frontend: FrontendConfig = dataclasses.field(
        default_factory=FrontendConfig)
    fill_vram: bool = True
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    # "vram": classic class-blind bin packing (`place`); "cost":
    # heterogeneity-aware cost-optimal solver (`place_cost_optimal`) —
    # initial deploy and rebalance rank candidate nodes by modeled
    # cost-per-token.  Scale-up/scale-down are always class-aware.
    placement_policy: str = "vram"


class SDAIController:
    def __init__(self, fleet: Fleet, catalog: ModelCatalog,
                 cfg: Optional[ControllerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.catalog = catalog
        self.cfg = cfg if cfg is not None else ControllerConfig()
        self.clock = clock
        self.nodes = NodeRegistry()
        self.replicas = ReplicaRegistry()
        self.monitor = HealthMonitor(self.cfg.health, clock=clock)
        self.bus = EventBus()
        self.perf = PerfModel()
        self.frontend = ServiceFrontend(fleet, self.replicas, self.monitor,
                                        self.cfg.frontend, perf=self.perf,
                                        catalog=catalog)
        self.demands: Dict[str, ModelDemand] = {}
        self._dead_nodes: set = set()
        # load-feedback autoscale state: model -> consecutive hot/idle
        # ticks and remaining per-direction cooldown ticks
        self._pressure_streak: Dict[str, int] = {}
        self._scale_cooldown: Dict[str, int] = {}
        self._idle_streak: Dict[str, int] = {}
        self._down_cooldown: Dict[str, int] = {}
        self.scale_ups = 0
        self.scale_downs = 0

    # ---------------------------------------------------------------- #
    # Discovery phase (paper: "Upon startup, it discovers and establishes
    # communication with all backend nodes")
    def discover(self) -> List[str]:
        found = []
        for node in self.fleet.nodes.values():
            if not node.alive:
                continue
            payload = node.discovery_payload()
            self.nodes.register(payload)
            self.monitor.observe_heartbeat(node.node_id)
            self.bus.emit("node_discovered", **payload)
            found.append(node.node_id)
        return found

    # ---------------------------------------------------------------- #
    def _free_capacity(self) -> Dict[str, tuple]:
        """node_id -> (free_bytes, legacy) over healthy nodes."""
        out = {}
        for nid in self.nodes.ids():
            node = self.fleet.nodes.get(nid)
            if node is None or not node.alive or nid in self._dead_nodes:
                continue
            if self.monitor.status(nid) == NodeHealth.DEAD:
                continue
            out[nid] = (node.hbm_free, node.klass.legacy)
        return out

    def _free_capacity_specs(self) -> Dict[str, NodeSpec]:
        """Capability-aware view of `_free_capacity` for the cost-optimal
        solver (free VRAM + the full NodeClass vector)."""
        out = {}
        for nid in self._free_capacity():
            node = self.fleet.nodes[nid]
            out[nid] = NodeSpec(node.hbm_free, node.klass)
        return out

    def _execute(self, plan: PlacementPlan) -> List[ReplicaKey]:
        keys = []
        for a in plan.assignments:
            node = self.fleet.nodes[a.node_id]
            cfg = self.catalog.get(a.model_name)
            real = cfg.num_params() <= self.cfg.real_param_threshold
            try:
                inst = node.deploy(cfg, quantize=a.quantize,
                                   n_slots=a.n_slots, max_len=a.max_len,
                                   real=real, page_size=a.page_size,
                                   kv_pages=a.kv_pages)
            except MemoryError as e:      # placement invariant violated
                self.bus.emit("deploy_failed", node=a.node_id,
                              model=a.model_name, error=str(e))
                continue
            if inst.engine is not None:
                # tenant fair-queuing weights flow from the frontend's
                # quota registry straight into the engine's DWRR
                # scheduler — live lookups, no broadcast needed
                inst.engine.scheduler.weight_of = \
                    self.frontend.tenants.weight
            key = ReplicaKey(a.node_id, inst.instance_id)
            self.replicas.add(ReplicaInfo(key, a.model_name, a.quantize,
                                          a.n_slots, a.max_len, a.bytes))
            self.bus.emit("instance_deployed", node=a.node_id,
                          model=a.model_name, quantize=a.quantize,
                          bytes=a.bytes, real=real)
            keys.append(key)
        return keys

    def deploy(self, demands: Sequence[ModelDemand]) -> PlacementPlan:
        for d in demands:
            if d.cfg.name not in self.catalog:
                self.catalog.register(d.cfg)
            self.demands[d.cfg.name] = d
        cap = self._free_capacity()
        if self.cfg.placement_policy == "cost":
            plan = place_cost_optimal(self._free_capacity_specs(), demands,
                                      self.perf, fill=self.cfg.fill_vram)
        else:
            plan = place(cap, demands, fill=self.cfg.fill_vram)
        self._execute(plan)
        self.bus.emit("deployment_complete",
                      assignments=len(plan.assignments),
                      unplaced=plan.unplaced,
                      utilization=plan_utilization(plan, cap))
        return plan

    # ---------------------------------------------------------------- #
    # Monitoring / dynamic reallocation loop
    def tick(self, load: Optional[Dict[str, ModelLoad]] = None):
        """One control-loop iteration.  `load` (optional) carries the
        per-model pressure signal — queue depth and in-flight count — the
        serving runtime measures each tick; sustained pressure triggers
        scale-up into free VRAM (`AutoscaleConfig`)."""
        # 1. heartbeats
        for node in list(self.fleet.nodes.values()):
            hb = node.heartbeat()
            if hb is not None:
                self.monitor.observe_heartbeat(node.node_id, hb["ts"])
        # 2. failure detection -> reallocation
        for nid in self.nodes.ids():
            node = self.fleet.nodes.get(nid)
            down = self.monitor.heartbeat_expired(nid) or node is None \
                or not node.alive
            if down and nid not in self._dead_nodes:
                self._handle_node_death(nid)
        # 3. elastic join: nodes present in fleet but not registered
        for nid, node in list(self.fleet.nodes.items()):
            if node.alive and nid not in self.nodes.payloads:
                self.nodes.register(node.discovery_payload())
                self.monitor.observe_heartbeat(nid)
                self.bus.emit("node_joined", node=nid)
                self._rebalance_into(nid)
            if node.alive and nid in self._dead_nodes:
                # recovered node: re-register empty
                self._dead_nodes.discard(nid)
                self.monitor.clear_mark(nid)
                self.monitor.observe_heartbeat(nid)
                self.nodes.register(node.discovery_payload())
                self.bus.emit("node_recovered", node=nid)
                self._rebalance_into(nid)
        # 4. load feedback -> scale-up under sustained pressure
        if load:
            self._observe_load(load)

    # ---------------------------------------------------------------- #
    def _observe_load(self, load: Dict[str, ModelLoad]):
        acfg = self.cfg.autoscale
        if not acfg.enabled:
            return
        for model, ml in load.items():
            replicas = max(ml.replicas, 1)
            hot = (ml.queue_depth / replicas >= acfg.queue_high
                   or ml.max_head_wait_s >= acfg.head_wait_high_s
                   or ml.page_pressure >= acfg.page_high)
            idle = ml.queue_depth == 0 and ml.inflight == 0
            # ---- scale-up under sustained pressure ------------------ #
            cd = self._scale_cooldown.get(model, 0)
            if cd > 0:
                self._scale_cooldown[model] = cd - 1
            else:
                streak = self._pressure_streak.get(model, 0) + 1 \
                    if hot else 0
                self._pressure_streak[model] = streak
                if streak >= acfg.sustain_ticks:
                    self._pressure_streak[model] = 0
                    if self.scale_up(model):
                        self._scale_cooldown[model] = acfg.cooldown_ticks
            # ---- scale-down after a sustained idle streak ----------- #
            if not acfg.scale_down:
                continue
            dcd = self._down_cooldown.get(model, 0)
            if dcd > 0:
                self._down_cooldown[model] = dcd - 1
                continue
            istreak = self._idle_streak.get(model, 0) + 1 if idle else 0
            self._idle_streak[model] = istreak
            if istreak >= acfg.idle_sustain_ticks:
                self._idle_streak[model] = 0
                if self.scale_down(model):
                    self._down_cooldown[model] = acfg.down_cooldown_ticks

    def scale_up(self, model: str) -> bool:
        """Place one additional replica of `model` into free VRAM (bounded
        by the demand's replica cap).  Class-aware: the delta replica goes
        to the node whose class serves the model's bucket mix at the
        lowest modeled cost-per-token — on a homogeneous fleet this
        degenerates to `place()`'s anti-affinity/tightest-fit choice.
        Returns True when a replica was actually deployed."""
        if model not in self.catalog:
            return False
        demand = self.demands.get(model)
        if demand is None:
            demand = ModelDemand(self.catalog.get(model), min_replicas=1)
        have = len(self.replicas.for_model(model))
        if have >= demand.replica_cap:
            return False
        delta = dataclasses.replace(demand, min_replicas=1, max_replicas=1)
        plan = place_cost_optimal(self._free_capacity_specs(), [delta],
                                  self.perf, fill=False)
        keys = self._execute(plan)
        if not keys:
            return False           # no node has room: pressure persists
        self.scale_ups += 1
        self.bus.emit("autoscaled_up", model=model,
                      replicas=have + len(keys),
                      placed=[str(k) for k in keys])
        return True

    def _instance_busy(self, inst) -> bool:
        if inst is None:
            return False
        if inst.engine is not None:
            return bool(inst.engine.slot_req
                        or inst.engine.scheduler.depth)
        return inst.sim_active > 0

    def scale_down(self, model: str) -> bool:
        """Retire one surplus replica of `model` back toward the
        demand's `min_replicas` floor, freeing its VRAM.  Only a replica
        with no queued or in-flight work is eligible; the most expensive
        node class retires first, most recently placed breaking ties — on a homogeneous fleet this unwinds
        autoscale growth exactly as before.  When every surplus replica
        is busy nothing is retired.  Returns True when a replica was
        actually removed."""
        demand = self.demands.get(model)
        floor = max(demand.min_replicas, 1) if demand is not None else 1
        infos = self.replicas.for_model(model)
        if len(infos) <= floor:
            return False

        def retire_cost(pair):
            idx, info = pair
            node = self.fleet.nodes.get(info.key.node_id)
            rate = node.klass.cost_rate if node is not None else 0.0
            return (-rate, -idx)

        ordered = [info for _, info
                   in sorted(enumerate(infos), key=retire_cost)]
        for info in ordered:
            node = self.fleet.nodes.get(info.key.node_id)
            if node is None or not node.alive:
                continue
            with node.lock:
                inst = node.instances.get(info.key.instance_id)
                if inst is None:
                    continue
                with inst.lock:   # don't retire an engine mid-step
                    if self._instance_busy(inst):
                        continue
                    # node.submit is deliberately lock-free, so a request
                    # can still slip into the scheduler between the busy
                    # check and undeploy: fail the engine first, so any
                    # such request finishes with ENGINE_FAILED and the
                    # gateway's pre-token retry re-routes it — never
                    # silently stranded
                    if inst.engine is not None:
                        inst.engine.fail()
                # undeploy re-takes node.lock (held here, reentrant) —
                # outside inst.lock so the instance -> node direction
                # never appears in the acquisition order.  Safe: the
                # engine is already failed, so a pump thread grabbing
                # inst.lock now sees a dead engine and does nothing.
                node.undeploy(info.key.instance_id)
            self.replicas.remove(info.key)
            self.scale_downs += 1
            self.bus.emit("autoscaled_down", model=model,
                          replicas=len(self.replicas.for_model(model)),
                          retired=str(info.key))
            return True
        return False

    def _handle_node_death(self, nid: str):
        self._dead_nodes.add(nid)
        self.monitor.mark_dead(nid)
        # fence a zombie: a node whose heartbeats went silent but whose
        # process is still up must not keep serving while routing has
        # written it off (split-brain).  fail() finishes every in-flight
        # request with ENGINE_FAILED, which drives the gateway's
        # pre-token re-route / mid-stream migration onto survivors.
        node = self.fleet.nodes.get(nid)
        if node is not None and node.alive:
            node.fail()
        lost = self.replicas.on_node(nid)
        for info in lost:
            self.replicas.remove(info.key)
        self.bus.emit("node_dead", node=nid,
                      lost=[r.model_name for r in lost])
        # recompute what must be re-placed to restore min replicas
        lost_demands = []
        for info in lost:
            d = self.demands.get(info.model_name)
            if d is None:
                continue
            alive = len(self.frontend.healthy_replicas(info.model_name))
            if alive < d.min_replicas:
                lost_demands.append(dataclasses.replace(
                    d, min_replicas=d.min_replicas - alive))
        if lost_demands:
            plan = reallocation_plan(self._free_capacity(), lost_demands)
            self._execute(plan)
            self.bus.emit("reallocated", node=nid,
                          moved=len(plan.assignments),
                          unplaced=plan.unplaced)

    def _rebalance_into(self, nid: str):
        """Fill a joined/recovered node with replicas of hot models."""
        if not self.demands or not self.cfg.fill_vram:
            return
        node = self.fleet.nodes[nid]
        fill = [dataclasses.replace(d, min_replicas=0)
                for d in self.demands.values()]
        if self.cfg.placement_policy == "cost":
            plan = place_cost_optimal(
                {nid: NodeSpec(node.hbm_free, node.klass)}, fill,
                self.perf, fill=True)
        else:
            plan = place({nid: (node.hbm_free, node.klass.legacy)}, fill,
                         fill=True)
        self._execute(plan)

    def remove_replicas(self, model: str, keep: int = 0) -> int:
        """Retire all but the first `keep` replicas of `model`.  In-flight
        and queued requests on a retired engine are finished with a
        structured error (streaming handles re-route or surface it) —
        never silently stranded."""
        removed = 0
        for info in self.replicas.for_model(model)[keep:]:
            node = self.fleet.nodes.get(info.key.node_id)
            if node is not None:
                with node.lock:
                    inst = node.instances.get(info.key.instance_id)
                    if inst is not None and inst.engine is not None:
                        with inst.lock:   # not mid-step on the executor
                            inst.engine.fail()
                    node.undeploy(info.key.instance_id)
            self.replicas.remove(info.key)
            removed += 1
        return removed

    def undeploy_model(self, model: str) -> int:
        """Remove every replica of `model` from the fleet and drop its
        demand (so reallocation stops restoring it)."""
        removed = self.remove_replicas(model, keep=0)
        self.demands.pop(model, None)
        self.bus.emit("model_undeployed", model=model, removed=removed)
        return removed

    def node_alive(self, nid: str) -> bool:
        node = self.fleet.nodes.get(nid)
        return node is not None and node.alive \
            and nid not in self._dead_nodes

    # ---------------------------------------------------------------- #
    def dashboard(self) -> Dict:
        """The SDAI Interface overview (paper Fig. 3).

        Back-compat: the typed view is `repro.api.AdminAPI.snapshot()`;
        this returns the same data as the legacy dict shape."""
        from repro_torch.api.admin import AdminAPI
        return AdminAPI(self).snapshot().to_dict()

    def fleet_utilization(self) -> float:
        used = tot = 0
        for nid in self.nodes.ids():
            node = self.fleet.nodes.get(nid)
            if node is None or not node.alive:
                continue
            used += node.hbm_used
            tot += node.hbm_budget
        return used / tot if tot else 0.0
