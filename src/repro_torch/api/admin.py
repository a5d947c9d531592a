"""Gateway API v1 — typed admin surface (the SDAI dashboard, typed).

`AdminAPI` is the control plane the old `SDAIController.dashboard()` dict
grows into: frozen `FleetSnapshot`/`NodeSnapshot`/`InstanceSnapshot`/
`TenantSnapshot` views plus deploy / undeploy / scale / drain verbs and
per-tenant quota configuration.  `dashboard()` remains as a thin shim that
renders `snapshot().to_dict()` in the legacy shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from repro_torch.core.events import FAILURE_EVENT_KINDS
from repro_torch.core.frontend import TenantQuota
from repro_torch.core.placement import ModelDemand

if TYPE_CHECKING:                      # avoid import cycle at runtime
    from repro_torch.api.gateway import Gateway
    from repro_torch.core.controller import SDAIController


@dataclasses.dataclass(frozen=True)
class InstanceSnapshot:
    instance_id: int
    model: str
    quantize: str
    n_slots: int
    max_len: int
    bytes: int
    load: float
    alive: bool
    # paged KV pool occupancy (real engines; accounted replicas report
    # their configured budget with zero occupancy)
    page_size: int = 0
    kv_pages: int = 0
    pages_in_use: int = 0
    page_occupancy: float = 0.0
    page_fragmentation: float = 0.0
    preemptions: int = 0
    # hierarchical KV memory (prefix cache + host swap tier); zeros when
    # the engine runs without the hierarchy enabled
    cache_hit_rate: float = 0.0
    cache_device_pages: int = 0
    cache_evictable_pages: int = 0
    host_pages: int = 0
    host_pages_in_use: int = 0
    swap_outs: int = 0
    swap_ins: int = 0
    # decode hot-path efficiency (paged attention + speculative decode);
    # zeros when the engine runs the gather/scatter path without spec
    paged_attention: bool = False
    speculative: bool = False
    logical_bytes_moved_per_token: float = 0.0
    spec_accepted_per_dispatch: float = 0.0


@dataclasses.dataclass(frozen=True)
class NodeSnapshot:
    node_id: str
    klass: str
    alive: bool
    health: str
    hbm_used: int
    hbm_budget: int
    instances: Tuple[InstanceSnapshot, ...]

    @property
    def utilization(self) -> float:
        return self.hbm_used / self.hbm_budget if self.hbm_budget else 0.0


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    name: str
    replicas: int
    healthy_replicas: int


@dataclasses.dataclass(frozen=True)
class TenantSnapshot:
    """One tenant's configured quota + cumulative usage."""
    tenant: str
    requests_per_s: float          # 0 => unlimited
    tokens_per_s: float            # 0 => unlimited
    admitted: int
    rate_limited: int
    tokens_charged: int
    weight: float = 1.0            # DWRR fair-queuing share
    refunds: int = 0               # cancelled-while-queued give-backs


@dataclasses.dataclass(frozen=True)
class ClassSnapshot:
    """Per-node-class rollup: fleet share, cost weight, modeled
    cost-per-token per request-size bucket (averaged over deployed
    models), and observed routed traffic per bucket — the heterogeneity
    dashboard the paper's mixed-GPU story needs."""
    klass: str
    cost_per_hour: float
    legacy: bool
    nodes: int
    alive_nodes: int
    hbm_budget: int
    hbm_used: int
    replicas: int
    routed_by_bucket: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    cost_per_token: Dict[str, float] = \
        dataclasses.field(default_factory=dict)

    @property
    def utilization(self) -> float:
        return self.hbm_used / self.hbm_budget if self.hbm_budget else 0.0


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    connected: int
    total: int
    nodes: Tuple[NodeSnapshot, ...]
    models: Tuple[ModelSnapshot, ...]
    routing: Dict[str, Tuple[str, ...]]
    utilization: float
    last_update: float
    tenants: Tuple[TenantSnapshot, ...] = ()
    # failure-handling activity over the bus's retained window:
    # migrations, watchdog trips, suspects, injected faults (kind -> n)
    failure_events: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    # per-GPU-class demand/cost rollup (heterogeneity dashboard)
    classes: Tuple[ClassSnapshot, ...] = ()

    def node(self, node_id: str) -> Optional[NodeSnapshot]:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        return None

    def to_dict(self) -> Dict:
        """Legacy `dashboard()` shape (paper Fig. 3)."""
        return {
            "connected": self.connected,
            "total": self.total,
            "agents": {
                n.node_id: {
                    "class": n.klass,
                    "alive": n.alive,
                    "health": n.health,
                    "hbm_used": n.hbm_used,
                    "hbm_budget": n.hbm_budget,
                    "instances": [{"model": i.model,
                                   "quantize": i.quantize,
                                   "kv_pages": i.kv_pages,
                                   "pages_in_use": i.pages_in_use,
                                   "page_occupancy": i.page_occupancy,
                                   "page_fragmentation":
                                       i.page_fragmentation,
                                   "cache": {
                                       "hit_rate": i.cache_hit_rate,
                                       "device_pages":
                                           i.cache_device_pages,
                                       "evictable_pages":
                                           i.cache_evictable_pages,
                                       "host_pages": i.host_pages,
                                       "host_pages_in_use":
                                           i.host_pages_in_use,
                                       "swap_outs": i.swap_outs,
                                       "swap_ins": i.swap_ins}}
                                  for i in n.instances],
                } for n in self.nodes},
            "models": {m.name: m.replicas for m in self.models},
            "routing": {m: list(r) for m, r in self.routing.items()},
            "tenants": {
                t.tenant: {"requests_per_s": t.requests_per_s,
                           "tokens_per_s": t.tokens_per_s,
                           "weight": t.weight,
                           "admitted": t.admitted,
                           "rate_limited": t.rate_limited,
                           "tokens_charged": t.tokens_charged,
                           "refunds": t.refunds}
                for t in self.tenants},
            "classes": {
                k.klass: {"cost_per_hour": k.cost_per_hour,
                          "legacy": k.legacy,
                          "nodes": k.nodes,
                          "alive_nodes": k.alive_nodes,
                          "hbm_budget": k.hbm_budget,
                          "hbm_used": k.hbm_used,
                          "utilization": k.utilization,
                          "replicas": k.replicas,
                          "routed_by_bucket": dict(k.routed_by_bucket),
                          "cost_per_token": dict(k.cost_per_token)}
                for k in self.classes},
            "failures": dict(self.failure_events),
            "last_update": self.last_update,
        }


@dataclasses.dataclass(frozen=True)
class DeployResult:
    placed: int
    unplaced: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.unplaced


class AdminAPI:
    """Typed control plane over the SDAI controller.  Standalone
    (`AdminAPI(ctrl)`) for observation; attach a `Gateway` (done
    automatically by `Gateway.__init__`) to enable `drain_model`."""

    def __init__(self, controller: "SDAIController",
                 gateway: Optional["Gateway"] = None) -> None:
        self.c = controller
        self.gateway = gateway

    # ---- observe ------------------------------------------------- #
    def snapshot(self) -> FleetSnapshot:
        c = self.c
        nodes: List[NodeSnapshot] = []
        for nid in c.nodes.ids():
            node = c.fleet.nodes.get(nid)
            alive = c.node_alive(nid)
            instances = []
            if alive:
                for r in c.replicas.on_node(nid):
                    inst = node.instances.get(r.key.instance_id)
                    pages: Dict[str, Any] = {}
                    if inst is not None:
                        if inst.engine is not None:
                            # instance lock: page_stats iterates pool
                            # dicts a pump thread mutates mid-step
                            eng = inst.engine
                            with inst.lock:
                                ps = eng.pool.page_stats()
                                pc, hp = eng.prefix_cache, eng.host_pool
                                cache = dict(
                                    cache_hit_rate=(
                                        pc.hit_rate() if pc else 0.0),
                                    cache_device_pages=(
                                        pc.device_pages if pc else 0),
                                    cache_evictable_pages=(
                                        pc.evictable_device_pages()
                                        if pc else 0),
                                    host_pages=hp.n_pages if hp else 0,
                                    host_pages_in_use=(
                                        hp.in_use if hp else 0),
                                    swap_outs=eng.swap_outs,
                                    swap_ins=eng.swap_ins,
                                    paged_attention=eng._paged_attn,
                                    speculative=eng._spec_ok,
                                    logical_bytes_moved_per_token=(
                                        eng.logical_bytes_moved
                                        / max(eng.total_tokens, 1)),
                                    spec_accepted_per_dispatch=(
                                        eng.spec_emitted
                                        / eng.spec_dispatches
                                        if eng.spec_dispatches else 0.0))
                            frag = ps["page_fragmentation"]
                            pages = dict(
                                page_size=int(ps["page_size"]),
                                kv_pages=int(ps["kv_pages"]),
                                pages_in_use=int(ps["pages_in_use"]),
                                page_occupancy=ps["page_occupancy"],
                                page_fragmentation=frag,
                                preemptions=int(ps["preemptions"]),
                                **cache)
                        else:
                            pages = dict(page_size=inst.page_size,
                                         kv_pages=inst.kv_pages)
                    instances.append(InstanceSnapshot(
                        instance_id=r.key.instance_id,
                        model=r.model_name, quantize=r.quantize,
                        n_slots=r.n_slots, max_len=r.max_len,
                        bytes=r.bytes,
                        load=inst.load if inst is not None else 0.0,
                        alive=inst.alive if inst is not None else False,
                        **pages))
            nodes.append(NodeSnapshot(
                node_id=nid,
                klass=node.klass.name if node else "?",
                alive=alive,
                health=c.monitor.status(nid).value,
                hbm_used=node.hbm_used if node and alive else 0,
                hbm_budget=node.hbm_budget if node else 0,
                instances=tuple(instances)))
        models = tuple(ModelSnapshot(
            name=m, replicas=len(c.replicas.for_model(m)),
            healthy_replicas=len(c.frontend.healthy_replicas(m)))
            for m in c.replicas.models())
        routing = {m: tuple(str(k) for k in c.frontend.healthy_replicas(m))
                   for m in c.replicas.models()}
        tenants: List[TenantSnapshot] = []
        for name, entry in sorted(c.frontend.tenants.snapshot().items()):
            quota, usage = entry["quota"], entry["usage"]
            tenants.append(TenantSnapshot(
                tenant=name,
                requests_per_s=quota.requests_per_s if quota else 0.0,
                tokens_per_s=quota.tokens_per_s if quota else 0.0,
                admitted=usage.admitted,
                rate_limited=usage.rate_limited,
                tokens_charged=usage.tokens_charged,
                weight=quota.weight if quota else 1.0,
                refunds=usage.refunds))
        return FleetSnapshot(
            connected=sum(1 for n in nodes if n.alive),
            total=len(nodes), nodes=tuple(nodes), models=models,
            routing=routing, utilization=c.fleet_utilization(),
            last_update=c.clock(), tenants=tuple(tenants),
            failure_events=c.bus.counts(FAILURE_EVENT_KINDS),
            classes=self._class_rollup(nodes))

    def _class_rollup(self,
                      nodes: List[NodeSnapshot]) -> Tuple[ClassSnapshot,
                                                          ...]:
        """Aggregate node snapshots per NodeClass and annotate each class
        with observed per-bucket routed traffic plus the perf model's
        per-bucket cost-per-token (averaged over models the class could
        serve — the controller's registered demands)."""
        from repro_torch.cluster.hardware import NODE_CLASSES
        from repro_torch.core.perfmodel import BUCKETS
        c = self.c
        by_class: Dict[str, List[NodeSnapshot]] = {}
        for n in nodes:
            by_class.setdefault(n.klass, []).append(n)
        # observed traffic: bucket -> class -> routed count
        traffic = c.frontend.stats.per_bucket_class
        out = []
        for kname in sorted(by_class):
            klass = NODE_CLASSES.get(kname)
            members = by_class[kname]
            cfgs = [d.cfg for d in c.demands.values()]
            cpt: Dict[str, float] = {}
            if klass is not None and cfgs:
                for b in BUCKETS:
                    vals = [c.perf.cost_per_token(klass, cfg, b)
                            for cfg in cfgs]
                    finite = [v for v in vals if v != float("inf")]
                    if finite:
                        cpt[b.name] = sum(finite) / len(finite)
            out.append(ClassSnapshot(
                klass=kname,
                cost_per_hour=klass.cost_per_hour if klass else 0.0,
                legacy=klass.legacy if klass else False,
                nodes=len(members),
                alive_nodes=sum(1 for n in members if n.alive),
                hbm_budget=sum(n.hbm_budget for n in members),
                hbm_used=sum(n.hbm_used for n in members),
                replicas=sum(len(n.instances) for n in members),
                routed_by_bucket={b: kc[kname]
                                  for b, kc in traffic.items()
                                  if kname in kc},
                cost_per_token=cpt))
        return tuple(out)

    # ---- mutate -------------------------------------------------- #
    def flush_cache(self, model: Optional[str] = None) -> Dict[str, int]:
        """Drop every unpinned prefix-cache entry (device and host
        tiers) on every live engine — or only on `model`'s replicas.
        Pinned entries (pages a running slot still reads) survive.
        Returns aggregate `{"flushed": n, "remaining": m}`."""
        c = self.c
        flushed = remaining = 0
        for nid in c.nodes.ids():
            node = c.fleet.nodes.get(nid)
            if node is None or not c.node_alive(nid):
                continue
            for r in c.replicas.on_node(nid):
                if model is not None and r.model_name != model:
                    continue
                inst = node.instances.get(r.key.instance_id)
                if inst is None or inst.engine is None:
                    continue
                with inst.lock:
                    res = inst.engine.flush_prefix_cache()
                flushed += int(res.get("flushed", 0))
                remaining += int(res.get("remaining", 0))
        self.c.bus.emit("cache_flushed", model=model or "*",
                        flushed=flushed, remaining=remaining)
        return {"flushed": flushed, "remaining": remaining}

    def deploy_model(self, demand: ModelDemand) -> DeployResult:
        plan = self.c.deploy([demand])
        return DeployResult(placed=len(plan.assignments),
                            unplaced=tuple(plan.unplaced))

    def undeploy_model(self, model: str) -> int:
        if self.gateway is not None:
            self.gateway._draining.discard(model)
        return self.c.undeploy_model(model)

    def scale_model(self, model: str, min_replicas: int) -> DeployResult:
        """Grow (place additional replicas) or shrink (undeploy surplus)
        the replica count for an already-registered demand."""
        demand = self.c.demands.get(model)
        if demand is None:
            demand = ModelDemand(self.c.catalog.get(model),
                                 min_replicas=min_replicas)
        new_max = demand.max_replicas and max(demand.max_replicas,
                                              min_replicas)
        target = dataclasses.replace(demand, min_replicas=min_replicas,
                                     max_replicas=new_max)
        have = len(self.c.frontend.healthy_replicas(model))
        if min_replicas > have:
            delta = dataclasses.replace(target,
                                        min_replicas=min_replicas - have,
                                        max_replicas=min_replicas - have)
            plan = self.c.deploy([delta])
            # deploy() overwrote the demand with the delta; restore target
            self.c.demands[model] = target
            return DeployResult(placed=len(plan.assignments),
                                unplaced=tuple(plan.unplaced))
        self.c.demands[model] = target
        removed = self.c.remove_replicas(model, keep=min_replicas)
        self.c.bus.emit("model_scaled", model=model,
                        target=min_replicas, removed=removed)
        return DeployResult(placed=0, unplaced=())

    def drain_model(self, model: str, timeout_s: float = 30.0) -> int:
        """Stop admitting new requests for `model` (structured `DRAINING`
        rejections) and wait until in-flight traffic settles — pump
        threads drain it when the runtime is started, otherwise this call
        hand-pumps.  Returns the number of requests still in flight
        (0 == drained).  The model stays drained until `resume_model` or
        `undeploy_model`."""
        if self.gateway is None:
            raise RuntimeError("drain_model needs a Gateway-attached "
                               "AdminAPI (use gateway.admin)")
        gw = self.gateway
        gw._draining.add(model)
        deadline = time.monotonic() + timeout_s
        while gw.inflight(model) > 0 and time.monotonic() < deadline:
            if gw.runtime_active:
                time.sleep(0.005)
            else:
                self.c.fleet.pump()
        self.c.bus.emit("model_drained", model=model,
                        remaining=gw.inflight(model))
        return gw.inflight(model)

    def resume_model(self, model: str) -> None:
        if self.gateway is not None:
            self.gateway._draining.discard(model)

    # ---- multi-tenancy ------------------------------------------- #
    def set_tenant_quota(self, tenant: str,
                         quota: Optional[TenantQuota] = None, *,
                         requests_per_s: float = 0.0,
                         tokens_per_s: float = 0.0,
                         weight: float = 1.0) -> TenantQuota:
        """Install per-tenant rate limits and the fair-queuing weight,
        enforced by the frontend at admission (`ErrorCode.RATE_LIMITED`
        rejections) and inside every engine's DWRR scheduler
        respectively.  Pass a `TenantQuota` or the shorthands; quotas
        show up in `FleetSnapshot.tenants`."""
        if quota is None:
            quota = TenantQuota(requests_per_s=requests_per_s,
                                tokens_per_s=tokens_per_s, weight=weight)
        self.c.frontend.tenants.set_quota(tenant, quota)
        self.c.bus.emit("tenant_quota_set", tenant=tenant,
                        requests_per_s=quota.requests_per_s,
                        tokens_per_s=quota.tokens_per_s,
                        weight=quota.weight)
        return quota

    def remove_tenant_quota(self, tenant: str) -> None:
        """Lift a tenant's rate limits (usage history is kept)."""
        self.c.frontend.tenants.set_quota(tenant, None)
        self.c.bus.emit("tenant_quota_removed", tenant=tenant)

    def tenant_quotas(self) -> Dict[str, TenantQuota]:
        return dict(self.c.frontend.tenants.quotas)
