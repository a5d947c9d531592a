"""VRAM-aware model placement — the SDAI controller's core algorithm.

The paper's objective (§1, §3): *fully exploit the VRAM capacity of each
node*, across a heterogeneous fleet, while spreading replicas for high
availability.  We implement it as best-fit-decreasing bin packing with:

  * replica anti-affinity (replicas of a model prefer distinct nodes —
    the paper's resilience-by-rerouting story needs them apart),
  * per-node precision selection (bf16 where it fits; int8/int4 fallback on
    small/legacy nodes — the Ollama-GGUF-quant analogue),
  * a fill phase that packs *extra* replicas into leftover VRAM until no
    instance fits (maximizing utilization and throughput),
  * reallocation planning for node failures / joins (dynamic reallocation,
    §3 "dynamically reallocating workloads as necessary").

`place_naive` is the paper-comparison baseline: first-fit, no sorting, no
quantization fallback, no anti-affinity.

`place_cost_optimal` is the heterogeneity-aware solver: same bin-packing
skeleton, but candidate nodes are ranked by modeled cost-per-token from
`core.perfmodel` (class cost weight / class tokens/s, prorated by the
VRAM share the instance occupies), with an SLO phase that adds replicas
until each demand's `target_tokens_per_s` is met — the Mélange/AIBrix
shape: a throughput matrix times a cost vector, solved greedily.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.hardware import RUNTIME_RESERVE_FRACTION, NodeClass
from repro_torch.cluster.node import instance_bytes
from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import PerfModel

PRECISIONS = ["", "int8", "int4"]          # descending fidelity


@dataclasses.dataclass(frozen=True)
class ModelDemand:
    cfg: ArchConfig
    min_replicas: int = 1
    max_replicas: int = 0                   # 0 => min_replicas + 2
    n_slots: int = 4
    max_len: int = 2048
    allow_quant: bool = True
    weight: float = 1.0                     # expected traffic share
    # paged KV pool sizing: placement charges the *page budget*, not the
    # worst-case n_slots x max_len strips.  kv_page_frac < 1 oversubscribes
    # slots against pages (engines preempt on exhaustion) — the VRAM win.
    page_size: int = 16
    kv_page_frac: float = 1.0
    # heterogeneity-aware extensions (consumed by `place_cost_optimal`):
    # aggregate output-tokens/s the replica set must sustain (0 = no SLO,
    # min_replicas only), and the expected request-size bucket mix
    # (frozen-safe tuple of (bucket_name, fraction); () = DEFAULT_MIX).
    target_tokens_per_s: float = 0.0
    bucket_mix: Tuple[Tuple[str, float], ...] = ()

    @property
    def replica_cap(self) -> int:
        return self.max_replicas or (self.min_replicas + 2)

    @property
    def kv_pages(self) -> int:
        """Per-replica page budget: `kv_page_frac` of the contiguous-
        equivalent pool, floored at one full sequence."""
        per_slot = -(-self.max_len // self.page_size)
        full = self.n_slots * per_slot
        return max(int(full * self.kv_page_frac), per_slot)

    def bytes_at(self, quantize: str) -> int:
        return instance_bytes(self.cfg, quantize, self.n_slots,
                              self.max_len, self.page_size, self.kv_pages)


@dataclasses.dataclass(frozen=True)
class Assignment:
    node_id: str
    model_name: str
    quantize: str
    n_slots: int
    max_len: int
    bytes: int
    page_size: int = 16
    kv_pages: int = 0          # 0 => contiguous-equivalent budget


@dataclasses.dataclass
class PlacementPlan:
    assignments: List[Assignment] = dataclasses.field(default_factory=list)
    unplaced: List[str] = dataclasses.field(default_factory=list)

    def by_node(self) -> Dict[str, List[Assignment]]:
        out: Dict[str, List[Assignment]] = {}
        for a in self.assignments:
            out.setdefault(a.node_id, []).append(a)
        return out

    def replicas(self, model_name: str) -> List[Assignment]:
        return [a for a in self.assignments if a.model_name == model_name]


@dataclasses.dataclass
class _Bin:
    node_id: str
    free: int
    legacy: bool
    hosted: Dict[str, int] = dataclasses.field(default_factory=dict)


def _mk_bins(nodes: Dict[str, Tuple[int, bool]]) -> List[_Bin]:
    return [_Bin(nid, free, legacy) for nid, (free, legacy)
            in nodes.items()]


def _best_node(bins: List[_Bin], demand: ModelDemand) -> \
        Optional[Tuple[_Bin, str]]:
    """Pick (node, precision): prefer anti-affinity, then highest
    precision, then tightest fit (best-fit => maximal utilization)."""
    precisions = PRECISIONS if demand.allow_quant else [""]
    best = None
    best_key = None
    for b in bins:
        for p_idx, prec in enumerate(precisions):
            need = demand.bytes_at(prec)
            if need > b.free:
                continue
            affinity = b.hosted.get(demand.cfg.name, 0)
            leftover = b.free - need
            key = (affinity, p_idx, leftover)
            if best_key is None or key < best_key:
                best, best_key = (b, prec), key
            break          # higher precision fits on this node; stop
    return best


def place(nodes: Dict[str, Tuple[int, bool]],
          demands: Sequence[ModelDemand],
          fill: bool = True) -> PlacementPlan:
    """nodes: node_id -> (free_bytes, is_legacy)."""
    bins = _mk_bins(nodes)
    plan = PlacementPlan()

    def commit(b: _Bin, d: ModelDemand, prec: str):
        need = d.bytes_at(prec)
        b.free -= need
        b.hosted[d.cfg.name] = b.hosted.get(d.cfg.name, 0) + 1
        plan.assignments.append(Assignment(
            b.node_id, d.cfg.name, prec, d.n_slots, d.max_len, need,
            page_size=d.page_size, kv_pages=d.kv_pages))

    # phase 1: min replicas, biggest models first (FFD)
    order = sorted(demands, key=lambda d: -d.bytes_at(""))
    for d in order:
        for _ in range(d.min_replicas):
            pick = _best_node(bins, d)
            if pick is None:
                plan.unplaced.append(d.cfg.name)
                continue
            commit(*[pick[0], d, pick[1]])

    # phase 2: fill leftover VRAM with extra replicas (bounded by each
    # demand's replica_cap), most under-provisioned-per-traffic first
    if fill and demands:
        counts = {d.cfg.name: len(plan.replicas(d.cfg.name))
                  for d in demands}
        exhausted: set = set()
        progress = True
        while progress:
            live = [d for d in demands
                    if d.cfg.name not in plan.unplaced
                    and d.cfg.name not in exhausted
                    and counts[d.cfg.name] < d.replica_cap]
            if not live:
                break
            progress = False
            live.sort(key=lambda d: counts[d.cfg.name] / d.weight)
            for d in live:
                pick = _best_node(bins, d)
                if pick is not None:
                    commit(pick[0], d, pick[1])
                    counts[d.cfg.name] += 1
                    progress = True
                    break
                exhausted.add(d.cfg.name)   # nothing fits anywhere
    return plan


def place_naive(nodes: Dict[str, Tuple[int, bool]],
                demands: Sequence[ModelDemand]) -> PlacementPlan:
    """Baseline: first-fit in arrival order, bf16 only, no fill phase."""
    bins = _mk_bins(nodes)
    plan = PlacementPlan()
    for d in demands:
        for _ in range(d.min_replicas):
            placed = False
            for b in bins:
                need = d.bytes_at("")
                if need <= b.free:
                    b.free -= need
                    plan.assignments.append(Assignment(
                        b.node_id, d.cfg.name, "", d.n_slots, d.max_len,
                        need))
                    placed = True
                    break
            if not placed:
                plan.unplaced.append(d.cfg.name)
    return plan


def reallocation_plan(nodes: Dict[str, Tuple[int, bool]],
                      lost: Sequence[ModelDemand]) -> PlacementPlan:
    """Re-place instances lost to a failure on the surviving fleet
    (min_replicas of each lost demand; no fill — keep headroom for the
    next failure)."""
    return place(nodes, lost, fill=False)


def plan_utilization(plan: PlacementPlan,
                     nodes: Dict[str, Tuple[int, bool]]) -> float:
    """Fraction of fleet VRAM used by the plan (the paper's efficiency
    objective)."""
    used = sum(a.bytes for a in plan.assignments)
    total = sum(free for free, _ in nodes.values())
    return used / total if total else 0.0


# ------------------------------------------------------------------ #
# Heterogeneity-aware, cost-optimal placement
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Capability-aware view of a node for the cost-optimal solver —
    free VRAM plus the full `NodeClass` vector (the `(bytes, legacy)`
    tuple `place()` consumes is this with the class erased)."""
    free: int
    klass: NodeClass

    @property
    def legacy(self) -> bool:
        return self.klass.legacy


def as_vram_nodes(nodes: Dict[str, NodeSpec]) -> Dict[str, Tuple[int, bool]]:
    """Erase capability vectors -> the class-blind shape `place()` eats."""
    return {nid: (s.free, s.legacy) for nid, s in nodes.items()}


def _hbm_fraction(need: int, klass: NodeClass) -> float:
    """VRAM share of the node an instance occupies — prorates node cost
    across co-hosted instances (nodes are shared; charging every tenant
    the full node would make packed nodes look expensive)."""
    budget = klass.hbm_total * (1.0 - RUNTIME_RESERVE_FRACTION)
    return min(need / budget, 1.0) if budget > 0 else 1.0


def _assign_cost_rate(a: Assignment, klass: NodeClass) -> float:
    """Prorated cost units/s this assignment consumes on its node."""
    return klass.cost_rate * _hbm_fraction(a.bytes, klass)


@dataclasses.dataclass
class _CostBin:
    node_id: str
    free: int
    klass: NodeClass
    hosted: Dict[str, int] = dataclasses.field(default_factory=dict)


def _best_node_cost(bins: List["_CostBin"], demand: ModelDemand,
                    perf: PerfModel) -> Optional[Tuple["_CostBin", str]]:
    """Pick (node, precision) minimizing modeled cost-per-token; within
    equal cost (nodes of the same class) the `place()` tie-break applies
    unchanged: anti-affinity, then highest precision, then tightest fit.
    Precision per node stays quality-first — quantization remains a
    *fit* fallback, never a cost dodge."""
    precisions = PRECISIONS if demand.allow_quant else [""]
    mix = dict(demand.bucket_mix) or None
    best = None
    best_key = None
    for b in bins:
        for p_idx, prec in enumerate(precisions):
            need = demand.bytes_at(prec)
            if need > b.free:
                continue
            cpt = perf.mix_cost_per_token(
                b.klass, demand.cfg, mix, prec,
                hbm_fraction=_hbm_fraction(need, b.klass))
            affinity = b.hosted.get(demand.cfg.name, 0)
            key = (cpt, affinity, p_idx, b.free - need)
            if best_key is None or key < best_key:
                best, best_key = (b, prec), key
            break          # higher precision fits on this node; stop
    return best


def place_cost_optimal(nodes: Dict[str, NodeSpec],
                       demands: Sequence[ModelDemand],
                       perf: Optional[PerfModel] = None,
                       fill: bool = True) -> PlacementPlan:
    """Cost-optimal replica mix: greedy over modeled cost-per-token.

    Three phases — (1) min_replicas of each demand on the cheapest
    feasible class, (2) SLO top-up: demands declaring
    `target_tokens_per_s` gain replicas (bounded by `replica_cap`) until
    the summed per-replica modeled throughput covers the target, (3) the
    usual fill phase, cheapest candidate first.  VRAM budgets are never
    exceeded (same bin accounting as `place()`); a demand whose SLO
    cannot be met keeps its replicas and the shortfall shows up in
    `plan_throughput`."""
    perf = perf or PerfModel()
    bins = [_CostBin(nid, s.free, s.klass) for nid, s in nodes.items()]
    plan = PlacementPlan()
    tput: Dict[str, float] = {d.cfg.name: 0.0 for d in demands}

    def commit(b: _CostBin, d: ModelDemand, prec: str):
        need = d.bytes_at(prec)
        b.free -= need
        b.hosted[d.cfg.name] = b.hosted.get(d.cfg.name, 0) + 1
        plan.assignments.append(Assignment(
            b.node_id, d.cfg.name, prec, d.n_slots, d.max_len, need,
            page_size=d.page_size, kv_pages=d.kv_pages))
        tput[d.cfg.name] += perf.mix_tokens_per_s(
            b.klass, d.cfg, dict(d.bucket_mix) or None, prec)

    # phase 1: min replicas, biggest models first (FFD), cheapest node
    order = sorted(demands, key=lambda d: -d.bytes_at(""))
    for d in order:
        for _ in range(d.min_replicas):
            pick = _best_node_cost(bins, d, perf)
            if pick is None:
                plan.unplaced.append(d.cfg.name)
                continue
            commit(pick[0], d, pick[1])

    # phase 2: SLO top-up — grow the most under-served demand first
    counts = {d.cfg.name: len(plan.replicas(d.cfg.name)) for d in demands}
    while True:
        lagging = [d for d in order
                   if d.target_tokens_per_s > 0
                   and d.cfg.name not in plan.unplaced
                   and tput[d.cfg.name] < d.target_tokens_per_s
                   and counts[d.cfg.name] < d.replica_cap]
        if not lagging:
            break
        lagging.sort(
            key=lambda d: tput[d.cfg.name] / d.target_tokens_per_s)
        placed_any = False
        for d in lagging:
            pick = _best_node_cost(bins, d, perf)
            if pick is not None:
                commit(pick[0], d, pick[1])
                counts[d.cfg.name] += 1
                placed_any = True
                break
        if not placed_any:
            break          # fleet exhausted; shortfall stands

    # phase 3: fill leftover VRAM, cheapest candidates first
    if fill and demands:
        exhausted: set = set()
        progress = True
        while progress:
            live = [d for d in demands
                    if d.cfg.name not in plan.unplaced
                    and d.cfg.name not in exhausted
                    and counts[d.cfg.name] < d.replica_cap]
            if not live:
                break
            progress = False
            live.sort(key=lambda d: counts[d.cfg.name] / d.weight)
            for d in live:
                pick = _best_node_cost(bins, d, perf)
                if pick is not None:
                    commit(pick[0], d, pick[1])
                    counts[d.cfg.name] += 1
                    progress = True
                    break
                exhausted.add(d.cfg.name)
    return plan


def plan_throughput(plan: PlacementPlan, nodes: Dict[str, NodeSpec],
                    demands: Sequence[ModelDemand],
                    perf: Optional[PerfModel] = None) -> Dict[str, float]:
    """Modeled aggregate output-tokens/s per model under each demand's
    bucket mix — works on any plan (cost-optimal or VRAM-only)."""
    perf = perf or PerfModel()
    by_name = {d.cfg.name: d for d in demands}
    out: Dict[str, float] = {d.cfg.name: 0.0 for d in demands}
    for a in plan.assignments:
        d = by_name.get(a.model_name)
        if d is None or a.node_id not in nodes:
            continue
        out[a.model_name] += perf.mix_tokens_per_s(
            nodes[a.node_id].klass, d.cfg,
            dict(d.bucket_mix) or None, a.quantize)
    return out


def plan_cost_per_token(plan: PlacementPlan, nodes: Dict[str, NodeSpec],
                        demands: Sequence[ModelDemand],
                        perf: Optional[PerfModel] = None) -> float:
    """Fleet-level modeled cost units per output token for a plan: total
    prorated node-cost rate / total modeled throughput.  The bench's
    headline heterogeneous metric (cost-optimal vs VRAM-only)."""
    perf = perf or PerfModel()
    by_name = {d.cfg.name: d for d in demands}
    cost_rate = 0.0
    for a in plan.assignments:
        if a.node_id in nodes and a.model_name in by_name:
            cost_rate += _assign_cost_rate(a, nodes[a.node_id].klass)
    tps = sum(plan_throughput(plan, nodes, demands, perf).values())
    return cost_rate / tps if tps > 0 else float("inf")
