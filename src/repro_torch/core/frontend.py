"""Service Frontend — the HAProxy analogue.

Health-checked, weighted-least-connection routing over model replicas, with
retries and transparent failover.  Every backend node also gets a
`NodeProxy` view (the paper runs HAProxy *on each node* so multiple replicas
of one model can live on one node or across nodes); the frontend composes
them into one logical endpoint per model — the unified client interface.

Multi-tenancy lives here too: per-tenant token buckets (`TenantQuota`)
rate-limit requests/s and generated-tokens/s at admission, so one tenant's
burst degrades into structured `RATE_LIMITED` rejections instead of eating
the whole fleet's slots.  Buckets are thread-safe — with the
`ServingRuntime` started, callers admit from arbitrary threads.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.fleet import Fleet
from repro_torch.configs import ZOO
from repro_torch.configs.base import ArchConfig
from repro_torch.core.health import HealthMonitor, NodeHealth
from repro_torch.core.perfmodel import PerfModel, SizeBucket, bucket_for
from repro_torch.core.registry import ReplicaKey, ReplicaRegistry
from repro_torch.serving.request import (CODE_ENGINE_FAILED, CODE_NO_BACKEND,
                                   Request)


@dataclasses.dataclass
class FrontendConfig:
    max_retries: int = 3
    straggler_penalty: float = 10.0     # virtual connections added to
    suspect_penalty: float = 10.0       # stragglers / suspect nodes
    # size-bucket routing: virtual connections added per unit of
    # class-mismatch (perf-model routing score - 1).  0 disables the
    # heterogeneity-aware term and recovers pure least-connections.
    bucket_affinity: float = 4.0


@dataclasses.dataclass
class FrontendStats:
    routed: int = 0
    failed: int = 0
    retried: int = 0
    rejected_no_backend: int = 0
    per_replica: Dict[str, int] = dataclasses.field(default_factory=dict)
    # bucket name -> count, and bucket name -> node-class name -> count
    routed_by_bucket: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    per_bucket_class: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)


# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant rate limits.  0 disables that dimension.  Bursts
    default to one second's worth of rate (min 1), so a quota of
    5 req/s admits 5 back-to-back then refills continuously.

    `weight` is the tenant's fair-queuing share inside every engine's
    DWRR scheduler: under contention a weight-3 tenant is served ~3x the
    tokens of a weight-1 tenant.  It does not gate admission."""
    requests_per_s: float = 0.0
    tokens_per_s: float = 0.0
    burst_requests: float = 0.0
    burst_tokens: float = 0.0
    weight: float = 1.0

    def request_burst(self) -> float:
        return self.burst_requests or max(self.requests_per_s, 1.0)

    def token_burst(self) -> float:
        return self.burst_tokens or max(self.tokens_per_s, 1.0)


@dataclasses.dataclass
class TenantUsage:
    admitted: int = 0
    rate_limited: int = 0
    tokens_charged: int = 0
    refunds: int = 0           # cancelled-before-admission give-backs


class _TokenBucket:
    """Classic leaky/token bucket: `rate` units/s refill up to `burst`."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = rate
        self.burst = burst
        self.clock = clock
        self.level = burst
        self._last = clock()

    def _refill(self):
        now = self.clock()
        self.level = min(self.burst,
                         self.level + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float) -> bool:
        self._refill()
        if self.level >= n:
            self.level -= n
            return True
        return False


class TenantLimiter:
    """Thread-safe registry of per-tenant request/token buckets."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.quotas: Dict[str, TenantQuota] = {}
        self.usage: Dict[str, TenantUsage] = {}
        self._req_buckets: Dict[str, _TokenBucket] = {}
        self._tok_buckets: Dict[str, _TokenBucket] = {}
        self._lock = threading.Lock()

    def set_quota(self, tenant: str, quota: Optional[TenantQuota]):
        """Install (or, with None, remove) a tenant's rate limits.
        Resets the tenant's buckets to a full burst."""
        with self._lock:
            self._req_buckets.pop(tenant, None)
            self._tok_buckets.pop(tenant, None)
            if quota is None:
                self.quotas.pop(tenant, None)
                return
            self.quotas[tenant] = quota
            if quota.requests_per_s > 0:
                self._req_buckets[tenant] = _TokenBucket(
                    quota.requests_per_s, quota.request_burst(), self.clock)
            if quota.tokens_per_s > 0:
                self._tok_buckets[tenant] = _TokenBucket(
                    quota.tokens_per_s, quota.token_burst(), self.clock)

    def admit(self, tenant: str, projected_tokens: int) -> Optional[str]:
        """Charge one request + its projected token budget against the
        tenant's buckets.  Returns None when admitted, else a human
        reason (the caller maps it to `RATE_LIMITED`).  Tenants without
        an installed quota (including the anonymous "") are unlimited
        and untracked — usage state stays bounded by the number of
        configured quotas, not by caller-supplied tenant strings."""
        with self._lock:
            if tenant not in self.quotas:
                return None
            usage = self.usage.setdefault(tenant, TenantUsage())
            rb = self._req_buckets.get(tenant)
            tb = self._tok_buckets.get(tenant)
            if rb is not None and not rb.try_take(1.0):
                usage.rate_limited += 1
                return (f"tenant {tenant!r} over request rate "
                        f"({self.quotas[tenant].requests_per_s:g} req/s)")
            if tb is not None and \
                    not tb.try_take(float(projected_tokens)):
                if rb is not None:      # roll back the request charge
                    rb.level = min(rb.burst, rb.level + 1.0)
                usage.rate_limited += 1
                return (f"tenant {tenant!r} over token rate "
                        f"({self.quotas[tenant].tokens_per_s:g} tok/s)")
            usage.admitted += 1
            usage.tokens_charged += projected_tokens
            return None

    def refund(self, tenant: str, projected_tokens: int):
        """Give back one request + its projected token charge — the
        request was cancelled while still queued, so it never consumed
        engine capacity.  Buckets refill up to their burst; usage books
        the refund so dashboards stay honest."""
        with self._lock:
            if tenant not in self.quotas:
                return
            usage = self.usage.setdefault(tenant, TenantUsage())
            rb = self._req_buckets.get(tenant)
            tb = self._tok_buckets.get(tenant)
            if rb is not None:
                rb.level = min(rb.burst, rb.level + 1.0)
            if tb is not None:
                tb.level = min(tb.burst,
                               tb.level + float(projected_tokens))
            usage.tokens_charged -= projected_tokens
            usage.refunds += 1

    def weight(self, tenant: str) -> float:
        """The tenant's DWRR fair-queuing weight (1.0 when no quota is
        installed).  Thread-safe: engine schedulers call this on the hot
        admission path."""
        with self._lock:
            q = self.quotas.get(tenant)
            return q.weight if q is not None else 1.0

    def snapshot(self) -> Dict[str, Dict]:
        """tenant -> {quota, usage} for the admin surface."""
        with self._lock:
            out = {}
            for tenant in set(self.quotas) | set(self.usage):
                q = self.quotas.get(tenant)
                u = self.usage.get(tenant, TenantUsage())
                out[tenant] = {"quota": q, "usage": dataclasses.replace(u)}
            return out


class ServiceFrontend:
    def __init__(self, fleet: Fleet, replicas: ReplicaRegistry,
                 monitor: HealthMonitor,
                 cfg: Optional[FrontendConfig] = None,
                 perf: Optional[PerfModel] = None,
                 catalog: Optional[Dict[str, ArchConfig]] = None):
        self.fleet = fleet
        self.replicas = replicas
        self.monitor = monitor
        self.cfg = cfg if cfg is not None else FrontendConfig()
        self.perf = perf if perf is not None else PerfModel()
        self.catalog = catalog if catalog is not None else ZOO
        self.stats = FrontendStats()
        self.tenants = TenantLimiter()
        self._last_pick: Dict[str, int] = {}
        self._pick_seq = 0
        # (model, bucket, live-class set, calibration epoch) -> scores
        self._score_cache: Dict[tuple, Dict[str, float]] = {}

    # ------------------------------------------------------------- #
    def _replica_load(self, key: ReplicaKey) -> Optional[float]:
        node = self.fleet.nodes.get(key.node_id)
        if node is None or not node.alive:
            return None
        if self.monitor.status(key.node_id) == NodeHealth.DEAD:
            return None
        inst = node.instances.get(key.instance_id)
        if inst is None or not inst.alive:
            return None
        load = float(inst.load)
        # capability weighting: stronger nodes look "less loaded"
        load /= max(node.klass.flops_total / 1e14, 1e-3)
        if self.monitor.is_straggler(str(key)):
            load += self.cfg.straggler_penalty
        if self.monitor.status(key.node_id) == NodeHealth.SUSPECT:
            load += self.cfg.suspect_penalty
        return load

    def healthy_replicas(self, model: str) -> List[ReplicaKey]:
        out = []
        for info in self.replicas.for_model(model):
            if self._replica_load(info.key) is not None:
                out.append(info.key)
        return out

    def _class_scores(self, model: str,
                      bucket: SizeBucket) -> Dict[str, float]:
        """Per-node-class routing scores (1.0 = best class) for one
        (model, bucket), over the classes that currently host healthy
        replicas of the model.  Cached; the cache key carries the live
        class set and the perf model's calibration epoch so topology
        changes and new measured rows invalidate naturally."""
        if model not in self.catalog:
            return {}
        cfg = self.catalog.get(model)
        klasses = {}
        for info in self.replicas.for_model(model):
            node = self.fleet.nodes.get(info.key.node_id)
            if node is not None and node.alive:
                klasses[node.klass.name] = node.klass
        if len(klasses) < 2:
            return {}          # homogeneous: nothing to discriminate
        key = (model, bucket.name, tuple(sorted(klasses)),
               self.perf.calibration_count())
        if key not in self._score_cache:
            self._score_cache[key] = self.perf.routing_scores(
                klasses.values(), cfg, bucket)
        return self._score_cache[key]

    def pick(self, model: str, exclude: Optional[set] = None,
             bucket: Optional[SizeBucket] = None) -> Optional[ReplicaKey]:
        """Weighted least-connections with round-robin tie-breaking (so
        instantly-completing requests still spread across replicas).

        With a `bucket`, the request-size policy folds in: replicas on a
        class the perf model scores poorly for this bucket carry extra
        virtual connections (`bucket_affinity` per unit of mismatch), so
        short chats drift to cheap legacy classes and long-context
        requests to fast big-VRAM classes — but a hammered "right" class
        still sheds load onto the "wrong" one (it is a preference, not a
        partition)."""
        scores = self._class_scores(model, bucket) \
            if bucket is not None else {}
        best, best_key = None, None
        for info in self.replicas.for_model(model):
            if exclude and info.key in exclude:
                continue
            load = self._replica_load(info.key)
            if load is None:
                continue
            if scores:
                node = self.fleet.nodes.get(info.key.node_id)
                if node is not None:
                    mismatch = scores.get(node.klass.name, 1.0) - 1.0
                    load += self.cfg.bucket_affinity * mismatch
            last = self._last_pick.get(str(info.key), -1)
            sort_key = (load, last)
            if best_key is None or sort_key < best_key:
                best, best_key = info.key, sort_key
        if best is not None:
            self._pick_seq += 1
            self._last_pick[str(best)] = self._pick_seq
        return best

    # ------------------------------------------------------------- #
    def submit(self, req: Request) -> bool:
        """Route with health-checked failover: on backend failure the
        request transparently retries on the next-best replica.

        Finish callbacks are suppressed while the retry loop runs so a
        streaming handle never sees a transient attempt failure as the
        request's final outcome; the settled outcome (success, routed, or
        terminal failure) fires exactly once on exit."""
        tried: set = set()
        last_code = CODE_ENGINE_FAILED
        bucket = bucket_for(len(req.prompt), req.sampling.max_tokens)
        req._suppress_finish = True
        try:
            for attempt in range(self.cfg.max_retries + 1):
                key = self.pick(req.model, exclude=tried, bucket=bucket)
                if key is None:
                    self.stats.rejected_no_backend += 1
                    req.finish(error="no healthy backend",
                               code=CODE_NO_BACKEND)
                    return False
                tried.add(key)
                node = self.fleet.nodes[key.node_id]
                t0 = time.monotonic()
                ok = node.submit(key.instance_id, req)
                if ok:
                    self.stats.routed += 1
                    rk = str(key)
                    self.stats.per_replica[rk] = \
                        self.stats.per_replica.get(rk, 0) + 1
                    self.stats.routed_by_bucket[bucket.name] = \
                        self.stats.routed_by_bucket.get(bucket.name, 0) + 1
                    by_class = self.stats.per_bucket_class.setdefault(
                        bucket.name, {})
                    kn = node.klass.name
                    by_class[kn] = by_class.get(kn, 0) + 1
                    self.monitor.observe_latency(rk, time.monotonic() - t0)
                    return True
                # backend refused / died mid-submit: reset & fail over
                self.stats.retried += 1
                if req.error_code:
                    last_code = req.error_code
                req.reset_for_retry()
            self.stats.failed += 1
            # keep the last attempt's class: all-queues-full must surface
            # as OVERLOADED (retryable 429), not an engine failure
            req.finish(error="all replicas failed", code=last_code)
            return False
        finally:
            req._suppress_finish = False
            if req.finished_at is not None:
                req._fire_finish()

    # ------------------------------------------------------------- #
    def routing_table(self) -> Dict[str, List[str]]:
        """model -> healthy replica keys (the generated HAProxy config)."""
        return {m: [str(k) for k in self.healthy_replicas(m)]
                for m in self.replicas.models()}
