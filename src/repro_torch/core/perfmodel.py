"""Per-GPU-class performance & cost model — heterogeneity made visible.

The source paper's premise is a fleet of mixed legacy GPUs, yet until this
module every placement/routing decision reduced a node to "free VRAM +
legacy bit".  `PerfModel` closes that gap: an analytical tokens/s
estimator per ``(NodeClass, model, phase)`` over request-size buckets,
derived from each class's capability vector (FLOP/s, chips, HBM
bandwidth) through the same two-term roofline the dry-run analyzer uses
(`repro.roofline.analysis.roofline_step_s`), plus a calibration hook that
overrides analytical estimates with measured ``bench_serving`` rows.

Three consumers:

* `core.placement.place_cost_optimal` — choose the replica mix that
  minimizes modeled cost-per-token subject to VRAM and SLO-throughput
  constraints (the Mélange shape: a measured/modeled tput matrix times a
  per-class cost weight; Adaptive Orchestration and AIBrix in PAPERS.md
  make the same argument at cloud scale),
* `core.frontend.ServiceFrontend` — size-bucket routing: short chats
  prefer cheap legacy classes, long-context requests prefer fast
  big-VRAM classes, folded into the weighted-least-connection score,
* `core.controller.SDAIController` — scale-up picks *which class* to
  grow (cheapest that satisfies demand); scale-down retires the most
  expensive surplus replica first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

from repro_torch.cluster.hardware import NodeClass
from repro_torch.configs.base import BYTES, ArchConfig
from repro_torch.roofline.analysis import roofline_step_s

Phase = str                              # "prefill" | "decode"


# ------------------------------------------------------------------ #
# Request-size buckets
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class SizeBucket:
    """One (prompt-length, output-length) bucket of the request-size
    policy.  ``rep_*`` are the representative lengths estimates are
    evaluated at; ``latency_weight`` sets how much routing weighs
    modeled request latency vs cost-per-token for this bucket — short
    chats chase cheap tokens (legacy cards are fine), long-context
    requests chase fast capable nodes (they hold slots and KV pages for
    a long time, so slot-seconds dominate)."""
    name: str
    max_prompt: int                      # inclusive upper bound
    max_output: int                      # inclusive upper bound
    rep_prompt: int
    rep_output: int
    latency_weight: float

    @property
    def rep_context(self) -> int:
        return self.rep_prompt + self.rep_output


BUCKETS: Tuple[SizeBucket, ...] = (
    SizeBucket("short", 128, 128, 64, 32, 0.0),
    SizeBucket("medium", 512, 512, 256, 128, 0.5),
    SizeBucket("long", 1 << 30, 1 << 30, 2048, 256, 1.0),
)

_BY_NAME: Dict[str, SizeBucket] = {b.name: b for b in BUCKETS}

# Default traffic mix placement assumes when a demand does not declare
# one: mostly short chat, a tail of long-context work.
DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("short", 0.6), ("medium", 0.3), ("long", 0.1))


def bucket_for(prompt_len: int, max_tokens: int) -> SizeBucket:
    """The first bucket that can hold (prompt_len, max_tokens)."""
    for b in BUCKETS:
        if prompt_len <= b.max_prompt and max_tokens <= b.max_output:
            return b
    return BUCKETS[-1]


def bucket_named(name: str) -> SizeBucket:
    return _BY_NAME[name]


def normalize_mix(mix: Optional[Mapping[str, float] |
                  Iterable[Tuple[str, float]]]) -> Dict[str, float]:
    """-> bucket-name -> fraction, summing to 1 (DEFAULT_MIX when
    empty/None)."""
    pairs = dict(mix or ()) or dict(DEFAULT_MIX)
    total = sum(pairs.values())
    if total <= 0:
        pairs, total = dict(DEFAULT_MIX), 1.0
    return {k: v / total for k, v in pairs.items() if v > 0}


# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class PerfEstimate:
    """One (class, model, phase, bucket) throughput estimate."""
    tokens_per_s: float
    source: str                          # "analytical" | "measured"


class PerfModel:
    """Analytical tokens/s per (NodeClass, model, phase, bucket), with
    measured-row overrides.

    The analytical path is a per-step roofline over the class capability
    vector: decode streams the resident weights plus each active slot's
    KV window every step (memory term) and spends ~2*N_active FLOPs per
    token plus the attention term (compute term); prefill amortizes the
    weight stream over the whole prompt.  ``batch_slots`` is the assumed
    continuous-batching occupancy (engines default to 4 slots).

    `record()` / `calibrate_from_bench()` install measured rows that take
    precedence over the analytical estimate — the bench machinery is the
    profiler, this table is the model."""

    def __init__(self, batch_slots: int = 4):
        self.batch_slots = max(int(batch_slots), 1)
        # (class, model, phase, bucket) -> measured tokens/s
        self._measured: Dict[Tuple[str, str, str, str], float] = {}

    # ---- calibration --------------------------------------------- #
    def record(self, klass: str, model: str, phase: Phase, bucket: str,
               tokens_per_s: float):
        """Install one measured throughput row (overrides analytical)."""
        if tokens_per_s > 0:
            self._measured[(klass, model, phase, bucket)] = \
                float(tokens_per_s)

    def calibrate_from_bench(self, report: Mapping, klass: str,
                             model: str) -> int:
        """Ingest a ``BENCH_serving.json``-shaped report measured on
        `klass` serving `model`: every fused-variant ``tok_per_s`` row
        becomes a measured decode estimate for every bucket (the fused
        study decodes at engine batch occupancy, which is what the
        analytical decode path models).  Returns rows installed."""
        n = 0
        for variant in (report.get("fused") or {}).values():
            if not isinstance(variant, Mapping):
                continue
            tps = float(variant.get("tok_per_s", 0.0))
            if tps <= 0:
                continue
            for b in BUCKETS:
                self.record(klass, model, "decode", b.name, tps)
                n += 1
        return n

    def measured(self, klass: str, model: str, phase: Phase,
                 bucket: str) -> Optional[float]:
        return self._measured.get((klass, model, phase, bucket))

    def calibration_count(self) -> int:
        """Measured rows installed — consumers key caches on this so
        fresh calibration data invalidates stale scores."""
        return len(self._measured)

    # ---- analytical roofline ------------------------------------- #
    def _weight_bytes(self, cfg: ArchConfig, quantize: str) -> float:
        dt = {"": cfg.dtype, "int8": "int8", "int4": "int4"}[quantize]
        return cfg.num_params() * BYTES[dt]

    def _flops_per_token(self, cfg: ArchConfig, context: int) -> float:
        """Forward FLOPs per generated/processed token: 2*N_active plus
        the attention score/value matmuls over the visible window."""
        window = context if cfg.swa_window == 0 \
            else min(context, cfg.swa_window)
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * window
        return 2.0 * cfg.active_params() + attn

    def _analytic(self, klass: NodeClass, cfg: ArchConfig, phase: Phase,
                  bucket: SizeBucket, quantize: str) -> float:
        w = self._weight_bytes(cfg, quantize)
        kv_tok = cfg.kv_bytes_per_token()
        if phase == "prefill":
            toks = max(bucket.rep_prompt, 1)
            flops = toks * self._flops_per_token(cfg, bucket.rep_prompt)
            hbm = w + toks * kv_tok          # stream weights once + write KV
            t = roofline_step_s(flops, hbm, klass.flops_total,
                                klass.hbm_bw_total)
            return toks / t if t > 0 else 0.0
        # decode: one token per active slot per step; the step re-reads
        # the weights once and every slot's live KV window
        batch = self.batch_slots
        ctx = bucket.rep_prompt + bucket.rep_output // 2
        window = ctx if cfg.swa_window == 0 else min(ctx, cfg.swa_window)
        flops = batch * self._flops_per_token(cfg, ctx)
        hbm = w + batch * window * kv_tok
        t = roofline_step_s(flops, hbm, klass.flops_total,
                            klass.hbm_bw_total)
        return batch / t if t > 0 else 0.0

    # ---- public estimates ---------------------------------------- #
    def estimate(self, klass: NodeClass, cfg: ArchConfig, phase: Phase,
                 bucket: SizeBucket, quantize: str = "") -> PerfEstimate:
        m = self.measured(klass.name, cfg.name, phase, bucket.name)
        if m is not None:
            return PerfEstimate(m, "measured")
        return PerfEstimate(
            self._analytic(klass, cfg, phase, bucket, quantize),
            "analytical")

    def tokens_per_s(self, klass: NodeClass, cfg: ArchConfig,
                     phase: Phase, bucket: SizeBucket,
                     quantize: str = "") -> float:
        return self.estimate(klass, cfg, phase, bucket,
                             quantize).tokens_per_s

    def request_latency_s(self, klass: NodeClass, cfg: ArchConfig,
                          bucket: SizeBucket, quantize: str = "") -> float:
        """Modeled wall-clock for one request of this bucket's shape:
        prefill the prompt, then decode the output at the per-sequence
        token rate (engine decode tokens/s is batch-aggregate)."""
        pre = self.tokens_per_s(klass, cfg, "prefill", bucket, quantize)
        dec = self.tokens_per_s(klass, cfg, "decode", bucket, quantize)
        if pre <= 0 or dec <= 0:
            return float("inf")
        per_seq = dec / self.batch_slots
        return bucket.rep_prompt / pre + bucket.rep_output / per_seq

    def bucket_tokens_per_s(self, klass: NodeClass, cfg: ArchConfig,
                            bucket: SizeBucket,
                            quantize: str = "") -> float:
        """Engine-level *output* tokens/s serving only this bucket:
        batch_slots concurrent requests, each paying prefill + decode."""
        lat = self.request_latency_s(klass, cfg, bucket, quantize)
        if lat <= 0 or lat == float("inf"):
            return 0.0
        return self.batch_slots * bucket.rep_output / lat

    def mix_tokens_per_s(self, klass: NodeClass, cfg: ArchConfig,
                         mix: Optional[Mapping[str, float]] = None,
                         quantize: str = "") -> float:
        """Time-weighted (harmonic) throughput over a bucket mix — the
        per-replica service rate placement sums against SLO targets."""
        denom = 0.0
        for name, frac in normalize_mix(mix).items():
            tps = self.bucket_tokens_per_s(klass, cfg, bucket_named(name),
                                           quantize)
            if tps <= 0:
                return 0.0
            denom += frac / tps
        return 1.0 / denom if denom > 0 else 0.0

    # ---- cost ------------------------------------------------------ #
    def cost_per_token(self, klass: NodeClass, cfg: ArchConfig,
                       bucket: SizeBucket, quantize: str = "",
                       hbm_fraction: float = 1.0) -> float:
        """Modeled cost units per generated token on this class for this
        bucket.  ``hbm_fraction`` prorates the node's cost by the VRAM
        share the instance occupies (instances share nodes; the paper's
        objective is to fully exploit each node's VRAM)."""
        tps = self.bucket_tokens_per_s(klass, cfg, bucket, quantize)
        if tps <= 0:
            return float("inf")
        return klass.cost_rate * max(min(hbm_fraction, 1.0), 0.0) / tps

    def mix_cost_per_token(self, klass: NodeClass, cfg: ArchConfig,
                           mix: Optional[Mapping[str, float]] = None,
                           quantize: str = "",
                           hbm_fraction: float = 1.0) -> float:
        tps = self.mix_tokens_per_s(klass, cfg, mix, quantize)
        if tps <= 0:
            return float("inf")
        return klass.cost_rate * max(min(hbm_fraction, 1.0), 0.0) / tps

    # ---- routing scores -------------------------------------------- #
    def routing_scores(self, classes: Iterable[NodeClass],
                       cfg: ArchConfig,
                       bucket: SizeBucket) -> Dict[str, float]:
        """Per-class routing score for one (model, bucket): a blend of
        normalized cost-per-token and normalized request latency, the
        bucket's ``latency_weight`` sliding between them.  The best class
        scores 1.0; the frontend turns (score - 1) into virtual
        connections.  Short buckets (weight 0) chase cheap tokens ->
        legacy classes win; long buckets (weight 1) chase modeled
        latency -> big-VRAM high-bandwidth classes win."""
        classes = list(classes)
        cost = {k.name: self.cost_per_token(k, cfg, bucket)
                for k in classes}
        lat = {k.name: self.request_latency_s(k, cfg, bucket)
               for k in classes}
        c_min = min(cost.values(), default=0.0)
        l_min = min(lat.values(), default=0.0)
        out: Dict[str, float] = {}
        lw = bucket.latency_weight
        for k in classes:
            c = cost[k.name] / c_min if c_min > 0 else 1.0
            lt = lat[k.name] / l_min if l_min > 0 else 1.0
            out[k.name] = (1.0 - lw) * c + lw * lt
        return out
