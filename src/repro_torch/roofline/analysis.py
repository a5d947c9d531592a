"""Three-term roofline of one step, from the counts of a run
(`roofline.op_profile`), the counterpart of `repro.roofline.analysis`:

    compute_term    = FLOPs a rank / peak FLOP/s of one card
    memory_term     = bytes a rank / memory bytes/s of one card
    collective_term = collective wire bytes a rank / link bytes/s

This file differs from the reference on purpose.  The counts come from a
dispatch mode over the step's run on each rank's own blocks (per rank by
construction), not from parsing a compiled program, so `analyze` takes
an `OpProfile` and `collective_bytes` takes the collectives' records
(kind, the full buffer's bytes, the group's size), not program text; the
ring model and the `Roofline` fields and methods are the reference's.
The constants are one H100 SXM's data-sheet peaks (dense BF16 on the
tensor cores, HBM3 bandwidth, at the full 700 W limit), the ones
`chip_smoke.py` bounds the kernels with, and NVLink 4's rate in one
direction.  `roofline_step_s` (the perf model's two-term step time,
`core.perfmodel`) and `model_flops_for` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

PEAK_FLOPS = 989e12          # bf16 FLOP/s, one H100 SXM
HBM_BW = 3.35e12             # bytes/s, one H100 SXM
# NVLink 4 on the H100 SXM: 900 GB/s a card over its 18 links, both
# directions together (NVIDIA H100 Tensor Core GPU data sheet), so
# 450 GB/s each way; a ring collective sends and receives at once
LINK_BW = 450e9              # bytes/s, one direction


def roofline_step_s(flops: float, hbm_bytes: float,
                    peak_flops: float = PEAK_FLOPS,
                    hbm_bw: float = HBM_BW) -> float:
    """Idealized step time under a two-term roofline: compute and memory
    perfectly overlap, so the step takes the *max* of the two terms.

    Parameterized over the capability vector (peak FLOP/s, memory
    bytes/s) so the per-GPU-class perf model (`core.perfmodel`) prices
    every node class with it."""
    if peak_flops <= 0 or hbm_bw <= 0:
        return float("inf")
    return max(flops / peak_flops, hbm_bytes / hbm_bw)


def collective_bytes(records: Iterable, n_devices: int = 2
                     ) -> Dict[str, float]:
    """Per-kind *wire bytes per device* (ring model) of collective
    records (`distributed.sharding.CollectiveRecord`: kind, F the full
    buffer's bytes, g the group's size; n_devices stands in for a size
    of 0):
      all-gather / reduce-scatter / all-to-all: F*(g-1)/g
      all-reduce: 2*F*(g-1)/g        collective-permute: F
    (the classic ring-collective cost)."""
    out: Dict[str, float] = {}
    for r in records:
        f, g = float(r.payload_bytes), (r.group_size or n_devices)
        if r.kind == "all-reduce":
            wire = 2.0 * f * (g - 1) / g
        elif r.kind == "collective-permute":
            wire = f
        else:                            # all-gather, reduce-scatter, a2a
            wire = f * (g - 1) / g
        out[r.kind] = out.get(r.kind, 0.0) + wire
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, float]
    chips: int
    # traffic inside the kernels' plain versions (attention scores, the
    # int8 product's dequantized weight): on-chip in the hand-written
    # kernel, memory traffic only in the plain version the count runs
    kernel_bytes_per_chip: float = 0.0
    kernel_coll_bytes_per_chip: float = 0.0
    # derived (raw = plain versions; adj = kernel-adjusted)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    memory_adj_s: float = 0.0
    collective_adj_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def finish(self, model_flops_global: float = 0.0):
        self.compute_s = self.flops_per_chip / PEAK_FLOPS
        self.memory_s = self.bytes_per_chip / HBM_BW
        self.collective_s = self.coll_bytes_per_chip / LINK_BW
        self.memory_adj_s = max(
            self.bytes_per_chip - self.kernel_bytes_per_chip, 0.0) / HBM_BW
        self.collective_adj_s = max(
            self.coll_bytes_per_chip - self.kernel_coll_bytes_per_chip,
            0.0) / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_adj_s,
                 "collective": self.collective_adj_s}
        self.dominant = max(terms, key=terms.get)
        self.model_flops = model_flops_global
        counted = self.flops_per_chip * self.chips
        self.useful_ratio = (model_flops_global / counted
                             if counted else 0.0)
        return self

    def bound_s(self) -> float:
        """Idealized step time if terms perfectly overlap = max of terms
        (kernel-adjusted memory/collective)."""
        return max(self.compute_s, self.memory_adj_s,
                   self.collective_adj_s)

    def roofline_fraction(self) -> float:
        """compute_term / max-term: 1.0 when compute-bound (the goal)."""
        b = self.bound_s()
        return self.compute_s / b if b else 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(prof, chips: int, model_flops_global: float = 0.0) -> Roofline:
    """The roofline of one step from its per-rank counts (an `OpProfile`
    of one rank; every rank's block is alike), on `chips` ranks."""
    return Roofline(
        flops_per_chip=prof.flops, bytes_per_chip=prof.bytes,
        coll_bytes_per_chip=prof.coll_bytes,
        coll_breakdown=dict(prof.coll_breakdown),
        kernel_bytes_per_chip=prof.kernel_bytes,
        kernel_coll_bytes_per_chip=prof.kernel_coll_bytes,
        chips=chips).finish(model_flops_global)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N_active D for a train step (D the tokens it
    processes), 2 N_active D for a prefill, 2 N_active a sequence for a
    decode step, as `repro.roofline.analysis.model_flops_for`."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens()
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens()      # forward only
    return 2.0 * n * shape.batch             # decode: one token per seq
