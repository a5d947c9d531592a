"""Heterogeneous hardware classes — the paper's mixed NVIDIA/AMD fleet
(Table 2) as the cards themselves.

The controller never touches vendor APIs; it consumes *capability vectors*
(memory bytes, peak FLOP/s, cards per node, link bandwidth) — exactly the
abstraction that makes the paper's software-defined approach work.

This file differs from `repro.cluster.hardware` on purpose: the reference
maps each of the paper's GPUs to an accelerator class of the same memory,
while the port names the GPUs and adds the H100 it runs on.  Node for node
the testbed keeps the reference's memory per card, card count and
`legacy` flag, which is all that VRAM-aware placement (`core.placement.
place`) reads, so both packages place `paper_testbed()` alike.  Datacenter
classes stand in for the reference's scale-out classes: 4x and 8x V100
16 GB, and 8x H100 80 GB (whose placements differ, having 80 GB a card).

Every figure is NOMINAL, from the vendors' published data sheets: memory
size and bandwidth, the dense FP16/BF16 peak (the tensor-core rate with
FP32 accumulation where the card has tensor cores, twice the FP32 rate
where it does not), and the per-card link bandwidth (PCIe for the
consumer cards, NVLink for V100 and H100).  They weight routing and cost;
none was measured.  `cost_per_hour` keeps the reference's relative
weights per mapped class.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class NodeClass:
    name: str
    chips: int                   # cards in the node
    hbm_per_chip: int            # bytes of device memory per card
    flops_per_chip: float        # FP16/BF16 FLOP/s per card
    ici_bw: float                # bytes/s per card link (intra-node)
    year: int
    toolkit: str                 # paper keeps CUDA/ROCm visible in the UI
    legacy: bool = False
    # per-GPU-class performance/cost vector: memory bandwidth bounds the
    # decode roofline (weights + KV stream every step); `cost_per_hour`
    # is the class's relative cost weight — legacy cards are nearly free
    # (sunk hardware, the paper's whole premise), datacenter cards are
    # priced like cloud on-demand.  The perf model and the cost-optimal
    # placement solver consume both.
    hbm_bw: float = 900e9        # bytes/s per card
    cost_per_hour: float = 1.0   # relative cost units per node-hour

    @property
    def hbm_total(self) -> int:
        return self.chips * self.hbm_per_chip

    @property
    def flops_total(self) -> float:
        return self.chips * self.flops_per_chip

    @property
    def hbm_bw_total(self) -> float:
        return self.chips * self.hbm_bw

    @property
    def cost_rate(self) -> float:
        """Cost units per second for the whole node."""
        return self.cost_per_hour / 3600.0


NODE_CLASSES: Dict[str, NodeClass] = {c.name: c for c in [
    # the paper's consumer and legacy cards (its regime)
    NodeClass("gtx1660s-6gb", 1, 6 * GB, 10.05e12, 15.75e9, 2019, "CUDA",
              legacy=True, hbm_bw=336e9, cost_per_hour=0.10),
    NodeClass("gtx1660s-6gb-x2", 2, 6 * GB, 10.05e12, 15.75e9, 2019, "CUDA",
              legacy=True, hbm_bw=336e9, cost_per_hour=0.18),
    NodeClass("rx6600-8gb", 1, 8 * GB, 17.86e12, 15.75e9, 2021, "ROCm",
              hbm_bw=224e9, cost_per_hour=0.35),
    NodeClass("rtx3070-8gb", 1, 8 * GB, 40.6e12, 31.5e9, 2020, "CUDA",
              hbm_bw=448e9, cost_per_hour=0.35),
    NodeClass("rx6800-16gb", 1, 16 * GB, 32.33e12, 31.5e9, 2020, "ROCm",
              hbm_bw=512e9, cost_per_hour=0.60),
    # datacenter classes for scale-out
    NodeClass("v100-16gb-x4", 4, 16 * GB, 125e12, 300e9, 2017, "CUDA",
              hbm_bw=900e9, cost_per_hour=2.40),
    NodeClass("v100-16gb-x8", 8, 16 * GB, 125e12, 300e9, 2017, "CUDA",
              hbm_bw=900e9, cost_per_hour=4.80),
    # the card this port runs on (H100 SXM 80 GB), alone and eight a node
    NodeClass("h100-80gb", 1, 80 * GB, 989e12, 900e9, 2022, "CUDA",
              hbm_bw=3350e9, cost_per_hour=13.00 / 8),
    NodeClass("h100-80gb-x8", 8, 80 * GB, 989e12, 900e9, 2022, "CUDA",
              hbm_bw=3350e9, cost_per_hour=13.00),
]}

# The paper's 6-node testbed (Table 2).
PAPER_TESTBED: List[tuple] = [
    ("node1", "rx6600-8gb"),        # AMD RX 6600 8GB (ROCm)
    ("node2", "rtx3070-8gb"),       # NVIDIA RTX 3070 8GB (CUDA)
    ("node3", "gtx1660s-6gb"),      # NVIDIA GTX 1660 Super 6GB
    ("node4", "rx6600-8gb"),        # AMD RX 6600 8GB (ROCm)
    ("node5", "gtx1660s-6gb-x2"),   # 2x NVIDIA GTX 1660 Super 6GB
    ("node6", "rx6800-16gb"),       # AMD RX 6800 16GB (ROCm)
]

# Serving memory model: fraction of device memory reserved for the
# runtime and activations
RUNTIME_RESERVE_FRACTION = 0.08
