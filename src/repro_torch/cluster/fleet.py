"""Fleet assembly & failure injection.

`paper_testbed()` reproduces the paper's 6-node heterogeneous deployment;
`scale_fleet()` builds thousand-node fleets from a class mix for the
large-scale placement/availability benchmarks.

This file differs from `repro.cluster.fleet` in two places:
`paper_testbed` and `scale_fleet` take the `device` the nodes' engines
run on (`None`: the card), and `scale_fleet`'s default mix names the
port's classes (`cluster.hardware`), with the reference's weights over
classes of the same memory, so the same seed builds the same memory
layout node for node.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.hardware import PAPER_TESTBED
from repro_torch.cluster.node import BackendNode
from repro_torch.device import DeviceLike


class Fleet:
    def __init__(self, nodes: Optional[List[BackendNode]] = None):
        self.nodes: Dict[str, BackendNode] = {
            n.node_id: n for n in (nodes or [])}

    def add(self, node: BackendNode):
        self.nodes[node.node_id] = node

    def remove(self, node_id: str):
        self.nodes.pop(node_id, None)

    def alive_nodes(self) -> List[BackendNode]:
        return [n for n in self.nodes.values() if n.alive]

    def pump(self, max_steps: int = 1):
        for n in self.alive_nodes():
            n.pump(max_steps)

    # failure injection ------------------------------------------- #
    def fail_node(self, node_id: str):
        self.nodes[node_id].fail()

    def fail_random(self, rng: random.Random, k: int = 1) -> List[str]:
        alive = [n.node_id for n in self.alive_nodes()]
        victims = rng.sample(alive, min(k, len(alive)))
        for v in victims:
            self.fail_node(v)
        return victims

    def recover_node(self, node_id: str):
        self.nodes[node_id].recover()

    def total_hbm(self) -> int:
        return sum(n.hbm_budget for n in self.alive_nodes())

    def used_hbm(self) -> int:
        return sum(n.hbm_used for n in self.alive_nodes())


def paper_testbed(param_store: Optional[Callable] = None,
                  device: DeviceLike = None) -> Fleet:
    """The paper's Table-2 testbed."""
    return Fleet([BackendNode(nid, klass, param_store=param_store, seed=i,
                              device=device)
                  for i, (nid, klass) in enumerate(PAPER_TESTBED)])


def scale_fleet(n_nodes: int, mix: Optional[Dict[str, float]] = None,
                param_store: Optional[Callable] = None,
                seed: int = 0, device: DeviceLike = None) -> Fleet:
    """Large fleet with a heterogeneous class mix (default: paper-like
    40% RX 6600 8 GB, 25% legacy GTX 1660 Super, 25% RX 6800 16 GB, 10%
    4x V100 16 GB)."""
    mix = mix or {"rx6600-8gb": 0.4, "gtx1660s-6gb": 0.25,
                  "rx6800-16gb": 0.25, "v100-16gb-x4": 0.10}
    rng = random.Random(seed)
    classes = list(mix)
    weights = [mix[c] for c in classes]
    fleet = Fleet()
    for i in range(n_nodes):
        klass = rng.choices(classes, weights)[0]
        fleet.add(BackendNode(f"node{i:05d}", klass,
                              param_store=param_store, seed=i,
                              device=device))
    return fleet
