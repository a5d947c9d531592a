"""Registries: the controller's authoritative view of nodes, models, and
deployed replicas (what the SDAI dashboard's agent cards render)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class ReplicaKey:
    node_id: str
    instance_id: int

    def __hash__(self):
        return hash((self.node_id, self.instance_id))

    def __eq__(self, other):
        return (self.node_id, self.instance_id) == \
            (other.node_id, other.instance_id)

    def __str__(self):
        return f"{self.node_id}/{self.instance_id}"


@dataclasses.dataclass
class ReplicaInfo:
    key: ReplicaKey
    model_name: str
    quantize: str
    n_slots: int
    max_len: int
    bytes: int


class ModelCatalog:
    """The deployable model zoo (paper Table 1)."""

    def __init__(self):
        self._models: Dict[str, ArchConfig] = {}

    def register(self, cfg: ArchConfig):
        self._models[cfg.name] = cfg

    def get(self, name: str) -> ArchConfig:
        return self._models[name]

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def names(self) -> List[str]:
        return sorted(self._models)


class NodeRegistry:
    def __init__(self):
        self.payloads: Dict[str, Dict] = {}

    def register(self, payload: Dict):
        self.payloads[payload["node_id"]] = payload

    def deregister(self, node_id: str):
        self.payloads.pop(node_id, None)

    def capacities(self) -> Dict[str, int]:
        return {nid: p["hbm_budget"] for nid, p in self.payloads.items()}

    def ids(self) -> List[str]:
        return sorted(self.payloads)


class ReplicaRegistry:
    def __init__(self):
        self.replicas: Dict[ReplicaKey, ReplicaInfo] = {}

    def add(self, info: ReplicaInfo):
        self.replicas[info.key] = info

    def remove(self, key: ReplicaKey):
        self.replicas.pop(key, None)

    def for_model(self, model_name: str) -> List[ReplicaInfo]:
        return [r for r in self.replicas.values()
                if r.model_name == model_name]

    def on_node(self, node_id: str) -> List[ReplicaInfo]:
        return [r for r in self.replicas.values()
                if r.key.node_id == node_id]

    def models(self) -> List[str]:
        return sorted({r.model_name for r in self.replicas.values()})
