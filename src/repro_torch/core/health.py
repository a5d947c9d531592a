"""Health monitoring: heartbeats, liveness deadlines, straggler detection.

HAProxy-style checks adapted to the controller loop: a node missing
`suspect_after` seconds of heartbeats is SUSPECT (demoted in routing);
missing `dead_after` it is DEAD (instances re-placed).  Per-replica EWMA
latency feeds straggler demotion in the frontend's weighted routing.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, Optional


class NodeHealth(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class HealthConfig:
    suspect_after: float = 2.0
    dead_after: float = 5.0
    straggler_factor: float = 3.0     # x median latency => straggler
    straggler_floor: float = 0.010    # ignore sub-10ms jitter


class HealthMonitor:
    """Two-level liveness: *marks* (authoritative, set by the controller
    when it confirms a death or recovery — what routing consults) and
    *heartbeat ages* (how the controller's tick loop detects silent
    failures in the first place)."""

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg if cfg is not None else HealthConfig()
        self.clock = clock
        self.last_seen: Dict[str, float] = {}
        self.latency_ewma: Dict[str, float] = {}
        self.dead_marks: set = set()
        # watchdog/operator demotions: the node still heartbeats, but a
        # pump step blew its deadline — weighted routing penalizes it
        # until the stall clears
        self.suspect_marks: set = set()

    def observe_heartbeat(self, node_id: str,
                          ts: Optional[float] = None):
        self.last_seen[node_id] = self.clock() if ts is None else ts

    def observe_latency(self, replica_key: str, seconds: float):
        prev = self.latency_ewma.get(replica_key)
        self.latency_ewma[replica_key] = seconds if prev is None \
            else 0.8 * prev + 0.2 * seconds

    def mark_dead(self, node_id: str):
        self.dead_marks.add(node_id)

    def clear_mark(self, node_id: str):
        self.dead_marks.discard(node_id)

    def mark_suspect(self, node_id: str):
        self.suspect_marks.add(node_id)

    def clear_suspect(self, node_id: str):
        self.suspect_marks.discard(node_id)

    def status(self, node_id: str) -> NodeHealth:
        """Routing-facing status: marks are authoritative; ages demote."""
        if node_id in self.dead_marks:
            return NodeHealth.DEAD
        seen = self.last_seen.get(node_id)
        if seen is None:
            return NodeHealth.DEAD
        if node_id in self.suspect_marks:
            return NodeHealth.SUSPECT
        if self.clock() - seen > self.cfg.suspect_after:
            return NodeHealth.SUSPECT
        return NodeHealth.HEALTHY

    def heartbeat_expired(self, node_id: str) -> bool:
        """Tick-loop detection: has this node missed its deadline?"""
        seen = self.last_seen.get(node_id)
        return seen is None or (self.clock() - seen > self.cfg.dead_after)

    def forget(self, node_id: str):
        self.last_seen.pop(node_id, None)
        self.dead_marks.discard(node_id)
        self.suspect_marks.discard(node_id)

    def is_straggler(self, replica_key: str) -> bool:
        lat = self.latency_ewma.get(replica_key)
        if lat is None or len(self.latency_ewma) < 3:
            return False      # need a quorum to call anyone slow
        vals = sorted(self.latency_ewma.values())
        median = vals[(len(vals) - 1) // 2]
        return lat > self.cfg.straggler_floor and median > 0 and \
            lat > self.cfg.straggler_factor * median
