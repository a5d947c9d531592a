"""Controller event bus: every orchestration action is an auditable event
(what the SDAI dashboard renders)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence

# Failure/recovery event kinds.  Emitters elsewhere pass ad-hoc strings
# for routine orchestration actions; the fault-tolerance kinds are named
# here because the admin snapshot (`FleetSnapshot.failure_events`) and
# the chaos harness both count them by exact name.
REQUEST_MIGRATED = "request_migrated"   # mid-stream resume on a new replica
NODE_SUSPECTED = "node_suspected"       # demoted in weighted routing
WATCHDOG_FIRED = "watchdog_fired"       # a pump step blew its deadline
FAULT_INJECTED = "fault_injected"       # chaos harness applied a fault

FAILURE_EVENT_KINDS = (REQUEST_MIGRATED, NODE_SUSPECTED, WATCHDOG_FIRED,
                       FAULT_INJECTED)


@dataclasses.dataclass
class Event:
    kind: str
    data: Dict[str, Any]
    ts: float = dataclasses.field(default_factory=time.monotonic)


class EventBus:
    def __init__(self, keep: int = 10_000):
        self.events: List[Event] = []
        self.keep = keep
        self.subscribers: List[Callable[[Event], None]] = []

    def emit(self, kind: str, **data):
        ev = Event(kind, data)
        self.events.append(ev)
        if len(self.events) > self.keep:
            self.events = self.events[-self.keep:]
        for sub in self.subscribers:
            sub(ev)
        return ev

    def subscribe(self, fn: Callable[[Event], None]):
        self.subscribers.append(fn)

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]

    def counts(self, kinds: Sequence[str]) -> Dict[str, int]:
        """Occurrence count per kind over the retained window (the admin
        snapshot's failure-event summary)."""
        out = {k: 0 for k in kinds}
        for e in self.events:
            if e.kind in out:
                out[e.kind] += 1
        return out
