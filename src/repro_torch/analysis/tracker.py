"""Runtime lock-order validator — the dynamic half of the deadlock
defense (a lightweight TSan for the pump/cancel/migration races).

A copy of `repro.analysis.tracker` over the port: `install()` patches
`repro_torch.cluster.node.BackendNode` / `Instance` and
`repro_torch.serving.scheduler.Scheduler`, and this module keeps its own
`_active`, so the port's tracker can be installed while the JAX
package's is live (the tier-1 conftest installs that one for the whole
suite).

`install()` wraps the three ranked locks (`BackendNode.lock`,
`Instance.lock`, `Scheduler._lock`) in `TrackedLock` proxies at
construction time; every acquisition pushes onto a thread-local held
stack and checks its rank against the stack top, and the observed edge
set cross-validates against `repro_torch.analysis.locks.allowed_edges()`.
No `threading.Condition` of the port is built over a ranked lock (the
node's `work_cv` has a plain lock of its own), so `TrackedLock` needs no
`_release_save` / `_acquire_restore` and has none.

Pure stdlib, import-light: installing touches repro_torch.cluster /
serving lazily, so `repro_torch.analysis` itself imports neither torch
nor jax.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.locks import LOCK_RANKS, allowed_edges


@dataclasses.dataclass(frozen=True)
class OrderViolation:
    thread: str
    held_level: str
    acquired_level: str

    def render(self) -> str:
        return (f"[{self.thread}] acquired {self.acquired_level!r} lock "
                f"while holding {self.held_level!r} — violates "
                f"node -> instance -> scheduler")


class LockOrderTracker:
    """Thread-safe recorder of actual lock-acquisition orders."""

    def __init__(self, ranks: Optional[Dict[str, int]] = None):
        self.ranks = dict(LOCK_RANKS) if ranks is None else dict(ranks)
        self._local = threading.local()
        self._mu = threading.Lock()
        self.violations: List[OrderViolation] = []
        self.edges: Set[Tuple[str, str]] = set()
        self.acquisitions = 0

    def _stack(self) -> List[Tuple[str, int]]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    # -------------------------------------------------------------- #
    def on_acquire(self, level: str, lock_id: int) -> None:
        st = self._stack()
        reentrant = any(lid == lock_id for _, lid in st)
        if st and not reentrant:
            held_levels = {lvl for lvl, _ in st}
            top_level = st[-1][0]
            with self._mu:
                self.acquisitions += 1
                for h in held_levels:
                    self.edges.add((h, level))
                bad = (self.ranks[level] <= self.ranks[top_level])
                if bad:
                    self.violations.append(OrderViolation(
                        thread=threading.current_thread().name,
                        held_level=top_level, acquired_level=level))
        else:
            with self._mu:
                self.acquisitions += 1
        st.append((level, lock_id))

    def on_release(self, lock_id: int) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][1] == lock_id:
                del st[i]
                return

    # -------------------------------------------------------------- #
    def disallowed_edges(self) -> Set[Tuple[str, str]]:
        """Observed edges outside the static hierarchy (empty == the
        runtime agreed with the analyzer)."""
        return self.edges - allowed_edges()

    def report(self) -> str:
        lines = [f"lock acquisitions observed: {self.acquisitions}",
                 f"nesting edges: {sorted(self.edges)}"]
        lines += [v.render() for v in self.violations]
        return "\n".join(lines)


class TrackedLock:
    """Context-manager/acquire/release proxy reporting to a tracker.
    Reentrant acquisitions of the same underlying lock are recorded but
    never flagged (the ranked locks are RLocks or never re-entered)."""

    def __init__(self, inner, level: str, tracker: LockOrderTracker):
        self._inner = inner
        self._level = level
        self._tracker = tracker

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._tracker.on_acquire(self._level, id(self._inner))
        return ok

    def release(self) -> None:
        self._inner.release()
        self._tracker.on_release(id(self._inner))

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ------------------------------------------------------------------ #
@dataclasses.dataclass
class _InstallHandle:
    node_init: object
    inst_init: object
    sched_init: object


_active: Optional[_InstallHandle] = None


def install(tracker: LockOrderTracker) -> _InstallHandle:
    """Wrap the ranked locks of every BackendNode/Instance/Scheduler
    constructed from now on.  Returns the handle `uninstall` needs."""
    global _active
    if _active is not None:
        raise RuntimeError("LockOrderTracker already installed")
    from repro_torch.cluster import node as node_mod
    from repro_torch.serving import scheduler as sched_mod

    orig_node = node_mod.BackendNode.__init__
    orig_inst = node_mod.Instance.__init__
    orig_sched = sched_mod.Scheduler.__init__

    def node_init(self, *a, **k):
        orig_node(self, *a, **k)
        self.lock = TrackedLock(self.lock, "node", tracker)

    def inst_init(self, *a, **k):
        orig_inst(self, *a, **k)
        self.lock = TrackedLock(self.lock, "instance", tracker)

    def sched_init(self, *a, **k):
        orig_sched(self, *a, **k)
        self._lock = TrackedLock(self._lock, "scheduler", tracker)

    node_mod.BackendNode.__init__ = node_init
    node_mod.Instance.__init__ = inst_init
    sched_mod.Scheduler.__init__ = sched_init
    _active = _InstallHandle(orig_node, orig_inst, orig_sched)
    return _active


def uninstall(handle: Optional[_InstallHandle] = None) -> None:
    global _active
    h = handle if handle is not None else _active
    if h is None:
        return
    from repro_torch.cluster import node as node_mod
    from repro_torch.serving import scheduler as sched_mod
    node_mod.BackendNode.__init__ = h.node_init
    node_mod.Instance.__init__ = h.inst_init
    sched_mod.Scheduler.__init__ = h.sched_init
    _active = None
