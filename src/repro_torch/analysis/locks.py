"""Lock-order analyzer — static half of the deadlock defense.

A copy of `repro.analysis.locks`, unchanged but for this docstring and
the caller's module passed to `ProjectIndex.resolve_call` (core.py's
departure): the port keeps the reference's classes and lock attributes
(`BackendNode.lock`, `Instance.lock`, `Scheduler._lock`), so the
hierarchy, the owner map and the receiver hints carry over as they are.

The runtime's canonical hierarchy is ``node -> instance -> scheduler``
(documented at `BackendNode.__init__`, load-bearing for the sharded
pump): a thread holding a later lock must never acquire an earlier one.
This checker extracts every acquisition site (`with <lock>` plus
explicit ``.acquire()``/``.release()`` pairs), classifies it onto the
hierarchy by owner class / receiver name, and propagates "eventually
acquires" summaries over the name-based call graph so an inversion
hiding two calls deep is still an edge.

Unranked locks (``work_cv``, handle ``_cv``, gateway stats/inflight
locks, HTTP server locks) are deliberately outside the hierarchy: they
are leaf locks by convention and never wrap a ranked acquisition; the
runtime `LockOrderTracker` (tracker.py) cross-checks the same ranks
against actual acquisition orders.  The port adds three unranked locks
of its own, all leaves: the Gateway handle's condition (its `result()`
waits on it), and in `kernels/ops.py` the kernel build lock and the
launch-counter lock.  The last two are taken while `Instance.lock` is
held — a pump steps an engine under its instance's lock, and every
kernel wrapper counts its launch (and builds the kernels at first use)
inside the step — but neither body acquires any lock, so the nesting
is instance -> leaf and adds no edge between ranked locks.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Checker, FunctionInfo, ProjectIndex,
                                 Violation, dotted_parts)

CANONICAL_ORDER: Tuple[str, ...] = ("node", "instance", "scheduler")
LOCK_RANKS: Dict[str, int] = {n: i for i, n in enumerate(CANONICAL_ORDER)}

# `self.<attr>` acquisitions classified by owner class
_SELF_LOCKS: Dict[Tuple[str, str], str] = {
    ("BackendNode", "lock"): "node",
    ("Instance", "lock"): "instance",
    ("Scheduler", "_lock"): "scheduler",
}
# `<owner>.lock` / `<owner>._lock` acquisitions classified by the
# receiver's conventional local name
_OWNER_HINTS: Dict[str, str] = {
    "inst": "instance", "instance": "instance", "victim": "instance",
    "node": "node",
    "scheduler": "scheduler", "sched": "scheduler",
}


def classify_lock(expr: ast.expr, cls: Optional[str]) -> Optional[str]:
    """Hierarchy level for a lock expression, or None if unranked."""
    parts = dotted_parts(expr)
    if parts is None or len(parts) < 2:
        return None
    attr = parts[-1]
    if attr not in ("lock", "_lock"):
        return None
    owner = parts[-2]
    if owner == "self" and len(parts) == 2:
        return _SELF_LOCKS.get((cls or "", attr))
    return _OWNER_HINTS.get(owner)


def allowed_edges() -> Set[Tuple[str, str]]:
    """Every (outer, inner) pair the hierarchy permits — used by the
    runtime tracker's cross-validation."""
    out: Set[Tuple[str, str]] = set()
    for a, ra in LOCK_RANKS.items():
        for b, rb in LOCK_RANKS.items():
            if rb > ra:
                out.add((a, b))
    return out


@dataclasses.dataclass(frozen=True)
class _Acq:
    line: int
    level: str
    text: str                       # lock expression, for same-rank check
    held: Tuple[Tuple[str, str], ...]   # ((level, text), ...) outer-first


@dataclasses.dataclass(frozen=True)
class _CallSite:
    line: int
    call: ast.Call
    held: Tuple[Tuple[str, str], ...]


class _FuncScanner(ast.NodeVisitor):
    """One function: acquisition events and call sites with the ranked
    locks lexically held at each."""

    def __init__(self, cls: Optional[str]):
        self.cls = cls
        self.held: List[Tuple[str, str]] = []
        self.manual: List[Tuple[str, str]] = []   # .acquire()'d, unreleased
        self.acquisitions: List[_Acq] = []
        self.calls: List[_CallSite] = []

    def _snapshot(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(self.held + self.manual)

    def _record_acquire(self, lvl: str, text: str, line: int) -> None:
        self.acquisitions.append(
            _Acq(line=line, level=lvl, text=text, held=self._snapshot()))

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node) -> None:
        pushed = 0
        for item in node.items:
            # the context expr may itself contain calls
            self.visit(item.context_expr)
            lvl = classify_lock(item.context_expr, self.cls)
            if lvl is not None:
                text = ast.unparse(item.context_expr)
                self._record_acquire(lvl, text, node.lineno)
                self.held.append((lvl, text))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in ("acquire",
                                                         "release"):
            lvl = classify_lock(fn.value, self.cls)
            if lvl is not None:
                text = ast.unparse(fn.value)
                if fn.attr == "acquire":
                    self._record_acquire(lvl, text, node.lineno)
                    self.manual.append((lvl, text))
                else:
                    for i in range(len(self.manual) - 1, -1, -1):
                        if self.manual[i][1] == text:
                            del self.manual[i]
                            break
                self.generic_visit(node)
                return
        self.calls.append(_CallSite(line=node.lineno, call=node,
                                    held=self._snapshot()))
        self.generic_visit(node)

    # nested defs run in other contexts (threads, callbacks): their
    # bodies do not inherit the lexically-held locks
    def visit_FunctionDef(self, node) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:
        pass

    def visit_Lambda(self, node) -> None:
        pass


def _scan(fi: FunctionInfo) -> _FuncScanner:
    sc = _FuncScanner(fi.cls)
    for stmt in fi.node.body:
        sc.visit(stmt)
    return sc


class LockOrderChecker(Checker):
    rule = "lock-order"

    def check(self, index: ProjectIndex) -> List[Violation]:
        scans: Dict[str, _FuncScanner] = {}
        for fi in index.functions:
            scans[fi.uid] = _scan(fi)

        # fixpoint: levels each function eventually acquires (itself or
        # via any resolvable callee)
        eventually: Dict[str, Set[str]] = {
            fi.uid: {a.level for a in scans[fi.uid].acquisitions}
            for fi in index.functions}
        changed = True
        while changed:
            changed = False
            for fi in index.functions:
                acc = eventually[fi.uid]
                for site in scans[fi.uid].calls:
                    for target in index.resolve_call(site.call, fi.cls,
                                                     fi.module):
                        extra = eventually[target.uid] - acc
                        if extra:
                            acc |= extra
                            changed = True

        out: List[Violation] = []
        edge_graph: Set[Tuple[str, str]] = set()
        seen_keys: Set[str] = set()

        def emit(v: Violation) -> None:
            if v.key not in seen_keys:
                seen_keys.add(v.key)
                out.append(v)

        for fi in index.functions:
            sc = scans[fi.uid]
            rel = fi.module.rel
            # lexical nesting: every acquisition under held locks
            for acq in sc.acquisitions:
                for h_lvl, h_text in acq.held:
                    edge_graph.add((h_lvl, acq.level))
                    if LOCK_RANKS[acq.level] < LOCK_RANKS[h_lvl]:
                        emit(Violation(
                            self.rule, rel, acq.line, fi.qualname,
                            f"acquires {acq.level!r} lock ({acq.text}) "
                            f"while holding {h_lvl!r} — inverts the "
                            f"canonical {' -> '.join(CANONICAL_ORDER)} "
                            f"order",
                            detail=f"{h_lvl}->{acq.level}"))
                    elif (acq.level == h_lvl and acq.text != h_text):
                        emit(Violation(
                            self.rule, rel, acq.line, fi.qualname,
                            f"nests two distinct {acq.level!r}-rank locks "
                            f"({h_text} then {acq.text}) — same-rank "
                            f"nesting can deadlock against the opposite "
                            f"interleaving",
                            detail=f"{h_lvl}={acq.level}"))
            # interprocedural: call sites under held locks reaching
            # functions that eventually acquire a lower rank
            for site in sc.calls:
                if not site.held:
                    continue
                for target in index.resolve_call(site.call, fi.cls, fi.module):
                    for lvl in eventually[target.uid]:
                        for h_lvl, _h_text in site.held:
                            edge_graph.add((h_lvl, lvl))
                            if LOCK_RANKS[lvl] < LOCK_RANKS[h_lvl]:
                                emit(Violation(
                                    self.rule, rel, site.line, fi.qualname,
                                    f"holds {h_lvl!r} lock across a call "
                                    f"into {target.qualname} which "
                                    f"(transitively) acquires {lvl!r} — "
                                    f"inverts the canonical order",
                                    detail=(f"{h_lvl}->{lvl}"
                                            f"@{target.qualname}")))

        # cycle check over the observed edge graph (covers pairs the
        # rank test can't see if ranks are ever extended)
        for a, b in sorted(edge_graph):
            if a != b and (b, a) in edge_graph and a < b:
                emit(Violation(
                    self.rule, "<graph>", 0, f"{a}<->{b}",
                    f"acquisition-order cycle between {a!r} and {b!r} "
                    f"locks", detail="cycle"))
        return out


def static_edges(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """The (outer, inner) level edges the given sources exhibit —
    exported for tests that cross-validate the runtime tracker."""
    from repro_torch.analysis.core import load_modules
    index = ProjectIndex(load_modules(paths))
    edges: Set[Tuple[str, str]] = set()
    for fi in index.functions:
        sc = _scan(fi)
        for acq in sc.acquisitions:
            for h_lvl, _ in acq.held:
                edges.add((h_lvl, acq.level))
    return edges
