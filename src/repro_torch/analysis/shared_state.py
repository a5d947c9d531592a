"""Unguarded-shared-state checker — a copy of
`repro.analysis.shared_state`, unchanged but for this docstring.

For every class that guards at least one attribute write with a lock,
flag attributes that are *also* written (or read) lock-free in another
method of the same class: the classic "counter bumped under the stats
lock in one thread, incremented bare in another" race
(`ServingRuntime.stats` was one).

Grouping is by attribute *root*: `self.stats.ticks += 1` and
`self.stats.watchdog_fired += 1` both touch root ``stats``, so guarding
one path and not the other is reported once per (class, root, kind).
Writes cover assignments, augmented assignments, subscript stores, and
the common container mutators (append/add/update/...).

Documented lock-free patterns are allowlisted in code (they are part of
the design, not accepted debt): `Scheduler._depth` ("plain int: read
lock-free by pumps"), `GenerationHandle._done`/`_response` ("`_done`
goes last"), and `BackendNode._alive`/`instances` reads (deliberately
lock-free submit/heartbeat paths).  Anything else needs a baseline
waiver with a reason.  `ALLOWED_LOCKFREE` is the reference's set, kept
as it is: a lock-free read that only the port has (the Gateway handle's
condition-based `result()`) is waived in `analysis_baseline_torch.json`
with its reason, not added here.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Checker, ProjectIndex, Violation,
                                 dotted_parts)

# documented lock-free access patterns: (class, attribute root, kind)
ALLOWED_LOCKFREE: Set[Tuple[str, str, str]] = {
    ("Scheduler", "_depth", "read"),
    ("GenerationHandle", "_done", "read"),
    ("GenerationHandle", "_response", "read"),
    ("BackendNode", "_alive", "read"),
    ("BackendNode", "instances", "read"),
}

_GUARD_RE = re.compile(r"lock|_cv\b|cv$|cond|mutex")
_MUTATORS = {"append", "extend", "add", "insert", "update", "pop",
             "popleft", "appendleft", "remove", "discard", "clear",
             "setdefault"}


def _is_guard_attr(name: str) -> bool:
    return bool(_GUARD_RE.search(name))


@dataclasses.dataclass
class _Access:
    root: str
    kind: str          # "write" | "read"
    method: str
    line: int
    guarded: bool


@dataclasses.dataclass
class _SelfCall:
    callee: str
    guarded: bool


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, method: str):
        self.method = method
        self.depth = 0                  # nesting level of guard withs
        self.accesses: List[_Access] = []
        self.guards_used: Set[str] = set()
        self.self_calls: List[_SelfCall] = []

    # ---- guard tracking ---- #
    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node) -> None:
        self._with(node)

    def _with(self, node) -> None:
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)
            parts = dotted_parts(item.context_expr)
            if parts and parts[0] == "self" and len(parts) == 2 \
                    and _is_guard_attr(parts[1]):
                self.guards_used.add(parts[1])
                self.depth += 1
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= pushed

    # ---- access collection ---- #
    def _self_root(self, expr: ast.expr) -> Optional[str]:
        parts = dotted_parts(expr)
        if parts and parts[0] == "self" and len(parts) >= 2:
            return parts[1]
        return None

    def _record(self, root: Optional[str], kind: str, line: int) -> None:
        if root is None or _is_guard_attr(root):
            return
        self.accesses.append(_Access(root=root, kind=kind,
                                     method=self.method, line=line,
                                     guarded=self.depth > 0))

    def _record_target(self, target: ast.expr) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt)
        elif isinstance(target, ast.Subscript):
            self._record(self._self_root(target.value), "write",
                         target.lineno)
            self.visit(target.slice)
        elif isinstance(target, ast.Attribute):
            self._record(self._self_root(target), "write", target.lineno)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(t)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_target(t)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            parts = dotted_parts(fn)
            if parts is not None and parts[0] == "self" \
                    and len(parts) == 2:
                self.self_calls.append(_SelfCall(callee=parts[1],
                                                 guarded=self.depth > 0))
            if fn.attr in _MUTATORS:
                root = self._self_root(fn.value)
                if root is not None:
                    self._record(root, "write", node.lineno)
                    for a in node.args:
                        self.visit(a)
                    for k in node.keywords:
                        self.visit(k.value)
                    return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            self._record(self._self_root(node), "read", node.lineno)
        self.generic_visit(node)

    # nested defs / lambdas: separate execution context
    def visit_FunctionDef(self, node) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:
        pass

    def visit_Lambda(self, node) -> None:
        pass


class SharedStateChecker(Checker):
    rule = "shared-state"

    def check(self, index: ProjectIndex) -> List[Violation]:
        out: List[Violation] = []
        for cls_name, methods in sorted(index.by_class.items()):
            callables = set(methods)        # method/property names: not
            scans: Dict[str, _MethodScanner] = {}   # shared *state* roots
            any_guards = False
            mod = None
            for mname, fi in sorted(methods.items()):
                mod = fi.module
                sc = _MethodScanner(mname)
                for stmt in fi.node.body:
                    sc.visit(stmt)
                any_guards = any_guards or bool(sc.guards_used)
                scans[mname] = sc
            if not any_guards or mod is None:
                continue
            # interprocedural guard propagation: a helper whose every
            # in-class call site runs with a guard held (lexically, or
            # from an already-guarded helper) is itself guarded —
            # `Scheduler._reserve` ("callers hold _lock") needs no
            # waiver, while a helper reachable from any bare call site
            # stays unguarded
            sites: Dict[str, List[Tuple[str, bool]]] = {}
            for mname, sc in scans.items():
                for call in sc.self_calls:
                    if call.callee in scans:
                        sites.setdefault(call.callee, []).append(
                            (mname, call.guarded))
            guarded_methods: Set[str] = set()
            changed = True
            while changed:
                changed = False
                for mname, callers in sites.items():
                    if mname in guarded_methods:
                        continue
                    if all(g or c in guarded_methods
                           for c, g in callers):
                        guarded_methods.add(mname)
                        changed = True
            accesses: List[_Access] = []
            for mname, sc in scans.items():
                effective = mname in guarded_methods
                for a in sc.accesses:
                    if a.root in callables:
                        continue
                    if effective and not a.guarded:
                        a = dataclasses.replace(a, guarded=True)
                    accesses.append(a)
            guarded_roots = {a.root for a in accesses
                             if a.kind == "write" and a.guarded
                             and a.method != "__init__"}
            for root in sorted(guarded_roots):
                for kind in ("write", "read"):
                    if (cls_name, root, kind) in ALLOWED_LOCKFREE:
                        continue
                    bare = [a for a in accesses
                            if a.root == root and a.kind == kind
                            and not a.guarded and a.method != "__init__"]
                    if not bare:
                        continue
                    where = sorted({f"{a.method}:{a.line}" for a in bare})
                    out.append(Violation(
                        self.rule, mod.rel, bare[0].line,
                        f"{cls_name}.{root}",
                        f"attribute {root!r} is written under a lock "
                        f"elsewhere in {cls_name} but {kind} lock-free "
                        f"at {', '.join(where)}",
                        detail=kind))
        return out
