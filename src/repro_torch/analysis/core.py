"""repro_torch.analysis framework core — source loading, indexing, call
graph.

A copy of `repro.analysis.core`, unchanged but for this docstring: the
analyzer is pure stdlib (``ast`` only), so it runs with neither torch nor
jax installed.  Checkers consume a `ProjectIndex` — every function/method
in the analyzed files plus a *name-based* call graph with receiver hints
(``self.scheduler.submit()`` resolves to `Scheduler.submit`, not every
``submit`` in the tree).  That is coarse by design: the runtime's locking
and hot-path disciplines are enforced on well-known class names, which
the port keeps, and the `analysis_baseline_torch.json` waiver layer
absorbs the residual imprecision explicitly instead of silently.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding.  `key` deliberately excludes the line number so a
    refactor that moves code does not churn the waiver baseline; the
    `detail` slug disambiguates repeated findings inside one symbol
    (e.g. the 2nd `device_get` in a function gets its own key)."""
    rule: str        # checker id, e.g. "lock-order"
    file: str        # repo-relative posix path
    line: int
    symbol: str      # dotted symbol, e.g. "BackendNode.fail"
    message: str
    detail: str = ""

    @property
    def key(self) -> str:
        base = f"{self.rule}::{self.file}::{self.symbol}"
        return f"{base}::{self.detail}" if self.detail else base

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.rule}] "
                f"{self.symbol}: {self.message}")


@dataclasses.dataclass
class SourceModule:
    path: pathlib.Path
    rel: str                     # posix path relative to the scan root
    tree: ast.Module


@dataclasses.dataclass
class FunctionInfo:
    module: SourceModule
    cls: Optional[str]           # enclosing class name, None at top level
    name: str
    node: FunctionNode

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name

    @property
    def uid(self) -> str:
        """Globally unique id (two files may define same-named classes)."""
        return f"{self.module.rel}::{self.qualname}"


def load_modules(paths: Sequence[Union[str, pathlib.Path]],
                 root: Optional[pathlib.Path] = None) -> List[SourceModule]:
    """Parse every .py under `paths` (files or directories)."""
    files: List[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    out: List[SourceModule] = []
    for f in files:
        rel = f.as_posix()
        if root is not None:
            try:
                rel = f.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                pass
        tree = ast.parse(f.read_text(), filename=str(f))
        out.append(SourceModule(path=f, rel=rel, tree=tree))
    return out


# ------------------------------------------------------------------ #
def dotted_parts(expr: ast.expr) -> Optional[Tuple[str, ...]]:
    """('self', 'scheduler', '_lock') for self.scheduler._lock; None for
    anything that isn't a plain Name/Attribute chain."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return tuple(reversed(parts))


def call_name(call: ast.Call) -> Optional[str]:
    """Bare callee name: `self._admit()` -> '_admit', `foo()` -> 'foo'."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def call_receiver(call: ast.Call) -> Optional[Tuple[str, ...]]:
    """Receiver chain of a method call: `inst.engine.cancel()` ->
    ('inst', 'engine'); None for bare-name calls."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    return dotted_parts(fn.value)


# Receiver-name -> class-name hints.  The runtime uses these local names
# consistently (enforced by review idiom, exploited here): they make the
# name-based call graph resolve `inst.engine.cancel()` to
# `InferenceEngine.cancel` instead of every `cancel` in the tree.
RECEIVER_CLASS_HINTS: Dict[str, str] = {
    "engine": "InferenceEngine", "eng": "InferenceEngine",
    "scheduler": "Scheduler", "sched": "Scheduler",
    "node": "BackendNode",
    "inst": "Instance", "instance": "Instance",
    "pool": "PagedKVPool",
    "req": "Request", "request": "Request", "retry": "Request",
    "frontend": "ServiceFrontend",
    "host": "HostPagePool",
    "gw": "Gateway", "gateway": "Gateway", "_gw": "Gateway",
    "handle": "GenerationHandle",
    "rt": "ServingRuntime", "runtime": "ServingRuntime",
    "tenants": "TenantLimiter",
}


def _is_frozen_dataclass_decorator(dec: ast.expr) -> Optional[bool]:
    """True/False for a @dataclass decorator (frozen or not); None when
    the decorator isn't a dataclass decorator at all."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    parts = dotted_parts(target)
    if parts is None or parts[-1] != "dataclass":
        return None
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
    return False


class ProjectIndex:
    """Every class and function in the analyzed files, plus resolution
    helpers shared by the lock-order and hot-path checkers."""

    def __init__(self, modules: Sequence[SourceModule]):
        self.modules = list(modules)
        self.functions: List[FunctionInfo] = []
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.by_class: Dict[str, Dict[str, FunctionInfo]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.class_module: Dict[str, SourceModule] = {}
        self.frozen_dataclasses: set = set()
        self.dataclasses: set = set()
        # names each module binds by `import` (modules, functions, classes)
        self.imported: Dict[str, set] = {}
        for mod in self.modules:
            self.imported[mod.rel] = {
                (a.asname or a.name).split(".")[0]
                for node in ast.walk(mod.tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for a in node.names}
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._add(FunctionInfo(mod, None, node.name, node))
                elif isinstance(node, ast.ClassDef):
                    self.classes[node.name] = node
                    self.class_module[node.name] = mod
                    for dec in node.decorator_list:
                        frozen = _is_frozen_dataclass_decorator(dec)
                        if frozen is not None:
                            self.dataclasses.add(node.name)
                            if frozen:
                                self.frozen_dataclasses.add(node.name)
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self._add(FunctionInfo(mod, node.name,
                                                   sub.name, sub))

    def _add(self, fi: FunctionInfo) -> None:
        self.functions.append(fi)
        self.by_name.setdefault(fi.name, []).append(fi)
        if fi.cls:
            self.by_class.setdefault(fi.cls, {})[fi.name] = fi

    # -------------------------------------------------------------- #
    def resolve_call(self, call: ast.Call, caller_cls: Optional[str],
                     caller_module: Optional[SourceModule] = None
                     ) -> List[FunctionInfo]:
        """Candidate targets for a call site.  `self.f()` binds to the
        caller's own class when it defines `f`; a hinted receiver binds
        to that class only (empty when the class lacks the method —
        a confident receiver with an unknown method is external code);
        a bare `f()` binds to module-level functions only, the caller's
        module's first (`caller_module`), and `mod.f()` on a name the
        caller's module imports to module-level functions only (or, on an
        imported class, to its method); any other receiver falls back to
        every function with that bare name.  The last three rules are the
        port's departure from `repro.analysis.core`: its kernel and MoE
        helpers (`ops._stream`, `moe._dispatch`, `spec_decode.record`)
        share names with HTTP handler and perf-model methods, which the
        reference's fallback would put on the engine step's call
        graph."""
        name = call_name(call)
        if name is None:
            return []
        recv = call_receiver(call)
        if recv is not None:
            key = recv[-1]
            if key == "self" and caller_cls is not None:
                own = self.by_class.get(caller_cls, {})
                if name in own:
                    return [own[name]]
                return self.by_name.get(name, [])
            hinted = RECEIVER_CLASS_HINTS.get(key)
            if hinted is not None:
                meth = self.by_class.get(hinted, {}).get(name)
                return [meth] if meth is not None else []
            if len(recv) == 1 and caller_module is not None \
                    and key in self.imported.get(caller_module.rel, ()):
                # `spec_lib.record()`: an imported module's function, or
                # an imported class's own method
                if key in self.by_class:
                    meth = self.by_class[key].get(name)
                    return [meth] if meth is not None else []
                return [fi for fi in self.by_name.get(name, [])
                        if fi.cls is None]
            return self.by_name.get(name, [])
        # a bare name is a module-level function, never a method: the
        # caller's own module's when it defines one, else any module's
        top = [fi for fi in self.by_name.get(name, []) if fi.cls is None]
        own = [fi for fi in top if fi.module is caller_module]
        return own or top


class Checker:
    """Base interface: one rule id, one pass over the index."""
    rule: str = ""

    def check(self, index: ProjectIndex) -> List[Violation]:
        raise NotImplementedError


def run_checkers(paths: Sequence[Union[str, pathlib.Path]],
                 checkers: Sequence[Checker],
                 root: Optional[pathlib.Path] = None) -> List[Violation]:
    index = ProjectIndex(load_modules(paths, root=root))
    out: List[Violation] = []
    for ch in checkers:
        out.extend(ch.check(index))
    out.sort(key=lambda v: (v.file, v.line, v.rule, v.symbol))
    return out
