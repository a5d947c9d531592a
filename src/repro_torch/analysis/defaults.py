"""Shared-mutable-default checker — a copy of
`repro.analysis.defaults`, unchanged but for this docstring.

The project's first bugfix class: a mutable default (``def f(x=[])`` or a
dataclass field ``x: Foo = Foo()`` with mutable ``Foo``) is one shared
object across every call/instance.  Flags:

* mutable literal / constructor defaults on function parameters
  (``[]``, ``{}``, ``set()``, ``list()``, ``deque()``, ...);
* call defaults constructing a class defined in the analyzed sources
  that is a *non-frozen* dataclass (``sampling=SamplingParams()`` is
  fine precisely because `SamplingParams` is ``frozen=True``);
* dataclass field defaults that are calls to non-frozen dataclasses
  (``field(default_factory=...)`` is the correct spelling and passes).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import (Checker, ProjectIndex, Violation,
                                 call_name)

_MUTABLE_CONSTRUCTORS = {"list", "dict", "set", "bytearray", "deque",
                         "defaultdict", "OrderedDict", "Counter"}


def _mutable_default_reason(expr: ast.expr,
                            index: ProjectIndex) -> Optional[str]:
    if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return "mutable literal"
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if name in _MUTABLE_CONSTRUCTORS:
            return f"mutable {name}()"
        if name in index.dataclasses \
                and name not in index.frozen_dataclasses:
            return f"instance of non-frozen dataclass {name}"
    return None


class MutableDefaultChecker(Checker):
    rule = "mutable-default"

    def check(self, index: ProjectIndex) -> List[Violation]:
        out: List[Violation] = []
        for fi in index.functions:
            args = fi.node.args
            defaults = list(args.defaults) + [d for d in args.kw_defaults
                                              if d is not None]
            for d in defaults:
                reason = _mutable_default_reason(d, index)
                if reason is not None:
                    out.append(Violation(
                        self.rule, fi.module.rel, d.lineno, fi.qualname,
                        f"parameter default is a {reason} — one shared "
                        f"object across every call "
                        f"({ast.unparse(d)[:40]})",
                        detail=f"arg:{ast.unparse(d)[:24]}"))
        # dataclass field defaults
        for cls_name in sorted(index.dataclasses):
            cls = index.classes[cls_name]
            mod = index.class_module[cls_name]
            for stmt in cls.body:
                if not isinstance(stmt, ast.AnnAssign) \
                        or stmt.value is None:
                    continue
                if isinstance(stmt.value, ast.Call) \
                        and call_name(stmt.value) == "field":
                    continue            # dataclasses.field(...) is fine
                reason = _mutable_default_reason(stmt.value, index)
                if reason is not None:
                    target = ast.unparse(stmt.target)
                    out.append(Violation(
                        self.rule, mod.rel, stmt.lineno,
                        f"{cls_name}.{target}",
                        f"dataclass field default is a {reason} — one "
                        f"shared object across every instance; use "
                        f"field(default_factory=...)"))
        return out
