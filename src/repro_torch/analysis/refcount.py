"""Refcount-pairing checker for the paged KV pool — a copy of
`repro.analysis.refcount`, unchanged but for this docstring: the port's
`serving/kv_cache.PagedKVPool` keeps JAX's `retain` / `free_page` /
`detach` / `attach`.

`PagedKVPool.retain(page)` takes shared ownership of a page; every code
path that retains must either release it (`free_page`/`detach`) or
*store* it somewhere that owns it (page table, prefix-cache entry, swap
handle) before the function can exit.  A `retain` followed by an early
``return``/``raise`` with neither is a leaked page — the pool's free
list shrinks until admission wedges.

The check is a line-ordered scan per function (flow-insensitive): for
each ``retain(X)`` call, any later exit statement with no intervening
release call or store mentioning ``X`` flags.  Coarse, but the settled
patterns in kv_cache/kv_hierarchy (retain-then-store-in-entry,
detach-then-free) all pass, and the classic leak shape (validate after
retain, raise on failure) is exactly what it catches.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional

from repro_torch.analysis.core import (Checker, ProjectIndex, Violation,
                                 call_name)

_RELEASES = {"free_page", "detach", "attach", "release_page", "free"}
_SKIP_FUNCS = {"retain", "free_page", "detach", "attach"}


@dataclasses.dataclass
class _Event:
    line: int
    kind: str          # "retain" | "settle" | "exit"
    text: str          # arg text for retain; full text for settle


class _Collector(ast.NodeVisitor):
    def __init__(self):
        self.events: List[_Event] = []

    def _arg_text(self, call: ast.Call) -> str:
        return ast.unparse(call.args[0]) if call.args else ""

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        if name == "retain":
            self.events.append(_Event(node.lineno, "retain",
                                      self._arg_text(node)))
        else:
            # any call/store mentioning the retained name is an
            # ownership handoff (release, table/entry insert, helper)
            self.events.append(_Event(node.lineno, "settle",
                                      ast.unparse(node)))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.events.append(_Event(node.lineno, "settle",
                                  ast.unparse(node)))
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        # `return page` transfers ownership to the caller; a bare or
        # unrelated return after a retain is an exit without settling
        self.events.append(_Event(node.lineno, "exit",
                                  ast.unparse(node)))

    def visit_Raise(self, node: ast.Raise) -> None:
        # the exception text mentioning the page does not settle it
        self.events.append(_Event(node.lineno, "exit", "raise"))

    def visit_FunctionDef(self, node) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:
        pass


def _root_name(arg_text: str) -> str:
    """'page' for 'page', 'pages' for 'pages[i]'; the loop-variable stem
    used for the mention test."""
    for sep in (".", "[", "("):
        if sep in arg_text:
            arg_text = arg_text.split(sep, 1)[0]
    return arg_text.strip()


class RefcountChecker(Checker):
    rule = "refcount-pairing"

    def check(self, index: ProjectIndex) -> List[Violation]:
        out: List[Violation] = []
        for fi in index.functions:
            if fi.name in _SKIP_FUNCS:
                continue
            col = _Collector()
            for stmt in fi.node.body:
                col.visit(stmt)
            retains = [e for e in col.events if e.kind == "retain"]
            if not retains:
                continue
            events = sorted(col.events, key=lambda e: e.line)
            for r in retains:
                stem = _root_name(r.text)
                if not stem:
                    continue
                settled: Optional[int] = None
                leak_at: Optional[int] = None
                for e in events:
                    if e.line <= r.line:
                        continue
                    if e.kind == "settle" and stem in e.text:
                        settled = e.line
                        break
                    if e.kind == "exit":
                        if e.text.startswith("return") \
                                and stem in e.text:
                            settled = e.line      # ownership to caller
                        else:
                            leak_at = e.line
                        break
                if settled is None:
                    how = (f"exits at line {leak_at}"
                           if leak_at is not None
                           else "reaches end of function")
                    out.append(Violation(
                        self.rule, fi.module.rel, r.line, fi.qualname,
                        f"retain({r.text}) at line {r.line} {how} "
                        f"without a matching free_page/detach or an "
                        f"ownership-transferring store — leaked page "
                        f"refcount",
                        detail=f"retain:{r.text[:24]}"))
        return out
