"""CLI: `python -m repro_torch.analysis [--check] [paths...]`.

The counterpart of `python -m repro.analysis` over the port: default
paths cover `src/repro_torch`; the default baseline is the checked-in
`analysis_baseline_torch.json` at the repo root.  Run it from the repo
root; it imports neither torch nor jax.  Exit codes: 0 clean (or
report-only mode), 2 new unwaived violations, 3 invalid baseline
(waiver without a reason).
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.core import Violation, run_checkers
from repro_torch.analysis.defaults import MutableDefaultChecker
from repro_torch.analysis.hotpath import HotPathSyncChecker
from repro_torch.analysis.locks import LockOrderChecker
from repro_torch.analysis.refcount import RefcountChecker
from repro_torch.analysis.shared_state import SharedStateChecker

ALL_CHECKERS = {
    "lock-order": LockOrderChecker,
    "shared-state": SharedStateChecker,
    "hot-path-sync": HotPathSyncChecker,
    "mutable-default": MutableDefaultChecker,
    "refcount-pairing": RefcountChecker,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Concurrency & hot-path static analyzer "
                    "(lock order, shared state, host syncs, mutable "
                    "defaults, refcount pairing)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to analyze (default: src/repro_torch)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help=f"waiver baseline file (default: "
                        f"{DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every violation, ignoring waivers")
    p.add_argument("--check", action="store_true",
                   help="exit 2 on unwaived violations, 3 on waivers "
                        "without reasons")
    p.add_argument("--write-baseline", action="store_true",
                   help="absorb current violations into the baseline "
                        "(preserving existing reasons)")
    p.add_argument("--rules", default="",
                   help="comma-separated subset of rules to run "
                        f"(default all: {','.join(ALL_CHECKERS)})")
    return p


def main(argv: List[str] = None) -> int:
    args = build_parser().parse_args(argv)
    paths = args.paths or ["src/repro_torch"]
    rules = [r for r in args.rules.split(",") if r] or list(ALL_CHECKERS)
    unknown = [r for r in rules if r not in ALL_CHECKERS]
    if unknown:
        print(f"unknown rules: {unknown}", file=sys.stderr)
        return 2
    checkers = [ALL_CHECKERS[r]() for r in rules]
    root = pathlib.Path.cwd()
    violations: List[Violation] = run_checkers(paths, checkers, root=root)

    if args.no_baseline:
        for v in violations:
            print(v.render())
        print(f"{len(violations)} violation(s), baseline ignored")
        return 2 if (args.check and violations) else 0

    baseline = Baseline.load(args.baseline)
    if args.write_baseline:
        baseline.absorb(violations)
        baseline.save(args.baseline)
        print(f"wrote {len(baseline.waivers)} waiver(s) to "
              f"{args.baseline}; fill in every TODO reason")
        return 0

    new, waived, stale = baseline.split(violations)
    unexplained = baseline.unexplained()
    for v in new:
        print(v.render())
    if stale:
        print(f"stale waivers (fixed sites — remove from "
              f"{args.baseline}):")
        for k in stale:
            print(f"  {k}")
    print(f"{len(violations)} violation(s): {len(new)} new, "
          f"{len(waived)} waived, {len(stale)} stale waiver(s)")
    if unexplained:
        print("waivers without a reason:", file=sys.stderr)
        for k in unexplained:
            print(f"  {k}", file=sys.stderr)
        if args.check:
            return 3
    if args.check and new:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
