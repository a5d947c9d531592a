"""repro_torch.analysis — concurrency & hot-path static analyzer over the
port.

The counterpart of `repro.analysis` for `src/repro_torch`: AST-based
checkers for the runtime's machine-checked invariants (canonical lock
order, guarded shared state, hot-path host-sync discipline with
PyTorch's sync and upload patterns, mutable defaults, page-refcount
pairing), a waiver baseline of the port's own
(`analysis_baseline_torch.json`), and a runtime `LockOrderTracker` that
wraps the port's ranked locks and cross-validates actual acquisition
orders.

Run `python -m repro_torch.analysis --check` from the repo root.  Pure
stdlib — importing it imports neither torch nor jax nor `repro`.
"""
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.core import (Checker, ProjectIndex, Violation,
                                       load_modules, run_checkers)
from repro_torch.analysis.defaults import MutableDefaultChecker
from repro_torch.analysis.hotpath import HotPathSyncChecker
from repro_torch.analysis.locks import (CANONICAL_ORDER, LOCK_RANKS,
                                        LockOrderChecker, allowed_edges)
from repro_torch.analysis.refcount import RefcountChecker
from repro_torch.analysis.shared_state import (ALLOWED_LOCKFREE,
                                               SharedStateChecker)
from repro_torch.analysis.tracker import (LockOrderTracker, TrackedLock,
                                          install, uninstall)

__all__ = [
    "ALLOWED_LOCKFREE", "Baseline", "CANONICAL_ORDER", "Checker",
    "HotPathSyncChecker", "LOCK_RANKS", "LockOrderChecker",
    "LockOrderTracker", "MutableDefaultChecker", "ProjectIndex",
    "RefcountChecker", "SharedStateChecker", "TrackedLock", "Violation",
    "allowed_edges", "install", "load_modules", "run_checkers",
    "uninstall",
]
