"""Waiver baseline — the analyzer's accepted-sites ledger.

A copy of `repro.analysis.baseline` whose one departure is the default
file: the port's own `analysis_baseline_torch.json` at the repo root,
beside the JAX package's `analysis_baseline.json`.  It pins every
violation the project has examined and accepted (sanctioned host
syncs, documented lock-free patterns the code-level allowlist doesn't
cover, known call-graph imprecision).
Each waiver is `{key, reason}`; a waiver with no reason is invalid by
construction — `--check` refuses it, so the baseline can never silently
accumulate unexplained debt.  New violations (keys not in the file)
fail `--check`; stale waivers (keys matching nothing) are reported so
fixed sites get their waivers removed.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Sequence, Tuple, Union

from repro_torch.analysis.core import Violation

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"


@dataclasses.dataclass
class Baseline:
    waivers: Dict[str, str]          # key -> reason

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "Baseline":
        p = pathlib.Path(path)
        if not p.exists():
            return cls(waivers={})
        data = json.loads(p.read_text())
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{p}: unsupported baseline version {data.get('version')!r}")
        waivers: Dict[str, str] = {}
        for w in data.get("waivers", []):
            waivers[w["key"]] = w.get("reason", "")
        return cls(waivers=waivers)

    def save(self, path: Union[str, pathlib.Path]) -> None:
        body = {
            "version": BASELINE_VERSION,
            "waivers": [{"key": k, "reason": self.waivers[k]}
                        for k in sorted(self.waivers)],
        }
        pathlib.Path(path).write_text(json.dumps(body, indent=2) + "\n")

    # -------------------------------------------------------------- #
    def unexplained(self) -> List[str]:
        """Waiver keys whose reason is empty/placeholder — never valid."""
        return sorted(k for k, r in self.waivers.items()
                      if not r.strip() or r.strip().upper().startswith("TODO"))

    def split(self, violations: Sequence[Violation]
              ) -> Tuple[List[Violation], List[Violation], List[str]]:
        """(new, waived, stale_waiver_keys)."""
        new: List[Violation] = []
        waived: List[Violation] = []
        seen = set()
        for v in violations:
            seen.add(v.key)
            if v.key in self.waivers:
                waived.append(v)
            else:
                new.append(v)
        stale = sorted(k for k in self.waivers if k not in seen)
        return new, waived, stale

    def absorb(self, violations: Sequence[Violation],
               placeholder: str = "TODO: justify or fix") -> None:
        """--write-baseline: add waivers for every current violation,
        keeping existing reasons; fixed sites drop out."""
        fresh: Dict[str, str] = {}
        for v in violations:
            fresh[v.key] = self.waivers.get(v.key, placeholder)
        self.waivers = fresh
