"""The one traffic generator: reads a mix's parameters (`traffic/<mix>.json`)
and yields the requests of a run from `--seed`.

Every seed runs the same schedule of request shapes and arrival gaps:
each dimension (prompt length, output length, gap) is a block of evenly
spaced quantiles of its distribution, in an order that no seed changes,
so that two seeds ask the same work of the program in the same order.  `--seed` draws the token ids (and the
harness the weights).  A closed loop's waits follow from the engine's
steps alone, so a schedule that moved with the seed would move the
admission groups, and with them the whole run.

Closed loop (`"loop": "closed"`): `clients` clients, spread evenly over
`tenants`, all starting at once, each sending its next request when its
previous one finishes.  Open loop (`"loop": "open"`): arrivals at `rate`
a second, in blocks of `block_s` seconds that each hold exactly
`rate * block_s` arrivals whose gaps are the quantiles of an exponential
distribution (Poisson within a block), the tenant drawn in turn.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

SEED_MOD = 2 ** 64
CLOSED_BLOCK = 4096      # a closed loop's shapes come in blocks this long


@dataclasses.dataclass
class Shape:
    """One request as the generator makes it."""
    index: int
    tenant: int
    prompt: List[int]
    max_tokens: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(dist: Dict, u: np.ndarray) -> np.ndarray:
    lo, hi = int(dist["lo"]), int(dist["hi"])
    kind = dist["dist"]
    if kind == "uniform":          # integers lo..hi, each equally often
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(int)
    if kind == "log_uniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(int)
    raise ValueError(f"unknown length distribution {kind!r}")


class Traffic:
    def __init__(self, spec: Dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed) % SEED_MOD
        self.vocab = int(vocab)
        self.loop = spec["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"loop must be 'closed' or 'open', not "
                             f"{self.loop!r}")
        self.tenants = int(spec["tenants"])
        self.clients = int(spec.get("clients", 0))
        self.rate = float(spec.get("rate", 0.0))
        self.block_s = float(spec.get("block_s", 5.0))
        if self.loop == "closed" and self.clients < 1:
            raise ValueError("a closed loop needs clients >= 1")
        if self.loop == "open":
            per = self.rate * self.block_s
            if self.rate <= 0 or abs(per - round(per)) > 1e-9:
                raise ValueError("an open loop needs rate * block_s to be a "
                                 "whole number of arrivals")
            self.block = int(round(per))
        else:
            self.block = CLOSED_BLOCK
        self._blocks: Dict[int, Dict[str, np.ndarray]] = {}

    # ---- the permuted blocks ------------------------------------- #
    def _block(self, b: int) -> Dict[str, np.ndarray]:
        if b not in self._blocks:
            rng = np.random.default_rng([0, 0, b])
            u = _quantiles(self.block)
            out = {"prompt": _lengths(self.spec["prompt"], rng.permutation(u)),
                   "output": _lengths(self.spec["output"],
                                      rng.permutation(u))}
            if self.loop == "open":
                gaps = -np.log1p(-u)
                out["gap"] = rng.permutation(gaps / gaps.sum() * self.block_s)
            self._blocks[b] = out
        return self._blocks[b]

    def _field(self, name: str, i: int):
        return self._block(i // self.block)[name][i % self.block]

    # ---- requests ------------------------------------------------- #
    def request(self, i: int, tenant: Optional[int] = None) -> Shape:
        """The i-th request sent; a closed loop's client names its tenant,
        an open loop's requests take the tenants in turn."""
        if tenant is None:
            tenant = i % self.tenants
        rng = np.random.default_rng([self.seed, 1, i])
        prompt = rng.integers(0, self.vocab, int(self._field("prompt", i)))
        return Shape(i, tenant, prompt.tolist(), int(self._field("output", i)))

    def arrival(self, i: int) -> float:
        """Open loop: seconds from the start of the traffic to request
        i's due time."""
        b, j = divmod(i, self.block)
        return b * self.block_s + float(self._block(b)["gap"][:j].sum())

    def client_tenant(self, client: int) -> int:
        return client % self.tenants

    def prompt_buckets(self, bucket_of) -> List[int]:
        """The prefill buckets this mix's prompts fall in (for warm-up)."""
        lo, hi = int(self.spec["prompt"]["lo"]), int(self.spec["prompt"]["hi"])
        return sorted({bucket_of(n) for n in range(lo, hi + 1)})
