"""Synthetic-but-structured LM data pipeline — the port's copy of
`repro.training.data` (numpy only, so it is the same code: the same
seed gives the same batches bit for bit).  The trainer moves each batch
onto its device where it calls `batch_at`.

Deterministic seeded streams (restart-safe: the iterator state is just
(seed, step)), sequence packing, and per-host sharding.  The token
distribution is a Zipfian mixture with local n-gram structure so models
actually *learn* (loss drops measurably within a few hundred steps —
the train_100m example relies on this).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    # structure knobs
    zipf_a: float = 1.2
    ngram_order: int = 3
    ngram_tables: int = 4096


class SyntheticLM:
    """Markov-ish synthetic corpus: next token depends on a hash of the
    previous `ngram_order` tokens, mixed with Zipf noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # per-context preferred continuations (the learnable signal)
        self._table = base.integers(
            0, cfg.vocab, size=(cfg.ngram_tables,), dtype=np.int64)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._zipf_p = p / p.sum()

    def _ctx_hash(self, ctx: np.ndarray) -> np.ndarray:
        h = np.zeros(ctx.shape[0], dtype=np.int64)
        for j in range(ctx.shape[1]):
            h = h * 1000003 + ctx[:, j]
        return np.abs(h) % self.cfg.ngram_tables

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, :cfg.ngram_order] = rng.integers(
            0, cfg.vocab, size=(b, cfg.ngram_order))
        follow = rng.random((b, s + 1)) < 0.65     # P(use table)
        noise = rng.choice(cfg.vocab, size=(b, s + 1), p=self._zipf_p)
        for t in range(cfg.ngram_order, s + 1):
            ctx = toks[:, t - cfg.ngram_order:t]
            preferred = self._table[self._ctx_hash(ctx)]
            toks[:, t] = np.where(follow[:, t], preferred, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def host_shard(batch: Dict[str, np.ndarray], host_id: int,
               n_hosts: int) -> Dict[str, np.ndarray]:
    """Per-host slice of the global batch (multi-host input pipeline)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n_hosts
        out[k] = v[host_id * per:(host_id + 1) * per]
    return out
