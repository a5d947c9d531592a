"""Seeded violation: a `masked_select` (its output shape depends on the
data) inside the engine step hot path (the checker roots reachability at
InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        return logits.masked_select(logits > 0)

    def _forward(self):
        return torch.zeros(4)
