"""Seeded violation: a one-argument `torch.where` (the indices of the true
entries) inside the engine step hot path (the checker roots reachability
at InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        return torch.where(logits > 0)

    def _forward(self):
        return torch.zeros(4)
