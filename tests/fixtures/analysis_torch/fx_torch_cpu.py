"""Seeded violation: a `.cpu()` read of a device tensor inside the engine
step hot path (the checker roots reachability at InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        return logits.cpu()

    def _forward(self):
        return torch.zeros(4)
