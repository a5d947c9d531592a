"""Seeded violation: a `torch.cuda.synchronize()` wait inside the engine
step hot path (the checker roots reachability at InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        torch.cuda.synchronize()
        return logits

    def _forward(self):
        return torch.zeros(4)
