"""Seeded violation: a `.to("cpu")` read and a `.to(device="cpu")` read
inside the engine step hot path (the checker roots reachability at
InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        a = logits.to("cpu")
        return a, logits.to(device="cpu")

    def _forward(self):
        return torch.zeros(4)
