"""Seeded violation: a `<stream>.synchronize()` wait inside the engine step
hot path (the checker roots reachability at InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        torch.cuda.current_stream().synchronize()
        return logits

    def _forward(self):
        return torch.zeros(4)
