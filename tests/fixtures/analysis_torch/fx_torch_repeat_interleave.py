"""Seeded violation: a `repeat_interleave` with tensor repeats and no
`output_size` inside the engine step hot path (the checker roots
reachability at InferenceEngine.step)."""
import torch


class InferenceEngine:
    def step(self):
        return self._read(self._forward())

    def _read(self, logits):
        reps = logits.argmax(-1)
        return torch.repeat_interleave(logits, reps, dim=0)

    def _forward(self):
        return torch.zeros(4)
