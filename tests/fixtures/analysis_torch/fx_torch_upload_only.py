"""Not a violation: host->device uploads on the engine step hot path are
a pattern of their own (`upload`), listed as sites but never flagged as
a sync: `torch.tensor` / `torch.as_tensor` with a device, `.to(<device>)`
and `.cuda()`."""
import numpy as np
import torch


class InferenceEngine:
    def __init__(self, device):
        self.device = device

    def step(self):
        rows = np.zeros((4,), np.int64)
        a = torch.tensor([1, 2], device=self.device)
        b = torch.as_tensor(rows, device="cuda")
        c = torch.from_numpy(rows).to(self.device, non_blocking=True)
        return a, b, c, self._more(rows)

    def _more(self, rows):
        t = torch.from_numpy(rows)
        return t.cuda(), t.to(device=self.device), t.to(torch.int32)
