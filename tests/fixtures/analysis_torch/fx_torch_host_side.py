"""Not a violation: host values on the engine step hot path.  Arrays
derived from a `.numpy()` result or a numpy call are host arrays (their
`.tolist()` reads nothing), `np.asarray` of a list built on the host
reads nothing, a `repeat_interleave` with int repeats and `int()` of a
parameter annotated as a Python scalar do not sync; the one read is the
`.cpu()` under the `.numpy()`, flagged once."""
import numpy as np
import torch


class InferenceEngine:
    def step(self, causal: bool = True):
        toks = torch.zeros((2, 4), dtype=torch.int32)
        host = torch.stack([toks, toks]).cpu().numpy()
        first, done = host[0], host[1].astype(bool)
        ids = np.asarray(list(range(3)), np.int64)
        n, ps = toks.shape[0], toks.shape[1]
        mask = (toks > 0).repeat_interleave(ps, dim=1)
        return (first[:, 0].tolist(), done.tolist(), ids.tolist(), mask,
                int(causal), n)
