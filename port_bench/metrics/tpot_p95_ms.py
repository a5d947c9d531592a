"""95th percentile, over the same requests as `ttft_p95_ms`, of (last
token's time - first token's time) / (output tokens - 1) (host clock)."""
import numpy as np


def read(rec):
    xs = rec["tpot_ms"]
    return float(np.percentile(xs, 95)) if xs else None
