"""95th percentile, over the requests due inside the window that got a
first token, of the time from their due time to that token's callback
(host clock).  Below the knee it is mostly the wait for admission (one
group of rows a step): a per-layer reading of the engine's queue, since
its runs spread too far to bound (PERF.md, section 2)."""
import numpy as np


def read(rec):
    xs = rec["ttft_ms"]
    return float(np.percentile(xs, 95)) if xs else None
