"""What the wire adds to a request, with and without Nagle's algorithm.

    python3 tools/wire_latency.py                      # the card
    python3 tools/wire_latency.py --device cpu --reduced

Builds the HTTP service with the launcher's own `build_service` (the
arguments are the launcher's: by default llama3.2-1b and qwen3-1.7b at
full width on the card), then, on one keep-alive connection, sends 12
greedy 4-token completions one after another and one 32-token stream,
four times: with the handler's `disable_nagle_algorithm` off (the JAX
package's server), on (the port's), on, off.  Prints one JSON line per
run: the client's latency less the Gateway's own (submit to finish) for
each non-streamed request, p50 and max, and the stream's TTFT and p50
gap between token frames, on the client's clock.  The engines' work is
in both numbers; only the wire's share differs between the two forms.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api.http import HTTPClient  # noqa: E402
from repro_torch.api.http import server as server_mod  # noqa: E402
from repro_torch.api.http.__main__ import build_service  # noqa: E402


def run(server, model, nodelay):
    server_mod._Handler.disable_nagle_algorithm = nodelay
    server.start()
    c = HTTPClient(server.url())
    try:
        extra = []
        for i in range(12):
            t0 = time.perf_counter()
            out = c.complete(model, [1, 2, 3, i], max_tokens=4)
            extra.append((time.perf_counter() - t0
                          - out["metadata"]["latency_s"]) * 1e3)
        t0 = time.perf_counter()
        arrivals = [time.perf_counter() for ch in c.complete(
            model, [5, 6, 7], max_tokens=32, stream=True)
            if ch["choices"][0].get("token") is not None]
    finally:
        c.close()
        server.stop(timeout_s=60)
    return {"nodelay": nodelay, "requests": len(extra),
            "wire_added_ms_p50": float(np.median(extra)),
            "wire_added_ms_max": max(extra),
            "wire_added_ms": extra,
            "stream_ttft_ms": (arrivals[0] - t0) * 1e3,
            "stream_gap_ms_p50": float(np.median(np.diff(arrivals)) * 1e3),
            "stream_tokens": len(arrivals)}


def main(argv=None) -> int:
    server, ctrl = build_service(["--port", "0"] + list(
        sys.argv[1:] if argv is None else argv))
    model = ctrl.replicas.models()[0]
    for nodelay in (False, True, True, False):
        print(json.dumps({"model": model, **run(server, model, nodelay)}),
              flush=True)
    server_mod._Handler.disable_nagle_algorithm = True
    return 0


if __name__ == "__main__":
    sys.exit(main())
