"""The port's benchmark: one run of one cell on one CUDA card.

    python3 port_bench/run.py --workload olmo-1b.chat-poisson --seed 7 \\
        --seconds 51 --trace 0

Finds the cell in BENCHMARK.json, its configuration, traffic, limits and
metric readers under port_bench/, builds `repro_torch`'s
InferenceEngine from them, warms the shapes the traffic uses, drives the
window (`driver.py`), judges the served tokens against the plain
reference (`check.py`) and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `check`, the numbers compared
beside their limits (also the last lines of standard error).

Exits non-zero, printing no result, without a CUDA card, without the
program beside it, or when the JAX package or JAX itself was loaded.
Kernel builds stay inside the checkout: the port's under build/kernels/,
Triton's under build/triton/.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str) -> int:
    print(f"port_bench: {msg}", file=sys.stderr)
    return 2


def metrics_of(rec, names) -> dict:
    from port_bench.harness import BENCH, load_metric
    out = {}
    for m in names:
        value = load_metric(BENCH, m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["family_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in ops],
            "idle_gaps": [list(kv) for kv in idle]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: this benchmark runs on the card only")
    try:
        from port_bench.harness import forbidden_modules, load_cell, run_cell
        spec = load_cell(ROOT / "port_bench", args.workload)
        import repro_torch  # noqa: F401  (the program under test)
    except (ImportError, OSError, KeyError) as e:
        return fail(f"cannot set up {args.workload!r}: {e!r}")
    if torch.cuda.device_count() < int(spec["cell"]["chips"]):
        return fail(f"{args.workload} needs {spec['cell']['chips']} cards, "
                    f"{torch.cuda.device_count()} found")
    rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   started=STARTED)
    bad = forbidden_modules()
    if bad:
        return fail(f"forbidden modules loaded: {', '.join(bad)}")
    names = spec["per_layer"] if args.trace else spec["end_to_end"]
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics_of(rec, names),
              "device": rec["device"]}
    if args.trace:
        t = rec["trace"]
        print(f"trace: {t['kernels']} kernels, {t['runtime_launches']} "
              f"launch calls, {t['tokens']} tokens in {t['window_s']:.3f} s;"
              f" clocks {t['clock']}", file=sys.stderr)
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = breakdown(rec["trace"])
    b = rec["backlog"]
    if b:
        third = max(len(b) // 3, 1)
        print("in flight over the window's first / last third: "
              f"{sum(n for _, n in b[:third]) / third:.1f} / "
              f"{sum(n for _, n in b[-third:]) / third:.1f}",
              file=sys.stderr)
    if rec["ttft_ms"]:
        import numpy as np
        print(f"ttft p50 / p95 ms: {np.percentile(rec['ttft_ms'], 50):.1f}"
              f" / {np.percentile(rec['ttft_ms'], 95):.1f}", file=sys.stderr)
    result["check"] = rec["numbers"]
    from port_bench.check import print_numbers
    print_numbers(rec["numbers"], rec["readings"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
