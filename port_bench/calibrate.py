"""The readings that a cell's limits are set from, on the card, in one
process (not run by the benchmark's own runs):

    python3 port_bench/calibrate.py --workload olmo-1b.chat-poisson \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 8

For each seed, a run of the cell as committed (shortened window), and
for each control seed a run with the program's int8 path switched on
(`quantize="int8"`: weights int8, the nearest precision below the
configuration's bf16); each prints one JSON line with the numbers
compared, `correct`, and the end-to-end readings.  `--rates` instead
runs the cell at each open-loop rate and prints whether it was sustained
(the backlog does not grow over the window, and at least 97% of the
requests due were completed in it), the sweep that finds the knee.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def summary(rec, **extra):
    from port_bench.harness import BENCH, load_metric
    out = {"correct": rec["correct"], **rec["readings"],
           **{k: v["value"] for k, v in rec["numbers"].items()},
           "attempted": rec["attempted"], "failed": rec["failed"],
           "peak_bytes": rec["device"]["memory_peak_bytes"], **extra}
    for m in rec["spec"]["end_to_end"]:
        out[m["name"]] = load_metric(BENCH, m["name"]).read(rec)
    return out


def sustained(rec) -> dict:
    """Backlog growth over the window and the share completed."""
    b = rec["backlog"]
    third = max(len(b) // 3, 1)
    first = sum(n for _, n in b[:third]) / third
    last = sum(n for _, n in b[-third:]) / third
    share = rec["completed_in_window"] / max(rec["attempted"], 1)
    ok = last <= 1.1 * first + 2 and share >= 0.97
    return {"backlog_first": first, "backlog_last": last,
            "completed_share": share, "sustained": ok}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from port_bench.harness import run_cell
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({"cell": args.workload, **obj})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        rec = run_cell(args.workload, seed, args.seconds, False, started=t)
        emit(summary(rec, seed=seed, run="program"))
    for seed in controls:
        t = time.perf_counter()
        rec = run_cell(args.workload, seed, args.seconds, False, started=t,
                       overrides={"quantize": "int8"})
        emit(summary(rec, seed=seed, run="control_int8"))
    for rate in [float(r) for r in args.rates.split(",") if r]:
        t = time.perf_counter()
        rec = run_cell(args.workload, 1000 + int(rate * 10), args.seconds,
                       False, started=t, traffic_overrides={"rate": rate})
        emit(summary(rec, rate=rate, run="sweep", **sustained(rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
