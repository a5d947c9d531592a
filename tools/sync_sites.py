"""Where one checkout's engine step makes the host wait on the card, and
what the step costs, on one CUDA device, so that two checkouts can be
compared.

    python3 tools/sync_sites.py [--src ROOT] [--label NAME] [--reps N]

Imports `repro_torch` from ROOT/src (default: this checkout) and, from
this checkout, only `chip_smoke.py`'s serve_setup, serve_requests, drive
and SyncRecorder, which import the package lazily.  So each checkout
runs in a process of its own: to compare a commit with its parent on
one card, unpack the parent with `git archive` into a gitignored
directory and run, in one command, parent, change, change, parent.

serve_bf16's engine and traffic: the full OLMo-1B in bf16 (seeded
weights), EngineConfig(n_slots=8, max_len=1024, page_size=16,
decode_block=8, paged_attention=True), the 12 seeded requests of
`chip_smoke.serve_requests`.  The first run records every synchronizing
CUDA call (torch.cuda.set_sync_debug_mode("warn"): a blocking copy
either way, a stream synchronize, an op that reads a size off the card)
by the innermost frame of the checkout's package and by the engine part
on its stack (an admission, a decode block), beside the engine's own
host_syncs count.  Then N runs of the same requests on fresh engines
over the same weights, unrecorded: wall seconds, tokens/s, the p50
step's host milliseconds and the p50 TTFT.  One JSON line, with the
card's name and power limit; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_sites: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.src).resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs             # puts this checkout's src first
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.kernels import ops
    pkg = (root / "src" / "repro_torch").resolve()
    if Path(repro_torch.__file__).resolve().parent != pkg:
        raise RuntimeError(f"repro_torch from {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ops.build()
    cfg, ecfg, eng, make_requests, _ = cs.serve_setup(
        dev, paged_attention=True)
    params = eng.params
    sites, parts = {}, {}
    before = eng.host_syncs
    with cs.SyncRecorder() as rec:
        step_ms, wall = cs.drive(eng, make_requests())
    for stack in rec.records:
        found = cs.sync_site(stack, pkg)
        path, qual, line, part, _ = found or (pkg / "?", "?", 0, "?", [])
        site = f"{path.relative_to(pkg).as_posix()}::{qual}:{line}"
        sites[site] = sites.get(site, 0) + 1
        parts[part] = parts.get(part, 0) + 1
    st = eng.perf_stats()
    runs = []
    for _ in range(args.reps):
        *_, eng, make_requests, _ = cs.serve_setup(
            dev, params=params, paged_attention=True)
        reqs = make_requests()
        torch.cuda.synchronize()
        step_ms, wall = cs.drive(eng, reqs)
        torch.cuda.synchronize()
        runs.append({"wall_s": wall,
                     "tok_per_s": eng.perf_stats()["tokens"] / wall,
                     "p50_step_ms": float(np.median(step_ms)),
                     "p50_ttft_ms": float(np.median([r.ttft for r in reqs]))
                     * 1e3, "steps": len(step_ms)})
    print(json.dumps({
        "label": args.label, "src": str(root), "model": cfg.name,
        "syncs": len(rec.records), "host_syncs": st["host_syncs"] - before,
        "by_part": parts, "by_site": sites,
        "decode_blocks": st["decode_dispatches"],
        "admissions": st["prefill_dispatches"], "runs": runs,
        "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
