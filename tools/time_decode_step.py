"""Time the unsharded decode step of one checkout on one CUDA device, so
that two checkouts can be compared.

    python3 tools/time_decode_step.py [--src ROOT] [--label NAME]

Imports `repro_torch` from ROOT/src (default: this checkout) and nothing
else of a checkout, so each checkout runs in a process of its own: to
compare a commit with its parent on one card, unpack the parent with
`git archive` into a gitignored directory and run, in one command,
parent, change, change, parent (and again).

The step: the full OLMo-1B (bf16, 16 layers, random weights from a seed)
through `launch.steps.make_decode_step`, 8 rows at position 700 of a
1024-long cache.  It is host-bound (its launches take longer to issue
than to run), so the reading is mostly the host's.  It prints one JSON
line: event_ms, CUDA events around 20 steps issued back to back, per
step, median of 7 such batches after 10 warm-up steps (every batch's
reading in event_ms_all), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src) / "src"))

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import build
    from repro_torch.models import transformer as tf

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    ops.build()
    dev = torch.device("cuda", 0)
    cfg = ARCHS["olmo-1b"]
    params = build(cfg, dev).init(torch.Generator(dev).manual_seed(7))
    cache = tf.init_cache(cfg, 8, 1024, dev)
    tok = torch.zeros(8, dtype=torch.int32, device=dev)
    pos = torch.full((8,), 700, dtype=torch.int32, device=dev)
    step = steps.make_decode_step(cfg, device=dev)
    per = []
    with torch.no_grad():
        for _ in range(10):
            step(params, cache, tok, pos)
        torch.cuda.synchronize()
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                step(params, cache, tok, pos)
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / 20)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"label": args.label, "src": args.src,
                      "event_ms": sorted(per)[3], "event_ms_all": per,
                      "card": card, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
