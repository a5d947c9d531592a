"""How `correct` is decided: the served tokens of a sample of finished
requests against the plain reference (`reference/<name>.py`, named by the
configuration), after the window has closed and the program's state is
freed.

The sample is drawn from the seed: the finished request with the most
served tokens, and `SAMPLE - 1` more.  The reference runs once over each
prompt with its served tokens (teacher forcing), and at each served
position reads the gap by which the served token's logit lies below the
reference's best (0 where the program served the reference's argmax).
The readings are the widest gap over the sample, the mean gap, and the
share of served tokens that are not the reference's argmax; each cell's
`limits/<cell>.json` names the ones compared and their limits (with the
readings they were set from in PERF.md).  Every finished request must
also hold exactly its budget of tokens (every request is greedy with no
end token), and the sample must hold `min_sampled_tokens`.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

SAMPLE = 16


def load_reference(bench: Path, name: str):
    path = bench / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_ref_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(finished: List, seed: int) -> List:
    """The longest finished request, then others drawn from the seed."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-len(r.output), r.index))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    pick = rng.permutation(len(rest))[:SAMPLE - 1]
    return [order[0]] + [rest[i] for i in sorted(pick)]


def gaps(reference, params: Dict, model: Dict, engine: Dict, req) -> np.ndarray:
    """The gap at each served position of one request."""
    toks = list(req.prompt) + list(req.output[:-1])
    with torch.no_grad():
        logits = reference.served_logits(params, model, engine, toks,
                                          len(req.prompt))
    served = torch.tensor(req.output, dtype=torch.long,
                          device=logits.device)
    gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
    return gap.double().cpu().numpy()


def judge(bench: Path, cfg: Dict, limits: Dict, params: Dict, finished: List,
          budget_misses: int, seed: int) -> Dict:
    """Runs the reference over the sample; returns `correct`, the numbers
    compared with their limits (`limits/<cell>.json` names them), and the
    readings not compared."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = load_reference(bench, cfg["reference"])
    picked = sample(finished, seed)
    all_gaps = [gaps(reference, params, cfg["model"], cfg["engine"], req)
                for req in picked]
    g = np.concatenate(all_gaps) if all_gaps else np.zeros(0)
    readings = {"logit_gap_max": float(g.max()) if g.size else 0.0,
                "logit_gap_mean": float(g.mean()) if g.size else 0.0,
                "argmax_miss_share": float((g > 0).mean()) if g.size else 0.0}
    numbers = {name: {"value": readings[name], "limit": float(lim)}
               for name, lim in limits["compared"].items()}
    numbers["budget_misses"] = {"value": budget_misses, "limit": 0}
    numbers["sampled_tokens"] = {"value": int(g.size),
                                 "limit": int(limits["min_sampled_tokens"])}
    correct = (bool(picked) and budget_misses == 0
               and g.size >= numbers["sampled_tokens"]["limit"]
               and all(readings[name] <= n["limit"]
                       for name, n in numbers.items() if name in readings))
    return {"correct": correct, "numbers": numbers, "readings": readings}


def print_numbers(numbers: Dict, readings: Dict) -> None:
    for name, value in readings.items():
        if name not in numbers:
            print(f"reading {name}: {value!r} (not compared)",
                  file=sys.stderr)
    for name, n in numbers.items():
        rel = ">=" if name == "sampled_tokens" else "<="
        print(f"check {name}: {n['value']!r} (limit {rel} {n['limit']!r})",
              file=sys.stderr)
