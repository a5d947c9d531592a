"""Training driver: the xLSTM-125M assigned architecture on the synthetic
LM pipeline, with checkpoint/restart fault tolerance — the port's
counterpart of examples/train_100m.py, with the same flags and
`--device` (the card unless told otherwise).

The full run trains the full xlstm-125m (6 mLSTM + sLSTM pairs, d 768,
vocab 50304); --tiny trains its reduced config, the same code path
(remat, AdamW, atomic checkpoints, crash-resume), on the CPU in seconds.

    python -m repro_torch.examples.train_100m                 # the card
    python -m repro_torch.examples.train_100m --tiny --device cpu
    python -m repro_torch.examples.train_100m --crash-at 30   # crash+resume
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, Trainer


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train100m"))
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a crash after N steps, then resume")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, log=print) -> Dict:
    """The example's run: with --crash-at N a first Trainer stops after N
    steps ("the crash"), then a second one resumes from its latest
    checkpoint to --steps.  Returns the last Trainer's `run` result, with
    "phases": the `run` result of each Trainer in order."""
    cfg = ARCHS["xlstm-125m"].reduced() if args.tiny \
        else ARCHS["xlstm-125m"]
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    ocfg = AdamWConfig(lr=3e-3 if args.tiny else 6e-4, warmup_steps=10,
                       total_steps=args.steps)
    log(f"arch={cfg.name} params~{cfg.num_params()/1e6:.1f}M "
        f"tokens/step={dc.batch * dc.seq_len} device={args.device}")
    phases = []
    if args.crash_at:
        log(f"-- phase 1: train to step {args.crash_at}, then 'crash'")
        t = Trainer(cfg, dc, TrainConfig(steps=args.crash_at,
                                         ckpt_every=max(args.crash_at // 2,
                                                        1),
                                         ckpt_dir=args.ckpt, log_every=10),
                    ocfg, device=args.device)
        phases.append(t.run())
        log("-- phase 2: restart, resume from latest checkpoint")
    t = Trainer(cfg, dc, TrainConfig(steps=args.steps,
                                     ckpt_every=max(args.steps // 4, 1),
                                     ckpt_dir=args.ckpt, log_every=10),
                ocfg, device=args.device)
    result = t.run()
    phases.append(result)
    if result["resumed_from"]:
        log(f"resumed from step {result['resumed_from']}")
    first = result["history"][0]["loss"]
    last = result["history"][-1]["loss"]
    log(f"loss {first:.4f} -> {last:.4f} over "
        f"{args.steps - result['resumed_from']} steps "
        f"({result['wall_s']:.1f}s)")
    if not result["resumed_from"] and args.steps >= 60:
        assert last < first, "training must reduce loss on structured data"
    return dict(result, phases=phases)


def main(argv: Optional[List[str]] = None) -> None:
    train(parse(argv))


if __name__ == "__main__":
    main()
