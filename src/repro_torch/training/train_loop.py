"""The training loop on one device, the counterpart of
`repro.training.train_loop`:

* deterministic restart-safe data (`SyntheticLM.batch_at(step)`),
* periodic atomic checkpoints (`CheckpointManager`) and one at the end,
* crash recovery: `Trainer.run` resumes from the latest checkpoint, and
  training 2N steps equals training N, crashing and resuming N, bit for
  bit (the step is deterministic on the card too: the embedding's and
  the MoE dispatch's backward sum in a fixed order),
* optional int8 error-feedback gradient compression (`compress_grads`).

Each step reads nothing back to the host except on a logged step, where
the metrics come back in one transfer; a batch goes to the card from
pinned memory without waiting for the step before it.  JAX's
`remesh_state` (re-sharding a state onto another mesh) waits for the
distributed slice (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import build
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, SyntheticLM

METRICS = ("loss", "aux", "grad_norm", "lr")


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    log_every: int = 10
    compress_grads: bool = False
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 tcfg: TrainConfig,
                 opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                 mesh=None, strategy=None, device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build(cfg, self.device)
        self.data = SyntheticLM(data_cfg)
        self.mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.opt_cfg = opt_cfg or opt_lib.AdamWConfig()
        step_fn, self._init_fn = make_train_step(cfg, mesh, strategy,
                                                 self.opt_cfg, self.device)
        self._step = (self._compressed_step if tcfg.compress_grads
                      else step_fn)
        self.history: List[Dict] = []

    # ------------------------------------------------------------- #
    def _compressed_step(self, state, batch):
        grads, mets = loss_and_grads(self.model, state["params"], batch)
        _, deq, new_err = comp_lib.compress_tree(grads, state["err"])
        new_p, new_opt, om = opt_lib.adamw_update(
            state["params"], deq, state["opt"], state["step"], self.opt_cfg)
        return ({"params": new_p, "opt": new_opt, "err": new_err,
                 "step": state["step"] + 1},
                {"loss": mets["loss"], "aux": mets["aux"],
                 "grad_norm": om["grad_norm"], "lr": om["lr"]})

    def init_state(self, seed: int = 0):
        """{"params", "opt": {"m", "v"}, "step"} (and "err" under
        compress_grads), the params drawn from a generator seeded with
        `seed` on the trainer's device."""
        state = self._init_fn(generator_for(self.device, seed))
        if self.tcfg.compress_grads:
            state["err"] = comp_lib.init_error(state["params"])
        return state

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self.data.batch_at(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------- #
    def run(self, resume: bool = True, state=None) -> Dict[str, Any]:
        """Train to tcfg.steps, resuming from the latest checkpoint.
        `state` (a train state on the trainer's device: one `run` left,
        or one carried across from JAX with `params.tree_from_jax`)
        replaces `init_state(tcfg.seed)` as the start, and training goes
        on from its step.  A checkpoint is written every tcfg.ckpt_every
        steps and at the end; ckpt_every=0 writes none."""
        start = 0
        if state is None:
            state = self.init_state(self.tcfg.seed)
        else:
            start = int(state["step"])
        if resume:
            step0, state = self.mgr.restore_latest(state)
            if step0 is not None:
                start = step0
        t0 = time.monotonic()
        for step in range(start, self.tcfg.steps):
            state, metrics = self._step(state, self._batch(step))
            if (step + 1) % self.tcfg.log_every == 0 or \
                    step == self.tcfg.steps - 1:
                vals = torch.stack([metrics[k].float() for k in METRICS])
                m = dict(zip(METRICS, vals.tolist()))
                m["step"] = step + 1
                self.history.append(m)
            if self.tcfg.ckpt_every and \
                    (step + 1) % self.tcfg.ckpt_every == 0:
                self.mgr.save(step + 1, state)
        if self.tcfg.ckpt_every:
            self.mgr.save(self.tcfg.steps, state)
        return {"state": state, "history": self.history,
                "wall_s": time.monotonic() - t0,
                "resumed_from": start}
