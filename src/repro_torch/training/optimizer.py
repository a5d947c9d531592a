"""Optimizers on dicts of tensors, the counterpart of
`repro.training.optimizer`: AdamW (f32 moments, the params in their own
dtype) with a linear warmup and cosine decay, and Adafactor (factored
second moments).

Numerics as JAX's: each gradient cast to f32 and clipped by the global
norm, the moments and the update in f32, the new param cast back to its
dtype.  Weight decay applies where `p.ndim >= 2`, so the stacked (L, d)
norm scales are decayed too: JAX's quirk, kept (ROADMAP C).  The global
norm sums each leaf's f32 sum of squares in JAX's leaf order (sorted
keys, `training.tree`).  The step, the lr and the clip scale stay
tensors on the params' device: an update reads nothing back to the
host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.training.tree import Tree, leaves, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio, in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's f32 sum
    of squares."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def adamw_init(params: Tree) -> Dict[str, Tree]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def adamw_update(params: Tree, grads: Tree, opt_state: Dict[str, Tree],
                 step: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step at `step` (a 0-d int tensor).  Returns (new_params,
    new_opt_state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float() + 1.0
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # no decay on norms/bias
            step_ = step_ + cfg.weight_decay * p.float()
        return (p.float() - lr * step_).to(p.dtype), m2, v2

    out = [upd(*leaf) for leaf in zip(
        leaves(params), leaves(grads), leaves(opt_state["m"]),
        leaves(opt_state["v"]), strict=True)]
    new_p, new_m, new_v = (unflatten(params, (o[j] for o in out))
                           for j in range(3))
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------- #
# Adafactor (factored second moments)

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0


def adafactor_init(params: Tree) -> Dict[str, Tree]:
    """A matrix (ndim >= 2) keeps row and column second moments ("vr" over
    the last dim dropped, "vc" over the one before it); a vector keeps
    "v" whole."""
    def fac(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"fac": _map_params(fac, params)}


def _map_params(fn, params: Tree, *rest: Tree) -> Tree:
    """fn over each param leaf (and the matching subtrees of `rest`),
    where a leaf of the result may itself be a dict."""
    if isinstance(params, dict):
        return {k: _map_params(fn, params[k], *(r[k] for r in rest))
                for k in params}
    return fn(params, *rest)


def adafactor_update(params: Tree, grads: Tree, opt_state: Dict[str, Tree],
                     step: torch.Tensor, cfg: AdafactorConfig):
    """One Adafactor step.  Returns (new_params, new_opt_state, {})."""
    t = step.float() + 1.0
    beta = 1.0 - torch.pow(t, -cfg.decay)

    def upd(p, g, st):
        g = g.float()
        g2 = g * g + cfg.eps
        if p.ndim >= 2:
            vr = beta * st["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * st["vc"] + (1 - beta) * g2.mean(-2)
            r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=cfg.eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + cfg.eps)
            st2 = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            u = g / (torch.sqrt(v) + cfg.eps)
            st2 = {"v": v}
        rms = torch.sqrt((u * u).mean())
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        return (p.float() - cfg.lr * u).to(p.dtype), st2

    out = _map_params(upd, params, grads, opt_state["fac"])
    new_p = _map_params(lambda o: o[0], out)
    new_fac = _map_params(lambda o: o[1], out)
    return new_p, {"fac": new_fac}, {}
