"""Step builders on one device — the counterpart of
`repro.launch.steps` without its sharding: the train step (loss,
autograd, AdamW), the prefill and decode steps (each with the int8 KV
cache as an option, the `int8kv` variant of JAX's `lower_cell`), and
stand-ins for every input (meta-device tensors: shapes and dtypes, no
memory).

A mesh or a strategy raises NotImplementedError: sharding, the mesh,
the dry run and `lower_cell` wait for the distributed slice (ROADMAP
A9).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike, torch_dtype
from repro_torch.models import build
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, map_tree

META = torch.device("meta")


def _single_device(mesh, strategy) -> None:
    if mesh is not None or strategy is not None:
        raise NotImplementedError(
            "repro_torch runs one device: a mesh or a sharding strategy "
            "waits for the distributed slice (ROADMAP A9)")


# --------------------------------------------------------------------- #
# Input stand-ins (meta-device tensors: no allocation)

def batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """The batch of one step, as meta tensors: tokens (and labels) (B,
    S - vision prefix) int32, a vision model's prefix_embeds and an
    encoder-decoder's src_embeds in the model dtype."""
    b, s = shape.batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    vision = cfg.frontend == "vision"
    n_text = s - (cfg.n_prefix_tokens if vision else 0)
    out = {"tokens": torch.empty((b, n_text), dtype=torch.int32,
                                 device=META)}
    if with_labels:
        out["labels"] = torch.empty((b, n_text), dtype=torch.int32,
                                    device=META)
    if vision:
        out["prefix_embeds"] = torch.empty(
            (b, cfg.n_prefix_tokens, cfg.d_model), dtype=dt, device=META)
    if cfg.is_encdec:
        out["src_embeds"] = torch.empty(
            (b, int(s * cfg.encdec.src_len_ratio), cfg.d_model), dtype=dt,
            device=META)
    return out


def cache_len_for(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Decode cache length: seq_len + always-resident prefix tokens."""
    return shape.seq_len + cfg.n_meta_tokens + \
        (cfg.n_prefix_tokens if cfg.frontend == "vision" else 0)


def decode_specs(cfg: ArchConfig, shape: ShapeSpec,
                 kv_quant: bool = False) -> Dict[str, Any]:
    """A decode step's inputs as meta tensors: the cache (int8 under
    kv_quant), token and pos (B,) int32."""
    b = shape.batch
    src = int(shape.seq_len * cfg.encdec.src_len_ratio) if cfg.is_encdec \
        else 0
    cache = build(cfg, META).init_cache(b, cache_len_for(cfg, shape),
                                        src_len=src, kv_quant=kv_quant)
    vec = torch.empty((b,), dtype=torch.int32, device=META)
    return {"cache": cache, "token": vec, "pos": vec}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """All step inputs for this (arch x shape) cell, as meta tensors."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    return decode_specs(cfg, shape)


def state_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """A train state's leaves as meta tensors: params, f32 moments, the
    int32 step."""
    p = build(cfg, META).init(None)

    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device=META)
    return {"params": p, "opt": {"m": map_tree(f32, p),
                                 "v": map_tree(f32, p)},
            "step": torch.empty((), dtype=torch.int32, device=META)}


# --------------------------------------------------------------------- #
# Step builders

def make_train_step(cfg: ArchConfig, mesh=None, strategy=None,
                    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                    device: DeviceLike = None):
    """Returns (train_step, init_state).  init_state(generator) -> {"params",
    "opt": {"m", "v"}, "step"} on `device` ("cuda" unless given);
    train_step(state, batch) -> (new state, {"loss", "aux", "grad_norm",
    "lr"}), the loss under remat, its gradients by autograd, one AdamW
    update.  Every metric stays a 0-d tensor on the device."""
    _single_device(mesh, strategy)
    model = build(cfg, device)
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()

    def init_state(generator: torch.Generator):
        params = model.init(generator)
        return {"params": params, "opt": opt_lib.adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}

    def train_step(state, batch):
        grads, mets = loss_and_grads(model, state["params"], batch)
        new_p, new_opt, om = opt_lib.adamw_update(
            state["params"], grads, state["opt"], state["step"], opt_cfg)
        return ({"params": new_p, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": mets["loss"], "aux": mets["aux"],
                 "grad_norm": om["grad_norm"], "lr": om["lr"]})

    return train_step, init_state


def loss_and_grads(model, params, batch, remat: bool = True):
    """(grads, metrics) of model.loss at params: every leaf's gradient by
    autograd (`jax.value_and_grad`), the params themselves untouched
    (the loss sees detached aliases that require grad)."""
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    with torch.enable_grad():
        total, mets = model.loss(live, batch, remat=remat)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = iter(torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads))
    return (map_tree(lambda _: next(grads), live),
            {k: v.detach() for k, v in mets.items()})


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                      strategy=None, kv_quant: bool = False,
                      device: DeviceLike = None):
    """prefill_step(params, batch) -> (last logits (B, V), cache, pos),
    the cache `cache_len_for(shape)` long (int8 under kv_quant; xLSTM
    ignores both)."""
    _single_device(mesh, strategy)
    model = build(cfg, device)
    max_len = cache_len_for(cfg, shape)

    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch["tokens"],
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 src_embeds=batch.get("src_embeds"),
                                 cache_len=max_len, kv_quant=kv_quant)
    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None, strategy=None,
                     kv_quant: bool = False, device: DeviceLike = None):
    """decode_step(params, cache, token, pos) -> (logits (B, V), cache),
    the cache advanced in place.  kv_quant says the cache is int8 (from
    `make_prefill_step(kv_quant=True)`); a cache of the other kind
    raises."""
    _single_device(mesh, strategy)
    model = build(cfg, device)

    def decode_step(params, cache, token, pos):
        if cfg.block != "xlstm" and ("k_scale" in cache) != kv_quant:
            raise ValueError(f"decode_step built with kv_quant={kv_quant} "
                             f"got a cache with keys {sorted(cache)}")
        with torch.no_grad():
            return model.decode(params, cache, token, pos)
    return decode_step
