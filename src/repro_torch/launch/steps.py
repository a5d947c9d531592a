"""Step builders — the counterpart of `repro.launch.steps`: the train
step (loss, autograd, AdamW) on one device or sharded over a mesh, the
prefill and decode steps on one device (each with the int8 KV cache as
an option, the `int8kv` variant of JAX's `lower_cell`), the sharding
trees of params, batches, caches and train states, and stand-ins for
every input (meta-device tensors: shapes and dtypes, no memory).

The sharded train step (`make_train_step(cfg, mesh, strategy)`) holds
its state as DTensors laid out by `state_shardings` and runs the loss
with JAX's hooks: `sh` (the activations' layouts), `shw` (each layer's
weights moved to their compute layout: `train_compute_strategy` under
fsdp_tp, everything gathered under fsdp) and the three Megatron helpers
attached to `sh`.  A mesh given to the prefill or decode step raises
NotImplementedError: the sharded serving steps come with `lower_cell`
and the dry run (the next slice of ROADMAP A9).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike, torch_dtype
from repro_torch.distributed.sharding import (Strategy, distribute,
                                              full_tensor, is_dtensor,
                                              make_sharder, redistribute,
                                              make_tp_col_projector,
                                              make_tp_gather,
                                              make_tp_projector,
                                              make_weight_sharder,
                                              train_compute_strategy,
                                              tree_shardings)
from repro_torch.models import Model, build
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, map_tree, unflatten

META = torch.device("meta")

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "prefix_embeds": ("batch", "seq", "embed"),
    "src_embeds": ("batch", "seq", "embed"),
}


def _single_device(mesh, strategy) -> None:
    if mesh is not None or strategy is not None:
        raise NotImplementedError(
            "the sharded prefill and decode steps wait for slice 16 of the "
            "port (lower_cell and the dry run, ROADMAP A9); repro_torch "
            "runs them on one device")


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
# Sharding trees (DTensor placements, one per mesh dim)

def param_shardings(model: Model, mesh, strategy: Strategy):
    return tree_shardings(model.param_axes(), model.param_specs(), mesh,
                          strategy)


def batch_shardings(cfg: ArchConfig, specs: Dict, mesh, strategy: Strategy):
    return {k: strategy.placements_for(BATCH_AXES[k], v.shape, mesh)
            for k, v in specs.items()}


def cache_shardings(model: Model, cache_specs, mesh, strategy: Strategy,
                    kv_quant: bool = False):
    return tree_shardings(model.cache_axes(kv_quant=kv_quant),
                          cache_specs, mesh, strategy)


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def state_shardings(cfg: ArchConfig, mesh, strategy: Strategy):
    ps = param_shardings(build(cfg, META), mesh, strategy)
    return {"params": ps, "opt": {"m": ps, "v": ps},
            "step": replicated(mesh)}


def place_tree(tree, shardings, mesh):
    """A tree of full tensors (alike on every rank) as DTensors in
    `shardings` (a matching tree of placements), each rank keeping its
    own blocks; no communication."""
    out = [distribute(t, mesh, pl) for t, pl in zip(
        leaves(tree), _placement_leaves(tree, shardings), strict=True)]
    return unflatten(tree, out)


def _placement_leaves(tree, shardings):
    """The placements of `shardings` in the leaf order of `tree` (a
    placements tuple is a leaf, not a level of the tree)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _placement_leaves(tree[k], shardings[k])]
    return [shardings]


def gather_tree(tree):
    """A tree with every DTensor leaf gathered to its full tensor (a
    collective over its mesh: every rank calls it)."""
    return map_tree(full_tensor, tree)


# --------------------------------------------------------------------- #
# Step builders

def _mesh_device(mesh, device: DeviceLike) -> DeviceLike:
    if device is not None or mesh is None:
        return device
    return mesh.device_type


def make_train_step(cfg: ArchConfig, mesh=None, strategy=None,
                    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                    device: DeviceLike = None):
    """Returns (train_step, init_state).  init_state(generator) -> {"params",
    "opt": {"m", "v"}, "step"} on `device` ("cuda" unless given, or the
    mesh's device type); train_step(state, batch) -> (new state, {"loss",
    "aux", "grad_norm", "lr"}), the loss under remat, its gradients by
    autograd, one AdamW update.  Every metric stays a 0-d tensor on the
    device.

    With a mesh and a strategy the state is DTensors laid out by
    `state_shardings` (each rank draws the full init from the same
    generator seed and keeps its blocks), a batch of full tensors is
    laid out by `batch_shardings`, and the loss runs with JAX's `sh`,
    `shw` and Megatron hooks; the metrics come back as plain 0-d tensors,
    alike on every rank.  The gradients return to the params' layout by
    the redistributions' own backward (all-gather forward, reduce-scatter
    backward), and AdamW's global norm sums every rank's blocks."""
    if (mesh is None) != (strategy is None):
        raise ValueError("a sharded step needs both a mesh and a strategy")
    model = build(cfg, _mesh_device(mesh, device))
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    sh = make_sharder(mesh, strategy)
    shw = None
    if mesh is not None:
        # explicit per-layer FSDP weight gather: fsdp_tp gathers only the
        # embed dim; pure fsdp gathers whole layer weights
        comp = train_compute_strategy(mesh) if strategy.name == "fsdp_tp" \
            else Strategy(rules={}, priority=[], name="gather_all")
        shw = make_weight_sharder(mesh, comp)
        # explicit Megatron-SP collectives: row-parallel reduce-scatter
        # out-projections, the column-parallel gather + einsum, and the
        # standalone seq gather
        sh.tp_project = make_tp_projector(mesh, strategy, comp)
        sh.tp_col_project = make_tp_col_projector(mesh, strategy, comp)
        sh.tp_gather = make_tp_gather(mesh, strategy)
        st_sh = state_shardings(cfg, mesh, strategy)

    def init_state(generator: torch.Generator):
        params = model.init(generator)
        state = {"params": params, "opt": opt_lib.adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        if mesh is not None:
            state = place_tree(state, st_sh, mesh)
        return state

    def train_step(state, batch):
        if mesh is None:
            grads, mets = loss_and_grads(model, state["params"], batch)
            new_p, new_opt, om = opt_lib.adamw_update(
                state["params"], grads, state["opt"], state["step"],
                opt_cfg)
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            batch = place_batch(cfg, batch, mesh, strategy)
            with implicit_replication():
                grads, mets = loss_and_grads(model, state["params"], batch,
                                             sh=sh, shw=shw)
                new_p, new_opt, om = opt_lib.adamw_update(
                    state["params"], grads, state["opt"], state["step"],
                    opt_cfg)
            mets = gather_tree(mets)
            om = gather_tree(om)
        return ({"params": new_p, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": mets["loss"], "aux": mets["aux"],
                 "grad_norm": om["grad_norm"], "lr": om["lr"]})

    def grads(params, batch):
        """(grads, metrics) with the step's hooks and batch layout, for a
        caller that updates on its own (the trainer's compressed step)."""
        if mesh is None:
            return loss_and_grads(model, params, batch)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        batch = place_batch(cfg, batch, mesh, strategy)
        with implicit_replication():
            return loss_and_grads(model, params, batch, sh=sh, shw=shw)

    train_step.grads = grads
    return train_step, init_state


def place_batch(cfg: ArchConfig, batch: Dict[str, torch.Tensor], mesh,
                strategy: Strategy) -> Dict[str, torch.Tensor]:
    """A batch of full tensors (alike on every rank) as DTensors laid out
    by `batch_shardings`; a batch of DTensors passes as it is."""
    pl = batch_shardings(cfg, batch, mesh, strategy)
    return {k: v if is_dtensor(v) else distribute(v, mesh, pl[k])
            for k, v in batch.items()}


def loss_and_grads(model, params, batch, remat: bool = True, sh=None,
                   shw=None):
    """(grads, metrics) of model.loss at params: every leaf's gradient by
    autograd (`jax.value_and_grad`), the params themselves untouched
    (the loss sees detached aliases that require grad).  `sh` / `shw`:
    a sharded step's hooks; its loss is made replicated before the
    backward, so the seed gradient is one on every rank."""
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    with torch.enable_grad():
        if sh is None:
            total, mets = model.loss(live, batch, remat=remat)
        else:
            total, mets = model.loss(live, batch, remat=remat, sh=sh,
                                     shw=shw)
            if is_dtensor(total):
                total = redistribute(total, replicated(total.device_mesh))
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
