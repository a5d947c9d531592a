"""Step builders — the counterpart of `repro.launch.steps`: the train,
prefill and decode steps, each on one device or sharded over a mesh
(the prefill and decode steps with the int8 KV cache as an option, the
`int8kv` variant), the sharding trees of params, batches, caches and
train states, stand-ins for every input (meta-device tensors: shapes and
dtypes, no memory), and `lower_cell`, the dry run's unit.

The sharded train step (`make_train_step(cfg, mesh, strategy)`) holds
its state as DTensors laid out by `state_shardings` and runs the loss
with JAX's hooks: `sh` (the activations' layouts), `shw` (each layer's
weights moved to their compute layout: `train_compute_strategy` under
fsdp_tp, everything gathered under fsdp) and the three Megatron helpers
attached to `sh`.  The sharded prefill and decode steps
(`make_prefill_step` / `make_decode_step` with a mesh and a strategy)
run the serving hooks (`serve_hooks`): the prefill's trunk is the
training forward's, with the flash kernel on each rank's rows and heads;
the decode step runs the decode kernel on each rank's block of the cache
(rows and kv heads), or, when the cache's positions are split, merges
the blocks' partials (`kernels.ops.lse_combine`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike, torch_dtype
from repro_torch.distributed.sharding import (Strategy, distribute,
                                              einsum_blocks, full_tensor,
                                              is_dtensor, make_sharder,
                                              make_tp_col_projector,
                                              make_tp_gather,
                                              make_tp_projector,
                                              make_weight_sharder,
                                              pick_strategy, redistribute,
                                              serve_strategy,
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
        # a projection no helper takes runs on the local blocks where no
        # input must move (a Partial result where a contracted index is
        # sharded), as in the serving steps
        sh.einsum = einsum_blocks
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


def serve_hooks(mesh, strategy: Strategy):
    """(sh, shw) of a sharded serving step: JAX's sharder with the three
    Megatron helpers attached and `sh.einsum`, the product wherever a
    helper falls back, on the local blocks where no collective is needed
    (`einsum_blocks`), and the weight mover.  The serve strategy
    stores the weights in their compute layout (over TP only), so shw is
    None and the helpers take the strategy for both operands; any other
    strategy's weights are moved to the serve strategy's layout a layer
    at a time, as the train step moves them to theirs."""
    compute = strategy if strategy.name == "serve" else serve_strategy(mesh)
    sh = make_sharder(mesh, strategy)
    sh.einsum = einsum_blocks
    sh.tp_project = make_tp_projector(mesh, strategy, compute)
    sh.tp_col_project = make_tp_col_projector(mesh, strategy, compute)
    sh.tp_gather = make_tp_gather(mesh, strategy)
    shw = None if compute is strategy else make_weight_sharder(mesh, compute)
    return sh, shw


def place_rows(x: torch.Tensor, mesh, strategy: Strategy) -> torch.Tensor:
    """A (B,) tensor (alike on every rank) as a DTensor laid out
    ("batch",); a DTensor passes as it is."""
    if is_dtensor(x):
        return x
    return distribute(x, mesh, strategy.placements_for(("batch",), x.shape,
                                                       mesh))


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, mesh=None,
                      strategy=None, kv_quant: bool = False,
                      device: DeviceLike = None):
    """prefill_step(params, batch) -> (last logits (B, V), cache, pos),
    the cache `cache_len_for(shape)` long (int8 under kv_quant; xLSTM
    ignores both).

    With a mesh and a strategy (JAX's `make_prefill_step(cfg, shape,
    mesh, strategy)`): params are DTensors laid out by `param_shardings`,
    a batch of full tensors is laid out by `batch_shardings` (a batch of
    DTensors passes), the model runs with `serve_hooks` (the flash kernel
    on each rank's rows and heads), and the cache comes back laid out by
    `cache_shardings`, so the decode step takes it as it is; the logits
    come back ("batch", "vocab") and pos ("batch",)."""
    if (mesh is None) != (strategy is None):
        raise ValueError("a sharded step needs both a mesh and a strategy")
    model = build(cfg, _mesh_device(mesh, device))
    max_len = cache_len_for(cfg, shape)
    if mesh is not None:
        sh, shw = serve_hooks(mesh, strategy)

    def prefill_step(params, batch):
        kw = dict(prefix_embeds=batch.get("prefix_embeds"),
                  src_embeds=batch.get("src_embeds"), cache_len=max_len,
                  kv_quant=kv_quant)
        if mesh is None:
            with torch.no_grad():
                return model.prefill(params, batch["tokens"], **kw)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        batch = place_batch(cfg, batch, mesh, strategy)
        kw.update(prefix_embeds=batch.get("prefix_embeds"),
                  src_embeds=batch.get("src_embeds"))
        with torch.no_grad(), implicit_replication():
            logits, cache, pos = model.prefill(params, batch["tokens"],
                                               sh=sh, shw=shw, **kw)
            pl = cache_shardings(model, cache, mesh, strategy,
                                 kv_quant=kv_quant)
            cache = {k: redistribute(v, pl[k]) for k, v in cache.items()}
        return logits, cache, pos
    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None, strategy=None,
                     kv_quant: bool = False, device: DeviceLike = None):
    """decode_step(params, cache, token, pos) -> (logits (B, V), cache),
    the cache advanced in place.  kv_quant says the cache is int8 (from
    `make_prefill_step(kv_quant=True)`); a cache of the other kind
    raises.

    With a mesh and a strategy (JAX's `make_decode_step(cfg, mesh,
    strategy)`): params and the cache are DTensors (the cache in any
    layout, `cache_shardings`' as the prefill step leaves it, and written
    in its local blocks: the counterpart of JAX donating it), token and
    pos full (B,) tensors or DTensors laid out ("batch",); the logits
    come back laid out ("batch", "vocab")."""
    if (mesh is None) != (strategy is None):
        raise ValueError("a sharded step needs both a mesh and a strategy")
    model = build(cfg, _mesh_device(mesh, device))
    if mesh is not None:
        sh, shw = serve_hooks(mesh, strategy)

    def decode_step(params, cache, token, pos):
        if cfg.block != "xlstm" and ("k_scale" in cache) != kv_quant:
            raise ValueError(f"decode_step built with kv_quant={kv_quant} "
                             f"got a cache with keys {sorted(cache)}")
        if mesh is None:
            with torch.no_grad():
                return model.decode(params, cache, token, pos)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        token, pos = (place_rows(t, mesh, strategy) for t in (token, pos))
        with torch.no_grad(), implicit_replication():
            return model.decode(params, cache, token, pos, sh=sh, shw=shw)
    return decode_step


# --------------------------------------------------------------------- #
# Lowering a cell (the dry run's unit)

@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell's step and its inputs, as meta
    DTensors in their layouts: the counterpart of JAX's `.lower()` of
    ShapeDtypeStructs.  `run()` runs the step once on them (nothing is
    computed on meta tensors: shapes, dtypes and layouts flow, and every
    collective goes to the world's process group)."""
    kind: str
    step: Any
    args: tuple
    donate_cache: bool = True

    def run(self):
        args = self.args
        if self.kind == "decode" and not self.donate_cache:
            args = (args[0], map_tree(torch.clone, args[1])) + args[2:]
        return self.step(*args)

    def inputs(self):
        """The step's inputs' leaves (DTensors)."""
        return [t for a in self.args for t in leaves(a)]


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               strategy_override: str = "", donate_cache: bool = True,
               variant: str = ""):
    """Build (not run) the step for one (arch x shape x mesh) cell: JAX's
    `lower_cell`.  Returns (cell, {"strategy", "variant"}).

    `pick_strategy` picks the strategy ("train" for a train shape, else
    "serve"; `strategy_override` names one).  The inputs are meta
    tensors laid out on `mesh` (whose world the caller started; the dry
    run's is the fake backend's): a train cell's state by
    `state_shardings` and its batch by `batch_shardings`; a prefill cell's
    params by `param_shardings` and its batch by `batch_shardings`; a
    decode cell's params, its cache by `cache_shardings` (int8 under the
    "int8kv" variant, which applies to decode cells of non-xLSTM configs
    only) and token and pos by ("batch",).  `donate_cache=False` makes
    the decode cell run on a copy of its cache."""
    model = build(cfg, META)
    strategy = pick_strategy(
        "train" if shape.kind == "train" else "serve", mesh,
        cfg.num_params(), override=strategy_override)
    kv_quant = (variant == "int8kv" and shape.kind == "decode"
                and cfg.block != "xlstm")
    specs = input_specs(cfg, shape)
    if kv_quant:
        specs = decode_specs(cfg, shape, kv_quant=True)
    if shape.kind == "train":
        step, _ = make_train_step(cfg, mesh, strategy, device=META)
        state = place_tree(state_specs(cfg),
                           state_shardings(cfg, mesh, strategy), mesh)
        args = (state, place_batch(cfg, specs["batch"], mesh, strategy))
    else:
        params = place_tree(model.param_specs(),
                            param_shardings(model, mesh, strategy), mesh)
        if shape.kind == "prefill":
            step = make_prefill_step(cfg, shape, mesh, strategy,
                                     device=META)
            args = (params, place_batch(cfg, specs["batch"], mesh,
                                        strategy))
        else:
            step = make_decode_step(cfg, mesh, strategy, kv_quant=kv_quant,
                                    device=META)
            cache = place_tree(specs["cache"], cache_shardings(
                model, specs["cache"], mesh, strategy, kv_quant=kv_quant),
                mesh)
            args = (params, cache,
                    place_rows(specs["token"], mesh, strategy),
                    place_rows(specs["pos"], mesh, strategy))
    cell = Cell(shape.kind, step, args, donate_cache)
    return cell, {"strategy": strategy.name, "variant": variant}
