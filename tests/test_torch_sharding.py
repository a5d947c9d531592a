"""The port's logical-axis resolver (`repro_torch.distributed.sharding`)
against JAX's (`repro.distributed.sharding`), in process: the four
resolver tests of tests/test_sharding_roofline.py, the param and cache
axes trees of every ARCHS config, every param, cache and batch leaf's
spec under the four strategies on five fake meshes, `pick_strategy`,
and the PartitionSpec -> DTensor placements rule (blocks on a fake mesh
coordinate; the real 4-rank worlds are in test_torch_distributed.py)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.distributed import sharding as jsh
from repro.launch import steps as jax_steps
from repro.models import build as jax_build
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps
from repro_torch.models import build

META = torch.device("meta")


class FakeMesh:
    """Duck-typed mesh for resolver tests (axis_names + device grid)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "4": ((4,), ("model",)),
}
STRATEGIES = ("fsdp_tp", "fsdp", "serve", "train_compute")


def _strategy(mod, name, mesh):
    if name == "train_compute":
        return mod.train_compute_strategy(mesh)
    return mod.STRATEGIES[name](mesh)


def _strategy_port():
    return tsh.train_strategy(FakeMesh((16, 16), ("data", "model")))


# ----------------- tests/test_sharding_roofline.py:23-72 ----------------- #
def test_spec_divisible():
    s = _strategy_port()
    mesh = FakeMesh((16, 16), ("data", "model"))
    spec = s.spec_for(("embed", "heads", "head_dim"), (2048, 32, 128), mesh)
    assert spec == jax.sharding.PartitionSpec("data", "model")
    assert spec == tsh.P("data", "model")


def test_spec_fallback_on_indivisible():
    s = _strategy_port()
    mesh = FakeMesh((16, 16), ("data", "model"))
    # kv_heads = 5 not divisible by 16 -> unsharded
    spec = s.spec_for(("embed", "kv_heads", "head_dim"), (1600, 5, 64), mesh)
    assert spec == jax.sharding.PartitionSpec("data")


def test_spec_axis_used_once():
    s = _strategy_port()
    mesh = FakeMesh((16, 16), ("data", "model"))
    # both seq and heads want "model": priority gives it to heads
    spec = s.spec_for(("batch", "seq", "heads", "head_dim"),
                      (256, 4096, 64, 128), mesh)
    assert list(spec).count("model") <= 1


def test_serve_strategy_kv_fallback():
    mesh = FakeMesh((16, 16), ("data", "model"))
    s = tsh.serve_strategy(mesh)
    # kv_heads=8 fails 16 -> seq_kv gets the model axis
    spec = s.spec_for(("layers", "batch", "seq_kv", "kv_heads",
                       "head_dim"), (80, 128, 32768, 8, 128), mesh)
    assert spec == jax.sharding.PartitionSpec(None, "data", "model")
    # kv_heads=32 divides -> heads win
    spec2 = s.spec_for(("layers", "batch", "seq_kv", "kv_heads",
                        "head_dim"), (30, 128, 32768, 32, 128), mesh)
    assert spec2[3] == "model"


# --------------------------- the axes trees --------------------------- #
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_axes_trees_equal_jax(name):
    """param_axes and cache_axes (kv_quant on and off): the same tuples,
    key for key; and the param tree's keys are the port's params'."""
    pm, jm = build(ARCHS[name], META), jax_build(JAX_ARCHS[name])
    assert pm.param_axes() == jm.param_axes()
    for kv_quant in (False, True):
        assert pm.cache_axes(kv_quant) == jm.cache_axes(kv_quant=kv_quant)
    shapes = tsh.map_axes(lambda ax, t: len(ax) == t.dim(),
                          pm.param_axes(), pm.param_specs())
    assert all(_leaves(shapes))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ------------------ every leaf's spec on five meshes ------------------ #
def _outcome(fn):
    """A spec as a tuple, or the exception's type name (JAX's resolver
    raises KeyError on a rule naming an axis the mesh lacks)."""
    try:
        return ("spec", tuple(fn()))
    except Exception as e:          # noqa: BLE001 - compared across both
        return ("raise", type(e).__name__)


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    """(param, cache (kv_quant off / on) and batch shapes) of JAX's model:
    nested dicts of shape tuples."""
    cfg, model = JAX_ARCHS[name], jax_build(JAX_ARCHS[name])
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    shape = dataclasses.replace(JAX_SHAPES["decode_32k"], seq_len=4096)
    caches = [jax_steps.decode_specs(cfg, shape, kv_quant=q)["cache"]
              for q in (False, True)]
    batch = jax_steps.batch_specs(cfg, JAX_SHAPES["train_4k"])
    return jax.tree.map(lambda s: tuple(s.shape),
                        (params, caches[0], caches[1], batch))


def _port_shapes(name):
    cfg = ARCHS[name]
    model = build(cfg, META)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=4096)
    caches = [steps.decode_specs(cfg, shape, kv_quant=q)["cache"]
              for q in (False, True)]
    batch = steps.batch_specs(cfg, SHAPES["train_4k"])
    return model.param_specs(), caches[0], caches[1], batch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_leaf_spec_equals_jax(name, mesh_name):
    """Every param, cache (kv_quant off and on) and batch leaf, under
    fsdp_tp, fsdp, serve and train_compute: the port's spec equals JAX's
    spec_for on the same fake mesh (or both raise the same error)."""
    mesh = FakeMesh(*MESHES[mesh_name])
    pm = build(ARCHS[name], META)
    jshapes = _jax_shapes(name)
    pshapes = _port_shapes(name)
    trees = [(pm.param_axes(), jshapes[0], pshapes[0]),
             (pm.cache_axes(False), jshapes[1], pshapes[1]),
             (pm.cache_axes(True), jshapes[2], pshapes[2]),
             ({k: steps.BATCH_AXES[k] for k in pshapes[3]}, jshapes[3],
              pshapes[3])]
    assert steps.BATCH_AXES == jax_steps.BATCH_AXES
    n = 0
    for strat in STRATEGIES:
        jstrat = _strategy(jsh, strat, mesh)
        pstrat = _strategy(tsh, strat, mesh)
        assert (pstrat.rules, pstrat.priority, pstrat.name) == \
            (jstrat.rules, jstrat.priority, jstrat.name)
        for axes, jtree, ptree in trees:
            def check(ax, jshape, pt):
                assert tuple(pt.shape) == jshape, ax
                got = _outcome(lambda: pstrat.spec_for(ax, pt.shape, mesh))
                want = _outcome(lambda: jstrat.spec_for(ax, jshape, mesh))
                assert got == want, (strat, ax, jshape)
                return 1
            n += sum(_leaves(tsh.map_axes(check, axes, jtree, ptree)))
    assert n > 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_pick_strategy_equals_jax(name):
    n_params = ARCHS[name].num_params()
    assert n_params == JAX_ARCHS[name].num_params()
    for mesh_name in ("16x16", "2x16x16", "2x4"):
        mesh = FakeMesh(*MESHES[mesh_name])
        for kind in ("train", "prefill", "decode"):
            for override in ("", "fsdp", "fsdp_tp", "serve"):
                got = tsh.pick_strategy(kind, mesh, n_params, override)
                want = jsh.pick_strategy(kind, mesh, n_params, override)
                assert (got.name, got.rules, got.priority) == \
                    (want.name, want.rules, want.priority)


# ---------------------- specs -> DTensor placements ---------------------- #
class CoordMesh:
    """A DeviceMesh stand-in at one coordinate (local_block reads
    mesh_dim_names, shape, size(i) and get_coordinate())."""
    def __init__(self, shape, names, coord):
        self.mesh_dim_names, self.shape, self._coord = names, shape, coord

    def size(self, i):
        return self.shape[i]

    def get_coordinate(self):
        return list(self._coord)


def test_placements_and_blocks():
    """A dim over ("pod", "data") is Shard(d) on both mesh dims, major
    axis first; the block at coordinates (i, j, k) is JAX's row-major
    device block: index i * n_data + j along that dim."""
    from torch.distributed.tensor import Replicate, Shard
    shape, names = (2, 4, 2), ("pod", "data", "model")
    mesh = CoordMesh(shape, names, (0, 0, 0))
    spec = tsh.P(("pod", "data"), None, "model")
    pl = tsh.placements_for(spec, mesh)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements_for(tsh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements_for(tsh.P(("data", "pod")), mesh)
    full = torch.arange(16 * 3 * 4).reshape(16, 3, 4)
    for i in range(2):
        for j in range(4):
            for k in range(2):
                got = tsh.local_block(full, CoordMesh(shape, names,
                                                      (i, j, k)), pl)
                r = (i * 4 + j) * 2
                assert torch.equal(got, full[r:r + 2, :, k * 2:k * 2 + 2])


def test_mesh_functions():
    """launch.mesh: importing it starts nothing (tests/test_torch_imports.py);
    make_host_mesh and make_node_mesh(1) start a one-rank group when none
    exists; a larger mesh in a one-rank world, or the production meshes
    (256 / 512 ranks), raise; the default device is the card."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    host = mesh_lib.make_host_mesh("cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert host.mesh_dim_names == ("model",) and tuple(host.shape) == (1,)
    node = mesh_lib.make_node_mesh(1, "cpu")
    assert node.mesh_dim_names == ("model",)
    for call in (lambda: mesh_lib.make_node_mesh(2, "cpu"),
                 lambda: mesh_lib.make_production_mesh(device="cpu"),
                 lambda: mesh_lib.make_production_mesh(multi_pod=True,
                                                       device="cpu")):
        with pytest.raises(RuntimeError, match="ranks"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            mesh_lib.make_host_mesh()
