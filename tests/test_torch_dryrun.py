"""The port's dry run (`launch.steps.lower_cell`, `launch.dryrun`) against
JAX's.

`lower_cell` needs a world of the mesh's size: a subprocess starts the
fake backend's (`launch.mesh.start_fake_world`; this test process keeps
whatever group other tests started) and writes, for every ARCHS config
on the five fake meshes of tests/test_torch_sharding.py, each cell's
strategy name and the spec of every input leaf (read back from its
DTensor placements), and the logits' spec of a few decode cells it runs.
JAX's side is the trees JAX's `lower_cell` passes to `jax.jit`
(`param_shardings`, `state_shardings`, `batch_shardings`,
`cache_shardings`, the logits' `sharding_for`), built with JAX's own
resolver on the same fake meshes, as test_torch_sharding.py does: JAX
cannot lower on 512 host devices in this process.  The CLI runs one
multi-pod cell as tests/test_system.py::test_dryrun_cell_multipod does;
that test is red here (ROADMAP C2: jax.make_mesh's Explicit axes), so
JAX's own dry run of the cell runs in a subprocess with 512 host devices
on a production mesh built with Auto axes, and its compiled memory
analysis is the oracle of the port's per-rank bytes.
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.distributed import sharding as jsh
from repro.launch import steps as jax_steps
from repro.models import build as jax_build
from repro_torch.configs import ARCHS

REPO = Path(__file__).resolve().parents[1]
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "4": ((4,), ("model",)),
}
# (shape, variant) of the cells lower_cell builds on every mesh
CELLS = (("train_4k", ""), ("prefill_32k", ""), ("decode_32k", ""),
         ("decode_32k", "int8kv"))
RUN = (("16x16", "olmo-1b"), ("2x16x16", "olmo-1b"),
       ("16x16", "phi4-mini-3.8b"), ("2x4", "xlstm-125m"))

PROBE = """
import json, sys
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed.sharding import axis_names, is_dtensor
from repro_torch.launch.mesh import make_mesh, start_fake_world
from repro_torch.launch.steps import lower_cell
from repro_torch.training.tree import items
MESHES, CELLS, RUN = %r, %r, %r

def spec(t, mesh):
    from torch.distributed.tensor import Shard
    parts = [[] for _ in range(t.dim())]
    for name, p in zip(axis_names(mesh), t.placements):
        if isinstance(p, Shard):
            parts[p.dim].append(name)
    out = [None if not g else g[0] if len(g) == 1 else g for g in parts]
    while out and out[-1] is None:
        out.pop()
    return out

out = {}
for mname, (shape, names) in MESHES.items():
    start_fake_world(int(__import__("math").prod(shape)))
    mesh = make_mesh(shape, names, "cpu")
    for arch in ARCHS:
        for sname, variant in CELLS:
            key = "|".join((mname, arch, sname, variant))
            try:
                cell, info = lower_cell(ARCHS[arch], SHAPES[sname], mesh,
                                        variant=variant)
            except Exception as e:
                out[key] = {"raise": type(e).__name__}
                continue
            rec = {"strategy": info["strategy"], "variant": info["variant"],
                   "specs": {}}
            for i, a in enumerate(cell.args):
                tree = a if isinstance(a, dict) else {"": a}
                for path, leaf in items(tree):
                    assert is_dtensor(leaf), path
                    rec["specs"][f"{i}/{path}"] = spec(leaf, mesh)
            if (mname, arch) in [tuple(r) for r in RUN] and \\
                    sname == "decode_32k" and not variant:
                logits = cell.run()[0]
                rec["logits"] = spec(logits, mesh)
            out[key] = rec
json.dump(out, open(sys.argv[1], "w"))
print("OK")
""" % (MESHES, CELLS, RUN)


class FakeMesh:
    """Duck-typed mesh for JAX's resolver (axis_names + device grid)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    r = subprocess.run([sys.executable, "-c", PROBE, str(path)],
                       capture_output=True, text=True, env=_env(),
                       timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return json.loads(path.read_text())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _map_axes(fn, axes, tree):
    """fn(axes, leaf) over a tree of logical-axes tuples and a matching
    tree of JAX's shapes (nested dicts)."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], tree[k]) for k in axes}
    return fn(axes, tree)


def _jspec(fn):
    spec = fn()
    return [None if p is None else p if isinstance(p, str) else list(p)
            for p in spec]


@functools.lru_cache(maxsize=None)
def _jax_trees(mname, arch, sname, variant):
    """JAX's lower_cell trees for one cell on a fake mesh, as
    {"0/<path>": spec, ...} (the in_shardings' order) and the logits'
    spec; or {"raise": name} where JAX's resolver raises."""
    mesh = FakeMesh(*MESHES[mname])
    cfg, shape = JAX_ARCHS[arch], JAX_SHAPES[sname]
    model = jax_build(cfg)
    try:
        strat = jsh.pick_strategy(
            "train" if shape.kind == "train" else "serve", mesh,
            cfg.num_params())
        kv_quant = (variant == "int8kv" and shape.kind == "decode"
                    and cfg.block != "xlstm")
        specs = jax_steps.input_specs(cfg, shape)
        if kv_quant:
            specs = jax_steps.decode_specs(cfg, shape, kv_quant=True)

        def tree(axes, shapes):
            return _map_axes(lambda ax, s: _jspec(
                lambda: strat.spec_for(ax, s.shape, mesh)), axes, shapes)
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        batch_axes = {k: jax_steps.BATCH_AXES[k] for k in specs.get(
            "batch", {})}
        if shape.kind == "train":
            p = tree(model.param_axes(), params)
            args = [{"params": p, "opt": {"m": p, "v": p}, "step": []},
                    tree(batch_axes, specs["batch"])]
        elif shape.kind == "prefill":
            args = [tree(model.param_axes(), params),
                    tree(batch_axes, specs["batch"])]
        else:
            vec = _jspec(lambda: strat.spec_for(("batch",), (shape.batch,),
                                                mesh))
            args = [tree(model.param_axes(), params),
                    tree(model.cache_axes(kv_quant=kv_quant),
                         specs["cache"]), vec, vec]
        out = {"strategy": strat.name, "specs": {}}
        for i, a in enumerate(args):
            for path, spec in _flat(a if isinstance(a, dict)
                                    else {"": a}).items():
                out["specs"][f"{i}/{path}"] = spec
        out["logits"] = _jspec(lambda: strat.spec_for(
            ("batch", "vocab"), (shape.batch, cfg.vocab), mesh))
        return out
    except Exception as e:              # noqa: BLE001 - compared across both
        return {"raise": type(e).__name__}


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_lower_cell_layouts_equal_jax(cells, mname):
    """Every ARCHS config's train, prefill, decode and int8kv decode cell
    on the mesh: the strategy name and every input leaf's layout (params
    or train state, cache, batch, token and pos) equal JAX's lower_cell
    trees; where JAX's resolver raises (a rule naming an axis the mesh
    lacks), the port's lower_cell raises the same error."""
    n = 0
    for arch in sorted(ARCHS):
        for sname, variant in CELLS:
            got = cells["|".join((mname, arch, sname, variant))]
            want = _jax_trees(mname, arch, sname, variant)
            if "raise" in want:
                assert got == want, (arch, sname)
                continue
            assert got["strategy"] == want["strategy"], (arch, sname)
            assert got["variant"] == variant
            assert got["specs"] == want["specs"], (arch, sname, variant)
            if "logits" in got:
                assert got["logits"] == want["logits"], (arch, sname)
                n += 1
    assert n == sum(m == mname for m, _ in RUN)


def test_int8kv_applies_to_decode_of_non_xlstm_only(cells):
    """The int8kv variant gives an int8 cache (scales beside K and V) to
    a decode cell of a transformer config, and none to xLSTM's."""
    olmo = cells["16x16|olmo-1b|decode_32k|int8kv"]["specs"]
    assert "1/k_scale" in olmo and "1/v_scale" in olmo
    xl = cells["16x16|xlstm-125m|decode_32k|int8kv"]["specs"]
    assert not any("scale" in k for k in xl)


def _local_bytes(shape, dtype, spec, sizes):
    n = 1
    for d, dim in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        group = () if part is None else (part,) if isinstance(part, str) \
            else tuple(part)
        n *= dim // math.prod(sizes[a] for a in group)
    return n * jnp.dtype(dtype).itemsize


JAX_CELL = """
import json, sys
import jax
from jax.sharding import AxisType
import repro.launch.mesh as mesh_lib
from repro.launch.dryrun import run_cell

def auto_mesh(multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

mesh_lib.make_production_mesh = auto_mesh
json.dump(run_cell("olmo-1b", "decode_32k", "multi"), open(sys.argv[1], "w"))
print("OK")
"""


def test_dryrun_cli_multipod(tmp_path):
    """`python -m repro_torch.launch.dryrun --arch olmo-1b --shape
    decode_32k,long_500k --mesh multi` on the CPU: the decode cell [ok]
    on a 512-rank fake world with JAX's record keys (build_s / trace_s
    for lower_s / compile_s), its per-rank argument bytes the sum of the
    local blocks of the params, the cache and token and pos under JAX's
    serve specs; the long_500k cell of a full-attention arch skipped
    with JAX's reason; exit 0."""
    # JAX's own dry run of the cell, beside the port's: its production
    # mesh built with Auto axes (ROADMAP C2: with jax.make_mesh's Explicit
    # axes JAX's lower_cell stops at with_sharding_constraint)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_CELL,
                                str(tmp_path / "jax.json")],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "olmo-1b", "--shape", "decode_32k,long_500k", "--mesh",
             "multi", "--out", str(tmp_path)], capture_output=True,
            text=True, env=_env(), timeout=300, cwd=tmp_path)
        j_out, j_err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ok]   olmo-1b__decode_32k__multi" in r.stdout
    assert "[skip] olmo-1b__long_500k__multi" in r.stdout
    assert "done; 0 failures" in r.stdout
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__multi.json")
                     .read_text())
    assert set(rec) == {"arch", "shape", "mesh", "strategy", "variant",
                        "status", "chips", "build_s", "trace_s", "memory",
                        "roofline", "dominant", "roofline_fraction"}
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["strategy"] == "serve"
    assert set(rec["roofline"]) == {
        "flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
        "coll_breakdown", "chips", "kernel_bytes_per_chip",
        "kernel_coll_bytes_per_chip", "compute_s", "memory_s",
        "collective_s", "memory_adj_s", "collective_adj_s", "dominant",
        "model_flops", "useful_ratio"}
    assert rec["roofline"]["flops_per_chip"] > 0
    assert rec["roofline"]["coll_breakdown"].get("all-reduce", 0) > 0
    # the argument bytes from JAX's specs on the same mesh
    mesh = FakeMesh(*MESHES["2x16x16"])
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    cfg, shape = JAX_ARCHS["olmo-1b"], JAX_SHAPES["decode_32k"]
    model = jax_build(cfg)
    strat = jsh.serve_strategy(mesh)
    specs = jax_steps.decode_specs(cfg, shape)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    want = 0
    for axes, tree in ((model.param_axes(), params),
                       (model.cache_axes(), specs["cache"]),
                       (("batch",), specs["token"]),
                       (("batch",), specs["pos"])):
        for spec_shape in _flat(_map_axes(
                lambda ax, s: (s.shape, s.dtype,
                               tuple(strat.spec_for(ax, s.shape, mesh))),
                axes, tree) if isinstance(axes, dict) else
                {"": (tree.shape, tree.dtype,
                      tuple(strat.spec_for(axes, tree.shape, mesh)))}
                ).values():
            want += _local_bytes(*spec_shape, sizes)
    assert rec["memory"]["argument_size_in_bytes"] == want
    # JAX's compiled memory analysis gives the same argument and aliased
    # (donated cache) bytes
    assert jax_run.returncode == 0 and "OK" in j_out, j_err[-3000:]
    jrec = json.loads((tmp_path / "jax.json").read_text())
    assert jrec["status"] == "ok" and jrec["strategy"] == rec["strategy"]
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert rec["memory"][key] == jrec["memory"][key], key
    # the same all-reduces, but XLA's CPU compiler promotes JAX's bf16
    # all-reduces to f32 (ROADMAP C2), so they move twice the port's bytes
    assert jrec["roofline"]["coll_breakdown"]["all-reduce"] == \
        2 * rec["roofline"]["coll_breakdown"]["all-reduce"]
    skip = json.loads((tmp_path / "olmo-1b__long_500k__multi.json")
                      .read_text())
    assert skip["status"] == "skipped"
    from repro.configs import runnable
    assert skip["reason"] == runnable(cfg, JAX_SHAPES["long_500k"])[1]
