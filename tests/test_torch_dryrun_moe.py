"""The multi-pod MoE train cells of the port's dry run (ROADMAP C21), and
`sharding.redistribute`'s refusal of what it cannot move, on fake worlds.

Two subprocesses (`launch.mesh.start_fake_world` needs a process of its
own) run `launch.dryrun.run_cell` for granite-moe-3b-a800m and
mixtral-8x22b `train_4k` on the 2 x 16 x 16 ("pod", "data", "model")
mesh and on the 16 x 16 one, side by side.  Each multi-pod cell comes
back ok with the strategy JAX picks; its per-rank argument bytes are the
local blocks of the train state and the batch under JAX's resolver specs
(`tests/test_torch_dryrun.py`'s bookkeeping); its per-rank dot FLOPs are
at most 0.6 x the single-pod cell's (the same global batch on twice the
ranks: 0.5 x where every product splits), and the single-pod counts are
no higher than the step's before the fix of ROADMAP C21 (granite
4.645e13, mixtral 3.377e15 FLOPs a rank on 16 x 16).

A third subprocess holds `redistribute` on a 16-rank fake world: a
DTensor of global dim 40 sharded over the 16 ranks (blocks of 3 and
less) and a strided shard raise ValueError naming the shape and the
placements before any collective; an even one (32) gathers.
"""
import json
import subprocess
import sys

import jax
import pytest

from repro.configs import ARCHS as JAX_ARCHS, SHAPES as JAX_SHAPES
from repro.distributed import sharding as jsh
from repro.launch import steps as jax_steps
from repro.models import build as jax_build
from test_torch_dryrun import MESHES, FakeMesh, _env, _flat, _local_bytes, \
    _map_axes

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")
# JAX's pick for each (train_4k, multi-pod), and the single-pod FLOPs a
# rank of the step before the fix of ROADMAP C21 (the dry run on a CPU)
STRATEGY = {"granite-moe-3b-a800m": "fsdp", "mixtral-8x22b": "fsdp_tp"}
SINGLE_FLOPS = {"granite-moe-3b-a800m": 4.645e13, "mixtral-8x22b": 3.377e15}

CELLS = """
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {m: run_cell(sys.argv[2], "train_4k", m) for m in ("single", "multi")}
json.dump(out, open(sys.argv[1], "w"))
print("OK")
"""

REDISTRIBUTE = """
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard
from repro_torch.distributed.sharding import (full_tensor,
                                              record_collectives,
                                              redistribute)
from repro_torch.launch.mesh import make_mesh, start_fake_world
start_fake_world(16)
mesh = make_mesh((16,), ("model",), "cpu")

def dt(rows, pl, block):
    return DTensor.from_local(torch.empty(block, 2, device="meta"), mesh,
                              (pl,), run_check=False,
                              shape=torch.Size((rows, 2)), stride=(2, 1))

for name, x in (("uneven", dt(40, Shard(0), 3)),
                ("strided", dt(32, _StridedShard(0, split_factor=2), 2))):
    with record_collectives() as rec:
        try:
            redistribute(x, (Replicate(),))
        except ValueError as e:
            msg = str(e)
            assert "(40, 2)" in msg if name == "uneven" else "(32, 2)" in msg
            assert "Shard" in msg, msg
            assert not rec, rec
            print(name, "raised:", msg)
        else:
            raise AssertionError(name + " moved")
with record_collectives() as rec:
    full = full_tensor(dt(32, Shard(0), 2))
assert tuple(full.shape) == (32, 2) and len(rec) == 1, (full.shape, rec)
assert rec[0].kind == "all-gather" and rec[0].group_size == 16
print("OK")
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_moe")
    procs = {arch: subprocess.Popen(
        [sys.executable, "-c", CELLS, str(tmp / f"{arch}.json"), arch],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for arch in ARCHS}
    try:
        for arch, p in procs.items():
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0 and "OK" in out, (arch, err[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return {arch: json.loads((tmp / f"{arch}.json").read_text())
            for arch in ARCHS}


def _jax_state_bytes(arch: str) -> int:
    """The per-rank bytes of the train state (params, AdamW m and v in
    f32, the int32 step) and the batch of the multi-pod train_4k cell
    under JAX's resolver on the 2 x 16 x 16 fake mesh."""
    mesh = FakeMesh(*MESHES["2x16x16"])
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    cfg, shape = JAX_ARCHS[arch], JAX_SHAPES["train_4k"]
    model = jax_build(cfg)
    strat = jsh.pick_strategy("train", mesh, cfg.num_params())
    assert strat.name == STRATEGY[arch]
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = jax_steps.input_specs(cfg, shape)["batch"]
    total = 4                                       # the step, replicated
    for axes, tree, dtypes in (
            (model.param_axes(), params, (None, "float32", "float32")),
            ({k: jax_steps.BATCH_AXES[k] for k in batch}, batch, (None,))):
        for s, dtype, spec in _flat(_map_axes(
                lambda ax, a: (a.shape, a.dtype,
                               tuple(strat.spec_for(ax, a.shape, mesh))),
                axes, tree)).values():
            total += sum(_local_bytes(s, dt or dtype, spec, sizes)
                         for dt in dtypes)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_multipod_moe_train_cell_ok(cells, arch):
    """The multi-pod cell is ok with JAX's strategy on 512 ranks, and its
    per-rank argument bytes are the train state's and the batch's local
    blocks under JAX's specs on the same mesh."""
    rec = cells[arch]["multi"]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    assert rec["strategy"] == STRATEGY[arch] and rec["chips"] == 512
    assert rec["memory"]["argument_size_in_bytes"] == _jax_state_bytes(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_multipod_moe_flops_split(cells, arch):
    """Per-rank dot FLOPs on 2 x 16 x 16 at most 0.6 x the 16 x 16 cell's
    from the same run (a product replicated over "model" would leave the
    expert products at 8 x their share); the single-pod cell no higher
    than before the fix."""
    single = cells[arch]["single"]
    multi = cells[arch]["multi"]
    assert single["status"] == "ok" and single["chips"] == 256
    f1 = single["roofline"]["flops_per_chip"]
    f2 = multi["roofline"]["flops_per_chip"]
    assert f2 <= 0.6 * f1, (f2, f1, f2 / f1)
    assert f1 <= SINGLE_FLOPS[arch] * (1 + 1e-3), f1


def test_redistribute_refuses_uneven_and_strided(tmp_path):
    """On a 16-rank fake world: a DTensor of global dim 40 sharded over
    the 16 ranks and a strided shard raise ValueError with the global
    shape and the placement, before any collective; an even shard (32)
    still gathers, in one all-gather over the 16 ranks."""
    r = subprocess.run([sys.executable, "-c", REDISTRIBUTE],
                       capture_output=True, text=True, env=_env(),
                       timeout=300, cwd=tmp_path)
    assert r.returncode == 0 and r.stdout.endswith("OK\n"), \
        r.stderr[-3000:]
    assert "uneven raised" in r.stdout and "strided raised" in r.stdout

