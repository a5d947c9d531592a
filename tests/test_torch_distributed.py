"""The port's sharded train step and sequence-sharded decode combine on a
4-rank gloo world on the CPU, against the port's unsharded step and
JAX's own sharded step.

JAX's oracle runs once, in a subprocess with 8 host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8), on meshes with
Auto axes: jax 0.9's `jax.make_mesh` gives Explicit axes, which
`with_sharding_constraint` refuses (ROADMAP C2; the JAX tests stay as
they are).  It writes an npz: the reduced f32 OLMo's init params, its
fsdp and fsdp_tp steps on a (2, 2) mesh (loss and grad norm at steps 0
and 1, the params after them), `decode_attention_sharded` on a (4,)
mesh with tests/test_system.py's inputs, and `devices_indices_map` of a
few specs.  Then one world of 4 spawned ranks (a FileStore under
tmp_path, a timeout on init and on join) runs the port's side and each
rank writes what it saw; the tests below read those files.

Steps: 0 is at lr 0 (the warmup), so the params move at step 1.
"""
import datetime
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
BLOCK_CASES = [   # (mesh shape, axis names, spec, array shape)
    ((2, 2), ("data", "model"), ("data", "model"), (8, 6)),
    ((2, 2), ("data", "model"), (None, ("data", "model")), (3, 8)),
    ((2, 2), ("pod", "data"), (("pod", "data"), None, None), (8, 2, 3)),
    ((2, 2), ("data", "model"), ("model", None, "data"), (4, 3, 2)),
    ((4,), ("model",), (None, "model"), (2, 8)),
]

ORACLE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.launch.steps import make_train_step
from repro.distributed.sharding import train_strategy, train_strategy_fsdp
from repro.kernels import ops
from repro.training.data import SyntheticLM, DataConfig
from repro.training.optimizer import AdamWConfig
BLOCK_CASES = %r

def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(p.key) for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out

out = {}
auto = lambda n: (AxisType.Auto,) * n
devs = jax.devices()
cfg = ARCHS["olmo-1b"].reduced(dtype="f32", name="olmo-1b-reduced-f32")
data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
batches = [{k: jnp.asarray(v) for k, v in data.batch_at(t).items()}
           for t in range(2)]
oc = AdamWConfig(lr=1e-3, warmup_steps=1)
_, init1 = make_train_step(cfg, opt_cfg=oc)
out.update(flat(init1(jax.random.PRNGKey(0))["params"], "init/"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2),
                     devices=devs[:4])
for strat in (train_strategy_fsdp(mesh), train_strategy(mesh)):
    step, init = make_train_step(cfg, mesh, strat, oc)
    with mesh:
        state = init(jax.random.PRNGKey(0))
        for t in range(2):
            state, m = jax.jit(step)(state, batches[t])
            out[f"{strat.name}/loss{t}"] = np.asarray(m["loss"])
            out[f"{strat.name}/grad_norm{t}"] = np.asarray(m["grad_norm"])
    out.update(flat(state["params"], f"{strat.name}/params/"))
mesh4 = jax.make_mesh((4,), ("model",), axis_types=auto(1), devices=devs[:4])
rng = np.random.default_rng(1)
B, K, G, S, hd = 2, 4, 4, 512, 64
q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
kc = rng.standard_normal((B, K, S, hd)).astype(np.float32)
vc = rng.standard_normal((B, K, S, hd)).astype(np.float32)
pos = np.asarray([300, 450], np.int32)
fn = ops.decode_attention_sharded(mesh4, "model")
with mesh4:
    o = jax.jit(fn)(q, kc, vc, pos)
out.update({"decode/q": q, "decode/k": kc, "decode/v": vc,
            "decode/pos": pos, "decode/out": np.asarray(o)})
for i, (shape, names, spec, ashape) in enumerate(BLOCK_CASES):
    m = jax.make_mesh(shape, names, axis_types=auto(len(shape)),
                      devices=devs[:4])
    idx = NamedSharding(m, P(*spec)).devices_indices_map(ashape)
    coords = {d.id: c for c, d in np.ndenumerate(m.devices)}
    rows = np.zeros((4, len(ashape), 2), np.int64)
    for d, sl in idx.items():
        r = int(np.ravel_multi_index(coords[d.id], shape))
        for j, s in enumerate(sl):
            rows[r, j] = (s.start or 0, ashape[j] if s.stop is None
                          else s.stop)
    out[f"blocks/{i}"] = rows
np.savez(sys.argv[1], **out)
print("OK")
""" % (BLOCK_CASES,)


def run_oracle(path: Path) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ORACLE),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def spawn_world(fn, tmp: Path, *args, world: int = WORLD) -> list:
    """fn(rank, store path, out dir, *args) on `world` spawned ranks; the
    ranks' pickled records, in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(str(tmp / "store"), str(tmp), *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = 240.0
    import time
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the world did not finish")
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def init_rank(rank: int, store: str, world: int = WORLD):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    return dist


class NoGatherUnderDTensor:
    """A dispatch mode that lets DTensor dispatch its own ops first
    (NotImplemented for a DTensor operand), so it sees the collectives
    DTensor's redistributions run on the local blocks, and raises on
    the functional all-gather and all-to-all: torch 2.11's crash on CUDA
    tensors over gloo (see `distributed.sharding`), which the port's
    sharded path must not reach.  DTensor's functional all-reduce (of a
    Partial loss, norm or mean) runs there and passes."""

    def __new__(cls):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                name = str(func)
                if "c10d_functional" in name and (
                        "all_gather" in name or "all_to_all" in name):
                    raise AssertionError(f"functional collective {name}")
                return func(*args, **(kwargs or {}))
        return Mode()


def _steps(cfg, mesh, strategy, state, batches, oc, detect=False):
    """Two steps of the unsharded (mesh None) or sharded step from
    `state` (plain tensors): [(loss, grad_norm)], the params after them
    (gathered), the helpers' counts."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.steps import (gather_tree, make_train_step,
                                          place_tree, state_shardings)
    step, _ = make_train_step(cfg, mesh, strategy, opt_cfg=oc,
                              device="cpu")
    if mesh is not None:
        state = place_tree(state, state_shardings(cfg, mesh, strategy), mesh)
    S.reset_counts()
    mets = []
    for b in batches:
        if detect:
            with NoGatherUnderDTensor():
                state, m = step(state, b)
        else:
            state, m = step(state, b)
        mets.append((float(m["loss"]), float(m["grad_norm"])))
    return mets, gather_tree(state["params"]), \
        {h: dict(c) for h, c in S.COUNTS.items()}


def _np_tree(params):
    from repro_torch.training.tree import items
    return {k: v.float().numpy() for k, v in items(params)}


def model_world(rank, store, out, oracle_path):
    """The steps (f32 against the oracle; bf16 against the unsharded
    step), the decode combine, the blocks."""
    dist = init_rank(rank, store)
    from repro_torch import params as params_lib
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    with np.load(oracle_path) as z:
        oracle = dict(z)
    rec = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    oc = AdamWConfig(lr=1e-3, warmup_steps=1)
    for dtype in ("f32", "bf16"):
        cfg = ARCHS["olmo-1b"].reduced(dtype=dtype,
                                       name=f"olmo-1b-reduced-{dtype}")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
        batches = [{k: torch.from_numpy(v) for k, v in
                    data.batch_at(t).items()} for t in range(2)]
        if dtype == "f32":
            tree = {}
            for k, v in oracle.items():
                if k.startswith("init/"):
                    node = tree
                    *path, leaf = k[len("init/"):].split("/")
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = v
            params = params_lib.from_jax(tree, cfg, "cpu")
        else:
            params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        rec[dtype] = {"unsharded": _steps(cfg, None, None, state, batches,
                                          oc)}
        for name in ("fsdp", "fsdp_tp"):
            res = _steps(cfg, mesh, S.STRATEGIES[name](mesh), state,
                         batches, oc, detect=True)
            rec[dtype][name] = (res[0], _np_tree(res[1]), res[2])
        un = rec[dtype]["unsharded"]
        rec[dtype]["unsharded"] = (un[0], _np_tree(un[1]), un[2])
    # the decode combine on a (4,) mesh, JAX's inputs
    line = make_mesh((WORLD,), ("model",), "cpu")
    q, kc, vc, pos = (torch.from_numpy(oracle[f"decode/{k}"])
                      for k in ("q", "k", "v", "pos"))
    fn = ops.decode_attention_sharded(line, "model")
    got = fn(q, kc, vc, pos)
    rec["decode"] = {"out": got.numpy(), "wire_bytes": fn.wire_bytes,
                     "kv_bytes": kc.numel() * kc.element_size(),
                     "ref": decode_attention_ref(q, kc, vc, pos).numpy()}
    # each rank's block against devices_indices_map at its coordinates
    from torch.distributed.device_mesh import init_device_mesh
    blocks = []
    for i, (shape, names, spec, ashape) in enumerate(BLOCK_CASES):
        m = init_device_mesh("cpu", shape, mesh_dim_names=names)
        full = torch.arange(int(np.prod(ashape))).reshape(ashape)
        dt = S.distribute(full, m, S.placements_for(S.P(*spec), m))
        want = oracle[f"blocks/{i}"][rank]
        sl = tuple(slice(a, b) for a, b in want)
        blocks.append(bool(torch.equal(dt.to_local(), full[sl])))
    rec["blocks"] = blocks
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    oracle = run_oracle(tmp / "oracle.npz")
    return oracle, spawn_world(model_world, tmp, str(tmp / "oracle.npz"))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("strategy", ["fsdp", "fsdp_tp"])
def test_sharded_step_matches_unsharded_and_jax(world, strategy):
    """f32 reduced OLMo on (2, 2): loss and grad norm at steps 0 and 1
    within 1e-5 relative of the port's unsharded step and of JAX's
    sharded step; every param leaf within 1e-5 of both after them."""
    oracle, recs = world
    got, got_p, _ = recs[0]["f32"][strategy]
    un, un_p, _ = recs[0]["f32"]["unsharded"]
    for t in range(2):
        for j, key in enumerate(("loss", "grad_norm")):
            want = float(oracle[f"{strategy}/{key}{t}"])
            assert _rel(got[t][j], un[t][j]) <= 1e-5, (t, key)
            assert _rel(got[t][j], want) <= 1e-5, (t, key, got[t][j], want)
    for path, leaf in got_p.items():
        assert np.abs(leaf - un_p[path]).max() <= 1e-5, path
        jax_leaf = oracle[f"{strategy}/params/{path}"]
        assert np.abs(leaf - jax_leaf).max() <= 1e-5, path
    assert all(recs[r]["f32"][strategy][0] == got for r in range(WORLD))


def test_fsdp_tp_takes_the_collective_paths(world):
    """Under fsdp_tp every row- and column-parallel projection takes its
    reduce-scatter / all-gather path (none falls back); OLMo's seq
    gathers all find kv_heads on the model axis, so the gather helper
    returns k and v as they are (its collective path: the MoE test in
    test_torch_distributed_train.py).  Under fsdp (weights gathered
    whole) every helper falls back, as in JAX."""
    counts = world[1][0]["f32"]["fsdp_tp"][2]
    assert counts["row"]["collective"] > 0 and counts["row"]["fallback"] == 0
    assert counts["col"]["collective"] > 0 and counts["col"]["fallback"] == 0
    assert counts["gather"] == {"collective": 0,
                                "fallback": counts["gather"]["fallback"]}
    fsdp = world[1][0]["f32"]["fsdp"][2]
    assert all(c["collective"] == 0 and c["fallback"] > 0
               for c in fsdp.values())


@pytest.mark.parametrize("strategy", ["fsdp", "fsdp_tp"])
def test_bf16_sharded_step_within_jax_bounds(world, strategy):
    """The bf16 reduced OLMo: JAX's own bounds (tests/test_system.py:92,
    :98, :179, :181): loss within 5e-3, grad norm within 2e-2 relative,
    params within 5e-2."""
    got, got_p, _ = world[1][0]["bf16"][strategy]
    un, un_p, _ = world[1][0]["bf16"]["unsharded"]
    for t in range(2):
        assert abs(got[t][0] - un[t][0]) < 5e-3
        assert _rel(got[t][1], un[t][1]) < 2e-2
    for path, leaf in got_p.items():
        assert np.abs(leaf - un_p[path]).max() < 5e-2, path


def test_decode_attention_sharded(world):
    """JAX's inputs (tests/test_system.py:128-134): the port's combine on
    4 ranks within 1e-5 of JAX's on a 4-device mesh and of
    decode_attention_ref, its wire bytes under 0.1 x the KV bytes, the
    result alike on every rank."""
    oracle, recs = world
    d = recs[0]["decode"]
    assert np.abs(d["out"] - oracle["decode/out"]).max() < 1e-5
    assert np.abs(d["out"] - d["ref"]).max() < 1e-5
    assert 0 < d["wire_bytes"] < 0.1 * d["kv_bytes"]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(recs[r]["decode"]["out"], d["out"])


def test_local_blocks_match_devices_indices_map(world):
    """Each rank's block of a distributed tensor is the slice JAX's
    NamedSharding.devices_indices_map gives the device at the same mesh
    coordinates (nested ("pod", "data"), transposed specs, 1-D)."""
    for r in range(WORLD):
        assert world[1][r]["blocks"] == [True] * len(BLOCK_CASES)


def test_no_functional_all_gather_on_olmo(world):
    """The f32 steps above ran under a dispatch mode that raises on the
    functional all-gather / all-to-all (the collectives torch 2.11
    crashes on over gloo with CUDA tensors): they finished, so the
    sharded OLMo step needs none.  (Every f32 step ran: see the records'
    two steps a strategy.)"""
    for strategy in ("fsdp", "fsdp_tp"):
        assert len(world[1][0]["f32"][strategy][0]) == 2
