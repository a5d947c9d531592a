"""The port's sharded MoE train step on a 3-D ("pod", "data", "model")
mesh of 8 gloo ranks on the CPU, against the port's unsharded step and
JAX's sharded step.

The mesh is (2, 2, 2) and the batch 4 x 32: 4 rows divide ("pod",
"data") but not all 8 ranks, so under fsdp the batch takes ("pod",
"data") and the expert buffer's embed lands on "model", the condition of
the 2 x 16 x 16 mesh at batch 256.  The cases: reduced granite with 3
experts and 3 query heads over 1 kv head (neither divides "model": the
expert products take the Partial route under fsdp, and the training
attention splits its queries over "model"), under fsdp and fsdp_tp; and
reduced mixtral (4 experts, which "model" divides, so fsdp_tp lays the
expert buffer's experts over "model" while wi takes F there, window 16)
under fsdp_tp.

The parent process draws each case's init params from a torch seed and
writes them to an npz; JAX's sharded step-0 loss on the same params runs
in a subprocess with 8 host devices on an Auto-axis mesh (ROADMAP C2)
while the 8 spawned ranks run the port's sharded steps 0 and 1 under
guards that raise on a functional all-gather or all-to-all (also inside
DTensor's own ops) and on DTensor's own einsum; the unsharded steps run
once, in the test process, after them.  Steps: 0 is at lr 0 (the
warmup), so the params move at step 1.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import (NoGatherUnderDTensor, _np_tree, _rel,
                                    _steps, init_rank, spawn_world)

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
CASES = (("granite", "fsdp"), ("granite", "fsdp_tp"), ("mixtral", "fsdp_tp"))

ORACLE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.configs.base import MoEConfig
from repro.distributed.sharding import STRATEGIES
from repro.launch.steps import make_train_step
from repro.training.data import DataConfig, SyntheticLM
from repro.training.optimizer import AdamWConfig, adamw_init
MESH, CASES = %r

CONFIGS = {
    "granite": ARCHS["granite-moe-3b-a800m"].reduced(
        dtype="f32", name="granite-e3-f32", n_heads=3, n_kv_heads=1,
        moe=MoEConfig(num_experts=3, top_k=2)),
    "mixtral": ARCHS["mixtral-8x22b"].reduced(dtype="f32",
                                              name="mixtral-f32"),
}
with np.load(sys.argv[1]) as z:
    flat = dict(z)
mesh = jax.make_mesh(*MESH, axis_types=(AxisType.Auto,) * 3,
                     devices=jax.devices()[:8])
out = {}
for case, strat in CASES:
    cfg = CONFIGS[case]
    params = {}
    for k, v in flat.items():
        if k.startswith(case + "/"):
            node = params
            *path, leaf = k[len(case) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
    batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    step, _ = make_train_step(cfg, mesh, STRATEGIES[strat](mesh),
                              AdamWConfig(lr=1e-3, warmup_steps=1))
    state = {"params": params, "opt": adamw_init(params),
             "step": jnp.zeros((), jnp.int32)}
    with mesh:
        _, m = jax.jit(step)(state, batch)
    out[f"{case}/{strat}/loss0"] = np.asarray(m["loss"])
np.savez(sys.argv[2], **out)
print("OK")
""" % ((MESH, CASES),)


def _configs():
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import MoEConfig
    return {
        "granite": ARCHS["granite-moe-3b-a800m"].reduced(
            dtype="f32", name="granite-e3-f32", n_heads=3, n_kv_heads=1,
            moe=MoEConfig(num_experts=3, top_k=2)),
        "mixtral": ARCHS["mixtral-8x22b"].reduced(dtype="f32",
                                                  name="mixtral-f32"),
    }


class NoDTensorEinsum:
    """torch.einsum raises on a DTensor operand inside it: DTensor's own
    einsum plans its moves itself, which the sharded MoE step must not
    reach (its products run on the local blocks)."""

    def __enter__(self):
        from repro_torch.distributed.sharding import is_dtensor
        self.orig = torch.einsum

        def einsum(eq, *ops):
            if any(is_dtensor(o) for o in ops):
                raise AssertionError(f"DTensor einsum {eq}")
            return self.orig(eq, *ops)
        torch.einsum = einsum
        return self

    def __exit__(self, *exc):
        torch.einsum = self.orig


def _case(case, flat):
    """(config, the train state at step 0 from the params in `flat`, the
    two batches) of one case."""
    from repro_torch import params as params_lib
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import adamw_init
    cfg = _configs()[case]
    tree = {}
    for k, v in flat.items():
        if k.startswith(case + "/"):
            node = tree
            *path, leaf = k[len(case) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    params = params_lib.from_jax(tree, cfg, "cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, batch=4))
    batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(t).items()}
               for t in range(2)]
    return cfg, {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}, batches


def moe_world(rank, store, out, params_path):
    """The sharded steps of every case on this rank (the unsharded ones
    run once, in the test process)."""
    dist = init_rank(rank, store, WORLD)
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.optimizer import AdamWConfig
    mesh = make_mesh(*MESH, "cpu")
    oc = AdamWConfig(lr=1e-3, warmup_steps=1)
    with np.load(params_path) as z:
        flat = dict(z)
    rec = {}
    for case, strat in CASES:
        cfg, state, batches = _case(case, flat)
        with NoDTensorEinsum(), NoGatherUnderDTensor():
            sh = _steps(cfg, mesh, S.STRATEGIES[strat](mesh), state, batches,
                        oc)
        rec[(case, strat)] = (sh[0], _np_tree(sh[1]), sh[2])
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX's step-0 losses, the ranks' records, the unsharded steps by
    case)."""
    from repro_torch.models import build
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.tree import items
    tmp = tmp_path_factory.mktemp("moe_mesh")
    flat = {}
    for case, cfg in _configs().items():
        params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
        flat.update({f"{case}/{k}": v.numpy() for k, v in items(params)})
    np.savez(tmp / "params.npz", **flat)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(ORACLE),
         str(tmp / "params.npz"), str(tmp / "oracle.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn_world(moe_world, tmp, str(tmp / "params.npz"),
                            world=WORLD)
        j_out, j_err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0 and "OK" in j_out, j_err[-3000:]
    unsharded = {}
    for case in _configs():
        cfg, state, batches = _case(case, flat)
        un = _steps(cfg, None, None, state, batches,
                    AdamWConfig(lr=1e-3, warmup_steps=1))
        unsharded[case] = (un[0], _np_tree(un[1]))
    with np.load(tmp / "oracle.npz") as z:
        return dict(z), ranks, unsharded


@pytest.mark.parametrize("case,strategy", CASES)
def test_sharded_moe_step_matches_unsharded(world, case, strategy):
    """Loss and grad norm at steps 0 and 1 within 1e-5 relative of the
    unsharded step, every param leaf within 1e-5 after them, alike on
    all 8 ranks; run under the guards that raise on a functional
    all-gather or all-to-all, DTensor's included, and on DTensor's own
    einsum."""
    recs = world[1]
    got, got_p, _ = recs[0][(case, strategy)]
    un, un_p = world[2][case]
    for t in range(2):
        for j, key in enumerate(("loss", "grad_norm")):
            assert _rel(got[t][j], un[t][j]) <= 1e-5, (t, key, got, un)
    assert set(got_p) == set(un_p)
    for path, leaf in got_p.items():
        assert np.abs(leaf - un_p[path]).max() <= 1e-5, path
    for r in range(1, WORLD):
        assert recs[r][(case, strategy)][0] == got


@pytest.mark.parametrize("case,strategy", CASES)
def test_sharded_moe_loss_matches_jax(world, case, strategy):
    """Step 0's loss within 1e-5 relative of JAX's sharded step on the
    same params, batch and (2, 2, 2) mesh."""
    oracle, recs, _ = world
    want = float(oracle[f"{case}/{strategy}/loss0"])
    got = recs[0][(case, strategy)][0][0][0]
    assert _rel(got, want) <= 1e-5, (got, want)


def test_moe_row_parallel_path_and_fallbacks(world):
    """Under fsdp_tp the MoE down-projection and the attention's
    out-projection take the row-parallel reduce-scatter where the heads
    and F divide "model" (mixtral); under fsdp (weights gathered whole)
    every row- and column-parallel projection falls back, as in JAX, to
    the sharder's einsum on the local blocks."""
    mixtral = world[1][0][("mixtral", "fsdp_tp")][2]
    assert mixtral["row"]["collective"] > 0
    fsdp = world[1][0][("granite", "fsdp")][2]
    for helper in ("row", "col"):
        assert fsdp[helper]["collective"] == 0
        assert fsdp[helper]["fallback"] > 0

