"""The port's sharded serving steps (`launch.steps.make_prefill_step` /
`make_decode_step` with a mesh) on a 4-rank gloo world on the CPU,
against the port's unsharded steps and JAX's own sharded steps.

One world of 4 spawned ranks (a FileStore under tmp_path, a timeout on
init and on join; the harness of tests/test_torch_distributed.py) runs,
on a (2, 2) ("data", "model") mesh under `pick_strategy("serve")`, a
sharded prefill of 4 rows and 8 greedy sharded decode steps beside the
unsharded steps on the same params and prompts, for reduced f32 configs:
OLMo (kv_heads over "model"), a K = 1 windowed decoder (gemma3-1b: the
cache's positions over "model", the window crossing them), OLMo's int8
KV cache, xLSTM, Hymba and the encoder-decoder (random frames, so the
cross-attention carries values).  Each rank writes the greedy tokens,
the worst logit difference, the kernels' calls a rank and the serve
layouts it saw.

JAX's oracle runs once, in a subprocess beside the world (its ranks take
the JAX case last, once the oracle's file is there), with 8 host devices
on a (2, 2) mesh with Auto axes (ROADMAP C2): its `make_prefill_step` /
`make_decode_step` jitted with JAX's in-shardings on reduced f32 OLMo
(JAX's init params, the port's prompts); the port's sharded steps run on
the same params.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distributed import WORLD, init_rank, spawn_world

REPO = Path(__file__).resolve().parents[1]
B, PROMPT, CACHE, STEPS = 4, 12, 32, 8
CASES = ("olmo", "windowed", "int8kv", "xlstm", "hymba", "encdec")

ORACLE = """
import os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS, ShapeSpec
from repro.distributed.sharding import pick_strategy
from repro.launch import steps
from repro.models import build
B, PROMPT, CACHE, STEPS = %r

def flat(tree, prefix):
    return {prefix + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

cfg = ARCHS["olmo-1b"].reduced(dtype="f32", name="olmo-1b-reduced-f32")
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
tokens = np.random.default_rng(0).integers(
    0, cfg.vocab, (B, PROMPT)).astype(np.int32)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
strat = pick_strategy("serve", mesh, cfg.num_params())
shape = ShapeSpec("oracle", "decode", CACHE, B)
with mesh:
    p_sh = steps.param_shardings(model, mesh, strat)
    b_sh = steps.batch_shardings(cfg, {"tokens": tokens}, mesh, strat)
    prefill = jax.jit(steps.make_prefill_step(cfg, shape, mesh, strat),
                      in_shardings=(p_sh, b_sh))
    logits, cache, pos = prefill(params, {"tokens": tokens})
    c_sh = steps.cache_shardings(model, cache, mesh, strat)
    tok_sh = strat.sharding_for(("batch",), (B,), mesh)
    decode = jax.jit(steps.make_decode_step(cfg, mesh, strat),
                     in_shardings=(p_sh, c_sh, tok_sh, tok_sh),
                     out_shardings=(strat.sharding_for(
                         ("batch", "vocab"), (B, cfg.vocab), mesh), c_sh),
                     donate_argnums=(1,))
    out = {"prefill": np.asarray(logits)}
    cache = jax.device_put(cache, c_sh)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for t in range(STEPS):
        pos = pos + 1
        tok, pos = (jax.device_put(x, tok_sh) for x in (tok, pos))
        logits, cache = decode(params, cache, tok, pos)
        out[f"decode{t}"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
out.update(flat(params, "init/"))
out["tokens"] = tokens
np.savez(sys.argv[1] + ".part.npz", **out)
os.replace(sys.argv[1] + ".part.npz", sys.argv[1])   # whole, or absent
print("OK")
""" % ((B, PROMPT, CACHE, STEPS),)


def start_oracle(path: Path) -> subprocess.Popen:
    """JAX's oracle, started in the background: it writes `path` whole
    when it is done (the world's ranks wait for it before the JAX case)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(ORACLE),
                             str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def wait_oracle(proc: subprocess.Popen, path: Path) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    with np.load(path) as z:
        return dict(z)


def _config(case):
    from repro_torch.configs import ARCHS, ZOO
    name = {"olmo": "olmo-1b", "windowed": "gemma3-1b", "int8kv": "olmo-1b",
            "xlstm": "xlstm-125m", "hymba": "hymba-1.5b",
            "encdec": "seamless-m4t-large-v2"}[case]
    return {**ZOO, **ARCHS}[name].reduced(dtype="f32")


def _greedy(prefill, decode, params, batch):
    """A prefill and STEPS greedy decode steps: (tokens (STEPS + 1, B),
    logits (STEPS + 1, B, V)), the logits gathered to full tensors, and
    the cache after them."""
    from repro_torch.distributed.sharding import full_tensor
    logits, cache, pos = prefill(params, batch)
    pos = full_tensor(pos)
    toks, outs = [], []
    for t in range(STEPS + 1):
        logits = full_tensor(logits)
        outs.append(logits.numpy())
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok.numpy())
        if t == STEPS:
            break
        pos = pos + 1
        logits, cache = decode(params, cache, tok, pos)
    return np.stack(toks), np.stack(outs), cache


class _Calls:
    """Counts the calls of the kernel wrappers the steps reach (the
    models call them through the `ops` module)."""

    def __init__(self, ops):
        self.ops, self.n, self.saved = ops, {}, {}

    def __enter__(self):
        for name in ("flash_attention", "decode_attention", "lse_combine"):
            fn = getattr(self.ops, name)
            self.saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] = self.n.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def serve_world(rank, store, out, oracle_path):
    import pickle
    dist = init_rank(rank, store)
    from repro_torch import params as params_lib
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    shape = ShapeSpec("serve", "decode", CACHE, B)
    rec = {}
    for case in CASES + ("jax",):
        cfg = _config("olmo" if case == "jax" else case)
        kv_quant = case == "int8kv"
        strat = S.pick_strategy("serve", mesh, cfg.num_params())
        model = build(cfg, "cpu")
        if case == "jax":
            deadline = time.monotonic() + 300
            while not Path(oracle_path).exists():   # JAX's, in the background
                assert time.monotonic() < deadline, "no oracle"
                time.sleep(0.2)
            with np.load(oracle_path) as z:
                oracle = dict(z)
            tree = {}
            for k, v in oracle.items():
                if k.startswith("init/"):
                    node = tree
                    *path, leaf = k[len("init/"):].split("/")
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = v
            params = params_lib.from_jax(tree, cfg, "cpu")
            tokens = torch.from_numpy(oracle["tokens"])
        else:
            params = model.init(torch.Generator().manual_seed(0))
            tokens = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, (B, PROMPT)).astype(np.int32))
        batch = {"tokens": tokens}
        if cfg.is_encdec:
            batch["src_embeds"] = torch.from_numpy(
                np.random.default_rng(2).standard_normal(
                    (B, 16, cfg.d_model)).astype(np.float32))
        plain = _greedy(steps.make_prefill_step(cfg, shape, kv_quant=kv_quant,
                                                device="cpu"),
                        steps.make_decode_step(cfg, kv_quant=kv_quant,
                                               device="cpu"),
                        params, batch)[:2]
        placed = steps.place_tree(
            params, steps.param_shardings(model, mesh, strat), mesh)
        prefill = steps.make_prefill_step(cfg, shape, mesh, strat,
                                          kv_quant=kv_quant)
        decode = steps.make_decode_step(cfg, mesh, strat, kv_quant=kv_quant)
        with _Calls(ops) as calls, S.record_collectives() as colls:
            *sharded, cache = _greedy(prefill, decode, placed, batch)
        rec[case] = {
            "plain": plain, "sharded": sharded, "calls": dict(calls.n),
            "strategy": strat.name,
            "cache": {k: (tuple(v.placements), tuple(v.to_local().shape))
                      for k, v in cache.items()},
            "collectives": sorted({c.kind for c in colls}),
        }
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    proc = start_oracle(tmp / "oracle.npz")
    try:
        ranks = spawn_world(serve_world, tmp, str(tmp / "oracle.npz"))
    finally:
        if proc.poll() is None and not (tmp / "oracle.npz").exists():
            proc.kill()
    return wait_oracle(proc, tmp / "oracle.npz"), ranks


# the int8 KV cache's decode logits: K/V computed in another summation
# order (1e-7 apart) can round to int8 one step apart where a value lies
# at a rounding boundary (1 entry of 32768 after this prefill), which
# moves a logit by ~1e-4; the prefill's logits read no quantized K/V
INT8KV_DECODE_TOL = 1e-3


@pytest.mark.parametrize("case", CASES)
def test_sharded_serving_equals_unsharded(world, case):
    """A sharded prefill and 8 greedy sharded decode steps: the same
    tokens as the unsharded steps, logits within 1e-5 (int8kv's decode
    logits within INT8KV_DECODE_TOL), on every rank."""
    for r in range(WORLD):
        (pt, pl), (st, sl) = (world[1][r][case][k]
                              for k in ("plain", "sharded"))
        assert np.array_equal(pt, st), (case, r, pt, st)
        assert np.abs(pl[0] - sl[0]).max() <= 1e-5, (case, r)
        tol = INT8KV_DECODE_TOL if case == "int8kv" else 1e-5
        assert np.abs(pl[1:] - sl[1:]).max() <= tol, (case, r)


def test_sharded_serving_layouts_and_kernels(world):
    """The serve strategy, the cache's layouts and the kernels a rank
    reaches: with kv heads over "model" the flash kernel runs once a
    layer in the prefill and the decode kernel once a layer a step, on
    each rank's (rows, kv heads) block; with K = 1 the cache's positions
    split over "model" and every decode step's attention merges the
    blocks (`lse_combine`), whose all-reduces are recorded."""
    from torch.distributed.tensor import Shard
    rec = world[1][0]
    n_layers = _config("olmo").n_layers
    for case in ("olmo", "int8kv"):
        assert rec[case]["strategy"] == "serve"
        pl, local = rec[case]["cache"]["k"]
        assert pl == (Shard(1), Shard(3)), pl
        assert local[1] == B // 2 and local[3] == _config(case).n_kv_heads // 2
        # the greedy run, then the prefill that reads the cache's layout
        assert rec[case]["calls"]["flash_attention"] == n_layers
        assert rec[case]["calls"]["decode_attention"] == n_layers * STEPS
        assert "lse_combine" not in rec[case]["calls"]
    pl, local = rec["int8kv"]["cache"]["k_scale"]
    assert pl == (Shard(1), Shard(3))
    w = rec["windowed"]
    assert w["cache"]["k"][0] == (Shard(1), Shard(2))
    assert w["cache"]["k"][1][2] == CACHE // 2
    layers = _config("windowed").n_layers
    assert w["calls"]["lse_combine"] == layers * STEPS
    assert "decode_attention" not in w["calls"]
    assert "all-reduce" in w["collectives"]
    assert "all-gather" in w["collectives"]     # q's heads, for the merge


def test_sharded_serving_equals_jax(world):
    """JAX's sharded prefill and decode steps (in-shardings on a (2, 2)
    Auto-axis mesh) on reduced f32 OLMo: the port's sharded steps on
    JAX's params give the same greedy tokens and logits within 1e-5."""
    oracle, recs = world
    toks, logits = recs[0]["jax"]["sharded"]
    want = np.stack([oracle["prefill"]]
                    + [oracle[f"decode{t}"] for t in range(STEPS)])
    assert np.abs(logits - want).max() <= 1e-5
    assert np.array_equal(toks, want.argmax(-1))
