"""The port's trainer against the JAX package, on the CPU: the optimizers,
gradient compression, the data pipeline, checkpoints (byte for byte
across the two packages), the training loop (crash-resume bit for bit;
three steps against JAX's Trainer from one state), the step builders,
the int8 KV cache and the train_100m example.

Tolerances: optimizer steps in f32 within 1e-6 of the param's scale and
bf16 params bit for bit; compression, data and checkpoint bytes bit for
bit; the 3-step trainer's params within 1e-5 of each leaf's largest
magnitude (under compression, int8 rounding flips excepted: see the
test) and its logged losses within 1e-5 relative; the int8-KV quantizer
bit for bit on the same inputs, the prefilled cache's scales within 1e-5
relative and q within one step; int8-KV decode logits within 1e-5 of
JAX's (their scale at least 1), within 0.05 of the f32 cache's scale
with the same argmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import steps as jax_steps
from repro.models import build as jax_build
from repro.models import transformer as jax_tf
from repro.training import checkpoint as jax_ckpt
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticLM as JaxSyntheticLM
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.examples import train_100m
from repro_torch.launch import steps
from repro_torch.models import build
from repro_torch.models import transformer as tf
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.data import DataConfig, SyntheticLM, host_shard
from repro_torch.training.train_loop import TrainConfig, Trainer
from repro_torch.training.tree import items, leaves

from _hypothesis_compat import given, settings, st

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(x):
    """Raw bits of a tensor or array, bf16 included, as a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# --------------------------- optimizer ------------------------------ #
@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 130])
def test_lr_schedule_matches_jax(step):
    cfg = opt_lib.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    jcfg = jax_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                               min_lr_ratio=0.1)
    got = float(opt_lib.lr_schedule(cfg, torch.tensor(step)))
    want = float(jax_opt.lr_schedule(jcfg, jnp.asarray(step)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3)


def test_lr_schedule_shape():
    cfg = opt_lib.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    lr0 = float(opt_lib.lr_schedule(cfg, torch.tensor(0.0)))
    lr_w = float(opt_lib.lr_schedule(cfg, torch.tensor(10.0)))
    lr_end = float(opt_lib.lr_schedule(cfg, torch.tensor(100.0)))
    assert lr0 < 0.05 and abs(lr_w - 1.0) < 1e-5
    assert abs(lr_end - 0.1) < 1e-5


def _opt_inputs(dtype, seed=0):
    """A tree with a 3-d weight, a stacked (L, d) norm scale (decayed:
    ndim >= 2, JAX's quirk), a vector and a matrix; gradients large
    enough that the clip binds; f32 moments; numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"layers": {"w": (2, 8, 6), "ln": (2, 8)}, "bias": (6,),
              "embed": (16, 8)}

    def draw(scale):
        return {k: ({kk: (scale * rng.standard_normal(s)).astype(np.float32)
                     for kk, s in v.items()} if isinstance(v, dict)
                    else (scale * rng.standard_normal(v)).astype(np.float32))
                for k, v in shapes.items()}
    params, grads = draw(1.0), draw(3.0)
    m, v = draw(0.1), jax.tree.map(np.abs, draw(0.1))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    return jparams, grads, m, v


def _tree(np_tree):
    return params_lib.tree_from_jax(_np_tree(np_tree), CPU)


def _hold_update(got, want, dtype):
    for (path, g), w in zip(items(got), jax.tree.leaves(want)):
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)
        else:
            w = np.asarray(w)
            tol = 1e-6 * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                       err_msg=path)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adamw_update_matches_jax(dtype):
    jparams, grads, m, v = _opt_inputs(dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
              grad_clip=1.0)
    step = 3
    want_p, want_opt, want_m = jax_opt.adamw_update(
        jparams, jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v)},
        jnp.asarray(step, jnp.int32), jax_opt.AdamWConfig(**kw))
    got_p, got_opt, got_m = opt_lib.adamw_update(
        _tree(jparams), _tree(grads), {"m": _tree(m), "v": _tree(v)},
        torch.tensor(step, dtype=torch.int32), opt_lib.AdamWConfig(**kw))
    _hold_update(got_p, want_p, dtype)
    for name in ("m", "v"):
        _hold_update(got_opt[name], want_opt[name], jnp.float32)
    for name in ("grad_norm", "lr"):
        assert abs(float(got_m[name]) - float(want_m[name])) <= \
            1e-6 * abs(float(want_m[name]))
    assert float(want_m["grad_norm"]) > kw["grad_clip"]      # clip binds


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adafactor_update_matches_jax(dtype):
    jparams, grads, _, _ = _opt_inputs(dtype, seed=1)
    cfg, jcfg = opt_lib.AdafactorConfig(), jax_opt.AdafactorConfig()
    jstate = jax_opt.adafactor_init(jparams)
    state = opt_lib.adafactor_init(_tree(jparams))
    assert [tuple(t.shape) for t in leaves(state)] == \
        [x.shape for x in jax.tree.leaves(jstate)]
    for step in range(2):
        jparams, jstate, _ = jax_opt.adafactor_update(
            jparams, jax.tree.map(jnp.asarray, grads), jstate,
            jnp.asarray(step, jnp.int32), jcfg)
    tparams = _tree(_opt_inputs(dtype, seed=1)[0])
    for step in range(2):
        tparams, state, _ = opt_lib.adafactor_update(
            tparams, _tree(grads), state, torch.tensor(step), cfg)
    _hold_update(tparams, jparams, dtype)
    _hold_update(state, jstate, jnp.float32)


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = opt_lib.adamw_init(params)
    cfg = opt_lib.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                              weight_decay=0.0, grad_clip=0,
                              min_lr_ratio=1.0)
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(80):
        g = {"w": 2 * params["w"]}
        params, opt, _ = opt_lib.adamw_update(params, g, opt, step, cfg)
        step = step + 1
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_caps_norm():
    params = {"w": torch.ones(4)}
    opt = opt_lib.adamw_init(params)
    cfg = opt_lib.AdamWConfig(lr=0.0, grad_clip=1.0)
    _, _, m = opt_lib.adamw_update(params, {"w": torch.full((4,), 100.0)},
                                   opt, torch.zeros((), dtype=torch.int32),
                                   cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


def test_adafactor_memory_factored():
    params = {"w": torch.ones(16, 8), "b": torch.ones(8)}
    st_ = opt_lib.adafactor_init(params)
    assert sum(x.numel() for x in leaves(st_)) == 16 + 8 + 8


# --------------------------- compression ---------------------------- #
def _grads_with_ties():
    """Leaves whose x / scale lands on .5 exactly (amax 127: scale 1),
    and random ones, with a nonzero error accumulator."""
    rng = np.random.default_rng(3)
    tie = np.array([127.0, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5],
                   np.float32)
    grads = {"tie": tie, "w": rng.standard_normal((5, 7)).astype(np.float32),
             "b": (1e-3 * rng.standard_normal(9)).astype(np.float32)}
    err = {"tie": np.zeros(9, np.float32),
           "w": (0.01 * rng.standard_normal((5, 7))).astype(np.float32),
           "b": (1e-5 * rng.standard_normal(9)).astype(np.float32)}
    return grads, err


def test_compress_tree_matches_jax_bitwise():
    grads, err = _grads_with_ties()
    jq, jdeq, jerr = jax_comp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                            jax.tree.map(jnp.asarray, err))
    q, deq, new_err = comp_lib.compress_tree(_tree(grads), _tree(err))
    assert q["q"]["tie"].tolist() == [127, 64, -64, 0, 2, 2, -2, 0, 126]
    for got, want in ((q["q"], jq["q"]), (q["scale"], jq["scale"]),
                      (deq, jdeq), (new_err, jerr)):
        for (path, g), w in zip(items(got), jax.tree.leaves(want)):
            assert g.dtype == params_lib._leaf(np.asarray(w), CPU).dtype
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)


def test_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_seq = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
             * 0.1 for _ in range(50)]
    e = torch.zeros(64)
    applied = torch.zeros(64)
    for g in g_seq:
        q, scale, e = comp_lib.compress(g, e)
        applied += comp_lib.decompress(q, scale)
    true = sum(g_seq)
    np.testing.assert_allclose((applied + e).numpy(), true.numpy(),
                               atol=1e-4)
    assert float(e.norm()) < 0.1 * float(true.norm()) + 1.0


def test_compression_wire_bytes():
    tree = {"w": torch.ones(1000), "b": torch.ones(10)}
    full = comp_lib.wire_bytes(tree, compressed=False)
    comp = comp_lib.wire_bytes(tree, compressed=True)
    assert comp < 0.27 * full
    jtree = {"w": jnp.ones(1000), "b": jnp.ones(10)}
    assert (full, comp) == (jax_comp.wire_bytes(jtree, False),
                            jax_comp.wire_bytes(jtree, True))


def _roundtrip_bound(n):
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(n)
                         .astype(np.float32))
    q, scale, err = comp_lib.compress(g, torch.zeros(n))
    assert float(err.abs().max()) <= float(scale) * 0.51


@settings(max_examples=20, deadline=None)
@given(st.integers(4, 256))
def test_compress_roundtrip_bound(n):
    _roundtrip_bound(n)


@pytest.mark.parametrize("n", [4, 5, 17, 128, 255, 256])
def test_compress_roundtrip_bound_cases(n):
    _roundtrip_bound(n)


# ------------------------------ data -------------------------------- #
def test_batch_at_matches_jax():
    kw = dict(vocab=300, seq_len=40, batch=3, seed=7)
    mine, theirs = SyntheticLM(DataConfig(**kw)), \
        JaxSyntheticLM(JaxDataConfig(**kw))
    for step in (0, 1, 5, 60):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_host_shard_partitions():
    b = SyntheticLM(DataConfig(vocab=16, seq_len=4, batch=8)).batch_at(0)
    shards = [host_shard(b, i, 4) for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([s["tokens"] for s in shards]), b["tokens"])


# --------------------------- checkpoint ----------------------------- #
@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state of the reduced OLMo in bf16 (bf16 params, f32
    moments filled from a seed, an int32 step), as numpy leaves."""
    cfg = JAX_ARCHS["olmo-1b"].reduced()
    _, init = jax_steps.make_train_step(cfg)
    state = _np_tree(jax.jit(init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("m", "v"):
        state["opt"][name] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            state["opt"][name])
    state["step"] = np.asarray(7, np.int32)
    return state


def test_checkpoints_are_byte_identical_and_read_both_ways(jax_state,
                                                           tmp_path):
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jax_ckpt.save(jax.tree.map(jnp.asarray, jax_state), jax_path)
    state = params_lib.tree_from_jax(jax_state, CPU)
    ckpt_lib.save(state, port_path)
    assert jax_path.read_bytes() == port_path.read_bytes()
    # JAX's file into the port, the port's into JAX
    like = jax.tree.map(torch.zeros_like, state,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    back = ckpt_lib.restore(jax_path, like)
    for (path, a), b in zip(items(back), leaves(state)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
    jback = jax_ckpt.restore(port_path, jax.tree.map(jnp.asarray, jax_state))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jax_state)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _codec_tree(rng):
    """A checkpoint-shaped map: more than 15 (map16) leaves of every
    dtype the files carry, bin of 0 bytes to past 64 KiB (bin8, 16, 32),
    shape entries of every int width, strings past 31 and 255 bytes."""
    out = {}
    dtypes = ("<f4", "<i4", "|i1", "<u2", "|b1", "<f8")
    for i in range(20):
        n = int(rng.choice([0, 3, 200, 300, 70000]))
        out[f"leaf/{i}"] = {"dtype": dtypes[i % len(dtypes)],
                            "shape": [n, 1],
                            "data": rng.bytes(n)}
    out["ints"] = {"shape": [0, 127, 128, 255, 256, 65535, 65536,
                             2 ** 32 - 1, 2 ** 32, -1, -32, -33, -128, -129,
                             -32768, -32769, -2 ** 31, -2 ** 31 - 1]}
    out["strings"] = ["x" * 40, "y" * 300]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_msgpack_codec_matches_msgpack(seed):
    tree = _codec_tree(np.random.default_rng(seed))
    blob = msgpack.packb(tree)
    assert ckpt_lib.packb(tree) == blob
    back = ckpt_lib.unpackb(blob)
    assert {k: {kk: (bytes(vv) if isinstance(vv, memoryview) else vv)
                for kk, vv in v.items()} if isinstance(v, dict) else v
            for k, v in back.items()} == msgpack.unpackb(blob)


def test_bf16_leaves_match_msgpack(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 5))
                                  .astype(np.float32)).bfloat16(),
            "b": {"c": torch.arange(7, dtype=torch.int32)}}
    ckpt_lib.save(tree, tmp_path / "x.msgpack")
    want = {"a": {"dtype": "bfloat16", "shape": [3, 5],
                  "data": tree["a"].view(torch.int16).numpy().tobytes()},
            "b/c": {"dtype": "<i4", "shape": [7],
                    "data": np.arange(7, dtype=np.int32).tobytes()}}
    assert (tmp_path / "x.msgpack").read_bytes() == msgpack.packb(want)


def test_checkpoint_manager_gc(tmp_path):
    mgr = ckpt_lib.CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, {"w": torch.ones(2)})
    assert mgr.latest_step() == 40
    assert len(list(tmp_path.glob("ckpt_*.msgpack"))) == 2
    step, back = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 40 and torch.equal(back["w"], torch.ones(2))


def test_restore_shape_mismatch_and_missing_raise(tmp_path):
    ckpt_lib.save({"w": torch.ones(4)}, tmp_path / "x.msgpack")
    with pytest.raises(ValueError):
        ckpt_lib.restore(tmp_path / "x.msgpack", {"w": torch.ones(5)})
    with pytest.raises(KeyError):
        ckpt_lib.restore(tmp_path / "x.msgpack", {"u": torch.ones(4)})


# ----------------------------- trainer ------------------------------ #
def test_crash_resume_equality(tmp_path):
    """train(2N) == train(N) + crash + resume(N), bit for bit: params,
    moments and step."""
    cfg = ARCHS["xlstm-125m"].reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, batch=2)
    kw = dict(log_every=100)

    def trainer(steps, d):
        return Trainer(cfg, dc, TrainConfig(steps=steps, ckpt_every=4,
                                            ckpt_dir=str(tmp_path / d), **kw),
                       device="cpu")
    r_full = trainer(8, "a").run()
    trainer(4, "b").run()
    r_res = trainer(8, "b").run()
    assert r_res["resumed_from"] == 4
    for (path, a), b in zip(items(r_full["state"]), leaves(r_res["state"])):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_matches_jax(compress, tmp_path):
    """Three steps of the port's Trainer and JAX's from the same state and
    data on the reduced OLMo in f32 (remat, AdamW at lr 1e-3, and with
    compress_grads the int8 error feedback): the logged losses within
    1e-5 relative, the params within 1e-5 of each leaf's largest
    magnitude.  Under compression a gradient element whose f32 value sits
    at an int8 rounding tie may round one step apart in the two packages
    (their gradients differ in the last bits); Adam turns such a flip into
    a step of at most lr.  So there, up to 1e-4 of the elements may be
    off by at most 2 lr (two nonzero learning rates: the first step's is
    0 under warmup)."""
    jcfg = JAX_ARCHS["olmo-1b"].reduced(dtype="f32")
    pcfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    dkw = dict(vocab=pcfg.vocab, seq_len=16, batch=2, seed=3)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    tkw = dict(steps=3, ckpt_every=100, log_every=1, compress_grads=compress)
    jt = JaxTrainer(jcfg, JaxDataConfig(**dkw),
                    JaxTrainConfig(ckpt_dir=str(tmp_path / "j"), **tkw),
                    jax_opt.AdamWConfig(**okw))
    start = params_lib.tree_from_jax(_np_tree(jt.init_state(0)), CPU)
    want = jt.run()
    pt = Trainer(pcfg, DataConfig(**dkw),
                 TrainConfig(ckpt_dir=str(tmp_path / "p"), **tkw),
                 opt_lib.AdamWConfig(**okw), device="cpu")
    got = pt.run(state=start)
    assert sorted(got["state"]) == sorted(want["state"])
    assert [h["step"] for h in got["history"]] == [1, 2, 3]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
    off, total = 0, 0
    for (path, g), w in zip(items(got["state"]["params"]),
                            jax.tree.leaves(want["state"]["params"])):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w)
        bad = err > 1e-5 * float(np.abs(w).max())
        off, total = off + int(bad.sum()), total + w.size
        assert float(err.max()) <= 2 * okw["lr"], path
    assert off <= (1e-4 * total if compress else 0), (off, total)
    assert int(got["state"]["step"]) == 3


def test_run_goes_on_from_a_given_state(tmp_path):
    """run(state=) starts at the state's step: 4 steps, then a second
    Trainer given that state to 6, equal bit for bit to 6 steps in one
    run; ckpt_every=0 writes no checkpoint."""
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    dc = DataConfig(vocab=cfg.vocab, seq_len=8, batch=2)

    def trainer(steps):
        return Trainer(cfg, dc, TrainConfig(steps=steps, ckpt_every=0,
                                            ckpt_dir=str(tmp_path),
                                            log_every=1), device="cpu")
    whole = trainer(6).run()
    part = trainer(4).run()
    rest = trainer(6).run(state=part["state"])
    assert [h["step"] for h in rest["history"]] == [5, 6]
    for (path, a), b in zip(items(whole["state"]), leaves(rest["state"])):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
    assert list(tmp_path.iterdir()) == []


def test_trainer_refuses_a_mesh(tmp_path):
    """A mesh without a strategy is refused; a "cpu" mesh of one rank
    (`launch.mesh.make_mesh`, a one-rank gloo group started for it) with
    a strategy is taken: every dim resolves unsharded there.  3 steps
    match the unsharded trainer's losses (the sharded path's einsums sum
    in another order than the plain path's matmuls), and the checkpoint
    is the file the unsharded codec writes for the gathered state, as
    long as the unsharded trainer's."""
    from repro_torch.distributed import train_strategy_fsdp
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import gather_tree
    from repro_torch.training import checkpoint as ckpt_lib
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    dc = DataConfig(vocab=cfg.vocab, seq_len=8, batch=2)
    with pytest.raises(ValueError, match="mesh and a strategy"):
        Trainer(cfg, dc, TrainConfig(), mesh=object(), device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    runs = {}
    for name, kw in (("mesh", {"mesh": mesh,
                               "strategy": train_strategy_fsdp(mesh)}),
                     ("plain", {"device": "cpu"})):
        tc = TrainConfig(steps=3, ckpt_every=3, log_every=1,
                         ckpt_dir=str(tmp_path / name))
        runs[name] = Trainer(cfg, dc, tc, **kw).run()
    assert all(is_dtensor(t) for t in leaves(runs["mesh"]["state"]))
    np.testing.assert_allclose([h["loss"] for h in runs["mesh"]["history"]],
                               [h["loss"] for h in runs["plain"]["history"]],
                               rtol=1e-6)
    files = [(tmp_path / n / "ckpt_00000003.msgpack").read_bytes()
             for n in runs]
    ckpt_lib.save(gather_tree(runs["mesh"]["state"]), tmp_path / "g.msgpack")
    assert files[0] == (tmp_path / "g.msgpack").read_bytes()
    assert len(files[0]) == len(files[1])


def test_train_100m_tiny_crash_and_resume(tmp_path):
    """The example's flags on the CPU: a crash after 6 steps, then the
    resume to 12 from the checkpoint at 6."""
    lines = []
    out = train_100m.train(train_100m.parse(
        ["--tiny", "--device", "cpu", "--steps", "12", "--crash-at", "6",
         "--ckpt", str(tmp_path)]), log=lines.append)
    assert out["resumed_from"] == 6 and len(out["phases"]) == 2
    assert any("resumed from step 6" in ln for ln in lines)
    assert np.isfinite(out["history"][-1]["loss"])


# -------------------------- step builders --------------------------- #
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_specs_match_jax(name):
    pcfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    for shape in ("train_4k", "prefill_32k"):
        got = steps.input_specs(pcfg, SHAPES[shape])["batch"]
        want = jax_steps.input_specs(jcfg, JAX_SHAPES[shape])["batch"]
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64)
    jshape = dataclasses.replace(JAX_SHAPES["decode_32k"], seq_len=64)
    assert steps.cache_len_for(pcfg, shape) == \
        jax_steps.cache_len_for(jcfg, jshape)
    if pcfg.block != "xlstm":
        got = steps.decode_specs(pcfg, shape, kv_quant=True)["cache"]
        want = jax_steps.decode_specs(jcfg, jshape, kv_quant=True)["cache"]
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert got["k"].dtype == torch.int8
    got = [tuple(t.shape) for t in leaves(steps.state_specs(pcfg))]
    want = [tuple(x.shape) for x in jax.tree.leaves(
        jax_steps.state_specs(jcfg))]
    assert got == want


# ---------------------------- int8 KV ------------------------------- #
@pytest.fixture(scope="module")
def deepseek():
    """(jax cfg, port cfg, JAX params, port params, tokens (2, 16))."""
    jcfg = JAX_ARCHS["deepseek-7b"].reduced(dtype="f32")
    pcfg = ARCHS["deepseek-7b"].reduced(dtype="f32")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0))
    tparams = params_lib.from_jax(_np_tree(jparams), pcfg, "cpu")
    toks = np.random.default_rng(11).integers(0, pcfg.vocab, (2, 16)) \
        .astype(np.int32)
    return jcfg, pcfg, jparams, tparams, toks


def test_kv_quantize_matches_jax_bitwise():
    """The quantizer on the same inputs, .5 ties included: q and scales
    bit for bit (JAX eager; jitted, XLA multiplies by 1/127 instead of
    dividing, a last-bit difference in the scale)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 63.5, -2.5, 0.5]    # scale 1: ties at .5
    x[0, 0, 0, 4:] = 0.0
    jq, js = jax_tf.kv_quantize(jnp.asarray(x))
    q, scale = tf.kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert q[0, 0, 0, :4].tolist() == [127, 64, -2, 0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tf.kv_dequant(q, scale).numpy(), np.asarray(jax_tf.kv_dequant(jq, js)))


def test_int8_kv_prefill_matches_jax(deepseek):
    """prefill(kv_quant=True): the cache's layout, dtypes and zeros past
    the prompt as JAX's; the scales within 1e-5 relative and q within one
    step (the K/V projections round differently in the two packages, by
    ulps, which moves a value at a .5 tie), equal almost everywhere."""
    jcfg, pcfg, jparams, tparams, toks = deepseek
    _, jc, jpos = jax_build(jcfg).prefill(jparams, jnp.asarray(toks[:, :-1]),
                                          cache_len=20, kv_quant=True)
    _, c, pos = build(pcfg, CPU).prefill(tparams, torch.from_numpy(
        toks[:, :-1]), cache_len=20, kv_quant=True)
    assert sorted(c) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    for name in c:
        want = np.asarray(jc[name])
        assert c[name].dtype == params_lib._leaf(want, CPU).dtype
        assert tuple(c[name].shape) == want.shape
        got = c[name].numpy()
        assert not got[:, :, 15:].any() and not want[:, :, 15:].any()
        if name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        else:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2, name
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_int8_kv_cache_decode(deepseek):
    """The counterpart of test_models.py's int8 KV test: decode logits
    against JAX's, and against the f32 cache within quantization
    tolerance; the int8 cache under 0.6x the bytes."""
    jcfg, pcfg, jparams, tparams, toks = deepseek
    jm, model = jax_build(jcfg), build(pcfg, CPU)
    t = torch.from_numpy(toks)
    _, c16, pos = model.prefill(tparams, t[:, :-1], cache_len=20)
    d16, _ = model.decode(tparams, c16, t[:, -1], pos + 1)
    _, c8, pos8 = model.prefill(tparams, t[:, :-1], cache_len=20,
                                kv_quant=True)
    d8, c8 = model.decode(tparams, c8, t[:, -1], pos8 + 1)
    _, jc8, jpos8 = jm.prefill(jparams, jnp.asarray(toks[:, :-1]),
                               cache_len=20, kv_quant=True)
    jd8, jc8 = jm.decode(jparams, jc8, jnp.asarray(toks[:, -1]), jpos8 + 1)
    want = np.asarray(jd8)
    np.testing.assert_allclose(d8.numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert c8["k"].dtype == torch.int8
    kv16 = c16["k"].numel() * c16["k"].element_size()
    kv8 = c8["k"].numel() + c8["k_scale"].numel() * 4
    assert kv8 < 0.6 * kv16
    scale = float(d16.abs().max())
    assert float((d8 - d16).abs().max()) < 0.05 * max(scale, 1.0)
    assert torch.equal(d8.argmax(-1), d16.argmax(-1))


def test_int8_kv_step_builders(deepseek):
    """make_prefill_step / make_decode_step with kv_quant: the model's
    own calls; a cache of the other kind is refused."""
    _, pcfg, _, tparams, toks = deepseek
    shape = dataclasses.replace(SHAPES["decode_32k"], batch=2, seq_len=15)
    prefill = steps.make_prefill_step(pcfg, shape, kv_quant=True,
                                      device="cpu")
    decode = steps.make_decode_step(pcfg, kv_quant=True, device="cpu")
    t = torch.from_numpy(toks)
    _, cache, pos = prefill(tparams, {"tokens": t[:, :-1]})
    assert cache["k"].shape[2] == steps.cache_len_for(pcfg, shape) == 15
    got, _ = decode(tparams, cache, t[:, -1], pos + 1)
    model = build(pcfg, CPU)
    _, c8, p8 = model.prefill(tparams, t[:, :-1], cache_len=15,
                              kv_quant=True)
    want, _ = model.decode(tparams, c8, t[:, -1], p8 + 1)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="kv_quant"):
        steps.make_decode_step(pcfg, device="cpu")(tparams, cache, t[:, -1],
                                                   pos + 1)
