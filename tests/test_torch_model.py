"""The port's dense model against the JAX package's, on the reduced OLMo-1B
in f32 with the JAX-initialised params carried across by `from_jax`:
params, layers, bucketed prefill, one decode step against a contiguous
cache and one through the page table, and the page gather / scatter /
slot writes of the KV cache.  Tolerances:
layers 1e-6 (same f32 arithmetic), logits 1e-4 (matmuls and attention
summed in another order), bf16 layers 1 ulp of bf16 (2**-7 relative)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.serving import kv_cache as jax_kv
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS as TORCH_ARCHS
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache as kv

torch.set_num_threads(2)

CPU = "cpu"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfg():
    # its own name: param_store caches by name, and the suite's bf16
    # reduced OLMo already holds "olmo-1b-reduced"
    return ARCHS["olmo-1b"].reduced(dtype="f32", name="olmo-1b-reduced-f32")


@pytest.fixture(scope="module")
def jparams(cfg, param_store):
    return param_store(cfg)


@pytest.fixture(scope="module")
def tparams(cfg, jparams):
    return params_lib.from_jax(_np_tree(jparams), cfg, CPU)


def test_configs_copy_equals_reference():
    assert set(TORCH_ARCHS) == set(ARCHS)
    for name, c in ARCHS.items():
        assert repr(TORCH_ARCHS[name]) == repr(c)
        assert repr(TORCH_ARCHS[name].reduced()) == repr(c.reduced())


@pytest.mark.parametrize("name", ["scheduler.py", "request.py"])
def test_serving_copies_equal_reference(name):
    """ROADMAP C7: the port's copies of serving/scheduler.py and
    serving/request.py equal the reference's but for their imports, which
    name repro_torch where the reference names repro."""
    root = Path(__file__).resolve().parents[1] / "src"
    ref = (root / "repro" / "serving" / name).read_text()
    port = (root / "repro_torch" / "serving" / name).read_text()
    assert "from repro_torch." in port
    assert port.replace("from repro_torch.", "from repro.") == ref


def test_from_jax_bf16_round_trip(param_store):
    """bf16 leaves cross through a 16-bit view: every bit survives."""
    cfg16 = ARCHS["olmo-1b"].reduced()
    assert cfg16.dtype == "bf16"
    tree = _np_tree(param_store(cfg16))
    got = params_lib.from_jax(tree, cfg16, CPU)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_j:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.bfloat16
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      leaf.view(np.uint16).view(np.int16))


def test_init_params_shapes_and_scales(cfg, jparams):
    """Seeded init: the JAX layout and the same scales (trunc normal at
    +-2 sigma; 0.02 for the embedding, 1/sqrt(d_in) for dense layers)."""
    gen = torch.Generator().manual_seed(0)
    got = build(cfg, CPU).init(gen)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, leaf in jflat.items():
        node = got
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        ref_std = float(np.std(np.asarray(leaf)))
        assert abs(float(node.std()) / ref_std - 1) < 0.15
        bound = float(np.abs(np.asarray(leaf)).max()) * 1.05
        assert float(node.abs().max()) <= bound


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = TORCH_ARCHS["olmo-1b"].reduced(dtype="f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_lib.init_params(cfg, torch.Generator())


def test_out_of_slice_families_raise():
    """xLSTM and the encoder-decoder, the last families out of the port,
    build now (every config in ARCHS does); configs that no family builds
    still raise: hymba without an SSM state, meta tokens outside hymba,
    prefix tokens on a frontend other than vision, an audio frontend
    without an encoder, another block."""
    import dataclasses
    for cfg in TORCH_ARCHS.values():
        assert build(cfg, CPU).cfg is cfg
        assert build(cfg.reduced(), CPU).cfg.name.endswith("-reduced")
    olmo = TORCH_ARCHS["olmo-1b"].reduced()
    bad = [dataclasses.replace(TORCH_ARCHS["hymba-1.5b"].reduced(),
                               ssm_state=0),
           dataclasses.replace(olmo, n_meta_tokens=2),
           dataclasses.replace(olmo, frontend="audio", n_prefix_tokens=4),
           dataclasses.replace(olmo, frontend="audio"),
           dataclasses.replace(olmo, block="mamba"),
           dataclasses.replace(TORCH_ARCHS["xlstm-125m"].reduced(),
                               encdec=TORCH_ARCHS[
                                   "seamless-m4t-large-v2"].encdec)]
    for cfg in bad:
        with pytest.raises(NotImplementedError, match="is not supported"):
            build(cfg, CPU)


# ------------------- layers ---------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_jax(dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3 + 1
    g = rng.standard_normal((2, 5, 64)).astype(np.float32)
    u = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-6 if dt == "f32" else 2 ** -7

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    close(L.nonparam_ln(tx), jax_layers.nonparam_ln(jx))
    pos = np.asarray([[0, 3, 7, 100, 1023], [5, 6, 7, 8, 9]], np.int32)
    jc, js = jax_layers.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = L.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    close(L.apply_rope(tx, tc, ts), jax_layers.apply_rope(jx, jc, js))
    close(L.apply_rope(tx, tc[0], ts[0]),
          jax_layers.apply_rope(jx, jc[0], js[0]))
    jg, ju = jnp.asarray(g, jdt), jnp.asarray(u, jdt)
    want = jax.nn.silu(jg.astype(jnp.float32)).astype(jdt) * ju
    close(L.swiglu(torch.from_numpy(g).to(tdt), torch.from_numpy(u).to(tdt)),
          want)


# ------------------- prefill and paged decode ---------------------- #
def test_prefill_ragged_rows_match_jax(cfg, jparams, tparams):
    """Right-padded rows: each row's logits and pos come from its own last
    real token, as in transformer.prefill(lengths=)."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, cfg.vocab, (3, 16)).astype(np.int32)
    lengths = np.asarray([16, 9, 1], np.int32)
    want_logits, want_cache, want_pos = jax_tf.prefill(
        jparams, cfg, jnp.asarray(tokens), lengths=jnp.asarray(lengths))
    logits, cache, pos = tf.prefill(tparams, cfg,
                                    torch.from_numpy(tokens).long(),
                                    lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]),
                                   atol=1e-4, rtol=1e-4)


def test_full_forward_impls_agree(cfg, tparams):
    """The no-cache recompute oracle (impl="full") and the prefill path
    (impl="flash", the plain flash version on the CPU) agree."""
    tokens = torch.arange(1, 21).reshape(2, 10)
    a = tf.forward(tparams, cfg, tokens, impl="full")
    b = tf.forward(tparams, cfg, tokens, impl="flash")
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_decode_step_paged_matches_jax(cfg, jparams, tparams):
    """One decode step through a sentinel-padded page table; the write
    table maps one slot's current page to the sentinel (a cache-shared
    page), so that slot's write drops in both packages."""
    rng = np.random.default_rng(3)
    n_pages, ps, pps = 12, 8, 4
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    table = np.full((3, pps), n_pages, np.int32)
    table[0, :2] = [4, 9]
    table[1, :1] = [2]
    table[2, :3] = [0, 7, 11]
    pos = np.asarray([12, 3, 20], np.int32)
    write = table.copy()
    write[2, 2] = n_pages            # slot 2's page at pos 20 is shared
    token = np.asarray([5, 17, 200], np.int32)
    want_logits, want_cache = jax_tf.decode_step_paged(
        jparams, cfg, {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool)},
        jnp.asarray(token), jnp.asarray(pos), jnp.asarray(table),
        jnp.asarray(write))
    # the port's pools carry one scratch page past the sentinel
    scratch = np.zeros(shape[:1] + (1,) + shape[2:], np.float32)
    cache = {"k": torch.from_numpy(np.concatenate([k_pool, scratch], 1)),
             "v": torch.from_numpy(np.concatenate([v_pool, scratch], 1))}
    logits, cache = tf.decode_step_paged(
        tparams, cfg, cache, torch.from_numpy(token).long(),
        torch.from_numpy(pos), torch.from_numpy(table),
        torch.from_numpy(write))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    for name, pool in (("k", k_pool), ("v", v_pool)):
        got = cache[name][:, :n_pages].numpy()
        np.testing.assert_allclose(got, np.asarray(want_cache[name]),
                                   atol=1e-5, rtol=1e-5)
        # the dropped write left slot 2's shared page untouched
        np.testing.assert_array_equal(got[:, 11, 20 % ps],
                                      pool[:, 11, 20 % ps])
        assert not np.array_equal(got[:, 9, 12 % ps], pool[:, 9, 12 % ps])


def test_paged_write_all_rows_dropped(cfg):
    """Every row dropping (a sentinel page, a position past the table)
    leaves the pool's real pages bit-identical; the writes land in the
    scratch page."""
    pool = torch.randn(7, 4, 2, 8)                  # 6 pages + scratch
    before = pool.clone()
    table = torch.full((2, 3), 6, dtype=torch.int32)
    new = torch.randn(2, 2, 8)
    tf._paged_write(pool, new, table,
                    torch.tensor([1, 14], dtype=torch.int32))
    assert torch.equal(pool[:6], before[:6])
    assert torch.equal(pool[6, 1], new[0])
    assert torch.equal(pool[6, 2], new[1])


def test_decode_step_matches_jax(cfg, jparams, tparams):
    """One decode step against a contiguous (L, B, S, K, hd) cache, in
    place; row 2 sits at pos == S, whose write JAX clamps to S - 1."""
    rng = np.random.default_rng(4)
    S = 24
    shape = (cfg.n_layers, 3, S, cfg.n_kv_heads, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    token = np.asarray([5, 17, 200], np.int32)
    pos = np.asarray([0, 13, S], np.int32)
    want_logits, want_cache = jax_tf.decode_step(
        jparams, cfg, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(token), jnp.asarray(pos))
    cache = {"k": torch.from_numpy(kc.copy()),
             "v": torch.from_numpy(vc.copy())}
    logits, out = tf.decode_step(tparams, cfg, cache,
                                 torch.from_numpy(token).long(),
                                 torch.from_numpy(pos))
    assert out["k"] is cache["k"]                  # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]),
                                   atol=1e-5, rtol=1e-5)


def test_gather_scatter_write_slots_match_jax():
    """Same pool and tables in both packages: the gathered views agree on
    every row that is not a sentinel row (the port reads its scratch page
    there, JAX zeros; both lie past pos and are masked), the scattered
    pools agree exactly on the real pages, and slot writes agree."""
    rng = np.random.default_rng(5)
    L, P, ps, K, hd = 2, 6, 4, 2, 8
    pool = rng.standard_normal((L, P, ps, K, hd)).astype(np.float32)
    table = np.asarray([[3, 0, P], [5, P, P], [P, P, P]], np.int32)
    jpool = {"k": jnp.asarray(pool)}
    want = np.asarray(jax_kv.gather_pages(jpool, jnp.asarray(table))["k"])
    scratch = rng.standard_normal((L, 1, ps, K, hd)).astype(np.float32)
    tpool = {"k": torch.from_numpy(np.concatenate([pool, scratch], 1))}
    got = kv.gather_pages(tpool, torch.from_numpy(table))["k"].numpy()
    real = np.repeat(table < P, ps, axis=1)         # (n_slots, pps * ps)
    np.testing.assert_array_equal(got[:, real], want[:, real])

    view = rng.standard_normal(want.shape).astype(np.float32)
    want_pool = np.asarray(jax_kv.scatter_pages(
        jpool, {"k": jnp.asarray(view)}, jnp.asarray(table))["k"])
    kv.scatter_pages(tpool, {"k": torch.from_numpy(view)},
                     torch.from_numpy(table))
    np.testing.assert_array_equal(tpool["k"][:, :P].numpy(), want_pool)

    strips = rng.standard_normal((L, 3, 16, K, hd)).astype(np.float32)
    rows = rng.standard_normal((L, 2, 16, K, hd)).astype(np.float32)
    slots = np.asarray([2, 3], np.int32)             # 3 >= n_slots: dropped
    want_strips = np.asarray(jax_kv.write_slots(
        {"k": jnp.asarray(strips)}, {"k": jnp.asarray(rows)},
        jnp.asarray(slots))["k"])
    tstrips = {"k": torch.from_numpy(strips.copy())}
    kv.write_slots(tstrips, {"k": torch.from_numpy(rows)}, slots)
    np.testing.assert_array_equal(tstrips["k"].numpy(), want_strips)
