"""The Mixture-of-Experts FFN in the port, against the JAX package, on
the CPU through the kernels' plain versions (JAX's Pallas kernels run as
its own CPU tests run them).

`moe_ffn` at E 4 / 8, top-k 1 / 2, swiglu and gelu, capacity factors
0.25 (pairs drop), 1.25 (the configs') and drop-free, on numpy inputs
from a seed: output, aux loss, top-k order, slots and keep mask.  Then
every transformer entry point and the engine on the reduced
granite-moe-3b-a800m (4 experts top-2, n_kv_heads 2: G = 2) and the
reduced mixtral-8x22b (window 16), in f32, JAX's initialised params
carried across with `from_jax` after their RMS-norm scales are drawn
from a numpy seed.  Each entry point feeds the FFN its own sequence
length, so each gets the capacity of that length, as in JAX: a full
forward is no oracle for the engine's tokens once pairs drop, and every
comparison here is with JAX on the same path.

Tolerances: 2e-5 on outputs and logits in f32 (matmuls and attention
summed in another order); routing (top-k indices, slots, kept pairs),
greedy tokens and the engines' counters must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.configs.base import MoEConfig
from repro_torch.models import build
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.serving import EngineConfig, InferenceEngine, Request
from repro_torch.serving import SamplingParams
from repro_torch.serving import quantization as q_lib

torch.set_num_threads(2)

TOL = 2e-5

# JAX's entry points jitted once per config (op by op they dominate the
# file's time)
_jax_ffn = jax.jit(jax_moe.moe_ffn, static_argnums=(4, 5))
_jax_decode = jax.jit(jax_tf.decode_step, static_argnums=(1,))
_jax_decode_paged = jax.jit(jax_tf.decode_step_paged, static_argnums=(1,))

# its own name each: param_store caches by name
CONFIGS = {
    "granite": lambda a: a["granite-moe-3b-a800m"].reduced(
        dtype="f32", n_kv_heads=2, name="granite-moe-3b-a800m-reduced-f32"),
    "mixtral": lambda a: a["mixtral-8x22b"].reduced(
        dtype="f32", name="mixtral-8x22b-reduced-f32"),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# -------------------- moe_ffn --------------------------------------- #
CAPACITY = {"0.25": 0.25, "1.25": 1.25, "drop_free": None}   # None: E


def _ffn_inputs(e, act, seed, b=2, s=24, d=16, f=32):
    rng = np.random.default_rng(seed)
    wi_shape = (e, 2, d, f) if act == "swiglu" else (e, d, f)
    return (rng.standard_normal((b, s, d)).astype(np.float32) * 0.5,
            rng.standard_normal((d, e)).astype(np.float32),
            rng.standard_normal(wi_shape).astype(np.float32) * 0.2,
            rng.standard_normal((e, f, d)).astype(np.float32) * 0.2)


@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8])
def test_moe_ffn_matches_jax(e, k, act, cap):
    """Output and aux at 2e-5; the router's top-k (descending), the
    slots and the keep mask exactly.  At 0.25 pairs drop; drop-free,
    the dense-masked oracle equals the dispatch on both sides."""
    factor = CAPACITY[cap] or float(e)
    arrays = _ffn_inputs(e, act, seed=e * 10 + k)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [_t(a) for a in arrays]
    jcfg, pcfg = JaxMoEConfig(e, k, factor), MoEConfig(e, k, factor)
    c = moe_lib.capacity(24, pcfg)
    assert c == jax_moe.capacity(24, jcfg)
    want_y, want_aux = _jax_ffn(*jargs, jcfg, act)
    with moe_lib.keep_masks() as log:
        got_y, got_aux = moe_lib.moe_ffn(*targs, pcfg, act)
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL,
                               atol=TOL)
    # routing and dispatch, exactly
    jg, ji, _ = jax_moe.router_topk(jargs[0], jargs[1], jcfg)
    tg, ti, _ = moe_lib.router_topk(targs[0], targs[1], pcfg)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=TOL, atol=TOL)
    _, jslot, jkeep, _ = jax.vmap(
        lambda xr, ir, gr: jax_moe._dispatch_one_row(xr, ir, gr, e, c))(
        jargs[0], ji, jg)
    _, slot, keep = moe_lib._dispatch(targs[0], ti, e, c)
    np.testing.assert_array_equal(keep.numpy(), _np(jkeep))
    np.testing.assert_array_equal(slot.numpy(), _np(jslot))
    assert len(log) == 1 and torch.equal(log[0], keep)
    if cap == "0.25":
        assert not bool(keep.all())
    if cap == "drop_free":
        assert bool(keep.all())
        ref_y, ref_aux = moe_lib.moe_ffn_ref(*targs, pcfg, act)
        np.testing.assert_allclose(ref_y.numpy(), got_y.numpy(), rtol=TOL,
                                   atol=TOL)
        assert float(ref_aux) == float(got_aux)
        jref, _ = jax_moe.moe_ffn_ref(*jargs, jcfg, act)
        np.testing.assert_allclose(ref_y.numpy(), _np(jref), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("factor", [0.25, 1.25])
def test_right_pads_never_take_a_real_tokens_slot(factor):
    """A row's real tokens followed by pads of two different contents:
    the real tokens' kept pairs and outputs are the same, bit for bit
    (pairs rank in s-major order, so a pad ranks after every real pair
    of its expert)."""
    x, router, wi, wo = (_t(a) for a in _ffn_inputs(4, "swiglu", seed=3,
                                                      b=1))
    cfg, n_real = MoEConfig(4, 2, factor), 10
    outs = []
    for seed in (4, 5):
        padded = x.clone()
        padded[:, n_real:] = torch.from_numpy(np.random.default_rng(
            seed).standard_normal((1, 24 - n_real, 16)).astype(np.float32))
        with moe_lib.keep_masks() as log:
            y, _ = moe_lib.moe_ffn(padded, router, wi, wo, cfg, "swiglu")
        outs.append((y[:, :n_real], log[0][:, :n_real * 2]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_capacity_is_jax_expression():
    for e, k, cf in ((40, 8, 1.25), (8, 2, 1.25), (4, 2, 1.25),
                     (4, 2, 0.25), (3, 1, 1.1)):
        for s in (1, 2, 5, 7, 16, 33, 128, 1024):
            assert moe_lib.capacity(s, MoEConfig(e, k, cf)) \
                == jax_moe.capacity(s, JaxMoEConfig(e, k, cf))
    # granite: a decode step keeps all 8 pairs; the verify of 4 drafts too
    granite = ARCHS["granite-moe-3b-a800m"].moe
    assert moe_lib.capacity(1, granite) == 8
    assert moe_lib.capacity(5, granite) == 8


# -------------------- the model ------------------------------------- #
def _pair(name, param_store):
    jcfg = CONFIGS[name](JAX_ARCHS)
    pcfg = CONFIGS[name](ARCHS)
    jparams = _seeded_norms(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return jcfg, pcfg, jparams, tparams


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_pair(request, param_store):
    """(jax cfg, port cfg, JAX params with seeded RMS scales, the port's
    params carried across)."""
    return _pair(request.param, param_store)


@pytest.fixture(scope="module")
def granite(param_store):
    return _pair("granite", param_store)


def _seeded_norms(params):
    params = dict(params)
    rng = np.random.default_rng(5)
    layers = dict(params["layers"])
    for name in ("ln1", "ln2"):
        layers[name] = jnp.asarray(rng.normal(0.0, 0.5, layers[name].shape),
                                   jnp.float32)
    params["layers"] = layers
    params["final_norm"] = jnp.asarray(
        rng.normal(0.0, 0.5, params["final_norm"].shape), jnp.float32)
    return params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def test_moe_params_are_jax_shaped(model_pair):
    """The stacked expert leaves and an f32 router, also in a bf16 model,
    and no dense `mlp`."""
    jcfg, pcfg, jparams, tparams = model_pair
    want = {k: tuple(v.shape) for k, v in jparams["layers"]["moe"].items()}
    e, d, f, n = pcfg.moe.num_experts, pcfg.d_model, pcfg.d_ff, \
        pcfg.n_layers
    assert want == {"router": (n, d, e), "wi": (n, e, 2, d, f),
                    "wo": (n, e, f, d)}
    assert {k: tuple(v.shape) for k, v in
            tparams["layers"]["moe"].items()} == want
    bf16 = build(dataclasses.replace(pcfg, dtype="bf16"), "cpu").init(
        torch.Generator().manual_seed(0))
    assert "mlp" not in bf16["layers"]
    assert {k: tuple(v.shape) for k, v in bf16["layers"]["moe"].items()} \
        == want
    assert bf16["layers"]["moe"]["router"].dtype == torch.float32
    assert bf16["layers"]["moe"]["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_forward_matches_jax(model_pair, impl):
    jcfg, pcfg, jparams, tparams = model_pair
    toks = _tokens(pcfg, 2, 40, 1)
    want, _, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(toks))
    got = tf.forward(tparams, pcfg, _t(toks).long(), impl=impl)
    assert tuple(got.shape) == want.shape == (2, 40, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_prefill_lengths_matches_jax(model_pair):
    """Right-padded rows in a bucket of 32: the capacity is the bucket's,
    and a pad never takes a real token's slot."""
    jcfg, pcfg, jparams, tparams = model_pair
    toks = _tokens(pcfg, 3, 32, 3)
    lengths = np.array([32, 19, 5], np.int32)
    want_last, want_cache, want_pos = jax_tf.prefill(
        jparams, jcfg, jnp.asarray(toks), lengths=jnp.asarray(lengths))
    got_last, got_cache, got_pos = tf.prefill(
        tparams, pcfg, _t(toks).long(), lengths=_t(lengths))
    np.testing.assert_array_equal(got_pos.numpy(), _np(want_pos))
    np.testing.assert_allclose(got_last.numpy(), _np(want_last), rtol=TOL,
                               atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_cache[name].numpy(),
                                   _np(want_cache[name]), rtol=TOL,
                                   atol=TOL)


def _decode_setup(jcfg, pcfg, jparams, tparams, cache_len):
    """Both packages' prefill of 2 rows of 24 tokens into a cache of
    `cache_len` positions, and 12 next tokens from a seed."""
    toks = _tokens(pcfg, 2, 24, 4)
    _, jcache, jpos = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     cache_len=cache_len)
    _, rows, pos = tf.prefill(tparams, pcfg, _t(toks).long())
    shape = (pcfg.n_layers, 2, cache_len, pcfg.n_kv_heads, pcfg.head_dim)
    cache = {}
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape)
        cache[name][:, :, :rows[name].shape[2]] = rows[name]
    nxt = _tokens(pcfg, 12, 2, 6)
    return jcache, jpos + 1, cache, pos + 1, nxt


def test_decode_step_matches_jax(model_pair):
    jcfg, pcfg, jparams, tparams = model_pair
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, 48)
    for tok in nxt:
        want, jcache = _jax_decode(jparams, jcfg, jcache, jnp.asarray(tok),
                                   jpos)
        got, cache = tf.decode_step(tparams, pcfg, cache, _t(tok), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        jpos, pos = jpos + 1, pos + 1


def test_decode_step_paged_matches_jax(model_pair):
    """Each package's pool: the contiguous caches cut into pages of 8
    (permuted), one scratch page past them in the port's."""
    jcfg, pcfg, jparams, tparams = model_pair
    cache_len, ps = 48, 8
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, cache_len)
    pps = cache_len // ps
    n_pages = 2 * pps + 3
    perm = np.random.default_rng(7).permutation(n_pages)[:2 * pps]
    table = perm.reshape(2, pps).astype(np.int32)
    tail = (pcfg.n_kv_heads, pcfg.head_dim)
    jpools, pools = {}, {}
    for name in ("k", "v"):
        rows = cache[name].reshape(pcfg.n_layers, 2 * pps, ps, *tail)
        pool = torch.zeros((pcfg.n_layers, n_pages + 1, ps) + tail)
        pool[:, torch.from_numpy(perm).long()] = rows
        pools[name] = pool
        jpools[name] = jnp.asarray(pool[:, :n_pages].numpy())
    jt, tt = jnp.asarray(table), _t(table)
    for tok in nxt:
        want, jpools = _jax_decode_paged(
            jparams, jcfg, jpools, jnp.asarray(tok), jpos, jt, jt)
        got, pools = tf.decode_step_paged(tparams, pcfg, pools, _t(tok),
                                          pos, tt, tt)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        jpos, pos = jpos + 1, pos + 1


def test_prefill_suffix_matches_jax(granite):
    """granite (no window): rows at offsets 0, 8 and 40 of 48-position
    views, a suffix bucket of 16 (capacity 10 against the prefill's):
    logits, positions and every cache entry equal JAX's."""
    jcfg, cfg, jparams, tparams = granite
    rng = np.random.default_rng(1)
    s_view, bucket = 48, 16
    offsets = np.array([0, 8, 40], np.int32)
    lengths = np.array([5, 16, 8], np.int32)
    tokens = rng.integers(0, cfg.vocab, (3, bucket)).astype(np.int32)
    shape = (cfg.n_layers, 3, s_view, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    jl, jc, jpos = jax_tf.prefill_suffix(
        jparams, jcfg, {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(tokens), jnp.asarray(offsets), jnp.asarray(lengths))
    view = {n: _t(a) for n, a in cache.items()}
    logits, out, pos = tf.prefill_suffix(
        tparams, cfg, view, _t(tokens).long(), _t(offsets), _t(lengths))
    assert out is view
    np.testing.assert_allclose(logits.numpy(), _np(jl), atol=TOL, rtol=TOL)
    assert pos.tolist() == _np(jpos).tolist()
    for n in ("k", "v"):
        np.testing.assert_allclose(view[n].numpy(), _np(jc[n]), atol=TOL,
                                   rtol=TOL)


def test_spec_verify_paged_matches_jax(granite):
    """Q = 5 tokens a row through the paged pool (capacity 3 at E 4,
    top-2: the verify can drop pairs): logits and every pool entry equal
    JAX's (the port's scratch page aside)."""
    jcfg, cfg, jparams, tparams = granite
    rng = np.random.default_rng(3)
    b, qn, ps, pps, n_pages = 3, 5, 8, 6, 24
    pos = np.array([3, 17, 40], np.int32)
    table = np.full((b, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos + qn - 1):
        for j in range(min(p // ps + 1, pps)):
            table[i, j] = next(free)
    wtable = table.copy()
    wtable[0, 0] = n_pages                     # a shared page, masked
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    tokens = rng.integers(0, cfg.vocab, (b, qn)).astype(np.int32)
    with moe_lib.keep_masks() as log:
        logits, out = tf.spec_verify_paged(
            tparams, cfg, {n: torch.cat([_t(a), torch.zeros_like(_t(
                a[:, :1]))], dim=1) for n, a in pools.items()},
            _t(tokens), _t(pos), _t(table), _t(wtable))
    jl, jc = jax_tf.spec_verify_paged(
        jparams, jcfg, {n: jnp.asarray(a) for n, a in pools.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(table),
        jnp.asarray(wtable))
    assert [m.shape for m in log] == [(b, qn * 2)] * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), _np(jl), atol=TOL, rtol=TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(out[n][:, :-1].numpy(), _np(jc[n]),
                                   atol=TOL, rtol=TOL)


def test_windowed_moe_refuses_suffix_and_verify(param_store):
    """mixtral's window: refused by both, as in JAX."""
    _, pcfg, _, tparams = _pair("mixtral", param_store)
    assert pcfg.swa_window
    with pytest.raises(NotImplementedError, match="plain causal"):
        tf.prefill_suffix(tparams, pcfg, {}, torch.zeros(1, 2).long(),
                          torch.zeros(1).long(), torch.ones(1).long())
    with pytest.raises(NotImplementedError, match="plain causal"):
        tf.spec_verify_paged(tparams, pcfg, {}, torch.zeros(1, 2).long(),
                             torch.zeros(1).long(), None, None)


# -------------------- the engine ------------------------------------ #
MODES = {"paged_attention": dict(paged_attention=True), "gather": {},
         "contiguous": dict(paged=False)}
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "tokens", "steps", "logical_bytes_moved", "paged",
            "paged_attention", "speculative", "suffix_prefills",
            "suffix_traces", "spec_dispatches", "spec_emitted",
            "prefill_dispatch_tokens", "preemptions")
BASE = dict(n_slots=4, max_len=64, page_size=8)
SHARED = list(range(1, 25))            # 24 tokens = 3 pages at size 8


def _work(req_cls, sp_cls, cfg, kind):
    """"mixed": prompts of 20-50 tokens (past mixtral's window of 16),
    budgets 3-10, submitted at once.  "prefix": prompts sharing SHARED,
    served one at a time so each later one hits the cache.  "repeat":
    short prompts whose greedy streams repeat (speculation accepts)."""
    if kind == "prefix":
        prompts, budgets = [SHARED + [30, 31], SHARED + [40, 41, 42],
                            SHARED[:12] + [7], SHARED + [9]], (8,) * 4
    elif kind == "repeat":
        prompts = [list(range(1, 2 + i)) for i in range(5)]
        budgets = tuple(12 + i for i in range(5))
    else:
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, cfg.vocab, n).tolist()
                   for n in (20, 33, 41, 50, 27)]
        budgets = (9, 4, 10, 3, 8)
    return [req_cls(model="m", prompt=p, sampling=sp_cls(max_tokens=m))
            for p, m in zip(prompts, budgets)]


def _serve(eng, reqs, serial):
    for r in reqs:
        assert eng.submit(r)
        if serial:
            eng.run_until_done()
    eng.run_until_done()
    st = eng.perf_stats()
    return [tuple(r.output) for r in reqs], {c: st[c] for c in COUNTERS}


@pytest.fixture(scope="module")
def jax_engine_runs(param_store):
    """JAX's (tokens, counters) per (config, workload, EngineConfig),
    each engine run once for the module."""
    memo = {}

    def run(name, kind, **kw):
        key = (name, kind, tuple(sorted(kw.items())))
        if key not in memo:
            jcfg, _, jparams, _ = _pair(name, param_store)
            eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**BASE, **kw))
            memo[key] = _serve(eng, _work(JaxRequest, JaxSampling, jcfg,
                                          kind), kind == "prefix")
        return memo[key]
    return run


def _port(name, param_store, kind, **kw):
    _, pcfg, _, tparams = _pair(name, param_store)
    eng = InferenceEngine(pcfg, tparams, EngineConfig(**BASE, **kw),
                          device="cpu")
    out = _serve(eng, _work(Request, SamplingParams, pcfg, kind),
                 kind == "prefix")
    eng.flush_prefix_cache()
    assert eng.pool.pages_in_use == 0
    return out, eng


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_granite_engine_matches_jax(jax_engine_runs, param_store, mode, k):
    want = jax_engine_runs("granite", "mixed", decode_block=k,
                           **MODES[mode])
    (toks, counters), _ = _port("granite", param_store, "mixed",
                                decode_block=k, **MODES[mode])
    assert (toks, counters) == want
    assert sum(len(t) for t in toks) == 34


@pytest.mark.parametrize("mode", ["contiguous", "gather"])
def test_mixtral_engine_matches_jax(jax_engine_runs, param_store, mode):
    """The paged-attention mode: below, with the prefix cache and
    speculation requested."""
    want = jax_engine_runs("mixtral", "mixed", decode_block=4,
                           **MODES[mode])
    (toks, counters), _ = _port("mixtral", param_store, "mixed",
                                decode_block=4, **MODES[mode])
    assert (toks, counters) == want


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_engine_matches_jax(jax_engine_runs, param_store,
                                      quantize):
    """int8: the attention projections and the tied head through the
    int8 kernel's plain version, the experts int8 at rest and dequantized
    a layer at a time, the router once; int4: the whole tree per
    dispatch (the 5-D `wi` packed along L)."""
    want = jax_engine_runs("granite", "mixed", decode_block=4,
                           quantize=quantize)
    (toks, counters), _ = _port("granite", param_store, "mixed",
                                decode_block=4, quantize=quantize)
    assert (toks, counters) == want


def test_granite_prefix_cache_matches_jax(jax_engine_runs, param_store):
    """The prefix cache stays on for a plain causal MoE, as in JAX: each
    suffix admission runs the FFN at its suffix bucket's capacity."""
    kw = dict(decode_block=4, prefix_cache=True, paged_attention=True)
    want = jax_engine_runs("granite", "prefix", **kw)
    (toks, counters), eng = _port("granite", param_store, "prefix", **kw)
    assert (toks, counters) == want
    assert counters["suffix_prefills"] >= 2
    assert eng.prefix_cache is not None


def test_granite_speculation_matches_jax(jax_engine_runs, param_store):
    """Speculation stays on for a plain causal MoE, as in JAX.  Held to
    JAX with speculation on, not to a run without it: the verify's D + 1
    tokens get capacity 3 at E 4, top-2, and may drop pairs a decode
    step keeps."""
    kw = dict(decode_block=4, paged_attention=True, speculative=True)
    want = jax_engine_runs("granite", "repeat", **kw)
    (toks, counters), _ = _port("granite", param_store, "repeat", **kw)
    assert (toks, counters) == want
    assert counters["speculative"] and counters["spec_dispatches"] >= 1


def test_mixtral_prefix_cache_and_speculation_stay_off(jax_engine_runs,
                                                       param_store):
    kw = dict(decode_block=4, paged_attention=True, prefix_cache=True,
              speculative=True)
    want = jax_engine_runs("mixtral", "mixed", **kw)
    (toks, counters), eng = _port("mixtral", param_store, "mixed", **kw)
    assert (toks, counters) == want
    assert eng.prefix_cache is None and not counters["speculative"]
    assert counters["suffix_prefills"] == counters["spec_dispatches"] == 0


def test_int8_expert_leaves_stay_int8(granite):
    """`int8_operands` keeps the experts' q (shared, not copied) and
    scale, dequantizes the router once to f32 (JAX's value), and the
    model's dequantization of one layer equals `dequantize_array`'s
    slice.  At rest, and as the engine runs them, the int8 weights stay
    under 0.65x the bf16 model's bytes."""
    _, cfg, _, tparams = granite
    qtree = q_lib.quantize_tree(tparams, 8)
    ops = q_lib.int8_operands(qtree)
    for name in ("wi", "wo"):
        leaf = ops["layers"]["moe"][name]
        assert q_lib.is_quantized_leaf(leaf) and "col" not in leaf
        assert leaf["__q__"] is qtree["layers"]["moe"][name]["__q__"]
        assert leaf["__q__"].dtype == torch.int8
        full = q_lib.dequantize_array(leaf)
        for i in range(cfg.n_layers):
            assert torch.equal(tf._dense(tf._index(leaf, i)), full[i])
    router = ops["layers"]["moe"]["router"]
    assert isinstance(router, torch.Tensor) and router.dtype == torch.float32
    assert torch.equal(router, q_lib.dequantize_array(
        qtree["layers"]["moe"]["router"]))
    bf16_cfg = ARCHS["granite-moe-3b-a800m"].reduced(n_kv_heads=2)
    params = build(bf16_cfg, "cpu").init(torch.Generator().manual_seed(0))
    dense = InferenceEngine(bf16_cfg, params, EngineConfig(**BASE),
                            device="cpu")
    eng = InferenceEngine(bf16_cfg, params, EngineConfig(
        **BASE, quantize="int8"), device="cpu")
    bf16_bytes = dense.memory_report()["param_bytes"]
    # the router counts 4 bytes a value, where the placement charge
    # (ArchConfig.param_bytes) counts the model dtype's 2 (ROADMAP C13)
    router = bf16_cfg.n_layers * bf16_cfg.d_model \
        * bf16_cfg.moe.num_experts
    assert bf16_bytes == bf16_cfg.param_bytes() + 2 * router
    assert eng.memory_report()["param_bytes"] < 0.65 * bf16_bytes
    assert q_lib.tree_bytes(eng._int8) < 0.65 * bf16_bytes
