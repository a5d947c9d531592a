"""The gelu FFN, the sliding window and the vision prefix tokens in the
port, against the JAX package, on the CPU through the kernels' plain
versions (JAX's Pallas kernels run as its own CPU tests run them).

Configs: the reduced gemma3-1b (gelu, window 16, 4 heads over 1 KV head:
G = 4) and gemma3-4b (gelu, window 16, 4 vision prefix tokens), in f32,
and a gemma3-4b with head_dim 256 and G = 2, so that hd 256 goes through
the plain versions too.  JAX's initialised params are carried across with
`from_jax`, their RMS-norm scales drawn from a numpy seed first (the init
leaves them 0).  Positions run past the window everywhere.

Tolerances: gelu 1e-6 in f32 (the same tanh formula in f32) and one bf16
ulp (2**-7 relative) in bf16; logits 2e-5 (matmuls and attention summed
in another order).  The engines' greedy tokens and dispatch / host-sync /
program / KV-byte counters must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ZOO as JAX_ZOO
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS, ZOO
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 RequestState, SamplingParams)
from repro_torch.serving.request import CODE_INVALID_REQUEST

torch.set_num_threads(2)

LOGIT_TOL = 2e-5

# its own name each: param_store caches by name
CONFIGS = {
    "gemma3-1b": lambda z: z["gemma3-1b"].reduced(
        dtype="f32", name="gemma3-1b-reduced-f32"),
    "gemma3-4b": lambda z: z["gemma3-4b"].reduced(
        dtype="f32", name="gemma3-4b-reduced-f32"),
    "gemma3-4b-hd256": lambda z: z["gemma3-4b"].reduced(
        dtype="f32", head_dim=256, n_kv_heads=2,
        name="gemma3-4b-reduced-hd256-f32"),
}
ENGINE_CONFIGS = ("gemma3-1b", "gemma3-4b")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# -------------------- gelu ------------------------------------------ #
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2.0 ** -7)])
def test_gelu_matches_jax_tanh_form(dtype, tol):
    x = np.random.default_rng(0).normal(0.0, 3.0, 4096).astype(np.float32)
    x = np.concatenate([x, [-6.0, -3.0, -1.0, 0.0, 0.5, 2.0, 8.0]])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.nn.gelu(jnp.asarray(x, jdt).astype(jnp.float32)).astype(jdt)
    got = L.gelu(torch.from_numpy(x).to(dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_gelu_is_not_the_erf_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's default is
    the exact erf form, which misses JAX by far more than 1e-6."""
    x = np.array([-3.0, -2.0, 1.5, 2.5], np.float32)
    want = _np(jax.nn.gelu(jnp.asarray(x)))
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


# -------------------- the model ------------------------------------- #
@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_pair(request, param_store):
    """(jax cfg, port cfg, JAX params with seeded RMS scales, the port's
    params carried across)."""
    jcfg = CONFIGS[request.param](JAX_ZOO)
    pcfg = CONFIGS[request.param](ZOO)
    jparams = _seeded_norms(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return jcfg, pcfg, jparams, tparams


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


def _inputs(cfg, b, s, seed):
    """Token ids (B, S) and, for a vision model, prefix embeddings drawn
    from a seed (not zeros: the prefix rows must matter)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pe = None
    if cfg.n_prefix_tokens:
        pe = rng.normal(0.0, 1.0, (b, cfg.n_prefix_tokens, cfg.d_model)) \
            .astype(np.float32)
    return toks, pe


def test_gelu_params_are_jax_shaped(model_pair):
    jcfg, pcfg, jparams, tparams = model_pair
    assert pcfg.act == "gelu"
    want = tuple(jparams["layers"]["mlp"]["wi"].shape)
    assert want == (pcfg.n_layers, pcfg.d_model, pcfg.d_ff)
    assert tuple(tparams["layers"]["mlp"]["wi"].shape) == want
    got = build(pcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert tuple(got["layers"]["mlp"]["wi"].shape) == want


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_forward_matches_jax(model_pair, impl):
    jcfg, pcfg, jparams, tparams = model_pair
    toks, pe = _inputs(pcfg, 2, 40, 1)
    want, _, _ = jax_tf.forward(
        jparams, jcfg, jnp.asarray(toks),
        prefix_embeds=None if pe is None else jnp.asarray(pe))
    got = tf.forward(tparams, pcfg, _t(toks).long(), impl=impl,
                     prefix_embeds=None if pe is None else _t(pe))
    assert tuple(got.shape) == want.shape == (
        2, 40 + pcfg.n_prefix_tokens, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_window_bites(model_pair):
    """Past the window the logits are not those of plain causal attention:
    the window is on."""
    import dataclasses
    jcfg, pcfg, jparams, tparams = model_pair
    toks, pe = _inputs(pcfg, 1, 40, 2)
    kw = dict(impl="full", prefix_embeds=None if pe is None else _t(pe))
    windowed = tf.forward(tparams, pcfg, _t(toks).long(), **kw)
    plain = tf.forward(tparams, dataclasses.replace(pcfg, swa_window=0),
                       _t(toks).long(), **kw)
    w = pcfg.swa_window + pcfg.n_prefix_tokens
    assert torch.equal(windowed[:, :w], plain[:, :w])
    assert (windowed[:, w:] - plain[:, w:]).abs().max() > 1e-3


def test_prefill_lengths_matches_jax(model_pair):
    jcfg, pcfg, jparams, tparams = model_pair
    toks, pe = _inputs(pcfg, 3, 32, 3)
    lengths = np.array([32, 19, 5], np.int32)
    want_last, want_cache, want_pos = jax_tf.prefill(
        jparams, jcfg, jnp.asarray(toks), lengths=jnp.asarray(lengths),
        prefix_embeds=None if pe is None else jnp.asarray(pe))
    got_last, got_cache, got_pos = tf.prefill(
        tparams, pcfg, _t(toks).long(), lengths=_t(lengths),
        prefix_embeds=None if pe is None else _t(pe))
    np.testing.assert_array_equal(got_pos.numpy(), _np(want_pos))
    assert got_pos.tolist() == [pcfg.n_prefix_tokens + n - 1
                                for n in lengths]
    np.testing.assert_allclose(got_last.numpy(), _np(want_last),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(got_cache[name].numpy(),
                                   _np(want_cache[name]), rtol=1e-5,
                                   atol=1e-5)


def _decode_setup(jcfg, pcfg, jparams, tparams, cache_len):
    """Both packages' prefill of 2 rows of 24 tokens into a cache of
    `cache_len` positions, and 12 next tokens from a seed."""
    toks, pe = _inputs(pcfg, 2, 24, 4)
    _, jcache, jpos = jax_tf.prefill(
        jparams, jcfg, jnp.asarray(toks), cache_len=cache_len,
        prefix_embeds=None if pe is None else jnp.asarray(pe))
    _, rows, pos = tf.prefill(tparams, pcfg, _t(toks).long(),
                              prefix_embeds=None if pe is None else _t(pe))
    shape = (pcfg.n_layers, 2, cache_len, pcfg.n_kv_heads, pcfg.head_dim)
    cache = {}
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape)
        cache[name][:, :, :rows[name].shape[2]] = rows[name]
    nxt = np.random.default_rng(6).integers(0, pcfg.vocab, (12, 2)) \
        .astype(np.int32)
    return jcache, jpos + 1, cache, pos + 1, nxt


def test_decode_step_matches_jax(model_pair):
    jcfg, pcfg, jparams, tparams = model_pair
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, 48)
    assert int(pos[0]) + len(nxt) > pcfg.swa_window + pcfg.n_prefix_tokens
    for tok in nxt:
        want, jcache = jax_tf.decode_step(jparams, jcfg, jcache,
                                          jnp.asarray(tok), jpos)
        got, cache = tf.decode_step(tparams, pcfg, cache, _t(tok), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
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
    jt = jnp.asarray(table)
    tt = _t(table)
    for tok in nxt:
        want, jpools = jax_tf.decode_step_paged(
            jparams, jcfg, jpools, jnp.asarray(tok), jpos, jt, jt)
        got, pools = tf.decode_step_paged(tparams, pcfg, pools, _t(tok),
                                          pos, tt, tt)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        jpos, pos = jpos + 1, pos + 1


def test_suffix_prefill_and_verify_refuse_these_families(model_pair):
    jcfg, pcfg, jparams, tparams = model_pair
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
            "paged_attention", "suffix_prefills", "spec_dispatches")
BASE = dict(n_slots=4, max_len=64, page_size=8)


@pytest.fixture(scope="module", params=ENGINE_CONFIGS)
def engine_pair(request, param_store):
    jcfg = CONFIGS[request.param](JAX_ZOO)
    pcfg = CONFIGS[request.param](ZOO)
    jparams = _seeded_norms(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return jcfg, pcfg, jparams, tparams


def _work(req_cls, sp_cls, cfg):
    """Prompts of 20-50 tokens (past the window of 16), budgets 3-10,
    every context inside max_len with the prefix."""
    rng = np.random.default_rng(9)
    lens, budgets = (20, 33, 41, 50, 27), (9, 4, 10, 3, 8)
    return [req_cls(model="m", prompt=rng.integers(0, cfg.vocab, n)
                    .tolist(), sampling=sp_cls(max_tokens=m))
            for n, m in zip(lens, budgets)]


def _run(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done()
    return [tuple(r.output) for r in reqs]


def _both(jcfg, pcfg, jparams, tparams, **kw):
    """(tokens, counters) of the JAX engine and of the port's on the same
    work and EngineConfig."""
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**BASE, **kw))
    jtoks = _run(jeng, _work(JaxRequest, JaxSampling, jcfg))
    eng = InferenceEngine(pcfg, tparams, EngineConfig(**BASE, **kw),
                          device="cpu")
    toks = _run(eng, _work(Request, SamplingParams, pcfg))
    assert eng.pool.pages_in_use == 0
    jst, st = jeng.perf_stats(), eng.perf_stats()
    return ((jtoks, {c: jst[c] for c in COUNTERS}),
            (toks, {c: st[c] for c in COUNTERS}))


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(engine_pair, mode, k):
    jax_side, port_side = _both(*engine_pair, decode_block=k, **MODES[mode])
    assert port_side == jax_side
    assert sum(len(t) for t in port_side[0]) == 34


@pytest.mark.parametrize("mode", ["paged_attention", "gather"])
def test_prefix_cache_and_speculation_stay_off(engine_pair, mode):
    """Requested, the prefix cache and speculation stay off for a window
    or prefix tokens, as in JAX: no suffix admission, no verify."""
    jax_side, port_side = _both(*engine_pair, decode_block=4,
                                prefix_cache=True, speculative=True,
                                **MODES[mode])
    assert port_side == jax_side
    assert port_side[1]["suffix_prefills"] == 0
    assert port_side[1]["spec_dispatches"] == 0
    pcfg, tparams = engine_pair[1], engine_pair[3]
    eng = InferenceEngine(pcfg, tparams, EngineConfig(
        **BASE, prefix_cache=True, speculative=True, **MODES[mode]),
        device="cpu")
    assert eng.prefix_cache is None
    assert not eng.perf_stats()["speculative"]


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_engine_matches_jax(engine_pair, quantize):
    """The gelu `wi` (L, d, f) quantizes per column and runs through the
    int8 kernel's plain version (int4: dequantized per dispatch)."""
    jax_side, port_side = _both(*engine_pair, decode_block=4,
                                quantize=quantize)
    assert port_side == jax_side


@pytest.mark.parametrize("name", ["internvl2-76b", "gemma3-4b"])
def test_vision_prefix_prompt_near_max_len(name):
    """tests/test_serving_fused.py::test_vision_prefix_prompt_near_max_len
    on the port: a prompt that only fits without its vision prefix is
    refused as invalid, one that fits decodes even where bucket rounding
    would overflow."""
    vcfg = (ARCHS if name in ARCHS else ZOO)[name].reduced()
    params = build(vcfg, "cpu").init(torch.Generator().manual_seed(0))
    eng = InferenceEngine(vcfg, params, EngineConfig(
        n_slots=2, max_len=24, decode_block=4), device="cpu")
    prefix = eng._prefix_tokens
    assert prefix == vcfg.n_prefix_tokens > 0
    ok = Request(model="v", prompt=list(range(24 - prefix)),
                 sampling=SamplingParams(max_tokens=2))
    _run(eng, [ok])
    assert ok.state == RequestState.FINISHED and len(ok.output) >= 1
    bad = Request(model="v", prompt=list(range(24 - prefix + 1)),
                  sampling=SamplingParams(max_tokens=2))
    assert not eng.submit(bad)
    assert bad.error_code == CODE_INVALID_REQUEST
    assert eng.pool.pages_in_use == 0


def test_vision_prefix_charges_pages_as_jax(param_store):
    """The prefix is charged in the page cost of a queued request and in
    the admission's allocation, as JAX's engine does."""
    jcfg = CONFIGS["gemma3-4b"](JAX_ZOO)
    pcfg = CONFIGS["gemma3-4b"](ZOO)
    jeng = JaxEngine(jcfg, param_store(jcfg), JaxEngineConfig(**BASE))
    eng = InferenceEngine(pcfg, build(pcfg, "cpu").init(
        torch.Generator().manual_seed(0)), EngineConfig(**BASE),
        device="cpu")
    for n in (1, 4, 12, 28, 59, 60):
        jr = JaxRequest(model="m", prompt=[1] * n)
        r = Request(model="m", prompt=[1] * n)
        assert eng._pages_for(r) == jeng._pages_for(jr)
        assert eng._bucket_of(n) == jeng._bucket_of(n)
    r = Request(model="m", prompt=[1] * 12,
                sampling=SamplingParams(max_tokens=30))
    assert eng.submit(r)
    eng.step()
    slot, = eng.slot_req
    assert eng.pool.lengths[slot] >= 12 + pcfg.n_prefix_tokens
    eng.run_until_done()


@pytest.mark.parametrize("k", [1, 8])
def test_embedding_family_engine_matches_jax(param_store, k):
    """nomic-embed-text (`family="embed"`, gelu, tied) builds and serves
    as the causal decoder `repro.models.build` makes of it: the reduced
    config's greedy tokens and counters equal JAX's."""
    jcfg = JAX_ZOO["nomic-embed-text"].reduced(
        dtype="f32", name="nomic-embed-text-reduced-f32")
    pcfg = ZOO["nomic-embed-text"].reduced(
        dtype="f32", name="nomic-embed-text-reduced-f32")
    assert pcfg.family == "embed" and pcfg.act == "gelu"
    jparams = _seeded_norms(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    jax_side, port_side = _both(jcfg, pcfg, jparams, tparams,
                                decode_block=k)
    assert port_side == jax_side
    assert sum(len(t) for t in port_side[0]) == 34
