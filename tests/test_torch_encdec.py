"""The encoder-decoder (seamless-m4t-large-v2's backbone) in the port
against the JAX package, on the CPU through the kernels' plain versions
(JAX's Pallas kernels run as its own CPU tests run them).

Config: the reduced seamless-m4t-large-v2 in f32 (4 decoder layers, 2
encoder layers, d 64, 4 heads over 4 KV heads, gelu, untied head).
JAX's initialised params are carried across with `from_jax`, their
RMS-norm scales (ln1, ln2, lnx, the encoder's, final_norm) drawn from a
numpy seed first (the init leaves them 0).

The model-level tests feed seeded random `src_embeds`, so the encoder's
output and the cross K/V are not 0.  The engine feeds zeros, as JAX's
does, under which they are exactly 0 (ROADMAP.md C17): engine parity
holds the decoder, the plumbing of the slot-resident cross K/V and the
counters, not the cross path's values.

Tolerances: logits, KV, cross KV and the encoder's output 2e-5 (another
order of the same f32 products).  Engines: greedy tokens and the
dispatch / host-sync / program / KV-byte / swap counters equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.models import build
from repro_torch.models import transformer as tf
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)

torch.set_num_threads(2)

TOL = 2e-5
NAME = "seamless-m4t-large-v2"


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _seeded(params, seed=5):
    """Every RMS-norm scale from a seed (the init leaves them at 0)."""
    rng = np.random.default_rng(seed)
    params = dict(params)
    for stack, names in (("layers", ("ln1", "ln2", "lnx")),
                         ("enc_layers", ("ln1", "ln2"))):
        layers = dict(params[stack])
        for name in names:
            layers[name] = jnp.asarray(
                rng.normal(0.0, 0.5, layers[name].shape), jnp.float32)
        params[stack] = layers
    params["final_norm"] = jnp.asarray(
        rng.normal(0.0, 0.5, params["final_norm"].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def pair(param_store):
    """(jax cfg, port cfg, JAX params with seeded norms, the port's
    params carried across)."""
    jcfg = JAX_ARCHS[NAME].reduced(dtype="f32", name=f"{NAME}-reduced-f32")
    pcfg = ARCHS[NAME].reduced(dtype="f32", name=f"{NAME}-reduced-f32")
    jparams = _seeded(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return jcfg, pcfg, jparams, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _src(cfg, b, s, seed=21):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# -------------------- params ---------------------------------------- #
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_are_jax_shaped(pair, param_store):
    """init_params draws JAX's leaves in JAX's shapes and dtypes: the
    decoder's cross-attention and its lnx, the encoder stack; from_jax
    carries every leaf across unchanged."""
    jcfg, pcfg, jparams, tparams = pair
    raw = param_store(jcfg)
    want = {p: (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _leaves(jax.tree.map(np.asarray, raw))}
    got = build(pcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _leaves(got)} == want
    assert ("layers", "xattn", "wq") in want and ("layers", "lnx") in want
    assert ("enc_layers", "attn", "wo") in want
    assert "xattn" not in got["enc_layers"]
    for p, x in _leaves(jax.tree.map(np.asarray, jparams)):
        leaf = tparams
        for k in p:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), x)


def test_full_seamless_builds():
    """The full config builds: its tree on the meta device holds the
    config's 1,632,130,048 parameters (24 + 24 layers, vocab 256206)."""
    cfg = ARCHS[NAME]
    assert build(cfg, "cpu").cfg is cfg
    tree = params_lib.init_params(cfg, None, torch.device("meta"))
    assert tuple(tree["enc_layers"]["mlp"]["wi"].shape) == (24, 1024, 8192)
    assert tuple(tree["layers"]["xattn"]["wk"].shape) == (24, 1024, 16, 64)
    assert tuple(tree["lm_head"].shape) == (1024, 256206)
    # the config's count (norm scales included) is the tree's exactly
    assert sum(x.numel() for _, x in _leaves(tree)) == cfg.num_params() \
        == 1_632_130_048


# -------------------- the model ------------------------------------- #
@pytest.mark.parametrize("impl", ["flash", "full"])
def test_encoder_matches_jax(pair, impl):
    """The encoder over random frames: non-causal self-attention with
    RoPE, the FFN, the decoder's final norm."""
    jcfg, pcfg, jparams, tparams = pair
    src = _src(pcfg, 2, 19)
    want = jax_tf._run_encoder(jparams, jcfg, jnp.asarray(src),
                               jax_tf._id_sh)
    got = tf._run_encoder(tparams, pcfg, _t(src), impl)
    assert float(np.abs(_np(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_forward_matches_jax(pair, impl):
    """Logits of 14 tokens over 19 random frames (the cross-attention
    with Sq != Skv)."""
    jcfg, pcfg, jparams, tparams = pair
    toks, src = _tokens(pcfg, 2, 14, 1), _src(pcfg, 2, 19)
    want, _, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(toks),
                                src_embeds=jnp.asarray(src))
    got = tf.forward(tparams, pcfg, _t(toks).long(), impl=impl,
                     src_embeds=_t(src))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    # the cross path weighs: other frames, other logits
    other = tf.forward(tparams, pcfg, _t(toks).long(), impl=impl,
                       src_embeds=_t(src) * 0)
    assert float((other - got).abs().max()) > 1e-3


def test_forward_needs_src_embeds(pair):
    _, pcfg, _, tparams = pair
    with pytest.raises(ValueError, match="src_embeds"):
        tf.forward(tparams, pcfg, torch.zeros(1, 3).long())


def test_prefill_matches_jax(pair):
    """Bucketed prefill (lengths 9 and 14 in a bucket of 14): last logits,
    pos, the self KV and each layer's cross K/V over 19 frames."""
    jcfg, pcfg, jparams, tparams = pair
    toks, src = _tokens(pcfg, 2, 14, 2), _src(pcfg, 2, 19, seed=22)
    lengths = np.asarray([9, 14], np.int32)
    wl, wc, wp = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                src_embeds=jnp.asarray(src),
                                lengths=jnp.asarray(lengths))
    gl, gc, gp = tf.prefill(tparams, pcfg, _t(toks).long(),
                            lengths=_t(lengths), src_embeds=_t(src))
    np.testing.assert_array_equal(gp.numpy(), _np(wp))
    np.testing.assert_allclose(gl.numpy(), _np(wl), rtol=TOL, atol=TOL)
    assert tuple(gc["ck"].shape) == (pcfg.n_layers, 2, 19, pcfg.n_kv_heads,
                                     pcfg.head_dim)
    for name in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(gc[name].numpy(), _np(wc[name]),
                                   rtol=TOL, atol=TOL)
    assert float(gc["ck"].abs().max()) > 0.1


def _decode_setup(jcfg, pcfg, jparams, tparams, cache_len):
    """Both packages' prefill of 2 rows of 10 tokens over 19 random
    frames into a cache of `cache_len` positions (the cross K/V beside
    it), and 4 next tokens from a seed."""
    toks, src = _tokens(pcfg, 2, 10, 5), _src(pcfg, 2, 19, seed=23)
    _, jcache, jpos = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     src_embeds=jnp.asarray(src),
                                     cache_len=cache_len)
    _, rows, pos = tf.prefill(tparams, pcfg, _t(toks).long(),
                              src_embeds=_t(src))
    shape = (pcfg.n_layers, 2, cache_len, pcfg.n_kv_heads, pcfg.head_dim)
    cache = {"ck": rows["ck"].clone(), "cv": rows["cv"].clone()}
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape)
        cache[name][:, :, :rows[name].shape[2]] = rows[name]
    return jcache, jpos + 1, cache, pos + 1, _tokens(pcfg, 4, 2, 6)


def test_decode_step_matches_jax(pair):
    """Four decode steps against a contiguous cache: the cross-attention
    through the decode kernel's plain version over the resident cross
    K/V."""
    jcfg, pcfg, jparams, tparams = pair
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, 24)
    for tok in nxt:
        want, jcache = jax_tf.decode_step(jparams, jcfg, jcache,
                                          jnp.asarray(tok), jpos)
        got, cache = tf.decode_step(tparams, pcfg, cache, _t(tok), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        jpos, pos = jpos + 1, pos + 1


def test_decode_step_paged_matches_jax(pair):
    """Four decode steps against each package's pool (the contiguous
    caches cut into pages of 8, permuted; a scratch page past them in the
    port's), the cross K/V slot-resident beside them."""
    jcfg, pcfg, jparams, tparams = pair
    cache_len, ps = 24, 8
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, cache_len)
    pps = cache_len // ps
    n_pages = 2 * pps + 3
    perm = np.random.default_rng(7).permutation(n_pages)[:2 * pps]
    table = perm.reshape(2, pps).astype(np.int32)
    tail = (pcfg.n_kv_heads, pcfg.head_dim)
    jpools = {"ck": jcache["ck"], "cv": jcache["cv"]}
    pools = {"ck": cache["ck"], "cv": cache["cv"]}
    for name in ("k", "v"):
        rows = cache[name].reshape(pcfg.n_layers, 2 * pps, ps, *tail)
        pool = torch.zeros((pcfg.n_layers, n_pages + 1, ps) + tail)
        pool[:, torch.from_numpy(perm).long()] = rows
        pools[name] = pool
        jpools[name] = jnp.asarray(pool[:, :n_pages].numpy())
    jt, tt = jnp.asarray(table), _t(table)
    for tok in nxt:
        want, jpools = jax_tf.decode_step_paged(
            jparams, jcfg, jpools, jnp.asarray(tok), jpos, jt, jt)
        got, pools = tf.decode_step_paged(tparams, pcfg, pools, _t(tok),
                                          pos, tt, tt)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        jpos, pos = jpos + 1, pos + 1


def test_suffix_prefill_and_verify_refuse_encdec(pair):
    _, pcfg, _, tparams = pair
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
            "paged_attention", "suffix_prefills", "spec_dispatches",
            "prefill_dispatch_tokens", "preemptions", "swap_outs",
            "swap_ins")
BASE = dict(n_slots=4, max_len=48, page_size=8)
LENS, BUDGETS = (5, 9, 5, 12, 3), (9, 4, 10, 3, 8)


def _work(req_cls, sp_cls, cfg, lens=LENS, budgets=BUDGETS, seed=9):
    rng = np.random.default_rng(seed)
    return [req_cls(model="m", prompt=rng.integers(0, cfg.vocab, n)
                    .tolist(), sampling=sp_cls(max_tokens=m))
            for n, m in zip(lens, budgets)]


def _run(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done()
    return [tuple(r.output) for r in reqs]


def _both(jcfg, pcfg, jparams, tparams, work=_work, **kw):
    """(tokens, counters) of the JAX engine and of the port's on the same
    work and EngineConfig, and the port's engine."""
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**{**BASE, **kw}))
    jtoks = _run(jeng, work(JaxRequest, JaxSampling, jcfg))
    eng = InferenceEngine(pcfg, tparams, EngineConfig(**{**BASE, **kw}),
                          device="cpu")
    toks = _run(eng, work(Request, SamplingParams, pcfg))
    assert eng.pool.pages_in_use == 0
    jst, st = jeng.perf_stats(), eng.perf_stats()
    return ((jtoks, {c: jst[c] for c in COUNTERS}),
            (toks, {c: st[c] for c in COUNTERS}), eng)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(pair, mode, k):
    """Greedy tokens and counters equal JAX's at K = 1, 4, 8 in the three
    decode modes; prompts are bucketed; the cross K/V sit slot-resident
    beside the pools or strips, (L, n_slots, max_len, K, hd)."""
    jax_side, port_side, eng = _both(*pair, decode_block=k, **MODES[mode])
    assert port_side == jax_side
    assert sum(len(t) for t in port_side[0]) == sum(BUDGETS)
    _, pcfg, _, _ = pair
    assert tuple(eng.cache["ck"].shape) == (
        pcfg.n_layers, BASE["n_slots"], BASE["max_len"], pcfg.n_kv_heads,
        pcfg.head_dim)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_engine_quantized_matches_jax(pair, quantize):
    jax_side, port_side, _ = _both(*pair, decode_block=4, quantize=quantize)
    assert port_side == jax_side


@pytest.mark.parametrize("mode", ["paged_attention", "gather"])
def test_prefix_cache_and_speculation_stay_off(pair, mode):
    """Requested, the prefix cache and speculation stay off for the
    encoder-decoder, as in JAX."""
    jax_side, port_side, eng = _both(*pair, decode_block=4,
                                     prefix_cache=True, speculative=True,
                                     **MODES[mode])
    assert port_side == jax_side
    assert eng.prefix_cache is None
    assert not eng.perf_stats()["speculative"]


def _swap_work(req_cls, sp_cls, cfg):
    """Four requests whose decode growth runs a 12-page pool dry."""
    return _work(req_cls, sp_cls, cfg, lens=(10, 12, 9, 11),
                 budgets=(30, 30, 30, 30), seed=3)


SWAP = dict(n_slots=4, max_len=48, page_size=8, kv_pages=12,
            decode_block=4, paged_attention=True)


def test_swap_tier_matches_jax(pair):
    """JAX's host tier is on for this paged family: under page pressure a
    slot is swapped out and back in on both sides with the same tokens
    and counters, which equal the run without the tier (the port's
    handle carries the slot's cross K/V rows; JAX's leaves them, and
    they are 0 either way: C17)."""
    jcfg, pcfg, jparams, tparams = pair
    plain_j, plain_p, _ = _both(jcfg, pcfg, jparams, tparams,
                                work=_swap_work, **SWAP)
    swap_j, swap_p, eng = _both(jcfg, pcfg, jparams, tparams,
                                work=_swap_work, host_kv_pages=64, **SWAP)
    assert plain_p == plain_j and plain_p[1]["preemptions"] >= 1
    assert swap_p == swap_j and swap_p[1]["swap_outs"] >= 1
    assert swap_p[0] == plain_p[0]
    assert eng.perf_stats()["host_pages_in_use"] == 0


def test_swap_carries_nonzero_cross_kv_rows(pair):
    """The swap handle carries a slot's cross K/V rows bit for bit.  The
    engine's own rows are 0 (C17), so the slot is given the rows of a
    prefill over random frames; a forced swap-out, the vacated slot's
    rows zeroed, and the swap-in resume leave the request's new slot
    holding those rows and every other slot's rows untouched."""
    _, pcfg, _, tparams = pair
    eng = InferenceEngine(pcfg, tparams, EngineConfig(
        **{**BASE, **SWAP, "host_kv_pages": 64}), device="cpu")
    reqs = _swap_work(Request, SamplingParams, pcfg)[:2]
    for r in reqs:
        assert eng.submit(r)
    eng.step()
    assert len(eng.slot_req) == 2
    slot, req = min(eng.slot_req.items())
    _, cache, _ = tf.prefill(tparams, pcfg, _t(_tokens(pcfg, 1, 6, 4)).long(),
                             src_embeds=_t(_src(pcfg, 1, BASE["max_len"],
                                                seed=23)))
    rows = {n: cache[n][:, 0].clone() for n in ("ck", "cv")}
    assert all(float(x.abs().max()) > 0.1 for x in rows.values())
    for n, x in rows.items():
        eng.cache[n][:, slot] = x
    others = {n: eng.cache[n].clone() for n in rows}
    eng._preempt(slot)
    assert eng.swap_outs == 1 and req.request_id in eng._swapped
    for n in rows:
        eng.cache[n][:, slot] = 0.0
        others[n][:, slot] = 0.0
    eng.step()
    assert eng.swap_ins == 1
    (new,) = [s for s, r in eng.slot_req.items() if r is req]
    for n, x in rows.items():
        assert torch.equal(eng.cache[n][:, new], x)
        rest = [s for s in range(BASE["n_slots"]) if s != new]
        assert torch.equal(eng.cache[n][:, rest], others[n][:, rest])


def test_c17_engine_cross_kv_is_zero(pair):
    """ROADMAP.md C17: both engines feed the encoder zero frames, so after
    an admission the cross K/V they hold are exactly 0 (while the model's
    prefill over random frames gives non-zero ones, see
    test_prefill_matches_jax): the cross-attention adds exactly 0."""
    jcfg, pcfg, jparams, tparams = pair
    kw = dict(BASE, decode_block=4, paged_attention=True)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw))
    eng = InferenceEngine(pcfg, tparams, EngineConfig(**kw), device="cpu")
    for e, req_cls, sp_cls in ((jeng, JaxRequest, JaxSampling),
                               (eng, Request, SamplingParams)):
        for r in _work(req_cls, sp_cls, pcfg)[:2]:
            assert e.submit(r)
        e.step()
        assert e.slot_req
    for name in ("ck", "cv"):
        assert float(np.abs(_np(jeng.cache[name])).max()) == 0.0
        assert float(eng.cache[name].abs().max()) == 0.0
    # the encoder and its K/V under zero frames: exactly 0
    src = tf.zero_src_embeds(pcfg, 1, 8, torch.device("cpu"))
    assert not tf._run_encoder(tparams, pcfg, src, "flash").any()
