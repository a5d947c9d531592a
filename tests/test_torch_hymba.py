"""Hymba's hybrid attention + SSM layer in the port, against the JAX
package, on the CPU through the kernels' plain versions (JAX's Pallas
kernels run as its own CPU tests run them).

Configs: the reduced hymba-1.5b in f32 (4 layers, layer 0 global and the
rest windowed at 16, 2 meta tokens, 4 heads over 4 KV heads: G = 1,
ssm_state 4) and the same with 2 KV heads (G = 2).  JAX's initialised
params are carried across with `from_jax`, their RMS-norm and branch-norm
scales and the branch mix `beta` drawn from a numpy seed first (the init
leaves them 0 and 1).

JAX's prefill collects the SSM states by re-running the stack with
every layer windowed (`repro/models/transformer.py:617-626`), which is
its own forward only while prompt + meta tokens <= window + 1: the
comparisons with JAX's prefill and engine stay there, and past it the
port is held to its own full forward (ROADMAP.md C15).  The swap tier's
handle carries the slot's SSM state, which JAX's leaves behind (C16).

Tolerances: the scan and the step 1e-5 (another order of the same f32
products); logits, KV and states 2e-5.  Engines: greedy tokens and the
dispatch / host-sync / program / KV-byte counters equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import paged_attention as jax_pa
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving import quantization as jax_q
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)
from repro_torch.serving import quantization as q_lib

torch.set_num_threads(2)

TOL = 2e-5
SCAN_TOL = 1e-5

# its own name each: param_store caches by name
CONFIGS = {
    "g1": lambda a: a["hymba-1.5b"].reduced(
        dtype="f32", name="hymba-1.5b-reduced-f32"),
    "g2": lambda a: a["hymba-1.5b"].reduced(
        dtype="f32", n_kv_heads=2, name="hymba-1.5b-reduced-kv2-f32"),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _seeded(params, seed=5):
    """Norm scales and the branch mix from a seed (the init leaves every
    norm at 0 and beta at 1, where they weigh nothing)."""
    rng = np.random.default_rng(seed)
    params = dict(params)
    layers = dict(params["layers"])
    for name in ("ln1", "ln2", "branch_norm_attn", "branch_norm_ssm"):
        layers[name] = jnp.asarray(
            rng.normal(0.0, 0.5, layers[name].shape), jnp.float32)
    layers["beta"] = jnp.asarray(rng.normal(1.0, 0.3, layers["beta"].shape),
                                 jnp.float32)
    params["layers"] = layers
    params["final_norm"] = jnp.asarray(
        rng.normal(0.0, 0.5, params["final_norm"].shape), jnp.float32)
    return params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, param_store):
    """(jax cfg, port cfg, JAX params with seeded norms, the port's
    params carried across)."""
    jcfg = CONFIGS[request.param](JAX_ARCHS)
    pcfg = CONFIGS[request.param](ARCHS)
    jparams = _seeded(param_store(jcfg))
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                  "cpu")
    return jcfg, pcfg, jparams, tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


# -------------------- the selective SSM ------------------------------ #
def _ssm_inputs(b, s, i, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, s, i)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, s, i))).astype(np.float32) * 0.1
    A = -np.abs(rng.normal(size=(i, n))).astype(np.float32)
    Bt = rng.normal(size=(b, s, n)).astype(np.float32)
    Ct = rng.normal(size=(b, s, n)).astype(np.float32)
    h0 = rng.normal(size=(b, i, n)).astype(np.float32)
    return u, dt, A, Bt, Ct, h0


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 8, 256])
def test_selective_scan_matches_jax_and_the_steps(chunk):
    """tests/test_ssm.py:97 on the port: the chunked doubling scan against
    JAX's chunked associative scan (at JAX's chunk, or the whole sequence
    where it does not divide) and against the per-timestep oracle, from
    a nonzero state."""
    args = _ssm_inputs(2, 24, 6, 4, 1)
    y, hf = ssm.selective_scan(*map(_t, args), chunk=chunk)
    jy, jh = jax_ssm.selective_scan(*map(jnp.asarray, args), chunk=chunk)
    ry, rh = ssm.selective_scan_ref(*map(_t, args))
    for got, want in ((y, jy), (hf, jh), (y, ry), (hf, rh)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_selective_step_matches_jax_and_the_scan():
    """tests/test_ssm.py:109 on the port: steps one at a time equal the
    scan, and each step equals JAX's."""
    u, dt, A, Bt, Ct, h0 = _ssm_inputs(1, 5, 4, 3, 2)
    h, jh = _t(h0), jnp.asarray(h0)
    ys = []
    for t in range(5):
        y, h = ssm.selective_step(_t(u[:, t]), _t(dt[:, t]), _t(A),
                                  _t(Bt[:, t]), _t(Ct[:, t]), h)
        jy, jh = jax_ssm.selective_step(u[:, t], dt[:, t], A, Bt[:, t],
                                        Ct[:, t], jh)
        np.testing.assert_allclose(y.numpy(), _np(jy), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
        ys.append(y)
    scanned, hf = ssm.selective_scan(*map(_t, (u, dt, A, Bt, Ct, h0)))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), scanned.numpy(),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), hf.numpy(), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


# -------------------- params ---------------------------------------- #
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_are_jax_shaped(pair, param_store):
    """init_params draws JAX's leaves (no attn.wo; meta, ssm, branch
    norms, beta, wo_comb) in JAX's shapes and dtypes, filled as JAX fills
    them; from_jax carries every leaf across unchanged."""
    jcfg, pcfg, jparams, tparams = pair
    raw = param_store(jcfg)
    want = {p: (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _leaves(jax.tree.map(np.asarray, raw))}
    got = build(pcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _leaves(got)} == want
    assert "wo" not in got["layers"]["attn"]
    n = pcfg.ssm_state
    sp = got["layers"]["ssm"]
    assert torch.equal(sp["b_dt"], torch.full_like(sp["b_dt"], -4.0))
    assert torch.equal(sp["d_skip"], torch.ones_like(sp["d_skip"]))
    np.testing.assert_array_equal(sp["a_log"].numpy(),
                                  _np(raw["layers"]["ssm"]["a_log"]))
    assert torch.equal(sp["a_log"][0, 0],
                       torch.log(torch.arange(1, n + 1).float()))
    assert torch.equal(got["layers"]["beta"],
                       torch.ones_like(got["layers"]["beta"]))
    for name in ("branch_norm_attn", "branch_norm_ssm"):
        assert not got["layers"][name].any()
    for p, x in _leaves(jax.tree.map(np.asarray, jparams)):
        leaf = tparams
        for k in p:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), x)


# -------------------- the model ------------------------------------- #
@pytest.mark.parametrize("is_global", [True, False])
def test_hymba_layer_matches_jax(pair, is_global):
    """One hybrid layer over 40 positions (past the window): attention
    and the SSM side by side on the normed input, branch norms, the beta
    mix and wo_comb, then the FFN; its KV, and its SSM's final state
    against JAX's `_hymba_ssm_seq` on the same input."""
    jcfg, pcfg, jparams, tparams = pair
    h = np.random.default_rng(3).normal(size=(2, 40, pcfg.d_model)) \
        .astype(np.float32)
    i = 1
    jlp = jax.tree.map(lambda x: x[i], jparams["layers"])
    prefix = pcfg.n_meta_tokens
    jh, (jk, jv), _ = jax_tf._decoder_layer(
        jlp, jcfg, jnp.asarray(h), jax_tf._id_sh, is_global=is_global,
        prefix=prefix)
    window = 0 if is_global else pcfg.swa_window
    ph, (pk, pv), pstate = tf._decoder_layer(
        tf._layer(tparams, i), pcfg, _t(h), impl="flash", prefix=prefix,
        window=window)
    x = jax_tf.L.norm(jnp.asarray(h), jlp.get("ln1"), jcfg.norm)
    _, jstate = jax_tf._hymba_ssm_seq(jlp["ssm"], jcfg, x)
    for got, want in ((ph, jh), (pk, jk), (pv, jv), (pstate, jstate)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)


def test_each_layer_takes_its_window(pair):
    """Static per-layer windows: 0 in the global layers, the config's in
    the rest (JAX's `_is_global_flags`)."""
    _, pcfg, _, _ = pair
    flags = np.asarray(jax_tf._is_global_flags(
        CONFIGS["g1"](JAX_ARCHS)))
    assert [tf._window(pcfg, i) for i in range(pcfg.n_layers)] == \
        [0 if f else pcfg.swa_window for f in flags]
    assert tf._prefix_len(pcfg) == pcfg.n_meta_tokens == 2


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_forward_matches_jax(pair, impl):
    """Logits over the meta tokens and 40 prompt tokens, past the window."""
    jcfg, pcfg, jparams, tparams = pair
    toks = _tokens(pcfg, 2, 40, 1)
    want, _, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(toks))
    got = tf.forward(tparams, pcfg, _t(toks).long(), impl=impl)
    assert tuple(got.shape) == want.shape == (2, 42, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_prefill_matches_jax_within_the_window(pair):
    """prompt + meta <= window + 1, where JAX's collected states are its
    forward's: logits, pos, k, v and ssm_h."""
    jcfg, pcfg, jparams, tparams = pair
    s = pcfg.swa_window + 1 - pcfg.n_meta_tokens
    toks = _tokens(pcfg, 3, s, 2)
    wl, wc, wp = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks))
    gl, gc, gp = tf.prefill(tparams, pcfg, _t(toks).long())
    np.testing.assert_array_equal(gp.numpy(), _np(wp))
    np.testing.assert_allclose(gl.numpy(), _np(wl), rtol=TOL, atol=TOL)
    assert tuple(gc["ssm_h"].shape) == (pcfg.n_layers, 3,
                                        pcfg.n_heads * pcfg.head_dim,
                                        pcfg.ssm_state)
    assert gc["ssm_h"].dtype == torch.float32
    for name in ("k", "v", "ssm_h"):
        want = _np(wc[name])
        if name != "ssm_h":
            want = want[:, :, :gc[name].shape[2]]
        np.testing.assert_allclose(gc[name].numpy(), want, rtol=TOL,
                                   atol=TOL)


def test_c15_jax_prefill_leaves_its_forward_past_the_window(pair,
                                                            param_store):
    """ROADMAP C15, JAX's own test_prefill_decode_consistency recipe with
    a 40-token prompt: JAX's prefill and one decode step leave JAX's full
    forward by more than 1e-2 (its states come from an all-windowed
    re-run), the port's stay within 1e-5 of the port's forward."""
    jcfg, pcfg, jparams, tparams = pair
    toks = _tokens(pcfg, 2, 41, 4)
    full, _, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(toks))
    _, cache, pos = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks[:, :-1]),
                                   cache_len=41 + pcfg.n_meta_tokens + 4)
    dec, _ = jax_tf.decode_step(jparams, jcfg, cache, jnp.asarray(toks[:, -1]),
                                pos + 1)
    assert float(np.abs(_np(dec) - _np(full[:, -1])).max()) > 1e-2
    pfull = tf.forward(tparams, pcfg, _t(toks).long())
    np.testing.assert_allclose(pfull.numpy(), _np(full), rtol=TOL, atol=TOL)
    _, rows, ppos = tf.prefill(tparams, pcfg, _t(toks[:, :-1]).long())
    cache_t = _contiguous(pcfg, rows, 2, 48)
    got, _ = tf.decode_step(tparams, pcfg, cache_t, _t(toks[:, -1]),
                            ppos + 1)
    assert float((got - pfull[:, -1]).abs().max()) < 1e-5


def _contiguous(cfg, rows, b, cache_len):
    """Prefilled rows in a contiguous cache of `cache_len` positions, the
    SSM state beside them."""
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"ssm_h": rows["ssm_h"].clone()}
    for name in ("k", "v"):
        cache[name] = torch.zeros(shape)
        cache[name][:, :, :rows[name].shape[2]] = rows[name]
    return cache


def _decode_setup(jcfg, pcfg, jparams, tparams, cache_len):
    """Both packages' prefill of 2 rows of 12 tokens (inside the window)
    into a cache of `cache_len` positions, and 14 next tokens from a
    seed: the decode steps run past the window."""
    toks = _tokens(pcfg, 2, 12, 5)
    _, jcache, jpos = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     cache_len=cache_len)
    _, rows, pos = tf.prefill(tparams, pcfg, _t(toks).long())
    nxt = _tokens(pcfg, 14, 2, 6)
    return jcache, jpos + 1, _contiguous(pcfg, rows, 2, cache_len), \
        pos + 1, nxt


def test_decode_step_matches_jax(pair):
    jcfg, pcfg, jparams, tparams = pair
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, 48)
    assert int(pos[0]) + len(nxt) > pcfg.swa_window + pcfg.n_meta_tokens
    for tok in nxt:
        want, jcache = jax_tf.decode_step(jparams, jcfg, jcache,
                                          jnp.asarray(tok), jpos)
        got, cache = tf.decode_step(tparams, pcfg, cache, _t(tok), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
        jpos, pos = jpos + 1, pos + 1
    np.testing.assert_allclose(cache["ssm_h"].numpy(), _np(jcache["ssm_h"]),
                               rtol=TOL, atol=TOL)


def test_decode_step_paged_matches_jax(pair):
    """Each package's pool: the contiguous caches cut into pages of 8
    (permuted), one scratch page past them in the port's; the SSM state
    slot-resident beside them."""
    jcfg, pcfg, jparams, tparams = pair
    cache_len, ps = 48, 8
    jcache, jpos, cache, pos, nxt = _decode_setup(jcfg, pcfg, jparams,
                                                  tparams, cache_len)
    pps = cache_len // ps
    n_pages = 2 * pps + 3
    perm = np.random.default_rng(7).permutation(n_pages)[:2 * pps]
    table = perm.reshape(2, pps).astype(np.int32)
    tail = (pcfg.n_kv_heads, pcfg.head_dim)
    jpools = {"ssm_h": jcache["ssm_h"]}
    pools = {"ssm_h": cache["ssm_h"]}
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
    np.testing.assert_allclose(pools["ssm_h"].numpy(), _np(jpools["ssm_h"]),
                               rtol=TOL, atol=TOL)


def test_per_layer_window_against_the_traced_window_ref():
    """tests/test_kernels.py:201 on the port: JAX routes hymba's traced
    per-slot windows to its reference; the port passes each layer's
    window as a static int, so each row of the same call holds against
    the row of JAX's traced-window reference with that window."""
    B, K, G, n_pages, pps, ps, hd = 3, 2, 4, 24, 6, 8, 64
    rng = np.random.default_rng(11)
    kp = rng.normal(size=(n_pages, ps, K, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, K, hd)).astype(np.float32)
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    pos = np.asarray([ps * 3, ps * 2 + 3, ps * 5 - 1], np.int32)
    table = np.full((B, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            table[i, j] = next(free)
    win = np.asarray([0, 8, 16], np.int32)
    want = _np(jax_pa.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(pos), window=jnp.asarray(win)))
    for i in range(B):
        got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                         _t(pos), window=int(win[i]))
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=TOL,
                                   atol=TOL)


def test_suffix_prefill_and_verify_refuse_hymba(pair):
    _, pcfg, _, tparams = pair
    with pytest.raises(NotImplementedError, match="plain causal"):
        tf.prefill_suffix(tparams, pcfg, {}, torch.zeros(1, 2).long(),
                          torch.zeros(1).long(), torch.ones(1).long())
    with pytest.raises(NotImplementedError, match="plain causal"):
        tf.spec_verify_paged(tparams, pcfg, {}, torch.zeros(1, 2).long(),
                             torch.zeros(1).long(), None, None)


def test_full_hymba_builds():
    """The full config builds (ROADMAP.md A2 done): its model on the CPU,
    and its param tree's shapes on the meta device."""
    cfg = ARCHS["hymba-1.5b"]
    assert build(cfg, "cpu").cfg is cfg
    tree = params_lib.init_params(cfg, None, torch.device("meta"))
    assert tuple(tree["meta"].shape) == (128, 1600)
    assert tuple(tree["layers"]["ssm"]["w_in"].shape) == (32, 1600, 2, 1600)
    assert tuple(tree["lm_head"].shape) == (1600, 32001)


# -------------------- int8 ------------------------------------------ #
def test_quantize_tree_matches_jax(pair):
    """ROADMAP C4 on hymba's leaves: `quantize_tree` quantizes exactly the
    leaves JAX's does (every >= 2-D float leaf: meta, a_log, b_dt,
    d_skip, beta and the stacked norms too) to the same q and scales;
    `int8_operands` hands w_in and wo_comb to the kernel and dequantizes
    the rest once."""
    jcfg, pcfg, jparams, tparams = pair
    jq = jax_q.quantize_tree(jparams, bits=8)
    pq = q_lib.quantize_tree(tparams, bits=8)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jq)))
    quantized = set()
    for path, leaf in _leaves(pq):
        if path[-1] in ("dtype", "bits"):
            continue
        if path[-1] == "__q__" or path[-1] == "scale":
            quantized.add(path[:-1])
        np.testing.assert_array_equal(leaf.numpy(), jflat[path])
    assert {p[:-1] for p in jflat if p[-1] == "__q__"} == quantized
    for leaf in (("layers", "ssm", "a_log"), ("layers", "beta"), ("meta",),
                 ("layers", "ssm", "b_dt")):
        assert leaf in quantized
    run = q_lib.int8_operands(pq)
    assert "col" in run["layers"]["ssm"]["w_in"]
    assert "col" in run["layers"]["wo_comb"]
    assert isinstance(run["layers"]["ssm"]["w_dt_a"], torch.Tensor)
    assert isinstance(run["meta"], torch.Tensor)


# -------------------- the engine ------------------------------------ #
MODES = {"paged_attention": dict(paged_attention=True), "gather": {},
         "contiguous": dict(paged=False), "int8": dict(quantize="int8")}
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "tokens", "steps", "logical_bytes_moved", "paged",
            "paged_attention", "suffix_prefills", "spec_dispatches",
            "prefill_dispatch_tokens", "preemptions", "swap_outs",
            "swap_ins")
BASE = dict(n_slots=4, max_len=64, page_size=8)
# prompt + 2 meta tokens <= window + 1 = 17 (where JAX's prefill is its
# forward); two prompts of 5 share an admission; decode runs past it
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
    decode modes and int8 gather; every prefill dispatch is a group of
    one exact length (the two prompts of 5 in one dispatch of 2 rows)."""
    jax_side, port_side, eng = _both(*pair, decode_block=k, **MODES[mode])
    assert port_side == jax_side
    assert sum(len(t) for t in port_side[0]) == sum(BUDGETS)
    shapes = eng.perf_stats()["prefill_shapes"]
    assert sorted(b for _, b in shapes) == sorted(set(LENS))
    assert (2, 5) in shapes


def _recompute(cfg, params, prompt, n):
    toks, out = list(prompt), []
    for _ in range(n):
        nxt = int(tf.forward(params, cfg, torch.tensor([toks]),
                             impl="full")[0, -1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_past_the_window_equals_its_recompute(pair, mode):
    """ROADMAP C15: prompts past window + meta, where JAX's prefill leaves
    its forward; the port's greedy tokens equal its own full-forward
    recompute (a true recompute for a family admitted at its exact
    length; for int8 on the dequantized weights)."""
    _, pcfg, _, tparams = pair
    reqs = _work(Request, SamplingParams, pcfg, lens=(20, 33, 41),
                 budgets=(6, 5, 7), seed=12)
    eng = InferenceEngine(pcfg, tparams, EngineConfig(
        **BASE, decode_block=4, **MODES[mode]), device="cpu")
    got = _run(eng, reqs)
    ref = (q_lib.dequant_tree(q_lib.quantize_tree(tparams, 8))
           if mode == "int8" else tparams)
    want = [tuple(_recompute(pcfg, ref, r.prompt, r.sampling.max_tokens))
            for r in reqs]
    assert got == want


@pytest.mark.parametrize("mode", ["paged_attention", "gather"])
def test_prefix_cache_and_speculation_stay_off(pair, mode):
    """Requested, the prefix cache and speculation stay off for a
    recurrent family, as in JAX."""
    jax_side, port_side, eng = _both(*pair, decode_block=4,
                                     prefix_cache=True, speculative=True,
                                     **MODES[mode])
    assert port_side == jax_side
    assert eng.prefix_cache is None
    assert not eng.perf_stats()["speculative"]
    assert port_side[1]["suffix_prefills"] == 0


def _swap_work(req_cls, sp_cls, cfg):
    """Four requests whose decode growth runs a 12-page pool dry."""
    return _work(req_cls, sp_cls, cfg, lens=(10, 12, 9, 11),
                 budgets=(30, 30, 30, 30), seed=3)


SWAP = dict(n_slots=4, max_len=48, page_size=8, kv_pages=12,
            decode_block=4, paged_attention=True)


def test_c16_swap_keeps_the_ssm_state(pair):
    """ROADMAP C16: through the host swap tier JAX's swapped request
    resumes on whatever SSM state its new slot holds, so its tokens leave
    those of the same run without the tier (recompute resume); the port's
    handle carries the slot's state and its tokens equal both the run
    without the tier and JAX's."""
    jcfg, pcfg, jparams, tparams = pair
    plain_j, plain_p, _ = _both(jcfg, pcfg, jparams, tparams,
                                work=_swap_work, **SWAP)
    swap_j, swap_p, _ = _both(jcfg, pcfg, jparams, tparams,
                              work=_swap_work, host_kv_pages=64, **SWAP)
    assert plain_p == plain_j and plain_p[1]["preemptions"] >= 1
    assert swap_j[1]["swap_outs"] >= 1 and swap_p[1]["swap_outs"] >= 1
    assert swap_j[0] != plain_j[0]
    assert swap_p[0] == plain_p[0]
