"""xLSTM in the port against the JAX package, on the CPU: the mLSTM and
sLSTM cells (`models/ssm.py`), the model (`models/xlstm.py`), the params,
int8 and the engine.

Configs: the reduced xlstm-125m in f32 (d 64, 4 heads: 1 pair of an
mLSTM and an sLSTM block) and the same at 4 layers (2 pairs).  JAX's
initialised params are carried across with `from_jax`, their RMS-norm
and group-norm scales and the gates' biases drawn from a numpy seed
first (the init leaves the norms at 0).

Tolerances: a cell against JAX's 1e-5 of the output's largest magnitude
(another order of the same f32 products); bf16 inputs the same once
cast up (the cells run in f32); logits and the seven state leaves 2e-5.
Engines: greedy tokens and the dispatch / host-sync / program counters
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xl
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
from repro_torch.models import xlstm as xl
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)
from repro_torch.serving import quantization as q_lib

torch.set_num_threads(2)

TOL = 2e-5
CELL_TOL = 1e-5
CPU = torch.device("cpu")

# its own name each: param_store caches by name
CONFIGS = {
    "p1": lambda a: a["xlstm-125m"].reduced(dtype="f32",
                                            name="xlstm-125m-reduced-f32"),
    "p2": lambda a: a["xlstm-125m"].reduced(
        dtype="f32", n_layers=4, name="xlstm-125m-reduced-p2-f32"),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=CELL_TOL):
    """got within tol of want, relative to want's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale)


def _seeded(params, seed=5):
    """The norm scales and the gates' biases from a seed (the init leaves
    every norm at 0, where it weighs nothing)."""
    rng = np.random.default_rng(seed)
    pairs = {blk: dict(sub) for blk, sub in params["pairs"].items()}
    for blk, names in (("mlstm", ("ln", "gn", "b_i", "b_f")),
                       ("slstm", ("ln", "gn", "b"))):
        for name in names:
            leaf = pairs[blk][name]
            pairs[blk][name] = jnp.asarray(
                np.asarray(leaf) + rng.normal(0.0, 0.5, leaf.shape),
                jnp.float32)
    out = dict(params, pairs=pairs)
    out["final_norm"] = jnp.asarray(
        rng.normal(0.0, 0.5, params["final_norm"].shape), jnp.float32)
    return out


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


# -------------------- the mLSTM cell -------------------------------- #
def _mlstm_inputs(b, s, h, hd, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = (rng.standard_normal((b, s, h)) * 2.0).astype(np.float32)
    f_raw = (rng.standard_normal((b, s, h)) * 2.0 + 1.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _state(b, h, hd):
    return ssm.mlstm_init_state(b, h, hd, CPU)


@pytest.mark.parametrize("shape", [(1, 8, 2, 16), (2, 37, 4, 8),
                                   (1, 64, 1, 32)])
def test_mlstm_parallel_matches_jax(shape):
    ins = _mlstm_inputs(*shape)
    want = jax_ssm.mlstm_parallel(*(jnp.asarray(x) for x in ins))
    got = ssm.mlstm_parallel(*(_t(x) for x in ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _close(got.numpy(), want)


def test_mlstm_parallel_bf16_matches_jax():
    """bf16 q, k, v: both cast up to f32 and the output back to bf16."""
    ins = list(_mlstm_inputs(2, 24, 2, 16))
    jins = [jnp.asarray(x, jnp.bfloat16) if i < 3 else jnp.asarray(x)
            for i, x in enumerate(ins)]
    want = jax_ssm.mlstm_parallel(*jins)
    got = ssm.mlstm_parallel(*(params_lib._leaf(np.asarray(x), CPU)
                               for x in jins))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), 2 ** -7)


def test_mlstm_recurrent_matches_jax_step_by_step():
    b, s, h, hd = 2, 12, 2, 16
    ins = _mlstm_inputs(b, s, h, hd, seed=4)
    jst = jax_ssm.mlstm_init_state(b, h, hd)
    st = _state(b, h, hd)
    for t in range(s):
        jo, jst = jax_ssm.mlstm_recurrent(*(jnp.asarray(x[:, t])
                                            for x in ins), jst)
        o, st = ssm.mlstm_recurrent(*(_t(x[:, t]) for x in ins), st)
        _close(o.numpy(), jo)
        for got, want in zip(st, jst):
            _close(got.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 4, 8, 256])
def test_mlstm_chunkwise_matches_jax(chunk):
    """Chunks of 1, 4 and 8 over 32 positions, and 256, which does not
    divide 32: one chunk of the whole length, as in JAX."""
    b, s, h, hd = 2, 32, 2, 16
    ins = _mlstm_inputs(b, s, h, hd, seed=5)
    wo, wst = jax_ssm.mlstm_chunkwise(*(jnp.asarray(x) for x in ins),
                                      jax_ssm.mlstm_init_state(b, h, hd),
                                      chunk=chunk)
    go, gst = ssm.mlstm_chunkwise(*(_t(x) for x in ins), _state(b, h, hd),
                                  chunk=chunk)
    _close(go.numpy(), wo)
    for got, want in zip(gst, wst):
        _close(got.numpy(), want)


def test_mlstm_chunkwise_carries_its_state_across_calls():
    """Two calls of 16 positions, the second from the first's state, equal
    JAX's same two calls and the parallel form over all 32."""
    b, s, h, hd = 1, 16, 2, 8
    ins = _mlstm_inputs(b, 2 * s, h, hd, seed=6)
    halves = [[x[:, :s] for x in ins], [x[:, s:] for x in ins]]
    jst, st, outs = jax_ssm.mlstm_init_state(b, h, hd), _state(b, h, hd), []
    for half in halves:
        jo, jst = jax_ssm.mlstm_chunkwise(*(jnp.asarray(x) for x in half),
                                          jst, chunk=8)
        o, st = ssm.mlstm_chunkwise(*(_t(x) for x in half), st, chunk=8)
        _close(o.numpy(), jo)
        outs.append(o)
    for got, want in zip(st, jst):
        _close(got.numpy(), want)
    full = ssm.mlstm_parallel(*(_t(x) for x in ins))
    _close(torch.cat(outs, dim=1).numpy(), full.numpy(), 2e-4)


# -------------------- the sLSTM cell -------------------------------- #
def _slstm_inputs(b, s, h, hd, seed=7):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, s, 4, h, hd)).astype(np.float32)
    r = (rng.standard_normal((4, h, hd, hd)) * 0.3).astype(np.float32)
    return xw, r


def test_slstm_step_matches_jax():
    b, s, h, hd = 2, 9, 3, 8
    xw, r = _slstm_inputs(b, s, h, hd)
    jst = jax_ssm.slstm_init_state(b, h, hd)
    st = ssm.slstm_init_state(b, h, hd, CPU)
    for t in range(s):
        jst = jax_ssm.slstm_step(jnp.asarray(xw[:, t]), jnp.asarray(r), jst)
        st = ssm.slstm_step(_t(xw[:, t]), _t(r), st)
        for got, want in zip(st, jst):
            _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_scan_matches_jax(dtype):
    """The head-major scan against JAX's lax.scan of slstm_step, from a
    random state; bf16 projections are cast up as in JAX."""
    b, s, h, hd = 2, 21, 4, 8
    xw, r = _slstm_inputs(b, s, h, hd, seed=8)
    rng = np.random.default_rng(9)
    st0 = [rng.standard_normal((b, h, hd)).astype(np.float32)
           for _ in range(4)]
    st0[1] = np.abs(st0[1]) + 0.5           # n > 0
    jxw = jnp.asarray(xw, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    hs_w, fin_w = jax_ssm.slstm_scan(
        jxw, jnp.asarray(r),
        jax_ssm.SLSTMState(*(jnp.asarray(x) for x in st0)))
    hs, fin = ssm.slstm_scan(params_lib._leaf(np.asarray(jxw), CPU), _t(r),
                             ssm.SLSTMState(*(_t(x) for x in st0)))
    assert hs.dtype == torch.float32 and tuple(hs.shape) == (b, s, h, hd)
    _close(hs.numpy(), hs_w)
    for got, want in zip(fin, fin_w):
        _close(got.numpy(), want)


class _Ops(TorchDispatchMode):
    """Counts the aten operations that compute (views excluded)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def test_slstm_scan_ops_per_step():
    """Each time step of the scan issues SLSTM_STEP_OPS operations (one
    batched product and the gates), whatever the length: on the card,
    that many launches a step."""
    b, h, hd = 2, 4, 8
    counts = []
    for s in (3, 7):
        xw, r = _slstm_inputs(b, s, h, hd)
        with _Ops() as c:
            ssm.slstm_scan(_t(xw), _t(r), ssm.slstm_init_state(b, h, hd,
                                                               CPU))
        counts.append(c.n)
    assert (counts[1] - counts[0]) == 4 * ssm.SLSTM_STEP_OPS == 64


# -------------------- params ---------------------------------------- #
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_params_are_jax_shaped(pair, param_store):
    """init_params draws JAX's leaves in JAX's shapes and dtypes (the
    gates' weights and biases f32), filled as JAX fills them (the forget
    gates' bias at 3); from_jax carries every leaf across unchanged."""
    jcfg, pcfg, jparams, tparams = pair
    raw = param_store(jcfg)
    want = {p: (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _leaves(jax.tree.map(np.asarray, raw))}
    got = build(pcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in _leaves(got)} == want
    mp = got["pairs"]["mlstm"]
    assert torch.equal(mp["b_f"], torch.full_like(mp["b_f"], 3.0))
    assert not mp["b_i"].any() and not got["pairs"]["slstm"]["b"].any()
    jflat = dict(_leaves(jax.tree.map(np.asarray, raw)))
    for p, leaf in _leaves(got):
        if p[-1] in ("w_up", "wq", "w_x", "r", "ffn_wo"):
            ratio = float(leaf.std()) / float(np.std(jflat[p]))
            assert abs(ratio - 1) < 0.15, p
    for p, x in _leaves(jax.tree.map(np.asarray, jparams)):
        leaf = tparams
        for k in p:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), x)


def test_full_xlstm_builds():
    """The full config builds: its model on the CPU and its tree's shapes
    on the meta device (6 pairs, inner 1536, 4 heads of 384 / 192)."""
    cfg = ARCHS["xlstm-125m"]
    assert build(cfg, "cpu").cfg is cfg
    tree = params_lib.init_params(cfg, None, torch.device("meta"))
    assert tuple(tree["pairs"]["mlstm"]["w_up"].shape) == (6, 768, 2, 1536)
    assert tuple(tree["pairs"]["mlstm"]["wq"].shape) == (6, 1536, 4, 384)
    assert tuple(tree["pairs"]["slstm"]["r"].shape) == (6, 4, 4, 192, 192)
    assert tuple(tree["pairs"]["slstm"]["ffn_wi"].shape) == (6, 768, 2112)
    assert "lm_head" not in tree
    cache = xl.init_cache(cfg, 8, torch.device("meta"))
    assert tuple(cache["mC"].shape) == (6, 8, 4, 384, 384)
    assert sum(x.numel() * 4 for x in cache.values()) == 114_131_712


# -------------------- the model ------------------------------------- #
def test_forward_matches_jax(pair):
    """Logits over 40 tokens: the parallel mLSTM and the sLSTM scan."""
    jcfg, pcfg, jparams, tparams = pair
    toks = _tokens(pcfg, 2, 40, 1)
    want, _, _ = jax_xl.forward(jparams, jcfg, jnp.asarray(toks))
    got = xl.forward(tparams, pcfg, _t(toks).long())
    assert tuple(got.shape) == want.shape == (2, 40, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_prefill_matches_jax(pair):
    """The last logits, pos and all seven state leaves (from the
    chunkwise form) over 3 rows of 23 tokens."""
    jcfg, pcfg, jparams, tparams = pair
    toks = _tokens(pcfg, 3, 23, 2)
    wl, wc, wp = jax_xl.prefill(jparams, jcfg, jnp.asarray(toks))
    gl, gc, gp = xl.prefill(tparams, pcfg, _t(toks).long())
    np.testing.assert_array_equal(gp.numpy(), _np(wp))
    np.testing.assert_allclose(gl.numpy(), _np(wl), rtol=TOL, atol=TOL)
    assert sorted(gc) == sorted(wc) == sorted(xl.CACHE_LEAVES)
    for name in xl.CACHE_LEAVES:
        assert gc[name].dtype == torch.float32
        assert tuple(gc[name].shape) == wc[name].shape
        _close(gc[name].numpy(), wc[name], TOL)


def test_decode_step_matches_jax(pair):
    """Six decode steps from the prefilled state: logits and every state
    leaf, advanced in place."""
    jcfg, pcfg, jparams, tparams = pair
    toks = _tokens(pcfg, 2, 11, 3)
    _, jcache, _ = jax_xl.prefill(jparams, jcfg, jnp.asarray(toks))
    _, cache, _ = xl.prefill(tparams, pcfg, _t(toks).long())
    for tok in _tokens(pcfg, 6, 2, 4):
        want, jcache = jax_xl.decode_step(jparams, jcfg, jcache,
                                          jnp.asarray(tok))
        got, out = xl.decode_step(tparams, pcfg, cache, _t(tok).long())
        assert out is cache
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL,
                                   atol=TOL)
    for name in xl.CACHE_LEAVES:
        _close(cache[name].numpy(), jcache[name], TOL)


def test_prefill_decode_consistency(pair):
    """tests/test_models.py's recipe on the port: prefill over S - 1
    tokens then one decode step equal the full forward's last two
    positions within 5e-4."""
    _, pcfg, _, tparams = pair
    model = build(pcfg, "cpu")
    tok = _t(_tokens(pcfg, 2, 16, 5)).long()
    full = xl.forward(tparams, pcfg, tok)
    last, cache, pos = model.prefill(tparams, tok[:, :-1], None)
    assert float((last - full[:, -2]).abs().max()) < 5e-4
    dec, _ = model.decode(tparams, cache, tok[:, -1], pos + 1)
    assert float((dec - full[:, -1]).abs().max()) < 5e-4


def test_kv_entry_points_refuse_xlstm(pair):
    _, pcfg, _, tparams = pair
    model = build(pcfg, "cpu")
    for call in (lambda: model.decode_paged(tparams, {}, None, None, None,
                                            None),
                 lambda: model.verify_paged(tparams, {}, None, None, None,
                                            None),
                 lambda: model.prefill_suffix(tparams, {}, None, None,
                                              None)):
        with pytest.raises(NotImplementedError, match="xlstm"):
            call()


# -------------------- int8 ------------------------------------------ #
def test_quantize_tree_matches_jax(pair):
    """ROADMAP C4 on xLSTM's leaves: `quantize_tree` quantizes exactly the
    leaves JAX's does (every >= 2-D float leaf: the f32 gate weights and
    biases and the stacked norms too) to the same q and scales;
    `int8_operands` hands the seven products to the kernel and
    dequantizes the rest once."""
    jcfg, pcfg, jparams, tparams = pair
    jq = jax_q.quantize_tree(jparams, bits=8)
    pq = q_lib.quantize_tree(tparams, bits=8)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jq)))
    quantized = set()
    for path, leaf in _leaves(pq):
        if path[-1] in ("dtype", "bits"):
            continue
        if path[-1] in ("__q__", "scale"):
            quantized.add(path[:-1])
        np.testing.assert_array_equal(leaf.numpy(), jflat[path])
    assert {p[:-1] for p in jflat if p[-1] == "__q__"} == quantized
    run = q_lib.int8_operands(pq)
    for blk, names in (("mlstm", ("w_up", "wq", "wk", "wv", "w_down")),
                       ("slstm", ("ffn_wi", "ffn_wo"))):
        for name in names:
            assert "col" in run["pairs"][blk][name]
    for blk, name in (("mlstm", "w_i"), ("mlstm", "b_f"), ("slstm", "r"),
                      ("slstm", "w_x"), ("mlstm", "ln")):
        leaf = run["pairs"][blk][name]
        assert isinstance(leaf, torch.Tensor)
        assert leaf.dtype == tparams["pairs"][blk][name].dtype
    # w_up's per-inner scale repeats over its two halves (u, z)
    col = run["pairs"]["mlstm"]["w_up"]["col"]
    scale = pq["pairs"]["mlstm"]["w_up"]["scale"].reshape(-1)
    assert torch.equal(col[0], torch.cat([scale, scale]))


def test_int8_launches_a_model_call(pair, monkeypatch):
    """7 int8 products a pair and the tied head, each model call: a
    prefill and a decode step, their results those of the dequantized
    weights within f32 rounding."""
    _, pcfg, _, tparams = pair
    calls = []
    real = ops.int8_matmul

    def counting(x, w, scale):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, scale)
    monkeypatch.setattr(ops, "int8_matmul", counting)
    run = q_lib.int8_operands(q_lib.quantize_tree(tparams, 8))
    deq = q_lib.dequant_tree(q_lib.quantize_tree(tparams, 8))
    toks = _t(_tokens(pcfg, 2, 9, 6)).long()
    logits, cache, _ = xl.prefill(run, pcfg, toks)
    want_l, want_c, _ = xl.prefill(deq, pcfg, toks)
    want = 7 * xl.n_pairs(pcfg) + 1
    assert len(calls) == want
    np.testing.assert_allclose(logits.numpy(), want_l.numpy(), rtol=1e-4,
                               atol=1e-4)
    calls.clear()
    xl.decode_step(run, pcfg, cache, toks[:, 0])
    assert len(calls) == want
    assert calls[-1] == ((2, pcfg.d_model), (pcfg.d_model, pcfg.vocab))


# -------------------- the engine ------------------------------------ #
MODES = {"paged_attention": dict(paged_attention=True), "gather": {},
         "contiguous": dict(paged=False)}
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "tokens", "steps", "logical_bytes_moved", "paged",
            "paged_attention", "suffix_prefills", "spec_dispatches",
            "prefill_dispatch_tokens", "preemptions", "swap_outs",
            "swap_ins")
BASE = dict(n_slots=4, max_len=64, page_size=8)
# two prompts of 5 share an admission (one exact length a group)
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
    jst, st = jeng.perf_stats(), eng.perf_stats()
    return ((jtoks, {c: jst[c] for c in COUNTERS}),
            (toks, {c: st[c] for c in COUNTERS}), eng)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(pair, mode, k):
    """Greedy tokens and counters equal JAX's at K = 1, 4, 8 with `paged`
    on (collapsing to the contiguous mode on both sides: nothing to
    page) and off; every prefill dispatch a group of one exact length
    (the two prompts of 5 in one dispatch of 2 rows); the cache the seven
    slot-resident leaves."""
    jax_side, port_side, eng = _both(*pair, decode_block=k, **MODES[mode])
    assert port_side == jax_side
    assert sum(len(t) for t in port_side[0]) == sum(BUDGETS)
    st = eng.perf_stats()
    assert not st["paged"] and not st["paged_attention"]
    assert sorted(b for _, b in st["prefill_shapes"]) == sorted(set(LENS))
    assert (2, 5) in st["prefill_shapes"]
    assert sorted(eng.cache) == sorted(xl.CACHE_LEAVES)
    assert eng.host_pool is None and eng.prefix_cache is None


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_engine_quantized_matches_jax(pair, quantize):
    jax_side, port_side, _ = _both(*pair, decode_block=4, quantize=quantize)
    assert port_side == jax_side


def test_prefix_cache_speculation_and_swap_stay_off(pair):
    """Requested, the prefix cache, speculation and the host tier stay
    off (nothing paged), as in JAX."""
    jax_side, port_side, eng = _both(*pair, decode_block=4,
                                     paged_attention=True, prefix_cache=True,
                                     speculative=True, host_kv_pages=16)
    assert port_side == jax_side
    assert eng.prefix_cache is None and eng.host_pool is None
    assert not eng.perf_stats()["speculative"]


def test_decodes_past_max_len(pair):
    """A constant-size state never runs out of cache positions: a budget
    past max_len is served in full (the position limit is 2**30), as in
    JAX."""
    jcfg, pcfg, jparams, tparams = pair

    def work(req_cls, sp_cls, cfg):
        return _work(req_cls, sp_cls, cfg, lens=(10, 6), budgets=(30, 12))
    jax_side, port_side, _ = _both(jcfg, pcfg, jparams, tparams, work=work,
                                   max_len=16, decode_block=4)
    assert port_side == jax_side
    assert [len(t) for t in port_side[0]] == [30, 12]


def test_preempted_request_resumes_by_recompute(pair):
    """A slot preempted mid-decode (nothing is paged, so no page shortage
    preempts one: the test calls the engines' own `_preempt` at the same
    step) resumes by recompute, a prefill over its prompt and its output
    so far at their exact length: its tokens equal JAX's engine's under
    the same preemption and the undisturbed run's."""
    jcfg, pcfg, jparams, tparams = pair
    runs = []
    for eng_cls, ecfg_cls, req_cls, sp_cls, cfg, params, preempt in (
            (JaxEngine, JaxEngineConfig, JaxRequest, JaxSampling, jcfg,
             jparams, True),
            (InferenceEngine, EngineConfig, Request, SamplingParams, pcfg,
             tparams, True),
            (InferenceEngine, EngineConfig, Request, SamplingParams, pcfg,
             tparams, False)):
        kw = {} if eng_cls is JaxEngine else dict(device="cpu")
        eng = eng_cls(cfg, params, ecfg_cls(**BASE, decode_block=4), **kw)
        reqs = _work(req_cls, sp_cls, cfg, lens=(7, 11, 6),
                     budgets=(20, 16, 18), seed=10)
        for r in reqs:
            assert eng.submit(r)
        eng.step()
        eng.step()
        if preempt:
            slot = min(s for s, r in eng.slot_req.items() if r is reqs[1])
            eng._preempt(slot)
        eng.run_until_done()
        runs.append(([tuple(r.output) for r in reqs], eng.preemptions))
    assert runs[0] == runs[1] and runs[1][1] == 1
    assert runs[2][0] == runs[1][0]
