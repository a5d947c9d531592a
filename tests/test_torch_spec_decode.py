"""The port's speculative decoding against the JAX package's, on the
reduced OLMo-1B in f32 with the same (carried-across) params, on the CPU
through the kernels' plain versions.

The proposer helpers (`ngram_hash` buckets, `propose`, `record`,
`accept_length`) equal JAX's on seeded inputs, bit for bit.  The verify
forward (`transformer.spec_verify_paged`, through
`kernels.ops.paged_suffix_attention`) equals JAX's within 2e-5 (f32).
The engine with `speculative=True` gives JAX's greedy tokens and
dispatch / host-sync / verify counters at D = 2 and 4 and K = 1, 4 and
8, tokens identical to speculation off; sampled batches take the fused
path; cancel and release wipe the proposer state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels import ops as jax_ops
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving import spec_decode as jsd
from repro_torch import params as params_lib
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)
from repro_torch.serving import spec_decode as sd

torch.set_num_threads(2)

F32_TOL = 2e-5
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "spec_traces", "tokens", "steps", "spec_dispatches",
            "spec_emitted", "spec_slot_accepted", "logical_bytes_moved",
            "speculative", "paged_attention", "preemptions")


@pytest.fixture(scope="module")
def cfg():
    # its own name: param_store caches by name
    return ARCHS["olmo-1b"].reduced(dtype="f32", name="olmo-1b-reduced-f32")


@pytest.fixture(scope="module")
def jparams(cfg, param_store):
    return param_store(cfg)


@pytest.fixture(scope="module")
def tparams(cfg, jparams):
    return params_lib.from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("paged_attention", True)
    kw.setdefault("speculative", True)
    return InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu")


def _run(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done()
    return [tuple(r.output) for r in reqs]


def _work(req_cls=Request, sp_cls=SamplingParams, n=5, max_tokens=12):
    """The workload of tests/test_spec_decode.py."""
    return [req_cls(model="m", prompt=list(range(1, 2 + i)),
                    sampling=sp_cls(max_tokens=max_tokens + i))
            for i in range(n)]


# ------------------- proposer helpers against JAX -------------------- #
def test_ngram_hash_buckets_equal_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(-1, 2 ** 31 - 1, 500),
                        [-1, 0, 1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    b = np.concatenate([rng.integers(-1, 50304, 500),
                        [-1, -1, 0, -2 ** 31, 2 ** 31 - 1]]).astype(np.int32)
    for t in (1, 64, 512, 1 << 16):
        want = np.asarray(jsd.ngram_hash(jnp.asarray(a), jnp.asarray(b), t))
        got = sd.ngram_hash(torch.from_numpy(a), torch.from_numpy(b), t)
        np.testing.assert_array_equal(got.numpy(), want)


def test_propose_record_accept_equal_jax():
    """A seeded table and token stream: each record, the proposals from
    the learned table, and the accept lengths equal JAX's."""
    rng = np.random.default_rng(1)
    b, t, d = 6, 64, 4
    jt, jp = jsd.init_tables(b, t)
    tt, tp = sd.init_tables(b, t)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    stream = rng.integers(0, 12, (40, b)).astype(np.int32)
    stream[3, 2] = -1                          # an unknown token drops
    valid = rng.random((40, b)) < 0.8
    for i in range(2, 40):
        args = (stream[i - 2], stream[i - 1], stream[i], valid[i])
        jt = jsd.record(jt, *(jnp.asarray(x) for x in args))
        sd.record(tt, *(torch.from_numpy(np.asarray(x)) for x in args))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    prev = np.array([stream[-2, 0], -1, 3, stream[-2, 3], 5, 7], np.int32)
    last = np.array([stream[-1, 0], 4, -1, stream[-1, 3], 6, 8], np.int32)
    jd = np.asarray(jsd.propose(jt, jnp.asarray(prev), jnp.asarray(last), d))
    td = sd.propose(tt, torch.from_numpy(prev), torch.from_numpy(last), d)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert td.dtype == torch.int32 and (jd >= 0).any()
    greedy = np.where(rng.random(jd.shape) < 0.7, jd,
                      rng.integers(0, 12, jd.shape)).astype(np.int32)
    want = np.asarray(jsd.accept_length(jnp.asarray(jd),
                                        jnp.asarray(greedy)))
    got = sd.accept_length(td, torch.from_numpy(greedy))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_tables_needs_a_power_of_two():
    with pytest.raises(ValueError):
        sd.init_tables(2, 48)


# ------------------- the verify forward ------------------------------ #
def _paged_case(rng, cfg, b, pps, ps, n_pages, pos):
    table = np.full((b, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(min(p // ps + 1, pps)):
            table[i, j] = next(free)
    if b > 1:
        table[1, 0] = table[0, 0]              # a shared page
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    return table, pools


def test_paged_suffix_attention_matches_jax():
    rng = np.random.default_rng(2)
    b, qn, h, nkv, hd, ps, pps, n_pages = 3, 5, 4, 2, 16, 8, 6, 20
    pos = np.array([0, 13, 40], np.int32)
    table = np.full((b, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(min((p + qn - 1) // ps + 1, pps)):
            if not (i == 2 and j == 2):        # a sentinel hole
                table[i, j] = next(free)
    q = rng.standard_normal((b, qn, h, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, ps, nkv, hd)).astype(np.float32)
              for _ in range(2))
    q_pos = (pos[:, None] + np.arange(qn)[None]).astype(np.int32)
    want = np.asarray(jax_ops.paged_suffix_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, table, q_pos))))
    got = ops.paged_suffix_attention(*(torch.from_numpy(x) for x in
                                       (q, kp, vp, table, q_pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_spec_verify_paged_matches_jax(cfg, jparams, tparams):
    """Q = 5 tokens a row through the paged pool: logits and every pool
    entry JAX writes equal JAX's (the port's scratch page aside).  Row 1
    shares page 0 with row 0 and the write table masks it; row 2's last
    positions run past the table and drop."""
    rng = np.random.default_rng(3)
    b, qn, ps, pps, n_pages = 3, 5, 8, 6, 24
    pos = np.array([3, 17, 45], np.int32)
    table, pools = _paged_case(rng, cfg, b, pps, ps, n_pages, pos + qn - 1)
    wtable = table.copy()
    wtable[1, 0] = n_pages
    wtable[0, 0] = n_pages
    tokens = rng.integers(0, cfg.vocab, (b, qn)).astype(np.int32)
    jl, jc = jax_tf.spec_verify_paged(
        jparams, cfg, {n: jnp.asarray(a) for n, a in pools.items()},
        jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(table),
        jnp.asarray(wtable))
    tpools = {n: torch.cat([torch.from_numpy(a),
                            torch.zeros_like(torch.from_numpy(a[:, :1]))],
                           dim=1) for n, a in pools.items()}
    logits, out = tf.spec_verify_paged(
        tparams, cfg, tpools, torch.from_numpy(tokens),
        torch.from_numpy(pos), torch.from_numpy(table),
        torch.from_numpy(wtable))
    assert out is tpools
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpools[n][:, :-1].numpy(),
                                   np.asarray(jc[n]), atol=F32_TOL,
                                   rtol=F32_TOL)


# ------------------- engine parity ----------------------------------- #
@pytest.fixture(scope="module")
def jax_runs(cfg, jparams):
    out = {}
    for d in (2, 4):
        for k in (1, 4, 8):
            eng = JaxEngine(cfg, jparams, JaxEngineConfig(
                n_slots=4, max_len=64, page_size=8, decode_block=k,
                paged_attention=True, speculative=True, spec_draft=d))
            toks = _run(eng, _work(JaxRequest, JaxSampling))
            out[d, k] = (toks, {c: eng.perf_stats()[c] for c in COUNTERS})
    return out


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("d", [2, 4])
def test_spec_tokens_and_counters_match_jax(cfg, tparams, jax_runs, d, k):
    eng = _engine(cfg, tparams, spec_draft=d, decode_block=k)
    toks = _run(eng, _work())
    want_toks, want_stats = jax_runs[d, k]
    assert toks == want_toks
    stats = eng.perf_stats()
    assert {c: stats[c] for c in COUNTERS} == want_stats
    assert stats["speculative"] and stats["spec_dispatches"] > 0
    assert stats["spec_accepted_per_dispatch"] > 1.0
    # greedy verify is lossless: speculation off gives the same tokens
    assert _run(_engine(cfg, tparams, speculative=False, decode_block=k),
                _work()) == want_toks
    assert eng.pool.pages_in_use == 0


def test_spec_study_matches_jax(cfg, jparams, tparams):
    """`benchmarks/bench_serving.py::_spec_study`'s engines (K = 1,
    speculation off and on, a repetition-heavy workload after a warm-up)
    on the f32 model: the port's tokens and counters equal JAX's, and a
    verify emits more than one token on average, so dispatches per token
    fall."""
    def study(engine_cls, cfg_cls, req_cls, sp_cls, params, **dev):
        res = {}
        for on in (False, True):
            eng = engine_cls(cfg, params, cfg_cls(
                n_slots=4, max_len=64, decode_block=1, page_size=8,
                paged_attention=True, speculative=on), **dev)
            _run(eng, [req_cls(model="m", prompt=[1, 2, 3],
                               sampling=sp_cls(max_tokens=2))
                       for _ in range(4)])
            base = eng.perf_stats()
            toks = _run(eng, [req_cls(model="m", prompt=[1, 2, 3 + (i % 5)],
                                      sampling=sp_cls(max_tokens=24))
                              for i in range(6)])
            st = eng.perf_stats()
            res[on] = (toks, {c: st[c] - base[c] for c in
                              ("tokens", "dispatches", "host_syncs",
                               "spec_dispatches", "spec_emitted")})
        return res
    want = study(JaxEngine, JaxEngineConfig, JaxRequest, JaxSampling,
                 jparams)
    got = study(InferenceEngine, EngineConfig, Request, SamplingParams,
                tparams, device="cpu")
    assert got == want
    assert got[True][0] == got[False][0]
    on, off = got[True][1], got[False][1]
    assert on["spec_emitted"] > on["spec_dispatches"]
    assert on["dispatches"] / on["tokens"] < off["dispatches"] / off["tokens"]


def test_sampled_batches_fall_back_to_fused(cfg, tparams):
    eng = _engine(cfg, tparams, decode_block=2)
    reqs = [Request(model="m", prompt=[1, 2],
                    sampling=SamplingParams(max_tokens=6)),
            Request(model="m", prompt=[3, 4],
                    sampling=SamplingParams(max_tokens=6, temperature=0.8))]
    _run(eng, reqs)
    assert eng.perf_stats()["spec_dispatches"] == 0
    assert all(len(r.output) == 6 for r in reqs)


def test_cancel_wipes_proposer_state_and_reused_slot_sees_none(cfg, tparams):
    """Cancelling a speculating request clears its slot's proposer row and
    chain seed; a request admitted into the slot then decodes as on a
    fresh engine."""
    probe = [Request(model="m", prompt=[4, 5],
                     sampling=SamplingParams(max_tokens=10))]
    ref = _run(_engine(cfg, tparams, n_slots=1, decode_block=1), probe)
    eng = _engine(cfg, tparams, n_slots=1, decode_block=1)
    victim = Request(model="m", prompt=[1, 2, 3],
                     sampling=SamplingParams(max_tokens=40))
    assert eng.submit(victim)
    for _ in range(4):
        eng.step()
    assert (eng.spec_table[0] >= 0).any()
    assert eng.cancel(victim.request_id) == "active"
    assert (eng.spec_table[0] == -1).all() and int(eng.spec_prev[0]) == -1
    assert _run(eng, [Request(model="m", prompt=[4, 5],
                              sampling=SamplingParams(max_tokens=10))]) \
        == ref
