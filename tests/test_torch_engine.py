"""The port's serving engine against the JAX engine in its paged-attention
mode, on the reduced OLMo-1B in f32 with the same (carried-across)
params, on the CPU through the kernels' plain versions: greedy tokens,
dispatch / host-sync / prefill-program counters, exact budgets, EOS,
cancel, preemption and sampling support."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 RequestState, SamplingParams)
from repro_torch.serving.sampler import sample_batched
from repro.serving.sampler import sample_batched as jax_sample_batched

torch.set_num_threads(2)


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
    kw.setdefault("paged_attention", True)
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    return InferenceEngine(cfg, params, EngineConfig(**kw), device="cpu")


def _run(eng, reqs, max_steps=10_000):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done(max_steps)
    return [tuple(r.output) for r in reqs]


def _work(req_cls=Request, sp_cls=SamplingParams, n=5, max_tokens=10):
    """The workload of tests/test_paged_attention.py."""
    return [req_cls(model="m", prompt=list(range(1, 2 + i)),
                    sampling=sp_cls(max_tokens=max_tokens + i))
            for i in range(n)]


COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "tokens", "steps")


@pytest.fixture(scope="module")
def jax_runs(cfg, jparams):
    """JAX engine (paged_attention=True) outputs and counters per K."""
    out = {}
    for k in (1, 4, 8):
        eng = JaxEngine(cfg, jparams, JaxEngineConfig(
            n_slots=4, max_len=64, page_size=8, decode_block=k,
            paged_attention=True))
        toks = _run(eng, _work(JaxRequest, JaxSampling))
        out[k] = (toks, {c: eng.perf_stats()[c] for c in COUNTERS})
    return out


@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_tokens_and_counters_match_jax(cfg, tparams, jax_runs, k):
    eng = _engine(cfg, tparams, decode_block=k)
    toks = _run(eng, _work())
    want_toks, want_stats = jax_runs[k]
    assert toks == want_toks
    stats = eng.perf_stats()
    assert {c: stats[c] for c in COUNTERS} == want_stats
    assert stats["paged_attention"] is True
    assert eng.pool.pages_in_use == 0


def test_exact_budgets_under_k8(cfg, tparams):
    eng = _engine(cfg, tparams, decode_block=8)
    reqs = [Request(model="m", prompt=[2, 3],
                    sampling=SamplingParams(max_tokens=m))
            for m in (1, 3, 11)]
    _run(eng, reqs)
    assert [len(r.output) for r in reqs] == [1, 3, 11]
    assert all(r.state == RequestState.FINISHED for r in reqs)


def test_eos_stops_mid_block(cfg, tparams):
    """EOS is the first greedy token that first occurs at index 3 or
    later (ROADMAP C1: an earlier repeat would stop the run sooner)."""
    eng = _engine(cfg, tparams, decode_block=8)
    probe = Request(model="m", prompt=[5, 6],
                    sampling=SamplingParams(max_tokens=10))
    _run(eng, [probe])
    out = probe.output
    idx = next(i for i in range(3, len(out)) if out[i] not in out[:i])
    r = Request(model="m", prompt=[5, 6],
                sampling=SamplingParams(max_tokens=10, eos_id=out[idx]))
    _run(eng, [r])
    assert r.output == out[:idx + 1]


def test_bucketed_prefill_one_program_per_bucket(cfg, tparams):
    eng = _engine(cfg, tparams)
    for ln in (3, 4, 5, 6, 7, 8):
        _run(eng, [Request(model="m", prompt=list(range(ln)),
                           sampling=SamplingParams(max_tokens=2))])
    assert eng.prefill_traces == 1          # lengths 3..8 -> bucket 8
    _run(eng, [Request(model="m", prompt=list(range(9)),
                       sampling=SamplingParams(max_tokens=2))])
    assert eng.prefill_traces == 2          # length 9 -> bucket 16
    assert eng.decode_traces == 1


def test_cancel_returns_slot_and_pages(cfg, tparams):
    eng = _engine(cfg, tparams, n_slots=2, decode_block=2)
    victim = Request(model="m", prompt=[1, 2, 3],
                     sampling=SamplingParams(max_tokens=30))
    assert eng.submit(victim)
    eng.step()
    assert eng.slot_req and eng.pool.pages_in_use > 0
    assert eng.cancel(victim.request_id) == "active"
    assert not eng.slot_req
    assert eng.pool.pages_in_use == 0
    assert len(eng.pool.free_slots) == 2
    assert not bool(eng.active.any())
    fresh = Request(model="m", prompt=[4, 5],
                    sampling=SamplingParams(max_tokens=6))
    ref = _run(_engine(cfg, tparams, n_slots=2, decode_block=2),
               [Request(model="m", prompt=[4, 5],
                        sampling=SamplingParams(max_tokens=6))])
    assert _run(eng, [fresh]) == ref
    assert eng.cancel(12345) is False


def test_preemption_resumes_with_same_tokens(cfg, tparams):
    """An oversubscribed page budget preempts and recomputes; every request
    still gets the tokens of an uncontended run."""
    def contended():
        return [Request(model="m", prompt=list(range(1, 3 + i)),
                        sampling=SamplingParams(max_tokens=20))
                for i in range(6)]
    ref = _run(_engine(cfg, tparams, n_slots=6, decode_block=4), contended())
    eng = _engine(cfg, tparams, n_slots=6, kv_pages=18, decode_block=4)
    assert _run(eng, contended()) == ref
    assert eng.preemptions >= 1
    assert eng.scheduler.requeued_total == eng.preemptions
    assert eng.pool.pages_in_use == 0


def test_sampled_tokens_stay_in_top_k(cfg, tparams):
    """Sampled decode ("full" mode) only ever emits tokens from each step's
    top-k set: replay each request's context greedily and check every
    emitted token against the top-k of the recomputed logits."""
    from repro_torch.models.transformer import forward
    eng = _engine(cfg, tparams, decode_block=4, seed=3)
    reqs = [Request(model="m", prompt=[7 + i, 8, 9],
                    sampling=SamplingParams(temperature=1.5, top_k=5,
                                            top_p=0.9, max_tokens=12))
            for i in range(3)]
    _run(eng, reqs)
    assert eng.decode_traces == 1
    for r in reqs:
        ctx = torch.tensor([list(r.prompt) + r.output[:-1]])
        logits = forward(tparams, cfg, ctx, impl="full")[0]
        top = logits[len(r.prompt) - 1:].topk(5, dim=-1).indices
        for i, tok in enumerate(r.output):
            assert tok in top[i].tolist()


def test_sample_batched_support_and_greedy_rows():
    """Per-row filters: top-k support, top-p support, greedy rows."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0, 0.0]] * 4)
    temps = torch.tensor([1.0, 1.0, 0.0, 1.0])
    top_ks = torch.tensor([2, 0, 0, 0], dtype=torch.int32)
    top_ps = torch.tensor([1.0, 0.8, 1.0, 1.0])
    seen = [set() for _ in range(4)]
    for _ in range(300):
        out = sample_batched(logits, gen, temps, top_ks, top_ps)
        for i, t in enumerate(out.tolist()):
            seen[i].add(t)
    assert seen[0] == {0, 1}
    assert seen[1] == {0, 1}       # cumulative mass 0.63, 0.87, ...
    assert seen[2] == {0}
    assert len(seen[3]) >= 4


GATES = [dict(), dict(prefix_cache=True), dict(host_kv_pages=8),
         dict(speculative=True), dict(speculative=True, paged_attention=False),
         dict(prefix_cache=True, paged=False, host_kv_pages=8),
         dict(speculative=True, paged=False),
         dict(prefix_cache=True, host_kv_pages=8, speculative=True)]


@pytest.mark.parametrize("kw", GATES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_feature_gating_matches_jax(cfg, jparams, tparams, kw):
    """The prefix cache, the host tier and speculation switch on and off
    as in the JAX engine: speculation needs paged attention (without it
    the engine runs with speculation off), and neither the cache nor the
    host tier exists on contiguous strips."""
    base = dict(n_slots=2, max_len=32, page_size=8, paged_attention=True)
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**{**base, **kw}))
    eng = _engine(cfg, tparams, **{**base, **kw})

    def gates(e):
        return (e._prefix_ok, e._spec_ok, e._paged_attn, e._growth,
                e.prefix_cache is None, e.host_pool is None,
                e.perf_stats()["speculative"])
    assert gates(eng) == gates(jeng)


def test_engine_needs_cuda_unless_told(cfg, tparams):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, tparams, EngineConfig())


# the sampler against JAX's: rows of (logits, temperature, top_k, top_p),
# with ties at the top-k threshold and at the top-p cut-off
SAMPLER_ROWS = [
    ([3.0, 2.0, 2.0, 2.0, 1.0, 0.0, -1.0, -2.0], 1.0, 2, 1.0),   # k-th tied
    ([3.0, 2.0, 2.0, 2.0, 1.0, 0.0, -1.0, -2.0], 0.7, 4, 1.0),
    ([2.0, 2.0, 1.0, 1.0, 0.0, 0.0, -1.0, -1.0], 1.0, 0, 0.5),   # p cut tie
    ([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5], 1.3, 0, 0.8),
    ([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5], 1.0, 5, 0.9),  # both
    ([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0], 1.0, 3, 1.0),     # all tied
    ([0.5, 0.4, 0.3, 0.2, 0.1, 0.0, -0.1, -0.2], 2.0, 0, 1.0),   # temp only
    ([4.0, 1.0, 3.0, 0.0, 2.0, -1.0, 1.0, 0.5], 0.0, 3, 0.5),    # greedy
]
SAMPLER_DRAWS = 4000


def _expected_support(logits, temp, top_k, top_p):
    """The distribution both samplers define, in float64: logits over the
    temperature, everything below the k-th largest value masked, then
    everything below the value at which the sorted cumulative mass first
    reaches top_p."""
    lg = np.asarray(logits, np.float64)
    if temp <= 0:
        out = np.zeros_like(lg)
        out[int(np.argmax(lg))] = 1.0
        return out
    lg = lg / temp
    keep = np.ones(lg.shape, bool)
    if top_k > 0:
        keep &= lg >= np.sort(lg)[::-1][top_k - 1]
    if top_p < 1.0:
        srt = np.sort(np.where(keep, lg, -np.inf))[::-1]
        p = np.exp(srt - srt[0])
        cum = np.cumsum(p / p.sum())
        keep &= lg >= srt[min(int((cum < top_p).sum()), len(lg) - 1)]
    p = np.where(keep, np.exp(lg - lg.max()), 0.0)
    return p / p.sum()


def test_sampler_support_and_frequencies_match_jax():
    """ROADMAP C6: per row, the port's sampler and JAX's draw from the
    same support (the float64 definition's, ties at the threshold kept),
    and each one's empirical frequencies pass a chi-square test against
    that distribution (p > 1e-6: the statistic below the chi-square
    quantile for the row's degrees of freedom)."""
    # chi-square 1 - 1e-6 quantiles by degrees of freedom 1..7
    crit = [23.93, 27.63, 30.66, 33.38, 35.89, 38.26, 40.52]
    v = len(SAMPLER_ROWS[0][0])
    logits = np.asarray([r[0] for r in SAMPLER_ROWS] * SAMPLER_DRAWS,
                        np.float32)
    temps, ks, ps = (np.asarray([r[i] for r in SAMPLER_ROWS] * SAMPLER_DRAWS,
                                dt) for i, dt in
                     ((1, np.float32), (2, np.int32), (3, np.float32)))
    got_t = sample_batched(torch.from_numpy(logits),
                           torch.Generator().manual_seed(0),
                           torch.from_numpy(temps), torch.from_numpy(ks),
                           torch.from_numpy(ps)).numpy()
    got_j = np.asarray(jax_sample_batched(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(ks), jnp.asarray(ps)))
    n_rows = len(SAMPLER_ROWS)
    for i, row in enumerate(SAMPLER_ROWS):
        want = _expected_support(*row)
        support = set(np.nonzero(want)[0].tolist())
        for name, got in (("torch", got_t), ("jax", got_j)):
            draws = got[i::n_rows]
            assert set(draws.tolist()) == support, (name, i)
            if len(support) < 2:
                continue
            idx = sorted(support)
            counts = np.bincount(draws, minlength=v)[idx]
            expect = want[idx] * SAMPLER_DRAWS
            chi2 = float(((counts - expect) ** 2 / expect).sum())
            assert chi2 < crit[len(idx) - 2], (name, i, chi2)
