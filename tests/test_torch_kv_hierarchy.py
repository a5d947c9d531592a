"""The port's hierarchical KV memory against the JAX package's: the
refcounted pool, the prefix cache and the host swap tier, on the reduced
OLMo-1B in f32 with the same (carried-across) params, on the CPU through
the kernels' plain versions.

Greedy tokens and the dispatch / host-sync / suffix / swap / KV-byte
counters must equal the JAX engine's at K = 1, 4 and 8: the prefix cache
in the gather and paged-attention modes (its own statistics too), the
prefix cache over a host tier that demotes and promotes blocks, and the
swap cycle.  Where JAX stalls with a cache on a small pool, the port
finishes with the tokens of an uncached run (ROADMAP C8).  The port's
`_prefix_study` reproduces `benchmarks/baseline_serving.json`'s
token-independent counters.  The pool and host-pool properties of
tests/test_kv_hierarchy.py hold for the port's classes, and the suffix
prefill (`attention.suffix_attention`, `transformer.prefill_suffix`)
equals JAX's within 2e-5 (f32)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)
from repro_torch.serving.kv_cache import (PagedKVPool, copy_pages,
                                          put_pages, take_pages)
from repro_torch.serving.kv_hierarchy import (HostPagePool, swap_in_slot,
                                              swap_out_slot)

from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)

F32_TOL = 2e-5
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "suffix_traces",
            "decode_traces", "tokens", "steps", "suffix_prefills",
            "prefill_dispatch_tokens", "swap_outs", "swap_ins",
            "preemptions", "logical_bytes_moved", "cache_hit_rate",
            "paged_attention")
SHARED = list(range(1, 25))            # 24 tokens = 3 pages at size 8
A, B, C = (list(range(o, o + 24)) for o in (1, 101, 201))
# (engine kwargs, serial prompts, budget) per mode; "prefix_host" caches
# over a host tier on a pool small enough that blocks demote and promote
PREFIX_MODES = {
    "gather": (dict(n_slots=4, max_len=48, page_size=8),
               [SHARED + [30, 31], SHARED + [40, 41, 42], SHARED[:12] + [7]],
               8),
    "paged_attention": (dict(n_slots=4, max_len=48, page_size=8,
                             paged_attention=True),
                        [SHARED + [30, 31], SHARED + [40, 41, 42],
                         SHARED[:12] + [7]], 8),
    "prefix_host": (dict(n_slots=2, max_len=32, page_size=8, kv_pages=8,
                         host_kv_pages=16),
                    [A + [30], B + [31], C + [32], A + [34], B + [35, 36]],
                    4),
}


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


def _serial(eng, req_cls, sp_cls, prompts, max_tokens):
    """One request at a time, so each later one sees the prefix pages the
    earlier ones inserted at finish."""
    outs = []
    for p in prompts:
        r = req_cls(model="m", prompt=list(p),
                    sampling=sp_cls(max_tokens=max_tokens))
        assert eng.submit(r)
        eng.run_until_done()
        outs.append(tuple(r.output))
    return outs


def _run(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done()
    return [tuple(r.output) for r in reqs]


def _work(req_cls, sp_cls, n=6, max_tokens=20):
    return [req_cls(model="m", prompt=list(range(1, 3 + i)),
                    sampling=sp_cls(max_tokens=max_tokens))
            for i in range(n)]


def _stats(eng):
    st = eng.perf_stats()
    return {c: st[c] for c in COUNTERS}, st.get("prefix_cache")


# ------------------- engine parity ----------------------------------- #
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(PREFIX_MODES))
def test_prefix_cache_tokens_and_counters_match_jax(cfg, jparams, tparams,
                                                    mode, k):
    kw, prompts, budget = PREFIX_MODES[mode]
    kw = dict(kw, decode_block=k, prefix_cache=True)
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**kw))
    want = _serial(jeng, JaxRequest, JaxSampling, prompts, budget)
    eng = InferenceEngine(cfg, tparams, EngineConfig(**kw), device="cpu")
    assert _serial(eng, Request, SamplingParams, prompts, budget) == want
    got, jax_stats = _stats(eng), _stats(jeng)
    assert got[0] == jax_stats[0]
    if mode != "prefix_host":
        # over a host tier the port also demotes entries whose children
        # are all demoted, where JAX pins them (ROADMAP C8): the cache's
        # own demotion and promotion counts may differ
        assert got[1] == jax_stats[1]
    st = eng.perf_stats()
    assert st["suffix_prefills"] >= 2
    if mode == "prefix_host":
        assert st["prefix_cache"]["demotions"] >= 1
        assert st["prefix_cache"]["promotions"] >= 1
    # an uncached engine gives the same tokens: caching is never a
    # numerics change
    off = InferenceEngine(cfg, tparams, EngineConfig(
        **{**kw, "prefix_cache": False, "host_kv_pages": 0,
           "kv_pages": 0}), device="cpu")
    assert _serial(off, Request, SamplingParams, prompts, budget) == want
    res = eng.flush_prefix_cache()
    assert res["flushed"] > 0 and res["remaining"] == 0
    assert eng.pool.pages_in_use == 0
    assert eng.host_pool is None or eng.host_pool.in_use == 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_swap_cycle_tokens_and_counters_match_jax(cfg, jparams, tparams, k):
    """Oversubscribed pages with a host tier: preempted slots park on the
    host and resume by upload, with the tokens of an uncontended run and
    JAX's counters; both tiers drain."""
    kw = dict(n_slots=6, max_len=48, page_size=8, kv_pages=18,
              decode_block=k, host_kv_pages=64)
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**kw))
    want = _run(jeng, _work(JaxRequest, JaxSampling))
    eng = InferenceEngine(cfg, tparams, EngineConfig(**kw), device="cpu")
    assert _run(eng, _work(Request, SamplingParams)) == want
    assert _stats(eng) == _stats(jeng)
    assert eng.swap_outs >= 1
    assert eng.swap_outs == eng.preemptions
    assert eng.swap_ins == eng.swap_outs
    ref = InferenceEngine(cfg, tparams, EngineConfig(
        n_slots=6, max_len=48, page_size=8, decode_block=k), device="cpu")
    assert _run(ref, _work(Request, SamplingParams)) == want
    assert eng.pool.pages_in_use == 0 and eng.host_pool.in_use == 0


def test_second_request_prefills_only_suffix(cfg, tparams):
    p1 = SHARED + [30] * 8                 # 32 tokens
    p2 = SHARED + [40] * 8                 # shares the first 24
    eng = InferenceEngine(cfg, tparams, EngineConfig(
        n_slots=4, max_len=48, page_size=8, decode_block=4,
        prefix_cache=True), device="cpu")
    _serial(eng, Request, SamplingParams, [p1], 4)
    cold = eng.prefill_dispatch_tokens
    _serial(eng, Request, SamplingParams, [p2], 4)
    assert eng.prefix_cache.matched_tokens == 24
    assert eng.suffix_prefills == 1
    assert (eng.prefill_dispatch_tokens - cold) * 4 <= cold
    # page pressure nets the cache's evictable leaves out
    assert eng.page_pressure() == (
        (eng.pool.pages_in_use - eng.prefix_cache.evictable_device_pages())
        / eng.pool.n_pages) < eng.pool.page_occupancy()


def _prefix_study(cfg, params, n_requests=10, max_tokens=12):
    """`benchmarks/bench_serving.py::_prefix_study` on the port: every
    request carries the same 32-token system prefix plus a private 8-token
    tail; warm-up, flush, then the requests one at a time."""
    shared = list(range(1, 33))
    prompts = [shared + [40 + i, 50 + i, 60 + i, 70 + i,
                         40 + i, 50 + i, 60 + i, 71 + i]
               for i in range(n_requests)]
    out, outputs = {}, {}
    for name, on in (("cache_off", False), ("cache_on", True)):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=64, decode_block=4, page_size=8,
            prefix_cache=on), device="cpu")
        for p in ([99] * 40, [99] * 32 + [98] * 8):
            _serial(eng, Request, SamplingParams, [p], 2)
        if on:
            eng.flush_prefix_cache()
            cache_base = eng.prefix_cache.stats()
        base = eng.perf_stats()
        outputs[name] = _serial(eng, Request, SamplingParams, prompts,
                                max_tokens)
        stats = eng.perf_stats()
        out[name] = {k: stats[k] - base[k] for k in
                     ("prefill_dispatch_tokens", "suffix_prefills")}
        if on:
            cs = eng.prefix_cache.stats()
            out[name]["prefix_hit_rate"] = (
                (cs["hits"] - cache_base["hits"])
                / max(cs["lookups"] - cache_base["lookups"], 1))
    assert outputs["cache_on"] == outputs["cache_off"]
    return out


def test_prefix_study_reproduces_the_baseline_counters(cfg, tparams):
    base = json.loads((Path(__file__).resolve().parents[1] / "benchmarks"
                       / "baseline_serving.json").read_text())["prefix"]
    got = _prefix_study(cfg, tparams)
    for name in ("cache_off", "cache_on"):
        for key in ("prefill_dispatch_tokens", "suffix_prefills"):
            assert got[name][key] == base[name][key]
    assert got["cache_on"]["prefix_hit_rate"] == \
        base["cache_on"]["prefix_hit_rate"] == 0.9
    assert (got["cache_off"]["prefill_dispatch_tokens"],
            got["cache_on"]["prefill_dispatch_tokens"]) == (640, 136)
    assert got["cache_on"]["suffix_prefills"] == 9


@pytest.mark.parametrize("kv_pages", [8, 14])
def test_cache_over_a_small_pool_never_stalls(cfg, tparams, kv_pages):
    """ROADMAP C8: on these pools the JAX engine stalls (a lone slot's
    growth preempts it instead of reclaiming cache pages, or an idle
    engine's budget counts only evictable leaves).  The port reclaims at
    growth and flushes the unpinned cache when idle with work queued:
    every request finishes with the tokens of an uncached run."""
    prompts = [p + [30 + i] for i, p in enumerate(
        [A[:16], B[:16], C[:16], list(range(51, 67)), A[:16] + [34],
         B[:16]])]
    ref = _serial(InferenceEngine(cfg, tparams, EngineConfig(
        n_slots=2, max_len=32, page_size=8, decode_block=4), device="cpu"),
        Request, SamplingParams, prompts, 8)
    eng = InferenceEngine(cfg, tparams, EngineConfig(
        n_slots=2, max_len=32, page_size=8, decode_block=4,
        kv_pages=kv_pages, prefix_cache=True, host_kv_pages=16),
        device="cpu")
    assert _serial(eng, Request, SamplingParams, prompts, 8) == ref
    assert all(len(o) == 8 for o in ref)
    eng.flush_prefix_cache()
    assert eng.pool.pages_in_use == 0 and eng.host_pool.in_use == 0


def test_cancel_drops_a_parked_request(cfg, tparams):
    """A request cancelled while parked in the host tier gives back its
    host pages and any device pages its handle kept."""
    eng = InferenceEngine(cfg, tparams, EngineConfig(
        n_slots=6, max_len=48, page_size=8, kv_pages=18, decode_block=4,
        host_kv_pages=64), device="cpu")
    reqs = _work(Request, SamplingParams)
    for r in reqs:
        assert eng.submit(r)
    for _ in range(200):
        if eng._swapped:
            break
        eng.step()
    rid = next(iter(eng._swapped))
    assert eng.cancel(rid) == "queued"
    assert rid not in eng._swapped
    eng.run_until_done()
    assert eng.pool.pages_in_use == 0 and eng.host_pool.in_use == 0


# ------------------- pool units -------------------------------------- #
def test_write_table_masks_shared_pages():
    pool = PagedKVPool(n_slots=3, max_len=32, page_size=8, n_pages=12)
    s0 = pool.alloc(1, 20)                 # 3 pages
    assert torch.equal(pool.write_table(), pool.page_table())
    shared = pool.slot_pages[s0][:2]
    s1 = pool.alloc(2, 20, shared_pages=shared)
    wt, pt = pool.write_table().numpy(), pool.page_table().numpy()
    assert (pt[s1, :2] == shared).all() and (wt[s1, :2] == 12).all()
    assert (wt[s0, :2] == 12).all() and wt[s0, 2] == pt[s0, 2]
    assert pool.refs[shared[0]] == 2
    old_new = pool.cow_page(s1, 0)
    assert old_new is not None and old_new[0] == shared[0]
    assert pool.refs[shared[0]] == 1
    assert pool.write_table().numpy()[s0, 0] == shared[0]
    pool.release(s0)
    pool.release(s1)
    assert pool.pages_in_use == 0 and not pool.refs


def test_page_movers_refuse_the_scratch_page():
    paged = {"k": torch.randn(2, 9, 4, 1, 3), "v": torch.randn(2, 9, 4, 1, 3)}
    before = {k: v.clone() for k, v in paged.items()}
    copy_pages(paged, [1, 2], [5, 6])
    for k in paged:
        assert torch.equal(paged[k][:, 5:7], before[k][:, 1:3])
    for bad in ([8], [-1], [9]):
        with pytest.raises(ValueError):
            take_pages(paged, bad)
        with pytest.raises(ValueError):
            copy_pages(paged, [0], bad)
        with pytest.raises(ValueError):
            put_pages(paged, bad, {k: v[:, :1] for k, v in paged.items()})


def test_swap_roundtrip_preserves_pages_and_freelists_disjoint():
    """Swap-out and swap-in of one slot: page payloads survive the host
    round trip bit for bit, handle pages never sit on the device free
    list, and host ids come from the host pool's own id space."""
    pool = PagedKVPool(n_slots=2, max_len=32, page_size=4, n_pages=16)
    gen = torch.Generator().manual_seed(0)
    paged = {"k": torch.randn(2, 17, 4, 1, 3, generator=gen),
             "v": torch.randn(2, 17, 4, 1, 3, generator=gen)}
    host = HostPagePool(8, paged)
    s = pool.alloc(1, 10)                  # 3 pages
    before = {i: paged["k"][:, p].clone()
              for i, p in enumerate(pool.slot_pages[s])}
    handle = swap_out_slot(pool, host, paged, s)
    assert handle is not None and handle.n_tokens == 10
    assert pool.n_active == 0
    assert host.in_use == len(handle.host) == 3
    assert set(pool.free_pages).isdisjoint(p for _, p in handle.kept)
    for p in range(16):                    # scribble over the freed pages
        paged["k"][:, p] = -1.0
    restored = swap_in_slot(pool, host, paged, handle)
    assert restored is not None and restored[1]
    slot = restored[0]
    assert pool.lengths[slot] == 10
    for i, p in enumerate(pool.slot_pages[slot]):
        assert torch.equal(paged["k"][:, p], before[i])
    assert host.in_use == 0
    assert host.swapped_out == host.swapped_in == 3
    pool.release(slot)
    assert pool.pages_in_use == 0


def test_swap_keeps_shared_pages_on_the_device():
    pool = PagedKVPool(n_slots=2, max_len=32, page_size=4, n_pages=16)
    paged = {k: torch.randn(1, 17, 4, 1, 2) for k in ("k", "v")}
    host = HostPagePool(8, paged)
    s0 = pool.alloc(1, 12)
    shared = pool.slot_pages[s0][:2]
    s1 = pool.alloc(2, 12, shared_pages=shared)
    handle = swap_out_slot(pool, host, paged, s1)
    assert [p for _, p in handle.kept] == shared
    assert len(handle.host) == 1 and host.in_use == 1
    assert all(pool.refs[p] == 2 for p in shared)
    slot, uploaded = swap_in_slot(pool, host, paged, handle)
    assert uploaded and pool.slot_pages[slot][:2] == shared
    pool.release(slot)
    pool.release(s0)
    assert pool.pages_in_use == 0 and not pool.refs


# ------------------- allocator properties --------------------------- #
@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(1, 40)),
                min_size=1, max_size=40))
def test_refcounted_pool_no_leak_no_double_free(ops):
    """Random alloc/share/release/orphan traffic: the free list never
    holds duplicates or referenced pages, refcounts never reach zero while
    tracked, and full teardown returns every page exactly once."""
    pool = PagedKVPool(n_slots=6, max_len=64, page_size=8, n_pages=48)
    rid = iter(range(100_000))
    live, orphans = [], []
    for op, n in ops:
        if op == 0:                        # alloc, maybe sharing pages
            shared = []
            if live:
                donor = pool.slot_pages[live[0]]
                shared = list(donor[:min(len(donor), n % 3)])
            want = len(shared) * 8 + (n % 8) + 1
            s = pool.alloc(next(rid), want, shared_pages=shared)
            if s is not None:
                live.append(s)
        elif op == 1 and live:
            pool.release(live.pop(n % len(live)))
        elif op == 2:                      # cache-style orphan claims
            pages = pool.alloc_pages(n % 4)
            if pages:
                orphans.append(pages)
            elif orphans and n % 2:
                for p in orphans.pop():
                    pool.free_page(p)
        free = pool.free_pages
        assert len(set(free)) == len(free)            # no double free
        assert set(free).isdisjoint(pool.refs)        # no free+live page
        assert all(r >= 1 for r in pool.refs.values())
        wt = pool.write_table().numpy()
        for p, r in pool.refs.items():                # shared => masked
            assert (p in wt) == (r == 1 and p in pool._table)
    for s in live:
        pool.release(s)
    for pages in orphans:
        for p in pages:
            pool.free_page(p)
    assert pool.pages_in_use == 0                     # no leak
    assert sorted(pool.free_pages) == list(range(pool.n_pages))
    assert not pool.refs


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(1, 6), min_size=1, max_size=25))
def test_host_pool_ids_unique_and_accounted(sizes):
    """Host ids are handed out at most once while outstanding, accounting
    is exact, over-capacity puts fail atomically, a round trip keeps each
    page's data, and a double free raises."""
    host = HostPagePool(24, {"k": torch.zeros(1, 1, 2)})
    held = []
    for i, n in enumerate(sizes):
        blocks = {"k": torch.arange(n * 2, dtype=torch.float32)
                  .reshape(1, n, 2) + 100 * i}
        ids = host.put(blocks, n)
        outstanding = [h for lst, _ in held for h in lst]
        if ids is None:
            assert not host.can_hold(n)               # atomic failure
            if held:
                host.release(held.pop(0)[0], restored=bool(i % 2))
            continue
        assert len(set(ids)) == len(ids)
        assert set(ids).isdisjoint(outstanding)
        held.append((ids, blocks["k"]))
        assert host.in_use == len(outstanding) + len(ids)
    for ids, data in held:
        assert torch.equal(host.get(ids)["k"], data)
        host.release(ids, restored=True)
    assert host.in_use == 0
    assert sorted(host.free_ids) == list(range(24))
    ids = host.put({"k": torch.zeros(1, 1, 2)}, 1)
    host.free(ids)
    with pytest.raises(ValueError):
        host.free(ids)


# ------------------- the suffix prefill ------------------------------ #
def test_suffix_attention_matches_jax():
    rng = np.random.default_rng(0)
    b, qn, h, nkv, s, hd = 3, 5, 4, 2, 24, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((b, qn, h, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
    q_pos = np.array([[0, 1, 2, 3, 4], [8, 9, 10, 11, 12],
                      [19, 20, 21, 22, 23]], np.int32)
    want = np.asarray(jax_attn.suffix_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos)))
    got = attn_lib.suffix_attention(*(torch.from_numpy(a) for a in
                                      (q, k, v, q_pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


def test_prefill_suffix_matches_jax(cfg, jparams, tparams):
    """Rows with cached prefixes at offsets 0, 8 and 40 (the last one's
    bucket runs past the view, so its padding positions drop), cache views
    of garbage past each offset: logits, positions and every cache entry
    equal JAX's."""
    rng = np.random.default_rng(1)
    s_view, bucket = 48, 16
    offsets = np.array([0, 8, 40], np.int32)
    lengths = np.array([5, 16, 8], np.int32)
    tokens = rng.integers(0, cfg.vocab, (3, bucket)).astype(np.int32)
    shape = (cfg.n_layers, 3, s_view, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    jl, jc, jpos = jax_tf.prefill_suffix(
        jparams, cfg, {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(tokens), jnp.asarray(offsets), jnp.asarray(lengths))
    view = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    logits, out, pos = tf.prefill_suffix(
        tparams, cfg, view, torch.from_numpy(tokens).long(),
        torch.from_numpy(offsets), torch.from_numpy(lengths))
    assert out is view
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)
    assert pos.tolist() == np.asarray(jpos).tolist()
    for n in ("k", "v"):
        np.testing.assert_allclose(view[n].numpy(), np.asarray(jc[n]),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_prefix_cache_tenant_salt_and_device_cap():
    """Blocks are keyed per tenant unless `share_tenants`, and
    `max_device_pages` caps the pages the cache pins: an insert past the
    cap evicts an unpinned entry first, and stops when none is."""
    from repro_torch.serving.kv_hierarchy import PrefixCache
    toks = list(range(40))                 # 5 blocks of 8
    for share in (False, True):
        pool = PagedKVPool(n_slots=2, max_len=64, page_size=8, n_pages=16)
        cache = PrefixCache(pool, share_tenants=share)
        s = pool.alloc(1, 40)
        assert cache.insert("a", toks, 40, pool.slot_pages[s]) == 5
        pool.release(s)
        assert cache.peek("a", toks, 39) == 32
        assert cache.peek("b", toks, 39) == (32 if share else 0)
        assert cache.match("b", toks, 39)[1] == (32 if share else 0)
    pool = PagedKVPool(n_slots=2, max_len=64, page_size=8, n_pages=16)
    cache = PrefixCache(pool, max_device_pages=3)
    s = pool.alloc(1, 40)
    entries, _, _ = cache.match("a", toks, 39)
    assert entries == []
    assert cache.insert("a", toks, 24, pool.slot_pages[s]) == 3
    assert cache.device_pages == 3
    cache.bind(7, cache.match("a", toks, 39)[0])     # pin all three
    pool.release(s)
    s2 = pool.alloc(2, 40)
    other = [t + 100 for t in toks]
    assert cache.insert("a", other, 16, pool.slot_pages[s2]) == 0
    cache.unbind(7)
    # two new blocks, each after evicting the oldest unpinned leaf
    assert cache.insert("a", other, 16, pool.slot_pages[s2]) == 2
    assert cache.device_pages == 3 and cache.evictions == 2
    assert cache.peek("a", toks, 39) == 8
    pool.release(s2)
    cache.flush()
    assert pool.pages_in_use == 0
