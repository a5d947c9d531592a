"""The port's engine in the JAX engine's other decode modes and under
weight quantization, against the JAX engine, on the reduced OLMo-1B in
f32 and on a reduced llama3.2-1b in f32 with grouped-query attention
(G = 4) and RMS-norm scales drawn from a seed, each with the same
(carried-across) params, on the CPU through the
kernels' plain versions: the gather mode (the default), contiguous
strips (`paged=False`), and the gather mode with int8 and with int4
weights.  Greedy tokens and the dispatch / host-sync / program / KV-byte
counters must equal JAX's at K = 1, 4, 8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, ZOO
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)

torch.set_num_threads(2)

MODES = {"gather": {}, "contiguous": dict(paged=False),
         "int8": dict(quantize="int8"), "int4": dict(quantize="int4")}
COUNTERS = ("dispatches", "host_syncs", "prefill_traces", "decode_traces",
            "tokens", "steps", "logical_bytes_moved", "paged",
            "paged_attention")
BASE = dict(n_slots=4, max_len=64, page_size=8)


CONFIGS = {
    # its own name: param_store caches by name
    "olmo": ARCHS["olmo-1b"].reduced(dtype="f32",
                                     name="olmo-1b-reduced-f32"),
    "llama-g4": ZOO["llama3.2-1b"].reduced(dtype="f32", n_kv_heads=1,
                                           name="llama3.2-1b-g4-f32"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def cfg(request):
    return CONFIGS[request.param]


@pytest.fixture(scope="module")
def jparams(cfg, param_store):
    """The shared `param_store` fixture's JAX params, with every RMS-norm
    scale drawn from a numpy seed (the init leaves them 0, so `1 + scale`
    would be 1)."""
    params = dict(param_store(cfg))
    if cfg.norm == "rms":
        rng = np.random.default_rng(5)
        layers = dict(params["layers"])
        for name in ("ln1", "ln2"):
            layers[name] = jnp.asarray(
                rng.normal(0.0, 0.5, layers[name].shape), jnp.float32)
        params["layers"] = layers
        params["final_norm"] = jnp.asarray(
            rng.normal(0.0, 0.5, params["final_norm"].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def tparams(cfg, jparams):
    return params_lib.from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _run(eng, reqs):
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_done()
    return [tuple(r.output) for r in reqs]


def _work(req_cls, sp_cls):
    """The workload of tests/test_paged_attention.py."""
    return [req_cls(model="m", prompt=list(range(1, 2 + i)),
                    sampling=sp_cls(max_tokens=10 + i)) for i in range(5)]


@pytest.fixture(scope="module")
def jax_runs(cfg, jparams):
    out = {}
    for mode, kw in MODES.items():
        for k in (1, 4, 8):
            eng = JaxEngine(cfg, jparams, JaxEngineConfig(
                decode_block=k, **BASE, **kw))
            toks = _run(eng, _work(JaxRequest, JaxSampling))
            out[mode, k] = (toks, {c: eng.perf_stats()[c] for c in COUNTERS})
    return out


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_and_counters_match_jax(cfg, tparams, jax_runs, mode, k):
    eng = InferenceEngine(cfg, tparams, EngineConfig(
        decode_block=k, **BASE, **MODES[mode]), device="cpu")
    toks = _run(eng, _work(Request, SamplingParams))
    want_toks, want_stats = jax_runs[mode, k]
    assert toks == want_toks
    stats = eng.perf_stats()
    assert {c: stats[c] for c in COUNTERS} == want_stats
    assert eng.pool.pages_in_use == 0


@pytest.mark.parametrize("mode", ["gather", "contiguous"])
def test_run_to_the_cache_end_matches_jax(cfg, jparams, tparams, mode):
    """max_len % page_size == 0: the request decodes until pos == max_len
    mid-block, and the block's remaining steps write at pos == max_len,
    one past the strip or view (JAX clamps that write to max_len - 1)."""
    kw = dict(n_slots=2, max_len=32, page_size=8, decode_block=8,
              **MODES[mode])
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**kw))
    jr = JaxRequest(model="m", prompt=[3, 1, 4, 1, 5],
                    sampling=JaxSampling(max_tokens=100))
    _run(jeng, [jr])
    eng = InferenceEngine(cfg, tparams, EngineConfig(**kw), device="cpu")
    r = Request(model="m", prompt=[3, 1, 4, 1, 5],
                sampling=SamplingParams(max_tokens=100))
    _run(eng, [r])
    assert len(jr.output) == 32 - 5 + 1      # stopped by the cache end
    assert r.output == jr.output
    assert eng.pool.pages_in_use == 0


def test_int8_param_bytes(cfg, jparams, tparams):
    """int8 at rest is under 0.65 x the f32 model (as
    tests/test_serving.py holds JAX to), and its q and scale bytes equal
    JAX's tree_bytes less JAX's 0-d `dtype` markers."""
    from repro.serving import quantization as jq
    full = InferenceEngine(cfg, tparams, EngineConfig(**BASE), device="cpu")
    eng = InferenceEngine(cfg, tparams, EngineConfig(quantize="int8", **BASE),
                          device="cpu")
    got = eng.memory_report()["param_bytes"]
    assert got < 0.65 * full.memory_report()["param_bytes"]
    jtree = jq.quantize_tree(jparams, bits=8)
    markers = sum(leaf.size * leaf.dtype.itemsize for path, leaf in
                  jax.tree_util.tree_leaves_with_path(jtree)
                  if path[-1].key == "dtype")
    assert got == jq.tree_bytes(jtree) - markers
