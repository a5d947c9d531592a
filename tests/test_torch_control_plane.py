"""The port's control plane against the JAX package's, module by module.

The sixteen modules the port copies verbatim equal the reference's but for
their imports.  The seven that differ say why, and are held by behaviour:
the hardware table keeps, node for node of the paper's testbed, the
reference's memory and legacy flag, so VRAM-aware placement gives the
same plans (each assignment charged the bytes the port's engine
allocates, ROADMAP.md C14); the cost-optimal solver, the perf model and the roofline
agree when both packages are given the same capability vectors.  (The
gateway's one change, `result()` and `generate_batch()` waiting without a
spin, is held by tests/test_torch_gateway.py and the ported runtime
tests; the wire server's TCP_NODELAY and the launcher by
tests/test_torch_http.py.)  Then the engine surface the control plane
reads (`alive`, `n_active`, `load`) and the host tier's `fail_puts`
hook, each against the JAX engine's, and the kernel wrappers' launch
counters under concurrent threads."""
import dataclasses
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.cluster import fleet as jax_fleet
from repro.cluster import hardware as jax_hw
from repro.configs import ARCHS, ZOO
from repro.core import perfmodel as jax_perf
from repro.core import placement as jax_place
from repro.roofline import analysis as jax_roof
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch import params as params_lib
from repro_torch.cluster import fleet as port_fleet
from repro_torch.cluster import hardware as port_hw
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import ZOO as PORT_ZOO
from repro_torch.core import perfmodel as port_perf
from repro_torch.core import placement as port_place
from repro_torch.kernels import ops
from repro_torch.roofline import analysis as port_roof
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)
from repro_torch.serving.kv_hierarchy import HostPagePool

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1] / "src"
VERBATIM = ["core/events.py", "core/registry.py", "core/health.py",
            "core/perfmodel.py", "cluster/faults.py", "core/placement.py",
            "core/frontend.py", "core/controller.py", "api/types.py",
            "api/admin.py", "api/runtime.py", "core/wizard.py",
            "core/client.py", "api/http/chat.py", "api/http/schemas.py",
            "api/http/client.py"]
DIFFERS = ["cluster/hardware.py", "cluster/node.py", "cluster/fleet.py",
           "roofline/analysis.py", "api/gateway.py", "api/http/server.py",
           "api/http/__main__.py"]
MODELS = ["llama3.2-1b", "deepseek-r1-7b", "qwen3-8b"]


@pytest.mark.parametrize("name", VERBATIM)
def test_verbatim_copies_equal_reference(name):
    """Each copy equals the reference's but for `from repro_torch.` in its
    imports."""
    ref = (ROOT / "repro" / name).read_text()
    port = (ROOT / "repro_torch" / name).read_text()
    assert "from repro." not in port
    assert port.replace("from repro_torch.", "from repro.") == ref


@pytest.mark.parametrize("name", DIFFERS)
def test_differing_modules_say_why_and_carry_no_tpu_figure(name):
    text = (ROOT / "repro_torch" / name).read_text()
    assert "differs from" in text
    for word in ("TPU", "v5e", "v5lite", "v5p", "v2-legacy", "XLA", "ICI",
                 "197e12", "819e9"):
        assert word not in text, word


def test_testbed_memory_and_legacy_match_reference():
    jax_nodes = jax_fleet.paper_testbed().nodes
    port_nodes = port_fleet.paper_testbed().nodes
    assert list(port_nodes) == list(jax_nodes)
    for nid, jn in jax_nodes.items():
        pn = port_nodes[nid]
        assert (pn.hbm_budget, pn.klass.legacy, pn.klass.chips,
                pn.klass.hbm_per_chip) == (jn.hbm_budget, jn.klass.legacy,
                                           jn.klass.chips,
                                           jn.klass.hbm_per_chip)
    assert port_hw.RUNTIME_RESERVE_FRACTION == \
        jax_hw.RUNTIME_RESERVE_FRACTION
    # the datacenter classes that stand in for the reference's scale-out
    # ones keep their memory and card counts (all but the 8x H100)
    for jname, pname in (("v5e-4", "v100-16gb-x4"),
                         ("v5e-8", "v100-16gb-x8")):
        j, p = jax_hw.NODE_CLASSES[jname], port_hw.NODE_CLASSES[pname]
        assert (p.hbm_total, p.chips, p.legacy) == (j.hbm_total, j.chips,
                                                    j.legacy)


def test_scale_fleet_builds_the_reference_memory_layout():
    jf, pf = jax_fleet.scale_fleet(200, seed=5), port_fleet.scale_fleet(
        200, seed=5)
    assert [(n.hbm_budget, n.klass.legacy) for n in pf.nodes.values()] == \
        [(n.hbm_budget, n.klass.legacy) for n in jf.nodes.values()]


def _plan(plan):
    """A plan's decisions: every assignment but its bytes, which the
    port charges as its engine allocates them (ROADMAP.md C14) and
    `_held_to_port_bytes` checks."""
    return ([dataclasses.astuple(dataclasses.replace(a, bytes=0))
             for a in plan.assignments], list(plan.unplaced))


def _held_to_port_bytes(plan, demands):
    """Each of the port's assignments carries the port's charge."""
    from repro_torch.cluster.node import instance_bytes
    cfgs = {d.cfg.name: d.cfg for d in demands}
    for a in plan.assignments:
        assert a.bytes == instance_bytes(cfgs[a.model_name], a.quantize,
                                         a.n_slots, a.max_len, a.page_size,
                                         a.kv_pages)
    return plan


def _demands(mod, zoo, archs):
    return [mod.ModelDemand(zoo["llama3.2-1b"], min_replicas=3,
                            max_replicas=5, max_len=2048),
            mod.ModelDemand(zoo["deepseek-r1-7b"], min_replicas=2,
                            max_len=4096),
            mod.ModelDemand(zoo["qwen3-8b"], min_replicas=1, max_len=1024,
                            kv_page_frac=0.5),
            mod.ModelDemand(archs["olmo-1b"], min_replicas=2, n_slots=8,
                            max_len=1024, allow_quant=False),
            mod.ModelDemand(archs["olmo-1b"].reduced(), min_replicas=2,
                            n_slots=2, max_len=48)]


@pytest.mark.parametrize("fill", [True, False])
def test_vram_placement_plans_match_reference(fill):
    jn = {nid: (n.hbm_free, n.klass.legacy)
          for nid, n in jax_fleet.paper_testbed().nodes.items()}
    pn = {nid: (n.hbm_free, n.klass.legacy)
          for nid, n in port_fleet.paper_testbed().nodes.items()}
    assert pn == jn
    for k in range(1, 6):
        jd = _demands(jax_place, ZOO, ARCHS)[:k]
        pd = _demands(port_place, PORT_ZOO, PORT_ARCHS)[:k]
        assert _plan(_held_to_port_bytes(
            port_place.place(pn, pd, fill=fill), pd)) == \
            _plan(jax_place.place(jn, jd, fill=fill))
        assert _plan(_held_to_port_bytes(
            port_place.place_naive(pn, pd), pd)) == \
            _plan(jax_place.place_naive(jn, jd))


def _classes():
    """The reference's capability vectors, built in both packages."""
    return [(c, port_hw.NodeClass(**dataclasses.asdict(c)))
            for c in jax_hw.NODE_CLASSES.values()]


def test_cost_optimal_placement_matches_reference():
    layout = [("a", "v5lite-1"), ("b", "v2-legacy"), ("c", "v5e-1"),
              ("d", "v2-legacy-2"), ("e", "v5e-4"), ("f", "v5p-8")]
    vecs = {c.name: (c, p) for c, p in _classes()}
    jn = {nid: jax_place.NodeSpec(vecs[k][0].hbm_total, vecs[k][0])
          for nid, k in layout}
    pn = {nid: port_place.NodeSpec(vecs[k][1].hbm_total, vecs[k][1])
          for nid, k in layout}
    jd = _demands(jax_place, ZOO, ARCHS)
    pd = _demands(port_place, PORT_ZOO, PORT_ARCHS)
    jd[0] = dataclasses.replace(jd[0], target_tokens_per_s=4000.0)
    pd[0] = dataclasses.replace(pd[0], target_tokens_per_s=4000.0)
    for fill in (True, False):
        assert _plan(_held_to_port_bytes(port_place.place_cost_optimal(
            pn, pd, port_perf.PerfModel(), fill=fill), pd)) == _plan(
            jax_place.place_cost_optimal(jn, jd, jax_perf.PerfModel(),
                                         fill=fill))


def test_perf_model_matches_reference():
    jm, pm = jax_perf.PerfModel(), port_perf.PerfModel()
    pairs = _classes()
    for name in MODELS:
        jc, pc = ZOO[name], PORT_ZOO[name]
        for jb, pb in zip(jax_perf.BUCKETS, port_perf.BUCKETS):
            for c, p in pairs:
                for phase in ("prefill", "decode"):
                    for q in ("", "int8", "int4"):
                        assert dataclasses.astuple(
                            pm.estimate(p, pc, phase, pb, q)) == \
                            dataclasses.astuple(
                                jm.estimate(c, jc, phase, jb, q))
            assert pm.routing_scores([p for _, p in pairs], pc, pb) == \
                jm.routing_scores([c for c, _ in pairs], jc, jb)


def test_roofline_step_matches_reference_with_explicit_peaks():
    assert (port_roof.PEAK_FLOPS, port_roof.HBM_BW) == (989e12, 3.35e12)
    for flops, nbytes, peak, bw in ((1e12, 1e9, 197e12, 819e9),
                                    (3e9, 4e10, 989e12, 3.35e12),
                                    (1.0, 1.0, 0.0, 1.0),
                                    (5e14, 2e12, 23e12, 300e9)):
        assert port_roof.roofline_step_s(flops, nbytes, peak, bw) == \
            jax_roof.roofline_step_s(flops, nbytes, peak, bw)


# ------------------- the engine surface ------------------------------ #
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


def _surface(eng):
    return eng.alive, eng.n_active, eng.load


def test_engine_surface_matches_reference(cfg, jparams, tparams):
    """`alive`, `n_active` and `load` (slots + queue depth) step for step
    through a run that queues, and after a crash."""
    kw = dict(n_slots=2, max_len=48, decode_block=4)
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**kw))
    eng = InferenceEngine(cfg, tparams, EngineConfig(**kw), device="cpu")
    assert _surface(eng) == _surface(jeng) == (True, 0, 0)
    for i in range(4):
        jeng.submit(JaxRequest(model="m", prompt=[1, 2, i + 3],
                               sampling=JaxSampling(max_tokens=6 + i)))
        eng.submit(Request(model="m", prompt=[1, 2, i + 3],
                           sampling=SamplingParams(max_tokens=6 + i)))
    assert _surface(eng) == _surface(jeng) == (True, 0, 4)
    seen = set()
    while jeng.slot_req or jeng.scheduler.depth:
        jeng.step()
        eng.step()
        assert _surface(eng) == _surface(jeng)
        seen.add(_surface(eng))
    assert (True, 2, 4) in seen and (True, 0, 0) in seen
    eng.submit(Request(model="m", prompt=[5], sampling=SamplingParams(
        max_tokens=30)))
    jeng.submit(JaxRequest(model="m", prompt=[5], sampling=JaxSampling(
        max_tokens=30)))
    eng.step()
    jeng.step()
    assert _surface(eng) == _surface(jeng) == (True, 1, 1)
    eng.fail()
    jeng.fail()
    assert _surface(eng) == _surface(jeng)
    assert not eng.alive


def test_host_pool_fail_puts_semantics():
    """The swap-tier outage hook: while set, `can_hold` is False and
    `put` refuses unless forced; pages already parked stay readable."""
    like = {"k": torch.zeros(2, 1, 4, 3)}
    pool = HostPagePool(4, like)
    blocks = {"k": torch.arange(2 * 2 * 4 * 3, dtype=torch.float32)
              .reshape(2, 2, 4, 3)}
    ids = pool.put(blocks, 2)
    assert ids is not None and pool.can_hold(2)
    pool.fail_puts = True
    assert not pool.can_hold(1)
    assert pool.put(blocks, 1) is None and pool.in_use == 2
    assert torch.equal(pool.get(ids)["k"], blocks["k"])
    forced = pool.put(blocks, 1, force=True)
    assert forced is not None and pool.in_use == 3
    pool.release(ids + forced, restored=True)
    pool.fail_puts = False
    assert pool.can_hold(4) and pool.in_use == 0


@pytest.mark.parametrize("k", [1, 4])
def test_swap_fail_falls_back_to_recompute_like_reference(cfg, jparams,
                                                           tparams, k):
    """With the host tier refusing puts for the whole run, every
    preemption recomputes: the same preemptions, no swap, the tokens and
    counters of the JAX engine under the same flag."""
    kw = dict(n_slots=6, max_len=48, page_size=8, kv_pages=18,
              decode_block=k, host_kv_pages=64)
    jeng = JaxEngine(cfg, jparams, JaxEngineConfig(**kw))
    eng = InferenceEngine(cfg, tparams, EngineConfig(**kw), device="cpu")
    jeng.host_pool.fail_puts = eng.host_pool.fail_puts = True
    outs = []
    for e, req, sp in ((jeng, JaxRequest, JaxSampling),
                       (eng, Request, SamplingParams)):
        reqs = [req(model="m", prompt=list(range(1, 3 + i)),
                    sampling=sp(max_tokens=20)) for i in range(6)]
        for r in reqs:
            assert e.submit(r)
        e.run_until_done()
        st = e.perf_stats()
        outs.append(([tuple(r.output) for r in reqs],
                     {c: st[c] for c in ("preemptions", "swap_outs",
                                         "swap_ins", "dispatches",
                                         "host_syncs", "tokens")}))
    assert outs[1] == outs[0]
    assert outs[1][1]["preemptions"] >= 1 and outs[1][1]["swap_outs"] == 0
    assert eng.pool.pages_in_use == 0 and eng.host_pool.in_use == 0


# ------------------- launch counters under threads ------------------- #
def test_launch_counts_are_exact_under_threads():
    """Pump threads count launches concurrently: 8 threads x 4000 counts
    on each wrapper (by route where it has routes), with the interpreter
    switching threads every microsecond, lose no update."""
    n_threads, n_each = 8, 4000
    routed = {ops.flash_attention: "tensor_core",
              ops.int8_matmul: "skinny_tc",
              ops.decode_attention: "tensor_core",
              ops.paged_decode_attention: "cuda_core"}
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(n_each):
            for fn in ops.WRAPPERS:
                ops._count(fn, routed.get(fn))

    old = sys.getswitchinterval()
    ops.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_each
    try:
        for fn in ops.WRAPPERS:
            assert fn.launches == total, fn.__name__
            if fn in routed:
                assert fn.launches_by_route[routed[fn]] == total
                assert sum(fn.launches_by_route.values()) == total
    finally:
        ops.reset_launches()
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
