"""Preemption and tenant fairness of the port's engine against the JAX
engine (ROADMAP.md A1): the counterparts of tests/test_paged.py's
lowest-deficit victim (:159), three weighted tenants' shares (:183), WFQ
charged once across preemption and resume (:263), engine weights from
the tenant quotas (:412) and a multi-instance node pumping through its
executor (:434).  Each runs both engines (or both stacks) on the same
requests, on the reduced OLMo-1B in f32 with the JAX-initialised params
carried across, and compares the order of the preemption victims and
every request's tokens; then a Hymba request preempted and resumed by
recompute (prefill over its prompt and output so far, at their exact
length).  The port's engine is not a copy of JAX's: its victim rule
`_pick_victim` and its page-gated admission run over the verbatim
scheduler."""
import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro import cluster as jax_cluster
from repro import core as jax_core
from repro.configs import ARCHS as JAX_ARCHS
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving import Scheduler as JaxScheduler
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro_torch import api as port_api
from repro_torch import cluster as port_cluster
from repro_torch import core as port_core
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams, Scheduler, SchedulerConfig)

torch.set_num_threads(2)

MODEL = "olmo-1b-reduced-f32"
JAX_SIDE = dict(engine=JaxEngine, ecfg=JaxEngineConfig, req=JaxRequest,
                sp=JaxSampling, kw={}, cfgs=JAX_ARCHS)
PORT_SIDE = dict(engine=InferenceEngine, ecfg=EngineConfig, req=Request,
                 sp=SamplingParams, kw={"device": "cpu"}, cfgs=ARCHS)


@pytest.fixture(scope="module")
def stores(param_store):
    """{side: params of the reduced OLMo-1B}: JAX's, and the port's
    carried across."""
    jcfg = JAX_ARCHS["olmo-1b"].reduced(dtype="f32", name=MODEL)
    jparams = param_store(jcfg)
    return {"jax": jparams,
            "port": params_lib.from_jax(jax.tree.map(np.asarray, jparams),
                                        ARCHS["olmo-1b"].reduced(
                                            dtype="f32", name=MODEL), "cpu")}


def _sides(stores):
    return ((JAX_SIDE, stores["jax"]), (PORT_SIDE, stores["port"]))


def _engine(side, params, name="olmo-1b", **kw):
    cfg = side["cfgs"][name].reduced(dtype="f32",
                                     name=f"{name}-reduced-f32")
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 48)
    return side["engine"](cfg, params, side["ecfg"](**kw), **side["kw"])


def _record_victims(eng):
    """Wrap the engine's `_preempt` to log each victim as (tenant, prompt,
    tokens emitted so far), in order."""
    log, preempt = [], eng._preempt

    def wrapped(slot):
        req = eng.slot_req[slot]
        log.append((req.tenant, tuple(req.prompt), len(req.output)))
        return preempt(slot)
    eng._preempt = wrapped
    return log


def test_preemption_victim_is_lowest_deficit_tenant(stores):
    """test_paged.py:159 in both engines: with one over-served tenant
    ("rich") and one under-served in slots, page exhaustion evicts the
    over-served tenant's slot; the victims, their order and every token
    are the same in both engines."""
    runs = []
    for side, params in _sides(stores):
        eng = _engine(side, params, n_slots=2, page_size=8, kv_pages=7,
                      decode_block=4)
        victims = _record_victims(eng)
        rich = side["req"](model="m", prompt=[1, 2], tenant="rich",
                           sampling=side["sp"](max_tokens=30))
        poor = side["req"](model="m", prompt=[3, 4], tenant="poor",
                           sampling=side["sp"](max_tokens=30))
        assert eng.submit(rich) and eng.submit(poor)
        eng.scheduler._vtime["rich"] = 100.0
        eng.scheduler._vtime["poor"] = 1.0
        while not eng.preemptions and (eng.slot_req or eng.scheduler.depth):
            eng.step()
        assert eng.preemptions >= 1
        first = list(victims)
        eng.run_until_done()
        assert len(rich.output) == 30 and len(poor.output) == 30
        runs.append((first, victims, rich.output, poor.output))
    assert runs[1] == runs[0]
    assert runs[1][0][0][0] == "rich"


def test_three_tenant_weighted_shares_within_20pct(stores):
    """test_paged.py:183 in both engines: 40 mixed requests a tenant with
    DWRR weights 1 : 2 : 3, 45 steps under sustained contention; the
    served tokens per tenant and every request's tokens so far are the
    same in both engines, and each share is within 20% of its weight."""
    weights = {"a": 1.0, "b": 2.0, "c": 3.0}
    plens, budgets = {"a": 3, "b": 9, "c": 5}, {"a": 8, "b": 6, "c": 10}
    runs = []
    for side, params in _sides(stores):
        eng = _engine(side, params, n_slots=3, page_size=8, decode_block=4)
        eng.scheduler.weight_of = lambda t: weights.get(t, 1.0)
        victims = _record_victims(eng)
        reqs = []
        for t in weights:
            for _ in range(40):
                r = side["req"](model="m",
                                prompt=list(range(1, 1 + plens[t])),
                                tenant=t,
                                sampling=side["sp"](max_tokens=budgets[t]))
                reqs.append(r)
                assert eng.submit(r)
        for _ in range(45):
            eng.step()
        backlog = eng.scheduler.tenant_backlog()
        assert all(backlog.get(t, 0) > 0 for t in weights)
        served = {t: 0 for t in weights}
        for r in reqs:
            served[r.tenant] += len(r.output)
        runs.append((served, victims, [tuple(r.output) for r in reqs]))
    assert runs[1] == runs[0]
    served = runs[1][0]
    total, wtotal = sum(served.values()), sum(weights.values())
    for t, w in weights.items():
        assert abs(served[t] / total - w / wtotal) / (w / wtotal) <= 0.20


def test_preempted_resume_charges_wfq_exactly_once(stores):
    """test_paged.py:263: the scheduler bills a request's full budget at
    its first admission and nothing when a preempted request is admitted
    again — in both packages' schedulers, and in both engines under real
    preemption (one tenant, five requests on a pool of 10 pages): the
    same victims, the same tokens, and a virtual clock of exactly the
    budgets billed once."""
    for sched_cls, cfg_cls, req_cls, sp_cls in (
            (JaxScheduler, JaxSchedulerConfig, JaxRequest, JaxSampling),
            (Scheduler, SchedulerConfig, Request, SamplingParams)):
        sched = sched_cls(cfg_cls(max_prefill_per_step=1))
        req = req_cls(model="m", prompt=[1, 2], tenant="t",
                      sampling=sp_cls(max_tokens=10))
        sched.submit(req)
        assert sched.next_prefill_bucket(1, lambda n: 8) == [req]
        assert sched._vtime["t"] == pytest.approx(10.0)
        req.output.extend([5] * 4)
        sched.requeue(req)
        assert sched.next_prefill_bucket(1, lambda n: 8) == [req]
        assert sched._vtime["t"] == pytest.approx(10.0)
    runs = []
    for side, params in _sides(stores):
        eng = _engine(side, params, n_slots=4, page_size=8, kv_pages=10,
                      decode_block=4)
        victims = _record_victims(eng)
        reqs = [side["req"](model="m", prompt=list(range(1, 4 + i)),
                            tenant="t", sampling=side["sp"](max_tokens=20))
                for i in range(5)]
        for r in reqs:
            assert eng.submit(r)
        eng.run_until_done()
        assert eng.preemptions >= 1
        assert all(r.state.name == "FINISHED" and len(r.output) == 20
                   for r in reqs)
        runs.append((victims, [tuple(r.output) for r in reqs],
                     eng.scheduler._vtime["t"]))
    assert runs[1] == runs[0]
    assert runs[1][2] == pytest.approx(5 * 20.0)


def _stack(api, cluster, core, cfg, klass, params, dev):
    fleet = cluster.Fleet([cluster.BackendNode(
        "n0", klass, param_store=lambda c: params, **dev)])
    catalog = core.ModelCatalog()
    catalog.register(cfg)
    ctrl = core.SDAIController(fleet, catalog)
    ctrl.discover()
    plan = ctrl.deploy([core.ModelDemand(cfg, min_replicas=1,
                                         max_replicas=1, n_slots=2,
                                         max_len=48)])
    assert not plan.unplaced
    return fleet, api.Gateway(ctrl)


def test_engine_weights_flow_from_tenant_quotas(stores):
    """test_paged.py:412 on both stacks: set_tenant_quota(weight=4)
    reaches the deployed engine's scheduler and the admin snapshot, and
    the two tenants' greedy requests through the Gateway get the same
    tokens."""
    runs = []
    for (api, cluster, core, cfgs, sp, klass, dev), params in zip(
            ((jax_api, jax_cluster, jax_core, JAX_ARCHS, JaxSampling,
              "v5e-1", {}),
             (port_api, port_cluster, port_core, ARCHS, SamplingParams,
              "rx6800-16gb", {"device": "cpu"})),
            (stores["jax"], stores["port"])):
        cfg = cfgs["olmo-1b"].reduced(dtype="f32", name=MODEL)
        fleet, gw = _stack(api, cluster, core, cfg, klass, params, dev)
        gw.admin.set_tenant_quota("vip", api.TenantQuota(weight=4.0))
        inst = next(iter(fleet.nodes["n0"].instances.values()))
        assert inst.engine.scheduler.weight_of("vip") == 4.0
        assert inst.engine.scheduler.weight_of("anon") == 1.0
        vip = next(t for t in gw.admin.snapshot().tenants
                   if t.tenant == "vip")
        assert vip.weight == 4.0
        handles = [gw.submit(MODEL, [1, 2 + i], sp(max_tokens=6),
                             tenant=t)
                   for i, t in enumerate(("vip", "anon", "vip", "anon"))]
        runs.append([tuple(h.result(timeout_s=120).tokens)
                     for h in handles])
    assert runs[1] == runs[0]


def test_multi_instance_node_pumps_through_executor(stores):
    """test_paged.py:434 on both nodes: a node hosting two engines steps
    them through its per-node thread pool, created lazily; every request
    finishes with the same tokens as on the JAX node; a single-instance
    node never builds a pool."""
    runs = []
    for (cluster, cfgs, req_cls, sp, klass, dev), params in zip(
            ((jax_cluster, JAX_ARCHS, JaxRequest, JaxSampling, "v5e-1", {}),
             (port_cluster, ARCHS, Request, SamplingParams, "rx6800-16gb",
              {"device": "cpu"})),
            (stores["jax"], stores["port"])):
        cfg = cfgs["olmo-1b"].reduced(dtype="f32", name=MODEL)
        node = cluster.BackendNode("n0", klass,
                                   param_store=lambda c: params, **dev)
        insts = [node.deploy(cfg, n_slots=2, max_len=48) for _ in range(2)]
        assert node._executor is None
        reqs = []
        for inst in insts:
            for j in range(2):
                r = req_cls(model=cfg.name, prompt=[1, 2 + j],
                            sampling=sp(max_tokens=6))
                reqs.append(r)
                assert node.submit(inst.instance_id, r)
        for _ in range(40):
            if not node.has_work():
                break
            node.pump()
        assert node._executor is not None
        assert all(len(r.output) == 6 for r in reqs)
        solo = cluster.BackendNode("n1", klass,
                                   param_store=lambda c: params, **dev)
        s1 = solo.deploy(cfg, n_slots=2, max_len=48)
        r = req_cls(model=cfg.name, prompt=[1, 2], sampling=sp(max_tokens=4))
        assert solo.submit(s1.instance_id, r)
        while solo.has_work():
            solo.pump()
        assert solo._executor is None
        runs.append([tuple(q.output) for q in reqs] + [tuple(r.output)])
    assert runs[1] == runs[0]


def test_hymba_recompute_resume_matches_jax(param_store):
    """A Hymba request preempted on page exhaustion (no host tier) resumes
    by recompute: prefill over its prompt and its output so far at their
    exact length, its SSM state rebuilt.  The victims and tokens equal
    JAX's (prompts inside window + 1 less the meta tokens, where JAX's
    prefill is its forward), and equal the same requests on a pool with
    room."""
    jcfg = JAX_ARCHS["hymba-1.5b"].reduced(dtype="f32",
                                           name="hymba-1.5b-reduced-f32")
    jparams = param_store(jcfg)
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, jparams),
                                  ARCHS["hymba-1.5b"].reduced(dtype="f32"),
                                  "cpu")
    runs = []
    for side, params, pages in ((JAX_SIDE, jparams, 12),
                                (PORT_SIDE, tparams, 12),
                                (PORT_SIDE, tparams, 0)):
        eng = _engine(side, params, name="hymba-1.5b", n_slots=4,
                      page_size=8, kv_pages=pages, decode_block=4,
                      paged_attention=True)
        victims = _record_victims(eng)
        rng = np.random.default_rng(3)
        reqs = [side["req"](model="m",
                            prompt=rng.integers(0, 256, n).tolist(),
                            sampling=side["sp"](max_tokens=30))
                for n in (10, 12, 9, 11)]
        for r in reqs:
            assert eng.submit(r)
        eng.run_until_done()
        assert eng.pool.pages_in_use == 0
        runs.append((victims, [tuple(r.output) for r in reqs]))
    assert runs[0][0] and runs[1] == runs[0]
    assert not runs[2][0] and runs[2][1] == runs[1][1]
