"""The slice as a whole against the JAX package: the paper's testbed, the
SDAI controller, the Gateway and the chaos harness over real engines,
on the reduced OLMo-1B in f32 with the JAX-initialised params carried
across by `from_jax` (the port's engines on the CPU, through the
kernels' plain versions).

Both packages place the same demands identically (node, precision,
slots, pages).  Greedy requests give identical tokens and finish reasons
hand-pumped and through the serving runtime's pump threads.  A crash of
the serving node at a fixed chaos step migrates the stream in both, with
the same event kinds and the same full token list (nothing lost or
duplicated), and a `swap_fail` window gives the same tokens and
preemptions.  The admin snapshot's deterministic fields agree.  Sampled
requests differ by generator, so they are held by support: each sampled
token lies in its step's top-k under a plain forward of the same
weights.  Which node serves a request may differ: the port's card
classes have other FLOP/s and bandwidths than the reference's, and the
frontend weighs them."""
import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro import cluster as jax_cluster
from repro import core as jax_core
from repro.configs import ARCHS
from repro.serving import SamplingParams as JaxSampling
from repro_torch import api as port_api
from repro_torch import cluster as port_cluster
from repro_torch import core as port_core
from repro_torch import params as params_lib
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.models import transformer as tf
from repro_torch.serving import SamplingParams

torch.set_num_threads(2)

MODEL = "olmo-1b-reduced-f32"
DEMAND = dict(min_replicas=2, max_replicas=2, n_slots=2, max_len=48)
PROMPTS = [[1, 2, 3], [4, 5], [7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [6],
           [2, 7, 1, 8, 2, 8]]
BUDGETS = [8, 5, 12, 9, 3, 10]
JAX_SIDE = (jax_api, jax_cluster, jax_core, ARCHS, JaxSampling, {})
PORT_SIDE = (port_api, port_cluster, port_core, PORT_ARCHS, SamplingParams,
             {"device": "cpu"})


@pytest.fixture(scope="module")
def cfg():
    # its own name: param_store caches by name
    return ARCHS["olmo-1b"].reduced(dtype="f32", name=MODEL)


@pytest.fixture(scope="module")
def stores(cfg, param_store):
    tparams = params_lib.from_jax(jax.tree.map(np.asarray, param_store(cfg)),
                                  cfg, "cpu")
    return {"jax": param_store, "port": lambda c: tparams}


def _cfg(side):
    return side[3]["olmo-1b"].reduced(dtype="f32", name=MODEL)


def _testbed(side, store, **demand):
    """The paper's testbed behind a controller, `MODEL` deployed through
    placement with real engines (threshold above its parameters)."""
    _, cluster, core, _, _, dev = side
    cfg = _cfg(side)
    fleet = cluster.paper_testbed(param_store=store, **dev)
    catalog = core.ModelCatalog()
    catalog.register(cfg)
    ctrl = core.SDAIController(fleet, catalog, core.ControllerConfig(
        real_param_threshold=cfg.num_params() + 1))
    ctrl.discover()
    plan = ctrl.deploy([core.ModelDemand(cfg, **(demand or DEMAND))])
    assert not plan.unplaced
    return fleet, ctrl, plan


def _sides(stores):
    return ((JAX_SIDE, stores["jax"]), (PORT_SIDE, stores["port"]))


def _tokens(resps):
    return [(tuple(r.tokens), r.finish_reason, r.ok) for r in resps]


def _greedy(side, gw, prompts=PROMPTS, budgets=BUDGETS, **kw):
    sp = side[4]
    handles = [gw.submit(MODEL, p, sp(max_tokens=n, **kw))
               for p, n in zip(prompts, budgets)]
    return [h.result(timeout_s=120) for h in handles]


def test_deploy_plans_match_reference(stores):
    plans = []
    for side, store in _sides(stores):
        fleet, ctrl, plan = _testbed(side, store)
        plans.append([(a.node_id, a.quantize, a.n_slots, a.max_len,
                       a.page_size, a.kv_pages, a.bytes)
                      for a in plan.assignments])
        engines = [i.engine for n in fleet.nodes.values()
                   for i in n.instances.values()]
        assert len(engines) == len(plan.assignments) == 2
        assert all(e is not None for e in engines)
    assert plans[1] == plans[0]
    assert len({a[0] for a in plans[0]}) == 2      # two nodes
    assert all(e.device.type == "cpu" for e in engines)


def test_greedy_tokens_match_reference_hand_pumped_and_runtime(stores):
    """The same greedy requests, all submitted at once: identical tokens
    and finish reasons, hand-pumped and through the pump threads; then a
    stop on EOS.  No page is left in use."""
    outs = []
    for side, store in _sides(stores):
        fleet, ctrl, _ = _testbed(side, store)
        gw = side[0].Gateway(ctrl)
        hand = _greedy(side, gw)
        first = hand[0].tokens
        i = next(i for i in range(1, len(first)) if first[i] not in first[:i])
        eos = _greedy(side, gw, PROMPTS[:1], BUDGETS[:1], eos_id=first[i])
        gw.start()
        live = _greedy(side, gw)
        assert gw.stop(drain=True, timeout_s=60) is True
        assert gw.stats.caller_pumps > 0
        for node in fleet.nodes.values():
            for inst in node.instances.values():
                assert inst.engine.pool.pages_in_use == 0
        outs.append((_tokens(hand), _tokens(eos), _tokens(live)))
    assert outs[1] == outs[0]
    hand, eos, live = outs[1]
    assert live == hand
    assert [len(t) for t, _, _ in hand] == BUDGETS
    assert all(ok and reason == "length" for _, reason, ok in hand)
    assert eos[0][1] == "stop" and eos[0][0] == hand[0][0][:i + 1]


def _crash_run(side, store, budget):
    fleet, ctrl, _ = _testbed(side, store)
    api, cluster = side[0], side[1]
    gw = api.Gateway(ctrl)
    ref = gw.generate(MODEL, PROMPTS[2], side[4](max_tokens=budget))
    h = gw.submit(MODEL, PROMPTS[2], side[4](max_tokens=budget))
    victim = h.internal.node
    # the chaos clock ticks once per node pump; every node pumps once a
    # round, so step 7 falls in round 2, after the victim's first step
    inj = cluster.FaultInjector([cluster.FaultSpec("crash", victim,
                                                   at_step=7)],
                                bus=ctrl.bus).install(fleet)
    events = list(h.stream(timeout_s=120))
    inj.uninstall()
    resp = h.response
    migrated = [e for e in ctrl.bus.events if e.kind == "request_migrated"]
    survivors = [i.engine for n in fleet.nodes.values() if n.alive
                 for i in n.instances.values()]
    assert all(e.pool.pages_in_use == 0 for e in survivors)
    return dict(kinds=[e.kind for e in ctrl.bus.events],
                tokens=list(resp.tokens), ok=resp.ok, ref=list(ref.tokens),
                streamed=[(e.index, e.token) for e in events
                          if e.type.value == "token"],
                moved=resp.node != victim, migrations=gw.stats.migrations,
                resumed=[e.data["tokens_resumed"] for e in migrated],
                fired=[(s, f.kind) for s, f in inj.fired],
                victim_alive=fleet.nodes[victim].alive)


def test_crash_midstream_migrates_like_reference(stores):
    budget = 16
    jax_run, port_run = (_crash_run(side, store, budget)
                         for side, store in _sides(stores))
    assert port_run == jax_run
    assert port_run["ok"] and port_run["moved"]
    assert not port_run["victim_alive"]
    assert port_run["migrations"] >= 1 and port_run["fired"] == [(7,
                                                                  "crash")]
    # nothing lost or duplicated: the journal is the fault-free output
    assert port_run["tokens"] == port_run["ref"]
    assert port_run["streamed"] == list(enumerate(port_run["tokens"]))
    assert 1 <= port_run["resumed"][0] < budget
    assert "fault_injected" in port_run["kinds"]


def _swap_fail_run(side, store):
    """One node, one engine over a small pool and a host tier, under a
    swap_fail window that covers the run: preemptions recompute."""
    api, cluster, core, _, sp, dev = side
    cfg = _cfg(side)
    klass = "v5e-1" if side is JAX_SIDE else "rx6800-16gb"
    fleet = cluster.Fleet([cluster.BackendNode("n0", klass,
                                               param_store=store, **dev)])
    catalog = core.ModelCatalog()
    catalog.register(cfg)
    ctrl = core.SDAIController(fleet, catalog)
    ctrl.discover()
    node = fleet.nodes["n0"]
    inst = node.deploy(cfg, n_slots=6, max_len=48, page_size=8, kv_pages=18,
                       host_kv_pages=64)
    ctrl.replicas.add(core.ReplicaInfo(
        core.ReplicaKey("n0", inst.instance_id), cfg.name, "", 6, 48,
        inst.bytes))
    inj = cluster.FaultInjector([cluster.FaultSpec(
        "swap_fail", "n0", at_step=1, duration_steps=1000)]).install(fleet)
    gw = api.Gateway(ctrl)
    handles = [gw.submit(MODEL, list(range(1, 3 + i)), sp(max_tokens=20))
               for i in range(6)]
    resps = [h.result(timeout_s=120) for h in handles]
    eng = inst.engine
    assert eng.host_pool.fail_puts
    inj.uninstall()
    assert not eng.host_pool.fail_puts
    return (_tokens(resps), eng.preemptions, eng.swap_outs,
            eng.pool.pages_in_use, eng.host_pool.in_use)


def test_swap_fail_window_matches_reference(stores):
    jax_run, port_run = (_swap_fail_run(side, store)
                         for side, store in _sides(stores))
    assert port_run == jax_run
    assert port_run[1] >= 1 and port_run[2:] == (0, 0, 0)


def _snapshot_fields(snap):
    return dict(
        connected=snap.connected, total=snap.total,
        routing={m: sorted(k.split("/")[0] for k in keys)
                 for m, keys in snap.routing.items()},
        models=[(m.name, m.replicas, m.healthy_replicas)
                for m in snap.models],
        # (health is not here: it ages with the wall clock since the
        # last heartbeat, and no tick runs while hand-pumping)
        nodes=[(n.node_id, n.alive, n.hbm_used, n.hbm_budget,
                [(i.model, i.n_slots, i.max_len, i.bytes, i.page_size,
                  i.kv_pages, i.pages_in_use, i.page_occupancy,
                  i.preemptions, i.alive) for i in n.instances])
               for n in snap.nodes])


def test_admin_snapshot_matches_reference(stores):
    snaps = []
    for side, store in _sides(stores):
        fleet, ctrl, _ = _testbed(side, store)
        gw = side[0].Gateway(ctrl)
        before = _snapshot_fields(gw.admin.snapshot())
        _greedy(side, gw, PROMPTS[:3], BUDGETS[:3])
        snaps.append((before, _snapshot_fields(gw.admin.snapshot())))
    assert snaps[1] == snaps[0]
    assert snaps[1][0]["connected"] == snaps[1][0]["total"] == 6


def test_sampled_tokens_lie_in_the_top_k(stores, cfg):
    """Sampled requests (top_k=4, temperature 1): every token, in both
    packages, is among the 4 largest logits of a plain forward over the
    prompt and the tokens before it."""
    tparams = stores["port"](cfg)
    for side, store in _sides(stores):
        fleet, ctrl, _ = _testbed(side, store)
        gw = side[0].Gateway(ctrl)
        resps = _greedy(side, gw, temperature=1.0, top_k=4)
        for p, n, r in zip(PROMPTS, BUDGETS, resps):
            assert r.ok and len(r.tokens) == n
            ids = torch.tensor([list(p) + list(r.tokens)])
            with torch.no_grad():
                logits = tf.forward(tparams, _cfg(PORT_SIDE), ids,
                                    impl="full")[0]
            for j, tok in enumerate(r.tokens):
                row = logits[len(p) - 1 + j]
                assert row[tok] >= torch.topk(row, 4).values[-1] - 1e-5


def test_runtime_result_waits_without_spinning(stores):
    """With the pump threads running, `result()` sleeps on the handle's
    condition until the request is done: it wakes per token and per
    wait timeout, not in a loop that holds the interpreter lock (the
    reference's `result()` returns from each wait while a token event is
    queued)."""
    side = PORT_SIDE
    fleet, ctrl, _ = _testbed(side, stores["port"])
    gw = side[0].Gateway(ctrl)
    gw.start()
    try:
        h = gw.submit(MODEL, PROMPTS[0], SamplingParams(max_tokens=40))
        calls = 0
        wait = h._wait_for_progress

        def counted(*args, **kw):
            nonlocal calls
            calls += 1
            return wait(*args, **kw)
        h._wait_for_progress = counted
        resp = h.result(timeout_s=120)
    finally:
        assert gw.stop(timeout_s=60) is True
    assert resp.ok and len(resp.tokens) == 40
    # one wake per token, one per 50 ms timeout of a ~second-long run
    assert calls <= 40 + 200, calls
