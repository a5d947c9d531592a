"""The port's counterpart of tests/test_chaos.py, on its engines on the
CPU.

Survivable streams: mid-stream migration keeps every emitted token,
bills exactly once, and the seeded chaos harness makes the whole story
reproducible — kill schedules fire at exact steps, and a faulted run's
greedy output is token-identical to the fault-free run."""
import time

import pytest
import torch

from repro_torch.api import (ErrorCode, Gateway, RuntimeConfig,
                             StreamEventType)
from repro_torch.cluster import BackendNode, FaultInjector, FaultSpec, Fleet
from repro_torch.configs import ARCHS
from repro_torch.core import (ModelCatalog, ReplicaInfo, ReplicaKey,
                              SDAIController)
from repro_torch.core.events import (FAULT_INJECTED, NODE_SUSPECTED,
                                     REQUEST_MIGRATED, WATCHDOG_FIRED)
from repro_torch.core.health import NodeHealth
from repro_torch.models import build
from repro_torch.serving import SamplingParams

MODEL = "olmo-1b-reduced"


@pytest.fixture(scope="module")
def param_store():
    """The port's engines on the CPU: seeded params per config name."""
    cache = {}

    def store(cfg):
        if cfg.name not in cache:
            cache[cfg.name] = build(cfg, "cpu").init(
                torch.Generator().manual_seed(0))
        return cache[cfg.name]
    return store


def _pinned_stack(param_store, n_nodes=2, n_slots=2, max_len=48):
    """One REAL engine per node, registered manually so replicas are
    guaranteed to span nodes (migration needs a cross-node survivor)."""
    cfg = ARCHS["olmo-1b"].reduced()
    fleet = Fleet([BackendNode(f"n{i}", "rx6800-16gb",
                               param_store=param_store, device="cpu")
                   for i in range(n_nodes)])
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.discover()
    for node in fleet.nodes.values():
        inst = node.deploy(cfg, n_slots=n_slots, max_len=max_len)
        ctrl.replicas.add(ReplicaInfo(
            ReplicaKey(node.node_id, inst.instance_id),
            cfg.name, "", n_slots, max_len, inst.bytes))
    return fleet, ctrl


def _stream_tokens(handle, timeout_s=120):
    toks = []
    for ev in handle.stream(timeout_s=timeout_s):
        if ev.type is StreamEventType.TOKEN:
            toks.append((ev.index, ev.token))
    return toks


# ---------------- mid-stream migration (hand-pump) ------------------ #
def test_midstream_migration_is_token_identical(param_store):
    """Kill the serving node after tokens have streamed: the stream
    resumes on the survivor and the final output is exactly what the
    fault-free run produced — no loss, no duplication, no reorder."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    gw = Gateway(ctrl)
    prompt, n = [3, 1, 4, 1, 5], 8
    reference = gw.generate(MODEL, prompt, SamplingParams(max_tokens=n))
    assert reference.ok and len(reference.tokens) == n

    handle = gw.submit(MODEL, prompt, SamplingParams(max_tokens=n),
                       tenant="steady")
    it = handle.stream()
    streamed = []
    for _ in range(2):                      # some tokens out the door
        ev = next(it)
        assert ev.type is StreamEventType.TOKEN
        streamed.append((ev.index, ev.token))
    victim = handle.internal.node
    fleet.fail_node(victim)                 # crash mid-decode
    for ev in it:
        if ev.type is StreamEventType.TOKEN:
            streamed.append((ev.index, ev.token))
    resp = handle.response

    assert resp.ok, resp.error
    assert resp.node != victim              # served out by the survivor
    assert resp.retries >= 1
    assert list(resp.tokens) == list(reference.tokens)
    # the SSE journal: contiguous indices, tokens == final response
    assert [i for i, _ in streamed] == list(range(n))
    assert [t for _, t in streamed] == list(resp.tokens)
    assert gw.stats.migrations >= 1
    migrated = ctrl.bus.of_kind(REQUEST_MIGRATED)
    assert migrated and migrated[-1].data["from_node"] == victim
    # the journal is authoritative: at least the 2 consumed tokens were
    # resumed (the engine may have banked more from its decode block)
    assert 2 <= migrated[-1].data["tokens_resumed"] < n


def test_migration_bills_wfq_and_tenant_exactly_once(param_store):
    """Across a migration the request pays for max_tokens once: the WFQ
    virtual clock advances by the full budget exactly once (journal
    floor on the new replica) and the tenant bucket was charged only at
    admission."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    gw = Gateway(ctrl)
    gw.admin.set_tenant_quota("acct", tokens_per_s=10_000)
    n = 6
    handle = gw.submit(MODEL, [2, 7], SamplingParams(max_tokens=n),
                       tenant="acct")
    it = handle.stream()
    assert next(it).type is StreamEventType.TOKEN
    fleet.fail_node(handle.internal.node)
    list(it)
    resp = handle.response
    assert resp.ok and len(resp.tokens) == n
    # exactly-once WFQ billing: served-journal floor means the victim's
    # charge plus the survivor's tops out at the request budget
    assert handle.internal.wfq_charged == float(n)
    usage = ctrl.frontend.tenants.snapshot()["acct"]["usage"]
    assert usage.tokens_charged == n        # admission-time, once


def test_single_node_failure_still_surfaces_error(param_store):
    """No survivor => no migration: the structured mid-stream failure
    contract is unchanged."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=1)
    gw = Gateway(ctrl)
    handle = gw.submit(MODEL, [9, 9], SamplingParams(max_tokens=10_000))
    it = handle.stream()
    assert next(it).type is StreamEventType.TOKEN
    fleet.fail_node(handle.internal.node)
    events = list(it)
    assert events[-1].type is StreamEventType.ERROR
    assert events[-1].error.code is ErrorCode.ENGINE_FAILED
    assert gw.stats.migrations == 0


# ---------------- zombie fencing ------------------------------------ #
def test_silent_heartbeat_loss_fences_zombie_and_migrates(param_store):
    """A node that stops heartbeating but keeps running (chaos
    `mute_heartbeat`) is fenced by the controller — fail()ed, not just
    unrouted — and its in-flight stream migrates to the survivor."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    ctrl.monitor.cfg.suspect_after = 0.02
    ctrl.monitor.cfg.dead_after = 0.05
    gw = Gateway(ctrl)
    ctrl.tick()                             # fresh heartbeats all around

    handle = gw.submit(MODEL, [1, 6, 1], SamplingParams(max_tokens=6))
    it = handle.stream()
    assert next(it).type is StreamEventType.TOKEN
    victim = handle.internal.node
    inj = FaultInjector([FaultSpec("mute_heartbeat", victim, at_step=1)],
                        bus=ctrl.bus).install(fleet)
    inj.on_step(fleet.nodes[victim])        # window opens
    assert fleet.nodes[victim].heartbeat() is None
    assert fleet.nodes[victim].alive        # the zombie is still up
    time.sleep(0.08)                        # victim misses its deadline
    ctrl.tick()
    assert not fleet.nodes[victim].alive    # fenced, not split-brained
    toks = [(ev.index, ev.token) for ev in it
            if ev.type is StreamEventType.TOKEN]
    resp = handle.response
    assert resp.ok, resp.error
    assert resp.node != victim
    first = [(i, t) for i, t in enumerate(resp.tokens)][:1]
    assert first + toks == list(enumerate(resp.tokens))
    assert ctrl.bus.of_kind(FAULT_INJECTED)
    inj.uninstall()


# ---------------- chaos soak (runtime, seeded) ---------------------- #
def test_seeded_chaos_soak_streams_survive_node_kill(param_store):
    """N tenants stream through the live runtime while a seeded kill
    schedule takes out a node mid-decode.  Every stream completes, every
    greedy output is token-identical to the fault-free run, and no
    survivor leaks a single KV page."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=3, n_slots=2)
    gw = Gateway(ctrl)
    prompts = [[1, 2, i + 1] for i in range(6)]
    n = 24          # long enough that the kill lands mid-decode
    # fault-free reference pass (greedy => per-prompt deterministic)
    reference = {}
    for p in prompts:
        r = gw.generate(MODEL, p, SamplingParams(max_tokens=n),
                        timeout_s=120)
        assert r.ok
        reference[tuple(p)] = list(r.tokens)

    inj = FaultInjector.kill_schedule(
        seed=1234, node_ids=list(fleet.nodes), n_kills=1,
        first_step=3).install(fleet, bus=ctrl.bus)
    gw.start(RuntimeConfig(tick_interval_s=0.02))
    try:
        tenants = ["alpha", "beta", "gamma"]
        handles = [(p, gw.submit(MODEL, p, SamplingParams(max_tokens=n),
                                 tenant=tenants[i % len(tenants)]))
                   for i, p in enumerate(prompts)]
        results = [(p, h, _stream_tokens(h)) for p, h in handles]
    finally:
        assert gw.stop(timeout_s=60) is True
        inj.uninstall()

    assert inj.fired, "the kill schedule never fired"
    dead = {s.node for _, s in inj.fired if s.kind == "crash"}
    assert dead and all(not fleet.nodes[d].alive for d in dead)
    for p, h, toks in results:
        resp = h.response
        assert resp.ok, (p, resp.error)
        # tokens_lost == 0 and tokens_duplicated == 0, by construction:
        # the stream journal equals the fault-free greedy reference
        assert [i for i, _ in toks] == list(range(n))
        assert [t for _, t in toks] == reference[tuple(p)]
        assert list(resp.tokens) == reference[tuple(p)]
    # streams that were in flight on the victim really migrated
    assert gw.stats.migrations + gw.stats.stream_retries >= 1
    # no leaked pages on any surviving engine
    for node in fleet.nodes.values():
        if not node.alive:
            continue
        for inst in node.instances.values():
            if inst.engine is not None:
                assert inst.engine.pool.pages_in_use == 0
                assert inst.engine.pool.n_active == 0
    # the failure surface is observable end to end
    snap = gw.admin.snapshot()
    assert snap.failure_events.get(FAULT_INJECTED, 0) >= 1
    assert snap.failure_events == snap.to_dict()["failures"]


def test_chaos_schedule_is_deterministic(param_store):
    """Same seed, same fleet, same workload => identical fault firings
    and identical tokens, run to run."""
    outs = []
    for _ in range(2):
        fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
        gw = Gateway(ctrl)
        inj = FaultInjector.kill_schedule(
            seed=77, node_ids=list(fleet.nodes), n_kills=1,
            first_step=5).install(fleet)
        h = gw.submit(MODEL, [4, 2], SamplingParams(max_tokens=6))
        toks = _stream_tokens(h)
        assert h.response.ok
        outs.append(([(step, s.kind, s.node) for step, s in inj.fired],
                     toks))
        inj.uninstall()
    assert outs[0] == outs[1]


# ---------------- watchdog + straggler ------------------------------ #
def test_watchdog_demotes_hung_pump_then_clears(param_store):
    """A chaos `hang` stalls one node's pump past the watchdog deadline:
    the node goes SUSPECT (demoted in routing, event emitted) and the
    mark clears once the stall window passes."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    gw = Gateway(ctrl)
    victim = next(iter(fleet.nodes))
    inj = FaultInjector(
        [FaultSpec("hang", victim, at_step=1, duration_steps=3,
                   stall_s=0.25)], bus=ctrl.bus).install(fleet)
    rt = gw.start(RuntimeConfig(tick_interval_s=0.01,
                                watchdog_step_timeout_s=0.05))
    try:
        h = gw.submit(MODEL, [5, 5], SamplingParams(max_tokens=6))
        deadline = time.monotonic() + 30
        while rt.stats.watchdog_fired == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rt.stats.watchdog_fired >= 1
        assert ctrl.bus.of_kind(WATCHDOG_FIRED)
        assert ctrl.bus.of_kind(NODE_SUSPECTED)
        assert h.result(timeout_s=120).ok
        # the stall window passed: the suspect mark clears
        deadline = time.monotonic() + 30
        while victim in ctrl.monitor.suspect_marks \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert victim not in ctrl.monitor.suspect_marks
        assert ctrl.monitor.status(victim) is NodeHealth.HEALTHY
    finally:
        assert gw.stop(timeout_s=60) is True
        inj.uninstall()


def test_suspect_mark_demotes_routing(param_store):
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    ctrl.tick()
    nid = next(iter(fleet.nodes))
    ctrl.monitor.mark_suspect(nid)
    assert ctrl.monitor.status(nid) is NodeHealth.SUSPECT
    # suspect replicas stay routable (availability > strictness) but a
    # healthy peer wins the weighted pick
    gw = Gateway(ctrl)
    h = gw.submit(MODEL, [8, 8], SamplingParams(max_tokens=2))
    assert h.internal.node != nid
    assert h.result(timeout_s=120).ok
    ctrl.monitor.clear_suspect(nid)
    ctrl.tick()         # fresh heartbeats: no age-based demotion left
    assert ctrl.monitor.status(nid) is NodeHealth.HEALTHY


# ---------------- submit flap + swap failure ------------------------ #
def test_submit_flap_fails_over_to_peer(param_store):
    """A flapping node refuses submits for a window: the frontend's
    retry loop lands the request on the peer; nothing is lost."""
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    gw = Gateway(ctrl)
    flappy = next(iter(fleet.nodes))
    inj = FaultInjector([FaultSpec("flap", flappy, at_step=1)],
                        bus=ctrl.bus).install(fleet)
    inj.on_step(fleet.nodes[flappy])        # open the window
    assert inj.submit_blocked(flappy)
    for i in range(4):
        h = gw.submit(MODEL, [6, i + 1], SamplingParams(max_tokens=3))
        resp = h.result(timeout_s=120)
        assert resp.ok, resp.error
        assert resp.node != flappy
    inj.uninstall()
    assert not inj.submit_blocked(flappy)


def test_swap_fail_window_forces_recompute_fallback(param_store):
    """With the host swap tier refusing puts (chaos `swap_fail`), the
    engine's preemption path must fall back to recompute — requests
    still finish, and the host pool stays clean."""
    from repro_torch.serving.kv_hierarchy import HostPagePool
    pool = HostPagePool(4, {"k": torch.zeros(1, 1, 1, 1)})
    assert pool.can_hold(2)
    pool.fail_puts = True
    assert not pool.can_hold(1)
    assert pool.put({}, 0) is None          # refused outright
    pool.fail_puts = False
    assert pool.can_hold(2)

    fleet, ctrl = _pinned_stack(param_store, n_nodes=1)
    nid = next(iter(fleet.nodes))
    inj = FaultInjector([FaultSpec("swap_fail", nid, at_step=1,
                                   duration_steps=2)]).install(fleet)
    node = fleet.nodes[nid]
    inj.on_step(node)                       # window opens
    for inst in node.instances.values():
        if inst.engine is not None and inst.engine.host_pool is not None:
            assert inst.engine.host_pool.fail_puts
    inj.on_step(node)
    inj.on_step(node)                       # window expires
    for inst in node.instances.values():
        if inst.engine is not None and inst.engine.host_pool is not None:
            assert not inst.engine.host_pool.fail_puts
    inj.uninstall()
