"""The port's counterpart of tests/test_api.py, on its engines on the CPU.

Gateway API v1: incremental streaming, async handles + cancellation,
admission control, structured failure surfacing, accounted-mode parity,
and the typed admin surface."""
import dataclasses

import pytest
import torch

from repro_torch.api import (AdminAPI, ErrorCode, FleetSnapshot, Gateway,
                             GatewayConfig, GenerationRequest,
                             StreamEventType)
from repro_torch.cluster import BackendNode, Fleet, paper_testbed
from repro_torch.configs import ARCHS, ZOO
from repro_torch.core import (ModelCatalog, ModelDemand, ReplicaInfo,
                              ReplicaKey, SDAIController)
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


def _live_stack(param_store, n_nodes=2, n_slots=2, max_len=48,
                min_replicas=2):
    """Small fleet running REAL tiny engines behind a controller."""
    fleet = Fleet([BackendNode(f"n{i}", "rx6800-16gb",
                               param_store=param_store, device="cpu")
                   for i in range(n_nodes)])
    cfg = ARCHS["olmo-1b"].reduced()
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, min_replicas=min_replicas,
                                    n_slots=n_slots, max_len=max_len)])
    assert not plan.unplaced
    return fleet, ctrl


def _pinned_stack(param_store, n_nodes=2):
    """One REAL engine per node, registered manually so replicas are
    guaranteed to span nodes (failover tests need that determinism)."""
    cfg = ARCHS["olmo-1b"].reduced()
    fleet = Fleet([BackendNode(f"n{i}", "rx6800-16gb",
                               param_store=param_store, device="cpu")
                   for i in range(n_nodes)])
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.discover()
    for node in fleet.nodes.values():
        inst = node.deploy(cfg, n_slots=2, max_len=48)
        ctrl.replicas.add(ReplicaInfo(
            ReplicaKey(node.node_id, inst.instance_id),
            cfg.name, "", 2, 48, inst.bytes))
    return fleet, ctrl


def _accounted_stack(n_nodes=2, min_replicas=2):
    """Accounted-mode (analytic) replicas of a big model, deployed
    through the controller's placement path."""
    fleet = Fleet([BackendNode(f"n{i}", "v100-16gb-x4")
                   for i in range(n_nodes)])
    cfg = ZOO["deepseek-r1-7b"]
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, min_replicas=min_replicas,
                                    max_replicas=min_replicas)])
    assert not plan.unplaced
    return fleet, ctrl


@pytest.fixture(scope="module")
def live(param_store):
    return _live_stack(param_store)


# ------------------------- streaming ------------------------------- #
def test_stream_yields_tokens_incrementally(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    handle = gw.submit(MODEL, [1, 2, 3], SamplingParams(max_tokens=6))
    assert not handle.done
    events = []
    tokens_before_done = 0
    for ev in handle.stream():
        if ev.type is StreamEventType.TOKEN and not handle.done:
            tokens_before_done += 1
        events.append(ev)
    # true incremental streaming: deltas arrive before the request ends
    assert tokens_before_done >= 1
    assert [e.type for e in events].count(StreamEventType.FINISH) == 1
    assert events[-1].type is StreamEventType.FINISH
    resp = events[-1].response
    assert resp.ok and resp.finish_reason == "length"
    assert list(resp.tokens) == [e.token for e in events[:-1]]
    assert [e.index for e in events[:-1]] == list(range(6))


def test_sync_generate_matches_internal_contract(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    resp = gw.generate(MODEL, [4, 5], SamplingParams(max_tokens=4))
    assert resp.ok and len(resp.tokens) == 4
    assert resp.ttft is not None and resp.latency is not None
    assert resp.node in fleet.nodes
    # responses are frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        resp.tokens = ()


def test_generate_batch_completes_all(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    reqs = [GenerationRequest(model=MODEL, prompt=(1, 2, i),
                              sampling=SamplingParams(max_tokens=3))
            for i in range(5)]
    resps = gw.generate_batch(reqs)
    assert len(resps) == 5
    assert all(r.ok and len(r.tokens) == 3 for r in resps)


# ------------------------- cancellation ---------------------------- #
def test_cancel_frees_engine_slot(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    handle = gw.submit(MODEL, [7, 8], SamplingParams(max_tokens=10_000))
    it = handle.stream()
    first = next(it)                       # at least one token streamed
    assert first.type is StreamEventType.TOKEN
    assert handle.cancel()
    resp = handle.response
    assert resp.finish_reason == "cancelled"
    assert resp.error.code is ErrorCode.CANCELLED
    # the engine slot the request occupied is released
    for node in fleet.nodes.values():
        for inst in node.instances.values():
            if inst.engine is not None:
                assert all(r.request_id != handle.internal.request_id
                           for r in inst.engine.slot_req.values())
    assert not handle.cancel()             # idempotent once finished
    # terminal event still surfaces on the stream
    rest = list(it)
    assert rest and rest[-1].type is StreamEventType.ERROR


# ------------------------- admission control ----------------------- #
def test_admission_rejects_overloaded_then_recovers(live):
    fleet, ctrl = live
    gw = Gateway(ctrl, GatewayConfig(max_inflight_per_model=2))
    h1 = gw.submit(MODEL, [1], SamplingParams(max_tokens=2000))
    h2 = gw.submit(MODEL, [2], SamplingParams(max_tokens=2000))
    h3 = gw.submit(MODEL, [3], SamplingParams(max_tokens=2))
    assert h3.done                         # structured 429, no queuing
    assert h3.response.error.code is ErrorCode.OVERLOADED
    assert h3.response.error.retryable
    assert gw.stats.rejected_overloaded == 1
    h1.cancel()
    h2.cancel()
    h4 = gw.submit(MODEL, [4], SamplingParams(max_tokens=2))
    assert h4.result().ok                  # slot freed -> admitted again


def test_admission_queue_depth_limit(live):
    fleet, ctrl = live
    gw = Gateway(ctrl, GatewayConfig(max_queue_depth_per_model=1))
    h1 = gw.submit(MODEL, [1], SamplingParams(max_tokens=2))
    h2 = gw.submit(MODEL, [2], SamplingParams(max_tokens=2))
    # h1 still sits in a backend scheduler queue (nothing pumped yet)
    assert h2.done
    assert h2.response.error.code is ErrorCode.OVERLOADED
    assert h1.result().ok                  # backlog drains
    assert gw.generate(MODEL, [3], SamplingParams(max_tokens=2)).ok


# ------------------------- failure surfacing ----------------------- #
def test_midstream_failure_surfaces_structured_error(param_store):
    fleet, ctrl = _pinned_stack(param_store, n_nodes=1)
    gw = Gateway(ctrl)
    handle = gw.submit(MODEL, [9, 9], SamplingParams(max_tokens=10_000))
    it = handle.stream()
    assert next(it).type is StreamEventType.TOKEN
    fleet.fail_node(handle.internal.node)  # crash mid-stream
    events = list(it)                      # must terminate, not hang
    assert events[-1].type is StreamEventType.ERROR
    assert events[-1].error.code is ErrorCode.ENGINE_FAILED
    assert handle.response.finish_reason == "error"


def test_pretoken_failure_retries_transparently(param_store):
    fleet, ctrl = _pinned_stack(param_store, n_nodes=2)
    gw = Gateway(ctrl)
    handle = gw.submit(MODEL, [1, 2], SamplingParams(max_tokens=3))
    victim = handle.internal.node
    fleet.fail_node(victim)                # dies before any token
    resp = handle.result()
    assert resp.ok, resp.error             # re-routed to the survivor
    assert resp.node != victim
    assert resp.retries >= 1
    assert gw.stats.stream_retries >= 1


def test_no_backend_is_structured(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    resp = gw.generate("no-such-model", [1])
    assert not resp.ok
    assert resp.error.code is ErrorCode.NO_BACKEND


def test_invalid_request_rejected_before_routing(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    resp = gw.generate(MODEL, [])              # empty prompt
    assert resp.error.code is ErrorCode.INVALID_REQUEST
    resp = gw.generate(MODEL, [1], SamplingParams(max_tokens=0))
    assert resp.error.code is ErrorCode.INVALID_REQUEST
    assert not resp.error.retryable
    # the fleet keeps serving afterwards (no engine saw the bad input)
    assert gw.generate(MODEL, [1], SamplingParams(max_tokens=2)).ok


# ------------------------- accounted mode -------------------------- #
def test_accounted_mode_honors_max_tokens_and_streams():
    fleet, ctrl = _accounted_stack(n_nodes=2, min_replicas=2)
    gw = Gateway(ctrl)
    handle = gw.submit("deepseek-r1-7b", [1, 2, 3],
                       SamplingParams(max_tokens=20))
    events = list(handle.stream())
    toks = [e for e in events if e.type is StreamEventType.TOKEN]
    assert len(toks) == 20                 # not capped at 8 any more
    assert events[-1].type is StreamEventType.FINISH
    assert len(handle.response.tokens) == 20
    assert handle.response.ttft is not None


# ------------------------- admin surface --------------------------- #
def test_admin_snapshot_typed_and_legacy_dict(live):
    fleet, ctrl = live
    gw = Gateway(ctrl)
    snap = gw.admin.snapshot()
    assert isinstance(snap, FleetSnapshot)
    assert snap.connected == snap.total == len(fleet.nodes)
    assert any(m.name == MODEL and m.healthy_replicas >= 2
               for m in snap.models)
    node = snap.node("n0")
    assert node is not None and node.hbm_budget > 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        node.alive = False
    # legacy dashboard() renders the same typed snapshot
    dash = ctrl.dashboard()
    assert dash["connected"] == snap.connected
    assert set(dash["agents"]) == {n.node_id for n in snap.nodes}
    assert dash["models"] == {m.name: m.replicas for m in snap.models}


def test_admin_scale_and_undeploy():
    model = "deepseek-r1-7b"
    fleet, ctrl = _accounted_stack(n_nodes=3, min_replicas=1)
    gw = Gateway(ctrl)
    assert len(ctrl.frontend.healthy_replicas(model)) == 1
    res = gw.admin.scale_model(model, 3)
    assert res.ok
    assert len(ctrl.frontend.healthy_replicas(model)) == 3
    res = gw.admin.scale_model(model, 1)
    assert len(ctrl.frontend.healthy_replicas(model)) == 1
    removed = gw.admin.undeploy_model(model)
    assert removed == 1
    assert model not in gw.models()
    resp = gw.generate(model, [1])
    assert resp.error.code is ErrorCode.NO_BACKEND


def test_undeploy_with_inflight_settles_structured(param_store):
    fleet, ctrl = _pinned_stack(param_store, n_nodes=1)
    gw = Gateway(ctrl)
    h = gw.submit(MODEL, [1, 2], SamplingParams(max_tokens=1000))
    assert not h.done
    gw.admin.undeploy_model(MODEL)
    # retired engine fails its queue -> handle settles immediately with a
    # structured error instead of stranding until the pump budget runs out
    assert h.done
    assert h.response.error.code in (ErrorCode.NO_BACKEND,
                                     ErrorCode.ENGINE_FAILED)
    assert gw.inflight(MODEL) == 0


def test_admin_drain_rejects_new_traffic(param_store):
    fleet, ctrl = _pinned_stack(param_store, n_nodes=1)
    gw = Gateway(ctrl)
    h = gw.submit(MODEL, [1], SamplingParams(max_tokens=4))
    remaining = gw.admin.drain_model(MODEL)
    assert remaining == 0                  # in-flight settled during drain
    assert h.done and h.response.ok
    rej = gw.submit(MODEL, [2], SamplingParams(max_tokens=2))
    assert rej.done
    assert rej.response.error.code is ErrorCode.DRAINING
    gw.admin.resume_model(MODEL)
    assert gw.generate(MODEL, [3], SamplingParams(max_tokens=2)).ok


def test_standalone_admin_requires_gateway_for_drain(live):
    fleet, ctrl = live
    admin = AdminAPI(ctrl)
    assert admin.snapshot().total == len(fleet.nodes)
    with pytest.raises(RuntimeError):
        admin.drain_model(MODEL)


# ------------------------- controller with engines ----------------- #
# (the engine-touching cases of tests/test_controller.py; the port has no
# `Client` shim yet, so the Gateway serves)
def test_testbed_deploy_and_serve(param_store):
    fleet = paper_testbed(param_store=param_store, device="cpu")
    catalog = ModelCatalog()
    tiny = dataclasses.replace(ZOO["llama3.2-1b"].reduced(),
                               name="llama3.2-1b")
    catalog.register(tiny)
    catalog.register(ZOO["deepseek-r1-7b"])
    ctrl = SDAIController(fleet, catalog)
    ctrl.discover()
    assert ctrl.nodes.payloads["node3"]["legacy"] is True
    plan = ctrl.deploy([
        ModelDemand(tiny, min_replicas=2, n_slots=2, max_len=48),
        ModelDemand(ZOO["deepseek-r1-7b"], min_replicas=2),
    ])
    assert not plan.unplaced
    gw = Gateway(ctrl)
    assert "llama3.2-1b" in gw.models()
    resp = gw.generate("llama3.2-1b", [1, 2, 3], SamplingParams(max_tokens=3))
    assert resp.ok and len(resp.tokens) == 3
    assert resp.ttft is not None and resp.latency is not None
    engines = [i.engine for n in fleet.nodes.values()
               for i in n.instances.values() if i.model_name == "llama3.2-1b"]
    assert engines and all(e is not None and e.device.type == "cpu"
                           for e in engines)
    dash = ctrl.dashboard()
    assert dash["connected"] == 6 and dash["total"] == 6
    assert "llama3.2-1b" in dash["models"]
    assert dash["routing"]["llama3.2-1b"]


# ------------------------- shared-default regression ---------------- #
def test_request_sampling_defaults_not_shared():
    from repro_torch.serving.request import Request
    a = Request(model="m", prompt=[1])
    b = Request(model="m", prompt=[2])
    assert a.sampling is not b.sampling
    c1 = SDAIController(Fleet([]), ModelCatalog())
    c2 = SDAIController(Fleet([]), ModelCatalog())
    assert c1.cfg is not c2.cfg
    assert c1.frontend.cfg is not c2.frontend.cfg
