"""The port's counterpart of tests/test_runtime.py, on its engines on the
CPU.

Continuous serving runtime: background pumps, event-blocking handles,
per-tenant token buckets, wall-clock timeouts, load-driven autoscale (up
AND down), and the threaded soak (concurrent tenants + mid-run node
kill)."""
import dataclasses
import threading
import time

import pytest
import torch

from repro_torch.api import (ErrorCode, Gateway, RuntimeConfig,
                             StreamEventType, TenantQuota)
from repro_torch.cluster import BackendNode, Fleet
from repro_torch.configs import ARCHS
from repro_torch.core import (ModelCatalog, ModelDemand, ModelLoad,
                              SDAIController)
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


def _stack(param_store, n_nodes=2, n_slots=2, max_len=48, min_replicas=2,
           max_replicas=0, fill=True):
    fleet = Fleet([BackendNode(f"n{i}", "rx6800-16gb",
                               param_store=param_store, device="cpu")
                   for i in range(n_nodes)])
    cfg = ARCHS["olmo-1b"].reduced()
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog)
    ctrl.cfg.fill_vram = fill
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, min_replicas=min_replicas,
                                    max_replicas=max_replicas,
                                    n_slots=n_slots, max_len=max_len)])
    assert not plan.unplaced
    return fleet, ctrl


@pytest.fixture(scope="module")
def shared(param_store):
    """Module-shared healthy stack (tests that kill nodes build their
    own)."""
    return _stack(param_store)


@pytest.fixture()
def gw(shared):
    fleet, ctrl = shared
    gateway = Gateway(ctrl)
    yield gateway
    gateway.stop(timeout_s=10.0)


# -------------------- lifecycle ------------------------------------ #
def test_runtime_drives_fleet_without_caller_pumps(gw):
    rt = gw.start()
    assert rt.running and gw.runtime_active
    handles = [gw.submit(MODEL, [1, 2, i + 1],
                         SamplingParams(max_tokens=4))
               for i in range(4)]
    for h in handles:
        resp = h.result(timeout_s=60)
        assert resp.ok and len(resp.tokens) == 4
    # pump threads did all the work: the callers never advanced the fleet
    assert gw.stats.caller_pumps == 0
    # a pump thread publishes its stats when the pump call that finished
    # these requests returns, after their handles woke: join the threads
    # before reading them
    assert gw.stop(timeout_s=10.0) is True
    assert rt.stats.tokens_pumped > 0


def test_stop_joins_all_pump_threads(gw):
    rt = gw.start()
    threads = rt.threads()
    assert len(threads) == len(gw.c.fleet.nodes) + 1   # pumps + ticker
    assert all(t.is_alive() for t in threads)
    assert gw.stop() is True
    assert all(not t.is_alive() for t in threads)
    # restartable: a fresh start serves again
    gw.start()
    assert gw.generate(MODEL, [5], SamplingParams(max_tokens=2),
                       timeout_s=60).ok
    assert gw.stop() is True


def test_stop_drains_inflight_work(gw):
    gw.start()
    handles = [gw.submit(MODEL, [3, i + 1], SamplingParams(max_tokens=6))
               for i in range(4)]
    assert gw.stop(drain=True, timeout_s=60) is True
    assert all(h.done for h in handles)
    assert all(h.response.ok for h in handles)


def test_streaming_through_runtime(gw):
    gw.start()
    events = list(gw.submit(MODEL, [9, 9],
                            SamplingParams(max_tokens=5)).stream(
                                timeout_s=60))
    toks = [e for e in events if e.type is StreamEventType.TOKEN]
    assert len(toks) == 5
    assert [e.index for e in toks] == list(range(5))
    assert events[-1].type is StreamEventType.FINISH
    assert gw.stats.caller_pumps == 0


# -------------------- tenant rate limits --------------------------- #
def test_rate_limited_tenant_gets_structured_429(gw):
    gw.admin.set_tenant_quota("burst1", requests_per_s=1)
    h1 = gw.submit(MODEL, [1], SamplingParams(max_tokens=2),
                   tenant="burst1")
    h2 = gw.submit(MODEL, [2], SamplingParams(max_tokens=2),
                   tenant="burst1")
    assert h2.done                          # rejected at admission
    assert h2.response.error.code is ErrorCode.RATE_LIMITED
    assert h2.response.error.retryable
    assert gw.stats.rejected_rate_limited == 1
    # an unlimited tenant is unaffected
    h3 = gw.submit(MODEL, [3], SamplingParams(max_tokens=2),
                   tenant="other")
    assert not h3.done
    assert h1.result(timeout_s=60).ok and h3.result(timeout_s=60).ok
    # buckets refill over wall clock: tenant admits again
    time.sleep(1.1)
    assert gw.generate(MODEL, [4], SamplingParams(max_tokens=2),
                       tenant="burst1", timeout_s=60).ok
    gw.admin.remove_tenant_quota("burst1")


def test_token_rate_quota_charges_max_tokens(gw):
    gw.admin.set_tenant_quota("tokcap", TenantQuota(tokens_per_s=4,
                                                    burst_tokens=4))
    ok = gw.submit(MODEL, [1], SamplingParams(max_tokens=4),
                   tenant="tokcap")
    hot = gw.submit(MODEL, [2], SamplingParams(max_tokens=4),
                    tenant="tokcap")
    assert hot.done
    assert hot.response.error.code is ErrorCode.RATE_LIMITED
    assert "tok/s" in hot.response.error.message
    assert ok.result(timeout_s=60).ok
    gw.admin.remove_tenant_quota("tokcap")


def test_tenant_quotas_inspectable_via_admin(gw):
    gw.admin.set_tenant_quota("acme", requests_per_s=100)
    gw.submit(MODEL, [1], SamplingParams(max_tokens=2),
              tenant="acme").result(timeout_s=60)
    snap = gw.admin.snapshot()
    acme = {t.tenant: t for t in snap.tenants}["acme"]
    assert acme.requests_per_s == 100
    assert acme.admitted >= 1
    assert acme.tokens_charged >= 2
    assert "acme" in snap.to_dict()["tenants"]
    assert "acme" in gw.admin.tenant_quotas()
    gw.admin.remove_tenant_quota("acme")
    assert "acme" not in gw.admin.tenant_quotas()


# -------------------- wall-clock timeout (bugfix) ------------------ #
def test_blocking_calls_time_out_on_wall_clock(gw):
    # hand-pump mode: an already-expired deadline surfaces TIMEOUT
    # deterministically — no pump-step counting involved
    h = gw.submit(MODEL, [7], SamplingParams(max_tokens=1000))
    resp = h.result(timeout_s=0.0)
    assert resp.error.code is ErrorCode.TIMEOUT
    assert resp.error.retryable
    assert gw.stats.timeouts == 1


def test_long_generation_not_spuriously_capped(gw):
    # the old pump-count cap could fire on long generations; wall-clock
    # budgets don't (40 tokens through 2-slot engines, many pump rounds)
    resp = gw.generate(MODEL, [1, 2], SamplingParams(max_tokens=40),
                       timeout_s=120)
    assert resp.ok and len(resp.tokens) == 40


def test_timeout_in_runtime_mode(gw):
    gw.start()
    h = gw.submit(MODEL, [8], SamplingParams(max_tokens=1000))
    resp = h.result(timeout_s=0.001)
    assert resp.error.code is ErrorCode.TIMEOUT
    # the slot freed: a fresh request completes
    assert gw.generate(MODEL, [9], SamplingParams(max_tokens=2),
                       timeout_s=60).ok


# -------------------- load-driven autoscale ------------------------ #
def test_sustained_pressure_triggers_scale_up(param_store):
    fleet, ctrl = _stack(param_store, n_nodes=3, min_replicas=1,
                         max_replicas=3, fill=False)
    assert len(ctrl.replicas.for_model(MODEL)) == 1
    acfg = ctrl.cfg.autoscale
    for _ in range(acfg.sustain_ticks + 1):
        ctrl.tick(load={MODEL: ModelLoad(
            queue_depth=8, inflight=8,
            replicas=len(ctrl.frontend.healthy_replicas(MODEL)))})
    assert ctrl.scale_ups == 1
    assert len(ctrl.replicas.for_model(MODEL)) == 2
    assert ctrl.bus.of_kind("autoscaled_up")
    # cooldown: immediate further pressure does not thrash
    ctrl.tick(load={MODEL: ModelLoad(queue_depth=8, inflight=8,
                                     replicas=2)})
    assert ctrl.scale_ups == 1


def test_scale_up_respects_replica_cap_and_vram(param_store):
    fleet, ctrl = _stack(param_store, n_nodes=2, min_replicas=2,
                         max_replicas=2, fill=False)
    assert ctrl.scale_up(MODEL) is False          # at replica cap
    assert len(ctrl.replicas.for_model(MODEL)) == 2


def test_idle_models_never_scale(param_store):
    fleet, ctrl = _stack(param_store, n_nodes=3, min_replicas=1,
                         max_replicas=3, fill=False)
    for _ in range(10):
        ctrl.tick(load={MODEL: ModelLoad(queue_depth=0, inflight=0,
                                         replicas=1)})
    assert ctrl.scale_ups == 0
    assert len(ctrl.replicas.for_model(MODEL)) == 1


# -------------------- load-driven scale-down ----------------------- #
def test_idle_streak_scales_down_to_min_with_cooldown(param_store):
    fleet, ctrl = _stack(param_store, n_nodes=3, min_replicas=1,
                         max_replicas=3, fill=False)
    acfg = ctrl.cfg.autoscale
    acfg.idle_sustain_ticks, acfg.down_cooldown_ticks = 3, 4
    assert ctrl.scale_up(MODEL) and ctrl.scale_up(MODEL)
    assert len(ctrl.replicas.for_model(MODEL)) == 3
    hbm_before = fleet.used_hbm()

    def idle_tick():
        ctrl.tick(load={MODEL: ModelLoad(
            queue_depth=0, inflight=0,
            replicas=len(ctrl.frontend.healthy_replicas(MODEL)))})

    for _ in range(acfg.idle_sustain_ticks):
        idle_tick()
    assert ctrl.scale_downs == 1            # one retirement per streak
    assert len(ctrl.replicas.for_model(MODEL)) == 2
    assert ctrl.bus.of_kind("autoscaled_down")
    assert fleet.used_hbm() < hbm_before    # VRAM returned to the pool
    # cooldown: the next idle ticks don't immediately retire another
    for _ in range(2):
        idle_tick()
    assert ctrl.scale_downs == 1
    # ... but a full streak after cooldown does, down to min_replicas
    for _ in range(40):
        idle_tick()
    assert ctrl.scale_downs == 2
    assert len(ctrl.replicas.for_model(MODEL)) == 1
    # the floor holds no matter how long the model idles
    for _ in range(40):
        idle_tick()
    assert len(ctrl.replicas.for_model(MODEL)) == 1


def test_scale_down_never_retires_busy_replicas(param_store):
    fleet, ctrl = _stack(param_store, n_nodes=2, min_replicas=2,
                         max_replicas=2, fill=False)
    ctrl.demands[MODEL] = dataclasses.replace(ctrl.demands[MODEL],
                                              min_replicas=1)
    gw = Gateway(ctrl)
    handles = [gw.submit(MODEL, [1, 2, i + 1],
                         SamplingParams(max_tokens=4)) for i in range(2)]
    # both replicas hold work -> nothing is eligible to retire
    assert ctrl.scale_down(MODEL) is False
    assert len(ctrl.replicas.for_model(MODEL)) == 2
    for h in handles:
        assert h.result(timeout_s=60).ok
    # drained: the surplus replica retires cleanly
    assert ctrl.scale_down(MODEL) is True
    assert len(ctrl.replicas.for_model(MODEL)) == 1
    assert gw.generate(MODEL, [3], SamplingParams(max_tokens=2),
                       timeout_s=60).ok


def test_runtime_closes_the_elasticity_loop(param_store):
    """Through the live runtime: sustained pressure grows the model,
    sustained idleness shrinks it back to min_replicas."""
    fleet, ctrl = _stack(param_store, n_nodes=3, min_replicas=1,
                         max_replicas=3, fill=False)
    acfg = ctrl.cfg.autoscale
    acfg.sustain_ticks, acfg.cooldown_ticks = 2, 2
    acfg.idle_sustain_ticks, acfg.down_cooldown_ticks = 5, 2
    gw = Gateway(ctrl)
    gw.start(RuntimeConfig(tick_interval_s=0.01))
    try:
        handles = [gw.submit(MODEL, [1, 2, (i % 5) + 1],
                             SamplingParams(max_tokens=10))
                   for i in range(16)]
        for h in handles:
            assert h.result(timeout_s=120) is not None
        deadline = time.monotonic() + 60
        while ctrl.scale_ups < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctrl.scale_ups >= 1          # grew under pressure
        while (len(ctrl.replicas.for_model(MODEL)) > 1
               and time.monotonic() < deadline):
            time.sleep(0.01)                # idle: shrink back
        assert len(ctrl.replicas.for_model(MODEL)) == 1
        assert ctrl.scale_downs >= 1
        assert ctrl.bus.of_kind("autoscaled_down")
        # the survivor still serves
        assert gw.generate(MODEL, [7], SamplingParams(max_tokens=2),
                           timeout_s=60).ok
    finally:
        assert gw.stop(timeout_s=60) is True


# -------------------- threaded soak -------------------------------- #
def test_soak_concurrent_tenants_node_kill_and_clean_stop(param_store):
    """N tenants submit concurrently through the runtime; one node dies
    mid-run.  Every request settles (ok or structured error), streams
    lose/duplicate no tokens, the rate-limited tenant sees RATE_LIMITED
    (never OVERLOADED), and stop() joins every pump thread."""
    fleet, ctrl = _stack(param_store, n_nodes=3, min_replicas=3,
                         max_replicas=3, fill=False)
    gw = Gateway(ctrl)
    # burst of 2, then effectively no refill during the run: the capped
    # tenant deterministically sees RATE_LIMITED on later submits
    gw.admin.set_tenant_quota("capped", TenantQuota(requests_per_s=0.01,
                                                    burst_requests=2))
    rt = gw.start(RuntimeConfig(tick_interval_s=0.02))
    results = []            # (tenant, response, stream_tokens)
    lock = threading.Lock()

    def worker(tenant, n_requests):
        for i in range(n_requests):
            h = gw.submit(MODEL, [1, 2, (i % 5) + 1],
                          SamplingParams(max_tokens=6), tenant=tenant)
            toks = []
            for ev in h.stream(timeout_s=120):
                if ev.type is StreamEventType.TOKEN:
                    toks.append((ev.index, ev.token))
            with lock:
                results.append((tenant, h.response, toks))

    tenants = ["alpha", "beta", "gamma", "capped"]
    threads = [threading.Thread(target=worker, args=(t, 5))
               for t in tenants]
    for t in threads:
        t.start()
    time.sleep(0.3)
    victim = "n2"
    fleet.fail_node(victim)                 # mid-run outage
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()

    assert len(results) == len(tenants) * 5
    ok = 0
    for tenant, resp, toks in results:
        assert resp is not None             # every request settled
        if resp.ok:
            ok += 1
            # stream integrity: indexes contiguous, tokens match the
            # final response exactly — nothing lost, nothing duplicated
            assert [i for i, _ in toks] == list(range(len(toks)))
            assert [tok for _, tok in toks] == list(resp.tokens)
        else:
            assert resp.error.code in (ErrorCode.ENGINE_FAILED,
                                       ErrorCode.RATE_LIMITED,
                                       ErrorCode.TIMEOUT,
                                       ErrorCode.NO_BACKEND)
            if tenant != "capped":
                assert resp.error.code is not ErrorCode.RATE_LIMITED
    assert ok >= 10                         # the fleet kept serving
    capped_codes = [r.error.code for t, r, _ in results
                    if t == "capped" and not r.ok]
    assert ErrorCode.OVERLOADED not in capped_codes
    assert any(c is ErrorCode.RATE_LIMITED for c in capped_codes)

    threads = rt.threads()
    assert gw.stop(timeout_s=60) is True
    assert all(not t.is_alive() for t in threads)
