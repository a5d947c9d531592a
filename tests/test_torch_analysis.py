"""repro_torch.analysis, the port's static analyzer and lock-order
tracker: the counterpart of tests/test_analysis.py.

The port's checkers against the JAX package's on the six seeded
fixtures of tests/fixtures/analysis (the same violation keys); the
PyTorch sync patterns through tests/fixtures/analysis_torch (one
fixture per added pattern, an upload-only fixture that is not flagged,
a fixture of host-side values); the CLI gate; the port's tree clean
against analysis_baseline_torch.json, whose hot-path-sync waivers are
exactly the engine's sanctioned syncs; the port's static lock edges
within the hierarchy; the tracker's inversion, re-entrance and
exclusivity; a CPU soak on the reduced OLMo-1B with the port's tracker
installed by a module fixture (Gateway pumps, a cancel, a mid-stream
migration after a node crash, two requests over the port's HTTP
server); the analyzer importing neither torch, jax nor repro; and
ROADMAP C19, the blocking uploads the step's path no longer makes."""
import json
import os
import pathlib
import subprocess
import sys
import threading
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import analysis as jax_analysis
from repro_torch.analysis import (ALLOWED_LOCKFREE, CANONICAL_ORDER,
                                  Baseline, HotPathSyncChecker,
                                  LockOrderChecker, LockOrderTracker,
                                  MutableDefaultChecker, RefcountChecker,
                                  SharedStateChecker, TrackedLock,
                                  allowed_edges, install, run_checkers,
                                  uninstall)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.core import ProjectIndex, load_modules
from repro_torch.analysis.hotpath import (SYNC, UPLOAD, hot_path_sites,
                                          reachable_functions)
from repro_torch.analysis.locks import static_edges
from repro_torch.api import Gateway, StreamEventType
from repro_torch.api.http import GatewayHTTPServer, HTTPClient, HTTPConfig
from repro_torch.cluster import BackendNode, Fleet
from repro_torch.configs import ARCHS
from repro_torch.core import (ModelCatalog, ReplicaInfo, ReplicaKey,
                              SDAIController)
from repro_torch.models import build
from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                 SamplingParams)

REPO = pathlib.Path(__file__).parents[1]
JAX_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
SRC = REPO / "src" / "repro_torch"
MODEL = "olmo-1b-reduced"

JAX_SEEDED = ("fx_lock_inversion.py", "fx_unguarded_state.py",
              "fx_mutable_default.py", "fx_hotpath_item.py",
              "fx_refcount_leak.py")
# each added PyTorch sync pattern: fixture -> the slugs it seeds
TORCH_SEEDED = {
    "fx_torch_cpu.py": ["cpu#0"],
    "fx_torch_numpy.py": ["numpy#0"],
    "fx_torch_to_cpu.py": ["to_cpu#0", "to_cpu#1"],
    "fx_torch_cuda_synchronize.py": ["synchronize#0"],
    "fx_torch_stream_synchronize.py": ["synchronize#0"],
    "fx_torch_nonzero.py": ["nonzero#0"],
    "fx_torch_unique.py": ["unique#0"],
    "fx_torch_masked_select.py": ["masked_select#0"],
    "fx_torch_where.py": ["where#0"],
    "fx_torch_repeat_interleave.py": ["repeat_interleave#0"],
    # host-side values are not flagged: only the .cpu() under .numpy()
    "fx_torch_host_side.py": ["cpu#0"],
}
# the engine's sanctioned syncs: one read per admission, one per decode
# block, the swap-out's read, the pinned-rows wait
SANCTIONED = {
    "src/repro_torch/serving/engine.py::InferenceEngine._admit_prefill::"
    "cpu#0",
    "src/repro_torch/serving/engine.py::InferenceEngine._admit_suffix::"
    "cpu#0",
    "src/repro_torch/serving/engine.py::InferenceEngine._decode_block::"
    "cpu#0",
    "src/repro_torch/serving/kv_cache.py::take_pages::cpu#0",
    "src/repro_torch/serving/kv_hierarchy.py::swap_out_slot::"
    "synchronize#0",
}


def _port_checkers():
    return [LockOrderChecker(), SharedStateChecker(), HotPathSyncChecker(),
            MutableDefaultChecker(), RefcountChecker()]


def _jax_checkers():
    return [jax_analysis.LockOrderChecker(), jax_analysis.SharedStateChecker(),
            jax_analysis.HotPathSyncChecker(),
            jax_analysis.MutableDefaultChecker(),
            jax_analysis.RefcountChecker()]


def _port_index():
    return ProjectIndex(load_modules([SRC], root=REPO))


# ---------------- the JAX fixtures, both analyzers ------------------ #
@pytest.mark.parametrize("name", JAX_SEEDED + ("fx_clean.py",))
def test_jax_fixture_same_keys_as_reference(name):
    path = JAX_FIXTURES / name
    port = run_checkers([path], _port_checkers(), root=JAX_FIXTURES)
    ref = jax_analysis.run_checkers([path], _jax_checkers(),
                                    root=JAX_FIXTURES)
    assert [v.key for v in port] == [v.key for v in ref]
    assert bool(port) == (name != "fx_clean.py")


@pytest.mark.parametrize("name", JAX_SEEDED)
def test_cli_exits_2_on_each_jax_fixture(name):
    assert analysis_main([str(JAX_FIXTURES / name), "--no-baseline",
                          "--check"]) == 2


def test_cli_exits_0_on_clean_fixture():
    assert analysis_main([str(JAX_FIXTURES / "fx_clean.py"),
                          "--no-baseline", "--check"]) == 0


# ---------------- the PyTorch sync patterns ------------------------ #
@pytest.mark.parametrize("name", sorted(TORCH_SEEDED))
def test_torch_fixture_flagged(name):
    vs = run_checkers([FIXTURES / name], _port_checkers(), root=FIXTURES)
    assert [(v.rule, v.symbol.split(".")[0]) for v in vs] == \
        [("hot-path-sync", "InferenceEngine")] * len(vs)
    assert sorted(v.detail for v in vs) == TORCH_SEEDED[name]


@pytest.mark.parametrize("name", sorted(TORCH_SEEDED))
def test_cli_exits_2_on_each_torch_fixture(name):
    assert analysis_main([str(FIXTURES / name), "--no-baseline",
                          "--check"]) == 2


def test_upload_only_fixture_is_no_sync():
    path = FIXTURES / "fx_torch_upload_only.py"
    assert run_checkers([path], _port_checkers(), root=FIXTURES) == []
    assert analysis_main([str(path), "--no-baseline", "--check"]) == 0
    sites = hot_path_sites(ProjectIndex(load_modules([path])))
    assert {s.kind for s in sites} == {UPLOAD}
    assert sorted(s.pattern for s in sites) == \
        ["as_tensor", "cuda", "tensor", "to", "to"]


def test_cli_waiver_lifecycle(tmp_path):
    """write-baseline absorbs with TODO reasons (exit 3 under --check
    until each is explained), then filled reasons gate green."""
    fx = str(FIXTURES / "fx_torch_cpu.py")
    b = tmp_path / "baseline.json"
    assert analysis_main([fx, "--baseline", str(b),
                          "--write-baseline"]) == 0
    assert analysis_main([fx, "--baseline", str(b), "--check"]) == 3
    data = json.loads(b.read_text())
    for w in data["waivers"]:
        w["reason"] = "fixture: intentionally seeded"
    b.write_text(json.dumps(data))
    assert analysis_main([fx, "--baseline", str(b), "--check"]) == 0


def test_stale_waiver_reported(tmp_path, capsys):
    b = tmp_path / "baseline.json"
    Baseline({"mutable-default::gone.py::f::arg:x": "was fixed"}).save(b)
    assert analysis_main([str(JAX_FIXTURES / "fx_clean.py"),
                          "--baseline", str(b), "--check"]) == 0
    assert "stale" in capsys.readouterr().out


def test_rules_subset():
    fx = str(JAX_FIXTURES / "fx_mutable_default.py")
    assert analysis_main([fx, "--no-baseline", "--check",
                          "--rules", "lock-order,hot-path-sync"]) == 0
    assert analysis_main([fx, "--no-baseline", "--check",
                          "--rules", "mutable-default"]) == 2
    assert analysis_main([fx, "--rules", "no-such-rule"]) == 2


# ---------------- the port's tree ---------------------------------- #
def test_port_tree_clean_against_baseline(monkeypatch):
    monkeypatch.chdir(REPO)
    assert analysis_main(["--check"]) == 0


def test_baseline_waivers_explained_and_sanctioned():
    b = Baseline.load(REPO / "analysis_baseline_torch.json")
    assert b.unexplained() == []
    assert all(k.split("::")[1].startswith("src/repro_torch/")
               for k in b.waivers)
    rule = "hot-path-sync::"
    assert {k[len(rule):] for k in b.waivers if k.startswith(rule)} \
        == SANCTIONED
    # the lock-free set is the reference's, kept as it is
    assert ALLOWED_LOCKFREE == jax_analysis.ALLOWED_LOCKFREE
    assert CANONICAL_ORDER == jax_analysis.CANONICAL_ORDER


def test_step_graph_reaches_no_handler_or_perf_model():
    """A bare call binds to module-level functions and `mod.f()` on an
    import to that module's: the kernel and MoE helpers' names
    (`_stream`, `_dispatch`, `record`) no longer pull HTTP handler and
    perf-model methods onto the step's graph (ROADMAP C20)."""
    reached = reachable_functions(_port_index())
    assert {"InferenceEngine._decode_block", "take_pages", "swap_out_slot",
            "rope_cos_sin", "to_device", "_stream", "_dispatch",
            "record"} <= reached
    assert not {"_Handler._stream", "_Handler._dispatch", "PerfModel.record",
                "GenerationHandle._cancel_backend"} & reached


def test_step_uploads_go_through_to_device():
    """ROADMAP C19: every host->device upload on the step's path is
    `to_device`'s pinned, non-blocking copy or a `.to(device)` of a
    tensor already there; rope's `torch.tensor(theta, device=)` was a
    blocking upload every model call."""
    sites = hot_path_sites(_port_index())
    uploads = sorted((s.symbol, s.text) for s in sites if s.kind == UPLOAD)
    assert uploads == [
        ("prefill", "lengths.to(h.device)"),
        ("prefill_suffix", "lengths.to(tokens.device)"),
        ("prefill_suffix", "offsets.to(tokens.device)"),
        ("to_device", "t.to(device, non_blocking=True)")]
    reads = {f"{s.file}::{s.symbol}::{s.pattern}#0" for s in sites
             if s.kind == SYNC}
    assert reads == SANCTIONED


def test_static_lock_edges_within_hierarchy():
    mods = [SRC / "cluster" / "node.py", SRC / "serving" / "engine.py",
            SRC / "serving" / "scheduler.py", SRC / "api" / "runtime.py",
            SRC / "api" / "http" / "server.py",
            SRC / "core" / "controller.py", SRC / "api" / "gateway.py"]
    edges = static_edges([str(m) for m in mods])
    assert edges <= allowed_edges(), edges - allowed_edges()
    assert ("node", "instance") in edges


# ---------------- runtime tracker ---------------------------------- #
def test_tracker_flags_inverted_acquisition():
    tr = LockOrderTracker()
    sched = TrackedLock(threading.Lock(), "scheduler", tr)
    node = TrackedLock(threading.RLock(), "node", tr)
    with sched:
        with node:                      # scheduler -> node: inversion
            pass
    assert len(tr.violations) == 1
    v = tr.violations[0]
    assert (v.held_level, v.acquired_level) == ("scheduler", "node")
    assert ("scheduler", "node") in tr.disallowed_edges()


def test_tracker_canonical_and_reentrant_are_clean():
    tr = LockOrderTracker()
    node = TrackedLock(threading.RLock(), "node", tr)
    inst = TrackedLock(threading.RLock(), "instance", tr)
    sched = TrackedLock(threading.Lock(), "scheduler", tr)
    with node:
        with node:                      # RLock re-entry: exempt
            with inst:
                with sched:
                    pass
    assert tr.violations == []
    assert tr.disallowed_edges() == set()
    assert tr.acquisitions == 4


@pytest.fixture(scope="module")
def port_tracker():
    """The port's tracker over every BackendNode / Instance / Scheduler
    the module builds, beside the JAX package's suite-wide tracker;
    uninstalled at teardown."""
    from repro_torch.analysis import tracker as tracker_mod
    tracker = LockOrderTracker()
    handle = install(tracker)
    yield tracker
    uninstall(handle)
    assert tracker_mod._active is None
    assert tracker.violations == [], tracker.report()
    assert tracker.disallowed_edges() == set()


def test_tracker_install_is_exclusive(port_tracker, lock_order_tracker):
    with pytest.raises(RuntimeError):
        install(LockOrderTracker())     # the module fixture holds it
    # the JAX package's suite-wide tracker is a separate installation
    from repro.analysis import tracker as jax_tracker
    assert jax_tracker._active is not None


def test_tracker_wraps_the_port_locks(port_tracker):
    from repro_torch.serving.scheduler import Scheduler
    node = BackendNode("w0", "rx6800-16gb", device="cpu")
    assert isinstance(node.lock, TrackedLock)
    assert isinstance(Scheduler()._lock, TrackedLock)


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


def test_tracker_zero_violations_under_soak(param_store, port_tracker):
    """Gateway pumps + a cancel + a mid-stream migration after a node
    crash, then two requests over the port's HTTP server, with the
    port's tracker live on every node, instance and scheduler: the
    actual acquisition order never leaves the static hierarchy."""
    tr = port_tracker
    before = (len(tr.violations), tr.acquisitions)
    fleet, ctrl = _pinned_stack(param_store)
    assert all(isinstance(inst.lock, TrackedLock)
               for node in fleet.nodes.values()
               for inst in node.instances.values())
    gw = Gateway(ctrl)
    gw.start()
    try:
        handles = [gw.submit(MODEL, [3, 1, 4, i], SamplingParams(
            max_tokens=8), tenant=f"t{i % 2}") for i in range(4)]
        handles[0].cancel()
        it = handles[1].stream()
        ev = next(it)
        while ev.type is not StreamEventType.TOKEN:
            ev = next(it)
        fleet.fail_node(handles[1].internal.node)    # migrate mid-stream
        for ev in it:
            pass
        assert handles[1].response.ok
        for h in handles[2:]:
            assert h.result(timeout_s=60).ok
    finally:
        assert gw.stop(timeout_s=10.0)
    _, ctrl = _pinned_stack(param_store)
    srv = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c = HTTPClient(srv.url())
    try:
        body = c.complete(MODEL, [5, 6, 7], max_tokens=4)
        assert body["usage"]["completion_tokens"] == 4
        chunks = list(c.complete(MODEL, [8, 9], max_tokens=3, stream=True))
        assert sum(ch["choices"][0].get("token") is not None
                   for ch in chunks) == 3
    finally:
        c.close()
        assert srv.stop(timeout_s=30.0)
    assert tr.violations[before[0]:] == [], \
        "\n".join(v.render() for v in tr.violations[before[0]:])
    assert tr.disallowed_edges() == set()
    assert tr.acquisitions > before[1]
    assert ("instance", "scheduler") in tr.edges


# ---------------- import-light ------------------------------------- #
def _blocked_env(tmp_path):
    """PYTHONPATH with stand-ins for torch, jax and repro ahead of src:
    importing any of them raises."""
    for name in ("torch", "jax", "repro"):
        pkg = tmp_path / "blocked" / name
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(
            f"raise ImportError('{name} is not importable here')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path / "blocked"), str(REPO / "src")])
    return env


def test_cli_runs_without_torch_jax_or_repro(tmp_path):
    env = _blocked_env(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.analysis, repro_torch.analysis.__main__;"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'repro')))"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert probe.returncode == 0, probe.stderr
    assert probe.stdout.strip() == "[]"


# ---------------- C19: no blocking upload on the step's path ------- #
class _HostScalarIndexPuts(TorchDispatchMode):
    """Where a step stores a value made from host data through a tensor
    index (`t[idx] = -1`: aten.lift_fresh, then aten.index_put_ with the
    lifted value).  On the card the value is made on the host and the
    index_put_ uploads it with a blocking copy; a store through an int
    index (`t[slot] = 0`) is a fill and does not."""

    def __init__(self):
        super().__init__()
        self.lifted = {}                # id -> weakref: ids get reused
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default:
            self.lifted[id(out)] = weakref.ref(out)
        elif func.overloadpacket in (torch.ops.aten.index_put_,
                                     torch.ops.aten.index_put) \
                and self.lifted.get(id(args[2]), lambda: None)() \
                is args[2]:
            frame = sys._getframe(1)
            while frame is not None and "repro_torch" not in \
                    frame.f_code.co_filename:
                frame = frame.f_back
            self.sites.append(frame.f_code.co_name if frame else None)
        return out


@pytest.mark.parametrize("mode", ["paged_attention", "swap", "prefix"])
def test_step_stores_no_host_scalar_through_a_tensor_index(
        param_store, mode):
    """ROADMAP C19: through admissions, decode blocks, a suffix
    admission and a swap-out / swap-in, no step stores a host-made value
    through a tensor index: `spec_table[idx] = -1` (each admission) and
    `active[idx] = True` (each swap-in) were blocking uploads on the
    card.  The other form, rope's `torch.tensor(theta, device=)`, is held
    by test_step_uploads_go_through_to_device."""
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32", name="olmo-1b-reduced-f32")
    kw = {"paged_attention": dict(paged_attention=True),
          "swap": dict(kv_pages=10, host_kv_pages=32),
          "prefix": dict(prefix_cache=True)}[mode]
    eng = InferenceEngine(cfg, param_store(cfg), EngineConfig(
        n_slots=4, max_len=64, page_size=8, decode_block=4, **kw),
        device="cpu")
    shared = list(range(1, 17))
    prompts = ([shared + [20 + i] for i in range(4)] if mode == "prefix"
               else [[3, 1, 4, 1, 5, 9, 2, 6][:3 + i] * 3 for i in range(4)])
    reqs = [Request(model=cfg.name, prompt=p,
                    sampling=SamplingParams(max_tokens=24))
            for p in prompts]
    puts = _HostScalarIndexPuts()
    with puts:
        if mode == "prefix":            # one at a time: later ones hit
            for r in reqs:
                assert eng.submit(r)
                eng.run_until_done()
        else:
            for r in reqs:
                assert eng.submit(r)
            eng.run_until_done()
    assert all(len(r.output) == 24 for r in reqs)
    st = eng.perf_stats()
    if mode == "swap":
        assert st["swap_outs"] >= 1 and st["swap_ins"] >= 1
    if mode == "prefix":
        assert st["suffix_prefills"] >= 1
    assert puts.lifted and puts.sites == []
