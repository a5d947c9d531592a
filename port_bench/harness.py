"""One run of one cell: the cell's configuration, traffic and metrics found
by name under the benchmark's folder, the system under test built from
them, the shapes warmed, the window driven, the metrics read and the
served tokens judged.

The program is `repro_torch` (imported from `src/` beside this folder);
nothing here imports the JAX package.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from port_bench import check, flops
from port_bench.driver import Driver
from port_bench.traffic import Traffic
from port_bench.weights import make_params

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(bench: Path, name: str) -> Dict:
    """The cell's entry, its configuration, its traffic, its limits and
    the metrics it reports, all found by name."""
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = json.loads((bench / "configs" / f"{cell['config']}.json")
                     .read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())

    def reports(m: Dict) -> bool:
        return "workloads" not in m or name in m["workloads"]
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
            "per_layer": [m for m in spec["per_layer"] if reports(m)]}


def load_metric(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def arch_config(model: Dict):
    """The port's ArchConfig for a configuration's `model` block."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    keys = ("name", "family", "n_layers", "d_model", "n_heads",
            "n_kv_heads", "d_ff", "vocab", "head_dim", "norm", "act",
            "rope_theta", "tie_embeddings", "dtype")
    kw = {k: model[k] for k in keys}
    if model.get("moe"):
        kw["moe"] = MoEConfig(**model["moe"])
    return ArchConfig(**kw)


def engine_config(cfg: Dict, traffic: Dict, seed: int, overrides: Dict):
    from repro_torch.serving import EngineConfig
    kw = {**cfg["engine"], **traffic.get("engine", {}), **overrides}
    return EngineConfig(seed=int(seed) % 2 ** 63, **kw)


def warm(engine, traffic: Traffic, engine_kw: Dict) -> None:
    """Runs once every prefill shape this mix can ask for (each prompt
    bucket at each padded row count the scheduler can group) and a
    decode block."""
    from repro_torch.serving import Request, SamplingParams
    from port_bench.reference.decoder import bucket_of
    rows, n = [], 1
    while n <= engine.scheduler.cfg.max_prefill_per_step:
        rows.append(n)
        n *= 2
    rng = np.random.default_rng(12345)
    vocab = traffic.vocab

    def run(prompts: List[List[int]], budget: int = 1):
        for p in prompts:
            engine.submit(Request(model="warm", prompt=p, tenant="warm",
                                  sampling=SamplingParams(
                                      max_tokens=budget, eos_id=-1)))
        engine.run_until_done()

    def toks(n: int) -> List[int]:
        return rng.integers(0, vocab, n).tolist()

    def b_of(n):
        return bucket_of(n, engine_kw)
    for b in traffic.prompt_buckets(b_of):
        for n in rows:
            run([toks(b) for _ in range(n)])
    run([toks(int(traffic.spec["prompt"]["lo"]))],
        budget=2 * engine.ecfg.decode_block)


def device_info(dev) -> Dict:
    import torch
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": 1,
                "memory_peak_bytes": 0}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        power = out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        power = ""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit": power or "unknown"}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             bench: Path = BENCH, overrides: Optional[Dict] = None,
             traffic_overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the record the metric readers read, with
    `correct`, the numbers compared and the device.  `overrides` change
    the engine's settings (the control: {"quantize": "int8"}) and
    `traffic_overrides` the mix's (the sweep: {"rate": r}); the
    benchmark's own runs change neither."""
    import torch

    from repro_torch.serving import InferenceEngine
    started = time.perf_counter() if started is None else started
    spec = load_cell(bench, name)
    cfg = spec["config"]
    tspec = {**spec["traffic"], **(traffic_overrides or {})}
    model = cfg["model"]
    dev = torch.device(device)
    # the MoE router's f32 product must stay f32 (the program refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = make_params(model, seed, dev)
    ecfg = engine_config(cfg, tspec, seed, overrides or {})
    engine = InferenceEngine(arch_config(model), params, ecfg, device=dev)
    traffic = Traffic(tspec, seed, int(cfg.get("token_ids", model["vocab"])))
    warm(engine, traffic, {**cfg["engine"], **tspec.get("engine", {})})
    tracer = None
    if trace:
        from port_bench.trace import Tracer
        tracer = Tracer(engine)
        tracer.warm()
        tracer.install()
    driver = Driver(engine, traffic, model, tracer=tracer,
                    trace_s=float(tspec.get("trace_s", 2.0)))
    out = driver.run(float(tspec["ramp_s"]), seconds)
    setup_s = driver.w0 - started
    rec = _record(spec, driver, out, seconds, setup_s)
    if tracer is not None:
        t = out["traced"]
        rec["trace"] = tracer.read()
        rec["trace"]["window_s"] = t["t1"] - t["t0"]
        rec["trace"]["tokens"] = driver.traced_tokens
        rec["trace"]["flash_bound_s"] = sum(
            flops.flash_bound_s(*launch) for launch in tracer.flash_launches)
        rec["trace"]["decode_bound_s"] = out["decode_bound_s"]
        tracer.uninstall()
    rec["device"] = device_info(dev)
    # the program's state goes before the reference runs
    finished = [r for r in driver.finished if not r.error]
    misses = sum(len(r.output) != r.budget for r in finished)
    del engine, driver, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(check.judge(bench, cfg, spec["limits"], params, finished,
                           misses, seed))
    rec["spec"] = spec
    return rec


def _record(spec: Dict, driver: Driver, out: Dict, seconds: float,
            setup_s: float) -> Dict:
    """The run's record.  Requests sent inside the window are timed; one
    that errs or has no first token by the end of the drain has failed,
    and one still decoding then is timed over the tokens it has.  The
    counters (admissions, padding, useful work) cover the window up to
    the traced slice, or the whole window in an untraced run."""
    model = spec["config"]["model"]
    w0, w1 = driver.w0, driver.w1
    window = [r for r in driver.recs if w0 <= r.due < w1]
    ok = [r for r in window if not r.error and r.first is not None]
    ttft = [(r.first - r.due) * 1e3 for r in ok]
    tpot = [(r.last - r.first) * 1e3 / (len(r.output) - 1) for r in ok
            if len(r.output) > 1]
    snaps = out["snaps"]
    s0, s1 = snaps["open"], snaps.get("trace", snaps["close"])
    steps = range(s0["step"], s1["step"])
    admitted = [r for r in driver.recs if r.first_step in steps]
    useful = sum(flops.prefill_flops(model, len(r.prompt)) for r in admitted) \
        + sum(driver.decode_flops.get(k, 0.0) for k in steps)
    return {
        "seconds": seconds, "setup_s": setup_s,
        "attempted": len(window), "failed": len(window) - len(ok),
        "window_tokens": driver.window_tokens,
        "ttft_ms": ttft, "tpot_ms": tpot,
        "useful_flops": useful, "counted_s": s1["t"] - s0["t"],
        "counters": {"open": s0, "close": s1},
        "admitted_prompt_tokens": sum(len(r.prompt) for r in admitted),
        "backlog": out["backlog"], "sent": out["sent"],
        "completed_in_window": sum(1 for r in driver.finished
                                   if w0 <= r.done < w1),
    }
