"""Where the time goes on the port's main paths, on one CUDA device.

    python3 tools/profile_serve.py           # serve_bf16
    python3 tools/profile_serve.py --int8    # serve_int8

Runs one of chip_smoke.py's serve workloads (the full OLMo-1B, 12 seeded
requests): serve_bf16 (bf16, the paged-attention mode) or, with --int8,
serve_int8 (int8 weights, the gather mode), three times on one engine: a
cold run (first use: kernel libraries loaded, cuBLAS initialised, pinned
buffers allocated),
a warm run timed on the host clock, and a warm run under
torch.profiler.  Prints one JSON line per run; the profiled one carries
the device busy time (sum of kernel times; one stream, so kernels do not
overlap), the device idle share of the profiled wall time, the device
time per kernel family (each of the port's kernels by route, cuBLAS,
and the rest) and the top kernels, and the CUDA kernel launches per
decode step.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (adds src/ to the path)

# (substring of the kernel's name, family); the first match wins, so a
# name that holds another (skinny_tc, skinny_) comes first
FAMILIES = (("paged_decode_kernel", "paged_decode_attention"),
            ("decode_split_kernel", "decode_attention (split)"),
            ("flash_tc", "flash_attention (tensor_core)"),
            ("flash_kernel", "flash_attention (cuda_core)"),
            ("tc_mm", "int8_matmul (tensor_core)"),
            ("skinny_tc", "int8_matmul (skinny_tc)"),
            ("skinny_", "int8_matmul (skinny)"),
            ("tile_mm", "int8_matmul (cuda_core_tile)"),
            ("gemm", "matmul"), ("cutlass", "matmul"), ("sm90", "matmul"),
            ("nvjet", "matmul"))


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other (elementwise, norms, copies, sampling)"


def run_line(tag, eng, step_ms, wall, before):
    st = eng.perf_stats()
    tokens = st["tokens"] - before["tokens"]
    return {"run": tag, "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "p50_step_ms": float(np.median(step_ms)),
            "steps": st["steps"] - before["steps"],
            "decode_dispatches": (st["decode_dispatches"]
                                  - before["decode_dispatches"]),
            "prefill_dispatches": (st["prefill_dispatches"]
                                   - before["prefill_dispatches"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true",
                    help="profile serve_int8 instead of serve_bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    ops.build()
    serve = "serve_int8" if args.int8 else "serve_bf16"
    engine_kw = (dict(quantize="int8") if args.int8
                 else dict(paged_attention=True))
    _, ecfg, eng, requests, _ = chip_smoke.serve_setup(dev, **engine_kw)
    for tag in ("cold", "warm"):
        before = eng.perf_stats()
        step_ms, wall = chip_smoke.drive(eng, requests())
        chip_smoke.emit({**run_line(tag, eng, step_ms, wall, before),
                         "serve": serve, "card": card})
    before = eng.perf_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_ms, wall = chip_smoke.drive(eng, requests())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    line = run_line("profiled", eng, step_ms, wall, before)
    kernels, fams, launches = [], {}, 0
    for evt in prof.key_averages():
        if evt.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += evt.count
        # device-side events only (kernels, copies, sets): CPU ops also
        # carry their children's device time, which would count twice
        if evt.device_type == DeviceType.CUDA:
            dev_us = evt.self_device_time_total
            kernels.append((dev_us, evt.count, evt.key))
            fam = family(evt.key)
            fams[fam] = fams.get(fam, 0.0) + dev_us
    busy_s = sum(k[0] for k in kernels) / 1e6
    kernels.sort(reverse=True)
    decode_steps = line["decode_dispatches"] * ecfg.decode_block
    chip_smoke.emit({
        **line, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            fams.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:90], "count": c, "device_ms": us / 1e3}
                        for us, c, n in kernels[:12]],
        "kernel_launches": launches,
        "decode_steps": decode_steps,
        "serve": serve, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
