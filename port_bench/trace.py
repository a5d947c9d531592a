"""The traced run (`--trace 1`): `torch.profiler` with the CUDA activity
alone (kernels, copies and the runtime's launch calls, from CUPTI; no
per-op host records, which would slow the host several-fold) over a
slice of the window that starts and ends at step boundaries.

The benchmark keeps its own host ranges (`bench.submit`, `engine.step`
with `engine.admit` and `engine.decode` inside it, `bench.callbacks`,
and `bench.wait`) on the profiler's clock (`time.time_ns`), and wraps
`repro_torch.kernels.ops.flash_attention` to record each launch's shape,
for the flash kernel's bound (`flops.flash_bound_s`); the wrapper
changes nothing that is run.

Each idle gap between device operations is charged to the innermost
benchmark range open on the host when it began.  The kernel-family
table is `tools/profile_serve.py`'s, with the split decode kernels of
PR 30 (`split_decode_tc<PagedRows, ...>` / `<ContigRows, ...>`) added.
"""
from __future__ import annotations

import bisect
import functools
import time
from typing import Dict, List, Optional

import torch

# (substring of the kernel's name, lowercased; family): the first match
# wins
FAMILIES = (("pagedrows", "paged_decode_attention"),
            ("contigrows", "decode_attention (split)"),
            ("paged_decode_kernel", "paged_decode_attention"),
            ("decode_split_kernel", "decode_attention (split)"),
            ("flash_tc", "flash_attention (tensor_core)"),
            ("flash_kernel", "flash_attention (cuda_core)"),
            ("tc_mm", "int8_matmul (tensor_core)"),
            ("skinny_tc", "int8_matmul (skinny_tc)"),
            ("skinny_", "int8_matmul (skinny)"),
            ("tile_mm", "int8_matmul (cuda_core_tile)"),
            ("gemm", "matmul"), ("cutlass", "matmul"), ("sm90", "matmul"),
            ("nvjet", "matmul"))
OTHER = "other (elementwise, norms, copies, sampling)"
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
# host ranges, innermost first where they nest
RANGES = ("bench.callbacks", "engine.admit", "engine.decode", "bench.submit",
          "bench.wait", "engine.step")


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return OTHER


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class _Range:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans: List, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, time.time_ns()))
        return False


class _Off:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Tracer:
    """Installs the wrappers for a traced run and reads its profile."""

    def __init__(self, engine):
        self.engine = engine
        self.active = False
        self.flash_launches: List[tuple] = []
        self.spans: List[tuple] = []
        self.prof = None
        self._undo: List = []

    def range(self, name: str):
        return _Range(self.spans, name) if self.active else _OFF

    # ---- wrappers ------------------------------------------------- #
    def install(self) -> None:
        from repro_torch.kernels import ops

        flash = ops.flash_attention

        @functools.wraps(flash)
        def flash_rec(q, k, v, *, causal=True, window=0, prefix=0):
            if self.active:
                b, h, sq, hd = q.shape
                self.flash_launches.append(
                    (b, h, k.shape[1], sq, k.shape[2], hd, bool(causal),
                     q.element_size()))
            return flash(q, k, v, causal=causal, window=window,
                         prefix=prefix)

        self._patch(ops, "flash_attention", flash_rec)
        eng = self.engine
        self._patch(eng, "_admit", self._ranged("engine.admit", eng._admit))
        self._patch(eng, "_decode_block",
                    self._ranged("engine.decode", eng._decode_block))

    def _ranged(self, name, fn):
        def call(*args, **kw):
            with self.range(name):
                return fn(*args, **kw)
        return call

    def _patch(self, obj, name, new) -> None:
        had = name in vars(obj)
        self._undo.append((obj, name, getattr(obj, name), had))
        setattr(obj, name, new)

    def uninstall(self) -> None:
        for obj, name, old, had in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()

    # ---- the traced slice ------------------------------------------ #
    def warm(self) -> None:
        """A first profile of nothing, in set-up: the profiler's first
        start initialises CUPTI, which takes about a second."""
        self.start()
        torch.zeros(1, device="cuda").add_(1)
        self.stop(time.perf_counter)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True

    def stop(self, clock) -> float:
        """Ends the slice; returns its end on `clock`, read once the
        device has finished and before the profiler's own wind-down."""
        torch.cuda.synchronize()
        end = clock()
        self.active = False
        self.prof.__exit__(None, None, None)
        return end

    def read(self) -> Dict:
        """Device busy seconds, kernel launches, device seconds by family,
        the flash kernel's device seconds, and the idle gaps by host
        range."""
        events = self.prof.profiler.kineto_results.events()
        dev, launch_at = [], {}
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(e)
            elif e.name() in LAUNCH_EVENTS:
                launch_at[e.correlation_id()] = e.start_ns()
        fams: Dict[str, float] = {}
        kernels, flash_s = 0, 0.0
        intervals = []
        for e in dev:
            name = e.name()
            t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
            intervals.append((t0, t1))
            sec = e.duration_ns() / 1e9
            fam = family(name)
            fams[fam] = fams.get(fam, 0.0) + sec
            if _is_copy(name):
                continue
            kernels += 1
            if fam.startswith("flash_attention"):
                flash_s += sec
        busy, idle = _busy_and_idle(intervals, self.spans)
        # the clocks agree when the launch calls fall in the host ranges
        # and each kernel starts after its launch
        steps = sorted((t0, t1) for n, t0, t1 in self.spans
                       if n in RANGES)
        starts = [t0 for t0, _ in steps]
        in_range = sum(_inside(t, steps, starts) for t in launch_at.values())
        lag = sorted(e.start_ns() - launch_at[e.correlation_id()]
                     for e in dev if e.correlation_id() in launch_at)
        after = sum(x >= 0 for x in lag)
        clock = {"launches_in_ranges": in_range / max(len(launch_at), 1),
                 "kernels_after_launch": after / max(len(dev), 1),
                 # a kernel's start less its launch call's, in us (5th,
                 # 50th and 95th percentiles): a negative lag is the
                 # offset between the profiler's device and host clocks
                 "launch_to_start_us": [lag[int(q * (len(lag) - 1))] / 1e3
                                        for q in (0.05, 0.5, 0.95)]
                 if lag else []}
        return {"busy_s": busy, "kernels": kernels, "clock": clock,
                "runtime_launches": len(launch_at), "family_s": fams,
                "flash_device_s": flash_s,
                "idle_s": idle}


def _inside(t: int, spans: List, starts: List) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][1] >= t


def _busy_and_idle(intervals: List, spans: List) -> tuple:
    """Busy seconds of the merged device intervals, and each gap between
    them charged to the innermost benchmark range open at its start."""
    intervals.sort()
    merged: List[list] = []
    for t0, t1 in intervals:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged) / 1e9
    by_name = {name: sorted((t0, t1) for n, t0, t1 in spans if n == name)
               for name in RANGES}
    starts = {name: [t0 for t0, _ in v] for name, v in by_name.items()}
    idle: Dict[str, float] = {}
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        at = _open_range(g0, by_name, starts) or "host: other"
        idle[at] = idle.get(at, 0.0) + (g1 - g0) / 1e9
    return busy, idle


def _open_range(t: int, spans: Dict, starts: Dict) -> Optional[str]:
    for name in RANGES:
        if _inside(t, spans[name], starts[name]):
            return name
    return None
