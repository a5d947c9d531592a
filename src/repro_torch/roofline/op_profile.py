"""One step's per-rank counts, taken while it runs: the counterpart of
`repro.roofline.hlo_profile`.

JAX's profiler parses the compiled per-device HLO module.  The port has
no compiled program to parse, so it runs the step (on meta tensors, which
compute nothing, or on real ones) under a dispatch mode (`profile`) that
sees every aten op each rank runs on its own blocks.  DTensors are
deferred to, so the mode sees the ops DTensor runs on the local blocks,
not the global op (torch's `FlopCounterMode` counts a DTensor matmul's
global FLOPs); the ops DTensor runs only to propagate shapes (under its
fake-tensor mode) are not counted.  Per rank it counts:

- flops: 2 M N K of every dot-like op (mm, bmm, addmm, baddbmm, mv, dot;
  einsum's products reach the dispatcher as these), from the local
  shapes: a sharded product counts its block, a replicated one the whole
  on every rank, as the per-device SPMD module does (`_dot_flops`);
- bytes: the input plus output bytes of every op that is not a view (a
  view, `select` of one layer's slice from a stacked (L, ...) leaf
  included, moves 0 bytes, so stacked weights are charged once: the
  counterpart of "scanned xs counted once"); an in-place update of rows
  (`index_put_`) is charged twice its payload, as JAX's
  dynamic-update-slice, a read of rows (`index`, `gather`, `embedding`)
  twice its output, as JAX's gather, and `copy_` its source and
  destination once;
  an uninitialised allocation nothing;
- kernel_bytes: the bytes inside the plain versions of the hand-written
  kernels (`kernels.ops`: flash, decode, paged decode attention, the int8
  product) less their own inputs and outputs: the intermediates (score
  tiles, dequantized weights) that the kernel keeps in shared memory and
  registers on the card.  The counterpart of JAX's named-scope tagging
  (`_kernel_tagged`).  Plain PyTorch attention (training's, the int8
  cache's dequantization, the sequence-sharded merge) stays in bytes: on
  the card its traffic is real;
- collectives: the wire bytes by kind, in the ring model
  (`analysis.collective_bytes`), of the port's own collectives as
  `distributed.sharding.record_collectives` records them, and of any
  functional collective DTensor issues by itself when an op's inputs need
  another layout (seen as ops: all-gather, reduce-scatter, all-reduce,
  all-to-all).

What has no counterpart: HLO while-loop trip counts.  Torch runs every
iteration of a Python loop (over layers, over an sLSTM's time steps), so
each op is counted once a trip by construction, and nested loops
multiply by themselves.  Fusion: every op's operands are charged, as an
unfused program moves them; XLA charges a fused computation at its call
site.  A program's temporaries and peak are not tracked: a meta tensor
has no allocator, and liveness from Python references is not what a
card's caching allocator holds (`launch.dryrun` says so in its record).

`profile(attribute=True)` also keeps each count under the site that
issued it (the innermost `repro_torch` model or kernel function on the
stack, as "models/transformer.py:_attend_cache"), which
`roofline.inspect` ranks: the counterpart of HLO's op_name paths.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, Iterator, List, Optional

import torch

from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops as kernel_ops

# the ops that move no bytes although their schema says they return a
# new tensor: allocations and aliases
_ZERO_BYTE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "_unsafe_view", "_local_scalar_dense",
                  "lift_fresh", "resize_", "set_"}
_ROW_UPDATES = {"index_put_", "index_put", "index_copy_", "index_copy",
                "scatter_", "masked_scatter_"}
# the ops that read only the rows they return (JAX charges a gather twice
# its output)
_ROW_READS = {"index", "gather", "index_select", "embedding"}
# DTensor's functional collectives (what its own redistribution runs)
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _dot_flops(name: str, args) -> float:
    """2 M N K of a dot-like op from its operands' (local) shapes."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if name == "dot":
        return 2.0 * args[0].shape[0]
    return 0.0


DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot")


@dataclasses.dataclass
class OpProfile:
    """The counts of one run, per rank (JAX's `HLOProfile`'s fields;
    `loop_trips` has no counterpart, see the module docstring)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_bytes: float = 0.0          # kept on chip by the kernels
    kernel_coll_bytes: float = 0.0     # no kernel issues a collective
    ops: int = 0
    records: List[S.CollectiveRecord] = dataclasses.field(
        default_factory=list)
    # site -> {"flops", "bytes", "coll"} (profile(attribute=True))
    sites: Optional[Dict[str, Dict[str, float]]] = None

    def add_coll(self, kind: str, b: float) -> None:
        self.coll_bytes += b
        self.coll_breakdown[kind] = self.coll_breakdown.get(kind, 0.0) + b


def _site() -> str:
    """The innermost `repro_torch` model or kernel function on the stack
    (else the innermost `repro_torch` one outside this package)."""
    f = sys._getframe(2)
    fallback = None
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in fn and "/roofline/" not in fn:
            rel = fn.split("/repro_torch/", 1)[1]
            if rel.startswith(("models/", "kernels/")):
                return f"{rel}:{f.f_code.co_name}"
            fallback = fallback or f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return fallback or "?"


class _Counter:
    """What the mode calls with each op it counts, and the kernels' plain
    versions' observer (`kernels.ops.PLAIN_OBSERVERS`)."""

    def __init__(self, prof: OpProfile, attribute: bool):
        self.prof, self.attribute = prof, attribute
        self.region_depth = 0
        self.region_bytes = 0.0
        # DTensor's own collectives, and the sites of the port's (one
        # c10d op each, in the order of their records)
        self.implicit: List[S.CollectiveRecord] = []
        self.implicit_sites: List[str] = []
        self.port_sites: List[str] = []

    def _at(self, key: str, v: float) -> None:
        if self.attribute and v:
            site = self.prof.sites.setdefault(
                _site(), {"flops": 0.0, "bytes": 0.0, "coll": 0.0})
            site[key] += v

    def op(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "c10d":                 # recorded by the port's own calls
            if self.attribute:
                self.port_sites.append(_site())
            return
        if ns == "_c10d_functional":
            self._functional(name, args, out)
            return
        self.prof.ops += 1
        if name in DOT_OPS:
            f = _dot_flops(name, args)
            self.prof.flops += f
            self._at("flops", f)
        if func.is_view or name in _ZERO_BYTE_OPS:
            return
        if name in _ROW_UPDATES:         # the rows written twice
            vals = [_nbytes(t) for t in _tensors(args[1:])]
            b = float(max(vals, default=0) + sum(vals))
        elif name in _ROW_READS:         # the rows, read and written
            idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
            b = 2.0 * sum(_nbytes(t) for t in _tensors(out)) + \
                sum(_nbytes(t) for t in idx)
        elif name == "copy_":
            b = float(_nbytes(args[0]) + _nbytes(args[1]))
        else:
            b = float(sum(_nbytes(t) for t in _tensors(args))
                      + sum(_nbytes(t) for t in _tensors(kwargs))
                      + sum(_nbytes(t) for t in _tensors(out)))
        self.prof.bytes += b
        if self.region_depth:
            self.region_bytes += b
        self._at("bytes", b)

    def _functional(self, name: str, args, out) -> None:
        kind = _FUNCTIONAL.get(name)
        if kind is None:                 # wait_tensor and the like
            return
        from torch.distributed.distributed_c10d import _resolve_process_group
        size = _resolve_process_group(args[-1]).size()   # the group's name
        full = _tensors(out)[0] if kind == "all-gather" else args[0]
        self.implicit.append(S.CollectiveRecord(kind, _nbytes(full), size))
        if self.attribute:
            self.implicit_sites.append(_site())

    # kernels.ops.PLAIN_OBSERVERS
    def kernel_enter(self, name: str) -> None:
        if not self.region_depth:
            self.region_bytes = 0.0
        self.region_depth += 1

    def kernel_exit(self, name: str, args, out) -> None:
        self.region_depth -= 1
        if self.region_depth:
            return
        io = sum(_nbytes(t) for t in _tensors(args) + _tensors(out))
        self.prof.kernel_bytes += max(self.region_bytes - io, 0.0)


def _make_mode(counter: _Counter):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import (
        TorchDispatchMode, _get_current_dispatch_mode_stack)

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented    # count the ops on its blocks
            out = func(*args, **kwargs)
            shadow = any(isinstance(m, FakeTensorMode)
                         for m in _get_current_dispatch_mode_stack()) or \
                any(isinstance(t, FakeTensor) for t in _tensors(args))
            if not shadow:               # not DTensor's shape propagation
                counter.op(func, args, kwargs, out)
            return out
    return _Mode()


@contextlib.contextmanager
def profile(*, attribute: bool = False) -> Iterator[OpProfile]:
    """Counts every op run inside the block on this rank; the OpProfile
    it yields is complete when the block exits (the collectives priced
    in the ring model there)."""
    from repro_torch.roofline.analysis import collective_bytes
    prof = OpProfile(sites={} if attribute else None)
    counter = _Counter(prof, attribute)
    kernel_ops.PLAIN_OBSERVERS.append(counter)
    try:
        with S.record_collectives() as recs, _make_mode(counter):
            yield prof
    finally:
        kernel_ops.PLAIN_OBSERVERS.remove(counter)
    prof.records = list(recs) + counter.implicit
    for kind, b in collective_bytes(prof.records).items():
        prof.add_coll(kind, b)
    if attribute:
        sites = counter.port_sites + counter.implicit_sites
        for rec, site in zip(prof.records, sites):
            s = prof.sites.setdefault(site, {"flops": 0.0, "bytes": 0.0,
                                             "coll": 0.0})
            s["coll"] += sum(collective_bytes([rec]).values())


def count(fn, *args, attribute: bool = False, **kwargs):
    """(fn(*args, **kwargs), its OpProfile)."""
    with profile(attribute=attribute) as prof:
        out = fn(*args, **kwargs)
    return out, prof
