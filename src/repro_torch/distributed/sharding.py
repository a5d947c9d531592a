"""Logical-axis sharding on DTensor, the counterpart of
`repro.distributed.sharding`: MaxText-style rules with divisibility
fallbacks.

Every model tensor (param, activation, cache) is annotated with a tuple
of *logical* axis names.  A `Strategy` maps logical axes to prioritized
lists of mesh-axis tuples; `Strategy.spec_for` picks, per tensor, the
first candidate that divides the dim and whose mesh axes are still
unused in that tensor (JAX's resolver, copied rule for rule).  It reads
a mesh by duck typing: a torch `DeviceMesh` (`mesh_dim_names`, `shape`)
or anything with JAX's `axis_names` and `devices.shape`.

A `PartitionSpec` becomes DTensor placements (`placements_for`): a dim
sharded over ("pod", "data") is `Shard(d)` on both mesh dims, the major
axis first, so each rank holds the block that JAX's
`NamedSharding.devices_indices_map` gives the device at the same mesh
coordinates.  The resolver only shards a dim its mesh axes divide, so
every block is even.

The sharder `make_sharder(mesh, strategy)` returns `sh(x, axes)`: x
redistributed to the resolved placements, the counterpart of
`with_sharding_constraint` (autograd carries it), the identity on a
plain tensor.  `redistribute` is the port's own: each step is a local
slice, an all-gather, a reduce-scatter or an all-reduce of the local
blocks by torch.distributed's collectives (`dist.all_gather_into_tensor`
and the like), each an autograd function whose backward is its
transpose, the blocks rewrapped as DTensors.  DTensor's own
`redistribute` runs the functional collectives, and on CUDA tensors
over gloo (several ranks sharing one card) torch 2.11's functional
all-gather crashes the process (a segmentation fault; its all-reduce
and reduce-scatter run).  The model's layouts are chosen so that no
DTensor op needs to move its inputs, forward or backward (what DTensor
would then move, it would move with its functional collectives).

The three Megatron helpers (`make_tp_projector`, `make_tp_col_projector`,
`make_tp_gather`) run on each rank's local blocks (`to_local()`, as
`shard_map` does) with autograd all-gather and reduce-scatter functions
over the TP group, and keep JAX's preconditions line for line; where
they fail a helper returns None and the caller
(`models.layers.row_project` / `col_project`) takes JAX's fallback, the
sharder's einsum and layout.  Their shard_map transpose
rules are JAX's: the cotangent of an input replicated over a mesh axis
is summed over it (the local block's gradient is `Partial`), and the
cotangent of an output replicated over a mesh axis is divided by its
size.  `COUNTS[helper]` counts how often each took its collective path
and how often its fallback; `reset_counts()` zeroes them.

Every collective the port issues itself (`_gather0`, `_scatter0`, the
all-reduce, and the all-reduces of the decode's combine,
`kernels.ops.lse_combine`) can be recorded: under `record_collectives()`
each call appends a `CollectiveRecord` (kind, the full buffer's bytes,
the group's size) to the list the context manager yields.
`roofline.analysis.collective_bytes` prices the records in the ring
model; nothing parses a program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

Axes = Tuple[str, ...]
Candidate = Tuple[str, ...]          # tuple of mesh axis names

HELPERS = ("row", "col", "gather")
COUNTS: Dict[str, Dict[str, int]] = {
    h: {"collective": 0, "fallback": 0} for h in HELPERS}


def reset_counts() -> None:
    for c in COUNTS.values():
        c["collective"] = c["fallback"] = 0


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective a rank issued: its kind ("all-gather",
    "reduce-scatter", "all-reduce"), the bytes of its full buffer (an
    all-gather's output, a reduce-scatter's input, an all-reduce's
    tensor) and the size of its group."""
    kind: str
    payload_bytes: int
    group_size: int


_RECORDS: List[List[CollectiveRecord]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveRecord]]:
    """Records every collective the port issues inside the block into
    the list it yields (nested blocks each get their own copy)."""
    rec: List[CollectiveRecord] = []
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def note_collective(kind: str, t: torch.Tensor, group_size: int) -> None:
    """Appends one record of `kind` over the full buffer `t` to every
    open `record_collectives` block."""
    if _RECORDS:
        r = CollectiveRecord(kind, t.numel() * t.element_size(), group_size)
        for rec in _RECORDS:
            rec.append(r)


class PartitionSpec(tuple):
    """A tuple of per-dim parts (None, a mesh axis name, or a tuple of
    them), trailing Nones dropped; equal to JAX's PartitionSpec with the
    same parts."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# --------------------------------------------------------------------- #
# Meshes, read by duck typing

def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Priority-ordered rules: logical axis -> candidate mesh-axis tuples.

    `priority` orders *which logical axes get first pick* of mesh axes
    when several dims of one tensor compete (e.g. kv_heads before seq_kv
    so head sharding wins when divisible).
    """
    rules: Dict[str, List[Candidate]]
    priority: List[str]
    name: str = ""

    def spec_for(self, axes: Axes, shape: Sequence[int],
                 mesh) -> PartitionSpec:
        sizes = axis_sizes(mesh)
        assign: Dict[int, Candidate] = {}
        used: set = set()
        order = [a for a in self.priority if a in axes] + \
                [a for a in axes if a not in self.priority]
        for logical in order:
            if logical not in self.rules:
                continue
            # find the dim index (first unassigned occurrence)
            dim = None
            for i, a in enumerate(axes):
                if a == logical and i not in assign:
                    dim = i
                    break
            if dim is None:
                continue
            for cand in self.rules[logical]:
                if any(c in used for c in cand):
                    continue
                total = math.prod(sizes[c] for c in cand)
                if shape[dim] % total == 0 and total > 1:
                    assign[dim] = cand
                    used.update(cand)
                    break
        parts = []
        for i in range(len(axes)):
            if i in assign:
                cand = assign[i]
                parts.append(cand[0] if len(cand) == 1 else cand)
            else:
                parts.append(None)
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    def placements_for(self, axes: Axes, shape: Sequence[int], mesh):
        return placements_for(self.spec_for(axes, shape, mesh), mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, axes_tree, *trees):
    """fn(axes, *leaves) over a tree of logical-axes tuples and trees of
    the same structure (nested dicts)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
            for k in axes_tree}


def tree_shardings(axes_tree, specs_tree, mesh, strategy: Strategy):
    """A tree of logical-axes tuples + shaped leaves (tensors, meta
    tensors) -> the tree of their DTensor placements on `mesh`."""
    return map_axes(lambda ax, spec: strategy.placements_for(
        ax, spec.shape, mesh), axes_tree, specs_tree)


# --------------------------------------------------------------------- #
# PartitionSpec -> DTensor placements, and moving between layouts

def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """One placement per mesh dim: Shard(d) where dim d of the spec names
    that mesh axis, else Replicate.  A dim over several mesh axes names
    them major first, which must be the mesh's own order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec part {part} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# --------------------------------------------------------------------- #
# The collectives on local blocks, as autograd functions

def _to0(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    note_collective("all-gather", out, n)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    note_collective("reduce-scatter", x, n)
    return out


def _gather_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along dim."""
    return _gather0(_to0(x, dim), group).movedim(0, dim).contiguous()


def _scatter_blocks(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum, this rank's block of it along dim."""
    return _scatter0(_to0(x, dim), group).movedim(0, dim).contiguous()


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


class _Gather(torch.autograd.Function):
    """Shard -> Replicate: all-gather; the backward keeps this rank's
    block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _Slice(torch.autograd.Function):
    """Replicate -> Shard: this rank's block; the backward all-gathers the
    blocks' gradients (the replicated input's whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.dim, ctx.group), None, None


class _GatherSum(torch.autograd.Function):
    """shard_map's all_gather: the backward reduce-scatters (each rank's
    cotangent of the gathered tensor is its own contribution)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_blocks(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial -> Shard, and shard_map's psum_scatter: reduce-scatter; the
    backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_blocks(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.dim, ctx.group), None, None


def all_reduce_sum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The group's elementwise sum (or `op`, a `dist.ReduceOp`) of x, a
    new tensor; recorded."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    note_collective("all-reduce", out, dist.get_world_size(group))
    return out


class _AllReduce(torch.autograd.Function):
    """Partial -> Replicate: all-reduce; each partial block's gradient is
    the replicated gradient itself."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromLocal(torch.autograd.Function):
    """Local blocks as a DTensor in `placements`.  DTensor's own
    `from_local` brings a gradient that arrives in another layout back
    with the functional collectives; this one with `redistribute`.  A
    Partial placement (each rank's block a summand) takes the replicated
    gradient: the sum's gradient is every summand's."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p
                               for p in placements)
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.placements).to_local(), None, None


# the functions' entry points (module-level names, called bare)
_from_local = _FromLocal.apply
from_local = _from_local        # local blocks as a DTensor, under autograd
_gather = _Gather.apply
_slice = _Slice.apply
_gather_sum = _GatherSum.apply
_reduce_scatter_fn = _ReduceScatter.apply
_all_reduce = _AllReduce.apply


def _check_movable(x, placements) -> None:
    """Raises ValueError where `redistribute` cannot move x from or to
    `placements`: a strided shard (a reshape that merged a sharded dim),
    a Partial that is neither a sum nor a mean, or a dim its mesh dims
    do not divide (every rank's block is taken to be the same size)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    for pl in (tuple(x.placements), tuple(placements)):
        for p in pl:
            if type(p) not in (Shard, Replicate) and not (
                    isinstance(p, Partial) and p.reduce_op in ("sum", "avg")):
                raise ValueError(
                    f"redistribute: cannot move {p} of a tensor of shape "
                    f"{tuple(x.shape)} in {tuple(x.placements)} to "
                    f"{tuple(placements)}")
        for d in range(x.ndim):
            n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                          if p == Shard(d))
            if x.shape[d] % n:
                raise ValueError(
                    f"redistribute: Shard({d}) in {pl} over {n} ranks does "
                    f"not divide dim {d} of the global shape "
                    f"{tuple(x.shape)}")


def redistribute(x, placements):
    """x (a DTensor) in `placements` (Shard, Replicate; Partial, a sum or
    a mean, only as a source) on its mesh, by the collectives above on
    its local block.  The tensor dims whose set of sharding mesh dims
    changes are gathered first, innermost mesh dim first (a shard may
    only gain inner mesh dims in place); then, mesh dims in order, a
    Partial is all-reduced or reduce-scattered (a mean's sum divided by
    the group's size) and a replicated dim sliced.  A strided or
    uneven layout, at either end of a move, raises ValueError before any
    collective (`_check_movable`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    target = tuple(placements)
    cur = list(x.placements)
    if tuple(cur) == target:
        return x
    _check_movable(x, target)
    mesh = x.device_mesh
    grad_pl = tuple(Replicate() if isinstance(p, Partial) else p
                    for p in cur)
    local = x.to_local(grad_placements=grad_pl)
    for d in range(x.ndim):
        have = [i for i, p in enumerate(cur) if p == Shard(d)]
        want = [i for i, p in enumerate(target) if p == Shard(d)]
        if not have or have == want:
            continue
        added = [i for i in want if i not in have]
        if set(have) <= set(want) and min(added) > max(have):
            continue                    # only inner mesh dims added
        for i in reversed(have):
            local = _gather(local, d, mesh.get_group(i))
            cur[i] = Replicate()
    for i, t in enumerate(target):
        c, group = cur[i], mesh.get_group(i)
        if c == t:
            continue
        if isinstance(c, Partial):
            local = (_all_reduce(local, group) if isinstance(
                t, Replicate) else _reduce_scatter_fn(local, t.dim, group))
            if c.reduce_op == "avg":        # DTensor's mean over a shard
                local = local / mesh.size(i)
        elif isinstance(t, Shard):
            local = _slice(local, t.dim, group)
        else:
            raise ValueError(f"redistribute: {c} -> {t}")
        cur[i] = t
    return _from_local(local, mesh, target)


def full_replicate(x):
    """x (a DTensor) replicated over its whole mesh (a plain tensor
    passes)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return redistribute(x, (Replicate(),) * x.device_mesh.ndim)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """x whole on every rank of its mesh, as a plain tensor (a plain
    tensor passes)."""
    return full_replicate(x).to_local() if is_dtensor(x) else x


def local_block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a full tensor under `placements` (Shard and
    Replicate), with no communication: the slice DTensor's own sharding
    gives, mesh dims in order."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    t = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return t.contiguous()


def distribute(full: torch.Tensor, mesh, placements):
    """A DTensor from a full tensor every rank holds alike (same seed,
    same file), each rank keeping its own block: no communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_block(full, mesh, placements), mesh,
                              tuple(placements), run_check=False)


# --------------------------------------------------------------------- #
# The serving steps' reads and writes on local blocks

def shard_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block index along a tensor dim sharded over the mesh
    dims `dims` (in mesh order): its coordinates over them, row-major."""
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def rows_placements(x) -> tuple:
    """x's (a DTensor's) placements with only its row (dim 0) shards
    kept: the layout of a (B,) or (B, ...) tensor that goes with x's
    rows."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def wrap(local: torch.Tensor, mesh, placements):
    """A local block as a DTensor in `placements`, no check and no
    collective (the block is the rank's own by construction)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False)


def embed_rows(table, tokens):
    """`F.embedding(tokens, table)` for a DTensor table (V, D) and DTensor
    tokens (B, ...), without gathering the table: each rank looks its
    tokens up in its own block of rows (zeros for a token outside it), and
    the blocks' rows are summed over the mesh dims that split the
    vocabulary, one all-reduce each (exact: one nonzero a token).  A
    table sharded along D is first gathered along it; tokens sharded over
    a vocabulary dim are gathered over it.  The rows come back in the
    tokens' layout, replicated over the table's vocabulary dims."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    table = redistribute(table, tuple(p if p == Shard(0) else Replicate()
                                      for p in table.placements))
    vdims = [d for d, p in enumerate(table.placements) if p == Shard(0)]
    tokens = redistribute(tokens, tuple(
        Replicate() if d in vdims else p
        for d, p in enumerate(tokens.placements)))
    block = table.to_local()
    n = block.shape[0]
    rows = tokens.to_local().long() - shard_index(mesh, vdims) * n
    hit = (rows >= 0) & (rows < n)
    out = F.embedding(rows.clamp(0, n - 1), block)
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    for d in vdims:
        out = all_reduce_sum(out, mesh.get_group(d))
    return wrap(out, mesh, tokens.placements)


def pick_rows(h, pos):
    """h[b, pos[b]] for a DTensor h (B, S, D) and pos (B,) (a DTensor or a
    full tensor alike on every rank): each rank takes the rows its block
    of positions holds (zeros for the others), summed over the mesh dims
    that split S, one all-reduce each (exact).  Returns (B, D) in h's
    layout along B and D."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    row_pl = rows_placements(h)
    if is_dtensor(pos):
        pos = redistribute(pos, row_pl).to_local()
    else:
        pos = local_block(pos, mesh, row_pl)
    sdims = [d for d, p in enumerate(h.placements) if p == Shard(1)]
    block = h.to_local()
    n = block.shape[1]
    loc = pos.long() - shard_index(mesh, sdims) * n
    hit = (loc >= 0) & (loc < n)
    out = block[torch.arange(block.shape[0], device=block.device),
                loc.clamp(0, n - 1)]
    out = torch.where(hit[:, None], out, torch.zeros_like(out))
    for d in sdims:
        out = all_reduce_sum(out, mesh.get_group(d))
    pl = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
               else Replicate() for p in h.placements)
    return wrap(out, mesh, pl)


def einsum_blocks(eq: str, a, b):
    """torch.einsum(eq, a, b) on the local blocks of DTensors a and b
    whose layouts need no input moved: every mesh dim shards at most one
    index.  An operand that carries that index but is replicated over
    the mesh dim takes its own slice of it, locally (`_slice`: its
    backward all-gathers the slice's gradient).  A kept index lays the
    result out by it; a contracted one gives a Partial result (each
    rank's product sums its slice of the index), which the caller lays
    out (the sharder reduce-scatters or all-reduces it).  Anything else
    (two indices on one mesh dim, an index sharded over several mesh
    dims that an operand must slice, a Partial or strided operand, a
    plain tensor) is DTensor's own einsum.

    Under autograd an operand's block gradient is Partial over the mesh
    dims that shard the result by an index the operand lacks (each rank
    saw its own rows), and otherwise in the operand's layout.  The
    serving steps' and the train step's sharders use it
    (`launch.steps.serve_hooks`, `make_train_step`): DTensor plans an
    einsum whose reshapes merge a sharded dim into a strided layout by a
    graph search that takes minutes on a 3-D mesh, moves inputs with
    the functional collectives, and may lay a dim out unevenly."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not (is_dtensor(a) and is_dtensor(b)):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    idx = ins.split(",")
    xs = (a, b)
    mesh = a.device_mesh
    for x in xs:
        if any(type(p) not in (Shard, Replicate) for p in x.placements):
            return torch.einsum(eq, a, b)
    pl, cuts = [], ([], [])     # cuts[k]: (mesh dim, index) k slices
    by = {}                     # index -> the mesh dims that shard it
    for i in range(mesh.ndim):
        letters = {ix[x.placements[i].dim] for ix, x in zip(idx, xs)
                   if type(x.placements[i]) is Shard}
        if not letters:
            pl.append(Replicate())
            continue
        if len(letters) > 1:
            return torch.einsum(eq, a, b)
        letter = letters.pop()
        by.setdefault(letter, []).append(i)
        for k, (ix, x) in enumerate(zip(idx, xs)):
            if letter in ix and type(x.placements[i]) is not Shard:
                cuts[k].append((i, letter))
        pl.append(Shard(out.index(letter)) if letter in out else Partial())
    if any(len(by[letter]) > 1 for c in cuts for _, letter in c):
        return torch.einsum(eq, a, b)
    locs = []
    for k, (ix, x) in enumerate(zip(idx, xs)):
        grad_pl = tuple(
            p if type(p) is Shard else
            Partial() if type(q) is Shard and out[q.dim] not in ix else
            Replicate() for p, q in zip(x.placements, pl))
        loc = x.to_local(grad_placements=grad_pl)
        for i, letter in cuts[k]:
            loc = _slice(loc, ix.index(letter), mesh.get_group(i))
        locs.append(loc)
    return _from_local(torch.einsum(eq, *locs), mesh, tuple(pl))


def cat_blocks(parts: Sequence[torch.Tensor], dim: int):
    """torch.cat(parts, dim) for DTensors, on the local blocks: each part
    is laid out (by `redistribute`) as the last with `dim` whole, so the
    blocks join in place; the result keeps that layout.  DTensor's own
    cat would gather a sharded `dim` with its functional all-gather.
    Plain tensors are torch.cat."""
    from torch.distributed.tensor import Replicate, Shard
    last = parts[-1]
    if not is_dtensor(last):
        return torch.cat(parts, dim)
    pl = tuple(Replicate() if p == Shard(dim) else p
               for p in last.placements)
    return _from_local(torch.cat([redistribute(p, pl).to_local()
                                  for p in parts], dim),
                       last.device_mesh, pl)


def mean_blocks(x, dims: Sequence[int]):
    """x.mean(dims) for a DTensor x, on its local blocks: each rank sums
    its block over `dims`, the sums are added over the mesh dims that
    shard them (`redistribute`'s all-reduce) and divided by the count.
    The result keeps x's other dims' layout.  DTensor's own mean leaves a
    Partial(avg), which it reduces with the functional collectives (an
    average gloo does not take).  A plain tensor is x.mean(dims)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not is_dtensor(x):
        return x.mean(dim=tuple(dims))
    dims = sorted(d % x.ndim for d in dims)
    part, whole = [], []
    for p in x.placements:
        if type(p) is Shard and p.dim in dims:
            part.append(Partial())
            whole.append(Replicate())
        else:
            if type(p) is Shard:
                p = Shard(p.dim - sum(d < p.dim for d in dims))
            part.append(p)
            whole.append(p)
    total = _from_local(x.to_local().sum(dim=tuple(dims)), x.device_mesh,
                        tuple(part))
    return redistribute(total, tuple(whole)) / math.prod(x.shape[d]
                                                         for d in dims)


def clear_clashes(eq: str, a, b):
    """a (a DTensor) gathered over every mesh dim on which a and b shard
    different indices of `eq`, so that `einsum_blocks(eq, a, b)` runs on
    the local blocks: b, a weight in its compute layout, keeps its
    layout, and the activation moves (by `redistribute`).  A plain
    tensor passes."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_dtensor(a) and is_dtensor(b)):
        return a
    ia, ib = eq.replace(" ", "").split("->")[0].split(",")
    pl = tuple(Replicate() if type(pa) is Shard and type(pb) is Shard
               and ia[pa.dim] != ib[pb.dim] else pa
               for pa, pb in zip(a.placements, b.placements))
    return redistribute(a, pl)


def select_blocks(x, dim: int, index: int):
    """x.select(dim, index) for a DTensor x that no mesh dim shards along
    `dim`, on its local block (no DTensor op: the gradient returns by
    `redistribute`); a plain tensor is selected as it is."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return x.select(dim, index)
    if any(p == Shard(dim) for p in x.placements):
        raise ValueError(f"select_blocks: dim {dim} is sharded in "
                         f"{tuple(x.placements)}")
    pl = tuple(Shard(p.dim - 1) if type(p) is Shard and p.dim > dim else p
               for p in x.placements)
    return _from_local(x.to_local().select(dim, index), x.device_mesh, pl)


def store_block(leaf, i: int, value) -> None:
    """leaf[i] = value for a stacked leaf (L, ...), in place.  A DTensor
    leaf, not sharded along L, is written on its local block: value (a
    DTensor) is laid out as leaf[i] first."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(leaf):
        leaf[i] = value
        return
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in leaf.placements)
    leaf.to_local()[i].copy_(redistribute(value, pl).to_local())


def _identity_sh(x, axes):
    return x


def make_sharder(mesh, strategy: Optional[Strategy]):
    """Returns sh(x, logical_axes): x redistributed to the layout the
    strategy resolves (identity on a plain tensor, or with no mesh)."""
    if mesh is None or strategy is None:
        return _identity_sh

    def sh(x, axes):
        if not is_dtensor(x):
            return x
        return redistribute(x, strategy.placements_for(
            tuple(axes), x.shape, mesh))
    return sh


def make_weight_sharder(mesh, strategy: Optional[Strategy]):
    """Returns shw(param_tree, axes_tree) moving weights to their
    *compute* layout inside the step.

    The explicit-FSDP-gather: weights are STORED sharded over the DP axis
    (`launch.steps.state_shardings`) and moved at use to a DP-replicated,
    TP-sharded layout (all-gather per layer), so the activations keep
    their own layout.
    """
    if mesh is None or strategy is None:
        return None

    def shw(tree, axes_tree):
        def f(ax, x):
            if not is_dtensor(x):
                return x
            return redistribute(x, strategy.placements_for(
                tuple(ax), x.shape, mesh))
        return map_axes(f, axes_tree, tree)
    return shw


# --------------------------------------------------------------------- #
# The Megatron helpers on local blocks

def _parts(spec: PartitionSpec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _einsum_shape(eq: str, a_shape, b_shape) -> Tuple[int, ...]:
    ins, out = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    size = dict(zip(ia, a_shape))
    size.update(zip(ib, b_shape))
    return tuple(size[c] for c in out)


def _enter(x, spec: PartitionSpec, mesh) -> torch.Tensor:
    """shard_map's entry: x in `spec`'s layout, as its local block.  The
    block's gradient is Partial over the mesh axes the spec leaves out
    (JAX sums an input's cotangent over them)."""
    from torch.distributed.tensor import Partial, Replicate
    pl = placements_for(spec, mesh)
    x = redistribute(x, pl)
    grad_pl = tuple(Partial() if isinstance(p, Replicate) else p
                    for p in pl)
    return x.to_local(grad_placements=grad_pl)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


_scale_grad = _ScaleGrad.apply


def _leave(local: torch.Tensor, spec: PartitionSpec, mesh):
    """shard_map's exit: the local blocks as a DTensor in `spec`'s layout.
    The cotangent is divided by the size of the mesh axes the spec
    leaves out (JAX's transpose of an unmapped output)."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = placements_for(spec, mesh)
    n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                  if isinstance(p, Replicate))
    if n > 1:
        local = _scale_grad(local, 1.0 / n)
    return _from_local(local, mesh, pl)


def local_map(fn, *args, mapped: Sequence[bool], dims: Sequence[int] = (0,)):
    """fn on each rank's local blocks, for a function that is independent
    along `dims` (a batch dim, a heads dim): the `mapped` args share one
    layout, sharded only along `dims` (each mesh dim keeps a Shard(d),
    d in dims, on which all of them agree, and is replicated otherwise),
    the other args are replicated.  The outputs (tensors, or tuples of
    them) carry the mapped layout.  A replicated arg's gradient is summed
    over the mesh dims the mapped layout shards (each rank saw its own
    blocks).  Plain tensors pass through: with no DTensor among the args
    this is fn(*args)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = [a for a, m in zip(args, mapped) if m and is_dtensor(a)]
    if not lead:
        return fn(*args)
    mesh = lead[0].device_mesh
    pl = []
    for i in range(mesh.ndim):
        p = lead[0].placements[i]
        keep = isinstance(p, Shard) and p.dim in dims and all(
            a.placements[i] == p for a in lead)
        pl.append(p if keep else Replicate())
    pl = tuple(pl)
    grad_pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in pl)
    local = []
    for a, m in zip(args, mapped):
        if not is_dtensor(a):
            local.append(a)
        elif m:
            local.append(redistribute(a, pl).to_local())
        else:
            # a new node in the replicated layout: its block's Partial
            # gradient is summed there (by `redistribute`), even where the
            # move to it was none, and never leaves as a Partial
            a = redistribute(a, (Replicate(),) * mesh.ndim)
            a = _from_local(a.to_local(), mesh, a.placements)
            local.append(a.to_local(grad_placements=grad_pl))

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return _from_local(o, mesh, pl)
        if isinstance(o, tuple):
            vals = [wrap(v) for v in o]
            return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
        return o
    return wrap(fn(*local))


def rows_map(fn, weights, *xs):
    """fn(*xs, weights) on each rank's rows of the xs (`local_map` over
    dim 0), with `weights` (a nested dict of tensors) whole on every
    rank: a block whose products would clash with the rows' layout runs
    as on one device, every move the port's own.  Each weight's gradient
    is summed over the mesh dims that split the rows.  With plain
    tensors this is fn(*xs, weights)."""
    from repro_torch.training.tree import leaves, unflatten
    ws, n = leaves(weights), len(xs)
    return local_map(lambda *a: fn(*a[:n], unflatten(weights, a[n:])),
                     *xs, *ws, mapped=(True,) * n + (False,) * len(ws))


def make_tp_projector(mesh, act_strategy: Optional[Strategy],
                      w_strategy: Optional[Strategy]):
    """Explicit row-parallel (Megatron) out-projection: the einsum on the
    local blocks, then a reduce-scatter over the TP group (backward: an
    all-gather), where an all-reduce would move twice the bytes.
    Returns None whenever the preconditions don't hold (contraction not
    sharded over exactly the TP axis, scatter dim not divisible, decode
    S=1, ...): the caller (`models.layers.row_project`) then falls back
    to the sharder's einsum + layout constraint.

    Returns project(x, w, eq, x_axes, w_axes, out_axes, scatter_axis).
    """
    if mesh is None or act_strategy is None or w_strategy is None:
        return None
    tp = _tp(mesh)[0]
    tp_size = axis_sizes(mesh)[tp]

    def project(x, w, eq, x_axes, w_axes, out_axes, scatter_axis):
        out_shape = _einsum_shape(eq, x.shape, w.shape)
        x_spec = act_strategy.spec_for(tuple(x_axes), x.shape, mesh)
        w_spec = w_strategy.spec_for(tuple(w_axes), w.shape, mesh)
        # precondition: w's first (contracted) dim sharded over tp alone,
        # x's matching dim likewise, scatter dim divisible
        x_parts = _parts(x_spec, len(x.shape))
        w_parts = _parts(w_spec, len(w.shape))
        ok = (tp in w_parts and
              out_shape[scatter_axis] % tp_size == 0 and
              x_parts.count(tp) == 1 and w_parts.count(tp) == 1)
        if not ok:
            COUNTS["row"]["fallback"] += 1
            return None
        COUNTS["row"]["collective"] += 1
        out_parts = [None] * len(out_shape)
        out_parts[scatter_axis] = tp
        # keep x's non-tp sharding (e.g. batch over dp) in the out spec
        for i, p in enumerate(x_parts[:len(out_parts)]):
            if p is not None and p != tp and i != scatter_axis:
                out_parts[i] = p
        o = torch.einsum(eq, _enter(x, x_spec, mesh),
                         _enter(w, w_spec, mesh))
        o = _reduce_scatter_fn(o, scatter_axis, mesh.get_group(tp))
        return _leave(o, P(*out_parts), mesh)

    return project


def make_tp_col_projector(mesh, act_strategy: Optional[Strategy],
                          w_strategy: Optional[Strategy]):
    """Column-parallel (Megatron f-operator) projection with the einsum
    on the local blocks: fwd = all_gather(x_seq) -> local einsum; bwd =
    one reduce-scatter.  Only used when the OUTPUT carries the tp axis
    (q heads / mlp F); returns None otherwise, and the caller
    (`models.layers.col_project`) falls back to the sharder's einsum +
    layout constraint.
    """
    if mesh is None or act_strategy is None or w_strategy is None:
        return None
    tp = _tp(mesh)[0]

    def project(x, w, eq, x_axes, w_axes, out_axes, gather_axis=1):
        out_shape = _einsum_shape(eq, x.shape, w.shape)
        x_spec = act_strategy.spec_for(tuple(x_axes), x.shape, mesh)
        w_spec = w_strategy.spec_for(tuple(w_axes), w.shape, mesh)
        out_spec = act_strategy.spec_for(tuple(out_axes), out_shape, mesh)
        x_parts = _parts(x_spec, len(x.shape))
        w_parts = _parts(w_spec, len(w.shape))
        out_parts = _parts(out_spec, len(out_shape))
        ok = (len(x_parts) > gather_axis and
              x_parts[gather_axis] == tp and
              x_parts.count(tp) == 1 and
              tp in out_parts and tp in w_parts)
        if not ok:
            COUNTS["col"]["fallback"] += 1
            return None
        COUNTS["col"]["collective"] += 1
        x_full = _gather_sum(_enter(x, x_spec, mesh), gather_axis,
                             mesh.get_group(tp))
        o = torch.einsum(eq, x_full, _enter(w, w_spec, mesh))
        return _leave(o, out_spec, mesh)

    return project


def make_tp_gather(mesh, act_strategy: Optional[Strategy]):
    """Megatron-SP f-operator: gather the TP(seq)-sharded residual once
    per block, an all-gather whose backward is a reduce-scatter.

    Returns gather(x, x_axes, gather_axis=1) -> x with that dim whole.
    """
    if mesh is None or act_strategy is None:
        return None
    tp = _tp(mesh)[0]

    def gather(x, x_axes, gather_axis: int = 1):
        x_spec = act_strategy.spec_for(tuple(x_axes), x.shape, mesh)
        x_parts = _parts(x_spec, len(x.shape))
        if len(x_parts) <= gather_axis or x_parts[gather_axis] != tp:
            COUNTS["gather"]["fallback"] += 1
            return x        # already whole on this dim
        COUNTS["gather"]["collective"] += 1
        out_parts = list(x_parts)
        out_parts[gather_axis] = None
        while out_parts and out_parts[-1] is None:
            out_parts.pop()
        o = _gather_sum(_enter(x, x_spec, mesh), gather_axis,
                        mesh.get_group(tp))
        return _leave(o, P(*out_parts), mesh)

    return gather


def train_compute_strategy(mesh) -> Strategy:
    """Weight layout at *use* time during training: TP dims sharded, the
    FSDP (embed) dim gathered."""
    tp = _tp(mesh)
    rules = {
        "mlp": [tp], "heads": [tp], "kv_heads": [tp], "inner": [tp],
        "vocab": [tp], "experts": [tp],
    }
    return Strategy(rules=rules,
                    priority=["mlp", "heads", "kv_heads", "inner",
                              "vocab", "experts"],
                    name="train_compute")


# --------------------------------------------------------------------- #
# Strategy presets.  DP = data(-parallel) meta axis; TP = model axis.

def _dp(mesh) -> Candidate:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _tp(mesh) -> Candidate:
    return ("model",)


def train_strategy(mesh, name: str = "fsdp_tp") -> Strategy:
    """FSDP over DP + tensor-parallel over TP + sequence-parallel residual.

    Params: embed dim FSDP-sharded over DP; mlp/heads/vocab over TP.
    Activations: batch over DP, seq over TP (Megatron-SP style residual).
    """
    dp, tp = _dp(mesh), _tp(mesh)
    rules = {
        # params
        "embed": [dp],
        "mlp": [tp],
        "heads": [tp],
        "kv_heads": [tp],
        "inner": [tp],
        "vocab": [tp],
        "experts": [tp],        # EP when divisible, else falls through
        # activations
        "batch": [dp],
        "seq": [tp],
        "embed_rs": [tp],       # MoE down-proj reduce-scatter target
    }
    return Strategy(rules=rules,
                    priority=["batch", "embed", "mlp", "heads", "kv_heads",
                              "inner", "vocab", "experts", "embed_rs",
                              "seq"],
                    name=name)


def train_strategy_fsdp(mesh) -> Strategy:
    """Pure FSDP: batch over DP+TP flattened; params fully sharded over the
    flattened mesh on their largest logical dim.  Best for small models
    where TP would be latency-bound."""
    dp, tp = _dp(mesh), _tp(mesh)
    all_ = dp + tp
    rules = {
        "embed": [all_, dp, tp],
        "mlp": [all_, tp, dp],
        "vocab": [all_, tp, dp],
        "heads": [tp],
        "kv_heads": [tp],
        "inner": [all_, tp, dp],
        "experts": [tp],
        "batch": [all_, dp],
        "seq": [tp],
        "embed_rs": [tp, dp],   # MoE down-proj reduce-scatter target
    }
    return Strategy(rules=rules,
                    priority=["batch", "mlp", "vocab", "embed", "inner",
                              "heads", "kv_heads", "experts", "embed_rs",
                              "seq"],
                    name="fsdp")


def serve_strategy(mesh, name: str = "serve") -> Strategy:
    """Serving: params TP-only (no per-step gathers); batch over DP;
    KV heads over TP when divisible, else KV sequence; long-context batch=1
    spreads KV sequence over every axis."""
    dp, tp = _dp(mesh), _tp(mesh)
    all_ = dp + tp
    rules = {
        # weights TP-only: no per-step gathers on the serving path (the
        # embed/contraction dim stays replicated across DP)
        "mlp": [tp],
        "heads": [tp],
        "kv_heads": [tp],
        "inner": [tp],
        "vocab": [tp],
        "experts": [tp],
        "batch": [dp],
        "seq": [tp],
        "seq_kv": [tp, dp, all_],
    }
    return Strategy(rules=rules,
                    priority=["batch", "kv_heads", "seq_kv", "heads", "mlp",
                              "inner", "vocab", "experts", "seq"],
                    name=name)


STRATEGIES = {
    "fsdp_tp": train_strategy,
    "fsdp": train_strategy_fsdp,
    "serve": serve_strategy,
}


def pick_strategy(kind: str, mesh, arch_params: int,
                  override: str = "") -> Strategy:
    """Default policy: big models train with fsdp_tp (SP residual keeps
    activations bounded); small models (<8B) train pure-FSDP; serving is
    always TP-centric."""
    if override:
        return STRATEGIES[override](mesh)
    if kind == "train":
        if arch_params >= 8e9:
            return train_strategy(mesh)
        return train_strategy_fsdp(mesh)
    return serve_strategy(mesh)
