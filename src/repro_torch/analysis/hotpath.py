"""Host-sync-in-hot-path checker.

The counterpart of `repro.analysis.hotpath` over the port.  The engine's
perf contract is "at most two dispatches and one host sync per step";
the engine can only count the syncs it chooses to count (`host_syncs`),
so this checker pins the *sites*: every expression reachable from the
engine step entry point (``InferenceEngine.step``, as in JAX) over the
name-based call graph that makes the host wait on the card.

The patterns are PyTorch's where the reference's were JAX's:

* device->host reads: ``.cpu()``, ``.numpy()`` (but on a ``.cpu()``,
  which is the read), ``.item()``, ``.tolist()``, ``.to("cpu")`` /
  ``.to(device="cpu")``;
* blocking waits: ``torch.cuda.synchronize()`` and
  ``<stream or event>.synchronize()``;
* ops whose output shape depends on the data, which block in PyTorch
  (under ``jit`` they could not occur at all): ``nonzero``,
  ``torch.unique``, ``masked_select``, one-argument ``torch.where`` and
  ``repeat_interleave`` with tensor repeats and no ``output_size``;
* as in JAX, ``np.asarray`` / ``np.array`` and ``float()`` / ``int()`` /
  ``bool()`` of a name or attribute.

Departures keep host-side values out of the findings, each decided
within one function: a value derived from a ``.numpy()`` result, a
numpy call or a Python container (``host = t.cpu().numpy(); toks =
host[0]``), or a parameter annotated as a container (and, for a
parameter typed as an analyzed class, that class's container fields:
``handle.host``), is on the host, so its ``.tolist()``, ``np.asarray``
or ``bool()`` reads nothing; and ``int()`` of a parameter annotated as a
Python scalar, or a ``repeat_interleave`` whose repeats is an int (a
constant, ``len()``, a ``.shape`` entry, a name bound to one), does not
sync.

Host->device uploads are a pattern of their own, ``upload``, and not a
violation: ``torch.tensor`` / ``torch.as_tensor`` with a ``device=``,
``.to(<device>)`` and ``.cuda()``.  `hot_path_sites` returns every
site of both kinds on the step's call graph, so a run on the card can
hold what the runtime synchronized on to what this checker claims.

Each sanctioned sync is waived individually in
`analysis_baseline_torch.json` (keyed by function + pattern +
occurrence), so adding a *second* ``.cpu()`` to `_decode_block`
surfaces as a new unwaived violation even if a workload happens not to
hit it.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Checker, FunctionInfo, ProjectIndex,
                                       Violation, call_name, call_receiver,
                                       dotted_parts)

# (class, method) roots of the fused decode/prefill paths
DEFAULT_ENTRIES: Tuple[Tuple[str, str], ...] = (
    ("InferenceEngine", "step"),
)

SYNC = "sync"
UPLOAD = "upload"

_NP_MODULES = {"np", "numpy", "onp"}
_HOST_BUILDERS = {"list", "tuple"}
_HOST_DISPLAYS = (ast.List, ast.Tuple, ast.Set, ast.Dict, ast.ListComp,
                  ast.SetComp, ast.DictComp)
_SCALAR_TYPES = {"int", "bool", "float"}
_CONTAINER_TYPES = {"list", "List", "tuple", "Tuple", "dict", "Dict",
                    "Sequence"}
_SHAPE_OPS = {"nonzero", "unique", "unique_consecutive", "masked_select"}


@dataclasses.dataclass(frozen=True)
class Site:
    """One sync or upload expression in a function on the step's path."""
    kind: str          # SYNC | UPLOAD
    pattern: str       # e.g. "cpu", "synchronize", "to"
    file: str
    symbol: str        # qualname of the enclosing indexed function
    line: int
    end_line: int
    text: str

    @property
    def uid(self) -> str:
        return f"{self.file}::{self.symbol}"


def _dotted(expr: ast.expr) -> Optional[str]:
    parts = dotted_parts(expr)
    return ".".join(parts) if parts else None


def _is_np_call(expr: ast.expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    recv = call_receiver(expr)
    return recv is not None and recv[0] in _NP_MODULES


def _host_valued(expr: ast.expr, host: Set[str]) -> bool:
    """True when `expr` is a host value: a Python container, a
    ``.numpy()`` result, a numpy call, or a chain of subscripts,
    attributes and method calls over one (or over a name or attribute
    already known to be one, `host`) that never moves it to the card
    (``.to()``, ``.cuda()``)."""
    node = expr
    while True:
        if isinstance(node, _HOST_DISPLAYS):
            return True
        if _dotted(node) in host:
            return True
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name == "numpy" or _is_np_call(node):
                return True
            if isinstance(node.func, ast.Name):
                return name in _HOST_BUILDERS
            if name in ("to", "cuda"):
                return False
            node = node.func.value
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.IfExp):
            return _host_valued(node.body, host) \
                and _host_valued(node.orelse, host)
        else:
            return False


def _scalar_valued(expr: ast.expr, scalars: Set[str]) -> bool:
    """True when `expr` is a Python scalar by construction: a constant,
    ``len()`` / ``int()``, a ``.shape`` entry or ``.size(d)``, arithmetic
    of those, or a name or attribute known to be one (`scalars`)."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, (int, float))
    if _dotted(expr) in scalars:
        return True
    if isinstance(expr, ast.BinOp):
        return _scalar_valued(expr.left, scalars) \
            and _scalar_valued(expr.right, scalars)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        return expr.func.id in ("len", "int")
    if isinstance(expr, ast.Call) and call_name(expr) == "size":
        return bool(expr.args)
    if isinstance(expr, ast.Subscript):
        parts = dotted_parts(expr.value)
        return parts is not None and parts[-1] == "shape"
    return False


def _bind(targets: Sequence[ast.expr], value: ast.expr, pred,
          unpack_shape: bool = False) -> Set[str]:
    """Names among `targets` bound to a value `pred` accepts: a tuple
    target against a tuple value element by element, and with
    `unpack_shape` every element of a tuple target against ``x.shape``."""
    out: Set[str] = set()
    for t in targets:
        if isinstance(t, ast.Name):
            if pred(value):
                out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(t.elts):
                for te, ve in zip(t.elts, value.elts):
                    out |= _bind([te], ve, pred, unpack_shape)
            elif unpack_shape and (dotted_parts(value) or ("",))[-1] \
                    == "shape":
                out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
    return out


def _type_kind(ann: Optional[ast.expr]) -> Optional[str]:
    """"scalar" / "host" for an annotation naming a Python scalar or
    container type, else None."""
    if isinstance(ann, ast.Subscript):         # List[int], Dict[str, T]
        ann = ann.value
    parts = dotted_parts(ann) if ann is not None else None
    if not parts:
        return None
    if parts[-1] in _SCALAR_TYPES:
        return "scalar"
    return "host" if parts[-1] in _CONTAINER_TYPES else None


def _local_kinds(fi: FunctionInfo,
                 index: Optional[ProjectIndex] = None
                 ) -> Tuple[Set[str], Set[str]]:
    """(host values, Python scalars) of one function, as names and
    dotted attributes: its parameters by annotation (a parameter typed
    as an analyzed class contributes that class's annotated fields,
    ``handle.host``), then every name assigned from such a value."""
    host: Set[str] = set()
    scalars: Set[str] = set()
    args = fi.node.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        kinds = [(a.arg, _type_kind(a.annotation))]
        ann = dotted_parts(a.annotation) if a.annotation else None
        cls = index.classes.get(ann[-1]) \
            if index is not None and ann else None
        if cls is not None:
            kinds += [(f"{a.arg}.{st.target.id}", _type_kind(st.annotation))
                      for st in cls.body if isinstance(st, ast.AnnAssign)
                      and isinstance(st.target, ast.Name)]
        for name, kind in kinds:
            (host if kind == "host" else scalars if kind == "scalar"
             else set()).add(name)
    assigns = [n for n in ast.walk(fi.node) if isinstance(n, ast.Assign)]
    changed = True
    while changed:
        changed = False
        for a in assigns:
            new_h = _bind(a.targets, a.value,
                          lambda v: _host_valued(v, host)) - host
            new_s = _bind(a.targets, a.value,
                          lambda v: _scalar_valued(v, scalars), True) \
                - scalars
            if new_h or new_s:
                host |= new_h
                scalars |= new_s
                changed = True
    return host, scalars


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_cpu(expr: Optional[ast.expr]) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and call_name(expr) == "device":
        return bool(expr.args) and _is_cpu(expr.args[0])
    return False


def _is_device(expr: Optional[ast.expr]) -> bool:
    """A device other than the CPU: a device string, ``torch.device``, or
    a name or attribute called ``dev`` / ``device`` / ``*_device``."""
    if expr is None or _is_cpu(expr):
        return False
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call) and call_name(expr) == "device":
        return True
    parts = dotted_parts(expr)
    return parts is not None and (parts[-1] in ("dev", "device")
                                  or parts[-1].endswith("_device"))


def _sync_pattern(call: ast.Call, host: Set[str] = frozenset(),
                  scalars: Set[str] = frozenset()) -> Optional[str]:
    """Pattern slug when `call` makes the host wait on the card."""
    name = call_name(call)
    if name is None:
        return None
    recv = call_receiver(call)
    fn = call.func
    on = fn.value if isinstance(fn, ast.Attribute) else None
    if recv is not None and recv[0] in _NP_MODULES:
        if name in ("asarray", "array") and call.args:
            # literals are host-side already; anything else may be a
            # device tensor
            arg = call.args[0]
            if isinstance(arg, ast.Constant) or _host_valued(arg, host):
                return None
            return f"np.{name}"
        return None                     # numpy's own ops run on the host
    if on is not None and _host_valued(on, host):
        return None                     # a method of a host array
    if name in ("cpu", "item", "tolist") and on is not None \
            and not call.args:
        return name
    if name == "numpy" and on is not None and not call.args:
        if isinstance(on, ast.Call) and _sync_pattern(on) in ("cpu",
                                                              "to_cpu"):
            return None                 # the .cpu() under it is the read
        return "numpy"
    if name == "to" and on is not None:
        target = call.args[0] if call.args else _kw(call, "device")
        if _is_cpu(target):
            return "to_cpu"
        return None
    if name == "synchronize" and on is not None:
        return "synchronize"
    if name in _SHAPE_OPS and on is not None:
        return "unique" if name.startswith("unique") else name
    if name == "where" and recv == ("torch",) and len(call.args) == 1 \
            and not call.keywords:
        return "where"
    if name == "repeat_interleave" and _kw(call, "output_size") is None:
        reps = _kw(call, "repeats")
        if reps is None and call.args:
            # torch.repeat_interleave(x, repeats) / (repeats); x.r_i(repeats)
            reps = call.args[1 if recv == ("torch",) and len(call.args) > 1
                             else 0]
        if reps is not None and not _scalar_valued(reps, scalars):
            return "repeat_interleave"
        return None
    if name in ("float", "int", "bool") and recv is None and call.args:
        # float(self.x) / int(done) force concretization when the value
        # is device-resident; float(len(..)) and literals don't
        arg = call.args[0]
        if isinstance(arg, (ast.Name, ast.Attribute)) \
                and not _host_valued(arg, host) \
                and not _scalar_valued(arg, scalars):
            return name
    return None


def _upload_pattern(call: ast.Call) -> Optional[str]:
    """Pattern slug when `call` moves host data onto the card."""
    name = call_name(call)
    recv = call_receiver(call)
    if name in ("tensor", "as_tensor") and recv == ("torch",) \
            and _is_device(_kw(call, "device")):
        return name
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if name == "cuda" and recv != ("torch",):
        return "cuda"
    if name == "to":
        target = call.args[0] if call.args else _kw(call, "device")
        if _is_device(target):
            return "to"
    return None


def function_sites(fi: FunctionInfo,
                   index: Optional[ProjectIndex] = None) -> List[Site]:
    """Every sync and upload expression in one function (nested defs and
    lambdas included, as the reference's walk includes them)."""
    host, scalars = _local_kinds(fi, index)
    out: List[Site] = []
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Call):
            continue
        pattern = _sync_pattern(node, host, scalars)
        kind = SYNC
        if pattern is None:
            pattern, kind = _upload_pattern(node), UPLOAD
        if pattern is None:
            continue
        out.append(Site(kind, pattern, fi.module.rel, fi.qualname,
                        node.lineno, node.end_lineno or node.lineno,
                        ast.unparse(node)))
    return out


def _reach(index: ProjectIndex,
           entries: Sequence[Tuple[str, str]]) -> Dict[str, FunctionInfo]:
    """Reachability over the name-based call graph from the entries."""
    roots: List[FunctionInfo] = []
    for cls, meth in entries:
        fi = index.by_class.get(cls, {}).get(meth)
        if fi is not None:
            roots.append(fi)
    reached: Dict[str, FunctionInfo] = {}
    work = list(roots)
    while work:
        fi = work.pop()
        if fi.uid in reached:
            continue
        reached[fi.uid] = fi
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                for target in index.resolve_call(node, fi.cls, fi.module):
                    if target.uid not in reached:
                        work.append(target)
    return reached


def hot_path_sites(index: ProjectIndex,
                   entries: Sequence[Tuple[str, str]] = DEFAULT_ENTRIES
                   ) -> List[Site]:
    """Every sync and upload site in the functions the entries reach."""
    out: List[Site] = []
    reached = _reach(index, entries)
    for uid in sorted(reached):
        out.extend(function_sites(reached[uid], index))
    return out


class HotPathSyncChecker(Checker):
    rule = "hot-path-sync"

    def __init__(self,
                 entries: Sequence[Tuple[str, str]] = DEFAULT_ENTRIES):
        self.entries = tuple(entries)

    def check(self, index: ProjectIndex) -> List[Violation]:
        out: List[Violation] = []
        counts: Dict[Tuple[str, str], int] = {}
        for s in hot_path_sites(index, self.entries):
            if s.kind != SYNC:
                continue
            n = counts.get((s.uid, s.pattern), 0)
            counts[(s.uid, s.pattern)] = n + 1
            out.append(Violation(
                self.rule, s.file, s.line, s.symbol,
                f"{s.pattern} site reachable from the engine step hot "
                f"path ({s.text[:60]}) — makes the host wait on the "
                f"device", detail=f"{s.pattern}#{n}"))
        return out


def reachable_uids(index: ProjectIndex,
                   entries: Sequence[Tuple[str, str]] = DEFAULT_ENTRIES
                   ) -> Set[str]:
    """`file::qualname` of every function the hot-path entries reach."""
    return set(_reach(index, entries))


def reachable_functions(index: ProjectIndex,
                        entries: Sequence[Tuple[str, str]] = DEFAULT_ENTRIES
                        ) -> Set[str]:
    """Qualnames reachable from the hot-path entries (for tests)."""
    return {fi.qualname for fi in _reach(index, entries).values()}
