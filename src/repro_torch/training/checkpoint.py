"""Checkpoints: msgpack files of a tree of tensors, atomic commits and a
keep-last-k manager — the counterpart of `repro.training.checkpoint`,
whose files it reads and writes byte for byte.

A file is one msgpack map from each leaf's path ("params/layers/attn/wq":
the keys joined with "/", in JAX's sorted-key order) to a map {"dtype":
numpy's dtype string ("<f4", "|i1", ...) or "bfloat16", "shape": [ints],
"data": the raw little-endian bytes}; bf16 travels as its uint16 bits.
The port carries its own encoder and decoder for the part of msgpack
such a file uses (maps, strings, arrays, bin, ints of every width), with
msgpack-python's choice of the smallest form, so that the same state
gives the same bytes as `msgpack.packb`: the port needs no msgpack
package.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.training.tree import Tree, items, unflatten

PathLike = Union[str, Path]


# --------------------------------------------------------------------- #
# msgpack, the subset the files use

def _head(n: int, fix: Optional[int], codes: Tuple[int, ...],
          fix_max: int = 0) -> bytes:
    """A length header: a fix form (fix | n, n <= fix_max), else the
    8-, 16- or 32-bit form of `codes` (None where msgpack has none)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7f:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, lim in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= lim:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if n >= -lim:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: int {n} out of range")


def pack_chunks(obj: Any) -> Iterator[bytes]:
    """msgpack bytes of obj, in chunks (a bin payload is yielded as it
    is, not copied into a larger buffer)."""
    if isinstance(obj, int) and not isinstance(obj, bool):
        yield _pack_int(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        yield _head(len(raw), 0xa0, (0xd9, 0xda, 0xdb), 31) + raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        yield _head(len(obj), None, (0xc4, 0xc5, 0xc6))
        yield obj
    elif isinstance(obj, (list, tuple)):
        yield _head(len(obj), 0x90, (None, 0xdc, 0xdd), 15)
        for v in obj:
            yield from pack_chunks(v)
    elif isinstance(obj, dict):
        yield _head(len(obj), 0x80, (None, 0xde, 0xdf), 15)
        for k, v in obj.items():
            yield from pack_chunks(k)
            yield from pack_chunks(v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    return b"".join(pack_chunks(obj))


_INTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
         0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def unpackb(buf) -> Any:
    """Decode one msgpack object that fills `buf` (bytes-like).  A bin
    comes back as a memoryview into `buf`, not a copy."""
    view = memoryview(buf)
    obj, end = _unpack(view, 0)
    if end != len(view):
        raise ValueError(f"msgpack: {len(view) - end} trailing bytes")
    return obj


def _unpack(view: memoryview, i: int) -> Tuple[Any, int]:
    b = view[i]
    i += 1
    if b <= 0x7f:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8f:
        return _unpack_map(view, i, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _unpack_array(view, i, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(view[i:i + n], "utf-8"), i + n
    if b in _INTS:
        fmt = _INTS[b]
        return struct.unpack_from(fmt, view, i)[0], i + struct.calcsize(fmt)
    if b in _LEN:
        fmt = _LEN[b]
        n = struct.unpack_from(fmt, view, i)[0]
        i += struct.calcsize(fmt)
        if b in (0xc4, 0xc5, 0xc6):
            return view[i:i + n], i + n
        if b in (0xd9, 0xda, 0xdb):
            return str(view[i:i + n], "utf-8"), i + n
        if b in (0xdc, 0xdd):
            return _unpack_array(view, i, n)
        return _unpack_map(view, i, n)
    raise ValueError(f"msgpack: type byte {b:#x} is not supported")


def _unpack_array(view: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _unpack(view, i)
        out.append(v)
    return out, i


def _unpack_map(view: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(view, i)
        v, i = _unpack(view, i)
        out[k] = v
    return out, i


# --------------------------------------------------------------------- #
# tensors <-> the file's entries

def _to_numpy(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(the file's dtype string, a contiguous numpy array of the raw
    values on the host)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.dtype.str, a


def _pack_leaf(t: torch.Tensor) -> Dict[str, Any]:
    dtype, a = _to_numpy(t)
    return {"dtype": dtype, "shape": list(a.shape),
            "data": memoryview(a.reshape(-1)).cast("B")}


def _unpack_leaf(d: Dict[str, Any]) -> torch.Tensor:
    """A host tensor of the entry's values (its own aligned copy)."""
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(a.copy())


def save(tree: Tree, path: PathLike) -> None:
    """Atomic checkpoint write (a temporary file in the same directory,
    then `os.replace`)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _pack_leaf(v) for k, v in items(tree)}
    with tempfile.NamedTemporaryFile(dir=path.parent, delete=False) as f:
        for chunk in pack_chunks(flat):
            f.write(chunk)
        tmp = f.name
    os.replace(tmp, path)        # atomic commit


def restore(path: PathLike, like: Tree) -> Tree:
    """Restore into the structure of `like`: each leaf converted to its
    `like` leaf's dtype, on its device; a DTensor leaf of `like` gets the
    restored tensor in its own layout (each rank keeps its blocks).  A
    missing leaf raises KeyError, a shape that differs ValueError, as
    JAX's."""
    from repro_torch.distributed.sharding import distribute, is_dtensor
    buf = bytearray(Path(path).stat().st_size)
    with open(path, "rb") as f:
        f.readinto(buf)
    flat = {k: _unpack_leaf(v) for k, v in unpackb(buf).items()}
    out = []
    for key, leaf in items(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if is_dtensor(leaf):
            t = distribute(t, leaf.device_mesh, leaf.placements)
        out.append(t)
    return unflatten(like, out)


@dataclasses.dataclass
class CheckpointManager:
    directory: PathLike
    keep: int = 3

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step:08d}.msgpack"

    def _steps(self):
        return sorted(int(p.stem.split("_")[1])
                      for p in self.directory.glob("ckpt_*.msgpack"))

    def save(self, step: int, tree: Tree) -> None:
        save(tree, self._path(step))
        self._gc()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Tree) -> Tuple[Optional[int], Tree]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, restore(self._path(step), like)

    def _gc(self) -> None:
        for s in self._steps()[:-self.keep]:
            self._path(s).unlink(missing_ok=True)
