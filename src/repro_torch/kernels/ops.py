"""Public kernel wrappers, routed by device, and the kernels' build.

Each wrapper takes the JAX package's layouts.  A CPU tensor goes to the
kernel's plain PyTorch version; a CUDA tensor launches the hand-written
kernel or raises — there is no fallback.  Each wrapper counts its
launches in a plain integer attribute, `<wrapper>.launches`, which
`chip_smoke.py` reads to show that the main path ran the kernels.  The
two wrappers with more than one kernel (`flash_attention`,
`int8_matmul`) pick it in a pure function of dtype, layout, scale, M and
alignment (`flash_attention_route`, `int8_matmul_route`), never from a
failure, and also count each launch by route in a plain dict,
`<wrapper>.launches_by_route`; the flash wrapper also counts its
non-causal launches (the encoder's and the cross-attention's) in
`flash_attention.launches_non_causal`.  Every count goes through
`_count`, under one lock: the serving runtime launches from one pump
thread per node, and an unlocked `+= 1` can lose an update.

Three kernels split their work across CTAs (decode attention its
sequence, paged decode attention its page table's columns, the int8
`skinny_tc` route its K) and merge the f32 partials in the CTA that
finishes last.  Their wrappers pick the split in a pure function of the
shapes and the SM count (`decode_attention_splits`,
`paged_decode_attention_splits`, `int8_skinny_tc_splits`).  All three
find the last CTA through counters that the kernels leave at 0, and
write their f32 partials into a buffer that is kept between calls: one
pair of buffers per (device, stream), `_split_buffers`.

Build: at first use on the card, every `csrc/*.cu` is compiled by `nvcc`
for sm_90a into its own shared library with a plain C interface (all
sources at once, one process each), under `build/kernels/<hash>/` at the
root of the checkout, keyed by a hash of the sources and flags.  The
libraries are bound with ctypes; pointers and the stream are passed as
Python ints, from `data_ptr()` and from the current stream's handle,
cached per stream (`_stream`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.int8_matmul import int8_matmul_ref
from repro_torch.kernels.paged_attention import (paged_decode_attention_ref,
                                                 paged_suffix_attention_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_decode_attention", "flash_attention",
           "decode_attention", "int8_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    """`build/kernels/<hash of sources and flags>`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every kernel not yet built for these sources; returns the
    library path of each.  `nvcc`'s report (registers, shared memory,
    spills from `-Xptxas -v`) is kept beside each library as `<name>.log`.
    Raises on any compile failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {name: out / f"lib{name}.so" for name in KERNELS}
    todo = [n for n, p in libs.items() if not p.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name in todo:   # one nvcc per source, all started together
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          + (out / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = build()[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, name)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            f = ctypes.c_float
            fn.argtypes = {
                "paged_decode_attention": [p] * 8 + [i] * 12 + [f, p],
                "flash_attention": [p] * 4 + [i] * 11 + [f] + [ll] * 9 + [p],
                "decode_attention": ([p] * 7 + [i] * 5 + [ll] * 3
                                     + [i] * 5 + [f, p]),
                "int8_matmul": ([p] * 6 + [i] * 3 + [ll] * 2 + [i] * 5
                                + [p]),
            }[name]
            fn.restype = i
            lib.error_string.argtypes = [i]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    _check_device(name, *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    """Strided views the kernels take in place: the last dim contiguous,
    every other stride a whole number of 16-byte rows."""
    for t in tensors:
        row = 16 // t.element_size()
        if t.stride(-1) != 1 or any(st % row for st in t.stride()[:-1]):
            raise ValueError(f"{name}: strides {t.stride()} need the last "
                             "dim contiguous and 16-byte rows")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_raw_streams: Dict[tuple, int] = {}


def _stream(device: torch.device) -> tuple:
    """(key, handle) of `device`'s current stream: torch's stream id, and
    the cudaStream_t as an int, cached by that id.  torch's ids name fixed
    streams (its pools' and the default stream), so the cache stays true;
    building a torch.cuda.Stream object on every launch would cost the
    host microseconds a call."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, torch._C._cuda_getCurrentStream(index)[0])
    handle = _raw_streams.get(key)
    if handle is None:
        handle = torch.cuda.current_stream(device).cuda_stream
        _raw_streams[key] = handle
    return key, handle


_split_bufs: Dict[tuple, list] = {}


def _split_buffers(device: torch.device, n_tickets: int,
                   n_ws: int) -> tuple:
    """(counters, partials) for the kernels that split work across CTAs:
    at least `n_tickets` int32 counters, zeroed once at allocation (the
    kernels find the last CTA of a group through them and leave them at
    0), and at least `n_ws` f32 partials, which every launch writes before
    it reads them.  One pair per (device, current stream), kept between
    calls: launches on one stream run in order, so each finds the pair
    free; a launch on another stream gets a pair of its own, so no
    counter or partial is ever shared by launches that may overlap."""
    bufs = _split_bufs.setdefault(_stream(device)[0], [None, None])
    if bufs[0] is None or bufs[0].numel() < n_tickets:
        bufs[0] = torch.zeros(max(n_tickets, 4096), dtype=torch.int32,
                              device=device)
    if bufs[1] is None or bufs[1].numel() < n_ws:
        bufs[1] = torch.empty(max(n_ws, 1 << 20), dtype=torch.float32,
                              device=device)
    return bufs[0], bufs[1]


_count_lock = threading.Lock()


def _count(wrapper, route: Optional[str] = None,
           non_causal: bool = False) -> None:
    """One launch of `wrapper` (on `route`; a non-causal flash launch),
    counted exactly whatever the threads launching."""
    with _count_lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.launches_by_route[route] += 1
        if non_causal:
            wrapper.launches_non_causal += 1


def _run(name: str, device: torch.device, *args) -> None:
    fn = getattr(_lib(name), name)
    stream = _stream(device)[1]
    if torch.cuda.current_device() == device.index:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_lib(name).error_string(err).decode()} "
                           f"({err})")


# --------------------------------------------------------------------- #
# wrappers

PAGED_MIN_ROWS = 64        # rows (pages x page size) worth a CTA
PAGED_MAX_SPLITS = 32      # the kernel's mask of running chunks
PAGED_CTAS_PER_SM = 4      # CTAs an SM holds at once (128 threads, ~125
                           # registers each): the grid aims for one wave


@functools.lru_cache(maxsize=None)
def paged_decode_attention_splits(b: int, nkv: int, pps: int, ps: int,
                                  n_sm: int) -> tuple:
    """(n_split, ppc) of the paged kernel's split of the page table's pps
    columns: chunks of `ppc` pages, each a CTA, each at least
    PAGED_MIN_ROWS rows where the table allows, as many as one wave of
    PAGED_CTAS_PER_SM CTAs per SM holds (B * K * n_split at most that),
    at most PAGED_MAX_SPLITS.  At the OLMo-1B decode shape that is 4
    chunks of 16 pages, the fastest of tools/sweep_splits.py's sweep: a
    fifth chunk starts a second wave, a third fewer leave slots idle
    (PERF.md section 6).  A function of the shapes and the SM count
    alone, never of `pos` or the table: the wrapper reads nothing back
    from the card.  Every chunk holds at least one column."""
    wave = PAGED_CTAS_PER_SM * n_sm // (b * nkv)
    min_ppc = -(-PAGED_MIN_ROWS // ps)
    n = max(1, min(wave, -(-pps // min_ppc), PAGED_MAX_SPLITS))
    ppc = -(-pps // n)
    return -(-pps // ppc), ppc


def _paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, page_table: torch.Tensor,
                  pos: torch.Tensor, window: int, prefix: int,
                  splits: tuple | None = None) -> torch.Tensor:
    """The paged kernel's launch on CUDA tensors, split as `splits`
    (n_split, ppc), by default the wrapper's rule; counts nothing.  The
    sweep and the card tests take other splits through it."""
    name = "paged_decode_attention"
    _check_cuda(name, q, k_pool, v_pool, page_table, pos)
    b, nkv, g, hd = q.shape
    n_pages, ps = k_pool.shape[0], k_pool.shape[1]
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype}; needs f32 or bf16, all the same")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if tuple(k_pool.shape) != (n_pages, ps, nkv, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1 or tuple(pos.shape) != (b,):
        raise ValueError(f"{name}: page_table (B, pps >= 1) and pos (B,) "
                         "must be int32 for B = q.shape[0]")
    if not isinstance(window, int) or not isinstance(prefix, int):
        raise TypeError(f"{name}: window and prefix must be static ints")
    out = torch.empty_like(q)
    _check_aligned(name, q, k_pool, v_pool, out)
    pps = page_table.shape[1]
    n_split, ppc = splits or paged_decode_attention_splits(
        b, nkv, pps, ps, _sm_count(q.device.index))
    ws = tickets = None
    if n_split > 1:   # per split and query row (chunks of 8): m, l, acc
        tickets, ws = _split_buffers(q.device, b * nkv,
                                     b * nkv * n_split * 8 * (hd + 2))
    _run(name, q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
         page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
         ws.data_ptr() if ws is not None else None,
         tickets.data_ptr() if tickets is not None else None, b, nkv, g, hd,
         n_pages, ps, pps, window, prefix, _DTYPES[q.dtype], n_split, ppc,
         hd ** -0.5)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *, window: int = 0,
                           prefix: int = 0) -> torch.Tensor:
    """q (B, K, G, hd); pools (P, ps, K, hd); page_table (B, pps) int32
    with sentinel == P; pos (B,) int32.  Returns (B, K, G, hd).  On the
    card the table's columns run in chunks of pages, one CTA each
    (`paged_decode_attention_splits`)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, page_table, pos,
                                          window=window, prefix=prefix)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    out = _paged_decode(q, k_pool, v_pool, page_table, pos, window, prefix)
    _count(paged_decode_attention)
    return out


paged_decode_attention.launches = 0


def paged_suffix_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_pos: torch.Tensor) -> torch.Tensor:
    """Multi-query paged attention for the speculative verify (plain
    causal): q (B, Q, H, hd), q_pos (B, Q).  Plain PyTorch on every
    device, as JAX runs its jnp reference on every backend: the verify
    is Q = spec_draft + 1 rows a slot.  No kernel, so nothing counts."""
    return paged_suffix_attention_ref(q, k_pool, v_pool, page_table, q_pos)


FLASH_ROUTES = ("tensor_core", "cuda_core")


def flash_attention_route(dtype: torch.dtype) -> str:
    """The flash kernel for this dtype: bf16 runs on the tensor cores
    (mma.sync), f32 on the CUDA cores (f32 on the tensor cores would be
    TF32, a numerics change)."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix: int = 0) -> torch.Tensor:
    """q (B, H, Sq, hd); k, v (B, K, Skv, hd) with H % K == 0.  Returns
    (B, H, Sq, hd).  Sq and Skv may be any length.

    On the card q, k and v may be strided views (the last dim
    contiguous, 16-byte rows, k and v with the same strides), which takes
    the (B, H, S, hd) views of (B, S, H, hd) tensors in place; the output
    is the (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer.

    The kernel has no backward: an input that requires grad (with grad
    mode on) raises, on every device, rather than being detached or
    routed to the plain version (training attends in plain PyTorch,
    `models.attention.attention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernel has no backward; "
                           "differentiate models.attention.attention")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix=prefix)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    name = "flash_attention"
    _check_device(name, q, k, v)
    b, h, sq, hd = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, k {k.dtype}, v {v.dtype}; "
                        "needs f32 or bf16, all the same")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if tuple(k.shape) != (b, nkv, skv, hd) or v.shape != k.shape \
            or nkv == 0 or h % nkv or skv == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check_rows(name, q, k, v)
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k strides {k.stride()} and v strides "
                         f"{v.stride()} differ")
    if not isinstance(window, int) or not isinstance(prefix, int):
        raise TypeError(f"{name}: window and prefix must be static ints")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    _check_aligned(name, q, k, v, out)
    route = flash_attention_route(q.dtype)
    _run(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), b, h, nkv, sq, skv, hd, int(causal), window, prefix,
         _DTYPES[q.dtype], FLASH_ROUTES.index(route), hd ** -0.5,
         *q.stride()[:3], *k.stride()[:3], *out.stride()[:3])
    _count(flash_attention, route, non_causal=not causal)
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(FLASH_ROUTES, 0)
flash_attention.launches_non_causal = 0


DECODE_MIN_CHUNK = 64      # rows: the smallest chunk worth a CTA
DECODE_MAX_SPLITS = 32     # the kernel's mask of running chunks
DECODE_CTAS_PER_SM = 4     # the grid the split aims for


@functools.lru_cache(maxsize=None)
def decode_attention_splits(b: int, nkv: int, s: int,
                            n_sm: int) -> tuple:
    """(n_split, chunk) of the decode kernel's sequence split: chunks of
    `chunk` rows (a multiple of DECODE_MIN_CHUNK), each a CTA, enough of
    them that B * K * n_split reaches DECODE_CTAS_PER_SM CTAs per SM where
    S allows, at most DECODE_MAX_SPLITS.  A function of the shapes and the
    SM count alone, never of `pos`: the wrapper reads nothing back from the
    card.  Every chunk holds at least one of the S rows."""
    want = -(-DECODE_CTAS_PER_SM * n_sm // (b * nkv))
    n = max(1, min(want, -(-s // DECODE_MIN_CHUNK), DECODE_MAX_SPLITS))
    chunk = -(-s // n)
    chunk = -(-chunk // DECODE_MIN_CHUNK) * DECODE_MIN_CHUNK
    return -(-s // chunk), chunk


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0, prefix: int = 0) -> torch.Tensor:
    """q (B, K, G, hd) contiguous; caches (B, K, S, hd), S any length, as
    strided views: the last dim contiguous, every other stride a whole
    number of 16-byte rows, the same strides for K and V.  That takes the
    `permute(0, 2, 1, 3)` view of a (B, S, K, hd) cache in place.  pos
    (B,) int32.  Returns (B, K, G, hd)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    prefix=prefix)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    name = "decode_attention"
    _check_cuda(name, q, pos)
    _check_device(name, q, k_cache, v_cache, pos)
    b, nkv, g, hd = q.shape
    s = k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q {q.dtype}, caches {k_cache.dtype}/"
                        f"{v_cache.dtype}; needs f32 or bf16, all the same")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if tuple(k_cache.shape) != (b, nkv, s, hd) or s < 1 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _check_rows(name, k_cache)
    strides = k_cache.stride()
    if v_cache.stride() != strides:
        raise ValueError(f"{name}: cache strides {strides}/"
                         f"{v_cache.stride()} must match")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError(f"{name}: pos must be (B,) int32 for B = {b}")
    if not isinstance(window, int) or not isinstance(prefix, int):
        raise TypeError(f"{name}: window and prefix must be static ints")
    out = torch.empty_like(q)
    _check_aligned(name, q, k_cache, v_cache, out)
    n_split, chunk = decode_attention_splits(b, nkv, s,
                                             _sm_count(q.device.index))
    ws = tickets = None
    if n_split > 1:   # per split and query row (chunks of 8): m, l, acc
        tickets, ws = _split_buffers(q.device, b * nkv,
                                     b * nkv * n_split * 8 * (hd + 2))
    _run(name, q.device, q.data_ptr(), k_cache.data_ptr(),
         v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
         ws.data_ptr() if ws is not None else None,
         tickets.data_ptr() if tickets is not None else None, b, nkv, g, hd,
         s, *strides[:3], window, prefix, _DTYPES[q.dtype], n_split, chunk,
         hd ** -0.5)
    _count(decode_attention)
    return out


decode_attention.launches = 0


INT8_ROUTES = ("skinny", "tensor_core", "cuda_core_tile", "skinny_tc")
SKINNY_MAX_M = 16


def int8_matmul_route(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> str:
    """The int8 kernel for these operands.  M <= 16 (decode, the tied
    head): "skinny_tc" for bf16 x on 16-byte aligned rows (K % 8 == 0,
    the weight's non-unit stride % 16 == 0, both pointers 16-byte
    aligned), KN or NK, either scale (a per-K one 16-byte aligned); "skinny" for f32 x (on the tensor
    cores it would be TF32) or unaligned rows.  M > 16: "tensor_core" for
    bf16 x on a (K, N) weight with unit stride along N, a per-N scale and
    16-byte aligned rows — every prefill projection; "cuda_core_tile" for
    the rest (f32 x, the per-K-scale (K, N) view of the tied head,
    unaligned rows)."""
    m, k = x.shape
    swk, swn = w_q.stride()
    if m <= SKINNY_MAX_M:
        row = swk if swn == 1 else swn
        per_k = tuple(scale.shape) == (k, 1)   # read 4 floats at a time
        if x.dtype == torch.bfloat16 and 1 in (swk, swn) and k % 8 == 0 \
                and row % 16 == 0 and x.data_ptr() % 16 == 0 \
                and w_q.data_ptr() % 16 == 0 \
                and not (per_k and scale.data_ptr() % 16):
            return "skinny_tc"
        return "skinny"
    if x.dtype == torch.bfloat16 and swn == 1 \
            and tuple(scale.shape) == (1, w_q.shape[1]) and k % 8 == 0 \
            and swk % 16 == 0 and x.data_ptr() % 16 == 0 \
            and w_q.data_ptr() % 16 == 0:
        return "tensor_core"
    return "cuda_core_tile"


SKINNY_TC_TILE = {True: (128, 16), False: (64, 64)}   # KN/NK: cols, k a step
SKINNY_TC_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def int8_skinny_tc_splits(k: int, n: int, kn: bool, n_sm: int) -> tuple:
    """(n_ks, per): the skinny_tc kernel's split of its k steps (16 k for
    a KN weight, 64 for NK) into n_ks CTAs of `per` steps per column
    tile: the longest `per` for which tiles x n_ks reaches
    SKINNY_TC_CTAS_PER_SM CTAs per SM, where K allows.  More splits cost
    more f32 partials and a longer merge, fewer leave SMs idle (PERF.md
    section 6).  No split is empty."""
    cols, step_k = SKINNY_TC_TILE[kn]
    tiles = -(-n // cols)
    steps = -(-k // step_k)
    target = SKINNY_TC_CTAS_PER_SM * n_sm
    per = -(-steps // max(1, min(steps, -(-target // tiles))))
    while per > 1 and tiles * -(-steps // per) < target:
        per -= 1
    return -(-steps // per), per


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 or bf16, contiguous; w_q (K, N) int8, a strided view
    with unit stride along N or along K (`embed_q.t()`); scale f32,
    contiguous, (1, N) per output channel or (K, 1) per input channel.
    Returns x @ (w_q * scale) as (M, N) in x.dtype."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for {x.device}")
    name = "int8_matmul"
    _check_cuda(name, x, scale)
    _check_device(name, x, w_q, scale)
    if x.dtype not in _DTYPES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: x {x.dtype}, w_q {w_q.dtype}, scale "
                        f"{scale.dtype}; needs f32/bf16, int8, f32")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not multiply")
    m, k = x.shape
    n = w_q.shape[1]
    if tuple(scale.shape) == (1, n):
        per_k = 0
    elif tuple(scale.shape) == (k, 1):
        per_k = 1
    else:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is neither "
                         f"(1, {n}) nor ({k}, 1)")
    swk, swn = w_q.stride()
    if swn != 1 and swk != 1:
        raise ValueError(f"{name}: w_q strides {w_q.stride()} have no unit "
                         "stride")
    if k == 0:
        raise ValueError(f"{name}: K = 0")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    route = int8_matmul_route(x, w_q, scale)
    n_ks, per, ws, tickets = 1, 1, None, None
    if route == "skinny_tc":
        kn = swn == 1
        n_ks, per = int8_skinny_tc_splits(k, n, kn,
                                          _sm_count(x.device.index))
        if n_ks > 1:   # f32 partials per column tile and split
            cols = SKINNY_TC_TILE[kn][0]
            tiles = -(-n // cols)
            tickets, ws = _split_buffers(x.device, tiles,
                                         tiles * n_ks * m * cols)
    _run(name, x.device, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
         out.data_ptr(), ws.data_ptr() if ws is not None else None,
         tickets.data_ptr() if tickets is not None else None, m, n, k, swk,
         swn, per_k, _DTYPES[x.dtype], INT8_ROUTES.index(route), n_ks, per)
    _count(int8_matmul, route)
    return out


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(INT8_ROUTES, 0)

WRAPPERS = (paged_decode_attention, flash_attention, decode_attention,
            int8_matmul)


def reset_launches() -> None:
    with _count_lock:
        for fn in WRAPPERS:
            fn.launches = 0
            for route in getattr(fn, "launches_by_route", ()):
                fn.launches_by_route[route] = 0
        flash_attention.launches_non_causal = 0
