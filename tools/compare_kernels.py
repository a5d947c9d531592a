"""Time the serves' kernels of one checkout on fixed yardsticks, on one
CUDA device, so that two checkouts can be compared.

    python3 tools/compare_kernels.py [--src ROOT] [--label NAME]
                                     [--kernels int8_matmul,...]

Imports `repro_torch` from ROOT/src (default: this checkout) and nothing
else of a checkout, so each checkout runs in a process of its own: to
compare a commit with its parent on one card, unpack the parent with
`git archive` into a gitignored directory and run, in one command,
parent, change, change, parent.

Cases: paged_decode_attention and decode_attention at every served
decode shape (DECODE_SHAPES: OLMo-1B's B=8 K=16 G=1 hd=128 with ragged
pos up to 1023, and chip_smoke.py's SERVED_GQA models at B=8 over S =
1024, hymba's 4096, with every position valid; decode_attention also at
kv_quant's f32 shape), each first held to its plain version (bf16 2e-2,
f32 1e-4), with its route, its split and its bound (the bytes of the
visible K/V rows, q and out over 3.35 TB/s), decode_attention beside one
SDPA call (enable_gqa, the ragged or window mask where there is one; no
single PyTorch call computes the paged kernel); at OLMo-1B's shape both
kernels also at pos one row before and at a chunk edge of the wrapper's
split (`merge_probe`: one chunk runs and stores directly, against two
that merge); int8_matmul at every served
product of PERF.md section 6 (INT8_SHAPES: OLMo-1B's, granite's,
hymba's, xlstm's and seamless's at decode M = 8, their tied or untied
heads, the 32001- and 256206-byte rows of the untied ones included, and
their prefills at the M the serves dispatch), each first held to its
plain version within bf16's 2e-2, beside one torch.matmul on the weight
dequantized beforehand, and the
bf16 flash kernel at the served prefill shapes of PERF.md section 6
(FLASH_SHAPES, each first held to its plain version within bf16's 2e-2)
beside one SDPA call with enable_gqa (under the window's boolean mask
where there is one), with its bound: the larger of the bytes of q, k, v
and out over 3.35 TB/s and 4 hd flops a visible (query, key) pair of a
head over 989 TFLOP/s.  For each call it
reports

- event_ms: CUDA events around the call, each from a cold L2 (a 256 MiB
  buffer written before the start event), median of 30.  The wrapper's
  host work (checks, allocations, the ctypes call) counts where it
  outlasts the flush.
- clean_ms (the decode kernels and SDPA beside them): waited_ms from an
  L2 emptied by reading, not writing, the 256 MiB buffer, so that the
  call's reads evict no dirty line (after a write, up to the L2's ~50 MB
  goes back to device memory while the call reads).
- waited_ms: the same with a 0.2 ms device-side wait
  (torch.cuda._sleep) before the start event, which holds the start
  until the host has enqueued the call: the device work alone.
  chip_smoke.py times kernels so.
- host_us: the host's time per call, median of 10 batches of 20 calls
  issued without a sync: what the call costs a host-bound serve;
  host_us_long the least of 3 batches of 500 calls (the one other
  processes on a shared host disturbed least), host_cpu_us the calling
  thread's CPU time a call over those batches (time.thread_time: the
  time the thread ran, not the time it waited for the host's other
  processes).
- kernel_us: the profiler's device time per launch of each kernel the
  call runs (torch.profiler, 30 cold-L2 calls), a check on both timings
  that no host time can enter.

--kernels limits the run to the named wrappers (comma-separated);
--host-only times only the host's us a call (the least and the median
of 10 batches of 500 calls), for a comparison of host cost run as many
alternating times as its spread needs.
It also prints a sha256 of decode_attention's output at OLMo-1B's shape,
which two checkouts with the same decode kernel share bit for bit.  One
JSON line per case, each with the card's name and power limit; exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPS = 30
SLEEP_CYCLES = 400_000      # ~0.2 ms at the H100's 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# label: (B, H, K, Sq, Skv, hd, window, prefix, causal), as chip_smoke.py
# times flash (kernel_timings, gqa_timings, encdec_timings)
FLASH_SHAPES = {
    "olmo-1b": (4, 16, 16, 1024, 1024, 128, 0, 0, True),
    "llama3.2-1b": (4, 32, 8, 1024, 1024, 64, 0, 0, True),
    "qwen3-1.7b": (4, 16, 8, 1024, 1024, 128, 0, 0, True),
    "gemma3-1b": (4, 4, 1, 1024, 1024, 256, 512, 0, True),
    "gemma3-4b": (2, 8, 4, 1280, 1280, 256, 1024, 256, True),
    "granite-moe-3b-a800m": (4, 24, 8, 1024, 1024, 64, 0, 0, True),
    "mixtral-8x22b": (4, 48, 8, 1024, 1024, 128, 4096, 0, True),
    "hymba-1.5b": (2, 25, 5, 2528, 2528, 64, 2048, 128, True),
    "seamless-m4t-large-v2": (4, 16, 16, 1024, 1024, 64, 0, 0, True),
    "seamless_encoder": (4, 16, 16, 1024, 1024, 64, 0, 0, False),
}
# label: (B, K, G, S, hd, window, prefix, dtype, pos): OLMo-1B's ragged
# decode, chip_smoke.py's SERVED_GQA at every position valid (hymba at
# max_len 4096), and kv_quant's f32 route (decode_attention only)
DECODE_SHAPES = {
    "olmo-1b": (8, 16, 1, 1024, 128, 0, 0, "bf16", "ragged"),
    "llama3.2-1b": (8, 8, 4, 1024, 64, 0, 0, "bf16", "full"),
    "qwen3-1.7b": (8, 8, 2, 1024, 128, 0, 0, "bf16", "full"),
    "gemma3-1b": (8, 1, 4, 1024, 256, 512, 0, "bf16", "full"),
    "gemma3-4b": (8, 4, 2, 1024, 256, 1024, 256, "bf16", "full"),
    "granite-moe-3b-a800m": (8, 8, 3, 1024, 64, 0, 0, "bf16", "full"),
    "mixtral-8x22b": (8, 8, 6, 1024, 128, 4096, 0, "bf16", "full"),
    "hymba-1.5b": (8, 5, 5, 4096, 64, 2048, 128, "bf16", "full"),
    "seamless-m4t-large-v2": (8, 16, 1, 1024, 64, 0, 0, "bf16", "full"),
    "olmo-1b int8 KV (f32 route)": (8, 16, 1, 1024, 128, 0, 0, "f32",
                                    "kv_quant"),
}
# label: (M, K, N, tied head), as PERF.md section 6 lists the int8 rows
INT8_SHAPES = {
    "olmo_decode_attn": (8, 2048, 2048, False),
    "olmo_decode": (8, 2048, 8192, False),
    "olmo_decode_down": (8, 8192, 2048, False),
    "olmo_head": (8, 2048, 50304, True),
    "olmo_prefill_attn": (4096, 2048, 2048, False),
    "olmo_prefill": (4096, 2048, 8192, False),
    "olmo_prefill_down": (4096, 8192, 2048, False),
    "granite_decode_attn": (8, 1536, 1536, False),
    "granite_decode_kv": (8, 1536, 512, False),
    "granite_head": (8, 1536, 49155, True),
    "granite_prefill_attn": (4096, 1536, 1536, False),
    "granite_prefill_kv": (4096, 1536, 512, False),
    **{f"hymba_decode_{k}x{n}": (8, k, n, False) for k, n in (
        (1600, 1600), (1600, 320), (1600, 3200), (1600, 5504),
        (5504, 1600))},
    "hymba_head": (8, 1600, 32001, False),
    "hymba_prefill_w_in": (816, 1600, 3200, False),
    **{f"xlstm_decode_{k}x{n}": (8, k, n, False) for k, n in (
        (768, 3072), (1536, 1536), (1536, 768), (768, 2112), (2112, 768))},
    "xlstm_head": (8, 768, 50304, True),
    "xlstm_prefill_w_up": (853, 768, 3072, False),
    **{f"seamless_decode_{k}x{n}": (8, k, n, False) for k, n in (
        (1024, 1024), (1024, 8192), (8192, 1024))},
    "seamless_head": (8, 1024, 256206, False),
    "seamless_prefill_wi": (4096, 1024, 8192, False),
}
_flush = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cold() -> None:
    if not _flush:
        _flush.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _flush[0].zero_()


def cold_clean() -> None:
    """L2 emptied of the call's data by reading the 256 MiB buffer: the
    lines it leaves are clean, so the call's reads evict nothing that
    must be written back (cold() leaves ~50 MB of dirty lines)."""
    if not _flush:
        cold()
    _flush[0].view(torch.int64).sum()


def event_ms(fn, wait: bool, clean: bool = False) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if clean:
            cold_clean()
        else:
            cold()
        if wait:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us(fn) -> tuple:
    """The median of 10 batches' host us a call (20 calls a batch), and
    over 3 batches of 500 calls the least host us a call and the median
    of the calling thread's CPU us a call (its clock is too coarse for a
    batch of 20 on the card's machine)."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        per_call.append((time.perf_counter() - t0) / 20)
        torch.cuda.synchronize()
    long, cpu = [], []
    for _ in range(3):
        c0, t0 = time.thread_time(), time.perf_counter()
        for _ in range(500):
            fn()
        long.append((time.perf_counter() - t0) / 500)
        cpu.append((time.thread_time() - c0) / 500)
        torch.cuda.synchronize()
    return (float(np.median(per_call)) * 1e6, float(min(long)) * 1e6,
            float(np.median(cpu)) * 1e6)


def kernel_us(fn) -> dict:
    """Device time per launch of each kernel fn() runs, the flush's own
    fill left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            cold()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or "FillFunctor" in evt.key:
            continue
        out[evt.key[:80]] = {"launches": evt.count,
                             "us": evt.self_device_time_total / evt.count}
    return out


HOST_ONLY = False   # --host-only


def measure(fn, clean: bool = False) -> dict:
    """The four timings; with `clean`, also waited_ms from an L2 holding
    only clean lines (clean_ms).  With --host-only, only the host's us a
    call: the least and the median of 10 batches of 500 calls."""
    if HOST_ONLY:
        fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(10):
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            per_call.append((time.perf_counter() - t0) / 500)
            torch.cuda.synchronize()
        return {"host_us_least": float(min(per_call)) * 1e6,
                "host_us_median": float(np.median(per_call)) * 1e6}
    host, host_long, host_cpu = host_us(fn)
    out = {"event_ms": event_ms(fn, wait=False),
           "waited_ms": event_ms(fn, wait=True),
           "host_us": host, "host_us_long": host_long,
           "host_cpu_us": host_cpu, "kernel_us": kernel_us(fn)}
    if clean:
        out["clean_ms"] = event_ms(fn, wait=True, clean=True)
    return out


def splits_of(ops, paged: bool, *shape) -> list:
    """The wrapper's split at (B, K, S or pps, [ps,] n_sm, hd, route) in
    this checkout (a checkout before the tensor-core route takes the
    shapes without hd and route)."""
    fn = (ops.paged_decode_attention_splits if paged
          else ops.decode_attention_splits)
    try:
        return list(fn(*shape))
    except TypeError:
        return list(fn(*shape[:-2]))


def decode_cases(ops, dev, head, run) -> None:
    """Both decode kernels at DECODE_SHAPES (see the module docstring)."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_ref
    F = torch.nn.functional
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, (B, K, G, S, hd, win, pre, dt, kind) in DECODE_SHAPES.items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        tol = 2e-2 if dt == "bf16" else 1e-4
        route = "tensor_core" if dt == "bf16" else "cuda_core"
        if kind == "ragged":
            pos = np.random.default_rng(1).integers(1, S, B)
            pos[0], pos[-1] = 0, S - 1
        elif kind == "kv_quant":
            pos = np.arange(1000, 1000 + B)
        else:
            pos = np.full(B, S - 1)
        p = torch.tensor(pos.tolist(), dtype=torch.int32, device=dev)
        vis = sum(int(x) + 1 if not win else
                  min(int(x) + 1, win) + min(pre, max(int(x) + 1 - win, 0))
                  for x in pos)
        sz = 2 if dt == "bf16" else 4
        t_bytes = (2 * vis * K * hd * sz + 2 * B * K * G * hd * sz
                   + B * 4) / HBM_BYTES_PER_S
        kw = dict(window=win, prefix=pre)
        rows = {"case": label}

        def probe(fn, chunk_rows):
            """fn(pos) timed at pos chunk_rows - 1 (one chunk) and
            chunk_rows (two chunks, merged), every slot."""
            out = {"chunk_rows": chunk_rows}
            for name, at in (("one_chunk", chunk_rows - 1),
                             ("two_chunks", chunk_rows)):
                pp = torch.full((B,), at, dtype=torch.int32, device=dev)
                out[name] = measure(lambda: fn(pp))
            return out

        if "paged_decode_attention" in run and kind != "kv_quant":
            rng = np.random.default_rng(7)
            pps = S // 16
            n_pages = B * pps + 3
            table = np.full((B, pps), n_pages, np.int32)
            perm = iter(rng.permutation(n_pages))
            for i, pi in enumerate(pos):
                for j in range(int(pi) // 16 + 1):
                    table[i, j] = next(perm)
            pq = tensor(rng, dev, dtype, B, K, G, hd)
            pools = [tensor(rng, dev, dtype, n_pages, 16, K, hd)
                     for _ in range(2)]
            ptable = torch.from_numpy(table).to(dev)
            got = ops.paged_decode_attention(pq, *pools, ptable, p, **kw)
            want = paged_decode_attention_ref(pq, *pools, ptable, p, **kw)
            err = float((got.float() - want.float()).abs().max())
            if err > tol:
                raise AssertionError(f"paged_decode_attention/{label}: {err}")
            split = splits_of(ops, True, B, K, pps, 16, n_sm, hd, route)
            row = {**head, **rows, "kernel": "paged_decode_attention",
                   "shape": f"B={B} K={K} G={G} hd={hd} ps=16 pps={pps} "
                            f"window={win} prefix={pre} {dt}, pos {kind}",
                   "route": route, "splits": split, "max_abs_err": err,
                   "bound_ms": t_bytes * 1e3, "bound_by": "bytes",
                   "wrapper": measure(lambda: ops.paged_decode_attention(
                       pq, *pools, ptable, p, **kw), clean=True)}
            if label == "olmo-1b" and split[0] > 1:
                full = torch.arange(pps, dtype=torch.int32,
                                    device=dev).repeat(B, 1)
                row["merge_probe"] = probe(
                    lambda pp: ops.paged_decode_attention(
                        pq, *pools, full, pp), split[1] * 16)
            emit(row)
            del pools, pq
        if "decode_attention" in run:
            rng = np.random.default_rng(9)
            q = tensor(rng, dev, dtype, B, K, G, hd)
            k, v = (tensor(rng, dev, dtype, B, S, K, hd).permute(0, 2, 1, 3)
                    for _ in range(2))
            got = ops.decode_attention(q, k, v, p, **kw)
            want = decode_attention_ref(q, k, v, p, **kw)
            err = float((got.float() - want.float()).abs().max())
            if err > tol:
                raise AssertionError(f"decode_attention/{label}: {err}")
            kp = torch.arange(S, device=dev)[None, :]
            mask = kp <= p[:, None].long()
            if win:
                mask &= (kp > p[:, None].long() - win) | (kp < pre)
            qh = q.reshape(B, K * G, 1, hd)
            split = splits_of(ops, False, B, K, S, n_sm, hd, route)
            row = {**head, **rows, "kernel": "decode_attention",
                   "shape": f"B={B} K={K} G={G} S={S} hd={hd} window={win} "
                            f"prefix={pre} {dt}, (B, S, K, hd) view, pos "
                            f"{kind}",
                   "route": route, "splits": split, "max_abs_err": err,
                   "bound_ms": t_bytes * 1e3, "bound_by": "bytes",
                   "wrapper": measure(lambda: ops.decode_attention(
                       q, k, v, p, **kw), clean=True),
                   "library": measure(
                       lambda: F.scaled_dot_product_attention(
                           qh, k, v, attn_mask=mask[:, None, None, :],
                           enable_gqa=True), clean=True)}
            if label == "olmo-1b":
                row["sha256"] = hashlib.sha256(got.view(
                    torch.int16).cpu().numpy().tobytes()).hexdigest()
            if label == "olmo-1b" and split[0] > 1:
                row["merge_probe"] = probe(
                    lambda pp: ops.decode_attention(q, k, v, pp), split[1])
            emit(row)
            del q, k, v
        torch.cuda.empty_cache()


def tensor(rng, dev, dtype, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose src/ is imported")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--kernels", default="paged_decode_attention,"
                    "decode_attention,int8_matmul,flash_attention",
                    help="the wrappers to time, comma-separated")
    ap.add_argument("--host-only", action="store_true",
                    help="time only the host's us a call (alternate the "
                    "checkouts' runs to see a difference of a few us)")
    args = ap.parse_args()
    global HOST_ONLY
    HOST_ONLY = args.host_only
    run = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels import ops
    from repro_torch.serving import quantization as q_lib
    dev = torch.device("cuda", 0)
    ops.build()
    head = {"label": args.label, "src": args.src, "card": card_line(),
            "torch": torch.__version__}
    bf16 = torch.bfloat16

    decode_cases(ops, dev, head, run)

    from repro_torch.kernels.int8_matmul import int8_matmul_ref
    for label, (M, K, N, tied) in INT8_SHAPES.items():
        if "int8_matmul" not in run:
            break
        rng = np.random.default_rng(10)
        w = tensor(rng, dev, torch.float32, *((N, K) if tied else (K, N)))
        qd = q_lib.quantize_array(w * 0.1, 8)
        wq, sc = qd["__q__"], qd["scale"]
        del w, qd
        if tied:
            wq, sc = wq.t(), sc.t()
        x = tensor(rng, dev, bf16, M, K)
        got = ops.int8_matmul(x, wq, sc).float()
        want = int8_matmul_ref(x, wq, sc).float()
        err = (got - want).abs()
        if bool((err > 2e-2 + 2e-2 * want.abs()).any()):
            raise AssertionError(f"int8_matmul/{label}: max |err| "
                                 f"{float(err.max())}")
        t_bytes = (K * N + 2 * (M * K + M * N) + 4 * sc.numel()) \
            / HBM_BYTES_PER_S
        t_ops = 2 * M * K * N / BF16_FLOPS
        del got, want, err
        w16 = (wq.float() * sc).to(bf16)
        emit({**head, "kernel": "int8_matmul", "label": label,
              "shape": f"M={M} K={K} N={N} bf16",
              "route": ops.int8_matmul_route(x, wq, sc),
              "bound_ms": max(t_bytes, t_ops) * 1e3,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "wrapper": measure(lambda: ops.int8_matmul(x, wq, sc)),
              "library": measure(lambda: torch.matmul(x, w16))})
        del w16, x, wq, sc
        torch.cuda.empty_cache()

    from repro_torch.kernels.flash_attention import flash_attention_ref
    F = torch.nn.functional
    for label, shape in FLASH_SHAPES.items():
        if "flash_attention" not in run:
            break
        B, H, K, Sq, Skv, hd, win, pre, causal = shape
        rng = np.random.default_rng(11)
        q = tensor(rng, dev, bf16, B, H, Sq, hd)
        k, v = (tensor(rng, dev, bf16, B, K, Skv, hd) for _ in range(2))
        kw = dict(causal=causal, window=win, prefix=pre)
        got = ops.flash_attention(q, k, v, **kw).float()
        want = flash_attention_ref(q, k, v, **kw).float()
        err = (got - want).abs()
        if bool((err > 2e-2 + 2e-2 * want.abs()).any()):
            raise AssertionError(f"flash_attention/{label}: max |err| "
                                 f"{float(err.max())}")
        mask = None
        if causal:
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Skv, device=dev)[None, :]
            mask = kp <= qp
            if win:
                mask &= (kp > qp - win) | (kp < pre)
        pairs = B * (int(mask.sum()) if causal else Sq * Skv)
        t_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            / HBM_BYTES_PER_S
        t_ops = 4 * H * hd * pairs / BF16_FLOPS
        emit({**head, "kernel": "flash_attention", "label": label,
              "shape": dict(zip("B H K Sq Skv hd window prefix causal"
                                .split(), shape)),
              "route": ops.flash_attention_route(q.dtype),
              "max_abs_err": float(err.max()),
              "bound_ms": max(t_bytes, t_ops) * 1e3,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "wrapper": measure(lambda: ops.flash_attention(q, k, v, **kw)),
              "library": measure(lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask if win else None,
                  is_causal=causal and not win, enable_gqa=True))})
        del q, k, v, got, want, err, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
