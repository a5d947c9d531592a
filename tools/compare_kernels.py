"""Time the serves' kernels of one checkout on fixed yardsticks, on one
CUDA device, so that two checkouts can be compared.

    python3 tools/compare_kernels.py [--src ROOT] [--label NAME]
                                     [--kernels int8_matmul,...]

Imports `repro_torch` from ROOT/src (default: this checkout) and nothing
else of a checkout, so each checkout runs in a process of its own: to
compare a commit with its parent on one card, unpack the parent with
`git archive` into a gitignored directory and run, in one command,
parent, change, change, parent.

Cases, at the OLMo-1B bf16 decode shapes: paged_decode_attention (B=8
K=16 G=1 hd=128, pages of 16, a table of 64 columns, ragged pos up to
1023; no single PyTorch call computes it), decode_attention (B=8 K=16
G=1 S=1024 hd=128, the (B, S, K, hd) cache view, the same pos) beside
one SDPA call with the ragged mask, and int8_matmul at every served
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
- waited_ms: the same with a 0.2 ms device-side wait
  (torch.cuda._sleep) before the start event, which holds the start
  until the host has enqueued the call: the device work alone.
  chip_smoke.py times kernels so.
- host_us: the host's time per call, median of 10 batches of 20 calls
  issued without a sync: what the call costs a host-bound serve.
- kernel_us: the profiler's device time per launch of each kernel the
  call runs (torch.profiler, 30 cold-L2 calls), a check on both timings
  that no host time can enter.

--kernels limits the run to the named wrappers (comma-separated).
It also prints a sha256 of decode_attention's output at its timed shape,
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


def event_ms(fn, wait: bool) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        cold()
        if wait:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        per_call.append((time.perf_counter() - t0) / 20)
        torch.cuda.synchronize()
    return float(np.median(per_call)) * 1e6


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


def measure(fn) -> dict:
    return {"event_ms": event_ms(fn, wait=False),
            "waited_ms": event_ms(fn, wait=True),
            "host_us": host_us(fn), "kernel_us": kernel_us(fn)}


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
    args = ap.parse_args()
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

    rng = np.random.default_rng(1)
    pos = rng.integers(1, 1024, 8)
    pos[0], pos[-1] = 0, 1023
    p = torch.tensor(pos, dtype=torch.int32, device=dev)

    rng = np.random.default_rng(7)
    n_pages = 8 * 64 + 3
    table = np.full((8, 64), n_pages, np.int32)
    perm = iter(rng.permutation(n_pages))
    for i, pi in enumerate(pos):
        for j in range(pi // 16 + 1):
            table[i, j] = next(perm)
    pq = tensor(rng, dev, bf16, 8, 16, 1, 128)
    pools = [tensor(rng, dev, bf16, n_pages, 16, 16, 128) for _ in range(2)]
    ptable = torch.from_numpy(table).to(dev)
    if "paged_decode_attention" in run:
        emit({**head, "kernel": "paged_decode_attention",
              "shape": "B=8 K=16 G=1 hd=128 ps=16 pps=64 bf16",
              "wrapper": measure(lambda: ops.paged_decode_attention(
                  pq, *pools, ptable, p))})

    rng = np.random.default_rng(9)
    q = tensor(rng, dev, bf16, 8, 16, 1, 128)
    k, v = (tensor(rng, dev, bf16, 8, 1024, 16, 128).permute(0, 2, 1, 3)
            for _ in range(2))
    mask = (torch.arange(1024, device=dev)[None, :]
            <= p[:, None].long())[:, None, None, :]
    F = torch.nn.functional
    got = ops.decode_attention(q, k, v, p)
    if "decode_attention" in run:
        emit({**head, "kernel": "decode_attention",
              "shape": "B=8 K=16 G=1 S=1024 hd=128 bf16, (B, S, K, hd) view",
              "sha256": hashlib.sha256(
                  got.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
              "wrapper": measure(lambda: ops.decode_attention(q, k, v, p)),
              "library": measure(lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask))})

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
