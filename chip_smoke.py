"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and `nvcc`, and
exits non-zero without a result line when either is missing or any check
fails; no phase catches its own failure.  Phases, each printed as one
JSON line:

1. device   — the card's name and power limit (nvidia-smi).
2. build    — every kernel in src/repro_torch/kernels/csrc is compiled
              from the checkout (nvcc, sm_90a), with ptxas' registers and
              spills.
3. kernel_checks — each hand-written kernel against its plain PyTorch
              version on the card, at the OLMo-1B decode / prefill /
              projection / head shapes and at GQA, window + prefix,
              head_dim 16, strided-cache, ragged and split-boundary cases
              (decode attention's chunks: pos 0, pos on a chunk edge, S
              not a multiple of the chunk, a window that skips whole
              chunks, G > 8; the paged kernel's chunks of pages: pos 0,
              pos on a chunk edge, sentinel holes, shared pages, a window
              across chunks, with a prefix, G = 16, head_dim 16), each
              flash and int8 launch also held to its
              route (bf16 flash and bf16 int8 with M > 16 on aligned
              rows: "tensor_core"; bf16 int8 with M <= 16 on aligned rows
              "skinny_tc"; f32 flash "cuda_core"; f32 or unaligned int8
              with M <= 16 "skinny"; the rest "cuda_core_tile"), and the
              three kernels that split work across CTAs (decode
              attention, paged decode attention, skinny_tc) held to
              bit-identical output over two launches.
              Tolerances: f32 1e-4 (another summation order than the
              plain version), bf16 2e-2 (as tests/test_kernels.py); the
              int8 products are held against the plain
              dequantize-then-multiply, so they too differ only in the
              order of summation (int8 is exact in bf16; skinny_tc's
              head carries x times its per-K scale as a bf16 hi/lo pair,
              to ~2^-17).
4. parity_f32 — a 2-layer full-width OLMo-1B in f32 serves 4 greedy
              requests through the engine in each decode mode (paged
              attention, gather, contiguous) and in the gather mode with
              int8 weights; then, on the dense weights, the prefix cache
              in the paged-attention and gather modes (prompts sharing a
              256-token prefix, one at a time, then a partial hit: >= 2
              suffix admissions), the host swap tier (prompts of 230-250
              tokens on 32 pages for 4 slots of 32, 64 host pages: >= 1
              swap-out, as many swap-ins) and speculative decoding
              (paged attention, repetitive prompts: >= 1 verify); then
              through the control plane (the paper's testbed, the SDAI
              controller, the Gateway; two replicas on two nodes sharing
              one weight tree): the 4 greedy requests through the
              serving runtime's pump threads, and, hand-pumped, one whose
              node is crashed after 2 streamed tokens, migrated to the
              other replica.  Each run's tokens must
              equal a plain greedy recompute on the card (full forward,
              plain attention, no cache, every step; for int8 on the
              dequantized weights), and each must launch exactly its
              mode's kernels (the Gateway's: flash and decode attention,
              node.deploy's default gather mode).
5. serve_bf16 — a main path: the full OLMo-1B (16 layers, bf16, seeded
              random weights) serves 12 requests through
              InferenceEngine.submit/step in the paged-attention mode,
              with the kernels' launch counters set to 0 just before and
              read just after; every request must finish with its exact
              budget, every page must be returned, and the launch counts
              must equal n_layers x decode_block x decode dispatches
              (paged decode) and n_layers x prefill dispatches (flash),
              every flash launch on the "tensor_core" route.
6. serve_int8 — the other main path: the same model, engine sizes and
              requests under quantize="int8" in the JAX engine's default
              decode mode (gather), counters reset just before and read
              just after: exact budgets, every page returned, launches
              n_layers x decode_block x decode dispatches (decode
              attention), 0 (paged decode), n_layers x prefill dispatches
              (flash), (7 n_layers + 1) x model calls (int8 matmul: wq,
              wk, wv, wo, gate, up, down per layer plus the tied head, in
              each prefill and each decode step), and int8 weights under
              0.65 x the bf16 model's bytes.  By route: every flash launch
              "tensor_core"; every int8 launch with M > 16 (a prefill
              projection of rows x bucket > 16) "tensor_core", the rest
              (decode, the head) "skinny_tc", none "skinny", counted from
              each prefill dispatch's (rows, bucket).
7. serve_prefix_swap — the same model with paged attention, the prefix
              cache and a 256-page (512 MiB) pinned host tier on a pool
              of 192 pages: two waves of requests sharing a 512-token
              system prefix (see the function).  Exact budgets, >= 6
              suffix admissions, >= 1 swap-out and as many swap-ins, no
              host page held at the end and no device page after the
              cache's flush; launches n_layers x decode_block x decode
              dispatches (paged decode) and n_layers x full prefill
              dispatches (flash; a suffix admission attends in plain
              PyTorch).  It prints the prefill dispatch tokens, the hit
              rate, the swaps, wave 2's p50 TTFT, the host ms per swap-out
              and per swap-in, each admission's ms, and one row's full
              prefill against its suffix admission.
8. serve_spec — the same model with paged attention and speculation: 12
              requests, 10 greedy on prompts repeating a random motif,
              2 sampled.  Exact budgets, >= 1 verify, paged launches
              n_layers x decode_block x (decode - verify dispatches).  It
              prints tokens per verify (all slots), accepted drafts per
              slot and verify, dispatches per token, and
              how many greedy rows agree with the same traffic with
              speculation off (bf16: informational).
9. serve_gateway — the full OLMo-1B (bf16, one seeded weight tree for
              every replica) served through the control plane: the
              paper's testbed, ModelDemand(n_slots=8, max_len=1024,
              allow_quant=False, min_replicas=2) placed by VRAM into the
              nodes' nominal memory (four replicas, each a real engine on
              the card with its own KV pool), the Gateway's runtime (one
              pump thread per node), serve_bf16's 12 requests from two
              tenants submitted at once and consumed through stream(),
              and one node crashed once some stream with room left is
              past its first token.  Exact budgets, every stream's tokens
              contiguous and equal to its response, >= 1 migration, >= 2
              serving nodes, every surviving engine's pages returned,
              launches summed over the engines (the crashed one's steps
              included) n_layers x decode_block x decode dispatches
              (decode attention) and n_layers x prefill dispatches (flash,
              all "tensor_core"), and every runtime thread joined by
              stop(drain=True).  It prints wall time, tok/s, p50 TTFT at
              the Gateway, requests per node, the migrations and the
              migrated streams' added TTFT, peak device bytes and the
              nodes' nominal accounting.
10. kernels — per kernel: its launches on the path that runs it (and on
              every serve), its error against the plain version, its
              time (CUDA events, median of 30 runs after warm-up, each
              from a cold L2)
              beside the plain version's, the least time the card could
              take (bound), and one PyTorch library call computing the
              same function where there is one.  Both decode kernels are
              timed at the serves' decode shape (the paged kernel with
              its split: chunks and pages per chunk); flash at serve_bf16's
              widest prefill (rows x bucket); the int8 matmul at decode
              M = 8 for 2048 -> 8192 (its entry), 2048 -> 2048 and
              8192 -> 2048, the tied head, and serve_int8's widest
              prefill M at all three projection shapes (its "shapes"),
              each with its route and its ratio to the library call
              ("vs_library").  Before the line: c5_f32_tile_error (the
              f32 CUDA-core int8 tile and f32 cuBLAS against f64 at
              M = 4096) and plain_timings (the verify's plain paged
              attention at the serves' verify shape).

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet (dense, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
REPS = 30
SLEEP_CYCLES = 400_000      # ~0.2 ms at the H100's 1.98 GHz boost clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_l2_flush = []


def time_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of fn() after 3 warm-up calls,
    each from a cold L2: a 256 MiB buffer (five times the H100's 50 MB
    L2) is written before every timed call, outside its events.  A 0.2 ms
    device-side wait (torch.cuda._sleep) then holds the stream before the
    start event, so that fn()'s host work (the wrapper's checks, its
    allocations, the ctypes call) is done before the start event fires:
    the events time the device work fn() enqueues, not the host's."""
    if not _l2_flush:
        _l2_flush.append(torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda"))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _l2_flush[0].zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_close(name, got, want, tol) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} "
                             f"beyond atol=rtol={tol}")
    return float(err.max())


def tol_of(dtype) -> float:
    return 1e-4 if dtype == torch.float32 else 2e-2


def on_route(wrapper, route, call):
    """call(), which must launch `wrapper`'s kernel once, on `route`
    (read from the wrapper's launches_by_route)."""
    before = dict(wrapper.launches_by_route)
    out = call()
    moved = {r: n - before[r] for r, n in wrapper.launches_by_route.items()
             if n != before[r]}
    if moved != {route: 1}:
        raise AssertionError(f"{wrapper.__name__}: launches by route "
                             f"{moved}, want {{{route!r}: 1}}")
    return out


def flash_route(dtype) -> str:
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def int8_route(dtype, M, bf16_route) -> str:
    """f32 x never takes the tensor cores (it would be TF32)."""
    if dtype == torch.bfloat16:
        return bf16_route
    return "skinny" if M <= 16 else "cuda_core_tile"


# --------------------------------------------------------------------- #
# kernel cases

def paged_case(dev, dtype, *, B, K, G, hd, ps, pps, pos, seed,
               kind="plain"):
    """Pools, a sentinel-padded table covering each slot's pos with
    scattered pages, and grouped queries, from a numpy seed.  `kind`
    "holes" leaves every third mapped column at the sentinel; "shared"
    maps slot 1's first half onto slot 0's pages."""
    rng = np.random.default_rng(seed)
    n_pages = B * pps + 3
    table = np.full((B, pps), n_pages, np.int32)
    perm = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            if not (kind == "holes" and j % 3 == 1):
                table[i, j] = next(perm)
    if kind == "shared":
        half = (pos[1] // ps + 1) // 2
        table[1, :half] = table[0, :half]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    return (t(B, K, G, hd), t(n_pages, ps, K, hd), t(n_pages, ps, K, hd),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(np.asarray(pos, np.int32)).to(dev))


def flash_case(dev, dtype, *, B, H, K, S, hd, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    return t(B, H, S, hd), t(B, K, S, hd), t(B, K, S, hd)


def decode_case(dev, dtype, *, B, K, G, S, hd, pos, seed, strided):
    """q and caches from a numpy seed; `strided` caches are the
    (B, K, S, hd) permuted views of (B, S, K, hd) tensors, the layout the
    engine hands the kernel."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    if strided:
        k, v = (t(B, S, K, hd).permute(0, 2, 1, 3) for _ in range(2))
    else:
        k, v = t(B, K, S, hd), t(B, K, S, hd)
    return (t(B, K, G, hd), k, v,
            torch.tensor(pos, dtype=torch.int32, device=dev))


def int8_case(dev, dtype, q_lib, *, M, K, N, head, seed):
    """x and an int8 weight quantized per output channel, or, for the
    tied head's route, the (K, N) view of an (N, K) embedding quantized
    per K with its (K, 1) scale."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    w = (t(N, K) if head else t(K, N)) * 0.1
    qd = q_lib.quantize_array(w, 8)
    wq, sc = qd["__q__"], qd["scale"]
    if head:
        wq, sc = wq.t(), sc.t()
    return t(M, K).to(dtype), wq, sc


def olmo_decode_pos(rng, B, max_len):
    """Ragged positions up to max_len - 1, one slot at pos 0."""
    pos = rng.integers(1, max_len, B)
    pos[0], pos[-1] = 0, max_len - 1
    return [int(p) for p in pos]


def kernel_checks(dev, ops, refs, q_lib):
    """Every kernel against its plain version; returns the rows."""
    paged_ref, flash_ref = refs["paged_decode_attention"], \
        refs["flash_attention"]
    rows = []
    rng = np.random.default_rng(0)
    for dtype in (torch.bfloat16, torch.float32):
        olmo_pos = olmo_decode_pos(rng, 8, 1024)
        cases = [
            ("olmo_decode", dict(B=8, K=16, G=1, hd=128, ps=16, pps=64,
                                 pos=olmo_pos), 0, 0),
            ("gqa_g4_hd64", dict(B=4, K=4, G=4, hd=64, ps=16, pps=8,
                                 pos=[0, 37, 100, 127]), 0, 0),
            ("window_prefix", dict(B=3, K=2, G=2, hd=64, ps=8, pps=16,
                                   pos=[5, 70, 127]), 32, 4),
            ("hd16_g8", dict(B=3, K=2, G=8, hd=16, ps=8, pps=6,
                             pos=[7, 19, 40]), 0, 0),
        ] + [   # split edges: at these B * K the table runs in chunks
            ("split_chunk_edges", dict(B=4, K=2, G=2, hd=64, ps=8, pps=32,
                                       pos=[63, 64, 127, 255]), 0, 0),
            ("split_pos0", dict(B=2, K=2, G=1, hd=128, ps=8, pps=32,
                                pos=[0, 0]), 0, 0),
            ("split_sentinel_holes", dict(B=2, K=2, G=4, hd=32, ps=8,
                                          pps=32, pos=[200, 255],
                                          kind="holes"), 0, 0),
            ("split_shared_pages", dict(B=2, K=2, G=2, hd=64, ps=8, pps=32,
                                        pos=[150, 150], kind="shared"),
             0, 0),
            ("split_window_crosses", dict(B=3, K=2, G=4, hd=64, ps=8,
                                          pps=32, pos=[99, 140, 255]),
             100, 0),
            ("split_window_prefix", dict(B=3, K=2, G=4, hd=64, ps=8, pps=32,
                                         pos=[150, 200, 255]), 100, 16),
            ("split_g16", dict(B=2, K=2, G=16, hd=32, ps=8, pps=32,
                               pos=[100, 255]), 0, 0),
            ("split_hd16_g8", dict(B=2, K=2, G=8, hd=16, ps=8, pps=32,
                                   pos=[17, 255]), 0, 0),
        ]
        for name, kw, win, pre in cases:
            args = paged_case(dev, dtype, seed=len(rows), **kw)
            got = ops.paged_decode_attention(*args, window=win, prefix=pre)
            torch.cuda.synchronize()
            want = paged_ref(*args, window=win, prefix=pre)
            err = check_close(f"paged_decode_attention/{name}", got, want,
                              tol_of(dtype))
            rows.append({"kernel": "paged_decode_attention", "case": name,
                         "dtype": str(dtype), "max_abs_err": err,
                         "splits": ops.paged_decode_attention_splits(
                             kw["B"], kw["K"], kw["pps"], kw["ps"],
                             ops._sm_count(dev.index))})
            if name == "olmo_decode" or name.startswith("split_"):
                again = ops.paged_decode_attention(*args, window=win,
                                                   prefix=pre)
                if not torch.equal(got, again):
                    raise AssertionError(f"paged_decode_attention/{name}: "
                                         "two launches differ")
        fcases = [
            ("olmo_prefill", dict(B=1, H=16, K=16, S=1024, hd=128), 0, 0),
            ("gqa_h8_k2", dict(B=2, H=8, K=2, S=256, hd=64), 0, 0),
            ("window_prefix", dict(B=1, H=4, K=2, S=256, hd=64), 48, 16),
            ("hd16_ragged", dict(B=2, H=4, K=4, S=200, hd=16), 0, 0),
            ("ragged_1000", dict(B=1, H=16, K=16, S=1000, hd=128), 0, 0),
        ]
        for name, kw, win, pre in fcases:
            q, k, v = flash_case(dev, dtype, seed=len(rows), **kw)
            got = on_route(ops.flash_attention, flash_route(dtype),
                           lambda: ops.flash_attention(
                               q, k, v, causal=True, window=win,
                               prefix=pre))
            torch.cuda.synchronize()
            want = flash_ref(q, k, v, causal=True, window=win, prefix=pre)
            err = check_close(f"flash_attention/{name}", got, want,
                              tol_of(dtype))
            rows.append({"kernel": "flash_attention", "case": name,
                         "dtype": str(dtype), "route": flash_route(dtype),
                         "max_abs_err": err})
        q, k, v = flash_case(dev, dtype, B=1, H=4, K=2, S=128, hd=64, seed=99)
        got = on_route(ops.flash_attention, flash_route(dtype),
                       lambda: ops.flash_attention(q, k, v, causal=False))
        torch.cuda.synchronize()
        err = check_close("flash_attention/noncausal", got,
                          flash_ref(q, k, v, causal=False), tol_of(dtype))
        rows.append({"kernel": "flash_attention", "case": "noncausal",
                     "dtype": str(dtype), "route": flash_route(dtype),
                     "max_abs_err": err})
        dcases = [
            ("olmo_decode_strided", dict(B=8, K=16, G=1, S=1024, hd=128,
                                         pos=olmo_pos, strided=True), 0, 0),
        ] + [   # the DECODE_CASES of tests/test_kernels.py
            (f"decode_case_{i}", dict(
                B=B, K=K, G=G, S=S, hd=hd, strided=False,
                pos=rng.integers(max(win, 1), S, B).tolist()), win, 0)
            for i, (B, K, G, S, hd, win) in enumerate(
                [(2, 2, 4, 512, 64, 0), (4, 8, 8, 256, 128, 0),
                 (2, 1, 4, 512, 64, 128), (1, 4, 2, 1024, 64, 0),
                 (3, 2, 8, 256, 32, 0)])
        ] + [
            ("window_prefix", dict(B=3, K=2, G=2, S=300, hd=64,
                                   pos=[5, 70, 299], strided=False), 32, 4),
            ("hd16_g8", dict(B=3, K=2, G=8, S=40, hd=16, pos=[7, 19, 39],
                             strided=False), 0, 0),
            ("strided_gqa", dict(B=4, K=4, G=4, S=200, hd=64,
                                 pos=[0, 50, 150, 199], strided=True), 0, 0),
        ] + [   # split boundaries: at these B * K, chunks of 64 rows
            ("split_pos0", dict(B=2, K=2, G=1, S=1000, hd=128, pos=[0, 0],
                                strided=True), 0, 0),
            ("split_chunk_edges", dict(B=4, K=2, G=2, S=1000, hd=64,
                                       pos=[63, 64, 127, 999],
                                       strided=True), 0, 0),
            ("split_window_skips", dict(B=3, K=2, G=4, S=1000, hd=64,
                                        pos=[99, 640, 999], strided=True),
             100, 0),
            ("split_window_prefix", dict(B=3, K=2, G=4, S=1000, hd=64,
                                         pos=[150, 640, 999],
                                         strided=True), 100, 16),
            ("split_g12", dict(B=2, K=2, G=12, S=1000, hd=32,
                               pos=[500, 999], strided=True), 0, 0),
        ]
        for name, kw, win, pre in dcases:
            args = decode_case(dev, dtype, seed=len(rows), **kw)
            got = ops.decode_attention(*args, window=win, prefix=pre)
            torch.cuda.synchronize()
            want = refs["decode_attention"](*args, window=win, prefix=pre)
            err = check_close(f"decode_attention/{name}", got, want,
                              tol_of(dtype))
            rows.append({"kernel": "decode_attention", "case": name,
                         "dtype": str(dtype), "max_abs_err": err})
            if name == "olmo_decode_strided" or name.startswith("split_"):
                again = ops.decode_attention(*args, window=win, prefix=pre)
                if not torch.equal(got, again):
                    raise AssertionError(f"decode_attention/{name}: two "
                                         "launches differ")
        # (name, shape, the route of bf16 x)
        icases = [(f"m{m}_{k}x{n}", dict(M=m, K=k, N=n, head=False),
                   "skinny_tc" if m <= 16 else "tensor_core")
                  for m in (8, 4096)
                  for k, n in ((2048, 2048), (2048, 8192), (8192, 2048))]
        icases += [
            ("head_m8_2048x50304", dict(M=8, K=2048, N=50304, head=True),
             "skinny_tc"),
            ("m16_8192x2048", dict(M=16, K=8192, N=2048, head=False),
             "skinny_tc"),
            # ragged M, K, N on 16-byte rows
            ("ragged_13x136x208", dict(M=13, K=136, N=208, head=False),
             "skinny_tc"),
            ("head_ragged_5x272x61", dict(M=5, K=272, N=61, head=True),
             "skinny_tc"),
            # K % 8 != 0: unaligned rows
            ("ragged_3x100x77", dict(M=3, K=100, N=77, head=False),
             "skinny"),
            # K % 8 != 0 and N % 16 != 0: unaligned rows
            ("ragged_70x100x77", dict(M=70, K=100, N=77, head=False),
             "cuda_core_tile"),
            ("head_ragged_5x37x61", dict(M=5, K=37, N=61, head=True),
             "skinny"),
        ]
        for name, kw, bf16_route in icases:
            x, wq, sc = int8_case(dev, dtype, q_lib, seed=len(rows), **kw)
            route = int8_route(dtype, kw["M"], bf16_route)
            got = on_route(ops.int8_matmul, route,
                           lambda: ops.int8_matmul(x, wq, sc))
            torch.cuda.synchronize()
            err = check_close(f"int8_matmul/{name}", got,
                              refs["int8_matmul"](x, wq, sc), tol_of(dtype))
            rows.append({"kernel": "int8_matmul", "case": name,
                         "dtype": str(dtype), "route": route,
                         "max_abs_err": err})
            if route == "skinny_tc" and not torch.equal(
                    got, ops.int8_matmul(x, wq, sc)):
                raise AssertionError(f"int8_matmul/{name}: two launches "
                                     "differ")
    # the tensor-core route's edges, bf16 only (seeds of their own, so
    # that the cases above keep theirs): the smallest tile-route M, and
    # ragged M, K, N with 16-byte rows
    for i, (name, kw) in enumerate((
            ("m17_2048x2048", dict(M=17, K=2048, N=2048, head=False)),
            ("ragged_4100x2056x8208", dict(M=4100, K=2056, N=8208,
                                           head=False)))):
        x, wq, sc = int8_case(dev, torch.bfloat16, q_lib, seed=1000 + i,
                              **kw)
        got = on_route(ops.int8_matmul, "tensor_core",
                       lambda: ops.int8_matmul(x, wq, sc))
        torch.cuda.synchronize()
        err = check_close(f"int8_matmul/{name}", got,
                          refs["int8_matmul"](x, wq, sc), 2e-2)
        rows.append({"kernel": "int8_matmul", "case": name,
                     "dtype": str(torch.bfloat16), "route": "tensor_core",
                     "max_abs_err": err})
    return rows


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_timings(dev, ops, refs, q_lib, prefill_shape, int8_m):
    """Time each kernel, its plain version and the library yardstick at
    the main paths' OLMo-1B bf16 shapes, each held against its plain
    version there first: decode over 8 slots with ragged positions up to
    1023 (max_len 1024, pages of 16), the (rows, bucket) prefill
    `prefill_shape` that serve_bf16 dispatched, and the int8 products at
    decode M = 8, the tied head and serve_int8's widest prefill M
    `int8_m`."""
    F = torch.nn.functional
    out = {}
    dt = torch.bfloat16
    pos = olmo_decode_pos(np.random.default_rng(1), 8, 1024)
    n_kv = sum(p + 1 for p in pos)           # valid (slot, position) pairs
    K, G, hd, sz = 16, 1, 128, 2
    kv_bytes = 2 * n_kv * K * hd * sz + 2 * 8 * K * G * hd * sz + 8 * 4
    kv_flops = 4 * n_kv * K * G * hd

    paged_ref = refs["paged_decode_attention"]
    args = paged_case(dev, dt, B=8, K=16, G=1, hd=128, ps=16, pps=64, pos=pos,
                      seed=7)
    err = check_close("paged_decode_attention/timed",
                      ops.paged_decode_attention(*args), paged_ref(*args),
                      tol_of(dt))
    b_ms, b_by = bound(kv_bytes + args[3].numel() * 4, kv_flops, BF16_FLOPS)
    n_split, ppc = ops.paged_decode_attention_splits(8, 16, 64, 16,
                                                     ops._sm_count(dev.index))
    out["paged_decode_attention"] = {
        "shape": "B=8 K=16 G=1 hd=128 ps=16 pps=64 bf16, pos up to 1023",
        "splits": {"n_split": n_split, "pages_per_chunk": ppc},
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.paged_decode_attention(*args)),
        "plain_ms": time_ms(lambda: paged_ref(*args), reps=10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    dec_ref = refs["decode_attention"]
    q, k, v, p = decode_case(dev, dt, B=8, K=16, G=1, S=1024, hd=128, pos=pos,
                             seed=9, strided=True)
    err = check_close("decode_attention/timed", ops.decode_attention(
        q, k, v, p), dec_ref(q, k, v, p), tol_of(dt))
    b_ms, b_by = bound(kv_bytes, kv_flops, BF16_FLOPS)
    # the yardstick: one SDPA call, G = 1 so heads line up, with the
    # ragged boolean mask (B, 1, 1, S)
    mask = (torch.arange(1024, device=dev)[None, :]
            <= p[:, None].long())[:, None, None, :]
    out["decode_attention"] = {
        "shape": "B=8 K=16 G=1 S=1024 hd=128 bf16, (B, S, K, hd) cache "
                 "view, pos up to 1023",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.decode_attention(q, k, v, p)),
        "plain_ms": time_ms(lambda: dec_ref(q, k, v, p), reps=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))}

    flash_ref = refs["flash_attention"]
    (B, S), H = prefill_shape, 16
    q, k, v = flash_case(dev, dt, B=B, H=H, K=16, S=S, hd=128, seed=8)
    got = on_route(ops.flash_attention, "tensor_core",
                   lambda: ops.flash_attention(q, k, v))
    err = check_close("flash_attention/timed", got, flash_ref(q, k, v),
                      tol_of(dt))
    pairs = B * S * (S + 1) // 2             # visible causal (q, k) pairs
    nbytes = 4 * q.numel() * q.element_size()
    b_ms, b_by = bound(nbytes, 4 * H * 128 * pairs, BF16_FLOPS)
    out["flash_attention"] = {
        "shape": f"B={B} H=16 K=16 S={S} hd=128 bf16 causal",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: flash_ref(q, k, v), reps=10),
        "bound_ms": b_ms, "bound_by": b_by,
        # a yardstick only: the port never calls it
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)), "kernel_route": "tensor_core"}
    out["flash_attention"]["vs_library"] = (
        out["flash_attention"]["ms"] / out["flash_attention"]["library_ms"])

    mm_ref = refs["int8_matmul"]
    shapes = []
    for label, M, Kd, N, head, route in (
            # decode at M = n_slots: gate/up, wq/wk/wv/wo, down; the head
            ("decode", 8, 2048, 8192, False, "skinny_tc"),
            ("decode_attn", 8, 2048, 2048, False, "skinny_tc"),
            ("decode_down", 8, 8192, 2048, False, "skinny_tc"),
            ("head", 8, 2048, 50304, True, "skinny_tc"),
            # serve_int8's widest prefill: wq/wk/wv/wo, gate/up, down
            ("prefill_attn", int8_m, 2048, 2048, False, "tensor_core"),
            ("prefill", int8_m, 2048, 8192, False, "tensor_core"),
            ("prefill_down", int8_m, 8192, 2048, False, "tensor_core")):
        x, wq, sc = int8_case(dev, dt, q_lib, M=M, K=Kd, N=N, head=head,
                              seed=10)
        got = on_route(ops.int8_matmul, route,
                       lambda: ops.int8_matmul(x, wq, sc))
        err = check_close(f"int8_matmul/timed_{label}", got,
                          mm_ref(x, wq, sc), tol_of(dt))
        # bytes: int8 weights, x, out (bf16) and the scale, each once;
        # operations at the bf16 tensor-core peak, the rate the card has
        # for this product
        nbytes = Kd * N + (M * Kd + M * N) * 2 + 4 * sc.numel()
        b_ms, b_by = bound(nbytes, 2 * M * Kd * N, BF16_FLOPS)
        w16 = (wq.float() * sc).to(dt)       # dequantized beforehand
        shapes.append({
            "label": label, "shape": f"M={M} K={Kd} N={N} bf16"
            + (" (tied head: embed_q.t(), per-K scale)" if head else ""),
            "kernel_route": route, "max_abs_err": err,
            "ms": time_ms(lambda: ops.int8_matmul(x, wq, sc)),
            "plain_ms": time_ms(lambda: mm_ref(x, wq, sc), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            # a yardstick only: the same product on a bf16 weight
            # dequantized beforehand, twice the weight bytes
            "library_ms": time_ms(lambda: torch.matmul(x, w16))})
        del w16
    for sh in shapes:
        sh["vs_library"] = sh["ms"] / sh["library_ms"]
    out["int8_matmul"] = {**shapes[0], "shapes": shapes}
    return out


def c5_f32_tile_error(dev, ops, q_lib):
    """ROADMAP C5: the f32 int8 product on the CUDA-core tile route and
    f32 cuBLAS (the dequantized weight, TF32 off), each against an f64
    product, at M = 4096 for 2048 -> 8192 and 8192 -> 2048: max |err|,
    max |err| over sum |x||w| (the scale f32 sums err at), and the entries
    beyond atol = rtol = 1e-4 of the f64 product and of each other."""
    rows = []
    for label, M, K, N in (("2048x8192", 4096, 2048, 8192),
                           ("8192x2048", 4096, 8192, 2048)):
        x, wq, sc = int8_case(dev, torch.float32, q_lib, M=M, K=K, N=N,
                              head=False, seed=20)
        tile = on_route(ops.int8_matmul, "cuda_core_tile",
                        lambda: ops.int8_matmul(x, wq, sc))
        w64 = wq.double() * sc.double()
        cublas = torch.matmul(x, w64.float())
        truth = x.double() @ w64
        scale = x.double().abs() @ w64.abs()
        row = {"shape": f"M={M} K={K} N={N} f32", "label": label}
        for name, got in (("tile", tile), ("cublas", cublas)):
            err = (got.double() - truth).abs()
            row[name] = {
                "max_abs_err": float(err.max()),
                "max_err_over_scale": float((err / scale.clamp_min(1e-30))
                                            .max()),
                "beyond_1e-4_of_f64": int((err > 1e-4 + 1e-4
                                           * truth.abs()).sum())}
        d = (tile.double() - cublas.double()).abs()
        row["tile_vs_cublas_beyond_1e-4"] = int(
            (d > 1e-4 + 1e-4 * cublas.double().abs()).sum())
        row["tile_is_outlier"] = (row["tile"]["max_abs_err"]
                                  > 2 * row["cublas"]["max_abs_err"])
        rows.append(row)
        del x, wq, sc, tile, cublas, truth, scale, w64
    emit({"phase": "c5_f32_tile_error", "cases": rows})
    return rows


def plain_timings(dev, ops):
    """The speculative verify's attention, plain PyTorch on the card (no
    kernel; JAX runs it as jnp on every backend), timed at the verify
    shape of the serves: B = 8 slots, Q = spec_draft + 1 = 5, H = 16,
    hd = 128, pages of 16, 64 a slot, bf16, positions up to 1018."""
    pos = olmo_decode_pos(np.random.default_rng(6), 8, 1020)
    _, kp, vp, table, _ = paged_case(dev, torch.bfloat16, B=8, K=16, G=1,
                                     hd=128, ps=16, pps=64,
                                     pos=[x + 4 for x in pos], seed=11)
    q = torch.randn(8, 5, 16, 128, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(12))
    q_pos = (torch.tensor(pos, device=dev)[:, None]
             + torch.arange(5, device=dev)).to(torch.int32)
    n_kv = sum(x + 5 for x in pos)           # (slot, position) pairs read
    nbytes = 2 * n_kv * 16 * 128 * 2 + 2 * q.numel() * 2 + table.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * 5 * n_kv * 16 * 128, BF16_FLOPS)
    ms = time_ms(lambda: ops.paged_suffix_attention(q, kp, vp, table, q_pos),
                 reps=10)
    out = {"paged_suffix_attention": {
        "shape": "B=8 Q=5 H=16 K=16 hd=128 ps=16 pps=64 bf16, positions up "
                 "to 1023", "route": "plain PyTorch",
        "ms": ms, "bound_ms": b_ms, "bound_by": b_by}}
    emit({"phase": "plain_timings", **out})
    return out


# --------------------------------------------------------------------- #
# engine phases

def greedy_recompute(tf, params, cfg, prompt, n):
    """Plain greedy decode: a full forward with plain attention and no
    cache at every step."""
    toks = list(prompt)
    out = []
    for _ in range(n):
        ids = torch.tensor([toks], device=params["embed"].device)
        logits = tf.forward(params, cfg, ids, impl="full")[0, -1]
        nxt = int(logits.argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def parity_f32(dev, ops, cfg=None):
    """The 2-layer f32 model in each decode mode, and int8 in the gather
    mode, against the plain greedy recompute (dense, or on the
    dequantized int8 weights); then the hierarchical KV memory and
    speculation on the dense weights: the prefix cache in the
    paged-attention and gather modes (prompts sharing a 256-token prefix,
    one at a time, then a partial hit), the host swap tier on an
    oversubscribed pool, and speculative decoding on repetitive prompts.
    `cfg` replaces the model (a CPU rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    from repro_torch.serving import quantization as q_lib
    cfg = cfg or dataclasses.replace(ARCHS["olmo-1b"], n_layers=2,
                                     dtype="f32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = build(cfg, dev).init(gen)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (1, 17, 100, 300)]
    shared = rng.integers(0, cfg.vocab, 256).tolist()
    prefix_prompts = [shared + rng.integers(0, cfg.vocab, n).tolist()
                      for n in (20, 37)]
    prefix_prompts.append(shared[:100] + rng.integers(0, cfg.vocab,
                                                      9).tolist())
    # two of these fill the 32-page pool: the second one's growth preempts
    swap_prompts = [rng.integers(0, cfg.vocab, n).tolist()
                    for n in (240, 250, 230, 245)]
    motifs = [rng.integers(0, cfg.vocab, n).tolist() for n in (3, 5, 8, 6)]
    spec_prompts = [(m * (n // len(m) + 1))[:n]
                    for m, n in zip(motifs, (30, 64, 130, 200))]
    dense = [greedy_recompute(tf, params, cfg, p, 16) for p in prompts]
    want_prefix = [greedy_recompute(tf, params, cfg, p, 16)
                   for p in prefix_prompts]
    want_swap = [greedy_recompute(tf, params, cfg, p, 16)
                 for p in swap_prompts]
    want_spec = [greedy_recompute(tf, params, cfg, p, 16)
                 for p in spec_prompts]
    deq = q_lib.dequant_tree(q_lib.quantize_tree(params, 8))
    int8 = [greedy_recompute(tf, deq, cfg, p, 16) for p in prompts]
    del deq
    paged, gather = ({"paged_decode_attention", "flash_attention"},
                     {"decode_attention", "flash_attention"})
    # (mode, engine kwargs, prompts, wants, kernels, serial, check)
    runs = (("paged_attention", dict(paged_attention=True), prompts, dense,
             paged, False, None),
            ("gather", {}, prompts, dense, gather, False, None),
            ("contiguous", dict(paged=False), prompts, dense, gather, False,
             None),
            ("gather_int8", dict(quantize="int8"), prompts, int8,
             gather | {"int8_matmul"}, False, None),
            ("prefix_cache_paged", dict(paged_attention=True,
                                        prefix_cache=True),
             prefix_prompts, want_prefix, paged, True,
             lambda st: st["suffix_prefills"] >= 2),
            ("prefix_cache_gather", dict(prefix_cache=True), prefix_prompts,
             want_prefix, gather, True,
             lambda st: st["suffix_prefills"] >= 2),
            ("swap", dict(kv_pages=32, host_kv_pages=64), swap_prompts,
             want_swap, gather, False,
             lambda st: st["swap_outs"] >= 1
             and st["swap_ins"] == st["swap_outs"]),
            ("speculative", dict(paged_attention=True, speculative=True),
             spec_prompts, want_spec, {"flash_attention"}, False,
             lambda st: st["spec_dispatches"] >= 1))
    lines, mismatches = [], []
    for mode, kw, ps, wants, kernels, serial, check in runs:
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=512, decode_block=4, **kw), device=dev)
        reqs = [Request(model=cfg.name, prompt=p,
                        sampling=SamplingParams(max_tokens=16))
                for p in ps]
        ops.reset_launches()
        for r in reqs:
            assert eng.submit(r)
            if serial:              # each later prompt sees the cache
                eng.run_until_done()
        eng.run_until_done()
        launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        ran = {name for name, n in launched.items() if n}
        if ran != kernels:
            raise AssertionError(f"parity_f32 {mode}: kernels {launched}, "
                                 f"want exactly {sorted(kernels)}")
        st = eng.perf_stats()
        if check is not None and not check(st):
            raise AssertionError(f"parity_f32 {mode}: counters {st}")
        eng.flush_prefix_cache()
        if eng.pool.pages_in_use or (eng.host_pool is not None
                                     and eng.host_pool.in_use):
            raise AssertionError(f"parity_f32 {mode}: pages not returned")
        bad = [{"mode": mode, "prompt_len": len(p), "got": r.output,
                "want": w} for r, p, w in zip(reqs, ps, wants)
               if r.output != w]
        mismatches += bad
        lines.append({"mode": mode, "launches": launched, "match": not bad,
                      **{k: st[k] for k in (
                          "suffix_prefills", "swap_outs", "swap_ins",
                          "spec_dispatches", "spec_emitted", "preemptions")
                         if st[k]}})
        del eng
    gw_lines, gw_bad = parity_gateway(dev, ops, cfg, params, prompts, dense,
                                      gather)
    lines += gw_lines
    mismatches += gw_bad
    emit({"phase": "parity_f32", "layers": cfg.n_layers, "d_model":
          cfg.d_model, "prompt_lens": [len(p) for p in prompts],
          "prefix_prompt_lens": [len(p) for p in prefix_prompts],
          "swap_prompt_lens": [len(p) for p in swap_prompts],
          "spec_prompt_lens": [len(p) for p in spec_prompts],
          "tokens_each": 16, "runs": lines, "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_f32 mismatches: {mismatches}")


def gateway_stack(dev, cfg, params, **demand):
    """The port's control plane over the paper's testbed: every node's
    engines on `dev`, all sharing one parameter tree through the
    param_store (engines do not copy weights already on the device), and
    `cfg` deployed through VRAM-aware placement with real engines (the
    threshold raised above its parameters).  Returns (fleet, controller,
    gateway); every deployed instance must hold an engine on `dev`."""
    from repro_torch.api import Gateway
    from repro_torch.cluster import paper_testbed
    from repro_torch.core import (ControllerConfig, ModelCatalog,
                                  ModelDemand, SDAIController)
    fleet = paper_testbed(param_store=lambda c: params, device=dev)
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(fleet, catalog, ControllerConfig(
        real_param_threshold=cfg.num_params() + 1))
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, **demand)])
    insts = [i for n in fleet.nodes.values() for i in n.instances.values()]
    if plan.unplaced or len(insts) != len(plan.assignments) or any(
            i.engine is None or i.engine.device.type != dev.type
            for i in insts):
        devs = [i.engine and i.engine.device for i in insts]
        raise AssertionError(f"gateway deploy: {plan}, engines on {devs}")
    return fleet, ctrl, Gateway(ctrl)


def parity_gateway(dev, ops, cfg, params, prompts, dense, kernels):
    """The f32 model through the control plane: the paper's testbed, the
    SDAI controller and the Gateway, two replicas on two nodes.  Four
    greedy requests through the serving runtime's pump threads; then,
    hand-pumped, one request whose node is crashed once 2 of its tokens
    have streamed, which must migrate to the other replica (re-admitted
    as prompt + journal by a full prefill).  Both runs' tokens must equal
    the plain recompute `dense`, and each run must launch exactly
    `kernels` (node.deploy's default: the gather decode mode)."""
    from repro_torch.serving import SamplingParams
    fleet, ctrl, gw = gateway_stack(dev, cfg, params, min_replicas=2,
                                    max_replicas=2, n_slots=4, max_len=512,
                                    allow_quant=False)
    lines, bad = [], []

    def run(mode, call):
        ops.reset_launches()
        got, extra = call()
        launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        if {n for n, k in launched.items() if k} != kernels:
            raise AssertionError(f"parity_f32 {mode}: kernels {launched}, "
                                 f"want exactly {sorted(kernels)}")
        miss = [{"mode": mode, "prompt_len": len(p), "got": g, "want": w}
                for p, g, w in got if g != w]
        bad.extend(miss)
        lines.append({"mode": mode, "launches": launched, "match": not miss,
                      **extra})

    def live():
        gw.start()
        hs = [gw.submit(cfg.name, p, SamplingParams(max_tokens=16))
              for p in prompts]
        resps = [h.result(timeout_s=300) for h in hs]
        if not gw.stop(drain=True, timeout_s=120):
            raise AssertionError("parity_f32 gateway: runtime threads alive")
        if not all(r.ok for r in resps):
            raise AssertionError(f"parity_f32 gateway: {resps}")
        return ([(p, list(r.tokens), w) for p, r, w in
                 zip(prompts, resps, dense)],
                {"nodes": sorted({r.node for r in resps})})

    def migration():
        h = gw.submit(cfg.name, prompts[2], SamplingParams(max_tokens=16))
        it = h.stream(timeout_s=300)
        seen = [next(it), next(it)]          # hand-pumped: 2 tokens out
        victim = h.internal.node
        fleet.fail_node(victim)
        rest = list(it)
        r = h.response
        toks = [e.token for e in seen + rest if e.type.value == "token"]
        if not r.ok or r.node == victim or gw.stats.migrations < 1 \
                or toks != list(r.tokens):
            raise AssertionError(f"parity_f32 gateway_migration: {r}, "
                                 f"migrations {gw.stats.migrations}")
        moved = [e.data for e in ctrl.bus.events
                 if e.kind == "request_migrated"]
        return ([(prompts[2], list(r.tokens), dense[2])],
                {"from_node": victim, "to_node": r.node,
                 "tokens_resumed": moved[-1]["tokens_resumed"]})

    run("gateway", live)
    run("gateway_migration", migration)
    for node in fleet.nodes.values():
        for inst in node.instances.values():
            if node.alive and inst.engine.pool.pages_in_use:
                raise AssertionError("parity_f32 gateway: pages held")
    return lines, bad


def serve_setup(dev, cfg=None, params=None, **engine_kw):
    """The main paths' model, engine and 12 seeded requests: the full
    OLMo-1B in bf16 with random weights from a seed; prompt lengths in
    16..896, budgets in 1..64; 10 greedy and 2 sampled requests.
    `engine_kw` picks the decode mode and quantization; `cfg` replaces the
    model (a CPU rehearsal) and `params` its weights.  Also returns the
    weights' bytes."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serving import EngineConfig, InferenceEngine
    from repro_torch.serving.quantization import tree_bytes
    cfg = cfg or ARCHS["olmo-1b"]
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = build(cfg, dev).init(gen)
    dense_bytes = tree_bytes(params)
    ecfg = EngineConfig(n_slots=8, max_len=1024, page_size=16,
                        decode_block=8, **engine_kw)
    eng = InferenceEngine(cfg, params, ecfg, device=dev)
    return cfg, ecfg, eng, lambda: serve_requests(cfg), dense_bytes


def serve_requests(cfg):
    """The main paths' 12 seeded requests: prompt lengths in 16..896,
    budgets in 1..64; 10 greedy and 2 sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(12):
        n = int(rng.integers(16, 897))
        budget = int(rng.integers(1, 65))
        sampled = i in (4, 9)
        sp = SamplingParams(max_tokens=budget,
                            temperature=0.8 if sampled else 0.0,
                            top_k=40 if sampled else 0,
                            top_p=0.95 if sampled else 1.0)
        reqs.append(Request(model=cfg.name,
                            prompt=rng.integers(0, cfg.vocab, n).tolist(),
                            sampling=sp))
    return reqs


def drive(eng, reqs):
    """Submit every request and step the engine until it drains; returns
    (per-step host milliseconds, wall seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        assert eng.submit(r)
    step_ms = []
    while eng.slot_req or eng.scheduler.depth:
        s0 = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        if len(step_ms) > 1000:
            raise AssertionError("the engine did not drain in 1000 steps")
    return step_ms, time.perf_counter() - t0


def expected_launches(cfg, ecfg, st):
    """Each kernel's launches for a serve with these stats: one attention
    kernel per layer per model call, and under int8 one int8 matmul per
    linear (wq, wk, wv, wo, gate, up, down) per layer plus the tied head
    per model call (a full prefill dispatch or a fused decode step).  A
    suffix admission and a speculative verify attend in plain PyTorch and
    launch no attention kernel."""
    n = cfg.n_layers
    # a speculative verify is a decode dispatch that runs no decode kernel
    steps = ecfg.decode_block * (st["decode_dispatches"]
                                 - st["spec_dispatches"])
    paged = st["paged_attention"]
    return {"paged_decode_attention": n * steps if paged else 0,
            "flash_attention": n * st["prefill_dispatches"],
            "decode_attention": 0 if paged else n * steps,
            "int8_matmul": ((7 * n + 1) * (st["prefill_dispatches"] + steps)
                            if ecfg.quantize == "int8" else 0)}


def expected_routes(cfg, ecfg, st, dispatch_shapes):
    """The flash and int8 launches of a bf16 serve by route.  Flash: all
    on the tensor cores.  int8: in a prefill dispatch of (rows, bucket)
    the 7 n_layers projections have M = rows x bucket, on the tensor
    cores when M > 16, and the tied head M = rows; every decode step has
    M = n_slots; M <= 16 (bf16 x, aligned rows) is skinny_tc, and nothing
    is left on the CUDA-core skinny kernels."""
    flash = {"tensor_core": cfg.n_layers * st["prefill_dispatches"],
             "cuda_core": 0}
    int8 = {"skinny": 0, "tensor_core": 0, "cuda_core_tile": 0,
            "skinny_tc": 0}
    if ecfg.quantize == "int8":
        def route(m, wide):
            return "skinny_tc" if m <= 16 else wide
        n = cfg.n_layers
        for rows, bucket in dispatch_shapes:
            int8[route(rows * bucket, "tensor_core")] += 7 * n
            int8[route(rows, "cuda_core_tile")] += 1     # the tied head
        steps = ecfg.decode_block * st["decode_dispatches"]
        int8[route(ecfg.n_slots, "tensor_core")] += 7 * n * steps
        int8[route(ecfg.n_slots, "cuda_core_tile")] += steps
    return {"flash_attention": flash, "int8_matmul": int8}


def serve(phase, dev, ops, card, **engine_kw):
    cfg, ecfg, eng, requests, dense_bytes = serve_setup(dev, **engine_kw)
    reqs = requests()
    # each prefill dispatch's (rows, bucket), for the expected routes
    dispatch_shapes = []
    admit = eng._prefill_admit

    def recording_admit(toks, *args):
        dispatch_shapes.append(tuple(toks.shape))
        return admit(toks, *args)
    eng._prefill_admit = recording_admit
    # the earlier phases' tensors that only the cycle collector frees would
    # otherwise count in this serve's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the path: counters at 0 just before, read just after
    ops.reset_launches()
    step_ms, wall = drive(eng, reqs)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    by_route = {fn.__name__: dict(fn.launches_by_route)
                for fn in (ops.flash_attention, ops.int8_matmul)}
    st = eng.perf_stats()
    check_serve(phase, cfg, ecfg, eng, reqs, launches)
    if eng.pool.pages_in_use != 0:
        raise AssertionError(f"{eng.pool.pages_in_use} pages not returned")
    if len(dispatch_shapes) != st["prefill_dispatches"]:
        raise AssertionError(f"{phase}: {len(dispatch_shapes)} prefill "
                             f"shapes for {st['prefill_dispatches']} "
                             "dispatches")
    want = expected_routes(cfg, ecfg, st, dispatch_shapes)
    if by_route != want:
        raise AssertionError(f"{phase} launches by route {by_route}, "
                             f"want {want}")
    mem = eng.memory_report()
    if ecfg.quantize == "int8" and mem["param_bytes"] >= 0.65 * dense_bytes:
        raise AssertionError(f"{phase}: int8 weights {mem['param_bytes']} B"
                             f", bf16 {dense_bytes} B")
    ttft = sorted(r.ttft for r in reqs)
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.num_params(), "quantize": ecfg.quantize,
          "paged": st["paged"], "paged_attention": st["paged_attention"],
          "requests": len(reqs),
          "prompt_lens": [len(r.prompt) for r in reqs],
          "budgets": [r.sampling.max_tokens for r in reqs],
          "tokens": st["tokens"], "wall_s": wall,
          "tok_per_s": st["tokens"] / wall,
          "p50_step_ms": float(np.median(step_ms)),
          "p50_ttft_ms": float(np.median(ttft)) * 1e3,
          "steps": st["steps"], "dispatches": st["dispatches"],
          "prefill_dispatches": st["prefill_dispatches"],
          "decode_dispatches": st["decode_dispatches"],
          "host_syncs": st["host_syncs"],
          "prefill_traces": st["prefill_traces"],
          "prefill_shapes": st["prefill_shapes"],
          "decode_traces": st["decode_traces"],
          "logical_bytes_moved": st["logical_bytes_moved"],
          "param_bytes": mem["param_bytes"], "bf16_param_bytes": dense_bytes,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          "launches": launches, "launches_by_route": by_route,
          "card": card})
    return launches, by_route, [tuple(s) for s in st["prefill_shapes"]]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev, fn, log):
    """fn wrapped so each call's host milliseconds go into `log`, with the
    stream drained before the call and after it: the call's own time,
    its device work included, none of the work queued before it."""
    def wrapper(*args, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(dev)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def check_serve(phase, cfg, ecfg, eng, reqs, launches):
    """What every serve holds: exact budgets, tokens in the vocabulary,
    the kernel launches its counters imply."""
    budgets = [r.sampling.max_tokens for r in reqs]
    lens = [len(r.output) for r in reqs]
    if lens != budgets or any(r.error for r in reqs):
        raise AssertionError(f"{phase} budgets {budgets} got {lens}")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.output):
        raise AssertionError(f"{phase}: token outside the vocabulary")
    want = expected_launches(cfg, ecfg, eng.perf_stats())
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, want {want}")


def serve_prefix_swap(dev, ops, card, cfg=None, params=None, kv_pages=192):
    """The prefix cache and the host swap tier on the full OLMo-1B (bf16,
    paged attention) with a pool of 192 pages where 8 full slots would
    need 512.  Wave 1: 4 greedy requests of tenant "a", each a shared
    512-token system prefix plus a private tail of 16-256 tokens, drained.
    Wave 2: 6 more of "a" on the same prefix (one sampled) and 2 of "b"
    with private prompts of 64-512 tokens.  Budgets 16-64.  Counters at 0
    just before wave 1, read after wave 2."""
    from repro_torch.serving import Request, SamplingParams
    from repro_torch.serving import engine as engine_mod
    cfg, ecfg, eng, _, _ = serve_setup(
        dev, cfg, params, paged_attention=True, prefix_cache=True,
        host_kv_pages=256, kv_pages=kv_pages)
    rng = np.random.default_rng(4)
    system = rng.integers(0, cfg.vocab, 512).tolist()

    def req(tenant, prompt, sampled=False):
        return Request(model=cfg.name, tenant=tenant, prompt=prompt,
                       sampling=SamplingParams(
                           max_tokens=int(rng.integers(16, 65)),
                           temperature=0.8 if sampled else 0.0,
                           top_k=40 if sampled else 0))

    def tail(lo, hi):
        return rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1))
                            ).tolist()
    wave1 = [req("a", system + tail(16, 256)) for _ in range(4)]
    wave2 = [req("a", system + tail(16, 256), sampled=(i == 3))
             for i in range(6)] + [req("b", tail(64, 512)) for _ in range(2)]
    swap_out_ms, swap_in_ms, admit_ms = [], [], {"suffix": [], "full": []}
    engine_mod.swap_out_slot = timed(dev, engine_mod.swap_out_slot,
                                     swap_out_ms)
    engine_mod.swap_in_slot = timed(dev, engine_mod.swap_in_slot, swap_in_ms)
    shapes = {"suffix": [], "full": []}

    def recording(kind, fn):
        inner = timed(dev, fn, admit_ms[kind])

        def wrapper(toks, *args):
            shapes[kind].append(tuple(toks.shape))
            return inner(toks, *args)
        return wrapper
    eng._suffix_admit = recording("suffix", eng._suffix_admit)
    eng._prefill_admit = recording("full", eng._prefill_admit)
    try:
        gc.collect()
        sync(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        drive(eng, wave1)
        drive(eng, wave2)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    finally:
        from repro_torch.serving import kv_hierarchy
        engine_mod.swap_out_slot = kv_hierarchy.swap_out_slot
        engine_mod.swap_in_slot = kv_hierarchy.swap_in_slot
    st = eng.perf_stats()
    reqs = wave1 + wave2
    check_serve("serve_prefix_swap", cfg, ecfg, eng, reqs, launches)
    seen = {k: st[k] for k in ("suffix_prefills", "swap_outs", "swap_ins",
                               "preemptions", "prefill_dispatches",
                               "prefix_cache")}
    if st["suffix_prefills"] < 6:
        raise AssertionError(f"serve_prefix_swap: want >= 6 suffix "
                             f"prefills: {seen}")
    if st["swap_outs"] < 1 or st["swap_ins"] != st["swap_outs"]:
        raise AssertionError(f"serve_prefix_swap: want >= 1 swap-out and "
                             f"as many swap-ins: {seen}")
    # every parked request came back: the host tier holds only the
    # cache's demoted blocks, and after the flush nothing at all
    if st["swapped_requests"] or \
            eng.host_pool.in_use != st["prefix_cache"]["host_pages"]:
        raise AssertionError(f"serve_prefix_swap: {eng.host_pool.in_use} "
                             f"host pages held: {seen}")
    if eng.flush_prefix_cache()["remaining"] or eng.pool.pages_in_use \
            or eng.host_pool.in_use:
        raise AssertionError(f"{eng.pool.pages_in_use} device and "
                             f"{eng.host_pool.in_use} host pages held after "
                             "the cache flush")
    # one request's prompt by full prefill (the cache flushed), then one
    # sharing its 512-token prefix by suffix admission: the same engine,
    # each timed alone, nothing else in flight
    probe_ms = {}
    for kind, prompt in (("full", system + tail(100, 100)),
                         ("suffix", system + tail(100, 100))):
        before = len(admit_ms[kind])
        drive(eng, [Request(model=cfg.name, tenant="a", prompt=prompt,
                            sampling=SamplingParams(max_tokens=1))])
        probe_ms[kind] = {"ms": admit_ms[kind][before],
                          "rows_x_bucket": shapes[kind][before]}
    eng.flush_prefix_cache()
    ttft2 = sorted(r.ttft for r in wave2)
    emit({"phase": "serve_prefix_swap", "model": cfg.name,
          "layers": cfg.n_layers, "kv_pages": ecfg.kv_pages,
          "host_kv_pages": ecfg.host_kv_pages, "requests": len(reqs),
          "prompt_lens": [len(r.prompt) for r in reqs],
          "budgets": [r.sampling.max_tokens for r in reqs],
          "tokens": st["tokens"], "wall_s": wall,
          "tok_per_s": st["tokens"] / wall,
          "prefill_dispatch_tokens": st["prefill_dispatch_tokens"],
          "suffix_prefills": st["suffix_prefills"],
          "cache_hit_rate": st["cache_hit_rate"],
          "prefix_cache": st["prefix_cache"],
          "swap_outs": st["swap_outs"], "swap_ins": st["swap_ins"],
          "preemptions": st["preemptions"],
          "wave2_p50_ttft_ms": float(np.median(ttft2)) * 1e3,
          "host_ms_per_swap_out": float(np.mean(swap_out_ms)),
          "host_ms_per_swap_in": float(np.mean(swap_in_ms)),
          "swap_out_ms": swap_out_ms, "swap_in_ms": swap_in_ms,
          "suffix_admit_ms": admit_ms["suffix"][:-1],
          "suffix_shapes": shapes["suffix"][:-1],
          "full_prefill_ms": admit_ms["full"][:-1],
          "full_shapes": shapes["full"][:-1],
          "probe_one_row": probe_ms,
          "dispatches": st["dispatches"], "host_syncs": st["host_syncs"],
          "prefill_dispatches": st["prefill_dispatches"],
          "decode_dispatches": st["decode_dispatches"],
          "launches": launches, "card": card})
    return launches


def serve_spec(dev, ops, card, cfg=None, params=None):
    """Speculative decoding on the full OLMo-1B (bf16, paged attention):
    12 requests, 10 greedy with prompts that repeat a random motif to
    128-768 tokens and 2 sampled, budgets 16-64; counters at 0 just before,
    read just after.  The same traffic then runs with speculation off on
    the same weights, for how often the greedy rows agree (bf16 near-ties
    may flip an argmax between the verify's and the decode kernel's
    attention; identity is held in f32 by parity_f32)."""
    from repro_torch.serving import Request, SamplingParams
    out = {}
    for on in (True, False):
        cfg, ecfg, eng, _, _ = serve_setup(
            dev, cfg, params, paged_attention=True, speculative=on)
        params = eng.params
        rng = np.random.default_rng(5)
        reqs = []
        for i in range(12):
            motif = rng.integers(0, cfg.vocab, int(rng.integers(2, 17)))
            n = int(rng.integers(128, 769))
            sampled = i in (3, 8)
            reqs.append(Request(
                model=cfg.name, prompt=np.resize(motif, n).tolist(),
                sampling=SamplingParams(
                    max_tokens=int(rng.integers(16, 65)),
                    temperature=0.8 if sampled else 0.0,
                    top_k=40 if sampled else 0)))
        gc.collect()
        sync(dev)
        ops.reset_launches()
        step_ms, wall = drive(eng, reqs)
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        st = eng.perf_stats()
        check_serve(f"serve_spec (speculative={on})", cfg, ecfg, eng, reqs,
                    launches)
        if eng.pool.pages_in_use:
            raise AssertionError(f"{eng.pool.pages_in_use} pages held")
        out[on] = (reqs, st, launches, wall, step_ms)
        del eng
    reqs, st, launches, wall, step_ms = out[True]
    if st["spec_dispatches"] < 1:
        raise AssertionError("serve_spec: no verify dispatch")
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature == 0]
    agree = sum(reqs[i].output == out[False][0][i].output for i in greedy)
    # a verify emits a slot's base token plus its accepted drafts
    accepted = sum(st["spec_slot_accepted"])
    off = out[False][1]
    emit({"phase": "serve_spec", "model": cfg.name, "layers": cfg.n_layers,
          "requests": len(reqs), "prompt_lens": [len(r.prompt) for r in reqs],
          "budgets": [r.sampling.max_tokens for r in reqs],
          "tokens": st["tokens"], "wall_s": wall,
          "tok_per_s": st["tokens"] / wall,
          "p50_step_ms": float(np.median(step_ms)),
          "spec_dispatches": st["spec_dispatches"],
          "spec_emitted": st["spec_emitted"],
          "tokens_per_verify": st["spec_accepted_per_dispatch"],
          "accepted_drafts_per_slot_verify": accepted / max(
              st["spec_emitted"] - accepted, 1),
          "dispatches_per_token": st["dispatches_per_token"],
          "dispatches_per_token_spec_off": off["dispatches_per_token"],
          "decode_dispatches": st["decode_dispatches"],
          "decode_dispatches_spec_off": off["decode_dispatches"],
          "wall_s_spec_off": out[False][3],
          "greedy_rows_agreeing_with_spec_off": f"{agree}/{len(greedy)}",
          "launches": launches, "card": card})
    return launches


def serve_gateway(dev, ops, card, cfg=None, params=None):
    """The full OLMo-1B (bf16, random weights from a seed, one tree shared
    by every replica) served through the control plane on the paper's
    testbed: `ModelDemand(n_slots=8, max_len=1024, allow_quant=False,
    min_replicas=2)` placed into the nodes' nominal memory, a real engine
    for every replica on the card, the serving runtime's pump threads
    (one per node) stepping them.  serve_bf16's 12 requests come from two
    tenants, all submitted at once through Gateway.submit, each consumed
    through stream() by a thread of its own; once some stream with room
    left in its budget is past its first token, its node is crashed.
    Exact budgets, >= 1 migration, >= 2 serving nodes, every surviving
    engine's pages returned, the launch counts implied by every engine's
    stats (the crashed one's steps and any replica the controller placed
    while serving included), every flash launch on the tensor cores, and
    every runtime thread joined by stop(drain=True)."""
    import threading
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or ARCHS["olmo-1b"]
    if params is None:
        params = build(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(0))
    fleet, ctrl, gw = gateway_stack(dev, cfg, params, min_replicas=2,
                                    n_slots=8, max_len=1024,
                                    allow_quant=False)
    insts = [(n, i) for n in fleet.nodes.values()
             for i in n.instances.values()]
    block = insts[0][1].engine.ecfg.decode_block
    # each deployed engine's steps, (node, start, end), from its pump
    # thread: where the wall clock goes between the engines
    steps = []
    for node, inst in insts:
        def timed_step(step=inst.engine.step, nid=node.node_id):
            t = time.perf_counter()
            out = step()
            steps.append((nid, t, time.perf_counter()))
            return out
        inst.engine.step = timed_step
    reqs = serve_requests(cfg)
    gc.collect()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rt = gw.start()
    threads = rt.threads()
    ops.reset_launches()
    t0 = time.perf_counter()
    handles, submitted = [], []
    for i, r in enumerate(reqs):
        submitted.append(time.perf_counter())
        handles.append(gw.submit(cfg.name, r.prompt, r.sampling,
                                 tenant="ab"[i % 2]))
    arrivals = [[] for _ in handles]

    def consume(i):
        for ev in handles[i].stream(timeout_s=600):
            if ev.type.value == "token":
                arrivals[i].append((time.perf_counter(), ev.index, ev.token))
    consumers = [threading.Thread(target=consume, args=(i,))
                 for i in range(len(handles))]
    for t in consumers:
        t.start()
    victim, crash_at, deadline = None, None, time.monotonic() + 300
    while victim is None and time.monotonic() < deadline:
        for h in handles:
            n = len(h.internal.output)
            if 0 < n and n + 2 * block <= \
                    h.request.sampling.max_tokens and not h.done:
                victim = h.internal.node
                break
        else:
            time.sleep(0.002)
    if victim is None:
        raise AssertionError("serve_gateway: no stream to crash mid-way")
    crash_at = time.perf_counter()
    fleet.fail_node(victim)
    for t in consumers:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    joined = gw.stop(drain=True, timeout_s=120)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    by_route = dict(ops.flash_attention.launches_by_route)
    if any(t.is_alive() for t in consumers) or not joined \
            or any(t.is_alive() for t in threads):
        raise AssertionError("serve_gateway: a thread did not join")
    # the controller may have placed replicas while serving (autoscale on
    # queue pressure, or reallocation below min_replicas); a crashed
    # node keeps its instances, so the union holds every engine that ran
    deployed = len(insts)
    insts += [(n, i) for n in fleet.nodes.values()
              for i in n.instances.values()
              if all(i is not j for _, j in insts)]
    resps = [h.response for h in handles]
    budgets = [r.sampling.max_tokens for r in reqs]
    lens = [len(r.tokens) if r else None for r in resps]
    if lens != budgets or not all(r.ok for r in resps):
        raise AssertionError(f"serve_gateway budgets {budgets} got {lens}: "
                             f"{[r.error for r in resps if not r.ok]}")
    for a, r in zip(arrivals, resps):
        if [(i, t) for _, i, t in a] != list(enumerate(r.tokens)):
            raise AssertionError("serve_gateway: a stream lost or "
                                 "duplicated a token")
    if any(not 0 <= t < cfg.vocab for r in resps for t in r.tokens):
        raise AssertionError("serve_gateway: token outside the vocabulary")
    served = sorted({r.node for r in resps})
    if gw.stats.migrations < 1 or len(served) < 2:
        raise AssertionError(f"serve_gateway: migrations "
                             f"{gw.stats.migrations}, nodes {served}")
    want = dict.fromkeys(launches, 0)
    for node, inst in insts:
        st = inst.engine.perf_stats()
        for k, v in expected_launches(cfg, inst.engine.ecfg, st).items():
            want[k] += v
        if node.alive and inst.engine.pool.pages_in_use:
            raise AssertionError(f"serve_gateway: {node.node_id} holds "
                                 f"{inst.engine.pool.pages_in_use} pages")
    if launches != want or by_route != {
            "tensor_core": want["flash_attention"], "cuda_core": 0}:
        raise AssertionError(f"serve_gateway launches {launches} by route "
                             f"{by_route}, want {want}")
    moved = [e.data for e in ctrl.bus.events if e.kind == "request_migrated"]
    added = []
    for m in moved:
        i = next(k for k, h in enumerate(handles)
                 if h.internal.request_id == m["request_id"])
        after = [t for t, idx, _ in arrivals[i]
                 if idx >= m["tokens_resumed"]]
        if after:
            added.append((min(after) - crash_at) * 1e3)
    # TTFT at the Gateway: submit to the first token event of the stream
    ttft = sorted(a[0][0] - t for a, t in zip(arrivals, submitted))
    tokens = sum(budgets)
    per_node = {nid: sum(r.node == nid for r in resps) for nid in served}
    busy = {}
    for nid, a, b in steps:
        busy[nid] = busy.get(nid, 0.0) + b - a
    # the same requests on one engine of the replicas' configuration,
    # driven directly (no Gateway, no threads): the control plane's share
    from repro_torch.serving import InferenceEngine
    ecfg = insts[0][1].engine.ecfg
    gc.collect()
    direct = InferenceEngine(cfg, params, ecfg, device=dev)
    dreqs = serve_requests(cfg)
    d_step_ms, d_wall = drive(direct, dreqs)
    greedy = [i for i, r in enumerate(reqs) if r.sampling.temperature == 0]
    agree = sum(list(resps[i].tokens) == dreqs[i].output for i in greedy)
    emit({"phase": "serve_gateway", "model": cfg.name,
          "layers": cfg.n_layers, "params": cfg.num_params(),
          "replicas": [(n.node_id, n.klass.name) for n, _ in
                       insts[:deployed]],
          "replicas_placed_while_serving": [
              (n.node_id, n.klass.name) for n, _ in insts[deployed:]],
          "controller_events": [e.kind for e in ctrl.bus.events
                                if e.kind in ("autoscaled_up", "node_dead",
                                              "reallocated",
                                              "instance_deployed")],
          "requests": len(reqs), "budgets": budgets,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
          "p50_ttft_ms": float(np.median(ttft)) * 1e3,
          "requests_per_node": per_node, "crashed": victim,
          "migrations": gw.stats.migrations,
          "stream_retries": gw.stats.stream_retries,
          "migrated_added_ttft_ms": added,
          "prefill_dispatches": sum(i.engine.prefill_dispatches
                                    for _, i in insts),
          "decode_dispatches": sum(i.engine.decode_dispatches
                                   for _, i in insts),
          "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None),
          "nominal_hbm_used_bytes": {n.node_id: n.hbm_used
                                     for n in fleet.nodes.values()
                                     if n.instances},
          "engine_steps": len(steps),
          "p50_engine_step_ms": float(np.median(
              [(b - a) * 1e3 for _, a, b in steps])),
          "engine_busy_s_by_node": busy,
          "engines_stepping_on_average": sum(busy.values()) / wall,
          "direct_one_engine": {
              "decode_block": ecfg.decode_block, "wall_s": d_wall,
              "tok_per_s": tokens / d_wall,
              "p50_step_ms": float(np.median(d_step_ms)),
              "p50_ttft_ms": float(np.median(
                  [r.ttft for r in dreqs])) * 1e3,
              "greedy_rows_agreeing": f"{agree}/{len(greedy)}"},
          "launches": launches, "launches_by_route": by_route,
          "card": card})
    return launches


# --------------------------------------------------------------------- #
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.int8_matmul import int8_matmul_ref
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_ref)
    from repro_torch.serving import quantization as q_lib
    refs = {"paged_decode_attention": paged_decode_attention_ref,
            "flash_attention": flash_attention_ref,
            "decode_attention": decode_attention_ref,
            "int8_matmul": int8_matmul_ref}
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "kind": kind, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = ops.build()
    ptxas = {}
    for name, path in libs.items():
        log = (path.parent / f"{name}.log").read_text()
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers") and w.isdigit()]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        ptxas[name] = {"max_registers": max(regs or [0]),
                       "spilling": spills[:4]}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(ops.build_dir().relative_to(ROOT)), "ptxas": ptxas})

    rows = kernel_checks(dev, ops, refs, q_lib)
    emit({"phase": "kernel_checks", "cases": rows})

    parity_f32(dev, ops)
    bf16_launches, bf16_routes, bf16_shapes = serve(
        "serve_bf16", dev, ops, card, paged_attention=True)
    int8_launches, int8_routes, int8_shapes = serve(
        "serve_int8", dev, ops, card, quantize="int8")
    path_launches = {"serve_bf16": bf16_launches, "serve_int8": int8_launches,
                     "serve_prefix_swap": serve_prefix_swap(dev, ops, card),
                     "serve_spec": serve_spec(dev, ops, card),
                     "serve_gateway": serve_gateway(dev, ops, card)}
    gc.collect()
    # the prefill whose attention did the most work: rows x bucket^2; the
    # widest int8 product: rows x bucket
    widest = max(bf16_shapes, key=lambda s: s[0] * s[1] ** 2)
    int8_m = max(r * b for r, b in int8_shapes)
    timings = kernel_timings(dev, ops, refs, q_lib, widest, int8_m)
    c5_f32_tile_error(dev, ops, q_lib)
    plain_timings(dev, ops)
    meta = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/paged_attention.py:239", "serve_bf16"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:113", "serve_bf16"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:131", "serve_int8"),
        "int8_matmul": (
            "src/repro_torch/kernels/csrc/int8_matmul.cu",
            "src/repro/kernels/int8_matmul.py:58", "serve_int8"),
    }
    path_routes = {"serve_bf16": bf16_routes, "serve_int8": int8_routes}
    kernels = []
    for name, (source, replaces, path) in meta.items():
        t = timings[name]
        launches = path_launches[path][name]
        if launches == 0:
            raise AssertionError(f"{name} never ran on {path}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "path": path, "max_abs_err": t["max_abs_err"],
                        "ms": t["ms"], "kernel_ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        "launches_by_path": {ph: ln[name] for ph, ln
                                             in path_launches.items()},
                        **({"launches_by_route": path_routes[path][name]}
                           if name in path_routes[path] else {}),
                        **({"shapes": t["shapes"]} if "shapes" in t else {}),
                        **({"splits": t["splits"]} if "splits" in t else {}),
                        "card": card})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
