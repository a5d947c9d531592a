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
              bit-identical output over two launches.  Then head_dim 256
              at gemma's shapes (gemma3-1b: G = 4 over 1 KV head, window
              512; gemma3-4b: G = 2, window 1024, 256 prefix tokens): the
              three attention kernels with pos 0, pos on a chunk edge and
              a window that skips whole chunks, the split kernels twice
              bit for bit, and the int8 matmul at gemma3-1b's gelu
              shapes (K 1152, N 6912 / 1024 / 256, down 6912 -> 1152,
              the tied head 1152 -> 262144).  Then the MoE models'
              groups: G = 3 at hd 64 (granite) and G = 6 at hd 128
              (mixtral, window 4096) in the three attention kernels
              (pos 0 and either side of the chunk edges, the split
              kernels twice bit for bit), and the int8 matmul at
              granite's 1536 -> 1536 and 1536 -> 512 (M 8 and 4096) and
              its tied head 1536 -> 49155.  Then hymba-1.5b's: G = 5 at
              hd 64 over 5 KV heads with its 128 meta tokens as the
              prefix, in both decode kernels at max_len 4096 (window 2048
              and 0; pos 0, either side of a chunk edge and of window +
              prefix; twice bit for bit) and in flash (H 25, S 128 +
              2400, window 2048); the int8 matmul at its products (1600
              -> 1600 / 320 / 3200 / 5504, 5504 -> 1600, the untied head
              1600 -> 32001 on the CUDA-core routes) at M 8 and 1024.
              Then seamless-m4t-large-v2's decoder self-attention: G = 1
              at hd 64 over 16 KV heads (B * K = 128) in both decode
              kernels (pos 0, either side of two chunk edges, the cache
              end; twice bit for bit) and its causal prefill in flash
              (H 16, S 1024 and a ragged 300).
              Last, ROADMAP C5: the f32 int8 product at M = 4096, 8192 ->
              2048 on four seeds against the f64 product within the f32
              summation bound (K + 4) u sum |x||w|.
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
              other replica; then over HTTP, on llama3.2-1b cut to 2
              layers at full width in f32 (G = 4, head_dim 64, RMS-norm
              scales from a seed): 4 greedy completions with token-id
              prompts, two streamed; then gemma3-1b and gemma3-4b cut to
              2 layers at full width in f32 (parity_gemma: prompts of
              600-900 tokens past gemma3-1b's window of 512, in the
              paged-attention and gather modes; gemma3-4b in the gather
              mode with its 256 prefix tokens).  Each run's tokens must
              equal a plain greedy recompute on the card (full forward,
              plain attention, no cache, every step; for int8 on the
              dequantized weights), and each must launch exactly its
              mode's kernels (the Gateway's: flash and decode attention,
              node.deploy's default gather mode); the recompute applies
              the window and feeds a vision model zero prefix
              embeddings, as the engine does.
   parity_moe — granite-moe-3b-a800m cut to 2 layers at full width
              (40 experts top-8, G = 3) in f32: 4 greedy requests in the
              paged-attention and gather modes and in the gather mode
              under int8, each held against a cached plain recompute
              (prefill at the bucket the engine's admission used, then
              one decode step a token, plain attention): a full forward
              would route the prompt at another MoE capacity.  It
              prints the (token, expert) pairs the admissions dropped.
   parity_hymba — hymba-1.5b cut to 4 layers at full width (layer 0
              global, 128 meta tokens, window 2048, G = 5) in f32, max_len
              4096: prompts of 10, 700, 2300 and 3000 tokens in the
              paged-attention and gather modes and in the gather mode
              under int8, each held against greedy_recompute (a family
              admitted at its exact length has a true recompute), each
              admission holding rows of one length; then two requests
              through the host swap tier (>= 1 swap-out) equal to the
              same requests on a pool with room (the SSM state rides in
              the swap handle).
   parity_xlstm — the paper's xlstm-125m at full width and depth (6
              pairs of an mLSTM and an sLSTM block, d 768, vocab 50304
              tied) in f32: prompts of 5, 300, 640 and 900 tokens at
              decode_block 8 in the contiguous mode, through a
              paged-attention config (which serves contiguous: nothing to
              page, as in JAX) and under int8, each request's tokens
              equal to greedy_recompute (xLSTM's full forward), one exact
              length an admission, the launches exact (none; int8: 7 x 6
              + 1 products a model call).
   parity_encdec — seamless-m4t-large-v2 at full width cut to 2 encoder
              and 2 decoder layers, f32, max_len 1024: prompts of 10-900
              tokens in the paged-attention, gather and contiguous modes
              and under int8, and a two-request swap leg, each equal to
              greedy_recompute (the engine and the recompute feed the
              encoder zero frames: the cross-attention adds exactly 0,
              ROADMAP C17), launches exact (non-causal flash for the
              encoder and the cross-attention, counted on their own; the
              decode kernel for the cross-attention in every mode); then,
              with random frames, the model's prefill (2 rows of 300 over
              1024 frames) and 8 decode steps on the kernels against the
              same calls on the plain versions within f32's 1e-4 (the
              only run where the cross path carries values).
   parity_train — the trainer's numerics on the card against the port's
              CPU path (itself held against JAX by the CPU tests):
              OLMo-1B at full width cut to 2 of 16 layers and the full
              xlstm-125m (6 pairs), f32, one batch of 2 x 128 tokens:
              the loss under remat within 1e-5 relative, every gradient
              leaf within 1e-4 of its largest magnitude (xLSTM's b_i
              against w_i's, see tests/test_torch_loss.py), one AdamW
              step from the same gradients within 1e-6 on both devices,
              no kernel launched (training attends in plain PyTorch).
   kv_quant — the int8 KV cache on OLMo-1B: 2 layers in f32, 8 prompts
              of 1000 tokens into a cache of 1024, 8 teacher-forced
              decode steps, the card within f32's 1e-4 of the CPU and
              within 0.05 of the f32 cache's logit scale (argmax
              agreement printed), the decode kernel n_layers times a
              step over the dequantized f32 cache; then the full 16
              layers in bf16 for the KV bytes (< 0.6 x the bf16 cache)
              and the step's host ms; then the decode kernel's f32 route
              timed at that shape (its row joins the kernels line's
              decode_attention "shapes").
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
10. serve_gemma — the paper's gemma3-1b at full width and depth (26
              layers, hd 256, window 512, G = 4, gelu, vocab 262144),
              bf16, seeded weights, paged attention, under serve_bf16's
              EngineConfig and requests; then gemma3-4b (34 layers, hd
              256, window 1024, G = 2, 256 vision prefix tokens) in the
              gather mode, prompts capped so that prompt + 256 + budget
              <= 1024.  Held as serve_bf16 is; each serve also prints
              what placement charges such an instance (instance_bytes,
              with the engine's page budget and with none) beside the
              engine's memory_report.
11. serve_http — the launcher's own `build_service` (python -m
              repro_torch.api.http) in-process with its defaults: the
              paper's full llama3.2-1b (G = 4, head_dim 64) and
              gemma3-1b (G = 4, head_dim 256, window 512), bf16, seeded
              weights,
              two real replicas each on the paper's testbed, behind the
              OpenAI-compatible HTTP service.  16 requests from three
              tenants on three keep-alive clients (chat and token-id
              completions, greedy and sampled, streamed and not), a
              cancelled stream (499), a prompt past the context (400),
              a tenant past its bucket (429); the same greedy requests
              in-process through Gateway.generate_batch (the wire tax);
              server.stop() with a stream in flight.  Exact budgets,
              streams contiguous and equal to their usage, caller_pumps
              0, >= 2 nodes for each model, every page returned, launches
              summed over the engines exactly what their stats imply (all
              flash "tensor_core"), every thread joined (see the
              function).  It prints tok/s, p50 / p95 TTFT over the wire
              and in-process, the latency the wire adds to a
              non-streamed request (the client's less the Gateway's),
              requests per model and node, the drain's
              seconds, peak device bytes and the greedy rows equal on
              both sides (bf16: informational).
10b. serve_moe — the MoE FFN in every engine path: the paper's
              granite-moe-3b-a800m at full width and depth (32 layers,
              40 experts top-8, 3.30 B params, bf16, seeded weights)
              under serve_bf16's engine and requests in the
              paged-attention mode and under int8 in the gather mode
              (experts int8 at rest, dequantized a layer at a time: the
              int8 kernel runs (4 n_layers + 1) x model calls), then
              through serve_prefix_swap and serve_spec; mixtral-8x22b
              at full width cut to 2 of its 56 layers (8 experts top-2,
              window 4096, 10.8 GB) in the gather mode.  Each leg is
              held as its phase holds OLMo and prints tok/s, p50 step,
              TTFT, peak device memory and the share of admission pairs
              dropped.
10c. serve_hymba — the paper's hymba-1.5b at full width and depth (32
              layers, 1.31 B params, bf16, seeded weights): serve_bf16's
              engine and requests (prompts capped at 832, so that
              prompt + 128 meta + budget <= 1024) in the paged-attention
              mode, then under int8 in the gather mode, then at max_len
              4096 in the paged-attention mode with 4 prompts of
              2100-3500 tokens where the window masks.  Each leg is held
              as serve_bf16 is, its routes exact (the untied head's
              32001-byte rows on "skinny") and every prefill admission a
              group of one exact length.
10d. serve_xlstm — the paper's xlstm-125m at full width and depth, bf16,
              seeded weights, serve_bf16's engine and 12 requests in the
              contiguous mode, then under int8 (a gather config, which
              serves contiguous): exact budgets, one exact length an
              admission, launches and routes exact (int8 only: 7 x 6 + 1
              a model call), placement's charge equal to the engine's
              bytes (the seven f32 state leaves).
10e. serve_seamless — the paper's seamless-m4t-large-v2 at full width
              and depth (24 + 24 layers, d 1024, gelu d_ff 8192, vocab
              256206 untied, 1.63 B params), bf16, seeded weights,
              serve_bf16's engine and requests in the paged-attention
              mode, the gather mode and the gather mode under int8: the
              cross K/V (805 MB) slot-resident; exact budgets and pages;
              flash 24 causal and 48 non-causal launches a prefill
              dispatch (counted on their own), the decode kernel 24 a
              decode step for the cross-attention even in the paged leg,
              the untied head's 256206-byte rows on "skinny"; the charge
              equal to the engine's bytes, cross K/V included.  Then the
              swap tier at full width (seamless_swap_leg: two requests on
              64 pages, each swap moving the slot's 100.7 MB of cross
              K/V beside its pages; the host ms of each swap).
12. launcher — `python -m repro_torch.api.http --port 0` as a process
              of its own: /healthz and /v1/models list both models, one
              streamed chat ends in `data: [DONE]`, and SIGINT makes it
              print "draining..." and exit 0 within 60 s.
12b. train_xlstm — repro_torch/examples/train_100m.py's code path on the
              full xlstm-125m (its settings: batch 4, seq 64, 60 steps,
              lr 6e-4, warmup 10): the last logged loss below the first;
              then its --crash-at 30 leg equal to the uninterrupted run
              bit for bit (params, moments, step); step ms p50 and the
              checkpoint's save and restore seconds.
12c. train_olmo — the full OLMo-1B (bf16 params, f32 moments, remat),
              4 x 1024 tokens a step, 8 steps then 4 with int8 gradient
              compression: every loss finite, the last below the first;
              step ms p50, tokens/s, the model-FLOP rate (6 N D) as a
              share of the data-sheet 989 TFLOP/s, peak memory, state
              bytes.
13. kernels — per kernel: its launches on the path that runs it (and on
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
              ("vs_library"); the three attention kernels also at the
              zoo's grouped-query shapes (SERVED_GQA: llama3.2-1b,
              qwen3-1.7b, gemma3-1b, gemma3-4b, and the served MoE,
              hymba and seamless shapes; their "shapes", with SDPA's
              enable_gqa as the yardstick, under the window's boolean
              mask where there is one; the gemmas' rows carry their
              launches on serve_gemma, the others' on their serve).  Before the
              line: c5_f32_tile_error (the
              f32 CUDA-core int8 tile and f32 cuBLAS against f64 at
              M = 4096) and plain_timings (the verify's plain paged
              attention at the serves' verify shape), and moe_timings
              (the int8 products at granite's shapes, and one MoE FFN
              layer against its dense-masked plain version and its
              bound at granite's decode and widest prefill and
              mixtral's decode), and hymba_timings (the int8 products at
              hymba-1.5b's shapes, and its plain SSM branch: one layer's
              decode step, one layer's selective scan over 2048 tokens),
              xlstm_timings (the int8 products at xlstm-125m's shapes;
              its plain cells: one pair's decode step over 8 slots, one
              pair's chunkwise mLSTM and sLSTM scan over 896 tokens) and
              the encoder-decoder's rows in the kernels' "shapes" (flash
              non-causal at the encoder's B=4 H=16 S=1024 hd=64 and at
              serve_seamless' widest cross prefill over 1024 frames, the
              decode kernel at the cross shape B=8 K=16 S=1024 with every
              position valid, each against unmasked SDPA; the int8
              products at seamless's shapes, its head on "skinny").
              The line also asserts every kernel ran on serve_seamless
              (flash non-causal among its launches) and int8 on
              serve_xlstm.
              The line asserts every kernel ran on serve_moe and on
              serve_hymba; the attention kernels' rows at the MoE,
              hymba and seamless shapes (hymba at S = 4096, flash at 128
              + 2400) carry their serve_moe / serve_hymba /
              serve_seamless launches.
              Each serve also holds placement's charge with the
              engine's page budget (cluster/node.py instance_bytes)
              equal to every byte the engine's memory_report counts
              (ROADMAP C14).

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import shutil
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
F32_FLOPS = 67e12           # outside the tensor cores
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


# gemma's decode positions: pos 0, either side of a chunk edge (chunks of
# 64 rows at B * K = 8), either side of the window of 512, the cache end
GEMMA_POS = [0, 63, 64, 511, 512, 700, 1000, 1023]
# the MoE models' (B 8 x K 8: chunks of 128 rows, of 8 pages of 16): pos 0,
# either side of two chunk edges, the cache end
MOE_POS = [0, 127, 128, 255, 256, 700, 1000, 1023]
# hymba-1.5b's at max_len 4096 (B 8 x K 5: chunks of 320 rows, of 20 pages
# of 16): pos 0, either side of a chunk edge, either side of the window of
# 2048 past the 128 meta tokens, the cache end
HYMBA_POS = [0, 319, 320, 2175, 2176, 2177, 3000, 4095]
# hymba-1.5b's int8 products (K -> N): wq, wk / wv, w_in (u and z), gate /
# up, down, and the untied head, whose row of 32001 bytes is not a whole
# number of 16-byte vectors (the CUDA-core routes)
HYMBA_INT8 = ((1600, 1600), (1600, 320), (1600, 3200), (1600, 5504),
              (5504, 1600), (1600, 32001))
# seamless-m4t-large-v2's decoder self-attention at serve_seamless' max_len
# 1024 (B 8 x K 16: chunks of 256 rows, of 16 pages of 16): pos 0, either
# side of two chunk edges, the cache end
SEAMLESS_POS = [0, 255, 256, 511, 512, 700, 1000, 1023]


def kernel_checks(dev, ops, refs, q_lib):
    """Every kernel against its plain version; returns the rows."""
    flash_ref = refs["flash_attention"]
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
        ] + [   # hd 256 at gemma's shapes (SERVED_GQA), split as served
            ("split_gemma3-1b", dict(B=8, K=1, G=4, hd=256, ps=16, pps=64,
                                     pos=GEMMA_POS), 512, 0),
            ("split_gemma3-4b", dict(B=8, K=4, G=2, hd=256, ps=16, pps=64,
                                     pos=GEMMA_POS), 1024, 256),
            ("split_gemma3-4b_window_bites", dict(
                B=4, K=4, G=2, hd=256, ps=16, pps=100,
                pos=[0, 300, 1599, 1100]), 1024, 256),
            ("split_hd256_holes", dict(B=2, K=1, G=4, hd=256, ps=8, pps=32,
                                       pos=[200, 255], kind="holes"), 0, 0),
        ]
        check_paged(dev, ops, refs, dtype, cases, rows)
        fcases = [
            ("olmo_prefill", dict(B=1, H=16, K=16, S=1024, hd=128), 0, 0),
            ("gqa_h8_k2", dict(B=2, H=8, K=2, S=256, hd=64), 0, 0),
            ("window_prefix", dict(B=1, H=4, K=2, S=256, hd=64), 48, 16),
            ("hd16_ragged", dict(B=2, H=4, K=4, S=200, hd=16), 0, 0),
            ("ragged_1000", dict(B=1, H=16, K=16, S=1000, hd=128), 0, 0),
            ("gemma3-1b_prefill", dict(B=1, H=4, K=1, S=1024, hd=256), 512,
             0),
            ("gemma3-4b_prefill", dict(B=1, H=8, K=4, S=1280, hd=256), 1024,
             256),
            ("hd256_ragged", dict(B=2, H=4, K=2, S=300, hd=256), 40, 8),
        ]
        check_flash(dev, ops, refs, dtype, fcases, rows)
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
            ("split_gemma3-1b", dict(B=8, K=1, G=4, S=1024, hd=256,
                                     pos=GEMMA_POS, strided=True), 512, 0),
            ("split_gemma3-4b", dict(B=8, K=4, G=2, S=1024, hd=256,
                                     pos=GEMMA_POS, strided=True), 1024, 256),
            ("split_gemma3-4b_window_bites", dict(
                B=4, K=4, G=2, S=1400, hd=256, pos=[0, 300, 1399, 1100],
                strided=True), 1024, 256),
        ]
        check_decode(dev, ops, refs, dtype, dcases, rows)
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
        # gemma3-1b's gelu shapes: wq 1152 -> 1024, wk / wv -> 256, wi
        # -> 6912, wo 1024 -> 1152, down 6912 -> 1152, the tied head
        icases += [(f"gemma3-1b_m{m}_{k}x{n}", dict(M=m, K=k, N=n,
                                                    head=False),
                    "skinny_tc" if m <= 16 else "tensor_core")
                   for m in (8, 4096)
                   for k, n in ((1152, 1024), (1152, 256), (1152, 6912),
                                (1024, 1152), (6912, 1152))]
        icases.append(("gemma3-1b_head_m8_1152x262144",
                       dict(M=8, K=1152, N=262144, head=True), "skinny_tc"))
        check_int8(dev, ops, refs, q_lib, dtype, icases, rows)
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
    # the MoE models' shapes (seeds of their own, from 2000, so that the
    # cases above keep theirs): granite's G = 3 at hd 64 and mixtral's
    # G = 6 at hd 128 (window 4096) in the three attention kernels, pos
    # 0 and either side of two chunk edges, the split kernels twice bit
    # for bit; the int8 matmul at granite's attention projections (wq /
    # wo 1536 -> 1536, wk / wv 1536 -> 512) at decode and prefill M and
    # its tied head's odd N (the experts stay off the kernel)
    for dtype in (torch.bfloat16, torch.float32):
        check_paged(dev, ops, refs, dtype, [
            ("split_granite", dict(B=8, K=8, G=3, hd=64, ps=16, pps=64,
                                   pos=MOE_POS), 0, 0),
            ("split_mixtral", dict(B=8, K=8, G=6, hd=128, ps=16, pps=64,
                                   pos=MOE_POS), 4096, 0)], rows, 2000)
        check_flash(dev, ops, refs, dtype, [
            ("granite_prefill", dict(B=4, H=24, K=8, S=1024, hd=64), 0, 0),
            ("granite_ragged", dict(B=2, H=24, K=8, S=300, hd=64), 0, 0),
            ("mixtral_prefill", dict(B=1, H=48, K=8, S=1024, hd=128), 4096,
             0)], rows, 2000)
        check_decode(dev, ops, refs, dtype, [
            ("split_granite", dict(B=8, K=8, G=3, S=1024, hd=64,
                                   pos=MOE_POS, strided=True), 0, 0),
            ("split_mixtral", dict(B=8, K=8, G=6, S=1024, hd=128,
                                   pos=MOE_POS, strided=True), 4096, 0)],
            rows, 2000)
        icases = [(f"granite_m{m}_{k}x{n}", dict(M=m, K=k, N=n, head=False),
                   "skinny_tc" if m <= 16 else "tensor_core")
                  for m in (8, 4096) for k, n in ((1536, 1536), (1536, 512))]
        icases.append(("granite_head_m8_1536x49155",
                       dict(M=8, K=1536, N=49155, head=True), "skinny_tc"))
        check_int8(dev, ops, refs, q_lib, dtype, icases, rows, 2000)
    # hymba-1.5b's shapes (seeds from 3000): G = 5 at hd 64 over 5 KV
    # heads, 128 meta tokens exempt from a window of 2048 and the global
    # layers' window 0, in the three attention kernels at max_len 4096
    # (the split kernels twice bit for bit); the int8 matmul at its
    # products, M 8 and 1024
    for dtype in (torch.bfloat16, torch.float32):
        check_paged(dev, ops, refs, dtype, [
            (f"split_hymba_window{w}", dict(B=8, K=5, G=5, hd=64, ps=16,
                                            pps=256, pos=HYMBA_POS), w, 128)
            for w in (2048, 0)], rows, 3000)
        check_flash(dev, ops, refs, dtype, [
            ("hymba_prefill", dict(B=1, H=25, K=5, S=128 + 2400, hd=64),
             2048, 128)], rows, 3000)
        check_decode(dev, ops, refs, dtype, [
            (f"split_hymba_window{w}", dict(B=8, K=5, G=5, S=4096, hd=64,
                                            pos=HYMBA_POS, strided=True),
             w, 128) for w in (2048, 0)], rows, 3000)
        icases = [(f"hymba_m{m}_{k}x{n}", dict(M=m, K=k, N=n, head=False),
                   ("skinny_tc" if m <= 16 else "tensor_core")
                   if n % 16 == 0 else
                   ("skinny" if m <= 16 else "cuda_core_tile"))
                  for m in (8, 1024) for k, n in HYMBA_INT8]
        check_int8(dev, ops, refs, q_lib, dtype, icases, rows, 3000)
    # seamless-m4t-large-v2's decoder self-attention (seeds from 5000): G = 1
    # at hd 64 over 16 KV heads, B * K = 128, with ragged positions in the
    # split kernels (twice bit for bit), and its causal prefill in flash
    for dtype in (torch.bfloat16, torch.float32):
        check_paged(dev, ops, refs, dtype, [
            ("split_seamless", dict(B=8, K=16, G=1, hd=64, ps=16, pps=64,
                                    pos=SEAMLESS_POS), 0, 0)], rows, 5000)
        check_flash(dev, ops, refs, dtype, [
            ("seamless_prefill", dict(B=4, H=16, K=16, S=1024, hd=64), 0, 0),
            ("seamless_ragged", dict(B=2, H=16, K=16, S=300, hd=64), 0, 0)],
            rows, 5000)
        check_decode(dev, ops, refs, dtype, [
            ("split_seamless", dict(B=8, K=16, G=1, S=1024, hd=64,
                                    pos=SEAMLESS_POS, strided=True), 0, 0)],
            rows, 5000)
    c5_seeds(dev, ops, q_lib, rows)
    return rows


C5_SEEDS = range(4000, 4004)


def c5_seeds(dev, ops, q_lib, rows):
    """ROADMAP C5: the f32 int8 product at M = 4096, 8192 -> 2048 (the
    CUDA-core tile route) on several seeds, each held against the f64
    product within what f32 summation can err by in any order, (K + 4) u
    sum |x||w| per entry (u = 2^-24, with a 1% margin): a wrong tile or a
    lost chunk errs by O(sum |x||w|) on any seed, the f32 sums meeting
    by ~1e-6 of it.  The existing f32 case `int8_matmul/m4096_8192x2048`
    is held against the f32 product as before."""
    M, K, N = 4096, 8192, 2048
    for seed in C5_SEEDS:
        x, wq, sc = int8_case(dev, torch.float32, q_lib, M=M, K=K, N=N,
                              head=False, seed=seed)
        got = on_route(ops.int8_matmul, "cuda_core_tile",
                       lambda: ops.int8_matmul(x, wq, sc))
        w64 = wq.double() * sc.double()
        err = (got.double() - x.double() @ w64).abs()
        lim = 1.01 * (K + 4) * 2.0 ** -24 * (x.double().abs() @ w64.abs())
        ratio = float((err / lim.clamp_min(1e-300)).max())
        if not bool(torch.isfinite(got).all()) or ratio > 1.0:
            raise AssertionError(f"int8_matmul/c5_seed{seed}: error "
                                 f"{ratio:.3e} of the f32 summation bound")
        rows.append({"kernel": "int8_matmul",
                     "case": f"c5_m{M}_{K}x{N}_seed{seed}",
                     "dtype": str(torch.float32), "route": "cuda_core_tile",
                     "max_abs_err": float(err.max()),
                     "max_err_over_bound": ratio})
        del x, wq, sc, got, w64, err, lim


def check_paged(dev, ops, refs, dtype, cases, rows, seed0=0):
    """Each (name, shape, window, prefix) case of the paged kernel against
    its plain version (seed seed0 + rows so far), appended to `rows`; the
    OLMo case and the split_ cases launch twice, bit for bit."""
    for name, kw, win, pre in cases:
        args = paged_case(dev, dtype, seed=seed0 + len(rows), **kw)
        got = ops.paged_decode_attention(*args, window=win, prefix=pre)
        torch.cuda.synchronize()
        want = refs["paged_decode_attention"](*args, window=win, prefix=pre)
        err = check_close(f"paged_decode_attention/{name}", got, want,
                          tol_of(dtype))
        rows.append({"kernel": "paged_decode_attention", "case": name,
                     "dtype": str(dtype), "max_abs_err": err,
                     "splits": ops.paged_decode_attention_splits(
                         kw["B"], kw["K"], kw["pps"], kw["ps"],
                         ops._sm_count(dev.index))})
        if name == "olmo_decode" or name.startswith("split_"):
            again = ops.paged_decode_attention(*args, window=win, prefix=pre)
            if not torch.equal(got, again):
                raise AssertionError(f"paged_decode_attention/{name}: two "
                                     "launches differ")


def check_flash(dev, ops, refs, dtype, cases, rows, seed0=0):
    """Each causal case of the flash kernel against its plain version, on
    the dtype's route."""
    for name, kw, win, pre in cases:
        q, k, v = flash_case(dev, dtype, seed=seed0 + len(rows), **kw)
        got = on_route(ops.flash_attention, flash_route(dtype),
                       lambda: ops.flash_attention(
                           q, k, v, causal=True, window=win, prefix=pre))
        torch.cuda.synchronize()
        want = refs["flash_attention"](q, k, v, causal=True, window=win,
                                       prefix=pre)
        err = check_close(f"flash_attention/{name}", got, want,
                          tol_of(dtype))
        rows.append({"kernel": "flash_attention", "case": name,
                     "dtype": str(dtype), "route": flash_route(dtype),
                     "max_abs_err": err})


def check_decode(dev, ops, refs, dtype, cases, rows, seed0=0):
    """Each case of the decode kernel against its plain version; the OLMo
    case and the split_ cases launch twice, bit for bit."""
    for name, kw, win, pre in cases:
        args = decode_case(dev, dtype, seed=seed0 + len(rows), **kw)
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


def check_int8(dev, ops, refs, q_lib, dtype, cases, rows, seed0=0):
    """Each (name, shape, route of bf16 x) case of the int8 matmul against
    its plain version, on its route; skinny_tc twice, bit for bit."""
    for name, kw, bf16_route in cases:
        x, wq, sc = int8_case(dev, dtype, q_lib, seed=seed0 + len(rows),
                              **kw)
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

    shapes = [int8_timing(dev, ops, refs, q_lib, *case) for case in (
            # decode at M = n_slots: gate/up, wq/wk/wv/wo, down; the head
            ("decode", 8, 2048, 8192, False, "skinny_tc"),
            ("decode_attn", 8, 2048, 2048, False, "skinny_tc"),
            ("decode_down", 8, 8192, 2048, False, "skinny_tc"),
            ("head", 8, 2048, 50304, True, "skinny_tc"),
            # serve_int8's widest prefill: wq/wk/wv/wo, gate/up, down
            ("prefill_attn", int8_m, 2048, 2048, False, "tensor_core"),
            ("prefill", int8_m, 2048, 8192, False, "tensor_core"),
            ("prefill_down", int8_m, 8192, 2048, False, "tensor_core"))]
    out["int8_matmul"] = {**shapes[0], "shapes": shapes}
    return out


def int8_timing(dev, ops, refs, q_lib, label, M, Kd, N, head, route):
    """One bf16 int8 product x (M, Kd) @ w (Kd, N) (the tied head's
    layout when `head`) on `route`, held against its plain version, then
    timed beside it and the library yardstick.  Returns its row."""
    dt, mm_ref = torch.bfloat16, refs["int8_matmul"]
    x, wq, sc = int8_case(dev, dt, q_lib, M=M, K=Kd, N=N, head=head,
                          seed=10)
    got = on_route(ops.int8_matmul, route,
                   lambda: ops.int8_matmul(x, wq, sc))
    err = check_close(f"int8_matmul/timed_{label}", got, mm_ref(x, wq, sc),
                      tol_of(dt))
    # bytes: int8 weights, x, out (bf16) and the scale, each once;
    # operations at the bf16 tensor-core peak, the rate the card has for
    # this product
    nbytes = Kd * N + (M * Kd + M * N) * 2 + 4 * sc.numel()
    b_ms, b_by = bound(nbytes, 2 * M * Kd * N, BF16_FLOPS)
    w16 = (wq.float() * sc).to(dt)           # dequantized beforehand
    row = {"label": label, "shape": f"M={M} K={Kd} N={N} bf16"
           + (" (tied head: embed_q.t(), per-K scale)" if head else ""),
           "kernel_route": route, "max_abs_err": err,
           "ms": time_ms(lambda: ops.int8_matmul(x, wq, sc)),
           "plain_ms": time_ms(lambda: mm_ref(x, wq, sc), reps=10),
           "bound_ms": b_ms, "bound_by": b_by,
           # a yardstick only: the same product on a bf16 weight
           # dequantized beforehand, twice the weight bytes
           "library_ms": time_ms(lambda: torch.matmul(x, w16))}
    row["vs_library"] = row["ms"] / row["library_ms"]
    return row


def moe_timings(dev, ops, refs, q_lib, int8_m, prefill_shape):
    """The MoE paths' own rows, bf16: the int8 products at
    granite-moe-3b-a800m's attention and head shapes (decode M = 8, and
    serve_moe's widest int8 prefill M `int8_m`), and the MoE FFN of one
    layer (`models.moe.moe_ffn`: router, sort-based dispatch, batched
    expert einsums) beside its plain dense-masked version (`moe_ffn_ref`,
    a loop over the experts) at granite's decode (8 slots, S = 1),
    granite's widest prefill (`prefill_shape` rows x bucket) and
    mixtral's decode.  The FFN's bound counts the router, the experts
    this input routes to (each read once), x and y, and the kept pairs'
    products (3 d f multiply-adds each); it has no library call."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe as moe_lib
    int8 = [int8_timing(dev, ops, refs, q_lib, *case) for case in (
        ("granite_decode_attn", 8, 1536, 1536, False, "skinny_tc"),
        ("granite_decode_kv", 8, 1536, 512, False, "skinny_tc"),
        ("granite_head", 8, 1536, 49155, True, "skinny_tc"),
        ("granite_prefill_attn", int8_m, 1536, 1536, False, "tensor_core"),
        ("granite_prefill_kv", int8_m, 1536, 512, False, "tensor_core"))]
    ffn = []
    for label, name, (b, s) in (("granite_decode", "granite-moe-3b-a800m",
                                 (8, 1)),
                                ("granite_prefill", "granite-moe-3b-a800m",
                                 prefill_shape),
                                ("mixtral_decode", "mixtral-8x22b", (8, 1))):
        cfg = ARCHS[name]
        e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        g = torch.Generator(device=dev).manual_seed(40)

        def rand(*shape, scale, dtype=torch.bfloat16):
            return (torch.randn(shape, generator=g, device=dev) * scale
                    ).to(dtype)
        x = rand(b, s, d, scale=1.0)
        router = rand(d, e, scale=d ** -0.5, dtype=torch.float32)
        wi, wo = rand(e, 2, d, f, scale=d ** -0.5), rand(e, f, d,
                                                         scale=f ** -0.5)
        args = (x, router, wi, wo, cfg.moe, cfg.act)
        with moe_lib.keep_masks() as log:
            y, _ = moe_lib.moe_ffn(*args)
        keep = log[0]
        _, idx, _ = moe_lib.router_topk(x, router, cfg.moe)
        kept = idx.reshape(b, -1)[keep]
        touched = int(torch.unique(kept).numel())
        # drop-free inputs only are the dense-masked oracle's
        err = (check_close(f"moe_ffn/{label}", y,
                           moe_lib.moe_ffn_ref(*args)[0], 2e-2)
               if bool(keep.all()) else None)
        nbytes = router.numel() * 4 + touched * 3 * d * f * 2 \
            + 2 * x.numel() * 2
        b_ms, b_by = bound(nbytes, 2 * 3 * d * f * int(keep.sum()),
                           BF16_FLOPS)
        ffn.append({
            "label": label, "shape": f"B={b} S={s} d={d} E={e} "
            f"top-{cfg.moe.top_k} f={f} bf16, capacity "
            f"{moe_lib.capacity(s, cfg.moe)}", "experts_read": touched,
            "pairs_kept": int(keep.sum()), "pairs": keep.numel(),
            "max_abs_err": err,
            "ms": time_ms(lambda: moe_lib.moe_ffn(*args)),
            "plain_ms": time_ms(lambda: moe_lib.moe_ffn_ref(*args), reps=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del x, wi, wo, args, y
        torch.cuda.empty_cache()
    out = {"int8_matmul": int8, "moe_ffn": ffn}
    emit({"phase": "moe_timings", **out})
    return out


SERVED_GQA = {
    # model: (n_heads, n_kv_heads, head_dim, window, prefix) of the paper's
    # zoo configs (configs/paper_zoo.py) the launcher serves: llama3.2-1b
    # and gemma3-1b by default, the others by name; then the MoE models
    # serve_moe serves (configs/granite_moe_3b.py, mixtral_8x22b.py)
    "llama3.2-1b": (32, 8, 64, 0, 0),
    "qwen3-1.7b": (16, 8, 128, 0, 0),
    "gemma3-1b": (4, 1, 256, 512, 0),
    "gemma3-4b": (8, 4, 256, 1024, 256),
    "granite-moe-3b-a800m": (24, 8, 64, 0, 0),
    "mixtral-8x22b": (48, 8, 128, 4096, 0),
    # configs/hymba_1_5b.py at serve_hymba's max_len 4096: its 128 meta
    # tokens are the prefix, its windowed layers' 2048 the window
    "hymba-1.5b": (25, 5, 64, 2048, 128),
    # configs/seamless_m4t_large.py: its decoder self-attention
    "seamless-m4t-large-v2": (16, 16, 64, 0, 0),
}
# decode S and flash S past the prefix, where not 1024 (so that the
# window bites)
GQA_LENGTHS = {"hymba-1.5b": (4096, 2400)}
GEMMA = ("gemma3-1b", "gemma3-4b")


def window_mask(sq, skv, window, prefix, dev):
    """(Sq, Skv) boolean visibility of a causal prefill from position 0
    with a window and an always-visible prefix (models/attention.py
    _mask)."""
    qp = torch.arange(sq, device=dev)[:, None]
    kp = torch.arange(skv, device=dev)[None, :]
    return (kp <= qp) & ((kp > qp - window) | (kp < prefix))


def gqa_timings(dev, ops, refs):
    """The three attention kernels at SERVED_GQA's shapes, bf16, each held
    against its plain version first: decode over 8 slots of S = 1024 with
    every position valid (pos 1023), in the engine's (B, S, K, hd) cache
    view and in pages of 16; flash over a causal prefill of 4 rows of
    1024 (2 rows of 256 + 1024 with gemma3-4b's prefix).  Bounds count
    only the rows and (query, key) pairs a window leaves visible.  The
    library yardstick is one SDPA call with enable_gqa (with the
    window's boolean mask where there is one; the port never calls it);
    the paged kernel has none.  Returns {kernel: [rows]}."""
    F = torch.nn.functional
    dt = torch.bfloat16
    out = {"paged_decode_attention": [], "decode_attention": [],
           "flash_attention": []}
    for model, (H, K, hd, win, pre) in SERVED_GQA.items():
        S, S_flash = GQA_LENGTHS.get(model, (1024, 1024))
        G, B, pps = H // K, 8, S // 16
        kw = dict(window=win, prefix=pre)
        tag = f" window={win} prefix={pre}" if win else ""
        pos = [S - 1] * B
        vis = sum(p + 1 if not win else
                  min(p + 1, win) + min(pre, max(p + 1 - win, 0))
                  for p in pos)              # visible (slot, row) pairs
        b_ms, b_by = bound(2 * vis * K * hd * 2 + 2 * B * H * hd * 2 + B * 4,
                           4 * vis * K * G * hd, BF16_FLOPS)
        args = paged_case(dev, dt, B=B, K=K, G=G, hd=hd, ps=16, pps=pps,
                          pos=pos, seed=31)
        ref = refs["paged_decode_attention"]
        err = check_close(f"paged_decode_attention/{model}",
                          ops.paged_decode_attention(*args, **kw),
                          ref(*args, **kw), tol_of(dt))
        out["paged_decode_attention"].append({
            "label": model, "shape": f"B={B} K={K} G={G} hd={hd} ps=16 "
            f"pps={pps}{tag} bf16, pos {S - 1}",
            "splits": dict(zip(("n_split", "pages_per_chunk"),
                               ops.paged_decode_attention_splits(
                                   B, K, pps, 16, ops._sm_count(dev.index)))),
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.paged_decode_attention(*args, **kw)),
            "plain_ms": time_ms(lambda: ref(*args, **kw), reps=10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        q, k, v, p = decode_case(dev, dt, B=B, K=K, G=G, S=S, hd=hd,
                                 pos=pos, seed=13, strided=True)
        ref = refs["decode_attention"]
        err = check_close(f"decode_attention/{model}", ops.decode_attention(
            q, k, v, p, **kw), ref(q, k, v, p, **kw), tol_of(dt))
        qh = q.reshape(B, H, 1, hd)       # head k * G + g reads kv head k
        mask = (window_mask(S, S, win, pre, dev)[S - 1][None, None, None]
                if win else None)
        out["decode_attention"].append({
            "label": model, "shape": f"B={B} K={K} G={G} S={S} hd={hd}{tag} "
            f"bf16, (B, S, K, hd) cache view, pos {S - 1}",
            "splits": dict(zip(("n_split", "chunk"),
                               ops.decode_attention_splits(
                                   B, K, S, ops._sm_count(dev.index)))),
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.decode_attention(q, k, v, p, **kw)),
            "plain_ms": time_ms(lambda: ref(q, k, v, p, **kw), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, enable_gqa=True))})
        del q, k, v, args
        B, S = (4, S_flash) if pre == 0 else (2, pre + S_flash)
        q, k, v = flash_case(dev, dt, B=B, H=H, K=K, S=S, hd=hd, seed=14)
        ref = refs["flash_attention"]
        got = on_route(ops.flash_attention, "tensor_core",
                       lambda: ops.flash_attention(q, k, v, **kw))
        err = check_close(f"flash_attention/{model}", got, ref(q, k, v, **kw),
                          tol_of(dt))
        mask = window_mask(S, S, win, pre, dev) if win else None
        pairs = B * (int(mask.sum()) if win else S * (S + 1) // 2)
        b_ms, b_by = bound(2 * (q.numel() + k.numel() + v.numel()
                                + q.numel()), 4 * H * hd * pairs,
                           BF16_FLOPS)
        out["flash_attention"].append({
            "label": model, "shape": f"B={B} H={H} K={K} S={S} hd={hd}{tag} "
            "bf16 causal", "kernel_route": "tensor_core",
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: ref(q, k, v, **kw), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=not win,
                enable_gqa=True))})
        del q, k, v
    for rows in out.values():
        for r in rows:
            r["vs_library"] = (r["ms"] / r["library_ms"]
                               if r["library_ms"] else None)
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

def greedy_recompute(tf, params, cfg, prompt, n, src_len=1024):
    """Plain greedy decode: a full forward with plain attention (the
    config's window) and no cache at every step; a vision model gets the
    zero prefix embeddings the engine feeds it, an encoder-decoder the
    zero frames (`src_len` of them, the engine's max_len).  xLSTM's full
    forward (`models.xlstm.forward`: the parallel mLSTM, the sLSTM scan)
    has no attention."""
    from repro_torch.models import xlstm as xl
    toks = list(prompt)
    out = []
    dev = params["embed"].device
    prefix = tf.zero_prefix_embeds(cfg, 1, dev)
    src = tf.zero_src_embeds(cfg, 1, src_len, dev)
    for _ in range(n):
        ids = torch.tensor([toks], device=dev)
        if cfg.block == "xlstm":
            logits = xl.forward(params, cfg, ids)[0, -1]
        else:
            logits = tf.forward(params, cfg, ids, impl="full",
                                prefix_embeds=prefix, src_embeds=src)[0, -1]
        nxt = int(logits.argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def parity_f32(dev, ops, cfg=None, http_cfg=None, gemma_cfgs=None):
    """The 2-layer f32 model in each decode mode, and int8 in the gather
    mode, against the plain greedy recompute (dense, or on the
    dequantized int8 weights); then the hierarchical KV memory and
    speculation on the dense weights: the prefix cache in the
    paged-attention and gather modes (prompts sharing a 256-token prefix,
    one at a time, then a partial hit), the host swap tier on an
    oversubscribed pool, and speculative decoding on repetitive prompts;
    then the control plane's runs (parity_gateway), the HTTP run
    (parity_http) and the gemma runs (parity_gemma).  `cfg`, `http_cfg`
    and `gemma_cfgs` replace the models (a CPU rehearsal)."""
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
    del params
    gc.collect()
    http_line, http_bad = parity_http(dev, ops, http_cfg)
    lines.append(http_line)
    mismatches += http_bad
    gc.collect()
    gemma_lines, gemma_bad = parity_gemma(dev, ops, gemma_cfgs)
    lines += gemma_lines
    mismatches += gemma_bad
    emit({"phase": "parity_f32", "layers": cfg.n_layers, "d_model":
          cfg.d_model, "prompt_lens": [len(p) for p in prompts],
          "prefix_prompt_lens": [len(p) for p in prefix_prompts],
          "swap_prompt_lens": [len(p) for p in swap_prompts],
          "spec_prompt_lens": [len(p) for p in spec_prompts],
          "tokens_each": 16, "runs": lines, "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_f32 mismatches: {mismatches}")


def parity_gemma(dev, ops, cfgs=None):
    """The paper's gemma3-1b and gemma3-4b cut to 2 layers, at full width
    (head_dim 256, the gelu FFN) and in f32, their RMS-norm scales from a
    seed: gemma3-1b (window 512, G = 4) serves 4 greedy prompts of
    600-900 tokens, so that the window bites, in the paged-attention and
    gather modes; gemma3-4b (window 1024, G = 2, 256 vision prefix
    tokens fed zeros) 4 of 600-740 (prompt + prefix + budget <= max_len
    1024) in the gather mode.  Each run's tokens must equal the plain
    greedy recompute (full forward, plain windowed attention, the zero
    prefix, no cache), and each must launch exactly its mode's kernels.
    Returns (lines, mismatches)."""
    from repro_torch.configs import ZOO
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    cfgs = cfgs or {name: dataclasses.replace(ZOO[name], n_layers=2,
                                              dtype="f32")
                    for name in GEMMA}
    kernels = {"paged_attention": {"paged_decode_attention",
                                   "flash_attention"},
               "gather": {"decode_attention", "flash_attention"}}
    lines, mismatches = [], []
    for i, (name, cfg) in enumerate(cfgs.items()):
        params = build(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(5 + i))
        rng = np.random.default_rng(6 + i)
        seed_norms(params, rng)
        hi = 900 if cfg.n_prefix_tokens == 0 else \
            1024 - cfg.n_prefix_tokens - 16 - 16
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in np.linspace(600, hi, 4).astype(int)]
        wants = [greedy_recompute(tf, params, cfg, p, 16) for p in prompts]
        modes = ("paged_attention", "gather") if cfg.n_prefix_tokens == 0 \
            else ("gather",)
        for mode in modes:
            eng = InferenceEngine(cfg, params, EngineConfig(
                n_slots=4, max_len=1024, decode_block=4,
                paged_attention=mode == "paged_attention"), device=dev)
            reqs = [Request(model=cfg.name, prompt=p,
                            sampling=SamplingParams(max_tokens=16))
                    for p in prompts]
            ops.reset_launches()
            for r in reqs:
                assert eng.submit(r)
            eng.run_until_done()
            launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
            if {k for k, n in launched.items() if n} != kernels[mode]:
                raise AssertionError(f"parity_gemma {name} {mode}: kernels "
                                     f"{launched}, want exactly "
                                     f"{sorted(kernels[mode])}")
            if eng.pool.pages_in_use:
                raise AssertionError(f"parity_gemma {name} {mode}: pages "
                                     "not returned")
            bad = [{"mode": f"{name}/{mode}", "prompt_len": len(p),
                    "got": r.output, "want": w}
                   for r, p, w in zip(reqs, prompts, wants)
                   if r.output != w]
            mismatches += bad
            lines.append({"mode": f"{name}/{mode}", "window":
                          cfg.swa_window, "prefix": cfg.n_prefix_tokens,
                          "head_dim": cfg.head_dim,
                          "prompt_lens": [len(p) for p in prompts],
                          "launches": launched, "match": not bad})
            del eng
        del params
        gc.collect()
    return lines, mismatches


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


def seed_norms(params, rng):
    """Draw every RMS-norm scale from `rng` (the init leaves them 0, and
    `1 + scale` then never weighs anything); Hymba's branch norms, an
    encoder-decoder's lnx and encoder norms, and xLSTM's blocks' ln and
    group-norm gn too."""
    lp, ep = params.get("layers", {}), params.get("enc_layers", {})
    slots = [(lp, "ln1"), (lp, "ln2"), (params, "final_norm"),
             (lp, "branch_norm_attn"), (lp, "branch_norm_ssm"), (lp, "lnx"),
             (ep, "ln1"), (ep, "ln2")]
    for blk in params.get("pairs", {}).values():
        slots += [(blk, "ln"), (blk, "gn")]
    for tree, key in slots:
        if key not in tree:
            continue
        t = tree[key]
        tree[key] = torch.from_numpy(rng.normal(
            0.0, 0.5, tuple(t.shape)).astype(np.float32)).to(t.device,
                                                             t.dtype)


def parity_http(dev, ops, cfg=None):
    """The paper's llama3.2-1b cut to 2 layers, at full width and in f32
    (G = 4, head_dim 64), its RMS-norm scales drawn from a seed, served
    over HTTP: the paper's testbed, two replicas on two nodes behind
    GatewayHTTPServer.  Four greedy /v1/completions with token-id
    prompts, two streamed and two not, from four keep-alive clients at
    once.  Their token ids must equal the plain greedy recompute, and the
    engines must launch exactly flash n_layers x prefill dispatches and
    decode attention n_layers x decode_block x decode dispatches
    (node.deploy's gather mode), summed over them.  `cfg` replaces the
    model (a CPU rehearsal).  Returns (line, mismatches)."""
    import threading
    from repro_torch.api.http import GatewayHTTPServer, HTTPClient, HTTPConfig
    from repro_torch.configs import ZOO
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    cfg = cfg or dataclasses.replace(ZOO["llama3.2-1b"], n_layers=2,
                                     dtype="f32")
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(3))
    seed_norms(params, np.random.default_rng(8))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (1, 17, 100, 300)]
    want = [greedy_recompute(tf, params, cfg, p, 16) for p in prompts]
    fleet, ctrl, gw = gateway_stack(dev, cfg, params, min_replicas=2,
                                    max_replicas=2, n_slots=4, max_len=512,
                                    allow_quant=False)
    server = GatewayHTTPServer(gw, HTTPConfig(port=0)).start()
    ops.reset_launches()
    got, errors = [None] * len(prompts), []

    def ask(i):
        c = HTTPClient(server.url())
        try:
            if i % 2:
                got[i] = [ch["choices"][0]["token"] for ch in c.complete(
                    cfg.name, prompts[i], max_tokens=16, stream=True,
                    timeout_s=300)
                    if ch["choices"][0].get("token") is not None]
            else:
                got[i] = c.complete(cfg.name, prompts[i], max_tokens=16,
                                    timeout_s=300)["choices"][0]["token_ids"]
        except Exception as e:          # reported on the main thread
            errors.append(repr(e))
        finally:
            c.close()
    clients = [threading.Thread(target=ask, args=(i,))
               for i in range(len(prompts))]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    stopped = server.stop(timeout_s=120)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    if errors or not stopped or any(t.is_alive() for t in clients):
        raise AssertionError(f"parity_f32 http: {errors}, stopped {stopped}")
    expect = dict.fromkeys(launches, 0)
    nodes = []
    for node in fleet.nodes.values():
        for inst in node.instances.values():
            eng = inst.engine
            for k, v in expected_launches(cfg, eng.ecfg,
                                          eng.perf_stats()).items():
                expect[k] += v
            if eng.pool.pages_in_use:
                raise AssertionError("parity_f32 http: pages held")
            nodes.append(node.node_id)
    if launches != expect or not launches["decode_attention"] \
            or not launches["flash_attention"]:
        raise AssertionError(f"parity_f32 http: launches {launches}, want "
                             f"{expect}")
    bad = [{"mode": "http", "prompt_len": len(p), "got": g, "want": w}
           for p, g, w in zip(prompts, got, want) if g != w]
    return ({"mode": "http", "model": cfg.name, "layers": cfg.n_layers,
             "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim":
             cfg.head_dim, "nodes": nodes, "streamed": [1, 3],
             "launches": launches, "match": not bad}, bad)


class DropMeter:
    """The (token, expert) pairs a MoE engine's layers kept and dropped:
    a context around a serve that collects every moe_ffn keep mask
    (`models.moe.keep_masks`, on the device: nothing is read back while
    it runs) and wraps the engine's two admission programs so that the
    masks made inside one are counted over its admitted rows' real
    tokens (position < the row's length; pads and padded rows are not
    pairs of any request).  The masks of every other call (decode steps,
    verifies) are counted over all their rows: a decode step never drops
    (capacity top_k at S = 1)."""

    def __init__(self, eng):
        from repro_torch.models import moe as moe_lib
        self._moe, self._k = moe_lib, eng.cfg.moe.top_k
        self._admits = []               # (first mask, last mask, lengths)
        self._log = None
        for attr, at in (("_prefill_admit", 0), ("_suffix_admit", 1)):
            setattr(eng, attr, self._wrap(getattr(eng, attr), at))

    def _wrap(self, fn, at):
        def wrapper(toks, *args):
            lengths, slots = args[at], args[at + 2]
            lo = len(self._log) if self._log is not None else 0
            out = fn(toks, *args)
            if self._log is not None:
                self._admits.append((lo, len(self._log),
                                     np.asarray(lengths[:len(slots)])))
            return out
        return wrapper

    def __enter__(self):
        self._ctx = self._moe.keep_masks()
        self._log = self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)

    def report(self):
        pairs = dropped = 0
        inside = set()
        for lo, hi, lengths in self._admits:
            inside.update(range(lo, hi))
            for keep in self._log[lo:hi]:
                keep = keep.cpu()[:len(lengths)]
                s = keep.shape[1] // self._k
                real = (torch.arange(s)[None, :]
                        < torch.from_numpy(lengths)[:, None].long())
                real = real.repeat_interleave(self._k, dim=1)  # s-major
                pairs += int(real.sum())
                dropped += int((real & ~keep).sum())
        other = [m for i, m in enumerate(self._log) if i not in inside]
        return {"admission_pairs": pairs, "admission_dropped": dropped,
                "dropped_share": dropped / max(pairs, 1),
                "other_calls": len(other),
                "other_dropped": int(sum(int((~m).sum()) for m in other))}


@contextlib.contextmanager
def plain_attention(ops):
    """Inside: the model's flash and decode attention calls take the
    plain PyTorch versions (`ops` is repro_torch.kernels.ops, whose
    attributes the model reads at each call); the wrappers' counters do
    not move."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention, ops.decode_attention = (flash_attention_ref,
                                                 decode_attention_ref)
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def cached_recompute(tf, ops, params, cfg, prompt, bucket, n):
    """Plain greedy decode through the cache, with plain attention: one
    prefill of the prompt right-padded to `bucket` (the length the
    engine's admission fed the model, so the MoE FFN gets the capacity
    it got there), then one `decode_step` a token (capacity top_k, as the
    engine's decode).  A full forward would route the prompt at another
    capacity.  Returns n tokens."""
    dev = params["embed"].device
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    with plain_attention(ops):
        logits, rows, pos = tf.prefill(
            params, cfg, toks,
            lengths=torch.tensor([len(prompt)], device=dev))
        cache = {}
        for name, kv in rows.items():
            cache[name] = kv.new_zeros((kv.shape[0], 1, bucket + n)
                                       + tuple(kv.shape[3:]))
            cache[name][:, :, :bucket] = kv
        out = [int(logits[0].argmax())]
        for _ in range(n - 1):
            pos = pos + 1
            logits, cache = tf.decode_step(
                params, cfg, cache, torch.tensor([out[-1]], device=dev,
                                                 dtype=torch.int32), pos)
            out.append(int(logits[0].argmax()))
    return out


def parity_moe(dev, ops, cfg=None):
    """The paper's granite-moe-3b-a800m cut to 2 layers at full width (40
    experts top-8, f 512, 24 heads over 8: G = 3, hd 64, vocab 49155
    tied), f32, RMS-norm scales from a seed: 4 greedy requests in the
    paged-attention mode, the gather mode, and the gather mode under
    int8.  Each request's tokens must equal `cached_recompute` at the
    bucket the engine's admission used (recorded; for int8 on the
    dequantized weights), and each run must launch exactly its mode's
    kernels.  Prints the (token, expert) pairs the admissions dropped.
    `cfg` replaces the model (a CPU rehearsal).  Returns (lines,
    mismatches)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    from repro_torch.serving import quantization as q_lib
    cfg = cfg or dataclasses.replace(ARCHS["granite-moe-3b-a800m"],
                                     n_layers=2, dtype="f32")
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(7))
    rng = np.random.default_rng(8)
    seed_norms(params, rng)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (5, 17, 100, 300)]
    deq = q_lib.dequant_tree(q_lib.quantize_tree(params, 8))
    paged, gather = ({"paged_decode_attention", "flash_attention"},
                     {"decode_attention", "flash_attention"})
    runs = (("paged_attention", dict(paged_attention=True), params, paged),
            ("gather", {}, params, gather),
            ("gather_int8", dict(quantize="int8"), deq,
             gather | {"int8_matmul"}))
    lines, mismatches = [], []
    for mode, kw, ref_params, kernels in runs:
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=512, decode_block=4, **kw), device=dev)
        buckets = {}                # prompt -> its admission's bucket
        admit = eng._prefill_admit

        def recording_admit(toks, lengths, *args, admit=admit,
                            buckets=buckets):
            for row, n in zip(toks, lengths):
                buckets.setdefault(tuple(int(t) for t in row[:n]),
                                   toks.shape[1])
            return admit(toks, lengths, *args)
        eng._prefill_admit = recording_admit
        meter = DropMeter(eng)
        reqs = [Request(model=cfg.name, prompt=p,
                        sampling=SamplingParams(max_tokens=16))
                for p in prompts]
        ops.reset_launches()
        with meter:
            for r in reqs:
                assert eng.submit(r)
            eng.run_until_done()
        launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        if {k for k, n in launched.items() if n} != kernels:
            raise AssertionError(f"parity_moe {mode}: kernels {launched}, "
                                 f"want exactly {sorted(kernels)}")
        st = eng.perf_stats()
        if st["preemptions"] or eng.pool.pages_in_use:
            raise AssertionError(f"parity_moe {mode}: {st['preemptions']} "
                                 f"preemptions, {eng.pool.pages_in_use} "
                                 "pages held")
        used = [buckets[tuple(p)] for p in prompts]
        wants = [cached_recompute(tf, ops, ref_params, cfg, p, b, 16)
                 for p, b in zip(prompts, used)]
        bad = [{"mode": f"moe/{mode}", "prompt_len": len(p), "got": r.output,
                "want": w} for r, p, w in zip(reqs, prompts, wants)
               if r.output != w]
        mismatches += bad
        lines.append({"mode": f"{cfg.name}/{mode}", "layers": cfg.n_layers,
                      "prompt_lens": [len(p) for p in prompts],
                      "buckets": used, **meter.report(),
                      "launches": launched, "match": not bad})
        del eng
    emit({"phase": "parity_moe", "experts": [cfg.moe.num_experts,
                                             cfg.moe.top_k],
          "heads": [cfg.n_heads, cfg.n_kv_heads], "d_model": cfg.d_model,
          "tokens_each": 16, "runs": lines, "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_moe mismatches: {mismatches}")
    return lines


def serve_setup(dev, cfg=None, params=None, max_prompt=896, max_len=1024,
                **engine_kw):
    """The main paths' model, engine and 12 seeded requests: the full
    OLMo-1B in bf16 with random weights from a seed; prompt lengths in
    16..max_prompt, budgets in 1..64; 10 greedy and 2 sampled requests.
    `engine_kw` picks the decode mode and quantization; `cfg` replaces the
    model (another zoo model, or a CPU rehearsal) and `params` its
    weights.  Also returns the weights' bytes."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serving import EngineConfig, InferenceEngine
    from repro_torch.serving.quantization import tree_bytes
    cfg = cfg or ARCHS["olmo-1b"]
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = build(cfg, dev).init(gen)
    dense_bytes = tree_bytes(params)
    ecfg = EngineConfig(n_slots=8, max_len=max_len, page_size=16,
                        decode_block=8, **engine_kw)
    eng = InferenceEngine(cfg, params, ecfg, device=dev)
    return (cfg, ecfg, eng, lambda: serve_requests(cfg, max_prompt),
            dense_bytes)


def serve_requests(cfg, max_prompt=896):
    """The main paths' 12 seeded requests: prompt lengths in
    16..max_prompt, budgets in 1..64; 10 greedy and 2 sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(12):
        n = int(rng.integers(16, max_prompt + 1))
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


def int8_products(cfg, prefill: bool) -> int:
    """The int8 kernel's products in one model call, the head excepted:
    a layer's wq, wk, wv, wo and its FFN's (gate, up, down; gelu's wi,
    wo), a MoE layer's four (its experts are batched products off the
    kernel, dequantized a layer at a time), Hymba's w_in and wo_comb in
    place of wo; an encoder-decoder's decoder layer adds its cross wq and
    wo, and a prefill also each layer's cross wk and wv and the encoder's
    layers; xLSTM's seven a pair (w_up, wq, wk, wv, w_down, ffn_wi,
    ffn_wo)."""
    if cfg.block == "xlstm":
        return 7 * max(1, cfg.n_layers // 2)
    ffn = 0 if cfg.moe else (3 if cfg.act == "swiglu" else 2)
    total = (4 + ffn + (cfg.block == "hymba")) * cfg.n_layers
    if cfg.is_encdec:
        total += 2 * cfg.n_layers
        if prefill:
            total += 2 * cfg.n_layers + (4 + ffn) * cfg.encdec.enc_layers
    return total


def flash_per_prefill(cfg):
    """(causal, non-causal) flash launches a prefill dispatch: one a
    decoder layer; an encoder-decoder's encoder layers and cross
    attentions are non-causal; xLSTM has no attention."""
    if cfg.block == "xlstm":
        return 0, 0
    return cfg.n_layers, (cfg.encdec.enc_layers + cfg.n_layers
                          if cfg.is_encdec else 0)


def expected_launches(cfg, ecfg, st):
    """Each kernel's launches for a serve with these stats: one attention
    kernel per layer per model call (an encoder-decoder's prefill also
    runs flash in its encoder and cross-attention, its decode the decode
    kernel for the cross-attention in every mode), and under int8 one
    int8 matmul per product (`int8_products`) plus the head per model
    call (a full prefill dispatch or a fused decode step).  A suffix
    admission and a speculative verify attend in plain PyTorch and
    launch no attention kernel; xLSTM launches only the int8 kernel."""
    n = 0 if cfg.block == "xlstm" else cfg.n_layers
    # a speculative verify is a decode dispatch that runs no decode kernel
    steps = ecfg.decode_block * (st["decode_dispatches"]
                                 - st["spec_dispatches"])
    paged = st["paged_attention"]
    pre = st["prefill_dispatches"]
    cross = n if cfg.is_encdec else 0
    return {"paged_decode_attention": n * steps if paged else 0,
            "flash_attention": sum(flash_per_prefill(cfg)) * pre,
            "decode_attention": ((0 if paged else n) + cross) * steps,
            "int8_matmul": ((int8_products(cfg, True) + 1) * pre
                            + (int8_products(cfg, False) + 1) * steps
                            if ecfg.quantize == "int8" else 0)}


def expected_routes(cfg, ecfg, st, dispatch_shapes):
    """The flash and int8 launches of a bf16 serve by route, and the
    flash launches that are non-causal.  Flash: all on the tensor cores.
    int8: in a prefill dispatch of (rows, bucket) the decoder's
    `int8_products` have M = rows x bucket, on the tensor cores when
    M > 16 (an encoder-decoder's encoder and cross wk / wv take the rows'
    max_len frames: M = rows x max_len), and the head M = rows; every
    decode step has M = n_slots; M <= 16 (bf16 x, aligned rows) is
    skinny_tc.  An untied head of N % 16 != 0 (hymba's 32001,
    seamless's 256206) has rows that are no whole number of 16-byte
    vectors: M <= 16 on "skinny"."""
    causal, non_causal = flash_per_prefill(cfg)
    flash = {"tensor_core": (causal + non_causal) * st["prefill_dispatches"],
             "cuda_core": 0}
    int8 = {"skinny": 0, "tensor_core": 0, "cuda_core_tile": 0,
            "skinny_tc": 0}
    if ecfg.quantize == "int8":
        head_row = cfg.d_model if cfg.tie_embeddings else cfg.vocab

        def route(m, wide, row=16):
            if m > 16:
                return wide
            return "skinny_tc" if row % 16 == 0 else "skinny"
        n = int8_products(cfg, False)
        frames = int8_products(cfg, True) - n
        for rows, bucket in dispatch_shapes:
            int8[route(rows * bucket, "tensor_core")] += n
            int8[route(rows * ecfg.max_len, "tensor_core")] += frames
            int8[route(rows, "cuda_core_tile", head_row)] += 1   # the head
        steps = ecfg.decode_block * st["decode_dispatches"]
        int8[route(ecfg.n_slots, "tensor_core")] += n * steps
        int8[route(ecfg.n_slots, "cuda_core_tile", head_row)] += steps
    return {"flash_attention": flash, "int8_matmul": int8,
            "flash_non_causal": non_causal * st["prefill_dispatches"]}


def serve(phase, dev, ops, card, cfg=None, max_prompt=896, params=None,
          note=None, max_len=1024, requests=None, **engine_kw):
    """One serve of serve_setup's model and requests (`cfg`: another zoo
    model, `params` its weights), its launches counted from 0 just before
    and read just after, held by check_serve, its routes and its pages; a
    MoE model's line also counts its dropped pairs (DropMeter).  `note`
    goes into the line (a depth cut).  Returns (launches, launches by
    route, prefill shapes)."""
    cfg, ecfg, eng, make_requests, dense_bytes = serve_setup(
        dev, cfg=cfg, params=params, max_prompt=max_prompt, max_len=max_len,
        **engine_kw)
    reqs = (requests or make_requests)()
    # each prefill dispatch's (rows, bucket), for the expected routes; an
    # exact-length family's admitted rows are each exactly the bucket long
    dispatch_shapes = []
    admit = eng._prefill_admit

    def recording_admit(toks, lengths, row_pages, slots, *args):
        dispatch_shapes.append(tuple(toks.shape))
        if not eng._supports_bucket and any(
                int(n) != toks.shape[1] for n in lengths[:len(slots)]):
            raise AssertionError(f"{phase}: an exact-length admission of "
                                 f"rows {lengths[:len(slots)].tolist()} "
                                 f"in a bucket of {toks.shape[1]}")
        return admit(toks, lengths, row_pages, slots, *args)
    eng._prefill_admit = recording_admit
    # the earlier phases' tensors that only the cycle collector frees would
    # otherwise count in this serve's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    meter = DropMeter(eng) if cfg.moe else None
    # the path: counters at 0 just before, read just after
    ops.reset_launches()
    with meter or contextlib.nullcontext():
        step_ms, wall = drive(eng, reqs)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    by_route = {fn.__name__: dict(fn.launches_by_route)
                for fn in (ops.flash_attention, ops.int8_matmul)}
    by_route["flash_non_causal"] = ops.flash_attention.launches_non_causal
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
    # what placement charges an instance of this engine (cluster/node.py),
    # with the engine's page budget and with none, beside what it holds:
    # with the budget, every byte (ROADMAP C14)
    from repro_torch.cluster.node import instance_bytes
    charged = {"paged": instance_bytes(cfg, ecfg.quantize, ecfg.n_slots,
                                       ecfg.max_len, ecfg.page_size,
                                       eng.pool.n_pages),
               "dense": instance_bytes(cfg, ecfg.quantize, ecfg.n_slots,
                                       ecfg.max_len)}
    if charged["paged"] != sum(mem.values()):
        raise AssertionError(f"{phase}: placement charges {charged['paged']}"
                             f" B, the engine holds {mem}")
    if ecfg.quantize == "int8" and mem["param_bytes"] >= 0.65 * dense_bytes:
        raise AssertionError(f"{phase}: int8 weights {mem['param_bytes']} B"
                             f", bf16 {dense_bytes} B")
    # and as the dispatches run them: the experts stay int8 (the kernel
    # operands share every q; only scales and the router are copies)
    from repro_torch.serving.quantization import tree_bytes
    run_bytes = tree_bytes(eng._int8) if eng._int8 is not None else None
    if run_bytes is not None and run_bytes >= 0.65 * dense_bytes:
        raise AssertionError(f"{phase}: the int8 operands hold {run_bytes} "
                             f"B, bf16 {dense_bytes} B")
    ttft = sorted(r.ttft for r in reqs)
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
          "params": cfg.num_params(), "head_dim": cfg.head_dim,
          "heads": [cfg.n_heads, cfg.n_kv_heads],
          "window": cfg.swa_window, "prefix_tokens": cfg.n_prefix_tokens,
          "meta_tokens": cfg.n_meta_tokens, "max_len": ecfg.max_len,
          "quantize": ecfg.quantize,
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
          "int8_operand_bytes": run_bytes,
          "cache_bytes": mem["cache_bytes"],
          "operand_bytes": mem["operand_bytes"], "instance_bytes": charged,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
          **(meter.report() if meter else {}),
          **({"note": note} if note else {}),
          "launches": launches, "launches_by_route": by_route,
          "card": card})
    return launches, by_route, [tuple(s) for s in st["prefill_shapes"]]


def serve_gemma(dev, ops, card):
    """The paper's gemma3-1b at full width and depth (26 layers, hd 256,
    window 512, G = 4, vocab 262144), bf16, seeded weights, in the
    paged-attention mode under serve_bf16's EngineConfig and requests
    (prompts 16-896: past the window); then gemma3-4b (34 layers, hd 256,
    window 1024, G = 2, 256 vision prefix tokens fed zeros) in the gather
    mode, its prompts capped at 704 so that prompt + 256 + budget <=
    1024.  Each serve is held as serve_bf16 is (exact budgets, every page
    returned, launches n_layers x model calls per attention kernel, every
    flash launch "tensor_core").  Returns {model: launches}, each counted
    from 0 just before its serve and read just after."""
    from repro_torch.configs import ZOO
    out = {}
    for name, kw, max_prompt in (
            ("gemma3-1b", dict(paged_attention=True), 896),
            ("gemma3-4b", {}, 1024 - ZOO["gemma3-4b"].n_prefix_tokens - 64)):
        gc.collect()
        torch.cuda.empty_cache()
        launches, _, _ = serve("serve_gemma", dev, ops, card, cfg=ZOO[name],
                               max_prompt=max_prompt, **kw)
        out[name] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return out


MIXTRAL_LAYERS = 2          # of mixtral-8x22b's 56: the depth cut


def serve_moe(dev, ops, card, granite=None, mixtral=None):
    """The MoE FFN in every engine path, launch counters at 0 just before
    each leg and read just after: (a) the paper's granite-moe-3b-a800m at
    full width and depth (32 layers, d 1536, 24 heads over 8, hd 64, 40
    experts top-8, f 512, vocab 49155 tied; 3.30 B params, bf16, seeded
    weights) under serve_bf16's engine and requests in the
    paged-attention mode; (b) the same weights and requests under
    quantize="int8" in the gather mode (the experts int8 at rest); (c)
    granite through serve_prefix_swap and serve_spec (JAX keeps the
    prefix cache and speculation on for it); (d) mixtral-8x22b at full
    width (d 6144, 48 heads over 8, hd 128, 8 experts top-2, f 16384,
    vocab 32768 untied, window 4096) cut to MIXTRAL_LAYERS of its 56
    layers, bf16, gather mode.  Each leg holds exact budgets, every page
    returned and its exact launches (serve / check_serve), and prints
    tok/s, p50 step, TTFT, peak device memory and the share of
    admission pairs dropped.  `granite` / `mixtral` replace the configs
    (a CPU rehearsal).  Returns ({leg: launches}, {leg: (launches by
    route, prefill shapes)} of the serve() legs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    granite = granite or ARCHS["granite-moe-3b-a800m"]
    mixtral = mixtral or dataclasses.replace(ARCHS["mixtral-8x22b"],
                                             n_layers=MIXTRAL_LAYERS)
    params = build(granite, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    legs, more = {}, {}
    for leg, kw in (("granite_paged", dict(paged_attention=True)),
                    ("granite_int8", dict(quantize="int8"))):
        legs[leg], *more[leg] = serve("serve_moe", dev, ops, card,
                                      cfg=granite, params=params, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    legs["granite_prefix_swap"] = serve_prefix_swap(dev, ops, card,
                                                    cfg=granite,
                                                    params=params)
    legs["granite_spec"] = serve_spec(dev, ops, card, cfg=granite,
                                      params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    full = ARCHS["mixtral-8x22b"].n_layers
    legs["mixtral"], *more["mixtral"] = serve(
        "serve_moe", dev, ops, card, cfg=mixtral,
        note=f"depth cut: {mixtral.n_layers} of {full} layers, full "
             "width")
    gc.collect()
    torch.cuda.empty_cache()
    return legs, more


def parity_runs(phase, dev, ops, cfg, params, prompts, budgets, runs,
                max_len=1024, decode_block=8):
    """Greedy requests through the engine in each of `runs` (mode, engine
    kwargs, weights "dense" or "int8", the kernels it must launch), each
    request's tokens against greedy_recompute (on the dequantized
    weights for int8), each run's launches against expected_launches
    (the non-causal flash launches too) and each admission of an
    exact-length family holding rows of one length.  Returns (lines,
    mismatches)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    from repro_torch.serving import quantization as q_lib
    deq = q_lib.dequant_tree(q_lib.quantize_tree(params, 8))
    wants = {}

    def want(weights, p, n):
        key = (weights, tuple(p), n)
        if key not in wants:
            wants[key] = greedy_recompute(
                tf, deq if weights == "int8" else params, cfg, p, n,
                src_len=max_len)
        return wants[key]
    lines, mismatches = [], []
    for mode, kw, weights, kernels in runs:
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=max_len, decode_block=decode_block, **kw),
            device=dev)
        shapes = []
        admit = eng._prefill_admit

        def recording_admit(toks, lengths, row_pages, slots, *args,
                            admit=admit, shapes=shapes):
            shapes.append((tuple(toks.shape),
                           sorted({int(n) for n in lengths[:len(slots)]})))
            return admit(toks, lengths, row_pages, slots, *args)
        eng._prefill_admit = recording_admit
        reqs = [Request(model=cfg.name, prompt=p,
                        sampling=SamplingParams(max_tokens=n))
                for p, n in zip(prompts, budgets)]
        ops.reset_launches()
        for r in reqs:
            assert eng.submit(r)
        eng.run_until_done()
        launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        non_causal = ops.flash_attention.launches_non_causal
        st = eng.perf_stats()
        if {k for k, n in launched.items() if n} != kernels \
                or launched != expected_launches(cfg, eng.ecfg, st):
            raise AssertionError(f"{phase} {mode}: kernels {launched}, "
                                 f"want exactly {sorted(kernels)}: "
                                 f"{expected_launches(cfg, eng.ecfg, st)}")
        if non_causal != flash_per_prefill(cfg)[1] \
                * st["prefill_dispatches"]:
            raise AssertionError(f"{phase} {mode}: {non_causal} non-causal "
                                 "flash launches")
        if not eng._supports_bucket \
                and any(ls != [sh[1]] for sh, ls in shapes):
            raise AssertionError(f"{phase} {mode}: admissions {shapes} "
                                 "hold rows of another length")
        if st["preemptions"] or eng.pool.pages_in_use:
            raise AssertionError(f"{phase} {mode}: {st['preemptions']} "
                                 f"preemptions, {eng.pool.pages_in_use} "
                                 "pages held")
        bad = [{"mode": f"{cfg.name}/{mode}", "prompt_len": len(p),
                "got": r.output, "want": want(weights, p, n)}
               for r, p, n in zip(reqs, prompts, budgets)
               if r.output != want(weights, p, n)]
        mismatches += bad
        lines.append({"mode": f"{cfg.name}/{mode}", "paged": st["paged"],
                      "paged_attention": st["paged_attention"],
                      "admissions": shapes, "launches": launched,
                      "flash_non_causal": non_causal, "match": not bad})
        del eng
    return lines, mismatches


HYMBA_PARITY_LAYERS = 4     # of hymba-1.5b's 32, as reduced() cuts them


def hymba_cut(cfg, n_layers):
    """hymba-1.5b at full width cut to its first n_layers, keeping the
    global layers among them (reduced()'s cut: layer 0 of 0, 15, 31)."""
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        global_attn_layers=tuple(i for i in cfg.global_attn_layers
                                 if i < n_layers))


def parity_hymba(dev, ops, cfg=None, swap_cfg=None):
    """The paper's hymba-1.5b at full width (d 1600, 25 heads over 5: G =
    5, hd 64, 128 meta tokens, window 2048, ssm_state 16, vocab 32001
    untied) cut to HYMBA_PARITY_LAYERS layers (layer 0 global), f32,
    RMS-norm and branch-norm scales from a seed, max_len 4096: greedy
    requests with prompts of 10, 700, 2300 and 3000 tokens (the last two
    past the window and the meta tokens) in the paged-attention mode,
    the gather mode and the gather mode under int8.  Each request's
    tokens must equal `greedy_recompute` (a full forward, plain
    attention, no cache, every step: for a family admitted at its exact
    length, a true recompute; on the dequantized weights for int8), each
    run launch exactly its mode's kernels, and each admission hold rows
    of one length.  Then the swap tier: two requests on a 70-page pool
    (max_len 1024) with a host tier, >= 1 swap-out, each request's
    tokens equal to the same request's without page pressure (its SSM
    state rides in the swap handle; ROADMAP C16).  `cfg` / `swap_cfg`
    replace the model (a CPU rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or dataclasses.replace(
        hymba_cut(ARCHS["hymba-1.5b"], HYMBA_PARITY_LAYERS), dtype="f32")
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(7))
    rng = np.random.default_rng(8)
    seed_norms(params, rng)
    lens, budgets = (10, 700, 2300, 3000), (16, 12, 8, 10)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    paged, gather = ({"paged_decode_attention", "flash_attention"},
                     {"decode_attention", "flash_attention"})
    runs = (("paged_attention", dict(paged_attention=True), "dense", paged),
            ("gather", {}, "dense", gather),
            ("gather_int8", dict(quantize="int8"), "int8",
             gather | {"int8_matmul"}))
    lines, mismatches = parity_runs("parity_hymba", dev, ops, cfg, params,
                                    prompts, budgets, runs, max_len=4096,
                                    decode_block=4)
    lines.append(swap_leg(dev, swap_cfg or cfg, params))
    if not lines[-1]["match"]:
        mismatches.append(lines[-1])
    emit({"phase": "parity_hymba", "heads": [cfg.n_heads, cfg.n_kv_heads],
          "d_model": cfg.d_model, "meta_tokens": cfg.n_meta_tokens,
          "window": cfg.swa_window, "global_layers": cfg.global_attn_layers,
          "budgets": list(budgets), "runs": lines, "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_hymba mismatches: {mismatches}")
    return lines


def swap_leg(dev, cfg, params, kv_pages=70, lens=(400, 410),
             swap_ms=None):
    """Two greedy requests (prompts of `lens` tokens, 48 tokens each) on
    a pool of `kv_pages` pages of 16 (max_len 1024, 2 slots, paged
    attention; hymba's 400 and 410 on 70 pages, its 128 meta tokens
    taking pages too) with 64 host pages: the decode growth runs the
    pool dry and one slot is swapped out, then back in.  It holds >= 1
    swap-out, as many swap-ins, every budget and no page held, and
    compares each request's tokens with the same request's without page
    pressure.  `swap_ms` (a dict) collects the host ms of each swap-out
    and swap-in ("out", "in"; the stream drained before and after each
    call).  Returns the run's line."""
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    from repro_torch.serving import engine as engine_mod
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    outs, stats = {}, {}
    saved = engine_mod.swap_out_slot, engine_mod.swap_in_slot
    if swap_ms is not None:
        engine_mod.swap_out_slot = timed(dev, saved[0],
                                         swap_ms.setdefault("out", []))
        engine_mod.swap_in_slot = timed(dev, saved[1],
                                        swap_ms.setdefault("in", []))
    try:
        for leg, kw in (("swap", dict(kv_pages=kv_pages, host_kv_pages=64)),
                        ("roomy", {})):
            eng = InferenceEngine(cfg, params, EngineConfig(
                n_slots=2, max_len=1024, decode_block=4,
                paged_attention=True, **kw), device=dev)
            reqs = [Request(model=cfg.name, prompt=p,
                            sampling=SamplingParams(max_tokens=48))
                    for p in prompts]
            for r in reqs:
                assert eng.submit(r)
            eng.run_until_done()
            st = eng.perf_stats()
            if eng.pool.pages_in_use or st["host_pages_in_use"] \
                    or any(len(r.output) != 48 for r in reqs):
                raise AssertionError(f"{cfg.name} swap {leg}: pages held "
                                     "or budgets missed")
            outs[leg] = [r.output for r in reqs]
            stats[leg] = {k: st[k] for k in ("swap_outs", "swap_ins",
                                             "preemptions")}
            del eng
    finally:
        engine_mod.swap_out_slot, engine_mod.swap_in_slot = saved
    if stats["swap"]["swap_outs"] < 1 \
            or stats["swap"]["swap_ins"] != stats["swap"]["swap_outs"]:
        raise AssertionError(f"{cfg.name} swap: {stats}")
    return {"mode": f"{cfg.name}/swap_tier", "prompt_lens": list(lens),
            **stats["swap"], "match": outs["swap"] == outs["roomy"]}


def hymba_long_requests(cfg):
    """serve_hymba's long leg: 4 greedy requests with prompts of
    2100-3500 tokens (past the window of 2048 and the 128 meta tokens),
    budgets 16-32."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(4)
    return [Request(model=cfg.name,
                    prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    sampling=SamplingParams(max_tokens=m))
            for n, m in zip((2100, 2650, 3100, 3500), (16, 24, 32, 20))]


def serve_hymba(dev, ops, card, cfg=None):
    """The paper's hymba-1.5b at full width and depth (32 layers, d 1600,
    25 heads over 5, hd 64, d_ff 5504, vocab 32001 untied, ssm_state 16,
    128 meta tokens, window 2048 but in layers 0, 15 and 31; 1.31 B
    params by the config's count), bf16, seeded weights, launch counters
    at 0 just before each leg and read just after: (a) serve_bf16's
    engine and requests in the paged-attention mode, prompts capped at
    832 so that prompt + 128 + budget <= 1024; (b) the same under
    quantize="int8" in the gather mode; (c) max_len 4096 in the
    paged-attention mode with 4 prompts of 2100-3500 tokens, where the
    window masks.  Each leg holds exact budgets, every page returned,
    its exact launches and routes, one length a prefill admission
    (serve / check_serve), and prints tok/s, p50 step, TTFT and peak
    device memory.  `cfg` replaces the model (a CPU rehearsal).
    Returns ({leg: launches}, {leg: (routes, prefill shapes)})."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or ARCHS["hymba-1.5b"]
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    max_prompt = 1024 - cfg.n_meta_tokens - 64
    out = serve_legs("serve_hymba", dev, ops, card, cfg, params, (
        ("paged", dict(paged_attention=True, max_prompt=max_prompt)),
        ("int8", dict(quantize="int8", max_prompt=max_prompt)),
        ("long", dict(paged_attention=True, max_len=4096,
                      requests=lambda: hymba_long_requests(cfg)))))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_legs(phase, dev, ops, card, cfg, params, legs):
    """`serve` once a leg (name, serve's keyword arguments) of one model
    with its weights `params`, the device's cached memory returned after
    each.  Returns ({leg: launches}, {leg: (routes, prefill shapes)})."""
    launches, more = {}, {}
    for leg, kw in legs:
        launches[leg], *more[leg] = serve(phase, dev, ops, card, cfg=cfg,
                                          params=params, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    return launches, more


def hymba_timings(dev, ops, refs, q_lib, int8_m):
    """The int8 products at hymba-1.5b's shapes, bf16: decode M = 8 for
    wq, wk / wv, w_in, gate / up, down and the untied head (its 32001-byte
    rows on "skinny"), and w_in at serve_hymba's widest int8 prefill M
    `int8_m`; then its SSM branch, plain PyTorch as JAX's is jnp (no TPU
    kernel; ROADMAP B7): one layer's decode step over 8 slots and one
    layer's selective scan over 2048 tokens, against the bound of the
    bytes they must move (the state read and written, the inputs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models import build
    int8 = [int8_timing(dev, ops, refs, q_lib, f"hymba_decode_{k}x{n}", 8,
                        k, n, False, "skinny_tc" if n % 16 == 0
                        else "skinny")
            for k, n in HYMBA_INT8]
    int8.append(int8_timing(dev, ops, refs, q_lib, "hymba_prefill_w_in",
                            int8_m, 1600, 3200, False, "tensor_core"))
    cfg = dataclasses.replace(ARCHS["hymba-1.5b"], n_layers=1)
    lp = tf._layer(build(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(3)), 0)
    inner, n_state = cfg.n_heads * cfg.head_dim, cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(4)
    ssm = []
    x1 = torch.randn(8, cfg.d_model, generator=g, device=dev).bfloat16()
    h = torch.randn(8, inner, n_state, generator=g, device=dev)
    # the state in and out, f32; the branch's weights, bf16
    w_bytes = sum(v.numel() * v.element_size() for v in lp["ssm"].values())
    b_ms, b_by = bound(2 * h.numel() * 4 + w_bytes, 0, BF16_FLOPS)
    ssm.append({"label": "hymba_ssm_step", "shape": f"B=8 d={cfg.d_model} "
                f"inner={inner} N={n_state}, one layer", "route":
                "plain PyTorch", "ms": time_ms(
                    lambda: tf._hymba_ssm_step(lp["ssm"], x1, h)),
                "bound_ms": b_ms, "bound_by": b_by})
    S = 2048
    u, dt = (torch.randn(1, S, inner, generator=g, device=dev) for _ in "ab")
    dt = torch.nn.functional.softplus(dt - 4)
    A = -torch.exp(lp["ssm"]["a_log"])
    Bt, Ct = (torch.randn(1, S, n_state, generator=g, device=dev)
              for _ in "ab")
    h0 = torch.zeros(1, inner, n_state, device=dev)
    b_ms, b_by = bound(4 * (3 * u.numel() + 2 * Bt.numel()), 0, BF16_FLOPS)
    ssm.append({"label": "hymba_selective_scan", "shape":
                f"B=1 S={S} inner={inner} N={n_state} f32, chunks of "
                f"{ssm_lib.CHUNK}", "route": "plain PyTorch",
                "ms": time_ms(lambda: ssm_lib.selective_scan(
                    u, dt, A, Bt, Ct, h0), reps=10),
                "bound_ms": b_ms, "bound_by": b_by})
    out = {"int8_matmul": int8, "ssm": ssm}
    emit({"phase": "hymba_timings", **out})
    return out


# --------------------------------------------------------------------- #
# xLSTM and the encoder-decoder

# xlstm-125m's int8 products (K -> N): w_up (u and z), wq / wk / wv,
# w_down, ffn_wi, ffn_wo; its tied head is 768 -> 50304
XLSTM_INT8 = ((768, 3072), (1536, 1536), (1536, 768), (768, 2112),
              (2112, 768))
# seamless-m4t-large-v2's (K -> N): wq / wk / wv / wo (self and cross),
# the gelu FFN's wi and wo; its untied head, 1024 -> 256206, has rows of
# 256206 bytes, no whole number of 16-byte vectors ("skinny")
SEAMLESS_INT8 = ((1024, 1024), (1024, 8192), (8192, 1024))
ENCDEC_PARITY_LAYERS = 2    # of seamless's 24 + 24, the depth cut


def encdec_cut(cfg, n_layers):
    """An encoder-decoder at full width cut to n_layers decoder and
    n_layers encoder layers."""
    return dataclasses.replace(cfg, n_layers=n_layers,
                               encdec=dataclasses.replace(
                                   cfg.encdec, enc_layers=n_layers))


def parity_xlstm(dev, ops, cfg=None):
    """The paper's xlstm-125m at full width and depth (6 pairs of an
    mLSTM and an sLSTM block, d 768, 4 heads, vocab 50304 tied) in f32,
    the blocks' norm scales from a seed: greedy requests with prompts of
    5, 300, 640 and 900 tokens at decode_block 8 in the contiguous mode,
    through a paged-attention config (which serves contiguous: nothing to
    page, as in JAX) and under int8.  Each request's tokens must equal
    greedy_recompute (xLSTM's full forward at every step: a true
    recompute for a family admitted at its exact length; on the
    dequantized weights for int8), each admission hold rows of one
    length, and each run launch exactly its kernels (none; int8: 7 x 6
    + 1 int8 products a model call).  `cfg` replaces the model (a CPU
    rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or dataclasses.replace(ARCHS["xlstm-125m"], dtype="f32")
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(11))
    rng = np.random.default_rng(12)
    seed_norms(params, rng)
    lens, budgets = (5, 300, 640, 900), (12, 8, 5, 3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    runs = (("contiguous", dict(paged=False), "dense", set()),
            ("paged_config", dict(paged_attention=True), "dense", set()),
            ("int8", dict(quantize="int8"), "int8", {"int8_matmul"}))
    lines, mismatches = parity_runs("parity_xlstm", dev, ops, cfg, params,
                                    prompts, budgets, runs)
    if any(ln["paged"] for ln in lines):
        raise AssertionError("parity_xlstm: an xlstm engine paged")
    emit({"phase": "parity_xlstm", "model": cfg.name, "pairs":
          cfg.n_layers // 2, "d_model": cfg.d_model, "prompt_lens":
          list(lens), "budgets": list(budgets), "decode_block": 8,
          "runs": lines, "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_xlstm mismatches: {mismatches}")
    return lines


def parity_encdec(dev, ops, cfg=None):
    """The paper's seamless-m4t-large-v2 at full width (d 1024, 16 heads,
    hd 64, gelu d_ff 8192, vocab 256206 untied) cut to
    ENCDEC_PARITY_LAYERS encoder and decoder layers, f32, its norm scales
    from a seed, max_len 1024.  (a) Greedy requests with prompts of 10,
    300, 600 and 900 tokens in the paged-attention, gather and contiguous
    modes and in the gather mode under int8, each request's tokens equal
    to greedy_recompute (the engine and the recompute feed the encoder
    zero frames, under which the cross-attention adds exactly 0: ROADMAP
    C17), each run's launches exact (flash: the decoder's causal
    self-attention and the non-causal encoder and cross-attention; the
    decode kernel for the cross-attention in every mode); then the swap
    tier (prompts of 480 and 490 tokens on 64 pages with a host tier,
    equal to the same requests with room).  (b) With random frames, the only run on the
    card where the cross path carries values: the model's prefill of 2
    rows of 300 tokens over 1024 frames and 8 decode steps on the
    kernels (non-causal flash with Sq != Skv, the decode kernel over the
    cross K/V) against the same calls on the plain versions, within
    f32's 1e-4.  `cfg` replaces the model (a CPU rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    cfg = cfg or dataclasses.replace(
        encdec_cut(ARCHS["seamless-m4t-large-v2"], ENCDEC_PARITY_LAYERS),
        dtype="f32")
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(13))
    rng = np.random.default_rng(14)
    seed_norms(params, rng)
    lens, budgets = (10, 300, 600, 900), (16, 12, 8, 10)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    paged, gather = ({"paged_decode_attention", "flash_attention",
                      "decode_attention"},
                     {"decode_attention", "flash_attention"})
    runs = (("paged_attention", dict(paged_attention=True), "dense", paged),
            ("gather", {}, "dense", gather),
            ("contiguous", dict(paged=False), "dense", gather),
            ("gather_int8", dict(quantize="int8"), "int8",
             gather | {"int8_matmul"}))
    lines, mismatches = parity_runs("parity_encdec", dev, ops, cfg, params,
                                    prompts, budgets, runs)
    lines.append(swap_leg(dev, cfg, params, kv_pages=64, lens=(480, 490)))
    if not lines[-1]["match"]:
        mismatches.append(lines[-1])
    cross = encdec_cross_check(dev, ops, tf, cfg, params)
    emit({"phase": "parity_encdec", "model": cfg.name,
          "layers": [cfg.encdec.enc_layers, cfg.n_layers],
          "d_model": cfg.d_model, "prompt_lens": list(lens),
          "budgets": list(budgets), "runs": lines, "cross_path": cross,
          "match": not mismatches})
    if mismatches:
        raise AssertionError(f"parity_encdec mismatches: {mismatches}")
    return lines


def encdec_cross_check(dev, ops, tf, cfg, params, rows=2, n_tok=300,
                       src_len=1024, steps=8):
    """The cross path with random frames: prefill and `steps` decode
    steps (a contiguous cache) on the kernels, counted, then the same on
    the plain versions; logits and the cross K/V held within f32's
    tolerance.  Returns its line."""
    g = torch.Generator(device=dev).manual_seed(15)
    toks = torch.randint(0, cfg.vocab, (rows, n_tok), generator=g,
                         device=dev)
    src = torch.randn(rows, src_len, cfg.d_model, generator=g, device=dev)
    nxt = torch.randint(0, cfg.vocab, (steps, rows), generator=g,
                        device=dev, dtype=torch.int32)

    def run():
        logits, cache, pos = tf.prefill(params, cfg, toks, src_embeds=src)
        for name in ("k", "v"):
            kv = cache[name]
            cache[name] = kv.new_zeros((kv.shape[0], rows, n_tok + steps)
                                       + tuple(kv.shape[3:]))
            cache[name][:, :, :n_tok] = kv
        outs = [logits, cache["ck"].clone()]
        for tok in nxt:
            pos = pos + 1
            logits, cache = tf.decode_step(params, cfg, cache, tok, pos)
            outs.append(logits)
        return outs
    ops.reset_launches()
    got = run()
    launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    non_causal = ops.flash_attention.launches_non_causal
    n = cfg.n_layers
    if non_causal != cfg.encdec.enc_layers + n \
            or launched["flash_attention"] != cfg.encdec.enc_layers + 2 * n \
            or launched["decode_attention"] != 2 * n * steps:
        raise AssertionError(f"parity_encdec cross: launches {launched}, "
                             f"{non_causal} non-causal")
    with plain_attention(ops):
        want = run()
    if float(want[1].abs().max()) < 0.1:
        raise AssertionError("parity_encdec cross: the cross K/V are ~0")
    errs = [check_close(f"parity_encdec/cross_{i}", a, b, tol_of(a.dtype))
            for i, (a, b) in enumerate(zip(got, want))]
    return {"rows": rows, "tokens": n_tok, "src_len": src_len,
            "decode_steps": steps, "launches": launched,
            "flash_non_causal": non_causal,
            "max_abs_err_prefill_logits": errs[0],
            "max_abs_err_cross_k": errs[1],
            "max_abs_err_decode_logits": max(errs[2:]),
            "cross_k_max_abs": float(want[1].abs().max())}


def serve_xlstm(dev, ops, card, cfg=None):
    """The paper's xlstm-125m at full width and depth (6 pairs, d 768,
    vocab 50304 tied), bf16, seeded weights, under serve_bf16's engine
    and 12 requests (prompts 16-896), launch counters at 0 just before
    each leg and read just after: (a) the contiguous mode, (b) quantize=
    "int8" in the gather config (which serves contiguous: nothing to
    page).  Each leg holds exact budgets, one exact length a prefill
    admission, its exact launches (none; int8: 7 x 6 + 1 a model call)
    and routes, and placement's charge equal to the engine's bytes (the
    seven f32 state leaves), and prints tok/s, p50 step, TTFT and peak
    device memory.  `cfg` replaces the model (a CPU rehearsal).  Returns
    ({leg: launches}, {leg: (routes, prefill shapes)})."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or ARCHS["xlstm-125m"]
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    out = serve_legs("serve_xlstm", dev, ops, card, cfg, params, (
        ("contiguous", dict(paged=False)), ("int8", dict(quantize="int8"))))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_seamless(dev, ops, card, cfg=None):
    """The paper's seamless-m4t-large-v2 at full width and depth (24
    encoder and 24 decoder layers, d 1024, 16 heads, hd 64, gelu d_ff
    8192, vocab 256206 untied; 1.63 B params, 3.26 GB), bf16, seeded
    weights, under serve_bf16's engine and 12 requests (8 slots of 1024:
    the cross K/V, 805 MB, slot-resident), launch counters at 0 just
    before each leg and read just after: the paged-attention mode, the
    gather mode, and the gather mode under int8.  Each leg holds exact
    budgets and every page returned, its exact launches (flash: 24
    causal and 48 non-causal a prefill dispatch, counted on their own;
    the decode kernel for the cross-attention, >= 24 a decode step, in
    the paged leg too) and routes (the untied head's rows on "skinny"),
    and placement's charge equal to the engine's bytes, cross K/V
    included.  Then `seamless_swap_leg`.  `cfg` replaces the model (a
    CPU rehearsal).  Returns ({leg: launches}, {leg: (routes, prefill
    shapes)})."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = cfg or ARCHS["seamless-m4t-large-v2"]
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    legs, more = serve_legs("serve_seamless", dev, ops, card, cfg, params, (
        ("paged", dict(paged_attention=True)), ("gather", {}),
        ("int8", dict(quantize="int8"))))
    for leg in legs:
        if not more[leg][0]["flash_non_causal"] \
                or legs[leg]["decode_attention"] < cfg.n_layers:
            raise AssertionError(f"serve_seamless {leg}: launches "
                                 f"{legs[leg]}, routes {more[leg][0]}")
    seamless_swap_leg(dev, cfg, params, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return legs, more


def seamless_swap_leg(dev, cfg, params, card):
    """`swap_leg` at full width: prompts of 480 and 490 tokens on 64
    pages, each swap moving the slot's cross K/V rows (n_layers x 1024 x
    K x hd x 2 leaves: 100.7 MB in bf16) beside its private pages.  It
    prints the host ms of each swap-out and swap-in, and whether the
    tokens equal the same requests on a pool with room (bf16,
    informational: the batch differs)."""
    swap_ms = {}
    line = swap_leg(dev, cfg, params, kv_pages=64, lens=(480, 490),
                    swap_ms=swap_ms)
    row_bytes = 2 * cfg.n_layers * 1024 * cfg.n_kv_heads * cfg.head_dim \
        * params["embed"].element_size()
    line["tokens_equal_roomy"] = line.pop("match")
    emit({"phase": "serve_seamless_swap", **line,
          "cross_kv_bytes_a_slot": row_bytes,
          "host_ms_per_swap_out": float(np.mean(swap_ms["out"])),
          "host_ms_per_swap_in": float(np.mean(swap_ms["in"])),
          "swap_out_ms": swap_ms["out"], "swap_in_ms": swap_ms["in"],
          "card": card})


def xlstm_timings(dev, ops, refs, q_lib, int8_m):
    """xlstm-125m's rows, bf16: the int8 products at decode M = 8 (w_up,
    wq / wk / wv, w_down, ffn_wi, ffn_wo, the tied head) and w_up at
    serve_xlstm's widest int8 prefill M `int8_m`; then its cells, plain
    PyTorch as JAX's are jnp (no TPU kernel; ROADMAP B): one pair's
    decode step over 8 slots, and one pair's prefill over 896 tokens,
    the chunkwise mLSTM and the sLSTM scan apart, each against the bound
    of the bytes it must move and the f32 operations it must do (at the
    f32 peak outside the tensor cores: the cells run in f32)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xl
    int8 = [int8_timing(dev, ops, refs, q_lib, f"xlstm_decode_{k}x{n}", 8,
                        k, n, False, "skinny_tc") for k, n in XLSTM_INT8]
    int8.append(int8_timing(dev, ops, refs, q_lib, "xlstm_head", 8, 768,
                            50304, True, "skinny_tc"))
    int8.append(int8_timing(dev, ops, refs, q_lib, "xlstm_prefill_w_up",
                            int8_m, 768, 3072, False, "tensor_core"))
    cfg = dataclasses.replace(ARCHS["xlstm-125m"], n_layers=2)   # one pair
    d, inner, nh, hd_m, hd_s, _ = xl.dims(cfg)
    params = build(cfg, dev).init(torch.Generator(device=dev).manual_seed(3))
    mp, sp = xl._pair(params, 0)
    g = torch.Generator(device=dev).manual_seed(4)
    B, S = 8, 896
    cache = xl.init_cache(cfg, B, dev)
    h = torch.randn(B, d, generator=g, device=dev).bfloat16()
    w_bytes = sum(v.numel() * v.element_size()
                  for blk in (mp, sp) for v in blk.values())
    state = sum(v.numel() * 4 for v in cache.values())
    # 2 flops a multiply-add of every matrix (the projections, the
    # gates', the sLSTM's h @ r) a row, and the mLSTM's C (hd x hd a
    # head): its update (3 a value) and C @ q
    mat = sum(v.numel() for blk in (mp, sp) for v in blk.values()
              if v.dim() >= 2)
    step_flops = B * (2 * mat + 5 * nh * hd_m * hd_m)
    b_ms, b_by = bound(w_bytes + 2 * state + 2 * h.numel() * 2, step_flops,
                       BF16_FLOPS)
    cells = [{"label": "xlstm_pair_decode_step",
              "shape": f"B={B} d={d} inner={inner} H={nh} hd_m={hd_m} "
              f"hd_s={hd_s} bf16 weights, f32 state, one pair",
              "route": "plain PyTorch",
              "ms": time_ms(lambda: xl.pair_step(mp, sp, cfg, cache, 0, h)),
              "bound_ms": b_ms, "bound_by": b_by}]
    q, k, v = (torch.randn(1, S, nh, hd_m, generator=g, device=dev)
               .bfloat16() for _ in "qkv")
    i_raw, f_raw = (torch.randn(1, S, nh, generator=g, device=dev)
                    for _ in "if")
    f_raw += 3.0
    st0 = ssm_lib.mlstm_init_state(1, nh, hd_m, dev)
    pairs = S * (S + 1) // 2                 # visible causal (t, s) pairs
    b_ms, b_by = bound(4 * q.numel() * 2 + 2 * i_raw.numel() * 4
                       + sum(x.numel() * 4 for x in st0),
                       nh * (4 * hd_m * pairs + 4 * S * hd_m * hd_m),
                       F32_FLOPS)
    cells.append({"label": "xlstm_mlstm_chunkwise",
                  "shape": f"B=1 S={S} H={nh} hd={hd_m}, bf16 q/k/v, f32 "
                  f"inside, one chunk of {S} (S % {ssm_lib.CHUNK} != 0)",
                  "route": "plain PyTorch",
                  "ms": time_ms(lambda: ssm_lib.mlstm_chunkwise(
                      q, k, v, i_raw, f_raw, st0), reps=10),
                  "bound_ms": b_ms, "bound_by": b_by})
    xw = torch.randn(1, S, 4, nh, hd_s, generator=g, device=dev)
    s0 = ssm_lib.slstm_init_state(1, nh, hd_s, dev)
    r = sp["r"]
    b_ms, b_by = bound(xw.numel() * 4 + r.numel() * 4 + S * d * 4,
                       2 * S * nh * hd_s * 4 * hd_s, F32_FLOPS)
    cells.append({"label": "xlstm_slstm_scan",
                  "shape": f"B=1 S={S} H={nh} hd={hd_s} f32, "
                  f"{ssm_lib.SLSTM_STEP_OPS} launches a step",
                  "route": "plain PyTorch",
                  "ms": time_ms(lambda: ssm_lib.slstm_scan(xw, r, s0),
                                reps=5),
                  "bound_ms": b_ms, "bound_by": b_by})
    out = {"int8_matmul": int8, "cells": cells}
    emit({"phase": "xlstm_timings", **out})
    del params, cache, q, k, v, xw
    torch.cuda.empty_cache()
    return out


def encdec_timings(dev, ops, refs, q_lib, int8_m, cross_shape):
    """seamless-m4t-large-v2's kernel rows, bf16, each held against its
    plain version first: flash non-causal at the encoder's shape (B=4
    H=16 K=16 S=1024 hd=64) and at the cross-attention's (serve_seamless'
    widest prefill `cross_shape` = (rows, bucket) queries over 1024
    frames), against one unmasked SDPA call; the decode kernel at the
    cross-attention's decode shape (B=8 K=16 G=1 S=1024 hd=64, every
    position valid) against SDPA; the int8 products at decode M = 8
    (1024 -> 1024, 1024 -> 8192, 8192 -> 1024, the untied head 1024 ->
    256206 on "skinny") and 1024 -> 8192 at the widest int8 prefill M
    `int8_m` (the encoder's rows x 1024 frames).  Returns {kernel:
    [rows]}."""
    F = torch.nn.functional
    dt = torch.bfloat16
    H, K, hd, Skv = 16, 16, 64, 1024
    flash = []
    for label, B, Sq in (("seamless_encoder", 4, Skv),
                         ("seamless_cross",) + tuple(cross_shape)):
        rng = np.random.default_rng(16)

        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dt)
        q, k, v = t(B, H, Sq, hd), t(B, K, Skv, hd), t(B, K, Skv, hd)
        ref = refs["flash_attention"]
        got = on_route(ops.flash_attention, "tensor_core",
                       lambda: ops.flash_attention(q, k, v, causal=False))
        err = check_close(f"flash_attention/{label}", got,
                          ref(q, k, v, causal=False), tol_of(dt))
        b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                           4 * B * H * hd * Sq * Skv, BF16_FLOPS)
        flash.append({
            "label": label, "shape": f"B={B} H={H} K={K} Sq={Sq} Skv={Skv} "
            f"hd={hd} bf16 non-causal", "kernel_route": "tensor_core",
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v,
                                                      causal=False)),
            "plain_ms": time_ms(lambda: ref(q, k, v, causal=False), reps=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v))})
        del q, k, v
    B = 8
    q, k, v, p = decode_case(dev, dt, B=B, K=K, G=1, S=Skv, hd=hd,
                             pos=[Skv - 1] * B, seed=17, strided=True)
    ref = refs["decode_attention"]
    err = check_close("decode_attention/seamless_cross",
                      ops.decode_attention(q, k, v, p), ref(q, k, v, p),
                      tol_of(dt))
    b_ms, b_by = bound(2 * B * Skv * K * hd * 2 + 2 * B * K * hd * 2 + B * 4,
                       4 * B * Skv * K * hd, BF16_FLOPS)
    decode = [{
        "label": "seamless_cross", "shape": f"B={B} K={K} G=1 S={Skv} "
        f"hd={hd} bf16, (B, S, K, hd) cross K/V view, every position valid",
        "splits": dict(zip(("n_split", "chunk"), ops.decode_attention_splits(
            B, K, Skv, ops._sm_count(dev.index)))),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.decode_attention(q, k, v, p)),
        "plain_ms": time_ms(lambda: ref(q, k, v, p), reps=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q.reshape(B, K, 1, hd), k, v))}]
    del q, k, v
    int8 = [int8_timing(dev, ops, refs, q_lib, f"seamless_decode_{kd}x{n}",
                        8, kd, n, False, "skinny_tc")
            for kd, n in SEAMLESS_INT8]
    int8.append(int8_timing(dev, ops, refs, q_lib, "seamless_head", 8, 1024,
                            256206, False, "skinny"))
    int8.append(int8_timing(dev, ops, refs, q_lib, "seamless_prefill_wi",
                            int8_m, 1024, 8192, False, "tensor_core"))
    out = {"flash_attention": flash, "decode_attention": decode,
           "int8_matmul": int8}
    for rows in out.values():
        for r in rows:
            r["vs_library"] = (r["ms"] / r["library_ms"]
                               if r["library_ms"] else None)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# the trainer and the int8 KV cache

TRAIN_LAYERS = 2            # of olmo-1b's 16 in parity_train and kv_quant


def hold_grads(name, got, want, tol=1e-4) -> float:
    """Each gradient leaf (card) within tol of the largest magnitude of
    its CPU counterpart; xLSTM's input-gate bias b_i against its gate
    weight w_i's, as tests/test_torch_loss.py holds it (its gradient is
    0 in exact arithmetic but for the exp(-m) floor, so what is left is
    rounding).  Returns the worst err / scale over the leaves."""
    from repro_torch.training.tree import items
    scale = {p: float(w.abs().max()) for p, w in items(want)}
    worst = 0.0
    for (path, g), (_, w) in zip(items(got), items(want)):
        ref = scale["pairs/mlstm/w_i" if path == "pairs/mlstm/b_i"
                    else path]
        err = float((g.float().cpu() - w.float()).abs().max())
        if not err <= tol * ref or not ref > 0:
            raise AssertionError(f"{name} {path}: gradient error {err:.3e}"
                                 f" beyond {tol} x {ref:.3e}")
        worst = max(worst, err / ref)
    return worst


def parity_train(dev, ops, olmo=None, xlstm=None):
    """The trainer's numerics on the card against the port's CPU path (the
    plain PyTorch that the CPU tests hold against JAX): OLMo-1B at full
    width cut to TRAIN_LAYERS of 16 layers and the full xlstm-125m (6
    pairs), both in f32, seeded weights (xLSTM's norm scales from a seed
    too), one batch of 2 x 128 tokens: the loss under remat (within 1e-5
    relative) and every gradient leaf (within 1e-4 of its largest
    magnitude) by autograd; then one AdamW step at step 5 (lr 1e-3, the
    clip binding or not) from the CPU's gradients on both devices, the
    params and moments within 1e-6 of each leaf's scale (at least 1).
    No kernel runs (training attends in plain PyTorch): the launch counts
    stay 0.  `olmo` / `xlstm` replace the models (a CPU rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.tree import items, leaves, map_tree
    cpu = torch.device("cpu")
    olmo = olmo or dataclasses.replace(ARCHS["olmo-1b"], dtype="f32",
                                       n_layers=TRAIN_LAYERS)
    xlstm = xlstm or dataclasses.replace(ARCHS["xlstm-125m"], dtype="f32")
    rows = []
    for cfg, seed in ((olmo, 21), (xlstm, 22)):
        params = build(cfg, cpu).init(torch.Generator().manual_seed(seed))
        rng = np.random.default_rng(seed)
        seed_norms(params, rng)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 129))
                                .astype(np.int32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].contiguous()}
        on_card = map_tree(lambda t: t.to(dev), params)
        ops.reset_launches()
        t0 = time.perf_counter()
        g_card, m_card = loss_and_grads(build(cfg, dev), on_card,
                                        {k: v.to(dev)
                                         for k, v in batch.items()})
        sync(dev)
        card_s = time.perf_counter() - t0
        launched = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        if any(launched.values()):
            raise AssertionError(f"parity_train: kernels launched "
                                 f"{launched}")
        t0 = time.perf_counter()
        g_cpu, m_cpu = loss_and_grads(build(cfg, cpu), params, batch)
        cpu_s = time.perf_counter() - t0
        loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
            / abs(float(m_cpu["loss"]))
        if not loss_err <= 1e-5:
            raise AssertionError(f"parity_train {cfg.name}: loss "
                                 f"{float(m_card['loss'])} vs "
                                 f"{float(m_cpu['loss'])}")
        grad_worst = hold_grads(f"parity_train {cfg.name}", g_card, g_cpu)
        ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        step = torch.tensor(5, dtype=torch.int32)
        new = {}
        for d, p in ((cpu, params), (dev, on_card)):
            new[d.type] = opt_lib.adamw_update(
                p, map_tree(lambda g: g.to(d), g_cpu), opt_lib.adamw_init(p),
                step.to(d), ocfg)
        opt_worst = 0.0
        for part in ((0,), (1, "m"), (1, "v")):
            got, want = new[dev.type][part[0]], new["cpu"][part[0]]
            if len(part) > 1:
                got, want = got[part[1]], want[part[1]]
            for (path, g), w in zip(items(got), leaves(want)):
                scale = max(1.0, float(w.float().abs().max()))
                err = float((g.float().cpu() - w.float()).abs().max())
                if not err <= 1e-6 * scale:
                    raise AssertionError(f"parity_train {cfg.name} adamw "
                                         f"{part} {path}: {err:.3e}")
                opt_worst = max(opt_worst, err / scale)
        rows.append({"model": cfg.name, "layers": cfg.n_layers,
                     "d_model": cfg.d_model, "batch": [2, 128],
                     "loss": float(m_card["loss"]),
                     "loss_rel_err": loss_err,
                     "grad_worst_err_over_scale": grad_worst,
                     "adamw_worst_err_over_scale": opt_worst,
                     "grad_norm": float(new[dev.type][2]["grad_norm"]),
                     "card_s": card_s, "cpu_s": cpu_s, "launches": launched})
        del params, on_card, g_card, g_cpu, new
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "parity_train", "tolerances": {
        "loss_rel": 1e-5, "grad": "1e-4 x max|g| a leaf",
        "adamw": "1e-6 x max(1, max|p|) a leaf"}, "models": rows})
    return rows


KV_ROWS, KV_PROMPT, KV_LEN, KV_STEPS = 8, 1000, 1024, 8


def kv_prefill(dev, ops, cfg, params, prompts, kv_quant):
    """prefill(cache_len=KV_LEN, kv_quant=) of the prompts on `dev`.
    Returns (the cache, pos, the flash kernel's launches)."""
    from repro_torch.models import build
    ops.reset_launches()
    with torch.no_grad():
        _, cache, pos = build(cfg, dev).prefill(
            params, prompts.to(dev), cache_len=KV_LEN, kv_quant=kv_quant)
    return cache, pos, ops.flash_attention.launches


def kv_decode(dev, ops, cfg, params, cache, pos, feed):
    """One decode step a column of `feed` (teacher-forced tokens, the
    same on every device) from `cache` (advanced in place) at pos + 1.
    Returns (the steps' logits (steps, B, V) f32 on the host, the decode
    kernel's launches a step, host ms a step)."""
    from repro_torch.models import build
    model = build(cfg, dev)
    dec = ops.decode_attention
    out, per_step, step_ms = [], [], []
    with torch.no_grad():
        for j in range(feed.shape[1]):
            before = dec.launches
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = model.decode(params, cache, feed[:, j].to(dev),
                                         pos + 1 + j)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(dec.launches - before)
            out.append(logits.float().cpu())
    return torch.stack(out), per_step, step_ms


def kv_prefill_close(card, cpu):
    """The card's prefilled int8 cache against the CPU's: scales within
    1e-5 relative; q within one step, apart in under 1% of the values
    (K and V round differently on the two devices, by ulps, and move a
    value at a .5 tie).  Returns (the worst scale error, the count of q
    values apart)."""
    worst, apart = 0.0, 0
    for name in ("k", "v"):
        got, want = card[f"{name}_scale"].cpu(), cpu[f"{name}_scale"]
        worst = max(worst, float(((got - want).abs()
                                  / want.abs().clamp_min(1e-30)).max()))
        dq = (card[name].cpu().int() - cpu[name].int()).abs()
        if int(dq.max()) > 1 or float((dq > 0).float().mean()) >= 1e-2:
            raise AssertionError(f"kv_quant: {name} q apart by "
                                 f"{int(dq.max())} in {int((dq > 0).sum())}")
        apart += int((dq > 0).sum())
    if not worst <= 1e-5:
        raise AssertionError(f"kv_quant: scales apart by {worst:.3e}")
    return worst, apart


def kv_quant(dev, ops, card, cfg=None, full=None):
    """The int8 KV cache (transformer.prefill(kv_quant=True) and
    decode_step's quantized branch) on OLMo-1B at full width.  (a) f32,
    cut to TRAIN_LAYERS layers: KV_ROWS prompts of KV_PROMPT tokens
    prefilled into an int8 cache of KV_LEN, then KV_STEPS teacher-forced
    decode steps.  The card's int8 cache against the CPU's prefill of the
    same prompts (the plain versions): scales within 1e-5 relative, q
    within one step, apart in under 1% (the count printed): quantizing
    is discontinuous, and the two devices' K and V differ by ulps.  The
    decode steps from the card's prefilled cache, on the card and on the
    CPU: the logits within f32's 1e-4 up to the first step whose new K or
    V rounds to another int8 value on the two devices (counted, compared
    in the caches after the steps), and from there within the
    quantization's 0.05 of the logit scale; and within 0.05 of the scale
    of the card's f32-cache logits (argmax agreement printed); the
    flash kernel n_layers times in the prefill, the decode kernel
    exactly n_layers times a step, over the dequantized f32 cache: its
    f32 route (the wrapper refuses a q and caches of two dtypes). (b)
    The full OLMo-1B (16 layers, bf16): the same traffic through the
    int8 cache and through the bf16 cache, the launches as in (a), the
    KV bytes (int8 + f32 scales) under 0.6 x the bf16 cache's, host ms a
    decode step for each. Then the decode kernel's f32 route timed at
    (b)'s shape (B=8 K=16 G=1 S=1024 hd=128 over the dequantized cache,
    pos 1000-1007) beside its plain version, its bound and SDPA. `cfg` /
    `full` replace the models (a CPU rehearsal). Returns (the f32
    route's timing row, whose launches are (a) and (b)'s decode
    launches, {kernel: launches in (a) and (b)})."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.models import build
    from repro_torch.training.tree import map_tree
    F = torch.nn.functional
    cpu = torch.device("cpu")
    cfg = cfg or dataclasses.replace(ARCHS["olmo-1b"], dtype="f32",
                                     n_layers=TRAIN_LAYERS)
    full = full or ARCHS["olmo-1b"]
    rng = np.random.default_rng(31)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (KV_ROWS, KV_PROMPT)).astype(np.int32))
    feed = torch.from_numpy(rng.integers(
        0, cfg.vocab, (KV_ROWS, KV_STEPS)).astype(np.int32))
    params = build(cfg, cpu).init(torch.Generator().manual_seed(31))
    on_card = map_tree(lambda t: t.to(dev), params)
    c8, pos, flash = kv_prefill(dev, ops, cfg, on_card, prompts, True)
    start = {k: v.cpu() for k, v in c8.items()}     # before decode moves it
    scale_err, apart = kv_prefill_close(c8, kv_prefill(
        cpu, ops, cfg, params, prompts, True)[0])
    q8, per_step, _ = kv_decode(dev, ops, cfg, on_card, c8, pos, feed)
    want = kv_decode(cpu, ops, cfg, params, start, pos.cpu(), feed)[0]
    # the decode steps' writes (positions KV_PROMPT + j), card vs CPU
    step_flips = [sum(int((c8[name][:, :, KV_PROMPT + j].cpu().int()
                           - start[name][:, :, KV_PROMPT + j].int())
                          .abs().gt(0).sum()) for name in ("k", "v"))
                  for j in range(KV_STEPS)]
    first = next((j for j, f in enumerate(step_flips) if f), KV_STEPS)
    dense = kv_decode(dev, ops, cfg, on_card,
                      *kv_prefill(dev, ops, cfg, on_card, prompts, False)[:2],
                      feed)[0]
    n = cfg.n_layers
    if flash != n or per_step != [n] * KV_STEPS \
            or c8["k"].dtype != torch.int8 \
            or c8["k_scale"].dtype != torch.float32:
        raise AssertionError(f"kv_quant: flash {flash}, decode a step "
                             f"{per_step}, cache {c8['k'].dtype}")
    err = check_close("kv_quant/card_vs_cpu", q8[:first], want[:first],
                      1e-4) if first else None
    scale = max(float(dense.abs().max()), 1.0)
    flip_err = float((q8[first:] - want[first:]).abs().max()) \
        if first < KV_STEPS else None
    if flip_err is not None and not flip_err < 0.05 * scale:
        raise AssertionError(f"kv_quant: past a flipped write {flip_err:.3e}"
                             f" beyond 0.05 x {scale:.3e}")
    quant_err = float((q8 - dense).abs().max())
    if not quant_err < 0.05 * scale:
        raise AssertionError(f"kv_quant: int8 vs f32 cache {quant_err:.3e}"
                             f" beyond 0.05 x {scale:.3e}")
    agree = int((q8.argmax(-1) == dense.argmax(-1)).sum())
    checks = {"model": cfg.name, "layers": n, "dtype": cfg.dtype,
              "rows": KV_ROWS, "prompt": KV_PROMPT, "cache_len": KV_LEN,
              "steps": KV_STEPS, "prefill_scale_rel_err": scale_err,
              "prefill_q_apart": f"{apart} of {2 * start['k'].numel()}",
              "card_vs_cpu_max_abs_err": err,
              "decode_write_flips_a_step": step_flips,
              "card_vs_cpu_after_a_flip_max_abs": flip_err,
              "int8_vs_f32_cache_max_abs": quant_err, "logit_scale": scale,
              "argmax_agree": f"{agree} of {KV_ROWS * KV_STEPS}",
              "flash_launches": flash, "decode_launches_a_step": per_step,
              "k_dtype": str(c8["k"].dtype)}
    del params, on_card, c8
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the full model in bf16
    fparams = build(full, dev).init(torch.Generator(device=dev)
                                    .manual_seed(32))
    fc8, fpos, fflash = kv_prefill(dev, ops, full, fparams, prompts, True)
    f8, fstep, ms8 = kv_decode(dev, ops, full, fparams, fc8, fpos, feed)
    fc16, fpos16, _ = kv_prefill(dev, ops, full, fparams, prompts, False)
    f16, _, ms16 = kv_decode(dev, ops, full, fparams, fc16, fpos16, feed)
    nf = full.n_layers
    if fflash != nf or fstep != [nf] * KV_STEPS:
        raise AssertionError(f"kv_quant full: flash {fflash}, decode a step"
                             f" {fstep}")
    kv8 = sum(fc8[k].numel() * fc8[k].element_size()
              for k in ("k", "v", "k_scale", "v_scale"))
    kv16 = sum(fc16[k].numel() * fc16[k].element_size() for k in ("k", "v"))
    if not kv8 < 0.6 * kv16:
        raise AssertionError(f"kv_quant: int8 KV {kv8} B vs bf16 {kv16} B")
    if not bool(torch.isfinite(f8).all()):
        raise AssertionError("kv_quant full: non-finite logits")
    full_row = {"model": full.name, "layers": nf, "dtype": full.dtype,
                "kv_bytes_int8": kv8, "kv_bytes_bf16": kv16,
                "ratio": kv8 / kv16, "flash_launches": fflash,
                "decode_launches_a_step": fstep,
                "argmax_agree_vs_bf16_cache":
                    f"{int((f8.argmax(-1) == f16.argmax(-1)).sum())} of "
                    f"{KV_ROWS * KV_STEPS}",
                "decode_step_ms_p50_int8": pct(ms8[1:], 50),
                "decode_step_ms_p50_bf16": pct(ms16[1:], 50)}
    del fparams, fc8, fc16
    gc.collect()
    torch.cuda.empty_cache()
    # the decode kernel's f32 route at (b)'s shape, over a dequantized
    # (B, S, K, hd) cache
    K, G, hd, S = full.n_kv_heads, full.n_heads // full.n_kv_heads, \
        full.head_dim, KV_LEN
    pos = [KV_PROMPT + j for j in range(KV_ROWS)]
    q, k, v, p = decode_case(dev, torch.float32, B=KV_ROWS, K=K, G=G, S=S,
                             hd=hd, pos=pos, seed=33, strided=True)
    kerr = check_close("decode_attention/f32_route", ops.decode_attention(
        q, k, v, p), decode_attention_ref(q, k, v, p), 1e-4)
    n_kv = sum(x + 1 for x in pos)
    b_ms, b_by = bound(2 * n_kv * K * hd * 4 + 2 * KV_ROWS * K * G * hd * 4
                       + KV_ROWS * 4, 4 * n_kv * K * G * hd, F32_FLOPS)
    mask = (torch.arange(S, device=dev)[None, :]
            <= p[:, None].long())[:, None, None, :]
    row = {"label": "olmo-1b int8 KV (f32 route)",
           "shape": f"B={KV_ROWS} K={K} G={G} S={S} hd={hd} f32, "
                    f"(B, S, K, hd) dequantized cache view, pos "
                    f"{pos[0]}-{pos[-1]}",
           "splits": dict(zip(("n_split", "chunk"),
                              ops.decode_attention_splits(
                                  KV_ROWS, K, S, ops._sm_count(dev.index)))),
           "max_abs_err": kerr,
           "ms": time_ms(lambda: ops.decode_attention(q, k, v, p)),
           "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, p),
                               reps=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask)),
           "launches": KV_STEPS * (n + nf)}
    row["vs_library"] = row["ms"] / row["library_ms"]
    emit({"phase": "kv_quant", "checks": checks, "full": full_row,
          "f32_route": row, "card": card})
    return row, {"paged_decode_attention": 0, "flash_attention": n + nf,
                 "decode_attention": row["launches"], "int8_matmul": 0}


@contextlib.contextmanager
def timed_train_steps(dev):
    """Time every train step the trainers built inside the block run
    (`train_loop.make_train_step`'s step and the compressed step), the
    stream drained before and after each: its host ms, its device work
    included.  Yields the list of ms."""
    from repro_torch.training import train_loop
    times = []
    make = train_loop.make_train_step
    comp = train_loop.Trainer._compressed_step

    def timed_make(*args, **kw):
        step, init = make(*args, **kw)
        return timed(dev, step, times), init

    def timed_comp(self, state, batch):
        return timed(dev, lambda s, b: comp(self, s, b), times)(state, batch)
    train_loop.make_train_step = timed_make
    train_loop.Trainer._compressed_step = timed_comp
    try:
        yield times
    finally:
        train_loop.make_train_step = make
        train_loop.Trainer._compressed_step = comp


def state_bytes(state) -> int:
    from repro_torch.training.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(state))


def train_xlstm(dev, card, argv=()):
    """The example repro_torch/examples/train_100m.py's code path on the
    full xlstm-125m (6 pairs, d 768, vocab 50304, bf16 params, f32
    moments) with its own settings (batch 4, seq 64, 60 steps, lr 6e-4,
    warmup 10, checkpoints every 15 under build/): the last logged loss
    below the first; then the --crash-at 30 leg (train 30 steps, a new
    Trainer resumes from the checkpoint at 30 to 60), whose params,
    moments and step equal the uninterrupted run's bit for bit.  Then
    the final state saved once more and restored, each timed.  It prints
    step ms p50 and the checkpoints' size.  `argv` adds flags (a CPU
    rehearsal: --tiny)."""
    from repro_torch.examples import train_100m
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.tree import items, leaves
    root = ROOT / "build" / "train_xlstm"
    shutil.rmtree(root, ignore_errors=True)
    log = []
    with timed_train_steps(dev) as ms:
        whole = train_100m.train(train_100m.parse(
            ["--device", str(dev), "--ckpt", str(root / "whole"), *argv]),
            log=log.append)
        steps_whole = list(ms)
        crash = train_100m.train(train_100m.parse(
            ["--device", str(dev), "--ckpt", str(root / "crash"),
             "--crash-at", "30", *argv]), log=log.append)
    losses = [h["loss"] for h in whole["history"]]
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise AssertionError(f"train_xlstm: losses {losses}")
    if crash["resumed_from"] != 30:
        raise AssertionError(f"train_xlstm: resumed from "
                             f"{crash['resumed_from']}")
    for (path, a), b in zip(items(whole["state"]), leaves(crash["state"])):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"train_xlstm: crash-resume differs at "
                                 f"{path}")
    ckpt = root / "timed.msgpack"
    sync(dev)
    t0 = time.perf_counter()
    ckpt_lib.save(whole["state"], ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt_lib.restore(ckpt, whole["state"])
    sync(dev)
    restore_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(whole["state"]))):
        raise AssertionError("train_xlstm: restore differs")
    size = ckpt.stat().st_size
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_xlstm", "steps": 60, "batch": 4, "seq": 64,
          "losses": losses, "history_steps":
          [h["step"] for h in whole["history"]],
          "step_ms_p50": pct(steps_whole[1:], 50),
          "first_step_ms": steps_whole[0],
          "tokens_per_s": 4 * 64 / (pct(steps_whole[1:], 50) / 1e3),
          "crash_resume_bitwise": True, "resumed_from": 30,
          "ckpt_bytes": size, "state_bytes": state_bytes(whole["state"]),
          "ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
          "wall_s": whole["wall_s"], "card": card})
    del whole, crash, back
    gc.collect()
    torch.cuda.empty_cache()


def with_error(state, comp_lib):
    """state with a zero error-feedback tree ("err") for compress_grads."""
    state["err"] = comp_lib.init_error(state["params"])
    return state


def train_olmo(dev, card, cfg=None, batch=4, seq=1024):
    """The full OLMo-1B (16 layers, d 2048, vocab 50304, bf16 params, f32
    moments) trained under remat: batch 4 x seq 1024, lr 3e-4, warmup 2,
    8 steps, then 4 more with compress_grads (the int8 error feedback;
    the state goes on from step 8), no checkpoint, every step logged.
    Every loss finite and the last below the first.  It prints step ms
    p50 (the first step apart), tokens/s, the model-FLOP rate
    (`roofline.model_flops_for`: 6 N D) as a share of the data-sheet
    989 TFLOP/s bf16 peak, the peak device memory and the state's bytes.
    `cfg`, `batch`, `seq` replace the model and shape (a CPU
    rehearsal)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.roofline import model_flops_for
    from repro_torch.training import compression as comp_lib
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = cfg or ARCHS["olmo-1b"]
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=12)
    ckpt_dir = str(ROOT / "build" / "train_olmo")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with timed_train_steps(dev) as ms:
        plain = Trainer(cfg, dc, TrainConfig(steps=8, ckpt_every=0,
                                             log_every=1, ckpt_dir=ckpt_dir),
                        ocfg, device=dev).run(resume=False)
        n_state = state_bytes(plain["state"])
        # the run is the state's only holder: each step frees the last
        comp = Trainer(cfg, dc, TrainConfig(steps=12, ckpt_every=0,
                                            log_every=1, ckpt_dir=ckpt_dir,
                                            compress_grads=True),
                       ocfg, device=dev).run(
            resume=False, state=with_error(plain.pop("state"), comp_lib))
    losses = [h["loss"] for h in plain["history"] + comp["history"]]
    if len(losses) != 12 or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train_olmo: losses {losses}")
    p50 = pct(ms[1:8], 50)
    p50_comp = pct(ms[8:], 50)
    flops = model_flops_for(cfg, ShapeSpec("train_olmo", "train", seq,
                                           batch))
    emit({"phase": "train_olmo", "model": cfg.name, "layers": cfg.n_layers,
          "batch": batch, "seq": seq, "remat": True, "losses": losses,
          "step_ms": ms, "step_ms_p50": p50, "first_step_ms": ms[0],
          "step_ms_p50_compressed": p50_comp,
          "tokens_per_s": batch * seq / (p50 / 1e3),
          "model_flops": flops,
          "model_flop_rate_share_of_989_tflops": flops / (p50 / 1e3)
          / BF16_FLOPS,
          "peak_note": "989 TFLOP/s: the H100 SXM data-sheet dense bf16 "
                       "peak at 700 W",
          "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None),
          "state_bytes": n_state,
          "state_bytes_with_err": state_bytes(comp["state"]),
          "card": card})
    del plain, comp
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


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
    meter = DropMeter(eng) if cfg.moe else None
    try:
        gc.collect()
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        with meter or contextlib.nullcontext():
            step_ms = drive(eng, wave1)[0] + drive(eng, wave2)[0]
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
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
          "p50_ttft_ms": float(np.median([r.ttft for r in reqs])) * 1e3,
          "p50_step_ms": float(np.median(step_ms)), "peak_mem_bytes": peak,
          **(meter.report() if meter else {}),
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
        meter = DropMeter(eng) if cfg.moe else None
        gc.collect()
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        with meter or contextlib.nullcontext():
            step_ms, wall = drive(eng, reqs)
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        st = eng.perf_stats()
        check_serve(f"serve_spec (speculative={on})", cfg, ecfg, eng, reqs,
                    launches)
        if eng.pool.pages_in_use:
            raise AssertionError(f"{eng.pool.pages_in_use} pages held")
        out[on] = (reqs, st, launches, wall, step_ms,
                   torch.cuda.max_memory_allocated(dev),
                   meter.report() if meter else {})
        del eng
    reqs, st, launches, wall, step_ms, peak, drops = out[True]
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
          "p50_ttft_ms": float(np.median([r.ttft for r in reqs])) * 1e3,
          "peak_mem_bytes": peak, **drops,
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


def http_requests(cfgs, models, max_len):
    """serve_http's traffic, from a seed: 16 requests alternating between
    the two models, 8 on /v1/chat/completions (a system turn and a user
    turn, rendered by the model's template to 150-700 byte-tokens) and 8
    on /v1/completions (token-id prompts of 16-512), budgets 16-64, 12
    greedy and 4 sampled, half streamed; tenants "acme" and "lab" take 7
    each, of both models, and "capped" 2.  Then three error paths:
    "acme" streams one more completion and cancels it after its 4th
    token, "lab" sends a prompt one token past the context (400), and
    "capped" a third request, past its bucket of 2 (429)."""
    from repro_torch.api.http import ChatMessage, render_prompt
    rng = np.random.default_rng(4)
    letters = list("abcdefghijklmnopqrstuvwxyz    ")
    specs = []
    for i in range(16):
        model = models[i % 2]
        cfg = cfgs[model]
        s = {"i": i, "model": model, "budget": int(rng.integers(16, 65)),
             "stream": (i // 4) % 2 == 0, "sampled": i in (5, 6, 9, 14),
             "tenant": (("acme", "lab")[(i + i // 2) % 2] if i < 14
                        else "capped"),
             "expect": "ok"}
        if (i // 2) % 2 == 0:
            n = int(rng.integers(80, 500))
            cut = int(rng.integers(20, 80))
            text = "".join(rng.choice(letters, n))
            s["kind"] = "chat"
            s["messages"] = [ChatMessage("system", text[:cut]),
                             ChatMessage("user", text[cut:])]
            s["prompt"] = list(render_prompt(model, s["messages"], cfg))
            if not 150 <= len(s["prompt"]) <= 700:
                raise AssertionError(f"chat prompt of {len(s['prompt'])}")
        else:
            s["kind"] = "completion"
            s["prompt"] = rng.integers(
                0, cfg.vocab, int(rng.integers(16, 513))).tolist()
        specs.append(s)
    extra = [("acme", "cancel", 64, 200), ("lab", "too_long", 16,
                                           max_len + 1),
             ("capped", "rate_limited", 16, 32)]
    for k, (tenant, expect, budget, n) in enumerate(extra):
        model = models[k % 2]
        specs.append({"i": 16 + k, "model": model, "kind": "completion",
                      "prompt": rng.integers(0, cfgs[model].vocab,
                                             n).tolist(),
                      "budget": budget, "stream": expect == "cancel",
                      "sampled": False, "tenant": tenant, "expect": expect})
    return specs


def http_call(client, s, canceller, timeout_s):
    """One request of serve_http over `client`'s keep-alive connection;
    a stream expected to be cancelled is, through `canceller`, once its
    4th token is in.  Returns what came back."""
    from repro_torch.api.http import HTTPClientError
    from repro_torch.api.types import ErrorCode
    kw = dict(max_tokens=s["budget"], stream=s["stream"],
              timeout_s=timeout_s)
    if s["sampled"]:
        kw.update(temperature=0.8, top_k=40, top_p=0.95)
    call, arg = ((client.chat, s["messages"]) if s["kind"] == "chat"
                 else (client.complete, s["prompt"]))
    t0 = time.perf_counter()
    try:
        if not s["stream"]:
            out = call(s["model"], arg, **kw)
            ch = out["choices"][0]
            return {"tokens": ch["token_ids"],
                    "indices": list(range(len(ch["token_ids"]))),
                    "usage": out["usage"], "finish": ch["finish_reason"],
                    "node": out["metadata"]["node"],
                    "total_s": time.perf_counter() - t0,
                    "gateway_latency_s": out["metadata"]["latency_s"]}
        rec = {"tokens": [], "indices": [], "usage": None, "finish": None,
               "first_s": None, "error": None}
        for chunk in call(s["model"], arg, **kw):
            if "error" in chunk:
                rec["error"] = chunk["error"]
                continue
            c0 = chunk["choices"][0]
            d = c0.get("delta", c0)
            if d.get("token") is not None:
                if rec["first_s"] is None:
                    rec["first_s"] = time.perf_counter() - t0
                rec["tokens"].append(d["token"])
                rec["indices"].append(d["token_index"])
                if s["expect"] == "cancel" and len(rec["tokens"]) == 4:
                    rid = int(chunk["id"].rsplit("-", 1)[1])
                    rec["cancelled"] = canceller.cancel(rid)
            if c0.get("finish_reason"):
                rec["finish"] = c0["finish_reason"]
            if "usage" in chunk:
                rec["usage"] = chunk["usage"]
        rec["total_s"] = time.perf_counter() - t0
        return rec
    except HTTPClientError as e:
        return {"status": e.status,
                "code": e.code.value if isinstance(e.code, ErrorCode)
                else None}


def check_http(specs, outs, cfgs):
    """serve_http's per-request checks: exact budgets, contiguous stream
    indices equal to usage, the error paths' statuses."""
    for s, o in zip(specs, outs):
        where = f"serve_http request {s['i']} ({s['tenant']}, {s['kind']})"
        if o is None:
            raise AssertionError(f"{where}: no answer")
        if s["expect"] == "too_long":
            if (o.get("status"), o.get("code")) != (400, "invalid_request"):
                raise AssertionError(f"{where}: {o}")
            continue
        if s["expect"] == "rate_limited":
            if (o.get("status"), o.get("code")) != (429, "rate_limited"):
                raise AssertionError(f"{where}: {o}")
            continue
        n = len(o.get("tokens", ()))
        if o.get("indices") != list(range(n)):
            raise AssertionError(f"{where}: token indices {o.get('indices')}")
        if any(not 0 <= t < cfgs[s["model"]].vocab for t in o["tokens"]):
            raise AssertionError(f"{where}: token outside the vocabulary")
        if s["expect"] == "cancel":
            err = o.get("error") or {}
            if not o.get("cancelled") or err.get("code") != 499 \
                    or not 4 <= n < s["budget"]:
                raise AssertionError(f"{where}: {o}")
            continue
        want_usage = {"prompt_tokens": len(s["prompt"]),
                      "completion_tokens": s["budget"],
                      "total_tokens": len(s["prompt"]) + s["budget"]}
        if n != s["budget"] or o["usage"] != want_usage \
                or o["finish"] != "length" or o.get("error"):
            raise AssertionError(f"{where}: {n} tokens of {s['budget']}, "
                                 f"usage {o['usage']}, {o.get('error')}")


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def serve_http(dev, ops, card, argv=None, timeout_s=600):
    """The launcher's own `build_service` in-process, with its defaults:
    the full llama3.2-1b and gemma3-1b (bf16, seeded weights, one tree
    per model) at two replicas each, placed by VRAM on the paper's
    testbed, every replica a real engine on the card in node.deploy's
    gather mode.  `http_requests`' traffic over three keep-alive
    HTTPClients, one per tenant, at once; the capped tenant's bucket is
    set over the admin API.  Then the wire tax: the same greedy requests
    through Gateway.generate_batch in-process.  Then server.stop() with
    one 64-token stream in flight, which must drain.  Holds: every budget
    exact and every stream's token indices contiguous and equal to its
    usage; the cancel (499), too-long (400) and rate-limit (429) paths;
    caller_pumps 0; traffic on >= 2 nodes for each model over the
    phase (the router keeps light traffic on the class its perf model
    prefers, so the 12 requests at once of the in-process leg may be
    what reaches the second); every page
    returned; the kernels' launches exactly what the engines' stats
    imply, every flash launch on the tensor cores; every runtime,
    handler and client thread joined.  `argv` replaces the launcher's
    arguments (a CPU rehearsal)."""
    import threading
    from repro_torch.api import GenerationRequest
    from repro_torch.api.http import HTTPClient
    from repro_torch.api.http.__main__ import build_service
    from repro_torch.serving import SamplingParams
    gc.collect()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter()
    server, ctrl = build_service(["--port", "0"] if argv is None else argv)
    sync(dev)
    build_s = time.perf_counter() - t_build
    fleet, gw = ctrl.fleet, server.gateway
    insts = [(n, i) for n in fleet.nodes.values()
             for i in n.instances.values()]
    models = sorted({i.model_name for _, i in insts})
    cfgs = {m: ctrl.catalog.get(m) for m in models}
    placed = {m: sorted(n.node_id for n, i in insts if i.model_name == m)
              for m in models}
    if len(models) != 2 or any(len(v) != 2 for v in placed.values()) \
            or any(i.engine.device.type != dev.type for _, i in insts):
        raise AssertionError(f"serve_http placement {placed}")
    max_len = insts[0][1].max_len
    specs = http_requests(cfgs, models, max_len)
    server.start()
    runtime_threads = gw.runtime.threads()
    url = server.url()
    admin = HTTPClient(url)
    admin.set_tenant_quota("capped", requests_per_s=0.01, burst_requests=2)
    admin.close()
    routed0 = dict(ctrl.frontend.stats.per_replica)
    ops.reset_launches()
    outs = [None] * len(specs)

    errors = []

    def tenant_run(tenant):
        client, canceller = HTTPClient(url, tenant=tenant), HTTPClient(url)
        try:
            for k, s in enumerate(specs):
                if s["tenant"] == tenant:
                    outs[k] = http_call(client, s, canceller, timeout_s)
        except Exception as e:          # reported on the main thread
            errors.append((tenant, repr(e)))
        finally:
            client.close()
            canceller.close()
    clients = [threading.Thread(target=tenant_run, args=(t,))
               for t in ("acme", "lab", "capped")]
    t0 = time.perf_counter()
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=timeout_s + 60)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"serve_http: client threads {errors}")
    check_http(specs, outs, cfgs)
    main16 = [(s, o) for s, o in zip(specs, outs) if s["expect"] == "ok"]
    tokens = sum(len(o["tokens"]) for _, o in main16)

    def routed_since(base):
        """Requests routed since `base`, by model and node."""
        out = {m: {} for m in models}
        for n, i in insts:
            key = f"{n.node_id}/{i.instance_id}"
            got = ctrl.frontend.stats.per_replica.get(key, 0) \
                - base.get(key, 0)
            if got:
                out[i.model_name][n.node_id] = \
                    out[i.model_name].get(n.node_id, 0) + got
        return out
    wire_by_model = routed_since(routed0)
    routed1 = dict(ctrl.frontend.stats.per_replica)
    # the wire tax: the same greedy requests in-process, all at once
    greedy = [(s, o) for s, o in main16 if not s["sampled"]]
    resps = gw.generate_batch([GenerationRequest(
        model=s["model"], prompt=tuple(s["prompt"]),
        sampling=SamplingParams(max_tokens=s["budget"]))
        for s, _ in greedy], timeout_s=timeout_s)
    if [len(r.tokens) if r.ok else None for r in resps] != \
            [s["budget"] for s, _ in greedy]:
        raise AssertionError(f"serve_http in-process: {resps}")
    inproc_by_model = routed_since(routed1)
    spread = {m: set(wire_by_model[m]) | set(inproc_by_model[m])
              for m in models}
    if any(len(v) < 2 for v in spread.values()):
        raise AssertionError(f"serve_http: requests by model and node, "
                             f"over the wire {wire_by_model}, in-process "
                             f"{inproc_by_model}")
    agree = sum(list(r.tokens) == o["tokens"]
                for (_, o), r in zip(greedy, resps))
    # shutdown with a stream in flight: stop() must let it finish
    drain = {"frames": []}
    first = threading.Event()

    def last_stream():
        c = HTTPClient(url)
        try:
            for ch in c.complete(models[0], specs[2]["prompt"],
                                 max_tokens=64, stream=True,
                                 timeout_s=timeout_s):
                drain["frames"].append(ch)
                if ch["choices"][0].get("token") is not None:
                    first.set()
        except Exception as e:          # reported on the main thread
            drain["error"] = repr(e)
        finally:
            first.set()
            c.close()
    tail = threading.Thread(target=last_stream)
    tail.start()
    first.wait(timeout_s)
    handler_threads = list(server._pool._threads) + [server._accept_thread]
    caller_pumps = gw.stats.caller_pumps
    d0 = time.perf_counter()
    stopped = server.stop(timeout_s=120)
    drain_s = time.perf_counter() - d0
    tail.join(timeout=60)
    for th in handler_threads:
        th.join(timeout=30)
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    by_route = dict(ops.flash_attention.launches_by_route)
    alive = [th.name for th in runtime_threads + handler_threads + [tail]
             if th.is_alive()]
    if not stopped or alive or "error" in drain:
        raise AssertionError(f"serve_http stop: {stopped}, alive {alive}, "
                             f"{drain.get('error')}")
    toks = [f for f in drain["frames"]
            if f["choices"][0].get("token") is not None]
    if len(toks) != 64 or drain["frames"][-1]["choices"][0][
            "finish_reason"] != "length":
        raise AssertionError(f"serve_http: the drained stream got "
                             f"{len(toks)} of 64 tokens")
    if caller_pumps:
        raise AssertionError(f"serve_http: {caller_pumps} caller pumps")
    insts += [(n, i) for n in fleet.nodes.values()
              for i in n.instances.values()
              if all(i is not j for _, j in insts)]
    want = dict.fromkeys(launches, 0)
    for node, inst in insts:
        eng = inst.engine
        for k, v in expected_launches(inst.cfg, eng.ecfg,
                                      eng.perf_stats()).items():
            want[k] += v
        if eng.pool.pages_in_use:
            raise AssertionError(f"serve_http: {node.node_id} holds "
                                 f"{eng.pool.pages_in_use} pages")
    if launches != want or by_route != {
            "tensor_core": want["flash_attention"], "cuda_core": 0} \
            or not launches["flash_attention"] \
            or not launches["decode_attention"]:
        raise AssertionError(f"serve_http launches {launches} by route "
                             f"{by_route}, want {want}")
    wire_ttft = [o["first_s"] * 1e3 for _, o in main16 if "first_s" in o]
    # what the wire adds to a request at the same load: the client's
    # latency less the Gateway's own (submit to finish), non-streamed
    wire_extra = [(o["total_s"] - o["gateway_latency_s"]) * 1e3
                  for _, o in main16 if "gateway_latency_s" in o]
    inproc_ttft = [r.ttft * 1e3 for r in resps]
    emit({"phase": "serve_http", "models": {
              m: {"layers": cfgs[m].n_layers, "params": cfgs[m].num_params(),
                  "heads": [cfgs[m].n_heads, cfgs[m].n_kv_heads],
                  "head_dim": cfgs[m].head_dim, "nodes": placed[m]}
              for m in models},
          "build_s": build_s, "requests": len(main16),
          "budgets": [s["budget"] for s, _ in main16],
          "prompt_lens": [len(s["prompt"]) for s, _ in main16],
          "kinds": [s["kind"] for s, _ in main16],
          "streamed": sum(s["stream"] for s, _ in main16),
          "sampled": sum(s["sampled"] for s, _ in main16),
          "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
          "wire_ttft_ms": {"p50": pct(wire_ttft, 50),
                           "p95": pct(wire_ttft, 95), "n": len(wire_ttft)},
          "wire_added_latency_ms": {"p50": pct(wire_extra, 50),
                                    "p95": pct(wire_extra, 95),
                                    "n": len(wire_extra)},
          "in_process_ttft_ms": {"p50": pct(inproc_ttft, 50),
                                 "p95": pct(inproc_ttft, 95),
                                 "n": len(inproc_ttft)},
          "requests_by_model_and_node": {"wire": wire_by_model,
                                         "in_process": inproc_by_model},
          "cancelled_after_tokens": len(outs[16]["tokens"]),
          "greedy_rows_equal_wire_and_in_process":
              f"{agree}/{len(greedy)}",
          "drain_s": drain_s, "default_drain_budget_s": 10.0,
          "caller_pumps": caller_pumps,
          "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None),
          "weight_bytes": {m: cfgs[m].param_bytes() for m in models},
          "prefill_dispatches": sum(i.engine.prefill_dispatches
                                    for _, i in insts),
          "decode_dispatches": sum(i.engine.decode_dispatches
                                   for _, i in insts),
          "launches": launches, "launches_by_route": by_route,
          "card": card})
    return launches


def launcher_run(card, argv=(), start_timeout_s=300, exit_timeout_s=60):
    """`python -m repro_torch.api.http --port 0` as a process of its own
    (the default models at full width on the card): read the URL it
    prints; GET /healthz and /v1/models must list both models, and one
    streamed chat completion must end in `data: [DONE]`; then SIGINT: it
    must print "draining..." and exit 0 within `exit_timeout_s`.  The
    process is killed if it outlives this function.  `argv` adds
    arguments (a CPU rehearsal)."""
    import http.client
    import os
    import signal
    import threading
    from urllib.parse import urlparse
    from repro_torch.api.http import HTTPClient
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.api.http", "--port", "0",
         *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, urls, ready = [], [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("serving ") and " on http://" in line:
                urls.append(line.split(" on ", 1)[1].split()[0])
                ready.set()
        ready.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not ready.wait(start_timeout_s) or not urls:
            raise AssertionError(f"launcher did not start: {lines[-20:]}")
        start_s = time.perf_counter() - t0
        c = HTTPClient(urls[0])
        health, models = c.healthz(), c.models()
        c.close()
        if sorted(health["models"]) != sorted(models) or len(models) != 2:
            raise AssertionError(f"launcher: {health}, models {models}")
        u = urlparse(urls[0])
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=300)
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "model": models[0], "max_tokens": 8, "stream": True,
            "messages": [{"role": "user", "content": "hello"}]}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data:"):
                data.append(line[len(b"data:"):].strip())
                if data[-1] == b"[DONE]":
                    break
        conn.close()
        tokens = sum(1 for d in data[:-1] if json.loads(d)["choices"][0]
                     ["delta"].get("token") is not None)
        if resp.status != 200 or not data or data[-1] != b"[DONE]" \
                or tokens != 8:
            raise AssertionError(f"launcher stream: {resp.status}, "
                                 f"{data[-3:]}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(exit_timeout_s)
        exit_s = time.perf_counter() - t1
        reader.join(timeout=10)
        if rc != 0 or "draining..." not in lines:
            raise AssertionError(f"launcher exit {rc}: {lines[-20:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit({"phase": "launcher", "argv": ["--port", "0", *argv],
          "start_s": start_s, "models": models, "stream_tokens": tokens,
          "exit_code": rc, "sigint_to_exit_s": exit_s,
          "exit_limit_s": exit_timeout_s, "card": card})


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
    parity_moe(dev, ops)
    parity_hymba(dev, ops)
    parity_xlstm(dev, ops)
    parity_encdec(dev, ops)
    parity_train(dev, ops)
    kv_row, kv_launches = kv_quant(dev, ops, card)
    bf16_launches, bf16_routes, bf16_shapes = serve(
        "serve_bf16", dev, ops, card, paged_attention=True)
    int8_launches, int8_routes, int8_shapes = serve(
        "serve_int8", dev, ops, card, quantize="int8")
    path_launches = {"serve_bf16": bf16_launches, "serve_int8": int8_launches,
                     "serve_prefix_swap": serve_prefix_swap(dev, ops, card),
                     "serve_spec": serve_spec(dev, ops, card),
                     "serve_gateway": serve_gateway(dev, ops, card)}
    gc.collect()
    gemma = serve_gemma(dev, ops, card)
    path_launches["serve_gemma"] = {
        name: sum(ln[name] for ln in gemma.values())
        for name in next(iter(gemma.values()))}
    moe_legs, moe_more = serve_moe(dev, ops, card)
    path_launches["serve_moe"] = {
        name: sum(ln[name] for ln in moe_legs.values())
        for name in next(iter(moe_legs.values()))}
    hymba_legs, hymba_more = serve_hymba(dev, ops, card)
    path_launches["serve_hymba"] = {
        name: sum(ln[name] for ln in hymba_legs.values())
        for name in next(iter(hymba_legs.values()))}
    xlstm_legs, xlstm_more = serve_xlstm(dev, ops, card)
    seamless_legs, seamless_more = serve_seamless(dev, ops, card)
    for path, legs in (("serve_xlstm", xlstm_legs),
                       ("serve_seamless", seamless_legs)):
        path_launches[path] = {
            name: sum(ln[name] for ln in legs.values())
            for name in next(iter(legs.values()))}
    seamless_non_causal = sum(m[0]["flash_non_causal"]
                              for m in seamless_more.values())
    path_launches["serve_http"] = serve_http(dev, ops, card)
    path_launches["kv_quant"] = kv_launches
    gc.collect()
    torch.cuda.empty_cache()
    launcher_run(card)
    train_xlstm(dev, card)
    train_olmo(dev, card)
    # the prefill whose attention did the most work: rows x bucket^2; the
    # widest int8 product: rows x bucket
    widest = max(bf16_shapes, key=lambda s: s[0] * s[1] ** 2)
    int8_m = max(r * b for r, b in int8_shapes)
    timings = kernel_timings(dev, ops, refs, q_lib, widest, int8_m)
    # a MoE model's launches: summed over its serve_moe legs
    moe_by_model = {"granite-moe-3b-a800m": [
        ln for leg, ln in moe_legs.items() if leg.startswith("granite")],
        "mixtral-8x22b": [moe_legs["mixtral"]],
        "hymba-1.5b": list(hymba_legs.values()),
        "seamless-m4t-large-v2": list(seamless_legs.values())}
    for name, rows in gqa_timings(dev, ops, refs).items():
        for r in rows:     # a gemma's launches on its serve in serve_gemma
            if r["label"] in gemma:
                r["launches"] = gemma[r["label"]][name]
            elif r["label"] in moe_by_model:
                r["launches"] = sum(ln[name]
                                    for ln in moe_by_model[r["label"]])
        timings[name].setdefault("shapes", []).extend(rows)
    moe_int8_routes = moe_more["granite_int8"][0]["int8_matmul"]
    moe = moe_timings(
        dev, ops, refs, q_lib,
        max(r * b for r, b in moe_more["granite_int8"][1]),
        max(moe_more["granite_paged"][1], key=lambda sh: sh[0] * sh[1]))
    for r in moe["int8_matmul"]:    # the serve_moe int8 leg, by route
        r["launches_on_route"] = moe_int8_routes[r["kernel_route"]]
    timings["int8_matmul"]["shapes"].extend(moe["int8_matmul"])
    hymba = hymba_timings(dev, ops, refs, q_lib,
                          max(r * b for r, b in hymba_more["int8"][1]))
    hymba_int8_routes = hymba_more["int8"][0]["int8_matmul"]
    for r in hymba["int8_matmul"]:  # the serve_hymba int8 leg, by route
        r["launches_on_route"] = hymba_int8_routes[r["kernel_route"]]
    timings["int8_matmul"]["shapes"].extend(hymba["int8_matmul"])
    xlstm = xlstm_timings(dev, ops, refs, q_lib,
                          max(r * b for r, b in xlstm_more["int8"][1]))
    for r in xlstm["int8_matmul"]:  # the serve_xlstm int8 leg, by route
        r["launches_on_route"] = \
            xlstm_more["int8"][0]["int8_matmul"][r["kernel_route"]]
    timings["int8_matmul"]["shapes"].extend(xlstm["int8_matmul"])
    # the widest int8 product of serve_seamless: the encoder's rows x 1024
    # frames; the widest cross-attention: rows x bucket over 1024 frames
    encdec = encdec_timings(
        dev, ops, refs, q_lib,
        max(r for r, _ in seamless_more["int8"][1]) * 1024,
        max(seamless_more["paged"][1], key=lambda sh: sh[0] * sh[1]))
    for r in encdec["int8_matmul"]:  # the serve_seamless int8 leg
        r["launches_on_route"] = \
            seamless_more["int8"][0]["int8_matmul"][r["kernel_route"]]
    for r in encdec["flash_attention"]:
        r["launches_non_causal"] = seamless_non_causal
    for r in encdec["decode_attention"]:
        r["launches"] = path_launches["serve_seamless"]["decode_attention"]
    for name, rows in encdec.items():
        timings[name].setdefault("shapes", []).extend(rows)
    timings["decode_attention"]["shapes"].append(kv_row)
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
        if name in ("flash_attention", "decode_attention") \
                and not path_launches["serve_http"][name]:
            raise AssertionError(f"{name} never ran on serve_http")
        if name != "int8_matmul" and not path_launches["serve_gemma"][name]:
            raise AssertionError(f"{name} never ran on serve_gemma")
        if not path_launches["serve_moe"][name]:
            raise AssertionError(f"{name} never ran on serve_moe")
        if not path_launches["serve_hymba"][name]:
            raise AssertionError(f"{name} never ran on serve_hymba")
        if not path_launches["serve_seamless"][name]:
            raise AssertionError(f"{name} never ran on serve_seamless")
        if name == "int8_matmul" and not path_launches["serve_xlstm"][name]:
            raise AssertionError(f"{name} never ran on serve_xlstm")
        if name == "flash_attention" and not seamless_non_causal:
            raise AssertionError("non-causal flash never ran on "
                                 "serve_seamless")
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
                        **({"launches_non_causal_by_path": {
                            "serve_seamless": seamless_non_causal}}
                           if name == "flash_attention" else {}),
                        "card": card})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
