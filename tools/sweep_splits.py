"""Time the three split kernels at the served decode shapes over their
splits, on one CUDA device.

    python3 tools/sweep_splits.py
    python3 tools/sweep_splits.py --gemma
    python3 tools/sweep_splits.py --moe
    python3 tools/sweep_splits.py --served
    python3 tools/sweep_splits.py --int8

The two decode kernels on their bf16 (tensor-core) route:
paged_decode_attention (pages of 16, a table of S / 16 columns) and
decode_attention (the (B, S, K, hd) cache view), B = 8, each over its
splits: the (row, kv head)'s chunks as one thread block cluster of c = 1,
2, 3, 4, 6, 8 and 16 CTAs (16: a non-portable cluster; chunks of whole
64-row tiles), and chunks of 64 and 128 rows merged through the global
workspace (cluster 1; where that makes at most 32 chunks, the kernels'
running-chunk mask).  With no flag: OLMo-1B's shape (K=16 G=1 hd=128
S=1024) at the ragged pos of chip_smoke.py's timings and with every
position valid, then the int8_matmul skinny_tc route (M = 8, bf16: 2048
-> 2048, 2048 -> 8192, 8192 -> 2048 and the tied head) over its
clusters: the K split into 1, 2, 4 or 8 CTAs of a thread block cluster,
each column tile a cluster (with no split, the CTAs of one wave walking
the tiles, two an SM where the tiles outnumber the SMs), beside the CTAs
the card holds at once for such a launch (its ring sets its shared
memory).  Each configuration is launched with the split given (through
ops._paged_decode, ops._decode, and the int8 C entry), held to the
wrapper's output (bf16 2e-2), and timed as chip_smoke.py times kernels
(CUDA events, cold L2, a 0.2 ms device-side wait, median of 30).  The
wrapper's own choice (ops.paged_decode_attention_splits,
ops.decode_attention_splits, ops.int8_skinny_tc_splits) is marked.
Prints one JSON line per kernel and shape, each with the card's name and
power limit; exits non-zero without a CUDA device.

--gemma: the two decode kernels at gemma3-1b's decode shape (K=1 G=4
hd=256, window 512; every position valid and the ragged pos), where one
KV head leaves 8 (slot, head) pairs and the window skips half of a
slot's rows.

--moe: the two decode kernels at the MoE models' groups, K=8 at the
ragged pos: granite-moe-3b-a800m's G=3 hd=64, and mixtral-8x22b's G=6
hd=128 with its window of 4096 and without one (the window skips nothing
at S = 1024), and G=4 and G=8 at hd=128 beside it (G = 1..8 run the same
products, N = 8); then skinny_tc at granite's M = 8 products (1536 ->
1536, 1536 -> 512, the tied head 1536 -> 49155).

--served: the two decode kernels at every chip_smoke.py SERVED_GQA shape
with every position valid (hymba-1.5b at S = 4096), as gqa_timings times
them.

--int8: only skinny_tc, at every served M = 8 product of PERF.md section
6 (OLMo-1B's, granite's, hymba's, xlstm's, seamless's, the heads).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (adds src/ to the path)


def close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def sweep_decode_kernels(dev, ops, card, n_sm, *, K, G, hd, window,
                         prefix=0, S=1024, full=False):
    """Both decode kernels over their splits (see the module docstring),
    B = 8 at the OLMo-1B decode's ragged pos, or at pos S - 1 (`full`)."""
    B, pps = 8, S // 16
    pos = ([S - 1] * B if full else
           chip_smoke.olmo_decode_pos(np.random.default_rng(1), B, S))
    tag = (f" window={window}" if window else "") + \
        (f" prefix={prefix}" if prefix else "")
    kw = dict(window=window, prefix=prefix)
    tiles = -(-S // 64)
    splits = {}
    for c in (1, 2, 3, 4, 6, 8, 16):
        if c <= tiles:
            rows = -(-tiles // c) * 64
            splits[f"cluster {c}"] = (c, rows)
    for rows in (64, 128):
        if -(-S // rows) <= ops.DECODE_MAX_SPLITS:
            splits[f"global {-(-S // rows)}x{rows}"] = (1, rows)
    pargs = chip_smoke.paged_case(dev, torch.bfloat16, B=B, K=K, G=G, hd=hd,
                                  ps=16, pps=pps, pos=pos, seed=7)
    dargs = chip_smoke.decode_case(dev, torch.bfloat16, B=B, K=K, G=G, S=S,
                                   hd=hd, pos=pos, seed=9, strided=True)
    for name, args in (("paged_decode_attention", pargs),
                       ("decode_attention", dargs)):
        paged = name.startswith("paged")
        want = getattr(ops, name)(*args, **kw)
        chosen = (ops.paged_decode_attention_splits(B, K, pps, 16, n_sm, hd)
                  if paged else ops.decode_attention_splits(B, K, S, n_sm,
                                                            hd))
        times = {}
        for label, (c, rows) in splits.items():
            n = -(-S // rows)
            sp = ((n, rows // 16, c if c > 1 else 1) if paged
                  else (n, rows, c if c > 1 else 1))
            if sp == tuple(chosen):
                label += " (wrapper)"

            def call(sp=sp):
                if paged:
                    return ops._paged_decode(*args, window, prefix,
                                             splits=sp)
                return ops._decode(*args, window, prefix, splits=sp)
            close(call(), want)
            times[label] = chip_smoke.time_ms(call)
        chip_smoke.emit({"kernel": name, "shape": f"B={B} K={K} G={G} "
                         f"S={S} hd={hd}{tag} bf16, pos "
                         f"{'S - 1' if full else 'ragged up to S - 1'}",
                         "ms_by_split": times,
                         "wrapper_choice": list(chosen), "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_splits: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.serving import quantization as q_lib
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    n_sm = ops._sm_count(0)
    ops.build()
    if "--int8" in sys.argv[1:]:
        sweep_skinny_tc(dev, ops, q_lib, card, n_sm, INT8_DECODE)
        return 0
    if "--gemma" in sys.argv[1:]:
        for full in (True, False):
            sweep_decode_kernels(dev, ops, card, n_sm, K=1, G=4, hd=256,
                                 window=512, full=full)
        return 0
    if "--served" in sys.argv[1:]:
        for model, (H, K, hd, win, pre) in chip_smoke.SERVED_GQA.items():
            S = chip_smoke.GQA_LENGTHS.get(model, (1024, 1024))[0]
            sweep_decode_kernels(dev, ops, card, n_sm, K=K, G=H // K, hd=hd,
                                 window=win, prefix=pre, S=S, full=True)
        return 0
    if "--moe" in sys.argv[1:]:
        for G, hd, window in ((3, 64, 0), (6, 128, 4096), (6, 128, 0),
                              (4, 128, 0), (8, 128, 0)):
            sweep_decode_kernels(dev, ops, card, n_sm, K=8, G=G, hd=hd,
                                 window=window)
        sweep_skinny_tc(dev, ops, q_lib, card, n_sm, (
            ("granite_decode_attn", 8, 1536, 1536, False),
            ("granite_decode_kv", 8, 1536, 512, False),
            ("granite_head", 8, 1536, 49155, True)))
        return 0
    for full in (False, True):
        sweep_decode_kernels(dev, ops, card, n_sm, K=16, G=1, hd=128,
                             window=0, full=full)
    sweep_skinny_tc(dev, ops, q_lib, card, n_sm, (
        ("decode_attn", 8, 2048, 2048, False),
        ("decode", 8, 2048, 8192, False),
        ("decode_down", 8, 8192, 2048, False),
        ("head", 8, 2048, 50304, True)))
    return 0


def sweep_skinny_tc(dev, ops, q_lib, card, n_sm, shapes):
    """The int8 matmul's skinny_tc route over its clusters at each
    (label, M, K, N, head) of `shapes`."""
    lib = ops._lib("int8_matmul")
    for label, M, K, N, head in shapes:
        x, wq, sc = chip_smoke.int8_case(dev, torch.bfloat16, q_lib, M=M,
                                         K=K, N=N, head=head, seed=10)
        swk, swn = wq.stride()
        kn = swn == 1
        cols, stage_k = ops.SKINNY_TC_TILE[kn]
        tiles, stages = -(-N // cols), -(-K // stage_k)
        want = ops.int8_matmul(x, wq, sc)
        out = torch.empty_like(want)
        chosen = ops.int8_skinny_tc_splits(K, N, kn, n_sm)
        times, resident = {}, {}
        for split in sorted({1, 2, 4, 8, chosen[0]}):
            if split > stages:
                continue
            per = -(-stages // split)
            cluster = -(-stages // per)
            ctas = tiles if cluster > 1 else min(tiles, 2 * n_sm)
            resident[f"{cluster}"] = lib.int8_matmul_resident(
                ops.INT8_ROUTES.index("skinny_tc"), cluster, per, tiles,
                ctas)

            def call(cluster=cluster, per=per, ctas=ctas):
                ops._run("int8_matmul", dev, x.data_ptr(), wq.data_ptr(),
                         sc.data_ptr(), out.data_ptr(), M, N, K, swk, swn, K,
                         int(head), 1, ops.INT8_ROUTES.index("skinny_tc"),
                         cluster, per, ctas)
            call()
            close(out, want)
            times[f"{cluster}x{per}"] = chip_smoke.time_ms(call)
        chip_smoke.emit({"kernel": "int8_matmul (skinny_tc)", "label": label,
                         "shape": f"M={M} K={K} N={N} bf16",
                         "ms_by_cluster_x_stages": times,
                         "resident_ctas_by_cluster": resident,
                         "wrapper_choice": f"{chosen[0]}x{chosen[1]}",
                         "card": card})


# every served M = 8 product of PERF.md section 6: (label, M, K, N, head)
INT8_DECODE = (
    ("olmo_decode_attn", 8, 2048, 2048, False),
    ("olmo_decode", 8, 2048, 8192, False),
    ("olmo_decode_down", 8, 8192, 2048, False),
    ("olmo_head", 8, 2048, 50304, True),
    ("granite_decode_attn", 8, 1536, 1536, False),
    ("granite_decode_kv", 8, 1536, 512, False),
    ("granite_head", 8, 1536, 49155, True),
    *((f"hymba_decode_{k}x{n}", 8, k, n, False) for k, n in
      ((1600, 1600), (1600, 320), (1600, 3200), (1600, 5504), (5504, 1600),
       (1600, 32001))),
    *((f"xlstm_decode_{k}x{n}", 8, k, n, False) for k, n in
      ((768, 3072), (1536, 1536), (1536, 768), (768, 2112), (2112, 768))),
    ("xlstm_head", 8, 768, 50304, True),
    *((f"seamless_decode_{k}x{n}", 8, k, n, False) for k, n in
      ((1024, 1024), (1024, 8192), (8192, 1024), (1024, 256206))),
)


if __name__ == "__main__":
    sys.exit(main())
