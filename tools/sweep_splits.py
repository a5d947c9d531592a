"""Time the three split kernels at the OLMo-1B decode shapes over their
split counts, on one CUDA device.

    python3 tools/sweep_splits.py
    python3 tools/sweep_splits.py --gemma
    python3 tools/sweep_splits.py --moe

paged_decode_attention (B=8 K=16 G=1 hd=128 bf16, pages of 16, a table
of 64 columns, ragged pos up to 1023) over its pages per chunk,
decode_attention (B=8 K=16 G=1 S=1024 hd=128 bf16, the (B, S, K, hd)
cache view, the same pos) over its chunk sizes, and the int8_matmul
skinny_tc route (M = 8, bf16: 2048 -> 2048, 2048 -> 8192, 8192 -> 2048
and the tied head) over its clusters: the K split into 1, 2, 4 or 8
CTAs of a thread block cluster, each column tile a cluster (with no
split, the CTAs of one wave walking the tiles, two an SM where the tiles
outnumber the SMs), beside the CTAs the card holds at once for such a
launch (its ring sets its shared memory).  Each configuration is launched
with the split given (the paged kernel through ops._paged_decode, the
others through their C entries), held to the wrapper's output (bf16
2e-2), and timed as chip_smoke.py times kernels (CUDA events, cold L2,
a 0.2 ms device-side wait, median of 30).  The wrapper's own choice
(ops.paged_decode_attention_splits, ops.decode_attention_splits,
ops.int8_skinny_tc_splits) is marked.  A paged chunking that needs more
chunks than the kernel's 32-bit running-chunk mask holds is listed as
not launchable.  Prints one JSON line per kernel and shape, each with
the card's name and power limit; exits non-zero without a CUDA device.

With --gemma it sweeps instead the two decode kernels at gemma3-1b's
decode shape (B=8 K=1 G=4 hd=256 bf16, window 512, the same ragged pos;
the paged kernel over a table of 64 columns of 16-row pages), where one
KV head leaves 8 (slot, head) pairs and the window skips half of a
slot's rows.

With --moe it sweeps the two decode kernels at the MoE models' groups,
B=8 K=8 at the same ragged pos: granite-moe-3b-a800m's G=3 hd=64, and
mixtral-8x22b's G=6 hd=128 with its window of 4096 and without one
(the window skips nothing at S = 1024, so the two differ only by the
kernel's window test), and G=4 and G=8 at hd=128 beside it (G = 6 runs
the kernels' 8-row group variant, G = 4 the 4-row one); then skinny_tc at granite's M = 8 products (1536
-> 1536, 1536 -> 512, the tied head 1536 -> 49155).

With --int8 it sweeps only skinny_tc, at every served M = 8 product of
PERF.md section 6 (OLMo-1B's, granite's, hymba's, xlstm's, seamless's,
the heads).
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


def sweep_decode_kernels(dev, ops, card, n_sm, *, K, G, hd, window):
    """The paged kernel over its pages per chunk and the decode kernel
    over its chunk sizes, B = 8 at the OLMo-1B decode's ragged pos."""
    B, S = 8, 1024
    pos = chip_smoke.olmo_decode_pos(np.random.default_rng(1), B, S)
    tag = f" window={window}" if window else ""
    pargs = chip_smoke.paged_case(dev, torch.bfloat16, B=B, K=K, G=G, hd=hd,
                                  ps=16, pps=64, pos=pos, seed=7)
    want = ops.paged_decode_attention(*pargs, window=window)
    chosen = ops.paged_decode_attention_splits(B, K, 64, 16, n_sm)
    times = {}
    for ppc in sorted({1, 2, 3, 4, 6, 8, 11, 13, 16, 22, 32, 64,
                       chosen[1]}):
        n = -(-64 // ppc)
        if n > ops.PAGED_MAX_SPLITS:
            times[f"{n}x{ppc}"] = f"not launchable: {n} chunks"
            continue

        def call(n=n, ppc=ppc):
            return ops._paged_decode(*pargs, window, 0, splits=(n, ppc))
        close(call(), want)
        times[f"{n}x{ppc}"] = chip_smoke.time_ms(call)
    chip_smoke.emit({"kernel": "paged_decode_attention", "shape": f"B={B} "
                     f"K={K} G={G} hd={hd} ps=16 pps=64{tag} bf16, pos up "
                     "to 1023", "ms_by_splits_x_pages": times,
                     "wrapper_choice": f"{chosen[0]}x{chosen[1]}",
                     "card": card})

    q, k, v, p = chip_smoke.decode_case(dev, torch.bfloat16, B=B, K=K, G=G,
                                        S=S, hd=hd, pos=pos, seed=9,
                                        strided=True)
    want = ops.decode_attention(q, k, v, p, window=window)
    out = torch.empty_like(q)
    chosen = ops.decode_attention_splits(B, K, S, n_sm)
    times = {}
    for chunk in (64, 128, 192, 256, 512, 1024):
        n = -(-S // chunk)
        tickets, ws = ops._split_buffers(dev, B * K,
                                         B * K * n * 8 * (hd + 2))

        def call(n=n, chunk=chunk, ws=ws, tickets=tickets):
            ops._run("decode_attention", dev, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), p.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), tickets.data_ptr(), B, K, G, hd, S,
                     *k.stride()[:3], window, 0, 1, n, chunk, hd ** -0.5)
        call()
        close(out, want)
        times[f"{n}x{chunk}"] = chip_smoke.time_ms(call)
    chip_smoke.emit({"kernel": "decode_attention", "shape": f"B={B} K={K} "
                     f"G={G} S={S} hd={hd}{tag} bf16",
                     "ms_by_splits_x_chunk": times,
                     "wrapper_choice": f"{chosen[0]}x{chosen[1]}",
                     "card": card})


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
        sweep_decode_kernels(dev, ops, card, n_sm, K=1, G=4, hd=256,
                             window=512)
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
    sweep_decode_kernels(dev, ops, card, n_sm, K=16, G=1, hd=128, window=0)
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
