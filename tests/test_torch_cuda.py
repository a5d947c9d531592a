"""The port's hand-written kernels against their plain PyTorch versions,
on the card.  Every test here carries the `cuda` marker and skips where
there is no CUDA device; it imports no JAX, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (another summation order than the plain version),
bf16 2e-2 (as tests/test_kernels.py).  The int8 products are held
against the plain dequantize-then-multiply, so they too differ only in
the order of summation (int8 values are exact in bf16, so the
tensor-core route's bf16 x bf16 product with f32 sums is too, and the
skinny_tc route's head, which carries x times its per-K scale as a bf16
hi/lo pair, to ~2^-17).  Every flash and int8 launch is also held to its
route through the wrapper's `launches_by_route`.  The three kernels that
split their work across CTAs (decode attention's sequence, paged decode
attention's page-table columns, skinny_tc's K) merge in a fixed order:
two launches give bit-identical outputs, on one stream and on two.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.int8_matmul import int8_matmul_ref
from repro_torch.kernels.paged_attention import paged_decode_attention_ref
from repro_torch.serving.quantization import quantize_array

DTYPES = {"f32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the H100)")
    return torch.device("cuda")


def _tensors(seed, dev, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype) for s in shapes]


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# decode positions of the MoE cases: pos 0, either side of the chunk
# edges at 128 rows (B 8 x K 8: 8 chunks), the cache end
MOE_POS = [0, 127, 128, 255, 256, 700, 1000, 1023]
# hymba-1.5b at max_len 4096 (B 8 x K 5: chunks of 320 rows, of 20 pages):
# pos 0, either side of a chunk edge and of window 2048 + 128 meta tokens
HYMBA_POS = [0, 319, 320, 2175, 2176, 2177, 3000, 4095]

PAGED = [
    # B, K, G, n_pages, pps, ps, hd, window, prefix
    (3, 2, 4, 24, 6, 8, 64, 0, 0),
    (2, 4, 2, 32, 8, 4, 32, 0, 0),
    (4, 1, 8, 24, 4, 8, 128, 0, 0),
    (3, 2, 4, 24, 6, 8, 64, 16, 4),      # window + prefix
    (2, 2, 3, 40, 5, 8, 16, 0, 0),       # hd 16, G 3
    (2, 2, 12, 40, 5, 8, 32, 0, 0),      # G > 8 runs in chunks
    (3, 16, 1, 200, 64, 16, 128, 0, 0),  # OLMo-1B decode shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", PAGED)
def test_paged_kernel_matches_plain(cuda, case, dt):
    B, K, G, n_pages, pps, ps, hd, win, pre = case
    dtype, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    pos = [0, ps * 2 + 3, ps * pps - 1][:B] + [5] * max(B - 3, 0)
    table = np.full((B, pps), n_pages, np.int32)     # sentinel-padded
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            table[i, j] = next(free)
    q, kp, vp = _tensors(2, cuda, dtype, (B, K, G, hd),
                         (n_pages, ps, K, hd), (n_pages, ps, K, hd))
    args = (q, kp, vp, torch.from_numpy(table).to(cuda),
            torch.tensor(pos, dtype=torch.int32, device=cuda))
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(*args, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    _close(got, paged_decode_attention_ref(*args, window=win, prefix=pre),
           tol)


# the split's edges: at these B * K and tables the wrapper cuts the table
# into more than one chunk (asserted), and each case also runs at other
# chunkings through ops._paged_decode
PAGED_SPLIT = [
    # B, K, G, n_pages, pps, ps, hd, window, prefix, pos, table
    (4, 2, 2, 140, 32, 8, 64, 0, 0, [63, 64, 127, 255], "plain"),  # edges
    (2, 2, 1, 70, 32, 8, 128, 0, 0, [0, 0], "plain"),        # pos 0
    (2, 2, 4, 70, 32, 8, 32, 0, 0, [200, 255], "holes"),      # sentinels
    (2, 2, 2, 70, 32, 8, 64, 0, 0, [150, 150], "shared"),     # shared pages
    (3, 2, 4, 100, 32, 8, 64, 100, 0, [99, 140, 255], "plain"),   # window
    (3, 2, 4, 100, 32, 8, 64, 100, 16, [150, 200, 255], "plain"),  # + prefix
    (2, 2, 16, 70, 32, 8, 32, 0, 0, [100, 255], "plain"),     # G 16: 2 runs
    (2, 2, 8, 70, 32, 8, 16, 0, 0, [17, 255], "plain"),       # hd 16, G 8
    (2, 2, 1, 70, 16, 12, 128, 0, 0, [100, 191], "plain"),    # ps 12
    # hd 256, gemma3's heads: gemma3-1b (G 4 over 1 KV head, window 512;
    # chunks of 64 rows: pos 0, chunk edges, whole chunks left of the
    # window), gemma3-4b (G 2, window 1024, 256 prefix tokens), holes
    (8, 1, 4, 600, 64, 16, 256, 512, 0, [0, 63, 64, 511, 512, 700, 1000,
                                         1023], "plain"),
    (4, 4, 2, 600, 100, 16, 256, 1024, 256, [0, 300, 1599, 1100], "plain"),
    (2, 1, 4, 70, 32, 8, 256, 0, 0, [200, 255], "holes"),
    # the MoE models' odd and 6-wide groups at their served shapes (8
    # chunks of 8 pages of 16: pos 0, either side of a chunk edge):
    # granite (G 3 over 8 KV heads, hd 64), mixtral (G 6, hd 128, window
    # 4096)
    (8, 8, 3, 600, 64, 16, 64, 0, 0, MOE_POS, "plain"),
    (8, 8, 6, 600, 64, 16, 128, 4096, 0, MOE_POS, "plain"),
    # hymba-1.5b (G 5 over 5 KV heads, hd 64): its windowed layers (2048,
    # 128 meta tokens exempt) and its global ones (window 0)
    (8, 5, 5, 2100, 256, 16, 64, 2048, 128, HYMBA_POS, "plain"),
    (8, 5, 5, 2100, 256, 16, 64, 0, 128, HYMBA_POS, "plain"),
]


def _paged_inputs(dev, dtype, case, seed):
    """q, pools, table and pos on the card.  Each slot maps the columns up
    to its pos; "holes" leaves every third of them at the sentinel,
    "shared" maps slot 1's first half onto slot 0's pages."""
    B, K, G, n_pages, pps, ps, hd, win, pre, pos, kind = case
    rng = np.random.default_rng(seed)
    table = np.full((B, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            if not (kind == "holes" and j % 3 == 1):
                table[i, j] = next(free)
    if kind == "shared":
        half = (pos[1] // ps + 1) // 2
        table[1, :half] = table[0, :half]
    q, kp, vp = _tensors(seed + 1, dev, dtype, (B, K, G, hd),
                         (n_pages, ps, K, hd), (n_pages, ps, K, hd))
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", PAGED_SPLIT)
def test_paged_kernel_split_edges(cuda, case, dt):
    """The wrapper's split, then one page a chunk
    where the table allows it, chunks of 3 and 7 pages (short last
    chunks) and one chunk."""
    B, K, G, n_pages, pps, ps, hd, win, pre = case[:9]
    dtype, tol = DTYPES[dt]
    args = _paged_inputs(cuda, dtype, case, 3)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops.paged_decode_attention_splits(B, K, pps, ps, n_sm)[0] > 1
    want = paged_decode_attention_ref(*args, window=win, prefix=pre)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(*args, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    _close(got, want, tol)
    for ppc in (1, 3, 7, pps):
        n = -(-pps // ppc)
        if n <= ops.PAGED_MAX_SPLITS:
            _close(ops._paged_decode(*args, win, pre, splits=(n, ppc)), want,
                   tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_kernel_long_chunk(cuda, dt):
    """One chunk of 300 pages: the CTA reads its page ids 128 columns at
    a time."""
    dtype, tol = DTYPES[dt]
    case = (2, 2, 1, 700, 300, 2, 64, 0, 0, [599, 350], "plain")
    args = _paged_inputs(cuda, dtype, case, 4)
    _close(ops._paged_decode(*args, 0, 0, splits=(1, 300)),
           paged_decode_attention_ref(*args), tol)


FLASH = [
    # B, H, K, Sq, Skv, hd, window, prefix, causal
    (2, 4, 2, 128, 128, 64, 0, 0, True),
    (1, 4, 2, 128, 128, 64, 48, 16, True),    # window + prefix
    (1, 6, 2, 192, 192, 64, 0, 0, True),      # 6 heads
    (2, 4, 4, 100, 100, 16, 0, 0, True),      # ragged length, hd 16
    (1, 8, 2, 72, 72, 128, 0, 0, True),
    (1, 4, 2, 128, 128, 64, 0, 0, False),     # non-causal
    (1, 16, 16, 1024, 1024, 128, 0, 0, True),  # OLMo-1B prefill bucket
    (1, 4, 2, 128, 256, 64, 0, 0, True),      # Sq < Skv, both from 0
    (2, 4, 2, 200, 200, 32, 40, 0, True),     # hd 32, window, ragged
    (1, 4, 4, 300, 300, 128, 64, 8, True),    # window + prefix, hd 128
    # hd 256 (the tensor-core route keeps Q in shared memory, kv tiles of
    # 32 rows): gemma3-1b's bucket, gemma3-4b's 256 + 1024 with prefix
    (1, 4, 1, 1024, 1024, 256, 512, 0, True),
    (1, 8, 4, 1280, 1280, 256, 1024, 256, True),
    (2, 4, 1, 100, 100, 256, 16, 4, True),    # ragged, small window
    (1, 4, 2, 128, 160, 256, 0, 0, False),    # non-causal, Skv % 32
    (2, 24, 8, 300, 300, 64, 0, 0, True),     # granite: G 3, ragged S
    (1, 48, 8, 256, 256, 128, 4096, 0, True),  # mixtral: G 6, window
    # hymba-1.5b: G 5, 128 meta tokens + 2400, window 2048
    (1, 25, 5, 2528, 2528, 64, 2048, 128, True),
]
FLASH_ROUTE = {"f32": "cuda_core", "bf16": "tensor_core"}


def _flash_checked(q, k, v, dt, **kw):
    """One flash launch, asserting it took the dtype's route."""
    route = FLASH_ROUTE[dt]
    before = ops.flash_attention.launches
    by_route = ops.flash_attention.launches_by_route[route]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.launches_by_route[route] == by_route + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH)
def test_flash_kernel_matches_plain(cuda, case, dt):
    """bf16 on the tensor-core route, f32 on the CUDA-core route.  The
    tensor-core route rounds P to bf16 before P.V: inside bf16's 2e-2."""
    B, H, K, Sq, Skv, hd, win, pre, causal = case
    dtype, tol = DTYPES[dt]
    q, k, v = _tensors(3, cuda, dtype, (B, H, Sq, hd), (B, K, Skv, hd),
                       (B, K, Skv, hd))
    got = _flash_checked(q, k, v, dt, causal=causal, window=win, prefix=pre)
    _close(got, flash_attention_ref(q, k, v, causal=causal, window=win,
                                    prefix=pre), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_kernel_takes_model_layout_views(cuda, dt):
    """The (B, H, S, hd) views of the model's (B, S, H, hd) tensors, read
    in place; the output is the view of a (B, S, H, hd) buffer."""
    dtype, tol = DTYPES[dt]
    q, k, v = _tensors(4, cuda, dtype, (2, 300, 8, 64), (2, 300, 2, 64),
                       (2, 300, 2, 64))
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    got = _flash_checked(qv, kv, vv, dt, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, flash_attention_ref(qv.contiguous(), kv.contiguous(),
                                    vv.contiguous()), tol)


DECODE = [
    # B, K, G, S, hd, window, prefix, pos (None: ragged from a seed)
    (2, 2, 4, 512, 64, 0, 0, None),      # DECODE_CASES of test_kernels.py
    (4, 8, 8, 256, 128, 0, 0, None),
    (2, 1, 4, 512, 64, 128, 0, None),
    (1, 4, 2, 1024, 64, 0, 0, None),
    (3, 2, 8, 256, 32, 0, 0, None),
    (4, 2, 2, 512, 64, 0, 0, [0, 63, 200, 511]),
    (3, 2, 4, 300, 64, 48, 16, [5, 100, 299]),     # window + prefix, S % 8
    (3, 2, 8, 40, 16, 0, 0, [0, 17, 39]),          # hd 16, G 8
    (2, 2, 12, 64, 32, 0, 0, [10, 63]),            # G > 8 in chunks
    (8, 16, 1, 1024, 128, 0, 0, [0, 5, 300, 511, 700, 900, 1000, 1023]),
    # split boundaries: at these B * K the sequence runs in chunks of 64
    (2, 2, 1, 1000, 128, 0, 0, [0, 0]),            # pos 0: one chunk runs
    (4, 2, 2, 1000, 64, 0, 0, [63, 64, 127, 999]),  # chunk edges, S % 64
    (3, 2, 4, 1000, 64, 100, 0, [99, 640, 999]),   # window skips chunks
    (3, 2, 4, 1000, 64, 100, 16, [150, 640, 999]),  # ... and a prefix
    (2, 2, 12, 1000, 32, 0, 0, [500, 999]),        # G > 8, split
    # hd 256, gemma3's heads (two vectors a lane in f32): gemma3-1b in
    # the gather mode, gemma3-4b with its prefix and a window that bites
    (8, 1, 4, 1024, 256, 512, 0, [0, 63, 64, 511, 512, 700, 1000, 1023]),
    (4, 4, 2, 1400, 256, 1024, 256, [0, 300, 1399, 1100]),
    (2, 1, 4, 1000, 256, 100, 16, [0, 999]),
    # granite (G 3, hd 64) and mixtral (G 6, hd 128, window 4096)
    (8, 8, 3, 1024, 64, 0, 0, MOE_POS),
    (8, 8, 6, 1024, 128, 4096, 0, MOE_POS),
    # hymba-1.5b (G 5, hd 64) at max_len 4096, windowed and global
    (8, 5, 5, 4096, 64, 2048, 128, HYMBA_POS),
    (8, 5, 5, 4096, 64, 0, 128, HYMBA_POS),
]
SPLIT = DECODE[10:15]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", DECODE)
@pytest.mark.parametrize("strided", [False, True])
def test_decode_kernel_matches_plain(cuda, case, dt, strided):
    """Contiguous (B, K, S, hd) caches, and the permuted view of a
    (B, S, K, hd) cache, the layout the engine hands the kernel."""
    B, K, G, S, hd, win, pre, pos = case
    dtype, tol = DTYPES[dt]
    if pos is None:
        pos = np.random.default_rng(5).integers(max(win, 1), S, B).tolist()
    q, = _tensors(6, cuda, dtype, (B, K, G, hd))
    if strided:
        kc, vc = (c.permute(0, 2, 1, 3) for c in
                  _tensors(7, cuda, dtype, (B, S, K, hd), (B, S, K, hd)))
    else:
        kc, vc = _tensors(7, cuda, dtype, (B, K, S, hd), (B, K, S, hd))
    args = (q, kc, vc, torch.tensor(pos, dtype=torch.int32, device=cuda))
    if case in SPLIT:   # the cases mean chunks of 64 rows
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert ops.decode_attention_splits(B, K, S, n_sm)[1] == 64
    before = ops.decode_attention.launches
    got = ops.decode_attention(*args, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    _close(got, decode_attention_ref(*args, window=win, prefix=pre), tol)


INT8 = [
    # M, K, N, weight layout, route of bf16 x (f32 x: skinny for M <= 16,
    # else cuda_core_tile); "kn_pad" is a (K, N) view of a weight with
    # 16-byte rows wider than N
    (128, 256, 128, "kn", "tensor_core"),    # INT8_CASES of test_kernels.py
    (256, 512, 256, "kn", "tensor_core"),
    (128, 128, 384, "kn", "tensor_core"),
    (8, 2048, 2048, "kn", "skinny_tc"),      # OLMo-1B decode projections
    (8, 2048, 8192, "kn", "skinny_tc"),
    (8, 8192, 2048, "kn", "skinny_tc"),
    (1, 2048, 8192, "kn", "skinny_tc"),
    (16, 8192, 2048, "kn", "skinny_tc"),     # two x tiles, split K
    (3, 100, 77, "kn", "skinny"),            # ragged M, K, N; unaligned
    (13, 33, 200, "kn", "skinny"),
    (13, 136, 208, "kn", "skinny_tc"),       # ragged M, K, N; aligned
    (9, 264, 77, "kn_pad", "skinny_tc"),
    (70, 100, 77, "kn", "cuda_core_tile"),   # K % 8, N % 16: unaligned rows
    (17, 2048, 2048, "kn", "tensor_core"),   # the smallest tile-route M
    (8, 2048, 50304, "head", "skinny_tc"),   # the tied head's route
    (2, 2048, 50304, "head", "skinny_tc"),
    (5, 272, 61, "head", "skinny_tc"),       # ragged, aligned
    (40, 96, 200, "head", "cuda_core_tile"),
    (5, 37, 61, "head", "skinny"),
    # granite-moe-3b-a800m: decode (M = 8) and prefill (M > 16) wq / wo
    # 1536 -> 1536 and wk / wv 1536 -> 512, the tied head's odd N
    (8, 1536, 1536, "kn", "skinny_tc"),
    (8, 1536, 512, "kn", "skinny_tc"),
    (64, 1536, 1536, "kn", "tensor_core"),
    (64, 1536, 512, "kn", "tensor_core"),
    (8, 1536, 49155, "head", "skinny_tc"),
    # hymba-1.5b: w_in 1600 -> 3200, down 5504 -> 1600, the untied head's
    # 32001-byte rows (unaligned: skinny, cuda_core_tile)
    (8, 1600, 3200, "kn", "skinny_tc"),
    (8, 5504, 1600, "kn", "skinny_tc"),
    (64, 1600, 3200, "kn", "tensor_core"),
    (8, 1600, 32001, "kn", "skinny"),
    (64, 1600, 32001, "kn", "cuda_core_tile"),
]


def _int8_operands(dev, seed, M, K, N, layout):
    """x (f32) and the int8 weight with its scale: quantized per output
    channel, or for the head the (d, V) view of a (V, d) embedding
    quantized per d with its (d, 1) scale."""
    x, w = _tensors(seed, dev, torch.float32, (M, K),
                    (N, K) if layout == "head" else (K, N))
    qd = quantize_array(w * 0.1, 8)
    wq, sc = qd["__q__"], qd["scale"]
    if layout == "head":
        wq, sc = wq.t(), sc.t().contiguous()
    elif layout == "kn_pad":
        wide = torch.zeros(K, -(-N // 16) * 16 + 16, dtype=torch.int8,
                           device=dev)
        wide[:, :N] = wq
        wq = wide[:, :N]
    return x, wq, sc


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", INT8)
def test_int8_kernel_matches_plain(cuda, case, dt):
    """The head route is the model's: the embedding (V, d) quantized per
    d, passed as the strided (d, V) view with its (d, 1) scale.  Each
    launch must take its route."""
    M, K, N, layout, bf16_route = case
    dtype, tol = DTYPES[dt]
    route = bf16_route if dt == "bf16" else (
        "skinny" if M <= 16 else "cuda_core_tile")
    x, wq, sc = _int8_operands(cuda, 8, M, K, N, layout)
    x = x.to(dtype)
    assert ops.int8_matmul_route(x, wq, sc) == route
    before = ops.int8_matmul.launches
    by_route = ops.int8_matmul.launches_by_route[route]
    got = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert ops.int8_matmul.launches == before + 1
    assert ops.int8_matmul.launches_by_route[route] == by_route + 1
    assert got.dtype == dtype and got.shape == (M, N)
    _close(got, int8_matmul_ref(x, wq, sc), tol)


INT8_PREFILL = [
    # M, K, N: OLMo-1B's prefill projections at the widest prefill, and
    # ragged M, K, N with aligned rows; bf16 x, the tensor-core route's
    # only dtype
    (4096, 2048, 2048), (4096, 2048, 8192), (4096, 8192, 2048),
    (4100, 2056, 8208),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_PREFILL)
def test_int8_tensor_core_prefill_shapes(cuda, case):
    M, K, N = case
    x, w = _tensors(9, cuda, torch.float32, (M, K), (K, N))
    qd = quantize_array(w * 0.1, 8)
    wq, sc = qd["__q__"], qd["scale"]
    x = x.to(torch.bfloat16)
    assert ops.int8_matmul_route(x, wq, sc) == "tensor_core"
    by_route = ops.int8_matmul.launches_by_route["tensor_core"]
    got = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert ops.int8_matmul.launches_by_route["tensor_core"] == by_route + 1
    _close(got, int8_matmul_ref(x, wq, sc), DTYPES["bf16"][1])


@pytest.mark.cuda
def test_int8_tensor_core_single_tile(cuda):
    """One 64 x 128 x 64 tile against the exact product: integer x and
    unit scales make every partial sum an integer below 2^24, so the
    bf16 x bf16 -> f32 product is exact and any swizzle or descriptor
    fault shows as a wrong entry."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-8, 9, (64, 64)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 128)).astype(np.int8))
    want = (x @ wq.float()).to(torch.bfloat16)
    x, wq = x.to(cuda, torch.bfloat16), wq.to(cuda)
    sc = torch.ones(1, 128, device=cuda)
    assert ops.int8_matmul_route(x, wq, sc) == "tensor_core"
    got = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "head"])
@pytest.mark.parametrize("M", [8, 16])
def test_int8_skinny_tc_single_tile(cuda, layout, M):
    """The swapped layout (the weight as the MMA's A, x as B) against the
    exact product: integer x and unit scales make every partial sum an
    integer below 2^24, so the bf16 x bf16 -> f32 product and the split-K
    sums are exact and any fragment-mapping fault shows as a wrong entry.
    K = 512 gives the KN route 32 k steps in several splits."""
    rng = np.random.default_rng(12)
    K, N = 512, 128
    x = torch.from_numpy(rng.integers(-8, 9, (M, K)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    want = (x @ wq.float()).to(torch.bfloat16)
    x = x.to(cuda, torch.bfloat16)
    if layout == "kn":
        wq, sc = wq.to(cuda), torch.ones(1, N, device=cuda)
    else:   # the head's (d, V) view of a (V, d) weight, per-K scale
        wq = wq.t().contiguous().to(cuda).t()
        sc = torch.ones(K, 1, device=cuda)
    assert ops.int8_matmul_route(x, wq, sc) == "skinny_tc"
    got = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (8, 2048, 2048, "kn"), (8, 8192, 2048, "kn"), (8, 2048, 50304, "head"),
    (13, 136, 208, "kn")])
def test_int8_skinny_tc_bit_identical_launches(cuda, case):
    """Split-K partials merge in split order: two launches, same bits."""
    x, wq, sc = _int8_operands(cuda, 13, *case)
    x = x.to(torch.bfloat16)
    assert ops.int8_matmul_route(x, wq, sc) == "skinny_tc"
    a = ops.int8_matmul(x, wq, sc)
    b = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def on_one_route(wrapper, route, call):
    before = dict(wrapper.launches_by_route)
    out = call()
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in wrapper.launches_by_route.items()
             if n != before[r]}
    assert moved == {route: 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["head", "kn"])
def test_int8_unaligned_per_k_scale_stays_skinny(cuda, layout):
    """skinny_tc reads a per-K scale four floats at a time, so a per-K
    scale off a 16-byte boundary routes to skinny (and the C entry refuses
    it on skinny_tc): no misaligned read, the same product."""
    x, wq, sc = _int8_operands(cuda, 14, 8, 2048, 512, "head")
    if layout == "kn":
        wq = wq.contiguous()
    x = x.to(torch.bfloat16)
    shifted = torch.empty(sc.numel() + 1, device=cuda)[1:].view(-1, 1)
    shifted.copy_(sc)
    assert shifted.data_ptr() % 16
    assert ops.int8_matmul_route(x, wq, shifted) == "skinny"
    got = on_one_route(ops.int8_matmul, "skinny",
                       lambda: ops.int8_matmul(x, wq, shifted))
    _close(got, int8_matmul_ref(x, wq, sc), 2e-2)
    out = torch.empty(8, 512, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._run("int8_matmul", cuda, x.data_ptr(), wq.data_ptr(),
                 shifted.data_ptr(), out.data_ptr(), None, None, 8, 512,
                 2048, *wq.stride(), 1, 1,
                 ops.INT8_ROUTES.index("skinny_tc"), 1, 128)


@pytest.mark.cuda
def test_split_kernels_on_two_streams(cuda):
    """Each stream gets its own counters and partials: the split kernels
    launched on two streams at once give, launch for launch, the bits of
    a launch on one stream alone."""
    B, K, G, S, hd, win, pre, pos = DECODE[9]
    q, = _tensors(6, cuda, torch.bfloat16, (B, K, G, hd))
    kc, vc = (c.permute(0, 2, 1, 3) for c in
              _tensors(7, cuda, torch.bfloat16, (B, S, K, hd), (B, S, K, hd)))
    dargs = (q, kc, vc, torch.tensor(pos, dtype=torch.int32, device=cuda))
    x, wq, sc = _int8_operands(cuda, 13, 8, 8192, 2048, "kn")
    x = x.to(torch.bfloat16)
    pcase = PAGED_SPLIT[0]
    pargs = _paged_inputs(cuda, torch.bfloat16, pcase, 5)
    want_d = ops.decode_attention(*dargs, window=win, prefix=pre)
    want_m = ops.int8_matmul(x, wq, sc)
    want_p = ops.paged_decode_attention(*pargs)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    got = {0: [], 1: []}
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append((ops.decode_attention(*dargs, window=win,
                                                    prefix=pre),
                               ops.int8_matmul(x, wq, sc),
                               ops.paged_decode_attention(*pargs)))
    torch.cuda.synchronize()
    ptrs = set()
    for st in streams:
        with torch.cuda.stream(st):
            ptrs.add(ops._split_buffers(q.device, 1, 1)[0].data_ptr())
    assert len(ptrs) == 2
    for outs in got.values():
        for d, m, pa in outs:
            assert torch.equal(d, want_d) and torch.equal(m, want_m)
            assert torch.equal(pa, want_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [DECODE[9], DECODE[11], DECODE[14],
                                  DECODE[15], DECODE[16], DECODE[18],
                                  DECODE[19]])
def test_decode_kernel_bit_identical_launches(cuda, case):
    """The splits of a row merge in split order: two launches, same bits
    (the OLMo-1B decode shape, chunk edges, G > 8, gemma3's hd 256, the
    MoE models' G 3 and G 6)."""
    B, K, G, S, hd, win, pre, pos = case
    q, = _tensors(6, cuda, torch.bfloat16, (B, K, G, hd))
    kc, vc = (c.permute(0, 2, 1, 3) for c in
              _tensors(7, cuda, torch.bfloat16, (B, S, K, hd), (B, S, K, hd)))
    args = (q, kc, vc, torch.tensor(pos, dtype=torch.int32, device=cuda))
    a = ops.decode_attention(*args, window=win, prefix=pre)
    b = ops.decode_attention(*args, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [PAGED[6], PAGED_SPLIT[0], PAGED_SPLIT[2],
                                  PAGED_SPLIT[6], PAGED_SPLIT[9],
                                  PAGED_SPLIT[10], PAGED_SPLIT[12],
                                  PAGED_SPLIT[13]])
def test_paged_kernel_bit_identical_launches(cuda, case):
    """The chunks of a slot merge in chunk order: two launches, same bits
    (the OLMo-1B decode shape, chunk edges, sentinel holes, G > 8,
    gemma3's hd 256, the MoE models' G 3 and G 6)."""
    if len(case) == 9:   # a PAGED case: pos as test_paged_kernel_matches_plain
        B, ps, pps = case[0], case[5], case[4]
        case = case + ([0, ps * 2 + 3, ps * pps - 1][:B], "plain")
    args = _paged_inputs(cuda, torch.bfloat16, case, 5)
    win, pre = case[7], case[8]
    a = ops.paged_decode_attention(*args, window=win, prefix=pre)
    b = ops.paged_decode_attention(*args, window=win, prefix=pre)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _tensors(4, cuda, torch.float32, (1, 2, 8, 24), (1, 2, 8, 24),
                       (1, 2, 8, 24))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _tensors(4, cuda, torch.float16, (1, 2, 8, 16), (1, 2, 8, 16),
                       (1, 2, 8, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v)
    q, k = _tensors(4, cuda, torch.bfloat16, (1, 2, 8, 16), (1, 2, 8, 16))
    v = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16,
                    device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention(q, k, v)     # k and v strides differ
    kc = torch.zeros(2, 4, 16, 32, device=cuda)[:, :, :, :16]   # rows of 64 B
    q = torch.zeros(2, 4, 1, 16, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    ops.decode_attention(q, kc, kc, pos)     # 16-byte rows: accepted
    with pytest.raises(ValueError, match="strides"):
        ops.decode_attention(q, kc.transpose(2, 3)[:, :, :16], kc, pos)
    q, kp, vp, table, pos = _paged_inputs(cuda, torch.float32,
                                          PAGED_SPLIT[1], 6)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(q[..., :24].contiguous(),
                                   kp[..., :24].contiguous(),
                                   vp[..., :24].contiguous(), table, pos)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q.half(), kp.half(), vp.half(), table,
                                   pos)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, table.long(), pos)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(q, kp, vp, table[:, :0], pos)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, kp, vp, table.t().contiguous().t(),
                                   pos)
    with pytest.raises(RuntimeError, match="launch failed"):   # 33 chunks
        ops._paged_decode(q, kp, vp, table, pos, 0, 0, splits=(33, 1))
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 6, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        ops.int8_matmul(x, w, torch.ones(1, 8, device=cuda))
    with pytest.raises(TypeError):
        ops.int8_matmul(x, w.float(), torch.ones(1, 6, device=cuda))


@pytest.mark.cuda
def test_kernels_refuse_a_route_whose_conditions_fail(cuda):
    """The C entries check the route they are given: f32 x on the int8
    tensor-core routes (tensor_core, skinny_tc), and f32 on the flash
    tensor-core route, are refused with an error the wrapper raises, not
    run."""
    x = torch.zeros(32, 64, device=cuda)
    w = torch.zeros(64, 128, dtype=torch.int8, device=cuda)
    sc = torch.ones(1, 128, device=cuda)
    out = torch.empty(32, 128, device=cuda)
    for m, route in ((32, "tensor_core"), (8, "skinny_tc")):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._run("int8_matmul", cuda, x.data_ptr(), w.data_ptr(),
                     sc.data_ptr(), out.data_ptr(), None, None, m, 128, 64,
                     128, 1, 0, 0, ops.INT8_ROUTES.index(route), 1, 4)
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._run("flash_attention", cuda, q.data_ptr(), q.data_ptr(),
                 q.data_ptr(), q.data_ptr(), 1, 2, 2, 8, 8, 16, 1, 0, 0, 0,
                 ops.FLASH_ROUTES.index("tensor_core"), 0.25,
                 *q.stride()[:3], *q.stride()[:3], *q.stride()[:3])


# --------------------------------------------------------------------- #
# the hierarchical KV memory and speculation on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_take_put_pages_round_trip_through_pinned_memory(cuda, dt):
    """Swap-out (`take_pages`) and swap-in (`put_pages`) through the
    pinned host tier: the pages come back bit for bit into other pages,
    the swap-out synchronises with the host exactly once (one `.cpu()`)
    and the swap-in never."""
    import warnings
    from repro_torch.serving.kv_cache import put_pages, take_pages
    from repro_torch.serving.kv_hierarchy import HostPagePool
    dtype, _ = DTYPES[dt]
    paged = dict(zip(("k", "v"), _tensors(20, cuda, dtype, (3, 13, 16, 2, 64),
                                          (3, 13, 16, 2, 64))))
    before = {k: v.clone() for k, v in paged.items()}
    host = HostPagePool(8, paged, pin=True)

    def syncs(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return out, sum("synchroniz" in str(w.message) for w in caught)
    blocks, n_out = syncs(lambda: take_pages(paged, [1, 4, 7]))
    assert n_out == 1
    ids = host.put(blocks, 3)
    assert all(s.is_pinned() for s in host._slab.values())
    staged = host.get(ids)
    assert all(s.is_pinned() for s in staged.values())
    _, n_in = syncs(lambda: put_pages(paged, [9, 10, 11], staged))
    assert n_in == 0
    torch.cuda.synchronize()
    for k in paged:
        assert torch.equal(paged[k][:, 9:12], before[k][:, [1, 4, 7]])
        assert torch.equal(paged[k][:, :9], before[k][:, :9])


ENGINE_FEATURES = {
    "prefix_cache_paged": dict(paged_attention=True, prefix_cache=True),
    "prefix_cache_gather": dict(prefix_cache=True),
    "swap": dict(n_slots=6, kv_pages=18, host_kv_pages=64),
    "speculative": dict(paged_attention=True, speculative=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(ENGINE_FEATURES))
def test_engine_features_match_the_cpu(cuda, feature):
    """The prefix cache (paged attention and gather), the host swap tier
    and speculative decoding on the card give the greedy tokens of the
    same engine on the CPU (reduced OLMo-1B, f32, the same weights)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    shared = list(range(1, 25))
    prompts = ([shared + [30, 31], shared + [40, 41, 42], shared[:12] + [7]]
               if feature.startswith("prefix") else
               [list(range(1, 3 + i)) for i in range(6)])
    kw = dict(n_slots=4, max_len=48, page_size=8, decode_block=4)
    kw.update(ENGINE_FEATURES[feature])
    outs, stats = {}, {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, params, EngineConfig(**kw), device=dev)
        reqs = [Request(model="m", prompt=p,
                        sampling=SamplingParams(max_tokens=20))
                for p in prompts]
        for r in reqs:
            assert eng.submit(r)
            if feature.startswith("prefix"):    # each sees the cache
                eng.run_until_done()
        eng.run_until_done()
        outs[str(dev)] = [r.output for r in reqs]
        st = eng.perf_stats()
        stats[str(dev)] = {k: st[k] for k in (
            "suffix_prefills", "swap_outs", "swap_ins", "spec_dispatches",
            "dispatches", "host_syncs")}
    assert outs[str(cuda)] == outs["cpu"]
    assert stats[str(cuda)] == stats["cpu"]
    assert any(stats["cpu"][k] for k in ("suffix_prefills", "swap_outs",
                                         "spec_dispatches"))


@pytest.mark.cuda
def test_gateway_runtime_crash_migrates_on_the_card(cuda):
    """A two-node stack on the card (reduced OLMo-1B, f32, one weight tree
    shared by both engines) behind the controller and the Gateway with its
    pump threads: 6 greedy requests, one node crashed while a stream with
    room left is past its first token.  Every request gets exactly its
    budget with the tokens of the same stack on the CPU, one migration at
    least, and the kernels launched from the pump threads count exactly
    what the engines' stats imply (the replica the controller re-places
    on the survivor included)."""
    import time

    from repro_torch.api import Gateway
    from repro_torch.cluster import BackendNode, Fleet
    from repro_torch.configs import ARCHS
    from repro_torch.core import ModelCatalog, ModelDemand, SDAIController
    from repro_torch.models import build
    from repro_torch.serving import SamplingParams
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    host = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    budgets = [24, 9, 30, 17, 5, 28]
    prompts = [list(range(1, 3 + i)) for i in range(6)]

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    def serve(dev, crash):
        params = to(host, dev)
        fleet = Fleet([BackendNode(f"n{i}", "rx6800-16gb",
                                   param_store=lambda c: params, device=dev)
                       for i in range(2)])
        catalog = ModelCatalog()
        catalog.register(cfg)
        ctrl = SDAIController(fleet, catalog)
        ctrl.discover()
        ctrl.deploy([ModelDemand(cfg, min_replicas=2, max_replicas=2,
                                 n_slots=4, max_len=64)])
        engines = [i.engine for n in fleet.nodes.values()
                   for i in n.instances.values()]
        assert len(engines) == 2
        assert all(e.device.type == torch.device(dev).type for e in engines)
        gw = Gateway(ctrl)
        gw.start()
        ops.reset_launches()
        hs = [gw.submit(cfg.name, p, SamplingParams(max_tokens=n))
              for p, n in zip(prompts, budgets)]
        if crash:
            deadline = time.monotonic() + 120
            victim = None
            while victim is None and time.monotonic() < deadline:
                for h in hs:
                    n = len(h.internal.output)
                    if 0 < n <= h.request.sampling.max_tokens - 8 \
                            and not h.done:
                        victim = h.internal.node
                        break
                else:
                    time.sleep(0.001)
            assert victim is not None
            fleet.fail_node(victim)
        resps = [h.result(timeout_s=300) for h in hs]
        threads = gw.runtime.threads()
        assert gw.stop(drain=True, timeout_s=60) is True
        assert not any(t.is_alive() for t in threads)
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        # the controller re-places a lost replica on the survivor (below
        # min_replicas); the crashed node keeps its instances
        engines += [i.engine for n in fleet.nodes.values()
                    for i in n.instances.values()
                    if all(i.engine is not e for e in engines)]
        want = {"flash_attention": 0, "decode_attention": 0}
        for e in engines:
            st = e.perf_stats()
            want["flash_attention"] += cfg.n_layers * st["prefill_dispatches"]
            want["decode_attention"] += (cfg.n_layers * e.ecfg.decode_block
                                         * st["decode_dispatches"])
        return resps, launches, want, gw.stats.migrations

    ref, _, _, _ = serve("cpu", crash=False)
    resps, launches, want, migrations = serve(cuda, crash=True)
    assert [len(r.tokens) for r in resps] == budgets
    assert all(r.ok for r in resps)
    assert [r.tokens for r in resps] == [r.tokens for r in ref]
    assert migrations >= 1
    assert launches["flash_attention"] == want["flash_attention"] > 0
    assert launches["decode_attention"] == want["decode_attention"] > 0
    assert launches["paged_decode_attention"] == 0


@pytest.mark.cuda
def test_launch_counts_exact_from_pump_like_threads(cuda):
    """Eight threads launch the decode kernel on the card at once (all on
    the default stream, as the serving runtime's pump threads do): the
    counter loses no launch, and every output equals the plain version."""
    import threading
    q, k, v = _tensors(3, cuda, torch.bfloat16, (4, 2, 1, 64),
                       (4, 2, 256, 64), (4, 2, 256, 64))
    pos = torch.tensor([255, 100, 7, 0], dtype=torch.int32, device=cuda)
    want = decode_attention_ref(q, k, v, pos)
    ops.reset_launches()
    n_threads, n_each, bad = 8, 200, []
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(n_each):
            out = ops.decode_attention(q, k, v, pos)
            if not torch.allclose(out.float(), want.float(), atol=2e-2,
                                  rtol=2e-2):
                bad.append(out)
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    torch.cuda.synchronize()
    assert not bad
    assert ops.decode_attention.launches == n_threads * n_each
    ops.reset_launches()


SERVED_GQA = [
    # model, H, K, hd of the full zoo configs and of seamless-m4t-large-v2's
    # decoder self-attention (flash at B = 4, decode at 8)
    ("llama3.2-1b", 32, 8, 64),
    ("qwen3-1.7b", 16, 8, 128),
    ("seamless-m4t-large-v2", 16, 16, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_GQA, ids=[c[0] for c in SERVED_GQA])
def test_flash_kernel_at_the_served_gqa_shapes(cuda, case):
    """A causal bf16 prefill of 4 rows of 1024 at the served models' heads
    (G = 4, hd 64; G = 2, hd 128; G = 1, hd 64), through the model's
    strided views."""
    _, H, K, hd = case
    q, k, v = _tensors(15, cuda, torch.bfloat16, (4, 1024, H, hd),
                       (4, 1024, K, hd), (4, 1024, K, hd))
    qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
    got = _flash_checked(qv, kv, vv, "bf16", causal=True)
    _close(got, flash_attention_ref(qv.contiguous(), kv.contiguous(),
                                    vv.contiguous()), DTYPES["bf16"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SERVED_GQA, ids=[c[0] for c in SERVED_GQA])
def test_decode_kernel_at_the_served_gqa_shapes(cuda, case):
    """8 slots over a (B, S, K, hd) cache of 1024 at the served models'
    heads, ragged positions from a seed with one slot at 0 and one at
    1023."""
    _, H, K, hd = case
    B, S = 8, 1024
    pos = np.random.default_rng(16).integers(1, S, B)
    pos[0], pos[-1] = 0, S - 1
    q, = _tensors(17, cuda, torch.bfloat16, (B, K, H // K, hd))
    kc, vc = (c.permute(0, 2, 1, 3) for c in _tensors(
        18, cuda, torch.bfloat16, (B, S, K, hd), (B, S, K, hd)))
    args = (q, kc, vc, torch.tensor(pos.tolist(), dtype=torch.int32,
                                    device=cuda))
    before = ops.decode_attention.launches
    got = ops.decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    _close(got, decode_attention_ref(*args), DTYPES["bf16"][1])


@pytest.mark.cuda
def test_http_greedy_request_on_a_full_width_llama(cuda):
    """The paper's llama3.2-1b at full width cut to 2 layers, in f32, its
    RMS-norm scales drawn from a seed, on two replicas of the paper's
    testbed behind the HTTP service: one greedy completion, streamed,
    equals the plain greedy recompute on the card and launches flash and
    decode attention."""
    import dataclasses

    from repro_torch.api import Gateway
    from repro_torch.api.http import GatewayHTTPServer, HTTPClient, HTTPConfig
    from repro_torch.cluster import paper_testbed
    from repro_torch.configs import ZOO
    from repro_torch.core import (ControllerConfig, ModelCatalog,
                                  ModelDemand, SDAIController)
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(ZOO["llama3.2-1b"], n_layers=2, dtype="f32")
    params = build(cfg, cuda).init(torch.Generator(device=cuda)
                                   .manual_seed(0))
    rng = np.random.default_rng(19)
    for tree, key in ((params["layers"], "ln1"), (params["layers"], "ln2"),
                      (params, "final_norm")):
        tree[key] = torch.from_numpy(rng.normal(0.0, 0.5, tuple(
            tree[key].shape)).astype(np.float32)).to(cuda)
    prompt = rng.integers(0, cfg.vocab, 37).tolist()
    toks, want = list(prompt), []
    for _ in range(12):
        logits = tf.forward(params, cfg, torch.tensor([toks], device=cuda),
                            impl="full")[0, -1]
        want.append(int(logits.argmax()))
        toks.append(want[-1])
    catalog = ModelCatalog()
    catalog.register(cfg)
    ctrl = SDAIController(paper_testbed(param_store=lambda c: params,
                                        device=cuda), catalog,
                          ControllerConfig(
                              real_param_threshold=cfg.num_params() + 1))
    ctrl.discover()
    plan = ctrl.deploy([ModelDemand(cfg, min_replicas=2, max_replicas=2,
                                    n_slots=2, max_len=128,
                                    allow_quant=False)])
    assert not plan.unplaced and len(plan.assignments) == 2
    server = GatewayHTTPServer(Gateway(ctrl), HTTPConfig(port=0)).start()
    c = HTTPClient(server.url())
    try:
        ops.reset_launches()
        got = [ch["choices"][0]["token"]
               for ch in c.complete(cfg.name, prompt, max_tokens=12,
                                    stream=True, timeout_s=300)
               if ch["choices"][0].get("token") is not None]
    finally:
        c.close()
        assert server.stop(timeout_s=60)
    assert got == want
    assert ops.flash_attention.launches > 0
    assert ops.decode_attention.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged_attention", "gather",
                                  "contiguous"])
@pytest.mark.parametrize("name", ["gemma3-1b", "gemma3-4b"])
def test_gemma_engines_match_the_cpu(cuda, name, mode):
    """The reduced gemma3-1b (window 16, G = 4) and gemma3-4b (window 16,
    4 vision prefix tokens), with head_dim 256, in f32: the engine on the
    card gives the greedy tokens and counters of the same engine on the
    CPU, with prompts past the window."""
    from repro_torch.configs import ZOO
    from repro_torch.models import build
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    cfg = ZOO[name].reduced(dtype="f32", head_dim=256)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (20, 37, 9)]
    kw = {"paged_attention": dict(paged_attention=True), "gather": {},
          "contiguous": dict(paged=False)}[mode]
    outs, stats = {}, {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=64, page_size=8, decode_block=4, **kw),
            device=dev)
        reqs = [Request(model="m", prompt=p,
                        sampling=SamplingParams(max_tokens=14))
                for p in prompts]
        for r in reqs:
            assert eng.submit(r)
        ops.reset_launches()
        eng.run_until_done()
        outs[str(dev)] = [r.output for r in reqs]
        st = eng.perf_stats()
        stats[str(dev)] = {k: st[k] for k in ("dispatches", "host_syncs")}
    assert outs[str(cuda)] == outs["cpu"]
    assert stats[str(cuda)] == stats["cpu"]
    assert ops.flash_attention.launches > 0
    attn = (ops.paged_decode_attention if mode == "paged_attention"
            else ops.decode_attention)
    assert attn.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged_attention", "gather",
                                  "contiguous", "int8"])
@pytest.mark.parametrize("kv", [4, 2])
def test_hymba_engines_match_the_cpu(cuda, kv, mode):
    """The reduced hymba-1.5b (window 16 but in layer 0, 2 meta tokens,
    G = 1 and G = 2) in f32: the engine on the card gives the greedy
    tokens and counters of the same engine on the CPU, prompts past the
    window, the SSM state carried slot by slot."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    cfg = ARCHS["hymba-1.5b"].reduced(dtype="f32", n_kv_heads=kv)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (20, 37, 9)]
    kw = {"paged_attention": dict(paged_attention=True), "gather": {},
          "contiguous": dict(paged=False),
          "int8": dict(quantize="int8")}[mode]
    outs, stats = {}, {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=64, page_size=8, decode_block=4, **kw),
            device=dev)
        reqs = [Request(model="m", prompt=p,
                        sampling=SamplingParams(max_tokens=14))
                for p in prompts]
        for r in reqs:
            assert eng.submit(r)
        ops.reset_launches()
        eng.run_until_done()
        outs[str(dev)] = [r.output for r in reqs]
        st = eng.perf_stats()
        stats[str(dev)] = {k: st[k] for k in ("dispatches", "host_syncs",
                                              "prefill_shapes")}
    assert outs[str(cuda)] == outs["cpu"]
    assert stats[str(cuda)] == stats["cpu"]
    assert ops.flash_attention.launches > 0
    attn = (ops.paged_decode_attention if mode == "paged_attention"
            else ops.decode_attention)
    assert attn.launches > 0


# the encoder-decoder's flash shapes at seamless-m4t-large-v2's width (16
# heads over 16, hd 64): the encoder's self-attention over 1024 frames,
# the cross-attention of a prefill bucket over them (Sq != Skv), and a
# ragged reduced-width pair (hd 16)
CROSS = [
    # B, H, K, Sq, Skv, hd
    (2, 16, 16, 1024, 1024, 64),
    (4, 16, 16, 64, 1024, 64),
    (2, 16, 16, 300, 1024, 64),
    (2, 4, 4, 37, 19, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CROSS)
def test_flash_kernel_non_causal_cross_shapes(cuda, case, dt):
    """Non-causal flash, Sq != Skv among the cases, against its plain
    version; each launch counted as non-causal on its dtype's route."""
    B, H, K, Sq, Skv, hd = case
    dtype, tol = DTYPES[dt]
    q, k, v = _tensors(9, cuda, dtype, (B, H, Sq, hd), (B, K, Skv, hd),
                       (B, K, Skv, hd))
    before = ops.flash_attention.launches_non_causal
    got = _flash_checked(q, k, v, dt, causal=False)
    assert ops.flash_attention.launches_non_causal == before + 1
    _close(got, flash_attention_ref(q, k, v, causal=False), tol)


def _engine_runs(cuda, cfg, params, prompts, budget, **kw):
    """The same engine and greedy requests on the CPU and on the card:
    {device: (tokens, counters)}, the card's launches left in the
    wrappers' counters."""
    from repro_torch.serving import (EngineConfig, InferenceEngine, Request,
                                     SamplingParams)
    runs = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=64, page_size=8, decode_block=4, **kw),
            device=dev)
        reqs = [Request(model="m", prompt=p,
                        sampling=SamplingParams(max_tokens=budget))
                for p in prompts]
        for r in reqs:
            assert eng.submit(r)
        ops.reset_launches()
        eng.run_until_done()
        st = eng.perf_stats()
        runs[str(dev)] = ([r.output for r in reqs],
                          {k: st[k] for k in (
                              "dispatches", "host_syncs", "prefill_shapes",
                              "prefill_dispatches", "decode_dispatches")})
    return runs["cpu"], runs[str(cuda)]


ENGINE_MODES = {"paged_attention": dict(paged_attention=True), "gather": {},
                "contiguous": dict(paged=False),
                "int8": dict(quantize="int8")}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_xlstm_engines_match_the_cpu(cuda, mode):
    """The reduced xlstm-125m at 4 layers (2 pairs) in f32: the engine on
    the card (every config in the contiguous mode: nothing to page) gives
    the greedy tokens and counters of the same engine on the CPU, a
    budget past max_len included; int8 launches 7 products a pair and
    the head each model call."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = ARCHS["xlstm-125m"].reduced(dtype="f32", n_layers=4)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (20, 37, 9)]
    cpu, card = _engine_runs(cuda, cfg, params, prompts, 70,
                             **ENGINE_MODES[mode])
    assert card == cpu
    assert all(len(t) == 70 for t in card[0])
    assert ops.flash_attention.launches == 0
    assert ops.decode_attention.launches == 0
    assert ops.paged_decode_attention.launches == 0
    if mode == "int8":
        calls = card[1]["prefill_dispatches"] \
            + 4 * card[1]["decode_dispatches"]
        assert ops.int8_matmul.launches == (7 * 2 + 1) * calls


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_encdec_engines_match_the_cpu(cuda, mode):
    """The reduced seamless-m4t-large-v2 in f32: the engine on the card
    gives the greedy tokens and counters of the same engine on the CPU;
    the prefill runs non-causal flash (the encoder, the cross-attention)
    and every decode mode the decode kernel (the cross-attention over
    the slot-resident cross K/V)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = ARCHS["seamless-m4t-large-v2"].reduced(dtype="f32")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(28)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (20, 37, 9)]
    cpu, card = _engine_runs(cuda, cfg, params, prompts, 14,
                             **ENGINE_MODES[mode])
    assert card == cpu
    assert ops.flash_attention.launches_non_causal > 0
    assert ops.decode_attention.launches > 0
    if mode == "paged_attention":
        assert ops.paged_decode_attention.launches > 0


@pytest.mark.cuda
def test_encdec_cross_path_matches_the_plain_versions(cuda):
    """With random frames (the engine feeds zeros, ROADMAP.md C17), the
    model's prefill and 4 decode steps on the card (non-causal flash,
    the decode kernel over the cross K/V) equal the same calls on the
    CPU, through the plain versions, within f32's 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models import transformer as tf
    cfg = ARCHS["seamless-m4t-large-v2"].reduced(dtype="f32")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(29)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 13)))
    src = torch.from_numpy(rng.standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2)).astype(
        np.int32))
    outs = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        logits, rows, pos = tf.prefill(p, cfg, toks.to(dev),
                                       src_embeds=src.to(dev))
        cache = {name: rows[name] for name in ("ck", "cv")}
        for name in ("k", "v"):
            cache[name] = rows[name].new_zeros(
                (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim))
            cache[name][:, :, :13] = rows[name]
        got = [logits, rows["ck"]]
        for tok in nxt:
            pos = pos + 1
            step, cache = tf.decode_step(p, cfg, cache, tok.to(dev), pos)
            got.append(step)
        outs[str(dev)] = [g.cpu() for g in got]
    assert float(outs["cpu"][1].abs().max()) > 0.1
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        _close(got, want, 1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
def test_int8_kv_decode_matches_cpu(cuda):
    """The int8 KV cache on the card against the CPU (a reduced OLMo, 3
    rows of 40 tokens into a cache of 64, 4 steps).  prefill(kv_quant=
    True): scales within 1e-5 relative, q within one step (the devices'
    K and V differ by ulps, which moves a value at a .5 tie).  The
    decode steps (the decode kernel on its f32 route over the
    dequantized cache) from the card's prefilled cache on both devices:
    f32 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    cfg = ARCHS["olmo-1b"].reduced(dtype="f32")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(31)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 40)).astype(
        np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 3)).astype(
        np.int32))
    caches = {}
    for dev in ("cpu", cuda):
        with torch.no_grad():
            caches[str(dev)] = build(cfg, dev).prefill(
                _to(params, dev), toks.to(dev), cache_len=64, kv_quant=True)
    card, pos = caches[str(cuda)][1:]
    want = caches["cpu"][1]
    for name in ("k", "v"):
        assert card[name].dtype == torch.int8
        _close(card[f"{name}_scale"].cpu(), want[f"{name}_scale"], 1e-5)
        assert int((card[name].cpu().int() - want[name].int()).abs().max()) \
            <= 1
    start = {k: v.cpu() for k, v in card.items()}
    outs = {}
    for dev, cache in ((cuda, card), ("cpu", start)):
        model, p = build(cfg, dev), _to(params, dev)
        ops.reset_launches()
        got = []
        with torch.no_grad():
            for i, tok in enumerate(nxt):
                step, cache = model.decode(p, cache, tok.to(dev),
                                           pos.to(dev) + 1 + i)
                got.append(step.cpu())
        outs[str(dev)] = got
        if dev == cuda:
            assert ops.decode_attention.launches == 4 * cfg.n_layers
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        _close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "xlstm-125m"])
def test_train_step_matches_cpu(cuda, arch):
    """One train step's loss and gradients (remat, autograd) at reduced
    width on the card against the CPU: the loss within 1e-5 relative,
    each gradient leaf within 1e-4 of its largest magnitude (xLSTM's b_i
    against w_i's, as in tests/test_torch_loss.py); no kernel launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build
    from repro_torch.training.tree import items
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[arch].reduced(dtype="f32")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(41)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33)).astype(
        np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].contiguous()}
    ops.reset_launches()
    got, gm = loss_and_grads(build(cfg, cuda), _to(params, cuda),
                             _to(batch, cuda))
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)
    want, wm = loss_and_grads(build(cfg, "cpu"), params, batch)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
        1e-5 * abs(float(wm["loss"]))
    scale = {p: float(w.abs().max()) for p, w in items(want)}
    for (path, g), (_, w) in zip(items(got), items(want)):
        ref = scale["pairs/mlstm/w_i" if path == "pairs/mlstm/b_i"
                    else path]
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * ref, path


@pytest.mark.cuda
def test_crash_resume_on_the_card(cuda, tmp_path):
    """train(8) == train(4) + crash + resume(4) on the card, bit for bit:
    the step is deterministic there (the embedding's backward sums in a
    fixed order)."""
    from repro_torch.configs import ARCHS
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    from repro_torch.training.tree import items, leaves
    cfg = ARCHS["xlstm-125m"].reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, batch=2)

    def run(steps, d):
        return Trainer(cfg, dc, TrainConfig(steps=steps, ckpt_every=4,
                                            ckpt_dir=str(tmp_path / d),
                                            log_every=100),
                       device=cuda).run()
    full = run(8, "a")
    run(4, "b")
    resumed = run(8, "b")
    assert resumed["resumed_from"] == 4
    for (path, a), b in zip(items(full["state"]), leaves(resumed["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b), path
