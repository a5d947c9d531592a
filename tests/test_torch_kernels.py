"""The port's attention kernels against the JAX package's.

On the CPU: each plain PyTorch version (`paged_decode_attention_ref`,
`flash_attention_ref`, `decode_attention_ref`, `int8_matmul_ref`) is
held against the Pallas kernel in interpret mode and against the JAX
reference, on the cases of `tests/test_kernels.py`; the device-routing wrappers send CPU tensors to
the plain versions and launch nothing.  Inputs are made with numpy from
a seed and handed to both packages.  Tolerances: f32 2e-5 (the same
online softmax in another summation order), bf16 2e-2 (as
tests/test_kernels.py); int8 products f32 1e-4, bf16 5e-2 (the bf16
rounding of x and of the output).  The kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda.py.

The route functions of the wrappers (`flash_attention_route`,
`decode_attention_route`, `int8_matmul_route`) are held to each branch
here, and plain emulations of the tensor-core kernels' arithmetic (bf16
operands, f32 sums; flash's and the split decode kernels' P rounded to
bf16 before P.V; skinny_tc's per-K scale folded into x as a bf16 hi/lo
pair) against the JAX reference at bf16's 2e-2, skinny_tc's at 5e-2.
The split decode kernel's composition (per-chunk LSE partials merged in
chunk order) is held against JAX's `_lse_partials`, its reference and
its Pallas kernel at 1e-4, and the pure split functions of both split
kernels to their contracts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import paged_attention as jax_pa
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.int8_matmul import int8_matmul as jax_int8
from repro.serving.quantization import quantize_array as jax_quantize
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  lse_partials_ref,
                                                  split_decode_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.int8_matmul import int8_matmul_ref
from repro_torch.kernels.paged_attention import (paged_decode_attention_ref,
                                                 paged_lse_partials_ref,
                                                 split_paged_ref)

torch.set_num_threads(2)

F32_TOL, BF16_TOL = 2e-5, 2e-2
SPLIT_TOL = 1e-4     # an LSE merge of chunk partials (f32)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(a, dt):
    return jnp.asarray(a, dt)


def _torch(a, dt, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=dt)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


# ------------------- paged decode attention ------------------------ #
PAGED_CASES = [
    # B, K, G, n_pages, pps, ps, hd, window  (tests/test_kernels.py)
    (3, 2, 4, 24, 6, 8, 64, 0),
    (2, 4, 2, 32, 8, 4, 32, 0),
    (4, 1, 8, 24, 4, 8, 128, 0),
    (3, 2, 4, 24, 6, 8, 64, 16),     # sliding window
    (2, 1, 4, 24, 6, 8, 256, 16),    # hd 256 (gemma3), G 4, window
]


def _paged_case(seed, B, K, G, n_pages, pps, ps, hd):
    """Pools, a sentinel-padded table mapping just enough pages to cover
    each slot's ragged pos, and grouped queries — as numpy."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([ps - 1, ps * 2 + 3, ps * (pps - 1)][:B]
                     + [5] * max(B - 3, 0), np.int32)
    table = np.full((B, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            table[i, j] = next(free)
    kp, vp, q = _arrays(seed + 1, (n_pages, ps, K, hd), (n_pages, ps, K, hd),
                        (B, K, G, hd))
    return q, kp, vp, table, pos


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_ref_matches_jax(case):
    B, K, G, n_pages, pps, ps, hd, win = case
    q, kp, vp, table, pos = _paged_case(11, B, K, G, n_pages, pps, ps, hd)
    args = [_jax(q, jnp.float32), _jax(kp, jnp.float32),
            _jax(vp, jnp.float32), jnp.asarray(table), jnp.asarray(pos)]
    want_kernel = jax_pa.paged_decode_attention(*args, window=win,
                                                interpret=True)
    want_ref = jax_pa.paged_decode_attention_ref(*args, window=win)
    got = paged_decode_attention_ref(
        _torch(q, torch.float32), _torch(kp, torch.float32),
        _torch(vp, torch.float32), torch.from_numpy(table),
        torch.from_numpy(pos), window=win)
    _close(got, want_kernel, F32_TOL)
    _close(got, want_ref, F32_TOL)


def test_paged_ref_shared_pages():
    """Two slots mapping the same physical prefix page read the same keys
    through their own tables (the shared-page case of test_kernels.py)."""
    B, K, G, n_pages, ps, hd = 2, 2, 2, 16, 8, 32
    kp, vp, q1 = _arrays(5, (n_pages, ps, K, hd), (n_pages, ps, K, hd),
                         (1, K, G, hd))
    q = np.tile(q1, (B, 1, 1, 1))
    table = np.asarray([[3, 5, 16, 16], [3, 7, 16, 16]], np.int32)
    pos = np.asarray([ps * 2 - 1, ps * 2 - 1], np.int32)
    want = jax_pa.paged_decode_attention(
        _jax(q, jnp.float32), _jax(kp, jnp.float32), _jax(vp, jnp.float32),
        jnp.asarray(table), jnp.asarray(pos), interpret=True)
    got = paged_decode_attention_ref(
        _torch(q, torch.float32), _torch(kp, torch.float32),
        _torch(vp, torch.float32), torch.from_numpy(table),
        torch.from_numpy(pos))
    _close(got, want, F32_TOL)


def test_paged_ref_bf16_matches_jax():
    B, K, G, n_pages, pps, ps, hd, _ = PAGED_CASES[0]
    q, kp, vp, table, pos = _paged_case(3, B, K, G, n_pages, pps, ps, hd)
    want = jax_pa.paged_decode_attention(
        _jax(q, jnp.bfloat16), _jax(kp, jnp.bfloat16),
        _jax(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(pos),
        interpret=True)
    got = paged_decode_attention_ref(
        _torch(q, torch.bfloat16), _torch(kp, torch.bfloat16),
        _torch(vp, torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    _close(_f32(got), want.astype(jnp.float32), BF16_TOL)


SPLIT_PAGED_CASES = [
    # B, K, G, n_pages, pps, ps, hd, window, prefix, pos, holes: the
    # PAGED_CASES (pos as _paged_case makes it), then the kernel's edges
    *[c[:7] + (c[7], 0, None, False) for c in PAGED_CASES],
    (3, 2, 4, 40, 8, 8, 64, 16, 4, [5, 30, 63], False),    # window + prefix
    (2, 2, 2, 40, 8, 8, 256, 16, 4, [5, 63], False),       # hd 256 + prefix
    (3, 2, 2, 40, 12, 4, 32, 10, 0, [3, 27, 47], False),   # window crosses
    (2, 2, 2, 24, 6, 4, 32, 0, 0, [23, 15], True),         # sentinel holes
    (3, 2, 1, 24, 6, 4, 64, 0, 0, [0, 8, 15], False),      # chunk edges
    (2, 1, 3, 16, 4, 8, 16, 0, 0, [0, 0], False),          # pos 0
]


def _split_paged_case(case, seed):
    """Pools, a table mapping each slot's pages up to pos (with `holes`,
    every third column of a slot left at the sentinel inside its mapped
    range) and queries, as numpy."""
    B, K, G, n_pages, pps, ps, hd, win, pre, pos, holes = case
    if pos is None:
        return (*_paged_case(seed, B, K, G, n_pages, pps, ps, hd), win, pre)
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos, np.int32)
    table = np.full((B, pps), n_pages, np.int32)
    free = iter(rng.permutation(n_pages))
    for i, p in enumerate(pos):
        for j in range(p // ps + 1):
            if not (holes and j % 3 == 1):
                table[i, j] = next(free)
    kp, vp, q = _arrays(seed + 1, (n_pages, ps, K, hd), (n_pages, ps, K, hd),
                        (B, K, G, hd))
    return q, kp, vp, table, pos, win, pre


def _split_paged_check(q, kp, vp, table, pos, win, pre, ppcs):
    """split_paged_ref at each chunking in `ppcs` against the JAX
    reference and its Pallas kernel in interpret mode (f32)."""
    args = [_jax(q, jnp.float32), _jax(kp, jnp.float32),
            _jax(vp, jnp.float32), jnp.asarray(table), jnp.asarray(pos)]
    want_kernel = jax_pa.paged_decode_attention(*args, window=win,
                                                prefix=pre, interpret=True)
    want_ref = jax_pa.paged_decode_attention_ref(*args, window=win,
                                                 prefix=pre)
    for ppc in ppcs:
        got = split_paged_ref(
            _torch(q, torch.float32), _torch(kp, torch.float32),
            _torch(vp, torch.float32), torch.from_numpy(table),
            torch.from_numpy(pos), ppc=ppc, window=win, prefix=pre)
        _close(got, want_kernel, SPLIT_TOL)
        _close(got, want_ref, SPLIT_TOL)


@pytest.mark.parametrize("case", SPLIT_PAGED_CASES)
def test_split_paged_composition_matches_jax(case):
    """The paged kernel's split-and-merge at the wrapper's chunking for
    this shape on an H100's 132 SMs, at one page per chunk and at a
    chunking whose last chunk is short."""
    q, kp, vp, table, pos, win, pre = _split_paged_case(case, 13)
    B, K, _, _, pps, ps = case[:6]
    _, ppc, _ = ops.paged_decode_attention_splits(B, K, pps, ps, 132,
                                                  q.shape[-1])
    _split_paged_check(q, kp, vp, table, pos, win, pre, sorted({ppc, 1, 3}))


def test_split_paged_shared_pages():
    """Two slots mapping the same physical prefix page, each chunk of one
    page and of two."""
    B, K, G, n_pages, ps, hd = 2, 2, 2, 16, 8, 32
    kp, vp, q1 = _arrays(5, (n_pages, ps, K, hd), (n_pages, ps, K, hd),
                         (1, K, G, hd))
    q = np.tile(q1, (B, 1, 1, 1))
    table = np.asarray([[3, 5, 16, 16], [3, 7, 16, 16]], np.int32)
    pos = np.asarray([ps * 2 - 1, ps * 2 - 1], np.int32)
    _split_paged_check(q, kp, vp, table, pos, 0, 0, [1, 2, 4])


def test_paged_lse_partials_of_empty_chunks():
    """A chunk past pos and a chunk of sentinels hold no visible row:
    their m is -1e30, so they weigh 0 in the merge."""
    q, kp, vp, table, pos, _, _ = _split_paged_case(SPLIT_PAGED_CASES[-3],
                                                    13)
    tq, tk, tv = (_torch(a, torch.float32) for a in (q, kp, vp))
    ttab, tpos = torch.from_numpy(table), torch.from_numpy(pos)
    m, _, _ = paged_lse_partials_ref(tq, tk, tv, ttab[:, 4:5], tpos, 4)
    assert bool((m[1] == -1e30).all())       # slot 1: pos 15, rows 16-19
    m, _, _ = paged_lse_partials_ref(tq, tk, tv, ttab[:, 1:2], tpos, 1)
    assert bool((m == -1e30).all())          # column 1 is a hole in both


def test_paged_decode_attention_splits():
    """The tensor-core route (bf16): the chunks of a (slot, kv head) are
    one cluster of at most DECODE_MAX_CLUSTER (within the kernel's 16),
    the grid of one wave at 132 SMs fits the CTAs it holds beside the
    other (slot, kv head)s, gemma3-1b's one kv head gets 8 chunks, the
    OLMo-1B decode shape 2, the K = 8 models' 3.  The CUDA-core route (f32): at
    least 2 CTAs per SM at the OLMo-1B shape, merged through the
    workspace.  Both: one split when the table fits one chunk, the chunks
    cover the table's columns, none is empty, and the rule reads nothing
    but shapes."""
    tc, cc = "tensor_core", "cuda_core"
    assert ops.paged_decode_attention_splits(8, 16, 64, 16, 132, 128) \
        == (2, 32, 2)                                      # OLMo-1B
    assert ops.paged_decode_attention_splits(8, 8, 64, 16, 132, 128) \
        == (3, 24, 3)                                      # qwen3, mixtral
    assert ops.paged_decode_attention_splits(8, 1, 64, 16, 132, 256) \
        == (8, 8, 8)                                       # gemma3-1b
    n, ppc, cl = ops.paged_decode_attention_splits(8, 16, 64, 16, 132, 128,
                                                   cc)
    assert 8 * 16 * n >= 2 * 132 and n > 1 and cl == 1
    for route in (tc, cc):
        assert ops.paged_decode_attention_splits(8, 16, 4, 16, 132, 128,
                                                 route) == (1, 4, 1)
        assert ops.paged_decode_attention_splits(1, 1, 1, 8, 132, 64,
                                                 route) == (1, 1, 1)
    for b, k, pps, ps, n_sm, hd in [
            (b, k, pps, ps, n_sm, hd) for b in (1, 3, 8, 64)
            for k in (1, 2, 16) for pps in range(1, 300, 13)
            for ps in (1, 8, 12, 16, 64) for n_sm in (1, 132)
            for hd in ops.HEAD_DIMS]:
        for route in (tc, cc):
            args = (b, k, pps, ps, n_sm, hd, route)
            n, ppc, cl = ops.paged_decode_attention_splits(*args)
            assert 1 <= n <= ops.PAGED_MAX_SPLITS and ppc >= 1
            assert (n - 1) * ppc < pps <= n * ppc, (args, n, ppc)
            if route == cc:
                assert cl == 1
                continue
            assert cl == n <= ops.DECODE_MAX_CLUSTER <= 16
            wave = max(1, n_sm // 8) * 8 * ops.DECODE_TC_CTAS_PER_SM[hd]
            assert b * k * n <= max(wave, b * k), (args, n)
            ops.paged_decode_attention_splits.cache_clear()
            assert ops.paged_decode_attention_splits(*args) == (n, ppc, cl)


# ------------------- flash attention ------------------------------- #
FLASH_CASES = [
    # B, H, K, Sq, Skv, hd, win, prefix, dtype (small rows of test_kernels)
    (2, 4, 2, 128, 128, 64, 0, 0, "f32"),
    (1, 4, 2, 128, 128, 64, 48, 16, "f32"),     # window + prefix
    (1, 2, 2, 64, 64, 32, 0, 0, "bf16"),
    (1, 6, 2, 192, 192, 64, 0, 0, "f32"),       # non-pow2 heads
    (1, 4, 1, 128, 128, 256, 48, 16, "f32"),    # hd 256, window + prefix
    (1, 4, 2, 128, 128, 256, 40, 8, "bf16"),
]
_DT = {"f32": (jnp.float32, torch.float32, F32_TOL),
       "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_ref_matches_jax(case):
    B, H, K, Sq, Skv, hd, win, pre, dt = case
    jdt, tdt, tol = _DT[dt]
    q, k, v = _arrays(21, (B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd))
    jq, jk, jv = _jax(q, jdt), _jax(k, jdt), _jax(v, jdt)
    want_kernel = jax_flash(jq, jk, jv, causal=True, window=win, prefix=pre,
                            block_q=64, block_k=64, interpret=True)
    want_ref = jax_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                           window=win, prefix=pre)
    got = flash_attention_ref(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                              causal=True, window=win, prefix=pre)
    assert got.dtype == tdt
    _close(_f32(got), want_kernel.astype(jnp.float32), tol)
    _close(_f32(got), want_ref.astype(jnp.float32), tol)


def test_flash_ref_noncausal():
    q, k, v = _arrays(22, (1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64))
    want = jax_flash(_jax(q, jnp.float32), _jax(k, jnp.float32),
                     _jax(v, jnp.float32), causal=False, block_q=64,
                     block_k=64, interpret=True)
    got = flash_attention_ref(_torch(q, torch.float32),
                              _torch(k, torch.float32),
                              _torch(v, torch.float32), causal=False)
    _close(got, want, F32_TOL)


# ------------------- decode attention ------------------------------ #
DECODE_CASES = [
    # B, K, G, S, hd, window, prefix, block_k, pos (None: from a seed)
    (2, 2, 4, 512, 64, 0, 0, 128, None),     # tests/test_kernels.py
    (4, 8, 8, 256, 128, 0, 0, 128, None),
    (2, 1, 4, 512, 64, 128, 0, 128, None),
    (1, 4, 2, 1024, 64, 0, 0, 256, None),
    (3, 2, 8, 256, 32, 0, 0, 64, None),
    (4, 2, 2, 512, 64, 0, 0, 64, [0, 63, 200, 511]),   # ragged positions
    (3, 2, 4, 256, 64, 48, 16, 64, [5, 100, 255]),     # window + prefix
    (2, 1, 4, 256, 256, 48, 16, 64, [5, 255]),         # hd 256, G 4
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_ref_matches_jax(case):
    B, K, G, S, hd, win, pre, bk, pos = case
    q, kc, vc = _arrays(31, (B, K, G, hd), (B, K, S, hd), (B, K, S, hd))
    if pos is None:
        pos = np.random.default_rng(32).integers(max(win, 1), S, B)
    pos = np.asarray(pos, np.int32)
    args = [_jax(q, jnp.float32), _jax(kc, jnp.float32),
            _jax(vc, jnp.float32), jnp.asarray(pos)]
    want_kernel = jax_decode(*args, window=win, prefix=pre, block_k=bk,
                             interpret=True)
    want_ref = jax_ref.decode_attention_ref(*args, window=win, prefix=pre)
    got = decode_attention_ref(
        _torch(q, torch.float32), _torch(kc, torch.float32),
        _torch(vc, torch.float32), torch.from_numpy(pos), window=win,
        prefix=pre)
    _close(got, want_kernel, F32_TOL)
    _close(got, want_ref, F32_TOL)


def _decode_inputs(case):
    B, K, G, S, hd, win, pre, bk, pos = case
    q, kc, vc = _arrays(31, (B, K, G, hd), (B, K, S, hd), (B, K, S, hd))
    if pos is None:
        pos = np.random.default_rng(32).integers(max(win, 1), S, B)
    return q, kc, vc, np.asarray(pos, np.int32)



@pytest.mark.parametrize("case", DECODE_CASES)
def test_lse_partials_ref_matches_jax(case):
    """Chunks of 32 rows that begin at 0, at a row's pos (cut there), past
    it (wholly masked for that row) and, with a window, wholly before the
    window and past the prefix."""
    B, K, G, S, hd, win, pre, bk, _ = case
    q, kc, vc, pos = _decode_inputs(case)
    C = 32
    p0 = int(pos[0])
    offsets = {0, min(p0, S - C), min(p0 + 1, S - C)}
    masked = None
    if win > 0:
        b = int(np.argmax(pos))
        assert pre + C - 1 <= int(pos[b]) - win
        masked = (pre, b)
        offsets.add(pre)
    for off in sorted(offsets):
        want = jax_ops._lse_partials(
            _jax(q, jnp.float32), _jax(kc[:, :, off:off + C], jnp.float32),
            _jax(vc[:, :, off:off + C], jnp.float32), jnp.asarray(pos), off,
            window=win, prefix=pre)
        got = lse_partials_ref(
            _torch(q, torch.float32),
            _torch(kc[:, :, off:off + C], torch.float32),
            _torch(vc[:, :, off:off + C], torch.float32),
            torch.from_numpy(pos), off, window=win, prefix=pre)
        for g_, w_ in zip(got, want):
            _close(g_, w_, SPLIT_TOL)
        if masked is not None and off == masked[0]:
            assert bool((got[0][masked[1]] == -1e30).all())
    if p0 + 1 <= S - C:           # the chunk past pos[0] holds nothing
        m, _, _ = lse_partials_ref(
            _torch(q, torch.float32),
            _torch(kc[:, :, p0 + 1:p0 + 1 + C], torch.float32),
            _torch(vc[:, :, p0 + 1:p0 + 1 + C], torch.float32),
            torch.from_numpy(pos), p0 + 1, window=win, prefix=pre)
        assert bool((m[0] == -1e30).all())


@pytest.mark.parametrize("case", DECODE_CASES)
def test_split_decode_composition_matches_jax(case):
    """The kernel's split-and-merge at the wrapper's chunking for this
    shape on an H100's 132 SMs and at the smallest chunk, against the
    JAX reference and its Pallas kernel in interpret mode (f32)."""
    B, K, G, S, hd, win, pre, bk, _ = case
    q, kc, vc, pos = _decode_inputs(case)
    args = [_jax(q, jnp.float32), _jax(kc, jnp.float32),
            _jax(vc, jnp.float32), jnp.asarray(pos)]
    want_kernel = jax_decode(*args, window=win, prefix=pre, block_k=bk,
                             interpret=True)
    want_ref = jax_ref.decode_attention_ref(*args, window=win, prefix=pre)
    _, chunk, _ = ops.decode_attention_splits(B, K, S, 132, hd)
    for c in sorted({chunk, ops.DECODE_MIN_CHUNK}):
        got = split_decode_ref(
            _torch(q, torch.float32), _torch(kc, torch.float32),
            _torch(vc, torch.float32), torch.from_numpy(pos), chunk=c,
            window=win, prefix=pre)
        _close(got, want_kernel, SPLIT_TOL)
        _close(got, want_ref, SPLIT_TOL)


def test_decode_attention_splits():
    """The tensor-core route (bf16): chunks of whole 64-row tiles, one
    cluster a (row, kv head) of at most DECODE_MAX_CLUSTER (within the
    kernel's 16), the grid of one wave at 132 SMs, gemma3-1b's thin grid
    (one kv head) cut into 8 chunks, OLMo-1B's wide one not cut.  The CUDA-core route (f32): at least
    2 waves of CTAs at the OLMo-1B decode shape (B=8, K=16, S=1024),
    chunks of a multiple of 64 rows, merged through the workspace.  Both:
    one split when S fits one chunk, the chunks cover S, none is empty,
    and the rule reads nothing but shapes."""
    tc, cc = "tensor_core", "cuda_core"
    assert ops.decode_attention_splits(8, 16, 1024, 132, 128) \
        == (1, 1024, 1)                                    # OLMo-1B
    assert ops.decode_attention_splits(8, 1, 1024, 132, 256) == (8, 128, 8)
    assert ops.decode_attention_splits(8, 4, 1024, 132, 256) \
        == (2, 512, 2)                                     # gemma3-4b
    n, c, cl = ops.decode_attention_splits(8, 16, 1024, 132, 128, cc)
    assert 8 * 16 * n >= 2 * 132 and cl == 1
    for route in (tc, cc):
        assert ops.decode_attention_splits(8, 16, 64, 132, 128, route) \
            == (1, 64, 1)
        assert ops.decode_attention_splits(1, 1, 40, 132, 16, route) \
            == (1, 64, 1)
    for b, k, s, n_sm, hd in [(b, k, s, n_sm, hd) for b in (1, 3, 8, 64)
                              for k in (1, 2, 16) for s in range(1, 3000, 37)
                              for n_sm in (1, 132) for hd in ops.HEAD_DIMS]:
        for route in (tc, cc):
            args = (b, k, s, n_sm, hd, route)
            n, c, cl = ops.decode_attention_splits(*args)
            assert 1 <= n <= ops.DECODE_MAX_SPLITS
            assert (n - 1) * c < s <= n * c, (args, n, c)
            if route == cc:
                assert c % ops.DECODE_MIN_CHUNK == 0 and cl == 1
                continue
            assert c % ops.DECODE_TILE_ROWS == 0
            assert cl == n <= ops.DECODE_MAX_CLUSTER <= 16
            wave = max(1, n_sm // 8) * 8 * ops.DECODE_TC_CTAS_PER_SM[hd]
            assert b * k * n <= max(wave, b * k), (args, n)


# ------------------- int8 matmul ----------------------------------- #
INT8_CASES = [
    # M, K, N, dtype (tests/test_kernels.py)
    (128, 256, 128, "f32"),
    (256, 512, 256, "bf16"),
    (128, 128, 384, "f32"),
]
_INT8_TOL = {"f32": 1e-4, "bf16": 5e-2}


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_ref_matches_jax(case):
    M, K, N, dt = case
    jdt, tdt, _ = _DT[dt]
    x, w = _arrays(41, (M, K), (K, N))
    qd = jax_quantize(jnp.asarray(w * 0.1), 8)
    jx = _jax(x, jdt)
    want_kernel = jax_int8(jx, qd["__q__"], qd["scale"], interpret=True)
    want_ref = jax_ref.int8_matmul_ref(jx, qd["__q__"], qd["scale"])
    got = int8_matmul_ref(_torch(x, tdt), torch.from_numpy(
        np.array(qd["__q__"])), torch.from_numpy(np.array(qd["scale"])))
    assert got.dtype == tdt
    _close(_f32(got), want_kernel.astype(jnp.float32), _INT8_TOL[dt])
    _close(_f32(got), want_ref.astype(jnp.float32), _INT8_TOL[dt])


# ------------------- device routing -------------------------------- #
def test_cpu_tensors_route_to_plain_versions():
    """CPU tensors take the plain versions, bit for bit, and launch no
    kernel."""
    ops.reset_launches()
    B, K, G, n_pages, pps, ps, hd, _ = PAGED_CASES[1]
    q, kp, vp, table, pos = _paged_case(4, B, K, G, n_pages, pps, ps, hd)
    targs = (_torch(q, torch.float32), _torch(kp, torch.float32),
             _torch(vp, torch.float32), torch.from_numpy(table),
             torch.from_numpy(pos))
    assert torch.equal(ops.paged_decode_attention(*targs),
                       paged_decode_attention_ref(*targs))
    fq, fk, fv = (_torch(a, torch.float32) for a in
                  _arrays(6, (1, 4, 40, 32), (1, 2, 40, 32), (1, 2, 40, 32)))
    assert torch.equal(ops.flash_attention(fq, fk, fv),
                       flash_attention_ref(fq, fk, fv))
    q, kc = (_torch(a, torch.float32) for a in
             _arrays(7, (2, 2, 3, 16), (2, 40, 2, 16)))
    pos = torch.tensor([3, 39], dtype=torch.int32)
    view = kc.permute(0, 2, 1, 3)        # the engine's (B, S, K, hd) cache
    assert torch.equal(ops.decode_attention(q, view, view, pos),
                       decode_attention_ref(q, view, view, pos))
    x, w = (_torch(a, torch.float32) for a in _arrays(8, (5, 37), (61, 37)))
    wq = torch.randint(-127, 128, (61, 37), dtype=torch.int8)
    sc = torch.rand(37, 1) + 0.5
    assert torch.equal(ops.int8_matmul(x, wq.t(), sc),
                       int8_matmul_ref(x, wq.t(), sc))
    assert all(fn.launches == 0 for fn in ops.WRAPPERS)


# ------------------- routes of the two-kernel wrappers ------------- #
def test_int8_route_selection():
    """Each branch of the pure route function, on CPU tensors (the
    function reads dtype, shape, strides, scale shape and pointers)."""
    bf16, f32 = torch.bfloat16, torch.float32
    w = torch.zeros(64, 128, dtype=torch.int8)
    per_n = torch.ones(1, 128)
    x = torch.zeros(17, 64, dtype=bf16)
    route = ops.int8_matmul_route
    assert route(x[:16], w, per_n) == "skinny_tc"
    assert route(x[:1], w, per_n) == "skinny_tc"
    assert route(x, w, per_n) == "tensor_core"
    assert route(torch.zeros(4096, 64, dtype=bf16), w, per_n) \
        == "tensor_core"
    assert route(x.float(), w, per_n) == "cuda_core_tile"      # f32 x
    head = torch.zeros(128, 64, dtype=torch.int8).t()           # NK view
    assert route(x, head, torch.ones(64, 1)) == "cuda_core_tile"
    assert route(x, w, torch.ones(64, 1)) == "cuda_core_tile"   # per-K scale
    x100 = torch.zeros(17, 100, dtype=bf16)                     # K % 8
    assert route(x100, torch.zeros(100, 128, dtype=torch.int8), per_n) \
        == "cuda_core_tile"
    narrow = torch.zeros(64, 136, dtype=torch.int8)[:, :120]    # row % 16
    assert route(x, narrow, torch.ones(1, 120)) == "cuda_core_tile"
    shifted = torch.zeros(17 * 64 + 1, dtype=bf16)[1:].view(17, 64)
    assert shifted.data_ptr() % 16                               # x pointer
    assert route(shifted, w, per_n) == "cuda_core_tile"
    w_off = torch.zeros(64 * 128 + 8, dtype=torch.int8)[8:].view(64, 128)
    assert route(x, w_off, per_n) == "cuda_core_tile"           # w pointer
    assert route(torch.zeros(17, 64, dtype=f32), w, per_n) == "cuda_core_tile"
    padded = torch.zeros(64, 144, dtype=torch.int8)[:, :77]     # N % 8: no
    assert route(x, padded, torch.ones(1, 77)) == "cuda_core_tile"  # TMA store


def test_int8_skinny_route_selection():
    """M <= 16: bf16 x takes the tensor cores on KN and NK operands,
    either scale, rows of any stride and alignment; f32 x stays on
    "skinny"."""
    bf16, f32 = torch.bfloat16, torch.float32
    route = ops.int8_matmul_route
    x = torch.zeros(8, 64, dtype=bf16)
    kn = torch.zeros(64, 128, dtype=torch.int8)
    nk = torch.zeros(128, 64, dtype=torch.int8).t()    # embed_q.t()
    per_n, per_k = torch.ones(1, 128), torch.ones(64, 1)
    assert route(x, kn, per_n) == "skinny_tc"
    assert route(x, kn, per_k) == "skinny_tc"
    assert route(x, nk, per_k) == "skinny_tc"           # the tied head
    assert route(x[:1], nk, per_k) == "skinny_tc"
    assert route(torch.zeros(16, 64, dtype=bf16), kn, per_n) == "skinny_tc"
    assert route(x.float(), kn, per_n) == "skinny"      # f32 x
    assert route(x.float(), nk, per_k) == "skinny"
    x100 = torch.zeros(8, 100, dtype=bf16)              # K % 8
    assert route(x100, torch.zeros(100, 128, dtype=torch.int8), per_n) \
        == "skinny_tc"
    assert route(x100.float(), torch.zeros(100, 128, dtype=torch.int8),
                 per_n) == "skinny"
    narrow = torch.zeros(64, 136, dtype=torch.int8)[:, :120]   # row % 16
    assert route(x, narrow, torch.ones(1, 120)) == "skinny_tc"
    assert route(x.float(), narrow, torch.ones(1, 120)) == "skinny"
    nk_odd = torch.zeros(128, 72, dtype=torch.int8)[:, :64].t()
    assert route(x, nk_odd, per_k) == "skinny_tc"       # NK row % 16
    shifted = torch.zeros(8 * 64 + 1, dtype=bf16)[1:].view(8, 64)
    assert route(shifted, kn, per_n) == "skinny_tc"     # x pointer
    w_off = torch.zeros(64 * 128 + 8, dtype=torch.int8)[8:].view(64, 128)
    assert route(x, w_off, per_n) == "skinny_tc"        # w pointer
    padded = torch.zeros(64, 144, dtype=torch.int8)[:, :77]    # ragged N
    assert route(x, padded, torch.ones(1, 77)) == "skinny_tc"
    shifted_k = torch.ones(64 + 1)[1:].view(64, 1)      # per-K scale off
    assert shifted_k.data_ptr() % 16                    # a 16-byte line
    assert route(x, nk, shifted_k) == "skinny_tc"
    assert route(x, kn, shifted_k) == "skinny_tc"
    shifted_n = torch.ones(128 + 1)[1:].view(1, 128)    # per-N: read 1
    assert route(x, kn, shifted_n) == "skinny_tc"
    # the untied heads' rows: 32001 (hymba) and 256206 (seamless) bytes
    for v in (32001, 256206):
        head = torch.empty(0, dtype=torch.int8).new_empty(
            (64, v)).as_strided((64, v), (v, 1))
        assert route(x, head, torch.ones(1, v)) == "skinny_tc"
        assert route(x.float(), head, torch.ones(1, v)) == "skinny"
    assert route(torch.zeros(8, 64, dtype=f32), kn, per_n) == "skinny"


def test_int8_skinny_tc_splits():
    """The cluster rule at 132 SMs: a K split only where the column tiles
    leave SMs idle, every split a thread block cluster of at most 8 CTAs,
    the tiles times the cluster within one wave of 128 CTAs, the longest
    splits that reach it, no split empty; with no split, at most two CTAs
    an SM walk the tiles.  At OLMo-1B's decode shapes (M = 8) that is
    2048 -> 2048: 8 x 16 tiles; 2048 -> 8192: 2 x 64; 8192 -> 2048: 8 x
    16; the tied head (NK): no split, 264 CTAs over 786 tiles."""
    want = {(2048, 2048, True): (8, 4, 16), (2048, 8192, True): (2, 16, 64),
            (8192, 2048, True): (8, 16, 16),
            (2048, 50304, False): (1, 16, 264),
            (1024, 256206, True): (1, 16, 264),    # seamless' untied head
            (1600, 32001, True): (1, 25, 251)}     # hymba's
    for (k, n, kn), split in want.items():
        assert ops.int8_skinny_tc_splits(k, n, kn, 132) == split, (k, n, kn)
    for k in range(8, 9000, 136):
        for n in (1, 77, 2048, 8192, 50304):
            for kn in (True, False):
                cluster, per, ctas = ops.int8_skinny_tc_splits(k, n, kn, 132)
                cols, stage_k = ops.SKINNY_TC_TILE[kn]
                tiles, stages = -(-n // cols), -(-k // stage_k)
                assert 1 <= cluster <= ops.SKINNY_TC_MAX_CLUSTER and per >= 1
                assert (cluster - 1) * per < stages <= cluster * per
                if cluster > 1:
                    assert ctas == tiles and tiles * cluster <= 128
                    # a cluster one larger would overflow the wave or K
                    longer = -(-stages // (per - 1)) if per > 1 else None
                    assert longer is None or tiles * longer > 128 \
                        or longer > ops.SKINNY_TC_MAX_CLUSTER
                else:
                    assert ctas == min(tiles, 2 * 132)
                    assert tiles * 2 > 128 or stages == 1


def test_int8_tensor_core_tile_m():
    """The tensor-core route's tile height: the fewest rounds of the
    persistent grid times a tile's time (its rows plus the widening's
    fixed share).  At 132 SMs: OLMo-1B's prefill (4096 rows) and
    seamless's frames take 256 rows; granite's 1536 -> 1536 (192 tiles of
    256 would take two rounds for 1.45 rounds of work), hymba's 816 and
    xlstm's 853 rows take 192; granite's 1536 -> 512 and short admissions
    take 128."""
    tile = ops.int8_tensor_core_tile_m
    want = {(4096, 2048): 256, (4096, 8192): 256, (4096, 1536): 192,
            (4096, 512): 128, (816, 3200): 192, (853, 3072): 192,
            (17, 2048): 128}
    for (m, n), bm in want.items():
        assert tile(m, n, 132) == bm, (m, n)

    def cost(m, n, bm):
        tiles = -(-m // bm) * -(-n // ops.TC_TILE_N)
        return -(-tiles // 132) * (bm + ops.TC_WIDEN)
    for m in range(17, 9000, 211):
        for n in (8, 512, 1536, 3200, 8192):
            bm = tile(m, n, 132)
            assert bm in ops.TC_TILE_M
            assert all(cost(m, n, bm) <= cost(m, n, o)
                       for o in ops.TC_TILE_M)


def test_flash_route_selection():
    assert ops.flash_attention_route(torch.bfloat16) == "tensor_core"
    assert ops.flash_attention_route(torch.float32) == "cuda_core"


def test_decode_route_selection():
    """Both split decode kernels: bf16 on the tensor cores, f32 on the
    CUDA cores (TF32 would change the numerics); each route's split."""
    assert ops.decode_attention_route(torch.bfloat16) == "tensor_core"
    assert ops.decode_attention_route(torch.float32) == "cuda_core"
    assert set(ops.DECODE_ROUTES) == {"tensor_core", "cuda_core"}
    for fn in (ops.decode_attention, ops.paged_decode_attention):
        assert set(fn.launches_by_route) == set(ops.DECODE_ROUTES)
    assert ops.decode_attention_splits(8, 16, 1024, 132, 128,
                                       "cuda_core") == (4, 256, 1)
    assert ops.decode_attention_splits(8, 1, 1024, 132, 256,
                                       "tensor_core")[2] == 8


def test_reset_launches_zeroes_the_route_counters():
    ops.int8_matmul.launches_by_route["tensor_core"] = 3
    ops.flash_attention.launches_by_route["cuda_core"] = 2
    ops.decode_attention.launches_by_route["tensor_core"] = 4
    ops.paged_decode_attention.launches_by_route["cuda_core"] = 5
    ops.reset_launches()
    assert set(ops.int8_matmul.launches_by_route) == set(ops.INT8_ROUTES)
    assert set(ops.flash_attention.launches_by_route) \
        == set(ops.FLASH_ROUTES)
    for fn in (ops.int8_matmul, ops.flash_attention, ops.decode_attention,
               ops.paged_decode_attention):
        assert not any(fn.launches_by_route.values())


# ------------------- the tensor-core kernels' numerics ------------- #
def _int8_tc_emulation(x, w_q, scale):
    """The int8 tensor-core route's arithmetic: bf16 x times the int8
    weight widened to bf16 (exact), f32 sums, the per-N scale applied
    once to the sum, one rounding to bf16."""
    w16 = w_q.to(torch.bfloat16)
    assert torch.equal(w16.float(), w_q.float())     # widening is exact
    return ((x.float() @ w16.float()) * scale).to(torch.bfloat16)


def _skinny_tc_emulation(x, w_q, scale):
    """The skinny_tc route's arithmetic: the int8 weight widened to bf16
    (exact), f32 sums; a per-N scale applied once to the sum; a per-K
    scale (the tied head's) folded into x in f32 and split into two bf16
    terms, hi = bf16(x s) and lo = bf16(x s - hi), each multiplied by the
    weight; one rounding of the output to bf16."""
    if scale.shape[0] == 1:
        return _int8_tc_emulation(x, w_q, scale)
    xs = x.float() * scale.t()
    hi = xs.to(torch.bfloat16).float()
    lo = (xs - hi).to(torch.bfloat16).float()
    w = w_q.float()
    return (hi @ w + lo @ w).to(torch.bfloat16)


SKINNY_TC_CASES = [
    # M, K, N, layout: the OLMo-1B decode projections (M = n_slots = 8),
    # the tied head, ragged M, K, N
    (8, 2048, 2048, "kn"), (8, 2048, 8192, "kn"), (8, 8192, 2048, "kn"),
    (8, 2048, 50304, "head"), (13, 136, 208, "kn"), (5, 272, 61, "head"),
]


@pytest.mark.parametrize("case", SKINNY_TC_CASES)
def test_skinny_tc_numerics_match_jax(case):
    """bf16 tolerance 5e-2 (as the int8 references above): besides the
    order of the f32 sums, the head's x * s is carried as two bf16 terms
    (~2^-17 of it lost).  The head
    case quantizes the embedding per d, as the model does, and hands JAX
    the (d, V) view's weight and its (d, 1) scale."""
    M, K, N, layout = case
    rng = np.random.default_rng(43)
    x = rng.standard_normal((M, K)).astype(np.float32)
    wq = rng.integers(-127, 128, (K, N) if layout == "kn" else (N, K),
                      dtype=np.int8)
    if layout == "kn":
        sc = (rng.random((1, N)) * 0.002 + 0.0005).astype(np.float32)
        wq_t = torch.from_numpy(wq)
    else:
        sc = (rng.random((K, 1)) * 0.002 + 0.0005).astype(np.float32)
        wq_t = torch.from_numpy(wq).t()
        wq = np.ascontiguousarray(wq.T)
    jx = _jax(x, jnp.bfloat16)
    want = jax_ref.int8_matmul_ref(jx, jnp.asarray(wq), jnp.asarray(sc))
    got = _skinny_tc_emulation(_torch(x, torch.bfloat16), wq_t,
                               torch.from_numpy(sc))
    _close(_f32(got), want.astype(jnp.float32), _INT8_TOL["bf16"])


INT8_TC_CASES = [
    # M, K, N: INT8_CASES in bf16, the smallest tile M, ragged aligned
    (128, 256, 128), (256, 512, 256), (128, 128, 384), (17, 512, 256),
    (130, 264, 272),
]


@pytest.mark.parametrize("case", INT8_TC_CASES)
def test_int8_tensor_core_numerics_match_jax(case):
    """bf16 tolerance 2e-2 (as tests/test_kernels.py): the emulation and
    the JAX reference differ in where the scale meets the sum (after it
    here, on the weight there) and in the order of the f32 sums."""
    M, K, N = case
    x, w = _arrays(42, (M, K), (K, N))
    qd = jax_quantize(jnp.asarray(w * 0.1), 8)
    jx = _jax(x, jnp.bfloat16)
    want = jax_ref.int8_matmul_ref(jx, qd["__q__"], qd["scale"])
    got = _int8_tc_emulation(_torch(x, torch.bfloat16),
                             torch.from_numpy(np.array(qd["__q__"])),
                             torch.from_numpy(np.array(qd["scale"])))
    _close(_f32(got), want.astype(jnp.float32), BF16_TOL)


def _flash_tc_emulation(q, k, v, *, causal, window, prefix, bq=64, bk=64):
    """The flash tensor-core route's arithmetic in plain torch: bf16 q, k,
    v; scores in f32, in log2 units; masked scores -1e30; the online
    softmax over 64-row kv tiles in the kernel's order, with its tile
    skip (tiles of 32 rows at hd 256); P rounded to bf16 before P.V (f32
    sums, l from the unrounded P); one division by l at the end."""
    b, h, sq, hd = q.shape
    nkv, skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // nkv, 1)
    vf = v.float().repeat_interleave(h // nkv, 1)
    qf = q.float()
    sc = hd ** -0.5 * 1.4426950408889634
    out = torch.zeros(b, h, sq, hd)
    for q0 in range(0, sq, bq):
        qp = torch.arange(q0, min(q0 + bq, sq))
        m = torch.full((b, h, len(qp)), -1e30)
        lsum = torch.zeros(b, h, len(qp))
        o = torch.zeros(b, h, len(qp), hd)
        kv_end = min(skv, q0 + bq) if causal else skv
        for k0 in range(0, kv_end, bk):
            if causal and window > 0:
                reach = k0 + bk - 1 > q0 - window
                if not reach and not (prefix > 0 and k0 < prefix):
                    continue
            kp = torch.arange(k0, min(k0 + bk, skv))
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, qp],
                             kf[:, :, kp]) * sc
            if causal:
                ok = kp[None, :] <= qp[:, None]
                if window > 0:
                    ok = ok & ((kp[None, :] > qp[:, None] - window)
                               | ((kp < prefix)[None, :] if prefix > 0
                                  else False))
                s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            lsum = lsum * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                vf[:, :, kp])
            m = m_new
        out[:, :, qp] = o / lsum.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


FLASH_TC_CASES = [
    # B, H, K, Sq, Skv, hd, window, prefix: tests/test_kernels.py's
    # FLASH_CASES in bf16, and the ragged and window-edge tiles
    (2, 4, 2, 128, 128, 64, 0, 0),
    (1, 8, 4, 256, 256, 128, 0, 0),
    (2, 4, 1, 128, 256, 64, 64, 0),
    (1, 4, 2, 128, 128, 64, 48, 16),
    (1, 2, 2, 64, 64, 32, 0, 0),
    (1, 6, 2, 192, 192, 64, 0, 0),
    (2, 4, 4, 100, 100, 16, 0, 0),
    (1, 4, 2, 300, 300, 32, 40, 8),
    (1, 4, 1, 256, 256, 256, 48, 16),    # hd 256: kv tiles of 32 rows
    (2, 4, 2, 100, 100, 256, 0, 0),
]


@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_tensor_core_numerics_match_jax(case):
    """bf16 tolerance 2e-2 (as tests/test_kernels.py): besides the order
    of the sums, the emulation rounds P to bf16 before P.V, a relative
    error of at most 2^-9 per weight, far inside it."""
    B, H, K, Sq, Skv, hd, win, pre = case
    q, k, v = _arrays(23, (B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd))
    jq, jk, jv = (_jax(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=True, window=win,
                                       prefix=pre)
    got = _flash_tc_emulation(*(_torch(a, torch.bfloat16) for a in (q, k, v)),
                              causal=True, window=win, prefix=pre,
                              bk=32 if hd >= 256 else 64)
    _close(_f32(got), want.astype(jnp.float32), BF16_TOL)


def _decode_tc_emulation(q, k, v, pos, *, chunk, ncw, window=0, prefix=0,
                         visible=None):
    """The split decode kernels' tensor-core arithmetic in plain torch:
    bf16 q, k, v over a (B, K, S, hd) cache; chunks of `chunk` rows, each
    cut into 64-row tiles dealt to `ncw` warps in turn, each warp with its
    own online softmax in log2 units (one step a tile; masked scores weigh
    0), P rounded to bf16 before P.V (f32 sums, l from the unrounded P);
    the warps merged in warp order, then the chunks in chunk order (exp2
    of the m differences), one division at the end.  `visible` (B, S)
    masks rows besides pos, window and prefix (sentinel pages)."""
    b, nkv, g, hd = q.shape
    s_len = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    sc = hd ** -0.5 * 1.4426950408889634
    kp = torch.arange(s_len)
    ok = kp[None, :] <= pos.long()[:, None]
    if window > 0:
        ok = ok & ((kp[None, :] > pos.long()[:, None] - window)
                   | (kp < prefix)[None, :])
    if visible is not None:
        ok = ok & visible
    parts = []
    for c0 in range(0, s_len, chunk):
        warps = [(torch.full((b, nkv, g), -1e30), torch.zeros(b, nkv, g),
                  torch.zeros(b, nkv, g, hd)) for _ in range(ncw)]
        for i, t0 in enumerate(range(c0, min(c0 + chunk, s_len), 64)):
            rows = torch.arange(t0, min(t0 + 64, c0 + chunk, s_len))
            m, lsum, o = warps[i % ncw]
            sc_t = torch.einsum("bkgd,bksd->bkgs", qf, kf[:, :, rows]) * sc
            vis = ok[:, rows][:, None, None, :]
            sc_t = torch.where(vis, sc_t, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc_t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.where(vis, torch.exp2(sc_t - m_new[..., None]),
                            torch.tensor(0.0))
            lsum = lsum * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgs,bksd->bkgd", p.to(torch.bfloat16).float(),
                vf[:, :, rows])
            warps[i % ncw] = (m_new, lsum, o)
        parts.append(warps)
    flat = [w for ws in parts for w in ws]   # chunk order, warp order
    m_g = torch.stack([m for m, _, _ in flat]).amax(0)
    l_g = torch.zeros_like(m_g)
    o_g = torch.zeros(b, nkv, g, hd)
    for ws in parts:   # the CTA's warps first, then the chunks
        m_c = torch.stack([m for m, _, _ in ws]).amax(0)
        l_c = sum(l_ * torch.exp2(m - m_c) for m, l_, _ in ws)
        o_c = sum(o * torch.exp2(m - m_c)[..., None] for m, _, o in ws)
        w = torch.exp2(m_c - m_g)
        l_g = l_g + l_c * w
        o_g = o_g + o_c * w[..., None]
    return (o_g / l_g.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_tensor_core_numerics_match_jax(case):
    """bf16 tolerance 2e-2 (as tests/test_kernels.py) at the wrapper's
    split on 132 SMs and at one chunk: besides the order of the sums, the
    emulation rounds P to bf16 before P.V, a relative error of at most
    2^-9 a weight."""
    B, K, G, S, hd, win, pre, _, _ = case
    q, kc, vc, pos = _decode_inputs(case)
    jargs = [_jax(a, jnp.bfloat16) for a in (q, kc, vc)] + [jnp.asarray(pos)]
    want = jax_ref.decode_attention_ref(*jargs, window=win, prefix=pre)
    _, chunk, _ = ops.decode_attention_splits(B, K, S, 132, hd)
    ncw = 3 if hd >= 64 else 4
    for c in sorted({chunk, -(-S // 64) * 64}):
        got = _decode_tc_emulation(
            *(_torch(a, torch.bfloat16) for a in (q, kc, vc)),
            torch.from_numpy(pos), chunk=c, ncw=ncw, window=win, prefix=pre)
        _close(_f32(got), want.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_tensor_core_numerics_match_jax(case):
    """The paged kernel's tensor-core arithmetic: the emulation over the
    table's logical view with sentinel pages' rows masked, at the
    wrapper's split on 132 SMs, against the JAX reference in bf16."""
    B, K, G, n_pages, pps, ps, hd, win = case
    q, kp, vp, table, pos = _paged_case(4, B, K, G, n_pages, pps, ps, hd)
    table[1, 1] = n_pages             # a hole: a sentinel mid-table
    jargs = [_jax(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = jax_pa.paged_decode_attention_ref(
        *jargs, jnp.asarray(table), jnp.asarray(pos), window=win)
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, kp, vp))
    ttab = torch.from_numpy(table).long()
    mapped = ttab < n_pages
    safe = torch.where(mapped, ttab, torch.zeros_like(ttab))
    # the logical (B, K, pps * ps, hd) view the table maps
    kl, vl = (t[safe].permute(0, 3, 1, 2, 4).reshape(B, K, pps * ps, hd)
              for t in (tk, tv))
    visible = mapped.repeat_interleave(ps, 1)
    _, ppc, _ = ops.paged_decode_attention_splits(B, K, pps, ps, 132, hd)
    got = _decode_tc_emulation(tq, kl, vl, torch.from_numpy(pos),
                               chunk=ppc * ps, ncw=3 if hd >= 64 else 4,
                               window=win, visible=visible)
    _close(_f32(got), want.astype(jnp.float32), BF16_TOL)


def test_flash_cpu_takes_model_layout_views():
    """The (B, H, S, hd) views of (B, S, H, hd) tensors, as prefill now
    passes them, give what contiguous copies give."""
    q, k, v = (_torch(a, torch.float32) for a in
               _arrays(24, (2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = ops.flash_attention(*views, window=16, prefix=4)
    want = flash_attention_ref(*(t.contiguous() for t in views), window=16,
                               prefix=4)
    _close(got, want, F32_TOL)
