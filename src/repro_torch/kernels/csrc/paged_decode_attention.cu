// Paged decode attention for Hopper (sm_90a), CUDA C++, f32 accumulation,
// each slot's pages split across CTAs (flash-decoding over chunks of
// pages).
//
// Replaces: src/repro/kernels/paged_attention.py, _paged_decode_kernel
// (launched by paged_decode_attention through pl.pallas_call).  One new
// query token per slot attends to its KV pages through the slot's row of
// the page table; sentinel entries (== P) and pages past `pos` are
// skipped, the mask is kv_pos <= pos with an optional static window and an
// always-visible prefix.
//
// What bounds it: bytes.  Each (slot, kv head) reads (pos+1) * hd keys and
// as many values once and does ~4*G flops per element read, far below the
// card's ~295 flops per byte, so the least time is
// 2 * sum_b (pos_b + 1) * K * hd * sizeof(T) over 3.35 TB/s.
//
// The TPU grid walks the page axis sequentially ("arbitrary") with (m, l,
// acc) in VMEM scratch.  Here the table's columns are cut into chunks of
// `ppc` pages and the grid is one CTA per chunk of each (slot, kv head);
// the wrapper picks the split from B, K, the table's width, the page size
// and the SM count alone (ops.paged_decode_attention_splits), never from
// pos or the table, so nothing is read back to the host.  Chunk 0 always
// runs; a later chunk runs only if its first row c * ppc * ps is at or
// before pos and it reaches the window or the prefix (common.cuh
// running_chunks), the same mask in every CTA.  A running chunk whose
// pages are all sentinels (or all outside the window) has the empty
// partial m = -1e30, l = 0: in the merge its weight is exp(-1e30 - max) =
// 0 exactly beside any chunk with a visible row, so it changes no bit.
//
// Two routes, picked by dtype (ops.decode_attention_route):
//
// bf16, "tensor_core": decode_common.cuh's body, shared with the
// contiguous kernel (PagedRows here): a chunk's rows in tiles of 64 (a
// tile spans several pages where ps < 64; its page ids are read one tile
// ahead of the copies), K/V through an async-copy ring fed by a producer
// warp (one bulk copy a row: a page row of one kv head is K * hd elements
// from the next), the query group on the tensor cores, one softmax step a
// tile, and the chunks of a slot merged in a thread block cluster
// (`cluster` = n_split) or, with cluster 1, through the global workspace
// below.  G above 16 runs in launches of 16 query rows.
//
// f32, "cuda_core": on the CUDA cores in f32.  The CTA reads the chunk's
// page ids once, up front, in one coalesced load (lane i of warp w holds
// column w + 4i), issued beside the load of pos, and hands them out with
// shuffles, so no K/V load waits behind a dependent table load page after
// page.  The 4 warps take the chunk's pages round-robin; a group of
// min(hd / VEC, 32) lanes owns a token row (two vectors a lane at hd 256),
// 16-byte loads along hd, its own online-softmax state in registers
// (common.cuh fold_block / online_row), and a page's rows are loaded
// packed before any is used, 8 rows a group when G <= 2.  Rows past pos
// are not read.  The chunks meet as in JAX's sequence-sharded combine
// (ops.py, _lse_partials and decode_attention_sharded), the same code as
// the contiguous decode kernel (common.cuh finish_split): each CTA stores
// its f32 partial in a workspace the wrapper allocates; the last CTA of a
// (slot, kv head) to finish, found through a counter the kernel leaves at
// 0, merges them in chunk order, so two launches give bit-identical
// results.  A slot that one chunk serves is written directly.  G above 8
// runs in chunks of 8 query rows, one launch each on the same workspace
// and counters.

#include "decode_common.cuh"

namespace {


constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 8;    // query rows per launch
constexpr int kMaxSplits = 32;  // bits of the running-chunk mask

// (kThreads, 1): without a floor of blocks ptxas capped some G = 2..4
// variants at 96 or 128 registers and spilled; the served G = 1
// variants keep their registers and 4 CTAs an SM either way.
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ pos_arr, T* __restrict__ out,
    float* __restrict__ ws, unsigned* __restrict__ tickets, int n_kv, int G,
    int n_pages, int ps, int pps, int window, int prefix, float sm_scale,
    int g0, int ppc) {
  using RL = repro::RowLayout<T, HD>;
  constexpr int EPL = RL::EPL;        // elements a lane (one or two vectors)
  constexpr int LPR = RL::LPR;        // lanes per token row
  constexpr int RPW = RL::RPW;        // rows per warp pass
  constexpr int NPART = kWarps * RPW; // partial states per CTA
  // rows a group loads before using any: as many 16-byte loads in flight
  // whether a row is one vector a lane or two
  constexpr int UNROLL_V = GC >= 8 ? 2 : GC >= 4 ? 4 : 8;
  constexpr int UNROLL = UNROLL_V / RL::NV > 0 ? UNROLL_V / RL::NV : 1;
  constexpr int BLK = RPW * UNROLL;   // rows per block, one warp each
  constexpr int kCols = kWarps * 32;  // table columns per coalesced load

  const int bk = blockIdx.x;
  const int b = bk / n_kv;
  const int kh = bk % n_kv;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;
  const int d0 = (lane % LPR) * EPL;
  const int ng = min(GC, G - g0);
  const int j0 = split * ppc;                 // the chunk's first column
  const int n_cols = min(ppc, pps - j0);
  const int* cols = page_table + (size_t)b * pps + j0;

  // the chunk's page ids, read beside pos: lane i of warp w holds column
  // w + kWarps * i (of the first kCols; a longer chunk reads on below)
  int my_page = n_pages;
  if (warp + kWarps * lane < n_cols) my_page = cols[warp + kWarps * lane];
  const int pos = pos_arr[b];

  const uint32_t mask =
      repro::running_chunks(n_split, ppc * ps, pos, pos, window, prefix);
  if (!((mask >> split) & 1u)) return;

  float qv[GC][EPL];
  float m[GC], l[GC], acc[GC][EPL];
  repro::load_query<T, GC, EPL, HD>(q + ((size_t)bk * G + g0) * HD + d0, ng,
                                    sm_scale, qv, m, l, acc);

  const long long row_stride = (long long)n_kv * HD;
  const T* kb = k_pool + (size_t)kh * HD + d0;
  const T* vb = v_pool + (size_t)kh * HD + d0;
  for (int c0 = 0; c0 < n_cols; c0 += kCols) {
    if (c0 > 0) {
      const int j = c0 + warp + kWarps * lane;
      my_page = j < n_cols ? cols[j] : n_pages;
    }
    // the warp's pages of these kCols columns, in order; warp-uniform
    for (int i = 0; i < 32; ++i) {
      const int j = c0 + warp + kWarps * i;
      if (j >= n_cols) break;
      const int page = __shfl_sync(0xffffffffu, my_page, i);
      const int start = (j0 + j) * ps;
      if (start > pos) break;              // the later pages hold no row
      // the Pallas kernel's `run` predicate: a mapped page in reach
      bool run = page >= 0 && page < n_pages;
      if (window > 0) {
        bool reach = start + ps - 1 > pos - window;
        if (prefix > 0) reach = reach || start < prefix;
        run = run && reach;
      }
      if (!run) continue;
      const int rows = min(ps, pos + 1 - start);   // rows up to pos
      const long long first = (long long)page * ps * row_stride;
      for (int t0 = 0; t0 < rows; t0 += BLK) {
        repro::fold_block<GC, EPL, LPR, RPW, UNROLL>(
            kb + first + t0 * row_stride, vb + first + t0 * row_stride,
            row_stride, rows - t0, start + t0, pos, window, prefix, grp, qv,
            m, l, acc);
      }
    }
  }

  repro::finish_split<T, GC, EPL, HD, NPART, kThreads, kMaxChunk>(
      mask, bk, gridDim.x, split, n_split, warp * RPW + grp, lane % LPR == 0,
      d0, m, l, acc, out + ((size_t)bk * G + g0) * HD, ws, tickets, ng);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* kp, const void* vp,
               const int* table, const int* pos, void* out, float* ws,
               unsigned* tickets, int B, int K, int G, int P, int ps,
               int pps, int window, int prefix, float sm_scale, int n_split,
               int ppc, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  T* ot = static_cast<T*>(out);
  const dim3 grid(B * K, n_split), block(kThreads);
  for (int g0 = 0; g0 < G; g0 += kMaxChunk) {
    const int n = G - g0 < kMaxChunk ? G - g0 : kMaxChunk;
#define REPRO_LAUNCH(GC)                                                    \
  paged_decode_kernel<T, HD, GC><<<grid, block, 0, stream>>>(               \
      qt, kt, vt, table, pos, ot, ws, tickets, K, G, P, ps, pps, window,    \
      prefix, sm_scale, g0, ppc)
    if (n == 1) REPRO_LAUNCH(1);
    else if (n == 2) REPRO_LAUNCH(2);
    else if (n <= 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
}

int launch_f32(const void* q, const void* kp, const void* vp,
               const int* table, const int* pos, void* out, float* ws,
               unsigned* tickets, int B, int K, int G, int hd, int P, int ps,
               int pps, int window, int prefix, float sm_scale, int n_split,
               int ppc, cudaStream_t stream) {
  switch (hd) {
#define REPRO_HD(HD)                                                        \
  case HD:                                                                  \
    launch_hd<float, HD>(q, kp, vp, table, pos, out, ws, tickets, B, K, G,  \
                         P, ps, pps, window, prefix, sm_scale, n_split,     \
                         ppc, stream);                                      \
    break;
    REPRO_HD(16) REPRO_HD(32) REPRO_HD(64) REPRO_HD(128) REPRO_HD(256)
#undef REPRO_HD
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, K, G, hd); k_pool, v_pool (P, ps, K, hd); page_table (B, pps)
// int32 with sentinel P; pos (B,) int32; out (B, K, G, hd).  All
// contiguous, 16-byte aligned.  dtype: 0 = f32 (the cuda_core route), 1 =
// bf16 (tensor_core).  The table's columns run in n_split chunks of ppc
// pages (1 <= n_split <= 32, every chunk holding at least one of the pps
// columns).  cluster: 1, or (bf16 only) n_split, up to 16: the chunks of a
// (slot, kv head) form one thread block cluster and merge in distributed
// shared memory.  With n_split > 1 and cluster 1, ws holds B * K *
// n_split * 16 * (hd + 2) floats and tickets B * K zeroed counters (left
// zeroed).  Returns the cudaError_t of the launch (0 on success).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const int* page_table,
                           const int* pos, void* out, void* ws,
                           void* tickets, int B, int K, int G, int hd, int P,
                           int ps, int pps, int window, int prefix,
                           int dtype, int n_split, int ppc, int cluster,
                           float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || G == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplits || ppc < 1 || ps < 1 ||
      (long long)ppc * n_split < pps ||
      (long long)ppc * (n_split - 1) >= pps || cluster < 1 ||
      (cluster == 1 && n_split > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (dtype == 0) {
    if (cluster != 1) return (int)cudaErrorInvalidValue;
    return launch_f32(q, k_pool, v_pool, page_table, pos, out, w, tk, B, K,
                      G, hd, P, ps, pps, window, prefix, sm_scale, n_split,
                      ppc, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using repro::dtc::bf16;
  const repro::dtc::PagedParams src{k_pool, v_pool, page_table, P, ps, K,
                                    pps, ppc};
  const repro::dtc::Args a{static_cast<const bf16*>(q),
                           static_cast<bf16*>(out), pos, w, tk, K, G, 0,
                           window, prefix, cluster,
                           sm_scale * repro::dtc::kLog2e};
  return repro::dtc::launch(src, a, hd, n_split, B * K, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
