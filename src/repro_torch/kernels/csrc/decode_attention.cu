// Decode attention over a contiguous cache for Hopper (sm_90a), CUDA C++,
// f32 accumulation, the sequence split across CTAs (flash-decoding).
//
// Replaces: src/repro/kernels/decode_attention.py, _decode_kernel
// (launched by decode_attention through pl.pallas_call).  One new query
// token per row attends to the row's cache positions 0..pos; rows past
// `pos` (and past S) are never read, the mask is kv_pos <= pos with an
// optional static window and an always-visible prefix.
//
// What bounds it: bytes.  Each (row, kv head) reads (min(pos, S-1) + 1)
// * hd keys and as many values once and does ~4*G flops per element read,
// far below the card's ~295 flops per byte, so the least time is
// 2 * sum_b (pos_b + 1) * K * hd * sizeof(T) over 3.35 TB/s.
//
// The positions 0..min(pos, S-1) are cut into chunks of `chunk` rows, one
// CTA each; the wrapper picks the split from the shapes and the SM count
// alone (ops.decode_attention_splits), never from pos, so nothing is read
// back to the host.  A later chunk runs only if it begins at or before
// min(pos, S-1) and reaches the window or the prefix (common.cuh
// running_chunks, the Pallas kernel's block skip at chunk granularity).
// The cache is read in place through strides (row t of (b, kh) at b * sb
// + kh * sk + t * ss elements), so a (B, S, K, hd) cache is taken through
// its (B, K, S, hd) permuted view with no copy.
//
// Two routes, picked by dtype (ops.decode_attention_route):
//
// bf16, "tensor_core": decode_common.cuh's body, shared with the paged
// kernel (ContigRows here): K/V tiles of 64 rows through an async-copy
// ring fed by a producer warp, the query group on the tensor cores (keys
// on M, the group on N), one softmax step a tile, and the chunks of a
// (row, kv head) merged in a thread block cluster (`cluster` = n_split),
// or, with cluster 1, through the global workspace below.  G above 16 runs
// in launches of 16 query rows.
//
// f32, "cuda_core": on the CUDA cores in f32 (on the tensor cores it
// would be TF32).  4 warps a CTA; a group of min(hd / VEC, 32) lanes a key
// row with 16-byte loads along hd (two vectors a lane at hd 256), the
// group's own online-softmax state in registers, a log-sum-exp merge of
// the groups in shared memory; UNROLL rows per group are loaded before any
// is used, packed, so a warp keeps 16 rows of K and of V in flight
// (common.cuh fold_block, shared with the paged kernel, as are the
// running-chunk mask and the merge below).  The splits meet as in JAX's
// sequence-sharded combine (ops.py, _lse_partials and
// decode_attention_sharded): each CTA stores its f32 partial (m, l,
// acc[hd]) per query row in a workspace the wrapper allocates; the last
// CTA of a (row, kv head) to finish, found through a counter the kernel
// leaves at 0 (common.cuh last_to_arrive), merges them in split order
// (merge_splits), so two launches give bit-identical results.  A row that
// only one chunk serves is written directly by that CTA.  G above 8 runs
// in chunks of 8 query rows, one launch each on the same workspace and
// counters.
#include "decode_common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 8;    // query rows per launch
constexpr int kMaxSplits = 32;  // bits of the running-chunk mask

// (kThreads, 1): without a floor of blocks ptxas capped some G = 2..4
// variants at 96 or 128 registers and spilled; the served G = 1
// variants keep their registers and 4 CTAs an SM either way.
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 1) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos_arr,
    T* __restrict__ out, float* __restrict__ ws,
    unsigned* __restrict__ tickets, int n_kv, int G, int S, long long sb,
    long long sk, long long ss, int window, int prefix, float sm_scale,
    int g0, int chunk) {
  using RL = repro::RowLayout<T, HD>;
  constexpr int EPL = RL::EPL;        // elements a lane (one or two vectors)
  constexpr int LPR = RL::LPR;        // lanes per key row
  constexpr int RPW = RL::RPW;        // rows per warp pass
  constexpr int NPART = kWarps * RPW; // partial states per CTA
  // rows a group loads before using any: as many 16-byte loads in flight
  // whether a row is one vector a lane or two
  constexpr int UNROLL_V = GC >= 8 ? 2 : GC >= 4 ? 4 : 8;
  constexpr int UNROLL = UNROLL_V / RL::NV > 0 ? UNROLL_V / RL::NV : 1;
  constexpr int BLK = RPW * UNROLL;   // rows per block, one warp each

  const int bk = blockIdx.x;
  const int b = bk / n_kv;
  const int kh = bk % n_kv;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;
  const int d0 = (lane % LPR) * EPL;
  const int pos = pos_arr[b];
  const int last = min(pos, S - 1);   // the last row that can be visible
  const int ng = min(GC, G - g0);

  // the chunks that run; the same mask in every CTA
  const uint32_t mask =
      repro::running_chunks(n_split, chunk, last, pos, window, prefix);
  if (!((mask >> split) & 1u)) return;
  const int c_begin = split * chunk;
  const int c_end = min(c_begin + chunk, last + 1);   // exclusive

  float qv[GC][EPL];
  float m[GC], l[GC], acc[GC][EPL];
  repro::load_query<T, GC, EPL, HD>(q + ((size_t)bk * G + g0) * HD + d0, ng,
                                    sm_scale, qv, m, l, acc);

  const T* kb = k + b * sb + kh * sk + d0;
  const T* vb = v + b * sb + kh * sk + d0;
  for (int start = c_begin + warp * BLK; start < c_end;
       start += kWarps * BLK) {
    if (window > 0) {   // the Pallas kernel's block skip; warp-uniform
      bool reach = start + BLK - 1 > pos - window;
      if (prefix > 0) reach = reach || start < prefix;
      if (!reach) continue;
    }
    repro::fold_block<GC, EPL, LPR, RPW, UNROLL>(
        kb + start * ss, vb + start * ss, ss, c_end - start, start, pos,
        window, prefix, grp, qv, m, l, acc);
  }

  repro::finish_split<T, GC, EPL, HD, NPART, kThreads, kMaxChunk>(
      mask, bk, gridDim.x, split, n_split, warp * RPW + grp, lane % LPR == 0,
      d0, m, l, acc, out + ((size_t)bk * G + g0) * HD, ws, tickets, ng);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, const int* pos,
               void* out, float* ws, unsigned* tickets, int B, int K, int G,
               int S, long long sb, long long sk, long long ss, int window,
               int prefix, float sm_scale, int n_split, int chunk,
               cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const dim3 grid(B * K, n_split), block(kThreads);
  for (int g0 = 0; g0 < G; g0 += kMaxChunk) {
    const int n = G - g0 < kMaxChunk ? G - g0 : kMaxChunk;
#define REPRO_LAUNCH(GC)                                                    \
  decode_split_kernel<T, HD, GC><<<grid, block, 0, stream>>>(               \
      qt, kt, vt, pos, ot, ws, tickets, K, G, S, sb, sk, ss, window,        \
      prefix, sm_scale, g0, chunk)
    if (n == 1) REPRO_LAUNCH(1);
    else if (n == 2) REPRO_LAUNCH(2);
    else if (n <= 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
}

int launch_f32(const void* q, const void* k, const void* v, const int* pos,
               void* out, float* ws, unsigned* tickets, int B, int K, int G,
               int hd, int S, long long sb, long long sk, long long ss,
               int window, int prefix, float sm_scale, int n_split, int chunk,
               cudaStream_t stream) {
  switch (hd) {
#define REPRO_HD(HD)                                                        \
  case HD:                                                                  \
    launch_hd<float, HD>(q, k, v, pos, out, ws, tickets, B, K, G, S, sb,    \
                         sk, ss, window, prefix, sm_scale, n_split, chunk,  \
                         stream);                                           \
    break;
    REPRO_HD(16) REPRO_HD(32) REPRO_HD(64) REPRO_HD(128) REPRO_HD(256)
#undef REPRO_HD
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, K, G, hd) contiguous; k_cache, v_cache (B, K, S, hd) with element
// strides sb, sk, ss over (B, K, S) and the last dim contiguous, the same
// for both; pos (B,) int32; out (B, K, G, hd) contiguous.  Pointers and
// rows 16-byte aligned.  dtype: 0 = f32 (the cuda_core route), 1 = bf16
// (tensor_core).  The sequence runs in n_split chunks of `chunk` rows (1
// <= n_split <= 32, every chunk holding at least one of the S rows).
// cluster: 1, or (bf16 only) n_split, up to 16: the chunks of a (row, kv
// head) form one thread block cluster and merge in distributed shared
// memory.  With n_split > 1 and cluster 1, ws holds B * K * n_split * 16
// * (hd + 2) floats and tickets B * K zeroed counters (left zeroed).
// Returns the cudaError_t of the launch (0 on success).
int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                     const int* pos, void* out, void* ws, void* tickets,
                     int B, int K, int G, int hd, int S, long long sb,
                     long long sk, long long ss, int window, int prefix,
                     int dtype, int n_split, int chunk, int cluster,
                     float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || G == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplits || chunk < 1 ||
      (long long)chunk * n_split < S ||
      (long long)chunk * (n_split - 1) >= S || cluster < 1 ||
      (cluster == 1 && n_split > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if (dtype == 0) {
    if (cluster != 1) return (int)cudaErrorInvalidValue;
    return launch_f32(q, k_cache, v_cache, pos, out, w, tk, B, K, G, hd, S,
                      sb, sk, ss, window, prefix, sm_scale, n_split, chunk,
                      s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using repro::dtc::bf16;
  const repro::dtc::ContigParams src{k_cache, v_cache, B, K, S,
                                     sb, sk, ss, chunk};
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
