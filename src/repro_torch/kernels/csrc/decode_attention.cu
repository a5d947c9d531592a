// Decode attention over a contiguous cache for Hopper (sm_90a), CUDA C++,
// f32 accumulation.
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
// Design.  The same CTA as the paged kernel (paged_decode_attention.cu):
// one CTA per (row, kv head) loops over its cache, 4 warps, a group of
// hd/VEC lanes per key row with 16-byte loads along hd, the group's own
// online-softmax state in registers (common.cuh online_row), and a
// log-sum-exp merge in shared memory at the end (common.cuh merge_store).
// The two differ only in how a row's KV is addressed: here the cache is
// cut into blocks of RPW * UNROLL rows dealt round-robin to the warps, and
// row t of (b, kh) sits at b * sb + kh * sk + t * ss elements, strides
// the wrapper passes, so a (B, S, K, hd) cache is read in place through
// its (B, K, S, hd) permuted view with no copy.  The Pallas kernel's
// `S % block_k == 0` does not carry over: blocks past min(pos, S-1) are
// never visited and the ragged last block is masked row by row.  Blocks
// wholly outside the window (and the prefix) are skipped as in
// _decode_kernel.  G above 8 runs in chunks of 8 query rows, one launch
// each.
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Vec;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 8;

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos_arr,
    T* __restrict__ out, int n_kv, int G, int S, long long sb, long long sk,
    long long ss, int window, int prefix, float sm_scale, int g0) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = HD / VEC;       // lanes per key row
  constexpr int RPW = 32 / LPR;       // rows per warp pass
  constexpr int NPART = kWarps * RPW; // partial states per CTA
  constexpr int UNROLL = GC >= 8 ? 2 : 4;
  constexpr int BLK = RPW * UNROLL;   // rows per block, one warp each

  const int b = blockIdx.x / n_kv;
  const int kh = blockIdx.x % n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;
  const int d0 = (lane % LPR) * VEC;
  const int pos = pos_arr[b];
  const int last = min(pos, S - 1);   // the last row that can be visible
  const int ng = min(GC, G - g0);

  float qv[GC][VEC];
  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) { qv[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < ng) {
      const T* qp = q + ((size_t)(b * n_kv + kh) * G + g0 + g) * HD + d0;
      repro::load_vec(qp, qv[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] *= sm_scale;
    }
  }

  const T* kb = k + b * sb + kh * sk + d0;
  const T* vb = v + b * sb + kh * sk + d0;
  for (int start = warp * BLK; start <= last; start += kWarps * BLK) {
    if (window > 0) {   // the Pallas kernel's block skip; warp-uniform
      bool reach = start + BLK - 1 > pos - window;
      if (prefix > 0) reach = reach || start < prefix;
      if (!reach) continue;
    }
    float kr[UNROLL][VEC], vr[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = start + u * RPW + grp;
      if (t <= last) {
        repro::load_vec(kb + t * ss, kr[u]);
        repro::load_vec(vb + t * ss, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kr[u][e] = 0.f; vr[u][e] = 0.f; }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = start + u * RPW + grp;
      bool valid = t <= last;
      if (window > 0)
        valid = valid && (t > pos - window || (prefix > 0 && t < prefix));
      repro::online_row<GC, VEC, LPR>(qv, kr[u], vr[u], valid, m, l, acc);
    }
  }

  repro::merge_store<T, GC, VEC, HD, NPART, kThreads>(
      warp * RPW + grp, lane % LPR == 0, d0, m, l, acc,
      out + ((size_t)(b * n_kv + kh) * G + g0) * HD, ng);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, const int* pos,
               void* out, int B, int K, int G, int S, long long sb,
               long long sk, long long ss, int window, int prefix,
               float sm_scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const dim3 grid(B * K), block(kThreads);
  for (int g0 = 0; g0 < G; g0 += kMaxChunk) {
    const int n = G - g0 < kMaxChunk ? G - g0 : kMaxChunk;
#define REPRO_LAUNCH(GC)                                                    \
  decode_kernel<T, HD, GC><<<grid, block, 0, stream>>>(                     \
      qt, kt, vt, pos, ot, K, G, S, sb, sk, ss, window, prefix, sm_scale,   \
      g0)
    if (n == 1) REPRO_LAUNCH(1);
    else if (n == 2) REPRO_LAUNCH(2);
    else if (n <= 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int K, int G, int hd, int S, long long sb,
           long long sk, long long ss, int window, int prefix,
           float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(q, k, v, pos, out, B, K, G, S, sb, sk, ss,
                              window, prefix, sm_scale, stream); break;
    case 32: launch_hd<T, 32>(q, k, v, pos, out, B, K, G, S, sb, sk, ss,
                              window, prefix, sm_scale, stream); break;
    case 64: launch_hd<T, 64>(q, k, v, pos, out, B, K, G, S, sb, sk, ss,
                              window, prefix, sm_scale, stream); break;
    case 128: launch_hd<T, 128>(q, k, v, pos, out, B, K, G, S, sb, sk, ss,
                                window, prefix, sm_scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, K, G, hd) contiguous; k_cache, v_cache (B, K, S, hd) with element
// strides sb, sk, ss over (B, K, S) and the last dim contiguous, the same
// for both; pos (B,) int32; out (B, K, G, hd) contiguous.  Pointers and
// rows 16-byte aligned.  dtype: 0 = f32, 1 = bf16.  Returns the
// cudaError_t of the launch (0 on success).
int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                     const int* pos, void* out, int B, int K, int G, int hd,
                     int S, long long sb, long long sk, long long ss,
                     int window, int prefix, int dtype, float sm_scale,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || G == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_cache, v_cache, pos, out, B, K, G, hd, S, sb,
                         sk, ss, window, prefix, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, pos, out, B, K, G, hd,
                                 S, sb, sk, ss, window, prefix, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
