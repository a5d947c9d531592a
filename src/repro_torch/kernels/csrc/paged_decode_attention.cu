// Paged decode attention for Hopper (sm_90a), CUDA C++, f32 accumulation.
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
// Design.  The TPU grid walks the page axis sequentially ("arbitrary")
// with (m, l, acc) in VMEM scratch; here one CTA per (slot, kv head) loops
// over the pages itself and reads each page id from the table (no scalar
// prefetch).  Pages are dealt round-robin to the CTA's 4 warps.  Inside a
// warp, a group of hd/VEC lanes owns one token row: each lane loads 16
// bytes of the key and of the value along hd (neighbouring lanes on
// neighbouring addresses; a page row of one kv head is K*hd elements from
// the next), the group reduces the q.k partial sums with shuffles, and
// keeps its own online-softmax state (m, l, acc) for the G query rows in
// registers.  UNROLL rows per group are loaded before any is used, so
// several 16-byte loads per lane are in flight.  At the end the CTA merges
// the per-group states through shared memory with the usual log-sum-exp
// rescale.  G above 8 runs in chunks of 8 query rows, one launch each.
// No tensor cores: G is 1..8 rows, far below a wgmma tile, and the kernel
// is bound by the bytes it reads.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Vec;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 8;

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ pos_arr, T* __restrict__ out, int n_kv, int G,
    int n_pages, int ps, int pps, int window, int prefix, float sm_scale,
    int g0) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = HD / VEC;       // lanes per token row
  constexpr int RPW = 32 / LPR;       // rows per warp pass
  constexpr int NPART = kWarps * RPW; // partial states per CTA
  constexpr int UNROLL = GC >= 8 ? 2 : 4;

  const int b = blockIdx.x / n_kv;
  const int kh = blockIdx.x % n_kv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPR;
  const int d0 = (lane % LPR) * VEC;
  const int pos = pos_arr[b];
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

  const size_t row_stride = (size_t)n_kv * HD;
  for (int j = warp; j < pps; j += kWarps) {
    const int page = page_table[(size_t)b * pps + j];
    const int start = j * ps;
    // the same `run` predicate as the Pallas kernel; uniform over a warp
    bool run = page >= 0 && page < n_pages && start <= pos;
    if (window > 0) {
      bool reach = start + ps - 1 > pos - window;
      if (prefix > 0) reach = reach || start < prefix;
      run = run && reach;
    }
    if (!run) continue;
    const size_t base = (size_t)page * ps * row_stride + (size_t)kh * HD + d0;
    for (int t0 = 0; t0 < ps; t0 += RPW * UNROLL) {
      float kr[UNROLL][VEC], vr[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u * RPW + grp;
        if (t < ps) {
          repro::load_vec(k_pool + base + (size_t)t * row_stride, kr[u]);
          repro::load_vec(v_pool + base + (size_t)t * row_stride, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) { kr[u][e] = 0.f; vr[u][e] = 0.f; }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = t0 + u * RPW + grp;
        const int kv_pos = start + t;
        bool valid = t < ps && kv_pos <= pos;
        if (window > 0) {
          valid = valid && (kv_pos > pos - window ||
                            (prefix > 0 && kv_pos < prefix));
        }
        repro::online_row<GC, VEC, LPR>(qv, kr[u], vr[u], valid, m, l, acc);
      }
    }
  }

  // merge the CTA's NPART partial states
  repro::merge_store<T, GC, VEC, HD, NPART, kThreads>(
      warp * RPW + grp, lane % LPR == 0, d0, m, l, acc,
      out + ((size_t)(b * n_kv + kh) * G + g0) * HD, ng);
}

template <typename T, int HD>
void launch_hd(const void* q, const void* kp, const void* vp,
               const int* table, const int* pos, void* out, int B, int K,
               int G, int P, int ps, int pps, int window, int prefix,
               float sm_scale, cudaStream_t stream) {
  for (int g0 = 0; g0 < G; g0 += kMaxChunk) {
    const int n = G - g0 < kMaxChunk ? G - g0 : kMaxChunk;
    const dim3 grid(B * K), block(kThreads);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(kp);
    const T* vt = static_cast<const T*>(vp);
    T* ot = static_cast<T*>(out);
#define REPRO_LAUNCH(GC)                                                    \
  paged_decode_kernel<T, HD, GC><<<grid, block, 0, stream>>>(               \
      qt, kt, vt, table, pos, ot, K, G, P, ps, pps, window, prefix,         \
      sm_scale, g0)
    if (n == 1) REPRO_LAUNCH(1);
    else if (n == 2) REPRO_LAUNCH(2);
    else if (n <= 4) REPRO_LAUNCH(4);
    else REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* pos, void* out, int B, int K, int G, int hd, int P,
           int ps, int pps, int window, int prefix, float sm_scale,
           cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(q, kp, vp, table, pos, out, B, K, G, P, ps,
                              pps, window, prefix, sm_scale, stream); break;
    case 32: launch_hd<T, 32>(q, kp, vp, table, pos, out, B, K, G, P, ps,
                              pps, window, prefix, sm_scale, stream); break;
    case 64: launch_hd<T, 64>(q, kp, vp, table, pos, out, B, K, G, P, ps,
                              pps, window, prefix, sm_scale, stream); break;
    case 128: launch_hd<T, 128>(q, kp, vp, table, pos, out, B, K, G, P, ps,
                                pps, window, prefix, sm_scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, K, G, hd); k_pool, v_pool (P, ps, K, hd); page_table (B, pps)
// int32 with sentinel P; pos (B,) int32; out (B, K, G, hd).  All
// contiguous, 16-byte aligned.  dtype: 0 = f32, 1 = bf16.  Returns the
// cudaError_t of the launch (0 on success).
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const int* page_table,
                           const int* pos, void* out, int B, int K, int G,
                           int hd, int P, int ps, int pps, int window,
                           int prefix, int dtype, float sm_scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0 || G == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, pos, out, B, K, G,
                         hd, P, ps, pps, window, prefix, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, pos, out, B,
                                 K, G, hd, P, ps, pps, window, prefix,
                                 sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
