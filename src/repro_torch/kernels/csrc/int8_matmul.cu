// Dequantizing int8 matmul for Hopper (sm_90a), CUDA C++ on CUDA cores,
// f32 accumulation: out (M, N) = x (M, K) @ (w_q (K, N) * scale), out in
// x's dtype.
//
// Replaces: src/repro/kernels/int8_matmul.py, _int8_mm_kernel (launched by
// int8_matmul through pl.pallas_call).  The weights stay int8 in device
// memory; each int8 value is widened to f32 in registers (skinny kernels)
// or in shared memory (tile kernel) and never written back.  The scale is
// either per output channel, (1, N), applied once to the f32 sum as the
// Pallas kernel does, or per input channel, (K, 1), applied to x as it is
// read: the tied LM head's embedding scale is per d, its K dimension.
//
// Layouts.  x (M, K) row-major f32 or bf16; w_q any (K, N) strided view
// with one unit stride: "KN" (stride_n == 1, every linear layer) or "NK"
// (stride_k == 1, the tied head's embed_q.t()).  M, N, K are any sizes:
// the ragged edges are masked, and 16-byte loads fall back to byte loads
// where a row is not 16-byte aligned.
//
// What bounds it.  In decode M = n_slots (8 in the serve), so each weight
// byte feeds 2 * M flops: the kernel is bound by the bytes of w_q
// (K * N) over 3.35 TB/s.  The skinny kernels (M <= 16) stream w_q once
// with 16-byte loads per lane and keep up to 8 rows of x in registers.
// In prefill M = rows x bucket (up to 4096 in the serve) and the product
// is bound by operations; the tile kernel is a plain 64 x 64 x 32 f32
// CUDA-core tiling (4 x 4 outputs per thread), far below the tensor
// cores' rate: wgmma and TMA are later work.
#include "common.cuh"

namespace {

using repro::from_f32;

constexpr int kThreads = 256;

// 8 consecutive int8 values widened to f32, zero past `nvalid`; one
// 8-byte load when `vec` (8-byte aligned) and the whole run is valid.
__device__ __forceinline__ void load_i8x8(const int8_t* p, bool vec,
                                          int nvalid, float (&o)[8]) {
  if (vec && nvalid >= 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = (float)(signed char)((e < 4 ? raw.x : raw.y) >> (8 * (e % 4)));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = e < nvalid ? (float)p[e] : 0.f;
  }
}

// 16 consecutive int8 values kept packed in a uint4 (value e in byte e % 4
// of word e / 4), zero past `nvalid`; one 16-byte load when `vec` and the
// whole run is valid.  Packed, 16 values cost 4 registers.
__device__ __forceinline__ uint4 load_raw16(const int8_t* p, bool vec,
                                            int nvalid) {
  if (vec && nvalid >= 16) return *reinterpret_cast<const uint4*>(p);
  unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < nvalid) wd[e / 4] |= (unsigned)(uint8_t)p[e] << (8 * (e % 4));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Value e of a packed run, widened to f32 (e is a constant once unrolled).
__device__ __forceinline__ float i8_at(const uint4& v, int e) {
  const unsigned wd = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (float)(signed char)(wd >> (8 * (e % 4)));
}

// 4 consecutive x values widened to f32, zero past `nvalid`.
__device__ __forceinline__ void load_x4(const float* p, bool vec, int nvalid,
                                        float (&o)[4]) {
  if (vec && nvalid >= 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = e < nvalid ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void load_x4(const __nv_bfloat16* p, bool vec,
                                        int nvalid, float (&o)[4]) {
  if (vec && nvalid >= 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = e < nvalid ? repro::to_f32(p[e]) : 0.f;
  }
}

// ---- skinny, KN: M <= 16, w_q rows along N ---------------------------- //
// A CTA owns 32 columns (two 16-byte chunks) and all of K: thread t reads
// chunk t & 1 of rows t >> 1, t >> 1 + 128, ..., four rows in flight.
// The 128 partial sums per column meet in shared memory.
constexpr int kKnCols = 32;
constexpr int kKnRows = kThreads / 2;
constexpr int kKnUnroll = 4;

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads) skinny_kn(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int M, int N,
    int K, long long swk, bool scale_per_k, bool vec) {
  __shared__ float red[kKnRows][kKnCols + 1];
  __shared__ float part[kThreads / 32][kKnCols];
  const int t = threadIdx.x;
  const int c = t & 1, r = t >> 1;
  const int n0 = blockIdx.x * kKnCols + c * 16;
  const int m0 = blockIdx.y * MC;
  const int mv = min(MC, M - m0);
  float acc[MC][16];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;

  for (int k0 = r; k0 < K; k0 += kKnUnroll * kKnRows) {
    uint4 wv[kKnUnroll];
#pragma unroll
    for (int u = 0; u < kKnUnroll; ++u) {
      const int k = k0 + u * kKnRows;
      wv[u] = load_raw16(w + (size_t)min(k, K - 1) * swk + n0, vec,
                         k < K ? N - n0 : 0);
    }
#pragma unroll
    for (int u = 0; u < kKnUnroll; ++u) {
      const int k = k0 + u * kKnRows;
      if (k >= K) break;
      const float sk = scale_per_k ? scale[k] : 1.f;
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        const float xv = m < mv
            ? repro::to_f32(x[(size_t)(m0 + m) * K + k]) * sk : 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[m][e] = fmaf(xv, i8_at(wv[u], e), acc[m][e]);
      }
    }
  }

  const int col = t & 31, p = t >> 5;
#pragma unroll
  for (int m = 0; m < MC; ++m) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[r][c * 16 + e] = acc[m][e];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kKnRows / (kThreads / 32); ++i)
      s += red[p * (kKnRows / (kThreads / 32)) + i][col];
    part[p][col] = s;
    __syncthreads();
    if (t < kKnCols) {
      const int n = blockIdx.x * kKnCols + t;
      float total = 0.f;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) total += part[i][t];
      if (m < mv && n < N)
        out[(size_t)(m0 + m) * N + n] =
            from_f32<T>(scale_per_k ? total : total * scale[n]);
    }
  }
}

// ---- skinny, NK: M <= 16, w_q rows along K (the tied head) ----------- //
// A warp owns 8 columns; its lanes stride along K in 16-byte chunks (a
// warp reads 512 contiguous bytes of each column), each x value read once
// per chunk serves all 8 columns.  A warp-shuffle reduction ends it.
constexpr int kNkCols = 8;

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads) skinny_nk(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int M, int N,
    int K, long long swn, bool scale_per_k, bool vec, bool xvec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = (blockIdx.x * (kThreads / 32) + warp) * kNkCols;
  const int m0 = blockIdx.y * MC;
  const int mv = min(MC, M - m0);
  float acc[MC][kNkCols];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int j = 0; j < kNkCols; ++j) acc[m][j] = 0.f;

  for (int kc = lane * 16; kc < K; kc += 32 * 16) {
    uint4 wv[kNkCols];
#pragma unroll
    for (int j = 0; j < kNkCols; ++j) {
      const int n = nb + j;
      wv[j] = load_raw16(w + (size_t)min(n, N - 1) * swn + kc, vec,
                         n < N ? K - kc : 0);
    }
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const int k = kc + q4 * 4;
      float sk[4] = {1.f, 1.f, 1.f, 1.f};
      if (scale_per_k) load_x4(scale + min(k, K - 1), xvec, K - k, sk);
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        float xv[4];
        load_x4(x + (size_t)(m0 + min(m, mv - 1)) * K + min(k, K - 1), xvec,
                m < mv ? K - k : 0, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xs = xv[e] * sk[e];
#pragma unroll
          for (int j = 0; j < kNkCols; ++j)
            acc[m][j] = fmaf(xs, i8_at(wv[j], q4 * 4 + e), acc[m][j]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int j = 0; j < kNkCols; ++j) {
      float s = acc[m][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int n = nb + j;
      if (lane == (m * kNkCols + j) % 32 && m < mv && n < N)
        out[(size_t)(m0 + m) * N + n] =
            from_f32<T>(scale_per_k ? s : s * scale[n]);
    }
}

// ---- tile: M > 16 --------------------------------------------------- //
// 64 x 64 output tile per CTA, K in steps of 32 through shared memory:
// x transposed to xs[k][m], w_q widened to ws[k][n] (times the per-K
// scale, when it has one).  Thread (ty, tx) owns rows ty*4.. and columns
// tx*4.. of the tile: two float4 shared loads per 16 FMAs.
constexpr int kBM = 64, kBN = 64, kBK = 32;

template <typename T, bool KN>
__global__ void __launch_bounds__(kThreads) tile_mm(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out, int M, int N,
    int K, long long w_row, bool scale_per_k, bool vec) {
  __shared__ __align__(16) float xs[kBK][kBM];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {   // x tile: thread -> row t % 64, 8 k values from (t / 64) * 8
      const int mm = t % kBM, kk = (t / kBM) * 8;
      const int m = m0 + mm, k = k0 + kk;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xs[kk + e][mm] = (m < M && k + e < K)
            ? repro::to_f32(x[(size_t)m * K + k + e]) : 0.f;
    }
    if (KN) {   // w rows along N: thread -> k row t / 8, 8 columns
      const int kk = t / 8, nn = (t % 8) * 8;
      const int k = k0 + kk;
      float wv[8];
      load_i8x8(w + (size_t)min(k, K - 1) * w_row + n0 + nn, vec,
                 k < K ? N - n0 - nn : 0, wv);
      const float sk = (scale_per_k && k < K) ? scale[k] : 1.f;
      *reinterpret_cast<float4*>(&ws[kk][nn]) =
          make_float4(wv[0] * sk, wv[1] * sk, wv[2] * sk, wv[3] * sk);
      *reinterpret_cast<float4*>(&ws[kk][nn + 4]) =
          make_float4(wv[4] * sk, wv[5] * sk, wv[6] * sk, wv[7] * sk);
    } else {    // w rows along K: thread -> column t % 64, 8 k values
      const int nn = t % kBN, kk = (t / kBN) * 8;
      const int n = n0 + nn, k = k0 + kk;
      float wv[8];
      load_i8x8(w + (size_t)min(n, N - 1) * w_row + k, vec,
                 n < N ? K - k : 0, wv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ws[kk + e][nn] = (scale_per_k && k + e < K)
            ? wv[e] * scale[k + e] : wv[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(size_t)m * N + n] =
            from_f32<T>(scale_per_k ? acc[i][j] : acc[i][j] * scale[n]);
    }
  }
}

constexpr int kSkinnyMaxM = 16;

template <typename T, int MC>
void launch_skinny(const T* x, const int8_t* w, const float* scale, T* out,
                   int M, int N, int K, bool kn, long long w_row,
                   bool scale_per_k, bool vec, bool xvec,
                   cudaStream_t stream) {
  const int my = (M + MC - 1) / MC;
  if (kn) {
    const dim3 grid((N + kKnCols - 1) / kKnCols, my);
    skinny_kn<T, MC><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, M, N, K, w_row, scale_per_k, vec);
  } else {
    const int cols = (kThreads / 32) * kNkCols;
    const dim3 grid((N + cols - 1) / cols, my);
    skinny_nk<T, MC><<<grid, kThreads, 0, stream>>>(
        x, w, scale, out, M, N, K, w_row, scale_per_k, vec, xvec);
  }
}

template <typename T>
int launch(const void* xp, const int8_t* w, const float* scale, void* op,
           int M, int N, int K, bool kn, long long w_row, bool scale_per_k,
           bool vec, bool xvec, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(op);
  if (M <= kSkinnyMaxM) {
    if (M == 1)
      launch_skinny<T, 1>(x, w, scale, out, M, N, K, kn, w_row, scale_per_k,
                          vec, xvec, stream);
    else if (M == 2)
      launch_skinny<T, 2>(x, w, scale, out, M, N, K, kn, w_row, scale_per_k,
                          vec, xvec, stream);
    else if (M <= 4)
      launch_skinny<T, 4>(x, w, scale, out, M, N, K, kn, w_row, scale_per_k,
                          vec, xvec, stream);
    else
      launch_skinny<T, 8>(x, w, scale, out, M, N, K, kn, w_row, scale_per_k,
                          vec, xvec, stream);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    if (kn)
      tile_mm<T, true><<<grid, kThreads, 0, stream>>>(
          x, w, scale, out, M, N, K, w_row, scale_per_k, vec);
    else
      tile_mm<T, false><<<grid, kThreads, 0, stream>>>(
          x, w, scale, out, M, N, K, w_row, scale_per_k, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) row-major; w_q int8 with element strides (swk, swn) over
// (K, N), one of them 1; scale f32, N values (scale_per_k == 0) or K
// values (scale_per_k == 1), contiguous; out (M, N) row-major in x's
// dtype.  dtype: 0 = f32, 1 = bf16.  Returns the cudaError_t of the
// launch (0 on success).
int int8_matmul(const void* x, const void* w_q, const float* scale,
                void* out, int M, int N, int K, long long swk,
                long long swn, int scale_per_k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K == 0) return (int)cudaErrorInvalidValue;
  bool kn;
  long long w_row;
  if (swn == 1) { kn = true; w_row = swk; }
  else if (swk == 1) { kn = false; w_row = swn; }
  else return (int)cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   w_row % 16 == 0;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    K % 8 == 0;
  if (dtype == 0)
    return launch<float>(x, w, scale, out, M, N, K, kn, w_row,
                         scale_per_k != 0, vec, xvec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, out, M, N, K, kn, w_row,
                                 scale_per_k != 0, vec, xvec, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
