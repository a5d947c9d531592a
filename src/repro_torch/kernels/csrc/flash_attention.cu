// Flash attention (prefill) for Hopper (sm_90a), CUDA C++, f32 accumulation.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (launched
// by flash_attention through pl.pallas_call).  GQA (query head h reads kv
// head h / G), causal or not, an optional static sliding window and an
// always-visible prefix; fully masked kv tiles are skipped with the same
// predicate as the Pallas kernel; online softmax (m, l, acc) in f32.
//
// What bounds it: operations.  A causal prefill does 4 * hd flops for
// every visible (query, key) pair of every head and reads each q, k, v
// element once, so at a prefill bucket of 1024 tokens it sits far above
// the card's flops-per-byte balance: the least time is
// 4 * B * H * hd * (visible pairs) over 989 TFLOP/s (bf16 tensor cores).
//
// Design.  The TPU grid's sequential kv axis becomes a loop inside one CTA
// per (64-row query tile, batch * head); the loop stops at the causal
// frontier and skips tiles wholly left of the window.  Ragged edges are
// masked in the kernel (the Pallas wrapper asserts Sq % block_q == 0, but
// prefill buckets are any power of two >= 8).  Each kv tile of 64 rows is
// staged in shared memory in f32 (16-byte global loads, K rows padded by
// one float so that 16 lanes reading 16 rows hit 16 banks); 256 threads
// each compute a 4x4 block of the 64x64 score tile on the CUDA cores,
// then 4 threads per query row do the online-softmax rescale, and each
// thread accumulates a 4 x hd/16 block of the output in registers.  This
// first kernel uses no tensor cores (no wgmma, no TMA): it is right and
// simple; its distance from the bound is recorded in PERF.md.

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Vec;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1) +
                          3 * kBQ);
}

// Stage `rows` x HD elements starting at `src` (row-major, HD per row)
// into shared memory with row pitch `pitch`, scaled; rows >= n_valid are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      int n_valid, int rows, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float v[VEC];
    if (r < n_valid) {
      repro::load_vec(src + (size_t)r * HD + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * pitch + c + e] = v[e] * scale;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int H, int n_kv, int Sq,
    int Skv, int causal, int window, int prefix, float sm_scale) {
  constexpr int DJ = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                          // [kBQ][HD]
  float* sK = sQ + kBQ * HD;                 // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);           // [kBK][HD]
  float* sS = sV + kBK * HD;                 // [kBQ][kBK + 1]
  float* sM = sS + kBQ * (kBK + 1);          // [kBQ]
  float* sL = sM + kBQ;                      // [kBQ]
  float* sC = sL + kBQ;                      // [kBQ] correction factors

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / n_kv);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  const T* qb = q + ((size_t)bh * Sq + q0) * HD;
  const T* kb = k + (size_t)(b * n_kv + kvh) * Skv * HD;
  const T* vb = v + (size_t)(b * n_kv + kvh) * Skv * HD;

  stage<T, HD>(sQ, HD, qb, Sq - q0, kBQ, sm_scale);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // kv tiles up to the causal frontier of this query tile
  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    if (causal && window > 0) {
      // tile wholly left of the window and not prefix-visible: skip
      const bool reach = k0 + kBK - 1 > q0 - window;
      if (!reach && !(prefix > 0 && k0 < prefix)) continue;
    }
    __syncthreads();  // previous tile's sK/sV/sS reads are done
    stage<T, HD>(sK, HD + 1, kb + (size_t)k0 * HD, Skv - k0, kBK, 1.f);
    stage<T, HD>(sV, HD, vb + (size_t)k0 * HD, Skv - k0, kBK, 1.f);
    __syncthreads();

    // scores: this thread's 4x4 block, rows tr + 16i, columns tc + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(tr + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = sK[(tc + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, kp = k0 + c;
        bool ok = kp < Skv;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0)
            ok = ok && (kp > qp - window || (prefix > 0 && kp < prefix));
        }
        sS[r * (kBK + 1) + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: 4 consecutive lanes per query row, 16 columns each
    {
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      float* row = sS + r * (kBK + 1) + part * 16;
      float mb = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mb = fmaxf(mb, row[c]);
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mb);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(tr + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * HD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)bh * Sq + q0) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)r * HD + tc + 16 * j] = repro::from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int causal, int window,
              int prefix, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H), block(kThreads);
  flash_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, Sq, Skv, causal,
      window, prefix, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int hd, int causal, int window,
           int prefix, float sm_scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                     window, prefix, sm_scale, s);
    case 32: return launch_hd<T, 32>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                     window, prefix, sm_scale, s);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                     window, prefix, sm_scale, s);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, H, K, Sq, Skv,
                                       causal, window, prefix, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd); k, v (B, K, Skv, hd) with H % K == 0; out (B, H, Sq,
// hd).  All contiguous, 16-byte aligned.  dtype: 0 = f32, 1 = bf16.
// Returns the cudaError_t of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int K, int Sq, int Skv, int hd, int causal,
                    int window, int prefix, int dtype, float sm_scale,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, K, Sq, Skv, hd, causal, window,
                         prefix, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Skv, hd, causal,
                                 window, prefix, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
