// Dequantizing int8 matmul for Hopper (sm_90a), CUDA C++, f32
// accumulation: out (M, N) = x (M, K) @ (w_q (K, N) * scale), out in x's
// dtype.
//
// Replaces: src/repro/kernels/int8_matmul.py, _int8_mm_kernel (launched by
// int8_matmul through pl.pallas_call).  The weights stay int8 in device
// memory; each int8 value is widened (exactly) in registers or shared
// memory and never written back.  The scale is either per output
// channel, (1, N), applied once to the f32 sum as the Pallas kernel does,
// or per input channel, (K, 1), applied to x as it is read: the tied LM
// head's embedding scale is per d, its K dimension.
//
// Layouts.  x (M, K) row-major f32 or bf16; w_q any (K, N) strided view
// with one unit stride: "KN" (stride_n == 1, every linear layer) or "NK"
// (stride_k == 1, the tied head's embed_q.t()).  M, N, K are any sizes:
// the ragged edges are masked.
//
// Routes, chosen by the caller (kernels/ops.py, int8_matmul_route) from
// dtype, layout, scale, M and alignment, never from a failure:
//   0 skinny          M <= 16 with f32 x or unaligned rows.  Bound by
//                     the bytes of w_q (each weight byte feeds 2 M flops)
//                     in principle, by the CUDA cores' int-to-float
//                     conversion and M FMAs per weight byte in practice:
//                     w_q is streamed once with 16-byte loads per lane,
//                     kept packed in registers, up to 8 rows of x in
//                     registers.  f32 stays here: on the tensor cores it
//                     would be TF32.
//   3 skinny_tc       bf16 x, M <= 16, K % 8 == 0, 16-byte aligned rows
//                     (KN or NK, per-N or 16-byte aligned per-K scale):
//                     decode and the tied head of a bf16 model.  The
//                     same bytes on the
//                     tensor cores (mma.sync with A and B swapped, the
//                     weight as A), K split across CTAs for small N; see
//                     skinny_tc below.
//   1 tensor_core     bf16 x, M > 16, KN, per-N scale, 16-byte rows: the
//                     prefill projections.  Bound by operations (989
//                     TFLOP/s bf16 on the tensor cores; int8 values are
//                     exact in bf16, so a bf16 x bf16 product with f32
//                     accumulation differs from the plain version only in
//                     the order of summation).  A 128 x 128 output tile
//                     per CTA: one producer thread keeps a 4-stage ring
//                     of TMA loads in flight (the x tile with 128-byte
//                     swizzle, the raw int8 tile), the two consumer
//                     warpgroups widen each int8 tile to bf16 into the
//                     swizzled N-major layout the wgmma B descriptor
//                     reads, then each runs wgmma m64n128k16 on its 64
//                     rows, the widening of the next tile overlapping the
//                     tensor cores' work on this one.  TMA's zero fill
//                     covers the ragged edges of M, N and K.
//   2 cuda_core_tile  everything else with M > 16 (f32 x, the per-K-scale
//                     NK head view, unaligned rows): a 64 x 64 x 32 f32
//                     CUDA-core tiling, kept for f32 exactness (f32 on
//                     the tensor cores would be TF32).
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

// ---- skinny_tc: bf16 x, M <= 16, on the tensor cores ---------------- //
// mma.sync m16n8k16 with A and B swapped: the weight is A, 16 output
// columns a tile (MMA rows), and x is B, its <= 8 rows the MMA's n = 8
// (two B tiles for M up to 16).  Nothing passes through shared memory on
// the way in.  The sum over k does not care in which order each k16 step
// lists its 16 k, so every lane's 16-byte load is mapped straight onto its
// own fragment registers (x's fragment takes the same k order):
//   KN (w rows along N): a step is 16 k.  Lane (g = lane/4, t = lane%4)
//     loads columns 16g..16g+15 of rows k = 4t..4t+3: 128 contiguous bytes
//     per row across the 8 lanes of one t.  Tile i's MMA row r is column
//     16 (r % 8) + 2i + r / 8, its logical k 2t, 2t+1, 2t+8, 2t+9 are rows
//     4t..4t+3, so x's fragment is x[g][4t..4t+3], one 8-byte load.  Each
//     bf16 pair of the A fragment joins bytes of two loads (two k).
//   NK (w rows along K, the tied head's embed_q.t()): a step is 64 k.
//     Lane (g, t) loads k 16t..16t+15 of columns g and g+8 of each of 4
//     tiles; k16 step j takes bytes 4j..4j+3 as its logical k 2t, 2t+1,
//     2t+8, 2t+9, and x's fragment is x[g][16t+4j..16t+4j+3].
// Each int8 is widened exactly (the byte permute of widen16, one
// subtraction) and paired into bf16x2 registers; sums are f32.  The per-N
// scale multiplies the f32 sum once at the end.  A per-K scale (the tied
// head's, one per d) cannot, so it is folded into x: x * s in f32, split
// into two bf16 terms, hi = bf16(x s) and lo = bf16(x s - hi), each
// multiplied by the exact bf16 weight on the tensor cores (one more MMA
// per tile and step, the same weight fragment).  hi alone, one rounding
// of x s to bf16, strays from the plain f32 product by up to 2^-9 of
// each term, ~0.03 in an output near 0 at K = 2048: past the 2e-2
// tolerance the route is held to.  hi + lo carries x s to ~2^-17, so the
// route differs from the plain version only in the order of its f32
// sums (tests/test_torch_kernels.py emulates the split).
//
// Pipeline: each warp keeps a ring of RING steps of raw loads in its
// registers (KN 4 x 2 KB, NK 2 x 4 KB of weight per warp, each step's x
// values and scales beside it), issuing step s + RING as soon as step s
// is widened, so 8 KB of weight is in flight per warp and 32-128 KB per
// SM, and no step waits on a load issued when it starts.  A CTA of
// kStWarps warps owns COLS columns and a range of `per` steps, dealt
// round-robin to its warps; their sums meet in shared memory in warp
// order.  Small N cannot fill 132 SMs with column tiles
// alone (2048 -> 2048: 16 tiles of 128), so K is split over gridDim.y
// CTAs too (ops.int8_skinny_tc_splits: at least 2 x the SM count of
// CTAs); each stores an f32 partial, and the last to finish (common.cuh
// last_to_arrive) sums them in split order: deterministic, one launch.
//
// Bound: the bytes of w_q, each read once (K N bytes; x, the scale and
// the output are a few KB), over 3.35 TB/s.  Per weight byte the kernel
// spends ~2.5 instructions widening it and 2 M / 256 of an MMA, where the
// CUDA-core skinny kernels spent a conversion and M FMAs.
constexpr int kStWarps = 4;
constexpr int kStThreads = 32 * kStWarps;

// Value e of the sign-flipped word u (u = word ^ 0x80808080), exactly, as
// an f32: 2^23 + (b + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) -
         8388736.f;
}

// Word j of a 16-byte run (j is a constant once unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// x * s for four bf16 of x (two bf16x2 words) and their four per-K
// scales, in f32, as the pair hi = bf16(x s), lo = bf16(x s - hi).
__device__ __forceinline__ void split_xs(const uint2& raw, const float4& s,
                                         uint2& hi, uint2& lo) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float f[4] = {a.x * s.x, a.y * s.y, b.x * s.z, b.y * s.w};
  hi.x = repro::pack_bf16x2(f[0], f[1]);
  hi.y = repro::pack_bf16x2(f[2], f[3]);
  const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(&hi);
  const float2 ra = __bfloat1622float2(r[0]), rb = __bfloat1622float2(r[1]);
  lo.x = repro::pack_bf16x2(f[0] - ra.x, f[1] - ra.y);
  lo.y = repro::pack_bf16x2(f[2] - rb.x, f[3] - rb.y);
}

// KN: a step is 16 k, 8 tiles of 16 columns, 4 weight loads a lane and
// 4 x values per x row; NK: a step is 64 k, 4 tiles, 8 weight loads and
// 16 x values per x row.
template <bool KN> struct StShape;
template <> struct StShape<true> {
  static constexpr int COLS = 128, STEP_K = 16, LOADS = 4, RING = 4, NT = 8;
  static constexpr int XQ = 1;   // 4-value x quads per x row and step
};
template <> struct StShape<false> {
  static constexpr int COLS = 64, STEP_K = 64, LOADS = 8, RING = 2, NT = 4;
  static constexpr int XQ = 4;
};

// One step's operands as they arrive: the raw int8 weight, the lane's x
// values (bf16, raw) and, with a per-K scale, their scales.
template <bool KN, int MT, bool PER_K> struct StSlot {
  uint4 w[StShape<KN>::LOADS];
  uint2 x[MT][StShape<KN>::XQ];
  float4 s[PER_K ? StShape<KN>::XQ : 1];
};

template <bool KN, int MT, bool PER_K>
__global__ void __launch_bounds__(kStThreads) skinny_tc(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, unsigned* __restrict__ tickets, int M, int N,
    int K, long long w_row, int per) {
  using S = StShape<KN>;
  using Slot = StSlot<KN, MT, PER_K>;
  constexpr int COLS = S::COLS, STEP_K = S::STEP_K, LOADS = S::LOADS;
  constexpr int RING = S::RING, NT = S::NT, XQ = S::XQ;
  __shared__ float red[MT * 8][COLS + 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * COLS;
  const int n_steps = (K + STEP_K - 1) / STEP_K;
  const int s_lo = blockIdx.y * per;
  const int s_hi = min(s_lo + per, n_steps);

  // step s's operands, all issued at once (zeros past K, N, M and s_hi):
  // x and the scale ride in the ring with the weight, so no step waits on
  // a load issued when it starts
  auto load_step = [&](int s, Slot& r) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) r.w[j] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < XQ; ++q) r.x[mt][q] = make_uint2(0u, 0u);
    if constexpr (PER_K)
#pragma unroll
      for (int q = 0; q < XQ; ++q) r.s[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s >= s_hi) return;
    // this lane's first k of the step: KN rows 4t..4t+3, NK 16t..16t+15
    const int k = s * STEP_K + (KN ? 4 * t : 16 * t);
    if constexpr (KN) {
      const int n = n0 + 16 * g;
#pragma unroll
      for (int j = 0; j < LOADS; ++j)
        if (k + j < K)
          r.w[j] = load_raw16(w + (size_t)(k + j) * w_row + n, true, N - n);
    } else {
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int n = n0 + 16 * (j / 2) + g + 8 * (j % 2);
        if (n < N && k < K)
          r.w[j] = load_raw16(w + (size_t)n * w_row + k, true, K - k);
      }
    }
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      if (k + 4 * q >= K) continue;   // K % 8 == 0: quads in or out
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = g + 8 * mt;
        if (m < M)
          r.x[mt][q] = *reinterpret_cast<const uint2*>(
              x + (size_t)m * K + k + 4 * q);
      }
      if constexpr (PER_K)
        r.s[q] = *reinterpret_cast<const float4*>(scale + k + 4 * q);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;

  // one step's MMAs
  auto mma_step = [&](const Slot& r) {
    uint2 xb[MT][XQ], xl[MT][XQ];   // B fragments: x (or hi, lo of x s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < XQ; ++q) {
        if constexpr (PER_K) split_xs(r.x[mt][q], r.s[q], xb[mt][q],
                                      xl[mt][q]);
        else xb[mt][q] = r.x[mt][q];
      }
    if constexpr (KN) {
      uint32_t u[4][4];   // [k row j][word q], sign-flipped
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) u[j][q] = word(r.w[j], q) ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int q = i / 2, p = i % 2;
        const uint32_t a[4] = {
            repro::pack_bf16x2(i8f(u[0][q], 2 * p), i8f(u[1][q], 2 * p)),
            repro::pack_bf16x2(i8f(u[0][q], 2 * p + 1),
                               i8f(u[1][q], 2 * p + 1)),
            repro::pack_bf16x2(i8f(u[2][q], 2 * p), i8f(u[3][q], 2 * p)),
            repro::pack_bf16x2(i8f(u[2][q], 2 * p + 1),
                               i8f(u[3][q], 2 * p + 1))};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          repro::mma_bf16_16816(acc[mt][i], a, xb[mt][0].x, xb[mt][0].y);
          if constexpr (PER_K)
            repro::mma_bf16_16816(acc[mt][i], a, xl[mt][0].x, xl[mt][0].y);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {       // k16 step j of the 64
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const uint32_t ug = word(r.w[2 * i], j) ^ 0x80808080u;
          const uint32_t u8 = word(r.w[2 * i + 1], j) ^ 0x80808080u;
          const uint32_t a[4] = {
              repro::pack_bf16x2(i8f(ug, 0), i8f(ug, 1)),
              repro::pack_bf16x2(i8f(u8, 0), i8f(u8, 1)),
              repro::pack_bf16x2(i8f(ug, 2), i8f(ug, 3)),
              repro::pack_bf16x2(i8f(u8, 2), i8f(u8, 3))};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            repro::mma_bf16_16816(acc[mt][i], a, xb[mt][j].x, xb[mt][j].y);
            if constexpr (PER_K)
              repro::mma_bf16_16816(acc[mt][i], a, xl[mt][j].x,
                                    xl[mt][j].y);
          }
        }
      }
    }
  };

  // this warp's steps: s_lo + warp, s_lo + warp + 4, ...; a ring of RING
  // steps of raw loads in flight
  Slot ring[RING];
  constexpr int W = kStWarps;
  const int first = s_lo + warp;
#pragma unroll
  for (int u = 0; u < RING; ++u) load_step(first + W * u, ring[u]);
  for (int s = first; s < s_hi; s += W * RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int su = s + W * u;
      if (su < s_hi) {
        mma_step(ring[u]);
        load_step(su + W * RING, ring[u]);
      }
    }
  }

  // the warps' sums meet in shared memory, added in warp order; the
  // accumulator fragment: c0, c1 are MMA row g, c2, c3 row g + 8, at
  // columns (x rows) 2t, 2t + 1
  for (int wi = 0; wi < W; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = 8 * mt + 2 * t + (c & 1);
            const int col = KN ? 16 * g + 2 * i + (c >> 1)
                               : 16 * i + g + 8 * (c >> 1);
            red[m][col] =
                wi == 0 ? acc[mt][i][c] : red[m][col] + acc[mt][i][c];
          }
    }
    __syncthreads();
  }

  const int rows = min(M, MT * 8);
  const int n_ks = gridDim.y;
  // partials of this column tile: [n_ks][rows][COLS] f32
  float* part = n_ks > 1 ? ws + (size_t)blockIdx.x * n_ks * rows * COLS
                         : nullptr;
  for (int idx = threadIdx.x; idx < rows * COLS; idx += kStThreads) {
    const int m = idx / COLS, col = idx % COLS, n = n0 + col;
    const float sum = red[m][col];
    if (n_ks == 1) {
      if (n < N)
        out[(size_t)m * N + n] =
            __float2bfloat16(PER_K ? sum : sum * scale[n]);
    } else {
      part[(size_t)blockIdx.y * rows * COLS + idx] = sum;
    }
  }
  if (n_ks == 1) return;
  if (!repro::last_to_arrive(tickets + blockIdx.x, (unsigned)n_ks)) return;
  // the partials' sum in split order, 4 columns a thread (16-byte loads
  // through L2), the split loop unrolled so that its loads overlap
  const float4* p4 = reinterpret_cast<const float4*>(part);
  const int n4 = rows * COLS / 4;
  for (int i = threadIdx.x; i < n4; i += kStThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_ks; ++s) {
      const float4 v = __ldcg(p4 + (size_t)s * n4 + i);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const int m = 4 * i / COLS, n = n0 + 4 * i % COLS;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N)
        out[(size_t)m * N + n + e] =
            __float2bfloat16(PER_K ? v[e] : v[e] * scale[n + e]);
  }
}

// Needs M <= 16, K % 8 == 0, 16-byte aligned x, w_q and weight rows, a
// 16-byte aligned per-K scale (read four floats at a time), and a split
// of the k steps that leaves no CTA empty.
int launch_skinny_tc(const __nv_bfloat16* x, const int8_t* w,
                     const float* scale, __nv_bfloat16* out, float* ws,
                     unsigned* tickets, int M, int N, int K, bool kn,
                     long long w_row, bool scale_per_k, int n_ks, int per,
                     cudaStream_t stream) {
  const int cols = kn ? StShape<true>::COLS : StShape<false>::COLS;
  const int step_k = kn ? StShape<true>::STEP_K : StShape<false>::STEP_K;
  const int n_steps = (K + step_k - 1) / step_k;
  if (M > 16 || K % 8 || w_row % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (scale_per_k && reinterpret_cast<uintptr_t>(scale) % 16) ||
      n_ks < 1 || per < 1 || (long long)n_ks * per < n_steps ||
      (long long)(n_ks - 1) * per >= n_steps ||
      (n_ks > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + cols - 1) / cols, n_ks);
#define REPRO_LAUNCH(KN, MT, PER_K)                                         \
  skinny_tc<KN, MT, PER_K><<<grid, kStThreads, 0, stream>>>(                \
      x, w, scale, out, ws, tickets, M, N, K, w_row, per)
#define REPRO_LAUNCH_M(KN, PER_K)                                           \
  if (M <= 8) REPRO_LAUNCH(KN, 1, PER_K); else REPRO_LAUNCH(KN, 2, PER_K)
  if (kn) {
    if (scale_per_k) { REPRO_LAUNCH_M(true, true); }
    else { REPRO_LAUNCH_M(true, false); }
  } else {
    if (scale_per_k) { REPRO_LAUNCH_M(false, true); }
    else { REPRO_LAUNCH_M(false, false); }
  }
#undef REPRO_LAUNCH_M
#undef REPRO_LAUNCH
  return (int)cudaGetLastError();
}

// ---- cuda_core_tile: M > 16, f32 x or NK or unaligned --------------- //
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

// ---- tensor_core: bf16 x, KN, per-N scale -------------------------- //
// CTA tile 128 x 128, K in steps of 64 through a ring of kStages stages.
// Per stage, from a 1024-byte aligned base:
//   A    x tile, 128 rows (m) x 64 bf16 (k): 128-byte rows, TMA's 128-byte
//        swizzle (16-byte chunk c of row r at chunk c ^ (r % 8));
//   RAW  int8 tile, 64 rows (k) x 128 bytes (n), as TMA lands it;
//   B    the widened tile, two 64-column atoms (n), each 64 rows (k) x
//        128 bytes with the same swizzle: the N-major layout of wgmma's
//        B operand (LBO = the atom stride, SBO = 8 rows = 1024 bytes).
// Threads 0-255 are the consumer warpgroups (rows 0-63 and 64-127 of the
// tile); thread 256 is the producer, the rest of its warpgroup idles.
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 384;
constexpr uint32_t kTcA = kTcBM * kTcBK * 2;           // 16384
constexpr uint32_t kTcRaw = kTcBK * kTcBN;             // 8192
constexpr uint32_t kTcAtom = kTcBK * 128;              // 8192
constexpr uint32_t kTcStage = kTcA + kTcRaw + 2 * kTcAtom;
constexpr size_t kTcSmem = (size_t)kTcStages * kTcStage + 1024 + 64;

// 16 int8 values (a 16-byte chunk) to 16 bf16, exactly: each byte b,
// sign-flipped to b + 128, becomes the low byte of the f32 2^23 + b + 128,
// from which 2^23 + 128 is subtracted.
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo,
                                        uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) -
             8388736.f;
    o[2 * i] = repro::pack_bf16x2(f[0], f[1]);
    o[2 * i + 1] = repro::pack_bf16x2(f[2], f[3]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(kTcThreads, 1) tc_mm(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
    int N, int K) {
  using namespace repro;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  const uint32_t bars = base + kTcStages * kTcStage;   // full[s], empty[s]
  uint8_t* const gbase = smem_raw + (base - raw_base);
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(bars + 8 * s, 1);                    // the producer + tx
      mbar_init(bars + 8 * (kTcStages + s), 2);      // one per consumer WG
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (t >= 256) {                                    // producer
    if (t == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages)
          mbar_wait(bars + 8 * (kTcStages + s), (i / kTcStages - 1) & 1);
        const uint32_t st = base + s * kTcStage;
        mbar_arrive_expect_tx(bars + 8 * s, kTcA + kTcRaw);
        tma_load_2d(st, &tm_x, bars + 8 * s, i * kTcBK, m0);
        tma_load_2d(st + kTcA, &tm_w, bars + 8 * s, n0, i * kTcBK);
      }
    }
    return;
  }

  const int wg = t / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int s = i % kTcStages;
    const uint32_t st = base + s * kTcStage;
    mbar_wait(bars + 8 * s, (i / kTcStages) & 1);
    // widen RAW -> B: 512 16-byte chunks of int8, two per thread.  Threads
    // of the second atom store their two halves in the other order, so
    // that 8 neighbouring threads hit 8 different bank groups.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = t + 256 * j;
      const int r = idx / 8, c16 = idx % 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          gbase + s * kTcStage + kTcA + r * 128 + c16 * 16);
      uint4 lo, hi;
      widen16(raw, lo, hi);
      const bool swap = c16 & 4;
      const int cc = (c16 % 4) * 2;
      uint8_t* row = gbase + s * kTcStage + kTcA + kTcRaw +
                     (c16 / 4) * kTcAtom + r * 128;
      *reinterpret_cast<uint4*>(row + (((cc + swap) ^ (r & 7)) << 4)) =
          swap ? hi : lo;
      *reinterpret_cast<uint4*>(row + (((cc + !swap) ^ (r & 7)) << 4)) =
          swap ? lo : hi;
    }
    fence_proxy_async();
    named_bar_sync(1, 256);

    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_ss<128, 1>(
          acc, smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024, 1),
          smem_desc(st + kTcA + kTcRaw + kk * 16 * 128, kTcAtom, 1024, 1), 1);
    wgmma_commit();
    // the previous step's products are done: release its stage
    wgmma_wait<1>();
    fence_acc(acc);
    if (i > 0 && t % 128 == 0)
      mbar_arrive(bars + 8 * (kTcStages + (i - 1) % kTcStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: the accumulator fragment of wgmma m64nN: value 4j + 2h + e
  // of lane l in warp w is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
  const int w = (t % 128) / 32, l = t % 32;
  const bool pair = (N % 2) == 0;
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (l % 4);
    if (n >= N) continue;
    const float s0 = scale[n], s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + 16 * w + l / 4 + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* o = out + (size_t)m * N + n;
      const float v0 = acc[4 * j + 2 * h] * s0;
      const float v1 = acc[4 * j + 2 * h + 1] * s1;
      if (pair && n + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (n + 1 < N) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

// The two tensor maps (built per call: the pointers change) and the launch.
// Needs K % 8 == 0, w_row % 16 == 0 and 16-byte aligned x and w_q.
int launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
              __nv_bfloat16* out, int M, int N, int K, long long w_row,
              cudaStream_t stream) {
  if (K % 8 || w_row % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_x, tm_w;
  const cuuint32_t ones[2] = {1, 1};
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {kTcBK, kTcBM};
    if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<__nv_bfloat16*>(x), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)w_row};
    const cuuint32_t box[2] = {kTcBN, kTcBK};
    if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<int8_t*>(w), dims, strides, box, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      tc_mm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
  tc_mm<<<grid, kTcThreads, kTcSmem, stream>>>(tm_x, tm_w, scale, out, M, N,
                                               K);
  return (int)cudaGetLastError();
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

enum Route { kSkinny = 0, kTensorCore = 1, kCudaCoreTile = 2,
             kSkinnyTc = 3 };

template <typename T>
int launch(const void* xp, const int8_t* w, const float* scale, void* op,
           int M, int N, int K, bool kn, long long w_row, bool scale_per_k,
           bool vec, bool xvec, int route, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(op);
  if (route == kSkinny) {
    if (M > kSkinnyMaxM) return (int)cudaErrorInvalidValue;
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
  } else if (route == kCudaCoreTile) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    if (kn)
      tile_mm<T, true><<<grid, kThreads, 0, stream>>>(
          x, w, scale, out, M, N, K, w_row, scale_per_k, vec);
    else
      tile_mm<T, false><<<grid, kThreads, 0, stream>>>(
          x, w, scale, out, M, N, K, w_row, scale_per_k, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) row-major; w_q int8 with element strides (swk, swn) over
// (K, N), one of them 1; scale f32, N values (scale_per_k == 0) or K
// values (scale_per_k == 1), contiguous; out (M, N) row-major in x's
// dtype.  dtype: 0 = f32, 1 = bf16.  route: 0 skinny (M <= 16), 1
// tensor_core (bf16, KN, per-N scale, K % 8 == 0, 16-byte aligned rows),
// 2 cuda_core_tile, 3 skinny_tc (bf16, M <= 16, K % 8 == 0, 16-byte
// aligned rows and per-K scale); a route whose conditions do not hold is
// refused.
// skinny_tc only: its k steps (16 k for KN, 64 for NK) run in n_ks
// splits of `per` steps, with, for n_ks > 1, ws holding ceil(N / cols)
// * n_ks * M * cols floats (cols 128 for KN, 64 for NK) and tickets
// ceil(N / cols) zeroed counters (left zeroed).  Returns the cudaError_t
// of the launch (0 on success).
int int8_matmul(const void* x, const void* w_q, const float* scale,
                void* out, void* ws, void* tickets, int M, int N, int K,
                long long swk, long long swn, int scale_per_k, int dtype,
                int route, int n_ks, int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K == 0) return (int)cudaErrorInvalidValue;
  bool kn;
  long long w_row;
  if (swn == 1) { kn = true; w_row = swk; }
  else if (swk == 1) { kn = false; w_row = swn; }
  else return (int)cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(w_q);
  if (route == kTensorCore) {
    if (dtype != 1 || !kn || scale_per_k) return (int)cudaErrorInvalidValue;
    return launch_tc(static_cast<const __nv_bfloat16*>(x), w, scale,
                     static_cast<__nv_bfloat16*>(out), M, N, K, w_row, s);
  }
  if (route == kSkinnyTc) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_skinny_tc(static_cast<const __nv_bfloat16*>(x), w, scale,
                            static_cast<__nv_bfloat16*>(out),
                            static_cast<float*>(ws),
                            static_cast<unsigned*>(tickets), M, N, K, kn,
                            w_row, scale_per_k != 0, n_ks, per, s);
  }
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   w_row % 16 == 0;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                    K % 8 == 0;
  if (dtype == 0)
    return launch<float>(x, w, scale, out, M, N, K, kn, w_row,
                         scale_per_k != 0, vec, xvec, route, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, out, M, N, K, kn, w_row,
                                 scale_per_k != 0, vec, xvec, route, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
