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
//   0 skinny          M <= 16 with f32 x.  Bound by the bytes of w_q
//                     (each weight byte feeds 2 M flops) in principle,
//                     by the CUDA cores' int-to-float conversion and M
//                     FMAs per weight byte in practice: w_q is streamed
//                     once with 16-byte loads per lane, kept packed in
//                     registers, up to 8 rows of x in registers.  f32
//                     stays here: on the tensor cores it would be TF32.
//   3 skinny_tc       bf16 x, M <= 16, KN or NK, either scale, weight
//                     rows of any stride and alignment: decode and the
//                     heads of a bf16 model.  The same bytes on the tensor
//                     cores (mma.sync with A and B swapped, the weight as
//                     A), in one wave with the weight in flight from the
//                     start through a TMA ring, the K split of a column
//                     tile summed in a thread block cluster; see skinny_tc
//                     below.
//   1 tensor_core     bf16 x, M > 16, KN, per-N scale, K % 8 == 0,
//                     N % 8 == 0, 16-byte rows: the prefill projections.
//                     Bound by operations (989 TFLOP/s bf16 on the tensor
//                     cores).  out^T = (w_q s)^T x^T on wgmma with the
//                     int8 weight widened into its register A operand, a
//                     persistent grid, TMA in and out; see tc_mm below.
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

// ---- int8 -> bf16 fragments, shared by the two tensor-core routes ---- //
// Value e of the sign-flipped word v (v = word ^ 0x80808080), exactly, as
// an f32: 2^23 + (b + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t v, int e) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + e)) -
         8388736.f;
}

// Two integer-valued f32 (|f| <= 128: their low 16 bits are 0) as a
// bf16x2, f0 in the low half: their high halves, exactly.
__device__ __forceinline__ uint32_t pk(float f0, float f1) {
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The A fragments (m16n8k16's, and each warp's share of wgmma's register
// A) of two 16-row tiles from four words of int8, read at the k rows 2t,
// 2t + 1, 2t + 8, 2t + 9 of a k16 step (t = lane % 4), four consecutive
// output channels n + 0..3 a word.  Channel n + 2b + h is row g + 8h of
// tile b (g = lane / 4): the tiles' rows are a permutation of n that the
// caller undoes when it stores the result.
__device__ __forceinline__ void widen_kn(const uint32_t (&u)[4],
                                         uint32_t (&a)[2][4]) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = u[j] ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[b][h] = pk(i8f(v[0], 2 * b + h), i8f(v[1], 2 * b + h));
      a[b][2 + h] = pk(i8f(v[2], 2 * b + h), i8f(v[3], 2 * b + h));
    }
}

// The A fragment of one 16-row tile from a word of int8 in each of its
// rows g and g + 8, four consecutive k (4t..4t+3) a word, taken as the
// fragment's k 2t, 2t + 1, 2t + 8, 2t + 9: a k order that the B fragment
// (x, from the same four k) repeats.
__device__ __forceinline__ void widen_nk(uint32_t u0, uint32_t u8,
                                         uint32_t (&a)[4]) {
  const uint32_t v0 = u0 ^ 0x80808080u, v8 = u8 ^ 0x80808080u;
  a[0] = pk(i8f(v0, 0), i8f(v0, 1));
  a[1] = pk(i8f(v8, 0), i8f(v8, 1));
  a[2] = pk(i8f(v0, 2), i8f(v0, 3));
  a[3] = pk(i8f(v8, 2), i8f(v8, 3));
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

// ---- skinny_tc: bf16 x, M <= 16, on the tensor cores ---------------- //
// mma.sync m16n8k16 with A and B swapped: the weight is A (16 output
// channels a tile), x is B (its <= 8 rows the MMA's n = 8; two B tiles
// for M up to 16).  At M <= 16 the weight is the only operand of size:
// wgmma's 64-row minimum would buy nothing, and the bound is its bytes.
//
// One wave with the bytes in flight from the start.  A CTA owns a column
// tile (COLS output channels) and a range of `per` stages of its K; a
// stage is 64 weight rows of 128 bytes (KN: 64 k x 128 n; NK: 64 n x 128
// k) with the x rows (and per-K scales) of its k.  The producer warp
// issues the copies of every stage the ring holds at once (kStRing
// stages, up to ~112 KB of weight an SM; kStRingPair where two CTAs
// share an SM), then refills each stage as the consumers free it.  On
// 16-byte aligned weight rows (row stride % 16 == 0, an aligned pointer)
// a stage's weight is one TMA tile with the 128-byte swizzle.  Rows of
// any other stride (the untied heads: 32001- or 256206-byte rows, or an
// offset view) start at offsets that repeat every P rows (StMaps): one
// tensor map a residue class reads the rows of the class, from the
// 16-byte boundary below, as one box a stage, and the consumers realign
// each 4-byte word with a funnel shift (a copy per row, or 16-byte
// cp.async per lane, read the same heads at a third of the rate: too
// many small requests).  x and the per-K scale come by TMA (zero past M
// and K); the wrapper copies an x whose rows are no whole number of
// 16-byte vectors, or a per-K scale off a 16-byte boundary, first.
//
// Eight consumer warps: warp w takes 32 (KN) or 16 (NK) of the tile's
// channels, w % 4, and every other k16 step of a stage, w / 4; its
// 4-byte shared loads give four channels at one k (KN: widen_kn, two
// MMA tiles a k16 step) or four k of one channel (NK: widen_nk), and are
// widened exactly to bf16 in registers.  A per-N scale multiplies the
// f32 sum once at the end.  A per-K scale (the tied head's, one per d)
// cannot, so it is folded into x: x * s in f32, split into two bf16
// terms, hi = bf16(x s) and lo = bf16(x s - hi), each multiplied by the
// exact bf16 weight on the tensor cores (one more MMA per tile and step,
// the same weight fragment).  hi alone, one rounding of x s to bf16,
// strays from the plain f32 product by up to 2^-9 of each term, ~0.03
// in an output near 0 at K = 2048: past the 2e-2 tolerance the route is
// held to.  hi + lo carries x s to ~2^-17, so the route differs from the
// plain version only in the order of its f32 sums
// (tests/test_torch_kernels.py emulates the split).
//
// The K split: small N cannot fill 132 SMs with column tiles alone
// (2048 -> 2048: 16 tiles of 128), so the `cluster` CTAs of a column
// tile (ops.int8_skinny_tc_splits: up to 8) form a thread block cluster,
// each over its own k stages.  Their f32 partials meet in distributed
// shared memory: each CTA stores its partial of rank q's slice of the
// columns into q's inbox, and after one cluster barrier each rank sums
// its inbox in rank order, so no partial goes to device memory, no
// ticket is taken, and the bits are the same at every launch.  With no
// split (as many tiles as a wave holds, or more: the heads), the CTAs of
// the one wave (two an SM where the tiles outnumber the SMs) walk the
// column tiles in turn while the producer streams on.  Each output's per-N scale is loaded at its tile's start, off the
// epilogue's path.
//
// Bound: the bytes of w_q, each read once (K N bytes; x, the scale and
// the output are a few KB), over 3.35 TB/s.  Per weight byte the kernel
// spends ~3 instructions widening it and 2 M / 256 of an MMA.
constexpr int kStConsumers = 8;
constexpr int kStThreads = 32 * (kStConsumers + 1);
constexpr int kStRows = 64;           // weight rows a stage
constexpr int kStPitch = 160;  // an unaligned row: 128 + its offset (< 16),
                               // each class's box 128-byte aligned
constexpr uint32_t kStXBytes = 4096;  // x: up to 16 rows x 128 k x 2 B
constexpr uint32_t kStWBytes = kStRows * kStPitch;
constexpr uint32_t kStSBytes = 512;   // the per-K scale of 128 k
constexpr uint32_t kStStage = 15360;  // x | w | scale, a multiple of 1024
constexpr int kStRing = 14;
// the ring where two CTAs an SM must fit: a clustered launch (clusters of
// up to 8 then pack one wave of 128 CTAs into 132 SMs; at the full ring,
// one CTA an SM, eight-CTA clusters pack only 15 = 120 CTAs) and a grid
// of more CTAs than SMs (the heads: two CTAs an SM stream the weight
// faster than one with twice the ring)
constexpr int kStRingPair = 6;
// the k groups' partials: KN one [16][128 + 4] f32, NK three [16][64 + 4]
constexpr uint32_t kStRed = 3 * 16 * (64 + 4) * 4;
// a cluster's inbox: [cluster][16][cw] f32 of this CTA's column slice,
// cw = ceil(COLS / cluster): at most 16 x 135 floats
constexpr uint32_t kStInbox = 16 * 136 * 4;
static_assert(kStXBytes + kStWBytes + kStSBytes <= kStStage, "stage");

// KN: a tile of 128 channels, 64 k a stage; NK: 64 channels, 128 k.
template <bool KN> struct StGeom;
template <> struct StGeom<true> {
  static constexpr int COLS = 128, STAGE_K = 64, XBOXES = 1;
};
template <> struct StGeom<false> {
  static constexpr int COLS = 64, STAGE_K = 128, XBOXES = 2;
};

// The ring of a launch of `ctas` CTAs (a cluster of `cluster` a tile, or
// walking `tiles`), each streaming `per` stages of a tile, on n_sm SMs.
constexpr int st_ring(int cluster, int per, int tiles, int ctas, int n_sm) {
  const long long streamed = (long long)per * ((tiles + ctas - 1) / ctas);
  const int cap = cluster > 1 || ctas > n_sm ? kStRingPair : kStRing;
  return streamed < cap ? (int)streamed : cap;
}

// The SM count of the current device, found once a process and device.
inline int st_sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

__host__ __device__ constexpr size_t st_smem_bytes(int ring, int cluster) {
  return 1024 + (size_t)ring * kStStage + kStRed +
         (cluster > 1 ? kStInbox : 0) + 16 * (size_t)ring;
}

// Word `off` (a multiple of 4) of weight row `row` of a stage: swizzled
// as TMA lands a 128-byte-row tile; or, for unaligned rows, in the box of
// the row's residue class (row % P: rows of one class share their offset
// `delta` within a 16-byte aligned span, see StMaps), kStPitch bytes a
// row, realigned with a funnel shift.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t st_word(const uint8_t* wbuf, int row,
                                            int off, uint32_t delta,
                                            int log2p) {
  if constexpr (ALIGNED) {
    return *reinterpret_cast<const uint32_t*>(
        wbuf + row * 128 + (((off >> 4) ^ (row & 7)) << 4) + (off & 15));
  } else {
    const int srow = ((row & ((1 << log2p) - 1)) << (6 - log2p)) +
                     (row >> log2p);
    const uint32_t b = srow * kStPitch + delta + off;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(wbuf + (b & ~3u));
    return __funnelshift_r(p[0], p[1], (b & 3u) * 8);
  }
}

// The weight's tensor maps.  Aligned rows: m[0], 128-byte boxes with the
// 128-byte swizzle.  Rows of a stride R that is no multiple of 16 start
// at offsets that repeat with period P = 16 / gcd(R, 16); the rows of
// residue r (r + P j) lie a multiple of 16 bytes apart, so m[r] maps them
// from the 16-byte boundary below row r (stride P R, kStPitch-byte boxes
// of 64 / P rows), each row landing `delta` bytes into its box row.  A
// pointer off a 16-byte boundary with aligned rows is P = 1.
struct StMaps {
  CUtensorMap m[16];
};

struct StArgs {
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* out;
  int M, N, K;
  long long w_row;
  int per, ring;   // stages a CTA's split, ring stages in use
  int log2p;       // unaligned rows: log2 of their period P
};

template <bool KN, int MT, bool PER_K, bool ALIGNED>
__global__ void __launch_bounds__(kStThreads, 1) skinny_tc(
    const __grid_constant__ StMaps wm,
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_s, const StArgs a) {
  using namespace repro;
  using G = StGeom<KN>;
  constexpr int COLS = G::COLS, STAGE_K = G::STAGE_K;
  constexpr uint32_t XBOX = MT * 8 * 128;   // one x box: MT*8 rows x 64 k
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw_base);
  const int ring = a.ring;
  const uint32_t red = base + ring * kStStage;
  float* const red_p = reinterpret_cast<float*>(gbase + ring * kStStage);
  const int cluster = gridDim.x;
  const uint32_t inbox = red + kStRed;
  float* const inbox_p = red_p + kStRed / 4;
  const uint32_t bars = inbox + (cluster > 1 ? kStInbox : 0);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ring + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_stages = (a.K + STAGE_K - 1) / STAGE_K;
  const int s_lo = blockIdx.x * a.per;
  const int s_hi = min(s_lo + a.per, n_stages);
  const int tiles = (a.N + COLS - 1) / COLS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kStConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // this CTA has started: the others may write its inbox (after their
  // matching wait)
  if (cluster > 1) cluster_arrive_relaxed();

  if (warp == kStConsumers) {   // the producer warp
    if (lane == 0) {
      for (int r = 0; r < (1 << a.log2p); ++r) tma_prefetch(&wm.m[r]);
      tma_prefetch(&tm_x);
      if constexpr (PER_K) tma_prefetch(&tm_s);
    }
    const uint32_t wlo = (uint32_t)reinterpret_cast<uintptr_t>(a.w);
    const uint32_t xs_bytes =
        G::XBOXES * XBOX + (PER_K ? STAGE_K * 4 : 0);
    int it = 0;
    for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
      const int n0 = tile * COLS;
      for (int st = s_lo; st < s_hi; ++st, ++it) {
        const int slot = it % ring;
        if (it >= ring) mbar_wait(empty(slot), (it / ring - 1) & 1);
        const uint32_t sb = base + slot * kStStage;
        const int k0 = st * STAGE_K;
        if (lane == 0) {
          if constexpr (ALIGNED) {
            mbar_arrive_expect_tx(full(slot), kStRows * 128 + xs_bytes);
            tma_load_2d(sb + kStXBytes, &wm.m[0], full(slot), KN ? n0 : k0,
                        KN ? k0 : n0);
          } else {
            // a box of each residue class with rows in this stage
            const int row0 = KN ? k0 : n0, nrows = KN ? a.K : a.N;
            const int P = 1 << a.log2p, box = kStRows >> a.log2p;
            const int classes = min(P, nrows - row0);
            mbar_arrive_expect_tx(full(slot),
                                  classes * box * kStPitch + xs_bytes);
            for (int r = 0; r < classes; ++r)
              tma_load_2d(sb + kStXBytes + r * box * kStPitch, &wm.m[r],
                          full(slot), KN ? n0 : k0, row0 >> a.log2p);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < G::XBOXES; ++c)
            tma_load_2d(sb + c * XBOX, &tm_x, full(slot), k0 + 64 * c, 0);
          if constexpr (PER_K)
            tma_load_1d(sb + kStXBytes + kStWBytes, &tm_s, full(slot), k0);
        }
        __syncwarp();
      }
    }
    if (cluster > 1) {   // the consumers' cluster barriers
      cluster_wait();
      cluster_sync();
    }
    return;
  }

  // the consumers: warp w takes channels cg (KN: 32 of 128; NK: 32 of
  // 64, two MMA tiles either way) and k group `grp` of the stage's k16
  // steps (KN: 2 groups of 2 of 4; NK: 4 groups of 2 of 8), so that each
  // x fragment (and per-K split) serves two weight tiles
  constexpr int GROUPS = KN ? 2 : 4;
  constexpr int RED_PITCH = COLS + 4;
  const int cg = KN ? warp % 4 : warp % 2, grp = KN ? warp / 4 : warp / 2;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t wlo = (uint32_t)reinterpret_cast<uintptr_t>(a.w);
  const uint32_t wrow = (uint32_t)a.w_row;
  constexpr int NT = 2;   // MMA tiles a warp
  int it = 0;
  // the output column of this thread: fixed for a tile (256 threads over
  // [rows][COLS] or, in a cluster, this rank's [rows][cw] slice)
  const int cw = (COLS + cluster - 1) / cluster;
  const int out_col = cluster == 1 ? threadIdx.x % COLS
                                   : blockIdx.x * cw + threadIdx.x % cw;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int n0 = tile * COLS;
    // its per-N scale, loaded now so that the epilogue waits on nothing
    const float out_scale = !PER_K && out_col < COLS && n0 + out_col < a.N
                                ? a.scale[n0 + out_col] : 1.f;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;

    for (int st = s_lo; st < s_hi; ++st, ++it) {
      const int slot = it % ring;
      mbar_wait(full(slot), (it / ring) & 1);
      const uint8_t* sx = gbase + slot * kStStage;
      const uint8_t* sw = sx + kStXBytes;
      const float* ss = reinterpret_cast<const float*>(sw + kStWBytes);
      const int k0 = st * STAGE_K;
      if constexpr (KN) {
        // k16 steps grp and grp + 2; rows 16 kk + 2t (+1, +8, +9), the
        // words of channels 32 cg + 4 g .. + 3
        uint32_t u[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = 16 * (grp + 2 * h) + 2 * t4;
          const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t delta =
                ALIGNED ? 0u
                        : (wlo + (uint32_t)(k0 + rows[j]) * wrow +
                           (uint32_t)n0) & 15u;
            u[h][j] = st_word<ALIGNED>(sw, rows[j], 32 * cg + 4 * g, delta,
                                       a.log2p);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = grp + 2 * h;
          uint32_t af[2][4];
          widen_kn(u[h], af);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int m = g + 8 * mt;
            const uint8_t* xr = sx + m * 128;
            uint2 xb;
            xb.x = *reinterpret_cast<const uint32_t*>(
                xr + (((2 * kk) ^ (m & 7)) << 4) + 4 * t4);
            xb.y = *reinterpret_cast<const uint32_t*>(
                xr + (((2 * kk + 1) ^ (m & 7)) << 4) + 4 * t4);
            if constexpr (PER_K) {
              const float2 s01 = *reinterpret_cast<const float2*>(
                  ss + 16 * kk + 2 * t4);
              const float2 s89 = *reinterpret_cast<const float2*>(
                  ss + 16 * kk + 2 * t4 + 8);
              uint2 hi, lo;
              split_xs(xb, make_float4(s01.x, s01.y, s89.x, s89.y), hi, lo);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                mma_bf16_16816(acc[mt][i], af[i], hi.x, hi.y);
                mma_bf16_16816(acc[mt][i], af[i], lo.x, lo.y);
              }
            } else {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                mma_bf16_16816(acc[mt][i], af[i], xb.x, xb.y);
            }
          }
        }
      } else {
        // tiles of channels 32 cg + 16 i + g and + 8 (i = 0, 1), k16
        // steps grp and grp + 4: the word of k 16 j + 4t .. + 3 of each
        uint32_t u[2][2][2];   // [step][tile][row g, g + 8]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 32 * cg + 16 * i + g + 8 * r;
            const uint32_t delta =
                ALIGNED ? 0u
                        : (wlo + (uint32_t)(n0 + row) * wrow +
                           (uint32_t)k0) & 15u;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              u[h][i][r] = st_word<ALIGNED>(
                  sw, row, 16 * (grp + 4 * h) + 4 * t4, delta, a.log2p);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = grp + 4 * h;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) widen_nk(u[h][i][0], u[h][i][1], af[i]);
          const int kb = 16 * (j & 3) + 4 * t4;   // k within its x box
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int m = g + 8 * mt;
            const int chunk = (2 * kb) >> 4;
            const uint2 xb = *reinterpret_cast<const uint2*>(
                sx + (j >> 2) * XBOX + m * 128 +
                ((chunk ^ (m & 7)) << 4) + ((2 * kb) & 15));
            if constexpr (PER_K) {
              const float4 s = *reinterpret_cast<const float4*>(
                  ss + 16 * j + 4 * t4);
              uint2 hi, lo;
              split_xs(xb, s, hi, lo);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                mma_bf16_16816(acc[mt][i], af[i], hi.x, hi.y);
                mma_bf16_16816(acc[mt][i], af[i], lo.x, lo.y);
              }
            } else {
#pragma unroll
              for (int i = 0; i < 2; ++i)
                mma_bf16_16816(acc[mt][i], af[i], xb.x, xb.y);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
    }

    // the k groups meet in shared memory (groups 1.. store, group 0 adds
    // them in group order): the CTA's partial, [m][channel] f32 in slot 0.
    // The accumulator fragment: c0, c1 are MMA row g, c2, c3 row g + 8,
    // at columns (x rows) 2t, 2t + 1.
    auto red_at = [&](int mt, int i, int c) {
      const int m = 8 * mt + 2 * t4 + (c & 1);
      const int col = KN ? 32 * cg + 4 * g + 2 * i + (c >> 1)
                         : 32 * cg + 16 * i + g + 8 * (c >> 1);
      return m * RED_PITCH + col;
    };
    constexpr int SLOT = 16 * RED_PITCH;
    named_bar_sync(1, 32 * kStConsumers);   // the last tile's readers
    if (grp > 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red_p[(grp - 1) * SLOT + red_at(mt, i, c)] = acc[mt][i][c];
    named_bar_sync(1, 32 * kStConsumers);
    if (grp == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int at = red_at(mt, i, c);
            float v = acc[mt][i][c];
#pragma unroll
            for (int q = 0; q < GROUPS - 1; ++q) v += red_p[q * SLOT + at];
            red_p[at] = v;
          }
    named_bar_sync(1, 32 * kStConsumers);

    const int rows = min(a.M, MT * 8);
    if (cluster == 1) {
      for (int idx = threadIdx.x; idx < rows * COLS;
           idx += 32 * kStConsumers) {   // idx % COLS == out_col
        const int m = idx / COLS, col = idx % COLS, n = n0 + col;
        if (n < a.N) {
          const float v = red_p[m * RED_PITCH + col];
          a.out[(size_t)m * a.N + n] = __float2bfloat16(v * out_scale);
        }
      }
    } else {
      // rank q owns columns [q cw, q cw + cw): each CTA stores its partial
      // of them into q's inbox, row `rank`, and after one cluster barrier
      // each rank sums its inbox over ranks 0, 1, ... in order
      const int rank = blockIdx.x;
      cluster_wait();   // every CTA has started
      for (int idx = threadIdx.x; idx < rows * COLS;
           idx += 32 * kStConsumers) {
        const int m = idx / COLS, col = idx % COLS;
        const int q = col / cw, c = col % cw;
        st_cluster_f32(cluster_map(inbox + 4u * ((rank * 16 + m) * cw + c),
                                   (uint32_t)q),
                       red_p[m * RED_PITCH + col]);
      }
      cluster_sync();
      for (int idx = threadIdx.x; idx < rows * cw;
           idx += 32 * kStConsumers) {
        const int m = idx / cw, c = idx % cw, col = rank * cw + c;
        const int n = n0 + col;
        if (col < COLS && n < a.N) {
          float v = 0.f;
          for (int r = 0; r < cluster; ++r)
            v += inbox_p[(r * 16 + m) * cw + c];
          // col == out_col but where 256 is no multiple of cw (3, 5-7)
          const float sc = PER_K ? 1.f : col == out_col ? out_scale
                                                        : a.scale[n];
          a.out[(size_t)m * a.N + n] = __float2bfloat16(v * sc);
        }
      }
    }
  }
}

// The maps and the launch.  Needs M <= 16, x 16-byte aligned with rows
// of ldx % 8 == 0 elements (ldx >= K), a 16-byte aligned per-K scale, a
// split of the stages into `cluster` (1-8) ranges of `per` that leaves
// none empty, and, with a cluster, one column tile a cluster (`ctas` the
// tile count); without, `ctas` CTAs walk the tiles.
int launch_skinny_tc(const __nv_bfloat16* x, const int8_t* w,
                     const float* scale, __nv_bfloat16* out, int M, int N,
                     int K, long long ldx, bool kn, long long w_row,
                     bool scale_per_k, int cluster, int per, int ctas,
                     cudaStream_t stream) {
  const int cols = kn ? StGeom<true>::COLS : StGeom<false>::COLS;
  const int stage_k = kn ? StGeom<true>::STAGE_K : StGeom<false>::STAGE_K;
  const int n_stages = (K + stage_k - 1) / stage_k;
  const int tiles = (N + cols - 1) / cols;
  if (M > 16 || ldx % 8 || ldx < K ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      (scale_per_k && reinterpret_cast<uintptr_t>(scale) % 16) ||
      cluster < 1 || cluster > 8 || per < 1 ||
      (long long)cluster * per < n_stages ||
      (long long)(cluster - 1) * per >= n_stages || ctas < 1 ||
      ctas > tiles || (cluster > 1 && ctas != tiles))
    return (int)cudaErrorInvalidValue;
  const bool aligned = w_row % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int mt = M <= 8 ? 1 : 2;
  const int nrows = kn ? K : N, ncols = kn ? N : K;
  StMaps wm = {};
  CUtensorMap tm_x, tm_s;
  int log2p = 0;
  if (aligned) {
    if (!repro::tensor_map(&wm.m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w,
                           ncols, nrows, (uint64_t)w_row, 128, kStRows,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  } else {
    const int rem = (int)(w_row % 16);   // P = 16 / gcd(R, 16)
    log2p = rem == 0 ? 0 : rem % 2 ? 4 : rem % 4 ? 3 : rem % 8 ? 2 : 1;
    // a class's rows no closer than its shifted width (an aligned stride
    // on an unaligned pointer: every other row)
    while (log2p < 4 && ((long long)w_row << log2p) < ncols + 16) ++log2p;
    const int P = 1 << log2p;
    for (int r = 0; r < P && r < nrows; ++r) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(w + r * w_row);
      const uint64_t delta = at % 16;
      if (!repro::tensor_map(&wm.m[r], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                             reinterpret_cast<const void*>(at - delta),
                             ncols + delta, (nrows - r + P - 1) / P,
                             (uint64_t)(P * w_row), kStPitch,
                             kStRows >> log2p, CU_TENSOR_MAP_SWIZZLE_NONE))
        return (int)cudaErrorInvalidValue;
    }
  }
  if (!repro::tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M,
                         (uint64_t)ldx * 2, 64, 8 * mt,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  if (scale_per_k) {
    if (!repro::tensor_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, scale,
                           K, 1, 16, stage_k, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  } else {
    tm_s = CUtensorMap{};
  }
  const int ring = st_ring(cluster, per, tiles, ctas, st_sm_count());
  const size_t smem = st_smem_bytes(ring, cluster);
  const StArgs args{w, scale, out, M, N, K, w_row, per, ring, log2p};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, ctas);
  cfg.blockDim = dim3(kStThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the kernels' attributes, once a process and device
  static bool attr_set[64][16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  auto go = [&](auto kernel, int variant) -> int {
    if (dev < 64 && !attr_set[dev][variant]) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)st_smem_bytes(kStRing, 1));
      if (e != cudaSuccess) return (int)e;
      attr_set[dev][variant] = true;
    }
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, wm, tm_x, tm_s, args);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  };
#define REPRO_ST(KN, MT, PK, AL)                                            \
  return go(skinny_tc<KN, MT, PK, AL>,                                      \
            (KN) * 8 + ((MT) - 1) * 4 + (PK) * 2 + (AL))
#define REPRO_ST_AL(KN, MT, PK)                                             \
  if (aligned) { REPRO_ST(KN, MT, PK, true); } else { REPRO_ST(KN, MT, PK, false); }
#define REPRO_ST_PK(KN, MT)                                                 \
  if (scale_per_k) { REPRO_ST_AL(KN, MT, true) } else { REPRO_ST_AL(KN, MT, false) }
#define REPRO_ST_MT(KN)                                                     \
  if (mt == 1) { REPRO_ST_PK(KN, 1) } else { REPRO_ST_PK(KN, 2) }
  if (kn) { REPRO_ST_MT(true) } else { REPRO_ST_MT(false) }
  return (int)cudaErrorInvalidValue;   // not reached
#undef REPRO_ST_MT
#undef REPRO_ST_PK
#undef REPRO_ST_AL
#undef REPRO_ST
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
// The product is computed transposed, out^T = (w_q s)^T x^T, so that the
// int8 weight is wgmma's A operand, fed from registers, and x is B, read
// by wgmma from shared memory: the widened weight is never written to
// shared memory, and no barrier couples the widening to the products
// (the structure of CUTLASS's Hopper mixed-input mainloop, written by
// hand here).
//
// A CTA tile is 128 channels (n) x BM rows of x (m: 256, 192 or 128,
// ops.int8_tensor_core_tile_m), K in stages of 64 through a ring of
// kTcStages stages; per
// stage, from a 1024-byte aligned base: the raw int8 weight as one TMA
// box of 64 k x 128 n and x as BM m x 64 k bf16 (K-major: wgmma's B
// without a transpose), both with the 128-byte swizzle.  Warp w of
// consumer warpgroup wg owns channels 64 wg + 16 w .. + 15, lane (g, t)
// the pair 2g, 2g + 1 of them (rows g and g + 8 of the warp's slice of
// the m64 A operand): four 2-byte shared loads, at k rows 2t, 2t + 1,
// 2t + 8, 2t + 9 of a k16 step (the swizzle spreads a warp's loads over
// 16 banks, two lanes a word), are widened exactly (widen_pair) into the
// A fragment of one wgmma m64nBMk16.  The widening is ALU work that does
// not overlap the tensor cores (measured: it adds its own time), so the
// tile is as wide along m as the registers allow: each widened weight
// feeds BM rows of x.  Fragments are double-buffered across k16 steps,
// so that the next step's loads and widening are issued while this
// step's product is in flight; a register an async wgmma reads stays
// untouched until the wgmma_wait that retires it (fence_frag).
//
// A persistent grid: one CTA an SM walks the output tiles in a static
// order (m fastest, so that CTAs in flight share weight tiles), and the
// producer warp (setmaxnreg.dec) runs on into the next tile's stages
// while the consumers finish this one.  The epilogue scales each
// accumulator row (a channel) by its channel's scale, stores the bf16
// tile transposed back to (m, n) through shared memory (a [BM][64] block
// a warpgroup, swizzled; 4-byte stores of a channel pair) and writes it
// with a TMA store, which writes nothing past M or N.  TMA's zero fill
// covers the ragged edges of M, N and K.
//
// Bound: operations, 2 M N K over 989 TFLOP/s (bf16); int8 values are
// exact in bf16, so the route differs from the plain version only in the
// order of its f32 sums.
constexpr int kTcBN = 128, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 384;
constexpr uint32_t kTcW = kTcBK * kTcBN;   // 64 k x 128 n int8

template <int BM> struct TcGeom {
  static constexpr uint32_t X = BM * kTcBK * 2;        // BM x 64 bf16
  static constexpr uint32_t STAGE = kTcW + X;
  static constexpr uint32_t OUT = BM * 128;            // a WG's [BM][64]
  static constexpr size_t SMEM =
      1024 + (size_t)kTcStages * STAGE + 2 * OUT + 16 * kTcStages;
};

// Widen the weight pair of a k16 step: raw[j] holds channels (n, n + 1)
// at k rows 2t, 2t + 1, 2t + 8, 2t + 9 in its low 16 bits; a[0] / a[1]
// are rows g / g + 8 (channels n / n + 1) at k 2t, 2t + 1, a[2] / a[3]
// the same at 2t + 8, 2t + 9.
__device__ __forceinline__ void widen_pair(const uint32_t (&raw)[4],
                                           uint32_t (&a)[4]) {
  const uint32_t v01 = __byte_perm(raw[0], raw[1], 0x5410) ^ 0x80808080u;
  const uint32_t v89 = __byte_perm(raw[2], raw[3], 0x5410) ^ 0x80808080u;
  a[0] = pk(i8f(v01, 0), i8f(v01, 2));
  a[1] = pk(i8f(v01, 1), i8f(v01, 3));
  a[2] = pk(i8f(v89, 0), i8f(v89, 2));
  a[3] = pk(i8f(v89, 1), i8f(v89, 3));
}

template <int BM>
__global__ void __launch_bounds__(kTcThreads, 1) tc_mm(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_o,
    const float* __restrict__ scale, int M, int N, int K) {
  using namespace repro;
  using G = TcGeom<BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw_base);
  const uint32_t obase = base + kTcStages * G::STAGE;
  const uint32_t bars = obase + 2 * G::OUT;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTcStages + s); };
  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + kTcBN - 1) / kTcBN);
  const int nk = (K + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);      // the producer + its bytes
      mbar_init(empty(s), 2);     // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {   // the producer: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch(&tm_w);
      tma_prefetch(&tm_x);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * kTcBN;
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % kTcStages;
          if (it >= kTcStages) mbar_wait(empty(s), (it / kTcStages - 1) & 1);
          const uint32_t st = base + s * G::STAGE;
          mbar_arrive_expect_tx(full(s), G::STAGE);
          tma_load_2d(st, &tm_w, full(s), n0, i * kTcBK);
          tma_load_2d(st + kTcW, &tm_x, full(s), i * kTcBK, m0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tw = threadIdx.x % 128, w = tw / 32, l = tw % 32;
  const int g = l / 4, t4 = l % 4;
  // this lane's channel pair: bytes 2g, 2g + 1 of 16-byte chunk 4 wg + w
  // of a row, swizzled by the row (k rows 2t and 2t + 8 share a phase,
  // as do 2t + 1 and 2t + 9)
  const int c16 = 4 * wg + w;
  const int off0 = ((c16 ^ ((2 * t4) & 7)) << 4) + 2 * g;
  const int off1 = ((c16 ^ ((2 * t4 + 1) & 7)) << 4) + 2 * g;
  float acc[BM / 2];
  uint32_t frag[2][4];   // [k16 step parity][register]
  uint32_t raw[4];

  // the raw weight pairs of k16 step kk of stage s
  auto load_raw = [&](int s, int kk) {
    const uint8_t* box = gbase + s * G::STAGE + (16 * kk + 2 * t4) * 128;
    raw[0] = *reinterpret_cast<const uint16_t*>(box + off0);
    raw[1] = *reinterpret_cast<const uint16_t*>(box + 128 + off1);
    raw[2] = *reinterpret_cast<const uint16_t*>(box + 8 * 128 + off0);
    raw[3] = *reinterpret_cast<const uint16_t*>(box + 9 * 128 + off1);
  };

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * kTcBN;
    const int n = n0 + 64 * wg + 16 * w + 2 * g;   // this lane's pair
    const float sc0 = n < N ? scale[n] : 0.f;
    const float sc1 = n + 1 < N ? scale[n + 1] : 0.f;

    mbar_wait(full(it % kTcStages), (it / kTcStages) & 1);
    load_raw(it % kTcStages, 0);
    widen_pair(raw, frag[0]);
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % kTcStages;
      const uint32_t xs = base + s * G::STAGE + kTcW;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int cur = kk & 1;
        wgmma_fence();
        wgmma_rs<BM, 0>(acc, frag[cur], smem_desc(xs + kk * 32, 16, 1024, 1),
                        i > 0 || kk > 0);
        wgmma_commit();
        // the next step's raw pairs: in this stage, or in the next one
        const bool more = kk < 3 || i + 1 < nk;
        if (kk < 3) {
          load_raw(s, kk + 1);
        } else if (more) {
          const int sn = (it + 1) % kTcStages;
          mbar_wait(full(sn), ((it + 1) / kTcStages) & 1);
          load_raw(sn, 0);
        }
        // the previous step's product is done: its fragment is free, and
        // after a stage's first step the last stage is released
        wgmma_wait<1>();
        fence_acc(acc);
        fence_frag(frag);
        if (kk == 0 && i > 0 && tw == 0)
          mbar_arrive(empty((it - 1) % kTcStages));
        if (more) widen_pair(raw, frag[cur ^ 1]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(frag);
    if (tw == 0) mbar_arrive(empty((it - 1) % kTcStages));

    // epilogue: value 4j + 2h + e is channel n + h, row of x 8j + 2t + e;
    // a channel pair a row is one 4-byte store into the warpgroup's
    // [BM][64] out block, swizzled as TMA stores it
    const uint32_t ob = obase + wg * G::OUT;
    if (tw == 0) bulk_wait_read<0>();   // the last tile's store read it
    named_bar_sync(1 + wg, 128);
    const int oc = 2 * w + (g >> 2);   // the pair's 16-byte chunk in a row
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t4 + e;
        st_shared_b32(ob + m * 128 + ((oc ^ (m & 7)) << 4) + 4 * (g & 3),
                      pack_bf16x2(acc[4 * j + e] * sc0,
                                  acc[4 * j + 2 + e] * sc1));
      }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tw == 0) {
      if (n0 + 64 * wg < N) tma_store_2d(&tm_o, ob, n0 + 64 * wg, m0);
      bulk_commit();
    }
  }
  if (tw == 0) bulk_wait<0>();
}

// The three tensor maps (cached while the pointers repeat) and the
// launch of at most `ctas` persistent CTAs (one an SM) of tiles BM rows
// of x tall (256, 192 or 128).  Needs K % 8 == 0, N % 8 == 0 (the output's
// rows for the TMA store), w_row % 16 == 0 and 16-byte aligned x, w_q and
// out.
template <int BM>
int launch_tc_bm(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                 __nv_bfloat16* out, int M, int N, int K, long long w_row,
                 int ctas, cudaStream_t stream) {
  using G = TcGeom<BM>;
  CUtensorMap tm_x, tm_w, tm_o;
  if (!repro::tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M,
                         (uint64_t)K * 2, kTcBK, BM,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !repro::tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, N, K,
                         (uint64_t)w_row, kTcBN, kTcBK,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
      !repro::tensor_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, N,
                         M, (uint64_t)N * 2, 64, BM,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool attr_set[64] = {};   // once a process and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        tc_mm<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) attr_set[dev] = true;
  }
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + kTcBN - 1) / kTcBN);
  const int grid = (int)(tiles < ctas ? tiles : ctas);
  tc_mm<BM><<<grid, kTcThreads, G::SMEM, stream>>>(tm_x, tm_w, tm_o, scale,
                                                     M, N, K);
  return (int)cudaGetLastError();
}

int launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
              __nv_bfloat16* out, int M, int N, int K, long long w_row,
              int bm, int ctas, cudaStream_t stream) {
  if (K % 8 || N % 8 || w_row % 16 || ctas < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (bm == 256)
    return launch_tc_bm<256>(x, w, scale, out, M, N, K, w_row, ctas, stream);
  if (bm == 192)
    return launch_tc_bm<192>(x, w, scale, out, M, N, K, w_row, ctas, stream);
  if (bm == 128)
    return launch_tc_bm<128>(x, w, scale, out, M, N, K, w_row, ctas, stream);
  return (int)cudaErrorInvalidValue;
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

// x (M, K) row-major, rows ldx elements apart (ldx == K but on
// skinny_tc, which takes ldx % 8 == 0, ldx >= K); w_q int8 with element
// strides (swk, swn) over (K, N), one of them 1; scale f32, N values
// (scale_per_k == 0) or K values (scale_per_k == 1), contiguous; out
// (M, N) row-major in x's dtype.  dtype: 0 = f32, 1 = bf16.  route: 0
// skinny (M <= 16), 1 tensor_core (bf16, KN, per-N scale, K % 8 == 0,
// N % 8 == 0, 16-byte aligned rows and pointers), 2 cuda_core_tile, 3
// skinny_tc (bf16, M <= 16, x 16-byte aligned, a 16-byte aligned per-K
// scale; weight rows of any stride and alignment); a route whose
// conditions do not hold is refused.  tensor_core: `ctas` persistent
// CTAs (at most one an SM).  skinny_tc: the k stages (64 k for KN, 128
// for NK) in `cluster` splits of `per` stages, a cluster of `cluster`
// CTAs a column tile (`ctas` the column tiles) or, with cluster 1, `ctas`
// CTAs walking the tiles.  Returns the cudaError_t of the launch (0 on
// success).
int int8_matmul(const void* x, const void* w_q, const float* scale,
                void* out, int M, int N, int K, long long swk, long long swn,
                long long ldx, int scale_per_k, int dtype, int route,
                int cluster, int per, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K == 0) return (int)cudaErrorInvalidValue;
  bool kn;
  long long w_row;
  if (swn == 1) { kn = true; w_row = swk; }
  else if (swk == 1) { kn = false; w_row = swn; }
  else return (int)cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(w_q);
  if (route == kSkinnyTc) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_skinny_tc(static_cast<const __nv_bfloat16*>(x), w, scale,
                            static_cast<__nv_bfloat16*>(out), M, N, K, ldx,
                            kn, w_row, scale_per_k != 0, cluster, per, ctas,
                            s);
  }
  if (ldx != K) return (int)cudaErrorInvalidValue;
  if (route == kTensorCore) {
    if (dtype != 1 || !kn || scale_per_k) return (int)cudaErrorInvalidValue;
    return launch_tc(static_cast<const __nv_bfloat16*>(x), w, scale,
                     static_cast<__nv_bfloat16*>(out), M, N, K, w_row, per,
                     ctas, s);
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

// CTAs of the skinny_tc kernel (route 3) the card holds at once for a
// launch of `ctas` CTAs in clusters of `cluster` (1-8), each streaming
// `per` stages of `tiles` column tiles (the ring, and so the shared
// memory, such a launch gets); 0 where the card cannot say (or the
// arguments are not a launch).
int int8_matmul_resident(int route, int cluster, int per, int tiles,
                         int ctas) {
  if (route != kSkinnyTc || cluster < 1 || cluster > 8 || per < 1 ||
      tiles < 1 || ctas < 1)
    return 0;
  const int ring = st_ring(cluster, per, tiles, ctas, st_sm_count());
  auto kernel = skinny_tc<true, 1, false, true>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)st_smem_bytes(kStRing, 1)) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 64);
  cfg.blockDim = dim3(kStThreads);
  cfg.dynamicSmemBytes = st_smem_bytes(ring, cluster);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return 0;
  return n * cluster;
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
