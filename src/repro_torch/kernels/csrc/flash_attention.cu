// Flash attention (prefill) for Hopper (sm_90a), CUDA C++, f32 softmax
// state and accumulation.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel (launched
// by flash_attention through pl.pallas_call).  GQA (query head h reads kv
// head h / G), causal or not, an optional static sliding window and an
// always-visible prefix; fully masked kv tiles are skipped with the same
// predicate as the Pallas kernel; online softmax (m, l, acc) in f32.
//
// What bounds it: operations.  A causal prefill does 4 * hd flops for
// every visible (query, key) pair of every head and reads each q, k, v
// element once, so at a prefill bucket of 1024 tokens it sits near or
// above the card's flops-per-byte balance: the least time is the larger
// of 4 * B * H * hd * (visible pairs) over 989 TFLOP/s (bf16 tensor
// cores) and the bytes of q, k, v and out over 3.35 TB/s.
//
// Layouts.  q (B, H, Sq, hd), k and v (B, K, Skv, hd) and out (B, H, Sq,
// hd) are strided views: the last dim contiguous, every other stride a
// whole number of 16-byte rows, k and v with the same strides.  That
// takes the (B, H, S, hd) views of the model's (B, S, H, hd) tensors in
// place, with no transposed copy, and writes the output into a (B, S, H,
// hd) buffer.
//
// The TPU grid's sequential kv axis becomes a loop inside one CTA per
// (64-row query tile, batch * head); the loop stops at the causal
// frontier and skips tiles wholly left of the window.  Ragged edges are
// masked in the kernel (the Pallas wrapper asserts Sq % block_q == 0, but
// prefill buckets are any power of two >= 8).  Two routes, chosen by the
// caller (kernels/ops.py, flash_attention_route) from the dtype:
//
//   tensor_core (bf16): the FlashAttention-2 structure on
//   mma.sync.m16n8k16 bf16 with f32 accumulators.  4 warps, each owning
//   16 query rows; Q is loaded once into registers as A fragments
//   (ldmatrix), passing through the second K/V buffer before that holds
//   a tile; K and V tiles of 64 rows stay bf16 in a swizzled (16-byte
//   chunk c of row r at c ^ f(r), so 8 rows at one chunk hit 8 bank
//   groups), double-buffered cp.async ring, the next tile's copy in
//   flight while this one computes.  64 KB of shared memory per CTA let
//   3 CTAs (12 warps) share an SM where the registers allow (hd <= 64;
//   hd 128 runs 2 without spilling), to hide the latency of each warp's
//   product-softmax-product chain.  At hd 256 a warp's output alone is
//   32 n8 tiles, 128 f32 registers a thread, and its Q fragments 64 more:
//   held together they pass ptxas' 255.  So at hd 256 Q stays in a
//   shared tile of its own and each k16 step reloads its fragment there
//   (one ldmatrix beside the step's four for K), and the kv tiles are 32
//   rows (the score tile's 16 registers instead of 32): 96 KB of shared
//   memory, two CTAs an SM.
//   S = Q.K^T takes K rows as the column-major B operand (ldmatrix, at
//   offsets stepped by XOR, one register per operand); the online
//   softmax stays in registers, reduced across the 4 lanes of a quad
//   with shuffles, and masks only the diagonal, ragged and window-edge
//   tiles; P is rounded to bf16 and reused in registers as the A operand
//   of P.V (V through ldmatrix.trans).  The score tile never touches
//   shared memory.
//
//   cuda_core (f32): 64x64 tiles staged in shared memory in f32 and
//   multiplied on the CUDA cores, kept for f32 exactness (f32 on the
//   tensor cores would be TF32): 256 threads each compute a 4x4 block of
//   the score tile, 4 threads per query row do the online-softmax
//   rescale, and each thread accumulates a 4 x hd/16 block of the
//   output in registers.

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

// Element strides of the four operands over (batch, head, row); the last
// dim is contiguous.  k and v share theirs.
struct Strides {
  long long qb, qh, qs, kb, kh, ks, ob, oh, os;
};

// Stage `rows` x HD elements starting at `src` (rows `src_row` elements
// apart) into shared memory with row pitch `pitch`, scaled; rows >=
// n_valid are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long src_row, int n_valid,
                                      int rows, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float v[VEC];
    if (r < n_valid) {
      repro::load_vec(src + r * src_row + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * pitch + c + e] = v[e] * scale;
  }
}

// CTAs per SM the f32 route's registers are sized for: its shared memory
// holds 2 at hd <= 128 and 1 at hd 256 (214 KB), where the 4 x 16 output
// block would not fit 128 registers.
template <int HD>
constexpr int flash_min_blocks() {
  return HD >= 256 ? 1 : 2;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, flash_min_blocks<HD>())
    flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int H, int n_kv, int Sq,
    int Skv, int causal, int window, int prefix, float sm_scale,
    Strides st) {
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

  const T* qb = q + b * st.qb + h * st.qh + q0 * st.qs;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.kb + kvh * st.kh;

  stage<T, HD>(sQ, HD, qb, st.qs, Sq - q0, kBQ, sm_scale);
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
    stage<T, HD>(sK, HD + 1, kb + k0 * st.ks, st.ks, Skv - k0, kBK, 1.f);
    stage<T, HD>(sV, HD, vb + k0 * st.ks, st.ks, Skv - k0, kBK, 1.f);
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

  T* ob = out + b * st.ob + h * st.oh + q0 * st.os;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[r * st.os + tc + 16 * j] = repro::from_f32<T>(acc[i][j] / den);
  }
}

// ---- tensor_core route (bf16) --------------------------------------- //
constexpr int kTcBQ = 64;                    // query rows per CTA
constexpr int kTcThreads = kTcBQ / 16 * 32;  // a warp per 16 query rows

// CTAs per SM (64 KB of shared memory each): 3, at most 168 registers a
// thread; hd 128's fragments take more (ptxas spills at 168), so 2; hd
// 256 (96 KB) 2, at most 255 registers.
template <int HD>
constexpr int tc_min_blocks() {
  return HD >= 128 ? 2 : 3;
}

// kv rows per tile, and whether Q stays in a shared tile of its own (its
// fragments reloaded each k16 step) rather than in registers: see the
// header, hd 256.
template <int HD>
__host__ __device__ constexpr int tc_bk() {
  return HD >= 256 ? 32 : kBK;
}
template <int HD>
__host__ __device__ constexpr bool tc_q_shared() {
  return HD >= 256;
}

template <int HD>
constexpr size_t tc_smem_bytes() {        // K[0], V[0], K[1], V[1] (, Q)
  return ((size_t)4 * tc_bk<HD>() + (tc_q_shared<HD>() ? kTcBQ : 0)) * HD *
         sizeof(__nv_bfloat16);
}

// Element offset of 16-byte chunk c of row r in a swizzled [rows][HD]
// bf16 tile: 8 consecutive rows at one chunk land in 8 different 16-byte
// bank groups, for ldmatrix and for cp.async alike.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = HD / 8;                // chunks per row
  if constexpr (C >= 8) {
    return r * HD + ((c ^ (r & 7)) << 3);
  } else {
    return r * HD + ((c ^ ((r / (8 / C)) % C)) << 3);
  }
}

// A thread's share of a tile copy: chunk c of rows r0, r0 + STEP, ...
// Where STEP is a multiple of the swizzle's period in rows (8), the
// swizzled column is the same for all of them; at hd 256 (STEP 4) each
// row's is computed.
template <int HD>
struct TileLoader {
  static constexpr int C = HD / 8;              // 16-byte chunks per row
  static constexpr int STEP = kTcThreads / C;   // rows per pass
  int r0, c;
  uint32_t dst0;                                // byte offset in a tile
  int src0;                                     // element offset in a row

  __device__ __forceinline__ TileLoader() {
    r0 = threadIdx.x / C;
    c = threadIdx.x % C;
    dst0 = 2 * swz<HD>(r0, c);
    src0 = c * 8;
  }

  // cp.async ROWS rows of HD bf16 (rows `row` elements apart) into the
  // swizzled tile at `dst`; rows >= n_valid are zero-filled.
  template <int ROWS>
  __device__ __forceinline__ void load(uint32_t dst,
                                       const __nv_bfloat16* src,
                                       long long row, int n_valid) const {
    const __nv_bfloat16* p = src + src0 + r0 * row;
#pragma unroll
    for (int j = 0; j < (ROWS + STEP - 1) / STEP; ++j) {
      const int r = r0 + j * STEP;
      const uint32_t at = STEP % 8 == 0 ? dst0 + j * STEP * HD * 2
                                        : 2 * swz<HD>(r, c);
      if (ROWS % STEP == 0 || r < ROWS)
        repro::cp_async16(dst + at, r < n_valid ? p + j * STEP * row : src,
                          r < n_valid ? 16 : 0);
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks<HD>()) flash_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int H, int n_kv, int Sq, int Skv, int causal, int window, int prefix,
    float sm_scale, Strides st) {
  using namespace repro;
  constexpr int BK = tc_bk<HD>();          // kv rows per tile
  constexpr bool QS = tc_q_shared<HD>();   // Q in its own shared tile
  constexpr int NKS = HD / 16;             // k16 steps of Q.K^T
  constexpr int NDT = HD / 8;              // n8 tiles of the output
  constexpr int NST = BK / 8;              // n8 tiles of the score tile
  constexpr int TILE = BK * HD;            // elements per tile
  extern __shared__ __align__(16) __nv_bfloat16 tsm[];
  const uint32_t sK = smem_addr(tsm);     // K[0], V[0], K[1], V[1] (, Q)
  const uint32_t sQ = sK + 8u * TILE;     // used when QS
  const TileLoader<HD> loader;

  // heaviest query tiles (most kv tiles under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / n_kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row
  // This lane's ldmatrix byte offsets at k16 step 0, for matrices that
  // step 8 rows with mi / 2 and a chunk with mi % 2 (K) or the other way
  // round (V, Q).  Step j is the offset XOR 32 j: the chunk 2 j + x is
  // (2 j) ^ x, XOR commutes with the swizzle's, and the row part is a
  // multiple of the power-of-two row size, above every bit it touches.
  // Whole 16-row blocks (np, kk, warp) add, keeping the swizzle.
  const uint32_t k_lane = 2 * swz<HD>(mr + (mi / 2) * 8, mi % 2);
  const uint32_t v_lane = 2 * swz<HD>(mr + (mi % 2) * 8, mi / 2);

  const __nv_bfloat16* kb = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vb = v + b * st.kb + kvh * st.kh;

  const int kv_end = causal ? min(Skv, q0 + kTcBQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // the kv tiles the Pallas kernel visits: up to the causal frontier,
  // minus those wholly left of the window that hold no prefix position
  auto visited = [&](int t) {
    if (!(causal && window > 0)) return true;
    const int k0 = t * BK;
    return k0 + BK - 1 > q0 - window || (prefix > 0 && k0 < prefix);
  };
  auto next_tile = [&](int t) {
    do { ++t; } while (t < n_tiles && !visited(t));
    return t;
  };
  // byte addresses of K[buf] and V[buf] (computed, not indexed: an array
  // indexed at run time would live in local memory)
  auto kbuf = [&](int buf) { return sK + 4u * TILE * buf; };
  auto vbuf = [&](int buf) { return sK + 4u * TILE * buf + 2u * TILE; };
  auto load_kv = [&](int tile, int buf) {
    const long long off = (long long)tile * BK * st.ks;
    loader.template load<BK>(kbuf(buf), kb + off, st.ks, Skv - tile * BK);
    loader.template load<BK>(vbuf(buf), vb + off, st.ks, Skv - tile * BK);
  };

  // Q (at most two tiles) passes through K[1] and V[1], free until the
  // first prefetch, or stays in its own tile (QS)
  static_assert(QS || kTcBQ <= 2 * BK, "Q must fit in K[1] and V[1]");
  const uint32_t q_tile = QS ? sQ : kbuf(1);
  int t = next_tile(-1);
  loader.template load<kTcBQ>(q_tile, q + b * st.qb + h * st.qh + q0 * st.qs,
                              st.qs, Sq - q0);
  if (t < n_tiles) load_kv(t, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q fragments (A operand, 16 rows x HD): matrix mi = rows +8 (mi % 2),
  // chunk +1 (mi / 2); with QS one k16 step's at a time, in the loop
  const uint32_t q_warp = q_tile + warp * 16 * HD * 2;
  uint32_t qf[QS ? 1 : NKS][4];
  if constexpr (!QS) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      ldmatrix_x4(q_warp + (v_lane ^ (32 * ks)), qf[ks]);
    __syncthreads();   // every warp holds its Q: buffer 1 takes a tile
  }

  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // scores in log2 units: exp2(s * scale * log2 e) == exp(s * scale)
  const float sc = sm_scale * 1.4426950408889634f;

  int buf = 0;
  while (t < n_tiles) {
    const int tn = next_tile(t);
    if (tn < n_tiles) load_kv(tn, buf ^ 1);   // in flight meanwhile
    cp_async_commit();
    const int k0 = t * BK;

    // S = Q.K^T: 16 rows x BK kv per warp, NST n8 tiles
    float s[NST][4];
#pragma unroll
    for (int i = 0; i < NST; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if constexpr (QS) ldmatrix_x4(q_warp + (v_lane ^ (32 * ks)), qf[0]);
      const uint32_t(&a)[4] = qf[QS ? 0 : ks];
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t r[4];   // matrix mi: kv rows +8 (mi / 2), chunk +1 (mi % 2)
        ldmatrix_x4(kbuf(buf) + np * 16 * HD * 2 + (k_lane ^ (32 * ks)), r);
        mma_bf16_16816(s[2 * np], a, r[0], r[1]);
        mma_bf16_16816(s[2 * np + 1], a, r[2], r[3]);
      }
    }

    // fragment value e of n8 tile nt: row g + 8 (e / 2), col 8 nt +
    // 2 c4 + e % 2
    const bool edge =
        k0 + BK > Skv ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && k0 <= q0 + kTcBQ - 1 - window)));
#pragma unroll
    for (int nt = 0; nt < NST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= sc;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + warp * 16 + g + 8 * (e / 2);
          const int kp = k0 + 8 * nt + 2 * c4 + e % 2;
          bool ok = kp < Skv;
          if (causal) {
            ok = ok && kp <= qp;
            if (window > 0)
              ok = ok && (kp > qp - window || (prefix > 0 && kp < prefix));
          }
          if (!ok) s[nt][e] = kNegInf;
        }
    }

    // online softmax, rows g (hh = 0) and g + 8 (hh = 1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      const float corr = exp2f(m_run[hh] - m_new);
      m_run[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = exp2f(s[nt][e] - m_new);
          s[nt][e] = p;
          sum += p;
        }
      l_run[hh] = l_run[hh] * corr + sum;   // this lane's columns only
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        o[dt][2 * hh] *= corr;
        o[dt][2 * hh + 1] *= corr;
      }
    }

    // O += P.V: P (bf16) from the score fragments, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t r[4];   // matrix mi: kv rows +8 (mi % 2), chunk +1 (mi / 2)
        ldmatrix_x4_trans(vbuf(buf) + kk * 16 * HD * 2 + (v_lane ^ (32 * dp)),
                          r);
        mma_bf16_16816(o[2 * dp], a, r[0], r[1]);
        mma_bf16_16816(o[2 * dp + 1], a, r[2], r[3]);
      }
    }

    cp_async_wait<0>();
    __syncthreads();   // the next tile has landed; this one is free
    t = tn;
    buf ^= 1;
  }

  __nv_bfloat16* ob = out + b * st.ob + h * st.oh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * st.os + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(o[dt][2 * hh] * inv, o[dt][2 * hh + 1] * inv);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int causal, int window,
              int prefix, float sm_scale, const Strides& st, bool tc,
              cudaStream_t stream) {
  if (tc) {
    const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, B * H);
    constexpr size_t smem = tc_smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_tc<HD><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), H, K, Sq, Skv, causal, window,
        prefix, sm_scale, st);
  } else {
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), H, K, Sq,
        Skv, causal, window, prefix, sm_scale, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd); k, v (B, K, Skv, hd) with H % K == 0; out (B, H, Sq,
// hd); strided views with the element strides (batch, head, row) given,
// the last dim contiguous, rows 16-byte aligned.  dtype: 0 = f32, 1 =
// bf16.  route: 0 = tensor_core (bf16), 1 = cuda_core (f32).  Returns the
// cudaError_t of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int K, int Sq, int Skv, int hd, int causal,
                    int window, int prefix, int dtype, int route,
                    float sm_scale, long long qb, long long qh, long long qs,
                    long long kb, long long kh, long long ks, long long ob,
                    long long oh, long long os, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Skv == 0 || K == 0 || H % K) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, ob, oh, os};
  // route 0 (tensor_core) takes bf16, route 1 (cuda_core) f32
  if ((route == 0 && dtype != 1) || (route == 1 && dtype != 0) || route > 1)
    return (int)cudaErrorInvalidValue;
  const bool tc = route == 0;
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                  window, prefix, sm_scale, st, tc, s);
    case 32: return launch_hd<32>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                  window, prefix, sm_scale, st, tc, s);
    case 64: return launch_hd<64>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                  window, prefix, sm_scale, st, tc, s);
    case 128: return launch_hd<128>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                    window, prefix, sm_scale, st, tc, s);
    case 256: return launch_hd<256>(q, k, v, out, B, H, K, Sq, Skv, causal,
                                    window, prefix, sm_scale, st, tc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
