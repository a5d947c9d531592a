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
// (query tile, batch * head): 128 query rows on the tensor-core route, 64
// on the CUDA-core one; the loop stops at the causal
// frontier and skips tiles wholly left of the window.  Ragged edges are
// masked in the kernel (the Pallas wrapper asserts Sq % block_q == 0, but
// prefill buckets are any power of two >= 8).  Two routes, chosen by the
// caller (kernels/ops.py, flash_attention_route) from the dtype:
//
//   tensor_core (bf16): the FlashAttention-3 structure on wgmma and TMA.
//   A persistent grid, one CTA an SM, whose CTAs take work items (a query
//   tile of 64 rows a consumer warpgroup, of one batch and head) from a
//   counter in device memory, in sections of heads whose K and V come to
//   about 16 MB (read from device memory once, then from L2), the query
//   tiles with the most kv tiles under the causal mask first within each.
//   The last warpgroup is the producer: setmaxnreg hands its registers to
//   the consumers, and one of its threads issues every copy with TMA
//   (4-D tensor maps over the strided views, built on the host per call):
//   each item's Q into one of two buffers (one at hd 256), so that the
//   next item's Q lands during this one, then K and V tiles of BK rows
//   (128; 64 at hd 256, where the output fragment alone is 128 f32
//   registers a thread) through a ring of stages with full and empty
//   mbarriers.  Tiles are stored as column blocks of at most 64 bf16 with
//   TMA's swizzle of the block's width (128 bytes; 64 at hd 32, 32 at hd
//   16), the layout wgmma's descriptors read.  Two consumer warpgroups
//   (three at hd <= 64 without a causal mask) each own 64 query rows:
//   S = Q.K^T on wgmma m64nBKk16 with both operands in shared memory (K
//   is K-major: no transpose), the online softmax in registers on the
//   accumulator's fragment (f32 m and l, exp2 on the MUFU unit with
//   sm_scale * log2 e folded into one fma; masks only on the diagonal,
//   ragged and window-edge tiles), then O += P.V on wgmma with P rounded
//   to bf16 as the register A operand and V read MN-major through the
//   descriptor's transpose bit.  Each tile's Q.K^T is issued before the
//   previous tile's P.V, so its softmax runs while P.V is in flight, and
//   the warpgroups take turns on named barriers to issue, so that one
//   warpgroup's exponentials run under the others' products.  TMA zero-
//   fills rows past Sq or Skv (a zero key scores 0, so kv >= Skv is
//   masked).  The epilogue divides by max(l, 1e-30) and writes bf16
//   through shared memory (the warpgroup's rows of its Q buffer) with a
//   TMA store, which writes no row past Sq.
//
//   cuda_core (f32): 64x64 tiles staged in shared memory in f32 and
//   multiplied on the CUDA cores, kept for f32 exactness (f32 on the
//   tensor cores would be TF32): 256 threads each compute a 4x4 block of
//   the score tile, 4 threads per query row do the online-softmax
//   rescale, and each thread accumulates a 4 x hd/16 block of the
//   output in registers.

#include <climits>

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

// ---- tensor_core route (bf16): wgmma, TMA, warp specialisation ------ //
// NWG consumer warpgroups, 64 query rows each: three where hd <= 64 and
// no causal mask (short products leave the softmax more to hide behind,
// and no diagonal tile wastes a third of its rows), else two.  The
// producer warpgroup comes after them; setmaxnreg moves its registers to
// the consumers within the 65536 a CTA launches with (128 x 40 + 256 x
// 232, or 128 x 32 + 384 x 160).
__host__ __device__ constexpr int tc_wgs(int hd, bool causal) {
  return hd <= 64 && !causal ? 3 : 2;
}
__host__ __device__ constexpr int tc_producer_regs(int nwg) {
  return nwg == 3 ? 32 : 40;
}
__host__ __device__ constexpr int tc_consumer_regs(int nwg) {
  return nwg == 3 ? 160 : 232;
}
constexpr float kTcMasked = -__builtin_huge_valf();   // a masked score

// kv rows per tile: at hd 256 the output fragment alone is 128 f32
// registers a thread, so the score tile is 64 wide there.
template <int HD>
__host__ __device__ constexpr int tc_bk() {
  return HD >= 256 ? 64 : 128;
}
// K/V stages in the ring: as many as shared memory holds beside Q.
template <int HD>
__host__ __device__ constexpr int tc_stages() {
  return HD >= 128 ? 2 : 4;
}
// A tile is stored as column blocks of at most 64 bf16 (128 bytes) a row,
// each [rows][block width] with TMA's swizzle of the block's width: 128
// bytes at hd >= 64, 64 at hd 32, 32 at hd 16.
template <int HD>
__host__ __device__ constexpr int tc_row_bytes() {
  return (HD < 64 ? HD : 64) * 2;
}
template <int HD>
__host__ __device__ constexpr int tc_swizzle_bits() {   // Swizzle<B, 4, 3>
  return tc_row_bytes<HD>() == 128 ? 3 : tc_row_bytes<HD>() == 64 ? 2 : 1;
}
template <int HD>
__host__ __device__ constexpr int tc_desc_layout() {    // wgmma descriptor
  return 4 - tc_swizzle_bits<HD>();
}
template <int HD, int NWG>
__host__ __device__ constexpr uint32_t tc_q_bytes() {
  return (uint32_t)64 * NWG * HD * 2;
}
template <int HD>
__host__ __device__ constexpr uint32_t tc_kv_bytes() {
  return (uint32_t)tc_bk<HD>() * HD * 2;
}
// Q buffers: two where shared memory holds them, so that the next work
// item's Q lands while this one computes; one at hd 256.
template <int HD>
__host__ __device__ constexpr int tc_q_bufs() {
  return HD >= 256 ? 1 : 2;
}
// Q[i], then K[s], V[s] for each stage, then the mbarriers (Q full and
// empty for each Q buffer; K full, V full, K empty, V empty for each
// stage), then the work item of each Q buffer; 1024 bytes of slack to
// align the base to the 128-byte swizzle's period.
template <int HD, int NWG>
constexpr size_t tc_smem_bytes() {
  return tc_q_bufs<HD>() * tc_q_bytes<HD, NWG>() +
         2 * tc_stages<HD>() * tc_kv_bytes<HD>() +
         8 * (2 * tc_q_bufs<HD>() + 4 * tc_stages<HD>()) +
         4 * tc_q_bufs<HD>() + 1024;
}
// K and V bytes a section of work items reads (see flash_tc).
constexpr long long kTcSectionBytes = 16ll << 20;

// exp2 on the MUFU unit in one instruction (inputs <= 0; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The consumer's per-tile state: this thread's share of the 64 x BK score
// tile (S, then P in f32), of P as wgmma's A fragments, of the 64 x HD
// output and the online softmax of its two rows (l / 4 and l / 4 + 8 of
// its warp's 16).
template <int HD>
struct TcState {
  static constexpr int BK = tc_bk<HD>();
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float o[HD / 2];
  float m[2], l[2];
};

// S = Q . K^T for this warpgroup's 64 rows, both operands K-major in
// shared memory (Q's column blocks BQ rows apart), one wgmma m64nBKk16 per
// 16 columns of hd.
template <int HD, int BQ>
__device__ __forceinline__ void tc_qk(TcState<HD>& st, uint32_t q_wg,
                                      uint32_t kbuf) {
  constexpr int RB = tc_row_bytes<HD>(), KB = RB / 32;   // k16 steps a block
  constexpr int L = tc_desc_layout<HD>();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks % KB) * 32;
    repro::wgmma_ss<tc_bk<HD>(), 0>(
        st.s,
        repro::smem_desc(q_wg + (ks / KB) * BQ * RB + off, 16, 8 * RB, L),
        repro::smem_desc(kbuf + (ks / KB) * tc_bk<HD>() * RB + off, 16,
                         8 * RB, L),
        ks > 0);
  }
}

// O += P . V: P from registers, V (kv rows x hd, hd contiguous) read
// MN-major through the descriptor's transpose bit, 16 kv rows a step.
template <int HD>
__device__ __forceinline__ void tc_pv(TcState<HD>& st, uint32_t vbuf) {
  constexpr int RB = tc_row_bytes<HD>(), BK = tc_bk<HD>();
  constexpr int L = tc_desc_layout<HD>();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    repro::wgmma_rs<HD, 1>(
        st.o, st.p[kk],
        repro::smem_desc(vbuf + kk * 16 * RB, BK * RB, 8 * RB, L), 1);
}

// Mask tile k0 where it needs it, then fold it into the online softmax:
// st.s becomes P (f32), corr the factor the output's rows are rescaled
// by.  Scores stay unscaled until exp2(s * sc - m) (one fma), sc =
// sm_scale * log2 e, m in the scaled units.  Masked scores are -inf, and
// a row with no visible key yet subtracts 0: its P and l stay 0 (JAX's
// kernel gives such a row P = 1 on its -1e30 scores; the first visible
// key's correction wipes either, and every query sees its own key).
template <int HD>
__device__ __forceinline__ void tc_softmax(TcState<HD>& st, int k0, int row0,
                                           int wq0, int Skv, int causal,
                                           int window, int prefix, float sc,
                                           float (&corr)[2]) {
  constexpr int BK = tc_bk<HD>();
  const int lane = threadIdx.x % 32;
  const bool edge =
      k0 + BK > Skv ||
      (causal && (k0 + BK - 1 > wq0 ||
                  (window > 0 && k0 <= wq0 + 63 - window)));
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + 8 * (e / 2);
        const int kp = k0 + 8 * j + 2 * (lane % 4) + e % 2;
        bool ok = kp < Skv;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && (kp > qp - window || kp < prefix);
        }
        if (!ok) st.s[4 * j + e] = kTcMasked;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mq[4] = {kTcMasked, kTcMasked, kTcMasked, kTcMasked};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mq[j % 4] = fmaxf(mq[j % 4],
                        fmaxf(st.s[4 * j + 2 * h], st.s[4 * j + 2 * h + 1]));
    float mx = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[h], mx * sc);
    const float m_use = m_new == kTcMasked ? 0.f : m_new;
    corr[h] = fast_exp2(st.m[h] - m_use);
    st.m[h] = m_new;
    float sq[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, not one
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(fmaf(st.s[4 * j + 2 * h + e], sc, -m_use));
        st.s[4 * j + 2 * h + e] = p;
        sq[j % 4] += p;
      }
    // this lane's columns only
    st.l[h] = st.l[h] * corr[h] + ((sq[0] + sq[1]) + (sq[2] + sq[3]));
  }
}

// P (f32 accumulator layout) to bf16 A fragments: k16 step kk is n8
// tiles 2kk and 2kk + 1 of the score fragment, exactly the A layout.
template <int HD>
__device__ __forceinline__ void tc_to_p(TcState<HD>& st) {
#pragma unroll
  for (int kk = 0; kk < tc_bk<HD>() / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st.p[kk][r] = repro::pack_bf16x2(st.s[8 * kk + 2 * r],
                                       st.s[8 * kk + 2 * r + 1]);
}

template <int HD>
__device__ __forceinline__ void tc_rescale(TcState<HD>& st,
                                           const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[4 * j + e] *= corr[e / 2];
}

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) flash_tc(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, int* __restrict__ sched,
    int B, int H, int n_kv, int Sq, int Skv, int causal, int window,
    int prefix, float sm_scale) {
  using namespace repro;
  constexpr int BK = tc_bk<HD>(), NS = tc_stages<HD>(), NQ = tc_q_bufs<HD>();
  constexpr int BQ = 64 * NWG;
  constexpr int RB = tc_row_bytes<HD>(), CB = RB / 2, NB = HD / CB;
  constexpr uint32_t QB = tc_q_bytes<HD, NWG>(), KVB = tc_kv_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + NQ * QB;  // K[s] at sKV + 2 s KVB, V[s] + KVB
  const uint32_t bars = sKV + 2 * NS * KVB;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (NQ + i); };
  auto k_full = [&](int s) { return bars + 8 * (2 * NQ + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 * NQ + NS + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 * NQ + 2 * NS + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 * NQ + 3 * NS + s); };
  auto kbuf = [&](int s) { return sKV + 2 * s * KVB; };
  auto vbuf = [&](int s) { return sKV + 2 * s * KVB + KVB; };
  // the work item in Q buffer i, or -1: the CTA's items are done
  int* const item = reinterpret_cast<int*>(
      smem_raw + (bars - smem_addr(smem_raw)) + 8 * (2 * NQ + 4 * NS));

  // Work items, one a (query tile, batch * head), in sections of SB
  // (batch, head) pairs whose K and V come to about kTcSectionBytes, so
  // that the CTAs read a section's K and V from device memory once, while
  // they compute, and then from L2; within a section the query tiles
  // with the most kv tiles under the causal mask come first, so that the
  // longest items do not form the tail.  The CTAs take items in order
  // from a counter in device memory (`sched`) as their producers free up.
  const int BH = B * H, n_qt = (Sq + BQ - 1) / BQ;
  const int n_items = BH * n_qt;
  const long long kv_bytes = 4ll * B * n_kv * Skv * HD;
  const int SB = (int)min((long long)BH,
                          (BH * kTcSectionBytes + kv_bytes - 1) / kv_bytes);
  int q0 = 0, b = 0, h = 0, n_tiles = 0;
  auto decode = [&](int w) {
    const int sec0 = w / (SB * n_qt) * SB;         // the section's first
    const int nb = min(SB, BH - sec0);             // its (batch, head)s
    const int in = w - sec0 * n_qt;
    q0 = (n_qt - 1 - in / nb) * BQ;
    b = (sec0 + in % nb) / H;
    h = (sec0 + in % nb) % H;
    const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
    n_tiles = (kv_end + BK - 1) / BK;
  };
  // the kv tiles the Pallas kernel visits: up to the causal frontier,
  // minus those wholly left of the window that hold no prefix position
  auto next_tile = [&](int t) {
    do { ++t; } while (t < n_tiles && causal && window > 0 &&
                       t * BK + BK - 1 <= q0 - window && t * BK >= prefix);
    return t;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NQ; ++i) {
      mbar_init(q_full(i), 1);            // the producer + its bytes
      mbar_init(q_empty(i), NWG);         // one arrival per consumer WG
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), NWG);
      mbar_init(v_empty(s), NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {   // the producer: one thread issues every copy
    setmaxnreg_dec<tc_producer_regs(NWG)>();
    if (threadIdx.x == 128 * NWG) {
      int it = 0;   // kv tiles loaded so far, over all of this CTA's items
      for (int r = 0;; ++r) {
        const int w = atomicAdd(sched, 1);
        // every CTA fetches once past the last item: the launch's last
        // fetch leaves the counter at 0 for the next launch
        if (w == n_items + (int)gridDim.x - 1) atomicExch(sched, 0);
        const int qi = r % NQ;
        if (r >= NQ) mbar_wait(q_empty(qi), (r / NQ - 1) & 1);
        item[qi] = w < n_items ? w : -1;
        if (w >= n_items) {
          mbar_arrive(q_full(qi));
          break;
        }
        decode(w);
        const int kvh = h / (H / n_kv);
        mbar_arrive_expect_tx(q_full(qi), QB);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(sQ + qi * QB + c * BQ * RB, &tm_q, q_full(qi),
                      c * CB, q0, h, b);
        for (int t = next_tile(-1); t < n_tiles; t = next_tile(t), ++it) {
          const int s = it % NS;
          const uint32_t ph = (it / NS - 1) & 1;
          if (it >= NS) mbar_wait(k_empty(s), ph);
          mbar_arrive_expect_tx(k_full(s), KVB);
          for (int c = 0; c < NB; ++c)
            tma_load_4d(kbuf(s) + c * BK * RB, &tm_k, k_full(s), c * CB,
                        t * BK, kvh, b);
          if (it >= NS) mbar_wait(v_empty(s), ph);
          mbar_arrive_expect_tx(v_full(s), KVB);
          for (int c = 0; c < NB; ++c)
            tma_load_4d(vbuf(s) + c * BK * RB, &tm_v, v_full(s), c * CB,
                        t * BK, kvh, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
  setmaxnreg_inc<tc_consumer_regs(NWG)>();
  const int tw = threadIdx.x % 128;
  const float sc = sm_scale * 1.4426950408889634f;
  // the schedule: WG wg waits on barrier 1 + wg to issue its products
  // and then lets the next go (barrier 1 + (wg + 1) % NWG), so that one
  // WG's exponentials run under the others' products; WG 0 goes first.
  const int my_turn = 1 + wg, their_turn = 1 + (wg + 1) % NWG;
  if (wg == NWG - 1) named_bar_arrive(1, 256);

  int it = 0;   // kv tiles consumed so far, over all of this CTA's items
  for (int r = 0;; ++r) {
    const int qi = r % NQ;
    mbar_wait(q_full(qi), (r / NQ) & 1);
    const int w = item[qi];
    if (w < 0) break;
    decode(w);
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (tw / 32) + (tw % 32) / 4;
    const uint32_t q_wg = sQ + qi * QB + 64 * wg * RB;

    TcState<HD> st;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) st.s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = kTcMasked;
    st.l[0] = st.l[1] = 0.f;
    float corr[2];

    // the first tile: S only
    int t = next_tile(-1);
    named_bar_sync(my_turn, 256);
    mbar_wait(k_full(it % NS), (it / NS) & 1);
    fence_acc(st.s);
    wgmma_fence();
    tc_qk<HD, BQ>(st, q_wg, kbuf(it % NS));
    wgmma_commit();
    named_bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_acc(st.s);
    if (tw == 0) mbar_arrive(k_empty(it % NS));
    tc_softmax<HD>(st, t * BK, row0, wq0, Skv, causal, window, prefix, sc,
                   corr);
    tc_to_p<HD>(st);

    // then each tile's S is issued before the previous tile's P . V, and
    // its softmax runs while P . V is in flight
    for (int tn = next_tile(t); tn < n_tiles; t = tn, tn = next_tile(tn)) {
      const int sp = it % NS, pp = (it / NS) & 1;
      ++it;
      const int sn = it % NS;
      named_bar_sync(my_turn, 256);
      mbar_wait(k_full(sn), (it / NS) & 1);
      fence_acc(st.o);
      wgmma_fence();
      tc_qk<HD, BQ>(st, q_wg, kbuf(sn));
      wgmma_commit();
      mbar_wait(v_full(sp), pp);
      tc_pv<HD>(st, vbuf(sp));
      wgmma_commit();
      named_bar_arrive(their_turn, 256);
      wgmma_wait<1>();                    // S of tile tn
      fence_acc(st.s);
      if (tw == 0) mbar_arrive(k_empty(sn));
      tc_softmax<HD>(st, tn * BK, row0, wq0, Skv, causal, window, prefix,
                     sc, corr);
      wgmma_wait<0>();                    // P . V of tile t
      fence_acc(st.o);
      fence_frag(st.p);
      if (tw == 0) mbar_arrive(v_empty(sp));
      tc_rescale<HD>(st, corr);
      tc_to_p<HD>(st);
    }

    // the last tile's P . V
    named_bar_sync(my_turn, 256);
    mbar_wait(v_full(it % NS), (it / NS) & 1);
    fence_acc(st.o);
    wgmma_fence();
    tc_pv<HD>(st, vbuf(it % NS));
    wgmma_commit();
    named_bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_acc(st.o);
    fence_frag(st.p);
    if (tw == 0) mbar_arrive(v_empty(it % NS));
    ++it;

    // epilogue: O / max(l, 1e-30) as bf16 into this WG's rows of its Q
    // buffer (its last Q . K^T is done), swizzled as TMA lays a tile;
    // one thread stores them with TMA, which writes no row past Sq, and
    // frees the rows for the next Q once the store has read them
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = st.l[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[hh] = 1.f / fmaxf(l, 1e-30f);
    }
    constexpr uint32_t SWZ = (1u << tc_swizzle_bits<HD>()) - 1;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = 16 * (tw / 32) + (tw % 32) / 4 + 8 * hh;
        const int col = 8 * jj + 2 * (tw % 4);
        uint32_t off = rr * RB + (col % CB) * 2;
        off ^= ((off >> 7) & SWZ) << 4;
        st_shared_b32(q_wg + (col / CB) * BQ * RB + off,
                      pack_bf16x2(st.o[4 * jj + 2 * hh] * inv[hh],
                                  st.o[4 * jj + 2 * hh + 1] * inv[hh]));
      }
    fence_proxy_async();
    named_bar_sync(1 + NWG + wg, 128);
    if (tw == 0) {
      if (wq0 < Sq) {
        for (int c = 0; c < NB; ++c)
          tma_store_4d(&tm_o, q_wg + c * BQ * RB, c * CB, wq0, h, b);
        bulk_commit();
        bulk_wait_read<0>();
      }
      mbar_arrive(q_empty(qi));
    }
  }
  if (wg == 0) named_bar_sync(1, 256);  // the last WG's last arrival
}

// A 4-D tensor map over a (B, heads, rows, HD) bf16 view with element
// strides (sb, sh, ss) and a unit last stride: boxes of one block's
// columns x box_rows rows, swizzled as the kernel reads them.  A stride of
// a dimension of size 1 is never followed: it is given as one row.
template <int HD>
bool tc_map(repro::EncodeTiled encode, CUtensorMap* map, const void* p,
            int B, int heads, int rows, long long sb, long long sh,
            long long ss, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const long long one = HD * 2;
  const cuuint64_t strides[3] = {
      (cuuint64_t)(rows > 1 ? ss * 2 : one),
      (cuuint64_t)(heads > 1 ? sh * 2 : one),
      (cuuint64_t)(B > 1 ? sb * 2 : one)};
  const cuuint32_t box[4] = {(cuuint32_t)(tc_row_bytes<HD>() / 2),
                             (cuuint32_t)box_rows, 1, 1};
  constexpr CUtensorMapSwizzle swz =
      tc_row_bytes<HD>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : tc_row_bytes<HD>() == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return repro::encode_map(encode, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           p, dims, strides, box, swz);
}

// The four tensor maps (built per call: the pointers change) and the
// launch of NWG consumer warpgroups: one CTA an SM at most, each taking
// work items until they are done; a map that cannot be encoded is
// refused.
template <int HD, int NWG>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              int* sched, int B, int H, int K, int Sq, int Skv, int causal,
              int window, int prefix, float sm_scale, const Strides& st,
              cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  if (!tc_map<HD>(encode, &tq, q, B, H, Sq, st.qb, st.qh, st.qs, BQ) ||
      !tc_map<HD>(encode, &tk, k, B, K, Skv, st.kb, st.kh, st.ks,
                  tc_bk<HD>()) ||
      !tc_map<HD>(encode, &tv, v, B, K, Skv, st.kb, st.kh, st.ks,
                  tc_bk<HD>()) ||
      !tc_map<HD>(encode, &to, out, B, H, Sq, st.ob, st.oh, st.os, 64))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<HD, NWG>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long n_items = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (n_items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  constexpr int threads = 128 * (NWG + 1);
  flash_tc<HD, NWG><<<grid, threads, smem, stream>>>(
      tq, tk, tv, to, sched, B, H, K, Sq, Skv, causal, window, prefix,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int* sched, int B, int H, int K, int Sq, int Skv, int causal,
              int window, int prefix, float sm_scale, const Strides& st,
              bool tc, cudaStream_t stream) {
  if (tc) {
    if constexpr (tc_wgs(HD, false) == 3) {   // built only where it runs
      if (tc_wgs(HD, causal) == 3)
        return launch_tc<HD, 3>(q, k, v, out, sched, B, H, K, Sq, Skv,
                                causal, window, prefix, sm_scale, st, stream);
    }
    return launch_tc<HD, 2>(q, k, v, out, sched, B, H, K, Sq, Skv, causal,
                            window, prefix, sm_scale, st, stream);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, K, Sq, Skv,
      causal, window, prefix, sm_scale, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd); k, v (B, K, Skv, hd) with H % K == 0; out (B, H, Sq,
// hd); strided views with the element strides (batch, head, row) given,
// the last dim contiguous, rows 16-byte aligned.  dtype: 0 = f32, 1 =
// bf16.  route: 0 = tensor_core (bf16), 1 = cuda_core (f32).  sched: an
// int32 counter at 0 in device memory, which the tensor-core route's CTAs
// take work items from and leave at 0 (launches that may overlap need
// counters of their own); the CUDA-core route reads none.  Returns the
// cudaError_t of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int K, int Sq, int Skv, int hd, int causal,
                    int window, int prefix, int dtype, int route,
                    float sm_scale, long long qb, long long qh, long long qs,
                    long long kb, long long kh, long long ks, long long ob,
                    long long oh, long long os, void* sched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Skv == 0 || K == 0 || H % K) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, ob, oh, os};
  // route 0 (tensor_core) takes bf16, route 1 (cuda_core) f32
  if ((route == 0 && (dtype != 1 || sched == nullptr)) ||
      (route == 1 && dtype != 0) || route > 1)
    return (int)cudaErrorInvalidValue;
  const bool tc = route == 0;
  int* const ctr = static_cast<int*>(sched);
#define FLASH_HD(D)                                                     \
  case D:                                                               \
    return launch_hd<D>(q, k, v, out, ctr, B, H, K, Sq, Skv, causal,    \
                        window, prefix, sm_scale, st, tc, s);
  switch (hd) {
    FLASH_HD(16) FLASH_HD(32) FLASH_HD(64) FLASH_HD(128) FLASH_HD(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_HD
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
