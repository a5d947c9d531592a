// The bf16 body of the two split decode kernels on Hopper (sm_90a): one
// device body for decode_attention.cu (rows of a strided (B, K, S, hd)
// cache) and paged_decode_attention.cu (rows of a (P, ps, K, hd) page pool
// read through the page table).  The two differ only in their row source
// (ContigRows, PagedRows): where row `local` of a CTA's chunk lies, and
// whether it is mapped.
//
// What bounds it: bytes.  A (row, kv head) reads its visible keys and
// values once, 2 * rows * hd * 2 bytes, and does 4 * G flops a key and
// element, far below the card's ~295 flops per byte.  What held the
// CUDA-core kernel far above that bound was fixed cost and latency: a
// softmax step with a shuffle reduction for every key row and query row,
// 16-byte loads that a warp issued and then waited on, padded query rows
// that cost as much as real ones, and a merge through device memory after
// the slowest chunk.  The design answers each:
//
// 1. K/V tiles reach shared memory asynchronously, through a ring.  A tile
//    is 64 key rows of K and of V.  One producer warp keeps a ring of NCW
//    stages (3 or 4; one stage for each consumer warp) full with TMA tile
//    copies, completing on the stage's mbarrier: the contiguous cache as a
//    4-D tensor (hd, S, K, B) in boxes of 64 rows, the page pool as a 3-D
//    tensor (hd, K, P * ps) in boxes of gcd(ps, 64) rows of one page, each
//    box min(hd, 64) columns wide (hd / 64 boxes a row block at hd 128 and
//    256), swizzled (128, 64 or 32 bytes, as wide as a box row) so that
//    the eight rows an ldmatrix reads fall in eight bank groups.  The
//    tensor maps are encoded on the host once per (pointer, shape,
//    strides) and kept (common.cuh tensor_map_nd).  Boxes whose rows are all masked
//    (past pos, out of the window and the prefix, a sentinel page) are not
//    copied; lane 0 hands the consumers the tile's 64-bit mask of visible
//    rows beside the data.  The paged source reads the page ids of a
//    tile's columns one tile ahead of the copies (PagedRows::ids).  Two
//    other copy routes were measured on the H100 and dropped: one 1-D bulk
//    copy a row (the copy engine took ~36 ns a request of 128-512 bytes)
//    and 16-byte cp.async (about 20 GB/s a CTA however many were in
//    flight); either read a tile at a third to a half of the TMA boxes'
//    rate.
// 2. The query group runs on the tensor cores, keys on M and the group on
//    N: S^T (64 x G) = K_tile . Q^T and out^T (hd x G) += V_tile^T . P^T,
//    mma.sync m16n8k16 fed by ldmatrix (.trans for V^T), G padded to 8 or
//    16 (N = 8 or 16) at the same instructions whatever G.  The score's C
//    fragment holds keys on rows; P^T's B fragment needs them on columns:
//    movmatrix.trans turns each 8x8 block of P (bf16) over in registers.
//    Q stays bf16 as given; sm_scale (and log2 e) multiply the f32 scores.
//    The accumulators stay f32.
// 3. The softmax steps once a tile: each warp owns whole tiles (tile i of
//    the CTA goes to warp i % NCW), and for each query row takes one max
//    over the tile's 64 scores (three shuffles), one correction factor and
//    one rescale of its accumulators.  A masked score (past pos, out of
//    the window and the prefix, on a sentinel page) weighs 0, as the
//    CUDA-core kernel skips such a row.  Whole tiles out of the window and
//    the prefix are neither copied nor visited (the Pallas kernel's block
//    skip); a 16-key block with no visible row is skipped.  A masked row
//    may hold stale shared memory (a box not copied) or cache rows past
//    pos: its score is replaced, never multiplied, and its V^T fragment
//    is zeroed.
// 4. The splits of a (row, kv head) merge in a thread block cluster.  The
//    CTA first merges its warps' states in shared memory (warp order),
//    keeps its f32 partial (m, l, acc) there, and after one cluster
//    barrier each rank merges its slice of the output over the cluster's
//    running chunks in rank order, reading the others' partials through
//    distributed shared memory; a second barrier keeps every partial alive
//    until it is read.  No partial goes to device memory, no ticket is
//    taken, and the bits do not depend on the order the CTAs finish in.
//    A launch with more chunks than a cluster takes (cluster == 1,
//    n_split > 1) keeps the global route: partials in a workspace, the
//    last CTA to arrive merges (common.cuh last_to_arrive, merge_splits).
//    A chunk that does not run (past pos, out of the window) contributes
//    nothing, and a chunk that runs but sees no row (all sentinels) the
//    empty partial m = -1e30, l = 0, whose weight is exactly 0.
#pragma once

#include "common.cuh"

namespace repro {
namespace dtc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // key rows a tile
constexpr int kMaxG = 16;        // query rows a launch (N = 8 or 16)
constexpr int kMaxCluster = 16;  // 8 portable; 16 non-portable
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a CTA at head dim HD: the ring (NCW stages of K | V,
// each a tile of 64 rows in NB column blocks of BW columns, RB bytes a
// box row), the query rows (padded: PITCH bytes a row), the barriers and
// the stages' row masks.  The end-of-CTA merge reuses the ring.  NCW and
// MIN_CTAS are set so that 1 (hd 256), 2 (hd 128) or 3 CTAs fit an SM
// (ops.DECODE_TC_CTAS_PER_SM).
template <int HD>
struct Geom {
  static constexpr int NCW = HD >= 64 ? 3 : 4;   // consumer warps = stages
  static constexpr int THREADS = 32 * (NCW + 1);
  static constexpr int MIN_CTAS = HD >= 256 ? 1 : HD >= 128 ? 2 : 3;
  static constexpr int BW = HD < 64 ? HD : 64;   // columns a box
  static constexpr int NB = HD / BW;             // boxes a row block
  static constexpr int RB = 2 * BW;              // bytes a box row
  static constexpr int SWM = RB / 16 - 1;        // the swizzle's row mask
  static constexpr int PITCH = 2 * HD + 16;      // bytes a query row
  static constexpr int TILE = kRows * 2 * HD;    // K (or V) of a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = NCW * STAGE;
  static constexpr int Q = kMaxG * PITCH;
  // + full, empty, masks; + 1024 to align the ring for the swizzle
  static constexpr int SMEM = RING + Q + 24 * NCW + 1024;
  // the warps' states and the CTA's partial, f32
  static constexpr int MERGE = (NCW + 1) * kMaxG * (HD + 2) * 4;
  static_assert(MERGE <= RING, "the merge reuses the ring");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// The swizzle the TMA box of RB-byte rows was written with, for its
// 16-byte chunks: chunk ^= (row of 128 bytes) % 8, in RB / 16 - 1 bits
// (128B: 3, 64B: 2, 32B: 1); swm = 0 reads an unswizzled box.
template <int HD>
__device__ __forceinline__ uint32_t kv_addr(uint32_t tile, int row, int d,
                                            uint32_t swm) {
  using Gm = Geom<HD>;
  const uint32_t off = row * Gm::RB + (d % Gm::BW) * 2;
  return tile + (d / Gm::BW) * (kRows * Gm::RB) +
         (off ^ (((off >> 7) & swm) << 4));
}

// ---- PTX ------------------------------------------------------------- //

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
// The 8x8 b16 matrix of a warp's fragments (lane l: row l / 4, columns
// 2 (l % 4) and + 1), transposed in the same layout.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- the row sources ------------------------------------------------- //

// The CTA's (slot, kv head), its pos, and its chunk: the first kv position
// c0 and the rows up to the last visible one, n_rows.
struct Ctx {
  int b, kh, pos, c0, n_rows;
};

// Rows of a (B, K, S, hd) cache, any strides (elements) with the last dim
// contiguous, through the 4-D maps mk, mv of (hd, S, K, B), boxes of
// (BW, 64, 1, 1); chunks of `chunk` rows.
struct ContigRows {
  CUtensorMap mk, mv;
  int S, chunk;
  struct Ids {};

  // The running chunks (common.cuh running_chunks) and this chunk's span.
  __device__ uint32_t span(Ctx& cx, int split, int n_split, int window,
                           int prefix) const {
    const int last = min(cx.pos, S - 1);
    cx.c0 = split * chunk;
    cx.n_rows = max(0, min(cx.c0 + chunk, last + 1) - cx.c0);
    return running_chunks(n_split, chunk, last, cx.pos, window, prefix);
  }
  __device__ Ids ids(const Ctx&, int, int) const { return {}; }
  __device__ bool mapped(const Ctx&, const Ids&, int, int) const {
    return true;
  }
  __device__ uint32_t swizzle_mask(int swm) const { return swm; }
  template <int HD>
  __device__ uint32_t bytes(unsigned long long) const {
    return kRows * 4 * HD;
  }
  // The tile's copies: one box a column block of K and of V, 64 rows
  // from chunk row t0 (rows past S land as zeros).
  template <int HD>
  __device__ void issue(const Ctx& cx, const Ids&, int t0,
                        unsigned long long, uint32_t sk, uint32_t sv,
                        uint32_t bar, int lane) const {
    using Gm = Geom<HD>;
    if (lane < 2 * Gm::NB) {
      const int cb = lane % Gm::NB;
      tma_load_4d((lane < Gm::NB ? sk : sv) + cb * kRows * Gm::RB,
                  lane < Gm::NB ? &mk : &mv, bar, cb * Gm::BW, cx.c0 + t0,
                  cx.kh, cx.b);
    }
  }
};

// Rows of a (P, ps, K, hd) pool through a (B, pps) table with sentinel
// n_pages, through the 3-D maps mk, mv of (hd, K, P * ps), boxes of (BW,
// 1, br) with br = gcd(ps, 64): a box never straddles a page or a tile.
// Boxes of fewer than 8 rows are not swizzled (a swizzled box must start
// on the pattern's 8-row period).  Chunks of `ppc` columns.  Every lane
// of the warp calls `ids`, `mapped` and `issue` (shuffles).
struct PagedRows {
  CUtensorMap mk, mv;
  const int* table;
  int n_pages, ps, pps, ppc, br;
  struct Ids {
    int lo, hi;   // the ids of columns w0 + lane and w0 + 32 + lane
  };

  __device__ uint32_t span(Ctx& cx, int split, int n_split, int window,
                           int prefix) const {
    const int j0 = split * ppc;
    const int n_cols = max(0, min(ppc, pps - j0));
    cx.c0 = j0 * ps;
    cx.n_rows = max(0, min(n_cols * ps, cx.pos + 1 - cx.c0));
    return running_chunks(n_split, ppc * ps, cx.pos, cx.pos, window, prefix);
  }
  // The page ids of the 64 columns from the one holding chunk row t0 on
  // (a tile of 64 rows spans at most those), sentinels past the chunk.
  __device__ Ids ids(const Ctx& cx, int t0, int lane) const {
    const int j0 = cx.c0 / ps;
    const int end = min(j0 + ppc, pps);
    const int c = j0 + t0 / ps + lane;
    const int* row = table + (size_t)cx.b * pps;
    return Ids{c < end ? row[c] : n_pages, c + 32 < end ? row[c + 32]
                                                       : n_pages};
  }
  // The page of chunk row `local` of the tile at t0 (-1 where unmapped).
  __device__ int page(const Ids& id, int t0, int local) const {
    const int jc = local / ps - t0 / ps;   // 0..63
    const int lo = __shfl_sync(0xffffffffu, id.lo, jc & 31);
    const int hi = __shfl_sync(0xffffffffu, id.hi, jc & 31);
    const int pg = jc < 32 ? lo : hi;
    return pg >= 0 && pg < n_pages ? pg : -1;
  }
  __device__ bool mapped(const Ctx&, const Ids& id, int t0,
                         int local) const {
    return page(id, t0, local) >= 0;
  }
  __device__ uint32_t swizzle_mask(int swm) const {
    return br % 8 == 0 ? swm : 0;
  }
  // the rows of box j of the tile, as bits of its row mask
  __device__ unsigned long long box_bits(int j) const {
    const unsigned long long ones = br >= 64 ? ~0ull : (1ull << br) - 1;
    return ones << (j * br);
  }
  template <int HD>
  __device__ uint32_t bytes(unsigned long long vm) const {
    int n = 0;
    for (int j = 0; j < kRows / br; ++j) n += (vm & box_bits(j)) != 0;
    return n * br * 4 * HD;
  }
  // The tile's copies: lane j (and j + 32) copies box j, K and V, every
  // column block, where a row of it is visible.
  template <int HD>
  __device__ void issue(const Ctx& cx, const Ids& id, int t0,
                        unsigned long long vm, uint32_t sk, uint32_t sv,
                        uint32_t bar, int lane) const {
    using Gm = Geom<HD>;
    const int n_box = kRows / br;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const int local = t0 + min(j, n_box - 1) * br;
      const int pg = page(id, t0, local);
      if (j >= n_box || !(vm & box_bits(j))) continue;
      const int row = pg * ps + local % ps;
#pragma unroll
      for (int cb = 0; cb < Gm::NB; ++cb) {
        const uint32_t off = cb * kRows * Gm::RB + j * br * Gm::RB;
        tma_load_3d(sk + off, &mk, bar, cb * Gm::BW, cx.kh, row);
        tma_load_3d(sv + off, &mv, bar, cb * Gm::BW, cx.kh, row);
      }
    }
  }
};

struct Args {
  const bf16* q;
  bf16* out;
  const int* pos;
  float* ws;
  unsigned* tickets;
  int n_kv, G, g0, window, prefix, cluster;
  float scale_log2;   // sm_scale * log2(e)
};

// ---- one tile of a consumer warp ------------------------------------- //

// Fold the tile at ks (K rows) / vs (V rows), swizzled as swm says (see
// kv_addr), whose visible rows are `vm`,
// into the warp's state: m, l in log2 units of the scaled score, for query
// rows 8 nt + 2 (lane % 4) + e; acc the out^T fragment (hd rows 16 md +
// lane / 4 (+ 8), the same query columns).
template <int HD, int NT, bool FULL>
__device__ __forceinline__ void fold_tile(uint32_t ks, uint32_t vs,
                                          uint32_t swm, uint32_t qs,
                                          unsigned long long vm,
                                          float scale_log2, int lane,
                                          float (&m)[NT][2],
                                          float (&l)[NT][2],
                                          float (&acc)[HD / 16][NT][4]) {
  constexpr int PITCH = Geom<HD>::PITCH;
  const int r = lane >> 2, t4 = lane & 3;
  const int j8 = lane & 7, q8 = lane >> 3;

  // S^T (64 keys x 8 NT queries) = K . Q^T, 16 keys an m-block
  float s[4][NT][4];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mb][nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t bq[NT][2];
    if constexpr (NT == 1) {
      uint32_t x[2];
      ldsm_x2(x, qs + j8 * PITCH + (16 * kk + 8 * (q8 & 1)) * 2);
      bq[0][0] = x[0];
      bq[0][1] = x[1];
    } else {
      uint32_t x[4];
      ldsm_x4(x, qs + (j8 + 8 * (q8 >> 1)) * PITCH +
                     (16 * kk + 8 * (q8 & 1)) * 2);
      bq[0][0] = x[0];
      bq[0][1] = x[1];
      bq[1][0] = x[2];
      bq[1][1] = x[3];
    }
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
      if (!FULL && !((vm >> (16 * mb)) & 0xFFFFull)) continue;
      uint32_t ak[4];
      ldsm_x4(ak, kv_addr<HD>(ks, 16 * mb + j8 + 8 * (q8 & 1),
                              16 * kk + 8 * (q8 >> 1), swm));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16_16816(s[mb][nt], ak, bq[nt][0], bq[nt][1]);
    }
  }

  // the softmax step of the tile: score (key 16 mb + r + 8 h, query
  // 8 nt + 2 t4 + e) is s[mb][nt][2 h + e]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = kNegInf;
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = 16 * mb + r + 8 * h;
          const float x = FULL || (vm >> key) & 1ull
                              ? s[mb][nt][2 * h + e] * scale_log2
                              : kNegInf;
          s[mb][nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[nt][e], mx);
      const float corr = exp2f(m[nt][e] - m_new);
      m[nt][e] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = 16 * mb + r + 8 * h;
          const float p = FULL || (vm >> key) & 1ull
                              ? exp2f(s[mb][nt][2 * h + e] - m_new) : 0.f;
          s[mb][nt][2 * h + e] = p;
          psum += p;
        }
      l[nt][e] = l[nt][e] * corr + psum;
#pragma unroll
      for (int md = 0; md < HD / 16; ++md) {
        acc[md][nt][e] *= corr;
        acc[md][nt][2 + e] *= corr;
      }
    }

  // P^T's B fragments: each 8x8 block (keys x queries) of P in bf16,
  // turned over so that the lane holds query lane / 4, keys 2 t4 (+ 1)
  uint32_t pb[4][NT][2];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pb[mb][nt][0] = movmatrix_t(pack_bf16x2(s[mb][nt][0], s[mb][nt][1]));
      pb[mb][nt][1] = movmatrix_t(pack_bf16x2(s[mb][nt][2], s[mb][nt][3]));
    }

  // out^T += V^T . P^T, a k16 step a 16-key block
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
    const uint32_t bits = (uint32_t)(vm >> (16 * mb)) & 0xFFFFu;
    if (!FULL && !bits) continue;
    // masked rows may hold anything: zero their V^T halves (a0, a1:
    // keys 2 t4, 2 t4 + 1; a2, a3: the same + 8)
    uint32_t m01 = ~0u, m89 = ~0u;
    if (!FULL) {
      m01 = ((bits >> (2 * t4)) & 1u ? 0x0000FFFFu : 0u) |
            ((bits >> (2 * t4 + 1)) & 1u ? 0xFFFF0000u : 0u);
      m89 = ((bits >> (2 * t4 + 8)) & 1u ? 0x0000FFFFu : 0u) |
            ((bits >> (2 * t4 + 9)) & 1u ? 0xFFFF0000u : 0u);
    }
#pragma unroll
    for (int md = 0; md < HD / 16; ++md) {
      uint32_t av[4];
      ldsm_x4_t(av, kv_addr<HD>(vs, 16 * mb + j8 + 8 * (q8 >> 1),
                                16 * md + 8 * (q8 & 1), swm));
      if (!FULL) {
        av[0] &= m01;
        av[1] &= m01;
        av[2] &= m89;
        av[3] &= m89;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16_16816(acc[md][nt], av, pb[mb][nt][0], pb[mb][nt][1]);
    }
  }
}

// ---- the kernel ------------------------------------------------------ //

// Grid (n_split, B * K): blockIdx.x is the chunk (the cluster rank when
// a.cluster > 1), blockIdx.y the (row, kv head); query rows a.g0 ..
// a.g0 + min(8 NT, G - g0) of it.  NCW consumer warps, then the producer.
template <class Src, int HD, int NT>
__global__ void __launch_bounds__(Geom<HD>::THREADS, Geom<HD>::MIN_CTAS)
    split_decode_tc(const __grid_constant__ Src src, const Args a) {
  using Gm = Geom<HD>;
  constexpr int NCW = Gm::NCW, THREADS = Gm::THREADS, PITCH = Gm::PITCH;
  static_assert(Gm::Q % 16 == 0 && Gm::RING % 1024 == 0, "layout");
  constexpr int GP = 8 * NT;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;   // the swizzle's period
  uint8_t* const smem = smem_raw + (ring - raw);
  const uint32_t qs = ring + Gm::RING;
  const uint32_t bars = qs + Gm::Q;
  unsigned long long* const vmasks =
      reinterpret_cast<unsigned long long*>(smem + Gm::RING + Gm::Q +
                                            16 * NCW);
  const uint32_t swm = src.swizzle_mask(Gm::SWM);
  const int split = blockIdx.x, n_split = gridDim.x;
  const int bk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool clustered = a.cluster > 1;

  Ctx cx;
  cx.b = bk / a.n_kv;
  cx.kh = bk % a.n_kv;
  cx.pos = a.pos[cx.b];
  const uint32_t mask = src.span(cx, split, n_split, a.window, a.prefix);
  const bool run = (mask >> split) & 1u;
  const int n_run = __popc(mask);
  // a chunk that does not run stores nothing; in a cluster it still
  // merges its slice of the output
  if (!run && (!clustered || n_run == 1)) return;
  const int ng = min(GP, a.G - a.g0);
  const int n_tiles = run ? (cx.n_rows + kRows - 1) / kRows : 0;
  auto reach = [&](int t) {   // the Pallas kernel's block skip
    if (a.window <= 0) return true;
    const int p0 = cx.c0 + t * kRows;
    return p0 + kRows - 1 > cx.pos - a.window ||
           (a.prefix > 0 && p0 < a.prefix);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NCW; ++s) {
      mbar_init(bars + 8 * s, 1);           // full: the producer's arrive
      mbar_init(bars + 8 * (NCW + s), 1);   // empty: the consumer's
    }
    mbar_fence_init();
  }
  __syncthreads();

  float m[NT][2], l[NT][2], acc[HD / 16][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nt][e] = kNegInf;
      l[nt][e] = 0.f;
    }
#pragma unroll
  for (int md = 0; md < HD / 16; ++md)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[md][nt][c] = 0.f;

  if (warp == NCW) {
    // the producer: tile `it` of the CTA's running tiles into stage
    // it % NCW, once its consumer has freed it
    if (lane == 0 && n_tiles > 0) {
      tma_prefetch(&src.mk);
      tma_prefetch(&src.mv);
    }
    int t = 0;
    while (t < n_tiles && !reach(t)) ++t;
    typename Src::Ids cur{};
    if (t < n_tiles) cur = src.ids(cx, t * kRows, lane);
    for (int it = 0; t < n_tiles; ++it) {
      int tn = t + 1;
      while (tn < n_tiles && !reach(tn)) ++tn;
      typename Src::Ids nxt{};
      if (tn < n_tiles) nxt = src.ids(cx, tn * kRows, lane);
      const int slot = it % NCW;
      if (it >= NCW) mbar_wait(bars + 8 * (NCW + slot), (it / NCW - 1) & 1);
      const int t0 = t * kRows;
      auto visible = [&](int local) {
        if (local >= cx.n_rows) return false;
        if (a.window <= 0) return true;
        const int p = cx.c0 + local;
        return p > cx.pos - a.window || (a.prefix > 0 && p < a.prefix);
      };
      const bool ok0 =
          src.mapped(cx, cur, t0, t0 + lane) && visible(t0 + lane);
      const bool ok1 =
          src.mapped(cx, cur, t0, t0 + 32 + lane) && visible(t0 + 32 + lane);
      const unsigned long long vm =
          __ballot_sync(0xffffffffu, ok0) |
          (unsigned long long)__ballot_sync(0xffffffffu, ok1) << 32;
      const uint32_t full = bars + 8 * slot;
      if (lane == 0) {
        vmasks[slot] = vm;
        mbar_arrive_expect_tx(full, src.template bytes<HD>(vm));
      }
      __syncwarp();
      const uint32_t sk = ring + slot * Gm::STAGE;
      src.template issue<HD>(cx, cur, t0, vm, sk, sk + Gm::TILE, full, lane);
      cur = nxt;
      t = tn;
    }
  } else if (n_tiles > 0) {
    // the group's query rows, bf16 as given; rows ng.. zero
    const bf16* qg = a.q + ((size_t)bk * a.G + a.g0) * HD;
    for (int i = threadIdx.x; i < GP * (HD / 8); i += 32 * NCW) {
      const int g = i / (HD / 8), c = i % (HD / 8);
      const uint4 v = g < ng ? load_raw(qg + (size_t)g * HD + c * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(smem + Gm::RING + g * PITCH + c * 16) = v;
    }
    named_bar_sync(1, 32 * NCW);
    int it = 0, j = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (!reach(t)) continue;
      if (it++ % NCW != warp) continue;
      mbar_wait(bars + 8 * warp, j++ & 1);
      const unsigned long long vm = vmasks[warp];
      const uint32_t sk = ring + warp * Gm::STAGE;
      if (vm == ~0ull)   // every row visible: no mask anywhere
        fold_tile<HD, NT, true>(sk, sk + Gm::TILE, swm, qs, vm,
                                a.scale_log2, lane, m, l, acc);
      else if (vm)
        fold_tile<HD, NT, false>(sk, sk + Gm::TILE, swm, qs, vm,
                                 a.scale_log2, lane, m, l, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (NCW + warp));
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 4);
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 8);
      l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], 16);
    }

  // every tile is consumed: the ring holds the merge from here on
  __syncthreads();
  float* const wm = reinterpret_cast<float*>(smem);   // [NCW][kMaxG]
  float* const wl = wm + NCW * kMaxG;
  float* const wacc = wl + NCW * kMaxG;               // [NCW][kMaxG][HD]
  float* const pm = wacc + NCW * kMaxG * HD;          // the CTA's partial
  float* const pl = pm + kMaxG;
  float* const pacc = pl + kMaxG;                     // [kMaxG][HD]
  if (warp < NCW) {
    const int r = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int md = 0; md < HD / 16; ++md)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wacc[(warp * kMaxG + 8 * nt + 2 * t4 + (c & 1)) * HD + 16 * md + r +
               8 * (c >> 1)] = acc[md][nt][c];
    if (r == 0)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wm[warp * kMaxG + 8 * nt + 2 * t4 + e] = m[nt][e];
          wl[warp * kMaxG + 8 * nt + 2 * t4 + e] = l[nt][e];
        }
  }
  __syncthreads();

  bf16* const out = a.out + ((size_t)bk * a.G + a.g0) * HD;
  const int n_bk = gridDim.y;
  float* const ml = a.ws + (size_t)bk * n_split * kMaxG * 2;
  float* const sums = a.ws + (size_t)n_bk * n_split * kMaxG * 2 +
                      (size_t)bk * n_split * kMaxG * HD;
  // the CTA's warps merged in warp order
  for (int idx = threadIdx.x; idx < ng * HD; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NCW; ++w) mx = fmaxf(mx, wm[w * kMaxG + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float wt = exp2f(wm[w * kMaxG + g] - mx);
      den = fmaf(wl[w * kMaxG + g], wt, den);
      num = fmaf(wacc[(w * kMaxG + g) * HD + d], wt, num);
    }
    if (n_run == 1) {
      out[(size_t)g * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else if (clustered) {
      pacc[g * HD + d] = num;
      if (d == 0) {
        pm[g] = mx;
        pl[g] = den;
      }
    } else {   // merge_splits' units: m in nats
      sums[((size_t)split * kMaxG + g) * HD + d] = num;
      if (d == 0) {
        ml[(split * kMaxG + g) * 2] = mx * kLn2;
        ml[(split * kMaxG + g) * 2 + 1] = den;
      }
    }
  }
  if (n_run == 1) return;

  if (!clustered) {
    if (!last_to_arrive(a.tickets + bk, (unsigned)n_run)) return;
    merge_splits<bf16, HD, THREADS>(mask, n_split, ml, sums, kMaxG * 2,
                                    kMaxG * HD, out, ng);
    return;
  }

  // the cluster: rank `split` merges its slice of the ng x HD outputs over
  // the running ranks in rank order, reading their partials in place
  cluster_sync();
  const int total = ng * HD, per = (total + n_split - 1) / n_split;
  const int hi_idx = min((split + 1) * per, total);
  const uint32_t pm_a = smem_addr(pm), pl_a = smem_addr(pl),
                 pacc_a = smem_addr(pacc);
  for (int idx = split * per + threadIdx.x; idx < hi_idx; idx += THREADS) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
    for (int rk = 0; rk < n_split; ++rk)
      if ((mask >> rk) & 1u)
        mx = fmaxf(mx, ld_cluster_f32(cluster_map(pm_a + 4 * g, rk)));
    float den = 0.f, num = 0.f;
    for (int rk = 0; rk < n_split; ++rk) {
      if (!((mask >> rk) & 1u)) continue;
      const float mr = ld_cluster_f32(cluster_map(pm_a + 4 * g, rk));
      const float lr = ld_cluster_f32(cluster_map(pl_a + 4 * g, rk));
      const float ar = ld_cluster_f32(cluster_map(pacc_a + 4 * idx, rk));
      const float wt = exp2f(mr - mx);
      den = fmaf(lr, wt, den);
      num = fmaf(ar, wt, num);
    }
    out[(size_t)g * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  cluster_sync();   // every partial stays until the others have read it
}

// ---- the launch ------------------------------------------------------ //

template <int HD>
constexpr CUtensorMapSwizzle box_swizzle() {
  return Geom<HD>::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : Geom<HD>::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The contiguous kernel's source: k, v (B, K, S, hd) views with element
// strides sb, sk, ss (a stride of a dimension of size 1 is never followed:
// it is given as one row).
struct ContigParams {
  using Src = ContigRows;
  const void* k;
  const void* v;
  int B, K, S;
  long long sb, sk, ss;
  int chunk;
  template <int HD>
  bool make(ContigRows& r) const {
    const long long one = 2 * HD;
    const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)S, (uint64_t)K,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)(S > 1 ? 2 * ss : one),
                                 (uint64_t)(K > 1 ? 2 * sk : one),
                                 (uint64_t)(B > 1 ? 2 * sb : one)};
    const uint32_t box[4] = {(uint32_t)Geom<HD>::BW, (uint32_t)kRows, 1, 1};
    r.S = S;
    r.chunk = chunk;
    constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    return tensor_map_nd(&r.mk, bf, 4, k, dims, strides, box,
                         box_swizzle<HD>()) &&
           tensor_map_nd(&r.mv, bf, 4, v, dims, strides, box,
                         box_swizzle<HD>());
  }
};

// The paged kernel's source: pools (P, ps, K, hd), contiguous, as (hd, K,
// P * ps) in boxes of br = gcd(ps, 64) rows.
struct PagedParams {
  using Src = PagedRows;
  const void* k;
  const void* v;
  const int* table;
  int P, ps, K, pps, ppc;
  template <int HD>
  bool make(PagedRows& r) const {
    int br = 64, x = ps;
    while (x != 0) {   // gcd(64, ps)
      const int t = br % x;
      br = x;
      x = t;
    }
    const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)K,
                              (uint64_t)P * ps, 1};
    const uint64_t strides[3] = {(uint64_t)(2 * HD),
                                 (uint64_t)(2 * HD) * K, 0};
    const uint32_t box[4] = {(uint32_t)Geom<HD>::BW, 1, (uint32_t)br, 1};
    const CUtensorMapSwizzle swz =
        br % 8 == 0 ? box_swizzle<HD>() : CU_TENSOR_MAP_SWIZZLE_NONE;
    r.table = table;
    r.n_pages = P;
    r.ps = ps;
    r.pps = pps;
    r.ppc = ppc;
    r.br = br;
    constexpr CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    return tensor_map_nd(&r.mk, bf, 3, k, dims, strides, box, swz) &&
           tensor_map_nd(&r.mv, bf, 3, v, dims, strides, box, swz);
  }
};

// One launch of query rows a.g0 .. + min(16, G - g0): n_split chunks of
// each of the n_bk (row, kv head)s, clusters of `a.cluster` (1, or
// n_split).  The kernel's attributes are set once a process and device.
template <class Src, int HD, int NT>
int launch_variant(const Src& src, const Args& a, int n_split, int n_bk,
                   cudaStream_t stream) {
  auto kernel = split_decode_tc<Src, HD, NT>;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             Geom<HD>::SMEM)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, n_bk);
  cfg.blockDim = dim3(Geom<HD>::THREADS);
  cfg.dynamicSmemBytes = Geom<HD>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, src, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Every launch of G query rows, 16 at a time, at head dim hd, from the
// source prm makes (its tensor maps); the cluster is 1 (one CTA a chunk,
// the global merge where n_split > 1) or n_split (up to kMaxCluster).
// Returns the cudaError_t (0 on success).
template <class Params>
int launch(const Params& prm, Args a, int hd, int n_split, int n_bk,
           cudaStream_t stream) {
  using Src = typename Params::Src;
  if (a.cluster != 1 && (a.cluster != n_split || a.cluster > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && a.cluster == 1 &&
      (a.ws == nullptr || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
#define REPRO_DTC(HD)                                                        \
  case HD: {                                                                 \
    Src src;                                                                 \
    if (!prm.template make<HD>(src)) return (int)cudaErrorInvalidValue;      \
    for (int g0 = 0; g0 < a.G; g0 += kMaxG) {                                \
      a.g0 = g0;                                                             \
      const int err =                                                        \
          a.G - g0 > 8                                                       \
              ? launch_variant<Src, HD, 2>(src, a, n_split, n_bk, stream)    \
              : launch_variant<Src, HD, 1>(src, a, n_split, n_bk, stream);   \
      if (err != 0) return err;                                              \
    }                                                                        \
    return 0;                                                                \
  }
    REPRO_DTC(16) REPRO_DTC(32) REPRO_DTC(64) REPRO_DTC(128) REPRO_DTC(256)
#undef REPRO_DTC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtc
}  // namespace repro
