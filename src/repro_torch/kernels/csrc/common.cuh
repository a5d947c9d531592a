// Shared helpers of the port's hand-written kernels.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// -1e30, the masked-score value of the JAX package's kernels: exp() of a
// fully masked running max minus itself is 1, and the next real score's
// correction factor exp(-1e30 - m) wipes that state, exactly as there.
constexpr float kNegInf = -1e30f;

// Elements per 16-byte vector load.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// A 16-byte load kept packed (4 registers) and its widening to f32:
// loading several rows packed and widening each just before use keeps
// more rows in flight for the registers of fewer widened ones.
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack_vec(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack_vec(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One 16-byte load of Vec<T>::N elements, widened to f32.
__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  unpack_vec(load_raw(p), out);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[8]) {
  unpack_vec(load_raw(p), out);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// ---- decode attention: one query token against rows of keys/values ---- //
// A group of LPR lanes owns one key/value row, each lane EPL elements of
// it along hd (NV 16-byte vectors, side by side from d0 = (lane % LPR) *
// EPL); the group keeps its own online-softmax state (m, l, acc) for GC
// query rows in registers.  A row takes at most a warp: at hd 256 in f32
// (64 vectors a row) each of the 32 lanes holds two vectors.
template <typename T, int HD>
struct RowLayout {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int LPR = HD / VEC < 32 ? HD / VEC : 32;  // lanes a row
  static constexpr int NV = HD / (VEC * LPR);      // vectors a lane
  static constexpr int EPL = VEC * NV;             // elements a lane
  static constexpr int RPW = 32 / LPR;             // rows a warp pass
  static_assert(LPR * EPL == HD, "hd must be a whole number of vectors");
};

// EPL elements at p as EPL / Vec<T>::N 16-byte loads, widened to f32.
template <typename T, int EPL>
__device__ __forceinline__ void load_elems(const T* p, float (&out)[EPL]) {
  constexpr int N = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < EPL / N; ++j) {
    float v[N];
    load_vec(p + j * N, v);
#pragma unroll
    for (int e = 0; e < N; ++e) out[j * N + e] = v[e];
  }
}

// Fold one key/value row into the group's state.  Every lane of the warp
// must call it (the q.k partial sums are reduced with shuffles); `valid`
// is the row's mask bit.
template <int GC, int EPL, int LPR>
__device__ __forceinline__ void online_row(const float (&qv)[GC][EPL],
                                           const float (&kr)[EPL],
                                           const float (&vr)[EPL],
                                           bool valid, float (&m)[GC],
                                           float (&l)[GC],
                                           float (&acc)[GC][EPL]) {
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) s = fmaf(qv[g][e], kr[e], s);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (valid) {
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = fmaf(p, vr[e], acc[g][e] * corr);
      m[g] = m_new;
    }
  }
}

// The group's query rows, scaled by sm_scale, and an empty state: q_row
// points at query row 0 of the (slot, kv head), the lane's d0 included;
// rows from ng on stay zero.
template <typename T, int GC, int EPL, int HD>
__device__ __forceinline__ void load_query(const T* q_row, int ng,
                                           float sm_scale,
                                           float (&qv)[GC][EPL],
                                           float (&m)[GC], float (&l)[GC],
                                           float (&acc)[GC][EPL]) {
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { qv[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < ng) {
      load_elems<T, EPL>(q_row + (size_t)g * HD, qv[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] *= sm_scale;
    }
  }
}

// Fold one block of key/value rows into the group's state: rows r =
// u * RPW + grp (u < UNROLL) at kb, vb + r * stride elements, read only
// for r < n_rows.  All 2 * UNROLL * NV loads are issued packed before the
// first is used, so that many 16-byte loads a lane are in flight.  Row r
// sits at kv_pos0 + r; with a window it is visible only inside the window
// or the prefix.  Every lane of the warp must call it.
template <int GC, int EPL, int LPR, int RPW, int UNROLL, typename T>
__device__ __forceinline__ void fold_block(
    const T* kb, const T* vb, long long stride, int n_rows, int kv_pos0,
    int pos, int window, int prefix, int grp, const float (&qv)[GC][EPL],
    float (&m)[GC], float (&l)[GC], float (&acc)[GC][EPL]) {
  constexpr int N = Vec<T>::N;
  constexpr int NV = EPL / N;
  uint4 kr[UNROLL][NV], vr[UNROLL][NV];   // packed: 4 registers a vector
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int r = u * RPW + grp;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (r < n_rows) {
        kr[u][j] = load_raw(kb + r * stride + j * N);
        vr[u][j] = load_raw(vb + r * stride + j * N);
      } else {
        kr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        vr[u][j] = kr[u][j];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int r = u * RPW + grp;
    bool valid = r < n_rows;
    if (window > 0) {
      const int t = kv_pos0 + r;
      valid = valid && (t > pos - window || (prefix > 0 && t < prefix));
    }
    float kf[EPL], vf[EPL];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float kt[N], vt[N];
      unpack_vec(kr[u][j], kt);
      unpack_vec(vr[u][j], vt);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        kf[j * N + e] = kt[e];
        vf[j * N + e] = vt[e];
      }
    }
    online_row<GC, EPL, LPR>(qv, kf, vf, valid, m, l, acc);
  }
}

// The chunks of a split decode that run, as a bit mask: chunk 0 always;
// chunk c (rows c * chunk onwards) if it begins at or before `last` and
// reaches the window (or the prefix).  A function of pos alone, so every
// CTA of a (row, kv head) finds the same mask.
__device__ __forceinline__ uint32_t running_chunks(int n_split, int chunk,
                                                   int last, int pos,
                                                   int window, int prefix) {
  uint32_t mask = 1u;
  for (int c = 1; c < n_split; ++c) {
    const int c0 = c * chunk;
    bool run = c0 <= last;
    if (window > 0) {
      bool reach = c0 + chunk - 1 > pos - window;
      if (prefix > 0) reach = reach || c0 < prefix;
      run = run && reach;
    }
    if (run) mask |= 1u << c;
  }
  return mask;
}

// ---- partials across CTAs (split-sequence decode, split-K) ---------- //

// Merge the CTA's NPART group states (the usual log-sum-exp rescale) of
// the first `ng` query rows and either store them normalised (`out`
// non-null: row g at out + g * HD) or, for a split kernel, keep the
// un-normalised f32 partial: (m, l) at pml[2g], pml[2g + 1] and the
// weighted sum at pacc[g * HD + d].  `part` is the calling group's
// index, d0 its lanes' first element along hd.  Every thread of the CTA
// must call it.
template <typename T, int GC, int EPL, int HD, int NPART, int NTHREADS>
__device__ __forceinline__ void merge_partial(
    int part, bool group_leader, int d0, const float (&m)[GC],
    const float (&l)[GC], const float (&acc)[GC][EPL], T* __restrict__ out,
    float* __restrict__ pml, float* __restrict__ pacc, int ng) {
  __shared__ float sm_m[NPART][GC];
  __shared__ float sm_l[NPART][GC];
  __shared__ float sm_acc[NPART][GC][HD];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (group_leader) { sm_m[part][g] = m[g]; sm_l[part][g] = l[g]; }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[part][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
    for (int p = 0; p < NPART; ++p) mx = fmaxf(mx, sm_m[p][g]);
    float den = 0.f, num = 0.f;
    for (int p = 0; p < NPART; ++p) {
      const float w = expf(sm_m[p][g] - mx);
      den = fmaf(sm_l[p][g], w, den);
      num = fmaf(sm_acc[p][g][d], w, num);
    }
    if (out != nullptr) {
      out[(size_t)g * HD + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      pacc[g * HD + d] = num;
      if (d == 0) { pml[2 * g] = mx; pml[2 * g + 1] = den; }
    }
  }
}

// The CTAs of one group (the splits of a (row, kv head), the K splits of
// an output tile) each store a partial and call this; it returns true in
// the CTA that arrives last, which then merges every partial in a fixed
// order.  The ticket decides only who merges, never the order of a sum,
// so the result is bit-identical from launch to launch.  The last CTA
// resets the counter, so the kernel leaves every counter at 0 for the
// next launch (counters start zeroed: the wrapper allocates them once
// per stream with torch.zeros).  Every thread of the CTA must call it.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter,
                                               unsigned n) {
  __shared__ bool last;
  __threadfence();           // this thread's partial, device-wide, first
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == n - 1;
    if (last) atomicExch(counter, 0u);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// JAX's sequence-sharded combine (repro/kernels/ops.py, the shard_fn of
// decode_attention_sharded) over the first n_split splits whose bit is set
// in `mask`, in split order: the max of their m, then l and the weighted
// sums scaled by exp(m_s - max) and summed; out = num / max(l, 1e-30).
// Split s of row g keeps (m, l) at pml + s * sml + 2g and its sum at
// pacc + s * sacc + g * HD, written by other CTAs of this launch: read
// through L2 (ld.global.cg), never a stale L1 line.  The split loops are
// unrolled with predicated loads, so a thread's loads are in flight
// together rather than one L2 round trip after another.  Every thread
// must call it.
template <typename T, int HD, int NTHREADS>
__device__ __forceinline__ void merge_splits(uint32_t mask, int n_split,
                                             const float* pml,
                                             const float* pacc, int sml,
                                             int sacc, T* __restrict__ out,
                                             int ng) {
  for (int idx = threadIdx.x; idx < ng * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      if ((mask >> s) & 1u) mx = fmaxf(mx, __ldcg(pml + s * sml + 2 * g));
    float den = 0.f, num = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      if ((mask >> s) & 1u) {
        const float w = expf(__ldcg(pml + s * sml + 2 * g) - mx);
        den = fmaf(__ldcg(pml + s * sml + 2 * g + 1), w, den);
        num = fmaf(__ldcg(pacc + s * sacc + g * HD + d), w, num);
      }
    }
    out[(size_t)g * HD + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

// The end of a split decode CTA, chunk `split` of n_split of the (row, kv
// head) bk of n_bk, whose running chunks are `mask`: the CTA merges its
// groups' states (merge_partial) and, if it is the only chunk that runs,
// stores the normalised rows at o, with the same arithmetic as the merge
// of one partial.  Otherwise it stores its f32 partial in ws, laid out as
// (m, l) of [n_bk][n_split][MAXG] and then the sums of
// [n_bk][n_split][MAXG][HD], and the last CTA to arrive (a counter per bk
// in `tickets`, left at 0) merges the running chunks in chunk order
// (merge_splits).  Every thread of the CTA must call it.
template <typename T, int GC, int EPL, int HD, int NPART, int NTHREADS,
          int MAXG>
__device__ __forceinline__ void finish_split(
    uint32_t mask, int bk, int n_bk, int split, int n_split, int part,
    bool group_leader, int d0, const float (&m)[GC], const float (&l)[GC],
    const float (&acc)[GC][EPL], T* __restrict__ o, float* __restrict__ ws,
    unsigned* __restrict__ tickets, int ng) {
  const int n_run = __popc(mask);
  if (n_run == 1) {
    merge_partial<T, GC, EPL, HD, NPART, NTHREADS>(
        part, group_leader, d0, m, l, acc, o, nullptr, nullptr, ng);
    return;
  }
  float* ml = ws + (size_t)bk * n_split * MAXG * 2;
  float* sums = ws + (size_t)n_bk * n_split * MAXG * 2 +
                (size_t)bk * n_split * MAXG * HD;
  merge_partial<T, GC, EPL, HD, NPART, NTHREADS>(
      part, group_leader, d0, m, l, acc, nullptr, ml + split * MAXG * 2,
      sums + (size_t)split * MAXG * HD, ng);
  if (!last_to_arrive(tickets + bk, (unsigned)n_run)) return;
  merge_splits<T, HD, NTHREADS>(mask, n_split, ml, sums, MAXG * 2,
                                MAXG * HD, o, ng);
}

// ---- Hopper PTX building blocks (tensor-core kernels) ---------------- //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mbarriers of the calling CTA (shared::cta; in a cluster too).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over the first `count` threads of the block.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Named barrier: arrive without waiting (the other side of named_bar_sync;
// the barrier completes when `count` threads have arrived or synced).
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Warp specialisation: a warpgroup hands registers back (a producer) or
// takes them (a consumer); all four warps of the warpgroup execute it.
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// ---- wgmma ----------------------------------------------------------- //

// A shared-memory matrix descriptor.  `layout`: 1 = 128-byte swizzle, 2 =
// 64-byte, 3 = 32-byte (the swizzle TMA wrote the tile with).  A K-major
// operand reads 16 values (32 bytes) of each row from the start address,
// rows 8 at a time SBO bytes apart (LBO unused); an MN-major one reads 8
// rows of the swizzle's width, its next 8 rows SBO bytes on and its next
// column block LBO bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x N f32, this warpgroup's fragment: value 4j + 2h + e of lane l in
// warp w is row 16w + l/4 + 8h, column 8j + 2(l%4) + e) = A . B + (scale_d
// ? d : 0), one k16 step, bf16 operands.  wgmma_ss: A (64 x 16, K-major)
// and B through shared-memory descriptors; TB = 1 reads B N-major.
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
}

// As wgmma_ss with A from registers: the m16n8k16 A fragment of each
// warp's 16 rows (a[0] row l/4, columns 2(l%4) + {0, 1}; a[1] row + 8;
// a[2], a[3] the same at column + 8).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95 "
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma writes (accumulators) or reads (A fragments) across
// the wgmma or its wait.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

// ---- TMA ------------------------------------------------------------- //

// Tile loads into shared memory, completing on the mbarrier `bar`; c0 is
// the innermost coordinate.  Rows past the tensor's bounds land as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// A tile store from shared memory (written by this thread's CTA, made
// visible with fence_proxy_async first); elements past the tensor's
// bounds are not written.  bulk_commit closes the group of stores,
// bulk_wait_read<0> waits until their reads of shared memory are done.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// Wait until the committed stores are complete (not only their reads).
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}
// Fetch a tensor map (a kernel parameter) ahead of its first copy.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- thread block clusters ------------------------------------------- //

// Every thread of every CTA of the cluster arrives (its shared-memory
// writes released) and waits for the others (theirs acquired).  All
// threads of a warp execute it together.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The two halves of cluster_sync: arrive without ordering (a CTA says it
// has started, before any other reads or writes its shared memory) and
// wait for the phase (each thread alternates arrive and wait).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// The shared-memory address `addr` of this CTA as the same address in the
// CTA of cluster rank `rank`, and a load from there.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr,
                                                uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(addr), "f"(v) : "memory");
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda);
// null where the installed CUDA has no such entry point.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// encode(out, ...) (no interleave, L2 promotion of 128 bytes, zero fill
// past the bounds) from any host thread.  The encoder checks the global
// address in the calling thread's current context, and a thread whose
// first CUDA call this is has none yet (its launch came back refused):
// where the encoder refuses, cudaFree(nullptr) binds the device's primary
// context to the thread and the map is encoded once more.
inline bool encode_map(EncodeTiled encode, CUtensorMap* out,
                       CUtensorMapDataType dtype, int rank, const void* p,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (encode(out, dtype, rank, const_cast<void*>(p), dims, strides, box,
               ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS)
      return true;
    if (attempt == 0) cudaFree(nullptr);
  }
  return false;
}

// A tensor map of rank 1 to 4 (dims, strides in bytes of dims 1.., box;
// as encode_map), encoded once for each distinct set of arguments: each
// host thread keeps the last 4 of each of 32 sets, so the maps of a
// weight, or of every layer's cache, stay encoded from call to call.  A
// map is a pure function of its arguments, so a pointer freed and reused
// for a tensor of the same layout finds a map that is still right.
// False where the map cannot be encoded.
inline bool tensor_map_nd(CUtensorMap* out, CUtensorMapDataType dtype,
                          int rank, const void* p, const uint64_t (&dims)[4],
                          const uint64_t (&strides)[3],
                          const uint32_t (&box)[4],
                          CUtensorMapSwizzle swizzle) {
  struct Entry {
    CUtensorMap map;
    const void* p;
    uint64_t dims[4], strides[3];
    uint32_t box[4];
    int dtype, rank, swizzle;
  };
  constexpr int kSets = 32, kWays = 4;
  thread_local Entry cache[kSets][kWays];
  thread_local int filled[kSets] = {}, next[kSets] = {};
  auto same = [&](const Entry& e) {
    if (e.p != p || e.dtype != (int)dtype || e.rank != rank ||
        e.swizzle != (int)swizzle)
      return false;
    for (int i = 0; i < 4; ++i)
      if (e.dims[i] != dims[i] || e.box[i] != box[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (e.strides[i] != strides[i]) return false;
    return true;
  };
  uint64_t h = reinterpret_cast<uintptr_t>(p) >> 4;
  h ^= dims[1] * 0x9E3779B97F4A7C15ull ^ strides[0] * 31 ^ box[1] ^ box[2];
  const int set = (int)((h ^ (h >> 29)) % kSets);
  for (int w = 0; w < filled[set]; ++w) {
    if (same(cache[set][w])) {
      *out = cache[set][w].map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr ||
      !encode_map(encode, out, dtype, rank, p, dims, strides, box, swizzle))
    return false;
  const int w = filled[set] < kWays ? filled[set]++ : next[set]++ % kWays;
  Entry& e = cache[set][w];
  e.map = *out;
  e.p = p;
  e.dtype = (int)dtype;
  e.rank = rank;
  e.swizzle = (int)swizzle;
  for (int i = 0; i < 4; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
  }
  for (int i = 0; i < 3; ++i) e.strides[i] = strides[i];
  return true;
}

// tensor_map_nd at rank 1 or 2: dims (d0, d1), the row stride in bytes,
// box (b0, b1).
inline bool tensor_map(CUtensorMap* out, CUtensorMapDataType dtype, int rank,
                       const void* p, uint64_t d0, uint64_t d1,
                       uint64_t stride_bytes, uint32_t b0, uint32_t b1,
                       CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {d0, d1, 1, 1};
  const uint64_t strides[3] = {stride_bytes, 0, 0};
  const uint32_t box[4] = {b0, b1, 1, 1};
  return tensor_map_nd(out, dtype, rank, p, dims, strides, box, swizzle);
}

}  // namespace repro
