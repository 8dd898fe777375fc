// Single-query (decode) GQA attention over a dense or a paged KV cache, for
// Hopper (sm_90a): split-K ("flash-decoding").  Plain C interface, bound
// from Python with ctypes.
//
// Replaces the Pallas TPU kernels
//   B1  src/repro/kernels/decode_attention/kernel.py::_decode_kernel
//   B2  src/repro/kernels/decode_attention/paged.py::_paged_decode_kernel
// with one template: PAGED only changes where logical position t lives,
//   dense  row = b * M + t
//   paged  row = ptab[b, t / ps] * ps + t % ps
// in a (rows, Hkv, dh) cache.  The TPU kernels walk a row's positions on a
// sequential grid axis and carry m, l and acc in VMEM scratch; CUDA blocks
// run in no order, so here the positions are split across CTAs and the
// partial softmaxes are merged by a second kernel.
//
// Bound.  The work is O(1) FLOP per byte: it moves
//   sum_b 2 * kv_len[b] * Hkv * dh * itemsize  bytes of K/V
// plus q and out, so it is HBM-bound (3.35 TB/s on an H100 SXM) and, at the
// serving widths (a few MB per call), bound by the launch and the latency
// of one round of loads.  What the design does about it:
//
// Split.  Kernel 1 runs one CTA of four warps per (split s, kv head, row b):
// split s covers logical positions [s * C, (s + 1) * C) that are < kv_len[b],
// with C a compile-time constant of the source (never derived from the
// cache's capacity, the batch or the page size).  The grid has
// n_split = ceil(cap / C) splits, from shapes only, so the host never reads
// kv_len; a CTA whose split starts at or past kv_len exits at once.  One
// MQA row of 2048 positions thus spreads over 32 CTAs instead of one.
// C = 64 at every head dim (C = 128 at dh 64 measured slower; see
// PERF.md); decode_attention_workspace gives the wrapper the workspace
// size, so the partition rule lives here alone.
//
// Staging.  Every thread issues its 16-byte cp.async copies (cg: L2 only)
// of the split's K rows (and q), commits, then those of its V rows, and
// commits again, before any compute; the scores wait only for K, so the V
// copies overlap them.  K/V stay in the input type in shared memory, rows
// padded by 16 bytes (conflict-free fragment loads); rows past kv_len are
// zero-filled, never loaded, so positions >= kv_len (the trash page) are
// not read at all.  At C 64 and dh 256 in bf16 the CTA holds 66 KB of K/V,
// so two CTAs share an SM.
//
// Products.  For bf16 the scores and P.V run on tensor cores with warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate): the GQA group is padded to
// the 16 rows of the A operand (10 for recurrentgemma-2b, 3 for the demo
// LM; larger groups take several 16-row blocks).  wgmma would want 64 rows,
// 4-20x more padding, for a product this small.  Warp w computes the scores
// of positions [w C/4, (w+1) C/4) of the split, and the softmax runs in
// registers: row maxima and sums reduce by shuffles within the warp and
// across the four warps through 512 bytes of shared memory.  P is rounded
// to bf16 for the P.V product, as FlashAttention-2 does, and l sums the
// rounded weights.  Warp w then owns dims [w dh/4, (w+1) dh/4) of the
// accumulator, in registers, with V fragments from ldmatrix.trans, two
// n-tiles per x4 load (dh 160 gives each warp 5 n-tiles of 8 dims: the
// fifth comes from an x2 load, so the cache keeps its 160-wide rows,
// unpadded).  The f32
// instances (tests and chip_smoke.py only) use the same split, staging and
// merge with fmaf on the CUDA cores.
//
// Merge.  Each split writes its unnormalised (m, l, acc) in f32 to a
// workspace the wrapper allocates.  Kernel 2, one CTA per (query head, row)
// and one thread per dim, folds splits 0 .. ceil(kv_len / C) - 1 in that
// order (max first, then the weighted sums with fmaf), skipping empty
// splits; rows with kv_len == 0 write exact zeros.  On request it also
// writes each (row, query head)'s log-sum-exp of the scaled scores, f32,
// m + log l (-inf for kv_len == 0): the partial a caller merges with
// other slices of the same row (a cache whose length is sharded).  It is launched as a
// programmatic dependent of kernel 1 (every split CTA signals at its
// start), so its launch overlaps the splits and it waits on
// griddepcontrol.wait before it reads the workspace; the first 16 splits'
// values load while (m, l) are staged.  No atomics: the result is the same
// from call to call, and since every sum runs over logical positions in a
// fixed order, paged == dense bitwise.  (Merging in the last split CTA of
// each (row, kv head) instead saves the second kernel but leaves one SM to
// fold all of a long row's splits: slower on full rings.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C = 64;         // positions per split
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_MAX = 232448;  // 227 KB a block may opt in to

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two 8x8 matrices: addresses from lanes 0-15 (the others' are ignored)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory plan of one split CTA, in elements of T unless said.
template <typename T, int DH> struct Plan {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = DH + PAD;  // K, V, q row stride
  static constexpr int PLD = C + 8;    // bf16 P row stride
  static size_t bytes(int group) {
    const size_t qrows = TC ? (size_t)(group + 15) / 16 * 16 : group;
    size_t n = (2 * (size_t)C + qrows) * LD * sizeof(T);
    if (TC)
      n += 16 * PLD * sizeof(bf16) + 2 * WARPS * 16 * sizeof(float);
    else
      n += (size_t)group * C * sizeof(float);
    return n;
  }
};

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_len;
  const int32_t* ptab;
  float* acc;  // workspace: acc (B, Hkv, n_split, G, dh), f32
  float* ml;   // workspace: (m, l) (B, Hkv, n_split, G, 2), f32
  int batch, hkv, group, cap, page_size, max_pages, n_split;
  float scale;
};

// bf16: scores and P.V on tensor cores; the 16-row block rb of the group.
template <int DH>
__device__ void split_tc(const SplitArgs& a, const bf16* k_s, const bf16* v_s,
                         const bf16* q_s, bf16* p_s, float* red, int n,
                         size_t part) {
  using P = Plan<bf16, DH>;
  constexpr int LD = P::LD, PLD = P::PLD;
  constexpr int SPW = C / WARPS;   // score positions per warp
  constexpr int NTS = SPW / 8;     // score n-tiles per warp
  constexpr int DPW = DH / WARPS;  // accumulator dims per warp
  constexpr int NTO = DPW / 8;     // accumulator n-tiles per warp
  static_assert(SPW % 8 == 0 && DPW % 8 == 0, "tile shape");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int group = a.group;
  float* red_m = red;
  float* red_l = red + WARPS * 16;

  for (int rb = 0; rb * 16 < group; ++rb) {
    const bf16* qb = q_s + rb * 16 * LD;
    // scores of this warp's positions: 16 rows x SPW, f32
    float s[NTS][4];
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t af[4];
      af[0] = lds32(qb + gid * LD + kk + tig * 2);
      af[1] = lds32(qb + (gid + 8) * LD + kk + tig * 2);
      af[2] = lds32(qb + gid * LD + kk + 8 + tig * 2);
      af[3] = lds32(qb + (gid + 8) * LD + kk + 8 + tig * 2);
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) {
        const bf16* kr = k_s + (warp * SPW + nt * 8 + gid) * LD + kk;
        mma_bf16(s[nt], af, lds32(kr + tig * 2), lds32(kr + 8 + tig * 2));
      }
    }
    // softmax over the split: rows gid (regs 0, 1) and gid + 8 (2, 3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = warp * SPW + nt * 8 + tig * 2 + e < n;
        s[nt][e] = ok ? s[nt][e] * a.scale : -INFINITY;
        s[nt][2 + e] = ok ? s[nt][2 + e] * a.scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    if (tig == 0) {
      red_m[warp * 16 + gid] = mx0;
      red_m[warp * 16 + gid + 8] = mx1;
    }
    __syncthreads();
    float m0 = red_m[gid], m1 = red_m[gid + 8];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      m0 = fmaxf(m0, red_m[w * 16 + gid]);
      m1 = fmaxf(m1, red_m[w * 16 + gid + 8]);
    }
    // position 0 of the split is < kv_len, so m0 and m1 are finite
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      const int j = warp * SPW + nt * 8 + tig * 2;
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = j + e < n;
        p[e] = ok ? expf(s[nt][e] - m0) : 0.f;
        p[2 + e] = ok ? expf(s[nt][2 + e] - m1) : 0.f;
      }
      const uint32_t w0 = pack_bf16(p[0], p[1]);
      const uint32_t w1 = pack_bf16(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(p_s + gid * PLD + j) = w0;
      *reinterpret_cast<uint32_t*>(p_s + (gid + 8) * PLD + j) = w1;
      const __nv_bfloat162 r0 = *reinterpret_cast<const __nv_bfloat162*>(&w0);
      const __nv_bfloat162 r1 = *reinterpret_cast<const __nv_bfloat162*>(&w1);
      l0 += __low2float(r0) + __high2float(r0);
      l1 += __low2float(r1) + __high2float(r1);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    if (tig == 0) {
      red_l[warp * 16 + gid] = l0;
      red_l[warp * 16 + gid + 8] = l1;
    }
    cp_async_wait<0>();  // V has landed (this thread's copies)
    __syncthreads();     // ... and every thread's; P and red_l complete
    // acc (16 x DPW of this warp) = P (16 x C) . V (C x DPW)
    float acc[NTO][4];
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t af[4];
      af[0] = lds32(p_s + gid * PLD + kk + tig * 2);
      af[1] = lds32(p_s + (gid + 8) * PLD + kk + tig * 2);
      af[2] = lds32(p_s + gid * PLD + kk + 8 + tig * 2);
      af[3] = lds32(p_s + (gid + 8) * PLD + kk + 8 + tig * 2);
#pragma unroll
      for (int np = 0; np < NTO / 2; ++np) {
        // four 8x8 matrices: (k lo, n lo), (k hi, n lo), (k lo, n hi),
        // (k hi, n hi) -> B fragments of n-tiles 2 np and 2 np + 1
        const int row = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = warp * DPW + np * 16 + (lane >> 4) * 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, v_s + row * LD + col);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
      if constexpr (NTO % 2) {
        // an odd n-tile count (dh 160: 5 per warp): the last n-tile's
        // two matrices, (k lo, n) and (k hi, n), from lanes 0-15
        const int row = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = warp * DPW + (NTO - 1) * 8;
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, v_s + row * LD + col);
        mma_bf16(acc[NTO - 1], af, bf[0], bf[1]);
      }
    }
    // write this split's partials for the real rows of the block
    const int g0 = rb * 16 + gid, g1 = g0 + 8;
#pragma unroll
    for (int nt = 0; nt < NTO; ++nt) {
      const int d = warp * DPW + nt * 8 + tig * 2;
      if (g0 < group)
        *reinterpret_cast<float2*>(a.acc + (part * group + g0) * DH + d) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (g1 < group)
        *reinterpret_cast<float2*>(a.acc + (part * group + g1) * DH + d) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
    if (warp == 0 && tig == 0) {
      float L0 = red_l[gid], L1 = red_l[gid + 8];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        L0 += red_l[w * 16 + gid];
        L1 += red_l[w * 16 + gid + 8];
      }
      if (g0 < group)
        *reinterpret_cast<float2*>(a.ml + (part * group + g0) * 2) =
            make_float2(m0, L0);
      if (g1 < group)
        *reinterpret_cast<float2*>(a.ml + (part * group + g1) * 2) =
            make_float2(m1, L1);
    }
    __syncthreads();  // p_s and red are reused by the next row block
  }
}

// f32: the same split on the CUDA cores with fmaf.
template <int DH>
__device__ void split_fma(const SplitArgs& a, const float* k_s,
                          const float* v_s, const float* q_s, float* p_s,
                          int n, size_t part) {
  constexpr int LD = Plan<float, DH>::LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = a.group;

  for (int i = tid; i < group * C; i += THREADS) {
    const int g = i / C, j = i - g * C;
    float s = -INFINITY;
    if (j < n) {
      const float4* qg = reinterpret_cast<const float4*>(q_s + g * LD);
      const float4* kj = reinterpret_cast<const float4*>(k_s + j * LD);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH / 4; ++d) {
        const float4 x = qg[d], y = kj[d];
        dot = fmaf(x.x, y.x, dot);
        dot = fmaf(x.y, y.y, dot);
        dot = fmaf(x.z, y.z, dot);
        dot = fmaf(x.w, y.w, dot);
      }
      s = dot * a.scale;
    }
    p_s[i] = s;
  }
  __syncthreads();
  // softmax: one warp per query head, lane l holds positions l + 32 r
  for (int g = warp; g < group; g += WARPS) {
    float* pg = p_s + g * C;
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < C / 32; ++r) mx = fmaxf(mx, pg[lane + 32 * r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < C / 32; ++r) {
      const int j = lane + 32 * r;
      const float p = j < n ? expf(pg[j] - mx) : 0.f;
      pg[j] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0)
      *reinterpret_cast<float2*>(a.ml + (part * group + g) * 2) =
          make_float2(mx, l);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < group * DH; i += THREADS) {
    const int g = i / DH, d = i - g * DH;
    const float* pg = p_s + g * C;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pg[j], v_s[j * LD + d], acc);
    a.acc[(part * group + g) * DH + d] = acc;
  }
}

template <typename T, int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const SplitArgs a) {
  using P = Plan<T, DH>;
  constexpr int LD = P::LD;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = DH / VEC;        // copies per row
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int len = a.kv_len[b];
  len = len < 0 ? 0 : (len > a.cap ? a.cap : len);
  // the merge kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int t0 = s * C;
  if (t0 >= len) return;  // an empty split: nothing written, never merged
  const int n = min(C, len - t0);
  const int group = a.group;
  const int qrows = P::TC ? (group + 15) / 16 * 16 : group;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + C * LD;
  T* q_s = v_s + C * LD;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* q = static_cast<const T*>(a.q);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // group 0: this split's K rows and the group's q rows; group 1: V rows
  const size_t qoff = ((size_t)b * a.hkv * group + (size_t)hk * group) * DH;
  for (int c = tid; c < qrows * CPR; c += THREADS) {
    const int g = c / CPR, part = c - g * CPR;
    T* dst = q_s + g * LD + part * VEC;
    if (g < group)
      cp_async16(dst, q + qoff + (size_t)g * DH + part * VEC);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass ? v : k;
    T* dst_s = pass ? v_s : k_s;
    for (int c = tid; c < C * CPR; c += THREADS) {
      const int j = c / CPR, part = c - j * CPR;
      T* dst = dst_s + j * LD + part * VEC;
      if (j < n) {
        const int t = t0 + j;
        size_t row;
        if (PAGED) {
          const int pg = a.ptab[(size_t)b * a.max_pages + t / a.page_size];
          row = (size_t)pg * a.page_size + (t % a.page_size);
        } else {
          row = (size_t)b * a.cap + t;
        }
        cp_async16(dst, src + (row * a.hkv + hk) * DH + (size_t)part * VEC);
      } else {
        *reinterpret_cast<uint4*>(dst) = zero;
      }
    }
    cp_async_commit();
  }
  cp_async_wait<1>();  // K and q have landed (this thread's copies)
  __syncthreads();

  const size_t part = ((size_t)b * a.hkv + hk) * a.n_split + s;
  if constexpr (P::TC) {
    bf16* p_s = q_s + qrows * LD;
    float* red = reinterpret_cast<float*>(p_s + 16 * P::PLD);
    split_tc<DH>(a, k_s, v_s, q_s, p_s, red, n, part);
  } else {
    float* p_s = q_s + group * LD;
    split_fma<DH>(a, k_s, v_s, q_s, p_s, n, part);
  }
}

// One CTA per (query head, row), one thread per dim: fold the row's
// non-empty splits in order.  Dynamic shared memory: (m, l) per split,
// then the weights.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    decode_merge_kernel(const float* __restrict__ acc,
                        const float* __restrict__ ml,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ lse,
                        int hkv, int group, int cap, int n_split) {
  extern __shared__ float2 ml_s[];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = h / group, g = h - hk * group;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int used = (len + C - 1) / C;
  const size_t first = (((size_t)b * hkv + hk) * n_split) * group + g;
  float* w_s = reinterpret_cast<float*>(ml_s + used);
  const float* a = acc + first * DH + d;
  const size_t stride = (size_t)group * DH;  // between splits
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the splits' writes
  // values load in batches of NB splits, the first while (m, l) are
  // staged; each batch is folded in split order
  constexpr int NB = 16;
  float v[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) v[j] = j < used ? a[j * stride] : 0.f;
  for (int s = d; s < used; s += DH)
    ml_s[s] = reinterpret_cast<const float2*>(ml)[first + (size_t)s * group];
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml_s[s].x);
  for (int s = d; s < used; s += DH) w_s[s] = expf(ml_s[s].x - mx);
  __syncthreads();
  float l = 0.f, x = 0.f;
  for (int s0 = 0; s0 < used; s0 += NB) {
    if (s0 > 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        v[j] = s0 + j < used ? a[(size_t)(s0 + j) * stride] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (s0 + j < used) {
        l = fmaf(w_s[s0 + j], ml_s[s0 + j].y, l);
        x = fmaf(w_s[s0 + j], v[j], x);
      }
    }
  }
  out[((size_t)b * hkv * group + h) * DH + d] =
      from_f32<T>(len > 0 ? x / l : 0.f);
  if (lse != nullptr && d == 0)
    lse[(size_t)b * hkv * group + h] = len > 0 ? mx + logf(l) : -INFINITY;
}

template <typename T, int DH, bool PAGED>
int launch_typed(const SplitArgs& a, void* out, float* lse,
                 cudaStream_t stream) {
  auto kern = decode_split_kernel<T, DH, PAGED>;
  const size_t smem = Plan<T, DH>::bytes(a.group);
  const size_t merge_smem = 3 * sizeof(float) * (size_t)a.n_split;
  if (smem > SMEM_MAX || merge_smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.n_split > 0) {
    kern<<<dim3(a.n_split, a.hkv, a.batch), THREADS, smem, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.hkv * a.group, a.batch);
  cfg.blockDim = dim3(DH);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel<T, DH>,
                                 (const float*)a.acc, (const float*)a.ml,
                                 a.kv_len, static_cast<T*>(out), lse,
                                 a.hkv, a.group, a.cap, a.n_split);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <bool PAGED>
int dispatch(const SplitArgs& a, void* out, float* lse, int dh, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_CASE(T, D) \
  if (dh == D) return launch_typed<T, D, PAGED>(a, out, lse, s)
  if (dtype == 0) {
    DA_CASE(float, 64);
    DA_CASE(float, 128);
    DA_CASE(float, 160);
    DA_CASE(float, 256);
  } else if (dtype == 1) {
    DA_CASE(bf16, 64);
    DA_CASE(bf16, 128);
    DA_CASE(bf16, 160);
    DA_CASE(bf16, 256);
  }
#undef DA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Elements of the f32 workspace for a cache of `cap` logical positions:
// (m, l, acc) per (row, query head, split).
long long decode_attention_workspace(int batch, int heads, int cap, int dh) {
  return (long long)batch * heads * ((cap + C - 1) / C) * (dh + 2);
}

// q (B, H, dh); k/v (B, M, Hkv, dh); kv_len (B,) int32; out (B, H, dh);
// ws f32 of decode_attention_workspace(B, H, M, dh) elements; lse (B, H)
// f32, or null for none.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* ws, void* out,
                            int batch, int hkv, int group, int m, int dh,
                            int dtype, float scale, void* stream,
                            void* lse) {
  const int n_split = (m + C - 1) / C;
  float* acc = static_cast<float*>(ws);
  SplitArgs a{q, k, v, static_cast<const int32_t*>(kv_len), nullptr, acc,
              acc + (size_t)batch * hkv * group * n_split * dh, batch, hkv,
              group, m, 1, 0, n_split, scale};
  return dispatch<false>(a, out, static_cast<float*>(lse), dh, dtype,
                         stream);
}

// q (B, H, dh); k/v pools (P+1, ps, Hkv, dh); ptab (B, max_pages) int32;
// kv_len (B,) int32; out (B, H, dh); ws as above with M = ps * max_pages.
int paged_decode_attention_launch(const void* q, const void* k,
                                  const void* v, const void* kv_len,
                                  const void* ptab, void* ws, void* out,
                                  int batch, int hkv, int group,
                                  int page_size, int max_pages, int dh,
                                  int dtype, float scale, void* stream) {
  const int cap = page_size * max_pages;
  const int n_split = (cap + C - 1) / C;
  float* acc = static_cast<float*>(ws);
  SplitArgs a{q, k, v, static_cast<const int32_t*>(kv_len),
              static_cast<const int32_t*>(ptab), acc,
              acc + (size_t)batch * hkv * group * n_split * dh, batch, hkv,
              group, cap, page_size, max_pages, n_split, scale};
  return dispatch<true>(a, out, nullptr, dh, dtype, stream);
}

}  // extern "C"
