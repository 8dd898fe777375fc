// Flash-attention forward (GQA, causal or not) for Hopper (sm_90a).
// Plain C interface, bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   B3  src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// and computes what it computes: softmax(q k^T * dh**-0.5) v per (batch,
// query head), kv head = h / (H / Hkv), causal mask top-left (key position
// <= query position + q_offset), online softmax with an f32 running max,
// denominator
// and accumulator.  q_offset is the absolute position of query row 0: a
// rank holding rows [r S / N, (r + 1) S / N) of a sequence-sharded q runs
// them against the whole K/V at q_offset = r S / N (0 for a whole q).
// Unlike the Pallas wrapper it takes any Sq and Skv and
// masks the ragged edge itself: keys >= Skv get exactly zero weight in both
// modes (no padding copies), and query rows >= Sq are never written.
// Strides are arguments, so the model's (B, S, H, dh) layout and the
// head-major (B, H, S, dh) layout both go in without a transpose copy.
// Instances: dh 64, 128 and 160, bf16 and f32; the wrapper zero-pads a
// head dim below 64 to 64 and passes the true dh's scale.
//
// Bound (bf16, causal, B 8, S 1024; 4 dh FLOP per visible (query, key)
// pair at 989 TFLOP/s, q, k, v read once and o written once at 3.35
// TB/s): the demo LM (H 12/4, dh 64) 13.0 us of operations (10.0 us of
// bytes), musicgen's MHA (H 24/24, dh 64) 30.05 us of bytes, stablelm
// (H 32/8, dh 160) 86.94 us of operations.  At dh 64 the 16-per-clock
// exp2 units take as long as the tensor cores, so the design keeps both
// fed.  Each item reads its K/V tiles up to the diagonal: over a call
// 113 MB (demo LM), 227 MB (MHA), 755 MB (dh 160), 9.4 GB (2,048 queries
// at offset 30,720 against 32,768 keys, H 36/36), against K/V of 8.4,
// 50.3, 41.9 and 604 MB.  Where the items meet that K/V in L2 is what
// the order decides (below; kernel.kv_traffic models it, unmeasured: no
// profiler reads the card's L2 counters here).
//
// bf16 design (flash_fwd_tc), after the Hopper flash-attention recipe:
// warp specialisation, TMA, wgmma, the accumulators in registers.  A
// persistent CTA (one per SM) of three warpgroups walks work items of
// (128 query rows, query head, batch).
//
// Order.  The items come in bands of (batch, kv head) pairs whose K/V
// fits an eighth of L2 (one band where the whole K/V fits a quarter),
// by query tile inside a band and the heads of a GQA group side by side
// (work_item), so a band's K/V comes from device memory
// about once: by the model 227 -> 50.3 MB for MHA and 189 -> 41.9 at dh
// 160, where the order by query tile over all (head, batch) read a
// pair's K/V again on every pass over the heads once the K/V outgrew L2
// (the long slice, 9.4 GB loaded, already found most of it in L2: the
// kernel before moved 3.5 TB/s of it).  The CTAs take the items in static
// rounds (CTA i takes items i, 2G - 1 - i, 2G + i, ...; G CTAs), which
// pair heavy items with light ones where the items' weights fall through
// the order.  So over several bands the bands alternate: the last one
// runs heaviest first, the one before it lightest first, and so on, and
// two bands meet at their light ends or at their heavy ones, where heavy
// first in every band would put a band's light end against the next
// one's heavy start inside a round.  Producer and consumers each decode
// an item from its index with three quotients by a multiply and a shift
// (FastDiv): divisions there cost up to 4% of a call.
//
// Ring.  Warpgroup 0 is the producer: it gives up registers (setmaxnreg)
// and one thread issues TMA loads, an item's Q tile and then its K and V
// tiles of 128 keys into a ring of STAGES stages; K and V each have their
// own full and empty mbarriers.  Each load is a 4-D tensor map over (dh,
// S, H, B) with the tensor's own strides, in 64-column boxes with 128-byte
// swizzle (dh 160: 32-column boxes with 64-byte swizzle, see TcLayout);
// rows past Sq or Skv arrive as zeros.  A K slot goes back to the
// producer once its S is done, a V slot once its P V is: at dh 160 (two
// stages of 80 KB) K(t + 1) now loads during tile t's softmax, where it
// waited for tile t - 1's P V before.  Warpgroups 1 and 2 are consumers
// (setmaxnreg up), each owning 64 of the item's query rows.  Per key tile
// a consumer
//   1. computes S = Q K^T (64 x 128, f32) with wgmma m64n128k16 from
//      shared memory, both operands K-major, into registers;
//   2. masks S on the item's last tile only (the diagonal tile in causal
//      mode, the ragged tile otherwise; tiles above the diagonal are never
//      loaded; at a q_offset that is not a multiple of 128 the diagonal
//      crosses two tiles, and both are masked) and takes the
//      online-softmax step in registers: the row
//      max over the 4 lanes that share a row, exp2 with dh**-0.5 * log2(e)
//      folded in, the f32 denominator summed per thread;
//   3. rounds P to bf16 in registers (the S accumulator layout is the
//      A-fragment layout) for O += P V with wgmma m64n{dh}k16, A from
//      registers and V from shared memory as an MN-major operand (the
//      transpose bit), and rescales the f32 O accumulator in registers.
// Tile t's S and tile t - 1's P V are issued back to back, so tile t's
// softmax runs while the tensor cores do the P V.  Finally each consumer
// divides by the quad-summed denominator and stores its rows < Sq in bf16
// straight from registers.  No atomics: a call is bitwise repeatable,
// and the order decides only which CTA computes an item, so every order
// gives the bits of the kernel before the order and the ring.
//
// Measured (`python3 chip_smoke.py --b3-against <the kernel before>`,
// both builds in one call; NVIDIA H100 80GB HBM3, 700 W, L2 flushed; the
// kernel before -> this one at its rule's bands, us, SDPA in the same
// call): demo LM 48.11 (its first turn 55.02) -> 48.04-48.50, SDPA
// 51.29 (one band); qwen2-vl dh 128 66.91-67.02 -> 66.65-66.68, 66.90
// (one band); MHA 100.64-100.65 -> 85.40-85.72, 86.96; dh 160
// 246.69-249.04 -> 196.90-197.18, 218.54; granite H 16/8 60.81-60.84 ->
// 60.84-60.92, 62.58; the long slice 2,656.84-2,657.22 ->
// 2,536.49-2,546.54, 4,235.88.  Bitwise the kernel before at every
// order.  In a whole `python3 chip_smoke.py` run (same card) qwen2-vl's
// dh 128 is level with SDPA, not below it: 68.04 against 67.82 (1.003x);
// MHA 0.987x and dh 160 0.906x of SDPA.  Tried and dropped (none faster): CTAs drawing items from a
// counter in device memory instead of static rounds, turns between the
// consumers (named barriers), a second Q slot, the next item's first S
// issued beside the last P V, an L2 prefetch of the next Q, L2 eviction
// hints, deeper rings at dh 64.
//
// f32 design (flash_fwd_f32).  One CTA of four warps per (64 query rows,
// head, batch), 64-key tiles staged in shared memory with 16-byte loads,
// scores and P V in plain fmaf (tensor cores would round f32 to TF32).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ f32 ------

constexpr int F_BQ = 64;        // query rows per CTA
constexpr int F_BK = 64;        // keys per tile
constexpr int F_THREADS = 128;  // four warps, 16 query rows each
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, head, position); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int sq, skv, group, causal, q_offset;
  float scale;
};

// Row strides (elements) of the tiles in shared memory: a 16-byte pad keeps
// every row 16-byte aligned for vector loads.
template <int DH> struct F32Layout {
  static constexpr int LD = DH + 4;     // q, k, v tiles
  static constexpr int SLD = F_BK + 4;  // scores, probabilities
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(float) * F_BQ * LD;
  static constexpr size_t V = K + sizeof(float) * F_BK * LD;
  static constexpr size_t S = V + sizeof(float) * F_BK * LD;
  static constexpr size_t O = S + sizeof(float) * F_BQ * SLD;
  static constexpr size_t M = O + sizeof(float) * F_BQ * LD;
  static constexpr size_t BYTES = M + sizeof(float) * 3 * F_BQ;
};

// rows [r0, r0 + 64) of a (rows_valid, DH) slab with row stride `ss` into
// shared memory with row stride LD; rows >= rows_valid become zeros
template <int DH, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ss, int r0,
                                          int rows_valid) {
  constexpr int CPR = DH / 4;
  for (int c = threadIdx.x; c < F_BQ * CPR; c += F_THREADS) {
    const int r = c / CPR;
    const int part = c - r * CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows_valid)
      val = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * ss +
                                             part * 4);
    *reinterpret_cast<float4*>(dst + r * LD + part * 4) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(Params p) {
  using L = F32Layout<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  float* k_s = reinterpret_cast<float*>(smem + L::K);
  float* v_s = reinterpret_cast<float*>(smem + L::V);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  float* o_s = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::M);
  float* l_s = m_s + F_BQ;
  float* a_s = l_s + F_BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * F_BQ;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16;  // this warp's first row

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<DH, L::LD>(q_s, qg, p.q_ss, q0, p.sq);
  for (int i = threadIdx.x; i < F_BQ * L::LD; i += F_THREADS) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < F_BQ; i += F_THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int kend = p.causal ? min(p.skv, q0 + F_BQ + p.q_offset) : p.skv;
  for (int k0 = 0; k0 < kend; k0 += F_BK) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<DH, L::LD>(k_s, kg, p.k_ss, k0, p.skv);
    load_tile<DH, L::LD>(v_s, vg, p.v_ss, k0, p.skv);
    __syncthreads();

    // 1. scores of this warp's 16 rows against the tile's 64 keys
    for (int r = 0; r < 16; ++r) {
      const float* qr = q_s + (row0 + r) * L::LD;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* kr = k_s + (lane + 32 * half) * L::LD;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
        s_s[(row0 + r) * L::SLD + lane + 32 * half] = s;
      }
    }
    __syncwarp();

    // 2. scale, mask, online-softmax step; lane holds columns lane, lane+32
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const int qpos = q0 + row;
      float s[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kpos = k0 + lane + 32 * half;
        ok[half] =
            kpos < p.skv && (!p.causal || kpos <= qpos + p.q_offset);
        s[half] = ok[half] ? s_s[row * L::SLD + lane + 32 * half] * p.scale
                           : NEG_INF;
        mx = fmaxf(mx, s[half]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float pr = ok[half] ? expf(s[half] - m_new) : 0.f;
        sum += pr;
        s_s[row * L::SLD + lane + 32 * half] = pr;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[row] = fmaf(l_s[row], alpha, sum);
        m_s[row] = m_new;
        a_s[row] = alpha;
      }
    }
    __syncwarp();

    // 3. acc = acc * alpha + P V for this warp's rows
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float alpha = a_s[row];
      const float* pr = s_s + row * L::SLD;
      for (int d = lane; d < DH; d += 32) {
        float pv = 0.f;
#pragma unroll 16
        for (int j = 0; j < F_BK; ++j) pv = fmaf(pr[j], v_s[j * L::LD + d], pv);
        o_s[row * L::LD + d] = fmaf(o_s[row * L::LD + d], alpha, pv);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < F_BQ * DH; i += F_THREADS) {
    const int r = i / DH;
    const int d = i - r * DH;
    if (q0 + r < p.sq)
      og[(int64_t)(q0 + r) * p.o_ss + d] =
          o_s[r * L::LD + d] / fmaxf(l_s[r], 1e-30f);
  }
}

template <int DH>
int launch_f32(const Params& p, int batch, int heads, cudaStream_t stream) {
  auto kern = flash_fwd_f32<DH>;
  const int smem = (int)F32Layout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.sq + F_BQ - 1) / F_BQ, heads, batch);
  kern<<<grid, F_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- bf16, wgmma ------

constexpr int BQ = 128;         // query rows per CTA: two consumers of 64
constexpr int BK = 128;         // keys per tile
constexpr int THREADS = 384;    // producer + two consumer warpgroups

// n / d for 0 <= n < 2^31 by a multiply and a shift, mul and shr found
// once a call on the host (fast_div; Granlund and Montgomery's round-up
// method, as in CUTLASS's FastDivmod): the work order's decode takes
// three such quotients, where three divisions would hold up both
// consumers at every item
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

__device__ __forceinline__ int quotient(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((uint32_t)n, f.mul) >> f.shr);
}

struct TcArgs {
  void* o;
  int64_t o_sb, o_sh, o_ss;  // element strides of the output
  int heads, batch, n_qt;    // n_qt query tiles of BQ rows per head
  int sq, skv, group, causal, q_offset;
  // the item order (work_item): bands of `band` (batch, kv head) pairs,
  // n_bands of them; items a band, (batch, head)s a band and in the last
  // band, and the heads, as divisors
  int band, n_bands;
  FastDiv band_items, band_hb, last_hb, by_heads;
  float scale_log2;  // dh**-0.5 * log2(e)
};

// Shared memory: the Q tile (BQ rows), then STAGES K tiles and STAGES V
// tiles (BK rows), each as DH / BOX_COLS swizzled boxes of (rows x
// BOX_BYTES), 1024-byte aligned; then the mbarriers (q_full, q_empty,
// k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]).
// dh 64 and 128 take 64-column boxes of 128 bytes under the 128-byte swizzle and a ring of 3
// stages (dh 128: 32 KB of Q + 3 x 64 KB of K and V).  dh 160 is no
// multiple of 64: it takes five 32-column boxes of 64 bytes under the
// 64-byte swizzle, so every box is whole and no column is padded, and a
// ring of 2 stages (40 KB of Q + 2 x 80 KB; 3 stages would need 280 KB of
// the 227 KB a block may have).
template <int DH_, int BOX_COLS_, int STAGES_> struct TcLayout {
  static constexpr int DH = DH_;
  static constexpr int BOX_COLS = BOX_COLS_;
  static constexpr int STAGES = STAGES_;
  static constexpr uint32_t BOX_BYTES = 2 * BOX_COLS;  // one swizzled row
  static constexpr uint32_t ATOM = 8 * BOX_BYTES;  // 8 rows: one swizzle atom
  static constexpr uint64_t SWIZZLE = BOX_COLS == 64 ? 1 : 2;  // wgmma desc
  static constexpr uint32_t Q_BOX = BQ * BOX_BYTES;
  static constexpr uint32_t KV_BOX = BK * BOX_BYTES;
  static constexpr uint32_t Q_BYTES = Q_BOX * (DH / BOX_COLS);
  static constexpr uint32_t KV_BYTES = KV_BOX * (DH / BOX_COLS);
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + Q_BYTES;
  static constexpr uint32_t V = K + STAGES * KV_BYTES;
  static constexpr uint32_t BAR = V + STAGES * KV_BYTES;
  static constexpr uint32_t BYTES = BAR + 8 * (2 + 4 * STAGES) + 1024;
  static_assert(DH % BOX_COLS == 0 && (BOX_COLS == 64 || BOX_COLS == 32),
                "boxes of 64 columns (128-byte swizzle) or 32 (64-byte)");
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
};
using Tc64 = TcLayout<64, 64, 3>;
using Tc128 = TcLayout<128, 64, 3>;
using Tc160 = TcLayout<160, 32, 2>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory; its bytes complete a transaction count on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of layout L's swizzle: start address,
// leading byte offset (MN-major: the stride between boxes), stride byte
// offset one swizzle atom (from one 8-row group to the next)
template <class L>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(L::ATOM >> 4) << 32) | (L::SWIZZLE << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128): A and B from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N), N = dh
// (64, 128 or 160): B from shared memory, MN-major (the transpose bit);
// scale-d, a predicate, is always set
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[80],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step on one tile of scores in registers.  In the
// wgmma accumulator layout, register i of a thread holds row
// r0 + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + c0 + (i & 1), with
// r0 = 16 * warp + lane / 4 and c0 = 2 * (lane % 4): a row's 128 columns
// lie in the 4 lanes of a quad.  On the last tile (`edge`) keys >= Skv
// and, in causal mode, keys past the row (its position + q_offset) get
// -inf; kpos0 is the key position of column c0 and qpos0 the query
// position of row r0.  Updates
// the running max m (raw scores) and this thread's share l of the
// denominator, writes P rounded to bf16 pairs (the A fragments of P V:
// its k-step over keys 16 kk .. 16 kk + 15 takes pk[4 kk .. 4 kk + 3])
// and the factor alpha that rescales O.
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             uint32_t (&pk)[32], bool edge,
                                             int kpos0, int qpos0,
                                             const TcArgs& a) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      if (kpos >= a.skv || (a.causal && kpos > qpos + a.q_offset))
        sc[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with no visible key yet keeps exp2(-inf) = 0 everywhere
    ms[r] = mx[r] == -INFINITY ? 0.f : __fmul_rn(mx[r], a.scale_log2);
    alpha[r] = ex2(__fmul_rn(m[r], a.scale_log2) - ms[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = ex2(fmaf(sc[i], a.scale_log2, -ms[r]));
    const float p1 = ex2(fmaf(sc[i + 1], a.scale_log2, -ms[r]));
    rs[r] += p0 + p1;
    pk[i / 2] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], rs[r]);
}

// S (64 x 128) = Q K^T over dh, committed and not waited for: Q's 64 rows
// and the tile's 128 keys, both K-major in swizzled boxes of BOX_COLS
template <class L>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_tile,
                                             uint32_t k_tile) {
  constexpr int STEPS = L::BOX_COLS / 16;  // k-steps of 16 columns per box
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::DH / 16; ++kk) {
    const uint32_t off = (kk % STEPS) * 32;  // 16 columns into the box
    wgmma_ss_n128(sc,
                  sw_desc<L>(q_tile + (kk / STEPS) * L::Q_BOX + off, 16),
                  sw_desc<L>(k_tile + (kk / STEPS) * L::KV_BOX + off, 16),
                  kk > 0);
  }
  wgmma_commit();
}

// O (64 x dh) += P V over the tile's 128 keys, committed and not waited
// for: P from registers, V MN-major (dh / BOX_COLS boxes, LBO = one box)
template <class L>
__device__ __forceinline__ void issue_values(float (&o)[L::DH / 2],
                                             const uint32_t (&pk)[32],
                                             uint32_t v_tile) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t frag[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                              pk[4 * kk + 3]};
    wgmma_rs(o, frag, sw_desc<L>(v_tile + kk * 16 * L::BOX_BYTES, L::KV_BOX));
  }
  wgmma_commit();
}

// One consumer's view of the CTA and of its current work item: shared
// memory addresses, the item's first tile in the CTA's stream of K/V
// tiles (g0, which sets ring stage and phase), its tile count, the
// first tile that needs the mask and the query position of row r0 (see
// softmax_step)
struct Consumer {
  uint32_t base, q_tile, q_empty, k_full, v_full, k_empty, v_empty;
  int c0, g0, n_tiles, mask_from, qrow0;
};

// Key tile it >= 1 of the item: S = Q K^T of tile it and O += P V of tile
// it - 1 (P in p) go to the tensor cores back to back; once S is done
// tile it's K slot goes back to the producer, and tile it's softmax (P
// into p_next) runs while the P V does; then O takes tile it's rescale
// and tile it - 1's V slot goes back.  After the item's last S the Q tile
// goes back too.
template <class L>
__device__ __forceinline__ void overlapped_tile(
    int it, const Consumer& c, const TcArgs& a, float (&sc)[64],
    float (&o)[L::DH / 2], float (&m)[2], float (&l)[2],
    const uint32_t (&p)[32], uint32_t (&p_next)[32]) {
  const int g = c.g0 + it;
  const int s = g % L::STAGES;
  const int sp = (g - 1) % L::STAGES;
  float alpha[2];
  mbar_wait(c.k_full + 8 * s, (g / L::STAGES) & 1);
  mbar_wait(c.v_full + 8 * sp, ((g - 1) / L::STAGES) & 1);
  issue_scores<L>(sc, c.q_tile, c.base + L::K + s * L::KV_BYTES);
  issue_values<L>(o, p, c.base + L::V + sp * L::KV_BYTES);
  wgmma_wait<1>();
  fence_regs(sc);
  mbar_arrive(c.k_empty + 8 * s);
  if (it == c.n_tiles - 1) mbar_arrive(c.q_empty);
  softmax_step(sc, m, l, alpha, p_next, it >= c.mask_from, it * BK + c.c0,
               c.qrow0, a);
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(c.v_empty + 8 * sp);
#pragma unroll
  for (int i = 0; i < L::DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// O += P V of the item's last tile, waited for, and its V slot released
template <class L>
__device__ __forceinline__ void last_values(const Consumer& c,
                                            float (&o)[L::DH / 2],
                                            const uint32_t (&p)[32]) {
  const int g = c.g0 + c.n_tiles - 1;
  const int s = g % L::STAGES;
  mbar_wait(c.v_full + 8 * s, (g / L::STAGES) & 1);
  issue_values<L>(o, p, c.base + L::V + s * L::KV_BYTES);
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(c.v_empty + 8 * s);
}

// Work item w of a call: (query tile, head, batch).  The (batch, kv head)
// pairs u = b * Hkv + hk are cut into bands of a.band pairs (the last
// band may hold fewer); a band's items come before the next band's, so
// the query tiles that read one pair's K/V run close together in time
// and find it in L2.  Inside a band: by query tile, then by (batch, head)
// (the heads of a GQA group side by side), heaviest query tiles first (in
// causal mode the last query tiles see the most keys) in the last band
// and every second band before it, lightest first in the others (see
// Order above).  One band (a.band >= B Hkv) is the order by query tile
// over all (head, batch), heaviest first.
struct Item {
  int q0, h, b, n_tiles;
};

__device__ __forceinline__ Item work_item(int w, const TcArgs& a) {
  const int band = quotient(w, a.band_items);
  const FastDiv hb = band == a.n_bands - 1 ? a.last_hb : a.band_hb;
  int r = w - band * a.band_items.d;                  // w inside the band
  if ((a.n_bands - 1 - band) & 1) r = a.n_qt * hb.d - 1 - r;
  const int qt = quotient(r, hb);
  const int f = band * a.band * a.group + (r - qt * hb.d);  // b * H + h
  Item it;
  it.q0 = (a.n_qt - 1 - qt) * BQ;
  it.b = quotient(f, a.by_heads);
  it.h = f - it.b * a.heads;
  const int kend = a.causal ? min(a.skv, it.q0 + BQ + a.q_offset) : a.skv;
  it.n_tiles = (kend + BK - 1) / BK;
  return it;
}

// Persistent: each CTA walks its share of the work items (item_index);
// its producer loads the next item's Q and first K/V tiles while the
// consumers finish the current one.
template <class L>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const TcArgs a) {
  constexpr int DH = L::DH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;  // + 8 * stage
  const uint32_t v_full = k_full + 8 * L::STAGES;
  const uint32_t k_empty = v_full + 8 * L::STAGES;
  const uint32_t v_empty = k_empty + 8 * L::STAGES;
  const int n_items = a.n_qt * a.heads * a.batch;
  // the CTA's j-th work item: rounds of gridDim.x items, every other round
  // in reverse, so heavy and light causal items even out across CTAs
  auto item_index = [](int j) {
    return j * (int)gridDim.x +
           ((j & 1) ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // every consumer thread arrives
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 256);
      mbar_init(v_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int g = 0;  // the CTA's K/V tile count: ring stage and phase
      for (int j = 0, w; (w = item_index(j)) < n_items; ++j) {
        const Item item = work_item(w, a);
        const int hk = item.h / a.group;
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < DH / L::BOX_COLS; ++c)
          tma_load(base + L::Q + c * L::Q_BOX, &qmap, q_full,
                   c * L::BOX_COLS, item.q0, item.h, item.b);
        for (int it = 0; it < item.n_tiles; ++it, ++g) {
          const int s = g % L::STAGES;
          const uint32_t parity = ((g / L::STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < DH / L::BOX_COLS; ++c)
            tma_load(base + L::K + s * L::KV_BYTES + c * L::KV_BOX, &kmap,
                     k_full + 8 * s, c * L::BOX_COLS, it * BK, hk, item.b);
          mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < DH / L::BOX_COLS; ++c)
            tma_load(base + L::V + s * L::KV_BYTES + c * L::KV_BOX, &vmap,
                     v_full + 8 * s, c * L::BOX_COLS, it * BK, hk, item.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4;  // see softmax_step
    Consumer c;
    c.base = base;
    c.k_full = k_full;
    c.v_full = v_full;
    c.k_empty = k_empty;
    c.v_empty = v_empty;
    c.q_tile = base + L::Q + 64 * cw * L::BOX_BYTES;
    c.q_empty = q_empty;
    c.c0 = 2 * (lane % 4);
    c.g0 = 0;
    float o[DH / 2];
    float m[2], l[2], alpha[2];  // running max (raw scores), sum share
    float sc[64];
    uint32_t pa[32], pb[32];  // P of consecutive tiles, in turn

    for (int j = 0, w; (w = item_index(j)) < n_items; ++j) {
      const Item item = work_item(w, a);
      c.n_tiles = item.n_tiles;
      c.qrow0 = item.q0 + 64 * cw + r0;
      // tile it holds a key past this consumer's first row iff
      // (it + 1) BK > q + q_offset + 1: only the last tile at q_offset 0
      c.mask_from = a.causal ? min(c.n_tiles - 1,
                                   (item.q0 + 64 * cw + a.q_offset + 1) / BK)
                             : c.n_tiles - 1;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      const int s = c.g0 % L::STAGES;
      mbar_wait(q_full, j & 1);
      mbar_wait(k_full + 8 * s, (c.g0 / L::STAGES) & 1);
      issue_scores<L>(sc, c.q_tile, base + L::K + s * L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      if (c.n_tiles == 1) mbar_arrive(c.q_empty);
      softmax_step(sc, m, l, alpha, pa, c.mask_from == 0, c.c0, c.qrow0, a);
      int it = 1;
      for (; it + 1 < c.n_tiles; it += 2) {
        overlapped_tile<L>(it, c, a, sc, o, m, l, pa, pb);
        overlapped_tile<L>(it + 1, c, a, sc, o, m, l, pb, pa);
      }
      if (it < c.n_tiles) {
        overlapped_tile<L>(it, c, a, sc, o, m, l, pa, pb);
        last_values<L>(c, o, pb);
      } else {
        last_values<L>(c, o, pa);
      }
      c.g0 += c.n_tiles;

      // O / l in bf16, rows < Sq, straight from the accumulator layout
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      }
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) +
                          item.b * a.o_sb + item.h * a.o_sh + c.c0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qpos = c.qrow0 + 8 * half;
        if (qpos < a.sq) {
          __nv_bfloat16* row = og + (int64_t)qpos * a.o_ss;
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj)
            *reinterpret_cast<uint32_t*>(row + 8 * jj) =
                pack_bf16(o[4 * jj + 2 * half] * inv[half],
                          o[4 * jj + 2 * half + 1] * inv[half]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in the driver library; the runtime hands
// out its address, so the build links nothing beyond the runtime
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

constexpr int ENCODE_FAILED = 10000;  // + the CUresult of the encoder

// A bf16 (dh, S, H, B) tensor with element strides (1, ss, sh, sb) as
// boxes of `cols` columns x `rows` rows, swizzled over the box's row (64
// columns: 128 bytes; 32: 64 bytes); out-of-bounds rows read as zeros.
// TMA needs the base 16-byte aligned and every stride a multiple of 16
// bytes (the wrapper checks both).
int encode(CUtensorMap* map, const void* ptr, int dh, int s, int heads,
           int batch, int64_t ss, int64_t sh, int64_t sb, int cols,
           int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    uint32_t l = 0;  // ceil(log2 d)
    while ((1ull << l) < (uint64_t)d) ++l;
    f.mul = (uint32_t)(((1ull << (31 + l)) + (uint64_t)d - 1) / (uint64_t)d);
    f.shr = l - 1;
  }
  return f;
}

template <class L>
int launch_tc(const void* const* ptrs, void* o, const int64_t* st,
              int batch, int heads, int group, int sq, int skv, int causal,
              int q_offset, float scale, int band, cudaStream_t stream) {
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int err = encode(&maps[i], ptrs[i], L::DH, i ? skv : sq,
                           i ? heads / group : heads, batch, st[3 * i + 2],
                           st[3 * i + 1], st[3 * i], L::BOX_COLS,
                           i ? BK : BQ);
    if (err) return err;
  }
  TcArgs a;
  a.o = o;
  a.o_sb = st[9];
  a.o_sh = st[10];
  a.o_ss = st[11];
  a.heads = heads;
  a.batch = batch;
  a.n_qt = (sq + BQ - 1) / BQ;
  a.sq = sq;
  a.skv = skv;
  a.group = group;
  a.causal = causal;
  a.q_offset = q_offset;
  const int pairs = batch * (heads / group);
  a.band = min(band, pairs);
  a.n_bands = (pairs + a.band - 1) / a.band;
  a.band_items = fast_div(a.band * a.n_qt * group);
  a.band_hb = fast_div(a.band * group);
  a.last_hb = fast_div((pairs - (a.n_bands - 1) * a.band) * group);
  a.by_heads = fast_div(heads);
  a.scale_log2 = scale * 1.4426950408889634f;
  auto kern = flash_fwd_tc<L>;
  const int smem = (int)L::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // One CTA per SM (__launch_bounds__(THREADS, 1)); host-side queries
  // that do not synchronise.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_items = a.n_qt * heads * batch;
  kern<<<min(n_items, sms), THREADS, smem, stream>>>(maps[0], maps[1],
                                                     maps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, dh), k/v (B, Hkv, Skv, dh), o like q, each given by its
// base pointer and element strides (batch, head, position) in `strides`
// (12 values: q, k, v, o).  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 = launched), or 10000 + a CUresult if a bf16 tensor map
// could not be encoded.  causal: key j is masked for query row i iff
// j > i + q_offset.  bf16 only: `band`, the (batch, kv head) pairs per
// band of the work order (>= 1).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const int64_t* strides, int batch,
                           int heads, int group, int sq, int skv, int dh,
                           int dtype, int causal, float scale, void* stream,
                           int q_offset, int band) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (band < 1) return (int)cudaErrorInvalidValue;
    const void* ptrs[3] = {q, k, v};
    if (dh == 64)
      return launch_tc<Tc64>(ptrs, o, strides, batch, heads, group, sq, skv,
                             causal, q_offset, scale, band, s);
    if (dh == 128)
      return launch_tc<Tc128>(ptrs, o, strides, batch, heads, group, sq,
                              skv, causal, q_offset, scale, band, s);
    if (dh == 160)
      return launch_tc<Tc160>(ptrs, o, strides, batch, heads, group, sq,
                              skv, causal, q_offset, scale, band, s);
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.sq = sq;
  p.skv = skv;
  p.group = group;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  if (dtype == 0 && dh == 64) return launch_f32<64>(p, batch, heads, s);
  if (dtype == 0 && dh == 128) return launch_f32<128>(p, batch, heads, s);
  if (dtype == 0 && dh == 160) return launch_f32<160>(p, batch, heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
