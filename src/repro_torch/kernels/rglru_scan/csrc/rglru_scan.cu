// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t along the sequence axis
// of (B, S, D) tensors, h0 = 0, for Hopper (sm_90a).  Plain C interface,
// bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   B4  src/repro/kernels/rglru_scan/kernel.py::_rglru_kernel
// which tiles (B, D/128) in parallel and walks S in 256-row VMEM blocks with
// the carry in scratch.  What it computes is a channel-parallel sequential
// walk; that is what this kernel does, without the blocks or the padding.
// Each step is h = __fadd_rn(__fmul_rn(a_t, h), x_t) in the order t = 0 ..
// S-1 with an f32 carry: the plain version's two roundings, so at f32 the
// kernel equals the plain PyTorch version bitwise.  Output is in x's dtype.
//
// Bound.  Each element of a and x is read once and each of h written once:
// 3 * B * S * D * itemsize bytes at 3.35 TB/s (H100 SXM), against 2 FLOP
// per element, so the scan is bound by HBM: 75.1 us at (4, 2048, 2560)
// f32, 37.6 us at (16, 256, 2560).  A channel's dependent chain is ~8
// cycles a step, ~9 us at S 2048: an eighth of the bytes bound, so the walk
// can stay sequential if the bytes keep coming.
//
// What held the earlier design back.  One thread per channel with a 16-step
// register prefetch kept 2 x 16 loads of 128 B per warp in flight, ~1.3 MB
// across the card at (4, 2048, 2560) (320 warps), where HBM at 3.35 TB/s
// and ~0.6 us of latency needs ~2 MB (Little's law): it reached 0.49 of
// its bound there.
//
// Design.  A CTA owns one tile of one batch row: the channels whose step is
// one ROW-byte row (ROW = 512: 128 f32 or 256 bf16 channels).  A producer
// warp streams (ST steps x tile) boxes of a and x through a ring of NS
// shared-memory stages with full and empty mbarriers, so NS - 1 stages
// (2 x 8 KB each) of every CTA are in flight while W = 4 walker warps fold
// the oldest one.  A walker lane owns V = 1 (f32) or 2 (bf16) channels: it
// reads a stage's steps from shared memory into registers, hands the stage
// back, folds the steps in order with the carry in registers and stores
// each step's h straight from registers (each warp store one 128-byte
// row).  Two copy paths fill the ring:
//   tma       one thread issues 3-D tensor-map loads over (D, S, B) (the
//             maps are encoded per call on the host); boxes past S or D
//             arrive as zeros.  TMA needs the bases 16-byte aligned and the
//             row stride D * itemsize a multiple of 16 bytes.
//   cp.async  every other layout, f32 only: each producer lane copies 4
//             bytes per channel and step with cp.async (zero-filled past S
//             or D), and cp.async.mbarrier.arrive completes the stage.  The
//             wrapper widens a bf16 layout TMA cannot take to f32 (exact)
//             and rounds the result once, as the kernel itself would.
// Balance.  One CTA per tile: B * ceil(D / (ROW / itemsize)) CTAs of 160
// threads with 64 KB of shared memory, all resident at once at the main
// path's shapes (3 fit on an SM).  At (4, 2048, 2560) f32 that is 80 CTAs,
// so 52 of 132 SMs idle; each busy SM streams ~3.1 MB at ~34 GB/s, and the
// card is bound by HBM, not by SMs: 512-byte rows measured faster than
// 128-byte rows over 320 CTAs (PERF.md).  At (16, 256, 2560) it is 320
// CTAs.  At B = 1 and D 2560 only 20 SMs stream (PERF.md, open questions).
//
// Backward (`rglru_scan_bwd_kernel`).  Replaces no Pallas kernel: the
// reference's VJP (src/repro/kernels/rglru_scan/ops.py::_scan_bwd)
// differentiates its associative-scan oracle in XLA.  It is the same
// channel-parallel walk run from t = S-1 down to 0, f32 only:
//   dh_{S-1} = g_{S-1},  dh_t = __fadd_rn(g_t, __fmul_rn(a_{t+1}, dh_{t+1}))
//   dx_t = dh_t,         da_t = __fmul_rn(dh_t, h_{t-1}),  h_{-1} = 0
// the plain reverse walk's roundings, so it equals
// `ref.rglru_scan_backward_reference` bitwise.  The producer warp streams
// boxes of a, h and g (unshifted) through the ring from the last box to the
// first; the walker keeps a_{t+1} and dh_{t+1} in registers, so no load is
// shifted by a position and no box boundary falls inside a shift: h_t,
// read at step t, completes da_{t+1}, and da_0 = dh_0 * 0.0 (the sign of
// dh_0 kept) is stored after the walk.  Bound: a, h, g read once and dx,
// da written once, 5 * B * S * D * 4 bytes: 125.2 us at (8, 1024, 2560).
// Three rings of NS stages: 96 KB of shared memory, two CTAs an SM.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 4;          // walker warps; a tile's step is W x 128 B
constexpr int ROW = 128 * W;  // bytes of one step of a tile
constexpr int ST = 16;        // steps per stage
constexpr int NS = 4;         // stages in the ring
constexpr int THREADS = 32 * (W + 1);  // warps 0 .. W-1 walk, warp W copies
constexpr int RING_BYTES = 2 * NS * ST * ROW;  // a's stages, then x's
constexpr int SMEM = RING_BYTES + 16 * NS;     // + full[NS], empty[NS]

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

// one box of a 3-D tensor map at (channel, step, batch) into shared memory;
// its bytes complete a transaction count on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 4 bytes global -> shared; `bytes` 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// V channels of one lane in one step: a float, or a bf16 pair
template <typename T> struct Lane;
template <> struct Lane<float> {
  static constexpr int V = 1;
  using Raw = float;
  __device__ static void widen(Raw r, float (&f)[1]) { f[0] = r; }
  __device__ static void store(float* p, const float (&h)[1]) { *p = h[0]; }
};
template <> struct Lane<__nv_bfloat16> {
  static constexpr int V = 2;
  using Raw = __nv_bfloat162;
  __device__ static void widen(Raw r, float (&f)[2]) {
    f[0] = __low2float(r);
    f[1] = __high2float(r);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&h)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(h[0], h[1]);
  }
};

// Fold one step into the carry and store it.
template <typename T>
__device__ __forceinline__ void step(typename Lane<T>::Raw ra,
                                     typename Lane<T>::Raw rx,
                                     float (&h)[Lane<T>::V], T* op,
                                     bool live) {
  constexpr int V = Lane<T>::V;
  float fa[V], fx[V];
  Lane<T>::widen(ra, fa);
  Lane<T>::widen(rx, fx);
#pragma unroll
  for (int j = 0; j < V; ++j) h[j] = __fadd_rn(__fmul_rn(fa[j], h[j]), fx[j]);
  if (live) Lane<T>::store(op, h);
}

template <typename T, bool TMA>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap xmap, const T* __restrict__ a,
    const T* __restrict__ x, T* __restrict__ out, int seq, int dim,
    int n_dt) {
  using L = Lane<T>;
  using Raw = typename L::Raw;
  using Stage = Raw[ST][32 * W];  // one step of the tile per row
  constexpr int TC = ROW / (int)sizeof(T);
  constexpr uint32_t STAGE_BYTES = ST * ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* ring_a = reinterpret_cast<Stage*>(smem);
  Stage* ring_x = reinterpret_cast<Stage*>(smem + RING_BYTES / 2);
  const uint32_t full = smem_u32(smem + RING_BYTES), empty = full + 8 * NS;

  const int b = blockIdx.x / n_dt;
  const int d0 = (blockIdx.x - b * n_dt) * TC;
  const int n_chunks = (seq + ST - 1) / ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, TMA ? 1 : 32);  // the expect_tx, or 32 lanes
      mbar_init(empty + 8 * s, 32 * W);       // every walker lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {
    // ---- producer: keep the ring full ----
    if constexpr (TMA) {
      if (lane == 0) {
        for (int k = 0; k < n_chunks; ++k) {
          const int s = k % NS;
          mbar_wait(empty + 8 * s, ((k / NS) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, 2 * STAGE_BYTES);
          tma_load(smem_u32(ring_a[s]), &amap, full + 8 * s, d0, k * ST, b);
          tma_load(smem_u32(ring_x[s]), &xmap, full + 8 * s, d0, k * ST, b);
        }
      }
    } else {
      const size_t row0 = (size_t)b * seq;
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % NS;
        mbar_wait(empty + 8 * s, ((k / NS) & 1) ^ 1);
#pragma unroll 8
        for (int u = 0; u < ST; ++u) {
          const int t = k * ST + u;
#pragma unroll
          for (int w = 0; w < W; ++w) {  // f32: one channel a lane
            const int j = 32 * w + lane, d = d0 + j;
            const bool in = d < dim && t < seq;
            const size_t off = in ? (row0 + t) * (size_t)dim + d : 0;
            cp_async4(smem_u32(&ring_a[s][u][j]), a + off, in ? 4u : 0u);
            cp_async4(smem_u32(&ring_x[s][u][j]), x + off, in ? 4u : 0u);
          }
        }
        cp_async_arrive(full + 8 * s);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  // ---- walker: fold each stage in order ----
  const int j = 32 * warp + lane;  // the lane's column of the tile
  const int c = d0 + j * L::V;     // its first channel
  const bool live = c < dim;       // tma: D % 8 == 0, so pairs are whole
  T* op = out + ((size_t)b * seq) * (size_t)dim + c;
  float h[L::V];
#pragma unroll
  for (int v = 0; v < L::V; ++v) h[v] = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % NS;
    mbar_wait(full + 8 * s, (k / NS) & 1);
    const int t0 = k * ST;
    if (t0 + ST <= seq) {
      Raw ra[ST], rx[ST];  // the whole stage into registers first
#pragma unroll
      for (int u = 0; u < ST; ++u) {
        ra[u] = ring_a[s][u][j];
        rx[u] = ring_x[s][u][j];
      }
      mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int u = 0; u < ST; ++u)
        step<T>(ra[u], rx[u], h, op + (size_t)(t0 + u) * dim, live);
    } else {
      for (int u = 0; u < seq - t0; ++u)
        step<T>(ring_a[s][u][j], ring_x[s][u][j], h,
                op + (size_t)(t0 + u) * dim, live);
      mbar_arrive(empty + 8 * s);
    }
  }
}

// ---- backward: a reverse walk over a, h and g (f32) ----
constexpr int BWD_RING_BYTES = 3 * NS * ST * ROW;  // a's, h's, g's stages
constexpr int BWD_SMEM = BWD_RING_BYTES + 16 * NS;

// One step t of the reverse walk for one channel.  h_t closes da_{t+1};
// dh_t folds g_t into a_{t+1} * dh_{t+1} (at t = S-1 it is g_t itself).
__device__ __forceinline__ void bwd_step(float at, float ht, float gt,
                                         int t, int seq, size_t dim,
                                         float& dh, float& a_next,
                                         float* da, float* dx, bool live) {
  const bool last = t + 1 == seq;
  if (live && !last) da[(size_t)(t + 1) * dim] = __fmul_rn(dh, ht);
  dh = last ? gt : __fadd_rn(gt, __fmul_rn(a_next, dh));
  if (live) dx[(size_t)t * dim] = dh;
  a_next = at;
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS) rglru_scan_bwd_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap hmap,
    const __grid_constant__ CUtensorMap gmap, const float* __restrict__ a,
    const float* __restrict__ hs, const float* __restrict__ g,
    float* __restrict__ da, float* __restrict__ dx, int seq, int dim,
    int n_dt) {
  using Stage = float[ST][32 * W];
  constexpr int TC = ROW / (int)sizeof(float);
  constexpr uint32_t STAGE_BYTES = ST * ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* ring_a = reinterpret_cast<Stage*>(smem);
  Stage* ring_h = ring_a + NS;
  Stage* ring_g = ring_h + NS;
  const uint32_t full = smem_u32(smem + BWD_RING_BYTES), empty = full + 8 * NS;

  const int b = blockIdx.x / n_dt;
  const int d0 = (blockIdx.x - b * n_dt) * TC;
  const int n_chunks = (seq + ST - 1) / ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, TMA ? 1 : 32);  // the expect_tx, or 32 lanes
      mbar_init(empty + 8 * s, 32 * W);       // every walker lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the k-th stage filled holds steps t0 = (n_chunks - 1 - k) * ST onward
  if (warp == W) {
    // ---- producer: keep the ring full, last box first ----
    if constexpr (TMA) {
      if (lane == 0) {
        for (int k = 0; k < n_chunks; ++k) {
          const int s = k % NS, t0 = (n_chunks - 1 - k) * ST;
          mbar_wait(empty + 8 * s, ((k / NS) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, 3 * STAGE_BYTES);
          tma_load(smem_u32(ring_a[s]), &amap, full + 8 * s, d0, t0, b);
          tma_load(smem_u32(ring_h[s]), &hmap, full + 8 * s, d0, t0, b);
          tma_load(smem_u32(ring_g[s]), &gmap, full + 8 * s, d0, t0, b);
        }
      }
    } else {
      const size_t row0 = (size_t)b * seq;
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % NS, t0 = (n_chunks - 1 - k) * ST;
        mbar_wait(empty + 8 * s, ((k / NS) & 1) ^ 1);
#pragma unroll 8
        for (int u = 0; u < ST; ++u) {
          const int t = t0 + u;
#pragma unroll
          for (int w = 0; w < W; ++w) {  // one channel a lane
            const int j = 32 * w + lane, d = d0 + j;
            const bool in = d < dim && t < seq;
            const size_t off = in ? (row0 + t) * (size_t)dim + d : 0;
            const uint32_t n = in ? 4u : 0u;
            cp_async4(smem_u32(&ring_a[s][u][j]), a + off, n);
            cp_async4(smem_u32(&ring_h[s][u][j]), hs + off, n);
            cp_async4(smem_u32(&ring_g[s][u][j]), g + off, n);
          }
        }
        cp_async_arrive(full + 8 * s);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    return;
  }

  // ---- walker: fold each stage from its last step to its first ----
  const int j = 32 * warp + lane;  // the lane's channel in the tile
  const int c = d0 + j;
  const bool live = c < dim;
  const size_t base = ((size_t)b * seq) * (size_t)dim + (live ? c : 0);
  float* const dap = da + base;
  float* const dxp = dx + base;
  float dh = 0.f, a_next = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % NS, t0 = (n_chunks - 1 - k) * ST;
    mbar_wait(full + 8 * s, (k / NS) & 1);
    if (t0 + ST <= seq) {
      float ra[ST], rh[ST], rg[ST];  // the whole stage into registers first
#pragma unroll
      for (int u = 0; u < ST; ++u) {
        ra[u] = ring_a[s][u][j];
        rh[u] = ring_h[s][u][j];
        rg[u] = ring_g[s][u][j];
      }
      mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int u = ST - 1; u >= 0; --u)
        bwd_step(ra[u], rh[u], rg[u], t0 + u, seq, dim, dh, a_next, dap, dxp,
                 live);
    } else {  // the ragged last box, the first one walked
      for (int u = seq - t0 - 1; u >= 0; --u)
        bwd_step(ring_a[s][u][j], ring_h[s][u][j], ring_g[s][u][j], t0 + u,
                 seq, dim, dh, a_next, dap, dxp, live);
      mbar_arrive(empty + 8 * s);
    }
  }
  if (live) *dap = __fmul_rn(dh, 0.f);  // da_0 = dh_0 * h_{-1}
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

// A contiguous (B, S, D) tensor as boxes of (a tile's ROW bytes of
// channels, ST steps, 1 batch row); boxes past D or S read as zeros.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int batch, int seq, int dim) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)dim * sizeof(T),
                                 (cuuint64_t)seq * dim * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)(ROW / sizeof(T)), ST, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

template <typename T>
int launch_typed(const void* a, const void* x, void* out, int batch, int seq,
                 int dim, int tma, cudaStream_t stream) {
  constexpr int TC = ROW / (int)sizeof(T);
  const int n_dt = (dim + TC - 1) / TC;
  const long long blocks = (long long)batch * n_dt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kern = rglru_scan_kernel<T, true>;
  if (!tma) {
    if constexpr (sizeof(T) == 4)  // cp.async: f32 only
      kern = rglru_scan_kernel<T, false>;
    else
      return (int)cudaErrorInvalidValue;
  }
  // a runtime call first: it makes the device's primary context current
  // on this thread (autograd's worker thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[2] = {};
  if (tma) {
    // TMA's rule: 16-byte aligned bases and row strides
    if ((dim * sizeof(T)) % 16 || (uintptr_t)a % 16 || (uintptr_t)x % 16)
      return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 2; ++i) {
      const int err = encode<T>(&maps[i], i ? x : a, batch, seq, dim);
      if (err) return err;
    }
  }
  kern<<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      maps[0], maps[1], static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<T*>(out), seq, dim, n_dt);
  return (int)cudaGetLastError();
}

int launch_bwd(const float* a, const float* h, const float* g, float* da,
               float* dx, int batch, int seq, int dim, int tma,
               cudaStream_t stream) {
  constexpr int TC = ROW / (int)sizeof(float);
  const int n_dt = (dim + TC - 1) / TC;
  const long long blocks = (long long)batch * n_dt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kern = tma ? rglru_scan_bwd_kernel<true> : rglru_scan_bwd_kernel<false>;
  // the runtime call before the encoder, as in launch_typed: autograd
  // launches this from its worker thread
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3] = {};
  if (tma) {
    const float* src[3] = {a, h, g};
    if ((dim * sizeof(float)) % 16) return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 3; ++i) {
      if ((uintptr_t)src[i] % 16) return (int)cudaErrorMisalignedAddress;
      const int err = encode<float>(&maps[i], src[i], batch, seq, dim);
      if (err) return err;
    }
  }
  kern<<<(unsigned)blocks, THREADS, BWD_SMEM, stream>>>(
      maps[0], maps[1], maps[2], a, h, g, da, dx, seq, dim, n_dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, x, out (B, S, D) contiguous, all of one dtype: 0 = float32,
// 1 = bfloat16.  tma: 1 for the TMA copy path (bases 16-byte aligned,
// D * itemsize a multiple of 16), 0 for the cp.async path (float32 only).
// Returns a cudaError_t (0 = launched), or 10000 + a CUresult if a tensor
// map could not be encoded.
int rglru_scan_launch(const void* a, const void* x, void* out, int batch,
                      int seq, int dim, int dtype, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_typed<float>(a, x, out, batch, seq, dim, tma, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(a, x, out, batch, seq, dim, tma, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of the scan: a, h (the forward's f32 carry), g (the
// output's gradient) in; da, dx out; all (B, S, D) contiguous float32.
// tma as for rglru_scan_launch.  Returns a cudaError_t (0 = launched), or
// 10000 + a CUresult if a tensor map could not be encoded.
int rglru_scan_bwd_launch(const void* a, const void* h, const void* g,
                          void* da, void* dx, int batch, int seq, int dim,
                          int tma, void* stream) {
  if (batch <= 0 || seq <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  return launch_bwd(static_cast<const float*>(a), static_cast<const float*>(h),
                    static_cast<const float*>(g), static_cast<float*>(da),
                    static_cast<float*>(dx), batch, seq, dim, tma,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
