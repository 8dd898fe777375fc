// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t along the sequence axis
// of (B, S, D) tensors, h0 = 0, for Hopper (sm_90a).  Plain C interface,
// bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   B4  src/repro/kernels/rglru_scan/kernel.py::_rglru_kernel
// which tiles (B, D/128) in parallel and walks S in 256-row VMEM blocks with
// the carry in scratch.  What it computes is a channel-parallel sequential
// walk; that is what this kernel does, without the blocks or the padding.
//
// Design.  One thread per channel (b, d) over all B * D channels, 64 threads
// a CTA, consecutive threads on consecutive d: every time step's loads of a
// and x and the store of h are coalesced across the warp.  The thread keeps
// the carry in a register in f32 and walks t = 0 .. S-1.  The loads do not
// depend on h, so the walk runs on chunks of UNROLL steps with the next
// chunk's a and x loaded into registers while the current one is folded in
// (a register prefetch: 2 * UNROLL loads in flight per thread).  Each step
// is h = __fadd_rn(__fmul_rn(a, h), x): the plain version's two roundings,
// so at f32 the kernel equals the plain PyTorch version bitwise.  Any S and
// D are taken; the ragged chunk at the end of S is predicated.
//
// Bound.  Each element of a and x is read once and each of h written once:
// 3 * B * S * D * itemsize bytes at 3.35 TB/s (H100 SXM), and 2 FLOP per
// element, so the scan is HBM-bound.  With one thread per channel the card
// is filled only when B * D is large (B 16, D 2560 gives 40,960 threads,
// ~310 per SM); a chunked two-pass scan over S, which would fill the card
// at small B * D, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;   // two warps: more CTAs, better spread on 132 SMs
constexpr int UNROLL = 16;    // steps per chunk; the prefetch depth

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ out,
    int batch, int seq, int dim) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= (long long)batch * dim) return;
  const long long b = c / dim;
  const long long d = c - b * dim;
  const size_t stride = (size_t)dim;
  const size_t base = (size_t)b * seq * stride + (size_t)d;
  const T* ap = a + base;
  const T* xp = x + base;
  T* op = out + base;

  float ca[UNROLL], cx[UNROLL];  // the chunk being folded in
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool in = u < seq;
    ca[u] = in ? to_f32(ap[(size_t)u * stride]) : 0.f;
    cx[u] = in ? to_f32(xp[(size_t)u * stride]) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < seq; t0 += UNROLL) {
    const int t1 = t0 + UNROLL;
    float na[UNROLL], nx[UNROLL];  // the next chunk, loaded ahead
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = t1 + u < seq;
      na[u] = in ? to_f32(ap[(size_t)(t1 + u) * stride]) : 0.f;
      nx[u] = in ? to_f32(xp[(size_t)(t1 + u) * stride]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < seq) {
        h = __fadd_rn(__fmul_rn(ca[u], h), cx[u]);
        op[(size_t)(t0 + u) * stride] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ca[u] = na[u];
      cx[u] = nx[u];
    }
  }
}

template <typename T>
int launch_typed(const void* a, const void* x, void* out, int batch, int seq,
                 int dim, cudaStream_t stream) {
  const long long channels = (long long)batch * dim;
  const long long blocks = (channels + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rglru_scan_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<T*>(out), batch, seq, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, x, out (B, S, D) contiguous, all of one dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int rglru_scan_launch(const void* a, const void* x, void* out, int batch,
                      int seq, int dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_typed<float>(a, x, out, batch, seq, dim, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(a, x, out, batch, seq, dim, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
