// Single-query (decode) GQA attention over a dense or a paged KV cache, for
// Hopper (sm_90a).  Plain C interface, bound from Python with ctypes.
//
// Replaces the Pallas TPU kernels
//   B1  src/repro/kernels/decode_attention/kernel.py::_decode_kernel
//   B2  src/repro/kernels/decode_attention/paged.py::_paged_decode_kernel
// with one template: PAGED only changes where logical position t lives,
//   dense  row = b * M + t
//   paged  row = ptab[b, t / ps] * ps + t % ps
// in a (rows, Hkv, dh) cache.  Every sum runs over logical positions in
// fixed tiles of TILE and in a fixed order, with explicit fmaf, so the
// result depends only on the values at positions t < kv_len[b]: paged ==
// dense bitwise, and positions >= kv_len (the trash page included) are
// never read at all.
//
// Design.  One CTA of 128 threads per (kv head, batch row) serves the whole
// GQA group (H / Hkv query heads), so each K/V row is read from HBM once.
// The CTA walks t < kv_len[b] in tiles of 32 positions: it stages the K and
// V rows of the tile in shared memory as f32 (16-byte loads), computes the
// G x 32 scores, takes the online-softmax step with one warp per query head
// (butterfly shuffles, identical on every lane), and folds P.V into an f32
// accumulator in shared memory.  Rows with kv_len == 0 write exact zeros.
// Head dims 64, 128 and 256 are instances; at dh 256 and a GQA group of 10
// (recurrentgemma-2b's MQA) the CTA's shared memory is ~87.5 KB, above the
// 48 KB default, so `launch_typed` opts in to it.
//
// Bound.  The work is O(1) FLOP per byte: it moves
//   sum_b 2 * kv_len[b] * Hkv * dh * itemsize  bytes of K/V
// plus q and out, so it is HBM-bound (3.35 TB/s on an H100 SXM) and, at the
// serving widths, launch-bound.  This first version runs one CTA per
// (row, kv head) with no split over M and no cp.async/TMA pipelining; both
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // positions per tile == warp size
constexpr int THREADS = 128;  // four warps
constexpr float NEG_INF = -1e30f;

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

template <typename T, int DH, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ ptab, T* __restrict__ out, int hkv,
    int group, int cap, int page_size, int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = DH / VEC;        // 16-byte chunks per cache row
  constexpr int KS = DH + 1;           // padded K row: no bank conflicts

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = hkv * group;

  extern __shared__ float smem[];
  float* k_s = smem;                   // TILE x KS
  float* v_s = k_s + TILE * KS;        // TILE x DH
  float* q_s = v_s + TILE * DH;        // group x DH (pre-scaled)
  float* acc_s = q_s + group * DH;     // group x DH
  float* p_s = acc_s + group * DH;     // group x TILE
  float* m_s = p_s + group * TILE;     // group
  float* l_s = m_s + group;            // group
  float* a_s = l_s + group;            // group

  int len = kv_len[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);

  const size_t qoff = ((size_t)b * h + (size_t)hk * group) * DH;
  for (int i = tid; i < group * DH; i += THREADS) {
    q_s[i] = to_f32(q[qoff + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    // stage the tile's K and V rows (positions t0 .. t0 + n - 1 only)
    for (int c = tid; c < n * CPR; c += THREADS) {
      const int j = c / CPR;
      const int part = c - j * CPR;
      const int t = t0 + j;
      size_t row;
      if (PAGED) {
        const int pg = ptab[(size_t)b * max_pages + t / page_size];
        row = (size_t)pg * page_size + (t % page_size);
      } else {
        row = (size_t)b * cap + t;
      }
      const size_t off = (row * hkv + hk) * DH + (size_t)part * VEC;
      const uint4 kr = *reinterpret_cast<const uint4*>(k + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(v + off);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[j * KS + part * VEC + e] = to_f32(ke[e]);
        v_s[j * DH + part * VEC + e] = to_f32(ve[e]);
      }
    }
    __syncthreads();

    // scores s[g][j] = (q_g * scale) . k_j
    for (int i = tid; i < group * TILE; i += THREADS) {
      const int g = i / TILE;
      const int j = i - g * TILE;
      float s = NEG_INF;
      if (j < n) {
        s = 0.f;
        const float* qg = q_s + g * DH;
        const float* kj = k_s + j * KS;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) s = fmaf(qg[d], kj[d], s);
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online-softmax step: one warp per query head, lane j = position j
    for (int g = warp; g < group; g += THREADS / 32) {
      const float s = p_s[g * TILE + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * TILE + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = fmaf(l_s[g], alpha, sum);
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha[g] + sum_j p[g][j] * v[j][d]
    for (int i = tid; i < group * DH; i += THREADS) {
      const int g = i / DH;
      const int d = i - g * DH;
      const float* pg = p_s + g * TILE;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv = fmaf(pg[j], v_s[j * DH + d], pv);
      acc_s[i] = fmaf(acc_s[i], a_s[g], pv);
    }
    __syncthreads();
  }

  for (int i = tid; i < group * DH; i += THREADS) {
    const int g = i / DH;
    const float o = len > 0 ? acc_s[i] / fmaxf(l_s[g], 1e-30f) : 0.f;
    out[qoff + i] = from_f32<T>(o);
  }
}

size_t smem_bytes(int dh, int group) {
  return sizeof(float) *
         ((size_t)TILE * (dh + 1) + (size_t)TILE * dh + 2 * (size_t)group * dh +
          (size_t)group * TILE + 3 * (size_t)group);
}

template <typename T, int DH, bool PAGED>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_len, const void* ptab, void* out, int batch,
                 int hkv, int group, int cap, int page_size, int max_pages,
                 float scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH, PAGED>;
  const size_t smem = smem_bytes(DH, group);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, batch);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<const int32_t*>(ptab), static_cast<T*>(out), hkv, group,
      cap, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             const void* ptab, void* out, int batch, int hkv, int group,
             int cap, int page_size, int max_pages, int dh, int dtype,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DA_CASE(T, D)                                                       \
  return launch_typed<T, D, PAGED>(q, k, v, kv_len, ptab, out, batch, hkv, \
                                   group, cap, page_size, max_pages, scale, \
                                   s)
  if (dtype == 0 && dh == 64) DA_CASE(float, 64);
  if (dtype == 0 && dh == 128) DA_CASE(float, 128);
  if (dtype == 1 && dh == 64) DA_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && dh == 128) DA_CASE(__nv_bfloat16, 128);
  if (dtype == 0 && dh == 256) DA_CASE(float, 256);
  if (dtype == 1 && dh == 256) DA_CASE(__nv_bfloat16, 256);
#undef DA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, dh); k/v (B, M, Hkv, dh); kv_len (B,) int32; out (B, H, dh).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, int batch,
                            int hkv, int group, int m, int dh, int dtype,
                            float scale, void* stream) {
  return dispatch<false>(q, k, v, kv_len, nullptr, out, batch, hkv, group,
                         m, 1, 0, dh, dtype, scale, stream);
}

// q (B, H, dh); k/v pools (P+1, ps, Hkv, dh); ptab (B, max_pages) int32;
// kv_len (B,) int32; out (B, H, dh).
int paged_decode_attention_launch(const void* q, const void* k,
                                  const void* v, const void* kv_len,
                                  const void* ptab, void* out, int batch,
                                  int hkv, int group, int page_size,
                                  int max_pages, int dh, int dtype,
                                  float scale, void* stream) {
  return dispatch<true>(q, k, v, kv_len, ptab, out, batch, hkv, group,
                        page_size * max_pages, page_size, max_pages, dh,
                        dtype, scale, stream);
}

}  // extern "C"
