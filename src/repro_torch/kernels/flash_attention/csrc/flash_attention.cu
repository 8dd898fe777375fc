// Flash-attention forward (GQA, causal or not) for Hopper (sm_90a).
// Plain C interface, bound from Python with ctypes.
//
// Replaces the Pallas TPU kernel
//   B3  src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// and computes what it computes: softmax(q k^T * dh**-0.5) v per (batch,
// query head), kv head = h / (H / Hkv), causal mask top-left (key position
// <= query position), online softmax with an f32 running max, denominator
// and accumulator.  Unlike the Pallas wrapper it takes any Sq and Skv and
// masks the ragged edge itself: keys >= Skv get exactly zero weight in both
// modes (no padding copies), and query rows >= Sq are never written.
//
// Design.  One CTA of four warps per (64-row query tile, query head,
// batch); each warp owns 16 query rows.  The CTA walks 64-key tiles (in
// causal mode it stops at the diagonal, the counterpart of the Pallas
// kernel's pl.when skip), staging the K and V tiles in shared memory with
// 16-byte loads (rows >= Skv are zero-filled).  Per tile each warp
//   1. computes its 16 x 64 scores S = Q K^T: bf16 tensor cores through
//      nvcuda::wmma (16x16x16, f32 accumulators), plain fmaf for f32;
//   2. scales S by dh**-0.5 in f32 (after the product; exact at dh 64,
//      one rounding away from the Pallas kernel's pre-scaled q at dh 128),
//      masks it, and takes the online-softmax step, two columns per lane;
//      P is stored in the input type, so the bf16 instance rounds the
//      probabilities to bf16 for the P V product (relative error <= 2**-9
//      per weight) while the denominator sums the f32 values;
//   3. rescales its f32 accumulator rows in shared memory by
//      exp(m_prev - m_new) and adds P V (wmma with the accumulator loaded
//      from and stored back to shared memory, or fmaf for f32).
// Finally each row is divided by its denominator and written in the input
// type.  Heavy causal tiles (the last query tiles) are scheduled first.
// Strides are arguments, so the model's (B, S, H, dh) layout and the
// head-major (B, H, S, dh) layout both go in without a transpose copy.
//
// Bound.  At the training shape (B 8, H 12, Hkv 4, S 1024, dh 64, bf16,
// causal) the work is 4 * dh FLOP per visible (query, key) pair, 12.9
// GFLOP, 13.0 us at 989 TFLOP/s; the bytes (q, k, v read once, o written
// once) are 33.6 MB, 10.0 us at 3.35 TB/s: compute-bound.  This first
// version uses warp-level wmma (mma.sync) from shared memory with no
// wgmma, TMA or pipelining, and keeps the accumulator in shared memory;
// those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps, 16 query rows each
constexpr int SLD = BK + 4;   // f32 score row stride (elements)
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, head, position); the head dim is contiguous
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int sq, skv, group, causal;
  float scale;
};

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

// Row strides (elements) of the tiles in shared memory: a 16-byte pad keeps
// every row 16-byte aligned for vector loads and is a multiple of 8 (bf16)
// or 4 (f32) elements, as wmma's ldm must be.
template <typename T, int DH> struct Layout {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = DH + PAD;   // q, k, v tiles (T)
  static constexpr int PLD = BK + PAD;  // probabilities (T)
  static constexpr int OLD = DH + 4;    // accumulator (f32)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(T) * BQ * LD;
  static constexpr size_t V = K + sizeof(T) * BK * LD;
  static constexpr size_t S = V + sizeof(T) * BK * LD;
  static constexpr size_t P = S + sizeof(float) * BQ * SLD;
  static constexpr size_t O = P + sizeof(T) * BQ * PLD;
  static constexpr size_t M = O + sizeof(float) * BQ * OLD;
  static constexpr size_t BYTES = M + sizeof(float) * 3 * BQ;
};

// rows [r0, r0 + 64) of a (rows_valid, DH) slab with row stride `ss` into
// shared memory with row stride LD; rows >= rows_valid become zeros
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ss,
                                          int r0, int rows_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DH / VEC;
  for (int c = threadIdx.x; c < BQ * CPR; c += THREADS) {
    const int r = c / CPR;
    const int part = c - r * CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * ss +
                                            part * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + part * VEC) = val;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using L = Layout<T, DH>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::Q);
  T* k_s = reinterpret_cast<T*>(smem + L::K);
  T* v_s = reinterpret_cast<T*>(smem + L::V);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  T* p_s = reinterpret_cast<T*>(smem + L::P);
  float* o_s = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::M);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * 16;  // this warp's first row in the tile

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<T, DH, L::LD>(q_s, qg, p.q_ss, q0, p.sq);
  for (int i = threadIdx.x; i < BQ * L::OLD; i += THREADS) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  const int kend = p.causal ? min(p.skv, q0 + BQ) : p.skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, DH, L::LD>(k_s, kg, p.k_ss, k0, p.skv);
    load_tile<T, DH, L::LD>(v_s, vg, p.v_ss, k0, p.skv);
    __syncthreads();

    // 1. scores of this warp's 16 rows against the tile's 64 keys
    if constexpr (BF16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[DH / 16];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wmma::load_matrix_sync(a[kk], q_s + row0 * L::LD + kk * 16, L::LD);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          // K^T as a column-major (dh x keys) matrix is K row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bk;
          wmma::load_matrix_sync(bk, k_s + j * 16 * L::LD + kk * 16, L::LD);
          wmma::mma_sync(c, a[kk], bk, c);
        }
        wmma::store_matrix_sync(s_s + row0 * SLD + j * 16, c, SLD,
                                wmma::mem_row_major);
      }
    } else {
      for (int r = 0; r < 16; ++r) {
        const T* qr = q_s + (row0 + r) * L::LD;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half;
          const T* kr = k_s + j * L::LD;
          float s = 0.f;
#pragma unroll 16
          for (int d = 0; d < DH; ++d) s = fmaf(to_f32(qr[d]), to_f32(kr[d]), s);
          s_s[(row0 + r) * SLD + j] = s;
        }
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
        ok[half] = kpos < p.skv && (!p.causal || kpos <= qpos);
        s[half] = ok[half] ? s_s[row * SLD + lane + 32 * half] * p.scale
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
        p_s[row * L::PLD + lane + 32 * half] = from_f32<T>(pr);
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
    if constexpr (BF16) {
      for (int i = lane; i < 16 * DH; i += 32) {
        const int r = i / DH;
        const int d = i - r * DH;
        o_s[(row0 + r) * L::OLD + d] *= a_s[row0 + r];
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], p_s + row0 * L::PLD + kk * 16,
                               L::PLD);
#pragma unroll
      for (int nb = 0; nb < DH / 16; ++nb) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::load_matrix_sync(c, o_s + row0 * L::OLD + nb * 16, L::OLD,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> vb;
          wmma::load_matrix_sync(vb, v_s + kk * 16 * L::LD + nb * 16, L::LD);
          wmma::mma_sync(c, pa[kk], vb, c);
        }
        wmma::store_matrix_sync(o_s + row0 * L::OLD + nb * 16, c, L::OLD,
                                wmma::mem_row_major);
      }
    } else {
      for (int r = 0; r < 16; ++r) {
        const int row = row0 + r;
        const float alpha = a_s[row];
        const T* pr = p_s + row * L::PLD;
        for (int d = lane; d < DH; d += 32) {
          float pv = 0.f;
#pragma unroll 16
          for (int j = 0; j < BK; ++j)
            pv = fmaf(to_f32(pr[j]), to_f32(v_s[j * L::LD + d]), pv);
          o_s[row * L::OLD + d] = fmaf(o_s[row * L::OLD + d], alpha, pv);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * DH; i += THREADS) {
    const int r = i / DH;
    const int d = i - r * DH;
    if (q0 + r < p.sq)
      og[(int64_t)(q0 + r) * p.o_ss + d] =
          from_f32<T>(o_s[r * L::OLD + d] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int DH>
int launch_typed(const Params& p, int batch, int heads, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH>;
  const int smem = (int)Layout<T, DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.sq + BQ - 1) / BQ, heads, batch);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, dh), k/v (B, Hkv, Skv, dh), o like q, each given by its
// base pointer and element strides (batch, head, position) in `strides`
// (12 values: q, k, v, o).  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const int64_t* strides, int batch,
                           int heads, int group, int sq, int skv, int dh,
                           int dtype, int causal, float scale, void* stream) {
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64) return launch_typed<float, 64>(p, batch, heads, s);
  if (dtype == 0 && dh == 128) return launch_typed<float, 128>(p, batch, heads, s);
  if (dtype == 1 && dh == 64)
    return launch_typed<__nv_bfloat16, 64>(p, batch, heads, s);
  if (dtype == 1 && dh == 128)
    return launch_typed<__nv_bfloat16, 128>(p, batch, heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
