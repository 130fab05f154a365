// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/flash_attention.py
// `_fwd` -> `_fwd_kernel`: blocked online-softmax attention, causal or not,
// writing O and the per-row logsumexp. Same contract: f32 running max/sum
// and accumulator, P rounded to V's dtype before the PV product, O in Q's
// dtype, lse in f32.
//
// Design (simple first): one block of 256 threads per (batch, head, 64-row
// q tile). The q tile stays in shared memory as f32; a loop walks 64-key
// k/v tiles (only up to the diagonal when causal), staging each in shared
// memory. Each thread owns a 4 x 4 block of the 64 x 64 score tile and the
// same 4 rows of the output accumulator, so the online max/sum for a row
// lives in the 16 threads (one half-warp) that share it and is reduced with
// warp shuffles -- no shared-memory statistics. All products are scalar
// f32 FMAs: at head_dim 64 the kernel is bound by shared-memory loads, not
// by the tensor cores it does not use (wgmma/TMA come later).
//
// C interface (ctypes): ff_flash_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence dims
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int SQ, int SK,
    Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][D + 1]
  float* Ks = Qs + BQ * QS;      // [BK][D + 1]
  float* Vs = Ks + BK * KS;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int bb = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + bb * qs.b + hh * qs.h;
  const T* kp = k + bb * ks.b + hh * ks.h;
  const T* vp = v + bb * vs.b + hh * vs.h;
  T* op = o + bb * os.b + hh * os.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    Qs[r * QS + c] = qr < SQ ? to_f32<T>(qp[(long long)qr * qs.s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past this tile's last row are masked for every row in it
  const int k_end = causal ? min(SK, q0 + BQ) : SK;
  const int nk = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's PV is done with Ks/Vs/Ps
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kr = k0 + r;
      const bool in = kr < SK;
      Ks[r * KS + c] = in ? to_f32<T>(kp[(long long)kr * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32<T>(vp[(long long)kr * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < SK && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads sharing row i are one half-warp (lanes differ in tx)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        // P goes into PV rounded to V's dtype, as on the TPU
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = to_f32<T>(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < SQ) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        op[(long long)row * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
      if (tx == 0) lse[(long long)bh * SQ + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int SQ, int SK, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SQ + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, SQ, SK, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (batch, head, seq) dims of q/k/v/o viewed as (b, h, s, d) with the last
// dim contiguous. lse is a contiguous (b, h, sq) float32 array.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int dtype, int B, int H, int SQ, int SK, int D,
                            long long qsb, long long qsh, long long qss,
                            long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss,
                            long long osb, long long osh, long long oss,
                            float scale, int causal, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal, st);
  else if (dtype == 1 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale,
                                    causal, st);
  else if (dtype == 1 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale,
                                     causal, st);
  return (int)err;
}
