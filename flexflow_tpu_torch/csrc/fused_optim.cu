// Fused Adam update for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/fused_optim.py
// `_adam_leaf` -> `_adam_kernel`: one pass that reads (g, mu, nu, p) and
// writes (mu', nu', p'), with all arithmetic in f32 and the moments stored
// in the optimizer's state dtype (f32, or bf16 rounded to nearest even as
// `astype(bf16)` does). Same math as the TPU kernel followed by
// `optax.apply_updates`:
//
//   mu' = b1 mu + (1 - b1) g          nu' = b2 nu + (1 - b2) g g
//   u   = (mu' / bc1) / (sqrt(nu' / bc2) + eps)   [+ wd p]
//   p'  = p + (-lr u)
//
// with bc1 = 1 - b1**count and bc2 = 1 - b2**count computed by the caller in
// f32. The update goes straight into p, which saves the pass that writes
// the update and reads it back.
//
// Design: ONE launch per step over every parameter (the TPU code launches
// one pallas_call per padded leaf, 389 a step for GPT-2 medium, which on
// this card would be pure host cost). The caller builds a device table with
// one entry per fixed-size chunk of every leaf: the chunk's g, mu, nu and p
// pointers and its length. Block c takes chunk c; its threads walk the chunk
// with 16-byte loads of g and p (8-byte loads of bf16 moments) where every
// pointer is aligned, and scalar loads otherwise.
//
// What bounds it on an H100: bytes. GPT-2 medium's 406,286,336 f32 params
// move 28 bytes each (g, mu, nu, p read; mu, nu, p written) = 11.4 GB,
// 3.40 ms at 3.35 TB/s; the arithmetic is ~15 flops per element.
//
// C interface (ctypes): ff_adam returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

// one table entry: g, mu, nu, p pointers and the chunk's element count
struct Chunk {
  long long g, mu, nu, p, n;
};

template <typename M> __device__ __forceinline__ float ld(const M* x);
template <> __device__ __forceinline__ float ld<float>(const float* x) { return *x; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* x) {
  return __bfloat162float(*x);
}
template <typename M> __device__ __forceinline__ M st(float x);
template <> __device__ __forceinline__ float st<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the per-element update; mu/nu come in and go out as f32. Every product
// and sum is rounded on its own (no FMA contraction), as the plain version's
// separate PyTorch ops round them.
__device__ __forceinline__ void adam_elem(const AdamArgs& a, float g, float& mu, float& nu,
                                          float& p) {
  mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, g));
  nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(__fmul_rn(a.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(mu, a.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, a.bc2)), a.eps));
  if (a.wd != 0.f) u = __fadd_rn(u, __fmul_rn(a.wd, p));
  p = __fadd_rn(p, __fmul_rn(-a.lr, u));
}

template <typename M>
__device__ __forceinline__ void load4(const M* x, float out[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* x, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* x, float out[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(x);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}
template <typename M>
__device__ __forceinline__ void store4(M* x, const float in[4]);
template <>
__device__ __forceinline__ void store4<float>(float* x, const float in[4]) {
  *reinterpret_cast<float4*>(x) = make_float4(in[0], in[1], in[2], in[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* x, const float in[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(in[0], in[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2], in[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned int*>(&lo);
  v.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(x) = v;
}

template <typename M>
__global__ void __launch_bounds__(NT) adam_kernel(const Chunk* __restrict__ table,
                                                  AdamArgs a) {
  const Chunk c = table[blockIdx.x];
  const float* g = reinterpret_cast<const float*>(c.g);
  M* mu = reinterpret_cast<M*>(c.mu);
  M* nu = reinterpret_cast<M*>(c.nu);
  float* p = reinterpret_cast<float*>(c.p);
  const long long n = c.n;
  const bool vec = ((c.g | c.p) & 15) == 0 && ((c.mu | c.nu) & (4 * sizeof(M) - 1)) == 0;
  long long i0 = 0;
  if (vec) {
    const long long n4 = n & ~3LL;
    for (long long i = 4LL * threadIdx.x; i < n4; i += 4LL * NT) {
      float gv[4], mv[4], vv[4], pv[4];
      load4<float>(g + i, gv);
      load4<M>(mu + i, mv);
      load4<M>(nu + i, vv);
      load4<float>(p + i, pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) adam_elem(a, gv[j], mv[j], vv[j], pv[j]);
      store4<M>(mu + i, mv);
      store4<M>(nu + i, vv);
      store4<float>(p + i, pv);
    }
    i0 = n4;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += NT) {
    float m = ld<M>(mu + i), v = ld<M>(nu + i), pv = p[i];
    adam_elem(a, g[i], m, v, pv);
    mu[i] = st<M>(m);
    nu[i] = st<M>(v);
    p[i] = pv;
  }
}

}  // namespace

// table: n_chunks entries of 5 int64 (g, mu, nu, p, n) in device memory;
// g and p are float32, mu and nu are float32 (moment_dtype 0) or bfloat16
// (moment_dtype 1).
extern "C" int ff_adam(const void* table, int n_chunks, int moment_dtype, float lr,
                       float b1, float omb1, float b2, float omb2, float eps, float wd,
                       float bc1, float bc2, void* stream) {
  if (n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chunk* t = static_cast<const Chunk*>(table);
  if (moment_dtype == 0)
    adam_kernel<float><<<n_chunks, NT, 0, st>>>(t, a);
  else if (moment_dtype == 1)
    adam_kernel<__nv_bfloat16><<<n_chunks, NT, 0, st>>>(t, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
