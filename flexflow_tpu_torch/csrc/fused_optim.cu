// Fused optimizer updates for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of flexflow_tpu/kernels/fused_optim.py:
//
//   `_adam_leaf` -> `_adam_kernel`: one pass that reads (g, mu, nu, p) and
//       writes (mu', nu', p'), all arithmetic in f32, the moments stored in
//       the optimizer's state dtype (f32, or bf16 rounded to nearest even
//       as `astype(bf16)` does). Same math as the TPU kernel followed by
//       `optax.apply_updates`:
//
//         mu' = b1 mu + (1 - b1) g          nu' = b2 nu + (1 - b2) g g
//         u   = (mu' / bc1) / (sqrt(nu' / bc2) + eps)   [+ wd p]
//         p'  = p + (-lr u)
//
//       with bc1 = 1 - b1**count and bc2 = 1 - b2**count computed by the
//       caller in f32 ON THE DEVICE: the kernel reads them from a (2,) f32
//       array `sc`, as the TPU kernel takes its scalars as an array. So a
//       CUDA graph that captures the step replays each step's own
//       corrections (a host float would be baked into the graph).
//   `_sgd_leaf` -> `_sgd_kernel` (momentum trace t, f32) and
//       `_sgd_plain_kernel` (no trace):
//
//         g' = g [+ wd p]     t' = g' + m t     u = t', or g' + m t' (nesterov)
//         p' = p + (-lr u)    (without a trace: u = g')
//
// Every update goes straight into p (and the moments or trace in place),
// which saves the pass that writes the update and reads it back.
//
// Design: ONE launch per step over every parameter (the TPU code launches
// one pallas_call per padded leaf, 389 a step for GPT-2 medium, which on
// this card would be pure host cost). The caller builds a device table with
// one entry per fixed-size chunk of every leaf: the chunk's leaf index and
// element offset, its pointers into the arrays that persist from step to
// step (params, moments, trace) and its length. The gradients are new
// tensors every step, so their leaves' base pointers come in a separate
// per-step array `gptrs`, indexed by the entry's leaf: the table itself is
// built once and reused while the persistent pointers hold. Block c takes
// chunk c; its threads walk the chunk with 16-byte loads of the f32 arrays
// (8-byte loads of bf16 moments) where every pointer is aligned, and scalar
// loads otherwise.
//
// What bounds them on an H100: bytes. Adam moves 28 bytes per f32 param
// (g, mu, nu, p read; mu, nu, p written): 11.4 GB for GPT-2 medium's
// 406,286,336 params, 3.40 ms at 3.35 TB/s. SGD with a trace moves 20
// bytes (g, t, p read; t, p written), without one 12 (g, p read; p
// written): 2.43 and 1.46 ms for the 406,334,464 params of GPT-2 medium
// with its vocab padded to 50304. The arithmetic is 2 to 15 flops per
// element.
//
// C interface (ctypes): ff_adam and ff_sgd return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps, wd;
};

// one table entry: the leaf's index into gptrs, the chunk's element offset
// in the leaf, mu, nu, p pointers and the chunk's element count
struct Chunk {
  long long leaf, off, mu, nu, p, n;
};

__device__ __forceinline__ const float* grad_ptr(const long long* gptrs, long long leaf,
                                                 long long off) {
  return reinterpret_cast<const float*>(gptrs[leaf]) + off;
}

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
__device__ __forceinline__ void adam_elem(const AdamArgs& a, float bc1, float bc2, float g,
                                          float& mu, float& nu, float& p) {
  mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, g));
  nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(__fmul_rn(a.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(mu, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), a.eps));
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
                                                  const long long* __restrict__ gptrs,
                                                  const float* __restrict__ sc, AdamArgs a) {
  const Chunk c = table[blockIdx.x];
  const float bc1 = sc[0], bc2 = sc[1];
  const float* g = grad_ptr(gptrs, c.leaf, c.off);
  M* mu = reinterpret_cast<M*>(c.mu);
  M* nu = reinterpret_cast<M*>(c.nu);
  float* p = reinterpret_cast<float*>(c.p);
  const long long n = c.n;
  const bool vec = (((long long)g | c.p) & 15) == 0 &&
                   ((c.mu | c.nu) & (4 * sizeof(M) - 1)) == 0;
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
      for (int j = 0; j < 4; ++j) adam_elem(a, bc1, bc2, gv[j], mv[j], vv[j], pv[j]);
      store4<M>(mu + i, mv);
      store4<M>(nu + i, vv);
      store4<float>(p + i, pv);
    }
    i0 = n4;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += NT) {
    float m = ld<M>(mu + i), v = ld<M>(nu + i), pv = p[i];
    adam_elem(a, bc1, bc2, g[i], m, v, pv);
    mu[i] = st<M>(m);
    nu[i] = st<M>(v);
    p[i] = pv;
  }
}

struct SgdArgs {
  float lr, m, wd;
};

// table entries of the SGD kernels, with a trace (t, p) and without (p),
// after the gradient's leaf index and offset as in Chunk
struct TraceChunk {
  long long leaf, off, t, p, n;
};
struct PlainChunk {
  long long leaf, off, p, n;
};

// Each product and sum rounded on its own, as the plain version rounds them.
template <bool WD, bool NESTEROV>
__device__ __forceinline__ void sgd_elem(const SgdArgs& a, float g, float& t, float& p) {
  if (WD) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  const float tn = __fadd_rn(g, __fmul_rn(a.m, t));
  const float u = NESTEROV ? __fadd_rn(g, __fmul_rn(a.m, tn)) : tn;
  t = tn;
  p = __fadd_rn(p, __fmul_rn(-a.lr, u));
}

template <bool WD>
__device__ __forceinline__ void sgd_plain_elem(const SgdArgs& a, float g, float& p) {
  if (WD) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  p = __fadd_rn(p, __fmul_rn(-a.lr, g));
}

template <bool WD, bool NESTEROV>
__global__ void __launch_bounds__(NT) sgd_kernel(const TraceChunk* __restrict__ table,
                                                 const long long* __restrict__ gptrs,
                                                 SgdArgs a) {
  const TraceChunk c = table[blockIdx.x];
  const float* g = grad_ptr(gptrs, c.leaf, c.off);
  float* t = reinterpret_cast<float*>(c.t);
  float* p = reinterpret_cast<float*>(c.p);
  const long long n = c.n;
  long long i0 = 0;
  if ((((long long)g | c.t | c.p) & 15) == 0) {
    const long long n4 = n & ~3LL;
    for (long long i = 4LL * threadIdx.x; i < n4; i += 4LL * NT) {
      float gv[4], tv[4], pv[4];
      load4<float>(g + i, gv);
      load4<float>(t + i, tv);
      load4<float>(p + i, pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) sgd_elem<WD, NESTEROV>(a, gv[j], tv[j], pv[j]);
      store4<float>(t + i, tv);
      store4<float>(p + i, pv);
    }
    i0 = n4;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += NT) {
    float tv = t[i], pv = p[i];
    sgd_elem<WD, NESTEROV>(a, g[i], tv, pv);
    t[i] = tv;
    p[i] = pv;
  }
}

template <bool WD>
__global__ void __launch_bounds__(NT) sgd_plain_kernel(const PlainChunk* __restrict__ table,
                                                       const long long* __restrict__ gptrs,
                                                       SgdArgs a) {
  const PlainChunk c = table[blockIdx.x];
  const float* g = grad_ptr(gptrs, c.leaf, c.off);
  float* p = reinterpret_cast<float*>(c.p);
  const long long n = c.n;
  long long i0 = 0;
  if ((((long long)g | c.p) & 15) == 0) {
    const long long n4 = n & ~3LL;
    for (long long i = 4LL * threadIdx.x; i < n4; i += 4LL * NT) {
      float gv[4], pv[4];
      load4<float>(g + i, gv);
      load4<float>(p + i, pv);
#pragma unroll
      for (int j = 0; j < 4; ++j) sgd_plain_elem<WD>(a, gv[j], pv[j]);
      store4<float>(p + i, pv);
    }
    i0 = n4;
  }
  for (long long i = i0 + threadIdx.x; i < n; i += NT) {
    float pv = p[i];
    sgd_plain_elem<WD>(a, g[i], pv);
    p[i] = pv;
  }
}

}  // namespace

// table: n_chunks entries of 6 int64 (leaf, off, mu, nu, p, n) in device
// memory; gptrs: one int64 gradient base pointer per leaf, in device memory;
// sc: the f32 bias corrections (bc1, bc2), in device memory.
// g and p are float32, mu and nu are float32 (moment_dtype 0) or bfloat16
// (moment_dtype 1).
extern "C" int ff_adam(const void* table, const void* gptrs, int n_chunks, int moment_dtype,
                       float lr, float b1, float omb1, float b2, float omb2, float eps, float wd,
                       const void* sc, void* stream) {
  if (n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, b1, omb1, b2, omb2, eps, wd};
  const float* scf = static_cast<const float*>(sc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Chunk* t = static_cast<const Chunk*>(table);
  const long long* gp = static_cast<const long long*>(gptrs);
  if (moment_dtype == 0)
    adam_kernel<float><<<n_chunks, NT, 0, st>>>(t, gp, scf, a);
  else if (moment_dtype == 1)
    adam_kernel<__nv_bfloat16><<<n_chunks, NT, 0, st>>>(t, gp, scf, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// table: n_chunks entries of 5 int64 (leaf, off, t, p, n) when has_trace,
// else of 4 int64 (leaf, off, p, n), in device memory; gptrs as for ff_adam;
// g, t and p are float32.
extern "C" int ff_sgd(const void* table, const void* gptrs, int n_chunks, int has_trace,
                      int nesterov, float lr, float momentum, float wd, void* stream) {
  if (n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const SgdArgs a{lr, momentum, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool decay = wd != 0.f;
  const long long* gp = static_cast<const long long*>(gptrs);
  if (has_trace) {
    const TraceChunk* t = static_cast<const TraceChunk*>(table);
    if (decay && nesterov)
      sgd_kernel<true, true><<<n_chunks, NT, 0, st>>>(t, gp, a);
    else if (decay)
      sgd_kernel<true, false><<<n_chunks, NT, 0, st>>>(t, gp, a);
    else if (nesterov)
      sgd_kernel<false, true><<<n_chunks, NT, 0, st>>>(t, gp, a);
    else
      sgd_kernel<false, false><<<n_chunks, NT, 0, st>>>(t, gp, a);
  } else {
    const PlainChunk* t = static_cast<const PlainChunk*>(table);
    if (decay)
      sgd_plain_kernel<true><<<n_chunks, NT, 0, st>>>(t, gp, a);
    else
      sgd_plain_kernel<false><<<n_chunks, NT, 0, st>>>(t, gp, a);
  }
  return (int)cudaGetLastError();
}
