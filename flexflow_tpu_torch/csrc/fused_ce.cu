// Fused sparse cross-entropy for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of flexflow_tpu/kernels/fused_ce.py:
//
//   `_forward` -> `_fwd_kernel`: per row of the (n, v) logits, an online
//       logsumexp over the vocab in f32, the label's logit, and
//       lse = m + log(l), loss = lse - x[y] (both f32);
//   `_backward` -> `_bwd_kernel`: dx = gs (exp(x - lse) - [col == y]) in
//       f32, rounded once to the logits' dtype, with gs = g / n.
//
// The logits stay in their own dtype (bf16 or f32): no f32 copy of the
// (n, v) array and no softmax is ever written.
//
// Design (simple first): one block of 256 threads per row in both kernels.
// The TPU walks a row's vocab blocks in order on one core, carrying
// (max, sum, picked) in VMEM scratch; here the row is split across the
// block's threads instead. Each thread strides the row with 16-byte loads
// (8 bf16 or 4 f32 values), UNROLL loads in flight, and keeps its own
// running (max, sum); the pairs merge by warp shuffles, then across the 8
// warps in shared memory. The label's logit is read once, as x[row, y]:
// JAX's sum(where(col == y, x, 0)) equals it exactly. Row offsets are
// 64-bit (n * v passes 2^31 at a larger batch in f32).
//
// The backward reads the cotangent g from device memory and divides it by
// n there, so the host never waits for the loss. Every operation is
// rounded on its own (__fsub_rn, __fmul_rn), as the plain version's
// separate PyTorch ops round them.
//
// What bounds them on an H100: bytes. At (8192, 50304) bf16 the forward
// reads 824 MB (0.246 ms at 3.35 TB/s), the backward reads and writes
// 1.65 GB (0.492 ms); the arithmetic is a few f32 operations and one exp
// per element.
//
// C interface (ctypes): ff_ce_fwd and ff_ce_bwd return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int UNROLL = 4;

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as .to(bfloat16)
}

// one 16-byte load of VecN<T>::N values, widened to f32
__device__ __forceinline__ void load_vec(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float out[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float in[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float in[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned int*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Fold K values into a running (max m, sum l of exp(x - m)). A thread that
// has seen only -inf holds (-inf, 0).
template <int K>
__device__ __forceinline__ void absorb(float& m, float& l, const float* x) {
  float cm = x[0];
#pragma unroll
  for (int i = 1; i < K; ++i) cm = fmaxf(cm, x[i]);
  if (cm > m) {
    l = __fmul_rn(l, expf(__fsub_rn(m, cm)));  // exp(-inf) = 0 on the first
    m = cm;
  }
  if (m == -INFINITY) return;  // every value so far is -inf
#pragma unroll
  for (int i = 0; i < K; ++i) l = __fadd_rn(l, expf(__fsub_rn(x[i], m)));
}

// Merge (m2, l2) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mn = fmaxf(m, m2);
  l = __fadd_rn(__fmul_rn(l, expf(__fsub_rn(m, mn))), __fmul_rn(l2, expf(__fsub_rn(m2, mn))));
  m = mn;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) ce_fwd_kernel(const T* __restrict__ x,
                                                    const int* __restrict__ y,
                                                    float* __restrict__ loss,
                                                    float* __restrict__ lse, int v,
                                                    long long ld) {
  constexpr int VN = VecN<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  float m = -INFINITY, l = 0.f;
  int c0 = 0;
  if (VEC) {
    const int nv = v / VN;
    for (int base = threadIdx.x; base < nv; base += NT * UNROLL) {
      float vals[UNROLL][VN];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u * NT < nv) load_vec(xr + (long long)(base + u * NT) * VN, vals[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u * NT < nv) absorb<VN>(m, l, vals[u]);
    }
    c0 = nv * VN;
  }
  for (int c = c0 + threadIdx.x; c < v; c += NT) {
    const float xv = to_f32(xr[c]);
    absorb<1>(m, l, &xv);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __shared__ float sm[NWARPS], sl[NWARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NWARPS; ++w) merge(m, l, sm[w], sl[w]);
    const int yy = y[row];
    // a label outside [0, v) matches no column: its logit counts as 0
    const float picked = (yy >= 0 && yy < v) ? to_f32(xr[yy]) : 0.f;
    const float s = __fadd_rn(m, logf(l));
    lse[row] = s;
    loss[row] = __fsub_rn(s, picked);
  }
}

__device__ __forceinline__ float ce_grad(float xv, float s, float gs, bool hit) {
  const float p = expf(__fsub_rn(xv, s));
  return __fmul_rn(gs, hit ? __fsub_rn(p, 1.f) : p);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) ce_bwd_kernel(const T* __restrict__ x,
                                                    const int* __restrict__ y,
                                                    const float* __restrict__ lse,
                                                    const float* __restrict__ g,
                                                    T* __restrict__ dx, int v, long long ld,
                                                    long long ldd, float n) {
  constexpr int VN = VecN<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  T* dr = dx + row * ldd;
  const float s = lse[row];
  const int yy = y[row];
  const float gs = __fdiv_rn(*g, n);
  int c0 = 0;
  if (VEC) {
    const int nv = v / VN;
    for (int base = threadIdx.x; base < nv; base += NT * UNROLL) {
      float vals[UNROLL][VN];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (base + u * NT < nv) load_vec(xr + (long long)(base + u * NT) * VN, vals[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * NT;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < VN; ++j) vals[u][j] = ce_grad(vals[u][j], s, gs, i * VN + j == yy);
          store_vec(dr + (long long)i * VN, vals[u]);
        }
      }
    }
    c0 = nv * VN;
  }
  for (int c = c0 + threadIdx.x; c < v; c += NT)
    dr[c] = from_f32<T>(ce_grad(to_f32(xr[c]), s, gs, c == yy));
}

template <typename T>
int launch_fwd(const void* x, const int* y, float* loss, float* lse, int n, int v, long long ld,
               int vec, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  if (vec)
    ce_fwd_kernel<T, true><<<n, NT, 0, st>>>(xp, y, loss, lse, v, ld);
  else
    ce_fwd_kernel<T, false><<<n, NT, 0, st>>>(xp, y, loss, lse, v, ld);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const int* y, const float* lse, const float* g, void* dx, int n,
               int v, long long ld, long long ldd, int vec, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* dp = static_cast<T*>(dx);
  if (vec)
    ce_bwd_kernel<T, true><<<n, NT, 0, st>>>(xp, y, lse, g, dp, v, ld, ldd, (float)n);
  else
    ce_bwd_kernel<T, false><<<n, NT, 0, st>>>(xp, y, lse, g, dp, v, ld, ldd, (float)n);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, v) logits with row stride ld (elements), float32 (dtype 0) or
// bfloat16 (dtype 1); y: (n,) int32 labels; loss, lse: (n,) float32 out.
// vec = 1 when x and every row start are 16-byte aligned.
extern "C" int ff_ce_fwd(const void* x, const void* y, void* loss, void* lse, int n, int v,
                         long long ld, int dtype, int vec, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* yp = static_cast<const int*>(y);
  float* lp = static_cast<float*>(loss);
  float* sp = static_cast<float*>(lse);
  if (dtype == 0) return launch_fwd<float>(x, yp, lp, sp, n, v, ld, vec, st);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, yp, lp, sp, n, v, ld, vec, st);
  return (int)cudaErrorInvalidValue;
}

// dx: (n, v) out, row stride ldd, the dtype of x; g: the float32 cotangent
// of the mean loss (one value in device memory). vec = 1 when x, dx and
// every row start of both are 16-byte aligned.
extern "C" int ff_ce_bwd(const void* x, const void* y, const void* lse, const void* g, void* dx,
                         int n, int v, long long ld, long long ldd, int dtype, int vec,
                         void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* yp = static_cast<const int*>(y);
  const float* sp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0) return launch_bwd<float>(x, yp, sp, gp, dx, n, v, ld, ldd, vec, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, yp, sp, gp, dx, n, v, ld, ldd, vec, st);
  return (int)cudaErrorInvalidValue;
}
