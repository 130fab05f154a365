// Fused int8 dequantize + decode attention for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/dequant_attention.py
// `dequant_decode_attention` -> `_kernel`: the gathered int8 K/V context of
// one slot is widened to f32 and multiplied by its per-(entry, head) scale
// in registers, scores are masked to `col <= pos + row` with -inf, a stable
// softmax runs over them, and P times the widened V gives the output. All
// math is f32; the output is in the query's dtype. The two f32 copies of the
// context never reach device memory.
//
// Design (simple first): one block of 256 threads per (slot, head). The
// 1..8 query rows sit in shared memory. Every loop stops at key pos + S - 1,
// the last one any query row of the slot may see. Scores: one key per thread -- the
// thread reads its key's int8 row in 16-byte loads, widens, scales and dots
// it against every query row; the score rows stay in shared memory. Softmax:
// one warp per query row. PV: each thread owns one output column for a
// strided group of keys (a warp reads one contiguous int8 row of V), and the
// groups are summed through shared memory. The kernel is bound by reading
// the int8 context once; with one block per (slot, head) a batch of 8 slots
// x 16 heads fills 128 of the 132 SMs and each block walks its context
// alone (a split-K layout comes later).
//
// C interface (ctypes): ff_dequant_decode returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_S = 8;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t smem_floats(int S, int L, int D) {
  // query rows, score rows, per-group partial outputs, row sums
  return (size_t)S * D + (size_t)S * L + (size_t)(NT / D) * S * D + MAX_S;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dequant_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq, const float* __restrict__ ksc,
    const int8_t* __restrict__ vq, const float* __restrict__ vsc,
    const int* __restrict__ pos, T* __restrict__ out, int S, int H, int L, float scale) {
  constexpr int G = NT / D;  // key groups of the PV phase
  extern __shared__ float smem[];
  float* Qs = smem;             // [S][D]
  float* Ps = Qs + S * D;       // [S][L]
  float* Red = Ps + S * L;      // [G][S][D]
  float* Ls = Red + G * S * D;  // [MAX_S]

  const int tid = threadIdx.x;
  const int bb = blockIdx.x / H, hh = blockIdx.x % H;
  const int p0 = pos[bb];
  // keys past pos + S - 1 are masked for every query row: never read them
  const int Lv = min(L, p0 + S);

  for (int idx = tid; idx < S * D; idx += NT) {
    const int i = idx / D, c = idx % D;
    Qs[idx] = to_f32<T>(q[(((long long)bb * S + i) * H + hh) * D + c]);
  }
  __syncthreads();

  // scores: one key per thread
  for (int j = tid; j < Lv; j += NT) {
    const long long row = ((long long)bb * L + j) * H + hh;
    const int8_t* kr = kq + row * D;
    const float sc = ksc[row];
    float acc[MAX_S];
#pragma unroll
    for (int i = 0; i < MAX_S; ++i) acc[i] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 16) {
      const int4 raw = *reinterpret_cast<const int4*>(kr + c0);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float kv = (float)b8[u] * sc;
#pragma unroll
        for (int i = 0; i < MAX_S; ++i)
          if (i < S) acc[i] = fmaf(Qs[i * D + c0 + u], kv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_S; ++i)
      if (i < S) Ps[i * L + j] = j <= p0 + i ? acc[i] * scale : -INFINITY;
  }
  __syncthreads();

  // softmax: one warp per query row
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < S; i += NT / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < Lv; j += 32) mx = fmaxf(mx, Ps[i * L + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < Lv; j += 32) {
      const float p = expf(Ps[i * L + j] - mx);
      Ps[i * L + j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) Ls[i] = sum;
  }
  __syncthreads();

  // PV: thread -> (key group g, output column c)
  const int c = tid % D, g = tid / D;
  float acc[MAX_S];
#pragma unroll
  for (int i = 0; i < MAX_S; ++i) acc[i] = 0.f;
  for (int j = g; j < Lv; j += G) {
    const long long row = ((long long)bb * L + j) * H + hh;
    const float vv = (float)vq[row * D + c] * vsc[row];
#pragma unroll
    for (int i = 0; i < MAX_S; ++i)
      if (i < S) acc[i] = fmaf(Ps[i * L + j], vv, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < MAX_S; ++i)
    if (i < S) Red[(g * S + i) * D + c] = acc[i];
  __syncthreads();
  for (int idx = tid; idx < S * D; idx += NT) {
    const int i = idx / D, cc = idx % D;
    float tot = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) tot += Red[(gg * S + i) * D + cc];
    out[(((long long)bb * S + i) * H + hh) * D + cc] = from_f32<T>(tot / Ls[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kq, const void* ks, const void* vq,
                   const void* vs, const void* pos, void* out, int B, int S, int H, int L,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(S, L, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dequant_decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dequant_decode_kernel<T, D><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<T*>(out), S, H, L, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q and out). q/out (B, S, H, D),
// kq/vq (B, L, H, D) int8, ks/vs (B, L, H) float32, pos (B,) int32, all
// contiguous; kq/vq 16-byte aligned.
extern "C" int ff_dequant_decode(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, const void* pos, void* out,
                                 int dtype, int B, int S, int H, int L, int D, float scale,
                                 void* stream) {
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, kq, ks, vq, vs, pos, out, B, S, H, L, scale, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, kq, ks, vq, vs, pos, out, B, S, H, L, scale, st);
  else if (dtype == 1 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, kq, ks, vq, vs, pos, out, B, S, H, L, scale, st);
  else if (dtype == 1 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, kq, ks, vq, vs, pos, out, B, S, H, L, scale, st);
  return (int)err;
}
