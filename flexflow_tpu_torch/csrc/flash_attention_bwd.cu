// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++:
// the dQ kernel and the dK/dV kernel.
//
// Replaces the Pallas TPU kernels of flexflow_tpu/kernels/flash_attention.py
// `_bwd`: `_dq_kernel` (dQ gridded over q tiles) and `_dkv_kernel` (dK, dV
// gridded over k tiles). Same contract, rounding for rounding: P is
// recomputed as exp(S * scale - lse) from the forward's saved lse, with the
// causal mask applied to P; delta = rowsum(f32(dO) * f32(O)) comes in
// precomputed; dS = P * (dP - delta) * scale is rounded to the input dtype
// before dS.K and dS^T.Q; P is rounded to dO's dtype before P^T.dO; every
// product accumulates in f32 and each output is written once in the input
// dtype.
//
// Design (simple first, the forward's thread layout): 256 threads as 16 x
// 16; thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j of each
// 64 x 64 score tile, and the same rows of its 64 x D accumulator. Tiles sit
// in shared memory as f32 with a padded row stride (D + 1), so the column
// walks of the score products are free of bank conflicts.
//
// - dQ: one block per (64-row q tile, batch*head). q, dO, lse and delta are
//   loaded once; a loop walks the 64-key k/v tiles (to the diagonal when
//   causal) and accumulates dQ += dS.K in registers. The block owns its dQ
//   rows: no reduction across blocks.
// - dK/dV: one block per (64-key k/v tile, batch*head). k and v stay in
//   shared memory; a loop walks the q tiles from the diagonal to the end
//   (all of them when not causal) and accumulates dV += round(P)^T.dO and
//   dK += dS^T.q in registers. Each output is written once; no atomics.
//
// What bounds them on an H100: at GPT-2 medium's training shape (8 x 16
// heads x 1024 x 64, bf16, causal) dQ does 3 causal matmuls (25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s) and dK/dV 4 (34.4 GFLOP, 0.035 ms), against
// ~85 MB of traffic (0.025 ms): about even, slightly operations bound.
// These kernels do their products as scalar f32 FMAs from shared memory and
// are bound by those instead; mma.sync/wgmma tiles are later work.
//
// C interface (ctypes): each entry point returns cudaGetLastError().

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
// x rounded to T and widened back: the value a T-typed product operand holds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence dims
};

// a 64-row tile of a (b, h, s, d) tensor into shared memory as f32, rows
// past `n` zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < n ? to_f32<T>(src[(long long)gr * st.s + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)64 * (D + 1) + (size_t)BQ * (BK + 1);
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)64 * (D + 1) + 2 * (size_t)BK * (BQ + 1) + 2 * (size_t)BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int SQ, int SK,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale, int causal) {
  constexpr int RS = D + 1, PS = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][D + 1]
  float* dOs = Qs + BQ * RS;     // [BQ][D + 1]
  float* Ks = dOs + BQ * RS;     // [BK][D + 1]
  float* Vs = Ks + BK * RS;      // [BK][D + 1]
  float* dSs = Vs + BK * RS;     // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int bb = bh / H, hh = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* kp = k + bb * ks.b + hh * ks.h;
  const T* vp = v + bb * vs.b + hh * vs.h;

  load_tile<T, D>(Qs, q + bb * qs.b + hh * qs.h, qs, q0, SQ);
  load_tile<T, D>(dOs, dout + bb * dos.b + hh * dos.h, dos, q0, SQ);
  float row_lse[4], row_delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < SQ ? lse[(long long)bh * SQ + row] : 0.f;
    row_delta[i] = row < SQ ? delta[(long long)bh * SQ + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(SK, q0 + BQ) : SK;
  const int nk = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's dS.K is done with Ks/dSs
    load_tile<T, D>(Ks, kp, ks, k0, SK);
    load_tile<T, D>(Vs, vp, vs, k0, SK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * RS + kk];
        dov[i] = dOs[(ty * 4 + i) * RS + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * RS + kk];
        vv[j] = Vs[(tx + 16 * j) * RS + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < SQ && col < SK && (!causal || col <= row);
        const float p = keep ? expf(__fmul_rn(s[i][j], scale) - row_lse[i]) : 0.f;
        dSs[(ty * 4 + i) * PS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dqp = dq + bb * dqs.b + hh * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < SQ) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqp[(long long)row * dqs.s + tx + 16 * j] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
    int SQ, int SK, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
    Strides dvs, float scale, int causal) {
  constexpr int RS = D + 1, PS = BQ + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][D + 1]
  float* Vs = Ks + BK * RS;      // [BK][D + 1]
  float* Qs = Vs + BK * RS;      // [BQ][D + 1]
  float* dOs = Qs + BQ * RS;     // [BQ][D + 1]
  float* Ps = dOs + BQ * RS;     // [BK][BQ + 1]: round(P)^T
  float* dSs = Ps + BK * PS;     // [BK][BQ + 1]: dS^T
  float* lse_s = dSs + BK * PS;  // [BQ]
  float* delta_s = lse_s + BQ;   // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int bb = bh / H, hh = bh % H;
  const int k0 = blockIdx.x * BK;
  const T* qp = q + bb * qs.b + hh * qs.h;
  const T* dop = dout + bb * dos.b + hh * dos.h;

  load_tile<T, D>(Ks, k + bb * ks.b + hh * ks.h, ks, k0, SK);
  load_tile<T, D>(Vs, v + bb * vs.b + hh * vs.h, vs, k0, SK);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: q rows before this tile's first key see none of its keys
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = (SQ + BQ - 1) / BQ;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's products are done with Qs/dOs/Ps/dSs
    load_tile<T, D>(Qs, qp, qs, q0, SQ);
    load_tile<T, D>(dOs, dop, dos, q0, SQ);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < SQ ? lse[(long long)bh * SQ + row] : 0.f;
      delta_s[tid] = row < SQ ? delta[(long long)bh * SQ + row] : 0.f;
    }
    __syncthreads();

    // transposed score tile: thread rows are keys, columns are q rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * RS + kk];
        vv[i] = Vs[(ty * 4 + i) * RS + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * RS + kk];
        dov[j] = dOs[(tx + 16 * j) * RS + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int row = q0 + qc;
        const bool keep = row < SQ && key < SK && (!causal || key <= row);
        const float p = keep ? expf(__fmul_rn(s[i][j], scale) - lse_s[qc]) : 0.f;
        Ps[(ty * 4 + i) * PS + qc] = round_to<T>(p);
        dSs[(ty * 4 + i) * PS + qc] = round_to<T>(p * (dp[i][j] - delta_s[qc]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty * 4 + i) * PS + c];
        dsv[i] = dSs[(ty * 4 + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = dOs[c * RS + tx + 16 * j];
        qv[j] = Qs[c * RS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dkp = dk + bb * dks.b + hh * dks.h;
  T* dvp = dv + bb * dvs.b + hh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < SK) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkp[(long long)key * dks.s + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
        dvp[(long long)key * dvs.s + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int H,
                      int SQ, int SK, Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SQ + BQ - 1) / BQ, B * H);
  flash_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, SQ, SK, qs, ks,
      vs, dos, dqs, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B,
                       int H, int SQ, int SK, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SK + BK - 1) / BK, B * H);
  flash_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, SQ, SK, qs, ks, vs, dos, dks, dvs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// (batch, head, seq) dims of each tensor viewed as (b, h, s, d) with the
// last dim contiguous. lse and delta are contiguous (b, h, sq) float32.
extern "C" int ff_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               void* dq, int dtype, int B, int H, int SQ, int SK, int D,
                               long long qsb, long long qsh, long long qss,
                               long long ksb, long long ksh, long long kss,
                               long long vsb, long long vsh, long long vss,
                               long long dosb, long long dosh, long long doss,
                               long long dqsb, long long dqsh, long long dqss,
                               float scale, int causal, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      dos{dosb, dosh, doss}, dqs{dqsb, dqsh, dqss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0 && D == 64)
    return (int)launch_dq<float, 64>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs,
                                     dos, dqs, scale, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch_dq<float, 128>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs,
                                      dos, dqs, scale, causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs,
                                             ks, vs, dos, dqs, scale, causal, st);
  if (dtype == 1 && D == 128)
    return (int)launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs,
                                              ks, vs, dos, dqs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ff_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dk, void* dv, int dtype, int B, int H, int SQ,
                                int SK, int D, long long qsb, long long qsh,
                                long long qss, long long ksb, long long ksh,
                                long long kss, long long vsb, long long vsh,
                                long long vss, long long dosb, long long dosh,
                                long long doss, long long dksb, long long dksh,
                                long long dkss, long long dvsb, long long dvsh,
                                long long dvss, float scale, int causal, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      dos{dosb, dosh, doss}, dks{dksb, dksh, dkss}, dvs{dvsb, dvsh, dvss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0 && D == 64)
    return (int)launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks,
                                      vs, dos, dks, dvs, scale, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch_dkv<float, 128>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks,
                                       vs, dos, dks, dvs, scale, causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK,
                                              qs, ks, vs, dos, dks, dvs, scale, causal,
                                              st);
  if (dtype == 1 && D == 128)
    return (int)launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK,
                                               qs, ks, vs, dos, dks, dvs, scale, causal,
                                               st);
  return (int)cudaErrorInvalidValue;
}
