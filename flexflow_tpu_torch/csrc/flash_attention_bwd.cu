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
// Routes, by dtype in the C entry points:
//
// - dQ, float32: flash_dq_kernel, scalar f32 FMAs. 256 threads as 16 x
//   16; thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j of
//   each 64 x 64 score tile and the same rows of its 64 x D accumulator.
//   Tiles sit in shared memory as f32 with a padded row stride (D + 1).
//   One block per (64-row q tile, batch*head): q, dO, lse and delta are
//   loaded once; a loop walks the 64-key k/v tiles (to the diagonal when
//   causal) and accumulates dQ += dS.K in registers.
// - dQ, bfloat16: flash_dq_tc_kernel, on the tensor cores (mma.sync
//   m16n8k16, tc_bf16.cuh): dK/dV's structure with the loop over k tiles.
//   One block of 4 warps per (64-row q tile, batch*head), each warp owning
//   16 q rows; its Q and dO rows are A fragments (held in registers at
//   head_dim 64, read again from shared memory each k tile at 128, where
//   registers run out), its rows' lse and delta sit in registers. The loop
//   over k tiles double-buffers K and V with cp.async: tile j+1 is in
//   flight while tile j is in the tensor cores. S = Q.K^T and dP = dO.V^T
//   come out as accumulator fragments (B by plain ldmatrix: keys run along
//   the tiles' rows); P (by expf) and dS are formed there, dS rounded to
//   bf16 and packed straight into A fragments for dQ += dS.K (B by
//   transposed ldmatrix over the same K tile: keys are its k dimension).
//   Only the diagonal tile and the ragged end are masked. Causal launches
//   the q tiles with the most k tiles first. dQ is staged in the warp's
//   own Q rows and written once, with 16-byte stores.
// - dK/dV, float32: flash_dkv_kernel, the same scalar layout. One block per
//   (64-key tile, batch*head); k and v stay in shared memory; a loop walks
//   the q tiles from the diagonal to the end (all of them when not causal)
//   and accumulates dV += round(P)^T.dO and dK += dS^T.q in registers.
//   Tensor cores give no f32 products at the 1e-4 the f32 checks hold
//   both f32 kernels to.
// - dK/dV, bfloat16: flash_dkv_tc_kernel, on the tensor cores (mma.sync
//   m16n8k16, tc_bf16.cuh). One block of 4 warps per (64-key tile,
//   batch*head), each warp owning 16 keys; its K and V rows are A
//   fragments (held in registers at head_dim 64, read again from shared
//   memory each q tile at 128, where registers run out). The loop over q
//   tiles double-buffers Q, dO, lse and delta with cp.async: tile i+1 is in
//   flight while tile i is in the tensor cores. S^T = K.Q^T and dP^T =
//   V.dO^T come out as accumulator fragments; P^T and dS^T are formed
//   there (P by expf, as dQ makes it), rounded to bf16 and packed straight
//   into A fragments for dV += P^T.dO and dK += dS^T.Q (B by transposed
//   ldmatrix). Only the diagonal tile and the ragged end are masked. dK
//   and dV are staged in the warp's own K and V rows and written once,
//   with 16-byte stores; no atomics.
//
// Each output is written once; no reduction across blocks.
//
// What bounds them on an H100: at GPT-2 medium's training shape (8 x 16
// heads x 1024 x 64, bf16, causal) dQ does 3 causal matmuls (25.8 GFLOP,
// 0.026 ms at 989 TFLOP/s) and dK/dV 4 (34.4 GFLOP, 0.035 ms), against
// ~85 MB of traffic (0.025 ms): about even, slightly operations bound. The
// scalar f32 kernels are bound by their FMAs from shared memory instead.
//
// C interface (ctypes): each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence dims
};

// a 64-row tile of a (b, h, s, d) f32 tensor into shared memory, rows past
// `n` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, Strides st, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < n ? src[(long long)gr * st.s + c] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int SQ, int SK,
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
  const float* kp = k + bb * ks.b + hh * ks.h;
  const float* vp = v + bb * vs.b + hh * vs.h;

  load_tile<D>(Qs, q + bb * qs.b + hh * qs.h, qs, q0, SQ);
  load_tile<D>(dOs, dout + bb * dos.b + hh * dos.h, dos, q0, SQ);
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
    load_tile<D>(Ks, kp, ks, k0, SK);
    load_tile<D>(Vs, vp, vs, k0, SK);
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
        dSs[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
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

  float* dqp = dq + bb * dqs.b + hh * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < SQ) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqp[(long long)row * dqs.s + tx + 16 * j] = acc[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H,
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
  const float* qp = q + bb * qs.b + hh * qs.h;
  const float* dop = dout + bb * dos.b + hh * dos.h;

  load_tile<D>(Ks, k + bb * ks.b + hh * ks.h, ks, k0, SK);
  load_tile<D>(Vs, v + bb * vs.b + hh * vs.h, vs, k0, SK);
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
    load_tile<D>(Qs, qp, qs, q0, SQ);
    load_tile<D>(dOs, dop, dos, q0, SQ);
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
        Ps[(ty * 4 + i) * PS + qc] = p;
        dSs[(ty * 4 + i) * PS + qc] = p * (dp[i][j] - delta_s[qc]) * scale;
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

  float* dkp = dk + bb * dks.b + hh * dks.h;
  float* dvp = dv + bb * dvs.b + hh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < SK) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkp[(long long)key * dks.s + tx + 16 * j] = dk_acc[i][j];
        dvp[(long long)key * dvs.s + tx + 16 * j] = dv_acc[i][j];
      }
    }
  }
}

// ------------------------------------------- bf16 tensor-core dK/dV route
constexpr int TC_THREADS = 128;  // 4 warps x 16 rows (keys for dK/dV, q rows for dQ)

template <int D>
constexpr size_t dkv_tc_smem_bytes() {  // K, V, (Q, dO) x 2 padded bf16 tiles, (lse, delta) x 2
  return (size_t)(2 * BK + 4 * BQ) * (D + tc::PAD) * sizeof(__nv_bfloat16) +
         4 * (size_t)BQ * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int SQ, int SK,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale,
    int causal) {
  static_assert(BQ == 64 && BK == 64, "4 warps x 16 keys, 8 n-blocks of q rows");
  constexpr int RS = D + tc::PAD, KD = D / 16, ND = D / 8;
  constexpr bool KV_IN_REGS = D <= 64;  // at 128 the fragments would spill
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][RS]
  __nv_bfloat16* Vs = Ks + BK * RS;                                // [BK][RS]
  __nv_bfloat16* Qs = Vs + BK * RS;                                // [2][BQ][RS]
  __nv_bfloat16* dOs = Qs + 2 * BQ * RS;                           // [2][BQ][RS]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * RS);         // [2][BQ]
  float* Dl = Ls + 2 * BQ;                                         // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // batch*head fastest: the key tiles with the most q tiles first
  const int bb = bh / H, hh = bh % H;
  const int k0 = blockIdx.y * BK;
  const __nv_bfloat16* qp = q + bb * qs.b + hh * qs.h;
  const __nv_bfloat16* dop = dout + bb * dos.b + hh * dos.h;
  const float* lse_bh = lse + (long long)bh * SQ;
  const float* delta_bh = delta + (long long)bh * SQ;

  // Q, dO, lse and delta of the q tile starting at row q0 into buffer b
  auto load_q_tile = [&](int b, int q0) {
    tc::load_tile_async<D, TC_THREADS>(Qs + b * BQ * RS, qp, qs.s, q0, SQ);
    tc::load_tile_async<D, TC_THREADS>(dOs + b * BQ * RS, dop, dos.s, q0, SQ);
    const int r = tid & (BQ - 1);  // threads 0..63 load lse, 64..127 delta
    const bool ok = q0 + r < SQ;
    if (tid < BQ)
      tc::cp_async4(Ls + b * BQ + r, ok ? lse_bh + q0 + r : lse_bh, ok);
    else
      tc::cp_async4(Dl + b * BQ + r, ok ? delta_bh + q0 + r : delta_bh, ok);
  };

  // causal: q rows before this tile's first key see none of its keys
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = (SQ + BQ - 1) / BQ;
  tc::load_tile_async<D, TC_THREADS>(Ks, k + bb * ks.b + hh * ks.h, ks.s, k0, SK);
  tc::load_tile_async<D, TC_THREADS>(Vs, v + bb * vs.b + hh * vs.h, vs.s, k0, SK);
  if (qt0 < nq) load_q_tile(0, qt0 * BQ);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[KV_IN_REGS ? KD : 1][4], vf[KV_IN_REGS ? KD : 1][4];
  if constexpr (KV_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      tc::ldmatrix_x4(kf[kd], tc::a16x16<RS>(Ks, warp * 16, kd * 16, lane));
      tc::ldmatrix_x4(vf[kd], tc::a16x16<RS>(Vs, warp * 16, kd * 16, lane));
    }
  }

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < nq) load_q_tile(buf ^ 1, (qt + 1) * BQ);  // in flight during this tile
    tc::cp_async_commit();
    const __nv_bfloat16* Qb = Qs + buf * BQ * RS;
    const __nv_bfloat16* dOb = dOs + buf * BQ * RS;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Dl + buf * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 64 q rows a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      if constexpr (KV_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ka[e] = kf[kd][e], va[e] = vf[kd][e];
      } else {
        tc::ldmatrix_x4(ka, tc::a16x16<RS>(Ks, warp * 16, kd * 16, lane));
        tc::ldmatrix_x4(va, tc::a16x16<RS>(Vs, warp * 16, kd * 16, lane));
      }
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, tc::b_rows<RS>(Qb, nb2 * 16, kd * 16, lane));
        tc::mma_bf16(s[2 * nb2], ka, b[0], b[1]);
        tc::mma_bf16(s[2 * nb2 + 1], ka, b[2], b[3]);
        tc::ldmatrix_x4(b, tc::b_rows<RS>(dOb, nb2 * 16, kd * 16, lane));
        tc::mma_bf16(dp[2 * nb2], va, b[0], b[1]);
        tc::mma_bf16(dp[2 * nb2 + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T on the fragments: [nb][e] is key k0 + 16 warp + g +
    // 8 (e / 2), q row q0 + 8 nb + 2 t + e % 2
    const int q0 = qt * BQ;
    const bool edge = (causal && qt == qt0) || q0 + BQ > SQ;
    uint32_t pf[4][4], dsf[4][4];  // A fragments of 4 k-steps of 16 q rows
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int qc = nb * 8 + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(Lb + qc);
      const float2 delta2 = *reinterpret_cast<const float2*>(Db + qc);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_e = (e & 1) ? lse2.y : lse2.x;
        const float delta_e = (e & 1) ? delta2.y : delta2.x;
        bool keep = true;
        if (edge) {
          const int key = k0 + warp * 16 + g + (e >> 1) * 8, row = q0 + qc + (e & 1);
          keep = row < SQ && key < SK && (!causal || key <= row);
        }
        p[e] = keep ? expf(__fmul_rn(s[nb][e], scale) - lse_e) : 0.f;
        ds[e] = p[e] * (dp[nb][e] - delta_e) * scale;
      }
      pf[nb >> 1][(nb & 1) * 2] = tc::pack_bf16(p[0], p[1]);
      pf[nb >> 1][(nb & 1) * 2 + 1] = tc::pack_bf16(p[2], p[3]);
      dsf[nb >> 1][(nb & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
      dsf[nb >> 1][(nb & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
    }

    // dV += round(P)^T.dO and dK += dS^T.Q, B by transposed ldmatrix
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, tc::b_trans<RS>(dOb, kc * 16, nd2 * 16, lane));
        tc::mma_bf16(dv_acc[2 * nd2], pf[kc], b[0], b[1]);
        tc::mma_bf16(dv_acc[2 * nd2 + 1], pf[kc], b[2], b[3]);
        tc::ldmatrix_x4_trans(b, tc::b_trans<RS>(Qb, kc * 16, nd2 * 16, lane));
        tc::mma_bf16(dk_acc[2 * nd2], dsf[kc], b[0], b[1]);
        tc::mma_bf16(dk_acc[2 * nd2 + 1], dsf[kc], b[2], b[3]);
      }
    }
    tc::cp_async_wait<0>();  // tile qt+1 has landed
    __syncthreads();         // and every warp is done with buffer qt
  }

  // staged in this warp's own K and V rows (only this warp reads them),
  // then 16-byte stores of the keys below SK
  tc::stage_rows<D>(Ks, warp * 16, dk_acc, 1.f, 1.f, lane);
  tc::stage_rows<D>(Vs, warp * 16, dv_acc, 1.f, 1.f, lane);
  __syncwarp();
  const int krow = k0 + warp * 16;
  tc::store_rows<D>(dk + bb * dks.b + hh * dks.h, dks.s, Ks, warp * 16, krow, SK, lane);
  tc::store_rows<D>(dv + bb * dvs.b + hh * dvs.h, dvs.s, Vs, warp * 16, krow, SK, lane);
}

// --------------------------------------------- bf16 tensor-core dQ route
template <int D>
constexpr size_t dq_tc_smem_bytes() {  // Q, dO, (K, V) x 2 padded bf16 tiles
  return (size_t)(2 * BQ + 4 * BK) * (D + tc::PAD) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int SQ, int SK, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dqs, float scale, int causal) {
  static_assert(BQ == 64 && BK == 64, "4 warps x 16 q rows, 8 n-blocks of keys");
  constexpr int RS = D + tc::PAD, KD = D / 16, ND = D / 8;
  constexpr bool QDO_IN_REGS = D <= 64;  // at 128 the fragments would spill
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RS]
  __nv_bfloat16* dOs = Qs + BQ * RS;                               // [BQ][RS]
  __nv_bfloat16* Ks = dOs + BQ * RS;                               // [2][BK][RS]
  __nv_bfloat16* Vs = Ks + 2 * BK * RS;                            // [2][BK][RS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // batch*head fastest: the q tiles with the most k tiles first
  const int bb = bh / H, hh = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int wr = warp * 16;  // the warp's first row in the tile
  const __nv_bfloat16* kp = k + bb * ks.b + hh * ks.h;
  const __nv_bfloat16* vp = v + bb * vs.b + hh * vs.h;

  // causal: keys past this tile's last row are masked for every row in it
  const int k_end = causal ? min(SK, q0 + BQ) : SK;
  const int nk = (k_end + BK - 1) / BK;

  tc::load_tile_async<D, TC_THREADS>(Qs, q + bb * qs.b + hh * qs.h, qs.s, q0, SQ);
  tc::load_tile_async<D, TC_THREADS>(dOs, dout + bb * dos.b + hh * dos.h, dos.s, q0, SQ);
  tc::load_tile_async<D, TC_THREADS>(Ks, kp, ks.s, 0, SK);
  tc::load_tile_async<D, TC_THREADS>(Vs, vp, vs.s, 0, SK);
  tc::cp_async_commit();

  // lse and delta of the lane's rows g and g + 8 (0 past SQ)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + 8 * i;
    row_lse[i] = row < SQ ? lse[(long long)bh * SQ + row] : 0.f;
    row_delta[i] = row < SQ ? delta[(long long)bh * SQ + row] : 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[QDO_IN_REGS ? KD : 1][4], dof[QDO_IN_REGS ? KD : 1][4];
  if constexpr (QDO_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      tc::ldmatrix_x4(qf[kd], tc::a16x16<RS>(Qs, wr, kd * 16, lane));
      tc::ldmatrix_x4(dof[kd], tc::a16x16<RS>(dOs, wr, kd * 16, lane));
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // tile kt+1 in flight while tile kt is computed
      tc::load_tile_async<D, TC_THREADS>(Ks + (buf ^ 1) * BK * RS, kp, ks.s, (kt + 1) * BK, SK);
      tc::load_tile_async<D, TC_THREADS>(Vs + (buf ^ 1) * BK * RS, vp, vs.s, (kt + 1) * BK, SK);
    }
    tc::cp_async_commit();
    const __nv_bfloat16* Kb = Ks + buf * BK * RS;
    const __nv_bfloat16* Vb = Vs + buf * BK * RS;

    // S = Q.K^T and dP = dO.V^T: 16 q rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], da[4];
      if constexpr (QDO_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kd][e], da[e] = dof[kd][e];
      } else {
        tc::ldmatrix_x4(qa, tc::a16x16<RS>(Qs, wr, kd * 16, lane));
        tc::ldmatrix_x4(da, tc::a16x16<RS>(dOs, wr, kd * 16, lane));
      }
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, tc::b_rows<RS>(Kb, nb2 * 16, kd * 16, lane));
        tc::mma_bf16(s[2 * nb2], qa, b[0], b[1]);
        tc::mma_bf16(s[2 * nb2 + 1], qa, b[2], b[3]);
        tc::ldmatrix_x4(b, tc::b_rows<RS>(Vb, nb2 * 16, kd * 16, lane));
        tc::mma_bf16(dp[2 * nb2], da, b[0], b[1]);
        tc::mma_bf16(dp[2 * nb2 + 1], da, b[2], b[3]);
      }
    }

    // P and dS on the fragments: [nb][e] is q row q0 + wr + g + 8 (e / 2),
    // key k0 + 8 nb + 2 t + e % 2
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > SK;
    uint32_t dsf[4][4];  // dS rounded to bf16: A fragments of 4 k-steps of 16 keys
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        bool keep = true;
        if (edge) {
          const int col = k0 + nb * 8 + 2 * t + (e & 1), row = q0 + wr + g + 8 * i;
          keep = row < SQ && col < SK && (!causal || col <= row);
        }
        const float p = keep ? expf(__fmul_rn(s[nb][e], scale) - row_lse[i]) : 0.f;
        ds[e] = p * (dp[nb][e] - row_delta[i]) * scale;
      }
      dsf[nb >> 1][(nb & 1) * 2] = tc::pack_bf16(ds[0], ds[1]);
      dsf[nb >> 1][(nb & 1) * 2 + 1] = tc::pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS.K, B from K by transposed ldmatrix
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, tc::b_trans<RS>(Kb, kc * 16, nd2 * 16, lane));
        tc::mma_bf16(acc[2 * nd2], dsf[kc], b[0], b[1]);
        tc::mma_bf16(acc[2 * nd2 + 1], dsf[kc], b[2], b[3]);
      }
    }
    tc::cp_async_wait<0>();  // tile kt+1 has landed
    __syncthreads();         // and every warp is done with buffer kt
  }

  // staged in this warp's own Q rows (only this warp reads them), then
  // 16-byte stores of the rows below SQ
  tc::stage_rows<D>(Qs, wr, acc, 1.f, 1.f, lane);
  __syncwarp();
  tc::store_rows<D>(dq + bb * dqs.b + hh * dqs.h, dqs.s, Qs, wr, q0 + wr, SQ, lane);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int H,
                      int SQ, int SK, Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SQ + BQ - 1) / BQ, B * H);
  flash_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), H, SQ, SK, qs, ks, vs, dos, dqs, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, int B, int H,
                         int SQ, int SK, Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dqs, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (SQ + BQ - 1) / BQ);
  using bf = __nv_bfloat16;
  flash_dq_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), H, SQ, SK, qs, ks, vs,
      dos, dqs, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B,
                       int H, int SQ, int SK, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SK + BK - 1) / BK, B * H);
  flash_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), H, SQ, SK, qs, ks, vs, dos, dks, dvs,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, int B,
                          int H, int SQ, int SK, Strides qs, Strides ks, Strides vs,
                          Strides dos, Strides dks, Strides dvs, float scale, int causal,
                          cudaStream_t stream) {
  const size_t smem = dkv_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (SK + BK - 1) / BK);
  using bf = __nv_bfloat16;
  flash_dkv_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), H,
      SQ, SK, qs, ks, vs, dos, dks, dvs, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar kernels), 1 = bfloat16 (the tensor-core
// kernels, which want 16-byte aligned rows: base pointers on 16 bytes,
// strides in multiples of 8 elements; the Python wrapper checks). Strides are in
// elements, for the (batch, head, seq) dims of each tensor viewed as
// (b, h, s, d) with the last dim contiguous. lse and delta are contiguous
// (b, h, sq) float32.
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
    return (int)launch_dq<64>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs, dos, dqs,
                              scale, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch_dq<128>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs, dos, dqs,
                               scale, causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch_dq_tc<64>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs, dos, dqs,
                                 scale, causal, st);
  if (dtype == 1 && D == 128)
    return (int)launch_dq_tc<128>(q, k, v, dout, l, dl, dq, B, H, SQ, SK, qs, ks, vs, dos,
                                  dqs, scale, causal, st);
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
    return (int)launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks, vs, dos,
                               dks, dvs, scale, causal, st);
  if (dtype == 0 && D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks, vs, dos,
                                dks, dvs, scale, causal, st);
  if (dtype == 1 && D == 64)
    return (int)launch_dkv_tc<64>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks, vs, dos,
                                  dks, dvs, scale, causal, st);
  if (dtype == 1 && D == 128)
    return (int)launch_dkv_tc<128>(q, k, v, dout, l, dl, dk, dv, B, H, SQ, SK, qs, ks, vs,
                                   dos, dks, dvs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
