// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/flash_attention.py
// `_fwd` -> `_fwd_kernel`: blocked online-softmax attention, causal or not,
// writing O and the per-row logsumexp. Same contract: f32 running max/sum
// and accumulator, P rounded to V's dtype before the PV product, O in Q's
// dtype, lse = m + log(l) of the scaled scores in f32.
//
// Two routes, chosen by dtype in ff_flash_fwd:
//
// - bfloat16: flash_fwd_tc_kernel, on the tensor cores (FlashAttention-2's
//   structure on mma.sync). What bounds it on an H100: at GPT-2 medium's
//   shape (8 x 16 heads x 1024 x 64, causal) 17.2 GFLOP (17 us at 989
//   TFLOP/s) against ~68 MB (20 us at 3.35 TB/s), so both the tensor cores
//   and the memory have to be kept busy. One block of 4 warps per (q tile,
//   batch*head); a warp owns two 16-row m-tiles at head_dim 64 (a 128-row
//   q tile), so each K or V fragment it reads feeds twice the products,
//   and one at 128 (64 rows), where registers run out. Causal launches the
//   tiles with the most k tiles first. Q, K and V sit in shared memory as
//   bf16 tiles with padded rows (tc_bf16.cuh), K and V double-buffered:
//   cp.async brings tile j+1 while tile j is in the tensor cores. The
//   warp's Q rows go into A fragments once. S = Q.K^T and O += P.V are
//   mma.sync m16n8k16 (B from ldmatrix, transposed for V); the online
//   softmax runs on the accumulator fragments in the scalar kernel's order
//   (s * scale, the mask, the running max with its -inf guard, then exp,
//   here the MUFU's __expf: P is rounded to bf16 anyway). A thread holds 2
//   rows of an m-tile, whose max and sum are two quad shuffles, and P is
//   rounded to bf16 and packed straight into A fragments, never through
//   shared memory. Only k tiles that cross the diagonal or SK are masked.
//   O/l is staged through the warp's own Q rows and written with 16-byte
//   stores; or, with out_f32 (the ring's chunks, which it merges in f32
//   and rounds once), written unrounded from the fragments as float32.
//   The output type is the kernel's template parameter, not a second
//   kernel.
// - float32: flash_fwd_kernel, scalar f32 FMAs. Tensor cores give no f32
//   products at the 1e-4 the f32 checks hold the kernel to (TF32 keeps ~3
//   digits). One block of 256 threads per (batch, head, 64-row q tile);
//   tiles in shared memory as f32, each thread owns a 4 x 4 block of the
//   64 x 64 score tile, the row max/sum reduced over a half-warp.
//
// C interface (ctypes): ff_flash_fwd returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads

struct Strides {
  long long b, h, s;  // element strides of the batch, head and sequence dims
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int SQ, int SK,
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
  const float* qp = q + bb * qs.b + hh * qs.h;
  const float* kp = k + bb * ks.b + hh * ks.h;
  const float* vp = v + bb * vs.b + hh * vs.h;
  float* op = o + bb * os.b + hh * os.h;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    Qs[r * QS + c] = qr < SQ ? qp[(long long)qr * qs.s + c] : 0.f;
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
      Ks[r * KS + c] = in ? kp[(long long)kr * ks.s + c] : 0.f;
      Vs[r * D + c] = in ? vp[(long long)kr * vs.s + c] : 0.f;
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
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;  // V's dtype is f32: no rounding
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
        op[(long long)row * os.s + tx + 16 * j] = acc[i][j] / l[i];
      if (tx == 0) lse[(long long)bh * SQ + row] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int SQ, int SK, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((SQ + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, SQ, SK, qs, ks, vs, os,
      scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16 tensor-core route
constexpr int TC_THREADS = 128;  // 4 warps

// 16-row m-tiles a warp owns: 2 at head_dim 64, so each K/V fragment read
// by ldmatrix feeds twice the products; 1 at 128, where registers run out
template <int D>
__host__ __device__ constexpr int tc_m_tiles() {
  return D == 64 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int tc_q_rows() {  // q rows a block owns
  return 4 * 16 * tc_m_tiles<D>();
}
template <int D>
constexpr size_t tc_smem_bytes() {  // Q, K x 2, V x 2 padded bf16 tiles
  return (size_t)(tc_q_rows<D>() + 4 * BK) * (D + tc::PAD) * sizeof(__nv_bfloat16);
}

template <int D, typename OutT>
__global__ void __launch_bounds__(TC_THREADS) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, OutT* __restrict__ o,
    float* __restrict__ lse, int SQ, int SK, int H, Strides qs, Strides ks, Strides vs,
    Strides os, float scale, int causal) {
  static_assert(BK == 64, "8 n-blocks of 8 keys a k tile");
  constexpr int MW = tc_m_tiles<D>(), QR = tc_q_rows<D>();
  constexpr int RS = D + tc::PAD, KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [QR][RS]
  __nv_bfloat16* Ks = Qs + QR * RS;                                // [2][BK][RS]
  __nv_bfloat16* Vs = Ks + 2 * BK * RS;                            // [2][BK][RS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // batch*head fastest: every head's heaviest tile first
  const int bb = bh / H, hh = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * QR;
  const int wr = warp * 16 * MW;  // the warp's first row in the tile
  const __nv_bfloat16* kp = k + bb * ks.b + hh * ks.h;
  const __nv_bfloat16* vp = v + bb * vs.b + hh * vs.h;

  // causal: keys past this tile's last row are masked for every row in it
  const int k_end = causal ? min(SK, q0 + QR) : SK;
  const int nk = (k_end + BK - 1) / BK;

  tc::load_tile_async<D, TC_THREADS, QR>(Qs, q + bb * qs.b + hh * qs.h, qs.s, q0, SQ);
  tc::load_tile_async<D, TC_THREADS>(Ks, kp, ks.s, 0, SK);
  tc::load_tile_async<D, TC_THREADS>(Vs, vp, vs.s, 0, SK);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[MW][KD][4];  // the warp's q rows as A fragments, for every k tile
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      tc::ldmatrix_x4(qf[mi][kd], tc::a16x16<RS>(Qs, wr + mi * 16, kd * 16, lane));

  float acc[MW][ND][4];
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nd][e] = 0.f;
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // tile kt+1 in flight while tile kt is computed
      tc::load_tile_async<D, TC_THREADS>(Ks + (buf ^ 1) * BK * RS, kp, ks.s, (kt + 1) * BK, SK);
      tc::load_tile_async<D, TC_THREADS>(Vs + (buf ^ 1) * BK * RS, vp, vs.s, (kt + 1) * BK, SK);
    }
    tc::cp_async_commit();
    const __nv_bfloat16* Kb = Ks + buf * BK * RS;
    const __nv_bfloat16* Vb = Vs + buf * BK * RS;

    // S = Q.K^T: 16 MW rows x 64 keys a warp, 8 n-blocks of 8 keys; each
    // K fragment feeds the warp's MW m-tiles
    float s[MW][8][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][nb][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, tc::b_rows<RS>(Kb, nb2 * 16, kd * 16, lane));
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          tc::mma_bf16(s[mi][2 * nb2], qf[mi][kd], b[0], b[1]);
          tc::mma_bf16(s[mi][2 * nb2 + 1], qf[mi][kd], b[2], b[3]);
        }
      }
    }

    // online softmax on the fragments: s[mi][nb][e] is row wr + 16 mi + g
    // + 8 (e / 2), key k0 + 8 nb + 2 t + e % 2. Only tiles that reach past
    // the tile's first row (causal) or past SK are masked.
    const int k0 = kt * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > SK;
    uint32_t pf[MW][4][4];  // P rounded to bf16: A fragments of 4 k-steps of 16 keys
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[mi][nb][e], scale);
          if (edge) {
            const int col = k0 + nb * 8 + 2 * t + (e & 1);
            const int row = q0 + wr + mi * 16 + g + (e >> 1) * 8;
            if (col >= SK || (causal && col > row)) x = -INFINITY;
          }
          s[mi][nb][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float m_use[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share rows g, g + 8
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[mi][i], mx[i]);
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = __expf(m[mi][i] - m_use[i]);
        m[mi][i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float p0 = __expf(s[mi][nb][0] - m_use[0]);
        const float p1 = __expf(s[mi][nb][1] - m_use[0]);
        const float p2 = __expf(s[mi][nb][2] - m_use[1]);
        const float p3 = __expf(s[mi][nb][3] - m_use[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[mi][nb >> 1][(nb & 1) * 2] = tc::pack_bf16(p0, p1);
        pf[mi][nb >> 1][(nb & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[mi][i] = l[mi][i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[mi][nd][0] *= alpha[0];
        acc[mi][nd][1] *= alpha[0];
        acc[mi][nd][2] *= alpha[1];
        acc[mi][nd][3] *= alpha[1];
      }
    }

    // O += P.V, B from V by transposed ldmatrix, each fragment feeding the
    // warp's MW m-tiles
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, tc::b_trans<RS>(Vb, kc * 16, nd2 * 16, lane));
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          tc::mma_bf16(acc[mi][2 * nd2], pf[mi][kc], b[0], b[1]);
          tc::mma_bf16(acc[mi][2 * nd2 + 1], pf[mi][kc], b[2], b[3]);
        }
      }
    }
    tc::cp_async_wait<0>();  // tile kt+1 has landed
    __syncthreads();         // and every warp is done with buffer kt
  }

  // O / l: in f32 straight from the fragments; in bf16 staged in this
  // warp's own Q rows (read only by this warp, into qf), then 16-byte
  // stores; lse = m + log(l)
  OutT* op = o + bb * os.b + hh * os.h;
  if constexpr (std::is_same<OutT, float>::value) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
      tc::store_acc_f32<D>(op, os.s, acc[mi], l[mi][0], l[mi][1], q0 + wr + mi * 16, SQ,
                           lane);
  } else {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
      tc::stage_rows<D>(Qs, wr + mi * 16, acc[mi], l[mi][0], l[mi][1], lane);
    __syncwarp();
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
      tc::store_rows<D>(op, os.s, Qs, wr + mi * 16, q0 + wr + mi * 16, SQ, lane);
  }
  if (t == 0) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + wr + mi * 16 + g + 8 * i;
        if (row < SQ) lse[(long long)bh * SQ + row] = m[mi][i] + logf(l[mi][i]);
      }
  }
}

template <int D, typename OutT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int H, int SQ, int SK, Strides qs, Strides ks, Strides vs, Strides os,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (SQ + tc_q_rows<D>() - 1) / tc_q_rows<D>());
  flash_fwd_tc_kernel<D, OutT><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<OutT*>(o), lse, SQ, SK, H, qs, ks, vs,
      os, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar kernel), 1 = bfloat16 (the tensor-core
// kernel, which wants 16-byte aligned rows: base pointers on 16 bytes and
// strides in multiples of 8 elements; the Python wrapper checks). Strides
// are in elements, for the (batch, head, seq) dims of q/k/v/o viewed as
// (b, h, s, d) with the last dim contiguous. lse is a contiguous
// (b, h, sq) float32 array. out_f32 = 1 writes a bf16 route's O in float32
// (the accumulator unrounded: the ring merges its chunks' O so); the f32
// route's O is float32 either way.
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int dtype, int B, int H, int SQ, int SK, int D,
                            long long qsb, long long qsh, long long qss,
                            long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss,
                            long long osb, long long osh, long long oss,
                            float scale, int causal, int out_f32, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = launch_f32<64>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal, st);
  else if (dtype == 0 && D == 128)
    err = launch_f32<128>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal, st);
  else if (dtype == 1 && D == 64 && out_f32)
    err = launch_tc<64, float>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal, st);
  else if (dtype == 1 && D == 128 && out_f32)
    err = launch_tc<128, float>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale, causal,
                                st);
  else if (dtype == 1 && D == 64)
    err = launch_tc<64, __nv_bfloat16>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale,
                                       causal, st);
  else if (dtype == 1 && D == 128)
    err = launch_tc<128, __nv_bfloat16>(q, k, v, o, l, B, H, SQ, SK, qs, ks, vs, os, scale,
                                        causal, st);
  return (int)err;
}
