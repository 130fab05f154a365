// Fused int8 dequantize + decode attention for Hopper (sm_90a), hand-written
// CUDA C++: a split-K (flash-decoding) kernel that reads the paged KV cache
// through its page table.
//
// Replaces the Pallas TPU kernel flexflow_tpu/kernels/dequant_attention.py
// `dequant_decode_attention` -> `_kernel`: for each slot and head, the int8
// K/V context is widened to f32 and multiplied by its per-(position, head)
// scale in registers, query row i's scores are masked to `col <= pos + i`,
// a stable softmax runs over them in f32, and P times the widened V over
// the sum of P gives the output in the query's dtype. The TPU kernel takes
// the context gathered into one contiguous copy per slot, because its grid
// runs in order and VMEM holds the whole context; here the kernel reads the
// pools as the cache holds them, so nothing is gathered first.
//
// What bounds it on an H100: reading, once, the int8 keys and values (and
// their f32 scales) of positions 0..pos + S - 1 of each slot, and the page
// ids that address them. The arithmetic is ~4 flops a byte, far below the
// card's ~20 f32 flops a byte, so the bound is the 3.35 TB/s of device
// memory and everything here is f32 on the CUDA cores. At the serving
// shape that is ~9 MB, ~3 us: the launch is short, so the design cuts the
// chain of dependent memory round trips a block waits on.
//
// Design:
// - Paged input. Key j of slot b lives in page pt[b, j / page] at offset
//   j % page of the pools [pages, page, H, D] (int8) and [pages, page, H]
//   (f32 scales): the address the gather `pool[pt]` reads. The page size
//   is a parameter; the gathered call is the paged one with page = L.
// - Split-K. The grid is (slot x head, key chunk); a chunk is CHUNK = NW
//   x TILE keys, a 32-key tile for each warp of the block. A chunk that
//   starts past key pos + S - 1 exits at once, and no page id or key past
//   that is read.
// - Each warp runs its tile alone. It copies the tile's K/V rows and
//   scales into its own shared-memory buffer with cp.async, 16 bytes a
//   copy, neighbouring lanes on neighbouring bytes of a row, so every
//   tile of the chunk is in flight at once (deeper chunks, a warp
//   double-buffering two tiles, were no faster). A lane scores one key
//   against every query row; the warp takes the tile's max m, sum l and
//   f32 partial O for each row (a lane owns D / 32 output columns); P
//   reaches the PV product through the warp's shared memory, four keys a
//   broadcast read. int8 values are widened exactly by a byte permute and
//   an add, not by the quarter-rate int-to-float unit. No block-wide
//   barrier runs between the loads and the end of the tile.
// - Merges. The warps' (m, l, O) are merged through shared memory; a chunk
//   that holds all of its (slot, head)'s keys writes the output. Otherwise
//   each chunk writes (m, l, O) to a workspace, fences, and takes a ticket
//   from its (slot, head)'s counter; the block that takes the last ticket
//   merges every chunk's partial (one pass, the loads independent of the
//   running max), writes the output and sets the counter back to 0 for the
//   next launch. The workspace and the counters are the caller's.
// Shared memory is a fixed few tens of KB: it does not grow with the
// context.
//
// C interface (ctypes): ff_paged_dequant_decode returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int NW = 4;  // warps a block
constexpr int NT = 32 * NW;
constexpr int TILE = 32;  // keys a warp's tile: one per lane
constexpr int CHUNK = NW * TILE;  // keys a block
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Signed bytes widened exactly to f32 without the quarter-rate I2F: a
// byte offset by 128 becomes the low mantissa byte of 2^23 (one byte
// permute), and subtracting 2^23 + 128 leaves the byte's value.
__device__ __forceinline__ float widen_byte(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}
template <int N>
__device__ __forceinline__ void widen(uint32_t w, float (&f)[N]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int n = 0; n < N; ++n) f[n] = widen_byte(u, 0x7540u + n);
}

// A warp's tile buffer: the int8 K and V rows and their f32 scales. Rows
// are D + 16 bytes: a lane reads its own key's row in 16-byte pieces, and
// the 16-byte shift puts the 8 lanes of a load phase on distinct banks.
template <int D> struct WarpTile {
  static constexpr int ROW = D + 16;
  static constexpr int KV = TILE * ROW;              // bytes of K (or V)
  static constexpr int BUF = 2 * KV + 2 * TILE * 4;  // K, V, K scales, V scales
};

// Shared memory, in bytes (all of it dynamic): every warp's tile buffer,
// then the f32 query rows, each warp's P row of its tile for every query
// row, and the merge flag. The warps' (m, l, O) for the block merge reuse
// the tiles' bytes.
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int S) {
  return (size_t)NW * WarpTile<D>::BUF + 4 * ((size_t)S * (D + CHUNK) + 1);
}
// within the 48 KB a launch may take without opting in to more
static_assert(smem_bytes<128>(MAX_S) <= 48 * 1024, "shared memory fits 48 KB");

// SR: the query rows the registers hold, 1 (one decode token, the main
// path: fewer registers) or MAX_S; S <= SR.
template <typename T, int D, int SR>
__global__ void __launch_bounds__(NT) paged_dequant_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kp, const float* __restrict__ ksc,
    const int8_t* __restrict__ vp, const float* __restrict__ vsc,
    const int* __restrict__ pt, const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int S, int H, int page,
    int pages_per_slot, float scale) {
  using W = WarpTile<D>;
  constexpr int CPT = D / 32;  // output columns a lane owns
  static_assert((SR * D + 2 * MAX_S) * 4 <= W::BUF, "merge fits the tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + NW * W::BUF);  // [S][D]
  int* is_last = reinterpret_cast<int*>(Qs + S * (D + CHUNK));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // chunks run along y: blocks are issued in order of x + y * gridDim.x,
  // so the late chunks, which short contexts leave idle, come last
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int ci = blockIdx.y, nchunks = gridDim.y;
  const int p0 = pos[b];
  // keys past pos + S - 1 are masked for every query row: never read them
  const int n_keys = min(pages_per_slot * page, p0 + S);
  const int n_active = (n_keys + CHUNK - 1) / CHUNK;
  if (ci >= n_active) return;
  const int j0 = ci * CHUNK + warp * TILE;  // this warp's first key
  const int j_end = min((ci + 1) * CHUNK, n_keys);
  const bool has_tile = j0 < j_end;         // warp-uniform
  const int* ptb = pt + (long long)b * pages_per_slot;
  int8_t* kt = reinterpret_cast<int8_t*>(smem + warp * W::BUF);
  int8_t* vt = kt + W::KV;
  float* sc = reinterpret_cast<float*>(vt + W::KV);  // [2][TILE]: K's, V's
  float* Pw = Qs + S * D + warp * S * TILE;  // [S][TILE]

  // copy the tile into the warp's buffer; keys at or past j_end are
  // zero-filled without reading
  if (has_tile) {
    constexpr int PIECES = D / 16;
#pragma unroll
    for (int u = lane; u < TILE * PIECES; u += 32) {
      const int kk = u / PIECES, piece = u % PIECES, j = j0 + kk;
      const bool ok = j < j_end;
      long long row = 0;
      if (ok) row = ((long long)ptb[j / page] * page + j % page) * H + h;
      const int dst = kk * W::ROW + piece * 16;
      tc::cp_async16(kt + dst, kp + row * D + piece * 16, ok);
      tc::cp_async16(vt + dst, vp + row * D + piece * 16, ok);
    }
    const int j = j0 + lane;
    const bool ok = j < j_end;
    long long row = 0;
    if (ok) row = ((long long)ptb[j / page] * page + j % page) * H + h;
    tc::cp_async4(sc + lane, ksc + row, ok);
    tc::cp_async4(sc + TILE + lane, vsc + row, ok);
    tc::cp_async_commit();
  }
  // the queries, while the tiles are in flight
  for (int idx = tid; idx < S * D; idx += NT)
    Qs[idx] = to_f32<T>(q[(((long long)b * S + idx / D) * H + h) * D + idx % D]);
  __syncthreads();

  // this warp's (m, l, O) for each query row; a warp without a tile
  // keeps m = -inf, l = 0, O = 0
  float m_w[SR], l_w[SR], o[SR][CPT];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m_w[i] = -INFINITY, l_w[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }
  if (has_tile) {
    tc::cp_async_wait<0>();
    __syncwarp();

    // scores: lane = key, against every query row (q read by broadcast)
    const int j = j0 + lane;
    float acc[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) acc[i] = 0.f;
#pragma unroll
    for (int v = 0; v < D; v += 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kt + lane * W::ROW + v);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kf[4];
        widen(words[u], kf);
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          if (i < S) {
            const float4 qv = *reinterpret_cast<const float4*>(Qs + i * D + v + 4 * u);
            acc[i] = fmaf(qv.x, kf[0], acc[i]);
            acc[i] = fmaf(qv.y, kf[1], acc[i]);
            acc[i] = fmaf(qv.z, kf[2], acc[i]);
            acc[i] = fmaf(qv.w, kf[3], acc[i]);
          }
        }
      }
    }
    // softmax terms per row; P is kept times V's scale, and 0 where
    // masked, in the warp's P rows
    const float ks = sc[lane] * scale, vs = sc[TILE + lane];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      if (i < S) {
        const float sv = (j < j_end && j <= p0 + i) ? acc[i] * ks : -INFINITY;
        m_w[i] = warp_max(sv);
        // a row with every key of the tile masked: m = -inf, l = 0, no NaN
        const float p = expf(sv - (m_w[i] == -INFINITY ? 0.f : m_w[i]));
        l_w[i] = warp_sum(p);
        Pw[i * TILE + lane] = sv == -INFINITY ? 0.f : p * vs;
      }
    }
    __syncwarp();
    // PV: lane owns columns lane * CPT..; four keys' p at a time by a
    // broadcast read of the P rows
#pragma unroll 2
    for (int kk = 0; kk < TILE; kk += 4) {
      float vv[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int8_t* vr = vt + (kk + u) * W::ROW + lane * CPT;
        if constexpr (CPT == 2)
          widen(*reinterpret_cast<const uint16_t*>(vr), vv[u]);
        else
          widen(*reinterpret_cast<const uint32_t*>(vr), vv[u]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        if (i < S) {
          const float4 p4 = *reinterpret_cast<const float4*>(Pw + i * TILE + kk);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            o[i][c] = fmaf(p4.x, vv[0][c], o[i][c]);
            o[i][c] = fmaf(p4.y, vv[1][c], o[i][c]);
            o[i][c] = fmaf(p4.z, vv[2][c], o[i][c]);
            o[i][c] = fmaf(p4.w, vv[3][c], o[i][c]);
          }
        }
      }
    }
  }

  // merge the warps' (m, l, O) through the tiles' bytes
  __syncthreads();
  float* Om = reinterpret_cast<float*>(smem);  // [NW][S][D]
  float* Mm = Om + NW * S * D;                 // [NW][S]
  float* Lm = Mm + NW * S;                     // [NW][S]
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    if (i < S) {
      if (lane == 0) Mm[warp * S + i] = m_w[i], Lm[warp * S + i] = l_w[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) Om[(warp * S + i) * D + lane * CPT + c] = o[i][c];
    }
  }
  __syncthreads();
  const long long base = (long long)bh * nchunks;  // this (slot, head)'s chunk 0
  float* ws_o = ws;                                           // [BH][nchunks][S][D]
  float* ws_m = ws + (long long)gridDim.x * nchunks * S * D;  // [BH][nchunks][S]
  float* ws_l = ws_m + (long long)gridDim.x * nchunks * S;
  for (int idx = tid; idx < S * D; idx += NT) {
    const int i = idx / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mm[w * S + i]);
    const float mu = M == -INFINITY ? 0.f : M;
    float Ls = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(Mm[w * S + i] - mu);
      Ls = fmaf(Lm[w * S + i], e, Ls);
      acc = fmaf(Om[w * S * D + idx], e, acc);
    }
    if (n_active == 1) {
      out[(((long long)b * S + i) * H + h) * D + idx % D] = from_f32<T>(acc / Ls);
    } else {
      ws_o[(base + ci) * S * D + idx] = acc;
      if (idx % D == 0) ws_m[(base + ci) * S + i] = M, ws_l[(base + ci) * S + i] = Ls;
    }
  }
  if (n_active == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *is_last = atomicAdd(tickets + bh, 1) == n_active - 1;
    if (*is_last) tickets[bh] = 0;
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();

  // the last chunk of this (slot, head) merges every chunk's partial, in
  // one pass with a running max
  for (int idx = tid; idx < S * D; idx += NT) {
    const int i = idx / D;
    float M = -INFINITY, Ls = 0.f, acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < n_active; ++k) {
      const float mk = __ldcg(ws_m + (base + k) * S + i);
      const float lk = __ldcg(ws_l + (base + k) * S + i);
      const float ok = __ldcg(ws_o + (base + k) * S * D + idx);
      const float m_new = fmaxf(M, mk);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float a = expf(M - mu), e = expf(mk - mu);
      Ls = Ls * a + lk * e;
      acc = acc * a + ok * e;
      M = m_new;
    }
    out[(((long long)b * S + i) * H + h) * D + idx % D] = from_f32<T>(acc / Ls);
  }
}

template <typename T, int D, int SR>
cudaError_t launch(const void* q, const void* kp, const void* ks, const void* vp,
                   const void* vs, const void* pt, const void* pos, void* out, void* ws,
                   void* tickets, int B, int S, int H, int page, int pages_per_slot,
                   float scale, cudaStream_t stream) {
  const int nchunks = (pages_per_slot * page + CHUNK - 1) / CHUNK;
  const dim3 grid(B * H, nchunks);
  paged_dequant_decode_kernel<T, D, SR><<<grid, NT, smem_bytes<D>(S), stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs),
      static_cast<const int*>(pt), static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), S, H, page, pages_per_slot,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q and out). q/out (B, S, H, D);
// kp/vp (pages, page, H, D) int8, 16-byte aligned; ks/vs (pages, page, H)
// float32; pt (B, pages_per_slot) int32 page ids; pos (B,) int32; all
// contiguous. ws holds B * H * ceil(pages_per_slot * page / chunk) * S *
// (D + 2) floats; tickets B * H ints, 0 before the launch and after it.
// chunk must be the kernel's CHUNK (the caller sizes ws by it); at most
// 65535 chunks.
extern "C" int ff_paged_dequant_decode(const void* q, const void* kp, const void* ks,
                                       const void* vp, const void* vs, const void* pt,
                                       const void* pos, void* out, void* ws, void* tickets,
                                       int dtype, int B, int S, int H, int D, int page,
                                       int pages_per_slot, int chunk, float scale,
                                       void* stream) {
  if (S < 1 || S > MAX_S || page < 1 || pages_per_slot < 1 || chunk != CHUNK ||
      (pages_per_slot * (long long)page + CHUNK - 1) / CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FF_LAUNCH(T, D, SR)                                                       \
  launch<T, D, SR>(q, kp, ks, vp, vs, pt, pos, out, ws, tickets, B, S, H, page, \
                   pages_per_slot, scale, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    err = S == 1 ? FF_LAUNCH(float, 64, 1) : FF_LAUNCH(float, 64, MAX_S);
  else if (dtype == 0 && D == 128)
    err = S == 1 ? FF_LAUNCH(float, 128, 1) : FF_LAUNCH(float, 128, MAX_S);
  else if (dtype == 1 && D == 64)
    err = S == 1 ? FF_LAUNCH(__nv_bfloat16, 64, 1) : FF_LAUNCH(__nv_bfloat16, 64, MAX_S);
  else if (dtype == 1 && D == 128)
    err = S == 1 ? FF_LAUNCH(__nv_bfloat16, 128, 1) : FF_LAUNCH(__nv_bfloat16, 128, MAX_S);
#undef FF_LAUNCH
  return (int)err;
}
