// Fused flat scan + per-tile top-r select.
//
// Replaces the Pallas kernel radad_tpu/ops/topk.py::flat_topk
// (_topk_tile_kernel), reached through FlatIndex(use_pallas=True)
// (radad_tpu/index/flat.py:1216-1224). For query b and database row n:
//   score = q.x                 (IP, COSINE on normalized rows)
//   score = 2 q.x - |x|^2       (L2; the caller adds back -|q|^2)
// with q and x rounded to bf16 (round to nearest even) when ROUND is set
// (the JAX package's fast_scan) and f32 sums; |x|^2 in f32 from the stored
// row. Rows n >= n_valid and rows whose id equals the query's excluded id
// score -inf. Each tile of kTileN rows then gives up its r best: r rounds of
// max, the LOWEST column at the max (the JAX tie rule), mask it; a round
// whose max is -inf gives (-inf, -1). Output [B, tiles, r] values and
// global rows; the caller merges the B x tiles*r candidates.
//
// Bound on the H100: the scan reads the database once. At the serving shape
// (25,600 x 5,376 f32 rows, B = 64) that is 550 MB, 0.164 ms at the H100
// SXM's 3.35 TB/s; its 17.6 GFLOP are 0.018 ms at the 989 TFLOP/s of dense
// bf16 (data sheet, 700 W). So the least time is the bytes. This first
// kernel does the products on the f32 FMA units (67 TFLOP/s, 0.26 ms), so
// at B = 64 it is bound by operations; tensor cores (mma/wgmma on the bf16
// operands) come in a later PR.
//
// Design: a block of 256 threads owns kTileN = 128 rows and up to kQB = 64
// queries (grid: row tiles x query blocks). D streams in chunks of kDC = 32
// columns through shared memory: each thread prefetches its part of the next
// chunk into registers (16-byte loads, 8 threads per 128-byte row segment)
// while the block computes on the current one, rounds it and stores it. A
// warp owns 8 queries and a lane 4 rows (lane + 32 j), an 8 x 4 register
// tile: per 4 columns, 4 x-row reads and 8 broadcast q reads feed 128 FMAs.
// Rows are padded to kDC + 4 floats so those 16-byte reads hit distinct
// banks. The loader also sums |x|^2 of its rows in f32. The ragged edges
// (rows past N, columns past D, queries past B) are masked in the kernel:
// nothing is padded or copied in device memory (the JAX wrapper pads the
// database to a multiple of chunk_d). The score tile [64, 128] then
// overwrites the staging buffers, and one warp per query runs the r rounds
// over its 128 scores with warp shuffles, as extract_candidates.cu does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;         // rows per block
constexpr int kQB = 64;             // queries per block
constexpr int kDC = 32;             // columns per chunk
constexpr int kDS = kDC + 4;        // padded stride of a staged row
constexpr int kQPW = kQB / kWarps;  // queries per warp (8)
constexpr int kXG = kTileN * kDC / 4 / kThreads;  // x float4 groups per thread (4)
constexpr int kQG = kQB * kDC / 4 / kThreads;     // q float4 groups per thread (2)

struct Stage {
  float xs[kTileN][kDS];
  float qs[kQB][kDS];
};
union Smem {
  Stage stage;
  float scores[kQB][kTileN];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

template <bool ROUND>
__device__ __forceinline__ float rnd(float v) {
  return ROUND ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool ROUND>
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(rnd<ROUND>(v.x), rnd<ROUND>(v.y), rnd<ROUND>(v.z), rnd<ROUND>(v.w));
}

template <typename XT, bool ROUND, bool L2>
__global__ void __launch_bounds__(kThreads)
flat_topk_kernel(const float* __restrict__ q, const XT* __restrict__ x,
                 const int32_t* __restrict__ ids, const int32_t* __restrict__ excl,
                 float* __restrict__ out_vals, int32_t* __restrict__ out_idx, int b_total,
                 int n_rows, int n_valid, int d, int r, int tiles) {
  __shared__ Smem sm;
  __shared__ float xsq_s[kTileN];
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int64_t row0 = static_cast<int64_t>(tile) * kTileN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col4 = (tid % 8) * 4;  // this thread's 4 columns within a chunk
  const bool warp_busy = q0 + warp * kQPW < b_total;

  float4 xr[kXG], qr[kQG];
  float xsq[kXG];
#pragma unroll
  for (int m = 0; m < kXG; ++m) xsq[m] = 0.f;
  auto fetch = [&](int d0) {
    const bool col_ok = d0 + col4 < d;  // d % 4 == 0: a group is all in or out
#pragma unroll
    for (int m = 0; m < kXG; ++m) {
      const int64_t row = row0 + tid / 8 + 32 * m;
      xr[m] = (col_ok && row < n_rows) ? load4(x + row * d + d0 + col4)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int m = 0; m < kQG; ++m) {
      const int64_t qb = q0 + tid / 8 + 32 * m;
      qr[m] = (col_ok && qb < b_total) ? load4(q + qb * d + d0 + col4)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[kQPW][4];
#pragma unroll
  for (int i = 0; i < kQPW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int d0 = 0; d0 < d; d0 += kDC) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int m = 0; m < kXG; ++m) {
      const float4 v = xr[m];
      if (L2) xsq[m] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      store4<ROUND>(&sm.stage.xs[tid / 8 + 32 * m][col4], v);
    }
#pragma unroll
    for (int m = 0; m < kQG; ++m) store4<ROUND>(&sm.stage.qs[tid / 8 + 32 * m][col4], qr[m]);
    __syncthreads();
    if (d0 + kDC < d) fetch(d0 + kDC);  // in flight during the products
    if (warp_busy) {
#pragma unroll
      for (int dd = 0; dd < kDC; dd += 4) {
        float4 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = *reinterpret_cast<const float4*>(&sm.stage.xs[lane + 32 * j][dd]);
#pragma unroll
        for (int i = 0; i < kQPW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(&sm.stage.qs[warp * kQPW + i][dd]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(qv.x, xv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);
          }
        }
      }
    }
  }

  if (L2) {
    // the 8 lanes that loaded a row's column groups sum its |x|^2
#pragma unroll
    for (int m = 0; m < kXG; ++m) {
      float v = xsq[m];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (tid % 8 == 0) xsq_s[tid / 8 + 32 * m] = v;
    }
  }
  __syncthreads();  // xsq_s written; every warp is done with the staging buffers

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    const int64_t row = row0 + c;
    const bool row_ok = row < n_valid;
    const int32_t row_id = (ids != nullptr && row < n_rows) ? ids[row] : 0;
#pragma unroll
    for (int i = 0; i < kQPW; ++i) {
      const int qb = q0 + warp * kQPW + i;
      float s = -INFINITY;
      if (row_ok && qb < b_total && !(ids != nullptr && row_id == excl[qb]))
        s = L2 ? 2.f * acc[i][j] - xsq_s[c] : acc[i][j];
      sm.scores[warp * kQPW + i][c] = s;
    }
  }
  __syncthreads();

  for (int ql = warp; ql < kQB; ql += kWarps) {
    const int qb = q0 + ql;
    if (qb >= b_total) break;  // uniform across the warp
    const float4 v4 = *reinterpret_cast<const float4*>(&sm.scores[ql][4 * lane]);
    float v0 = v4.x, v1 = v4.y, v2 = v4.z, v3 = v4.w;
    const int64_t out_base = (static_cast<int64_t>(qb) * tiles + tile) * r;
    for (int j = 0; j < r; ++j) {
      const float best = warp_max(fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)));
      int mine = kTileN;
      if (v3 >= best) mine = 4 * lane + 3;
      if (v2 >= best) mine = 4 * lane + 2;
      if (v1 >= best) mine = 4 * lane + 1;
      if (v0 >= best) mine = 4 * lane;
      const int bidx = warp_min(mine);
      if ((bidx >> 2) == lane) {
        switch (bidx & 3) {
          case 0: v0 = -INFINITY; break;
          case 1: v1 = -INFINITY; break;
          case 2: v2 = -INFINITY; break;
          default: v3 = -INFINITY; break;
        }
      }
      if (lane == 0) {
        out_vals[out_base + j] = best;
        out_idx[out_base + j] = isfinite(best) ? static_cast<int32_t>(row0 + bidx) : -1;
      }
    }
  }
}

template <typename XT, bool ROUND>
int launch(const float* q, const void* x, const int32_t* ids, const int32_t* excl,
           float* vals, int32_t* idx, int b, int n, int n_valid, int d, int r, bool l2,
           cudaStream_t stream) {
  const int tiles = (n + kTileN - 1) / kTileN;
  const dim3 grid(tiles, (b + kQB - 1) / kQB);
  const XT* xt = static_cast<const XT*>(x);
  if (l2)
    flat_topk_kernel<XT, ROUND, true><<<grid, kThreads, 0, stream>>>(
        q, xt, ids, excl, vals, idx, b, n, n_valid, d, r, tiles);
  else
    flat_topk_kernel<XT, ROUND, false><<<grid, kThreads, 0, stream>>>(
        q, xt, ids, excl, vals, idx, b, n, n_valid, d, r, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, D] f32, x [N, D] f32 (x_kind 0) or bf16 (x_kind 1), D % 4 == 0,
// 16-byte aligned; ids [N] and excl [B] int32, or both null (no exclusion);
// 1 <= r <= 128. Writes vals [B, tiles, r] f32 and idx [B, tiles, r] int32,
// tiles = ceil(N / 128). round: bf16 operands; l2: 2 q.x - |x|^2 (else q.x).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int radad_flat_topk(const float* q, const void* x, const int32_t* ids,
                               const int32_t* excl, float* vals, int32_t* idx, int b,
                               int n, int n_valid, int d, int r, int x_kind, int round,
                               int l2, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (r < 1 || r > kTileN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    return round ? launch<float, true>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s)
                 : launch<float, false>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s);
  return round ? launch<__nv_bfloat16, true>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s)
               : launch<__nv_bfloat16, false>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s);
}
