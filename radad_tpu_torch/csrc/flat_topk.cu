// Fused flat scan + per-tile top-r select.
//
// Replaces the Pallas kernel radad_tpu/ops/topk.py::flat_topk
// (_topk_tile_kernel), reached through FlatIndex(use_pallas=True)
// (radad_tpu/index/flat.py:1216-1224). For query b and database row n:
//   score = q.x                 (IP, COSINE on normalized rows)
//   score = 2 q.x - |x|^2       (L2; the caller adds back -|q|^2)
// with q and x rounded to bf16 (round to nearest even) when `round` is set
// (the JAX package's fast_scan), products exact and f32 sums; |x|^2 in f32
// from the stored row. Rows n >= n_valid and rows whose id equals the
// query's excluded id score -inf. Each tile of kTileN rows then gives up its
// r best: r rounds of max, the LOWEST column at the max (the JAX tie rule),
// mask it; a round whose max is -inf gives (-inf, -1). Output [B, tiles, r]
// values and global rows; the caller merges the B x tiles*r candidates.
//
// Bound on the H100: the scan reads the database once. At the serving shape
// (25,600 x 5,376 f32 rows, B = 64) that is 550 MB, 0.164 ms at the H100
// SXM's 3.35 TB/s; its 17.6 GFLOP are 0.018 ms at the 989 TFLOP/s of dense
// bf16 (data sheet, 700 W). So the least time is the bytes, at every B.
//
// The bf16 body (flat_topk_kernel, round = 1), designed for that bound:
// - Tensor cores: mma.sync m16n8k16 bf16 -> f32. Database rows sit on the M
//   side (each of the 8 warps owns 16 rows of the 128-row tile), queries on
//   the N side (one n8 fragment per 8 queries, so B = 1..8 costs one
//   fragment), K along D. Every row is converted and read by one warp only.
//   Each k16 product is issued with a zero accumulator and its 16-product
//   block sum added to the running f32 sum with an ordinary (RN) add, so the
//   tensor core's undocumented accumulation touches 16 exact products at a
//   time (ops/topk_check.py::pair_scores, order "mma", bounds it).
// - Rounding on the way in: the f32 x tile lands in shared memory as it is;
//   the owning warp reads it in the A-fragment pattern (a float2 per
//   register pair), packs it with __floats2bfloat162_rn and sums |x|^2 from
//   the same f32 values (each lane an fmaf chain over its 16 columns of a
//   stage, added to its running sum; then a 2-level shuffle tree over the
//   row's 4 lanes). q is rounded once, by
//   flat_topk_round_q_kernel, into a bf16 scratch whose rows are padded to
//   a whole number of stages; its fragments come from ldmatrix.
// - An asynchronous ring: D streams through kStages stages of kMC columns
//   by cp.async 16-byte copies (8-byte for bf16 rows with D % 8 != 0) with
//   zero-fill for rows past N and columns past D, one __syncthreads a
//   stage. The next stage is in flight while one is consumed: 32 KB of rows
//   a block, 64 KB an SM. What the DRAM wants is long runs of a row: 2
//   stages of 64 columns (256 bytes of an f32 row) beat 4 of 32 and 3 of
//   48 at B = 1, 8 and 64 (experiments/flat_topk_variants.py); 3 stages of
//   64 columns do not fit two blocks on an SM.
// - One wave: __launch_bounds__(256, 2) and ~91 KB of shared memory a
//   block put two blocks on an SM, 264 slots for the 200 tiles of the
//   serving shape, so no tile waits for a second wave.
// - The select stage: the [64, 128] f32 score tile overwrites the ring, and
//   r rounds of warp max / min over each query's 128 scores pick its r
//   best, as extract_candidates.cu does, one warp per query, but each
//   reduction is one redux.sync on order-preserving int keys instead of a
//   5-step shuffle chain.
// The ragged edges (rows past N, columns past D, queries past B) are masked
// in the kernel: nothing is padded or copied in device memory but the
// rounded q.
//
// The f32 body (flat_topk_f32_kernel, round = 0: the JAX kernel's HIGHEST
// precision route) does the products on the f32 FMA units, one FMA chain
// over D per pair: a block of 256 threads owns 128 rows and up to 64
// queries, D streams in chunks of kDC = 32 columns prefetched into
// registers, a warp owns 8 queries and a lane 4 rows (an 8 x 4 register
// tile). It is not on the serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;         // rows per block
constexpr int kQB = 64;             // queries per block
constexpr unsigned kFull = 0xffffffffu;

// Scores as ints whose order is the floats' (no NaN; -0 counts as +0), so
// that a warp's max is one redux.sync; the map is its own inverse.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v + 0.f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The select stage: one warp per query; its 128 scores (row `ql` of
// `scores`, stride `stride` floats) give up their r best by r rounds of max
// (one redux.sync), the lowest column at the max (one redux.sync), mask it
// to -inf.
__device__ __forceinline__ void select_tile(const float* scores, int stride, int q0,
                                            int b_total, int64_t row0, int tile, int tiles,
                                            int r, float* __restrict__ out_vals,
                                            int32_t* __restrict__ out_idx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int neg_inf = order_key(-INFINITY);
  for (int ql = warp; ql < kQB; ql += kWarps) {
    const int qb = q0 + ql;
    if (qb >= b_total) break;  // uniform across the warp
    const float4 v4 = *reinterpret_cast<const float4*>(&scores[ql * stride + 4 * lane]);
    int k0 = order_key(v4.x), k1 = order_key(v4.y), k2 = order_key(v4.z),
        k3 = order_key(v4.w);
    const int64_t out_base = (static_cast<int64_t>(qb) * tiles + tile) * r;
    for (int j = 0; j < r; ++j) {
      const int best = __reduce_max_sync(kFull, max(max(k0, k1), max(k2, k3)));
      unsigned mine = kTileN;
      if (k3 == best) mine = 4 * lane + 3;
      if (k2 == best) mine = 4 * lane + 2;
      if (k1 == best) mine = 4 * lane + 1;
      if (k0 == best) mine = 4 * lane;
      const unsigned bidx = __reduce_min_sync(kFull, mine);
      if ((bidx >> 2) == static_cast<unsigned>(lane)) {
        switch (bidx & 3) {
          case 0: k0 = neg_inf; break;
          case 1: k1 = neg_inf; break;
          case 2: k2 = neg_inf; break;
          default: k3 = neg_inf; break;
        }
      }
      if (lane == 0) {
        const float v = key_value(best);
        out_vals[out_base + j] = v;
        out_idx[out_base + j] = isfinite(v) ? static_cast<int32_t>(row0 + bidx) : -1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 body (round = 0).

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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

template <typename XT, bool L2>
__global__ void __launch_bounds__(kThreads)
flat_topk_f32_kernel(const float* __restrict__ q, const XT* __restrict__ x,
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
      *reinterpret_cast<float4*>(&sm.stage.xs[tid / 8 + 32 * m][col4]) = v;
    }
#pragma unroll
    for (int m = 0; m < kQG; ++m)
      *reinterpret_cast<float4*>(&sm.stage.qs[tid / 8 + 32 * m][col4]) = qr[m];
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
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      v += __shfl_xor_sync(kFull, v, 4);
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
  select_tile(&sm.scores[0][0], kTileN, q0, b_total, row0, tile, tiles, r, out_vals, out_idx);
}

// ---------------------------------------------------------------------------
// The bf16 body (round = 1): tensor cores fed from a cp.async ring.

constexpr int kMC = 64;             // columns per ring stage (256 bytes of an f32 row)
constexpr int kStages = 2;          // ring depth (kStages - 1 in flight)
constexpr int kPad = 8;             // row padding (elements): conflict-free fragment reads
constexpr int kSS = kTileN + 4;     // padded stride of the score tile
constexpr int kFrags = kQB / 8;     // n8 query fragments (8)

template <typename XT>
struct MmaStage {
  XT xs[kTileN][kMC + kPad];              // rows as stored (f32 or bf16)
  __nv_bfloat16 qs[kQB][kMC + kPad];      // rounded queries
};

// the ring, which the score tile overwrites after the scan
template <typename XT>
constexpr int kRingBytes = static_cast<int>(
    kStages * sizeof(MmaStage<XT>) > kQB * kSS * sizeof(float)
        ? kStages * sizeof(MmaStage<XT>)
        : kQB * kSS * sizeof(float));

template <typename XT>
constexpr int kMmaSmemBytes = kRingBytes<XT> + kTileN * sizeof(float);  // + |x|^2

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 8-byte asynchronous copy; zero-fills the destination if !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int src_size = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_size));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// acc += A (16 x 16) . B (16 x 8), the product issued with a zero
// accumulator and its block sum added with round-to-nearest f32 adds.
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  acc[0] += d0;
  acc[1] += d1;
  acc[2] += d2;
  acc[3] += d3;
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x: the lower column
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two adjacent columns of a staged row: as the A fragment's register
// (bf16 pair) and as f32 values for |x|^2.
__device__ __forceinline__ void a_pair(const float* p, uint32_t& a, float2& v) {
  v = *reinterpret_cast<const float2*>(p);
  a = pack_bf16(v);  // round to nearest even, as __float2bfloat16_rn
}

__device__ __forceinline__ void a_pair(const __nv_bfloat16* p, uint32_t& a, float2& v) {
  a = *reinterpret_cast<const uint32_t*>(p);
  v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float sq_add(float2 v, float s) {
  return fmaf(v.y, v.y, fmaf(v.x, v.x, s));
}

__global__ void flat_topk_round_q_kernel(const float* __restrict__ q,
                                         __nv_bfloat16* __restrict__ qb, int b, int d,
                                         int dq) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(b) * dq) return;
  const int64_t row = i / dq;
  const int col = static_cast<int>(i % dq);
  qb[i] = __float2bfloat16_rn(col < d ? q[row * d + col] : 0.f);
}

template <typename XT, bool L2>
__global__ void __launch_bounds__(kThreads, 2)
flat_topk_kernel(const __nv_bfloat16* __restrict__ qb, int dq, const XT* __restrict__ x,
                 const int32_t* __restrict__ ids, const int32_t* __restrict__ excl,
                 float* __restrict__ out_vals, int32_t* __restrict__ out_idx, int b_total,
                 int n_rows, int n_valid, int d, int r, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  MmaStage<XT>* ring = reinterpret_cast<MmaStage<XT>*>(smem);
  float* scores = reinterpret_cast<float*>(smem);  // [kQB][kSS], after the scan
  float* xsq_s = reinterpret_cast<float*>(smem + kRingBytes<XT>);
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int64_t row0 = static_cast<int64_t>(tile) * kTileN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;              // fragment row group, column pair
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;   // this lane's two rows of the tile
  const int nq = min(kQB, b_total - q0);
  const int nf = (nq + 7) / 8;                       // n8 fragments in use
  const int nchunks = (d + kMC - 1) / kMC;
  const bool wide = sizeof(XT) == 4 || d % 8 == 0;   // 16-byte row copies, else 8

  auto issue = [&](int c) {
    const int d0 = c * kMC;
    MmaStage<XT>& st = ring[c % kStages];
    if (wide) {
      constexpr int kE = 16 / sizeof(XT), kPer = kMC / kE;  // elements, copies a row
#pragma unroll
      for (int i = tid; i < kTileN * kPer; i += kThreads) {
        const int row = i / kPer, col = (i % kPer) * kE;
        const int64_t grow = row0 + row;
        const bool ok = grow < n_rows && d0 + col < d;
        cp_async<16>(&st.xs[row][col], ok ? x + grow * d + d0 + col : x, ok);
      }
    } else {  // bf16 rows, d % 8 == 4: rows are only 8-byte aligned
      constexpr int kPer = kMC / 4;
#pragma unroll
      for (int i = tid; i < kTileN * kPer; i += kThreads) {
        const int row = i / kPer, col = (i % kPer) * 4;
        const int64_t grow = row0 + row;
        const bool ok = grow < n_rows && d0 + col < d;
        cp_async<8>(&st.xs[row][col], ok ? x + grow * d + d0 + col : x, ok);
      }
    }
    // q: copies of 8 bf16; the scratch rows hold dq >= d0 + kMC columns
    constexpr int kQPer = kMC / 8;
#pragma unroll
    for (int i = tid; i < kQB * kQPer; i += kThreads) {
      const int row = i / kQPer, col = (i % kQPer) * 8;
      const bool ok = row < nq;
      cp_async<16>(&st.qs[row][col],
                   ok ? qb + static_cast<int64_t>(q0 + row) * dq + d0 + col : qb, ok);
    }
  };

  float acc[kFrags][4];
#pragma unroll
  for (int f = 0; f < kFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float sq_lo = 0.f, sq_hi = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();  // one group a stage, empty ones included
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // stage c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage c - 1 is consumed
    if (c + kStages - 1 < nchunks) issue(c + kStages - 1);
    cp_async_commit();
    const MmaStage<XT>& st = ring[c % kStages];
    float c_lo = 0.f, c_hi = 0.f;  // this stage's |x|^2 terms of the lane's columns
#pragma unroll
    for (int kk = 0; kk < kMC; kk += 16) {
      uint32_t a[4];
      float2 v0, v1, v2, v3;
      a_pair(&st.xs[r_lo][kk + 2 * t], a[0], v0);
      a_pair(&st.xs[r_hi][kk + 2 * t], a[1], v1);
      a_pair(&st.xs[r_lo][kk + 8 + 2 * t], a[2], v2);
      a_pair(&st.xs[r_hi][kk + 8 + 2 * t], a[3], v3);
      if (L2) {
        c_lo = sq_add(v2, sq_add(v0, c_lo));
        c_hi = sq_add(v3, sq_add(v1, c_hi));
      }
      const int mat = lane / 8;  // ldmatrix: lanes 8m..8m+7 address matrix m's rows
#pragma unroll
      for (int fp = 0; fp < kFrags / 2; ++fp) {
        if (2 * fp < nf) {
          uint32_t bq[4];
          ldmatrix_x4(bq, &st.qs[16 * fp + 8 * (mat / 2) + lane % 8][kk + 8 * (mat % 2)]);
          mma_add(acc[2 * fp], a, bq[0], bq[1]);
          if (2 * fp + 1 < nf) mma_add(acc[2 * fp + 1], a, bq[2], bq[3]);
        }
      }
    }
    sq_lo += c_lo;
    sq_hi += c_hi;
  }
  cp_async_wait<0>();

  if (L2) {  // the row's 4 lanes: a 2-level tree
    sq_lo += __shfl_xor_sync(kFull, sq_lo, 1);
    sq_lo += __shfl_xor_sync(kFull, sq_lo, 2);
    sq_hi += __shfl_xor_sync(kFull, sq_hi, 1);
    sq_hi += __shfl_xor_sync(kFull, sq_hi, 2);
    if (t == 0) {
      xsq_s[r_lo] = sq_lo;
      xsq_s[r_hi] = sq_hi;
    }
  }
  __syncthreads();  // xsq_s written; every warp is done with the ring

  // D fragment: acc[f] = {(r_lo, 8f + 2t), (r_lo, 8f + 2t + 1), (r_hi, ..), (r_hi, ..)}
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rt = h ? r_hi : r_lo;
    const int64_t row = row0 + rt;
    const bool row_ok = row < n_valid;
    const int32_t row_id = (ids != nullptr && row < n_rows) ? ids[row] : 0;
    const float xsq = L2 ? xsq_s[rt] : 0.f;
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      if (f < nf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * f + 2 * t + e;
          const int qi = q0 + ql;
          float s = -INFINITY;
          if (row_ok && qi < b_total && !(ids != nullptr && row_id == excl[qi]))
            s = L2 ? 2.f * acc[f][2 * h + e] - xsq : acc[f][2 * h + e];
          scores[ql * kSS + rt] = s;
        }
      }
    }
  }
  __syncthreads();
  select_tile(scores, kSS, q0, b_total, row0, tile, tiles, r, out_vals, out_idx);
}

template <typename XT>
int launch_f32(const float* q, const void* x, const int32_t* ids, const int32_t* excl,
               float* vals, int32_t* idx, int b, int n, int n_valid, int d, int r, bool l2,
               cudaStream_t stream) {
  const int tiles = (n + kTileN - 1) / kTileN;
  const dim3 grid(tiles, (b + kQB - 1) / kQB);
  const XT* xt = static_cast<const XT*>(x);
  if (l2)
    flat_topk_f32_kernel<XT, true><<<grid, kThreads, 0, stream>>>(
        q, xt, ids, excl, vals, idx, b, n, n_valid, d, r, tiles);
  else
    flat_topk_f32_kernel<XT, false><<<grid, kThreads, 0, stream>>>(
        q, xt, ids, excl, vals, idx, b, n, n_valid, d, r, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool L2>
int launch_mma_body(const __nv_bfloat16* qb, int dq, const void* x, const int32_t* ids,
                    const int32_t* excl, float* vals, int32_t* idx, int b, int n,
                    int n_valid, int d, int r, cudaStream_t stream) {
  auto kernel = flat_topk_kernel<XT, L2>;
  const int smem = kMmaSmemBytes<XT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTileN - 1) / kTileN;
  const dim3 grid(tiles, (b + kQB - 1) / kQB);
  kernel<<<grid, kThreads, smem, stream>>>(qb, dq, static_cast<const XT*>(x), ids, excl,
                                           vals, idx, b, n, n_valid, d, r, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_mma(const float* q, void* q_scratch, const void* x, const int32_t* ids,
               const int32_t* excl, float* vals, int32_t* idx, int b, int n, int n_valid,
               int d, int r, bool l2, cudaStream_t stream) {
  const int dq = (d + kMC - 1) / kMC * kMC;
  auto* qb = static_cast<__nv_bfloat16*>(q_scratch);
  const int64_t total = static_cast<int64_t>(b) * dq;
  flat_topk_round_q_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(q, qb, b, d, dq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return l2 ? launch_mma_body<XT, true>(qb, dq, x, ids, excl, vals, idx, b, n, n_valid, d, r,
                                        stream)
            : launch_mma_body<XT, false>(qb, dq, x, ids, excl, vals, idx, b, n, n_valid, d, r,
                                         stream);
}

}  // namespace

// q [B, D] f32, x [N, D] f32 (x_kind 0) or bf16 (x_kind 1), D % 4 == 0,
// 16-byte aligned; ids [N] and excl [B] int32, or both null (no exclusion);
// 1 <= r <= 128. round: bf16 operands on the tensor cores, with q_scratch a
// bf16 [B, ceil(D / 64) * 64] buffer for the rounded q (16-byte aligned);
// else the f32 body (q_scratch unused). l2: 2 q.x - |x|^2 (else q.x).
// Writes vals [B, tiles, r] f32 and idx [B, tiles, r] int32, tiles =
// ceil(N / 128). Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int radad_flat_topk(const float* q, void* q_scratch, const void* x,
                               const int32_t* ids, const int32_t* excl, float* vals,
                               int32_t* idx, int b, int n, int n_valid, int d, int r,
                               int x_kind, int round, int l2, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (r < 1 || r > kTileN || d % 4 || (round && q_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (round)
    return x_kind == 0 ? launch_mma<float>(q, q_scratch, x, ids, excl, vals, idx, b, n,
                                           n_valid, d, r, l2, s)
                       : launch_mma<__nv_bfloat16>(q, q_scratch, x, ids, excl, vals, idx, b,
                                                   n, n_valid, d, r, l2, s);
  return x_kind == 0
             ? launch_f32<float>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s)
             : launch_f32<__nv_bfloat16>(q, x, ids, excl, vals, idx, b, n, n_valid, d, r, l2, s);
}
