// Candidate rerank: out[b, r] = sum_d q[b, d] * float(x[idx[b, r], d]), in
// true f32 (FMA, no TF32), with the row gather fused so that the [B, R, D]
// candidate rows never land in device memory.
//
// Replaces the Pallas kernel radad_tpu/ops/rerank.py::exact_dot
// (_rerank_kernel), the exact re-scoring step of the certified flat search
// (radad_tpu/index/flat.py::_search_fast_exact).
//
// Bound on the H100: bytes. The candidate rows are read once,
// B * R * D * bytes(x): 176 MB for B = 256, R = 32, D = 5376 f32, at least
// 53 us at the H100 SXM's 3.35 TB/s (data sheet, 700 W). The arithmetic
// (2 * B * R * D flops, 88 MFLOP) is far below the card's f32 rate. At
// small B the bytes are few (688 KB at B = 1, D = 5376: 0.2 us), and what
// bounds a call is the launch and the chain of dependent round trips to
// device memory, each ~1 us.
//
// Two forms, picked by the wrapper by shape (ops/rerank.py::exact_dot_form)
// and passed to the C entry, which refuses a form it cannot take:
// - per_query (large B): one block per query. The block stages q[b] in
//   shared memory (21.5 KB at D = 5376), then each warp takes one candidate
//   row at a time and reads it with coalesced vector loads (16 bytes a lane
//   for f32, 8 for bf16, 4 for int8), casts in registers, multiplies with
//   f32 FMA against the staged query, and finishes with a warp shuffle
//   reduction. Enough blocks are in flight on each SM to cover the memory
//   latency; q is read from device memory once a query. It reaches 0.76 of
//   its byte bound at B = 256 (PERF.md).
// - split (small B): one block per (query, candidate row), so B * R blocks
//   (32 at B = 1) spread the rows over the SMs instead of one SM reading
//   all 32. Each of the block's kSplitThreads lanes takes the row's 4-value
//   units u = lane, lane + kSplitThreads, ... (coalesced), issues all its
//   loads of x and of q (through the read-only path: q stays in L2 after
//   the first block touches it, and no barrier stands before the first row
//   load) before its first FMA, up to kSplitBatch units at a time (16
//   loads of 16 bytes in flight a lane for f32), and sums them with f32
//   FMA in unit order. The lane sums go over the warp by a shuffle
//   butterfly and the warps' sums are added in warp order by one thread:
//   a fixed order, no atomics, so two calls give bitwise-equal dots. A
//   call then costs the launch and about two round trips: 0.0018 ms at
//   B = 1 and 0.0027 at B = 8, D = 5376 (per_query 0.0138 / 0.0134).
//   Above B = 64 each row's q comes from L2 once a row, 32 times a query,
//   which the per_query form reads once: at B = 64 split wins (0.0176
//   against 0.0263 ms at D = 5376); at B = 128 per_query wins by 19 % at
//   D = 3584 and loses by 2-3 % at D = 5376; at B = 256 per_query wins at
//   both (0.0624 against 0.0703 at D = 5376). So the wrapper takes split
//   at B <= 64 (ops/rerank.py::SPLIT_MAX_B; PERF.md, chip_smoke.py on an
//   H100 80GB HBM3 at 700 W).
// The TPU kernel's double-buffered DMA ring has no counterpart. int8
// sources are cast in the kernel; the caller applies the per-row scales.
//
// Requires D % 4 == 0 and 16-byte aligned q and x (the wrapper checks).
// Indices are clamped to [0, n - 1]; callers mask invalid candidates by
// score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // per_query: 8 warps, a row each at a time
constexpr int kSplitThreads = 256;  // split: the lanes of one row
constexpr int kSplitBatch = 8;      // split: 4-value units a lane loads at once
constexpr int kFormPerQuery = 0;    // the C entry's `form`
constexpr int kFormSplit = 1;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float fma4(const float4 a, const float4 v, float acc) {
  acc = fmaf(a.x, v.x, acc);
  acc = fmaf(a.y, v.y, acc);
  acc = fmaf(a.z, v.z, acc);
  return fmaf(a.w, v.w, acc);
}

__device__ __forceinline__ int64_t clamp_row(int64_t row, int64_t n) {
  return row < 0 ? 0 : (row >= n ? n - 1 : row);
}

template <typename T>
__global__ void exact_dot_kernel(const float* __restrict__ q,
                                 const T* __restrict__ x,
                                 const int32_t* __restrict__ idx,
                                 float* __restrict__ out, int64_t n, int d,
                                 int r) {
  extern __shared__ float4 q_smem[];
  const int64_t b = blockIdx.x;
  const int d4 = d / 4;
  const float4* qb = reinterpret_cast<const float4*>(q + b * d);
  for (int i = threadIdx.x; i < d4; i += kThreads) q_smem[i] = qb[i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = warp; j < r; j += kThreads / 32) {
    const int64_t row = clamp_row(idx[b * r + j], n);
    const T* xr = x + row * static_cast<int64_t>(d);
    float acc = 0.0f;
#pragma unroll 4
    for (int i = lane; i < d4; i += 32) {
      acc = fma4(q_smem[i], load4(xr + 4 * static_cast<int64_t>(i)), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) out[b * r + j] = acc;
  }
}

// block p: query p / r, candidate p % r
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
exact_dot_split_kernel(const float* __restrict__ q, const T* __restrict__ x,
                       const int32_t* __restrict__ idx, float* __restrict__ out,
                       int64_t n, int d, int r) {
  __shared__ float warp_sums[kSplitThreads / 32];
  const int64_t p = blockIdx.x;
  const int64_t b = p / r;
  const int d4 = d / 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float4* qb = reinterpret_cast<const float4*>(q + b * d);
  const T* xr = x + clamp_row(idx[p], n) * static_cast<int64_t>(d);
  float acc = 0.0f;
  for (int u0 = tid; u0 < d4; u0 += kSplitBatch * kSplitThreads) {
    float4 xv[kSplitBatch], qv[kSplitBatch];
#pragma unroll
    for (int k = 0; k < kSplitBatch; ++k) {
      const int u = u0 + k * kSplitThreads;
      if (u < d4) {
        xv[k] = load4(xr + 4 * static_cast<int64_t>(u));
        qv[k] = __ldg(qb + u);
      }
    }
#pragma unroll
    for (int k = 0; k < kSplitBatch; ++k) {
      if (u0 + k * kSplitThreads < d4) acc = fma4(qv[k], xv[k], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = warp_sums[0];
#pragma unroll
    for (int w = 1; w < kSplitThreads / 32; ++w) s += warp_sums[w];
    out[p] = s;
  }
}

template <typename T>
int launch(const float* q, const void* x, const int32_t* idx, float* out,
           int64_t b, int64_t n, int d, int r, int form, cudaStream_t stream) {
  if (form == kFormSplit) {
    if (b * r > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    exact_dot_split_kernel<T><<<static_cast<unsigned>(b * r), kSplitThreads, 0, stream>>>(
        q, static_cast<const T*>(x), idx, out, n, d, r);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != kFormPerQuery) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exact_dot_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  exact_dot_kernel<T><<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
      q, static_cast<const T*>(x), idx, out, n, d, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_kind: 0 = f32, 1 = bf16, 2 = int8; form: 0 = per_query, 1 = split.
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a form it cannot take, or -1 for an unknown
// x_kind.
extern "C" int radad_exact_dot(const float* q, const void* x,
                               const int32_t* idx, float* out, int64_t b,
                               int64_t n, int d, int r, int x_kind, int form,
                               void* stream) {
  if (b == 0 || r == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0: return launch<float>(q, x, idx, out, b, n, d, r, form, s);
    case 1: return launch<__nv_bfloat16>(q, x, idx, out, b, n, d, r, form, s);
    case 2: return launch<int8_t>(q, x, idx, out, b, n, d, r, form, s);
    default: return -1;
  }
}
