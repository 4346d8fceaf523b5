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
// (2 * B * R * D flops, 88 MFLOP) is far below the card's f32 rate.
//
// Design: one block per query. The block stages q[b] in shared memory
// (21.5 KB at D = 5376), then each warp takes one candidate row at a time
// and reads it with coalesced vector loads (16 bytes a lane for f32, 8 for
// bf16, 4 for int8), casts in registers, multiplies with f32 FMA against
// the staged query, and finishes with a warp shuffle reduction. The TPU
// kernel's double-buffered DMA ring has no counterpart: enough warps are in
// flight on each SM to cover the memory latency. int8 sources are cast in
// the kernel; the caller applies the per-row scales.
//
// Requires D % 4 == 0 and 16-byte aligned q and x (the wrapper checks).
// Indices are clamped to [0, n - 1]; callers mask invalid candidates by
// score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
    int64_t row = idx[b * r + j];
    row = row < 0 ? 0 : (row >= n ? n - 1 : row);
    const T* xr = x + row * static_cast<int64_t>(d);
    float acc = 0.0f;
#pragma unroll 4
    for (int i = lane; i < d4; i += 32) {
      const float4 a = q_smem[i];
      const float4 v = load4(xr + 4 * static_cast<int64_t>(i));
      acc = fmaf(a.x, v.x, acc);
      acc = fmaf(a.y, v.y, acc);
      acc = fmaf(a.z, v.z, acc);
      acc = fmaf(a.w, v.w, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) out[b * r + j] = acc;
  }
}

template <typename T>
int launch(const float* q, const void* x, const int32_t* idx, float* out,
           int64_t b, int64_t n, int d, int r, cudaStream_t stream) {
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

// x_kind: 0 = f32, 1 = bf16, 2 = int8. Returns cudaGetLastError() after the
// launch (0 on success), or -1 for an unknown x_kind.
extern "C" int radad_exact_dot(const float* q, const void* x,
                               const int32_t* idx, float* out, int64_t b,
                               int64_t n, int d, int r, int x_kind,
                               void* stream) {
  if (b == 0 || r == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_kind) {
    case 0: return launch<float>(q, x, idx, out, b, n, d, r, s);
    case 1: return launch<__nv_bfloat16>(q, x, idx, out, b, n, d, r, s);
    case 2: return launch<int8_t>(q, x, idx, out, b, n, d, r, s);
    default: return -1;
  }
}
