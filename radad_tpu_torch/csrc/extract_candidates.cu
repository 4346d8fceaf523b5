// Per-tile top-m extraction for the certified flat search's candidate
// select.
//
// Replaces the Pallas kernel radad_tpu/ops/topk.py::extract_candidates
// (_extract_kernel), called from radad_tpu/index/flat.py::_hier_candidates.
// It must agree bit for bit with the XLA loop there (flat.py:867-884): in
// each of m rounds a tile gives up its maximum, the LOWEST lane that holds
// it, and that lane is masked to -inf; a tile of all -inf gives -inf at
// lane 0. Outputs are j-major, vals[b, j * T + t] and
// rows[b, j * T + t] = lane * nt + tsel[b, t], plus leftover[b, t], the
// tile's maximum after the m rounds (the in-tile part of the certificate's
// spill bound).
//
// Bound on the H100: launch and latency. At the serving shape
// (B = 256, T = 24, m = 8) it reads 3.1 MB and writes 0.4 MB, about 1 us
// at the H100 SXM's 3.35 TB/s (data sheet, 700 W), and its arithmetic is a
// few compares per element per round.
//
// Design: one warp per (b, t) tile. The 128 lanes of a tile are loaded
// once, 4 consecutive lanes to a thread with one 16-byte load, and stay in
// registers through all m rounds. A round is a warp max (shuffle xor), then
// each thread proposes the lowest of its 4 lanes that reaches the maximum,
// a shuffle-xor min picks the lowest lane in the tile, and the owning
// thread masks it to -inf. Only compares and copies touch the values, so
// the result is exact. Written in CUDA rather than Triton: the kernel is a
// handful of warp shuffles, which CUDA states directly.
//
// Inputs must be free of NaN (they are masked scores of finite vectors).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__global__ void extract_candidates_kernel(const float* __restrict__ cand,
                                          const int32_t* __restrict__ tsel,
                                          float* __restrict__ vals,
                                          int32_t* __restrict__ rows,
                                          float* __restrict__ leftover,
                                          int64_t tiles_total, int t, int m,
                                          int nt) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= tiles_total) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const int64_t b = w / t;
  const int ti = static_cast<int>(w % t);
  const float4 v4 = reinterpret_cast<const float4*>(cand + w * 128)[lane];
  float v0 = v4.x, v1 = v4.y, v2 = v4.z, v3 = v4.w;
  const int32_t tile = tsel[w];
  const int64_t out_base = b * static_cast<int64_t>(m) * t + ti;

  for (int j = 0; j < m; ++j) {
    const float best = warp_max(fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)));
    int mine = 128;
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
      const int64_t o = out_base + static_cast<int64_t>(j) * t;
      vals[o] = best;
      rows[o] = min(bidx, 127) * nt + tile;
    }
  }
  const float rest = warp_max(fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)));
  if (lane == 0) leftover[w] = rest;
}

}  // namespace

// cand [B, T, 128] f32, tsel [B, T] i32 -> vals [B, m*T] f32,
// rows [B, m*T] i32, leftover [B, T] f32. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int radad_extract_candidates(const float* cand, const int32_t* tsel,
                                        float* vals, int32_t* rows,
                                        float* leftover, int64_t b, int t,
                                        int m, int nt, void* stream) {
  const int64_t tiles_total = b * t;
  if (tiles_total == 0) return 0;
  const int64_t blocks = (tiles_total + kWarps - 1) / kWarps;
  extract_candidates_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      cand, tsel, vals, rows, leftover, tiles_total, t, m, nt);
  return static_cast<int>(cudaGetLastError());
}
