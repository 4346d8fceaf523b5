// Per-tile top-m extraction for the certified flat search's candidate
// select.
//
// Replaces the Pallas kernel radad_tpu/ops/topk.py::extract_candidates
// (_extract_kernel), called from radad_tpu/index/flat.py::_hier_candidates.
// It must agree with the XLA loop there (flat.py:867-884): in each of m
// rounds a tile gives up its maximum, the LOWEST lane that holds it, and
// that lane is masked to -inf; a tile of all -inf gives -inf at lane 0.
// Outputs are j-major, vals[b, j * T + t] and
// rows[b, j * T + t] = lane * nt + tsel[b, t], plus leftover[b, t], the
// tile's maximum after the m rounds (the in-tile part of the certificate's
// spill bound). The values are the inputs' own, so the result is exact; a
// zero maximum comes out as +0 (the reference's max keeps no rule for the
// sign of a zero either: torch's CPU amax returns the first zero it meets,
// XLA's max +0).
//
// Bound on the H100: launch and latency. At the serving shape
// (B = 256, T = 24, m = 8) it reads 3.1 MB and writes 0.4 MB, about 1 us
// at the H100 SXM's 3.35 TB/s (data sheet, 700 W), and its arithmetic is a
// few compares per element per round. What is left is the chain of m
// dependent rounds of each tile and the stores.
//
// Design:
// - One warp per (b, t) tile. The 128 lanes of a tile are loaded once, 4
//   consecutive lanes to a thread with one 16-byte load, turned into
//   order-preserving int keys, and stay in registers through all m rounds.
// - A round is two redux.sync: the max over the warp of each thread's best
//   key, then the min over the lowest of each thread's lanes whose key
//   equals it; the owning thread masks that lane to the key of -inf. (The
//   shuffle-xor chains these replace took 5 dependent steps each.) -0 and
//   +0 share a key, so a -0 at a lower lane than a +0 goes first, as the
//   XLA loop's `cand >= best` has it; an all-(-inf) tile picks lane 0 in
//   every round.
// - Coalesced output: a block takes one batch row b and a run of w tiles
//   (w <= 16, one warp each; the tiles of a row split evenly over the
//   fewest blocks: at T = 24, 2 blocks of 12, so that at small B more SMs
//   share the rounds). Lane 0 of each warp stages its rounds' (value, row)
//   in shared memory as [m][w]; after one barrier the block writes each
//   round's w contiguous entries of vals[b, j * T + t0 ...] and rows[...],
//   and leftover[b, t0 ...], with coalesced stores.
// These were measured against the shuffle chains, direct stores, 4 to 32
// tiles a block, and each thread's 4 keys sorted once so that a round
// reduces one head a thread (experiments/select_gather_variants.py).
// Written in CUDA rather than Triton: the kernel is warp collectives, which
// CUDA states directly.
//
// Inputs must be free of NaN (they are masked scores of finite vectors).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTiles = 16;  // tiles (warps) a block at most
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

__device__ __forceinline__ int warp_max(int k) { return __reduce_max_sync(kFull, k); }

__device__ __forceinline__ unsigned warp_min(unsigned i) { return __reduce_min_sync(kFull, i); }

// Tiles a block: the fewest blocks of at most kMaxTiles, evenly filled.
inline int tiles_per_block(int t) {
  const int blocks = (t + kMaxTiles - 1) / kMaxTiles;
  return (t + blocks - 1) / blocks;
}

// blockIdx.x: the batch row b; blockIdx.y: its run of w tiles from t0.
// Shared memory: vals [m][w] f32, rows [m][w] i32, leftover [w] f32.
__global__ void __launch_bounds__(kMaxTiles * 32)
extract_candidates_kernel(const float* __restrict__ cand, const int32_t* __restrict__ tsel,
                          float* __restrict__ vals, int32_t* __restrict__ rows,
                          float* __restrict__ leftover, int t, int m, int nt, int w) {
  extern __shared__ __align__(16) float smem[];
  float* s_val = smem;
  int32_t* s_row = reinterpret_cast<int32_t*>(s_val + m * w);
  float* s_left = reinterpret_cast<float*>(s_row + m * w);
  const int64_t b = blockIdx.x;
  const int t0 = blockIdx.y * w;
  const int tiles = min(w, t - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp < tiles) {  // uniform across the warp
    const int64_t tile_at = b * t + t0 + warp;
    const float4 v4 = reinterpret_cast<const float4*>(cand + tile_at * 128)[lane];
    int k0 = order_key(v4.x), k1 = order_key(v4.y), k2 = order_key(v4.z), k3 = order_key(v4.w);
    const int32_t tile = tsel[tile_at];
    const int neg_inf = order_key(-INFINITY);
    for (int j = 0; j < m; ++j) {
      const int best = warp_max(max(max(k0, k1), max(k2, k3)));
      unsigned mine = 128;
      if (k3 == best) mine = 4 * lane + 3;
      if (k2 == best) mine = 4 * lane + 2;
      if (k1 == best) mine = 4 * lane + 1;
      if (k0 == best) mine = 4 * lane;
      const unsigned bidx = warp_min(mine);
      if ((bidx >> 2) == static_cast<unsigned>(lane)) {
        switch (bidx & 3) {
          case 0: k0 = neg_inf; break;
          case 1: k1 = neg_inf; break;
          case 2: k2 = neg_inf; break;
          default: k3 = neg_inf; break;
        }
      }
      if (lane == 0) {
        s_val[j * w + warp] = key_value(best);
        s_row[j * w + warp] = static_cast<int32_t>(bidx) * nt + tile;
      }
    }
    const int rest = warp_max(max(max(k0, k1), max(k2, k3)));
    if (lane == 0) s_left[warp] = key_value(rest);
  }
  __syncthreads();

  // round j's entries of this block's tiles are contiguous in the output
  const int64_t out0 = b * m * t + t0;
  for (int e = threadIdx.x; e < m * tiles; e += blockDim.x) {
    const int j = e / tiles, i = e - j * tiles;
    vals[out0 + static_cast<int64_t>(j) * t + i] = s_val[j * w + i];
    rows[out0 + static_cast<int64_t>(j) * t + i] = s_row[j * w + i];
  }
  if (static_cast<int>(threadIdx.x) < tiles) leftover[b * t + t0 + threadIdx.x] = s_left[threadIdx.x];
}

}  // namespace

// cand [B, T, 128] f32, tsel [B, T] i32 -> vals [B, m*T] f32,
// rows [B, m*T] i32, leftover [B, T] f32, 1 <= m <= 128. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int radad_extract_candidates(const float* cand, const int32_t* tsel,
                                        float* vals, int32_t* rows,
                                        float* leftover, int64_t b, int t,
                                        int m, int nt, void* stream) {
  if (b * t == 0) return 0;
  if (b > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int w = tiles_per_block(t);
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>((t + w - 1) / w));
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(m) * w + w);
  extract_candidates_kernel<<<grid, w * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, tsel, vals, rows, leftover, t, m, nt, w);
  return static_cast<int>(cudaGetLastError());
}
