// Row gather: out[m, :] = x[clamp(idx[m], 0, n - 1), :].
//
// Replaces the Pallas kernel radad_tpu/ops/gather.py::gather_rows
// (_gather_kernel): the neighbor fetch of both serving routes
// (radad_tpu/train/pipeline.py::retrieve_on_device, M = 5 B rows) and the
// re-rank gather of the use_pallas route (index/flat.py::_rerank_exact,
// M = 32 B rows).
//
// Bound on the H100: bytes. Each output row is read once and written once,
// 2 * M * row_bytes in all: 55 MB for M = 1280 rows of 5376 f32, at least
// 16.4 us at the H100 SXM's 3.35 TB/s (data sheet, 700 W). There is no
// arithmetic to speak of. At the small M of one query (5 rows, 107 KB) the
// copy is bound by latency instead: one load and one store round trip.
//
// Design: the TPU version needs the table re-laid out as [N, D/128, 128] so
// that one row is a legal DMA source. Here rows stay [N, D] and contiguous.
// - Work for every SM at every M: the grid runs over (output row, chunk of
//   the row), a chunk being kChunk vectors of the widest width the row's
//   size and both pointers' alignment allow (16 bytes for f32 rows whose
//   width is a multiple of 4, else 4, else 2). So 5 rows of 21.5 KB take 15
//   blocks, not 2, and M = 1280 takes 3840. The tail chunk of a row is
//   masked.
// - Bytes in flight: each thread issues its kUnroll loads, kThreads vectors
//   apart so that a warp's loads stay contiguous, before any store, with
//   32-bit index math inside the chunk. The loads go through the read-only
//   path (const __restrict__, ld.global.nc); the stores keep the default
//   policy, since the next op reads the output at once.
// - The index is clamped in the kernel, as jnp.take clips on the TPU;
//   callers mask invalid neighbors themselves.
// Measured against 1 to 8 loads a thread, 64 to 256 threads a block, loads
// that skip L1, an L2 prefetch hint, streaming stores, and Hopper's bulk
// copies through shared memory (experiments/gather_rows_bulk.cu), at the
// serving M, each timed call reading its rows from device memory
// (experiments/select_gather_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // threads a block
constexpr int kUnroll = 4;                    // loads a thread issues before its stores
constexpr int kChunk = kThreads * kUnroll;    // vectors a block copies
constexpr int64_t kMaxChunks = 65535;         // gridDim.y

// blockIdx.x: the output row; blockIdx.y: the chunk of it
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                   V* __restrict__ out, int64_t n, int row_vecs) {
  const int64_t dst_row = blockIdx.x;
  int64_t src_row = idx[dst_row];
  src_row = src_row < 0 ? 0 : (src_row >= n ? n - 1 : src_row);
  const int first = static_cast<int>(blockIdx.y) * kChunk + static_cast<int>(threadIdx.x);
  const V* src = x + src_row * row_vecs;
  V* dst = out + dst_row * row_vecs;
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int c = first + u * kThreads;
    if (c < row_vecs) v[u] = src[c];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int c = first + u * kThreads;
    if (c < row_vecs) dst[c] = v[u];
  }
}

template <typename V>
int launch(const void* x, const int32_t* idx, void* out, int64_t n,
           int64_t row_bytes, int64_t m, cudaStream_t stream) {
  const int64_t row_vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t chunks = (row_vecs + kChunk - 1) / kChunk;
  if (chunks > kMaxChunks || m > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(chunks));
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(x), idx, static_cast<V*>(out), n, static_cast<int>(row_vecs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), -1 when
// row_bytes is not a multiple of 2, and cudaErrorInvalidValue when a row
// needs more than 65,535 chunks or M exceeds 2^31 - 1 (the wrapper never
// passes such shapes).
extern "C" int radad_gather_rows(const void* x, const int32_t* idx, void* out,
                                 int64_t n, int64_t row_bytes, int64_t m,
                                 void* stream) {
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(x, idx, out, n, row_bytes, m, s);
  if (align % 4 == 0) return launch<uint32_t>(x, idx, out, n, row_bytes, m, s);
  if (align % 2 == 0) return launch<uint16_t>(x, idx, out, n, row_bytes, m, s);
  return -1;
}
