// Row gather: out[m, :] = x[clamp(idx[m], 0, n - 1), :].
//
// Replaces the Pallas kernel radad_tpu/ops/gather.py::gather_rows
// (_gather_kernel), the neighbor fetch of the serving path
// (radad_tpu/train/pipeline.py::retrieve_on_device).
//
// Bound on the H100: bytes. Each output row is read once and written once,
// 2 * M * row_bytes in all: 55 MB for M = 1280 rows of 5376 f32, at least
// 16.4 us at the H100 SXM's 3.35 TB/s (data sheet, 700 W). There is no
// arithmetic to speak of.
//
// Design: the TPU version needs the table re-laid out as [N, D/128, 128] so
// that one row is a legal DMA source. Here rows stay [N, D] and contiguous.
// One block copies a group of kRowsPerBlock (4) output rows; its threads walk
// each row with the widest vector load the row's size and alignment allow
// (16 bytes for f32 rows whose width is a multiple of 4), neighbouring
// threads on neighbouring addresses, so every warp issues full 512-byte
// transactions. The index is clamped in the kernel, as jnp.take clips on
// the TPU; callers mask invalid neighbors themselves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t n,
                                   int64_t row_vecs, int64_t m) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int r = 0; r < kRowsPerBlock; ++r) {
    const int64_t dst_row = first + r;
    if (dst_row >= m) return;
    int64_t src_row = idx[dst_row];
    src_row = src_row < 0 ? 0 : (src_row >= n ? n - 1 : src_row);
    const V* src = x + src_row * row_vecs;
    V* dst = out + dst_row * row_vecs;
    for (int64_t v = threadIdx.x; v < row_vecs; v += kThreads) {
      dst[v] = src[v];
    }
  }
}

template <typename V>
int launch(const void* x, const int32_t* idx, void* out, int64_t n,
           int64_t row_bytes, int64_t m, cudaStream_t stream) {
  const int64_t blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const V*>(x), idx, static_cast<V*>(out), n,
      row_bytes / static_cast<int64_t>(sizeof(V)), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 when
// row_bytes is not a multiple of 2 (the wrapper never passes such rows).
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
