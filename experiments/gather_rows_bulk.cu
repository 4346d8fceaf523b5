// Row gather out[m, :] = x[clamp(idx[m], 0, n - 1), :] by Hopper bulk
// copies: the design that radad_tpu_torch/csrc/gather_rows.cu was measured
// against (experiments/select_gather_variants.py builds this file, with
// kStages and kChunkBytes swapped, and calls its C entry, which has the
// kernel's signature).
//
// One block of one warp takes up to kStages chunks of kChunkBytes of one
// output row; its thread 0 issues each chunk's cp.async.bulk from global
// into shared memory against its own mbarrier, all of them before it waits
// on any, then copies each chunk back out with cp.async.bulk from shared to
// global as it lands, and waits until the stores have read shared memory
// before the block ends. Threads spend no registers on the bytes.
//
// The bulk copies need 16-byte aligned addresses and sizes that are a
// multiple of 16, so this entry takes only rows and pointers that allow it
// and returns cudaErrorInvalidValue for any other (the serving rows, f32
// 5,376 wide, do).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;         // chunks in flight a block
constexpr int kChunkBytes = 8192;  // bytes a bulk copy
constexpr int64_t kBlockBytes = static_cast<int64_t>(kStages) * kChunkBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(32)
gather_rows_bulk_kernel(const char* __restrict__ x, const int32_t* __restrict__ idx,
                        char* __restrict__ out, int64_t n, int64_t row_bytes) {
  __shared__ __align__(128) char buf[kStages][kChunkBytes];
  __shared__ __align__(8) uint64_t bar[kStages];
  if (threadIdx.x != 0) return;
  const int64_t dst_row = blockIdx.x;
  int64_t src_row = idx[dst_row];
  src_row = src_row < 0 ? 0 : (src_row >= n ? n - 1 : src_row);
  const int64_t first = static_cast<int64_t>(blockIdx.y) * kBlockBytes;
  const char* src = x + src_row * row_bytes + first;
  char* dst = out + dst_row * row_bytes + first;
  const int64_t left = row_bytes - first;
  const int stages = static_cast<int>(min(static_cast<int64_t>(kStages),
                                          (left + kChunkBytes - 1) / kChunkBytes));
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;" ::
                   : "memory");
  for (int s = 0; s < stages; ++s) {
    const uint32_t bytes = static_cast<uint32_t>(min(static_cast<int64_t>(kChunkBytes),
                                                     left - static_cast<int64_t>(s) * kChunkBytes));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(&bar[s])),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(buf[s])),
        "l"(src + static_cast<int64_t>(s) * kChunkBytes), "r"(bytes), "r"(smem_u32(&bar[s]))
        : "memory");
  }
  for (int s = 0; s < stages; ++s) {
    const uint32_t bytes = static_cast<uint32_t>(min(static_cast<int64_t>(kChunkBytes),
                                                     left - static_cast<int64_t>(s) * kChunkBytes));
    wait_phase0(smem_u32(&bar[s]));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                     dst + static_cast<int64_t>(s) * kChunkBytes),
                 "r"(smem_u32(buf[s])), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace

extern "C" int radad_gather_rows(const void* x, const int32_t* idx, void* out,
                                 int64_t n, int64_t row_bytes, int64_t m,
                                 void* stream) {
  if (m == 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  const int64_t chunks = (row_bytes + kBlockBytes - 1) / kBlockBytes;
  if (align % 16 != 0 || chunks > 65535 || m > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m), static_cast<unsigned>(chunks));
  gather_rows_bulk_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), idx, static_cast<char*>(out), n, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
