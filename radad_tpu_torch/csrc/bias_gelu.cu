// Bias add and the tanh GELU on bf16 in one pass:
// out = gelu_tanh(x + b), rounded to bf16 after every step exactly where
// the op-by-op chain of radad_tpu_torch/models/encoder_common.py rounds, so
// the output is bit for bit that chain's.
//
// Replaces, on the card, the chain that the JAX package's bf16 encoders
// run (radad_tpu/models/encoder_common.py: a linear's or conv's product
// rounded to bf16, its bias added in bf16, then jax.nn.gelu(approximate=
// True) op by op with bf16 constants), which PyTorch runs as ten
// elementwise kernels, each reading and writing the whole activation. With
// c = bf16(sqrt(2 / pi)) and a = bf16(0.044715), PyTorch computes each step
// in f32 and rounds it to bf16 (round to nearest even, NaN to the canonical
// NaN):
//   y = x + b     t1 = y * y     t2 = y * t1    t3 = a * t2    u = y + t3
//   t4 = c * u    t5 = tanh(t4)  t6 = 1 + t5    t7 = 0.5 * t6  out = y * t7
// y = x where there is no bias. Here every step but tanh is one correctly
// rounded bf16x2 instruction (mul.rn / add.rn, which ptxas never fuses into
// an fma), two elements at a time, and the result is the same: a product
// of two bf16 values is exact in f32 (16 significant bits; below 2^-126 the
// f32 rounding can only land on the bf16 midpoint 2^-134 from below, which
// rounds to 0 either way), and a sum is exact in f32 unless the exponents
// differ by 16 or more, where the smaller term is far below half a bf16 ulp
// of the larger, which both roundings return. tanh takes the f32 path:
// tanhf is CUDA's accurate one, which PyTorch's tanh kernel calls, with no
// fast-math flag and no flush of denormals (NVCC_FLAGS in ops/_native.py),
// its argument and result converted exactly as PyTorch does.
//
// Bound on the H100: bytes. x is read once and out written once, 4 bytes
// an element: 1.57 GB for one whisper-base FFN hidden state of 128 padded
// windows (128 x 1,500 x 2,048), at least 0.47 ms at the H100 SXM's
// 3.35 TB/s (data sheet, 700 W). The arithmetic is not far below that
// rate: with each step in f32 and rounded (two instructions more a step
// and element) the kernel took 0.75 ms at that shape; in bf16x2 the steps
// cost half an instruction an element and tanhf most of the rest.
//
// Design:
// - 16-byte loads and stores (8 bf16), two vectors in flight a thread, on a
//   grid-stride loop sized to the SMs.
// - The bias sits at (i / inner) % outer for element i: along the last axis
//   (inner 1, outer = its width) or along the channels of a [B, C, T] conv
//   output (inner T, outer C). Both divisions are a multiply-high and a
//   shift (n < 2^31, which the wrapper keeps by splitting larger tensors at
//   whole periods of the bias). A vector's first bias index is divided out
//   and the next seven are stepped from it (a vector can straddle two
//   channels: conv2's T = 1,500 is not a multiple of 8), with no shared
//   memory. One 16-byte load of the 8 biases where the last axis allows it
//   was no faster at the FFN shapes (H100 SXM at 700 W, CUDA events:
//   0.5989 against 0.5942 ms at 128 x 1,500 x 2,048, 0.0976 against 0.0948
//   at 128 x 149 x 3,072): the bias sits in L1 and x's bytes bound the pass.
// - Elements past the last whole vector, or every element where x or out is
//   not 16-byte aligned, take the same arithmetic one at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;                    // bf16 in 16 bytes
// bf16x2 constants, the same value in both halves
constexpr uint32_t kA = 0x3D373D37u;      // bf16(0.044715) = 0.044677734375
constexpr uint32_t kC = 0x3F4C3F4Cu;      // bf16(sqrt(2 / pi)) = 0.796875
constexpr uint32_t kOne = 0x3F803F80u;    // 1.0
constexpr uint32_t kHalf = 0x3F003F00u;   // 0.5

enum Mode { kNoBias = 0, kBias = 1 };

// n / d for n < 2^31 (PyTorch's IntDivider<unsigned int>)
struct Divider {
  uint32_t d, m, s;
};

Divider make_divider(uint32_t d) {
  uint32_t s = 0;
  while (s < 32 && (uint64_t(1) << s) < d) ++s;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t divide(const Divider& v, uint32_t n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// GELU of two bf16 values y; each step rounded where the chain rounds.
__device__ __forceinline__ __nv_bfloat162 gelu2(__nv_bfloat162 y) {
  const __nv_bfloat162 t1 = __hmul2_rn(y, y);
  const __nv_bfloat162 t2 = __hmul2_rn(y, t1);
  const __nv_bfloat162 t3 = __hmul2_rn(as_bf2(kA), t2);
  const __nv_bfloat162 u = __hadd2_rn(y, t3);
  const float2 t4 = __bfloat1622float2(__hmul2_rn(as_bf2(kC), u));
  const __nv_bfloat162 t5 = __floats2bfloat162_rn(tanhf(t4.x), tanhf(t4.y));
  const __nv_bfloat162 t6 = __hadd2_rn(as_bf2(kOne), t5);
  const __nv_bfloat162 t7 = __hmul2_rn(as_bf2(kHalf), t6);
  return __hmul2_rn(y, t7);
}

struct Bias {
  const __nv_bfloat16* b;
  Divider inner, outer;  // the bias of element i: b[(i / inner) % outer]

  __device__ __forceinline__ uint32_t index(uint32_t i, uint32_t* col) const {
    const uint32_t r = divide(inner, i);
    *col = i - r * inner.d;
    return r - divide(outer, r) * outer.d;
  }
  __device__ __forceinline__ __nv_bfloat16 at(uint32_t i) const {
    uint32_t col;
    return b[index(i, &col)];
  }
};

template <int kMode>
__device__ __forceinline__ uint4 vector_gelu(uint4 xv, uint32_t i0, const Bias& bias) {
  uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
  uint32_t bw[4];
  if (kMode == kBias) {
    uint32_t col;
    uint32_t c = bias.index(i0, &col);
    __nv_bfloat16 bv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      bv[k] = bias.b[c];
      if (++col == bias.inner.d) {
        col = 0;
        c = c + 1 == bias.outer.d ? 0 : c + 1;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) bw[p] = as_u32(__halves2bfloat162(bv[2 * p], bv[2 * p + 1]));
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    __nv_bfloat162 y = as_bf2(w[p]);
    if (kMode != kNoBias) y = __hadd2_rn(y, as_bf2(bw[p]));
    w[p] = as_u32(gelu2(y));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                 Bias bias, uint32_t n, uint32_t nvec) {
  const uint32_t stride = gridDim.x * kThreads;
  const uint32_t tid = blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (uint32_t v = tid; v < nvec; v += 2 * stride) {
    const uint32_t v2 = v + stride;
    const uint4 a = xv[v];
    uint4 b;
    if (v2 < nvec) b = xv[v2];
    ov[v] = vector_gelu<kMode>(a, v * kVec, bias);
    if (v2 < nvec) ov[v2] = vector_gelu<kMode>(b, v2 * kVec, bias);
  }
  for (uint32_t i = nvec * kVec + tid; i < n; i += stride) {
    __nv_bfloat162 y = __bfloat162bfloat162(x[i]);
    if (kMode != kNoBias) y = __hadd2_rn(y, __bfloat162bfloat162(bias.at(i)));
    out[i] = __low2bfloat16(gelu2(y));
  }
}

}  // namespace

// x, out: n bf16 elements (out may not alias x). bias: NULL, or outer bf16
// values, element i taking bias[(i / inner) % outer]. Returns
// cudaGetLastError() after the launch (0 on success), and
// cudaErrorInvalidValue where n, inner or outer is not below 2^31 or inner
// or outer is below 1 (the wrapper splits larger tensors and never passes
// such shapes).
extern "C" int radad_bias_gelu(const void* x, const void* bias, void* out, int64_t n,
                               int64_t inner, int64_t outer, void* stream) {
  constexpr int64_t kMax = int64_t(1) << 31;
  if (n < 0 || n >= kMax || inner < 1 || inner >= kMax || outer < 1 || outer >= kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const uint32_t nvec = aligned ? static_cast<uint32_t>(n / kVec) : 0;
  const int64_t work = nvec > 0 ? nvec : n;
  const int64_t blocks64 = (work + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      blocks64 < int64_t(sms) * kBlocksPerSm ? blocks64 : int64_t(sms) * kBlocksPerSm);
  const Bias b{static_cast<const __nv_bfloat16*>(bias),
               make_divider(static_cast<uint32_t>(inner)),
               make_divider(static_cast<uint32_t>(outer))};
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n32 = static_cast<uint32_t>(n);
  if (bias == nullptr) {
    bias_gelu_kernel<kNoBias><<<blocks, kThreads, 0, s>>>(xp, op, b, n32, nvec);
  } else {
    bias_gelu_kernel<kBias><<<blocks, kThreads, 0, s>>>(xp, op, b, n32, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}
