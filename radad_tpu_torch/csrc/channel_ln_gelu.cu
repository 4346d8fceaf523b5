// Bias add, LayerNorm over the channels and the tanh GELU of a bf16 conv
// output, in one pass: for each (b, t) of a [B, C, T] product,
//   v = bf16(x + bias)                        (no bias: v = x)
//   y = bf16(scale * (rstd * (v - mean)) + shift)
//   out = gelu_tanh(y), bf16 step by step     (bias_gelu.cu's gelu2)
// with mean and var = mean((v - mean)^2) over the C values of v in f32 and
// rstd = rsqrtf(var + eps).
//
// Replaces no TPU kernel: the JAX package's layer-norm conv front end
// (radad_tpu/models/wav2vec2.py, feat_extract_norm == "layer": conv, bias,
// LN over channels, GELU), which XLA fuses. PyTorch runs it as a chain
// (ops/channel_ln_gelu.py::channel_ln_gelu_plain): the bias add in bf16, a
// transpose and cast to f32, F.layer_norm, the cast back, bias_gelu, and
// the transpose back that the next conv copies: some 36 bytes moved per
// value. The rounding points here are the chain's (bf16 sum, f32
// statistics, one rounding of the f32 LN output, the GELU's bf16 steps);
// only the order of the f32 sums differs (F.layer_norm: Welford per thread,
// then a tree; here a sum of the values, then of the squared deviations),
// which moves y by at most one bf16 step where the f32 result lies next to
// a rounding boundary. The affine step is written as PyTorch's layer-norm
// kernel writes it, which nvcc contracts to one fma in both builds.
//
// Bound on the H100: bytes. x is read once and out written once, 4 bytes a
// value: 1.68 GB for wavlm-large's conv 0 at 128 windows of 2 s
// ([128, 512, 6,399]), at least 0.50 ms at 3.35 TB/s (H100 SXM data sheet,
// 700 W). The arithmetic, ~40 instructions a value (tanhf most of them),
// is not far below that rate.
//
// Design: x is channels-last (the front end runs its convs in NHWC,
// models/encoder_common.py::conv1d_channels_last), so the C <= 512 values
// of one (b, t) are one row of up to 1 KB. A warp takes a row at a time:
// lane l holds channels 8 (l + 32 j) + e, read and written as 16-byte
// vectors (so C is a multiple of 8 and x and out are 16-byte aligned: the
// published 512, the tests' 16 and 8); the sums are warp shuffles, two
// rounds (mean, then the squared deviations) over values held in
// registers. Warps persist over rows (a grid of 2 blocks an SM), keep
// their channels' bias, scale and shift in registers, and load the next
// row before they reduce this one. At conv 0's shape this runs at 0.82 of the byte bound (0.61 ms;
// H100 SXM at 700 W, torch.profiler); at 3 blocks an SM ptxas held it to
// 80 registers and it spilled, 0.74. Two designs lost on the same card:
// a warp a row that read its row's bias, scale and shift again (scattered
// 4-byte loads) ran at 0.44; a kernel on the row-major [B, C, T] that
// row-major convs write (T odd, so 2-byte loads, a block of 32 frames x
// all C, the sums through shared memory) at 0.22 (2.26 ms), and with the
// row-major convs that front end took 10.6 ms at 128 windows against
// 3.96 for this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 512;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;  // bf16 values in a 16-byte vector
constexpr int kJ = kMaxChannels / (32 * kVec);  // vectors a lane
constexpr int kBlocksPerSm = 2;  // up to 128 registers: no spill
// bf16x2 constants of the tanh GELU, the same value in both halves
constexpr uint32_t kA = 0x3D373D37u;    // bf16(0.044715) = 0.044677734375
constexpr uint32_t kC = 0x3F4C3F4Cu;    // bf16(sqrt(2 / pi)) = 0.796875
constexpr uint32_t kOne = 0x3F803F80u;  // 1.0
constexpr uint32_t kHalf = 0x3F003F00u; // 0.5

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The GELU of two bf16 values, each step rounded where the chain rounds
// (bias_gelu.cu's gelu2, which holds the argument).
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

// y of one value, before its rounding: PyTorch's layer-norm kernel's
// expression, which nvcc contracts to the same fma.
__device__ __forceinline__ float normed(float v, float mean, float rstd, float scale, float shift) {
  return scale * (rstd * (v - mean)) + shift;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The lane's 16-byte vectors of one row: channels 8 (lane + 32 j) .. + 7,
// where the channel exists.
__device__ __forceinline__ void load_row(const __nv_bfloat16* xr, int lane, const bool (&on)[kJ],
                                         uint4 (&wide)[kJ]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (on[j]) wide[j] = *reinterpret_cast<const uint4*>(xr + kVec * (lane + 32 * j));
}

// Each warp walks rows row, row + step, ... (a grid sized to the SMs);
// lane l holds channels 8 (l + 32 j) + e of each row, with their bias,
// scale and shift in registers for every row, and loads the next row
// before it reduces the current one.
template <bool kBias>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
channel_ln_gelu_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bias,
                            const float* __restrict__ scale, const float* __restrict__ shift,
                            __nv_bfloat16* __restrict__ out, int channels, int64_t rows, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  bool on[kJ];
  float sc[kJ][kVec], sh[kJ][kVec];
  __nv_bfloat16 bs[kJ][kVec];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int c0 = kVec * (lane + 32 * j);
    on[j] = c0 < channels;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sc[j][e] = on[j] ? scale[c0 + e] : 0.f;
      sh[j][e] = on[j] ? shift[c0 + e] : 0.f;
      bs[j][e] = kBias && on[j] ? bias[c0 + e] : __float2bfloat16_rn(0.f);
    }
  }
  uint4 wide[kJ];  // the lane's raw bf16 of a row
  if (row < rows) load_row(x + static_cast<size_t>(row) * channels, lane, on, wide);
  for (; row < rows; row += step) {
    float v[kJ][kVec];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const uint32_t words[4] = {wide[j].x, wide[j].y, wide[j].z, wide[j].w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        __nv_bfloat162 h = as_bf2(words[p]);
        if (kBias) h = __hadd2_rn(h, __halves2bfloat162(bs[j][2 * p], bs[j][2 * p + 1]));
        const float2 f = __bfloat1622float2(h);
        v[j][2 * p] = on[j] ? f.x : 0.f;
        v[j][2 * p + 1] = on[j] ? f.y : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[j][e];
    }
    if (row + step < rows)  // in flight while this row reduces
      load_row(x + static_cast<size_t>(row + step) * channels, lane, on, wide);
    const float mean = warp_sum(sum) / static_cast<float>(channels);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[j][e] - mean;
        if (on[j]) sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(channels) + eps);
    __nv_bfloat16* orow = out + static_cast<size_t>(row) * channels;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (!on[j]) continue;
      uint32_t words[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float y0 = normed(v[j][2 * p], mean, rstd, sc[j][2 * p], sh[j][2 * p]);
        const float y1 = normed(v[j][2 * p + 1], mean, rstd, sc[j][2 * p + 1], sh[j][2 * p + 1]);
        words[p] = as_u32(gelu2(__floats2bfloat162_rn(y0, y1)));
      }
      *reinterpret_cast<uint4*>(orow + kVec * (lane + 32 * j)) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

template <bool kBias>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* bias, const float* scale,
                   const float* shift, __nv_bfloat16* out, int64_t rows, int channels, float eps,
                   cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t need = (rows + kWarps - 1) / kWarps;
  const unsigned blocks = static_cast<unsigned>(
      need < int64_t(sms) * kBlocksPerSm ? need : int64_t(sms) * kBlocksPerSm);
  channel_ln_gelu_rows_kernel<kBias><<<blocks, kThreads, 0, s>>>(x, bias, scale, shift, out,
                                                                 channels, rows, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: `rows` rows of `channels` bf16 values (a channels-last
// [B, C, T]: rows = B T), out not aliasing x; bias: NULL or `channels` bf16
// values; scale, shift: `channels` f32 values. Returns cudaGetLastError()
// after the launch (0 on success), and cudaErrorInvalidValue where channels
// is not a multiple of 8 in 8 .. 512, x or out is not 16-byte aligned, or
// rows is negative (the wrapper refuses such tensors).
extern "C" int radad_channel_ln_gelu(const void* x, const void* bias, const void* scale,
                                     const void* shift, void* out, int64_t rows,
                                     int64_t channels, float eps, void* stream) {
  const uintptr_t ends = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (channels < kVec || channels > kMaxChannels || channels % kVec || ends % 16 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(channels);
  const cudaError_t e = bias == nullptr ? launch<false>(xp, bp, sc, sh, op, rows, c, eps, s)
                                        : launch<true>(xp, bp, sc, sh, op, rows, c, eps, s);
  return static_cast<int>(e);
}
