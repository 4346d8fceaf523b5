// Fused multi-head self-attention on the [B, T, D] projection layout, with
// an optional gated relative position bias (WavLM).
//
// Replaces the Pallas kernels radad_tpu/ops/attention.py::fused_mha
// (_mha_kernel, and _mha_bias_kernel for the bias). Per batch row b and
// head h, with heads as column slices h*HD .. (h+1)*HD of q, k and v and q
// already scaled by HD^-0.5:
//   logits[t, s] = q[b,t,h] . k[b,s,h]  (+ gate[b,t,h] * pos_bias[h,t,s])
//   out[b,t,h]   = softmax_s(logits[t, :]) @ v[b,:,h]
// in f32. The [B, H, T, T] logits and bias never exist in device memory:
// the bias is formed in a register from its two factors.
//
// Bound on the H100: at the WavLM serving shape (B = 128 windows, T = 99,
// D = 768, H = 12) the kernel reads q, k, v, gate and pos_bias once and
// writes the context, 157 MB, 0.047 ms at the H100 SXM's 3.35 TB/s; its
// 3.85 GFLOP of f32 products take 0.058 ms at 67 TFLOP/s outside the tensor
// cores (data sheet, 700 W). So it is bound by f32 operations. The TPU's
// 512-row query tiles and its rows-per-program heuristic exist for VMEM and
// are not carried over.
//
// Design: the grid runs over (query tile, head, batch row). A block of
// kWarps warps takes kWarps * kRowsPerWarp query rows of one head; each warp
// owns kRowsPerWarp rows, so every value it reads from shared memory feeds
// kRowsPerWarp FMAs. The head's K and V columns stream through shared memory
// in tiles of 32 keys, one key per lane for q.k (K rows padded to HD + 4
// floats, so 16-byte reads by a quarter warp hit distinct banks) and lanes
// over the head dimension for p.V. An online softmax in f32 keeps each
// row's running max and sum and an HD-wide f32 accumulator (HD / 32 values
// a lane), rescaled when the max grows; the context is divided by the sum
// once at the end and written to the head's column slice. The kernel is
// right for every T: only the key tiles loop, and rows and keys past T are
// masked. f32 only; wgmma/TMA (bf16, tensor cores) come later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per shared-memory tile

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * HD + kKeys * (HD + 4) + kKeys * HD);
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(kWarps * 32)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ gate,
           const float* __restrict__ pos, float* __restrict__ out, int t_len,
           int d_model, int heads) {
  constexpr int KS = HD + 4;            // padded K row stride (floats)
  constexpr int NACC = (HD + 31) / 32;  // accumulator values per lane
  constexpr int V4 = HD / 4;            // float4 per head row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][HD]
  float* ks = qs + kRows * HD;                  // [kKeys][KS]
  float* vs = ks + kKeys * KS;                  // [kKeys][HD]

  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;

  for (int i = threadIdx.x; i < kRows * V4; i += blockDim.x) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < t_len)
      val = *reinterpret_cast<const float4*>(q + base + static_cast<int64_t>(t0 + r) * d_model + c);
    *reinterpret_cast<float4*>(qs + r * HD + c) = val;
  }

  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile
  float m[kRowsPerWarp], l[kRowsPerWarp], g[kRowsPerWarp];
  float acc[kRowsPerWarp][NACC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    g[i] = 0.f;
    if (BIAS && t0 + row0 + i < t_len)
      g[i] = gate[(b * t_len + t0 + row0 + i) * heads + h];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 < t_len; s0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < kKeys * V4; i += blockDim.x) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (s0 + r < t_len) {
        const int64_t off = base + static_cast<int64_t>(s0 + r) * d_model + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + r * KS + c) = kv;
      *reinterpret_cast<float4*>(vs + r * HD + c) = vv;
    }
    __syncthreads();

    const int s = s0 + lane;  // this lane's key
    const bool key_ok = s < t_len;
    float logit[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) logit[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(ks + lane * KS + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (row0 + i) * HD + d);
        logit[i] = fmaf(qq.x, kk.x, logit[i]);
        logit[i] = fmaf(qq.y, kk.y, logit[i]);
        logit[i] = fmaf(qq.z, kk.z, logit[i]);
        logit[i] = fmaf(qq.w, kk.w, logit[i]);
      }
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = t0 + row0 + i;
      if (BIAS && key_ok && t < t_len)
        logit[i] += g[i] * pos[(static_cast<int64_t>(h) * t_len + t) * t_len + s];
      const float x = key_ok ? logit[i] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));  // finite: key s0 exists
      const float scale = expf(m[i] - m_new);        // 0 on the first tile
      p[i] = key_ok ? expf(x - m_new) : 0.f;
      l[i] = l[i] * scale + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[i][j] *= scale;
    }

    const int n_keys = min(kKeys, t_len - s0);
    for (int sk = 0; sk < n_keys; ++sk) {
      float vv[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int d = lane + 32 * j;
        vv[j] = (d < HD) ? vs[sk * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float ps = __shfl_sync(0xffffffffu, p[i], sk);
#pragma unroll
        for (int j = 0; j < NACC; ++j) acc[i][j] = fmaf(ps, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = t0 + row0 + i;
    if (t >= t_len) continue;
    const float inv = 1.f / l[i];
    float* o = out + base + static_cast<int64_t>(t) * d_model;
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) o[d] = acc[i][j] * inv;
    }
  }
}

template <int HD, bool BIAS>
int launch(const float* q, const float* k, const float* v, const float* gate,
           const float* pos, float* out, int64_t b, int t, int d, int heads,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_kernel<HD, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kRows - 1) / kRows, heads, static_cast<unsigned>(b));
  mha_kernel<HD, BIAS><<<grid, kWarps * 32, smem, stream>>>(q, k, v, gate, pos, out, t, d,
                                                            heads);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch(const float* q, const float* k, const float* v, const float* gate,
             const float* pos, float* out, int64_t b, int t, int d, int heads,
             cudaStream_t stream) {
  switch (d / heads) {
    case 16: return launch<16, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    case 32: return launch<32, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    case 64: return launch<64, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    case 128: return launch<128, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out [B, T, D] f32 contiguous, D = heads * HD with HD in
// {16, 32, 64, 128}; gate [B, T, heads] and pos [heads, T, T] f32, both null
// for the bias-free body. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int radad_fused_mha(const float* q, const float* k, const float* v,
                               const float* gate, const float* pos, float* out,
                               int64_t b, int t, int d, int heads, void* stream) {
  if (b == 0 || t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate != nullptr)
    return dispatch<true>(q, k, v, gate, pos, out, b, t, d, heads, s);
  return dispatch<false>(q, k, v, gate, pos, out, b, t, d, heads, s);
}
