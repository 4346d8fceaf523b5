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
// D = 768, H = 12) the kernel reads q, k and v once and writes the context,
// 155.7 MB, plus gate and pos_bias, 1.1 MB: 0.0465 / 0.0469 ms at the H100
// SXM's 3.35 TB/s. Its 3.85 GFLOP of products, run three times on the TF32
// tensor cores (below), take 3 x 3.85 / 495 TFLOP/s = 0.023 ms (data sheet,
// 700 W). So it is bound by bytes. (On the f32 CUDA cores, 67 TFLOP/s, the
// operations alone took 0.058 ms: that was the bound of the SIMT design this
// one replaces.)
//
// Design:
// - Arithmetic: 3xTF32 on mma.sync m16n8k8 for both products, S = Q K^T and
//   O = P V. Every operand value is split once, where it is read, into
//   hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact); for each
//   k8 step lo.hi and hi.lo go into the f32 accumulator first, then hi.hi.
//   hi + lo holds x within 2^-22 relative, and the dropped lo.lo term is of
//   the same order, so the products are f32-grade; one TF32 product alone
//   is ~2^-11 off and misses the 1e-5 * (1 + |plain|) tolerance by 20-100x
//   (tests/test_torch_attention_tf32.py emulates both). The rounding is
//   written as two integer ops: the PTX cvt.rna.tf32.f32 measured slower.
//   The tensor core truncates when it adds into its accumulator, so O,
//   which sums over all T keys, takes each k8 step's three products in a
//   zero accumulator and adds the block sum with round-to-nearest f32 adds;
//   S keeps the products of a tile's HD / 8 steps in its accumulator.
// - Tiling: the grid runs over (query tile, head, batch row). A block of
//   kWarps warps takes 16 query rows a warp. Q stays in shared memory, and
//   each warp splits its A fragments there at each use. K and V stream
//   through shared memory in tiles of 32 keys by 16-byte cp.async copies
//   with zero-fill past T, double-buffered: tile j + 1 lands while tile j
//   is multiplied. What limits the kernel is the latency of its dependent
//   chains, not one unit's rate, so what counts is the warps an SM holds
//   (PERF.md). Measured choices
//   (experiments/fused_mha_variants.py): at most 128 registers and 70 KB
//   of shared memory put 2 blocks of 8 warps (128 rows, so K and V are
//   read once per batch row and head) on an SM, 16 warps. 4 warps a block
//   (4 blocks an SM) measured 1-2 % slower on the bias body and within
//   2 % on the bias-free one; Q split once into registers (64 more a
//   thread, 3 blocks of 4 warps) and 64-key tiles (a 32-register S tile)
//   were slower. Rows keep a stride of HD + 4 floats, so the A- and
//   B-fragment reads (Q and K: row = lane / 4, dim = lane % 4; V: key =
//   2 (lane % 4), dim = lane / 4) hit 32 distinct banks.
// - Softmax in f32 on the CUDA cores, online over the key tiles: the row max
//   and row sum over the 4 lanes of a quad that share a row of the
//   accumulator, expf, and a rescale of O when the max grows. The gated bias
//   is added to S in registers: gate[b,t,h], one register a row, times
//   pos_bias[h,t,s] read from L2 into registers, 0 past T (8-byte loads
//   where T is even; the whole [12, T, T] table stays in L2 across the
//   batch). Staged with the key tile by cp.async it measured slower; read
//   before or after the tile's products, the same.
// - P V without shuffles: the S accumulator holds columns 2c and 2c + 1 of
//   a lane's row (c = lane % 4), and the A operand of m16n8k8 wants columns
//   c and c + 4. The k order of the P V product is taken as j -> key 2j for
//   j < 4 and j -> key 2(j - 4) + 1 for j >= 4, and V's B fragment is read in
//   the same order, so P goes from the accumulator into the A operand in
//   place; the sum over keys does not depend on their order.
// - Edges: keys >= T take -inf before the row max (and zero V rows); rows
//   >= T read zeros, add no bias and are not stored; a warp whose 16 rows
//   all lie past T skips the products. Every T is right (only the key tiles
//   loop), and every HD in {16, 32, 64, 80, 128}, each a multiple of the
//   k8 depth (80, hubert-xlarge's 1,280 columns over 16 heads: ten k8 steps
//   and ten n8 fragments of O; its stride of 84 floats keeps the fragment
//   reads on 32 banks too). Shared memory above 48 KB is requested by
//   cudaFuncSetAttribute.
// No wgmma or TMA yet.
//
// bf16 bodies (mha_bf16_kernel; the mixed-precision encoders give q, k, v,
// gate and pos_bias all in bf16): the Pallas bodies form the logits in f32
// from the bf16 operands, take the softmax in f32, cast the NORMALIZED
// weights to v's dtype, accumulate P V in f32 and store the output in bf16.
// - Arithmetic: one mma.sync m16n8k16 bf16 -> f32 for each k16 step of
//   S = Q K^T and of O = P V: the operands are bf16 already and their
//   products are exact in f32, so no split. Softmax, the gate x pos_bias
//   product and its add stay f32 on the CUDA cores, as in the f32 body.
//   P goes to bf16 (RN) in place in registers: the S accumulator holds keys
//   2c, 2c + 1 (and 2c + 8, 2c + 9 in the next n8 fragment) of rows g and
//   g + 8, which is the k16 A operand's layout, so a pair of S values packs
//   into one A register. V's B fragment (keys 2c, 2c + 1, dim g) is two
//   16-bit reads of a row-major V tile. Each P V block goes into a zero
//   accumulator and is added to O with RN f32 adds, as in the f32 body (the
//   tensor core truncates when it adds; O sums over all T keys).
// - Softmax: two passes over the key tiles, not the online softmax. Pass 1
//   streams K only and takes each row's max m and sum l (online over the
//   tiles, in f32); pass 2 streams K and V again, recomputes the same S (the
//   same instructions, so the same values), forms p = exp(s - m) / l, the
//   normalized weight, and rounds it to bf16 before the P V product. That
//   is where the Pallas body rounds (w.astype(v.dtype) after the softmax);
//   the online softmax would round unnormalized weights exp(s - m_j) and
//   divide at the end, another rounding of every weight. The price is Q K^T
//   twice and K read twice, from the L2 (it is the [T, HD] slice of one
//   head); the bf16 products take a small part of the time.
// - Tiling, rings and edges as in the f32 body: 8 warps of 16 query rows a
//   block, 32-key tiles of K (and V in pass 2) double-buffered by 16-byte
//   cp.async with zero-fill past T; rows keep a stride of HD + 8 bf16 (16
//   bytes of pad), so the A and B fragment reads (row = lane / 4, 32-bit
//   word = lane % 4) and V's 16-bit reads (key = 2 (lane % 4), dim = lane /
//   4) fall on distinct banks. Every HD in _HEAD_DIMS is a multiple of k16.
// Bound at the WavLM serving shape in bf16: 78.4 MB of q, k, v, out, gate
// and pos_bias, 0.0234 ms at 3.35 TB/s, against 3.85 GFLOP (5.8 with pass
// 1's second Q K^T) at 989 TFLOP/s: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                     // 16 query rows each
constexpr int kRows = kWarps * 16;            // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 16 / kWarps;       // blocks an SM (register budget)
constexpr int kKeys = 32;                     // keys per shared-memory tile
constexpr int kKF = kKeys / 8;                // n8 key fragments of a tile
constexpr unsigned kFull = 0xffffffffu;

// floats of one stage of the ring: a K and a V tile
template <int HD>
constexpr int kStageFloats = 2 * kKeys * (HD + 4);

// the two stages of the ring, then Q
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kStageFloats<HD> + kRows * (HD + 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; zero-fills the destination if !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// x = hi + lo, each a TF32 value (10 explicit mantissa bits, the low 13 bits
// zero): round to nearest, ties away, as cvt.rna.tf32.f32, written as integer
// ops so the low bits are zero by construction; x - hi is exact in f32.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += A (16 x 8) . B (8 x 8), TF32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: the correction products lo.hi and hi.lo first, then hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// d += b with round-to-nearest f32 adds
__device__ __forceinline__ void add4(float (&d)[4], const float (&b)[4]) {
  d[0] += b[0];
  d[1] += b[1];
  d[2] += b[2];
  d[3] += b[3];
}

// The A fragment of rows g, g + 8 and columns c, c + 4 at p = &X[g][c]
// (row stride `stride` floats), split
__device__ __forceinline__ void load_a(const float* p, int stride, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(p[0], hi[0], lo[0]);
  split(p[8 * stride], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * stride + 4], hi[3], lo[3]);
}

// pos_bias[key], pos_bias[key + 1] of one row (key even); 0 past T
__device__ __forceinline__ float2 bias_pair(const float* row, int key, int t_len, bool pair) {
  if (pair && key + 1 < t_len) return *reinterpret_cast<const float2*>(row + key);
  return make_float2(key < t_len ? row[key] : 0.f, key + 1 < t_len ? row[key + 1] : 0.f);
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ gate,
           const float* __restrict__ pos, float* __restrict__ out, int t_len,
           int d_model, int heads) {
  constexpr int KS = HD + 4;        // padded row stride of Q, K and V tiles (floats)
  constexpr int KSTEPS = HD / 8;    // k8 steps of Q K^T; n8 fragments of O
  constexpr int kPer = HD / 4;      // 16-byte copies a row
  constexpr int kStage = kStageFloats<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + 2 * kStage;  // [kRows][KS]

  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;  // fragment row group, column pair
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;
  const int r0 = warp * 16;              // the warp's first row in the tile
  const int t_lo = t0 + r0 + g, t_hi = t_lo + 8;  // the lane's two query rows
  const bool active = t0 + r0 < t_len;   // warp-uniform
  const int n_tiles = (t_len + kKeys - 1) / kKeys;

  auto issue = [&](int j) {
    float* ks = smem + (j % 2) * kStage;
    float* vs = ks + kKeys * KS;
    const int s0 = j * kKeys;
    for (int i = tid; i < kKeys * kPer; i += kThreads) {
      const int r = i / kPer, col = (i % kPer) * 4;
      const bool ok = s0 + r < t_len;
      const int64_t off = ok ? base + static_cast<int64_t>(s0 + r) * d_model + col : 0;
      cp_async16(ks + r * KS + col, k + off, ok);
      cp_async16(vs + r * KS + col, v + off, ok);
    }
  };

  for (int i = tid; i < kRows * kPer; i += kThreads) {
    const int r = i / kPer, col = (i % kPer) * 4;
    const bool ok = t0 + r < t_len;
    cp_async16(qs + r * KS + col, q + (ok ? base + static_cast<int64_t>(t0 + r) * d_model + col : 0),
               ok);
  }
  issue(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float* qw = qs + (r0 + g) * KS + c;  // the lane's A-fragment origin

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float g_lo = 0.f, g_hi = 0.f;
  if (BIAS) {
    if (t_lo < t_len) g_lo = gate[(b * t_len + t_lo) * heads + h];
    if (t_hi < t_len) g_hi = gate[(b * t_len + t_hi) * heads + h];
  }
  const float* pos_lo = BIAS ? pos + (static_cast<int64_t>(h) * t_len + t_lo) * t_len : nullptr;
  const float* pos_hi = BIAS ? pos_lo + 8 * static_cast<int64_t>(t_len) : nullptr;
  const bool pair = (t_len % 2 == 0) && (reinterpret_cast<uintptr_t>(pos) % 8 == 0);

  float o[KSTEPS][4];
#pragma unroll
  for (int nd = 0; nd < KSTEPS; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) {
      cp_async_wait_all();  // tile j has landed (this thread's copies)
      __syncthreads();      // ... everyone's; tile j - 1 is consumed
    }
    if (j + 1 < n_tiles) {
      issue(j + 1);
      cp_async_commit();
    }
    if (!active) continue;
    const float* ks = smem + (j % 2) * kStage;
    const float* vs = ks + kKeys * KS;
    const int s0 = j * kKeys;
    const int nkf = min(kKF, (t_len - s0 + 7) / 8);  // key fragments holding a key < T

    // the tile's pos_bias pairs, 0 past T
    float2 pb_lo[kKF], pb_hi[kKF];
    if constexpr (BIAS) {
#pragma unroll
      for (int f = 0; f < kKF; ++f) {
        const int key = s0 + 8 * f + 2 * c;
        const float2 zero = make_float2(0.f, 0.f);
        pb_lo[f] = f < nkf && t_lo < t_len ? bias_pair(pos_lo, key, t_len, pair) : zero;
        pb_hi[f] = f < nkf && t_hi < t_len ? bias_pair(pos_hi, key, t_len, pair) : zero;
      }
    }

    // S = Q K^T; s[f] = {(g, 8f + 2c), (g, 8f + 2c + 1), (g + 8, ..), (g + 8, ..)}
    float s[kKF][4];
#pragma unroll
    for (int f = 0; f < kKF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ah[4], al[4];
      load_a(qw + 8 * kk, KS, ah, al);
#pragma unroll
      for (int f = 0; f < kKF; ++f) {
        if (f < nkf) {
          const float* kp = ks + (8 * f + g) * KS + 8 * kk + c;
          uint32_t bh[2], bl[2];
          split(kp[0], bh[0], bl[0]);
          split(kp[4], bh[1], bl[1]);
          mma3(s[f], ah, al, bh, bl);
        }
      }
    }

    // the gated bias (product rounded, then added, as the plain version),
    // keys >= T to -inf, the row max over the quad
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int f = 0; f < kKF; ++f) {
      const int key = s0 + 8 * f + 2 * c;
      if constexpr (BIAS) {
        s[f][0] = __fadd_rn(s[f][0], __fmul_rn(g_lo, pb_lo[f].x));
        s[f][1] = __fadd_rn(s[f][1], __fmul_rn(g_lo, pb_lo[f].y));
        s[f][2] = __fadd_rn(s[f][2], __fmul_rn(g_hi, pb_hi[f].x));
        s[f][3] = __fadd_rn(s[f][3], __fmul_rn(g_hi, pb_hi[f].y));
      }
      if (key >= t_len) s[f][0] = s[f][2] = -INFINITY;
      if (key + 1 >= t_len) s[f][1] = s[f][3] = -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[f][0], s[f][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[f][2], s[f][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);  // finite: key s0 < T
    const float sc_lo = expf(m_lo - mn_lo), sc_hi = expf(m_hi - mn_hi);  // 0 on the first tile
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int f = 0; f < kKF; ++f) {
      s[f][0] = expf(s[f][0] - mn_lo);
      s[f][1] = expf(s[f][1] - mn_lo);
      s[f][2] = expf(s[f][2] - mn_hi);
      s[f][3] = expf(s[f][3] - mn_hi);
      sum_lo += s[f][0] + s[f][1];
      sum_hi += s[f][2] + s[f][3];
    }
    sum_lo += __shfl_xor_sync(kFull, sum_lo, 1);
    sum_lo += __shfl_xor_sync(kFull, sum_lo, 2);
    sum_hi += __shfl_xor_sync(kFull, sum_hi, 1);
    sum_hi += __shfl_xor_sync(kFull, sum_hi, 2);
    l_lo = l_lo * sc_lo + sum_lo;
    l_hi = l_hi * sc_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int nd = 0; nd < KSTEPS; ++nd) {
      o[nd][0] *= sc_lo;
      o[nd][1] *= sc_lo;
      o[nd][2] *= sc_hi;
      o[nd][3] *= sc_hi;
    }

    // O += P V, k8 step f over keys 8f + {0, 2, 4, 6, 1, 3, 5, 7}: the A
    // operand (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4) is s[f][0, 2, 1, 3].
    // Each step's three products go into a zero accumulator and the block
    // sum into O by RN adds: the tensor core truncates when it adds, and O
    // would take 3 T / 8 truncating steps (2.9e-5 off at T = 1,500, outside
    // the tolerance, when O was the accumulator), while S takes 3 HD / 8.
#pragma unroll
    for (int f = 0; f < kKF; ++f) {
      if (f < nkf) {
        uint32_t ph[4], pl[4];
        split(s[f][0], ph[0], pl[0]);
        split(s[f][2], ph[1], pl[1]);
        split(s[f][1], ph[2], pl[2]);
        split(s[f][3], ph[3], pl[3]);
        const float* vp = vs + (8 * f + 2 * c) * KS + g;
#pragma unroll
        for (int nd = 0; nd < KSTEPS; ++nd) {
          uint32_t bh[2], bl[2];
          split(vp[8 * nd], bh[0], bl[0]);
          split(vp[8 * nd + KS], bh[1], bl[1]);
          float blk[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(blk, ph, pl, bh, bl);
          add4(o[nd], blk);
        }
      }
    }
  }
  if (!active) return;

  // O fragment: o[nd] = {(g, 8nd + 2c), (g, 8nd + 2c + 1), (g + 8, ..), (g + 8, ..)}
#pragma unroll
  for (int nd = 0; nd < KSTEPS; ++nd) {
    const int col = 8 * nd + 2 * c;
    if (t_lo < t_len)
      *reinterpret_cast<float2*>(out + base + static_cast<int64_t>(t_lo) * d_model + col) =
          make_float2(o[nd][0] / l_lo, o[nd][1] / l_lo);
    if (t_hi < t_len)
      *reinterpret_cast<float2*>(out + base + static_cast<int64_t>(t_hi) * d_model + col) =
          make_float2(o[nd][2] / l_hi, o[nd][3] / l_hi);
  }
}

template <int HD, bool BIAS>
int launch(const float* q, const float* k, const float* v, const float* gate,
           const float* pos, float* out, int64_t b, int t, int d, int heads,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mha_kernel<HD, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mha_kernel<HD, BIAS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kRows - 1) / kRows, heads, static_cast<unsigned>(b));
  mha_kernel<HD, BIAS><<<grid, kThreads, smem, stream>>>(q, k, v, gate, pos, out, t, d,
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
    case 80: return launch<80, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    case 128: return launch<128, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- bf16 bodies

using bf16 = uint16_t;  // raw bf16 bits; arithmetic is f32

// bf16 elements of one K or V tile of the bf16 ring (padded rows)
template <int HD>
constexpr int kTileBf16 = kKeys * (HD + 8);

// K ring [2], V ring [2], then Q [kRows] (bf16 rows of HD + 8)
template <int HD>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16) * (4 * kTileBf16<HD> + kRows * (HD + 8));
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ float bf16_to_f32(bf16 x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// two f32 values rounded to bf16 (RN) in one 32-bit register: lo in the low
// half (the lower column / key of an mma operand pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pair_u32(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += A (16 x 16) . B (16 x 8), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pos_bias[key], pos_bias[key + 1] of one bf16 row as f32 (key even); 0 past T
__device__ __forceinline__ float2 bias_pair_bf16(const bf16* row, int key, int t_len,
                                                 bool pair) {
  if (pair && key + 1 < t_len) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + key);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  return make_float2(key < t_len ? bf16_to_f32(row[key]) : 0.f,
                     key + 1 < t_len ? bf16_to_f32(row[key + 1]) : 0.f);
}

template <int HD, bool BIAS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mha_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ gate,
                const bf16* __restrict__ pos, bf16* __restrict__ out, int t_len,
                int d_model, int heads) {
  constexpr int RS = HD + 8;        // padded row stride of the tiles (bf16)
  constexpr int K16 = HD / 16;      // k16 steps of Q K^T
  constexpr int NF = HD / 8;        // n8 fragments of O
  constexpr int kCopies = HD / 8;   // 16-byte copies a row
  constexpr int kTile = kTileBf16<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_k = reinterpret_cast<bf16*>(smem_raw);  // [2][kKeys][RS]
  bf16* ring_v = ring_k + 2 * kTile;                  // [2][kKeys][RS]
  bf16* qtile = ring_v + 2 * kTile;                   // [kRows][RS]

  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;
  const int r0 = warp * 16;
  const int t_lo = t0 + r0 + g, t_hi = t_lo + 8;
  const bool active = t0 + r0 < t_len;  // warp-uniform
  const int n_tiles = (t_len + kKeys - 1) / kKeys;
  const int n_steps = 2 * n_tiles;      // pass 1 (K), then pass 2 (K and V)

  // step j: key tile j % n_tiles into ring slot j % 2; V only in pass 2
  auto fetch = [&](int j) {
    const int s0 = (j < n_tiles ? j : j - n_tiles) * kKeys;
    bf16* kdst = ring_k + (j % 2) * kTile;
    bf16* vdst = ring_v + (j % 2) * kTile;
    const bool with_v = j >= n_tiles;
    for (int i = tid; i < kKeys * kCopies; i += kThreads) {
      const int r = i / kCopies, col = (i % kCopies) * 8;
      const bool ok = s0 + r < t_len;
      const int64_t src = ok ? base + static_cast<int64_t>(s0 + r) * d_model + col : 0;
      cp_async16(kdst + r * RS + col, k + src, ok);
      if (with_v) cp_async16(vdst + r * RS + col, v + src, ok);
    }
  };

  for (int i = tid; i < kRows * kCopies; i += kThreads) {
    const int r = i / kCopies, col = (i % kCopies) * 8;
    const bool ok = t0 + r < t_len;
    cp_async16(qtile + r * RS + col,
               q + (ok ? base + static_cast<int64_t>(t0 + r) * d_model + col : 0), ok);
  }
  fetch(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the lane's A-fragment words: rows g and g + 8, columns 2c, 2c + 1 (+ 8)
  const bf16* qrow = qtile + (r0 + g) * RS + 2 * c;

  float g_lo = 0.f, g_hi = 0.f;
  if (BIAS) {
    if (t_lo < t_len) g_lo = bf16_to_f32(gate[(b * t_len + t_lo) * heads + h]);
    if (t_hi < t_len) g_hi = bf16_to_f32(gate[(b * t_len + t_hi) * heads + h]);
  }
  const bf16* prow_lo = BIAS ? pos + (static_cast<int64_t>(h) * t_len + t_lo) * t_len : nullptr;
  const bf16* prow_hi = BIAS ? prow_lo + 8 * static_cast<int64_t>(t_len) : nullptr;
  const bool pair = (t_len % 2 == 0) && (reinterpret_cast<uintptr_t>(pos) % 4 == 0);

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[NF][4];
#pragma unroll
  for (int nd = 0; nd < NF; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    if (j > 0) {
      cp_async_wait_all();  // step j's tiles have landed (this thread's copies)
      __syncthreads();      // ... everyone's; step j - 1's slot is free
    }
    if (j + 1 < n_steps) {
      fetch(j + 1);
      cp_async_commit();
    }
    if (!active) continue;
    const bool second = j >= n_tiles;
    const bf16* kt = ring_k + (j % 2) * kTile;
    const bf16* vt = ring_v + (j % 2) * kTile;
    const int s0 = (second ? j - n_tiles : j) * kKeys;
    const int nkf = min(kKF, (t_len - s0 + 7) / 8);  // key fragments holding a key < T

    // S = Q K^T on bf16 tensor cores; s[f] as in the f32 body
    float s[kKF][4];
#pragma unroll
    for (int f = 0; f < kKF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      const bf16* qa = qrow + 16 * kk;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(qa),
                             *reinterpret_cast<const uint32_t*>(qa + 8 * RS),
                             *reinterpret_cast<const uint32_t*>(qa + 8),
                             *reinterpret_cast<const uint32_t*>(qa + 8 * RS + 8)};
#pragma unroll
      for (int f = 0; f < kKF; ++f) {
        if (f < nkf) {
          const bf16* kb = kt + (8 * f + g) * RS + 16 * kk + 2 * c;
          mma_bf16(s[f], a, *reinterpret_cast<const uint32_t*>(kb),
                   *reinterpret_cast<const uint32_t*>(kb + 8));
        }
      }
    }

    // gate x pos_bias in f32 (product rounded, then added), keys >= T to -inf
#pragma unroll
    for (int f = 0; f < kKF; ++f) {
      const int key = s0 + 8 * f + 2 * c;
      if constexpr (BIAS) {
        const float2 zero2 = make_float2(0.f, 0.f);
        const float2 plo = f < nkf && t_lo < t_len ? bias_pair_bf16(prow_lo, key, t_len, pair) : zero2;
        const float2 phi = f < nkf && t_hi < t_len ? bias_pair_bf16(prow_hi, key, t_len, pair) : zero2;
        s[f][0] = __fadd_rn(s[f][0], __fmul_rn(g_lo, plo.x));
        s[f][1] = __fadd_rn(s[f][1], __fmul_rn(g_lo, plo.y));
        s[f][2] = __fadd_rn(s[f][2], __fmul_rn(g_hi, phi.x));
        s[f][3] = __fadd_rn(s[f][3], __fmul_rn(g_hi, phi.y));
      }
      if (key >= t_len) s[f][0] = s[f][2] = -INFINITY;
      if (key + 1 >= t_len) s[f][1] = s[f][3] = -INFINITY;
    }

    if (!second) {
      // pass 1: the row max and the row sum, online over the tiles
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int f = 0; f < kKF; ++f) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[f][0], s[f][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[f][2], s[f][3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int f = 0; f < kKF; ++f) {
        sum_lo += expf(s[f][0] - mn_lo) + expf(s[f][1] - mn_lo);
        sum_hi += expf(s[f][2] - mn_hi) + expf(s[f][3] - mn_hi);
      }
      sum_lo += __shfl_xor_sync(kFull, sum_lo, 1);
      sum_lo += __shfl_xor_sync(kFull, sum_lo, 2);
      sum_hi += __shfl_xor_sync(kFull, sum_hi, 1);
      sum_hi += __shfl_xor_sync(kFull, sum_hi, 2);
      l_lo = l_lo * expf(m_lo - mn_lo) + sum_lo;
      l_hi = l_hi * expf(m_hi - mn_hi) + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
      continue;
    }

    // pass 2: normalized weights p = exp(s - m) / l rounded to bf16, O += P V;
    // k16 step kk takes keys 16 kk .. 16 kk + 15 of the tile: A = P's
    // fragments 2 kk and 2 kk + 1 packed in place
    const int nks = min(kKF / 2, (t_len - s0 + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < kKF / 2; ++kk) {
      if (kk < nks) {
        const float(&f0)[4] = s[2 * kk];
        const float(&f1)[4] = s[2 * kk + 1];
        const uint32_t a[4] = {
            pack_bf16(expf(f0[0] - m_lo) / l_lo, expf(f0[1] - m_lo) / l_lo),
            pack_bf16(expf(f0[2] - m_hi) / l_hi, expf(f0[3] - m_hi) / l_hi),
            pack_bf16(expf(f1[0] - m_lo) / l_lo, expf(f1[1] - m_lo) / l_lo),
            pack_bf16(expf(f1[2] - m_hi) / l_hi, expf(f1[3] - m_hi) / l_hi)};
        const bf16* vb = vt + (16 * kk + 2 * c) * RS + g;
#pragma unroll
        for (int nd = 0; nd < NF; ++nd) {
          const bf16* vp = vb + 8 * nd;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(acc, a, pair_u32(vp[0], vp[RS]), pair_u32(vp[8 * RS], vp[9 * RS]));
          add4(o[nd], acc);
        }
      }
    }
  }
  if (!active) return;

  // O fragment: o[nd] = {(g, 8nd + 2c), (g, 8nd + 2c + 1), (g + 8, ..), (g + 8, ..)}
#pragma unroll
  for (int nd = 0; nd < NF; ++nd) {
    const int col = 8 * nd + 2 * c;
    if (t_lo < t_len)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_lo) * d_model + col) =
          pack_bf16(o[nd][0], o[nd][1]);
    if (t_hi < t_len)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_hi) * d_model + col) =
          pack_bf16(o[nd][2], o[nd][3]);
  }
}

template <int HD, bool BIAS>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                const bf16* pos, bf16* out, int64_t b, int t, int d, int heads,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_bf16<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mha_bf16_kernel<HD, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mha_bf16_kernel<HD, BIAS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kRows - 1) / kRows, heads, static_cast<unsigned>(b));
  mha_bf16_kernel<HD, BIAS><<<grid, kThreads, smem, stream>>>(q, k, v, gate, pos, out, t, d,
                                                              heads);
  return static_cast<int>(cudaGetLastError());
}

template <bool BIAS>
int dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                  const bf16* pos, bf16* out, int64_t b, int t, int d, int heads,
                  cudaStream_t s) {
  switch (d / heads) {
    case 16: return launch_bf16<16, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, s);
    case 32: return launch_bf16<32, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, s);
    case 64: return launch_bf16<64, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, s);
    case 80: return launch_bf16<80, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, s);
    case 128: return launch_bf16<128, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f32 bodies: q, k, v, out [B, T, D] f32 contiguous, D = heads * HD with HD in
// {16, 32, 64, 80, 128}; gate [B, T, heads] and pos [heads, T, T] f32, both null
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

// The same contract in bf16: q, k, v, out [B, T, D], gate [B, T, heads] and
// pos [heads, T, T] all bf16 (raw 16-bit values), q, k, v 16-byte aligned.
extern "C" int radad_fused_mha_bf16(const void* q, const void* k, const void* v,
                                    const void* gate, const void* pos, void* out,
                                    int64_t b, int t, int d, int heads, void* stream) {
  if (b == 0 || t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(gate),
             *pb = static_cast<const bf16*>(pos);
  bf16* ob = static_cast<bf16*>(out);
  if (gate != nullptr) return dispatch_bf16<true>(qb, kb, vb, gb, pb, ob, b, t, d, heads, s);
  return dispatch_bf16<false>(qb, kb, vb, gb, pb, ob, b, t, d, heads, s);
}
