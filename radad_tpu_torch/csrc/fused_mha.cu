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
// bf16 bodies (the mixed-precision encoders give q, k, v, gate and pos_bias
// all in bf16): the Pallas bodies form the logits in f32 from the bf16
// operands, take the softmax in f32, cast the NORMALIZED weights to v's
// dtype, accumulate P V in f32 and store the output in bf16. The forms
// below run bf16 -> f32 tensor-core products for each k16 step of S = Q K^T
// and of O = P V (bf16 products are exact in f32, so no split): mma.sync
// m16n8k16 with every fragment read by ldmatrix.x4 (.trans for V; rows of
// HD + 8 bf16 keep the eight 16-byte row addresses of each 8 x 8 matrix on
// distinct banks), or wgmma (the streamed form at HD 64). They take the
// gate x pos_bias product and its add, the softmax and e = ex2(s log2(e) -
// m log2(e)) (one FMA) in f32 on the CUDA cores, and round the weights to
// bf16 (RN) in place in registers: the S accumulator holds keys 2c, 2c + 1
// (and 2c + 8, 2c + 9 in the next n8 fragment) of rows g and g + 8, the k16
// A operand's layout (wgmma's accumulator and register A operand have
// mma.sync's layout, a warp's 16 rows each). The wrapper picks the form by shape
// (ops/attention.py::bf16_form) and passes it to the C entry, which refuses
// a form it cannot take.
// - Resident form (mha_bf16_resident_kernel; T <= 128, HD <= 80: every
//   shipped encoder's 2 s window, T = 99). A block walks batch rows of one
//   head, ceil(T / 16) warps of 16 query rows; its grid (heads, row groups)
//   is one wave at the occupancy the runtime reports. Each row's Q, K and V
//   slices of the head land in shared memory by 16-byte cp.async, the next
//   row's while this one computes (two buffers; K and Q rows past T are not
//   stored, reads past them fall into finite data of rows and keys that are
//   dropped, V's are zero). pos_bias[h] is staged once a block, flat by
//   16-byte copies and laid out in rows of a stride = 8 (mod 16), so that
//   one ldmatrix.x4 gives the bias of two key fragments in the S
//   accumulator's layout; the gate column of the next row (strided) is
//   loaded into a register before the row's copies and staged at its end.
//   A warp holds its whole row of S in registers (2 NK n8 fragments,
//   NK = 7 at T <= 112, else 8), takes the exact row max and sum in one
//   pass (the lane's fragments, then the quad; no online rescale) and
//   rounds the normalized weights p = e * (1 / l) (one reciprocal a row),
//   as the Pallas body does; each k16 block of P V goes into O by RN f32
//   adds. At T <= 112, at most 128 registers, so 2 blocks of 7 warps an SM
//   (8 warps at T > 112: one block, no register cap). What bounds it: the
//   issue of its instructions and the latency of each warp's dependent
//   chains at 14 warps an SM, more than the byte rate (PERF.md). It keeps
//   the bias body and the other head widths.
//   - HD 64 without bias (mha_bf16_resident_wgmma_kernel: wav2vec2's fused
//     check, train_bf16, trimmed Whisper): the same arithmetic on wgmma. A
//     persistent block of 2 warpgroups covers all 128 query rows of a
//     (batch row, head) and walks batch rows of its head. One thread asks
//     TMA for each row's Q, K and V boxes (tensor maps over [B, T, D], box
//     [1, tp, 64], rows past T zero-filled) into 128B-swizzled tiles, a
//     ring of 2 rows whose mbarrier reports the bytes landed, so the next
//     row's copies take no issue slots and run while this row computes.
//     S = Q K^T is one m64nNk16 wgmma a k16 step (N = T rounded up to 64,
//     104 or 128: 104 at T = 99 and 100), Q and K by descriptor, so K is
//     read from shared memory once a warpgroup, not once a warp; the exact
//     row max and sum, p = e * (1 / l) rounded to bf16 in registers as
//     above; O = P V by wgmma with P from registers and V as the transposed
//     B operand, summed in one accumulator over ceil(N / 16) k16 steps (its
//     truncating adds cost at most ~T / 16 x 2^-23 relative, far below the
//     output's bf16 rounding). O goes in bf16 into the warpgroups' own Q
//     rows (dead after S) and out by one thread's TMA stores (rows past T
//     are not written); the slot's K and V are reloaded at that barrier,
//     its Q after the next row's S, once the stores have read it. 4-byte
//     stores from the accumulator's registers were slower (PERF.md). 96 KB
//     of ring a block, so 2 blocks an SM; the time is the data path's.
// - Streamed form (T > 128, and HD 128 at any T, whose resident form would
//   not fit in shared memory): one pass over the keys in 64-key tiles with
//   an online softmax, so Q K^T runs once a logit. Per tile: S = Q K^T in
//   f32 (+ gate x pos_bias, read from L2 as in the f32 body), keys >= T to
//   -inf (last tile only), the row max m over the lane's keys and the quad,
//   O and l rescaled by ex2((m_old - m) log2(e)), e = ex2(s log2(e) -
//   m log2(e)) in place, l += the lane's e (f32, summed over the quad once
//   at the end), e rounded to bf16 in place as the A operand of O += P V,
//   accumulated in f32 across tiles; at the end O * (1 / l) in bf16. The
//   weights are rounded before the normalization (the Pallas body rounds
//   after it): an intended difference inside BF16_TOL (ROADMAP Queue 3;
//   tests/test_torch_attention_bf16.py emulates it). O sums in the tensor
//   core's accumulator, whose truncating adds cost at most ~T/16 x 2^-23
//   relative (1.1e-5 at T = 1,500), far below the output's bf16 rounding.
//   Bound at whisper-base's [B, 1500, 512], 8 heads of 64: 4 B H T^2 HD
//   operations at 989 TFLOP/s against 4 B T D x 2 bytes at 3.35 TB/s, bound
//   by operations (0.0745 ms at B = 16); the exponentials, one a logit,
//   take about as long again at an SM's 16 ex2 a clock, so the tensor cores
//   and the softmax must overlap to come near it.
//   - HD 64 (mha_bf16_wgmma_kernel: whisper-base and every shipped 64-wide
//     head): wgmma. A block takes 128 query rows of one (batch row, head):
//     2 warpgroups of 64 rows, m64n64k16 for both products. Q (once) and
//     K, V (64-key tiles, a ring of 5, 3 tiles in flight) land by 16-byte
//     cp.async in 128B-swizzled rows of 128 bytes (chunk ch of row r at
//     ch ^ (r % 8)), which wgmma reads by descriptor: S from Q and K
//     (K-major), O from P in registers and V (transposed B). One barrier a
//     tile. 109 registers, no spill, so 2 blocks (4 warpgroups) an SM,
//     whose softmax and products interleave. Designs that lost (PERF.md,
//     experiments/fused_mha_bf16_variants.py): the mma.sync body below at
//     HD 64; P V left running into the next tile, which ptxas serializes;
//     S of the next tile issued before the softmax of this one (two S
//     buffers), whose 182 registers leave one block an SM.
//   - Other widths (mha_bf16_streamed_kernel, mma.sync m16n8k16,
//     FlashAttention-2 style): 128 query rows a block, 4 warps of 32 rows
//     (two m16 tiles, so each K and V fragment read by ldmatrix feeds two
//     products) at HD <= 80, 8 warps of 16 rows at HD 128 (whose O and Q
//     fragments would not fit twice in 255 registers); Q's A fragments in
//     registers once; K and V in 64-key tiles through a ring of 3 stages,
//     ldmatrix (.trans for V) from rows of HD + 8.
// Every HD in _HEAD_DIMS is a multiple of k16. Bound at the WavLM serving
// shape in bf16: 78.4 MB of q, k, v, out, gate and pos_bias, 0.0234 ms at
// 3.35 TB/s, against 3.85 GFLOP at 989 TFLOP/s: bound by bytes.

#include <cuda.h>
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

// ------------------------------------------ bf16 resident body (T <= kResMaxT)

constexpr int kFormStreamed = 0;  // the C entry's `form`: mha_bf16_streamed_kernel
constexpr int kFormResident = 1;  // mha_bf16_resident_kernel
constexpr int kResMaxT = 128;     // the resident body's largest T (16 n8 key fragments)
constexpr int kResMaxHD = 80;     // and head width (HD 128 takes the streamed body)
constexpr int kResMinBlocks = 2;  // blocks an SM at T <= 112 (7 warps): 128 registers
constexpr int kResBuffers = 2;    // row buffers: the next batch row lands during this one
constexpr float kLog2e = 1.4426950408889634f;

// keys (and query rows) padded to whole k16 steps
__host__ __device__ constexpr int res_keys(int t) { return (t + 15) / 16 * 16; }

// pos_bias[h] in shared memory: rows of res_bias_stride(T) >= T bf16, the
// smallest = 8 (mod 16), so that ldmatrix's row addresses are 16-byte
// aligned and the eight rows of a matrix fall on distinct banks; tp rows
// (zero past T), 16 elements of slack for the last row's padded keys
__host__ __device__ constexpr int res_bias_stride(int t) { return (t + 7) / 16 * 16 + 8; }
__host__ __device__ constexpr int res_bias(int t) { return res_keys(t) * res_bias_stride(t) + 16; }

// bf16 elements of one row buffer: Q and K of T rows, V of tp rows (HD + 8
// wide). Reads of the last warp's Q rows past T fall into K, and of K's keys
// past T into V (whose rows past T are zero): finite values of rows that are
// not stored and of keys that are masked.
template <int HD>
__host__ __device__ constexpr int res_buffer(int t) {
  return (2 * t + res_keys(t)) * (HD + 8);
}

// the row buffers, then for the bias body pos_bias[h] and the gate column of
// this and the next batch row ([2][tp])
template <int HD, bool BIAS>
constexpr size_t res_smem_bytes(int t) {
  return sizeof(bf16) *
         (kResBuffers * res_buffer<HD>(t) + (BIAS ? res_bias(t) + 2 * res_keys(t) : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16-byte asynchronous copy of the first `bytes` (1 .. 16), zero-filling the rest
__device__ __forceinline__ void cp_async16_part(bf16* dst, const bf16* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Q's A fragment of k16 step kk for the 16 rows at q0 (row stride RS): rows
// g, g + 8 and columns 2c, 2c + 8 of the step; lane l names row l % 16 of
// column half l / 16
template <int RS>
__device__ __forceinline__ void frag_q(uint32_t (&a)[4], const bf16* q0, int kk, int lane) {
  ldsm_x4(a, q0 + (lane % 16) * RS + 16 * kk + 8 * (lane / 16));
}

// K's B fragments of k16 step kk for key fragments 2p (b[0], b[1]) and
// 2p + 1 (b[2], b[3]): key g, dims 2c and 2c + 8 of the step
template <int RS>
__device__ __forceinline__ void frag_k(uint32_t (&b)[4], const bf16* kt, int p, int kk,
                                       int lane) {
  ldsm_x4(b, kt + (16 * p + lane % 8 + 8 * (lane / 16)) * RS + 16 * kk + 8 * (lane / 8 % 2));
}

// V's B fragments of keys 16 kk .. 16 kk + 15 for the n8 fragments 2n (b[0],
// b[1]) and 2n + 1 (b[2], b[3]): keys 2c, 2c + 1 (+ 8) of dim g, transposed
// out of the row-major V rows
template <int RS>
__device__ __forceinline__ void frag_v(uint32_t (&b)[4], const bf16* vt, int kk, int n,
                                       int lane) {
  ldsm_x4_trans(b, vt + (16 * kk + lane % 16) * RS + 16 * n + 8 * (lane / 16));
}

// pos_bias of key fragments 2p (b[0]: rows g, b[1]: rows g + 8) and 2p + 1
// (b[2], b[3]) for the 16 rows at b0 (row stride BS): keys 2c, 2c + 1 of the
// fragment, the S accumulator's own layout
__device__ __forceinline__ void frag_bias(uint32_t (&b)[4], const bf16* b0, int bs, int p,
                                          int lane) {
  ldsm_x4(b, b0 + (lane % 16) * bs + 16 * p + 8 * (lane / 16));
}

// the two bf16 of a pair as f32 (the lower key in the low half)
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softmax's arithmetic: e = 2^(s log2(e) - m log2(e)) (one FMA and ex2),
// then p = e * (1 / l) with the reciprocal once a row
__device__ __forceinline__ float res_scale_max(float m) { return m * kLog2e; }
__device__ __forceinline__ float res_exp(float s, float ms) { return ex2(fmaf(s, kLog2e, -ms)); }
__device__ __forceinline__ float res_norm(float l) { return __frcp_rn(l); }
__device__ __forceinline__ float res_weight(float e, float n) { return e * n; }

// grid (heads, row groups): block (h, y) takes batch rows y, y + gridDim.y, ...
// of head h, ceil(T / 16) warps of 16 query rows; NK: the most k16 key steps
// (T <= 16 NK), which sizes S in registers and the block
template <int HD, bool BIAS, int NK>
__global__ void __launch_bounds__(NK * 32, NK <= 7 ? kResMinBlocks : 1)
mha_bf16_resident_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ gate,
                         const bf16* __restrict__ pos, bf16* __restrict__ out, int64_t n_rows,
                         int t_len, int d_model, int heads) {
  constexpr int RS = HD + 8;            // padded row stride (bf16): 16 bytes of pad
  constexpr int K16 = HD / 16;          // k16 steps of Q K^T
  constexpr int NF = HD / 8;            // n8 fragments of O
  constexpr int kCopies = HD / 8;       // 16-byte copies a row
  constexpr int kMaxKF = 2 * NK;        // n8 key fragments of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = res_keys(t_len);
  const int nks = tp / 16;              // k16 key steps
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);  // [kResBuffers][Q, K, V]
  bf16* bias_s = bufs + kResBuffers * res_buffer<HD>(t_len);  // [tp][bs] + slack
  bf16* gate_s = bias_s + res_bias(t_len);                     // [2][tp], 0 past T

  const int h = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = warp * 16;
  const int t_lo = r0 + g, t_hi = t_lo + 8;  // the lane's query rows, < tp
  const bool active = r0 < t_len;            // warp-uniform

  auto row_base = [&](int64_t b) { return b * t_len * static_cast<int64_t>(d_model) + h * HD; };
  // batch row b's Q, K and V slices of head h into buffer `slot`; V zero past T
  auto fetch = [&](int64_t b, int slot) {
    bf16* qd = bufs + slot * res_buffer<HD>(t_len);
    bf16* kd = qd + t_len * RS;
    bf16* vd = kd + t_len * RS;
    const int64_t base = row_base(b);
    for (int i = tid; i < tp * kCopies; i += nthreads) {
      const int r = i / kCopies, col = (i % kCopies) * 8;
      const bool ok = r < t_len;
      const int64_t src = ok ? base + static_cast<int64_t>(r) * d_model + col : 0;
      if (ok) {
        cp_async16(qd + r * RS + col, q + src, true);
        cp_async16(kd + r * RS + col, k + src, true);
      }
      cp_async16(vd + r * RS + col, v + src, ok);
    }
  };

  int b = blockIdx.y;  // batch rows <= 65,535 (the wrapper checks)
  const int stride = gridDim.y;
  // gate[b, t, h] of a batch row, thread t's element (0 past T): a strided
  // column, loaded a row ahead into a register and staged at the row's end
  auto gate_of = [&](int64_t row) {
    return BIAS && tid < t_len ? gate[(row * t_len + tid) * heads + h] : bf16(0);
  };
  if (BIAS && tid < tp) gate_s[tid] = gate_of(b);
  fetch(b, 0);
  // pos_bias[h] once a block: 16-byte copies of the flat [T, T] slice from
  // the aligned element e0 - a into the end of its region, then (after
  // every copy has landed) into rows of stride bs through registers: each
  // thread reads its 8-key chunks of the padded layout, the block waits,
  // each writes them (zero past T)
  const int bs = res_bias_stride(t_len);
  if constexpr (BIAS) {
    const int64_t e0 = static_cast<int64_t>(h) * t_len * t_len;
    const int a = static_cast<int>(e0 % 8);
    const int have = a + t_len * t_len;        // elements of the flat copy
    const int fo = res_bias(t_len) - (have + 7) / 8 * 8;  // its place, >= 0
    for (int j = tid; 8 * j < have; j += nthreads)
      cp_async16_part(bias_s + fo + 8 * j, pos + (e0 - a) + 8 * j, 2 * min(8, have - 8 * j));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int per_row = bs / 8, n_chunks = tp * per_row;  // <= (NK + 1) nthreads
    uint4 chunk[NK + 1];
    int r = tid / per_row, k0 = (tid % per_row) * 8;
#pragma unroll
    for (int u = 0; u <= NK; ++u) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < t_len) {
        const bf16* src = bias_s + fo + a + r * t_len;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k0 + e < t_len) w[e / 2] |= static_cast<uint32_t>(src[k0 + e]) << (16 * (e % 2));
      }
      chunk[u] = make_uint4(w[0], w[1], w[2], w[3]);
      k0 += (nthreads % per_row) * 8;  // the next chunk: nthreads further on
      r += nthreads / per_row + (k0 >= bs ? 1 : 0);
      if (k0 >= bs) k0 -= bs;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u <= NK; ++u) {
      const int it = tid + u * nthreads;
      if (it < n_chunks)
        *reinterpret_cast<uint4*>(bias_s + (it / per_row) * bs + (it % per_row) * 8) = chunk[u];
    }
  }
  cp_async_commit();

  for (int i = 0; b < n_rows; ++i, b += stride) {
    const int slot = i % kResBuffers;
    cp_async_wait_all();  // row b has landed (this thread's copies)
    __syncthreads();      // ... everyone's; the slot of row b - stride is consumed
    const int next = b + stride;
    const bf16 gate_next = next < n_rows ? gate_of(next) : bf16(0);  // before the copies
    if (next < n_rows) {
      fetch(next, (i + 1) % kResBuffers);
      cp_async_commit();
    }
    if (active) {
      const bf16* qw = bufs + slot * res_buffer<HD>(t_len) + r0 * RS;  // the warp's 16 Q rows
      const bf16* kt = bufs + slot * res_buffer<HD>(t_len) + t_len * RS;
      const bf16* vt = kt + t_len * RS;
      // S = Q K^T over every key at once: s[f] = {(g, 8f + 2c), (g, 8f + 2c + 1),
      // (g + 8, ..), (g + 8, ..)}
      float s[kMaxKF][4];
#pragma unroll
      for (int f = 0; f < kMaxKF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K16; ++kk) {
        uint32_t qa[4];
        frag_q<RS>(qa, qw, kk, lane);
#pragma unroll
        for (int p = 0; p < NK; ++p) {
          if (p < nks) {
            uint32_t kb[4];
            frag_k<RS>(kb, kt, p, kk, lane);
            mma_bf16(s[2 * p], qa, kb[0], kb[1]);
            mma_bf16(s[2 * p + 1], qa, kb[2], kb[3]);
          }
        }
      }

      // gate x pos_bias in f32 (product rounded, then added: the product of
      // two bf16 values is exact in f32, so one FMA rounds as the two do),
      // keys >= T to -inf, the exact row max: the lane's fragments, then the
      // quad
      float g_lo = 0.f, g_hi = 0.f;
      if constexpr (BIAS) {
        g_lo = bf16_to_f32(gate_s[(i % 2) * tp + t_lo]);
        g_hi = bf16_to_f32(gate_s[(i % 2) * tp + t_hi]);
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int p = 0; p < NK; ++p) {
        if (p < nks) {
          uint32_t pb[4];  // pos_bias of key fragments 2p and 2p + 1
          if constexpr (BIAS) frag_bias(pb, bias_s + r0 * bs, bs, p, lane);
#pragma unroll
          for (int f = 2 * p; f < 2 * p + 2; ++f) {
            const int key = 8 * f + 2 * c;
            if constexpr (BIAS) {
              const uint32_t wl = pb[2 * (f % 2)], wh = pb[2 * (f % 2) + 1];
              s[f][0] = __fmaf_rn(g_lo, lo_f32(wl), s[f][0]);
              s[f][1] = __fmaf_rn(g_lo, hi_f32(wl), s[f][1]);
              s[f][2] = __fmaf_rn(g_hi, lo_f32(wh), s[f][2]);
              s[f][3] = __fmaf_rn(g_hi, hi_f32(wh), s[f][3]);
            }
            if (8 * f + 8 > t_len) {  // the fragment holds keys >= T (warp-uniform)
              if (key >= t_len) s[f][0] = s[f][2] = -INFINITY;
              if (key + 1 >= t_len) s[f][1] = s[f][3] = -INFINITY;
            }
            mx_lo = fmaxf(mx_lo, fmaxf(s[f][0], s[f][1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[f][2], s[f][3]));
          }
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));

      // e = exp(s - m) in place and the row sum l: the lane's fragments in
      // order (a pair, then added), then the quad
      const float ms_lo = res_scale_max(mx_lo), ms_hi = res_scale_max(mx_hi);
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int f = 0; f < kMaxKF; ++f) {
        if (f / 2 < nks) {
          s[f][0] = res_exp(s[f][0], ms_lo);
          s[f][1] = res_exp(s[f][1], ms_lo);
          s[f][2] = res_exp(s[f][2], ms_hi);
          s[f][3] = res_exp(s[f][3], ms_hi);
          sum_lo += s[f][0] + s[f][1];
          sum_hi += s[f][2] + s[f][3];
        }
      }
      sum_lo += __shfl_xor_sync(kFull, sum_lo, 1);
      sum_lo += __shfl_xor_sync(kFull, sum_lo, 2);
      sum_hi += __shfl_xor_sync(kFull, sum_hi, 1);
      sum_hi += __shfl_xor_sync(kFull, sum_hi, 2);
      const float n_lo = res_norm(sum_lo), n_hi = res_norm(sum_hi);

      // the normalized weights rounded to bf16, packed in place into the k16
      // A operands of P V (fragments 2 kk and 2 kk + 1)
      uint32_t pa[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (kk < nks) {
          pa[kk][0] = pack_bf16(res_weight(s[2 * kk][0], n_lo), res_weight(s[2 * kk][1], n_lo));
          pa[kk][1] = pack_bf16(res_weight(s[2 * kk][2], n_hi), res_weight(s[2 * kk][3], n_hi));
          pa[kk][2] = pack_bf16(res_weight(s[2 * kk + 1][0], n_lo),
                                res_weight(s[2 * kk + 1][1], n_lo));
          pa[kk][3] = pack_bf16(res_weight(s[2 * kk + 1][2], n_hi),
                                res_weight(s[2 * kk + 1][3], n_hi));
        }
      }

      // O = P V, two n8 fragments (16 dims) at a time: each k16 block into a
      // zero accumulator, added with RN f32 adds; the pair stored in bf16
#pragma unroll
      for (int n = 0; n < NF / 2; ++n) {
        float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (kk < nks) {
            uint32_t vb[4];
            frag_v<RS>(vb, vt, kk, n, lane);
            float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(acc0, pa[kk], vb[0], vb[1]);
            mma_bf16(acc1, pa[kk], vb[2], vb[3]);
            add4(o0, acc0);
            add4(o1, acc1);
          }
        }
        if (t_lo < t_len) {
          bf16* row = out + row_base(b) + static_cast<int64_t>(t_lo) * d_model + 16 * n + 2 * c;
          *reinterpret_cast<uint32_t*>(row) = pack_bf16(o0[0], o0[1]);
          *reinterpret_cast<uint32_t*>(row + 8) = pack_bf16(o1[0], o1[1]);
        }
        if (t_hi < t_len) {
          bf16* row = out + row_base(b) + static_cast<int64_t>(t_hi) * d_model + 16 * n + 2 * c;
          *reinterpret_cast<uint32_t*>(row) = pack_bf16(o0[2], o0[3]);
          *reinterpret_cast<uint32_t*>(row + 8) = pack_bf16(o1[2], o1[3]);
        }
      }
    }
    // the next row's gate; its slot was last read before this row's barrier
    if (BIAS && tid < tp) gate_s[((i + 1) % 2) * tp + tid] = gate_next;
  }
}

// Shared memory above 48 KB for the largest T; the grid:
// one wave of blocks (the SM count times the blocks an SM holds at this T),
// spread over the heads, each walking its share of the batch rows
template <int HD, bool BIAS, int NK>
int launch_resident_nk(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                       const bf16* pos, bf16* out, int64_t b, int t, int d, int heads,
                       cudaStream_t stream) {
  constexpr size_t most = res_smem_bytes<HD, BIAS>(16 * NK);
  if (most > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mha_bf16_resident_kernel<HD, BIAS, NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(most));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mha_bf16_resident_kernel<HD, BIAS, NK>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = res_smem_bytes<HD, BIAS>(t);
  const int threads = 32 * ((t + 15) / 16);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mha_bf16_resident_kernel<HD, BIAS, NK>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t groups = (static_cast<int64_t>(sms) * per_sm + heads - 1) / heads;
  if (groups > b) groups = b;
  const dim3 grid(heads, static_cast<unsigned>(groups));
  mha_bf16_resident_kernel<HD, BIAS, NK><<<grid, threads, smem, stream>>>(
      q, k, v, gate, pos, out, b, t, d, heads);
  return static_cast<int>(cudaGetLastError());
}

// 7 k16 key steps (T <= 112, every shipped encoder) or 8
template <int HD, bool BIAS>
int launch_resident(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                    const bf16* pos, bf16* out, int64_t b, int t, int d, int heads,
                    cudaStream_t stream) {
  if (t <= 112)
    return launch_resident_nk<HD, BIAS, 7>(q, k, v, gate, pos, out, b, t, d, heads, stream);
  return launch_resident_nk<HD, BIAS, 8>(q, k, v, gate, pos, out, b, t, d, heads, stream);
}

// ------------------------------------------------- bf16 streamed body (any T)

constexpr int kStrKeys = 64;              // keys of a K / V tile
constexpr int kStrKF = kStrKeys / 8;      // n8 key fragments of a tile
constexpr int kStrStages = 3;             // tiles in the cp.async ring
constexpr int kStrRows = 128;             // query rows a block
constexpr int kStrMinBlocks = 2;          // blocks an SM at HD <= 80

// m16 row tiles a warp: 2 at HD <= 80 (a K or V fragment feeds two
// products), 1 at HD 128; warps a block
template <int HD>
__host__ __device__ constexpr int str_mi() { return HD <= 80 ? 2 : 1; }
template <int HD>
__host__ __device__ constexpr int str_warps() { return kStrRows / (16 * str_mi<HD>()); }

// the ring ([kStrStages][K tile, V tile]), then Q, rows of HD + 8 bf16
template <int HD>
constexpr size_t str_smem_bytes() {
  return sizeof(bf16) * (kStrStages * 2 * kStrKeys + kStrRows) * (HD + 8);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid (query tiles, heads, batch rows)
template <int HD, bool BIAS>
__global__ void __launch_bounds__(32 * str_warps<HD>(), HD <= 80 ? kStrMinBlocks : 1)
mha_bf16_streamed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ gate,
                         const bf16* __restrict__ pos, bf16* __restrict__ out, int t_len,
                         int d_model, int heads) {
  constexpr int RS = HD + 8;            // padded row stride (bf16)
  constexpr int K16 = HD / 16;          // k16 steps of Q K^T
  constexpr int NF = HD / 8;            // n8 fragments of O
  constexpr int MI = str_mi<HD>();      // m16 row tiles a warp
  constexpr int kBlock = 32 * str_warps<HD>();  // threads
  constexpr int kCopies = HD / 8;       // 16-byte copies a row
  constexpr int kTile = kStrKeys * RS;  // bf16 of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qtile = ring + kStrStages * 2 * kTile;  // [kStrRows][RS]

  const int t0 = blockIdx.x * kStrRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;
  const int r0 = warp * 16 * MI;         // the warp's first row in the block
  const bool active = t0 + r0 < t_len;   // warp-uniform
  const int n_tiles = (t_len + kStrKeys - 1) / kStrKeys;

  // key tile j into ring slot j % kStrStages, zero past T
  auto fetch = [&](int j) {
    bf16* kd = ring + (j % kStrStages) * 2 * kTile;
    bf16* vd = kd + kTile;
    const int s0 = j * kStrKeys;
    for (int i = tid; i < kStrKeys * kCopies; i += kBlock) {
      const int r = i / kCopies, col = (i % kCopies) * 8;
      const bool ok = s0 + r < t_len;
      const int64_t src = ok ? base + static_cast<int64_t>(s0 + r) * d_model + col : 0;
      cp_async16(kd + r * RS + col, k + src, ok);
      cp_async16(vd + r * RS + col, v + src, ok);
    }
  };

  // groups: Q, then tiles 0 .. kStrStages - 2 (each committed, maybe empty)
  for (int i = tid; i < kStrRows * kCopies; i += kBlock) {
    const int r = i / kCopies, col = (i % kCopies) * 8;
    const bool ok = t0 + r < t_len;
    cp_async16(qtile + r * RS + col,
               q + (ok ? base + static_cast<int64_t>(t0 + r) * d_model + col : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStrStages - 1; ++j) {
    if (j < n_tiles) fetch(j);
    cp_async_commit();
  }
  cp_async_wait<kStrStages - 1>();  // Q has landed (this thread's copies)
  __syncthreads();                  // ... everyone's

  // Q's A fragments, once: m16 tile i holds rows r0 + 16 i .. r0 + 16 i + 15
  uint32_t qa[MI][K16][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) frag_q<RS>(qa[i][kk], qtile + (r0 + 16 * i) * RS, kk, lane);

  // the lane's rows: t0 + r0 + 16 i + g (lo) and + 8 (hi)
  float g_lo[MI], g_hi[MI];
  const bf16* prow_lo[MI];
  const bf16* prow_hi[MI];
  const bool pair = (t_len % 2 == 0) && (reinterpret_cast<uintptr_t>(pos) % 4 == 0);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int t_lo = t0 + r0 + 16 * i + g, t_hi = t_lo + 8;
    g_lo[i] = g_hi[i] = 0.f;
    prow_lo[i] = prow_hi[i] = nullptr;
    if constexpr (BIAS) {
      if (t_lo < t_len) {
        g_lo[i] = bf16_to_f32(gate[(b * t_len + t_lo) * heads + h]);
        prow_lo[i] = pos + (static_cast<int64_t>(h) * t_len + t_lo) * t_len;
      }
      if (t_hi < t_len) {
        g_hi[i] = bf16_to_f32(gate[(b * t_len + t_hi) * heads + h]);
        prow_hi[i] = pos + (static_cast<int64_t>(h) * t_len + t_hi) * t_len;
      }
    }
  }

  float m[MI][2], l[MI][2], o[MI][NF][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < NF; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][nd][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStrStages - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; tile j - 1's slot is free
    if (j + kStrStages - 1 < n_tiles) fetch(j + kStrStages - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* kt = ring + (j % kStrStages) * 2 * kTile;
    const bf16* vt = kt + kTile;
    const int s0 = j * kStrKeys;

    // S = Q K^T: s[i][f] = {(g, 8f + 2c), (g, 8f + 2c + 1), (g + 8, ..), (g + 8, ..)}
    // of m16 tile i, keys of the tile
    float s[MI][kStrKF][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int f = 0; f < kStrKF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][f][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
#pragma unroll
      for (int p = 0; p < kStrKF / 2; ++p) {
        uint32_t kb[4];
        frag_k<RS>(kb, kt, p, kk, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(s[i][2 * p], qa[i][kk], kb[0], kb[1]);
          mma_bf16(s[i][2 * p + 1], qa[i][kk], kb[2], kb[3]);
        }
      }
    }

    const bool edge = s0 + kStrKeys > t_len;  // the tile holds keys >= T (uniform)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      // gate x pos_bias (product exact in f32, so one FMA rounds as the
      // plain version's multiply and add), keys >= T to -inf, the row max
#pragma unroll
      for (int f = 0; f < kStrKF; ++f) {
        const int key = s0 + 8 * f + 2 * c;
        if constexpr (BIAS) {
          const float2 zero2 = make_float2(0.f, 0.f);
          const float2 plo = prow_lo[i] ? bias_pair_bf16(prow_lo[i], key, t_len, pair) : zero2;
          const float2 phi = prow_hi[i] ? bias_pair_bf16(prow_hi[i], key, t_len, pair) : zero2;
          s[i][f][0] = __fmaf_rn(g_lo[i], plo.x, s[i][f][0]);
          s[i][f][1] = __fmaf_rn(g_lo[i], plo.y, s[i][f][1]);
          s[i][f][2] = __fmaf_rn(g_hi[i], phi.x, s[i][f][2]);
          s[i][f][3] = __fmaf_rn(g_hi[i], phi.y, s[i][f][3]);
        }
        if (edge) {
          if (key >= t_len) s[i][f][0] = s[i][f][2] = -INFINITY;
          if (key + 1 >= t_len) s[i][f][1] = s[i][f][3] = -INFINITY;
        }
      }
      float mx_lo = m[i][0], mx_hi = m[i][1];
#pragma unroll
      for (int f = 0; f < kStrKF; ++f) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[i][f][0], s[i][f][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[i][f][2], s[i][f][3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));
      // finite: the tile's first key is < T. 0 on the first tile (m = -inf)
      const float sc_lo = ex2((m[i][0] - mx_lo) * kLog2e);
      const float sc_hi = ex2((m[i][1] - mx_hi) * kLog2e);
      m[i][0] = mx_lo;
      m[i][1] = mx_hi;
#pragma unroll
      for (int nd = 0; nd < NF; ++nd) {
        o[i][nd][0] *= sc_lo;
        o[i][nd][1] *= sc_lo;
        o[i][nd][2] *= sc_hi;
        o[i][nd][3] *= sc_hi;
      }
      // e = ex2(s log2(e) - m log2(e)) in place; the lane's l in key order
      const float ms_lo = res_scale_max(mx_lo), ms_hi = res_scale_max(mx_hi);
      float sum_lo = l[i][0] * sc_lo, sum_hi = l[i][1] * sc_hi;
#pragma unroll
      for (int f = 0; f < kStrKF; ++f) {
        s[i][f][0] = res_exp(s[i][f][0], ms_lo);
        s[i][f][1] = res_exp(s[i][f][1], ms_lo);
        s[i][f][2] = res_exp(s[i][f][2], ms_hi);
        s[i][f][3] = res_exp(s[i][f][3], ms_hi);
        sum_lo += s[i][f][0] + s[i][f][1];
        sum_hi += s[i][f][2] + s[i][f][3];
      }
      l[i][0] = sum_lo;
      l[i][1] = sum_hi;
    }

    // O += P V: k16 step kk takes the tile's keys 16 kk .. 16 kk + 15, A = e
    // of fragments 2 kk and 2 kk + 1 rounded to bf16 in place; two n8
    // fragments of O (16 dims) a V ldmatrix
#pragma unroll
    for (int kk = 0; kk < kStrKF / 2; ++kk) {
      uint32_t pa[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        pa[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
        pa[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
        pa[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
        pa[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NF / 2; ++n) {
        uint32_t vb[4];
        frag_v<RS>(vb, vt, kk, n, lane);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(o[i][2 * n], pa[i], vb[0], vb[1]);
          mma_bf16(o[i][2 * n + 1], pa[i], vb[2], vb[3]);
        }
      }
    }
  }
  if (!active) return;

  // l over the quad ((l0 + l1) + (l2 + l3)), O * (1 / l) in bf16
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float l_lo = l[i][0], l_hi = l[i][1];
    l_lo += __shfl_xor_sync(kFull, l_lo, 1);
    l_lo += __shfl_xor_sync(kFull, l_lo, 2);
    l_hi += __shfl_xor_sync(kFull, l_hi, 1);
    l_hi += __shfl_xor_sync(kFull, l_hi, 2);
    const float n_lo = res_norm(l_lo), n_hi = res_norm(l_hi);
    const int t_lo = t0 + r0 + 16 * i + g, t_hi = t_lo + 8;
#pragma unroll
    for (int nd = 0; nd < NF; ++nd) {
      const int col = 8 * nd + 2 * c;
      if (t_lo < t_len)
        *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_lo) * d_model + col) =
            pack_bf16(o[i][nd][0] * n_lo, o[i][nd][1] * n_lo);
      if (t_hi < t_len)
        *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_hi) * d_model + col) =
            pack_bf16(o[i][nd][2] * n_hi, o[i][nd][3] * n_hi);
    }
  }
}

template <int HD, bool BIAS>
int launch_streamed(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                    const bf16* pos, bf16* out, int64_t b, int t, int d, int heads,
                    cudaStream_t stream) {
  constexpr size_t smem = str_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mha_bf16_streamed_kernel<HD, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mha_bf16_streamed_kernel<HD, BIAS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((t + kStrRows - 1) / kStrRows, heads, static_cast<unsigned>(b));
  mha_bf16_streamed_kernel<HD, BIAS><<<grid, 32 * str_warps<HD>(), smem, stream>>>(
      q, k, v, gate, pos, out, t, d, heads);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------- bf16 streamed body on wgmma (HD 64 only)

constexpr int kWgKeys = 64;                   // keys of a K / V tile
constexpr int kWgStages = 5;                  // tiles in the cp.async ring
constexpr int kWgAhead = kWgStages - 2;       // tiles fetched ahead of the one in use
constexpr int kWgRows = 128;                  // query rows a block: 2 warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kWgTile = kWgKeys * 64;         // bf16 of a K or V tile (128-byte rows)
// the ring, Q, and 1,024 bytes to align both to the swizzle pattern
constexpr size_t kWgSmem = sizeof(bf16) * (kWgStages * 2 * kWgTile + kWgRows * 64) + 1024;
static_assert(kWgKeys * 8 % kWgThreads == 0 && kWgRows * 8 % kWgThreads == 0,
              "a tile's 16-byte copies spread evenly over the threads");

// element offset of 16-byte chunk ch of row r in a tile of 128-byte rows,
// 128B-swizzled: chunk ch ^ (r % 8) of the row (rows 1,024-byte aligned in
// groups of 8, as the hardware's pattern repeats)
__device__ __forceinline__ int sw128(int r, int ch) { return r * 64 + 8 * (ch ^ (r % 8)); }

// wgmma descriptor of a 128B-swizzled tile at p (a 1,024-byte aligned group
// of 8 rows, or an offset of k16 steps inside its rows): start address,
// leading byte offset 1 (not read for these layouts), stride byte offset
// 1,024 (from one group of 8 rows to the next: Q's and K's rows, V's keys),
// swizzle 128B
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across a
// wgmma wait or issue
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) asm volatile("" : "+f"(d[e])::"memory");
}
// this thread's writes to shared memory (cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = A (64 x 16) . B (16 x 64) (ACC false: d only written) or d += A . B,
// both K-major in shared memory by descriptor (Q's rows, K's rows); f32
// accumulator in the layout of 8 m16n8 fragments of the warp's 16 rows:
// d[4 j + e] is the mma.sync body's s[j][e]
template <bool ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d += A (64 x 16, bf16 registers: the warp's 16 rows in mma.sync's A
// layout) . B (16 x 64) stored as K rows of N (V's keys; transposed)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// grid (query tiles, heads, batch rows); HD = 64: one 128-byte swizzle row
// a Q, K or V row. ptxas serializes every wgmma of a kernel where one of
// them sits on a divergent path, where registers that a running wgmma
// reads or writes are copied or defined (the compiler copies loop-carried
// registers at a loop's entry and back edge) or where registers run short.
// So: no branch around a wgmma, a wait or a copy (every warpgroup
// computes, also one whose rows all lie past T; copies past the last tile
// zero-fill), nothing in flight across the loop's back edge, O's and P's
// registers settled before each issue, and at most 128 registers.
template <bool BIAS>
__global__ void __launch_bounds__(kWgThreads, 2)
mha_bf16_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ gate,
                      const bf16* __restrict__ pos, bf16* __restrict__ out, int t_len,
                      int d_model, int heads) {
  constexpr int HD = 64;
  constexpr int K16 = HD / 16;           // k16 steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024);
  bf16* qs = ring + kWgStages * 2 * kWgTile;  // [kWgRows][64], swizzled

  const int t0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4, ch = tid % 8;
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;
  const bf16* qw = qs + (warp / 4) * 64 * 64;  // the warpgroup's 64 rows of Q
  const int n_tiles = (t_len + kWgKeys - 1) / kWgKeys;

  // key tile j into ring slot j % kWgStages, zero past T (all of it for
  // j >= n_tiles); thread tid copies chunk tid % 8 of rows tid / 8 + 32 u
  auto fetch = [&](int j) {
    bf16* kd = ring + (j % kWgStages) * 2 * kWgTile;
    const int s0 = j * kWgKeys;
#pragma unroll
    for (int u = 0; u < kWgKeys * 8 / kWgThreads; ++u) {
      const int r = (tid + u * kWgThreads) / 8;
      const bool ok = s0 + r < t_len;
      const int64_t at = ok ? base + static_cast<int64_t>(s0 + r) * d_model + 8 * ch : 0;
      cp_async16(kd + sw128(r, ch), k + at, ok);
      cp_async16(kd + kWgTile + sw128(r, ch), v + at, ok);
    }
  };

  // groups: Q with tile 0, then tiles 1 .. kWgAhead - 1
#pragma unroll
  for (int u = 0; u < kWgRows * 8 / kWgThreads; ++u) {
    const int r = (tid + u * kWgThreads) / 8;
    const bool ok = t0 + r < t_len;
    cp_async16(qs + sw128(r, ch),
               q + (ok ? base + static_cast<int64_t>(t0 + r) * d_model + 8 * ch : 0), ok);
  }
#pragma unroll
  for (int j = 0; j < kWgAhead; ++j) {
    fetch(j);
    cp_async_commit();
  }

  const int t_lo = t0 + 16 * warp + g, t_hi = t_lo + 8;  // the lane's rows
  float g_lo = 0.f, g_hi = 0.f;
  const bf16* prow_lo = nullptr;
  const bf16* prow_hi = nullptr;
  const bool pair = (t_len % 2 == 0) && (reinterpret_cast<uintptr_t>(pos) % 4 == 0);
  if constexpr (BIAS) {
    if (t_lo < t_len) {
      g_lo = bf16_to_f32(gate[(b * t_len + t_lo) * heads + h]);
      prow_lo = pos + (static_cast<int64_t>(h) * t_len + t_lo) * t_len;
    }
    if (t_hi < t_len) {
      g_hi = bf16_to_f32(gate[(b * t_len + t_hi) * heads + h]);
      prow_hi = pos + (static_cast<int64_t>(h) * t_len + t_hi) * t_len;
    }
  }
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float s[32], o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = o[e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kWgAhead - 1>();  // tile j has landed (this thread's copies)
    fence_async_smem();
    __syncthreads();  // ... everyone's; every warpgroup's P V(j - 2) is done
    fetch(j + kWgAhead);  // into the slot of tile j - 2
    cp_async_commit();
    const bf16* kt = ring + (j % kWgStages) * 2 * kWgTile;
    const bf16* vt = kt + kWgTile;

    // S = Q K^T: four k16 steps, each 32 bytes further along the rows of Q
    // and of K
    wg_fence();
    wgmma_ss<false>(s, sw128_desc(qw), sw128_desc(kt));
#pragma unroll
    for (int kk = 1; kk < K16; ++kk)
      wgmma_ss<true>(s, sw128_desc(qw + 16 * kk), sw128_desc(kt + 16 * kk));
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // gate x pos_bias, keys >= T to -inf, the row max
    const int s0 = j * kWgKeys;
    const bool edge = s0 + kWgKeys > t_len;  // the last tile (uniform)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int key = s0 + 8 * f + 2 * c;
      float* sf = s + 4 * f;
      if constexpr (BIAS) {
        const float2 zero2 = make_float2(0.f, 0.f);
        const float2 plo = prow_lo ? bias_pair_bf16(prow_lo, key, t_len, pair) : zero2;
        const float2 phi = prow_hi ? bias_pair_bf16(prow_hi, key, t_len, pair) : zero2;
        sf[0] = __fmaf_rn(g_lo, plo.x, sf[0]);
        sf[1] = __fmaf_rn(g_lo, plo.y, sf[1]);
        sf[2] = __fmaf_rn(g_hi, phi.x, sf[2]);
        sf[3] = __fmaf_rn(g_hi, phi.y, sf[3]);
      }
      if (edge) {
        if (key >= t_len) sf[0] = sf[2] = -INFINITY;
        if (key + 1 >= t_len) sf[1] = sf[3] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sf[0], sf[1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sf[2], sf[3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));
    // O and l to the new max (0 on the first tile: m = -inf)
    const float sc_lo = ex2((m_lo - mx_lo) * kLog2e), sc_hi = ex2((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      o[4 * f] *= sc_lo;
      o[4 * f + 1] *= sc_lo;
      o[4 * f + 2] *= sc_hi;
      o[4 * f + 3] *= sc_hi;
    }
    // e = ex2(s log2(e) - m log2(e)) in place; the lane's l in key order
    const float ms_lo = res_scale_max(mx_lo), ms_hi = res_scale_max(mx_hi);
    float sum_lo = l_lo * sc_lo, sum_hi = l_hi * sc_hi;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      float* sf = s + 4 * f;
      sf[0] = res_exp(sf[0], ms_lo);
      sf[1] = res_exp(sf[1], ms_lo);
      sf[2] = res_exp(sf[2], ms_hi);
      sf[3] = res_exp(sf[3], ms_hi);
      sum_lo += sf[0] + sf[1];
      sum_hi += sf[2] + sf[3];
    }
    l_lo = sum_lo;
    l_hi = sum_hi;

    // O += P V, left running into the next tile: k16 step kk takes keys
    // 16 kk .. 16 kk + 15 (A: e of fragments 2 kk and 2 kk + 1 rounded to
    // bf16), V's keys 16 kk on (2,048 bytes a step)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O's rescale and P's packing done before the fence (ptxas serializes
    // a kernel whose accumulators are written between fence and wgmma)
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(o, pa[kk], sw128_desc(vt + 16 * kk * 64));
    wg_commit();
    wg_wait_all();  // nothing in flight across the loop's back edge (see above)
    fence_regs(o);
  }

  l_lo += __shfl_xor_sync(kFull, l_lo, 1);
  l_lo += __shfl_xor_sync(kFull, l_lo, 2);
  l_hi += __shfl_xor_sync(kFull, l_hi, 1);
  l_hi += __shfl_xor_sync(kFull, l_hi, 2);
  const float n_lo = res_norm(l_lo), n_hi = res_norm(l_hi);
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int col = 8 * f + 2 * c;
    if (t_lo < t_len)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_lo) * d_model + col) =
          pack_bf16(o[4 * f] * n_lo, o[4 * f + 1] * n_lo);
    if (t_hi < t_len)
      *reinterpret_cast<uint32_t*>(out + base + static_cast<int64_t>(t_hi) * d_model + col) =
          pack_bf16(o[4 * f + 2] * n_hi, o[4 * f + 3] * n_hi);
  }
}

template <bool BIAS>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* gate, const bf16* pos,
                 bf16* out, int64_t b, int t, int d, int heads, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(mha_bf16_wgmma_kernel<BIAS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kWgSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mha_bf16_wgmma_kernel<BIAS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t + kWgRows - 1) / kWgRows, heads, static_cast<unsigned>(b));
  mha_bf16_wgmma_kernel<BIAS><<<grid, kWgThreads, kWgSmem, stream>>>(q, k, v, gate, pos, out, t,
                                                                      d, heads);
  return static_cast<int>(cudaGetLastError());
}

// --------------- bf16 resident body on wgmma (HD 64, no bias, T <= 128)

constexpr int kFormResidentMma = 2;  // the C entry's `form`: mha_bf16_resident_kernel also
                                     // where the wgmma one below runs (to time the two
                                     // side by side; the wrapper never passes it)
constexpr int kRwThreads = 256;      // 2 warpgroups: the 128 query rows of a batch row
constexpr int kRwRing = 2;           // batch rows in the TMA ring
constexpr int kRwTile = kResMaxT * 64;  // bf16 of a Q, K or V tile: 128 rows of 128 bytes
// the ring ([kRwRing][Q, K, V]) and 1,024 bytes to align it to the swizzle pattern
constexpr size_t kRwSmem = sizeof(bf16) * kRwRing * 3 * kRwTile + 1024;

// d += A (64 x 16) . B (16 x 104), both K-major in shared memory by descriptor
__device__ __forceinline__ void wgmma_ss104(float (&d)[52], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A (64 x 16) . B (16 x 128), both K-major in shared memory by descriptor
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// S += Q K^T for one k16 step at N keys (64, 104 or 128)
template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_ss<true>(d, desc_a, desc_b);
  else if constexpr (N == 104)
    wgmma_ss104(d, desc_a, desc_b);
  else
    wgmma_ss128(d, desc_a, desc_b);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the mbarrier at `bar` has
// completed; a copy that never lands traps (an error the wrapper raises)
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 24)) __trap();
  }
}

// TMA store: shared memory at src into the box at (c0, c1, c2) of the
// tensor map (elements out of its bounds are not written), in a bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const bf16* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// TMA: the box at (c0, c1, c2) of the tensor map into shared memory at dst,
// completion reported to the mbarrier at `bar` (as transaction bytes)
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// grid (heads, row groups): block (h, y) takes batch rows y, y + gridDim.y,
// ... of head h, all 128 query rows of each (2 warpgroups of 64). The tensor
// maps view q, k and v as [B, T, D] with a box of [1, tp, 64] (one head's
// columns of tp = T rounded up to 16 rows; rows past T come zero-filled)
// and the 128B swizzle that wgmma reads. N: the keys of S (T rounded up to
// 64, 104 or 128). Written as mha_bf16_wgmma_kernel's loop is, for ptxas:
// no branch around a wgmma or its wait, nothing in flight across the loop's
// back edge, the accumulators settled before each issue, <= 128 registers.
template <int N>
__global__ void __launch_bounds__(kRwThreads, 2)
mha_bf16_resident_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to, int n_rows, int t_len) {
  constexpr int NF = N / 8;          // n8 key fragments of S
  constexpr int NP = (N + 15) / 16;  // k16 steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRwRing];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int wg = warp / 4, r_lo = 16 * (warp % 4) + g;  // the lane's rows r_lo, r_lo + 8 of its
                                                        // warpgroup's 64
  const uint32_t bytes = 3u * res_keys(t_len) * 128u;  // a batch row's three boxes

  // every tile zero once, so every value wgmma reads is finite: K and V
  // rows past a box's tp rows stay zero (V rows past T meet weights of 0);
  // Q rows past tp hold zeros or an earlier row's O (rows not stored)
  for (int i = tid; i < kRwRing * 3 * kRwTile / 8; i += kRwThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRwRing; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();  // the zeros before the copies (async proxy)
  __syncthreads();

  const int stride = gridDim.y;
  const CUtensorMap* maps[3] = {&tq, &tk, &tv};
  // thread 0: box j (0 Q, 1 K, 2 V) of batch row b into ring slot `slot`
  auto load = [&](int j, int b, int slot) {
    tma_load(ring + (3 * slot + j) * kRwTile, maps[j], 64 * h, 0, b, smem_u32(&full[slot]));
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kRwRing; ++s) {
      if (blockIdx.y + s * stride < n_rows) {
        mbar_expect_tx(smem_u32(&full[s]), bytes);
#pragma unroll
        for (int j = 0; j < 3; ++j) load(j, blockIdx.y + s * stride, s);
      }
    }
  }

  int i = 0;
  for (int b = blockIdx.y; b < n_rows; b += stride, ++i) {
    const int slot = i % kRwRing;
    mbar_wait(smem_u32(&full[slot]), (i / kRwRing) & 1);
    bf16* qw = ring + slot * 3 * kRwTile + wg * 64 * 64;  // the warpgroup's rows of Q
    const bf16* kt = ring + slot * 3 * kRwTile + kRwTile;
    const bf16* vt = kt + kRwTile;

    // S = Q K^T over every key at once: four k16 steps, 32 bytes further
    // along the rows of Q and of K each; s[4 f + e] is the mma.sync body's
    // s[f][e]: keys 8 f + 2 c (+ 1) of rows g (e < 2) and g + 8
    float s[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[e] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s<N>(s, sw128_desc(qw + 16 * kk), sw128_desc(kt + 16 * kk));
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    // the next row's Q box, into the other slot's Q rows once the stores of
    // the last row's O have read them (long done: a row's S came between)
    if (tid == 0 && i > 0 && b + stride < n_rows) {
      tma_store_wait_read();
      load(0, b + stride, slot ^ 1);
    }

    // keys >= T to -inf, the exact row max: the lane's fragments, then the quad
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float* sf = s + 4 * f;
      const int key = 8 * f + 2 * c;
      if (8 * f + 8 > t_len) {  // the fragment holds keys >= T (uniform)
        if (key >= t_len) sf[0] = sf[2] = -INFINITY;
        if (key + 1 >= t_len) sf[1] = sf[3] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sf[0], sf[1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sf[2], sf[3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));

    // e = exp(s - m) in place and the row sum l: the lane's fragments in
    // order (a pair, then added), then the quad
    const float ms_lo = res_scale_max(mx_lo), ms_hi = res_scale_max(mx_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float* sf = s + 4 * f;
      sf[0] = res_exp(sf[0], ms_lo);
      sf[1] = res_exp(sf[1], ms_lo);
      sf[2] = res_exp(sf[2], ms_hi);
      sf[3] = res_exp(sf[3], ms_hi);
      sum_lo += sf[0] + sf[1];
      sum_hi += sf[2] + sf[3];
    }
    sum_lo += __shfl_xor_sync(kFull, sum_lo, 1);
    sum_lo += __shfl_xor_sync(kFull, sum_lo, 2);
    sum_hi += __shfl_xor_sync(kFull, sum_hi, 1);
    sum_hi += __shfl_xor_sync(kFull, sum_hi, 2);
    const float n_lo = res_norm(sum_lo), n_hi = res_norm(sum_hi);

    // the normalized weights rounded to bf16, as the A operands of P V: k16
    // step kk takes fragments 2 kk and 2 kk + 1 (0 past N)
    uint32_t pa[NP][4];
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      const float* s0 = s + 8 * kk;
      pa[kk][0] = pack_bf16(res_weight(s0[0], n_lo), res_weight(s0[1], n_lo));
      pa[kk][1] = pack_bf16(res_weight(s0[2], n_hi), res_weight(s0[3], n_hi));
      if (2 * kk + 1 < NF) {
        pa[kk][2] = pack_bf16(res_weight(s0[4], n_lo), res_weight(s0[5], n_lo));
        pa[kk][3] = pack_bf16(res_weight(s0[6], n_hi), res_weight(s0[7], n_hi));
      } else {
        pa[kk][2] = pa[kk][3] = 0u;
      }
    }

    // O = P V in one accumulator across the k16 steps, V's keys 16 kk on
    // (2,048 bytes a step), read as the transposed B operand
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) wgmma_rs_t(o, pa[kk], sw128_desc(vt + 16 * kk * 64));
    wg_commit();
    wg_wait_all();
    fence_regs(o);

    // O in bf16 into the warpgroup's own Q rows (dead since S), in the
    // swizzled layout; thread 0 stores each warpgroup's 64 rows by TMA
    // (rows >= T fall outside the tensor map and are not written) and
    // loads row b + 2 stride's K and V into the slot (its Q follows the
    // next row's S, above)
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      *reinterpret_cast<uint32_t*>(qw + sw128(r_lo, f) + 2 * c) = pack_bf16(o[4 * f], o[4 * f + 1]);
      *reinterpret_cast<uint32_t*>(qw + sw128(r_lo + 8, f) + 2 * c) =
          pack_bf16(o[4 * f + 2], o[4 * f + 3]);
    }
    fence_async_smem();  // the writes before the stores' reads (async proxy)
    __syncthreads();     // ... everyone's; the slot's K and V are read
    if (tid == 0) {
      const bf16* qs = ring + slot * 3 * kRwTile;
      tma_store(&to, qs, 64 * h, 0, b);
      tma_store(&to, qs + 64 * 64, 64 * h, 64, b);
      if (b + kRwRing * stride < n_rows) {
        mbar_expect_tx(smem_u32(&full[slot]), bytes);
        load(1, b + kRwRing * stride, slot);
        load(2, b + kRwRing * stride, slot);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled (a driver function) through the runtime's entry
// point query, so the library needs no -lcuda; null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int N>
int launch_resident_wgmma_n(const CUtensorMap (&maps)[4], int64_t b, int t, int heads,
                            cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(mha_bf16_resident_wgmma_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kRwSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mha_bf16_resident_wgmma_kernel<N>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mha_bf16_resident_wgmma_kernel<N>, kRwThreads, kRwSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // one wave: the blocks the card holds, spread over the heads
  const int64_t per_head = (static_cast<int64_t>(sms) * per_sm + heads - 1) / heads;
  const dim3 grid(heads, static_cast<unsigned>(per_head < b ? per_head : b));
  mha_bf16_resident_wgmma_kernel<N><<<grid, kRwThreads, kRwSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<int>(b), t);
  return static_cast<int>(cudaGetLastError());
}

// The resident form at HD 64 without bias: q, k, v [B, T, D] as 3-D tensor
// maps (D innermost), boxes of 64 columns x tp rows x 1 batch row; out with
// boxes of 64 rows (a warpgroup's)
int launch_resident_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* out, int64_t b,
                          int t, int d, int heads, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(bf16),
                                 static_cast<cuuint64_t>(t) * d * sizeof(bf16)};
  const cuuint32_t box_in[3] = {64, static_cast<cuuint32_t>(res_keys(t)), 1};
  const cuuint32_t box_out[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap maps[4];
  const bf16* src[4] = {q, k, v, out};
  for (int j = 0; j < 4; ++j) {
    const CUresult r = encode(&maps[j], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                              const_cast<bf16*>(src[j]), dims, strides,
                              j < 3 ? box_in : box_out, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t <= 64) return launch_resident_wgmma_n<64>(maps, b, t, heads, stream);
  if (t <= 104) return launch_resident_wgmma_n<104>(maps, b, t, heads, stream);
  return launch_resident_wgmma_n<128>(maps, b, t, heads, stream);
}

template <int HD, bool BIAS>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                const bf16* pos, bf16* out, int64_t b, int t, int d, int heads, int form,
                cudaStream_t stream) {
  if (form == kFormResident || form == kFormResidentMma) {
    if constexpr (HD <= kResMaxHD) {
      if (t <= kResMaxT) {
        if constexpr (HD == 64 && !BIAS) {
          if (form == kFormResident)
            return launch_resident_wgmma(q, k, v, out, b, t, d, heads, stream);
        }
        return launch_resident<HD, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (form != kFormStreamed) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (HD == 64)
    return launch_wgmma<BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
  return launch_streamed<HD, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, stream);
}

template <bool BIAS>
int dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* gate,
                  const bf16* pos, bf16* out, int64_t b, int t, int d, int heads, int form,
                  cudaStream_t s) {
  switch (d / heads) {
    case 16: return launch_bf16<16, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, form, s);
    case 32: return launch_bf16<32, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, form, s);
    case 64: return launch_bf16<64, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, form, s);
    case 80: return launch_bf16<80, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, form, s);
    case 128: return launch_bf16<128, BIAS>(q, k, v, gate, pos, out, b, t, d, heads, form, s);
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
// `form` picks the body: 0 the streamed body (one pass over key tiles, any
// T), 1 the resident body (T <= 128 and HD <= 80; cudaErrorInvalidValue
// elsewhere, as for any other form): mha_bf16_resident_wgmma_kernel at HD 64
// without bias, mha_bf16_resident_kernel otherwise; 2 the latter also at
// HD 64 without bias (to time the two side by side).
extern "C" int radad_fused_mha_bf16(const void* q, const void* k, const void* v,
                                    const void* gate, const void* pos, void* out,
                                    int64_t b, int t, int d, int heads, int form,
                                    void* stream) {
  if (b == 0 || t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(gate),
             *pb = static_cast<const bf16*>(pos);
  bf16* ob = static_cast<bf16*>(out);
  if (gate != nullptr)
    return dispatch_bf16<true>(qb, kb, vb, gb, pb, ob, b, t, d, heads, form, s);
  return dispatch_bf16<false>(qb, kb, vb, gb, pb, ob, b, t, d, heads, form, s);
}
