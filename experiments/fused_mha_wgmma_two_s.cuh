// A design of fused_mha.cu's streamed bf16 body at head width 64 that
// lost, kept for experiments/fused_mha_bf16_variants.py (variant
// "two_s"), which puts this text in place of the body's section (from its
// "bf16 streamed body on wgmma" line to launch_wgmma) and builds it.
//
// It overlaps Q K^T of the next tile with the softmax of this one inside
// each warpgroup (FlashAttention-3's intra-warpgroup pipelining): two S
// accumulators, the loop unrolled by two so that they swap roles, an extra
// tile of masked keys where the tile count is odd, the last pair of tiles
// masked by a compile-time flag, and P's fragments kept live until their
// P V is retired. ptxas fits it only above 128 registers, so one block (two
// warpgroups) an SM; capped at 128 it spills and ptxas serializes its
// wgmma. The shipped body trades the overlap for two blocks an SM.

// ----------------------------------- bf16 streamed body on wgmma (HD 64 only)

constexpr int kWgKeys = 64;                   // keys of a K / V tile
constexpr int kWgStages = 5;                  // tiles in the cp.async ring
constexpr int kWgGroups = 2;                  // warpgroups a block, 64 query rows each
constexpr int kWgMinBlocks = 1;               // blocks an SM (register budget)
constexpr int kWgRows = 64 * kWgGroups;       // query rows a block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgTile = kWgKeys * 64;         // bf16 of a K or V tile (128-byte rows)
// the ring, Q, and 1,024 bytes to align both to the swizzle pattern
constexpr size_t kWgSmem = sizeof(bf16) * (kWgStages * 2 * kWgTile + kWgRows * 64) + 1024;
static_assert(kWgRows * 8 % kWgThreads == 0, "Q's 16-byte copies spread evenly");

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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// (the resident form's wgmma kernel, which follows this section, uses it)
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }
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

// d = A (64 x 16) . B (16 x 64) (ACC = false; d written only) or d += A . B
// (ACC), both K-major in shared memory by descriptor (Q's rows, K's rows);
// f32 accumulator in the layout of 8 m16n8 fragments of the warp's 16
// rows: d[4 j + e] = the mma.sync body's s[j][e]
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

template <bool B>
struct Flag {  // a compile-time bool as a lambda argument
  static constexpr bool value = B;
};

// grid (query tiles, heads, batch rows); HD = 64: one 128-byte swizzle row
// a Q, K or V row
template <bool BIAS>
__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks)
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
  const int g = lane / 4, c = lane % 4;
  const int64_t base = b * t_len * static_cast<int64_t>(d_model) + h * HD;
  const int wg = warp / 4;
  const int n_tiles = (t_len + kWgKeys - 1) / kWgKeys;

  // key tile j into ring slot j % kWgStages, zero past T (all of it for
  // j >= n_tiles). No branch (see step): a thread past the tile's last copy
  // repeats one. Each thread's rows, chunk and swizzled offsets are fixed.
  constexpr int kCopies = (kWgKeys * 8 + kWgThreads - 1) / kWgThreads;
  int rows[kCopies], dst[kCopies];
  int64_t src[kCopies];
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    rows[u] = (tid + u * kWgThreads) % (kWgKeys * 8) / 8;
    dst[u] = sw128(rows[u], tid % 8);
    src[u] = base + static_cast<int64_t>(rows[u]) * d_model + 8 * (tid % 8);
  }
  auto fetch = [&](int j) {
    bf16* kd = ring + (j % kWgStages) * 2 * kWgTile;
    const int s0 = j * kWgKeys;
    const int64_t step = static_cast<int64_t>(s0) * d_model;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const bool ok = s0 + rows[u] < t_len;
      const int64_t at = ok ? src[u] + step : 0;
      cp_async16(kd + dst[u], k + at, ok);
      cp_async16(kd + kWgTile + dst[u], v + at, ok);
    }
  };

  // groups: Q, then tiles 0 .. kWgStages - 3
#pragma unroll
  for (int u = 0; u < kWgRows * 8 / kWgThreads; ++u) {
    const int r = (tid + u * kWgThreads) / 8, ch = tid % 8;
    const bool ok = t0 + r < t_len;
    cp_async16(qs + sw128(r, ch),
               q + (ok ? base + static_cast<int64_t>(t0 + r) * d_model + 8 * ch : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kWgStages - 2; ++j) {
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
  float sa[32], sb[32], o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sa[e] = sb[e] = o[e] = 0.f;
  // P's A fragments, read by the tensor cores until P V is retired: kept
  // live to that wait, so that no other value takes their registers while
  // P V runs (ptxas would guard such a reuse with a wait of its own)
  uint32_t pa[4][4] = {};

  // Descriptors, built once and stepped in units of 16 bytes: Q's k16
  // step kk at qd + 2 kk (32 bytes along its rows); slot i's K at
  // rd + i * kStage16, k16 step kk + 2 kk; its V kTile16 further, k16 step
  // kk 128 kk further (16 keys of 128 bytes)
  constexpr uint64_t kStage16 = 2 * kWgTile * sizeof(bf16) / 16;
  constexpr uint64_t kTile16 = kWgTile * sizeof(bf16) / 16;
  const uint64_t qd = sw128_desc(qs + wg * 64 * 64);
  const uint64_t rd = sw128_desc(ring);

  // S(j) = Q K(j)^T into s: four k16 steps
  auto issue_s = [&](float(&s)[32], int j) {
    const uint64_t kd = rd + (j % kWgStages) * kStage16;
    wg_fence();
    wgmma_ss<false>(s, qd, kd);
#pragma unroll
    for (int kk = 1; kk < K16; ++kk) wgmma_ss<true>(s, qd + 2 * kk, kd + 2 * kk);
    wg_commit();
  };
  cp_async_wait<kWgStages - 3>();  // Q and tile 0 have landed (this thread's copies)
  fence_async_smem();
  __syncthreads();                 // ... everyone's
  issue_s(sa, 0);
  wg_wait<0>();  // no wgmma in flight into the loop (see its end)
  fence_regs(sa);

  // Tile j: S(j + 1) goes to the tensor cores while the softmax of S(j)
  // runs; then O += P(j) V(j), left in flight into the next tile. No
  // branch holds a wgmma, its wait or a copy (ptxas serializes wgmma on a
  // divergent path): every warpgroup computes, also one whose rows all lie
  // past T; tiles past the last are fetched as zeros, S of the tile after
  // the last is issued, and an odd count of tiles takes one more, whose
  // keys are all masked (P = 0 against zero V). MASK: the tile may hold
  // keys >= T (the last pair of tiles only).
  auto step = [&](auto mask, float(&s)[32], float(&s_next)[32], int j) {
    constexpr bool MASK = decltype(mask)::value;
    cp_async_wait<kWgStages - 4>();  // tile j + 1 has landed (this thread's copies)
    fence_async_smem();
    __syncthreads();  // ... everyone's; every warpgroup's P V(j - 2) is done
    fetch(j + kWgStages - 2);  // into tile j - 2's slot
    cp_async_commit();
    wg_wait<0>();  // S(j) and P V(j - 1) are done
    fence_regs(s);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
    issue_s(s_next, j + 1);  // runs during the softmax of S(j)
    const uint64_t vd = rd + (j % kWgStages) * kStage16 + kTile16;
    const int s0 = j * kWgKeys;

    // gate x pos_bias, keys >= T to -inf, the row max
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
      if constexpr (MASK) {
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

    // O += P V: k16 step kk takes keys 16 kk .. 16 kk + 15 (A: e of
    // fragments 2 kk and 2 kk + 1 rounded to bf16), V's keys 16 kk on
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t(o, pa[kk], vd + 128 * kk);
    wg_commit();
  };
  // the two S buffers change roles each tile; nothing is in flight across
  // a loop's back edge either (S(j + 2) was issued into sa): the
  // compiler's copies of loop-carried registers there would read an
  // accumulator that a wgmma is still writing
  const Flag<false> whole;
  const Flag<true> edge;
  int j = 0;
  for (; j + 2 <= t_len / kWgKeys; j += 2) {
    step(whole, sa, sb, j);
    step(whole, sb, sa, j + 1);
    wg_wait<0>();
    fence_regs(sa);
    fence_regs(o);
  }
  for (; j < n_tiles; j += 2) {  // the last tile, maybe a full one before it
    step(edge, sa, sb, j);
    step(edge, sb, sa, j + 1);
    wg_wait<0>();
    fence_regs(sa);
    fence_regs(o);
  }
  wg_wait<0>();
  fence_regs(o);

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

