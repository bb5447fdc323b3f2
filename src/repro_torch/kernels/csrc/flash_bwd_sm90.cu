// Causal / windowed GQA flash-attention backward on Hopper's tensor cores
// (sm_90a): the dQ and dKV kernels for bf16 residuals, bf16 dO and bf16
// gradients at head_dim 64, 128 and 160, the combination of the bf16
// training policy.  kernels/flash/ops.py routes exactly that combination here
// (ops.bwd_route); every other one stays on flash_bwd.cu's FMA kernels,
// which also keep the delta pre-pass.
//
// Replaces the TPU kernels of src/repro/kernels/flash/kernel.py
// :: flash_attention_bwd_pallas -- _bwd_dq_kernel and _bwd_dkv_kernel.
// Same functions as flash_bwd.cu's dQ and dKV kernels:
//
//   dQ   P = exp(S scale - (m + log max(l, 1e-30))), masked entries
//        exactly 0; dS = P * (dO V^T - delta); dQ = dS K * scale;
//   dKV  dV = sum P^T dO and dK = sum dS^T Q * scale over the query heads
//        of the GQA group and the live q tiles.
//
// Block structure (kept from flash_bwd.cu, which the tests and counters
// rely on): 64 x 64 tiles; dQ one block per (q tile, b*h) looping over the
// KV tiles in [lo, hi] of tiling.kv_tile_bounds; dKV one block per (KV
// tile, b*hkv) looping over the group's query heads and the q tiles in
// [lo, hi] of tiling.q_tile_bounds; a KV tile wholly at or past kv_len
// writes zeros.  No atomics: every output element is written once by one
// block, so the gradients are deterministic.  The grids put the tile
// index on y and the head on x, so the heaviest causal tiles of every
// head are handed out first.  dQ recomputes S and dP itself, so a live
// tile pair costs 7 products (FlashAttention-3's atomic dQ does it in 5).
//
// What bounds it on the H100: tensor-core FLOPs -- 2 D flops per live
// (q, k) entry per product, at 989 TFLOP/s bf16.  What the design does
// about it:
//   * every product is a wgmma (bf16 in, f32 accumulate) issued by one
//     warpgroup of 128 threads that owns the block's 64-row output tile;
//   * operands arrive by TMA (cp.async.bulk.tensor) into shared memory,
//     128-byte swizzled, in a ring of two stages whose mbarriers count the
//     bytes; thread 0 issues the next tile's loads as soon as a stage is
//     released, so they land while the current tile is computed.  The
//     f32 row statistics (m, l, delta) of dKV's next step are read one
//     step ahead into registers by threads 0..63 (a row of them starts at
//     any 4-byte offset, which a TMA box may not);
//   * S and dP (dQ), S^T and dP^T (dKV) are m64n64k16 products with both
//     operands in shared memory, K-major; P and dS never touch shared
//     memory: their f32 accumulators are rounded to bf16 in registers and
//     reused as the A operand of the second-stage products (dS K; P^T dO
//     and dS^T Q), whose B operand is the same shared tile read MN-major
//     (the transpose bit);
//   * bf16 staging (~97 KB of shared memory at D = 128) lets two blocks
//     share an SM, so one block's exponentials and waits overlap the
//     other's products;
//   * at D = 160 a tile is three panels (192 columns, the last 32 TMA's
//     zeros past the tensor's edge): the K-major products take 10 k16
//     steps, the MN-major ones are m64n160 products over the panels'
//     first 160 columns, and ~145 KB (dQ) or ~161 KB (dKV) of staging
//     leaves one block an SM.  dKV's two 64 x 160 f32 accumulators do not
//     fit one warpgroup's registers beside S and dP, so at D = 160 it runs
//     two consumer warpgroups (dkv_kernel_2wg): the first computes P^T
//     and dV, the second dP^T, dS^T and dK, and P^T passes between them
//     through shared memory in f32 (so dS^T rounds as it does in one
//     warpgroup), behind a named barrier.
//
// Ragged S: the tensor maps are 3-D (D, S, heads), so rows past S load as
// zeros within their own head; such rows are masked out of P and never
// written.  Keys at or past kv_len are masked, so their dK/dV rows come
// out exactly 0.
//
// Layouts, row-major: q, dO (B*H, S, D); k, v (B*Hkv, S, D); m, l, delta
// (B*H, S) f32; dq like q, dk/dv like k, bf16; counts (B*H, n_q) for dQ
// and (B*Hkv, n_k) for dKV, int32, optional.  q, k, v, dO 16-byte
// aligned (TMA).
#include <initializer_list>

#include "flash_sm90.cuh"

namespace {

// tiling.q_tile_bounds(ki, bq=64, bk=64, causal, window, n_q, kv_len)
__device__ __forceinline__ void q_bounds(int ki, int n_q, int causal,
                                         int window, int kv_len, int* lo,
                                         int* hi) {
  *lo = 0;
  *hi = n_q - 1;
  if (causal) {
    *lo = min((ki * BK) / BQ, n_q - 1);
    if (window > 0) {
      const int khi = max(min((ki + 1) * BK, kv_len), ki * BK + 1) - 1;
      *hi = min(*hi, (khi + window - 1) / BQ);
      *hi = max(*hi, *lo);
    }
  }
}

// Shared memory of each kernel.
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {  // Q, dO; (K, V) ring
  return 1024 + 2 * tile_bytes<D>() + STAGES * 2 * tile_bytes<D>();
}
template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {  // K, V; (Q, dO) ring
  return 1024 + 2 * tile_bytes<D>() + STAGES * 2 * tile_bytes<D>();
}

// Row statistics of q row `row` of head bh: log2-scaled lse and delta
// (zeros past S, where every entry is masked).
__device__ __forceinline__ void row_stats(const float* m, const float* l,
                                          const float* delta, int bh,
                                          int row, int S, float* lse2,
                                          float* dlt) {
  const bool in = row < S;
  const size_t at = (size_t)bh * S + (in ? row : 0);
  *lse2 = in ? (m[at] + logf(fmaxf(l[at], 1e-30f))) * LOG2E : 0.f;
  *dlt = in ? delta[at] : 0.f;
}

// Blocks an SM must hold: as many as the shared memory allows, which caps
// the registers (65,536 an SM) at 128 / 170 a thread for D = 64 and 255
// for D = 128; at D = 160 dQ's staging leaves one block an SM (dKV runs
// dkv_kernel_2wg).
template <int D>
__host__ __device__ constexpr int dq_blocks_per_sm() {
  return D == 64 ? 4 : D == 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int dkv_blocks_per_sm() {
  return D == 64 ? 3 : 2;
}

// dkv_kernel_2wg: two warpgroups; K, V; (Q, dO) ring; P^T in f32, one
// 32-float fragment a thread of the first warpgroup
constexpr int NT2 = 2 * NT;
template <int D>
__host__ __device__ constexpr int dkv2_smem_bytes() {
  return dkv_smem_bytes<D>() + 32 * NT * 4;
}

// Named barrier 1 over both warpgroups: the first arrives once P^T is in
// shared memory, the second waits for it.
__device__ __forceinline__ void p_ready_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(NT2) : "memory");
}
__device__ __forceinline__ void p_ready_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT2) : "memory");
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, dq_blocks_per_sm<D>())
dq_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdo,
          const float* __restrict__ m, const float* __restrict__ l,
          const float* __restrict__ delta, bf16* __restrict__ dq,
          int* __restrict__ counts, int S, int group, int causal, int window,
          int kv_len, float sm_scale) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full[STAGES];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* dOs = Qs + TILE;
  uint8_t* ring = dOs + TILE;

  const int n_q = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x;
  const int qi = n_q - 1 - blockIdx.y;  // late (heavy) q tiles first
  const int bhkv = bh / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // and columns 8 j + c0 (+1)

  int lo, hi;
  kv_bounds(qi, causal, window, kv_len, &lo, &hi);
  const int n_t = hi - lo + 1;  // 0 when kv_len == 0

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(&bar_q, 2 * TILE);
    tma_load_tile<D>(Qs, &mq, &bar_q, qi * BQ, bh);
    tma_load_tile<D>(dOs, &mdo, &bar_q, qi * BQ, bh);
    for (int j = 0; j < STAGES && j < n_t; ++j)
      ring_load<D>(ring, full, &mk, &mv, j, (lo + j) * BK, bhkv);
  }

  float lse2[2], dlt[2];  // of rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row_stats(m, l, delta, bh, qi * BQ + r0 + 8 * h, S, &lse2[h], &dlt[h]);
  const float scale2 = sm_scale * LOG2E;
  const uint32_t q_addr = smem_addr(Qs), do_addr = smem_addr(dOs);

  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  if (n_t > 0) mbar_wait(&bar_q, 0);
  for (int j = 0; j < n_t; ++j) {
    const int st = j % STAGES;
    const int kt = lo + j;
    const uint32_t k_addr = smem_addr(ring + st * 2 * TILE);
    const uint32_t v_addr = k_addr + TILE;
    mbar_wait(&full[st], (j / STAGES) & 1);

    // S = Q K^T and dP = dO V^T, both operands K-major in shared memory
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_m64n64(s, desc_kmajor(q_addr, k), desc_kmajor(k_addr, k),
                      k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_m64n64(dp, desc_kmajor(do_addr, k), desc_kmajor(v_addr, k),
                      k > 0);
    wgmma_commit();

    wgmma_wait<1>();
    fence_regs(s);
    const bool full_tile = tile_full(qi, kt, S, causal, window, kv_len);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      float p = exp2f(s[i] * scale2 - lse2[h]);
      if (!full_tile &&
          !live(qi * BQ + r0 + 8 * h, kt * BK + 8 * (i / 4) + c0 + (i % 2), S,
                causal, window, kv_len))
        p = 0.f;
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dlt[(i % 4) / 2]);

    // dQ += dS K: dS from registers, K the same tile read MN-major
    uint32_t a[4][4];
    acc_to_a(dp, a);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_rs_tb<D>(acc, a[k], desc_mnmajor(k_addr, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + STAGES < n_t)
      ring_load<D>(ring, full, &mk, &mv, j + STAGES,
                   (lo + j + STAGES) * BK, bhkv);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = qi * BQ + r0 + 8 * ((i % 4) / 2);
    if (row < S)
      store_pair(dq + ((size_t)bh * S + row) * D + 8 * (i / 4) + c0,
                 acc[i] * sm_scale, acc[i + 1] * sm_scale);
  }
  if (counts != nullptr && tid == 0) counts[(size_t)bh * n_q + qi] = n_t;
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (KV tile, bhkv).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, dkv_blocks_per_sm<D>())
dkv_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const __grid_constant__ CUtensorMap mdo,
           const float* __restrict__ m, const float* __restrict__ l,
           const float* __restrict__ delta, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int* __restrict__ counts, int S, int group,
           int causal, int window, int kv_len, float sm_scale) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[STAGES];
  // the current step's q rows: log2-scaled lse and delta
  __shared__ __align__(16) float lse_s[BQ];
  __shared__ __align__(16) float dl_s[BQ];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* ring = Vs + TILE;

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int bhkv = blockIdx.x;
  const int kt = blockIdx.y;  // early (heavy, under causal) KV tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // KV rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // q columns 8 j + c0 (+1)

  const bool tile_live = kt * BK < kv_len;
  int lo, hi;
  q_bounds(kt, n_q, causal, window, kv_len, &lo, &hi);
  const int n_qt = hi - lo + 1;
  const int n_t = tile_live ? group * n_qt : 0;  // (head, q tile) steps

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(&bar_kv, 2 * TILE);
    tma_load_tile<D>(Ks, &mk, &bar_kv, kt * BK, bhkv);
    tma_load_tile<D>(Vs, &mv, &bar_kv, kt * BK, bhkv);
    for (int j = 0; j < STAGES && j < n_t; ++j)
      ring_load<D>(ring, full, &mq, &mdo, j, (lo + j % n_qt) * BQ,
                   bhkv * group + j / n_qt);
  }
  // threads 0..63 fetch the row statistics one step ahead in registers
  float next_lse2 = 0.f, next_dlt = 0.f;
  if (tid < BQ && n_t > 0)
    row_stats(m, l, delta, bhkv * group, lo * BQ + tid, S, &next_lse2,
              &next_dlt);
  const float scale2 = sm_scale * LOG2E;
  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);

  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  if (n_t > 0) mbar_wait(&bar_kv, 0);
  for (int j = 0; j < n_t; ++j) {
    const int st = j % STAGES;
    const int qt = lo + j % n_qt;
    const uint32_t q_addr = smem_addr(ring + st * 2 * TILE);
    const uint32_t do_addr = q_addr + TILE;
    if (tid < BQ) {
      lse_s[tid] = next_lse2;
      dl_s[tid] = next_dlt;
      const int jn = j + 1;
      if (jn < n_t)
        row_stats(m, l, delta, bhkv * group + jn / n_qt,
                  (lo + jn % n_qt) * BQ + tid, S, &next_lse2, &next_dlt);
    }
    mbar_wait(&full[st], (j / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T: the accumulators hold P^T and dS^T
    // in the row order of the next products' A operand
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_m64n64(s, desc_kmajor(k_addr, k), desc_kmajor(q_addr, k),
                      k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_m64n64(dp, desc_kmajor(v_addr, k), desc_kmajor(do_addr, k),
                      k > 0);
    wgmma_commit();
    __syncthreads();  // lse_s and dl_s of this step are in

    wgmma_wait<1>();
    fence_regs(s);
    const bool full_tile = tile_full(qt, kt, S, causal, window, kv_len);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = 8 * jn + c0;
      const float2 lse = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        float p = exp2f(s[i] * scale2 - (e % 2 ? lse.y : lse.x));
        if (!full_tile && !live(qt * BQ + c + (e % 2),
                                kt * BK + r0 + 8 * (e / 2), S, causal,
                                window, kv_len))
          p = 0.f;
        s[i] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * jn + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        dp[i] = s[i] * (dp[i] - (e % 2 ? dl.y : dl.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q: A from registers, B the stage's dO
    // and Q tiles read MN-major.  Both are issued after dS^T is formed:
    // issuing dV first, to run while dS^T is formed, was no faster at the
    // train shape (D = 128) and took dKV at D = 64 from 160 to 168
    // registers, the cap for three blocks an SM.
    uint32_t ap[4][4], ads[4][4];
    acc_to_a(s, ap);
    acc_to_a(dp, ads);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_rs_tb<D>(dv_acc, ap[k], desc_mnmajor(do_addr, k), 1);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_rs_tb<D>(dk_acc, ads[k], desc_mnmajor(q_addr, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    __syncthreads();  // every warp is done with this stage and lse_s
    const int jn = j + STAGES;
    if (tid == 0 && jn < n_t)
      ring_load<D>(ring, full, &mq, &mdo, jn, (lo + jn % n_qt) * BQ,
                   bhkv * group + jn / n_qt);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = kt * BK + r0 + 8 * ((i % 4) / 2);
    if (row < S) {
      const size_t at = ((size_t)bhkv * S + row) * D + 8 * (i / 4) + c0;
      store_pair(dk + at, dk_acc[i] * sm_scale, dk_acc[i + 1] * sm_scale);
      store_pair(dv + at, dv_acc[i], dv_acc[i + 1]);
    }
  }
  if (counts != nullptr && tid == 0)
    counts[(size_t)bhkv * n_k + kt] = n_t;
}

// ---------------------------------------------------------------------------
// dK, dV at D = 160: dkv_kernel's work over two warpgroups.  Warpgroup 0
// computes S^T = K Q^T, P^T (into shared memory) and dV += P^T dO;
// warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and
// dK += dS^T Q.  Each keeps one 64 x D accumulator.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT2, 1)
dkv_kernel_2wg(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int* __restrict__ counts, int S,
               int group, int causal, int window, int kv_len,
               float sm_scale) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(16) float lse_s[BQ];
  __shared__ __align__(16) float dl_s[BQ];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* ring = Vs + TILE;
  float* Ps = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int bhkv = blockIdx.x;
  const int kt = blockIdx.y;
  const int tid = threadIdx.x, wg = tid / NT, t = tid % NT;
  const int warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4;  // KV rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // q columns 8 j + c0 (+1)

  const bool tile_live = kt * BK < kv_len;
  int lo, hi;
  q_bounds(kt, n_q, causal, window, kv_len, &lo, &hi);
  const int n_qt = hi - lo + 1;
  const int n_t = tile_live ? group * n_qt : 0;

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n_t > 0) {
    mbar_expect_tx(&bar_kv, 2 * TILE);
    tma_load_tile<D>(Ks, &mk, &bar_kv, kt * BK, bhkv);
    tma_load_tile<D>(Vs, &mv, &bar_kv, kt * BK, bhkv);
    for (int j = 0; j < STAGES && j < n_t; ++j)
      ring_load<D>(ring, full, &mq, &mdo, j, (lo + j % n_qt) * BQ,
                   bhkv * group + j / n_qt);
  }
  float next_lse2 = 0.f, next_dlt = 0.f;
  if (tid < BQ && n_t > 0)
    row_stats(m, l, delta, bhkv * group, lo * BQ + tid, S, &next_lse2,
              &next_dlt);
  const float scale2 = sm_scale * LOG2E;
  // warpgroup 0 multiplies K, warpgroup 1 V, against the stage's Q / dO
  const uint32_t kv_addr = smem_addr(wg == 0 ? Ks : Vs);

  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  if (n_t > 0) mbar_wait(&bar_kv, 0);
  for (int j = 0; j < n_t; ++j) {
    const int st = j % STAGES;
    const int qt = lo + j % n_qt;
    const uint32_t q_addr = smem_addr(ring + st * 2 * TILE);
    const uint32_t do_addr = q_addr + TILE;
    if (tid < BQ) {
      lse_s[tid] = next_lse2;
      dl_s[tid] = next_dlt;
      const int jn = j + 1;
      if (jn < n_t)
        row_stats(m, l, delta, bhkv * group + jn / n_qt,
                  (lo + jn % n_qt) * BQ + tid, S, &next_lse2, &next_dlt);
    }
    mbar_wait(&full[st], (j / STAGES) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    const uint32_t b_addr = wg == 0 ? q_addr : do_addr;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss_m64n64(s, desc_kmajor(kv_addr, k), desc_kmajor(b_addr, k),
                      k > 0);
    wgmma_commit();
    __syncthreads();  // lse_s and dl_s of this step are in
    wgmma_wait<0>();
    fence_regs(s);

    if (wg == 0) {
      const bool full_tile = tile_full(qt, kt, S, causal, window, kv_len);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int c = 8 * jn + c0;
        const float2 lse = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          float p = exp2f(s[i] * scale2 - (e % 2 ? lse.y : lse.x));
          if (!full_tile && !live(qt * BQ + c + (e % 2),
                                  kt * BK + r0 + 8 * (e / 2), S, causal,
                                  window, kv_len))
            p = 0.f;
          s[i] = p;
          Ps[i * NT + t] = p;
        }
      }
      p_ready_arrive();
    } else {
      p_ready_wait();
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 dl =
            *reinterpret_cast<const float2*>(dl_s + 8 * jn + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          s[i] = Ps[i * NT + t] * (s[i] - (e % 2 ? dl.y : dl.x));
        }
      }
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): A from
    // registers, B the stage's dO or Q tile read MN-major
    uint32_t a[4][4];
    acc_to_a(s, a);
    const uint32_t mn_addr = wg == 0 ? do_addr : q_addr;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_rs_tb<D>(acc, a[k], desc_mnmajor(mn_addr, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // both warpgroups are done with this stage and Ps
    const int jn = j + STAGES;
    if (tid == 0 && jn < n_t)
      ring_load<D>(ring, full, &mq, &mdo, jn, (lo + jn % n_qt) * BQ,
                   bhkv * group + jn / n_qt);
  }

  bf16* out = wg == 0 ? dv : dk;
  const float scale = wg == 0 ? 1.f : sm_scale;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = kt * BK + r0 + 8 * ((i % 4) / 2);
    if (row < S)
      store_pair(out + ((size_t)bhkv * S + row) * D + 8 * (i / 4) + c0,
                 acc[i] * scale, acc[i + 1] * scale);
  }
  if (counts != nullptr && tid == 0)
    counts[(size_t)bhkv * n_k + kt] = n_t;
}

// ---------------------------------------------------------------------------
// Launchers: tensor maps built on the host for every call (they hold the
// base pointers), passed by value as __grid_constant__ parameters.
// ---------------------------------------------------------------------------
template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* m, const float* l,
                      const float* delta, void* dq, int* counts, int bh,
                      int bhkv, int S, int causal, int window, int kv_len,
                      float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!map_bf16_tiles(&mq, q, D, S, bh) ||
      !map_bf16_tiles(&mk, k, D, S, bhkv) ||
      !map_bf16_tiles(&mv, v, D, S, bhkv) ||
      !map_bf16_tiles(&mdo, dout, D, S, bh))
    return cudaErrorNotSupported;
  constexpr int smem = dq_smem_bytes<D>();
  auto kern = dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(mq, mk, mv, mdo, m, l, delta,
                                   static_cast<bf16*>(dq), counts, S,
                                   bh / bhkv, causal, window, kv_len,
                                   sm_scale);
  return cudaGetLastError();
}

// The dKV kernel of head dim D (only the chosen one is instantiated).
template <int D>
auto dkv_kernel_of() {
  if constexpr (D == 160)
    return dkv_kernel_2wg<D>;
  else
    return dkv_kernel<D>;
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* l,
                       const float* delta, void* dk, void* dv, int* counts,
                       int bh, int bhkv, int S, int causal, int window,
                       int kv_len, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!map_bf16_tiles(&mq, q, D, S, bh) ||
      !map_bf16_tiles(&mk, k, D, S, bhkv) ||
      !map_bf16_tiles(&mv, v, D, S, bhkv) ||
      !map_bf16_tiles(&mdo, dout, D, S, bh))
    return cudaErrorNotSupported;
  constexpr bool two = D == 160;  // two warpgroups (dkv_kernel_2wg)
  constexpr int smem = two ? dkv2_smem_bytes<D>() : dkv_smem_bytes<D>();
  auto kern = dkv_kernel_of<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhkv, (S + BK - 1) / BK);
  kern<<<grid, two ? NT2 : NT, smem, stream>>>(mq, mk, mv, mdo, m, l, delta,
                                   static_cast<bf16*>(dk),
                                   static_cast<bf16*>(dv), counts, S,
                                   bh / bhkv, causal, window, kv_len,
                                   sm_scale);
  return cudaGetLastError();
}

// Only (bf16, bf16, bf16), and 16-byte aligned TMA operands and outputs;
// the head dim is checked by the dispatch.
bool bad_args(int bh, int bhkv, int S, int rdt, int gdt, int odt,
              int kv_len, std::initializer_list<const void*> ptrs) {
  if (bhkv <= 0 || bh % bhkv != 0 || S < 1 || kv_len < 0 || kv_len > S)
    return true;
  if (rdt != 1 || gdt != 1 || odt != 1) return true;
  for (const void* p : ptrs)
    if (!aligned(p)) return true;
  return false;
}

}  // namespace

// The argument lists of flash_bwd.cu's flash_bwd_dq / flash_bwd_dkv.  Each
// returns cudaGetLastError() after its launch: cudaErrorInvalidValue for
// a shape, dtype or alignment it does not take, cudaErrorNotSupported if
// a tensor map cannot be encoded.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* m,
                                 const void* l, const void* delta, void* dq,
                                 void* counts, int bh, int bhkv, int S, int D,
                                 int rdt, int gdt, int odt, int causal,
                                 int window, int kv_len, float sm_scale,
                                 void* stream) {
  if (bad_args(bh, bhkv, S, rdt, gdt, odt, kv_len, {q, k, v, dout, dq}))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto run = [&](auto launch) {
    return (int)launch(q, k, v, dout, f(m), f(l), f(delta), dq,
                       static_cast<int*>(counts), bh, bhkv, S, causal, window,
                       kv_len, sm_scale, st);
  };
  switch (D) {  // every head dim by name: no other D reaches a kernel
    case 64: return run(launch_dq<64>);
    case 128: return run(launch_dq<128>);
    case 160: return run(launch_dq<160>);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m,
                                  const void* l, const void* delta, void* dk,
                                  void* dv, void* counts, int bh, int bhkv,
                                  int S, int D, int rdt, int gdt, int odt,
                                  int causal, int window, int kv_len,
                                  float sm_scale, void* stream) {
  if (bad_args(bh, bhkv, S, rdt, gdt, odt, kv_len, {q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto run = [&](auto launch) {
    return (int)launch(q, k, v, dout, f(m), f(l), f(delta), dk, dv,
                       static_cast<int*>(counts), bh, bhkv, S, causal, window,
                       kv_len, sm_scale, st);
  };
  switch (D) {  // every head dim by name: no other D reaches a kernel
    case 64: return run(launch_dkv<64>);
    case 128: return run(launch_dkv<128>);
    case 160: return run(launch_dkv<160>);
    default: return (int)cudaErrorInvalidValue;
  }
}
