// Causal / windowed GQA flash-attention forward on Hopper's tensor cores
// (sm_90a), for bf16 q, k, v at head_dim 64, 128 and 160: the bf16 policy's
// prefill and training forward.  kernels/flash/ops.py routes exactly that
// combination here (ops.fwd_route); f32, and bf16 at head_dim 16, stay on
// flash_fwd.cu's FMA kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py
// :: flash_attention_fwd_pallas (body _flash_kernel).  Same function and
// outputs as flash_fwd.cu: o = softmax(Q K^T scale + mask) V per (b*h) row,
// query head h reading KV head h / group, the causal, sliding-window and
// kv_len masks of _position_mask; the f32 row statistics m (the max of the
// masked scaled scores, natural units) and l (sum of exp(s - m)) that the
// backward reads; optionally the KV tiles each q tile executed.
//
// Block structure (kept from flash_fwd.cu, which the tests and counters
// rely on): 64 x 64 tiles, one block per (b*h, q tile) looping over exactly
// the KV tiles in [lo, hi] of tiling.kv_tile_bounds; the grid puts the head
// on x and the q tile, reversed, on y, so the heaviest causal tiles of every
// head are handed out first.
//
// What bounds it on the H100: tensor-core FLOPs -- 2 D flops per live
// (q, k) entry per product, two products, at 989 TFLOP/s bf16; q, k, v and
// o cross device memory once.  What the design does about it:
//   * one warpgroup of 128 threads owns the block's 64-row output tile and
//     issues every product as a wgmma (bf16 in, f32 accumulate);
//   * Q's tile arrives once by TMA; K and V arrive by TMA into a ring of two
//     stages (128-byte swizzled panels, mbarriers counting the bytes), and
//     thread 0 issues the next tile's loads as soon as a stage is released,
//     so they land while the current tile is computed;
//   * S = Q K^T is an m64n64k16 product with both operands K-major in
//     shared memory; the online softmax runs on its f32 accumulator in
//     registers.  A row's max is taken over the raw scores (reduced over
//     the 4 lanes of a quad) and scaled once; p = 2^(s scale log2 e - m)
//     is one FMA and one ex2.approx.ftz; a row's sum is kept per thread
//     and reduced once at the end.  The softmax, not the products, sets
//     the pace of one block, so each instruction per score counts.  P,
//     rounded to bf16 in registers, is the A operand of O += P V, whose B
//     operand is the V tile read MN-major (the transpose bit).  P never
//     touches shared memory;
//   * at D = 160 a tile is three panels (192 columns, the last 32 zeros
//     that TMA fills past the tensor's edge): S = Q K^T takes 10 k16 steps
//     and never reads the zeros, O += P V is one m64n160 product over the
//     panels' first 160 columns.  Q is staged once, through the ring's
//     second stage, into registers (10 A fragments, 40 registers) and S
//     is a register-A product: its 24 KB tile would have left one block
//     an SM (121 KB); the ring alone (97 KB) leaves two;
//   * bf16 staging (~81 KB of shared memory at D = 128, ~41 KB at D = 64)
//     lets 2 (D = 128) or 4 (D = 64) blocks share an SM, so one block's
//     exponentials and waits overlap another's products.  Each product is
//     waited for at once: issuing the next tile's S before this tile's
//     P V (the next scores in s while P sits in its A fragments) and
//     skipping the rescale of a warp whose rows kept their max were both
//     measured and not taken (PERF.md).
//
// Rounding: P is rounded to bf16 before P V (the Pallas kernel and the
// plain version multiply in f32); l is summed from the f32 p.  Masked
// entries get a score of -inf, so their p is exactly 0; the running max
// starts at -1e30, so alpha = exp2(m_old - m_new) stays finite while a row
// has seen no live key.  A row with no live key at all (kv_len = 0) writes
// o = 0, m = -1e30, l = 0, as flash_fwd.cu does.
//
// Ragged S: the tensor maps are 3-D (D, S, heads), so rows past S load as
// zeros within their own head; such rows are masked and never written.
//
// Layouts, row-major: q (B*H, S, D); k, v (B*Hkv, S, D); o like q, bf16;
// m, l (B*H, S) f32; counts (B*H, n_q) int32, optional.  q, k, v 16-byte
// aligned (TMA), o 4-byte aligned.
#include <math.h>

#include "flash_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // the running max before any live key

// Q from registers (the A operand of S = Q K^T) instead of shared memory
template <int D>
__host__ __device__ constexpr bool q_in_regs() {
  return D == 160;
}

template <int D>
__host__ __device__ constexpr int fwd_smem_bytes() {  // [Q;] (K, V) ring
  return 1024 + (q_in_regs<D>() ? 0 : tile_bytes<D>()) +
         STAGES * 2 * tile_bytes<D>();
}

// Blocks an SM must hold: as many as the shared memory allows at D = 128
// and 160 (2: 255 registers a thread); at D = 64, 4 (128 registers a
// thread).
template <int D>
__host__ __device__ constexpr int fwd_blocks_per_sm() {
  return D == 64 ? 4 : 2;
}

// Thread (warp, lane)'s A fragments of a 64 x D bf16 tile staged as
// 128-byte-swizzled panels: step k covers columns 16 k .. 16 k + 15, in
// acc_to_a's order (rows r0 / r0 + 8, column pairs c0 / c0 + 8).
template <int D>
__device__ __forceinline__ void tile_to_a(const uint8_t* tile, int r0, int c0,
                                          uint32_t (&a)[D / 16][4]) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i % 2), c = 16 * k + c0 + 8 * (i / 2);
      const int cc = c % 64;
      a[k][i] = *reinterpret_cast<const uint32_t*>(
          tile + (c / 64) * PANEL_BYTES + r * 128 +
          ((cc / 8) ^ (r % 8)) * 16 + (cc % 8) * 2);
    }
}

template <int D>
__global__ void __launch_bounds__(NT, fwd_blocks_per_sm<D>())
fwd_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
           float* __restrict__ m_out, float* __restrict__ l_out,
           int* __restrict__ counts, int S, int group, int causal,
           int window, int kv_len, float sm_scale) {
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full[STAGES];
  constexpr bool QREG = q_in_regs<D>();
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* ring = QREG ? Qs : Qs + TILE;
  if constexpr (QREG) Qs = ring + 2 * TILE;  // stage 1's K slot, at first

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
    mbar_expect_tx(&bar_q, TILE);
    tma_load_tile<D>(Qs, &mq, &bar_q, qi * BQ, bh);
    for (int j = 0; j < (QREG ? 1 : STAGES) && j < n_t; ++j)
      ring_load<D>(ring, full, &mk, &mv, j, (lo + j) * BK, bhkv);
  }

  const float scale2 = sm_scale * LOG2E;
  const uint32_t q_addr = smem_addr(Qs);
  // rows r0, r0 + 8: the running max in log2 units, and this thread's part
  // of the running sum (its 16 columns of each tile)
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  if (n_t > 0) mbar_wait(&bar_q, 0);
  // QREG: Q's A fragments out of stage 1, which then takes its KV tile
  uint32_t qa[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
    if (n_t > 0) tile_to_a<D>(Qs, r0, c0, qa);
    __syncthreads();
    if (tid == 0 && n_t > 1) {
      fence_proxy_async();
      ring_load<D>(ring, full, &mk, &mv, 1, (lo + 1) * BK, bhkv);
    }
  }
  for (int j = 0; j < n_t; ++j) {
    const int st = j % STAGES;
    const int kt = lo + j;
    const uint32_t k_addr = smem_addr(ring + st * 2 * TILE);
    const uint32_t v_addr = k_addr + TILE;
    mbar_wait(&full[st], (j / STAGES) & 1);

    // S = Q K^T, both operands K-major in shared memory
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      if constexpr (QREG)
        wgmma_rs_m64n64(s, qa[k], desc_kmajor(k_addr, k), k > 0);
      else
        wgmma_ss_m64n64(s, desc_kmajor(q_addr, k), desc_kmajor(k_addr, k),
                        k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // masked entries -inf; the rows' new max, in log2 units
    const bool full_tile = tile_full(qi, kt, S, causal, window, kv_len);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      if (!full_tile &&
          !live(qi * BQ + r0 + 8 * h, kt * BK + 8 * (i / 4) + c0 + (i % 2), S,
                causal, window, kv_len))
        s[i] = -INFINITY;
      mx[h] = fmaxf(mx[h], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m2[h], mx[h] * scale2);
      alpha[h] = ex2(m2[h] - m_new);
      m2[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      const float p = ex2(fmaf(s[i], scale2, -m2[h]));
      l[h] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    // O += P V: P from registers, V the stage's tile read MN-major
    uint32_t a[4][4];
    acc_to_a(s, a);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_rs_tb<D>(acc, a[k], desc_mnmajor(v_addr, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + STAGES < n_t)
      ring_load<D>(ring, full, &mk, &mv, j + STAGES,
                   (lo + j + STAGES) * BK, bhkv);
  }

  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    denom[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i % 4) / 2;
    const int row = qi * BQ + r0 + 8 * h;
    if (row < S)
      store_pair(o + ((size_t)bh * S + row) * D + 8 * (i / 4) + c0,
                 acc[i] / denom[h], acc[i + 1] / denom[h]);
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qi * BQ + r0 + 8 * h;
      if (row < S) {
        const size_t at = (size_t)bh * S + row;
        m_out[at] = m2[h] == NEG_INF ? NEG_INF : m2[h] / LOG2E;
        l_out[at] = l[h];
      }
    }
  }
  if (counts != nullptr && tid == 0) counts[(size_t)bh * n_q + qi] = n_t;
}

// Tensor maps built on the host for every call (they hold the base
// pointers), passed by value as __grid_constant__ parameters.
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int* counts, int bh, int bhkv,
                       int S, int causal, int window, int kv_len,
                       float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!map_bf16_tiles(&mq, q, D, S, bh) ||
      !map_bf16_tiles(&mk, k, D, S, bhkv) ||
      !map_bf16_tiles(&mv, v, D, S, bhkv))
    return cudaErrorNotSupported;
  constexpr int smem = fwd_smem_bytes<D>();
  auto kern = fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), m, l,
                                   counts, S, bh / bhkv, causal, window,
                                   kv_len, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// The argument list of flash_fwd.cu's flash_fwd (dtype: 0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError() after the launch:
// cudaErrorInvalidValue for a shape, dtype or alignment it does not take
// (only bf16 at D 64, 128 or 160), cudaErrorNotSupported if a tensor map
// cannot be encoded.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, void* counts,
                              int bh, int bhkv, int S, int D, int dtype,
                              int causal, int window, int kv_len,
                              float sm_scale, void* stream) {
  if (bhkv <= 0 || bh % bhkv != 0 || S < 1 || kv_len < 0 || kv_len > S ||
      dtype != 1 || !aligned(q) || !aligned(k) || !aligned(v) ||
      (reinterpret_cast<uintptr_t>(o) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto run = [&](auto launch) {
    return (int)launch(q, k, v, o, f(m), f(l), static_cast<int*>(counts), bh,
                       bhkv, S, causal, window, kv_len, sm_scale, st);
  };
  switch (D) {  // every head dim by name: no other D reaches a kernel
    case 64: return run(launch_fwd<64>);
    case 128: return run(launch_fwd<128>);
    case 160: return run(launch_fwd<160>);
    default: return (int)cudaErrorInvalidValue;
  }
}
