// SSD (mamba2 state-space duality) intra-chunk kernel on Hopper's tensor
// cores (sm_90a): the route of kernels/ssd/ops.py (ops.ssd_route) for
// head_p 64 at d_state 16 and 128, mamba2's and hymba's widths.  head_p 16
// stays on ssd.cu's FMA kernel.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py :: ssd_chunk_pallas
// (body _ssd_chunk_kernel).  Same function as ssd.cu: for every folded
// (batch * head) row g and chunk t, with C, B (Q, N), xbar (Q, P) and the
// inclusive cumulative log-decay da (Q,), all f32,
//   y     = tril(C B^T o exp(da_i - da_j)) xbar                    (Q, P)
//   state = B^T (xbar o exp(da[Q-1] - da))                          (N, P)
// C and B are head-shared, read as (G / H, T, Q, N): row g uses batch g / H.
//
// What bounds it on the H100: bytes.  At mamba2's widths a head-chunk
// moves xbar in and y and the state out (96 KB) for ~3.2 MFLOP of products
// once the scores are shared by the heads; at 3.35 TB/s and three TF32
// passes at 495 TFLOP/s the bytes take ~1.5x the operations (hymba's
// N = 16: ~2.6x).  What the design does about it:
//   * S = C B^T once per (batch, chunk, group of heads): a CTA takes one
//     (b, t) and walks a group of its heads (ops.heads_per_cta sizes the
//     groups so the grid fills the card), computes S's three 64 x 64
//     blocks on or below the diagonal (a warpgroup each) and keeps S in
//     shared memory in the A-fragment order of the y product, so each
//     head reads its part of S with one 16-byte load a k8 step and
//     applies its own causal mask and decay exp(da_i - da_j) per element
//     (never factored as e^da_i e^-da_j: da falls below -100);
//   * every product on the tensor cores, wgmma .tf32 in three passes
//     (hi lo + lo hi + hi hi, each operand split x = hi + lo with tf32
//     rounding, f32 accumulation): 1e-4 of max needs it, one pass misses
//     (tests/test_torch_ssd_sm90.py).  tf32 operands in shared memory must
//     be K-major, so each head's xbar is transposed and split once, to
//     x^T hi / lo, the B operand of both y = G xbar and state = (B o w)^T
//     xbar (N = 128, M = n).  At N = 16 the state is taken transposed,
//     state^T = (xbar o w)^T B (M = p = 64), against B^T hi / lo (8 KB).
//     The A operands (G, B o w, xbar o w) are split in registers;
//   * the per-head xbar streams in by 1-D bulk copies (cp.async.bulk on an
//     mbarrier) into a ring of raw slots (one at N = 128, two at N = 16)
//     issued as soon as a slot is transposed, so the next heads' bytes
//     land while this one's products run; y and the state are stored from
//     the accumulators (8-byte stores, whole 32-byte sectors);
//   * one warpgroup a 64-row output tile: y's rows 0-63 and 64-127 (only
//     the k8 steps at or below the diagonal: 8 and 16) and the state's
//     rows 0-63 and 64-127 at N = 128 (16 each), or its one tile at N = 16;
//     4 warpgroups (3 at N = 16) in one CTA an SM.  A warpgroup issues 4
//     k8 steps (12 wgmma) at a time and waits for them; the others'
//     fragment arithmetic and products fill its wait.
// What sets its pace (tools/ssd_phases.py, PERF.md): the products, then
// their fragment arithmetic, the stores and the per-head transpose, one
// after the other: the CTA's two barriers a head keep them apart.
//
// Shared memory (bytes): raw xbar slots, 32 KB each; the state's B operand
// (N = 128: B in A-fragment order, 64 KB; N = 16: B^T hi / lo, 16 KB); S
// in fragment order (48 KB); x^T hi / lo (64 KB); da and w of the head.
// B hi / lo of the score product (K-major, 128 KB at N = 128) live over S
// and x^T until S is computed.  226 KB at N = 128, 194 KB at N = 16.
//
// Any Q in [1, 128]: rows past Q are zero in every operand and never
// stored; the products run K to 128 (Q > 64) or 64.
// Layouts, row-major f32: c, b (G / H, T, Q, N); x (G, T, Q, P); acum
// (G, T, Q); y (G, T, Q, P); state (G, T, N, P); all 16-byte aligned.
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// warpgroups: y's two row tiles, the state's two (N = 128) or one (N = 16)
template <int N>
__host__ __device__ constexpr int threads() { return N == 128 ? 512 : 384; }
constexpr int QMAX = 128;
constexpr int P = 64;        // head_p
constexpr int KC = 4;        // k8 steps issued as one group
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Smem {
  static constexpr int RS = N == 128 ? 1 : 2;      // raw xbar slots
  static constexpr int SLOT = QMAX * P * 4;
  static constexpr int RAW = 0;
  static constexpr int BST = RAW + RS * SLOT;      // the state's B operand
  static constexpr int BST_HALF = N * QMAX * 4;    // N = 16: B^T lo after hi
  static constexpr int BST_BYTES = N == 128 ? QMAX * N * 4 : 2 * BST_HALF;
  static constexpr int SF = BST + BST_BYTES;       // S, fragment order
  // k8 steps of S's rows 0-63 (8) and 64-127 (16), 2 KB each
  static constexpr int SF_BYTES = (8 + 16) * 2048;
  static constexpr int XT = SF + SF_BYTES;         // x^T hi, then lo
  static constexpr int XT_HALF = P * QMAX * 4;
  static constexpr int NP = N < 32 ? 32 : N;       // B's row: >= one panel
  static constexpr int BHL = SF;                   // B hi, lo (QMAX x NP) for S
  static constexpr int BHL_HALF = QMAX * NP * 4;
  static constexpr int END = XT + 2 * XT_HALF > BHL + 2 * BHL_HALF
                                 ? XT + 2 * XT_HALF
                                 : BHL + 2 * BHL_HALF;
  static constexpr int DA = END;                   // da, then w: 2 x QMAX f32
  static constexpr int BAR = DA + 2 * QMAX * 4;    // RS mbarriers
  static constexpr int BYTES = 1024 + BAR + 8 * RS;  // + 1024-byte alignment
};

// A barrier for code that the warpgroups reach on different paths.
__device__ __forceinline__ void cta_barrier() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// Byte offset of A-fragment register r of lane l, warp w, k8 step s in a
// fragment-ordered operand: 16 bytes a lane, 512 a warp, 2048 a k8 step.
__device__ __forceinline__ int frag_off(int s, int w, int l, int r) {
  return s * 2048 + w * 512 + l * 16 + r * 4;
}

// KC k8 steps (fewer if `steps` says so), three passes each, on A
// fragments (hi, lo) and the B operand's hi / lo tiles (R rows a panel).
template <int NC>
__device__ __forceinline__ void issue_steps(float (&acc)[NC / 2],
                                            const uint32_t (&ah)[KC][4],
                                            const uint32_t (&al)[KC][4],
                                            uint32_t b_hi, uint32_t b_lo,
                                            int s0, int R, int steps = KC) {
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    if (s < steps) {
      const uint64_t bh = desc_kmajor_f32(b_hi, s0 + s, R);
      const uint64_t bl = desc_kmajor_f32(b_lo, s0 + s, R);
      wgmma_tf32<NC>(acc, ah[s], bl, 1);
      wgmma_tf32<NC>(acc, al[s], bh, 1);
      wgmma_tf32<NC>(acc, ah[s], bh, 1);
    }
  }
}

// S rows 64 r .. 64 r + 63, columns c0 .. c0 + 63: C from global memory
// into A fragments, split in registers; B hi / lo from shared memory.
// Then, after every warpgroup is done with B hi / lo (which S
// overwrites), S into fragment order.
template <int N>
__device__ __forceinline__ void score_product(const float* __restrict__ cp,
                                              uint8_t* sm, int Q, int r,
                                              int c0, int warp, int lane) {
  using L = Smem<N>;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t b_hi = smem_addr(sm + L::BHL) + c0 * 128;  // row c0
  const uint32_t b_lo = b_hi + L::BHL_HALF;
  constexpr int NS = N / 8;
  constexpr int STEPS = NS < KC ? NS : KC;
  const int row0 = 64 * r + 16 * warp;
#pragma unroll
  for (int s0 = 0; s0 < NS; s0 += KC) {
    uint32_t ah[KC][4], al[KC][4];
#pragma unroll
    for (int s = 0; s < KC; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = row0 + tf32_frag_row(lane, k);
        const int n = 8 * (s0 + s) + tf32_frag_col(lane, k);
        const float v = (s < STEPS && i < Q) ? cp[(size_t)i * N + n] : 0.f;
        split_tf32(v, ah[s][k], al[s][k]);
      }
    fence_regs(acc);
    wgmma_fence();
    issue_steps<64>(acc, ah, al, b_hi, b_lo, s0, QMAX, STEPS);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cta_barrier();  // every warpgroup is done reading B hi / lo
  // accumulator register i: row 16 w + l / 4 + 8 ((i % 4) / 2), column
  // c0 + 8 (i / 4) + 2 (l % 4) + (i % 2); to fragment register (h + 2 e)
  // of the lane that holds (row, column) as an A operand
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c8 = 2 * (lane % 4) + (i % 2);
    const int h = (i % 4) / 2, e = c8 / 4;
    const int l2 = (lane / 4) * 4 + c8 % 4;
    *reinterpret_cast<float*>(
        sm + L::SF +
        frag_off(8 * r + c0 / 8 + i / 4, warp, l2, h + 2 * e)) = acc[i];
  }
}

// Group gi (KC k8 steps) of the y product's A: G = S o mask o decay at
// rows row0, row0 + 8 of warpgroup wg's tile, split.
template <int N>
__device__ __forceinline__ void y_frags(const uint8_t* sm, const float* da_s,
                                        int Q, int wg, int warp, int lane,
                                        int gi, uint32_t (&ah)[KC][4],
                                        uint32_t (&al)[KC][4]) {
  using L = Smem<N>;
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const float da_i[2] = {da_s[row0], da_s[row0 + 8]};
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    const int ks = KC * gi + s;
    const float4 sv = *reinterpret_cast<const float4*>(
        sm + L::SF + frag_off(8 * wg + ks, warp, lane, 0));
    const float svv[4] = {sv.x, sv.y, sv.z, sv.w};
    const int j0 = 8 * ks + lane % 4;
    const float da_j[2] = {da_s[j0], da_s[j0 + 4]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = row0 + 8 * (k % 2), j = j0 + 4 * (k / 2);
      float g = 0.f;
      if (j <= i && i < Q)
        g = svv[k] * ex2((da_i[k % 2] - da_j[k / 2]) * LOG2E);
      split_tf32(g, ah[s][k], al[s][k]);
    }
  }
}

// Group gi of the state product's A, split: N = 128, (B o w)^T at rows
// 64 wg + ..., from B in fragment order; N = 16, (x' o w)^T with x' = hi +
// lo read back from x^T.
template <int N>
__device__ __forceinline__ void state_frags(const uint8_t* sm,
                                            const float* w_s, int wg,
                                            int warp, int lane, int gi,
                                            uint32_t (&ah)[KC][4],
                                            uint32_t (&al)[KC][4]) {
  using L = Smem<N>;
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    const int ks = KC * gi + s;
    const int j0 = 8 * ks + lane % 4;
    if constexpr (N == 128) {
      const float4 bv = *reinterpret_cast<const float4*>(
          sm + L::BST + frag_off(16 * wg + ks, warp, lane, 0));
      const float bvv[4] = {bv.x, bv.y, bv.z, bv.w};
      const float w[2] = {w_s[j0], w_s[j0 + 4]};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_tf32(bvv[k] * w[k / 2], ah[s][k], al[s][k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 16 * warp + tf32_frag_row(lane, k);
        const int j = j0 + 4 * (k / 2);
        const int off = sw128_f32(p, j, P);
        const float xv =
            *reinterpret_cast<const float*>(sm + L::XT + off) +
            *reinterpret_cast<const float*>(sm + L::XT + L::XT_HALF + off);
        split_tf32(xv * w_s[j], ah[s][k], al[s][k]);
      }
    }
  }
}

// One head's products for warpgroup `role`: 0 and 1 take y's rows
// 0 .. 63 and 64 .. 127 (2 and 4 groups of KC k8 steps: the steps at or
// below the diagonal), 2 and 3 the state's rows 0 .. 63 and 64 .. 127
// (N = 128: state = (B o w)^T x), or 2 the whole state^T = (x o w)^T B
// (N = 16).  Each group is issued and waited for; the other warpgroups'
// fragments and products fill the wait.  Then the accumulator is stored.
template <int N, int ROLE>
__device__ __forceinline__ void head_products(const uint8_t* sm,
                                              const float* da_s,
                                              const float* w_s, int Q,
                                              int groups, int warp, int lane,
                                              float* __restrict__ yp,
                                              float* __restrict__ sp) {
  using L = Smem<N>;
  constexpr bool Y = ROLE < 2;
  constexpr int NC = Y || N == 128 ? 64 : 16;  // accumulator columns
  constexpr int TILE = Y ? ROLE : ROLE - 2;    // the 64-row tile of y / state
  // the B operand: x^T, or at N = 16 for the state B^T
  const uint32_t b_hi = smem_addr(sm + (Y || N == 128 ? L::XT : L::BST));
  const uint32_t b_lo = b_hi + (Y || N == 128 ? L::XT_HALF : L::BST_HALF);
  constexpr int R = Y || N == 128 ? P : N;     // its rows
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  for (int gi = 0; gi < groups; ++gi) {
    uint32_t ah[KC][4], al[KC][4];
    if constexpr (Y)
      y_frags<N>(sm, da_s, Q, TILE, warp, lane, gi, ah, al);
    else
      state_frags<N>(sm, w_s, TILE, warp, lane, gi, ah, al);
    fence_regs(acc);
    wgmma_fence();
    issue_steps<NC>(acc, ah, al, b_hi, b_lo, KC * gi, R);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  const int r0 = 64 * TILE + 16 * warp + lane / 4;  // rows r0, r0 + 8
  if constexpr (NC == 64) {
    float* out = Y ? yp : sp;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i % 4) / 2);
      if (!Y || row < Q)
        *reinterpret_cast<float2*>(out + (size_t)row * P + 8 * (i / 4) +
                                   2 * (lane % 4)) =
            make_float2(acc[i], acc[i + 1]);
    }
  } else {
    // state^T: register i at p = r0 + 8 ((i % 4) / 2), n = 8 (i / 4) +
    // 2 (l % 4) + (i % 2)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      const int n = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      sp[(size_t)n * P + r0 + 8 * ((i % 4) / 2)] = acc[i];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(threads<N>(), 1)
ssd_chunk_sm90_kernel(const float* __restrict__ c, const float* __restrict__ b,
                      const float* __restrict__ x,
                      const float* __restrict__ acum, float* __restrict__ y,
                      float* __restrict__ state, int T, int Q, int H,
                      int group) {
  using L = Smem<N>;
  constexpr int RS = L::RS;
  constexpr int NT = threads<N>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  float* da_s = reinterpret_cast<float*>(sm + L::DA);
  float* w_s = da_s + QMAX;

  const int pair = blockIdx.x;            // (batch, chunk)
  const int bt = pair / T, t = pair % T;
  const int h0 = blockIdx.y * group;
  const int nh = min(group, H - h0);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const size_t shared_chunk = (size_t)bt * T + t;
  auto chunk_of = [&](int hh) {
    return (size_t)(bt * H + h0 + hh) * T + t;
  };
  const uint32_t qp_bytes = (uint32_t)Q * P * 4;
  auto issue = [&](int hh) {
    const int slot = hh % RS;
    mbar_expect_tx(&full[slot], qp_bytes);
    bulk_load_1d(sm + L::RAW + slot * L::SLOT, x + chunk_of(hh) * Q * P,
                 qp_bytes, &full[slot]);
  };

  if (tid == 0) {
    for (int s = 0; s < RS; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int hh = 0; hh < RS && hh < nh; ++hh) issue(hh);
  // da of the first head, one ahead of its use from here on
  float da_next = 0.f, da_last_next = 0.f;
  auto load_da = [&](int hh) {
    const float* ap = acum + chunk_of(hh) * Q;
    if (tid < Q) da_next = ap[tid];
    da_last_next = ap[Q - 1];
  };
  load_da(0);

  // ---- B in the layouts the products read (rows past Q zero) -----------
  const float* bp = b + shared_chunk * Q * N;
#pragma unroll 4
  for (int e = tid; e < QMAX * (N / 4); e += NT) {
    const int j = e / (N / 4), n0 = e % (N / 4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < Q) {
      const float4 f =
          *reinterpret_cast<const float4*>(bp + (size_t)j * N + n0);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
    uint4 hi, lo;
    split4(v, hi, lo);
    // the score product's B operand: rows j, K = n
    *reinterpret_cast<uint4*>(sm + L::BHL + sw128_f32(j, n0, QMAX)) = hi;
    *reinterpret_cast<uint4*>(sm + L::BHL + L::BHL_HALF +
                              sw128_f32(j, n0, QMAX)) = lo;
    if constexpr (N == 128) {
      // the state's A operand (B o w)^T, rows n, K = j: raw B in fragment
      // order, n-tile m = n / 64 at k8 step 16 m + j / 8
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n0 + k;
        const int l2 = (n % 8) * 4 + j % 4;
        const int r = (n % 16) / 8 + 2 * ((j % 8) / 4);
        *reinterpret_cast<float*>(
            sm + L::BST + frag_off(16 * (n / 64) + j / 8, (n % 64) / 16, l2,
                                   r)) = v[k];
      }
    } else {
      // the state^T product's B operand B^T: rows n, K = j
      const uint32_t hv[4] = {hi.x, hi.y, hi.z, hi.w};
      const uint32_t lv[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = sw128_f32(n0 + k, j, N);
        *reinterpret_cast<uint32_t*>(sm + L::BST + off) = hv[k];
        *reinterpret_cast<uint32_t*>(sm + L::BST + L::BST_HALF + off) = lv[k];
      }
    }
  }
  fence_proxy_async();
  __syncthreads();

  // ---- S = C B^T once for the group of heads ----------------------------
  const float* cp = c + shared_chunk * Q * N;
  // rows 0-63 x columns 0-63; rows 64-127 x columns 0-63 and 64-127 (the
  // block above the diagonal is never needed)
  if (wg == 0)
    score_product<N>(cp, sm, Q, 0, 0, warp, lane);
  else if (wg <= 2 && Q > 64)
    score_product<N>(cp, sm, Q, 1, 64 * (wg - 1), warp, lane);
  else
    cta_barrier();  // no block of S: only the barrier

  const int qk = Q > 64 ? 128 : 64;  // K of the products
  for (int hh = 0; hh < nh; ++hh) {
    const int slot = hh % RS;
    __syncthreads();  // the previous head's products are done with x^T, da, w
    mbar_wait(&full[slot], (hh / RS) & 1);

    // ---- x^T hi / lo: thread (j-block, p), rows j0 .. j0 + 3 of column p
    // (every pass's loads issued together: the trip count is at most 4)
    const float* raw =
        reinterpret_cast<const float*>(sm + L::RAW + slot * L::SLOT);
#pragma unroll
    for (int it = 0; it < QMAX / 4 * P / NT + 1; ++it) {
      const int e = tid + it * NT;
      if (e >= qk / 4 * P) break;
      const int p = e % P, j0 = e / P * 4;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = j0 + k < Q ? raw[(j0 + k) * P + p] : 0.f;
      uint4 hi, lo;
      split4(v, hi, lo);
      *reinterpret_cast<uint4*>(sm + L::XT + sw128_f32(p, j0, P)) = hi;
      *reinterpret_cast<uint4*>(sm + L::XT + L::XT_HALF +
                                sw128_f32(p, j0, P)) = lo;
    }
    if (tid < QMAX) {
      da_s[tid] = tid < Q ? da_next : 0.f;
      w_s[tid] = tid < Q ? ex2((da_last_next - da_next) * LOG2E) : 0.f;
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0 && hh + RS < nh) {
      fence_proxy_async();  // the slot was read by the generic proxy
      issue(hh + RS);
    }
    if (hh + 1 < nh) load_da(hh + 1);
    const size_t chunk = chunk_of(hh);

    // ---- the products, one part a warpgroup ----------------------------
    float* yp = y + chunk * Q * P;
    float* sp = state + chunk * N * P;
    if (wg == 0)
      head_products<N, 0>(sm, da_s, w_s, Q, 2, warp, lane, yp, sp);
    else if (wg == 1 && Q > 64)
      head_products<N, 1>(sm, da_s, w_s, Q, 4, warp, lane, yp, sp);
    else if (wg == 2)
      head_products<N, 2>(sm, da_s, w_s, Q, qk / 32, warp, lane, yp, sp);
    else if constexpr (N == 128)
      if (wg == 3)
        head_products<N, 3>(sm, da_s, w_s, Q, qk / 32, warp, lane, yp, sp);
  }
}

template <int N>
cudaError_t launch(const float* c, const float* b, const float* x,
                   const float* acum, float* y, float* state, int G, int T,
                   int Q, int H, int group, cudaStream_t stream) {
  constexpr int smem = Smem<N>::BYTES;
  auto kern = ssd_chunk_sm90_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((G / H) * T, (H + group - 1) / group);
  kern<<<grid, threads<N>(), smem, stream>>>(c, b, x, acum, y, state, T, Q,
                                             H, group);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The argument list of ssd.cu's ssd_chunk, plus `group`, the heads one CTA
// walks (ops.heads_per_cta).  Returns cudaGetLastError() after the launch:
// cudaErrorInvalidValue for a shape or alignment it does not take (P must
// be 64, N 16 or 128).
extern "C" int ssd_chunk_sm90(const void* c, const void* b, const void* x,
                              const void* acum, void* y, void* state, int G,
                              int T, int Q, int N, int P_, int H, int group,
                              void* stream) {
  if (G < 1 || T < 1 || Q < 1 || Q > QMAX || H < 1 || G % H || P_ != P ||
      group < 1 || group > H || !aligned16(c) || !aligned16(b) ||
      !aligned16(x) || !aligned16(acum) || !aligned16(y) || !aligned16(state))
    return (int)cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(acum);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 128)
    return (int)launch<128>(cf, bf, xf, af, yf, sf, G, T, Q, H, group, st);
  if (N == 16)
    return (int)launch<16>(cf, bf, xf, af, yf, sf, G, T, Q, H, group, st);
  return (int)cudaErrorInvalidValue;
}
