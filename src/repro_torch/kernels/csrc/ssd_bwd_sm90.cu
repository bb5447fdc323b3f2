// Backward of the SSD (mamba2 state-space duality) intra-chunk product on
// Hopper's tensor cores (sm_90a): the route of kernels/ssd/ops.py
// (ops.ssd_bwd_route) for head_p 64 at d_state 16 and 128, mamba2's and
// hymba's widths.  head_p 16 stays on ssd_bwd.cu's FMA kernel.
//
// No TPU kernel to replace: the JAX package trains through
// src/repro/kernels/ssd/ref.py :: ssd_chunk_ref under XLA's autodiff.  Same
// function as ssd_bwd.cu (ref.ssd_chunk_bwd_ref): for every folded
// (batch * head) row g and chunk t, with C, B (Q, N) shared by the H heads
// of a batch row, xbar (Q, P) and the inclusive cumulative log-decay a,
//   S = C B^T,  L_ij = exp(a_i - a_j) (j <= i, else 0),  M = S o L,
//   w_j = exp(a_{Q-1} - a_j);  given dy (Q, P) and dstate (N, P):
//   dM = (dy xbar^T) o mask,  dS = dM o L,  Z = dM o M = dS o S,
//   U = B dstate,  dxbar = M^T dy + w o U,
//   da_i = sum_j Z_ij - sum_j Z_ji - v_i + [i = Q-1] sum_j v_j,
//          v_j = w_j (xbar_j . U_j),
//   and, as B and C do not depend on the head, with D = sum_h dS_h,
//   dc = D B,  db = D^T C + E,  E = sum_h (w_h o xbar_h) dstate_h^T.
//
// What bounds it on the H100: bytes, at mamba2's train shape by a little
// (0.131 ms of bytes against 0.122 ms of three-pass TF32 operations once
// the head sum takes the two Q x Q x N score products out of the head
// loop), hymba's by 2x.  What the design does about it:
//   * every product on the tensor cores, wgmma .tf32 in three passes
//     (hi lo + lo hi + hi hi, each operand split x = hi + lo): one pass
//     misses 1e-4 of max (tests/test_torch_ssd_bwd_sm90.py).  tf32 wgmma
//     reads its shared-memory operand K-major only, so each product's B
//     operand is written split and K-major once: B (rows j, K = n) for S;
//     per head dstate (rows n, K = p) for E and dstate^T (rows p, K = n)
//     for U, xbar (rows j, K = p) for dM and dy^T (rows p, K = i) for
//     dxbar; after the heads C^T and B^T (rows n, K = i / j) for db and
//     dc.  A operands (C, B, w o xbar, M^T, dy, D) are read in fragment
//     order and split in registers;
//   * one CTA a (batch, chunk) walks the heads that share its C and B:
//     S = C B^T once, kept in shared memory (f32, three 64 x 64 blocks on
//     or below the diagonal, rows 72 floats apart: both the dM tiles'
//     accumulator order and M^T's fragment order read it without bank
//     conflicts); each head applies its own mask and decay per element,
//     exp(a_i - a_j) on and below the diagonal and a select above it
//     (never e^a_i e^-a_j: a falls below -100);
//   * D and E are summed over the heads in the accumulators of the
//     warpgroup that owns each tile, in head order (deterministic, no
//     atomics), and dc, db are taken once, after the last head;
//   * each head's dstate, xbar and dy stream through a raw slot by 1-D
//     bulk copies (cp.async.bulk on an mbarrier), each issued as soon as
//     the slot's previous operand is split, so it lands while products
//     run; acum is read directly;
//   * two warpgroups of 128 threads, each owning the tiles of one 64-row
//     half: U, E and dxbar rows j (0-63 / 64-127), dM blocks (0,0) /
//     (1,0) and (1,1), db rows j, dc rows i; the same number of k8 steps
//     a head for each.  A warpgroup builds the next group of KC k8 steps'
//     fragments in a second register buffer while the tensor cores run
//     the last one (wait<1>); fragments read from global memory (C, B) are
//     loaded a group ahead.
// What sets its pace (tools/ssd_bwd_phases.py, PERF.md): the phases run
// one after another between CTA barriers, with the tensor cores idle
// during the copies' waits (one slot: a head's xbar and dy each wait on
// the split before them), the splits and the dM tiles' elementwise work.
//
// Shared memory (bytes): W0, W1 (64 KB each: the split operands, hi then
// lo), the raw slot (32 KB), S / D (54 KB), a, w, v and Z's partial sums
// (5 KB), one mbarrier: 226 KB at both widths (one CTA an SM).
//
// Any Q in [1, 128]: every product runs at Q = 128, rows past Q are zero
// in every operand and never stored, and a is padded with a[Q-1].
// Layouts, row-major f32: c, b, dc, db (G / H, T, Q, N); x, dy, dx (G, T,
// Q, P); acum, dacum (G, T, Q); dstate (G, T, N, P); all but acum and dacum
// 16-byte aligned.
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int NT = 256;       // two warpgroups
constexpr int QMAX = 128;
constexpr int P = 64;         // head_p
constexpr int KC = 2;         // k8 steps issued as one group
constexpr int SST = 72;       // row stride (floats) of a 64 x 64 block of S, D
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  static constexpr int W0 = 0;
  static constexpr int W1 = 65536;
  static constexpr int HALF = 32768;   // lo after hi, per-head operands
  static constexpr int SLOT = 131072;  // the raw operand in flight
  static constexpr int SB = SLOT + QMAX * P * 4;      // S, then D
  static constexpr int DA = SB + 3 * 64 * SST * 4;    // a, w, v
  static constexpr int ZR = DA + 3 * QMAX * 4;        // [3 blocks][64 rows]
  static constexpr int ZC = ZR + 3 * 64 * 4;          // [3][4 warps][64 cols]
  static constexpr int VW = ZC + 3 * 4 * 64 * 4;      // sum of v, [8 warps]
  static constexpr int BAR = VW + 8 * 4;
  static constexpr int BYTES = 1024 + BAR + 8;        // + 1024-byte alignment
};

// Block (ib, jb) of a lower-triangular Q x Q matrix: (0,0), (1,0), (1,1).
__device__ __forceinline__ int blk(int ib, int jb) { return ib + jb; }
__device__ __forceinline__ int sb_off(int b, int r, int c) {
  return (b * 64 + r) * SST + c;
}
// Entry (i, j), i >= j, of the lower-triangular matrix held in `sb`.
__device__ __forceinline__ float lower_at(const float* sb, int i, int j) {
  return sb[sb_off(blk(i / 64, j / 64), i % 64, j % 64)];
}

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [0, R) x K of a row-major matrix (`ld` floats a row, `live` rows,
// zero past them) into a K-major operand of R rows, split hi / lo.
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo,
                                           const float* src, int ld,
                                           int live, int R, int K, int tid) {
  const int k4 = K / 4;
  for (int e = tid; e < R * k4; e += NT) {
    const int r = e / k4, k0 = e % k4 * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < live) {
      const float4 f = *reinterpret_cast<const float4*>(src + (size_t)r * ld + k0);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
    uint4 h, l;
    split4(v, h, l);
    *reinterpret_cast<uint4*>(hi + sw128_f32(r, k0, R)) = h;
    *reinterpret_cast<uint4*>(lo + sw128_f32(r, k0, R)) = l;
  }
}

// The transpose: operand row r, K index k = src[k][r] (`ld` floats a src
// row, k < live, zero past), R rows x K, split hi / lo.
__device__ __forceinline__ void split_cols(uint8_t* hi, uint8_t* lo,
                                           const float* src, int ld,
                                           int live, int R, int K, int tid) {
  for (int e = tid; e < R * (K / 4); e += NT) {
    const int r = e % R, k0 = e / R * 4;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = k0 + q < live ? src[(size_t)(k0 + q) * ld + r] : 0.f;
    uint4 h, l;
    split4(v, h, l);
    *reinterpret_cast<uint4*>(hi + sw128_f32(r, k0, R)) = h;
    *reinterpret_cast<uint4*>(lo + sw128_f32(r, k0, R)) = l;
  }
}

// One group of KC k8 steps, three tf32 passes each, issued and committed:
// acc (+)= A B, A's fragments split in (ah, al), B K-major hi / lo at
// b_hi / b_lo with R rows a panel.
template <int NC>
__device__ __forceinline__ void issue_group(float (&acc)[NC / 2],
                                            const uint32_t (&ah)[KC][4],
                                            const uint32_t (&al)[KC][4],
                                            uint32_t b_hi, uint32_t b_lo,
                                            int s0, int R) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    const uint64_t bh = desc_kmajor_f32(b_hi, s0 + s, R);
    const uint64_t bl = desc_kmajor_f32(b_lo, s0 + s, R);
    wgmma_tf32<NC>(acc, ah[s], bl, 1);
    wgmma_tf32<NC>(acc, al[s], bh, 1);
    wgmma_tf32<NC>(acc, ah[s], bh, 1);
  }
  wgmma_commit();
}

// acc (+)= A B over k8 steps [s_begin, s_end) (a multiple of KC apart):
// group(s0, ah, al) builds the A fragments of steps s0 .. s0 + KC - 1,
// split, into one of two register buffers while the other buffer's group
// runs on the tensor cores (wait<1>: at most one group in flight behind
// the one just issued).
template <int NC, class Group>
__device__ __forceinline__ void product_g(float (&acc)[NC / 2], Group group,
                                          uint32_t b_hi, uint32_t b_lo,
                                          int R, int s_begin, int s_end) {
  uint32_t ah0[KC][4], al0[KC][4], ah1[KC][4], al1[KC][4];
  group(s_begin, ah0, al0);
  fence_regs(acc);
  issue_group<NC>(acc, ah0, al0, b_hi, b_lo, s_begin, R);
  for (int s0 = s_begin + KC; s0 < s_end; s0 += 2 * KC) {
    group(s0, ah1, al1);
    issue_group<NC>(acc, ah1, al1, b_hi, b_lo, s0, R);
    wgmma_wait<1>();  // buffer 0's group is done
    if (s0 + KC >= s_end) break;
    group(s0 + KC, ah0, al0);
    issue_group<NC>(acc, ah0, al0, b_hi, b_lo, s0 + KC, R);
    wgmma_wait<1>();  // buffer 1's group is done
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// product_g with frag(s, hi, lo) giving this thread's A fragment of step
// s, split.
template <int NC, class Frag>
__device__ __forceinline__ void product(float (&acc)[NC / 2], Frag frag,
                                        uint32_t b_hi, uint32_t b_lo, int R,
                                        int s_begin, int s_end) {
  product_g<NC>(
      acc,
      [&](int s0, uint32_t (&ah)[KC][4], uint32_t (&al)[KC][4]) {
#pragma unroll
        for (int s = 0; s < KC; ++s) frag(s0 + s, ah[s], al[s]);
      },
      b_hi, b_lo, R, s_begin, s_end);
}

// product() for A fragments loaded from global memory: load(s, v) gives
// the four f32 values of step s, loaded a group ahead of their split, so
// the loads' latency hides behind the tensor cores.
template <int NC, class Load>
__device__ __forceinline__ void product_ld(float (&acc)[NC / 2], Load load,
                                           uint32_t b_hi, uint32_t b_lo,
                                           int R, int s_begin, int s_end) {
  float raw[KC][4];
#pragma unroll
  for (int s = 0; s < KC; ++s) load(s_begin + s, raw[s]);
  product_g<NC>(
      acc,
      [&](int s0, uint32_t (&ah)[KC][4], uint32_t (&al)[KC][4]) {
#pragma unroll
        for (int s = 0; s < KC; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_tf32(raw[s][r], ah[s][r], al[s][r]);
        if (s0 + KC < s_end) {
#pragma unroll
          for (int s = 0; s < KC; ++s) load(s0 + KC + s, raw[s]);
        }
      },
      b_hi, b_lo, R, s_begin, s_end);
}

// The lane and the warp of the warpgroup, read from the special registers:
// inside the head loop the addresses derived from them are then recomputed
// each head (a few integer operations) instead of held in registers
// across the whole loop.
__device__ __forceinline__ int lane_now() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(l));
  return l;
}
__device__ __forceinline__ int warp_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return (t / 32) % 4;
}

// Accumulator register i of thread (warp, lane): row acc_row, column
// acc_col of the 64 x NC tile.
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

// A 64 x 64 accumulator into block b of S / D.
__device__ __forceinline__ void store_block(float* sb, int b,
                                            const float (&acc)[32], int warp,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(
        sb + sb_off(b, acc_row(warp, lane, i), acc_col(lane, i))) =
        make_float2(acc[i], acc[i + 1]);
}

// Rows r0 .. r0 + 63 of a row-major (., NC) output from a 64 x NC
// accumulator, rows past Q dropped.
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[NC / 2], int r0,
                                           int Q, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int row = r0 + acc_row(warp, lane, i);
    if (row < Q)
      *reinterpret_cast<float2*>(out + (size_t)row * NC + acc_col(lane, i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_bwd_sm90_kernel(const float* __restrict__ c,
                          const float* __restrict__ b,
                          const float* __restrict__ x,
                          const float* __restrict__ acum,
                          const float* __restrict__ dy,
                          const float* __restrict__ dstate,
                          float* __restrict__ dx, float* __restrict__ dacum,
                          float* __restrict__ dc, float* __restrict__ db,
                          int T, int Q, int H) {
  using L = Smem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t sa = smem_addr(sm);
  const float* slot = reinterpret_cast<const float*>(sm + L::SLOT);
  float* sb = reinterpret_cast<float*>(sm + L::SB);
  float* a_s = reinterpret_cast<float*>(sm + L::DA);
  float* w_s = a_s + QMAX;
  float* v_s = w_s + QMAX;
  float* zr = reinterpret_cast<float*>(sm + L::ZR);
  float* zc = reinterpret_cast<float*>(sm + L::ZC);
  float* vw = reinterpret_cast<float*>(sm + L::VW);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);

  const int pair = blockIdx.x;  // (batch, chunk)
  const int bt = pair / T, t = pair % T;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4,
            lane = tid % 32;
  const int r0 = 64 * wg;  // this warpgroup's 64 rows (j, or i for dc)
  const size_t shared_chunk = (size_t)bt * T + t;
  const float* cp = c + shared_chunk * Q * N;
  const float* bp = b + shared_chunk * Q * N;
  auto chunk_of = [&](int h) { return ((size_t)bt * H + h) * T + t; };

  // The slot: one bulk copy in flight at a time, waited for in issue order.
  uint32_t loads = 0;
  auto issue = [&](const float* src, uint32_t bytes) {  // thread 0
    fence_proxy_async();  // the slot was last read by the generic proxy
    mbar_expect_tx(full, bytes);
    bulk_load_1d(sm + L::SLOT, src, bytes, full);
  };
  auto wait_slot = [&]() {
    mbar_wait(full, loads & 1);
    ++loads;
  };
  if (tid == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) issue(dstate + chunk_of(0) * N * P, N * P * 4);

  // ---- S = C B^T once: B (rows j, K = n) hi in W0, lo in W1 ------------
  split_rows(sm + L::W0, sm + L::W1, bp, N, Q, QMAX, N, tid);
  fence_proxy_async();
  __syncthreads();
  auto score = [&](int ib, int jb) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    product_ld<64>(
        acc,
        [&](int s, float (&v)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 64 * ib + 16 * warp + tf32_frag_row(lane, r);
            const int n = 8 * s + tf32_frag_col(lane, r);
            v[r] = i < Q ? __ldg(cp + (size_t)i * N + n) : 0.f;
          }
        },
        sa + L::W0 + jb * 64 * 128, sa + L::W1 + jb * 64 * 128, QMAX, 0,
        N / 8);
    store_block(sb, blk(ib, jb), acc, warp, lane);
  };
  if (wg == 0) {
    score(0, 0);
    score(1, 0);
  } else {
    score(1, 1);
  }

  // the head sums: E (rows j of this warpgroup, n) and this warpgroup's
  // blocks of D: (0,0) in d0; (1,0) in d0 and (1,1) in d1
  float e_acc[N / 2], d0[32], d1[32];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) e_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;

  // a of a head (padded with a[Q-1]) and its last entry, one head ahead
  float a_next = 0.f, a_last_next = 0.f;
  auto load_a = [&](int h) {
    const float* ap = acum + chunk_of(h) * Q;
    if (tid < QMAX) a_next = __ldg(ap + min(tid, Q - 1));
    a_last_next = __ldg(ap + Q - 1);
  };
  load_a(0);

  for (int h = 0; h < H; ++h) {
    const size_t ch = chunk_of(h);
    const int lane = lane_now(), warp = warp_now();  // not hoisted
    __syncthreads();  // the previous head is done with W0, W1, a, w, v, Z
    if (tid < QMAX) {
      a_s[tid] = a_next;
      w_s[tid] = ex2((a_last_next - a_next) * LOG2E);
    }
    // ---- dstate: rows n, K = p into W0; the transpose rows p, K = n into W1
    wait_slot();
    split_rows(sm + L::W0, sm + L::W0 + L::HALF, slot, P, N, N, P, tid);
    split_cols(sm + L::W1, sm + L::W1 + L::HALF, slot, P, N, P, N, tid);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) issue(x + ch * Q * P, Q * P * 4);

    // ---- U = B dstate (the dxbar accumulator), then E += (w o xbar) dstate^T
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    product_ld<64>(
        acc,
        [&](int s, float (&v)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = r0 + 16 * warp + tf32_frag_row(lane, r);
            const int n = 8 * s + tf32_frag_col(lane, r);
            v[r] = j < Q ? __ldg(bp + (size_t)j * N + n) : 0.f;
          }
        },
        sa + L::W1, sa + L::W1 + L::HALF, P, 0, N / 8);
    wait_slot();  // xbar
    product<N>(
        e_acc,
        [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = r0 + 16 * warp + tf32_frag_row(lane, r);
            const int p = 8 * s + tf32_frag_col(lane, r);
            split_tf32(j < Q ? w_s[j] * slot[j * P + p] : 0.f, hi[r], lo[r]);
          }
        },
        sa + L::W0, sa + L::W0 + L::HALF, N, 0, P / 8);
    __syncthreads();  // W0 is free

    // ---- xbar: rows j, K = p into W0 -------------------------------------
    split_rows(sm + L::W0, sm + L::W0 + L::HALF, slot, P, Q, QMAX, P, tid);
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) issue(dy + ch * Q * P, Q * P * 4);
    {
      // v_j = w_j (xbar_j . U_j), xbar = hi + lo; then U becomes w o U
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int off = sw128_f32(r0 + acc_row(warp, lane, i), acc_col(lane, i),
                                  QMAX);
        const float xv =
            __uint_as_float(ld_u32(sm + L::W0 + off)) +
            __uint_as_float(ld_u32(sm + L::W0 + L::HALF + off));
        part[(i % 4) / 2] += xv * acc[i];
      }
      float vsum = 0.f;  // this warp's rows' v, summed
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 1);
        part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 2);
        const int j = r0 + 16 * warp + lane / 4 + 8 * hh;
        const float v = j < Q ? w_s[j] * part[hh] : 0.f;
        if (lane % 4 == 0) v_s[j] = v;
        vsum += lane % 4 == 0 ? v : 0.f;
      }
#pragma unroll
      for (int o = 4; o < 32; o *= 2)
        vsum += __shfl_xor_sync(0xffffffffu, vsum, o);
      if (lane == 0) vw[tid / 32] = vsum;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= w_s[r0 + acc_row(warp, lane, i)];
    }

    // ---- dy: the transpose, rows p, K = i, into W1 -----------------------
    wait_slot();
    split_cols(sm + L::W1, sm + L::W1 + L::HALF, slot, P, Q, P, QMAX, tid);
    fence_proxy_async();
    __syncthreads();
    if (h + 1 < H) {
      if (tid == 0) issue(dstate + chunk_of(h + 1) * N * P, N * P * 4);
      load_a(h + 1);
    }

    // ---- dxbar = w o U + M^T dy: A = M^T rows j, K = i >= j -----------------
    product<64>(
        acc,
        [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = r0 + 16 * warp + tf32_frag_row(lane, r);
            const int i = 8 * s + tf32_frag_col(lane, r);
            float m = 0.f;
            if (i >= j)
              m = lower_at(sb, i, j) * ex2((a_s[i] - a_s[j]) * LOG2E);
            split_tf32(m, hi[r], lo[r]);
          }
        },
        sa + L::W1, sa + L::W1 + L::HALF, P, 8 * wg, QMAX / 8);
    store_rows<64>(dx + ch * Q * P, acc, r0, Q, warp, lane);

    // ---- dM = dy xbar^T a block at a time: D += dS, Z's sums ---------------
    auto dm_block = [&](int ib, int jb, float (&d)[32]) {
      float m[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) m[i] = 0.f;
      product<64>(
          m,
          [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 64 * ib + 16 * warp + tf32_frag_row(lane, r);
              const int p = 8 * s + tf32_frag_col(lane, r);
              const int off = sw128_f32(p, i, P);  // dy^T, already split
              hi[r] = ld_u32(sm + L::W1 + off);
              lo[r] = ld_u32(sm + L::W1 + L::HALF + off);
            }
          },
          sa + L::W0 + jb * 64 * 128, sa + L::W0 + L::HALF + jb * 64 * 128,
          QMAX, 0, P / 8);
      // registers 4 c .. 4 c + 3: rows (rl, rl + 8) x columns (cl, cl + 1)
      const int bb = blk(ib, jb);
      float rz[2] = {0.f, 0.f};
#pragma unroll
      for (int cg = 0; cg < 8; ++cg) {
        float cz[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 4 * cg; i < 4 * cg + 4; i += 2) {
          const int rl = acc_row(warp, lane, i), cl = acc_col(lane, i);
          const float2 sv =
              *reinterpret_cast<const float2*>(sb + sb_off(bb, rl, cl));
          const float svv[2] = {sv.x, sv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ii = 64 * ib + rl, jj = 64 * jb + cl + e;
            if (jj <= ii) {
              const float ds = m[i + e] * ex2((a_s[ii] - a_s[jj]) * LOG2E);
              d[i + e] += ds;
              const float z = ds * svv[e];
              rz[(i % 4) / 2] += z;
              cz[e] += z;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 4);
          cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 8);
          cz[e] += __shfl_xor_sync(0xffffffffu, cz[e], 16);
          if (lane < 4)
            zc[(bb * 4 + warp) * 64 + 8 * cg + 2 * lane + e] = cz[e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rz[hh] += __shfl_xor_sync(0xffffffffu, rz[hh], 1);
        rz[hh] += __shfl_xor_sync(0xffffffffu, rz[hh], 2);
        if (lane % 4 == 0) zr[bb * 64 + 16 * warp + lane / 4 + 8 * hh] = rz[hh];
      }
    };
    if (wg == 0) {
      dm_block(0, 0, d0);
    } else {
      dm_block(1, 0, d0);
      dm_block(1, 1, d1);
    }
    __syncthreads();  // Z's sums and v are in

    // ---- dacum: Z's row sum minus its column sum, minus v (plus sum v) ----
    if (tid < Q) {
      const int il = tid % 64;
      float z, zcol = 0.f;
      if (tid < 64) {
        z = zr[il];
#pragma unroll
        for (int w = 0; w < 4; ++w) zcol += zc[w * 64 + il];
#pragma unroll
        for (int w = 0; w < 4; ++w) zcol += zc[(4 + w) * 64 + il];
      } else {
        z = zr[64 + il] + zr[128 + il];
#pragma unroll
        for (int w = 0; w < 4; ++w) zcol += zc[(8 + w) * 64 + il];
      }
      float da = z - zcol - v_s[tid];
      if (tid == Q - 1)
#pragma unroll
        for (int k = 0; k < 8; ++k) da += vw[k];
      dacum[ch * Q + tid] = da;
    }
  }

  // ---- after the heads: D into S's place, then db and dc once -------------
  __syncthreads();  // every head is done with S, W0 and W1
  if (wg == 0) {
    store_block(sb, 0, d0, warp, lane);
  } else {
    store_block(sb, 1, d0, warp, lane);
    store_block(sb, 2, d1, warp, lane);
  }
  // C^T (rows n, K = i) hi in W0, lo in W1
  split_cols(sm + L::W0, sm + L::W1, cp, N, Q, N, QMAX, tid);
  fence_proxy_async();
  __syncthreads();
  // db = E + D^T C: A = D^T rows j, K = i >= j
  product<N>(
      e_acc,
      [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = r0 + 16 * warp + tf32_frag_row(lane, r);
          const int i = 8 * s + tf32_frag_col(lane, r);
          split_tf32(i >= j ? lower_at(sb, i, j) : 0.f, hi[r], lo[r]);
        }
      },
      sa + L::W0, sa + L::W1, N, 8 * wg, QMAX / 8);
  store_rows<N>(db + shared_chunk * Q * N, e_acc, r0, Q, warp, lane);
  __syncthreads();  // every warpgroup is done with C^T
  // B^T (rows n, K = j) hi in W0, lo in W1
  split_cols(sm + L::W0, sm + L::W1, bp, N, Q, N, QMAX, tid);
  fence_proxy_async();
  __syncthreads();
  // dc = D B: A = D rows i, K = j <= i
  float c_acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c_acc[i] = 0.f;
  product<N>(
      c_acc,
      [&](int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + 16 * warp + tf32_frag_row(lane, r);
          const int j = 8 * s + tf32_frag_col(lane, r);
          split_tf32(j <= i ? lower_at(sb, i, j) : 0.f, hi[r], lo[r]);
        }
      },
      sa + L::W0, sa + L::W1, N, 0, 8 * wg + 8);
  store_rows<N>(dc + shared_chunk * Q * N, c_acc, r0, Q, warp, lane);
}

template <int N>
cudaError_t launch(const float* c, const float* b, const float* x,
                   const float* acum, const float* dy, const float* dstate,
                   float* dx, float* dacum, float* dc, float* db, int G, int T,
                   int Q, int H, cudaStream_t stream) {
  constexpr int smem = Smem::BYTES;
  auto kern = ssd_chunk_bwd_sm90_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<(G / H) * T, NT, smem, stream>>>(c, b, x, acum, dy, dstate, dx,
                                           dacum, dc, db, T, Q, H);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The argument list of ssd_bwd.cu's ssd_chunk_bwd.  Returns
// cudaGetLastError() after the launch: cudaErrorInvalidValue for a shape
// or alignment it does not take (P must be 64, N 16 or 128).
extern "C" int ssd_chunk_bwd_sm90(const void* c, const void* b,
                                  const void* x, const void* acum,
                                  const void* dy, const void* dstate,
                                  void* dx, void* dacum, void* dc, void* db,
                                  int G, int T, int Q, int N, int P_, int H,
                                  void* stream) {
  const void* ptrs[] = {c, b, x, dy, dstate, dx, dc, db};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (G < 1 || T < 1 || Q < 1 || Q > QMAX || H < 1 || G % H || P_ != P)
    return (int)cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(acum);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(dstate);
  float* dxf = static_cast<float*>(dx);
  float* daf = static_cast<float*>(dacum);
  float* dcf = static_cast<float*>(dc);
  float* dbf = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 128)
    return (int)launch<128>(cf, bf, xf, af, dyf, dsf, dxf, daf, dcf, dbf, G,
                            T, Q, H, st);
  if (N == 16)
    return (int)launch<16>(cf, bf, xf, af, dyf, dsf, dxf, daf, dcf, dbf, G,
                           T, Q, H, st);
  return (int)cudaErrorInvalidValue;
}
