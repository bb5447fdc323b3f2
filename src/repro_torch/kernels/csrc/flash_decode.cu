// Split-K GQA decode attention over an int8 KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kvq/kernel.py
// :: flash_decode_pallas (body _flash_decode_kernel), both of its masks.  One
// new token per row: q (B, Hkv, G, D) f32 attends over the int8 cache
// k, v (B, Hkv, S, D) with f32 per-token scales (B, Hkv, S), dequantized
// after the load, and either masked to the first lengths[b] positions
// (entry flash_decode) or offset by a dense (B, S) f32 bias added to every
// logit (entry flash_decode_bias: a window band that lengths cannot
// express).  With a bias every position is visited, as on the TPU; a run
// of entries that are all -1e30 (finite) gets m = -1e30 and drops out with
// weight exp(-1e30 - m) = 0 against any live max, never as NaN.  The KV
// axis is cut into tiles of bs tokens and the tiles into `nsp` splits of
// `spt` tiles each (tiling.resolve_decode_grid).  Given no m / l buffers
// (one split) the kernel normalises and writes (B, Hkv, G, D); given them
// (always with several splits, and at one split for the partials form
// that a sequence-sharded decode merges across devices) it writes
// unnormalised partials acc (B, Hkv, nsp, G, D), m, l (B, Hkv, nsp, G)
// that kvq/ops.py::combine_splits merges.  counts[b, h, split] is the
// number of bs tiles of the split whose start lies below the row's length
// (tiling.decode_tile_step_counts); a split with no live token writes
// (0, -1e30, 0).
//
// What bounds it on the H100: bytes.  It reads about
// B * Hkv * sum(len) * (2 D + 8) bytes of cache (1 byte per element and a
// 4-byte scale per token, for K and V; len = S with a bias, which adds 4
// bytes a position) and does only 4 G D FLOPs per cached token, far below
// the 295 FLOP/byte ridge, so 3.35 TB/s of HBM is the limit; at serving
// sizes the launch and the first load's latency are comparable to it.
//
// What the design does about it:
//  * The card is filled whatever the batch.  A unit is one (row, KV head,
//    split, group of GH query heads); a cluster of C CTAs shares the
//    unit's live span.  C is the largest size up to 8 whose whole grid the
//    card holds at once (cudaOccupancyMaxActiveClusters) and that leaves
//    each warp a block, so hymba's 40 units at one split run as 200 CTAs.
//    Only tokens below the row's length are read.  GH <= 5 keeps a CTA's
//    query slice in registers; a larger G (6, 8, 16) runs G / GH groups of
//    CTAs, each reading the cache again.
//  * Memory-level parallelism.  The span is cut into 32-token blocks (the
//    kernel's own size, crossing bs tiles freely) and every warp owns a
//    contiguous run of them (tiling.decode_warp_blocks), streamed through
//    its own shared-memory ring (3 stages at D = 64, 2 at D = 128 and
//    160): lane 0
//    issues one 1-D bulk copy of the block's live K rows and one of its V
//    rows on the stage's mbarrier, and refills a stage as soon as the warp
//    has read it.  Every warp's first block is requested before any warp's
//    later ones, so compute starts as early as it can.  The scales and the
//    bias row (4 bytes a token, rows not 16-byte aligned unless S % 4 == 0)
//    are read by the lane that owns the token, one block ahead.
//  * No block-wide barrier in the loop.  A warp keeps its own online-
//    softmax state (m, l, acc) in registers, in log2 units, and moves its
//    max only when a score passes it by more than 8 (p <= 2^8), so most
//    blocks skip the warp-wide max and the rescale.  The only waits are its
//    ring's mbarriers and two __syncwarp.  Warps merge once at the end
//    through shared memory; each CTA then stores its state into rank 0 of
//    the cluster with st.async, counted on one mbarrier there, and rank 0
//    merges the CTAs in rank order and writes the output.
//  * Scores: K rows are read 16 bytes a lane (D / 16 lanes a row; at
//    D = 160, 20 bytes a lane, 8 lanes a row, so a row's lanes stay a power
//    of two), each lane's partial dot products over the 32 / KR steps are
//    reduce-scattered across the row's lanes, so each lane ends with the
//    full scores of one token for all GH heads.  Values: 8 bytes a lane
//    (10 at D = 160, 16 lanes a row), p read back from a per-warp buffer
//    as float4 broadcasts.
//  * int8 -> f32 without I2F (a quarter-rate instruction): the biased byte
//    is permuted into the mantissa of 2^23 and one FADD removes 2^23 + 128.
//  * One copy of the loop body (about 1,340 instructions at GH = 5,
//    D = 64; tools/decode_phases.py --sass): a launch runs it a few times
//    a warp, so fetching more code would cost more than it saves.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NW = 4;           // warps a CTA
constexpr int NT = 32 * NW;
constexpr int TB = 32;          // tokens a streamed block, one a lane
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int MAX_HEADS = 5;    // query heads a CTA keeps in registers
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A block moves a warp's max (and rescales its state) only when one of its
// scores passes the max by more than this, in log2 units: p <= 2^8.
constexpr float RESCALE_AT = 8.f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* lengths;  // the lengths path, else nullptr
  const float* bias;   // the dense-bias path, else nullptr
  float* out;
  float* m_p;
  float* l_p;
  int* counts;
  int B, Hkv, G, S, bs, ns, spt, nsp;
  float sm_scale;
};

// Shared memory of one CTA, in bytes.
template <int GH, int D>
struct Smem {
  static constexpr int NS = D == 64 ? 3 : 2;   // ring stages a warp
  static constexpr int SLOT = 2 * TB * D;      // a stage: K rows, V rows
  static constexpr int ST = GH * D + 2 * GH;   // a state: acc, m, l floats
  static constexpr int STS = (ST + 3) / 4 * 4;  // its slot, 16-byte aligned
  static constexpr int RING = 0;                          // [NW][NS][SLOT]
  static constexpr int QW = RING + NW * NS * SLOT;        // [NW][GH][D] q
  static constexpr int BARS = QW + NW * GH * D * 4;       // [NW][NS] rings
  static constexpr int CBAR = BARS + NW * NS * 8;         // the cluster's
  static constexpr int PBUF = CBAR + 16;                  // [NW][GH][TB] p
  static constexpr int SLOTS = PBUF + NW * GH * TB * 4;   // [C][STS]
  static constexpr int bytes(int C) { return SLOTS + C * STS * 4; }
};

// Four int8 of a word as exact floats: byte b + 128 in the mantissa of
// 2^23 is the float 2^23 + 128 + b.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
}

// a where `mask` is all ones, else b: one LOP3, and never turned into a
// select of two array indices (which would put the array in local memory)
__device__ __forceinline__ float blend(uint32_t mask, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & mask) |
                         (__float_as_uint(b) & ~mask));
}

template <int GH, int D>
__global__ void __launch_bounds__(NT, 2) decode_kernel(const Args a) {
  using L = Smem<GH, D>;
  constexpr int NS = L::NS, SLOT = L::SLOT, ST = L::ST;
  static_assert(D == 64 || D == 128 || D == 160, "D is 64, 128 or 160");
  // K: lanes a row, bytes a lane, rows a step; V likewise.  A row's lanes
  // are a power of two (the reduce-scatter and the row sums step by xor).
  constexpr int KL = D == 64 ? 4 : 8, KB = D / KL, KR = 32 / KL;
  constexpr int LOG_KL = KL == 8 ? 3 : 2;
  constexpr int VL = D == 64 ? 8 : 16, VB = D / VL, VR = 32 / VL;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* cbar = reinterpret_cast<uint64_t*>(smem + L::CBAR);
  float* slots = reinterpret_cast<float*>(smem + L::SLOTS);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x / C;
  const int split = blockIdx.y % a.nsp, hg = blockIdx.y / a.nsp;
  const int b = (int)(bh / a.Hkv);
  const int S = a.S;
  const int len = a.bias != nullptr ? S : a.lengths[b];
  const int tlo = split * a.spt, thi = min(tlo + a.spt, a.ns);
  const int lo = tlo * a.bs, e = min(thi * a.bs, len);
  const int nbt = max(0, e - lo + TB - 1) / TB;  // live blocks of the unit
  // this warp's run of blocks (tiling.decode_warp_blocks)
  const int nwt = C * NW, w = rank * NW + warp;
  const int blk0 = (int)((long long)w * nbt / nwt);
  const int nb = (int)((long long)(w + 1) * nbt / nwt) - blk0;
  const int t0 = lo + blk0 * TB;

  const int8_t* kp = a.kq + bh * S * D;
  const int8_t* vp = a.vq + bh * S * D;
  const float* ksp = a.ks + bh * S;
  const float* vsp = a.vs + bh * S;
  const float* brow = a.bias != nullptr ? a.bias + (size_t)b * S : nullptr;
  uint8_t* ring = smem + L::RING + warp * NS * SLOT;
  float* qw = reinterpret_cast<float*>(smem + L::QW) + warp * GH * D;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BARS) + warp * NS;
  float* pw = reinterpret_cast<float*>(smem + L::PBUF) + warp * GH * TB;

  const int ksub = lane % KL, kgrp = lane / KL;
  const int vsub = lane % VL, vgrp = lane / VL;
  const int own = ksub * KR + kgrp;              // the row whose score I hold
  const int own_p = (own % VR) * VL + own / VR;  // its p in value order

  // my row's K scale, V scale and bias in block i (0 past the span)
  auto scales = [&](int i, float& sk, float& sv, float& sb) {
    const int t = t0 + i * TB + own;
    if (i < nb && t < e) {
      sk = __ldg(ksp + t);
      sv = __ldg(vsp + t);
      sb = brow != nullptr ? __ldg(brow + t) : 0.f;
    }
  };
  // lane 0: block i's live K and V rows into stage i % NS (with block 0,
  // the warp's copy of the query group)
  auto issue = [&](int i) {
    const int t = t0 + i * TB;
    const uint32_t bytes = (uint32_t)min(TB, e - t) * D;
    const uint32_t qbytes = i == 0 ? GH * D * 4 : 0;
    uint8_t* dst = ring + (i % NS) * SLOT;
    uint64_t* br = &bar[i % NS];
    sm90::mbar_expect_tx(br, 2 * bytes + qbytes);
    if (i == 0)
      sm90::bulk_load_1d(qw, a.q + (bh * a.G + hg * GH) * D, qbytes, br);
    sm90::bulk_load_1d(dst, kp + (size_t)t * D, bytes, br);
    sm90::bulk_load_1d(dst + TB * D, vp + (size_t)t * D, bytes, br);
  };

  // every warp's first block is requested before any warp's later ones:
  // the first blocks arrive first and the warps start computing sooner
  if (lane == 0) {
    if (warp == 0 && rank == 0) sm90::mbar_init(cbar, 1);
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::fence_barrier_init();
    // the cluster's C states, ST floats each, land on rank 0's cbar
    if (warp == 0 && rank == 0) sm90::mbar_expect_tx(cbar, C * ST * 4);
    if (nb > 0) issue(0);
  }
  __syncwarp();
  sm90::cluster_arrive();  // rank 0's cbar is ready (waited for at the end)
  float sk = 0.f, sv = 0.f, sb = 0.f;
  scales(0, sk, sv, sb);
  if (lane == 0)
    for (int i = 1; i < min(NS, nb); ++i) issue(i);
  float m[GH], l[GH], acc[GH][VB];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < VB; ++x) acc[g][x] = 0.f;
  }
  if (nb > 0) sm90::mbar_wait(&bar[0], 0);
  float qr[GH][KB];  // my KB-dim slice of every head's query
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int x = 0; x < KB; x += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(qw + g * D + KB * ksub + x);
      qr[g][x] = v.x;
      qr[g][x + 1] = v.y;
      qr[g][x + 2] = v.z;
      qr[g][x + 3] = v.w;
    }

#pragma unroll 1  // one copy of the body: the code stays in the i-cache
  for (int i = 0; i < nb; ++i) {
    float nk = 0.f, nv = 0.f, nbias = 0.f;
    scales(i + 1, nk, nv, nbias);
    const int rows = min(TB, e - (t0 + i * TB));
    sm90::mbar_wait(&bar[i % NS], (i / NS) & 1);
    const uint8_t* kb = ring + (i % NS) * SLOT;
    const uint8_t* vb = kb + TB * D;

    // partial scores: step j, rows j * KR + kgrp, my KB dims of each
    float part[KL][GH];
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const uint8_t* krow = kb + (j * KR + kgrp) * D + KB * ksub;
      float kf[KB];
      if constexpr (KB == 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow);
        i8x4_to_f32(raw.x, kf);
        i8x4_to_f32(raw.y, kf + 4);
        i8x4_to_f32(raw.z, kf + 8);
        i8x4_to_f32(raw.w, kf + 12);
      } else {  // 20 bytes: five 4-byte words
#pragma unroll
        for (int w4 = 0; w4 < KB / 4; ++w4)
          i8x4_to_f32(reinterpret_cast<const uint32_t*>(krow)[w4],
                      kf + 4 * w4);
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < KB; ++x) s = fmaf(qr[g][x], kf[x], s);
        part[j][g] = s;
      }
    }
    // reduce-scatter over the row's KL lanes: lane ksub keeps step ksub
#pragma unroll
    for (int lv = 0; lv < LOG_KL; ++lv) {
      const int o = KL >> (lv + 1);
      const uint32_t up = (ksub & o) != 0 ? ~0u : 0u;
#pragma unroll
      for (int x = 0; x < o; ++x)
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float send = blend(up, part[x][g], part[x + o][g]);
          const float keep = blend(up, part[x + o][g], part[x][g]);
          part[x][g] = keep + __shfl_xor_sync(FULL, send, o);
        }
    }

    // online softmax over the block in log2 units, the warp's own state
    const bool live = own < rows;
    float s2[GH];
    bool over = false;
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      s2[g] = live ? (part[0][g] * sk * a.sm_scale + sb) * LOG2E
                   : __uint_as_float(0xff800000u);  // -inf: p = 0
      over |= s2[g] > m[g] + RESCALE_AT;
    }
    if (__any_sync(FULL, over)) {
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float mx = s2[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float mn = fmaxf(m[g], mx);
        const float alpha = sm90::ex2(m[g] - mn);
        l[g] *= alpha;
#pragma unroll
        for (int x = 0; x < VB; ++x) acc[g][x] *= alpha;
        m[g] = mn;
      }
    }
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float p = sm90::ex2(s2[g] - m[g]);
      l[g] += p;
      pw[g * TB + own_p] = p * sv;
    }
    __syncwarp();

    // acc += (p * v_scale) v_int8: step r, rows r * VR + vgrp, my VB dims
#pragma unroll
    for (int r0 = 0; r0 < VL; r0 += 4) {
      float pv[GH][4];
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(pw + g * TB + vgrp * VL + r0);
        pv[g][0] = x4.x;
        pv[g][1] = x4.y;
        pv[g][2] = x4.z;
        pv[g][3] = x4.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint8_t* vrow = vb + ((r0 + r) * VR + vgrp) * D + VB * vsub;
        float vf[VB];
        if constexpr (VB == 8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(vrow);
          i8x4_to_f32(raw.x, vf);
          i8x4_to_f32(raw.y, vf + 4);
        } else {  // 10 bytes at a 2-byte offset: five 2-byte loads
          const uint16_t* h = reinterpret_cast<const uint16_t*>(vrow);
          float tail[4];
          i8x4_to_f32(h[0] | (uint32_t)h[1] << 16, vf);
          i8x4_to_f32(h[2] | (uint32_t)h[3] << 16, vf + 4);
          i8x4_to_f32(h[4], tail);
          vf[8] = tail[0];
          vf[9] = tail[1];
        }
#pragma unroll
        for (int g = 0; g < GH; ++g)
#pragma unroll
          for (int x = 0; x < VB; ++x)
            acc[g][x] = fmaf(pv[g][r], vf[x], acc[g][x]);
      }
    }
    __syncwarp();  // the stage and pw are free again
    if (lane == 0 && i + NS < nb) {
      sm90::fence_proxy_async();
      issue(i + NS);
    }
    sk = nk;
    sv = nv;
    sb = nbias;
  }

  // the warp's state into its drained ring: acc summed over the VR row
  // groups, l over the lanes
#pragma unroll
  for (int g = 0; g < GH; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
    for (int o = VL; o < 32; o <<= 1)
#pragma unroll
      for (int x = 0; x < VB; ++x)
        acc[g][x] += __shfl_xor_sync(FULL, acc[g][x], o);
  }
  float* ws = reinterpret_cast<float*>(ring);
  if (vgrp == 0)
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      if constexpr (VB == 8) {
        float4* dst = reinterpret_cast<float4*>(ws + g * D + 8 * vsub);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      } else {  // 10 floats at an 8-byte aligned offset
        float2* dst = reinterpret_cast<float2*>(ws + g * D + VB * vsub);
#pragma unroll
        for (int x = 0; x < VB; x += 2)
          dst[x / 2] = make_float2(acc[g][x], acc[g][x + 1]);
      }
    }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      ws[GH * D + g] = m[g];
      ws[GH * D + GH + g] = l[g];
    }
  __syncthreads();

  // the CTA's state, its warps merged in order, stored into slot `rank` of
  // the cluster's rank 0, each store counted on rank 0's cbar
  auto wstate = [&](int v) {
    return reinterpret_cast<const float*>(smem + L::RING + v * NS * SLOT);
  };
  // the warps' weights in head g's merge; returns the merged m
  auto weights = [&](int g, float (&wgt)[NW]) {
    float mx = NEG_INF;
#pragma unroll
    for (int v = 0; v < NW; ++v) mx = fmaxf(mx, wstate(v)[GH * D + g]);
#pragma unroll
    for (int v = 0; v < NW; ++v)
      wgt[v] = sm90::ex2(wstate(v)[GH * D + g] - mx);
    return mx;
  };
  sm90::cluster_wait();  // rank 0's cbar is initialised
  const uint32_t rbar = sm90::cluster_addr(cbar, 0);
  float* dst = slots + rank * L::STS;
  for (int x = 4 * tid; x < GH * D; x += 4 * NT) {
    float wgt[NW];
    weights(x / D, wgt);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float4 a4 = *reinterpret_cast<const float4*>(wstate(v) + x);
      s.x += a4.x * wgt[v];
      s.y += a4.y * wgt[v];
      s.z += a4.z * wgt[v];
      s.w += a4.w * wgt[v];
    }
    sm90::st_async(sm90::cluster_addr(dst + x, 0), s, rbar);
  }
  if (tid < GH) {
    float wgt[NW];
    const float mx = weights(tid, wgt);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) s += wstate(v)[GH * D + GH + tid] * wgt[v];
    sm90::st_async(sm90::cluster_addr(dst + GH * D + tid, 0), mx, rbar);
    sm90::st_async(sm90::cluster_addr(dst + GH * D + GH + tid, 0), s, rbar);
  }
  if (rank != 0) return;

  // rank 0: the cluster's states merged in rank order
  sm90::mbar_wait_cluster(cbar, 0);
  const size_t head0 = (bh * a.nsp + split) * a.G + hg * GH;
  for (int x = tid; x < ST - GH; x += NT) {
    const int g = x < GH * D ? x / D : x - GH * D;
    float mx = NEG_INF;
    for (int c = 0; c < C; ++c)
      mx = fmaxf(mx, slots[c * L::STS + GH * D + g]);
    float s = 0.f, ll = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* st = slots + c * L::STS;
      const float wgt = sm90::ex2(st[GH * D + g] - mx);
      if (x < GH * D) s += st[x] * wgt;
      ll += st[GH * D + GH + g] * wgt;
    }
    if (x < GH * D) {
      a.out[head0 * D + x] = a.m_p == nullptr ? s / fmaxf(ll, 1e-30f) : s;
    } else if (a.m_p != nullptr) {
      // natural units for combine_splits; a dead state keeps the sentinel
      a.m_p[head0 + g] = mx == NEG_INF ? NEG_INF : mx * LN2;
      a.l_p[head0 + g] = ll;
    }
  }
  if (a.counts != nullptr && hg == 0 && tid == 0)
    a.counts[bh * a.nsp + split] =
        max(0, min(thi, (len + a.bs - 1) / a.bs) - tlo);
}

// Clusters of C CTAs the card holds at once (0 if it cannot launch them).
template <int GH, int D>
int resident_clusters(int C) {
  static int cache[MAX_CLUSTER + 1] = {};
  if (cache[C] == 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = Smem<GH, D>::bytes(C);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, decode_kernel<GH, D>, &cfg) !=
        cudaSuccess)
      n = 0;
    cache[C] = n > 0 ? n : -1;
  }
  return max(cache[C], 0);
}

// CTAs a cluster: the largest C <= 8 whose grid the card holds in one wave
// and whose warps each get a block of the longest split's span; else 1.
template <int GH, int D>
int cluster_size(int units, int span) {
  const int blocks = (span + TB - 1) / TB;
  for (int c = MAX_CLUSTER; c > 1; --c)
    if (c * NW <= blocks && units <= resident_clusters<GH, D>(c)) return c;
  return 1;
}

template <int GH, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Smem<GH, D>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<GH, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(MAX_CLUSTER));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int groups = a.G / GH;
  const int units = a.B * a.Hkv;
  const int C = cluster_size<GH, D>(units * a.nsp * groups, a.spt * a.bs);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units * C, a.nsp * groups, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = L::bytes(C);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<GH, D>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// GH: the largest divisor of G that is at most MAX_HEADS
template <int D>
cudaError_t dispatch_g(const Args& a, cudaStream_t st) {
  switch (a.G) {
    case 1: return launch<1, D>(a, st);
    case 2: return launch<2, D>(a, st);
    case 3:
    case 6: return launch<3, D>(a, st);
    case 4:
    case 8:
    case 16: return launch<4, D>(a, st);
    case 5: return launch<5, D>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MAX_HEADS == 5, "dispatch_g maps G to its heads a CTA");

cudaError_t dispatch(const void* q, const void* kq, const void* ks,
                     const void* vq, const void* vs, const void* lengths,
                     const void* bias, void* out, void* m_p, void* l_p,
                     void* counts, int B, int Hkv, int G, int S, int D,
                     int bs, int ns, int spt, int nsp, float sm_scale,
                     void* stream) {
  // the bulk copies take 16-byte aligned rows
  if (B < 1 || Hkv < 1 || bs < 1 || bs > 512 || ns * bs != S || nsp < 1 ||
      spt < 1 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(kq) % 16 ||
      reinterpret_cast<uintptr_t>(vq) % 16 ||
      (m_p == nullptr) != (l_p == nullptr) || (nsp > 1 && m_p == nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.kq = static_cast<const int8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const int8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.m_p = static_cast<float*>(m_p);
  a.l_p = static_cast<float*>(l_p);
  a.counts = static_cast<int*>(counts);
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.S = S;
  a.bs = bs;
  a.ns = ns;
  a.spt = spt;
  a.nsp = nsp;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // every head dim by name: no other D reaches a kernel
    case 64: return dispatch_g<64>(a, st);
    case 128: return dispatch_g<128>(a, st);
    case 160: return dispatch_g<160>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape they do not take: G not in {1, 2, 3, 4, 5, 6, 8, 16}, D not in
// {64, 128, 160}, a cache not 16-byte aligned, several splits without m / l
// buffers).  Given m_p and l_p they write unnormalised partials at any
// split count; without them (one split only) the normalised output.
// The lengths path: lengths (B,) int32.
extern "C" int flash_decode(const void* q, const void* kq, const void* ks,
                            const void* vq, const void* vs,
                            const void* lengths, void* out, void* m_p,
                            void* l_p, void* counts, int B, int Hkv, int G,
                            int S, int D, int bs, int ns, int spt, int nsp,
                            float sm_scale, void* stream) {
  if (lengths == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, kq, ks, vq, vs, lengths, nullptr, out, m_p, l_p,
                       counts, B, Hkv, G, S, D, bs, ns, spt, nsp, sm_scale,
                       stream);
}

// The dense-bias path: bias (B, S) f32 added to every logit, every
// position visited.
extern "C" int flash_decode_bias(const void* q, const void* kq,
                                 const void* ks, const void* vq,
                                 const void* vs, const void* bias, void* out,
                                 void* m_p, void* l_p, void* counts, int B,
                                 int Hkv, int G, int S, int D, int bs, int ns,
                                 int spt, int nsp, float sm_scale,
                                 void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, kq, ks, vq, vs, nullptr, bias, out, m_p, l_p,
                       counts, B, Hkv, G, S, D, bs, ns, spt, nsp, sm_scale,
                       stream);
}
