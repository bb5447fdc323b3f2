// Causal / windowed GQA flash-attention backward for Hopper (sm_90a):
// three kernels, run in this order by kernels/flash/ops.py.
//
// Replaces the TPU kernels of src/repro/kernels/flash/kernel.py
// :: flash_attention_bwd_pallas -- _bwd_delta_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel.  Same functions, not the same block structure:
//
//   delta  D = rowsum(dO * O), f32, one value per query row;
//   dQ     P = exp(S - (m + log max(l, 1e-30))) from the forward's saved
//          row stats, masked entries exactly 0; dS = P * (dO V^T - D);
//          dQ = dS K * scale;
//   dKV    dV = sum P^T dO and dK = sum dS^T Q * scale, summed over the
//          query heads of the GQA group and the live q tiles.
//
// The TPU grids carry their accumulators in VMEM scratch from one
// sequential grid step to the next.  Blocks on Hopper run in no order, so
// each block owns one output tile and loops over its inputs itself:
//   dQ:  one block per (64-row q tile, b*h); an in-block loop over exactly
//        the KV tiles in [lo, hi] of tiling.kv_tile_bounds (the forward's
//        bounds), reading KV head bh / group;
//   dKV: one block per (64-row KV tile, b*hkv); a loop over the group's
//        query heads and, inside it, the q tiles in [lo, hi] of
//        tiling.q_tile_bounds.  A KV tile wholly at or past kv_len writes
//        zeros and visits nothing.  No atomics: every output element is
//        written once by one block, so results are deterministic.
//
// What bounds it on the H100: tensor-core FLOPs -- five 64 x 64 x D
// products per live tile pair (the recomputed Q K^T and dO V^T in both
// kernels, then dS K, P^T dO and dS^T Q), at 989 TFLOP/s bf16.  What this
// first design does about it: nothing yet -- it is simple and right
// first.  Operands are staged in shared memory as f32 and multiplied with
// plain FMAs at CUDA-core rates, each of the 256 threads owning a 4 x 4
// score tile and a 4 x D/16 accumulator tile, as in flash_fwd.cu.  K^T,
// V^T, Q^T and dO^T are stored transposed with a stride of 64 + 1, which
// keeps both of their uses (score products and accumulation) free of bank
// conflicts.  The staging takes up to 166 KB at head_dim 128 (178 KB for
// dQ and 195 KB for dKV at 160), so the kernels opt in to more than 48 KB
// of dynamic shared memory.
//
// Which combinations run here (kernels/flash/ops.py bwd_route): delta
// takes every supported one.  dQ and dKV take f32 and bf16 residuals under
// f32 compute at head_dim 16 / 64 / 128 / 160 -- they are held to 1e-4 of the
// f32 plain version, which bf16 tensor-core products cannot meet -- and
// the all-bf16 combination at head_dim 16 only.  The all-bf16 combination
// at head_dim 64 / 128 / 160 is flash_bwd_sm90.cu's (wgmma on TMA-fed rings);
// these entry points return cudaErrorInvalidValue for it.
//
// Ragged S: q rows at or past S load as zeros, are masked out of P and
// are never written; keys at or past kv_len are masked, so their dK/dV
// rows come out exactly 0.  A row whose every key is masked has P = 0.
//
// Layouts, row-major: q, o, dO (B*H, S, D); k, v (B*Hkv, S, D); m, l,
// delta (B*H, S) f32; dq like q, dk/dv like k, in the gradient dtype;
// counts (B*H, n_q) for dQ and (B*Hkv, n_k) for dKV, int32, optional.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int TS = 65;  // stride of a transposed [D][64] or a [64][64] tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The causal / window / kv_len predicate of _position_mask, plus the
// ragged-S row guard.
__device__ __forceinline__ bool live(int row, int col, int S, int causal,
                                     int window, int kv_len) {
  bool ok = row < S && col < kv_len;
  if (causal) {
    ok = ok && row >= col;
    if (window > 0) ok = ok && (row - col) < window;
  }
  return ok;
}

// tiling.kv_tile_bounds(qi, bq=64, bk=64, causal, window, kv_len)
__device__ __forceinline__ void kv_bounds(int qi, int causal, int window,
                                          int kv_len, int* lo, int* hi) {
  const int hi_valid = (kv_len + BK - 1) / BK - 1;
  *lo = 0;
  *hi = hi_valid;
  if (causal) {
    *hi = min(hi_valid, ((qi + 1) * BQ - 1) / BK);
    if (window > 0) {
      *lo = max(0, (qi * BQ - (window - 1)) / BK);
      *hi = max(*hi, *lo);
    }
  }
}

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

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp per row, 8 rows per 256-thread block.
// ---------------------------------------------------------------------------
template <typename TR, typename TG>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const TR* __restrict__ o, const TG* __restrict__ dout,
                       float* __restrict__ delta, int rows, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (NT / 32) + warp;
  if (row >= (size_t)rows) return;
  const TR* op = o + row * D;
  const TG* gp = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(op[d]), to_f32(gp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh).
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO [BQ][D+1]; K^T, V^T [D][TS]; dS [BQ][TS]
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * D * TS + BQ * TS);
}

template <typename TR, typename TG, typename TO, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const TR* __restrict__ q, const TR* __restrict__ k,
                    const TR* __restrict__ v, const TG* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, TO* __restrict__ dq,
                    int* __restrict__ counts, int S, int group, int causal,
                    int window, int kv_len, float sm_scale) {
  constexpr int QS = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][QS]
  float* dOs = Qs + BQ * QS;      // [BQ][QS]
  float* Kt = dOs + BQ * QS;      // [D][TS]
  float* Vt = Kt + D * TS;        // [D][TS]
  float* dSs = Vt + D * TS;       // [BQ][TS]

  const int n_q = (S + BQ - 1) / BQ;
  const int qi = n_q - 1 - blockIdx.x;  // late (heavy) q tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx + 16 j, dq columns tx + 16 c
  const int ty = tid / 16;  // rows 4 ty .. 4 ty + 3 of the q tile
  const size_t qoff = (size_t)bh * S * D;
  const size_t kvoff = (size_t)(bh / group) * S * D;

  int lo, hi;
  kv_bounds(qi, causal, window, kv_len, &lo, &hi);

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = qi * BQ + r;
    const bool in = row < S;
    Qs[r * QS + d] = in ? to_f32(q[qoff + (size_t)row * D + d]) : 0.f;
    dOs[r * QS + d] = in ? to_f32(dout[qoff + (size_t)row * D + d]) : 0.f;
  }
  float lse[4], dlt[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty * 4 + i;
    const bool in = row < S;
    const size_t at = (size_t)bh * S + (in ? row : 0);
    lse[i] = in ? m[at] + logf(fmaxf(l[at], 1e-30f)) : 0.f;
    dlt[i] = in ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt <= hi; ++kt) {
    __syncthreads();  // previous tile's K^T / dS reads are done (Q is in)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int kr = kt * BK + c;
      const bool in = kr < S;
      Kt[d * TS + c] = in ? to_f32(k[kvoff + (size_t)kr * D + d]) : 0.f;
      Vt[d * TS + c] = in ? to_f32(v[kvoff + (size_t)kr * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * QS + d];
        gv[i] = dOs[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Kt[d * TS + tx + 16 * j];
        vv[j] = Vt[d * TS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qi * BQ + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BK + tx + 16 * j;
        const float p = live(row, col, S, causal, window, kv_len)
                            ? expf(s[i][j] * sm_scale - lse[i])
                            : 0.f;
        dSs[(ty * 4 + i) * TS + tx + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();

    // dQ += dS K: K[c][d] is K^T[d][c]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * TS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kv[cc] = Kt[(tx + 16 * cc) * TS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(sv[i], kv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty * 4 + i;
    if (row >= S) continue;
    TO* out = dq + qoff + (size_t)row * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) store(out + tx + 16 * cc, acc[i][cc] * sm_scale);
  }
  if (counts != nullptr && tid == 0) counts[(size_t)bh * n_q + qi] = hi - lo + 1;
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (KV tile, bhkv).
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V [BK][D+1]; Q^T, dO^T [D][TS]; P^T, dS^T [BK][TS]; lse, delta [BQ]
  return sizeof(float) *
         (2 * BK * (D + 1) + 2 * D * TS + 2 * BK * TS + 2 * BQ);
}

template <typename TR, typename TG, typename TO, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const TR* __restrict__ q, const TR* __restrict__ k,
                     const TR* __restrict__ v, const TG* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, TO* __restrict__ dk,
                     TO* __restrict__ dv, int* __restrict__ counts, int S,
                     int group, int causal, int window, int kv_len,
                     float sm_scale) {
  constexpr int KS = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][KS]
  float* Vs = Ks + BK * KS;      // [BK][KS]
  float* Qt = Vs + BK * KS;      // [D][TS]
  float* dOt = Qt + D * TS;      // [D][TS]
  float* Pt = dOt + D * TS;      // [BK][TS]: P^T, key rows x query columns
  float* dSt = Pt + BK * TS;     // [BK][TS]
  float* lse_s = dSt + BK * TS;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  const int n_q = (S + BQ - 1) / BQ;
  const int n_k = (S + BK - 1) / BK;
  const int kt = blockIdx.x;
  const int bhkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query columns tx + 16 j, dk/dv columns tx + 16 c
  const int ty = tid / 16;  // key rows 4 ty .. 4 ty + 3 of the KV tile
  const size_t kvoff = (size_t)bhkv * S * D;

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const bool tile_live = kt * BK < kv_len;
  int lo, hi;
  q_bounds(kt, n_q, causal, window, kv_len, &lo, &hi);
  if (tile_live) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int kr = kt * BK + r;
      const bool in = kr < S;
      Ks[r * KS + d] = in ? to_f32(k[kvoff + (size_t)kr * D + d]) : 0.f;
      Vs[r * KS + d] = in ? to_f32(v[kvoff + (size_t)kr * D + d]) : 0.f;
    }
    for (int g = 0; g < group; ++g) {
      const int bh = bhkv * group + g;
      const size_t qoff = (size_t)bh * S * D;
      for (int qt = lo; qt <= hi; ++qt) {
        __syncthreads();  // previous step's Q^T / dO^T / P^T / dS^T reads
        for (int idx = tid; idx < BQ * D; idx += NT) {
          const int r = idx / D, d = idx % D;
          const int row = qt * BQ + r;
          const bool in = row < S;
          Qt[d * TS + r] = in ? to_f32(q[qoff + (size_t)row * D + d]) : 0.f;
          dOt[d * TS + r] =
              in ? to_f32(dout[qoff + (size_t)row * D + d]) : 0.f;
        }
        if (tid < BQ) {
          const int row = qt * BQ + tid;
          const bool in = row < S;
          const size_t at = (size_t)bh * S + (in ? row : 0);
          lse_s[tid] = in ? m[at] + logf(fmaxf(l[at], 1e-30f)) : 0.f;
          dlt_s[tid] = in ? delta[at] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T for this thread's 4 x 4 entries
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kv[i] = Ks[(ty * 4 + i) * KS + d];
            vv[i] = Vs[(ty * 4 + i) * KS + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qv[j] = Qt[d * TS + tx + 16 * j];
            gv[j] = dOt[d * TS + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = kt * BK + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qj = tx + 16 * j;
            const int row = qt * BQ + qj;
            const float p = live(row, col, S, causal, window, kv_len)
                                ? expf(s[i][j] * sm_scale - lse_s[qj])
                                : 0.f;
            Pt[(ty * 4 + i) * TS + qj] = p;
            dSt[(ty * 4 + i) * TS + qj] = p * (dp[i][j] - dlt_s[qj]);
          }
        }
        __syncthreads();

        // dV += P^T dO and dK += dS^T Q: dO[j][d] is dO^T[d][j]
#pragma unroll 2
        for (int j = 0; j < BQ; ++j) {
          float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = Pt[(ty * 4 + i) * TS + j];
            sv[i] = dSt[(ty * 4 + i) * TS + j];
          }
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            gv[cc] = dOt[(tx + 16 * cc) * TS + j];
            qv[cc] = Qt[(tx + 16 * cc) * TS + j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < DC; ++cc) {
              dv_acc[i][cc] = fmaf(pv[i], gv[cc], dv_acc[i][cc]);
              dk_acc[i][cc] = fmaf(sv[i], qv[cc], dk_acc[i][cc]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = kt * BK + ty * 4 + i;
    if (kr >= S) continue;
    TO* krow = dk + kvoff + (size_t)kr * D;
    TO* vrow = dv + kvoff + (size_t)kr * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      store(krow + tx + 16 * cc, dk_acc[i][cc] * sm_scale);
      store(vrow + tx + 16 * cc, dv_acc[i][cc]);
    }
  }
  if (counts != nullptr && tid == 0)
    counts[(size_t)bhkv * n_k + kt] = tile_live ? group * (hi - lo + 1) : 0;
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *delta;
  void *out0, *out1;
  int* counts;
  int bh, bhkv, S, causal, window, kv_len;
  float sm_scale;
  cudaStream_t stream;
};

template <typename TR, typename TG, typename TO, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_bwd_dq_kernel<TR, TG, TO, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.bh);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const TR*>(a.q), static_cast<const TR*>(a.k),
      static_cast<const TR*>(a.v), static_cast<const TG*>(a.dout), a.m, a.l,
      a.delta, static_cast<TO*>(a.out0), a.counts, a.S, a.bh / a.bhkv,
      a.causal, a.window, a.kv_len, a.sm_scale);
  return cudaGetLastError();
}

template <typename TR, typename TG, typename TO, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_bwd_dkv_kernel<TR, TG, TO, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BK - 1) / BK, a.bhkv);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const TR*>(a.q), static_cast<const TR*>(a.k),
      static_cast<const TR*>(a.v), static_cast<const TG*>(a.dout), a.m, a.l,
      a.delta, static_cast<TO*>(a.out0), static_cast<TO*>(a.out1), a.counts,
      a.S, a.bh / a.bhkv, a.causal, a.window, a.kv_len, a.sm_scale);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16.  The (residual, dO, gradient)
// combinations the policies produce: f32 (0,0,0), bf16 (1,1,1), and
// bf16-saved residuals under f32 compute (1,0,0).  dQ / dKV take bf16
// (1,1,1) at head_dim 16 only: at 64, 128 and 160 it goes to
// flash_bwd_sm90.cu (kernels/flash/ops.py bwd_route).
template <bool DKV, typename TR, typename TG, typename TO, int D>
cudaError_t launch(const Args& a) {
  if constexpr (DKV)
    return launch_dkv<TR, TG, TO, D>(a);
  else
    return launch_dq<TR, TG, TO, D>(a);
}

template <bool DKV, typename TR, typename TG, typename TO>
cudaError_t by_dim(const Args& a, int D) {
  if (D == 160) return launch<DKV, TR, TG, TO, 160>(a);
  if (D == 128) return launch<DKV, TR, TG, TO, 128>(a);
  if (D == 64) return launch<DKV, TR, TG, TO, 64>(a);
  if (D == 16) return launch<DKV, TR, TG, TO, 16>(a);  // smoke configs
  return cudaErrorInvalidValue;
}

// The all-bf16 combination at head_dim 64 / 128 / 160 is flash_bwd_sm90.cu's;
// here it is taken at head_dim 16 only (the smoke configurations).
template <bool DKV>
cudaError_t dispatch(const Args& a, int D, int rdt, int gdt, int odt) {
  using bf = __nv_bfloat16;
  if (rdt == 0 && gdt == 0 && odt == 0) return by_dim<DKV, float, float, float>(a, D);
  if (rdt == 1 && gdt == 1 && odt == 1)
    return D == 16 ? launch<DKV, bf, bf, bf, 16>(a) : cudaErrorInvalidValue;
  if (rdt == 1 && gdt == 0 && odt == 0) return by_dim<DKV, bf, float, float>(a, D);
  return cudaErrorInvalidValue;
}

bool bad_shape(int bh, int bhkv, int S, int kv_len) {
  return bhkv <= 0 || bh % bhkv != 0 || S < 1 || kv_len < 0 || kv_len > S;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int flash_bwd_delta(const void* o, const void* dout, void* delta,
                               int bh, int S, int D, int rdt, int gdt,
                               void* stream) {
  if (bh < 1 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int rows = bh * S;
  const dim3 grid((rows + NT / 32 - 1) / (NT / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  using bf = __nv_bfloat16;
  if (rdt == 0 && gdt == 0)
    flash_bwd_delta_kernel<float, float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl,
        rows, D);
  else if (rdt == 1 && gdt == 1)
    flash_bwd_delta_kernel<bf, bf><<<grid, NT, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), dl, rows, D);
  else if (rdt == 1 && gdt == 0)
    flash_bwd_delta_kernel<bf, float><<<grid, NT, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const float*>(dout), dl, rows,
        D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* m, const void* l,
                            const void* delta, void* dq, void* counts, int bh,
                            int bhkv, int S, int D, int rdt, int gdt, int odt,
                            int causal, int window, int kv_len,
                            float sm_scale, void* stream) {
  if (bad_shape(bh, bhkv, S, kv_len)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout,
         static_cast<const float*>(m), static_cast<const float*>(l),
         static_cast<const float*>(delta), dq, nullptr,
         static_cast<int*>(counts), bh, bhkv, S, causal, window, kv_len,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch<false>(a, D, rdt, gdt, odt);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* delta, void* dk, void* dv,
                             void* counts, int bh, int bhkv, int S, int D,
                             int rdt, int gdt, int odt, int causal,
                             int window, int kv_len, float sm_scale,
                             void* stream) {
  if (bad_shape(bh, bhkv, S, kv_len)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout,
         static_cast<const float*>(m), static_cast<const float*>(l),
         static_cast<const float*>(delta), dk, dv,
         static_cast<int*>(counts), bh, bhkv, S, causal, window, kv_len,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch<true>(a, D, rdt, gdt, odt);
}
