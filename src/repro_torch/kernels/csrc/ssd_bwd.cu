// Backward of the SSD (mamba2 state-space duality) intra-chunk product for
// Hopper (sm_90a), f32 FMA: the route of kernels/ssd/ops.py
// (ops.ssd_bwd_route) for head_p 16, the smoke configurations' width, on no
// full-size path.  head_p 64 (mamba2's and hymba's widths) goes to the
// tensor-core ssd_bwd_sm90.cu.
//
// No TPU kernel to replace: the JAX package trains through
// src/repro/kernels/ssd/ref.py :: ssd_chunk_ref under XLA's autodiff (the
// Pallas kernel src/repro/kernels/ssd/kernel.py :: ssd_chunk_pallas has no
// backward).  This is the backward of the forward that ssd_sm90.cu and
// ssd.cu compute, for every folded (batch * head) row g and chunk t, with
// C, B (Q, N) shared by the H heads of a batch row, xbar (Q, P) and the
// inclusive cumulative log-decay a (Q,):
//   S = C B^T,  L_ij = exp(a_i - a_j) (j <= i, else 0),  M = S o L
//   y = M xbar,  w_j = exp(a_{Q-1} - a_j),  state = B^T (w o xbar).
// Given dy (Q, P) and dstate (N, P) it returns, recomputing S, L and w from
// the saved inputs (no (Q, Q) tensor is kept between forward and backward):
//   dM  = (dy xbar^T) o mask,  dS = dM o L,  Z = dM o M,  U = B dstate
//   dxbar = M^T dy + w o U
//   dc    = sum_heads dS B
//   db    = sum_heads dS^T C + w o (xbar dstate^T)
//   da_i  = sum_j Z_ij - sum_j Z_ji - w_i (xbar_i . U_i)
//           + [i = Q-1] sum_j w_j (xbar_j . U_j)
//
// What bounds it on the H100: operations.  At mamba2's widths at head_p
// 16 a (batch, chunk) pair's 24 heads take ~190 MFLOP of products as this
// kernel runs them (the scores, dS B and dS^T C once a head) on ~1.1 MB of
// operands, above the f32 FMA ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// What the design does: one CTA of 256 threads a (batch, chunk) pair walks
// the H heads that share its C and B, so the head sum of dc and db is
// taken in a fixed order by the thread that owns each output tile (the
// first head stores, the others add to what it stored: deterministic, no
// atomics, C and B never broadcast over the heads).  Each head runs four
// phases over one shared region, every product from register tiles on
// 16-byte shared loads:
//   A. S (8 x 8 tiles on or below the diagonal, C / B staged 16 columns of
//      N at a time), M = S o L into shared memory, dM = dy xbar^T, then
//      dS = dM o L into shared memory and Z's row and column sums;
//   B. dxbar = M^T dy + w o U (B / dstate staged 16 rows of N at a time),
//      the per-row xbar . U, and da;
//   C. B staged whole over M: dc += dS B;
//   D. C staged whole over M, dstate over dy: db += dS^T C + (w o xbar)
//      dstate^T.
// A simple kernel that is right: the tiles are not fed by TMA, nothing
// overlaps a phase with the next, and the 136 tiles of phase A leave 120
// threads idle.
//
// Shapes: any Q in [1, 128] (rows past Q are zero in every staged operand
// and never stored), N in {16, 128}, P = 16 (cudaErrorInvalidValue at 64).  Layouts, row-major
// f32: c, b, dc, db (G / H, T, Q, N); x, dy, dx (G, T, Q, P); acum, dacum
// (G, T, Q); dstate (G, T, N, P); all 16-byte aligned.  Shared memory at
// Q = 128, N = 128, P = 16: 174 KB (one CTA an SM).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int QMAX = 128;
constexpr int NK = 16;       // N step of the staged score and U products
constexpr int KS = NK + 4;   // row stride of a staged 16-column tile

__host__ __device__ inline int qpad(int q) { return (q + 7) / 8 * 8; }

// The shared region, in floats, phase by phase (see the header).
template <int N, int P>
struct Layout {
  static constexpr int XS = P + 4;  // row stride of x, dy, dstate
  static constexpr int NS = N + 4;  // row stride of a whole C or B
  int qp, ms;                       // Q rounded up to 8; row stride of M, dS
  int r_m, r_ds, r_x, r_dy, r_st, total;
  __host__ __device__ explicit Layout(int q) {
    qp = qpad(q);
    ms = qp + 4;
    const int m = qp * (ms > NS ? ms : NS);
    const int dy = qp * XS > N * XS ? qp * XS : N * XS;
    int st = 2 * qp * KS;                                  // A: C, B tiles
    st = st > qp * KS + NK * XS ? st : qp * KS + NK * XS;  // B: B, dstate
    st = st > 2 * qp * (qp / 8) ? st : 2 * qp * (qp / 8);  // A: Z sums
    st = st > qp * (P / 4) ? st : qp * (P / 4);            // B: x . U
    r_m = 0;
    r_ds = r_m + m;
    r_x = r_ds + qp * ms;
    r_dy = r_x + qp * XS;
    r_st = r_dy + dy;
    total = r_st + st + 4 * qp;  // + a, w, Z sums, w (x . U)
  }
};

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ inline float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ inline float at(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [0, qp) x cols [0, cols) of a row-major global matrix of `rows` live
// rows and `ld` columns into shared memory at row stride `stride`, zero
// past `rows`; cols a multiple of 4
__device__ inline void stage(float* dst, int stride, const float* src,
                             int ld, int rows, int qp, int cols, int tid) {
  const int c4 = cols / 4;
  for (int e = tid; e < qp * c4; e += NT) {
    const int i = e / c4, k = e % c4 * 4;
    st4(dst + i * stride + k,
        i < rows ? ld4(src + (size_t)i * ld + k) : make_float4(0, 0, 0, 0));
  }
}

template <int N, int P>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ c, const float* __restrict__ b,
                     const float* __restrict__ x,
                     const float* __restrict__ acum,
                     const float* __restrict__ dy,
                     const float* __restrict__ dstate,
                     float* __restrict__ dx, float* __restrict__ dacum,
                     float* __restrict__ dc, float* __restrict__ db, int T,
                     int Q, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout<N, P> lay(Q);
  constexpr int XS = Layout<N, P>::XS, NS = Layout<N, P>::NS;
  const int qp = lay.qp, ms = lay.ms, nt = qp / 8;
  float* sM = sm + lay.r_m;    // M; then B, then C, whole
  float* sdS = sm + lay.r_ds;  // dS
  float* sx = sm + lay.r_x;    // xbar
  float* sdy = sm + lay.r_dy;  // dy; then dstate, whole
  float* sst = sm + lay.r_st;  // staged tiles and partial sums
  float* sa = sm + lay.total - 4 * qp;  // a
  float* sw = sa + qp;         // w
  float* sz = sw + qp;         // sum_j Z_ij - sum_j Z_ji
  float* sv = sz + qp;         // w_j (xbar_j . U_j)

  const int t = blockIdx.x, gb = blockIdx.y, tid = threadIdx.x;
  const size_t shared_chunk = (size_t)gb * T + t;
  const float* cp = c + shared_chunk * Q * N;
  const float* bp = b + shared_chunk * Q * N;
  float* dcp = dc + shared_chunk * Q * N;
  float* dbp = db + shared_chunk * Q * N;

  // phase A's tile: the tid-th 8 x 8 tile on or below the diagonal
  const bool live_a = tid < nt * (nt + 1) / 2;
  int ty = 0, tx = tid;
  while (tx > ty) tx -= ++ty;
  const int ia = ty * 8, ja = tx * 8;
  // phase B's tile: 8 rows j x 4 columns p of dxbar
  constexpr int PT = P / 4;
  const bool live_b = tid < nt * PT;
  const int jb = tid / PT * 8, pb = tid % PT * 4;
  // phases C and D: 8 rows x 8 columns n of dc / db
  constexpr int NT8 = N / 8;
  const bool live_cd = tid < nt * NT8;
  const int rc = tid / NT8 * 8, nc = tid % NT8 * 8;

  for (int h = 0; h < H; ++h) {
    const size_t chunk = ((size_t)gb * H + h) * T + t;
    const float* xp = x + chunk * Q * P;
    const float* dyp = dy + chunk * Q * P;
    const float* dsp = dstate + chunk * N * P;
    const float* ap = acum + chunk * Q;
    __syncthreads();  // the previous head's phase D is done with everything
    for (int i = tid; i < qp; i += NT) sa[i] = ap[i < Q ? i : Q - 1];
    stage(sx, XS, xp, P, Q, qp, P, tid);
    stage(sdy, XS, dyp, P, Q, qp, P, tid);
    __syncthreads();
    for (int i = tid; i < qp; i += NT) sw[i] = expf(sa[Q - 1] - sa[i]);

    // ---- A: S, M = S o L, dM, dS = dM o L, Z's sums ----------------------
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    for (int k0 = 0; k0 < N; k0 += NK) {
      stage(sst, KS, cp + k0, N, Q, qp, NK, tid);
      stage(sst + qp * KS, KS, bp + k0, N, Q, qp, NK, tid);
      __syncthreads();
      if (live_a) {
#pragma unroll
        for (int k = 0; k < NK; k += 4) {
          float4 cv[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) cv[r] = ld4(sst + (ia + r) * KS + k);
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const float4 bv = ld4(sst + qp * KS + (ja + s) * KS + k);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r][s] += dot4(cv[r], bv);
          }
        }
      }
      __syncthreads();  // the tiles are restaged next step
    }
    if (live_a) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int i = ia + r, j = ja + s;
          sM[i * ms + j] = j <= i ? acc[r][s] * expf(sa[i] - sa[j]) : 0.f;
          acc[r][s] = 0.f;
        }
#pragma unroll 4
      for (int p = 0; p < P; p += 4) {
        float4 dv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) dv[r] = ld4(sdy + (ia + r) * XS + p);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const float4 xv = ld4(sx + (ja + s) * XS + p);
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][s] += dot4(dv[r], xv);
        }
      }
      float zr[8], zc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) zr[r] = zc[r] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int i = ia + r, j = ja + s;
          float ds = 0.f;
          if (j <= i) {
            ds = acc[r][s] * expf(sa[i] - sa[j]);
            const float z = acc[r][s] * sM[i * ms + j];
            zr[r] += z;
            zc[s] += z;
          }
          sdS[i * ms + j] = ds;
        }
      // row sums by column tile, column sums by row tile (sst is free:
      // the last score step ended on a barrier)
#pragma unroll
      for (int r = 0; r < 8; ++r) sst[(ia + r) * nt + tx] = zr[r];
#pragma unroll
      for (int s = 0; s < 8; ++s) sst[qp * nt + (ja + s) * nt + ty] = zc[s];
    }
    __syncthreads();
    for (int i = tid; i < qp; i += NT) {
      float z = 0.f;
      for (int k = 0; k <= i / 8; ++k) z += sst[i * nt + k];
      for (int k = i / 8; k < nt; ++k) z -= sst[qp * nt + i * nt + k];
      sz[i] = z;
    }
    __syncthreads();  // sst is restaged below

    // ---- B: dxbar = M^T dy + w o U, U = B dstate ---------------------------
    float ax[8][4], au[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[r][e] = au[r][e] = 0.f;
    if (live_b) {
      for (int i = jb; i < qp; ++i) {  // M[i][j] = 0 for i < j
        const float4 m0 = ld4(sM + i * ms + jb), m1 = ld4(sM + i * ms + jb + 4);
        const float4 dv = ld4(sdy + i * XS + pb);
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) ax[r][e] = fmaf(mv[r], at(dv, e), ax[r][e]);
      }
    }
    for (int k0 = 0; k0 < N; k0 += NK) {
      stage(sst, KS, bp + k0, N, Q, qp, NK, tid);
      stage(sst + qp * KS, XS, dsp + (size_t)k0 * P, P, NK, NK, P, tid);
      __syncthreads();
      if (live_b) {
#pragma unroll
        for (int k = 0; k < NK; k += 4) {
          float4 dv[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            dv[kk] = ld4(sst + qp * KS + (k + kk) * XS + pb);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 bv = ld4(sst + (jb + r) * KS + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                au[r][e] = fmaf(at(bv, kk), at(dv[kk], e), au[r][e]);
          }
        }
      }
      __syncthreads();
    }
    if (live_b) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = jb + r;
        const float wj = sw[j];
        const float4 xv = ld4(sx + j * XS + pb);
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) v = fmaf(at(xv, e), au[r][e], v);
        sst[j * PT + tid % PT] = v;
        if (j < Q)
          st4(dx + chunk * Q * P + (size_t)j * P + pb,
              make_float4(fmaf(wj, au[r][0], ax[r][0]),
                          fmaf(wj, au[r][1], ax[r][1]),
                          fmaf(wj, au[r][2], ax[r][2]),
                          fmaf(wj, au[r][3], ax[r][3])));
      }
    }
    __syncthreads();
    for (int j = tid; j < qp; j += NT) {
      float v = 0.f;
      for (int k = 0; k < PT; ++k) v += sst[j * PT + k];
      sv[j] = j < Q ? v * sw[j] : 0.f;
    }
    __syncthreads();
    for (int j = tid; j < Q; j += NT) {
      float da = sz[j] - sv[j];
      if (j == Q - 1)
        for (int k = 0; k < Q; ++k) da += sv[k];
      dacum[chunk * Q + j] = da;
    }

    // ---- C: dc += dS B -------------------------------------------------------
    stage(sM, NS, bp, N, Q, qp, N, tid);  // M's last reader was phase B
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    if (live_cd) {
      for (int j = 0; j < rc + 8; j += 4) {  // dS[i][j] = 0 for j > i
        float4 bv[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          bv[kk][0] = ld4(sM + (j + kk) * NS + nc);
          bv[kk][1] = ld4(sM + (j + kk) * NS + nc + 4);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 dv = ld4(sdS + (rc + r) * ms + j);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              acc[r][s] = fmaf(at(dv, kk), at(bv[kk][0], s), acc[r][s]);
              acc[r][s + 4] = fmaf(at(dv, kk), at(bv[kk][1], s), acc[r][s + 4]);
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (rc + r >= Q) continue;
        float* o = dcp + (size_t)(rc + r) * N + nc;
        float4 lo = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        float4 hi = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        if (h > 0) {  // this thread stored the earlier heads' sum here
          const float4 o0 = ld4(o), o1 = ld4(o + 4);
          lo = make_float4(o0.x + lo.x, o0.y + lo.y, o0.z + lo.z, o0.w + lo.w);
          hi = make_float4(o1.x + hi.x, o1.y + hi.y, o1.z + hi.z, o1.w + hi.w);
        }
        st4(o, lo);
        st4(o + 4, hi);
      }
    }
    __syncthreads();  // B is replaced by C, dy by dstate

    // ---- D: db += dS^T C + (w o xbar) dstate^T ------------------------------
    stage(sM, NS, cp, N, Q, qp, N, tid);
    stage(sdy, XS, dsp, P, N, N, P, tid);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
    if (live_cd) {
      for (int i = rc; i < qp; ++i) {  // dS[i][j] = 0 for i < j
        const float4 d0 = ld4(sdS + i * ms + rc), d1 = ld4(sdS + i * ms + rc + 4);
        const float4 c0 = ld4(sM + i * NS + nc), c1 = ld4(sM + i * NS + nc + 4);
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(dv[r], cv[s], acc[r][s]);
      }
      float wr[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) wr[r] = sw[rc + r];
#pragma unroll 2
      for (int p = 0; p < P; p += 4) {
        float4 xv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = ld4(sx + (rc + r) * XS + p);
          xv[r] = make_float4(wr[r] * v.x, wr[r] * v.y, wr[r] * v.z,
                              wr[r] * v.w);
        }
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const float4 dv = ld4(sdy + (nc + s) * XS + p);
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][s] += dot4(xv[r], dv);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (rc + r >= Q) continue;
        float* o = dbp + (size_t)(rc + r) * N + nc;
        float4 lo = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        float4 hi = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        if (h > 0) {
          const float4 o0 = ld4(o), o1 = ld4(o + 4);
          lo = make_float4(o0.x + lo.x, o0.y + lo.y, o0.z + lo.z, o0.w + lo.w);
          hi = make_float4(o1.x + hi.x, o1.y + hi.y, o1.z + hi.z, o1.w + hi.w);
        }
        st4(o, lo);
        st4(o + 4, hi);
      }
    }
  }
}

template <int N, int P>
cudaError_t launch(const float* c, const float* b, const float* x,
                   const float* acum, const float* dy, const float* dstate,
                   float* dx, float* dacum, float* dc, float* db, int G, int T,
                   int Q, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Layout<N, P>(Q).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_bwd_kernel<N, P><<<dim3(T, G / H), NT, smem, stream>>>(
      c, b, x, acum, dy, dstate, dx, dacum, dc, db, T, Q, H);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it does not take or an operand not 16-byte aligned).
extern "C" int ssd_chunk_bwd(const void* c, const void* b, const void* x,
                             const void* acum, const void* dy,
                             const void* dstate, void* dx, void* dacum,
                             void* dc, void* db, int G, int T, int Q, int N,
                             int P, int H, void* stream) {
  const void* ptrs[] = {c, b, x, dy, dstate, dx, dc, db};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (G < 1 || T < 1 || Q < 1 || Q > QMAX || H < 1 || G % H)
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
#define SSD_BWD_LAUNCH(NN, PP)                                                \
  if (N == NN && P == PP)                                                     \
    return (int)launch<NN, PP>(cf, bf, xf, af, dyf, dsf, dxf, daf, dcf, dbf, \
                               G, T, Q, H, st);
  SSD_BWD_LAUNCH(128, 16)
  SSD_BWD_LAUNCH(16, 16)
#undef SSD_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
