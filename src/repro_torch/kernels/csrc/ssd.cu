// SSD (mamba2 state-space duality) intra-chunk kernel for Hopper (sm_90a),
// f32 FMA, at head_p 16 (the smoke configurations' width).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py :: ssd_chunk_pallas
// (body _ssd_chunk_kernel) where kernels/ssd/ops.py ssd_route sends head_p
// 16; head_p 64 (mamba2's and hymba's widths) goes to ssd_sm90.cu, whose
// wgmma tiles are 64 wide.  For every folded (batch * head) row g and chunk
// t, with C, B (Q, N), xbar (Q, P) and the inclusive cumulative log-decay
// da (Q,), all f32:
//   y[i]     = sum_{j <= i} (C[i] . B[j]) exp(da[i] - da[j]) xbar[j]
//   state    = B^T (xbar * exp(da[Q-1] - da))                  (N, P)
// The inter-chunk recurrence stays in PyTorch (kernels/ssd/ops.py).
// C and B are head-shared: they are read as (G / H, T, Q, N) and row g uses
// batch g / H, so the serving path never broadcasts them over the heads.
//
// What bounds it on the H100: operations.  At P = 16 the scores C B^T (2N
// flops a live entry, recomputed for each head) are most of a chunk's work:
// at Q = 128, N = 128 ~2.1 of ~2.9 MFLOP, on ~150 KB of operands, most of
// them C and B from L2.  The kernel stays in f32 (FMA, no TF32) so that it
// can be held tightly against its plain version: 67 TFLOP/s is the roof.
//
// What the design does about it: one block of 256 threads per chunk, every
// operand staged once in shared memory, each product from register tiles.
// The TPU kernel holds C, B, x, y and the Q x Q decay in VMEM at once;
// here N is tiled in steps of 16 for the scores, and one shared region is
// reused phase by phase (~85 KB at Q = 128, N = 128, so two blocks share
// an SM):
//   A. scores C B^T: only the 8 x 8 register tiles on or below the
//      diagonal are computed (thread k takes the k-th of them), masked and
//      decayed, and stored transposed (G^T, j-major);
//   B. y = G xbar: 8 x 4 register tiles, the j loop stops at the diagonal;
//   C. state = B^T (xbar * w): xbar scaled in place, B staged whole, register
//      tiles of (N / 16) x 4.
// Any Q in [1, 128] (a prompt shorter than the chunk gives Q = L), N in
// {16, 128}, P = 16.  Rows and columns past Q are computed from unloaded
// shared memory and never stored.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int QMAX = 128;
constexpr int NK = 16;  // N step of the score product
constexpr int P = 16;   // head_p

// j-major row stride of the transposed tiles: a multiple of 4 floats (16-byte
// rows for float4 reads) with room for the 8-wide tiles that straddle Q
__host__ __device__ inline int row_stride(int q) { return (q + 3) / 4 * 4 + 4; }

__host__ __device__ inline int region_a(int q, int n) {
  const int g = q * row_stride(q), b = q * n;
  return g > b ? g : b;
}

__host__ __device__ inline int region_b(int q) {
  const int tiles = 2 * NK * row_stride(q), x = q * P;
  return tiles > x ? tiles : x;
}

template <int N>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk_kernel(const float* __restrict__ c, const float* __restrict__ b,
                 const float* __restrict__ x, const float* __restrict__ acum,
                 float* __restrict__ y, float* __restrict__ state, int T,
                 int Q, int H) {
  extern __shared__ float4 smem4[];
  __shared__ float da[QMAX];
  float* ra = reinterpret_cast<float*>(smem4);  // G^T, then B
  float* rb = ra + region_a(Q, N);              // C, B tiles, then xbar
  const int qs = row_stride(Q);
  const int t = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const size_t chunk = (size_t)g * T + t;
  const size_t shared_chunk = (size_t)(g / H) * T + t;
  const float* cp = c + shared_chunk * Q * N;
  const float* bp = b + shared_chunk * Q * N;
  const float* xp = x + chunk * Q * P;
  float* yp = y + chunk * Q * P;
  float* sp = state + chunk * N * P;
  for (int i = tid; i < Q; i += NT) da[i] = acum[chunk * Q + i];

  // ---- A: scores of the lower-triangle 8 x 8 tiles ----------------------
  const int nrg = (Q + 7) / 8;
  const bool live = tid < nrg * (nrg + 1) / 2;
  int ty = 0, tx = tid;  // thread k -> the k-th tile on or below the diagonal
  while (tx > ty) tx -= ++ty;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  float* cs = rb;            // [NK][qs] C^T tile
  float* bs = rb + NK * qs;  // [NK][qs] B^T tile
  for (int k0 = 0; k0 < N; k0 += NK) {
    for (int e = tid; e < Q * (NK / 4); e += NT) {
      const int i = e / (NK / 4), k = e % (NK / 4) * 4;
      const float4 cv = *reinterpret_cast<const float4*>(cp + (size_t)i * N + k0 + k);
      const float4 bv = *reinterpret_cast<const float4*>(bp + (size_t)i * N + k0 + k);
      cs[(k + 0) * qs + i] = cv.x;
      cs[(k + 1) * qs + i] = cv.y;
      cs[(k + 2) * qs + i] = cv.z;
      cs[(k + 3) * qs + i] = cv.w;
      bs[(k + 0) * qs + i] = bv.x;
      bs[(k + 1) * qs + i] = bv.y;
      bs[(k + 2) * qs + i] = bv.z;
      bs[(k + 3) * qs + i] = bv.w;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < NK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(cs + k * qs + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(cs + k * qs + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + k * qs + tx * 8);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + k * qs + tx * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
      }
    }
    __syncthreads();  // the tiles are rewritten next step
  }
  if (live) {  // causal mask and decay, stored transposed: ra[j * qs + i]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int j = tx * 8 + s;
        if (i < Q && j < Q)
          ra[j * qs + i] = j <= i ? acc[r][s] * expf(da[i] - da[j]) : 0.f;
      }
    }
  }
  for (int e = tid; e < Q * P / 4; e += NT)
    reinterpret_cast<float4*>(rb)[e] = reinterpret_cast<const float4*>(xp)[e];
  __syncthreads();

  // ---- B: y = G xbar over j <= i -----------------------------------------
  {
    constexpr int CG = P / 4;
    const int i0 = tid / CG * 8, p0 = tid % CG * 4;
    if (i0 < Q) {
      float ay[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) ay[r][e] = 0.f;
      const int jmax = min(Q, i0 + 8);
      for (int j = 0; j < jmax; ++j) {
        const float4 g0 = *reinterpret_cast<const float4*>(ra + j * qs + i0);
        const float4 g1 = *reinterpret_cast<const float4*>(ra + j * qs + i0 + 4);
        const float4 xv = *reinterpret_cast<const float4*>(rb + j * P + p0);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) ay[r][e] = fmaf(gv[r], xs[e], ay[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (i0 + r < Q)
          *reinterpret_cast<float4*>(yp + (size_t)(i0 + r) * P + p0) =
              make_float4(ay[r][0], ay[r][1], ay[r][2], ay[r][3]);
    }
  }
  __syncthreads();  // G^T and xbar are rewritten below

  // ---- C: state = B^T (xbar * exp(da[Q-1] - da)) --------------------------
  const float last = da[Q - 1];
  for (int e = tid; e < Q * P; e += NT) rb[e] *= expf(last - da[e / P]);
  for (int e = tid; e < Q * N / 4; e += NT)
    reinterpret_cast<float4*>(ra)[e] = reinterpret_cast<const float4*>(bp)[e];
  __syncthreads();
  {
    constexpr int CG = P / 4, RN = N / 16;
    const int ng = tid / CG, p0 = tid % CG * 4, n0 = ng * RN;
    if (ng < 16) {
      float as[RN][4];
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) as[r][e] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(rb + j * P + p0);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const float bv = ra[j * N + n0 + r];
#pragma unroll
          for (int e = 0; e < 4; ++e) as[r][e] = fmaf(bv, xs[e], as[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
        *reinterpret_cast<float4*>(sp + (size_t)(n0 + r) * P + p0) =
            make_float4(as[r][0], as[r][1], as[r][2], as[r][3]);
    }
  }
}

template <int N>
cudaError_t launch(const float* c, const float* b, const float* x,
                   const float* acum, float* y, float* state, int G, int T,
                   int Q, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)region_a(Q, N) + region_b(Q));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<N><<<dim3(T, G), NT, smem, stream>>>(c, b, x, acum, y,
                                                          state, T, Q, H);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int ssd_chunk(const void* c, const void* b, const void* x,
                         const void* acum, void* y, void* state, int G, int T,
                         int Q, int N, int p, int H, void* stream) {
  if (G < 1 || T < 1 || Q < 1 || Q > QMAX || H < 1 || G % H) return (int)cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(b);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(acum);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p != P) return (int)cudaErrorInvalidValue;  // head_p 64: ssd_sm90.cu
  if (N == 128) return (int)launch<128>(cf, bf, xf, af, yf, sf, G, T, Q, H, st);
  if (N == 16) return (int)launch<16>(cf, bf, xf, af, yf, sf, G, T, Q, H, st);
  return (int)cudaErrorInvalidValue;
}
