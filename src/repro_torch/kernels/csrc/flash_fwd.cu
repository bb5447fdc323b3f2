// Causal / windowed GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py
// :: flash_attention_fwd_pallas (body _flash_kernel).  Same function, not
// the same block structure: softmax(Q K^T * scale + mask) V per (b*h) row
// with an online softmax in f32, query head h reading KV head h / group,
// the causal, sliding-window and kv_len masks of _position_mask, and the
// f32 row statistics m (running max) and l (running denominator) written
// beside the output for the backward kernels of the training slice.
//
// What bounds it on the H100: tensor-core FLOPs, about
// 4 * B * H * D * S(S+1)/2 for causal attention (two matmuls, two FLOPs a
// multiply-add) at 989 TFLOP/s bf16; the bytes (q, k, v read once, o
// written once) are far below the 295 FLOP/byte ridge at prefill lengths.
//
// What this first design does about it: it is deliberately simple and
// right first.  One block of 256 threads per (b*h, q tile of 64 rows);
// an in-block loop walks only the KV tiles in [lo, hi] of
// tiling.kv_tile_bounds (bq = bk = 64), so fully masked tiles are never
// loaded -- the TPU's wedge grid becomes a loop bound.  Q, K^T, V and the
// probability tile are staged in shared memory as f32 and multiplied with
// plain FMAs (each thread owns a 4 x 4 score tile and a 4 x D/16 output
// tile), so it runs at CUDA-core, not tensor-core, rates.  K and V share
// one shared-memory buffer (K^T for the scores, then V for the product),
// which keeps a block under 83 KB so two blocks fit on an SM.  The late
// (most expensive) q tiles are scheduled first.  wgmma / TMA are later
// work.  The ragged tail (S not a multiple of 64) is masked in the
// kernel: rows past S are never written, keys past kv_len are masked and
// loaded as zeros.
//
// Inputs are row-major (B*H, S, D) for q and (B*Hkv, S, D) for k, v, in
// bf16 or f32; o has the input dtype; m, l are (B*H, S) f32; counts, if
// not null, is (B*H, n_q) int32: the KV tiles each q tile executed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D+1], K^T [D][BK+1] / V [BK][D] (shared), P [BQ][BK+1]
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int* __restrict__ counts, int S, int group, int causal,
                 int window, int kv_len, float sm_scale) {
  constexpr int QS = D + 1;   // padded strides keep shared reads conflict-free
  constexpr int KS = BK + 1;
  constexpr int PS = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QS]
  float* KV = Qs + BQ * QS;      // K^T [D][KS], then V [BK][D]
  float* Ps = KV + D * KS;       // [BQ][PS]

  const int n_q = (S + BQ - 1) / BQ;
  const int qi = n_q - 1 - blockIdx.x;  // late (heavy) q tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx + 16 j, output columns tx + 16 c
  const int ty = tid / 16;  // rows 4 ty .. 4 ty + 3 of the q tile
  const T* qp = q + (size_t)bh * S * D;
  const T* kp = k + (size_t)(bh / group) * S * D;
  const T* vp = v + (size_t)(bh / group) * S * D;

  // tiling.kv_tile_bounds(qi, bq=64, bk=64, causal, window, kv_len)
  const int hi_valid = (kv_len + BK - 1) / BK - 1;
  int lo = 0, hi = hi_valid;
  if (causal) {
    hi = min(hi_valid, ((qi + 1) * BQ - 1) / BK);
    if (window > 0) {
      lo = max(0, (qi * BQ - (window - 1)) / BK);
      hi = max(hi, lo);
    }
  }

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int row = qi * BQ + r;
    Qs[r * QS + d] = row < S ? to_f32(qp[(size_t)row * D + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo; kt <= hi; ++kt) {
    __syncthreads();  // previous tile's V / P reads are done (and Q is in)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int kr = kt * BK + c;
      KV[d * KS + c] = kr < S ? to_f32(kp[(size_t)kr * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KV[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask (same predicate as _position_mask), then the online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qi * BQ + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BK + tx + 16 * j;
        bool ok = col < kv_len;
        if (causal) {
          ok = ok && row >= col;
          if (window > 0) ok = ok && (row - col) < window;
        }
        s[i][j] = ok ? s[i][j] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K^T reads done: the buffer takes V

    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int kr = kt * BK + c;
      KV[c * D + d] = kr < S ? to_f32(vp[(size_t)kr * D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = KV[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) store(orow + tx + 16 * cc, acc[i][cc] / denom);
    if (tx == 0) {
      m_out[(size_t)bh * S + row] = m_i[i];
      l_out[(size_t)bh * S + row] = l_i[i];
    }
  }
  if (counts != nullptr && tid == 0) counts[(size_t)bh * n_q + qi] = hi - lo + 1;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int* counts, int bh, int S, int group,
                   int causal, int window, int kv_len, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, counts, S, group,
      causal, window, kv_len, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or dtype it does not take).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* m, void* l, void* counts, int bh,
                         int bhkv, int S, int D, int dtype, int causal,
                         int window, int kv_len, float sm_scale,
                         void* stream) {
  if (bhkv <= 0 || bh % bhkv != 0 || S < 1 || kv_len < 0 || kv_len > S)
    return (int)cudaErrorInvalidValue;
  const int group = bh / bhkv;
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  int* cnt = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && D == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, mf, lf, cnt, bh, S, group,
                                      causal, window, kv_len, sm_scale, st);
  else if (dtype == 1 && D == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, mf, lf, cnt, bh, S, group,
                                     causal, window, kv_len, sm_scale, st);
  else if (dtype == 0 && D == 128)
    err = launch<float, 128>(q, k, v, o, mf, lf, cnt, bh, S, group, causal,
                             window, kv_len, sm_scale, st);
  else if (dtype == 0 && D == 64)
    err = launch<float, 64>(q, k, v, o, mf, lf, cnt, bh, S, group, causal,
                            window, kv_len, sm_scale, st);
  return (int)err;
}
