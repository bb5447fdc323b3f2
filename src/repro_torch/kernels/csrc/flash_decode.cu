// Split-K GQA decode attention over an int8 KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kvq/kernel.py
// :: flash_decode_pallas (body _flash_decode_kernel), both of its masks.  One
// new token per row: q (B, Hkv, G, D) f32 attends over the int8 cache
// k, v (B, Hkv, S, D) with f32 per-token scales (B, Hkv, S), dequantized
// after the load, and either masked to the first lengths[b] positions
// (entry flash_decode) or offset by a dense (B, S) f32 bias added to every
// logit (entry flash_decode_bias: a window band that lengths cannot
// express).  With a bias every tile is visited, as on the TPU; a tile whose
// entries are all -1e30 (finite) runs with m = -1e30 and drops out with
// weight exp(-1e30 - m) = 0 at the first live tile or in the split merge,
// never as NaN.  The KV axis
// is cut into tiles of bs tokens and the tiles into `nsp` splits of `spt`
// tiles each (tiling.resolve_decode_grid).  With one split the kernel
// normalises and writes (B, Hkv, G, D); otherwise it writes unnormalised
// partials acc (B, Hkv, nsp, G, D), m, l (B, Hkv, nsp, G) that
// kvq/ops.py::combine_splits merges.  On the lengths path a split with no
// live tile writes (0, -1e30, 0).
//
// What bounds it on the H100: bytes.  It reads about
// B * Hkv * sum(len) * (2 D + 8) bytes of cache (1 byte per element and a
// 4-byte scale per token, for K and V; len = S with a bias, which adds 4
// bytes a position per KV head) and does only 4 G D FLOPs per
// cached token, far below the 295 FLOP/byte ridge, so 3.35 TB/s of HBM is
// the limit; at serving sizes the launch itself is comparable.
//
// What the design does about it: only int8 values and f32 scales cross
// device memory, and only for live tokens -- a tile whose start is at or
// past lengths[b] is never loaded, and in the straddling tile the loads
// stop at the length.  One block of 128 threads per (split, kv head, row);
// all G query heads of the group share every loaded K and V row.  Scores:
// D/16 lanes per token, each lane one 16-byte load of its K row (a warp
// reads 512 contiguous bytes), reduced with warp shuffles.  Values: one
// 4-byte load of four int8 per thread, a warp covering a 128-byte row.
// The online-softmax state lives in shared memory and registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;

// byte i (0..3) of a 32-bit word, as a signed int8 value
__device__ __forceinline__ float byte_f(int w, int i) {
  return (float)(signed char)(w >> (8 * i));
}

template <int G, int D>
size_t smem_bytes(int bs) {
  constexpr int NG = NT / (D / 4);
  return sizeof(float) * ((size_t)G * D + (size_t)G * bs + (size_t)NG * G * D);
}

template <int G, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ ks,
                    const int8_t* __restrict__ vq,
                    const float* __restrict__ vs,
                    const int* __restrict__ lengths,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ m_p, float* __restrict__ l_p,
                    int* __restrict__ counts, int Hkv, int S, int bs, int ns,
                    int spt, int nsp, float sm_scale) {
  constexpr int LPT = D / 16;  // lanes per token in the score pass
  constexpr int TPI = NT / LPT;  // tokens per block iteration (scores)
  constexpr int NQ = D / 4;    // 4-dim quads of a V row
  constexpr int NG = NT / NQ;  // token groups in the value pass
  extern __shared__ float smem[];
  float* qs = smem;            // [G][D]
  float* ps = qs + G * D;      // [G][bs] scores, then probabilities
  float* red = ps + G * bs;    // [NG][G][D] partial accumulators
  __shared__ float m_s[G], l_s[G], a_s[G];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * Hkv + h;
  const int len = bias != nullptr ? S : lengths[b];
  const float* brow = bias != nullptr ? bias + (size_t)b * S : nullptr;
  const int8_t* kp = kq + bh * S * D;
  const int8_t* vp = vq + bh * S * D;
  const float* ksp = ks + bh * S;
  const float* vsp = vs + bh * S;

  for (int i = tid; i < G * D; i += NT) qs[i] = q[bh * G * D + i];
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const int dq = tid % NQ, tg = tid / NQ;
  const int sub = tid % LPT;
  int executed = 0;
  __syncthreads();
  float qr[G][16];  // this lane's 16-dim slice of every head's query
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[g][e] = qs[g * D + sub * 16 + e];

  const int t_end = min((split + 1) * spt, ns);
  for (int t = split * spt; t < t_end; ++t) {
    const int start = t * bs;
    if (start >= len) break;  // this tile and every later one are dead
    const int n = min(bs, len - start);
    ++executed;

    // scores of the tile's live tokens, all G heads at once
    for (int base = 0; base < n; base += TPI) {
      const int j = base + tid / LPT;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (j < n) {
        const int4 raw = *reinterpret_cast<const int4*>(
            kp + (size_t)(start + j) * D + sub * 16);
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = byte_f(words[e / 4], e % 4);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] = fmaf(qr[g][e], kf, part[g]);
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (j < n && sub == 0) {
        const float sc = ksp[start + j];
#pragma unroll
        for (int g = 0; g < G; ++g) ps[g * bs + j] = part[g] * sc * sm_scale;
        if (brow != nullptr) {
          const float bj = brow[start + j];
#pragma unroll
          for (int g = 0; g < G; ++g) ps[g * bs + j] += bj;
        }
      }
    }
    __syncthreads();

    // online-softmax update, one warp per head
    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[g * bs + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(ps[g * bs + j] - m_new);
        ps[g * bs + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the tile's live tokens
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = a_s[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
    }
    for (int j = tg; j < n; j += NG) {
      const char4 raw = *reinterpret_cast<const char4*>(
          vp + (size_t)(start + j) * D + dq * 4);
      const float sc = vsp[start + j];
      const float vf[4] = {(float)raw.x * sc, (float)raw.y * sc,
                           (float)raw.z * sc, (float)raw.w * sc};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g * bs + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(tg * G + g) * D + dq * 4 + e] = acc[g][e];
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    float a = 0.f;
    for (int r = 0; r < NG; ++r) a += red[r * G * D + i];
    if (nsp == 1)
      out[bh * G * D + i] = a / fmaxf(l_s[i / D], 1e-30f);
    else
      out[(bh * nsp + split) * G * D + i] = a;
  }
  if (nsp > 1 && tid < G) {
    m_p[(bh * nsp + split) * G + tid] = m_s[tid];
    l_p[(bh * nsp + split) * G + tid] = l_s[tid];
  }
  if (counts != nullptr && tid == 0) counts[bh * nsp + split] = executed;
}

template <int G, int D>
cudaError_t launch(const float* q, const int8_t* kq, const float* ks,
                   const int8_t* vq, const float* vs, const int* lengths,
                   const float* bias, float* out, float* m_p, float* l_p,
                   int* counts, int B,
                   int Hkv, int S, int bs, int ns, int spt, int nsp,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<G, D>(bs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<G, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nsp, Hkv, B);
  flash_decode_kernel<G, D><<<grid, NT, smem, stream>>>(
      q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, Hkv, S, bs, ns,
      spt, nsp, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_g(int G, const float* q, const int8_t* kq,
                       const float* ks, const int8_t* vq, const float* vs,
                       const int* lengths, const float* bias, float* out,
                       float* m_p, float* l_p, int* counts, int B, int Hkv,
                       int S, int bs, int ns,
                       int spt, int nsp, float sm_scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<1, D>(q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
    case 2: return launch<2, D>(q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
    case 4: return launch<4, D>(q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
    case 5: return launch<5, D>(q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
    case 8: return launch<8, D>(q, kq, ks, vq, vs, lengths, bias, out, m_p, l_p, counts, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* kq, const void* ks,
                     const void* vq, const void* vs, const void* lengths,
                     const void* bias, void* out, void* m_p, void* l_p,
                     void* counts, int B, int Hkv, int G, int S, int D,
                     int bs, int ns, int spt, int nsp, float sm_scale,
                     void* stream) {
  if (B < 1 || Hkv < 1 || bs < 1 || bs > 512 || ns * bs != S || nsp < 1 ||
      spt < 1)
    return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int8_t* kb = static_cast<const int8_t*>(kq);
  const int8_t* vb = static_cast<const int8_t*>(vq);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* len = static_cast<const int*>(lengths);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* mp = static_cast<float*>(m_p);
  float* lp = static_cast<float*>(l_p);
  int* cnt = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return dispatch_g<128>(G, qf, kb, ksf, vb, vsf, len, bi, o, mp, lp, cnt, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
  if (D == 64)
    return dispatch_g<64>(G, qf, kb, ksf, vb, vsf, len, bi, o, mp, lp, cnt, B, Hkv, S, bs, ns, spt, nsp, sm_scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both return cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape they do not take: G not in {1, 2, 4, 5, 8}, D not in {64, 128}).
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

// The dense-bias path: bias (B, S) f32 added to every logit, every tile
// visited.
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
