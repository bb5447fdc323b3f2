// The E-D codec's decode and encode kernels for Hopper (sm_90a): the
// paper's "custom deep learning layer to decode each input matrix".
//
// Replaces the TPU kernels src/repro/kernels/pack/kernel.py
// :: decode_pallas (body _decode_kernel) and :: encode_pallas (body
// _encode_kernel).
//
// decode: packed uint32 (M, P) -> float32 (4M, P), image-major:
//   out[(4j + i) * P + p] = ((in[j * P + p] >> 8i) & 0xFF) * scale + shift
// for lane i = 0..3, so image n is container n / 4, byte lane n % 4.
// encode: uint8 (4M, P) -> uint32 (M, P), the inverse:
//   out[j * P + p] = sum_i in[(4j + i) * P + p] << 8i.
//
// What bounds them on the H100: bytes.  decode reads 4 B and writes 16 B
// per container and does two flops per pixel; encode reads 4 B and writes
// 4 B.  Both are a single pass at 3.35 TB/s of HBM.
//
// What the design does about it: one pass, nothing but the final layout
// touches device memory.  The TPU path pads the containers to (8, 128)
// tiles, writes lane-major (4, R, C) and transposes to image-major
// afterwards (pack/ops.py); here each thread writes the image-major
// planes itself, and the ragged tail needs no padding.  When P is a
// multiple of 4 and the pointers are 16-byte aligned, a thread takes four
// neighbouring containers of one row: one 16-byte load (uint4) and one
// float4 store into each of the four image planes (decode), or four
// 4-byte loads (uchar4) and one 16-byte store (encode).  Otherwise one
// container per thread.  A grid-stride loop covers any size.
//
// Exactness: nvcc would contract x * scale + shift into one FMA (one
// rounding) where the plain PyTorch version rounds the product and then
// the sum; __fmul_rn / __fadd_rn keep the two roundings, so the kernel is
// bit-exact with the plain version for any scale and shift.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float lane_f(uint32_t w, int i, float scale,
                                        float shift) {
  return __fadd_rn(__fmul_rn((float)((w >> (8 * i)) & 0xFFu), scale), shift);
}

__global__ void __launch_bounds__(NT)
decode_vec(const uint4* __restrict__ in, float4* __restrict__ out,
           size_t n, size_t p4, float scale, float shift) {
  for (size_t t = (size_t)blockIdx.x * NT + threadIdx.x; t < n;
       t += (size_t)gridDim.x * NT) {
    const size_t j = t / p4, q = t - j * p4;
    const uint4 w = in[t];
    float4* plane = out + 4 * j * p4 + q;  // lane i's plane at i * p4
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      v.x = lane_f(w.x, i, scale, shift);
      v.y = lane_f(w.y, i, scale, shift);
      v.z = lane_f(w.z, i, scale, shift);
      v.w = lane_f(w.w, i, scale, shift);
      plane[i * p4] = v;
    }
  }
}

__global__ void __launch_bounds__(NT)
decode_scalar(const uint32_t* __restrict__ in, float* __restrict__ out,
              size_t n, size_t p, float scale, float shift) {
  for (size_t t = (size_t)blockIdx.x * NT + threadIdx.x; t < n;
       t += (size_t)gridDim.x * NT) {
    const size_t j = t / p, c = t - j * p;
    const uint32_t w = in[t];
    float* plane = out + 4 * j * p + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) plane[i * p] = lane_f(w, i, scale, shift);
  }
}

__device__ __forceinline__ uint32_t join(uchar4 a, uchar4 b, uchar4 c,
                                         uchar4 d, int k) {
  const unsigned char* pa = reinterpret_cast<const unsigned char*>(&a);
  const unsigned char* pb = reinterpret_cast<const unsigned char*>(&b);
  const unsigned char* pc = reinterpret_cast<const unsigned char*>(&c);
  const unsigned char* pd = reinterpret_cast<const unsigned char*>(&d);
  return (uint32_t)pa[k] | ((uint32_t)pb[k] << 8) | ((uint32_t)pc[k] << 16) |
         ((uint32_t)pd[k] << 24);
}

__global__ void __launch_bounds__(NT)
encode_vec(const uchar4* __restrict__ in, uint4* __restrict__ out, size_t n,
           size_t p4) {
  for (size_t t = (size_t)blockIdx.x * NT + threadIdx.x; t < n;
       t += (size_t)gridDim.x * NT) {
    const size_t j = t / p4, q = t - j * p4;
    const uchar4* plane = in + 4 * j * p4 + q;
    const uchar4 a = plane[0], b = plane[p4], c = plane[2 * p4],
                 d = plane[3 * p4];
    uint4 w;
    w.x = join(a, b, c, d, 0);
    w.y = join(a, b, c, d, 1);
    w.z = join(a, b, c, d, 2);
    w.w = join(a, b, c, d, 3);
    out[t] = w;
  }
}

__global__ void __launch_bounds__(NT)
encode_scalar(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
              size_t n, size_t p) {
  for (size_t t = (size_t)blockIdx.x * NT + threadIdx.x; t < n;
       t += (size_t)gridDim.x * NT) {
    const size_t j = t / p, c = t - j * p;
    const uint8_t* plane = in + 4 * j * p + c;
    out[t] = (uint32_t)plane[0] | ((uint32_t)plane[p] << 8) |
             ((uint32_t)plane[2 * p] << 16) | ((uint32_t)plane[3 * p] << 24);
  }
}

int blocks_for(size_t n) {
  const size_t b = (n + NT - 1) / NT;
  return (int)(b < (size_t)MAX_BLOCKS ? b : (size_t)MAX_BLOCKS);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// in: uint32 (M, P); out: float32 (4M, P).  Returns cudaGetLastError().
extern "C" int pack_decode(const void* in, void* out, int M, int P,
                           float scale, float shift, void* stream) {
  if (M < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 4 == 0 && aligned16(in) && aligned16(out)) {
    const size_t p4 = (size_t)P / 4, n = (size_t)M * p4;
    decode_vec<<<blocks_for(n), NT, 0, st>>>(
        static_cast<const uint4*>(in), static_cast<float4*>(out), n, p4,
        scale, shift);
  } else {
    const size_t n = (size_t)M * P;
    decode_scalar<<<blocks_for(n), NT, 0, st>>>(
        static_cast<const uint32_t*>(in), static_cast<float*>(out), n,
        (size_t)P, scale, shift);
  }
  return (int)cudaGetLastError();
}

// in: uint8 (4M, P); out: uint32 (M, P).  Returns cudaGetLastError().
extern "C" int pack_encode(const void* in, void* out, int M, int P,
                           void* stream) {
  if (M < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 4 == 0 && (reinterpret_cast<uintptr_t>(in) & 3u) == 0 &&
      aligned16(out)) {
    const size_t p4 = (size_t)P / 4, n = (size_t)M * p4;
    encode_vec<<<blocks_for(n), NT, 0, st>>>(
        static_cast<const uchar4*>(in), static_cast<uint4*>(out), n, p4);
  } else {
    const size_t n = (size_t)M * P;
    encode_scalar<<<blocks_for(n), NT, 0, st>>>(
        static_cast<const uint8_t*>(in), static_cast<uint32_t*>(out), n,
        (size_t)P);
  }
  return (int)cudaGetLastError();
}
