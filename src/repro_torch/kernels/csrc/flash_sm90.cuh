// What the tensor-core flash kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu)
// share beyond sm90.cuh: the 64 x 64 tiling, the mask predicate of
// _position_mask, the KV-tile bounds of tiling.kv_tile_bounds, shared-
// memory layout helpers (head dims 64, 128 and 160) and the bf16 pair
// store.  Header-only, in an
// anonymous namespace: each .cu that includes it is compiled on its own.
#pragma once

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;     // one warpgroup
constexpr int STAGES = 2;   // ring depth
constexpr float LOG2E = 1.4426950408889634f;

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

// True when every entry of q tile qi x KV tile kt is live.
__device__ __forceinline__ bool tile_full(int qi, int kt, int S, int causal,
                                          int window, int kv_len) {
  bool ok = (qi + 1) * BQ <= S && (kt + 1) * BK <= kv_len;
  if (causal) {
    ok = ok && (kt + 1) * BK - 1 <= qi * BQ;
    if (window > 0) ok = ok && (qi + 1) * BQ - 1 - kt * BK < window;
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

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of one 64 x D bf16 tile: ceil(D / 64) panels, so 160
// takes three (its last 32 columns TMA's zeros).  A K-major product over
// D steps through the panels 16 values at a time and never reaches the
// zeros; an MN-major product of width D reads the panels' first D
// columns.
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  static_assert(D == 64 || D == 128 || D == 160, "head_dim 64, 128 or 160");
  return (D + 63) / 64 * PANEL_BYTES;
}

// Stage j % STAGES of a ring whose stages hold two 64 x D tiles: rows
// [row, row + 64) of slice z of map a, then the same rows of map b, both
// counted on the stage's barrier.
template <int D>
__device__ __forceinline__ void ring_load(uint8_t* ring, uint64_t* full,
                                          const CUtensorMap* a,
                                          const CUtensorMap* b, int j,
                                          int row, int z) {
  constexpr int TILE = tile_bytes<D>();
  const int st = j % STAGES;
  uint8_t* dst = ring + st * 2 * TILE;
  mbar_expect_tx(&full[st], 2 * TILE);
  tma_load_tile<D>(dst, a, &full[st], row, z);
  tma_load_tile<D>(dst + TILE, b, &full[st], row, z);
}

inline bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
