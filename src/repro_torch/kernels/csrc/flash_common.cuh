// flash_common.cuh — what the attention forward (flash_attention.cu) and its
// backward (flash_attention_bwd.cu) share: the CUDA-core tiles, the masking
// constants and the bf16 packing of an f32 pair, with internal linkage in
// each source that includes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FA_BQ = 64;        // query rows per block (mma.sync and f32 kernels)
constexpr int FA_BK = 64;        // keys per tile
constexpr int FA_THREADS = 128;  // 4 warps
constexpr float FA_NEG_INF = -1e30f;
constexpr float FA_LOG2E = 1.4426950408889634f;
constexpr float FA_LN2 = 0.6931471805599453f;

// Row pitch of the f32 kernels' score tiles, in elements.
constexpr int FA_PLD = FA_BK + 1;

// Row pitch of a staged f32 tile, in elements: D plus 4 bytes.
template <int D>
__host__ __device__ constexpr int f32_pitch() {
  return D + 1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
