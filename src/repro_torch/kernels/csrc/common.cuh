// Shared device helpers for the bloom-clock kernels.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace bloom {

// Paper Eq. 3 fp of "X -> Y": exp(sx * log(clip(-expm1(sy * log_q), 1e-30, 1))).
// log_q is float32 log1p(-1/m) computed on the host the way the plain
// version computes it, so only expm1f/logf/expf can differ by ulps.
__device__ __forceinline__ float eq3_fp(float sx, float sy, float log_q) {
  float inner = -expm1f(sy * log_q);
  inner = fminf(fmaxf(inner, 1e-30f), 1.0f);
  return expf(sx * logf(inner));
}

// Warp sum of 32-bit lanes with wrap-around (unsigned: no signed overflow).
__device__ __forceinline__ uint32_t warp_sum_u32(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A tile's int32 sum (wrapped) as the float the reference adds.
__device__ __forceinline__ float tile_sum_f32(uint32_t s) {
  return static_cast<float>(static_cast<int32_t>(s));
}

}  // namespace bloom
