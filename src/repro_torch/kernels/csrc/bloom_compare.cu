// Fused receive path: per row, merged = max(a, b), le = all(a <= b),
// ge = all(a >= b), ΣA, ΣB and the Eq. 3 fp both ways, in one pass.
//
// Replaces the TPU kernel repro/kernels/bloom_compare.py:bloom_compare_kernel
// (wrapper bloom_merge_compare_pallas).  Like that kernel it compares
// directly (signed <=, >=, max), not by wrap-subtraction.
//
// Bound on this card: bytes.  Two int32 rows in, one int32 row out
// (12 bytes per cell) against a handful of integer operations per cell.
// Design: one CTA per row walks the m axis in tiles of bm, the tiling
// the Pallas grid revisits.  Each thread reads its cells of the tile
// coalesced, writes the max, and keeps the dominance flags; the tile's
// int32 sums (unsigned adds, so the wrap is defined) are reduced over
// the block and thread 0 adds them, as float, to the running totals in
// tile order, which keeps the float32 sums bit-identical to the
// reference.  Flags are AND-reduced once with __syncthreads_and, and
// thread 0 finalizes Eq. 3.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
bloom_compare_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                     int32_t* __restrict__ merged, int32_t* __restrict__ flags,
                     float* __restrict__ sums, float* __restrict__ fp, int m,
                     int bm, float log_q) {
  __shared__ uint32_t part[2][kWarps];
  const size_t row = blockIdx.x;
  const int32_t* ar = a + row * m;
  const int32_t* br = b + row * m;
  int32_t* mr = merged + row * m;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int le = 1, ge = 1;
  float acc_a = 0.0f, acc_b = 0.0f;  // used by thread 0 only
  for (int t0 = 0; t0 < m; t0 += bm) {
    const int t1 = min(t0 + bm, m);
    uint32_t sa = 0, sb = 0;
    for (int c = t0 + threadIdx.x; c < t1; c += kThreads) {
      const int32_t x = ar[c], y = br[c];
      mr[c] = max(x, y);
      le &= (x <= y);
      ge &= (x >= y);
      sa += static_cast<uint32_t>(x);
      sb += static_cast<uint32_t>(y);
    }
    sa = bloom::warp_sum_u32(sa);
    sb = bloom::warp_sum_u32(sb);
    if (lane == 0) {
      part[0][warp] = sa;
      part[1][warp] = sb;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t ta = 0, tb = 0;
      for (int w = 0; w < kWarps; ++w) {
        ta += part[0][w];
        tb += part[1][w];
      }
      acc_a += bloom::tile_sum_f32(ta);
      acc_b += bloom::tile_sum_f32(tb);
    }
    __syncthreads();  // part[] is reused by the next tile
  }
  le = __syncthreads_and(le);
  ge = __syncthreads_and(ge);
  if (threadIdx.x == 0) {
    flags[2 * row] = le;
    flags[2 * row + 1] = ge;
    sums[2 * row] = acc_a;
    sums[2 * row + 1] = acc_b;
    fp[2 * row] = bloom::eq3_fp(acc_a, acc_b, log_q);
    fp[2 * row + 1] = bloom::eq3_fp(acc_b, acc_a, log_q);
  }
}

extern "C" int bloom_merge_compare(const void* a, const void* b, void* merged,
                                   void* flags, void* sums, void* fp, int B,
                                   int m, int bm, float log_q, void* stream) {
  if (B == 0) return 0;
  bloom_compare_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(merged), static_cast<int32_t*>(flags),
      static_cast<float*>(sums), static_cast<float*>(fp), m, bm, log_q);
  return static_cast<int>(cudaGetLastError());
}
