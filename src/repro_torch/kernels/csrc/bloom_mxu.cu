// All-pairs violation counts over two packed slabs:
//   viol[i, j] = sum over m of relu(a_im - b_jm)
// on window-relative values a = u8 + (row_base - lo), b = u8 + (col_base - lo)
// in [0, T], as float32.  le(i, j) = viol == 0, and the caller derives ge
// from the rank-1 identity with the row and col sums.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_mxu
// (generate.bloom_matrix_mxu_pallas), which thermometer-encodes both
// tiles over T thresholds and counts #{(m, t): b < t <= a} with one f32
// dot_general on the MXU.  That count is relu(min(a, T) - max(b, 0)) per
// lane, for any a and b, which is what this kernel sums: the same value
// without the T-fold encoding.
//
// Bound on this card: operations.  Each pair and lane adds relu(a - b) to
// a count: at fewest 0.75 instructions (a DPX add-relu, __viaddmax_s16x2
// with 0, per two 16-bit lanes and a three-input add of two packed
// counts per four), ~6 ms at the SM's issue rate for N = M = 16,384,
// m = 1024 (the inputs are 16 MiB, the output 1 GiB, ~0.3 ms).  The
// tensor-core formulation, 0/1 thermometer operands in int8 with s32
// accumulation, does 2T operations per pair and lane at 1,979 Tops:
// ~18 ms at T = 64, below the integer bound only for T <= 16.  This
// design compiles to ~1.8 instructions per pair and lane (a VIADDMNMX
// add-relu and half an IADD3).  Both redesigns are noted in ROADMAP.md.
// Design: the tile
// sweep of bloom_matrix.cu (common.cuh) with the window shift and the
// clamps applied once per staged cell, not per pair: a is clamped to
// [-1, T] and b to [0, T + 1], which keeps the count and keeps the
// difference far from int32 overflow; the count stays in int32 (exact:
// the caller refuses m * T >= 2^24, as the reference does) and is stored
// as float32.
#include "common.cuh"

namespace {

using bloom::PAIR_CT;
using bloom::PAIR_LDK;
using bloom::PAIR_KC;
using bloom::PAIR_RT;

// u8 residual -> window-relative value (residual + base - lo, int32
// wrap), clamped to [lo_clamp, hi_clamp].
struct ShiftClamp {
  const int32_t* base;
  uint32_t lo;
  int lo_clamp, hi_clamp;

  __device__ __forceinline__ uint32_t operator()(int row, uint32_t v) const {
    const int x = static_cast<int>(v + static_cast<uint32_t>(base[row]) - lo);
    return static_cast<uint32_t>(min(max(x, lo_clamp), hi_clamp));
  }
};

struct Violations {
  int n[PAIR_RT][PAIR_CT];

  __device__ __forceinline__ void operator()(int r, int c, uint32_t a, uint32_t b) {
    n[r][c] += max(static_cast<int>(a) - static_cast<int>(b), 0);
  }
};

__global__ void mxu_viol_kernel(const uint8_t* __restrict__ rows,
                                const uint8_t* __restrict__ cols,
                                const int32_t* __restrict__ row_base,
                                const int32_t* __restrict__ col_base, float* __restrict__ viol,
                                int N, int M, int m, int bi, int bj, int lo, int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;
  uint32_t* Bs = smem + bi * PAIR_LDK;
  const int i0 = blockIdx.y * bi, j0 = blockIdx.x * bj;
  const int cstep = bj / PAIR_CT, rstep = bi / PAIR_RT;
  const int tx = threadIdx.x % cstep, ty = threadIdx.x / cstep;
  const ShiftClamp fa{row_base, static_cast<uint32_t>(lo), -1, T};
  const ShiftClamp fb{col_base, static_cast<uint32_t>(lo), 0, T + 1};
  Violations acc;
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) acc.n[r][c] = 0;
  }
  for (int k0 = 0; k0 < m; k0 += PAIR_KC) {
    const int kc = min(PAIR_KC, m - k0);
    bloom::stage_rows(As, rows, N, i0, bi, m, k0, kc, fa);
    bloom::stage_rows(Bs, cols, M, j0, bj, m, k0, kc, fb);
    __syncthreads();
    bloom::sweep_chunk(As, Bs, kc, ty, tx, rstep, cstep, acc);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      const int i = i0 + ty + r * rstep, j = j0 + tx + c * cstep;
      if (i < N && j < M) viol[static_cast<size_t>(i) * M + j] = static_cast<float>(acc.n[r][c]);
    }
  }
}

}  // namespace

extern "C" int matrix_mxu_viol(const void* rows, const void* cols, const void* row_base,
                               const void* col_base, void* viol, int N, int M, int m, int bi,
                               int bj, int lo, int T, void* stream) {
  if (N == 0 || M == 0) return 0;
  if (!bloom::pair_tiles_ok(bi, bj) || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bloom::pair_smem_bytes(bi, bj);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mxu_viol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((M + bj - 1) / bj, (N + bi - 1) / bi);
  mxu_viol_kernel<<<grid, (bi / PAIR_RT) * (bj / PAIR_CT), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cols),
      static_cast<const int32_t*>(row_base), static_cast<const int32_t*>(col_base),
      static_cast<float*>(viol), N, M, m, bi, bj, lo, T);
  return static_cast<int>(cudaGetLastError());
}
