// All-pairs dominance between two slabs of clocks: for every (row i,
// col j), le = all(a_i <= b_j) and ge = all(a_i >= b_j) over the m cells.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_tri and its two
// siblings in that file, all three on the same pair body:
//   - _emit_tri (generate.bloom_matrix_tri_pallas): one u8 slab plus an
//     int32 base per row, symmetric, block-upper triangle only;
//   - _emit_rect_u8 (generate.bloom_matrix_packed_pallas): the same flag
//     math (_pair_flags_u8) over a full rows x cols rectangle;
//   - _emit_rect_i32_stats (generate.bloom_matrix_pallas): int32 logical
//     rows, wrap-subtraction dominance, row sums per bm-wide m-tile and
//     the Eq. 3 fp(row -> col) from a given col_sums.
//
// Bound on this card: operations.  Each pair keeps a running max and min
// of the difference of m cells.  On sm_90 that takes at fewest one
// instruction per pair and lane for u8 rows (a DPX add-max and add-min,
// __viaddmax_s16x2 / __viaddmin_s16x2, each over two 16-bit lanes) and
// two for int32 rows, whose wrap differences do not pack; half the pairs
// for the triangle.  The inputs are N*m bytes (4 N*m for int32 rows) and
// the outputs 2 to 6 bytes per pair: at N = M = 16,384, m = 1024 the u8
// rectangle is ~8 ms at the SM's issue rate (128 lanes a clock), the
// int32 one ~16 ms, and memory traffic well under 1 ms.  This design
// compiles to ~2.3 instructions per pair and lane (a VIMNMX3 max or min
// over two lanes, ~1.2 IMAD subtractions); packing two lanes into 16 bits
// is the redesign noted in ROADMAP.md.
// Design: one CTA per bi x bj tile of pairs; both row tiles stream
// through shared memory in 64-lane chunks (common.cuh) and each thread
// keeps 4 x 4 pairs in registers, so every staged word is used 4 times
// from one 16-byte shared-memory read.  The difference d = a - b is taken
// unsigned and reinterpreted as int32 (the reference's wrap-subtraction;
// for widened u8 it is the plain difference in [-255, 255]), and each
// pair keeps a running max and min of d.  For packed rows the clipped
// base delta is constant across lanes, so it is added once at the end:
// le = max(d) + delta <= 0, ge = min(d) + delta >= 0, the reference's
// single int16 difference d + delta, since max(d + c) = max(d) + c.
// Lanes past m are never compared; the reference masks them to 0, which
// moves neither max(d) <= 0 nor min(d) >= 0.  Flags go out as 0/1 bytes
// (torch.bool) through a shared-memory tile so that both the tile and,
// for the triangle, its mirror le(j, i) = ge(i, j) are written with
// coalesced stores.  The triangle walks tiles ti <= tj from a linear
// block index (the scalar-prefetched (ti, tj) lists of the TPU kernel)
// and writes pairs i <= j directly and i > j by the mirror, a rule that
// does not depend on the tile size.  The i32 kernel also sums its row
// tile per bm-wide m-tile as uint32 (wrapping) and adds the tile sums as
// float in tile order, so its float32 row sums are bit-identical to the
// reference; every CTA sums its own rows, and the CTAs of tile column 0
// write them out.
#include "common.cuh"

namespace {

using bloom::PAIR_CT;
using bloom::PAIR_LDK;
using bloom::PAIR_KC;
using bloom::PAIR_RT;

// Running max and min of d = a - b per pair of the thread.
struct MinMax {
  int hi[PAIR_RT][PAIR_CT];
  int lo[PAIR_RT][PAIR_CT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c) {
        hi[r][c] = INT_MIN;
        lo[r][c] = INT_MAX;
      }
    }
  }

  __device__ __forceinline__ void operator()(int r, int c, uint32_t a, uint32_t b) {
    const int d = static_cast<int>(a - b);
    hi[r][c] = max(hi[r][c], d);
    lo[r][c] = min(lo[r][c], d);
  }
};

// Tile (ti, tj), ti <= tj, of the linear index t over n tiles a side.
__device__ __forceinline__ void tri_tile(long long t, int n, int& ti, int& tj) {
  const double b = 2.0 * n + 1.0;
  long long i = static_cast<long long>((b - sqrt(b * b - 8.0 * static_cast<double>(t))) / 2.0);
  auto first = [n](long long r) { return r * n - r * (r - 1) / 2; };  // tiles before row r
  if (i < 0) i = 0;
  if (i > n - 1) i = n - 1;
  while (i > 0 && first(i) > t) --i;
  while (i + 1 < n && first(i + 1) <= t) ++i;
  ti = static_cast<int>(i);
  tj = static_cast<int>(i + (t - first(i)));
}

// Sweep every m-chunk of the tile.  With ROW_SUMS, warps also sum the
// staged row tile per bm-wide m-tile into rs_f (one float per row).
template <typename T, bool ROW_SUMS>
__device__ __forceinline__ void sweep_tile(const T* __restrict__ rows, const T* __restrict__ cols,
                                           int N, int M, int m, int i0, int j0, int bi, int bj,
                                           int bm, uint32_t* As, uint32_t* Bs,
                                           uint32_t* rs_tile, float* rs_f, MinMax& mm) {
  const int cstep = bj / PAIR_CT, rstep = bi / PAIR_RT;
  const int tx = threadIdx.x % cstep, ty = threadIdx.x / cstep;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  if (ROW_SUMS) {
    for (int r = threadIdx.x; r < bi; r += blockDim.x) {
      rs_tile[r] = 0u;
      rs_f[r] = 0.0f;
    }
  }
  for (int k0 = 0; k0 < m; k0 += PAIR_KC) {
    const int kc = min(PAIR_KC, m - k0);
    bloom::stage_rows(As, rows, N, i0, bi, m, k0, kc, bloom::AsWord());
    bloom::stage_rows(Bs, cols, M, j0, bj, m, k0, kc, bloom::AsWord());
    __syncthreads();
    if (ROW_SUMS) {
      const bool tile_end = (k0 + kc) % bm == 0 || k0 + kc == m;
      for (int r = warp; r < bi; r += n_warps) {
        uint32_t v = As[r * PAIR_LDK + lane] + As[r * PAIR_LDK + lane + 32];
        v = bloom::warp_sum_u32(v);
        if (lane == 0) {
          const uint32_t s = rs_tile[r] + v;
          if (tile_end) {
            rs_f[r] += bloom::tile_sum_f32(s);
            rs_tile[r] = 0u;
          } else {
            rs_tile[r] = s;
          }
        }
      }
    }
    bloom::sweep_chunk(As, Bs, kc, ty, tx, rstep, cstep, mm);
    __syncthreads();
  }
}

// Flags of the tile through shared memory F (which may overlay the
// staged tiles: the caller has synchronised after the last sweep), then
// coalesced stores of the tile and, for TRI, its mirror.
template <bool TRI>
__device__ __forceinline__ void write_flags(const MinMax& mm, const int32_t* __restrict__ row_base,
                                            const int32_t* __restrict__ col_base, int with_base,
                                            int N, int M, int i0, int j0, int bi, int bj,
                                            uint8_t* F, uint8_t* __restrict__ le,
                                            uint8_t* __restrict__ ge) {
  const int cstep = bj / PAIR_CT, rstep = bi / PAIR_RT;
  const int tx = threadIdx.x % cstep, ty = threadIdx.x / cstep;
  const int ldf = bj + 4;
  uint8_t* Fle = F;
  uint8_t* Fge = F + bi * ldf;
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      const int rr = ty + r * rstep, cc = tx + c * cstep;
      const int i = i0 + rr, j = j0 + cc;
      int delta = 0;
      if (with_base && i < N && j < M) {
        delta = static_cast<int>(static_cast<uint32_t>(row_base[i]) -
                                 static_cast<uint32_t>(col_base[j]));
        delta = min(max(delta, -256), 256);
      }
      Fle[rr * ldf + cc] = (mm.hi[r][c] + delta) <= 0;
      Fge[rr * ldf + cc] = (mm.lo[r][c] + delta) >= 0;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bi * bj; idx += blockDim.x) {
    const int rr = idx / bj, cc = idx % bj, i = i0 + rr, j = j0 + cc;
    if (i < N && j < M && (!TRI || i <= j)) {
      const size_t o = static_cast<size_t>(i) * M + j;
      le[o] = Fle[rr * ldf + cc];
      ge[o] = Fge[rr * ldf + cc];
    }
  }
  if (TRI) {
    for (int idx = threadIdx.x; idx < bi * bj; idx += blockDim.x) {
      const int rr = idx % bi, cc = idx / bi, i = i0 + rr, j = j0 + cc;
      if (j < M && i < j) {
        const size_t o = static_cast<size_t>(j) * N + i;
        le[o] = Fge[rr * ldf + cc];
        ge[o] = Fle[rr * ldf + cc];
      }
    }
  }
}

__global__ void tri_flags_kernel(const uint8_t* __restrict__ cells,
                                 const int32_t* __restrict__ base, uint8_t* __restrict__ le,
                                 uint8_t* __restrict__ ge, int N, int m, int bt, int n_tiles,
                                 int with_base) {
  extern __shared__ __align__(16) uint32_t smem[];
  int ti, tj;
  tri_tile(blockIdx.x, n_tiles, ti, tj);
  const int i0 = ti * bt, j0 = tj * bt;
  MinMax mm;
  mm.init();
  sweep_tile<uint8_t, false>(cells, cells, N, N, m, i0, j0, bt, bt, m, smem,
                             smem + bt * PAIR_LDK, nullptr, nullptr, mm);
  write_flags<true>(mm, base, base, with_base, N, N, i0, j0, bt, bt,
                    reinterpret_cast<uint8_t*>(smem), le, ge);
}

__global__ void rect_u8_flags_kernel(const uint8_t* __restrict__ rows,
                                     const uint8_t* __restrict__ cols,
                                     const int32_t* __restrict__ row_base,
                                     const int32_t* __restrict__ col_base,
                                     uint8_t* __restrict__ le, uint8_t* __restrict__ ge, int N,
                                     int M, int m, int bi, int bj, int with_base) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int i0 = blockIdx.y * bi, j0 = blockIdx.x * bj;
  MinMax mm;
  mm.init();
  sweep_tile<uint8_t, false>(rows, cols, N, M, m, i0, j0, bi, bj, m, smem,
                             smem + bi * PAIR_LDK, nullptr, nullptr, mm);
  write_flags<false>(mm, row_base, col_base, with_base, N, M, i0, j0, bi, bj,
                     reinterpret_cast<uint8_t*>(smem), le, ge);
}

__global__ void rect_i32_stats_kernel(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ cols,
                                      const float* __restrict__ col_sums,
                                      uint8_t* __restrict__ le, uint8_t* __restrict__ ge,
                                      float* __restrict__ row_sums, float* __restrict__ fp, int N,
                                      int M, int m, int bi, int bj, int bm, float log_q) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int i0 = blockIdx.y * bi, j0 = blockIdx.x * bj;
  uint32_t* rs_tile = smem + (bi + bj) * PAIR_LDK;
  float* rs_f = reinterpret_cast<float*>(rs_tile + bi);
  MinMax mm;
  mm.init();
  sweep_tile<int32_t, true>(rows, cols, N, M, m, i0, j0, bi, bj, bm, smem,
                            smem + bi * PAIR_LDK, rs_tile, rs_f, mm);
  // rs_f is complete (the sweep ends in a barrier) and lies outside F
  const int cstep = bj / PAIR_CT, rstep = bi / PAIR_RT;
  const int tx = threadIdx.x % cstep, ty = threadIdx.x / cstep;
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      const int i = i0 + ty + r * rstep, j = j0 + tx + c * cstep;
      if (i < N && j < M)
        fp[static_cast<size_t>(i) * M + j] = bloom::eq3_fp(rs_f[ty + r * rstep], col_sums[j], log_q);
    }
  }
  if (blockIdx.x == 0) {
    for (int r = threadIdx.x; r < bi; r += blockDim.x)
      if (i0 + r < N) row_sums[i0 + r] = rs_f[r];
  }
  write_flags<false>(mm, nullptr, nullptr, 0, N, M, i0, j0, bi, bj,
                     reinterpret_cast<uint8_t*>(smem), le, ge);
}

template <typename K>
int prepare(K kernel, int bi, int bj, size_t* smem) {
  if (!bloom::pair_tiles_ok(bi, bj))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = bloom::pair_smem_bytes(bi, bj);
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(*smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int matrix_tri_flags(const void* cells, const void* base, void* le, void* ge, int N,
                                int m, int bt, int with_base, void* stream) {
  if (N == 0) return 0;
  size_t smem = 0;
  if (int err = prepare(tri_flags_kernel, bt, bt, &smem)) return err;
  const int n_tiles = (N + bt - 1) / bt;
  const long long blocks = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
  tri_flags_kernel<<<static_cast<unsigned>(blocks), (bt / PAIR_RT) * (bt / PAIR_CT), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cells), static_cast<const int32_t*>(base),
      static_cast<uint8_t*>(le), static_cast<uint8_t*>(ge), N, m, bt, n_tiles, with_base);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matrix_rect_u8_flags(const void* rows, const void* cols, const void* row_base,
                                    const void* col_base, void* le, void* ge, int N, int M,
                                    int m, int bi, int bj, int with_base, void* stream) {
  if (N == 0 || M == 0) return 0;
  size_t smem = 0;
  if (int err = prepare(rect_u8_flags_kernel, bi, bj, &smem)) return err;
  const dim3 grid((M + bj - 1) / bj, (N + bi - 1) / bi);
  rect_u8_flags_kernel<<<grid, (bi / PAIR_RT) * (bj / PAIR_CT), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cols),
      static_cast<const int32_t*>(row_base), static_cast<const int32_t*>(col_base),
      static_cast<uint8_t*>(le), static_cast<uint8_t*>(ge), N, M, m, bi, bj, with_base);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int matrix_rect_i32_stats(const void* rows, const void* cols, const void* col_sums,
                                     void* le, void* ge, void* row_sums, void* fp, int N, int M,
                                     int m, int bi, int bj, int bm, float log_q, void* stream) {
  if (N == 0 || M == 0) return 0;
  if (bm <= 0 || bm % PAIR_KC != 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (int err = prepare(rect_i32_stats_kernel, bi, bj, &smem)) return err;
  const dim3 grid((M + bj - 1) / bj, (N + bi - 1) / bi);
  rect_i32_stats_kernel<<<grid, (bi / PAIR_RT) * (bj / PAIR_CT), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(col_sums), static_cast<uint8_t*>(le), static_cast<uint8_t*>(ge),
      static_cast<float*>(row_sums), static_cast<float*>(fp), N, M, m, bi, bj, bm, log_q);
  return static_cast<int>(cudaGetLastError());
}
