// All-pairs dominance between two slabs of clocks: for every (row i,
// col j), le = all(a_i <= b_j) and ge = all(a_i >= b_j) over the m cells.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_tri and its two
// siblings in that file, all three on one pair body, each pair keeping a
// running max and min of d = a - b over the m lanes:
//   - _emit_tri (generate.bloom_matrix_tri_pallas): one u8 slab plus an
//     int32 base per row, symmetric, block-upper triangle only;
//   - _emit_rect_u8 (generate.bloom_matrix_packed_pallas): the same flag
//     math (_pair_flags_u8) over a full rows x cols rectangle;
//   - _emit_rect_i32_stats (generate.bloom_matrix_pallas): int32 logical
//     rows, wrap-subtraction dominance, row sums per bm-wide m-tile and
//     the Eq. 3 fp(row -> col) from a given col_sums.
// For packed rows the clipped base delta is constant across lanes, so it
// is added once at the end: le = max(d) + delta <= 0, ge = min(d) + delta
// >= 0, the reference's single int16 difference d + delta.
//
// Bound on this card: operations, all three.  The inputs are N*m bytes
// (4 N*m for int32 rows) and the outputs 2 to 6 bytes per pair, well
// under 1 ms at N = M = 16,384, m = 1024; the pair body is N*M*m lanes
// (half for the triangle).  Its instructions go to two pipes, each at
// half the SM's issue rate: the integer ALU pipe (VIMNMX3, IADD3, PRMT,
// LOP3) and the other (IMAD, IDP).
//
// tri: rect-u8's kernel below (TRI = true), over one slab against
// itself.  Each CTA takes one upper-triangle tile from a linear block
// index (the scalar-prefetched (ti, tj) lists of the TPU kernel), so its
// grid is the n (n + 1) / 2 tiles on and above the diagonal of an n x n
// grid, about half of rect-u8's.  The row tile stages a and the column
// tile 256 - b as in rect-u8; a diagonal tile stages the same rows in
// both forms and needs no special case.  Pairs i <= j are written
// directly and i > j by the mirror le(j, i) = ge(i, j), at any tile size.
//
// rect-u8: two lanes a 32-bit word as unsigned 16-bit halves.  Rows
// stage a | a' << 16 and columns (256 - b) | (256 - b') << 16, so one
// 32-bit add gives both lanes' d + 256 in [1, 511] with no carry between
// the halves, and a three-input VIMNMX3 (u16x2) folds two such words into
// each running max and min: 1 instruction a pair and lane, the min/max
// half on the ALU pipe and the add, as ptxas places it, on the IMAD
// pipe.  (DPX add-max and add-min would be the same count all on the ALU
// pipe.)  max(d) is the larger half of the max word less 256, min(d)
// likewise.  Lanes past m are filled, in rows and columns alike, with the
// row's lane m - 1, so that padding moves neither max nor min (a zero
// lane is not neutral once a base delta is added) and the sweep has no
// bounds.  The sweep runs faster with more warps an SM than 2 CTAs
// give, so the kernel holds no staged chunk in registers: each thread
// cp.asyncs its 4-byte
// quads of chunk k + 1 (byte loads where a row is not 4-byte aligned)
// into its own slots of a raw buffer while chunk k is swept, then turns
// them into words in the other of two shared buffers itself; one barrier
// a chunk, and 80 registers let 3 CTAs (24 warps) share an SM.
//
// rect-i32: d = a - b wraps in 32 bits and does not pack: a wrap
// subtraction a lane and a VIMNMX3 each for the max and the min of two
// lanes, 2 instructions a pair and lane, the VIMNMX3s 1 of them on the
// ALU pipe.  ptxas put a third of the subtractions there too, as IADD3;
// written as one IMAD each (common.cuh sub_imad) they all go to the
// other pipe.  Its slab (64 MiB a side at the shapes above) does not fit
// in L2, and the old design summed rows in every CTA and exposed each
// chunk's global latency.  So the chunks go global -> shared by cp.async,
// 16 bytes a copy (4-byte copies where rows are not 16-byte aligned),
// issued for chunk k + 1 before chunk k is swept, one barrier a chunk;
// lanes past m are zero in rows and columns alike, d = 0, which moves
// neither max(d) <= 0 nor min(d) >= 0.  The row sums come
// from a pre-pass launched by the same call: one warp a row sums each
// bm-wide m-tile as uint32 (wrapping) and adds the tile sums as float in
// tile order, so the float32 sums are bit-identical to the reference;
// the pair kernel reads them for Eq. 3.
//
// Flags go out as 0/1 bytes (torch.bool) through a shared-memory tile,
// coalesced (write_flags).
#include "common.cuh"

namespace {

using bloom::PAIR_CT;
using bloom::PAIR_LDK;
using bloom::PAIR_KC;
using bloom::PAIR_RT;
using bloom::PK_LANES;
using bloom::PK_LDW;
using bloom::PK_QUADS;
using bloom::PK_WORDS;

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

// Shared memory of a u16x2 tile: two word buffers and the raw slots.
constexpr size_t u16x2_smem_bytes(int bi, int bj) {
  return (2 * static_cast<size_t>(PK_LDW) + PK_QUADS) * (bi + bj) * sizeof(uint32_t);
}

// CTAs of a u16x2 tile an SM is asked to hold: 768 threads (80 registers
// each), or fewer where shared memory admits fewer (228 KiB an SM, 1 KiB
// of it reserved a CTA): 9 of the 32 x 32 tiles, not 12.  Asking for more
// than fit would cap the registers for nothing and spill.
constexpr int u16x2_ctas(int bi, int bj) {
  const int by_threads = 768 * PAIR_RT * PAIR_CT / (bi * bj);
  const int by_smem = static_cast<int>(228 * 1024 / (u16x2_smem_bytes(bi, bj) + 1024));
  return by_threads < by_smem ? by_threads : by_smem;
}

// rect-u8 on two unsigned 16-bit lanes a word (see the note at the head
// of this file): a BI x BJ tile of pairs, 4 x 4 a thread.  With TRI it
// is tri: rows and cols are one slab (N == M) with one base, and the
// block index names an upper-triangle tile.
template <int BI, int BJ, bool TRI>
__global__ void __launch_bounds__(BI * BJ / (PAIR_RT * PAIR_CT), u16x2_ctas(BI, BJ))
rect_u8_u16x2_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ cols,
                     const int32_t* __restrict__ row_base, const int32_t* __restrict__ col_base,
                     uint8_t* __restrict__ le, uint8_t* __restrict__ ge, int N, int M, int m,
                     int with_base, bool word_copies) {
  static_assert(!TRI || BI == BJ, "tri tiles are square");
  constexpr int NT = BI * BJ / (PAIR_RT * PAIR_CT);   // threads
  constexpr int RSTEP = BI / PAIR_RT, CSTEP = BJ / PAIR_CT;
  constexpr int ROWS_PER_PASS = NT / PK_QUADS;        // staged rows a pass of the CTA
  constexpr int NA = BI / ROWS_PER_PASS, NQ = NA + BJ / ROWS_PER_PASS;
  constexpr int TILE_WORDS = (BI + BJ) * PK_LDW;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* raw = smem + 2 * TILE_WORDS;              // NQ x NT u8 quads, one slot a thread each

  const int tid = threadIdx.x;
  int ti = blockIdx.y, tj = blockIdx.x;
  if (TRI) tri_tile(blockIdx.x, (N + BI - 1) / BI, ti, tj);
  const int i0 = ti * BI, j0 = tj * BJ;
  const int tx = tid % CSTEP, ty = tid / CSTEP;
  // Staging: this thread copies quad q (lanes 4q .. 4q + 3 of a chunk) of
  // NQ staged rows, the first NA of the row tile, the rest of the col
  // tile, into its own raw slots, and later turns them into words itself.
  const int q = tid % PK_QUADS, r0 = tid / PK_QUADS;
  auto tile_row = [&](int s) { return r0 + (s < NA ? s : s - NA) * ROWS_PER_PASS; };
  auto src_row = [&](int s) { return (s < NA ? i0 : j0) + tile_row(s); };
  auto row_ok = [&](int s) { return src_row(s) < (s < NA ? N : M); };
  auto row_ptr = [&](int s) { return (s < NA ? rows : cols) + static_cast<size_t>(src_row(s)) * m; };
  auto quad_lanes = [&](int k0) { return min(max(m - k0 - 4 * q, 0), 4); };
  // the chunk at lane k0 into the raw slots: 4-byte cp.async where rows
  // are 4-byte aligned (nv is then 0 or 4), else byte loads
  auto copy_chunk = [&](int k0) {
    const int nv = quad_lanes(k0);
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      const int n = row_ok(s) ? nv : 0;
      if (word_copies)
        bloom::cp_async4(raw + s * NT + tid, n ? row_ptr(s) + k0 + 4 * q : rows, n ? 4 : 0);
      else
        raw[s * NT + tid] = bloom::pk_read(row_ptr(s) + k0 + 4 * q, n, false);
    }
    bloom::cp_async_commit();
  };
  // the raw chunk at lane k0 into tile as words, lanes past m padded
  auto stage_chunk = [&](uint32_t* tile, int k0) {
    const int nv = quad_lanes(k0);
    bloom::cp_async_wait_all();
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      uint32_t x = raw[s * NT + tid];
      if (nv < 4 && row_ok(s)) x = bloom::pk_pad_last(x, nv, row_ptr(s)[m - 1]);
      const uint2 w = s < NA ? bloom::pk_u16x2(x) : bloom::pk_u16x2_neg256(x);
      *reinterpret_cast<uint2*>(tile + ((s < NA ? 0 : BI) + tile_row(s)) * PK_LDW + 2 * q) = w;
    }
  };

  // running max and min of d + 256 in both halves
  uint32_t hi[PAIR_RT][PAIR_CT], lo[PAIR_RT][PAIR_CT];
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      hi[r][c] = 0u;
      lo[r][c] = 0xFFFFFFFFu;
    }
  }
  // 4 words (8 lanes) of the staged chunk through the thread's 4 x 4 pairs
  auto sweep_group = [&](const uint32_t* As, const uint32_t* Bs, int w) {
    uint4 a[PAIR_RT], b[PAIR_CT];
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r)
      a[r] = *reinterpret_cast<const uint4*>(As + (ty + r * RSTEP) * PK_LDW + w);
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c)
      b[c] = *reinterpret_cast<const uint4*>(Bs + (tx + c * CSTEP) * PK_LDW + w);
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c) {
        uint32_t s0 = a[r].x + b[c].x, s1 = a[r].y + b[c].y;
        hi[r][c] = __vimax3_u16x2(hi[r][c], s0, s1);
        lo[r][c] = __vimin3_u16x2(lo[r][c], s0, s1);
        s0 = a[r].z + b[c].z;
        s1 = a[r].w + b[c].w;
        hi[r][c] = __vimax3_u16x2(hi[r][c], s0, s1);
        lo[r][c] = __vimin3_u16x2(lo[r][c], s0, s1);
      }
    }
  };

  const int n_chunks = (m + PK_LANES - 1) / PK_LANES;
  copy_chunk(0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    uint32_t* As = smem + (chunk & 1) * TILE_WORDS;
    const uint32_t* Bs = As + BI * PK_LDW;
    stage_chunk(As, chunk * PK_LANES);
    if (chunk + 1 < n_chunks) copy_chunk((chunk + 1) * PK_LANES);
    __syncthreads();   // As complete; the other buffer's sweep is done
#pragma unroll 2
    for (int w = 0; w < PK_WORDS; w += 8) {
      sweep_group(As, Bs, w);
      sweep_group(As, Bs, w + 4);
    }
  }
  bloom::cp_async_wait_all();   // none in flight, even with no chunk (m = 0)
  __syncthreads();   // the flag tile overlays the staged chunks

  MinMax mm;
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      mm.hi[r][c] = static_cast<int>(max(hi[r][c] & 0xFFFFu, hi[r][c] >> 16)) - 256;
      mm.lo[r][c] = static_cast<int>(min(lo[r][c] & 0xFFFFu, lo[r][c] >> 16)) - 256;
    }
  }
  write_flags<TRI>(mm, row_base, col_base, with_base, N, M, i0, j0, BI, BJ,
                   reinterpret_cast<uint8_t*>(smem), le, ge);
}

// Row sums of int32 rows, the reference's order: uint32 (wrapping) sums
// of each bm-wide m-tile, added as float in tile order; one warp a row.
__global__ void row_tile_sums_kernel(const int32_t* __restrict__ rows, float* __restrict__ sums,
                                     int N, int m, int bm) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= N) return;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(rows) + static_cast<size_t>(row) * m;
  float acc = 0.0f;
  for (int t0 = 0; t0 < m; t0 += bm) {
    const int end = min(t0 + bm, m);
    uint32_t s = 0;
#pragma unroll 8
    for (int k = t0 + lane; k < end; k += 32) s += p[k];
    acc += bloom::tile_sum_f32(bloom::warp_sum_u32(s));
  }
  if (lane == 0) sums[row] = acc;
}

// rect-i32 flags and fp (see the note at the head of this file): a
// BI x BJ tile of pairs, 4 x 4 a thread; VEC stages 16 bytes a copy.
template <int BI, int BJ, bool VEC>
__global__ void __launch_bounds__(BI * BJ / (PAIR_RT * PAIR_CT), 512 * PAIR_RT * PAIR_CT / (BI * BJ))
rect_i32_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                const float* __restrict__ row_sums, const float* __restrict__ col_sums,
                uint8_t* __restrict__ le, uint8_t* __restrict__ ge, float* __restrict__ fp, int N,
                int M, int m, float log_q, uint32_t neg1) {
  constexpr int NT = BI * BJ / (PAIR_RT * PAIR_CT);   // threads
  constexpr int RSTEP = BI / PAIR_RT, CSTEP = BJ / PAIR_CT;
  constexpr int QUADS = PAIR_KC / 4;                  // 16-byte copies a staged row
  constexpr int ROWS_PER_PASS = NT / QUADS;
  constexpr int NA = BI / ROWS_PER_PASS, NQ = NA + BJ / ROWS_PER_PASS;
  constexpr int TILE_WORDS = (BI + BJ) * PAIR_LDK;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  const int tx = tid % CSTEP, ty = tid / CSTEP;
  // Staging: this thread copies quad q (lanes 4q .. 4q + 3 of a chunk) of
  // NQ staged rows, the first NA of the row tile, the rest of the col tile.
  const int q = tid % QUADS, r0 = tid / QUADS;
  auto stage_chunk = [&](uint32_t* tile, int k0) {
    const int nv = min(max(m - k0 - 4 * q, 0), 4);
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      const int tr = r0 + (s < NA ? s : s - NA) * ROWS_PER_PASS;
      const int row = (s < NA ? i0 : j0) + tr;
      const int32_t* src = s < NA ? rows : cols;
      const int n = row < (s < NA ? N : M) ? nv : 0;
      const int32_t* p = n ? src + static_cast<size_t>(row) * m + k0 + 4 * q : src;
      uint32_t* dst = tile + ((s < NA ? 0 : BI) + tr) * PAIR_LDK + 4 * q;
      if (VEC) {
        bloom::cp_async16(dst, p, 4 * n);
      } else {
#pragma unroll
        for (int l = 0; l < 4; ++l) bloom::cp_async4(dst + l, l < n ? p + l : src, l < n ? 4 : 0);
      }
    }
    bloom::cp_async_commit();
  };

  MinMax mm;
  mm.init();
  const int n_chunks = (m + PAIR_KC - 1) / PAIR_KC;
  stage_chunk(smem, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    bloom::cp_async_wait_all();
    __syncthreads();   // chunk landed everywhere; the other buffer is free
    if (chunk + 1 < n_chunks) stage_chunk(smem + ((chunk + 1) & 1) * TILE_WORDS, (chunk + 1) * PAIR_KC);
    const uint32_t* As = smem + (chunk & 1) * TILE_WORDS;
    const uint32_t* Bs = As + BI * PAIR_LDK;
#pragma unroll 4
    for (int k = 0; k < PAIR_KC; k += 4) {
      uint4 a[PAIR_RT], b[PAIR_CT];
#pragma unroll
      for (int r = 0; r < PAIR_RT; ++r)
        a[r] = *reinterpret_cast<const uint4*>(As + (ty + r * RSTEP) * PAIR_LDK + k);
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c)
        b[c] = *reinterpret_cast<const uint4*>(Bs + (tx + c * CSTEP) * PAIR_LDK + k);
#pragma unroll
      for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
        for (int c = 0; c < PAIR_CT; ++c) {
          int d0 = static_cast<int>(bloom::sub_imad(a[r].x, b[c].x, neg1));
          int d1 = static_cast<int>(bloom::sub_imad(a[r].y, b[c].y, neg1));
          mm.hi[r][c] = __vimax3_s32(mm.hi[r][c], d0, d1);
          mm.lo[r][c] = __vimin3_s32(mm.lo[r][c], d0, d1);
          d0 = static_cast<int>(bloom::sub_imad(a[r].z, b[c].z, neg1));
          d1 = static_cast<int>(bloom::sub_imad(a[r].w, b[c].w, neg1));
          mm.hi[r][c] = __vimax3_s32(mm.hi[r][c], d0, d1);
          mm.lo[r][c] = __vimin3_s32(mm.lo[r][c], d0, d1);
        }
      }
    }
  }
  bloom::cp_async_wait_all();   // none in flight, even with no chunk (m = 0)
  __syncthreads();   // the flag tile overlays the staged chunks

  float sx[PAIR_RT], sy[PAIR_CT];
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) sx[r] = i0 + ty + r * RSTEP < N ? row_sums[i0 + ty + r * RSTEP] : 0.0f;
#pragma unroll
  for (int c = 0; c < PAIR_CT; ++c) sy[c] = j0 + tx + c * CSTEP < M ? col_sums[j0 + tx + c * CSTEP] : 0.0f;
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      const int i = i0 + ty + r * RSTEP, j = j0 + tx + c * CSTEP;
      if (i < N && j < M) fp[static_cast<size_t>(i) * M + j] = bloom::eq3_fp(sx[r], sy[c], log_q);
    }
  }
  write_flags<false>(mm, nullptr, nullptr, 0, N, M, i0, j0, BI, BJ,
                     reinterpret_cast<uint8_t*>(smem), le, ge);
}

// rect-u8 over a grid of BI x BJ tiles, or with TRI tri over the
// n (n + 1) / 2 upper-triangle tiles of one slab (rows == cols, N == M).
template <int BI, int BJ, bool TRI>
int launch_u16x2(const void* rows, const void* cols, const void* row_base,
                 const void* col_base, void* le, void* ge, int N, int M, int m, int with_base,
                 cudaStream_t stream) {
  const auto kernel = rect_u8_u16x2_kernel<BI, BJ, TRI>;
  const size_t smem = u16x2_smem_bytes(BI, BJ);
  if (int err = bloom::allow_smem(kernel, smem)) return err;
  const bool word_copies = m % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0 &&
                           reinterpret_cast<uintptr_t>(cols) % 4 == 0;
  const long long n_tiles = (N + BI - 1) / BI;
  const dim3 grid = TRI ? dim3(static_cast<unsigned>(n_tiles * (n_tiles + 1) / 2))
                        : dim3((M + BJ - 1) / BJ, (N + BI - 1) / BI);
  kernel<<<grid, BI * BJ / (PAIR_RT * PAIR_CT), smem, stream>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cols),
      static_cast<const int32_t*>(row_base), static_cast<const int32_t*>(col_base),
      static_cast<uint8_t*>(le), static_cast<uint8_t*>(ge), N, M, m, with_base, word_copies);
  return static_cast<int>(cudaGetLastError());
}

template <int BI, int BJ>
int launch_rect_i32(const void* rows, const void* cols, const void* row_sums,
                    const void* col_sums, void* le, void* ge, void* fp, int N, int M, int m,
                    float log_q, cudaStream_t stream) {
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const auto kernel = vec ? &rect_i32_kernel<BI, BJ, true> : &rect_i32_kernel<BI, BJ, false>;
  const size_t smem = 2 * static_cast<size_t>(BI + BJ) * PAIR_LDK * sizeof(uint32_t);
  if (int err = bloom::allow_smem(kernel, smem)) return err;
  const dim3 grid((M + BJ - 1) / BJ, (N + BI - 1) / BI);
  kernel<<<grid, BI * BJ / (PAIR_RT * PAIR_CT), smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(row_sums), static_cast<const float*>(col_sums),
      static_cast<uint8_t*>(le), static_cast<uint8_t*>(ge), static_cast<float*>(fp), N, M, m,
      log_q, 0xFFFFFFFFu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matrix_tri_flags(const void* cells, const void* base, void* le, void* ge, int N,
                                int m, int bt, int with_base, void* stream) {
  if (N == 0) return 0;
  if (!bloom::pair_tiles_ok(bt, bt)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bt == 32)
    return launch_u16x2<32, 32, true>(cells, cells, base, base, le, ge, N, N, m, with_base, s);
  if (bt == 64)
    return launch_u16x2<64, 64, true>(cells, cells, base, base, le, ge, N, N, m, with_base, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#define PAIR_TILE_CASES(X) \
  X(32, 32) X(32, 64) X(32, 128) X(64, 32) X(64, 64) X(64, 128) X(128, 32) X(128, 64)

extern "C" int matrix_rect_u8_flags(const void* rows, const void* cols, const void* row_base,
                                    const void* col_base, void* le, void* ge, int N, int M,
                                    int m, int bi, int bj, int with_base, void* stream) {
  if (N == 0 || M == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define RECT_U8(BI, BJ)                                                                   \
  if (bi == BI && bj == BJ)                                                               \
    return launch_u16x2<BI, BJ, false>(rows, cols, row_base, col_base, le, ge, N, M, m,    \
                                       with_base, s);
  PAIR_TILE_CASES(RECT_U8)
#undef RECT_U8
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int SUM_WARPS = 8;  // warps a CTA of the row-sum pre-pass

extern "C" int matrix_rect_i32_stats(const void* rows, const void* cols, const void* col_sums,
                                     void* le, void* ge, void* row_sums, void* fp, int N, int M,
                                     int m, int bi, int bj, int bm, float log_q, void* stream) {
  if (N == 0 || M == 0) return 0;
  if (bm <= 0 || !bloom::pair_tiles_ok(bi, bj)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  row_tile_sums_kernel<<<(N + SUM_WARPS - 1) / SUM_WARPS, 32 * SUM_WARPS, 0, s>>>(
      static_cast<const int32_t*>(rows), static_cast<float*>(row_sums), N, m, bm);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
#define RECT_I32(BI, BJ)                                                                  \
  if (bi == BI && bj == BJ)                                                               \
    return launch_rect_i32<BI, BJ>(rows, cols, row_sums, col_sums, le, ge, fp, N, M, m,    \
                                   log_q, s);
  PAIR_TILE_CASES(RECT_I32)
#undef RECT_I32
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel instances the autotuner's model describes: 0 rect-u8, 1 tri, 2
// rect-i32 with 16-byte staging, 3 rect-i32 with 4-byte staging (bi x bj
// pairs a CTA), 4 rect-i32's row-sum pre-pass (no tile).
enum MatrixKind { KIND_RECT_U8 = 0, KIND_TRI, KIND_I32, KIND_I32_SCALAR, KIND_ROW_SUMS };

// Dynamic shared memory of a CTA of instance `kind` at a bi x bj tile, as
// its launcher asks for it; -1 for a tile the instance does not take.
extern "C" int matrix_smem(int kind, int bi, int bj) {
  if (kind == KIND_ROW_SUMS) return 0;
  if (!bloom::pair_tiles_ok(bi, bj) || (kind == KIND_TRI && (bi != bj || bi > 64))) return -1;
  if (kind == KIND_RECT_U8 || kind == KIND_TRI) return static_cast<int>(u16x2_smem_bytes(bi, bj));
  if (kind == KIND_I32 || kind == KIND_I32_SCALAR)
    return static_cast<int>(2 * static_cast<size_t>(bi + bj) * PAIR_LDK * sizeof(uint32_t));
  return -1;
}

// Registers, thread limit, static and dynamic shared memory and the CTAs
// an SM the runtime admits (common.cuh kernel_attrs) of instance `kind`
// at a bi x bj tile, launched as its launcher starts it.
extern "C" int matrix_attrs(int kind, int bi, int bj, int* out) {
  if (kind == KIND_ROW_SUMS) return bloom::kernel_attrs(row_tile_sums_kernel, 32 * SUM_WARPS, 0, out);
  const int smem = matrix_smem(kind, bi, bj);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = bi * bj / (PAIR_RT * PAIR_CT);
  if (kind == KIND_TRI) {
    if (bi == 32) return bloom::kernel_attrs(rect_u8_u16x2_kernel<32, 32, true>, threads, smem, out);
    return bloom::kernel_attrs(rect_u8_u16x2_kernel<64, 64, true>, threads, smem, out);
  }
#define ATTRS(BI, BJ)                                                                        \
  if (bi == BI && bj == BJ) {                                                                \
    if (kind == KIND_RECT_U8)                                                                \
      return bloom::kernel_attrs(rect_u8_u16x2_kernel<BI, BJ, false>, threads, smem, out);  \
    if (kind == KIND_I32)                                                                    \
      return bloom::kernel_attrs(rect_i32_kernel<BI, BJ, true>, threads, smem, out);        \
    if (kind == KIND_I32_SCALAR)                                                             \
      return bloom::kernel_attrs(rect_i32_kernel<BI, BJ, false>, threads, smem, out);       \
  }
  PAIR_TILE_CASES(ATTRS)
#undef ATTRS
  return static_cast<int>(cudaErrorInvalidValue);
}
