// All-pairs violation counts over two packed slabs:
//   viol[i, j] = sum over m of relu(min(a_im, T) - max(b_jm, 0))
// on window-relative values a = u8 + (row_base - lo), b = u8 +
// (col_base - lo) (int32 wrap), as float32.  le(i, j) = viol == 0, and
// the caller derives ge from the rank-1 identity with the row and col
// sums.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_mxu
// (generate.bloom_matrix_mxu_pallas), which thermometer-encodes both
// tiles over T thresholds and counts #{(m, t): b < t <= a} with one f32
// dot_general on the MXU.  That count is relu(min(a, T) - max(b, 0)) per
// lane, for any a and b, which is what this kernel sums: the same value
// without the T-fold encoding.
//
// Bound on this card: operations.  Each pair and lane adds relu(a - b) to
// a count (the inputs are 16 MiB and the output 1 GiB at N = M = 16,384,
// m = 1024, ~0.3 ms).  With a clamped to [-1, T] and b to [0, T + 1],
// a and -b fit 16 bits, so the design holds two lanes a 32-bit word and
// takes them with one DPX add-relu (VIADDMNMX.S16x2.RELU): 0.5
// instructions per pair and lane.  The sums of the results are the rest.
// VIADDMNMX and IADD3 go to the integer ALU pipe, which takes half the
// SM's issue rate; IDP goes to the other.  So of every 8 words, 2 go
// into a packed count of two 16-bit halves with one three-input IADD3
// and 6 into a 32-bit count with one IDP each (dp2a, weights 1, 1):
// ~0.96 instructions per pair and lane in the built hot loop, of which
// ~0.57 on the ALU pipe.  (All IADD3 is 0.75 a pair and lane, all on the
// ALU pipe, and ran slower; all IDP is 1.0 plus the loop's overhead.)  The
// packed halves are non-negative and gain at most 8 T a chunk, so no
// carry crosses them; they move into the 32-bit count before any could
// pass 65,535 (every floor(65535 / (8 T)) staged chunks; T <= 8191).
// The tensor-core formulation, 0/1 thermometer operands in int8 with s32
// accumulation, does 2T operations per pair and lane at 1,979 Tops: ~18
// ms at T = 64.
//
// Design: the 4 x 4-pairs-a-thread tile of bloom_matrix.cu over packed
// chunks of 64 lanes (common.cuh, PK_*), double-buffered in shared
// memory: each thread reads its share of the next chunk from global
// memory (4 bytes a read) into registers while it sweeps the current
// one, so one barrier a chunk suffices.  The window shift and clamps are
// done once per staged lane with 16 x 2 SIMD, from an offset packed once
// per row (pk_offset); rows stage clamp(a) and columns -clamp(b), padded
// lanes and rows 0 in both, which adds 0.  The count is exact in int32
// (the caller refuses m * T >= 2^24, as the reference does) and stored
// as float32.
//
// Above MXU_T_MAX the packed halves could overflow within a chunk, so a
// plain kernel takes over: one lane a 32-bit word (common.cuh
// stage_rows, sweep_chunk), rows staged clamp(u8 + (base - lo), -1, T)
// and columns clamp(u8 + (base - lo), 0, T + 1) in int32 wrap, each
// pair adding max(a - b, 0) to a 32-bit count; lanes and rows past the
// slab are 0 and add 0.  Its bound is operations: while T <= 32,766 the
// clamped values and every a - b still fit signed 16-bit halves, so one
// add-relu and one dp2a (IDP) into a 32-bit count take two lanes, 1 a
// pair and lane (2 above that T: a subtraction with relu and an add).
// It lies on no engine's path (pairs asks for T <= 64) and is not tuned.
#include "common.cuh"

namespace {

using bloom::PAIR_CT;
using bloom::PAIR_RT;
using bloom::PK_LDW;
using bloom::PK_QUADS;
using bloom::PK_WORDS;

constexpr int PK_GROUP = 4;                       // words a 16-byte shared load
constexpr int PK_PACKED_WORDS = PK_WORDS / 4;     // words a chunk into the packed count
// Largest T whose 16-bit count halves cannot overflow within one chunk:
// the s16x2 kernel takes T up to it, the 32-bit-lane kernel T above it.
constexpr int MXU_T_MAX = 65535 / PK_PACKED_WORDS;

// relu(a - b) in both halves as max(a + nb, nb, 0), which is
// max(a + nb, 0) because nb = -b <= 0: one VIADDMNMX.RELU, with no zero
// operand to build (the (a, nb, 0) form costs a PRMT per instruction).
__device__ __forceinline__ uint32_t relu_diff(uint32_t a, uint32_t nb) {
  return __viaddmax_s16x2_relu(a, nb, nb);
}

// total plus both 16-bit halves of r: one IDP (dp2a with weights 1, 1).
__device__ __forceinline__ uint32_t add_halves(uint32_t total, uint32_t r) {
  return __dp2a_lo(r, 0x0101u, total);
}

template <int BI, int BJ>
__global__ void __launch_bounds__(BI * BJ / (PAIR_RT * PAIR_CT), 512 * PAIR_RT * PAIR_CT / (BI * BJ))
mxu_viol_s16x2_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ cols,
                      const int32_t* __restrict__ row_base,
                      const int32_t* __restrict__ col_base, float* __restrict__ viol,
                      int N, int M, int m, int lo, int T, bool word_reads) {
  constexpr int NT = BI * BJ / (PAIR_RT * PAIR_CT);   // threads
  constexpr int RSTEP = BI / PAIR_RT, CSTEP = BJ / PAIR_CT;
  constexpr int ROWS_PER_PASS = NT / PK_QUADS;        // staged rows a pass of the CTA
  constexpr int NA = BI / ROWS_PER_PASS, NQ = NA + BJ / ROWS_PER_PASS;
  constexpr int TILE_WORDS = (BI + BJ) * PK_LDW;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * BI, j0 = blockIdx.x * BJ;
  const int tx = tid % CSTEP, ty = tid / CSTEP;
  // Staging: this thread reads quad q (lanes 4q .. 4q + 3 of a chunk) of
  // NQ staged rows, the first NA of the row tile, the rest of the col
  // tile; their packed offsets are fixed for the whole sweep.
  const int q = tid % PK_QUADS, r0 = tid / PK_QUADS;
  auto tile_row = [&](int s) { return r0 + (s < NA ? s : s - NA) * ROWS_PER_PASS; };
  auto src_row = [&](int s) { return (s < NA ? i0 : j0) + tile_row(s); };
  auto row_ok = [&](int s) { return src_row(s) < (s < NA ? N : M); };
  uint32_t d2[NQ];
#pragma unroll
  for (int s = 0; s < NQ; ++s)
    d2[s] = bloom::pk_offset(row_ok(s) ? (s < NA ? row_base : col_base)[src_row(s)] : lo,
                             lo, T + 1);
  const uint32_t a_lo = bloom::pk_splat(-1), a_hi = bloom::pk_splat(T);
  const uint32_t b_lo = 0, b_hi = bloom::pk_splat(T + 1);

  // lanes of quad q inside m, for the chunk at lane k0
  auto quad_lanes = [&](int k0) { return min(max(m - k0 - 4 * q, 0), 4); };
  uint32_t x[NQ];
  auto read_chunk = [&](int k0) {
    const int nv = quad_lanes(k0);
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      const uint8_t* p = (s < NA ? rows : cols) + static_cast<size_t>(src_row(s)) * m + k0 + 4 * q;
      x[s] = row_ok(s) ? bloom::pk_read(p, nv, word_reads) : 0;
    }
  };
  auto stage_chunk = [&](uint32_t* tile, int k0) {
    const int nv = quad_lanes(k0);
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      const int n = row_ok(s) ? nv : 0;
      const uint2 w = s < NA ? bloom::pk_quad<false>(x[s], d2[s], a_lo, a_hi, n)
                             : bloom::pk_quad<true>(x[s], d2[s], b_lo, b_hi, n);
      *reinterpret_cast<uint2*>(tile + ((s < NA ? 0 : BI) + tile_row(s)) * PK_LDW + 2 * q) = w;
    }
  };

  uint32_t acc[PAIR_RT][PAIR_CT], total[PAIR_RT][PAIR_CT];
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) acc[r][c] = total[r][c] = 0;
  }
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c) {
        total[r][c] += (acc[r][c] & 0xFFFFu) + (acc[r][c] >> 16);
        acc[r][c] = 0;
      }
    }
  };

  // PK_GROUP words of the staged chunk through the thread's 4 x 4 pairs:
  // with `packed`, the first two words' add-relus go into the packed
  // count with one three-input add, the rest into the 32-bit count.
  auto sweep_group = [&](const uint32_t* As, const uint32_t* Bs, int w, bool packed) {
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
        const uint32_t r0 = relu_diff(a[r].x, b[c].x), r1 = relu_diff(a[r].y, b[c].y);
        if (packed) {
          acc[r][c] += r0 + r1;
        } else {
          total[r][c] = add_halves(add_halves(total[r][c], r0), r1);
        }
        total[r][c] = add_halves(total[r][c], relu_diff(a[r].z, b[c].z));
        total[r][c] = add_halves(total[r][c], relu_diff(a[r].w, b[c].w));
      }
    }
  };

  const int n_chunks = (m + 2 * PK_WORDS - 1) / (2 * PK_WORDS);
  const int flush_every = 65535 / (PK_PACKED_WORDS * T);
  read_chunk(0);
  for (int chunk = 0, since = 0; chunk < n_chunks; ++chunk) {
    uint32_t* As = smem + (chunk & 1) * TILE_WORDS;
    const uint32_t* Bs = As + BI * PK_LDW;
    stage_chunk(As, chunk * 2 * PK_WORDS);
    __syncthreads();
    if (chunk + 1 < n_chunks) read_chunk((chunk + 1) * 2 * PK_WORDS);
#pragma unroll 2
    for (int w = 0; w < PK_WORDS; w += 2 * PK_GROUP) {
      sweep_group(As, Bs, w, true);
      sweep_group(As, Bs, w + PK_GROUP, false);
    }
    if (++since == flush_every) {
      flush();
      since = 0;
    }
  }
  flush();
#pragma unroll
  for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c) {
      const int i = i0 + ty + r * RSTEP, j = j0 + tx + c * CSTEP;
      if (i < N && j < M) viol[static_cast<size_t>(i) * M + j] = static_cast<float>(total[r][c]);
    }
  }
}

// clamp(u8 + (base[row] - lo), lo_c, hi_c), the window shift in int32 wrap.
struct WindowClamp {
  const int32_t* __restrict__ base;
  int32_t lo;
  int lo_c, hi_c;
  __device__ __forceinline__ uint32_t operator()(int row, uint32_t v) const {
    const uint32_t d = static_cast<uint32_t>(base[row]) - static_cast<uint32_t>(lo);
    const int x = static_cast<int>(v + d);
    return static_cast<uint32_t>(min(max(x, lo_c), hi_c));
  }
};

// relu(a - b) summed per pair of the thread; a in [-1, T], b in [0, T + 1].
struct ReluCount {
  uint32_t n[PAIR_RT][PAIR_CT];
  __device__ __forceinline__ void operator()(int r, int c, uint32_t a, uint32_t b) {
    n[r][c] += static_cast<uint32_t>(max(static_cast<int>(a) - static_cast<int>(b), 0));
  }
};

// Violation counts on 32-bit lanes, for T > MXU_T_MAX: a bi x bj tile of
// pairs a CTA, 4 x 4 a thread.
__global__ void __launch_bounds__(bloom::PAIR_MAX_PAIRS / (PAIR_RT * PAIR_CT))
mxu_viol_wide_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ cols,
                     const int32_t* __restrict__ row_base, const int32_t* __restrict__ col_base,
                     float* __restrict__ viol, int N, int M, int m, int bi, int bj, int lo,
                     int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;
  uint32_t* Bs = smem + bi * bloom::PAIR_LDK;
  const int i0 = blockIdx.y * bi, j0 = blockIdx.x * bj;
  const int cstep = bj / PAIR_CT, rstep = bi / PAIR_RT;
  const int tx = threadIdx.x % cstep, ty = threadIdx.x / cstep;
  const WindowClamp fa{row_base, lo, -1, T}, fb{col_base, lo, 0, T + 1};
  ReluCount acc{};
  for (int k0 = 0; k0 < m; k0 += bloom::PAIR_KC) {
    const int kc = min(bloom::PAIR_KC, m - k0);
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

int launch_wide(const void* rows, const void* cols, const void* row_base, const void* col_base,
                void* viol, int N, int M, int m, int bi, int bj, int lo, int T,
                cudaStream_t stream) {
  const size_t smem = bloom::pair_smem_bytes(bi, bj);
  if (int err = bloom::allow_smem(mxu_viol_wide_kernel, smem)) return err;
  const dim3 grid((M + bj - 1) / bj, (N + bi - 1) / bi);
  mxu_viol_wide_kernel<<<grid, (bi / PAIR_RT) * (bj / PAIR_CT), smem, stream>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cols),
      static_cast<const int32_t*>(row_base), static_cast<const int32_t*>(col_base),
      static_cast<float*>(viol), N, M, m, bi, bj, lo, T);
  return static_cast<int>(cudaGetLastError());
}

template <int BI, int BJ>
int launch(const void* rows, const void* cols, const void* row_base, const void* col_base,
           void* viol, int N, int M, int m, int lo, int T, cudaStream_t stream) {
  const auto kernel = mxu_viol_s16x2_kernel<BI, BJ>;
  const size_t smem = 2 * static_cast<size_t>(BI + BJ) * PK_LDW * sizeof(uint32_t);
  if (int err = bloom::allow_smem(kernel, smem)) return err;
  const bool word_reads = m % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(cols) % 4 == 0;
  const dim3 grid((M + BJ - 1) / BJ, (N + BI - 1) / BI);
  kernel<<<grid, BI * BJ / (PAIR_RT * PAIR_CT), smem, stream>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint8_t*>(cols),
      static_cast<const int32_t*>(row_base), static_cast<const int32_t*>(col_base),
      static_cast<float*>(viol), N, M, m, lo, T, word_reads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matrix_mxu_viol(const void* rows, const void* cols, const void* row_base,
                               const void* col_base, void* viol, int N, int M, int m, int bi,
                               int bj, int lo, int T, void* stream) {
  if (N == 0 || M == 0) return 0;
  if (!bloom::pair_tiles_ok(bi, bj) || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (T > MXU_T_MAX)
    return launch_wide(rows, cols, row_base, col_base, viol, N, M, m, bi, bj, lo, T, s);
#define MXU_TILE(BI, BJ) \
  if (bi == BI && bj == BJ) return launch<BI, BJ>(rows, cols, row_base, col_base, viol, N, M, m, lo, T, s);
  MXU_TILE(32, 32) MXU_TILE(32, 64) MXU_TILE(32, 128) MXU_TILE(64, 32)
  MXU_TILE(64, 64) MXU_TILE(64, 128) MXU_TILE(128, 32) MXU_TILE(128, 64)
#undef MXU_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a CTA at a bi x bj tile for thresholds T: the
// 16-bit-lane kernel's two staged buffers, or the wide kernel's one
// (T > MXU_T_MAX); -1 for a tile no instance takes.
extern "C" int mxu_smem(int bi, int bj, int T) {
  if (!bloom::pair_tiles_ok(bi, bj) || T < 1) return -1;
  if (T > MXU_T_MAX) return static_cast<int>(bloom::pair_smem_bytes(bi, bj));
  return static_cast<int>(2 * static_cast<size_t>(bi + bj) * PK_LDW * sizeof(uint32_t));
}

// Registers, thread limit, static and dynamic shared memory and the CTAs
// an SM the runtime admits (common.cuh kernel_attrs) of the instance
// that takes a bi x bj tile at thresholds T, launched as launch() or
// launch_wide() starts it.
extern "C" int mxu_attrs(int bi, int bj, int T, int* out) {
  const int smem = mxu_smem(bi, bj, T);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (bi / PAIR_RT) * (bj / PAIR_CT);
  if (T > MXU_T_MAX) return bloom::kernel_attrs(mxu_viol_wide_kernel, threads, smem, out);
#define MXU_ATTRS(BI, BJ) \
  if (bi == BI && bj == BJ) return bloom::kernel_attrs(mxu_viol_s16x2_kernel<BI, BJ>, threads, smem, out);
  MXU_ATTRS(32, 32) MXU_ATTRS(32, 64) MXU_ATTRS(32, 128) MXU_ATTRS(64, 32)
  MXU_ATTRS(64, 64) MXU_ATTRS(64, 128) MXU_ATTRS(128, 32) MXU_ATTRS(128, 64)
#undef MXU_ATTRS
  return static_cast<int>(cudaErrorInvalidValue);
}
