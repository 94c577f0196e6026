// Shared device helpers for the bloom-clock kernels.
#pragma once
#include <climits>
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

// ---------------------------------------------------------------------------
// All-pairs tiles (bloom_matrix.cu, bloom_mxu.cu)
//
// One CTA owns a tile of bi x bj pairs (bi, bj in {32, 64, 128}, at most
// PAIR_MAX_PAIRS pairs); each of its (bi / 4) * (bj / 4) threads owns
// 4 x 4 pairs: rows ty + r * bi/4 and cols tx + c * bj/4.  The m lanes stream through shared memory in
// chunks of PAIR_KC, both row tiles stored row-major as 32-bit words with
// PAIR_LDK words per row: 16-byte reads of 4 lanes at a time, and since
// PAIR_LDK is 4 words past a multiple of 32, the 8 threads of a quarter
// warp that read 8 consecutive rows hit 8 disjoint bank groups.
// ---------------------------------------------------------------------------

constexpr int PAIR_KC = 64;             // m lanes per staged chunk
constexpr int PAIR_LDK = PAIR_KC + 4;   // words per staged row
constexpr int PAIR_RT = 4;              // pairs per thread along rows
constexpr int PAIR_CT = 4;              // pairs per thread along cols

// Pairs a tile may hold: (bi / 4) * (bj / 4) = 512 threads at ~75
// registers each fit the SM's 65,536 registers; 1024 threads do not.
constexpr int PAIR_MAX_PAIRS = 128 * 64;

__host__ __device__ inline bool pair_edge_ok(int b) {
  return b == 32 || b == 64 || b == 128;
}

__host__ __device__ inline bool pair_tiles_ok(int bi, int bj) {
  return pair_edge_ok(bi) && pair_edge_ok(bj) && bi * bj <= PAIR_MAX_PAIRS;
}

// Shared memory for two staged row tiles.
__host__ __device__ inline size_t pair_smem_bytes(int bi, int bj) {
  return static_cast<size_t>(bi + bj) * PAIR_LDK * sizeof(uint32_t);
}

// Raise a kernel's dynamic shared memory limit where it needs more than
// the default 48 KiB.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// What the autotuner's occupancy model (kernels/template.py) is held to,
// for one kernel instance launched with `threads` threads and `smem`
// bytes of dynamic shared memory: out[0] registers a thread, out[1] the
// most threads a CTA may take, out[2] static shared memory, out[3] the
// CTAs an SM the runtime admits, out[4] threads, out[5] dynamic shared
// memory.
template <typename K>
int kernel_attrs(K kernel, int threads, size_t smem, int* out) {
  if (int err = allow_smem(kernel, smem)) return err;
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, kernel)) return static_cast<int>(err);
  int ctas = 0;
  if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem))
    return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = a.maxThreadsPerBlock;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = ctas;
  out[4] = threads;
  out[5] = static_cast<int>(smem);
  return 0;
}

// Stage lanes [k0, k0 + kc) of rows [r0, r0 + tile_rows) into s as 32-bit
// words, each passed through f(row, value).  Consecutive threads take
// consecutive lanes of one row: coalesced loads, conflict-free stores.
// Rows past n_rows and lanes past kc are stored as 0 and never compared.
template <typename T, class F>
__device__ __forceinline__ void stage_rows(uint32_t* __restrict__ s,
                                           const T* __restrict__ src,
                                           int n_rows, int r0, int tile_rows,
                                           int m, int k0, int kc, const F& f) {
  for (int idx = threadIdx.x; idx < tile_rows * PAIR_KC; idx += blockDim.x) {
    const int r = idx / PAIR_KC, k = idx % PAIR_KC, row = r0 + r;
    uint32_t v = 0;
    if (row < n_rows && k < kc)
      v = f(row, static_cast<uint32_t>(src[static_cast<size_t>(row) * m + k0 + k]));
    s[r * PAIR_LDK + k] = v;
  }
}

// One staged chunk through a thread's 4 x 4 pairs: acc(r, c, a, b) for
// every lane, four lanes per 16-byte read.
template <class Acc>
__device__ __forceinline__ void sweep_chunk(const uint32_t* __restrict__ As,
                                            const uint32_t* __restrict__ Bs,
                                            int kc, int ty, int tx, int rstep,
                                            int cstep, Acc& acc) {
  int k = 0;
  for (; k + 4 <= kc; k += 4) {
    uint4 a[PAIR_RT], b[PAIR_CT];
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r)
      a[r] = *reinterpret_cast<const uint4*>(As + (ty + r * rstep) * PAIR_LDK + k);
#pragma unroll
    for (int c = 0; c < PAIR_CT; ++c)
      b[c] = *reinterpret_cast<const uint4*>(Bs + (tx + c * cstep) * PAIR_LDK + k);
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c) {
        acc(r, c, a[r].x, b[c].x);
        acc(r, c, a[r].y, b[c].y);
        acc(r, c, a[r].z, b[c].z);
        acc(r, c, a[r].w, b[c].w);
      }
    }
  }
  for (; k < kc; ++k) {
#pragma unroll
    for (int r = 0; r < PAIR_RT; ++r) {
#pragma unroll
      for (int c = 0; c < PAIR_CT; ++c)
        acc(r, c, As[(ty + r * rstep) * PAIR_LDK + k], Bs[(tx + c * cstep) * PAIR_LDK + k]);
    }
  }
}

// ---------------------------------------------------------------------------
// All-pairs tiles on packed 16-bit lanes (bloom_mxu.cu)
//
// The tile and thread layout above (4 x 4 pairs a thread), with two m
// lanes a 32-bit word as signed 16-bit halves (s16x2), so that one DPX
// instruction takes two lanes.  A staged chunk is PK_LANES lanes:
// PK_WORDS words a row, rows PK_LDW words apart (4 past a multiple of
// 32: the 8 threads of a quarter warp that read 8 consecutive rows with
// 16-byte loads hit 8 disjoint bank groups, as above).  Staging reads 4
// u8 lanes a thread from global memory and turns them into two words.
// ---------------------------------------------------------------------------

constexpr int PK_LANES = 64;              // m lanes per staged chunk
constexpr int PK_WORDS = PK_LANES / 2;    // s16x2 words per staged row
constexpr int PK_LDW = PK_WORDS + 4;      // words between staged rows
constexpr int PK_QUADS = PK_LANES / 4;    // 4-byte reads per row and chunk

__device__ __forceinline__ uint32_t pk_splat(int v) {
  return (static_cast<uint32_t>(v) & 0xFFFFu) * 0x10001u;
}

// The offset d = base - lo (int32 wrap) of lanes u8 + d that are then
// clamped into [lo_clamp, hi] (lo_clamp >= -1, hi + 255 < 2^15), packed
// into both halves.  d is cut to [-257, hi], which changes no clamped value
// (u8 is in [0, 255]) and makes u8 + d fit 16 bits, except where
// u8 + d wraps in int32 (d > INT_MAX - 256): there d moves to the top
// of the 16-bit range by the same distance from it, so u8 + d wraps in
// 16 bits at the same u8 and the clamps give what they gave in 32 bits.
__device__ __forceinline__ uint32_t pk_offset(int32_t base, int32_t lo, int hi) {
  int d = static_cast<int>(static_cast<uint32_t>(base) - static_cast<uint32_t>(lo));
  d = d > INT_MAX - 256 ? d - INT_MAX + SHRT_MAX : min(max(d, -257), hi);
  return pk_splat(d);
}

// Four u8 lanes (a little-endian word) -> two s16x2 words of
// clamp(u8 + d, lo, hi), negated when NEG; lanes at or past nv are 0.
template <bool NEG>
__device__ __forceinline__ uint2 pk_quad(uint32_t x, uint32_t d2, uint32_t lo2,
                                         uint32_t hi2, int nv) {
  uint32_t w0 = __vadd2(__byte_perm(x, 0, 0x4140), d2);   // lanes 0, 1
  uint32_t w1 = __vadd2(__byte_perm(x, 0, 0x4342), d2);   // lanes 2, 3
  w0 = __vmins2(__vmaxs2(w0, lo2), hi2);
  w1 = __vmins2(__vmaxs2(w1, lo2), hi2);
  if (NEG) {
    w0 = __vneg2(w0);
    w1 = __vneg2(w1);
  }
  if (nv < 4) {
    w0 &= (nv > 0 ? 0xFFFFu : 0u) | (nv > 1 ? 0xFFFF0000u : 0u);
    w1 &= nv > 2 ? 0xFFFFu : 0u;
  }
  return make_uint2(w0, w1);
}

// The first nv of the four u8 lanes at p as a little-endian word, 0
// past them: one 4-byte read where rows are 4-byte aligned (nv is then
// 0 or 4), else byte reads.
__device__ __forceinline__ uint32_t pk_read(const uint8_t* __restrict__ p, int nv,
                                            bool word_reads) {
  if (nv <= 0) return 0;
  if (word_reads) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nv) x |= static_cast<uint32_t>(p[j]) << (8 * j);
  return x;
}

// Four u8 lanes x (a little-endian word) of which the first nv are
// lanes of the row, the rest replaced by the row's last lane: a lane
// equal to the last one moves no max or min of a lane-wise difference.
__device__ __forceinline__ uint32_t pk_pad_last(uint32_t x, int nv, uint8_t last) {
  const uint32_t keep = nv >= 4 ? 0xFFFFFFFFu : nv > 0 ? 0xFFFFFFFFu >> (32 - 8 * nv) : 0u;
  return (x & keep) | (static_cast<uint32_t>(last) * 0x01010101u & ~keep);
}

// Four u8 lanes -> two words of unsigned 16-bit lanes, a0 | a1 << 16.
__device__ __forceinline__ uint2 pk_u16x2(uint32_t x) {
  return make_uint2(__byte_perm(x, 0, 0x4140), __byte_perm(x, 0, 0x4342));
}

// The same lanes biased as 256 - b, in [1, 256]: a word of pk_u16x2 rows
// plus one of these is a - b + 256 in [1, 511] in both halves, one
// 32-bit add with no carry between them.
__device__ __forceinline__ uint2 pk_u16x2_neg256(uint32_t x) {
  const uint2 w = pk_u16x2(x);
  return make_uint2(0x01000100u - w.x, 0x01000100u - w.y);
}

// a - b (wrapping) as one IMAD, b * neg1 + a, where the caller holds
// neg1 = 0xFFFFFFFF in a value the compiler cannot see (a kernel
// argument): written as a subtraction, ptxas puts a share of them on the
// integer ALU pipe as IADD3, beside the min/max instructions there.
__device__ __forceinline__ uint32_t sub_imad(uint32_t a, uint32_t b, uint32_t neg1) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(b), "r"(neg1), "r"(a));
  return d;
}

// ---------------------------------------------------------------------------
// Asynchronous global -> shared copies (cp.async)
// ---------------------------------------------------------------------------

// Copy `bytes` (0 or 16) from src to dst, zero-filling the rest of 16;
// both 16-byte aligned, src a valid address even when bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

// The same for 4 bytes (0 or 4), both 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every copy this thread has committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Grid sizing
// ---------------------------------------------------------------------------

// SMs of the current device (132 on an H100 SXM), read once per device.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace bloom
