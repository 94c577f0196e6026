// Batched bloom-clock tick: out[b, c] = cells[b, c] + #{p : probes[b, p] == c}.
//
// Replaces the TPU kernel repro/kernels/bloom_tick.py:bloom_tick_kernel
// (wrapper bloom_tick_pallas), which turns the scatter into a one-hot
// iota compare because the TPU has no fast scatter.
//
// Bound on this card: bytes.  Each cell is read once and written once
// (8 bytes for int32 cells) and each probe is read once; the operation
// count is one compare-and-add per probe.  The output is a new tensor,
// as in the reference, so every cell moves, touched or not.  Design: one
// warp per row, over a grid-stride grid of 8-warp CTAs sized to the SM
// count.  A warp takes its row in chunks of TICK_CHUNK cells (one chunk
// at m <= 1024).  It first issues the chunk's cell loads into registers,
// as 16-byte vectors (8 a lane for int32 cells, 4 for int16) where rows
// are 16-byte aligned and as scalars where they are not; only then does
// it build the chunk's increments in its own slice of shared memory
// (zero, one shared atomicAdd per probe, __syncwarp), so HBM latency
// overlaps the histogram.  It adds the increments in registers and
// stores the same way.  16-bit cells accumulate with wrap-around in
// their 16 bits, which is the reference's int32 sum cast back.
// Additions are unsigned so int32 wrap-around is defined.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TICK_WARPS = 8;                    // warps a CTA, one row each
constexpr int TICK_CTAS_PER_SM = 2;              // resident CTAs the grid asks for
constexpr int TICK_CHUNK = 1024;                 // cells a warp holds at once
constexpr int TICK_PER_LANE = TICK_CHUNK / 32;   // cells a lane holds at once

template <typename T>
struct TickVec {
  static constexpr int CELLS = 16 / sizeof(T);            // cells a uint4
  static constexpr int N = TICK_PER_LANE / CELLS;         // uint4 a lane
};

// Counts h[0..4) added to four int32 cells, or h[0..8) to eight int16.
__device__ __forceinline__ void add_counts(uint4& v, const int32_t* h, int32_t) {
  const int4 c = *reinterpret_cast<const int4*>(h);
  v.x += static_cast<uint32_t>(c.x);
  v.y += static_cast<uint32_t>(c.y);
  v.z += static_cast<uint32_t>(c.z);
  v.w += static_cast<uint32_t>(c.w);
}

__device__ __forceinline__ uint32_t pack_halves(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void add_counts(uint4& v, const int32_t* h, int16_t) {
  const int4 c0 = *reinterpret_cast<const int4*>(h);
  const int4 c1 = *reinterpret_cast<const int4*>(h + 4);
  v.x = __vadd2(v.x, pack_halves(c0.x, c0.y));
  v.y = __vadd2(v.y, pack_halves(c0.z, c0.w));
  v.z = __vadd2(v.z, pack_halves(c1.x, c1.y));
  v.w = __vadd2(v.w, pack_halves(c1.z, c1.w));
}

// The increments of cells [c0, c0 + width) of one row in the warp's
// slice h: zeroed, then one shared atomicAdd per probe that lands there.
__device__ __forceinline__ void warp_histogram(int32_t* __restrict__ h,
                                               const int32_t* __restrict__ pr,
                                               int P, int c0, int width, int lane) {
  __syncwarp();  // the slice's previous chunk has been read by every lane
#pragma unroll
  for (int j = 0; j < TICK_CHUNK / 4 / 32; ++j)
    reinterpret_cast<int4*>(h)[j * 32 + lane] = make_int4(0, 0, 0, 0);
  __syncwarp();
  for (int p = lane; p < P; p += 32) {
    const int c = pr[p] - c0;
    if (c >= 0 && c < width) atomicAdd(&h[c], 1);
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(TICK_WARPS * 32)
bloom_tick_kernel(const T* __restrict__ cells, const int32_t* __restrict__ probes,
                  T* __restrict__ out, int B, int m, int P, bool vec) {
  using V = TickVec<T>;
  __shared__ __align__(16) int32_t hist[TICK_WARPS * TICK_CHUNK];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int32_t* h = hist + warp * TICK_CHUNK;
  for (int row = blockIdx.x * TICK_WARPS + warp; row < B; row += gridDim.x * TICK_WARPS) {
    const size_t off = static_cast<size_t>(row) * m;
    const int32_t* pr = probes + static_cast<size_t>(row) * P;
    for (int c0 = 0; c0 < m; c0 += TICK_CHUNK) {
      const int width = min(TICK_CHUNK, m - c0);
      if (vec) {
        // 16-byte vectors: lane takes vectors j * 32 + lane of the chunk
        const uint4* src = reinterpret_cast<const uint4*>(cells + off + c0);
        uint4* dst = reinterpret_cast<uint4*>(out + off + c0);
        const int nvec = width / V::CELLS;
        uint4 v[V::N];
#pragma unroll
        for (int j = 0; j < V::N; ++j)
          if (j * 32 + lane < nvec) v[j] = __ldcs(src + j * 32 + lane);
        warp_histogram(h, pr, P, c0, width, lane);
#pragma unroll
        for (int j = 0; j < V::N; ++j) {
          const int i = j * 32 + lane;
          if (i < nvec) {
            add_counts(v[j], h + i * V::CELLS, T{});
            dst[i] = v[j];
          }
        }
      } else {
        // scalar: lane takes cells j * 32 + lane of the chunk
        uint32_t s[TICK_PER_LANE];
#pragma unroll
        for (int j = 0; j < TICK_PER_LANE; ++j)
          if (j * 32 + lane < width)
            s[j] = static_cast<uint32_t>(static_cast<int32_t>(__ldcs(cells + off + c0 + j * 32 + lane)));
        warp_histogram(h, pr, P, c0, width, lane);
#pragma unroll
        for (int j = 0; j < TICK_PER_LANE; ++j) {
          const int c = j * 32 + lane;
          if (c < width)
            out[off + c0 + c] = static_cast<T>(static_cast<int32_t>(s[j] + static_cast<uint32_t>(h[c])));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* cells, const void* probes, void* out, int B, int m, int P,
           void* stream) {
  if (B == 0 || m == 0) return 0;
  const bool vec = (m * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cells) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int ctas = std::min((B + TICK_WARPS - 1) / TICK_WARPS, bloom::sm_count() * TICK_CTAS_PER_SM);
  bloom_tick_kernel<T><<<ctas, TICK_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cells), static_cast<const int32_t*>(probes),
      static_cast<T*>(out), B, m, P, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bloom_tick_i32(const void* cells, const void* probes, void* out,
                              int B, int m, int P, void* stream) {
  return launch<int32_t>(cells, probes, out, B, m, P, stream);
}

extern "C" int bloom_tick_i16(const void* cells, const void* probes, void* out,
                              int B, int m, int P, void* stream) {
  return launch<int16_t>(cells, probes, out, B, m, P, stream);
}
