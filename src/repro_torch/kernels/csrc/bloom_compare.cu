// Fused receive path: per row, merged = max(a, b), le = all(a <= b),
// ge = all(a >= b), ΣA, ΣB and the Eq. 3 fp both ways, in one pass.
//
// Replaces the TPU kernel repro/kernels/bloom_compare.py:bloom_compare_kernel
// (wrapper bloom_merge_compare_pallas).  Like that kernel it compares
// directly (signed <=, >=, max), not by wrap-subtraction.
//
// Bound on this card: bytes.  Two int32 rows in, one int32 row out
// (12 bytes per cell) against a handful of integer operations per cell;
// at the receive path's B = 1 the launch itself.  The first port ran one
// 256-thread CTA a row with two block barriers per m-tile and one
// 4-byte load a thread in flight, and its wrapper added two .bool()
// kernels.  Design: one warp a row and no block barrier.  Where rows
// are 16-byte aligned (m a multiple of 4) a lane issues all its loads of
// up to 1024 cells (8 int4 of each row) before any arithmetic, stores
// the max as int4, and keeps its flags and the wrapped uint32 sums of
// the current m-tile; 128 consecutive cells (32 lanes x 4) never
// straddle a tile (bm is a multiple of 128), so a tile closes after a
// whole group and is reduced across the warp with __reduce_add_sync and
// added as float in tile order, which keeps the float32 sums
// bit-identical to the reference.  Other rows take the same walk one
// cell a lane.  Flags are AND-reduced with __all_sync; one lane runs
// Eq. 3 and writes the flags as a torch.bool pair: the wrapper's call is
// one launch.
#include "common.cuh"

namespace {

constexpr int MC_WARPS = 4;      // warps a CTA, one row each
constexpr int MC_GROUPS = 8;     // 128-cell groups a lane holds at once
constexpr uint32_t FULL = 0xffffffffu;

// The tile sums of one row: lanes add their cells of the open tile, and
// close() reduces them and adds the tile, as float, in order.
struct TileSums {
  uint32_t a = 0, b = 0;
  float acc_a = 0.0f, acc_b = 0.0f;
  int tile_end;
  __device__ __forceinline__ explicit TileSums(int bm, int m) : tile_end(min(bm, m)) {}
  // after the group of cells ending at `group_end`
  __device__ __forceinline__ void after(int group_end, int bm, int m) {
    if (group_end < tile_end) return;
    acc_a += bloom::tile_sum_f32(__reduce_add_sync(FULL, a));
    acc_b += bloom::tile_sum_f32(__reduce_add_sync(FULL, b));
    a = b = 0;
    tile_end = min(tile_end + bm, m);
  }
};

__device__ __forceinline__ int4 max4(const int4& x, const int4& y) {
  return make_int4(max(x.x, y.x), max(x.y, y.y), max(x.z, y.z), max(x.w, y.w));
}

__global__ void __launch_bounds__(MC_WARPS * 32)
merge_compare_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                     int32_t* __restrict__ merged, uint8_t* __restrict__ flags,
                     float* __restrict__ sums, float* __restrict__ fp, int B, int m,
                     int bm, float log_q, bool vec) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * MC_WARPS + threadIdx.x / 32;
  if (row >= B) return;  // warp-uniform
  const size_t off = static_cast<size_t>(row) * m;
  bool le = true, ge = true;
  TileSums ts(bm, m);
  if (vec) {
    const int4* a4 = reinterpret_cast<const int4*>(a + off);
    const int4* b4 = reinterpret_cast<const int4*>(b + off);
    int4* m4 = reinterpret_cast<int4*>(merged + off);
    const int nvec = m / 4;
    for (int v0 = 0; v0 < nvec; v0 += MC_GROUPS * 32) {
      int4 x[MC_GROUPS], y[MC_GROUPS];
#pragma unroll
      for (int g = 0; g < MC_GROUPS; ++g) {
        const int k = v0 + g * 32 + lane;
        if (k < nvec) {
          x[g] = __ldcs(a4 + k);
          y[g] = __ldcs(b4 + k);
        }
      }
#pragma unroll
      for (int g = 0; g < MC_GROUPS; ++g) {
        const int g0 = v0 + g * 32;
        if (g0 >= nvec) break;
        const int k = g0 + lane;
        if (k < nvec) {
          m4[k] = max4(x[g], y[g]);
          le &= x[g].x <= y[g].x && x[g].y <= y[g].y && x[g].z <= y[g].z && x[g].w <= y[g].w;
          ge &= x[g].x >= y[g].x && x[g].y >= y[g].y && x[g].z >= y[g].z && x[g].w >= y[g].w;
          ts.a += static_cast<uint32_t>(x[g].x) + static_cast<uint32_t>(x[g].y) +
                  static_cast<uint32_t>(x[g].z) + static_cast<uint32_t>(x[g].w);
          ts.b += static_cast<uint32_t>(y[g].x) + static_cast<uint32_t>(y[g].y) +
                  static_cast<uint32_t>(y[g].z) + static_cast<uint32_t>(y[g].w);
        }
        ts.after(4 * (g0 + 32), bm, m);
      }
    }
  } else {
    for (int c0 = 0; c0 < m; c0 += 32) {
      const int c = c0 + lane;
      if (c < m) {
        const int32_t x = a[off + c], y = b[off + c];
        merged[off + c] = max(x, y);
        le &= x <= y;
        ge &= x >= y;
        ts.a += static_cast<uint32_t>(x);
        ts.b += static_cast<uint32_t>(y);
      }
      ts.after(c0 + 32, bm, m);
    }
  }
  le = __all_sync(FULL, le);
  ge = __all_sync(FULL, ge);
  if (lane == 0) {
    reinterpret_cast<uint16_t*>(flags)[row] =
        static_cast<uint16_t>(le) | static_cast<uint16_t>(ge) << 8;
    reinterpret_cast<float2*>(sums)[row] = make_float2(ts.acc_a, ts.acc_b);
    reinterpret_cast<float2*>(fp)[row] = make_float2(bloom::eq3_fp(ts.acc_a, ts.acc_b, log_q),
                                                     bloom::eq3_fp(ts.acc_b, ts.acc_a, log_q));
  }
}

}  // namespace

extern "C" int bloom_merge_compare(const void* a, const void* b, void* merged,
                                   void* flags, void* sums, void* fp, int B,
                                   int m, int bm, float log_q, void* stream) {
  if (bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(merged) % 16 == 0;
  merge_compare_kernel<<<(B + MC_WARPS - 1) / MC_WARPS, MC_WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(merged), static_cast<uint8_t*>(flags),
      static_cast<float*>(sums), static_cast<float*>(fp), B, m, bm, log_q, vec);
  return static_cast<int>(cudaGetLastError());
}
