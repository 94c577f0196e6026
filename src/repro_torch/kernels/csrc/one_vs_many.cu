// One query clock against N peer rows: per peer, le = all(p - q >= 0),
// ge = all(p - q <= 0), the sums Σq and Σp, and the Eq. 3 fp both ways.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_one_vs_many
// (body _one_vs_many_step, finalize _eq3_pair_finalize), in both of its
// named instances: generate.bloom_one_vs_many_packed_pallas (peers are
// u8 residuals plus an int32 base per row) and
// generate.bloom_one_vs_many_pallas (peers are int32 logical rows).
//
// Bound on this card: bytes.  Each peer cell is read once (1 byte packed,
// 4 bytes i32) for a few integer operations, and each row writes 24
// bytes of results.  Design: the query row sits in shared memory; one
// warp owns one peer row (bn warps per CTA) and reads it as 16-byte
// vectors, widening u8 residuals with the row base in registers.  A lane
// needs the VEC query values of its 16-byte chunk, so the query is stored
// chunk-transposed (element j of chunk c at j * stride + c, stride odd):
// at each j the lanes of a warp read consecutive words, free of bank
// conflicts, where a row-major query would put 16 lanes on one bank.  The
// difference p - q is taken unsigned and reinterpreted as int32, the
// wrap-subtraction of the reference without signed overflow.  Lanes at
// or beyond m never enter the computation.  Per bm-wide m-tile the
// int32 sums of p and q (wrapping) are warp-reduced and added as float
// in tile order, so the float32 sums are bit-identical to the reference;
// the flags are AND-reduced across the warp once at the end.
#include "common.cuh"

// Words between the rows of the chunk-transposed query: the chunk count,
// made odd so that the transposing stores are free of bank conflicts too.
__host__ __device__ inline int query_stride(int m, int vec) {
  return ((m + vec - 1) / vec) | 1;
}

template <typename T, bool PACKED>
__global__ void one_vs_many_kernel(const int32_t* __restrict__ q,
                                   const T* __restrict__ peers,
                                   const int32_t* __restrict__ base,
                                   int32_t* __restrict__ flags,
                                   float* __restrict__ sums,
                                   float* __restrict__ fp, int N, int m,
                                   int bm, float log_q, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ int32_t qs[];
  const int stride = query_stride(m, VEC);
  for (int i = threadIdx.x; i < m; i += blockDim.x) qs[(i % VEC) * stride + i / VEC] = q[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;  // warp-uniform: whole warps leave together
  const T* pr = peers + static_cast<size_t>(row) * m;
  const uint32_t b = PACKED ? static_cast<uint32_t>(base[row]) : 0u;
  int le = 1, ge = 1;
  float acc_q = 0.0f, acc_p = 0.0f;
  for (int t0 = 0; t0 < m; t0 += bm) {
    const int t1 = min(t0 + bm, m);
    uint32_t sp = 0, sq = 0;
    for (int c = t0 + lane * VEC; c < t1; c += 32 * VEC) {
      union {
        uint4 v;
        T e[VEC];
      } u;
      if (vec_ok && c + VEC <= t1) {
        u.v = *reinterpret_cast<const uint4*>(pr + c);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) u.e[j] = (c + j < t1) ? pr[c + j] : T(0);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (c + j < t1) {
          const uint32_t p = static_cast<uint32_t>(u.e[j]) + b;
          const uint32_t qq = static_cast<uint32_t>(qs[j * stride + c / VEC]);
          const int32_t d = static_cast<int32_t>(p - qq);
          le &= (d >= 0);
          ge &= (d <= 0);
          sp += p;
          sq += qq;
        }
      }
    }
    acc_q += bloom::tile_sum_f32(bloom::warp_sum_u32(sq));
    acc_p += bloom::tile_sum_f32(bloom::warp_sum_u32(sp));
  }
  le = __all_sync(0xffffffffu, le);
  ge = __all_sync(0xffffffffu, ge);
  if (lane == 0) {
    flags[2 * row] = le;
    flags[2 * row + 1] = ge;
    sums[2 * row] = acc_q;
    sums[2 * row + 1] = acc_p;
    fp[2 * row] = bloom::eq3_fp(acc_q, acc_p, log_q);
    fp[2 * row + 1] = bloom::eq3_fp(acc_p, acc_q, log_q);
  }
}

template <typename T, bool PACKED>
static int launch(const void* q, const void* peers, const void* base,
                  void* flags, void* sums, void* fp, int N, int m, int bn,
                  int bm, float log_q, int vec_ok, void* stream) {
  if (N == 0) return 0;
  auto kernel = one_vs_many_kernel<T, PACKED>;
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(VEC) * query_stride(m, VEC) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (N + bn - 1) / bn;
  kernel<<<blocks, 32 * bn, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const T*>(peers),
      static_cast<const int32_t*>(base), static_cast<int32_t*>(flags),
      static_cast<float*>(sums), static_cast<float*>(fp), N, m, bm, log_q,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int one_vs_many_packed(const void* q, const void* peers,
                                  const void* base, void* flags, void* sums,
                                  void* fp, int N, int m, int bn, int bm,
                                  float log_q, int vec_ok, void* stream) {
  return launch<uint8_t, true>(q, peers, base, flags, sums, fp, N, m, bn, bm,
                               log_q, vec_ok, stream);
}

extern "C" int one_vs_many_i32(const void* q, const void* peers, void* flags,
                               void* sums, void* fp, int N, int m, int bn,
                               int bm, float log_q, int vec_ok, void* stream) {
  return launch<int32_t, false>(q, peers, nullptr, flags, sums, fp, N, m, bn,
                                bm, log_q, vec_ok, stream);
}
