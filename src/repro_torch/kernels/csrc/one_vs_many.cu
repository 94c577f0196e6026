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

// Stage the query row into shared memory, chunk-transposed (see above).
template <int VEC>
__device__ __forceinline__ void stage_query(int32_t* __restrict__ qs,
                                            const int32_t* __restrict__ q,
                                            int m) {
  const int stride = query_stride(m, VEC);
  for (int i = threadIdx.x; i < m; i += blockDim.x) qs[(i % VEC) * stride + i / VEC] = q[i];
  __syncthreads();
}

// One peer row against the staged query, by one whole warp: writes
// flags, sums and fp of output row `out`.  The packed one-vs-many kernel
// and the tail rows of the hybrid kernel both run this body.
template <typename T, bool PACKED>
__device__ __forceinline__ void one_vs_many_row(
    const int32_t* __restrict__ qs, const T* __restrict__ peers,
    const int32_t* __restrict__ base, int row, int out,
    int32_t* __restrict__ flags, float* __restrict__ sums,
    float* __restrict__ fp, int m, int bm, float log_q, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int stride = query_stride(m, VEC);
  const int lane = threadIdx.x % 32;
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
    flags[2 * out] = le;
    flags[2 * out + 1] = ge;
    sums[2 * out] = acc_q;
    sums[2 * out + 1] = acc_p;
    fp[2 * out] = bloom::eq3_fp(acc_q, acc_p, log_q);
    fp[2 * out + 1] = bloom::eq3_fp(acc_p, acc_q, log_q);
  }
}

template <typename T, bool PACKED>
__global__ void one_vs_many_kernel(const int32_t* __restrict__ q,
                                   const T* __restrict__ peers,
                                   const int32_t* __restrict__ base,
                                   int32_t* __restrict__ flags,
                                   float* __restrict__ sums,
                                   float* __restrict__ fp, int N, int m,
                                   int bm, float log_q, int vec_ok) {
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  extern __shared__ int32_t qs[];
  stage_query<VEC>(qs, q, m);
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= N) return;  // warp-uniform: whole warps leave together
  one_vs_many_row<T, PACKED>(qs, peers, base, row, row, flags, sums, fp, m,
                             bm, log_q, vec_ok);
}

// The hybrid sweep (replaces repro/kernels/template.py:_emit_hybrid): one
// query against H exact hot rows and T packed tail rows, outputs stacked
// hot first.  The grid is ceil(H / bn) hot blocks followed by ceil(T / bn)
// tail blocks, one warp per row; the branch is per block.  Tail blocks
// run the packed one-vs-many body above unchanged, so tail flags, sums and
// fp are bit-identical to one_vs_many_packed at the same bm.  Hot blocks
// read no tail bytes (the Pallas version fetches clamped tail tiles and
// discards them): a hot row is its chain coordinates (v, n_private)
// against the local chain version V, le = V <= v and ge = v <= V with no
// private events, fp = 0; sums = (Σq, the row's precomputed sum), Σq
// taken per bm tile exactly as the tail rows take it, since callers read
// sum_q off row 0.  Bound on this card: bytes, those of the tail.
__global__ void hybrid_kernel(const int32_t* __restrict__ q, int V,
                              const int32_t* __restrict__ hot_meta,
                              const float* __restrict__ hot_sums,
                              const uint8_t* __restrict__ tail,
                              const int32_t* __restrict__ tail_base,
                              int32_t* __restrict__ flags,
                              float* __restrict__ sums,
                              float* __restrict__ fp, int H, int T, int m,
                              int bm, float log_q, int vec_ok) {
  constexpr int VEC = 16;
  extern __shared__ int32_t qs[];
  stage_query<VEC>(qs, q, m);
  const int rows = blockDim.x / 32;
  const int hot_blocks = (H + rows - 1) / rows;
  const int lane = threadIdx.x % 32;
  if (static_cast<int>(blockIdx.x) >= hot_blocks) {
    const int row = (blockIdx.x - hot_blocks) * rows + threadIdx.x / 32;
    if (row >= T) return;
    one_vs_many_row<uint8_t, true>(qs, tail, tail_base, row, H + row, flags,
                                   sums, fp, m, bm, log_q, vec_ok);
    return;
  }
  const int row = blockIdx.x * rows + threadIdx.x / 32;
  if (row >= H) return;
  const int stride = query_stride(m, VEC);
  float acc_q = 0.0f;
  for (int t0 = 0; t0 < m; t0 += bm) {
    const int t1 = min(t0 + bm, m);
    uint32_t sq = 0;
    for (int i = t0 + lane; i < t1; i += 32)
      sq += static_cast<uint32_t>(qs[(i % VEC) * stride + i / VEC]);
    acc_q += bloom::tile_sum_f32(bloom::warp_sum_u32(sq));
  }
  if (lane == 0) {
    const int v = hot_meta[2 * row], n_private = hot_meta[2 * row + 1];
    flags[2 * row] = V <= v;
    flags[2 * row + 1] = (v <= V) && (n_private == 0);
    sums[2 * row] = acc_q;
    sums[2 * row + 1] = hot_sums[row];
    fp[2 * row] = 0.0f;
    fp[2 * row + 1] = 0.0f;
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

extern "C" int hybrid_classify(const void* q, int V, const void* hot_meta,
                               const void* hot_sums, const void* tail,
                               const void* tail_base, void* flags, void* sums,
                               void* fp, int H, int T, int m, int bn, int bm,
                               float log_q, int vec_ok, void* stream) {
  if (H <= 0 || T <= 0 || bn < 1 || bn > 32) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(16) * query_stride(m, 16) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hybrid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (H + bn - 1) / bn + (T + bn - 1) / bn;
  hybrid_kernel<<<blocks, 32 * bn, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), V, static_cast<const int32_t*>(hot_meta),
      static_cast<const float*>(hot_sums), static_cast<const uint8_t*>(tail),
      static_cast<const int32_t*>(tail_base), static_cast<int32_t*>(flags),
      static_cast<float*>(sums), static_cast<float*>(fp), H, T, m, bm, log_q,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}
