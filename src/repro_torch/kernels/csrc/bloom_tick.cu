// Batched bloom-clock tick: cells[b, c] += #{p : probes[b, p] == c}.
//
// Replaces the TPU kernel repro/kernels/bloom_tick.py:bloom_tick_kernel
// (wrapper bloom_tick_pallas), which turns the scatter into a one-hot
// iota compare because the TPU has no fast scatter.
//
// Bound on this card: bytes.  Each cell is read once and written once
// (8 bytes for int32 cells) and each probe is read once per m-chunk;
// the operation count is one compare-and-add per probe.  Design: one
// CTA per (row, m-chunk).  Probes land in a shared-memory int32
// histogram of the chunk with shared-memory atomicAdd (an integer sum:
// exact in any order), then one coalesced read-add-write pass over the
// chunk's cells.  16-bit cells accumulate in int32 and are cast back,
// as the reference does.  Additions are unsigned so int32 wrap-around
// is defined.
#include "common.cuh"

template <typename T>
__global__ void bloom_tick_kernel(const T* __restrict__ cells,
                                  const int32_t* __restrict__ probes,
                                  T* __restrict__ out, int m, int P,
                                  int chunk, int n_chunks) {
  extern __shared__ int32_t hist[];
  const int row = blockIdx.x / n_chunks;
  const int col0 = (blockIdx.x % n_chunks) * chunk;
  const int width = min(chunk, m - col0);
  for (int c = threadIdx.x; c < width; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const int32_t* pr = probes + static_cast<size_t>(row) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int c = pr[p] - col0;
    if (c >= 0 && c < width) atomicAdd(&hist[c], 1);
  }
  __syncthreads();
  const size_t off = static_cast<size_t>(row) * m + col0;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(static_cast<int32_t>(cells[off + c])) +
                       static_cast<uint32_t>(hist[c]);
    out[off + c] = static_cast<T>(static_cast<int32_t>(v));
  }
}

template <typename T>
static int launch(const void* cells, const void* probes, void* out, int B,
                  int m, int P, int chunk, void* stream) {
  if (B == 0 || m == 0) return 0;
  const int n_chunks = (m + chunk - 1) / chunk;
  const int threads = 256;
  const size_t smem = static_cast<size_t>(chunk) * sizeof(int32_t);
  bloom_tick_kernel<T><<<static_cast<unsigned>(B) * n_chunks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cells), static_cast<const int32_t*>(probes),
      static_cast<T*>(out), m, P, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bloom_tick_i32(const void* cells, const void* probes, void* out,
                              int B, int m, int P, int chunk, void* stream) {
  return launch<int32_t>(cells, probes, out, B, m, P, chunk, stream);
}

extern "C" int bloom_tick_i16(const void* cells, const void* probes, void* out,
                              int B, int m, int P, int chunk, void* stream) {
  return launch<int16_t>(cells, probes, out, B, m, P, chunk, stream);
}
