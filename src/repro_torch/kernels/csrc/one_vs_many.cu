// One query clock against N peer rows: per peer, le = all(p - q >= 0),
// ge = all(p - q <= 0), the sums Σq and Σp, and the Eq. 3 fp both ways;
// and the hybrid sweep, the same rows behind a block of exact hot rows.
//
// Replaces the TPU kernel repro/kernels/template.py:_emit_one_vs_many
// (body _one_vs_many_step, finalize _eq3_pair_finalize), in both of its
// named instances: generate.bloom_one_vs_many_packed_pallas (peers are
// u8 residuals plus an int32 base per row) and
// generate.bloom_one_vs_many_pallas (peers are int32 logical rows); and
// repro/kernels/template.py:_emit_hybrid (the fused hot + tail sweep).
//
// Bound on this card: bytes.  Each peer cell is read once (1 byte packed,
// 4 bytes i32), and each row writes 2 bytes of flags and 16 of sums and
// fp.  The first port spent ~30 instructions a packed cell (per-cell
// bounds checks, a shared load of the query a cell, two running sums)
// with one 16-byte load a lane in flight, and re-staged the query in
// every 8-row CTA: it ran at 4.6x the byte bound.  Design:
//
// - Fewer instructions a cell.  A lane keeps the running min and max of
//   the wrapped d = p - q over its chunks (ovm_chunk): a byte extract,
//   one three-input add (u8 + base - q) and half a three-input min and
//   max (__vimin3_s32 / __vimax3_s32) a cell; both start at 0, which
//   moves neither test, and a cell past m enters as d = 0 (a zero
//   residual beside the row's base would not be neutral).  A second,
//   16-bit-lane body (min and max of u8 + (qmax - q), free of the base,
//   for queries whose span fits 16 bits) took the packed call at N =
//   65,536, m = 1024 from 0.0355 to 0.0300 ms on an H100, a change no
//   path shows end to end; one body serves every row instead.
//   Σp of an m-tile is Σu8 + n·base (mod 2^32, n the tile's cells): Σu8
//   takes one __dp4a per 4 cells, on the other pipe.  Σq is the query's,
//   the same for every row: each warp takes it once.  The tile sums are
//   warp-reduced (__reduce_add_sync) and added as float in tile order,
//   so the float32 sums stay bit-identical to the reference.
// - Bytes in flight.  A grid-stride grid of CTAs (OVM_WARPS_PER_SM warps
//   an SM) stages the query once per CTA in shared memory, laid out so
//   that a lane's query values for a chunk are conflict-free 16-byte
//   loads.  Each warp walks batches of up to 32 consecutive rows as one
//   stream of stages (OVM_CPL 16-byte chunks a lane), OVM_DEPTH stages
//   ahead through a per-warp cp.async ring; a lane reads back only what
//   it copied, so the ring needs no barrier.  Rows that are not 16-byte
//   aligned or m not a multiple of the chunk take scalar loads instead.
// - Finalize.  Lane i keeps row i's Σp and flags; at the end of a batch
//   every lane runs Eq. 3 both ways for its row and the stores are
//   coalesced (flags as one 2-byte bool pair, sums and fp as float2).
//   The kernels write the flags as torch.bool bytes: the wrapper's call
//   is one launch.
//
// The hybrid kernel runs the same tail stream, so its tail rows are
// bit-identical to one_vs_many_packed; its hot rows (exact chain
// coordinates (v, n_private) against the local chain version V) take
// one lane each: le = V <= v, ge = v <= V with no private events, fp =
// 0, sums = (Σq, the row's precomputed sum).  Hot rows read no tail
// bytes.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int OVM_CPL = 2;          // 16-byte chunks a lane takes a stage
constexpr int OVM_DEPTH = 2;        // stages a warp keeps in flight
constexpr int OVM_BATCH_MAX = 32;   // rows a warp finalizes together, one a lane
constexpr int OVM_WARPS_PER_SM = 32;
constexpr uint32_t FULL = 0xffffffffu;

template <typename T>
struct Ovm {
  static constexpr int VEC = 16 / sizeof(T);   // cells a 16-byte chunk
  static constexpr int STAGE = 32 * VEC * OVM_CPL;  // cells a warp-wide stage
};

// Shared memory of one CTA: the query, chunk-major in int4 words (word
// g of chunk k at g * n_chunks + k), then each warp's ring.
__host__ __device__ inline int ovm_chunks(int m, int vec) { return (m + vec - 1) / vec; }

__host__ __device__ inline size_t ovm_smem(int m, int vec, int warps) {
  return static_cast<size_t>(ovm_chunks(m, vec)) * vec * sizeof(int32_t) +
         static_cast<size_t>(warps) * OVM_DEPTH * OVM_CPL * 32 * 16;
}

// One 16-byte chunk of a row against the query: the running min and max
// of d = p - q over its first `nv` cells (d = 0 past them: MASKED, where
// nv < VEC) and the sum of its raw values (u8 residuals or int32 cells;
// zeros past nv).
template <bool MASKED>
__device__ __forceinline__ void ovm_chunk(const uint4& v, const int4* __restrict__ qw,
                                          int n_chunks, uint32_t base, int nv,
                                          int32_t& lo, int32_t& hi, uint32_t& sum, uint8_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int4 q = qw[g * n_chunks];
    const int32_t qq[4] = {q.x, q.y, q.z, q.w};
    int32_t d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t p = __byte_perm(w[g], 0, 0x4440 + e) + base;
      d[e] = static_cast<int32_t>(p - static_cast<uint32_t>(qq[e]));
      if (MASKED && 4 * g + e >= nv) d[e] = 0;
    }
    lo = __vimin3_s32(lo, d[0], d[1]);
    lo = __vimin3_s32(lo, d[2], d[3]);
    hi = __vimax3_s32(hi, d[0], d[1]);
    hi = __vimax3_s32(hi, d[2], d[3]);
    sum = __dp4a(w[g], 0x01010101u, sum);
  }
}

template <bool MASKED>
__device__ __forceinline__ void ovm_chunk(const uint4& v, const int4* __restrict__ qw, int,
                                          uint32_t, int nv, int32_t& lo, int32_t& hi,
                                          uint32_t& sum, int32_t) {
  const int4 q = qw[0];
  const uint32_t p[4] = {v.x, v.y, v.z, v.w};
  const int32_t qq[4] = {q.x, q.y, q.z, q.w};
  int32_t d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] = static_cast<int32_t>(p[e] - static_cast<uint32_t>(qq[e]));
    if (MASKED && e >= nv) d[e] = 0;
  }
  lo = __vimin3_s32(lo, d[0], d[1]);
  lo = __vimin3_s32(lo, d[2], d[3]);
  hi = __vimax3_s32(hi, d[0], d[1]);
  hi = __vimax3_s32(hi, d[2], d[3]);
  sum += p[0] + p[1] + p[2] + p[3];
}

// The first nv cells of the chunk at p by scalar loads, zeros past them.
template <typename T>
__device__ __forceinline__ uint4 load_scalar(const T* __restrict__ p, int nv) {
  union {
    uint4 v;
    T e[Ovm<T>::VEC];
  } u;
#pragma unroll
  for (int j = 0; j < Ovm<T>::VEC; ++j) u.e[j] = j < nv ? p[j] : T(0);
  return u.v;
}

// A warp's place in its stream of tail stages: batch tb of up to `rb`
// rows (nr of them), row i of the batch and its first byte `row`, stage s
// of the row.
struct Cursor {
  int tb, nr, i, s;
  const char* row;
  __device__ __forceinline__ void start(int b, int rb, int n, const char* src,
                                        size_t row_bytes) {
    tb = b;
    nr = min(rb, n - b * rb);
    i = 0;
    s = 0;
    row = src + static_cast<size_t>(b) * rb * row_bytes;
  }
  __device__ __forceinline__ void next(int spr, int warps, int rb, int n, const char* src,
                                       size_t row_bytes) {
    if (++s < spr) return;
    s = 0;
    row += row_bytes;
    if (++i < nr) return;
    start(tb + warps, rb, n, src, row_bytes);
  }
};

// The copy side of a warp's tail stream: `in` is the next stage to copy
// into the cp.async ring.
template <typename T>
struct Feed {
  Cursor in;
  const char* src0;
  size_t row_bytes;
  int N, rb, warps, n_batches, n_chunks, spr;
  uint4* ring;  // this lane's slot 0
  __device__ __forceinline__ Feed(const T* peers, int N_, int m, int rb_, int warps_, int gw,
                                  uint4* ring_)
      : src0(reinterpret_cast<const char*>(peers)),
        row_bytes(static_cast<size_t>(m) * sizeof(T)),
        N(N_),
        rb(rb_),
        warps(warps_),
        n_batches((N_ + rb_ - 1) / rb_),
        n_chunks(ovm_chunks(m, Ovm<T>::VEC)),
        spr((m + Ovm<T>::STAGE - 1) / Ovm<T>::STAGE),
        ring(ring_) {
    in.start(gw, rb, N, src0, row_bytes);
  }
  // copy stage `in` into ring slot `slot` (one commit group), step `in`
  __device__ __forceinline__ void issue(unsigned slot) {
    const int lane = threadIdx.x % 32;
    if (in.tb < n_batches) {
#pragma unroll
      for (int j = 0; j < OVM_CPL; ++j) {
        const int k = (in.s * OVM_CPL + j) * 32 + lane;
        if (k < n_chunks) bloom::cp_async16(ring + (slot * OVM_CPL + j) * 32, in.row + k * 16, 16);
      }
    }
    bloom::cp_async_commit();
    in.next(spr, warps, rb, N, src0, row_bytes);
  }
};

// The query into shared memory (chunk-major int4 words, zeros past m).
template <typename T>
__device__ __forceinline__ void stage_query(int32_t* __restrict__ qs,
                                            const int32_t* __restrict__ q, int m) {
  constexpr int VEC = Ovm<T>::VEC;
  const int n_chunks = ovm_chunks(m, VEC);
#pragma unroll 4
  for (int c = threadIdx.x; c < n_chunks * VEC; c += blockDim.x) {
    const int k = c / VEC, g = (c % VEC) / 4, e = c % 4;
    qs[(g * n_chunks + k) * 4 + e] = c < m ? q[c] : 0;
  }
  __syncthreads();
}

// Σq of the staged query per bm-wide tile, added as float in tile order
// (a chunk never straddles a tile: bm is a multiple of 128 cells).
template <typename T>
__device__ __forceinline__ float query_sum(const int32_t* __restrict__ qs, int m, int bm) {
  constexpr int VEC = Ovm<T>::VEC;
  const int n_chunks = ovm_chunks(m, VEC), lane = threadIdx.x % 32;
  const int4* qw = reinterpret_cast<const int4*>(qs);
  float acc = 0.0f;
  for (int t0 = 0; t0 < m; t0 += bm) {
    uint32_t s = 0;
    for (int k = t0 / VEC + lane; k < min(t0 + bm, m + VEC - 1) / VEC; k += 32) {
#pragma unroll
      for (int g = 0; g < VEC / 4; ++g) {
        const int4 w = qw[g * n_chunks + k];
        s += static_cast<uint32_t>(w.x) + static_cast<uint32_t>(w.y) +
             static_cast<uint32_t>(w.z) + static_cast<uint32_t>(w.w);
      }
    }
    acc += bloom::tile_sum_f32(__reduce_add_sync(FULL, s));
  }
  return acc;
}

__device__ __forceinline__ void store_row(uint8_t* __restrict__ flags, float* __restrict__ sums,
                                          float* __restrict__ fp, int out, bool le, bool ge,
                                          float sq, float sp, float f_qp, float f_pq) {
  reinterpret_cast<uint16_t*>(flags)[out] =
      static_cast<uint16_t>(le) | static_cast<uint16_t>(ge) << 8;
  reinterpret_cast<float2*>(sums)[out] = make_float2(sq, sp);
  reinterpret_cast<float2*>(fp)[out] = make_float2(f_qp, f_pq);
}

// The running Σp of one row: lanes add their chunks' sums to the open
// tile, and a closed tile is reduced over the warp and added, as float
// with its n·base, in tile order.
struct RowSum {
  uint32_t run;
  float acc;
  int tile_lo, tile_hi;
  __device__ __forceinline__ void start(int bm, int m) {
    run = 0;
    acc = 0.0f;
    tile_lo = 0;
    tile_hi = min(bm, m);
  }
  __device__ __forceinline__ void close(uint32_t b, int bm, int m) {
    const uint32_t tot = __reduce_add_sync(FULL, run) +
                         static_cast<uint32_t>(tile_hi - tile_lo) * b;
    acc += bloom::tile_sum_f32(tot);
    run = 0;
    tile_lo = tile_hi;
    tile_hi = min(tile_hi + bm, m);
  }
};

// A warp's tail rows: batches gw, gw + warps, ... of rb rows as one
// stream of stages, OVM_CPL chunk groups (32 chunks each, one a lane) a
// stage.  ASYNC: 16-byte chunks through the cp.async ring (rows 16-byte
// aligned, m a multiple of the chunk); else scalar loads.  A tile can end
// inside a stage, so each lane's chunk is added to its own tile and
// every tile that ends in the stage is closed, in order.  The lanes'
// running min and max of d decide the flags.  The batch's rows are
// finalized together, lane i holding row i; output row H + r is tail
// row r.  The kernel has issued the feed's first
// OVM_DEPTH - 1 stages (ASYNC) and loaded the first batch's bases
// (b_mine, one a lane) before staging the query.
template <typename T, bool PACKED, bool ASYNC>
__device__ __forceinline__ void ovm_tail(const int32_t* __restrict__ qs, float sq,
                                         Feed<T>& feed, uint32_t b_mine, int gw,
                                         const int32_t* __restrict__ base, int H,
                                         uint8_t* __restrict__ flags, float* __restrict__ sums,
                                         float* __restrict__ fp, int m, int bm, float log_q) {
  constexpr int VEC = Ovm<T>::VEC, STAGE = Ovm<T>::STAGE;
  const int lane = threadIdx.x % 32;
  const int n_batches = feed.n_batches, n_chunks = feed.n_chunks, spr = feed.spr;
  const int N = feed.N, rb = feed.rb, warps = feed.warps;
  const uint4* ring = feed.ring;
  const int4* qw = reinterpret_cast<const int4*>(qs) + lane;

  Cursor at;  // the stage being computed
  at.start(gw, rb, N, feed.src0, feed.row_bytes);
  unsigned g = 0;
  while (at.tb < n_batches) {
    const int tb = at.tb, nr = at.nr;
    float sp_mine = 0.0f;
    bool le_mine = false, ge_mine = false;
    uint32_t b = 0;
    int32_t lo = 0, hi = 0;
    RowSum rs;
    for (int st = nr * spr; st > 0; --st, ++g) {
      if (at.s == 0) {  // a row starts
        b = __shfl_sync(FULL, b_mine, at.i);
        lo = 0;
        hi = 0;
        rs.start(bm, m);
      }
      const int s0 = at.s * STAGE;
      if (ASYNC) {
        feed.issue((g + OVM_DEPTH - 1) % OVM_DEPTH);
        bloom::cp_async_wait<OVM_DEPTH - 1>();
      }
      int c0[OVM_CPL], nv[OVM_CPL];
      uint32_t part[OVM_CPL];
#pragma unroll
      for (int j = 0; j < OVM_CPL; ++j) {
        const int k0 = s0 / VEC + j * 32;  // the group's first chunk
        c0[j] = (k0 + lane) * VEC;
        nv[j] = max(0, min(VEC, m - c0[j]));
        part[j] = 0;
        if (ASYNC) {
          if (nv[j] > 0)  // a whole chunk: m is a multiple of VEC
            ovm_chunk<false>(ring[((g % OVM_DEPTH) * OVM_CPL + j) * 32], qw + k0, n_chunks, b,
                             nv[j], lo, hi, part[j], T{});
        } else if (nv[j] > 0) {
          const uint4 v = load_scalar(reinterpret_cast<const T*>(at.row) + c0[j], nv[j]);
          if (nv[j] == VEC)
            ovm_chunk<false>(v, qw + k0, n_chunks, b, nv[j], lo, hi, part[j], T{});
          else
            ovm_chunk<true>(v, qw + k0, n_chunks, b, nv[j], lo, hi, part[j], T{});
        }
      }
      // close every tile that ends in this stage, in order; each of the
      // lane's chunks lies in one tile (bm is a multiple of 128 cells, a
      // chunk 16 or 4)
      const int s1 = min(s0 + STAGE, m);
      while (rs.tile_lo < m && rs.tile_hi <= s1) {
#pragma unroll
        for (int j = 0; j < OVM_CPL; ++j) {
          if (nv[j] > 0 && c0[j] < rs.tile_hi) {
            rs.run += part[j];
            part[j] = 0;
          }
        }
        rs.close(b, bm, m);
      }
#pragma unroll
      for (int j = 0; j < OVM_CPL; ++j) rs.run += part[j];
      if (at.s + 1 == spr) {  // the row ends: lane i keeps row i
        const bool le = __all_sync(FULL, lo >= 0);
        const bool ge = __all_sync(FULL, hi <= 0);
        if (lane == at.i) {
          sp_mine = rs.acc;
          le_mine = le;
          ge_mine = ge;
        }
      }
      at.next(spr, warps, rb, N, feed.src0, feed.row_bytes);
    }
    // the batch ends: every lane its row, and the next batch's bases
    if (lane < nr)
      store_row(flags, sums, fp, H + tb * rb + lane, le_mine, ge_mine, sq, sp_mine,
                bloom::eq3_fp(sq, sp_mine, log_q), bloom::eq3_fp(sp_mine, sq, log_q));
    if (PACKED && at.tb < n_batches)
      b_mine = lane < at.nr ? static_cast<uint32_t>(base[at.tb * rb + lane]) : 0u;
  }
  if (ASYNC) bloom::cp_async_wait_all();
}

// Hot rows and N tail rows (H = 0: plain one-vs-many).  `warps` warps of
// the grid have work: warp w takes tail batches w, w + warps, ... of rb
// rows, and hot batches (32 rows, one a lane) counted from the last warp.
template <typename T, bool PACKED>
__global__ void __launch_bounds__(1024)
ovm_kernel(const int32_t* __restrict__ q, int V, const int32_t* __restrict__ hot_meta,
           const float* __restrict__ hot_sums, int H, const T* __restrict__ peers,
           const int32_t* __restrict__ base, int N, uint8_t* __restrict__ flags,
           float* __restrict__ sums, float* __restrict__ fp, int m, int bm, float log_q,
           int vec_ok, int rb, int warps) {
  constexpr int VEC = Ovm<T>::VEC;
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gw = blockIdx.x * (blockDim.x / 32) + warp;
  // the tail's first copies and bases go out before the query is staged
  const bool tail = gw < warps && gw * rb < N;  // warp-uniform
  Feed<T> feed(peers, N, m, rb, warps, gw,
               reinterpret_cast<uint4*>(smem + ovm_chunks(m, VEC) * VEC) +
                   warp * OVM_DEPTH * OVM_CPL * 32 + lane);
  if (vec_ok && tail)
    for (unsigned j = 0; j + 1 < OVM_DEPTH; ++j) feed.issue(j);
  const uint32_t b_mine = PACKED && tail && lane < min(rb, N - gw * rb)
                              ? static_cast<uint32_t>(base[gw * rb + lane])
                              : 0u;
  stage_query<T>(smem, q, m);
  if (gw >= warps) return;
  const float sq = query_sum<T>(smem, m, bm);

  // hot rows: one lane each
  for (int hb = warps - 1 - gw; hb * 32 < H; hb += warps) {
    const int row = hb * 32 + lane;
    if (row < H) {
      const int v = hot_meta[2 * row], n_private = hot_meta[2 * row + 1];
      store_row(flags, sums, fp, row, V <= v, v <= V && n_private == 0, sq, hot_sums[row],
                0.0f, 0.0f);
    }
  }

  if (!tail) return;
  if (vec_ok)
    ovm_tail<T, PACKED, true>(smem, sq, feed, b_mine, gw, base, H, flags, sums, fp, m, bm, log_q);
  else
    ovm_tail<T, PACKED, false>(smem, sq, feed, b_mine, gw, base, H, flags, sums, fp, m, bm, log_q);
}

template <typename T, bool PACKED>
int launch(const void* q, int V, const void* hot_meta, const void* hot_sums, int H,
           const void* peers, const void* base, void* flags, void* sums, void* fp, int N,
           int m, int bn, int bm, float log_q, int vec_ok, void* stream) {
  if (bn < 1 || bn > 32 || bm < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 && H == 0) return 0;
  auto kernel = ovm_kernel<T, PACKED>;
  const size_t smem = ovm_smem(m, Ovm<T>::VEC, bn);
  if (int err = bloom::allow_smem(kernel, smem)) return err;
  // rows a batch: fill the grid's warps once, at most 32 rows a warp
  const int cap = bloom::sm_count() * std::max(1, OVM_WARPS_PER_SM / bn) * bn;
  const int rb = std::min(OVM_BATCH_MAX, std::max(1, (N + cap - 1) / cap));
  const int warps = std::min(cap, std::max({(N + rb - 1) / rb, (H + 31) / 32, 1}));
  kernel<<<(warps + bn - 1) / bn, 32 * bn, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), V, static_cast<const int32_t*>(hot_meta),
      static_cast<const float*>(hot_sums), H, static_cast<const T*>(peers),
      static_cast<const int32_t*>(base), N, static_cast<uint8_t*>(flags),
      static_cast<float*>(sums), static_cast<float*>(fp), m, bm, log_q, vec_ok, rb, warps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int one_vs_many_packed(const void* q, const void* peers,
                                  const void* base, void* flags, void* sums,
                                  void* fp, int N, int m, int bn, int bm,
                                  float log_q, int vec_ok, void* stream) {
  return launch<uint8_t, true>(q, 0, nullptr, nullptr, 0, peers, base, flags, sums, fp, N, m,
                               bn, bm, log_q, vec_ok, stream);
}

extern "C" int one_vs_many_i32(const void* q, const void* peers, void* flags,
                               void* sums, void* fp, int N, int m, int bn,
                               int bm, float log_q, int vec_ok, void* stream) {
  return launch<int32_t, false>(q, 0, nullptr, nullptr, 0, peers, nullptr, flags, sums, fp, N,
                                m, bn, bm, log_q, vec_ok, stream);
}

extern "C" int hybrid_classify(const void* q, int V, const void* hot_meta,
                               const void* hot_sums, const void* tail,
                               const void* tail_base, void* flags, void* sums,
                               void* fp, int H, int T, int m, int bn, int bm,
                               float log_q, int vec_ok, void* stream) {
  if (H <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint8_t, true>(q, V, hot_meta, hot_sums, H, tail, tail_base, flags, sums, fp,
                               T, m, bn, bm, log_q, vec_ok, stream);
}

// Dynamic shared memory (bytes, at most INT_MAX) of one CTA of bn warps
// for rows of m cells of elem_bytes each: the wrappers check it against
// the card's limit before they launch.
extern "C" int one_vs_many_smem(int m, int elem_bytes, int bn) {
  const size_t bytes = ovm_smem(m, 16 / elem_bytes, bn);
  return static_cast<int>(std::min(bytes, static_cast<size_t>(INT_MAX)));
}

// Registers, thread limit, static and dynamic shared memory and the CTAs
// an SM the runtime admits (common.cuh kernel_attrs) of the instance for
// elem_bytes (1: packed and hybrid, 4: i32) at a CTA of bn warps over
// rows of m cells, as launch() would start it.
extern "C" int one_vs_many_attrs(int m, int elem_bytes, int bn, int* out) {
  if (bn < 1 || bn > 32 || m < 1 || (elem_bytes != 1 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ovm_smem(m, 16 / elem_bytes, bn);
  if (elem_bytes == 1) return bloom::kernel_attrs(ovm_kernel<uint8_t, true>, 32 * bn, smem, out);
  return bloom::kernel_attrs(ovm_kernel<int32_t, false>, 32 * bn, smem, out);
}
