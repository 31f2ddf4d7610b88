// Jacobi-2D 5-point sweeps for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/jacobi2d.py:32 (jacobi2d_step,
// pallas_call at :45): every interior point of a float32 [R, C] grid
// becomes 0.2 * (center + left + right + up + down); the boundary rows and
// columns keep their values.  The Pallas wrapper materialised overlapping
// halo strips (a[idx]) and needed (R - 2) % rows_per_block == 0; here the
// one-sweep kernel reads the rows around each tile straight from the input
// and writes a fresh output, for any R and C.
// The reference's many-sweep function (repro/kernels/ref.py:29,
// jacobi2d(a, iters)) has no Pallas kernel; its ports are the cluster
// kernel (grids that fit one cluster) and the tiled kernel (grids past
// it) below.
//
// One sweep (jacobi2d_kernel).  Bound on an H100: bytes.  Each point is
// read once and written once (8 B a point in float32: 62.7 MB, 18.7 us, on
// PolyBench EXTRALARGE's 2,800 x 2,800 grid; 4 B, 9.4 us, in 16 bits)
// against 5 float operations a point.  Design: few instructions and many
// bytes in flight a thread.  A thread holds chunks of a row, on the vector
// route two 16-byte chunks (8 16-bit or 4 float32 points each: one load
// and one store instruction a chunk), and walks down a tile of 16 rows
// (fewer where a grid's tiles would not give every SM a CTA's warps), the
// rows above, at and below in a ring of registers with 3 rows loaded
// ahead (loads that do not allocate in L1, stores with a streaming hint).
// The left and right neighbours of a chunk's end points come from the
// adjacent lanes by shuffles; the two edge lanes of a warp load the
// columns past its strip.  Tiles (a warp's strip of columns x 16 rows) go
// in a 1-D order over CTAs sized from the SM count and an occupancy query,
// so any R and C are taken in about one wave.  The vector route runs where
// C is a multiple of 16 bytes' points and both pointers are 16-byte
// aligned; elsewhere the same kernel runs at a width of one point a chunk
// (4 chunks a thread in float32, 2 in 16 bits).  A ring of rows in shared
// memory fed by cp.async from a loading warp was no faster
// (scripts/jacobi2d_ring.cu).
//
// Many sweeps (jacobi2d_cluster_kernel).  A grid of a few hundred rows
// takes ~2.5 us a launch against a fraction of that in bytes, so RiVec's
// 4,000 sweeps of 164 x 164 were launch bound.  Here one launch runs all
// sweeps: the grid lives in the shared memory of one thread-block cluster
// of up to 16 CTAs, double-buffered.  CTA j holds rows [j rpc, (j+1) rpc)
// and K halo rows above and below, and runs the sweeps in blocks of K: the
// block's first sweep also updates K - 1 halo rows on each side, its next
// K - 2, and so on (the same arithmetic on the same values as the CTA that
// owns those rows, so the same bits), with a CTA barrier between sweeps.
// At a block's end each CTA stores its K top and K bottom rows into its
// neighbours' inboxes (remote stores into distributed shared memory), and
// one cluster barrier (arrive with release, wait with acquire) orders them
// before the neighbours copy them into their halo rows at the next
// block's start.  The inboxes are double-buffered by the block's parity: a
// CTA writes inbox p again only at the end of block b + 2, after the
// barrier that ends block b + 1, which its neighbour passes only once it
// has copied inbox p at the start of block b + 1.  So K sweeps take one
// cluster barrier, the K - 1 halo rows' redundant updates and one
// exchange; the last block exchanges nothing, and no CTA touches another
// CTA's shared memory after the last barrier, so none exits while a
// neighbour still writes into it.  A thread takes one column of a run of
// rows, walking down it with the rows above and below in registers (three
// shared-memory loads a point).  Bound: the dependent cluster barriers
// (4,000 / K for the app), not bytes (the grid is read and written once).
//
// Many sweeps of a grid past the cluster (jacobi2d_tiled_kernel):
// temporal blocking.  PolyBench's 2,800 x 2,800 float32 grid does not fit
// a cluster's shared memory, and one launch a sweep reads and writes it
// (62.7 MB) every sweep.  Here a launch runs k sweeps: each CTA loads its
// output tile and k halo rows and columns on every side (as far as they
// lie in the grid) into two shared buffers, runs the k sweeps on the
// shrinking region (the first sweep updates the tile and k - 1 halo rows
// and columns a side, the next k - 2, ...: the same arithmetic on the same
// values as the CTA that owns those points, so the same bits), with a CTA
// barrier between sweeps, and stores only its own tile.  ceil(iters / k)
// launches ping-pong between two global buffers, the last one running the
// remaining sweeps; each reads the grid once with its halos and writes it
// once.  The tile comes in by 16-byte cp.async where its rows fall on
// 16-byte boundaries, into one buffer; the other gets only the grid's
// boundary points (held, so read from both), since every other point a
// sweep reads the sweep before it wrote.  A thread walks a column down a
// run of rows with the rows above and below in registers, as the cluster
// kernel does (three shared loads and a store a point: the sweeps are
// bound by shared memory's 128 bytes a clock, ~8 points a clock an SM).
// Two CTAs an SM.  Tiles go on a 1-D order that the CTAs stride over, so
// any R and C are taken.  Bound: the sweeps' operations (5 a point a
// sweep: 0.58 ms for PolyBench's 1,000 sweeps at 67 TFLOP/s); what holds
// it is shared memory in the sweeps, then the ceil(iters / k) passes over
// the grid and the halo's redundant updates.
//
// All three kernels are built with -fmad=false and sum in the plain version's
// order (((((c + l) + r) + u) + d) * 0.2f, repro_torch/kernels/ref.py:
// jacobi2d): every sweep equals its plain version bit for bit.  A bfloat16
// or float16 grid is widened as it is loaded, summed in float32 in the same
// order and rounded to its type on every store, as the plain version
// rounds at the end of every sweep; a held point is copied.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The one-sweep kernel: a CTA's threads; on each route (16-byte chunks,
// and one-point chunks) the rows of a tile, the rows loaded ahead of the
// one below the row computed, and the chunks a thread holds of a row (at
// width one, of a float32 or a 16-bit grid).
constexpr int STEP_THREADS = 256;
constexpr int VEC_RUN = 16, VEC_AHEAD = 3, VEC_CHUNKS = 2;
constexpr int ONE_RUN = 16, ONE_AHEAD = 3, ONE_CHUNKS_32 = 4, ONE_CHUNKS_16 = 2;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_MAX = 232448;           // a block's opt-in shared memory
constexpr int MAX_CLUSTER = 16;            // non-portable past 8
constexpr int CLUSTER_THREADS = 1024;
constexpr int TILED_THREADS = 512;         // at most, two CTAs an SM

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// round to nearest even, as torch's cast
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// A row's chunk as a thread holds it: V elements' raw bits in W 32-bit
// words (16 bytes on the vector route; one element, in the low bits of one
// word, at width one).
template <typename T, int V>
struct Chunk {
  static constexpr int W = V * (int)sizeof(T) < 4 ? 1 : V * (int)sizeof(T) / 4;
  uint32_t w[W];
};

// element j's raw bits
template <typename T, int V>
__device__ __forceinline__ uint32_t bits_at(const Chunk<T, V>& c, int j) {
  if constexpr (sizeof(T) == 4) return c.w[j];
  else return (c.w[j / 2] >> (16 * (j & 1))) & 0xffffu;
}

template <typename T, int V>
__device__ __forceinline__ void set_bits(Chunk<T, V>& c, int j, uint32_t b) {
  if constexpr (sizeof(T) == 4) {
    c.w[j] = b;
  } else {
    const int s = 16 * (j & 1);
    c.w[j / 2] = (c.w[j / 2] & ~(0xffffu << s)) | (b << s);
  }
}

template <typename T> __device__ __forceinline__ float widen(uint32_t b);
template <> __device__ __forceinline__ float widen<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float widen<__half>(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}

// rounded to T as torch's cast rounds, as raw bits
template <typename T> __device__ __forceinline__ uint32_t narrow(float v);
template <> __device__ __forceinline__ uint32_t narrow<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint32_t narrow<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
template <> __device__ __forceinline__ uint32_t narrow<__half>(float v) {
  return __half_as_ushort(__float2half(v));
}

// Read-only loads that do not allocate in L1 (nothing is read twice from
// there), and stores marked streaming.
__device__ __forceinline__ uint32_t load_elem(const float* p) {
  uint32_t b;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(b) : "l"(p));
  return b;
}
template <typename T>
__device__ __forceinline__ uint32_t load_elem(const T* p) {
  unsigned short h;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(h) : "l"(p));
  return h;
}

template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* p, Chunk<T, V>& c) {
  if constexpr (Chunk<T, V>::W == 4) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(c.w[0]), "=r"(c.w[1]), "=r"(c.w[2]), "=r"(c.w[3])
        : "l"(p));
  } else {
    c.w[0] = load_elem(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T, V>& c) {
  if constexpr (Chunk<T, V>::W == 4) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(c.w[0]), "r"(c.w[1]), "r"(c.w[2]),
                    "r"(c.w[3]) : "memory");
  } else if constexpr (sizeof(T) == 4) {
    asm volatile("st.global.cs.b32 [%0], %1;" :: "l"(p), "r"(c.w[0])
                 : "memory");
  } else {
    asm volatile("st.global.cs.b16 [%0], %1;"
                 :: "l"(p), "h"((unsigned short)c.w[0]) : "memory");
  }
}

// Row g_row's chunks of a thread (at p + 32 V k where `have` has bit k)
// and, for an edge lane, its point at p + eo, where the row lies in the
// grid; p is the row's chunk 0.
template <typename T, int V, int G>
__device__ __forceinline__ void load_row(const T* p, int g_row, int R,
                                         unsigned have, bool edge, int eo,
                                         Chunk<T, V> (&row)[G],
                                         uint32_t& erow) {
  if (g_row < 0 || g_row >= R) return;
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (have >> k & 1) load_chunk<T, V>(p + 32 * V * k, row[k]);
  if (edge) erow = load_elem(p + eo);
}

// One sweep.  A thread holds G chunks of V points of a row; a warp's 32 G
// chunks are a strip of 32 V G columns, chunk k of lane l at columns
// c0 + (32 k + l) V .. + V - 1, so each of a warp's loads is 32 chunks side
// by side.  A warp takes tiles of `run` (<= RUN) rows x a strip in a 1-D
// order, strips fastest; CTA b's warp w takes tiles b + gridDim.x (w +
// STEP_THREADS / 32 n), so the busy warps spread evenly over the CTAs.  It
// walks down a tile with the rows above, at and below in a ring of AHEAD +
// 3 rows of registers, loading AHEAD rows past the one below.  The left
// neighbour of a chunk's first point is the last point of the chunk before
// it in the strip (the previous lane's, or for lane 0 lane 31's of the
// chunk before), the right neighbour of its last the first of the chunk
// after it: one rotating shuffle each a chunk.  Lane 0 loads the column
// left of the strip, lane 31 the one right of it.  What a tile's chunks
// are (in the grid, holding column 0 or C - 1) is worked out once a tile.
template <typename T, int V, int G, int RUN, int AHEAD>
__global__ void __launch_bounds__(STEP_THREADS)
jacobi2d_kernel(const T* __restrict__ a, T* __restrict__ out, int R, int C,
                int run) {
  constexpr int S = AHEAD + 3;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long strip_w = 32LL * V * G;
  const long long nstrips = (C + strip_w - 1) / strip_w;
  const long long tiles = (R + run - 1) / run * nstrips;
  const long long stride = (long long)gridDim.x * (STEP_THREADS / 32);
  for (long long t = (long long)(threadIdx.x / 32) * gridDim.x + blockIdx.x;
       t < tiles; t += stride) {
    const int r0 = (int)(t / nstrips) * run;
    const long long c0 = t % nstrips * strip_w;
    const long long cl = c0 + (long long)lane * V;   // chunk 0's first column
    unsigned have = 0, hold_first = 0, hold_last = 0;   // bit k: chunk k
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const long long c = cl + 32LL * V * k;
      have |= (unsigned)(c < C) << k;
      hold_first |= (unsigned)(c == 0) << k;
      hold_last |= (unsigned)(c + V == C) << k;
    }
    const int eo = lane == 0 ? -1 : (int)(strip_w - 31 * V);  // from cl
    const bool edge = (lane == 0 || lane == 31) && cl + eo >= 0 &&
                      cl + eo < C;
    // local row i is grid row r0 - 1 + i, i = 0 .. run + 1; its chunk 0 at
    // a + (r0 - 1 + i) C + cl
    const T* src = a + ((long long)r0 - 1) * C + cl;
    T* dst = out + ((long long)r0 - 1) * C + cl;
    Chunk<T, V> ring[S][G] = {};
    uint32_t ering[S] = {};
#pragma unroll
    for (int i = 0; i < AHEAD + 2 && i <= RUN + 1; ++i)
      if (i <= run + 1)
        load_row<T, V, G>(src + (long long)i * C, r0 - 1 + i, R, have, edge,
                          eo, ring[i % S], ering[i % S]);
#pragma unroll
    for (int i = 1; i <= RUN; ++i) {
      if (i > run) break;
      if (i + AHEAD + 1 <= RUN + 1 && i + AHEAD + 1 <= run + 1)
        load_row<T, V, G>(src + (long long)(i + AHEAD + 1) * C,
                          r0 + i + AHEAD, R, have, edge, eo,
                          ring[(i + AHEAD + 1) % S],
                          ering[(i + AHEAD + 1) % S]);
      const int row = r0 - 1 + i;
      if (row >= R) break;
      // lane l gets lane l - 1's last points and lane l + 1's first
      uint32_t last[G], first[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        last[k] = __shfl_sync(FULL, bits_at(ring[i % S][k], V - 1),
                              (lane + 31) & 31);
        first[k] = __shfl_sync(FULL, bits_at(ring[i % S][k], 0),
                               (lane + 1) & 31);
      }
      const bool interior = row > 0 && row < R - 1;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (!(have >> k & 1)) continue;
        const uint32_t lft =
            lane != 0 ? last[k] : k == 0 ? ering[i % S] : last[k - 1];
        const uint32_t rgt =
            lane != 31 ? first[k] : k == G - 1 ? ering[i % S] : first[k + 1];
        const Chunk<T, V>& mid = ring[i % S][k];
        Chunk<T, V> res = mid;   // held points are copied
        if (interior) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            // only a chunk's first point can be column 0, only its last
            // column C - 1
            if ((j == 0 && (hold_first >> k & 1)) ||
                (j == V - 1 && (hold_last >> k & 1)))
              continue;
            const float l = widen<T>(j > 0 ? bits_at(mid, j - 1) : lft);
            const float r = widen<T>(j < V - 1 ? bits_at(mid, j + 1) : rgt);
            const float sum = (((widen<T>(bits_at(mid, j)) + l) + r) +
                               widen<T>(bits_at(ring[(i - 1) % S][k], j))) +
                              widen<T>(bits_at(ring[(i + 1) % S][k], j));
            set_bits(res, j, narrow<T>(sum * 0.2f));
          }
        }
        store_chunk<T, V>(dst + (long long)i * C + 32 * V * k, res);
      }
    }
  }
}

// `iters` sweeps of the [R, C] grid in one cluster of gridDim.x CTAs,
// each holding rows [rank rpc, (rank + 1) rpc) of it (the last ones may
// hold fewer, or none), in blocks of K (<= rpc) sweeps.  Shared memory:
// two working buffers of (rpc + 2 K) rows (K halo rows, the CTA's own
// rows, K halo rows) and the inboxes [parity][top, bottom][K] rows, all C
// wide.  blockDim.x threads take the columns of a row, blockDim.y runs of
// rows at a time.
template <typename T>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
jacobi2d_cluster_kernel(const T* __restrict__ a, T* __restrict__ out, int R,
                        int C, int rpc, int K, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ctas = (int)cluster.num_blocks();
  const int r0 = rank * rpc;                   // the first row held
  const int nr = max(0, min(rpc, R - r0));     // rows held
  const int span = (rpc + 2 * K) * C;          // one working buffer
  T* const inbox = buf + 2 * span;             // [2][2][K][C]
  // signed copies: a CTA past the grid's last row has lo > hi below
  const int ty = threadIdx.y, by = blockDim.y;
  const int tid = ty * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * by;
  // neighbours that hold rows, and the rows they and this CTA swap
  const bool has_prev = rank > 0 && nr > 0;
  const bool has_next = rank + 1 < ctas && (rank + 1) * rpc < R;
  const int up_rows = has_prev ? K : 0;                 // from prev
  const int down_rows = has_next ? min(K, R - r0 - nr) : 0;
  T* const prev_inbox =
      has_prev ? cluster.map_shared_rank(inbox, rank - 1) : inbox;
  T* const next_inbox =
      has_next ? cluster.map_shared_rank(inbox, rank + 1) : inbox;

  // rows r0 - K .. r0 + nr + K - 1, as far as they exist, into both
  // working buffers: held points never change
  for (int i = tid; i < (nr + 2 * K) * C; i += nthreads) {
    const int g = r0 - K + i / C;
    if (g >= 0 && g < R) {
      const T v = a[(long long)g * C + i % C];
      buf[i] = v;
      buf[span + i] = v;
    }
  }
  cluster.sync();

  // local rows lo..hi that hold interior rows of the grid (1 .. R - 2)
  const int lo_g = K + 1 - r0, hi_g = K + R - 2 - r0;
  int cur = 0;                                 // the buffer read next
  for (int done = 0; done < iters;) {
    const int kb = min(K, iters - done);
    T* src = buf + cur;
    if (done > 0) {   // the neighbours' rows of the last block: the halos
      const T* in = inbox + ((done / K - 1) & 1) * 2 * K * C;
      for (int i = tid; i < up_rows * C; i += nthreads) src[i] = in[i];
      for (int i = tid; i < down_rows * C; i += nthreads)
        src[(K + nr) * C + i] = in[K * C + i];
      __syncthreads();
    }
    for (int j = 1; j <= kb; ++j) {
      src = buf + cur;
      T* const dst = buf + (span - cur);
      const int ext = kb - j;                  // halo rows updated too
      const int lo = max(K - ext, lo_g), hi = min(K + nr - 1 + ext, hi_g);
      const int run = hi >= lo ? (hi - lo + by) / by : 0;   // rows a thread
      const int first = lo + ty * run;
      const int last = min(hi, first + run - 1);
      for (int c = 1 + threadIdx.x; c < C - 1; c += blockDim.x) {
        if (first > last) break;
        const T* col = src + c;
        float up = to_f(col[(first - 1) * C]), mid = to_f(col[first * C]);
#pragma unroll 4
        for (int lr = first; lr <= last; ++lr) {
          const float down = to_f(col[(lr + 1) * C]);
          const float v = 0.2f * ((((mid + to_f(col[lr * C - 1])) +
                                    to_f(col[lr * C + 1])) +
                                   up) +
                                  down);
          dst[lr * C + c] = from_f<T>(v);
          up = mid;
          mid = down;
        }
      }
      __syncthreads();
      cur = span - cur;
    }
    done += kb;
    if (done < iters) {   // this block's edge rows to the neighbours
      const int p = (done / K - 1) & 1;
      const T* res = buf + cur;
      for (int i = tid; i < up_rows * C; i += nthreads)   // top K rows
        prev_inbox[(p * 2 + 1) * K * C + i] = res[K * C + i];
      for (int i = tid; i < K * C && has_next; i += nthreads)
        next_inbox[p * 2 * K * C + i] = res[nr * C + i];
      cluster.sync();
    }
  }

  const T* fin = buf + cur;
  for (int i = tid; i < nr * C; i += nthreads)
    out[(long long)r0 * C + i] = fin[K * C + i];
}

// 16 bytes from global to shared memory, not through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// `kb` sweeps of the [R, C] grid `a` into `out`, on tiles of tr x tc
// output points (tiles_x a row of tiles), each held in shared memory with
// K (>= kb) halo rows and columns a side: two buffers of (tr + 2 K) rows
// of (tc + 2 K) points, `pitch` (that rounded up to whole 16-byte chunks)
// apart.  `vec`: the tile's rows move between the grid and shared memory
// as whole chunks (the host checks the alignment), else point by point.
// blockDim.x threads: a thread a column of a buffer row (in whole warps),
// the rest in runs of rows.
template <typename T>
__global__ void __launch_bounds__(TILED_THREADS, 2)
jacobi2d_tiled_kernel(const T* __restrict__ a, T* __restrict__ out, int R,
                      int C, int tr, int tc, int K, int kb, int pitch,
                      int vec, int tiles_x, long long tiles) {
  constexpr int V = 16 / sizeof(T);             // points a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);
  const int W = tc + 2 * K, H = tr + 2 * K;   // a buffer's points, rows
  const int span = H * pitch, wc = pitch / V;   // chunks a row
  // signed copies: a signed row split below
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int bx = min((W + 31) / 32 * 32, nthreads), by = nthreads / bx;
  const int tx = tid % bx, ty = tid / bx;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = (int)(t / tiles_x) * tr, c0 = (int)(t % tiles_x) * tc;
    // rows r0 - K .. r0 + tr + K - 1 and columns c0 - K .. c0 + tc + K - 1,
    // as far as they lie in the grid, into the first buffer; no point
    // outside the grid is read
    if (vec) {
      for (int i = tid; i < H * wc; i += nthreads) {
        const int lr = i / wc, lc = (i % wc) * V;
        const int g = r0 - K + lr, gc = c0 - K + lc;
        if (g >= 0 && g < R && gc >= 0 && gc < C)
          cp_async16(buf + lr * pitch + lc, a + (long long)g * C + gc);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" :::
                       "memory");
    } else {
      for (int i = tid; i < H * W; i += nthreads) {
        const int lr = i / W, lc = i % W;
        const int g = r0 - K + lr, gc = c0 - K + lc;
        if (g >= 0 && g < R && gc >= 0 && gc < C)
          buf[lr * pitch + lc] = a[(long long)g * C + gc];
      }
    }
    __syncthreads();
    // the grid's boundary rows and columns in the tile into the second
    // buffer too: held, they are read from both (every other point a
    // sweep reads, the sweep before wrote)
    auto hold = [&](int lr, int lc) {
      const int g = r0 - K + lr, gc = c0 - K + lc;
      if (lr >= 0 && lr < H && lc >= 0 && lc < W && g >= 0 && g < R &&
          gc >= 0 && gc < C)
        buf[span + lr * pitch + lc] = buf[lr * pitch + lc];
    };
    for (int i = tid; i < 2 * W; i += nthreads)   // rows 0 and R - 1
      hold(i < W ? K - r0 : K + R - 1 - r0, i % W);
    for (int i = tid; i < 2 * H; i += nthreads)   // columns 0 and C - 1
      hold(i % H, i < H ? K - c0 : K + C - 1 - c0);
    __syncthreads();
    // local rows and columns of the grid's interior (1 .. R - 2, 1 .. C - 2)
    const int lo_r = K + 1 - r0, hi_r = K + R - 2 - r0;
    const int lo_c = K + 1 - c0, hi_c = K + C - 2 - c0;
    int cur = 0;                               // the buffer read next
    for (int j = 1; j <= kb; ++j) {
      const T* const src = buf + cur;
      T* const dst = buf + (span - cur);
      const int ext = kb - j;                  // halo rows and columns too
      const int lo = max(K - ext, lo_r), hi = min(K + tr - 1 + ext, hi_r);
      const int clo = max(K - ext, lo_c), chi = min(K + tc - 1 + ext, hi_c);
      const int run = hi >= lo ? (hi - lo + by) / by : 0;   // rows a thread
      const int first = lo + ty * run;
      const int last = min(hi, first + run - 1);
      for (int c = clo + tx; c <= chi && ty < by; c += bx) {
        if (first > last) break;
        const T* col = src + c;
        float up = to_f(col[(first - 1) * pitch]);
        float mid = to_f(col[first * pitch]);
#pragma unroll 4
        for (int lr = first; lr <= last; ++lr) {
          const float down = to_f(col[(lr + 1) * pitch]);
          const float v = 0.2f * ((((mid + to_f(col[lr * pitch - 1])) +
                                    to_f(col[lr * pitch + 1])) +
                                   up) +
                                  down);
          dst[lr * pitch + c] = from_f<T>(v);
          up = mid;
          mid = down;
        }
      }
      cur = span - cur;
      __syncthreads();
    }
    // this tile's own points
    const T* const fin = buf + cur;
    const int nr = min(tr, R - r0), nc = min(tc, C - c0);
    if (vec) {
      const int ncc = (nc + V - 1) / V;
      for (int i = tid; i < nr * ncc; i += nthreads) {
        const int lr = i / ncc, lc = (i % ncc) * V;
        *reinterpret_cast<uint4*>(out + (long long)(r0 + lr) * C + c0 + lc) =
            *reinterpret_cast<const uint4*>(fin + (K + lr) * pitch + K + lc);
      }
    } else {
      for (int i = tid; i < nr * nc; i += nthreads) {
        const int lr = i / nc, lc = i % nc;
        out[(long long)(r0 + lr) * C + c0 + lc] =
            fin[(K + lr) * pitch + K + lc];
      }
    }
    __syncthreads();   // the buffers are loaded again for the next tile
  }
}

int set_smem(const void* kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

// The launch of a one-sweep kernel on the current device: rows a tile, RUN
// or, where the grid's tiles would give the card's SMs fewer warps than a
// CTA each, as few as give them that many (a tile's rows are walked one
// after another, so a small grid's few long tiles would set its time); and
// CTAs, the card's SMs times as many an SM as the tiles fill, at most as
// many as an SM holds (the occupancy query, cached by device).
template <typename T, int V, int G, int RUN, int AHEAD>
int step_plan(int r, int c, int* run, int* ctas) {
  static int sms[MAX_DEVICES], per_sm[MAX_DEVICES];
  int dev = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (e) return e;
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    int n = 0, m = 0;
    e = static_cast<int>(cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, dev));
    if (!e)
      e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &m, jacobi2d_kernel<T, V, G, RUN, AHEAD>, STEP_THREADS, 0));
    if (e) return e;
    sms[dev] = n;
    per_sm[dev] = m > 0 ? m : 1;
  }
  constexpr int warps = STEP_THREADS / 32;
  const long long nstrips = (c + 32LL * V * G - 1) / (32LL * V * G);
  const long long runs = (sms[dev] * (long long)warps + nstrips - 1) / nstrips;
  long long rows = (r + runs - 1) / runs;
  *run = (int)(rows < 1 ? 1 : rows > RUN ? RUN : rows);
  const long long tiles = (r + *run - 1) / *run * nstrips;
  long long per = ((tiles + warps - 1) / warps + sms[dev] - 1) / sms[dev];
  if (per > per_sm[dev]) per = per_sm[dev];
  if (per < 1) per = 1;
  *ctas = (int)(per * sms[dev]);
  return 0;
}

template <typename T, int V, int G, int RUN, int AHEAD>
int launch_step(const void* a, void* out, int r, int c, cudaStream_t st) {
  int run = RUN, ctas = 0;
  const int e = step_plan<T, V, G, RUN, AHEAD>(r, c, &run, &ctas);
  if (e) return e;
  jacobi2d_kernel<T, V, G, RUN, AHEAD><<<ctas, STEP_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<T*>(out), r, c, run);
  return static_cast<int>(cudaGetLastError());
}

// The vector route (16 bytes a chunk) where c is a multiple of it and both
// pointers are 16-byte aligned; the width-one route (one point a chunk).
template <typename T>
int launch_step_width(const void* a, void* out, int r, int c, int width,
                      cudaStream_t st) {
  constexpr int v = 16 / sizeof(T);
  constexpr int g = sizeof(T) == 4 ? ONE_CHUNKS_32 : ONE_CHUNKS_16;
  if (width == 1)
    return launch_step<T, 1, g, ONE_RUN, ONE_AHEAD>(a, out, r, c, st);
  if (width == v && c % v == 0 &&
      reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_step<T, v, VEC_CHUNKS, VEC_RUN, VEC_AHEAD>(a, out, r, c,
                                                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_step_typed(const void* a, void* out, int r, int c, int dtype,
                      int width, cudaStream_t st) {
  if (dtype == 1)
    return launch_step_width<__nv_bfloat16>(a, out, r, c, width, st);
  if (dtype == 2) return launch_step_width<__half>(a, out, r, c, width, st);
  return launch_step_width<float>(a, out, r, c, width, st);
}

// The cluster launch's configuration: one cluster of `ctas`, rows of
// `rpc`, blocks of K sweeps, a thread a column (in whole warps, up to 1024)
// and as many runs of rows at once as the remaining threads allow, up to
// the rows a sweep updates.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int rpc;
  size_t bytes;
  ClusterLaunch(int r, int c, int ctas, int k, size_t elem, cudaStream_t st)
      : cfg{}, attr{} {
    rpc = (r + ctas - 1) / ctas;
    bytes = (size_t)(2 * (rpc + 2 * k) + 4 * k) * c * elem;
    int bx = ((c > 2 ? c - 2 : 1) + 31) / 32 * 32;
    if (bx > CLUSTER_THREADS) bx = CLUSTER_THREADS;
    int by = CLUSTER_THREADS / bx;
    if (by > rpc + 2 * k - 2) by = rpc + 2 * k - 2;
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3((unsigned)bx, (unsigned)by);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
int prepare_cluster(const ClusterLaunch& L, int ctas) {
  const void* kern = (const void*)jacobi2d_cluster_kernel<T>;
  if (L.bytes > (size_t)SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = set_smem(kern, L.bytes);
  if (e) return e;
  if (ctas > 8)
    e = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return e;
}

template <typename T>
int launch_cluster(const void* a, void* out, int r, int c, int iters,
                   int ctas, int k, cudaStream_t st) {
  ClusterLaunch L(r, c, ctas, k, sizeof(T), st);
  const int e = prepare_cluster<T>(L, ctas);
  if (e) return e;
  return static_cast<int>(cudaLaunchKernelEx(
      &L.cfg, jacobi2d_cluster_kernel<T>, static_cast<const T*>(a),
      static_cast<T*>(out), r, c, L.rpc, k, iters));
}

template <typename T>
int clusters_fit(int r, int c, int ctas, int k, int* count) {
  ClusterLaunch L(r, c, ctas, k, sizeof(T), nullptr);
  const int e = prepare_cluster<T>(L, ctas);
  if (e) return e;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, (const void*)jacobi2d_cluster_kernel<T>, &L.cfg));
}

// The tiled launch's shared memory: two buffers of (tr + 2 k) rows of
// (tc + 2 k) points, each row padded to whole 16-byte chunks.
size_t tiled_pitch(int tc, int k, size_t elem) {
  const size_t v = 16 / elem;
  return ((size_t)tc + 2 * (size_t)k + v - 1) / v * v;
}
size_t tiled_bytes(int tr, int tc, int k, size_t elem) {
  return 2 * (size_t)(tr + 2 * k) * tiled_pitch(tc, k, elem) * elem;
}

// `kb` sweeps from `a` into `out` on tr x tc tiles with k halo rows and
// columns, `threads` a CTA.  Whole chunks move between the grid and shared
// memory where the grid's rows and the tile's and halo's columns fall on
// 16-byte boundaries.
template <typename T>
int launch_tiled(const void* a, void* out, int r, int c, int tr, int tc,
                 int k, int kb, int threads, cudaStream_t st) {
  const void* kern = (const void*)jacobi2d_tiled_kernel<T>;
  const size_t bytes = tiled_bytes(tr, tc, k, sizeof(T));
  const int e = set_smem(kern, bytes);
  if (e) return e;
  constexpr int v = 16 / sizeof(T);
  const int pitch = (int)tiled_pitch(tc, k, sizeof(T));
  const bool vec = c % v == 0 && tc % v == 0 && k % v == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int tiles_x = (c + tc - 1) / tc;
  const long long tiles = (long long)((r + tr - 1) / tr) * tiles_x;
  const unsigned grid = (unsigned)(tiles < 0x7fffffffll ? tiles : 0x7fffffffll);
  jacobi2d_tiled_kernel<T><<<grid, threads, bytes, st>>>(
      static_cast<const T*>(a), static_cast<T*>(out), r, c, tr, tc, k, kb,
      pitch, vec ? 1 : 0, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiled_typed(const void* a, void* out, int r, int c, int dtype,
                       int tr, int tc, int k, int kb, int threads,
                       cudaStream_t st) {
  if (dtype == 1)
    return launch_tiled<__nv_bfloat16>(a, out, r, c, tr, tc, k, kb, threads,
                                       st);
  if (dtype == 2)
    return launch_tiled<__half>(a, out, r, c, tr, tc, k, kb, threads, st);
  return launch_tiled<float>(a, out, r, c, tr, tc, k, kb, threads, st);
}

bool bad_dims(int r, int c, int dtype) {
  return r < 1 || c < 1 || dtype < 0 || dtype > 2;
}

// a cluster of `ctas` CTAs in blocks of `k` sweeps: k at most a CTA's rows
bool bad_cluster(int r, int ctas, int k) {
  return ctas < 1 || ctas > MAX_CLUSTER || k < 1 || k > (r + ctas - 1) / ctas;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One sweep of the [r, c] grid `a` into `out` (distinct buffers), float32
// (`dtype` 0), bfloat16 (1) or float16 (2), `width` elements a thread: 1,
// or 16 bytes' worth where c is a multiple of it and both pointers are
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int jacobi2d_launch(const void* a, void* out, int r, int c,
                               int dtype, int width, void* stream) {
  if (bad_dims(r, c, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step_typed(a, out, r, c, dtype, width,
                           static_cast<cudaStream_t>(stream));
}

// The loop route: `iters` (>= 1) one-sweep launches from `a`, between
// `out` and `tmp` in turns so that the last lands in `out`, at `width`.
extern "C" int jacobi2d_loop_launch(const void* a, void* out, void* tmp,
                                    int r, int c, int dtype, int width,
                                    int iters, void* stream) {
  if (bad_dims(r, c, dtype) || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* src = a;
  for (int k = 0; k < iters; ++k) {
    void* dst = (iters - 1 - k) % 2 == 0 ? out : tmp;
    const int e = launch_step_typed(src, dst, r, c, dtype, width, st);
    if (e) return e;
    src = dst;
  }
  return 0;
}

// The cluster route: `iters` (>= 0) sweeps of `a` into `out` in one
// launch of one cluster of `ctas` (1 to 16) CTAs, in blocks of `k` (1 to
// ceil(r / ctas)) sweeps between cluster barriers.
extern "C" int jacobi2d_cluster_launch(const void* a, void* out, int r,
                                       int c, int dtype, int iters, int ctas,
                                       int k, void* stream) {
  if (bad_dims(r, c, dtype) || iters < 0 || bad_cluster(r, ctas, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_cluster<__nv_bfloat16>(a, out, r, c, iters, ctas, k, st);
  if (dtype == 2)
    return launch_cluster<__half>(a, out, r, c, iters, ctas, k, st);
  return launch_cluster<float>(a, out, r, c, iters, ctas, k, st);
}

// How many clusters of `ctas` CTAs in blocks of `k` sweeps for an [r, c]
// grid of `dtype` the card can hold at once, into *count (0: the cluster
// cannot be scheduled); returns a CUDA error code.
extern "C" int jacobi2d_clusters_fit(int r, int c, int dtype, int ctas,
                                     int k, int* count) {
  *count = 0;
  if (bad_dims(r, c, dtype) || bad_cluster(r, ctas, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return clusters_fit<__nv_bfloat16>(r, c, ctas, k, count);
  if (dtype == 2) return clusters_fit<__half>(r, c, ctas, k, count);
  return clusters_fit<float>(r, c, ctas, k, count);
}

// The tiled route: `iters` (>= 1) sweeps from `a` in ceil(iters / k)
// launches of k sweeps (the last one the rest), between `out` and `tmp` in
// turns so that the last lands in `out`; tiles of tr x tc points with k
// halo rows and columns a side, whose two buffers must fit a CTA's shared
// memory, and `threads` (a multiple of 32, 32 to 512) a CTA.
extern "C" int jacobi2d_tiled_launch(const void* a, void* out, void* tmp,
                                     int r, int c, int dtype, int iters,
                                     int tr, int tc, int k, int threads,
                                     void* stream) {
  const size_t elem = dtype == 0 ? 4 : 2;
  if (bad_dims(r, c, dtype) || iters < 1 || tr < 1 || tc < 1 || k < 1 ||
      threads < 32 || threads > TILED_THREADS || threads % 32 ||
      tiled_bytes(tr, tc, k, elem) > (size_t)SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (iters + k - 1) / k;
  const void* src = a;
  for (int i = 0; i < n; ++i) {
    void* dst = (n - 1 - i) % 2 == 0 ? out : tmp;
    const int kb = i + 1 < n ? k : iters - (n - 1) * k;
    const int e = launch_tiled_typed(src, dst, r, c, dtype, tr, tc, k, kb,
                                     threads, st);
    if (e) return e;
    src = dst;
  }
  return 0;
}
