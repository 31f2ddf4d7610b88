// Canneal swap_cost for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/canneal.py:34 (swap_cost,
// pallas_call at :41): for each of B candidate swaps, the manhattan
// distance of its F fan-in locations (index < 0 is padding) to two
// candidate locations, summed over the valid entries.
//
// Bound on an H100: device-memory bandwidth for the bytes the function
// must move (the [B,F] index table, the two [B,2] candidates, the two [B]
// outputs and the [N,2] location table once: ~218 MB at PARSEC simlarge,
// 65 us at 3.35 TB/s).  The gathers make it worse: each valid entry pulls a
// 32-byte sector for 8 useful bytes.  The TPU kernel pinned the whole
// location table in VMEM; here the 400,000-entry table (3.2 MB) does not
// fit in a block's shared memory, so it is read through L2 (__ldcg).
//
// The tile kernel (swap_cost_tiles_kernel), for rows of up to MAX_F slots:
// persistent CTAs of TILE threads take tiles of TILE swaps, one swap a
// thread.  A tile's [TILE, F] index block is contiguous, so it comes into
// shared memory coalesced, by 16-byte cp.async (4-byte copies for the
// words before the first 16-byte boundary and after the last; the block
// lands at the same offset mod 16 in shared memory), double-buffered: the
// next tile's block is in flight during this tile's gathers.
//
// The row kernel (swap_cost_rows_kernel), for wider rows, whose tiles do
// not fit a CTA's shared memory: the same persistent CTAs of TILE swaps,
// but a tile's rows come into shared memory in chunks of ROW_CHUNK slots,
// a [TILE, ROW_CHUNK] block of strided row segments at a time, by 16-byte
// cp.async with 4-byte copies at each segment's unaligned head and tail
// (a segment lands at its own offset mod 16); each thread carries its
// swap's sums across the chunks.  So no width needs a case of its own and
// no thread reads its row from device memory.  (The kernel it replaced
// did: one thread walking its row there asks for each warp load's 32
// sectors, 4 F bytes apart, about F / 8 times over; 0.0425 ms of device
// time on the main path's 65,536 rows of 128 slots, 0.2504 on simlarge's
// 22, where the tile kernel took 0.2065; scripts/canneal_variants.py,
// which keeps it to time beside this one as `rows-parent`; NVIDIA H100
// 80GB HBM3, 700 W.)
//
// Both walk a row eight slots at a time and issue all eight predicated
// gathers before any sum uses them (costs8).  They sum a row in slot
// order (k = 0 .. F-1), take an index < 0 anywhere in the row as padding
// and read row N-1 for an index >= N, as the reference's gather clamps.
// Integer-valued coordinates keep every sum exact in float32, whatever the
// order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;    // swaps a tile, one a thread
constexpr int MAX_F = 96;    // widest row a tile kernel takes
constexpr int CHUNK = 8;     // gathers in flight a thread
constexpr int ROW_CHUNK = 32;             // slots a stage of the row kernel
constexpr int ROW_PITCH = ROW_CHUNK + 4;  // words a staged row

// a location through L2 (cached in L2, not L1)
__device__ __forceinline__ float2 gather(const float2* p) { return __ldcg(p); }

// Eight slots of one swap's row, `idx` (the first `cnt` of them in the
// row): every valid gather in flight before any sum uses it, then the
// sums, {to a, to c}, in slot order.  An index < 0 is padding, one >= n
// reads location n - 1.  Eight slots of padding add nothing: a sum starts
// at +0 and adds values >= +0 (or NaN), so adding +0 keeps its bits.
__device__ __forceinline__ void costs8(const int (&idx)[CHUNK], int cnt,
                                       const float2* __restrict__ locs,
                                       int n, float2 a, float2 c, float& sa,
                                       float& sb) {
  int top = -1;
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    if (j < cnt) top = max(top, idx[j]);
  if (top < 0) return;
  float2 p[CHUNK];
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    p[j] = make_float2(0.0f, 0.0f);
    if (j < cnt && idx[j] >= 0)
      p[j] = gather(locs + (idx[j] < n ? idx[j] : n - 1));
  }
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (j < cnt) {
      const bool valid = idx[j] >= 0;
      const float da = fabsf(p[j].x - a.x) + fabsf(p[j].y - a.y);
      const float db = fabsf(p[j].x - c.x) + fabsf(p[j].y - c.y);
      sa += valid ? da : 0.0f;
      sb += valid ? db : 0.0f;
    }
  }
}

// The costs of one swap, {to a, to c}, from its index row `row` of f slots
// in shared memory, CHUNK slots at a time.
__device__ __forceinline__ float2 row_costs(const int32_t* row, int f,
                                            const float2* __restrict__ locs,
                                            int n, float2 a, float2 c) {
  float sa = 0.0f, sb = 0.0f;
  for (int k0 = 0; k0 < f; k0 += CHUNK) {
    int idx[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) idx[j] = k0 + j < f ? row[k0 + j] : -1;
    costs8(idx, f - k0, locs, n, a, c, sa, sb);
  }
  return make_float2(sa, sb);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The words of a tile's index block, and the most a buffer holds: the
// block and up to 3 words ahead of it, to put it at its offset mod 16.
__host__ __device__ __forceinline__ int tile_words(int f) {
  return (TILE * f + 3 + 3) / 4 * 4;
}

// Tile `tile`'s index rows into `dst` (a buffer of tile_words(f) words):
// word i of the block at dst[m + i], m = the block's word offset mod 4.
__device__ __forceinline__ void stage(int32_t* dst,
                                      const int32_t* __restrict__ fan,
                                      long long tile, long long b, int f) {
  const long long first = tile * TILE;
  const long long left = b - first;
  const int nw = (int)(left < TILE ? left : TILE) * f;
  const int32_t* src = fan + first * f;
  const int m = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  int32_t* d = dst + m;
  const int head = ((4 - m) & 3) < nw ? ((4 - m) & 3) : nw;
  const int body = (nw - head) / 4;
  for (int i = threadIdx.x; i < head; i += TILE) cp_async4(d + i, src + i);
  for (int i = threadIdx.x; i < body; i += TILE)
    cp_async16(d + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < nw; i += TILE)
    cp_async4(d + i, src + i);
}

__global__ void __launch_bounds__(TILE)
swap_cost_tiles_kernel(const float2* __restrict__ locs,
                       const int32_t* __restrict__ fan,
                       const float2* __restrict__ cand_a,
                       const float2* __restrict__ cand_b,
                       float* __restrict__ out_a, float* __restrict__ out_b,
                       long long b, int f, int n) {
  extern __shared__ __align__(16) int32_t sidx[];
  const int words = tile_words(f);
  const long long tiles = (b + TILE - 1) / TILE;
  const int t = threadIdx.x;
  long long tile = blockIdx.x;
  int buf = 0;
  if (tile < tiles) stage(sidx, fan, tile, b, f);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) stage(sidx + (buf ^ 1) * words, fan, next, b, f);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" :::
                     "memory");
    __syncthreads();   // this tile's block is in shared memory
    const long long i = tile * TILE + t;
    if (i < b) {
      const int32_t* row =
          sidx + buf * words +
          ((reinterpret_cast<uintptr_t>(fan + tile * TILE * f) >> 2) & 3) +
          t * f;
      const float2 s = row_costs(row, f, locs, n, cand_a[i], cand_b[i]);
      out_a[i] = s.x;
      out_b[i] = s.y;
    }
    __syncthreads();   // every row is read before the buffer is refilled
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The word offset mod 4 of a pointer into the index table.
__device__ __forceinline__ int word_mod4(const int32_t* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Slots [c0, c0 + len) (len <= ROW_CHUNK) of the index rows first ..
// first + rows - 1 into `dst`, row r at dst[r ROW_PITCH + m_r + j], m_r
// its words' offset mod 4: ROW_CHUNK / 4 threads a row, each a 16-byte
// copy and at most one word of the row's unaligned head and tail.  A
// thread's rows are TILE / (ROW_CHUNK / 4) apart, a multiple of 4 rows,
// so they share one m_r.
__device__ __forceinline__ void stage_rows(int32_t* dst,
                                           const int32_t* __restrict__ fan,
                                           long long first, int rows, int f,
                                           int c0, int len) {
  constexpr int NQ = ROW_CHUNK / 4;   // threads a row
  constexpr int STRIDE = TILE / NQ;   // rows between a thread's rows
  const int q = threadIdx.x % NQ;
  int r = threadIdx.x / NQ;
  const int32_t* src = fan + (first + r) * f + c0;
  const int m = word_mod4(src);
  const int head = ((4 - m) & 3) < len ? ((4 - m) & 3) : len;
  const int body = (len - head) / 4;
  const int tail = len - head - 4 * body;
  int32_t* d = dst + r * ROW_PITCH + m;
  for (; r < rows; r += STRIDE, src += (long long)STRIDE * f,
                   d += STRIDE * ROW_PITCH) {
    if (q < body) cp_async16(d + head + 4 * q, src + head + 4 * q);
    if (q < head) cp_async4(d + q, src + q);
    if (q < tail)
      cp_async4(d + head + 4 * body + q, src + head + 4 * body + q);
  }
}

// Persistent CTAs of TILE threads take tiles of TILE swaps in turn, and
// walk each tile's index rows ROW_CHUNK slots at a time: a chunk's
// [TILE, ROW_CHUNK] block comes into shared memory by cp.async
// (stage_rows), then every thread sums its row's slots of it (a tile of
// f = 0 is one empty chunk: zeros).  Thread t carries its swap's two sums
// across its row's chunks.  It reads its chunk as aligned 16-byte quads
// (rows ROW_PITCH words apart: a quarter warp's quads fall on distinct
// banks) and picks its words by the row's offset mod 4.  One stage, no
// ring: copies in flight from the summing warps hold back their shared
// reads (a ring of two, the next chunk's copies issued before this one's
// sums, measured slower at every width; scripts/canneal_variants.py), and
// 36 KB a CTA leaves room for more CTAs an SM to overlap one another.
__global__ void __launch_bounds__(TILE)
swap_cost_rows_kernel(const float2* __restrict__ locs,
                      const int32_t* __restrict__ fan,
                      const float2* __restrict__ cand_a,
                      const float2* __restrict__ cand_b,
                      float* __restrict__ out_a, float* __restrict__ out_b,
                      long long b, int f, int n, int chunks) {
  __shared__ __align__(16) int32_t block[TILE * ROW_PITCH];
  const long long tiles = (b + TILE - 1) / TILE;
  const int t = threadIdx.x;
  float sa = 0.0f, sb = 0.0f;
  float2 a = make_float2(0.0f, 0.0f), c = a;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long first = tile * TILE;
    const long long left = b - first;
    const long long i = first + t;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int c0 = chunk * ROW_CHUNK;
      const int len = f - c0 < ROW_CHUNK ? f - c0 : ROW_CHUNK;
      stage_rows(block, fan, first, (int)(left < TILE ? left : TILE), f, c0,
                 len);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" :::
                       "memory");
      __syncthreads();   // the chunk's block is in shared memory
      // the row's words' offset mod 4 (the same in every chunk); a warp
      // whose rows all start on 16 bytes reads its words as they stand
      const int m = word_mod4(fan + i * f + c0);
      const bool flat = __all_sync(0xffffffffu, m == 0);
      if (i < b) {
        if (chunk == 0) {
          sa = sb = 0.0f;
          a = cand_a[i];
          c = cand_b[i];
        }
        const int32_t* row = block + t * ROW_PITCH;
        for (int s = 0; s < len; s += CHUNK) {
          // slots s .. s + 7 are words m + s .. m + s + 7 of the row: its
          // quads s / 4 .. s / 4 + 2 (the first two where m is 0)
          int w[12], idx[CHUNK];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            if (q == 2 && flat) break;
            const int4 v = *reinterpret_cast<const int4*>(row + s + 4 * q);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
          }
          if (flat) {
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) idx[j] = w[j];
          } else {
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
              const int lo = m & 1 ? w[j + 1] : w[j];
              const int hi = m & 1 ? w[j + 3] : w[j + 2];
              idx[j] = m & 2 ? hi : lo;
            }
          }
          costs8(idx, len - s, locs, n, a, c, sa, sb);
        }
        if (chunk == chunks - 1) {
          out_a[i] = sa;
          out_b[i] = sb;
        }
      }
      __syncthreads();   // every row is read before the next chunk comes in
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile kernel: persistent CTAs, as many as the card holds at once (at
// most one a tile).  Launches on `stream`; returns the first CUDA error (0
// on success).
extern "C" int swap_cost_tiles_launch(const float* locs, const int32_t* fan,
                                      const float* cand_a,
                                      const float* cand_b, float* out_a,
                                      float* out_b, long long b, int f, int n,
                                      void* stream) {
  if (f < 1 || f > MAX_F) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * (size_t)tile_words(f) * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      swap_cost_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, swap_cost_tiles_kernel, TILE, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  const long long tiles = (b + TILE - 1) / TILE;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  swap_cost_tiles_kernel<<<(unsigned)blocks, TILE, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(locs), fan,
      reinterpret_cast<const float2*>(cand_a),
      reinterpret_cast<const float2*>(cand_b), out_a, out_b, b, f, n);
  return static_cast<int>(cudaGetLastError());
}

// The row kernel's CTAs the current device holds at once, into *ctas; 0
// or a CUDA error code.
extern "C" int swap_cost_rows_fit(int* ctas) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, swap_cost_rows_kernel, TILE, 0)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  *ctas = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

// The row kernel, any f, on the host's plan
// (repro_torch/kernels/canneal.py:rows_plan): tiles of `tile` swaps, rows
// staged `chunk` slots at a time in `chunks` stages (one empty stage where
// f = 0), held here to the kernel's TILE and ROW_CHUNK; `ctas` persistent
// CTAs at most (at most one a tile; swap_cost_rows_fit's count), launched
// on `stream`.  Returns cudaErrorInvalidValue for a plan that does not
// fit, else cudaGetLastError() (0 on success).
extern "C" int swap_cost_rows_launch(const float* locs, const int32_t* fan,
                                     const float* cand_a, const float* cand_b,
                                     float* out_a, float* out_b, long long b,
                                     int f, int n, int tile, int chunk,
                                     int chunks, int ctas, void* stream) {
  if (f < 0 || ctas < 1 || tile != TILE || chunk != ROW_CHUNK ||
      chunks != (f > 0 ? (f + ROW_CHUNK - 1) / ROW_CHUNK : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (b + TILE - 1) / TILE;
  const long long blocks = ctas < tiles ? ctas : tiles;
  swap_cost_rows_kernel<<<(unsigned)blocks, TILE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(locs), fan,
      reinterpret_cast<const float2*>(cand_a),
      reinterpret_cast<const float2*>(cand_b), out_a, out_b, b, f, n,
      chunks);
  return static_cast<int>(cudaGetLastError());
}
