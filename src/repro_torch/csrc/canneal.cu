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
// next tile's block is in flight during this tile's gathers.  (One thread
// walking its row in device memory, as the row kernel does, asks for each
// warp load's 32 sectors, 4 F bytes apart, about F / 8 times over: 0.243
// against the tile kernel's 0.210 ms at PARSEC simlarge on an H100,
// scripts/canneal_variants.py.)
//
// The row kernel (swap_cost_rows_kernel), for wider rows, whose tiles do
// not fit a CTA's shared memory: one thread a swap reads its index row
// from device memory, grid-stride.
//
// Both walk a row eight slots at a time and issue all eight predicated
// gathers before any sum uses them (row_costs).  They sum a row in slot
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

// a location through L2 (cached in L2, not L1)
__device__ __forceinline__ float2 gather(const float2* p) { return __ldcg(p); }

// The costs of one swap, {to a, to c}, from its index row `row` of f slots
// (in shared or device memory): CHUNK slots at a time, every valid gather
// of a chunk in flight before any sum uses it, the sums in slot order.
__device__ __forceinline__ float2 row_costs(const int32_t* row, int f,
                                            const float2* __restrict__ locs,
                                            int n, float2 a, float2 c) {
  float sa = 0.0f, sb = 0.0f;
  for (int k0 = 0; k0 < f; k0 += CHUNK) {
    int idx[CHUNK];
    float2 p[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) idx[j] = k0 + j < f ? row[k0 + j] : -1;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      p[j] = make_float2(0.0f, 0.0f);
      if (idx[j] >= 0) p[j] = gather(locs + (idx[j] < n ? idx[j] : n - 1));
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (k0 + j < f) {
        const bool valid = idx[j] >= 0;
        const float da = fabsf(p[j].x - a.x) + fabsf(p[j].y - a.y);
        const float db = fabsf(p[j].x - c.x) + fabsf(p[j].y - c.y);
        sa += valid ? da : 0.0f;
        sb += valid ? db : 0.0f;
      }
    }
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

__global__ void swap_cost_rows_kernel(const float2* __restrict__ locs,
                                      const int32_t* __restrict__ fan,
                                      const float2* __restrict__ cand_a,
                                      const float2* __restrict__ cand_b,
                                      float* __restrict__ out_a,
                                      float* __restrict__ out_b, long long b,
                                      int f, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    const float2 s = row_costs(fan + i * f, f, locs, n, cand_a[i], cand_b[i]);
    out_a[i] = s.x;
    out_b[i] = s.y;
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

// The row kernel.  Launches on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int swap_cost_rows_launch(const float* locs, const int32_t* fan,
                                     const float* cand_a, const float* cand_b,
                                     float* out_a, float* out_b, long long b,
                                     int f, int n, void* stream) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  // enough resident warps on the 132 SMs to keep many gathers in flight
  if (blocks > 132 * 16) blocks = 132 * 16;
  swap_cost_rows_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(locs), fan,
      reinterpret_cast<const float2*>(cand_a),
      reinterpret_cast<const float2*>(cand_b), out_a, out_b, b, f, n);
  return static_cast<int>(cudaGetLastError());
}
