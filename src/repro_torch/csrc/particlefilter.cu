// Particle-filter find-index (the vfirst.m / vpopc.m pattern) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/particlefilter.py:31 (find_index,
// pallas_call at :36): for each query u_j, count(cdf < u_j) over all N
// entries, clamped to N-1.  The count is kept as a count, not turned into a
// binary search, so the result equals the reference on any CDF, monotone
// or not.
//
// Bound on an H100: operations.  M queries x N entries is 1e10 compares and
// 1e10 adds at Rodinia's 100,000 particles (0.30 ms at 67 TFLOP/s); the
// bytes (0.8 MB) are nothing.  Design: one query per thread, 256 threads a
// block; the block stages the CDF through shared memory in tiles of
// PF_TILE entries, read back as float4 broadcasts (every thread of a warp
// reads the same address), so a compare costs ~2 instructions: the compare
// and a float add.  The ragged end of the last tile is filled with +inf,
// which no query counts.  Per tile the four float partial counts are exact
// (at most PF_TILE ones each, far below 2^24) and go into an int count.
// Where the Pallas kernel carried the count across a sequential grid
// dimension, a loop inside the block walks the CDF.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PF_THREADS = 256;
constexpr int PF_TILE = 2048;   // CDF entries per shared tile (8 KB)

__global__ void __launch_bounds__(PF_THREADS)
find_index_kernel(const float* __restrict__ cdf, const float* __restrict__ u,
                  int32_t* __restrict__ out, long long n, long long m) {
  __shared__ __align__(16) float tile[PF_TILE];
  const long long j = (long long)blockIdx.x * PF_THREADS + threadIdx.x;
  const float q = j < m ? u[j] : 0.0f;
  long long count = 0;
  for (long long base = 0; base < n; base += PF_TILE) {
    for (int t = threadIdx.x; t < PF_TILE; t += PF_THREADS) {
      const long long k = base + t;
      tile[t] = k < n ? cdf[k] : INFINITY;   // +inf < q is false for every q
    }
    __syncthreads();
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll 8
    for (int t = 0; t < PF_TILE / 4; ++t) {
      const float4 c = t4[t];
      c0 += c.x < q ? 1.0f : 0.0f;
      c1 += c.y < q ? 1.0f : 0.0f;
      c2 += c.z < q ? 1.0f : 0.0f;
      c3 += c.w < q ? 1.0f : 0.0f;
    }
    count += (long long)c0 + (long long)c1 + (long long)c2 + (long long)c3;
    __syncthreads();
  }
  if (j < m) out[j] = (int32_t)(count < n - 1 ? count : n - 1);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int find_index_launch(const float* cdf, const float* u,
                                 int32_t* out, long long n, long long m,
                                 void* stream) {
  const long long blocks = (m + PF_THREADS - 1) / PF_THREADS;
  find_index_kernel<<<(unsigned)blocks, PF_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(cdf, u, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
