// Particle-filter find-index (the vfirst.m / vpopc.m pattern) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/particlefilter.py:31 (find_index,
// pallas_call at :36): for each query u_j, count(cdf < u_j) over all N
// entries, clamped to N-1.  That is the reference's function on every
// float32 input, and this file computes exactly it, by one of two paths
// chosen on the device:
//
// 1. check_monotone_kernel: a fixed grid of FLAG_SLOTS blocks tests
//    cdf[i] <= cdf[i+1] over slices of the N - 1 adjacent pairs (slices
//    overlap by one entry) and writes one int a block into its own slot
//    of a flag buffer: every slot on every call, so no memset and no
//    atomic.  A NaN anywhere fails the test.
// 2. find_index_kernel reads the slots (one warp, __all_sync).  Where all
//    pass, the CDF is non-decreasing, so cdf[i] < u holds for a prefix of
//    the entries and the count equals the lower bound, the first i with
//    !(cdf[i] < u): each thread searches for its query, the upper levels
//    in a sample of every STRIDE-th entry staged in shared memory (1,563
//    floats at N 100,000), the last ~6 levels in the window of STRIDE
//    entries the sample leaves, from L2.  Where any slot fails, the block
//    counts: each thread compares its query with every entry, the CDF
//    staged through shared memory in tiles of PF_TILE entries read back as
//    float4 broadcasts (~2 instructions a compare), the ragged end of the
//    last tile filled with +inf, which no query counts; per tile the four
//    float partial counts are exact (at most PF_TILE ones each, far below
//    2^24) and go into an int count.  Both paths clamp to N - 1, and a NaN
//    query counts 0 on both.
//
// Bound on an H100, what the input needs: on a non-decreasing CDF the
// bytes (the CDF read once, the queries read and the indices written,
// 1.2 MB at Rodinia's 100,000 particles, 0.36 us at 3.35 TB/s) against
// M * ceil(log2 N) compares (1.7 M, nothing); otherwise operations, M x N
// compares and adds (2e10, 0.30 ms at 67 TFLOP/s).  Where the Pallas
// kernel carried the count across a sequential grid dimension, the count
// path's loop inside the block walks the CDF.  The wrapper never reads
// the flags (that would synchronize); a caller reads them after a
// synchronize to see which path ran.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PF_THREADS = 256;
constexpr int PF_TILE = 2048;       // CDF entries per shared tile (8 KB)
constexpr int SAMPLE_MAX = 4096;    // sampled entries in shared memory
constexpr int MIN_STRIDE = 64;      // CDF entries between two samples
constexpr int MAX_SLOTS = 1024;     // flag slots: one check block each

__global__ void __launch_bounds__(PF_THREADS)
check_monotone_kernel(const float* __restrict__ cdf, int32_t* __restrict__ flags,
                      long long n) {
  const long long pairs = n > 1 ? n - 1 : 0;
  const long long per = (pairs + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < pairs ? lo + per : pairs;
  int ok = 1;
  for (long long i = lo + threadIdx.x; i < hi; i += PF_THREADS)
    ok &= cdf[i] <= cdf[i + 1];   // false for a NaN on either side
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) flags[blockIdx.x] = ok;
}

// count(cdf < q) over all n entries, through shared `tile` (PF_TILE floats).
__device__ __forceinline__ long long count_below(const float* __restrict__ cdf,
                                                 float* tile, float q,
                                                 long long n) {
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
  return count;
}

// The first i in [lo, hi) with !(a[i] < q), or hi: a[i] < q must hold for a
// prefix of [lo, hi).  Fixed steps, halving: no branch on the data.
template <typename Load>
__device__ __forceinline__ long long lower_bound(Load a, long long lo,
                                                 long long hi, float q) {
  long long step = 1;
  while (step * 2 <= hi - lo) step *= 2;
  for (; step > 0; step /= 2)
    if (lo + step <= hi && a(lo + step - 1) < q) lo += step;
  return lo;
}

__global__ void __launch_bounds__(PF_THREADS)
find_index_kernel(const float* __restrict__ cdf, const float* __restrict__ u,
                  const int32_t* __restrict__ flags, int slots,
                  int32_t* __restrict__ out, long long n, long long m) {
  __shared__ __align__(16) float buf[SAMPLE_MAX];   // the sample, or a tile
  __shared__ int searched;
  const long long j = (long long)blockIdx.x * PF_THREADS + threadIdx.x;
  const float q = j < m ? u[j] : 0.0f;
  // every stride-th entry, at most SAMPLE_MAX of them, loaded beside the
  // flags (one round trip for both; the count path overwrites them)
  long long stride = MIN_STRIDE;
  while ((n + stride - 1) / stride > SAMPLE_MAX) stride *= 2;
  const int ns = (int)((n + stride - 1) / stride);
  for (int s = threadIdx.x; s < ns; s += PF_THREADS) buf[s] = cdf[s * stride];
  if (threadIdx.x < 32) {   // the check kernel's flags, one warp
    int ok = 1;
    for (int s = threadIdx.x; s < slots; s += 32) ok &= flags[s] != 0;
    ok = __all_sync(0xffffffffu, ok);
    if (threadIdx.x == 0) searched = ok;
  }
  __syncthreads();
  long long count;
  if (searched) {
    // k entries of the sample are below q: cdf[(k - 1) stride] < q, and
    // cdf[k stride] >= q where it exists, so the count is in that window
    const long long k =
        lower_bound([&](long long i) { return buf[i]; }, 0, ns, q);
    count = k == 0 ? 0
                   : lower_bound([&](long long i) { return cdf[i]; },
                                 (k - 1) * stride + 1,
                                 k * stride < n ? k * stride : n, q);
  } else {
    count = count_below(cdf, buf, q, n);
  }
  if (j < m) out[j] = (int32_t)(count < n - 1 ? count : n - 1);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both kernels on `stream`, the check first; `flags` holds `slots` ints
// (1..MAX_SLOTS), every one written.  Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a slot count out of range.
extern "C" int find_index_launch(const float* cdf, const float* u,
                                 int32_t* out, int32_t* flags, int slots,
                                 long long n, long long m, void* stream) {
  if (slots < 1 || slots > MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  check_monotone_kernel<<<slots, PF_THREADS, 0, st>>>(cdf, flags, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (m + PF_THREADS - 1) / PF_THREADS;
  find_index_kernel<<<(unsigned)blocks, PF_THREADS, 0, st>>>(cdf, u, flags,
                                                            slots, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
