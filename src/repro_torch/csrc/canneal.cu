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
// fit in a block's shared memory, so it is read through L2 (__ldcg: cached
// in L2, not L1, where it would evict the index rows that each thread walks
// F words of).  One thread per swap, grid-stride; the loads of a row are
// predicated rather than branched, so several gathers are in flight at
// once.  Indices >= N read row N-1, as the reference's gather clamps.
// Integer-valued coordinates keep every sum exact in float32, whatever the
// order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void swap_cost_kernel(const float2* __restrict__ locs,
                                 const int32_t* __restrict__ fan,
                                 const float2* __restrict__ cand_a,
                                 const float2* __restrict__ cand_b,
                                 float* __restrict__ out_a,
                                 float* __restrict__ out_b, long long b,
                                 int f, int n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < b;
       i += stride) {
    const float2 a = cand_a[i], c = cand_b[i];
    const int32_t* row = fan + i * f;
    float sa = 0.0f, sb = 0.0f;
#pragma unroll 4
    for (int k = 0; k < f; ++k) {
      const int idx = row[k];
      const bool valid = idx >= 0;
      float2 p = make_float2(0.0f, 0.0f);
      if (valid) p = __ldcg(locs + (idx < n ? idx : n - 1));
      const float da = fabsf(p.x - a.x) + fabsf(p.y - a.y);
      const float db = fabsf(p.x - c.x) + fabsf(p.y - c.y);
      sa += valid ? da : 0.0f;
      sb += valid ? db : 0.0f;
    }
    out_a[i] = sa;
    out_b[i] = sb;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int swap_cost_launch(const float* locs, const int32_t* fan,
                                const float* cand_a, const float* cand_b,
                                float* out_a, float* out_b, long long b, int f,
                                int n, void* stream) {
  const int threads = 256;
  long long blocks = (b + threads - 1) / threads;
  // enough resident warps on the 132 SMs to keep many gathers in flight
  if (blocks > 132 * 16) blocks = 132 * 16;
  swap_cost_kernel<<<(unsigned)blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(locs), fan,
      reinterpret_cast<const float2*>(cand_a),
      reinterpret_cast<const float2*>(cand_b), out_a, out_b, b, f, n);
  return static_cast<int>(cudaGetLastError());
}
