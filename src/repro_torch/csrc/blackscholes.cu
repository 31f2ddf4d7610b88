// Black-Scholes option pricing for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/blackscholes.py:38 (pallas_call at
// :45).  One option per thread per grid-stride iteration; inputs and output
// are read and written once, coalesced.  Bound on an H100: device-memory
// bandwidth (28 B per option; 183.5 MB at 6,553,600 options = 55 us at
// 3.35 TB/s), far above the ~100 float ops per option.
//
// Built without --use_fast_math: erff/logf/expf/sqrtf are the accurate
// library versions, as the reference's 3e-5 tolerance requires.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float cndf(float x) {
  return 0.5f * (1.0f + erff(x / 1.4142135623730951f));
}

__global__ void blackscholes_kernel(const float* __restrict__ spot,
                                    const float* __restrict__ strike,
                                    const float* __restrict__ rate,
                                    const float* __restrict__ vol,
                                    const float* __restrict__ time,
                                    const int32_t* __restrict__ is_call,
                                    float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = spot[i], k = strike[i], r = rate[i], v = vol[i],
                t = time[i];
    const float sqrt_t = sqrtf(t);
    const float d1 = (logf(s / k) + (r + 0.5f * v * v) * t) / (v * sqrt_t);
    const float d2 = d1 - v * sqrt_t;
    const float disc = k * expf(-r * t);
    const float call = s * cndf(d1) - disc * cndf(d2);
    const float put = disc * cndf(-d2) - s * cndf(-d1);
    out[i] = is_call[i] != 0 ? call : put;
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int blackscholes_launch(const float* spot, const float* strike,
                                   const float* rate, const float* vol,
                                   const float* time, const int32_t* is_call,
                                   float* out, long long n, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // a few waves over the 132 SMs; the grid-stride loop covers the rest
  if (blocks > 132 * 16) blocks = 132 * 16;
  blackscholes_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      spot, strike, rate, vol, time, is_call, out, n);
  return static_cast<int>(cudaGetLastError());
}
