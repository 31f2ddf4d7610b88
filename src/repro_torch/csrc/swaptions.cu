// Swaptions CumNormalInv (Moro 1995 inverse normal CDF) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel repro/kernels/swaptions.py:42 (cum_normal_inv,
// pallas_call at :47).  One uniform per thread per grid-stride iteration,
// read and written once, coalesced; the tail is masked, so any N works (the
// Pallas kernel needed N % block == 0).  Bound on an H100: device-memory
// bandwidth (8 B per element; 337.9 MB at PARSEC simlarge's 42,240,000
// uniforms = 101 us at 3.35 TB/s), far above the ~40 float ops per element.
//
// Arithmetic follows repro_torch/kernels/ref.py:cum_normal_inv term by term:
// the constants are the reference's doubles rounded once to float, logf and
// the division are the accurate (IEEE) versions, no --use_fast_math, and the
// build passes -fmad=false so no a*b+c is contracted into one rounding.

#include <cuda_runtime.h>

namespace {

#define F(x) static_cast<float>(x)

__global__ void cum_normal_inv_kernel(const float* __restrict__ u,
                                      float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ui = u[i];
    const float x = ui - 0.5f;
    const float r = x * x;
    const float num =
        x * (F(2.50662823884) +
             r * (F(-18.61500062529) +
                  r * (F(41.39119773534) + r * F(-25.44106049637))));
    const float den =
        1.0f + r * (F(-8.47351093090) +
                    r * (F(23.08336743743) +
                         r * (F(-21.06224101826) + r * F(3.13082909833))));
    const float central = num / den;
    float rr = x > 0.0f ? 1.0f - ui : ui;
    // clamp to [1e-12, 0.5]; a NaN fails both tests and passes through, as
    // in torch.clamp
    if (rr < F(1e-12)) rr = F(1e-12);
    if (rr > 0.5f) rr = 0.5f;
    const float z = logf(-logf(rr));
    float tail = F(0.0000003960315187);
    tail = F(0.0000002888167364) + z * tail;
    tail = F(0.0000321767881768) + z * tail;
    tail = F(0.0003951896511919) + z * tail;
    tail = F(0.0038405729373609) + z * tail;
    tail = F(0.0276438810333863) + z * tail;
    tail = F(0.1607979714918209) + z * tail;
    tail = F(0.9761690190917186) + z * tail;
    tail = F(0.3374754822726147) + z * tail;
    tail = x > 0.0f ? tail : -tail;
    out[i] = fabsf(x) < F(0.42) ? central : tail;
  }
}

#undef F

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cum_normal_inv_launch(const float* u, float* out, long long n,
                                     void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  // a few waves over the 132 SMs; the grid-stride loop covers the rest
  if (blocks > 132 * 16) blocks = 132 * 16;
  cum_normal_inv_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(u, out, n);
  return static_cast<int>(cudaGetLastError());
}
