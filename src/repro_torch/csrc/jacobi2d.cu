// Jacobi-2D, one 5-point sweep, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/jacobi2d.py:32 (jacobi2d_step,
// pallas_call at :45): every interior point of a float32 [R, C] grid
// becomes 0.2 * (center + left + right + up + down); the boundary rows and
// columns keep their values.  The Pallas wrapper materialised overlapping
// halo strips (a[idx]) and needed (R - 2) % rows_per_block == 0; here each
// thread reads its four neighbours straight from the input (the block's
// rows share them through L1) and writes a fresh output, for any R and C.
//
// Bound on an H100: bytes.  Each point is read once and written once
// (8 B a point: 62.7 MB, 18.7 us, on PolyBench EXTRALARGE's 2,800 x 2,800
// grid) against 5 float operations a point.  Design: a 32 x 8 thread block
// covers 32 columns x 32 rows.  A thread owns four rows of one column and
// loads the six rows around them once, so every up/down neighbour is its
// own load; a warp's loads are 128-byte row segments.
//
// Built with -fmad=false and summed in the plain version's order
// (((((c + l) + r) + u) + d) * 0.2f, repro_torch/kernels/ref.py:jacobi2d):
// the sweep equals its plain version bit for bit.  A bfloat16 grid is
// widened as it is loaded, summed in float32 in the same order and rounded
// once, on the store (as the plain version does); a held point is copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8, ROWS = 4;   // a block: 32 cols x 32 rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
jacobi2d_kernel(const T* __restrict__ a, T* __restrict__ out, int R, int C) {
  const int c = blockIdx.x * TX + threadIdx.x;
  const int r0 = (blockIdx.y * TY + threadIdx.y) * ROWS;
  if (c >= C) return;
  // rows r0 - 1 .. r0 + ROWS of this column, as far as they exist
  float col[ROWS + 2];
#pragma unroll
  for (int i = 0; i < ROWS + 2; ++i) {
    const int r = r0 - 1 + i;
    col[i] = (r >= 0 && r < R) ? to_f(__ldg(a + (long long)r * C + c)) : 0.0f;
  }
  const bool edge_col = (c == 0 || c == C - 1);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    if (r >= R) break;
    const long long at = (long long)r * C + c;
    if (!edge_col && r > 0 && r < R - 1) {
      const float left = to_f(__ldg(a + at - 1));
      const float right = to_f(__ldg(a + at + 1));
      store(out + at,
            0.2f * ((((col[i + 1] + left) + right) + col[i]) + col[i + 2]));
    } else {
      out[at] = a[at];
    }
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One sweep of the [r, c] grid `a` into `out` (distinct buffers), float32
// (`is_bf16` 0) or bfloat16 (1).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int jacobi2d_launch(const void* a, void* out, int r, int c,
                               int is_bf16, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((unsigned)((c + TX - 1) / TX),
                  (unsigned)((r + TY * ROWS - 1) / (TY * ROWS)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    jacobi2d_kernel<<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(out),
        r, c);
  else
    jacobi2d_kernel<<<grid, block, 0, st>>>(static_cast<const float*>(a),
                                            static_cast<float*>(out), r, c);
  return static_cast<int>(cudaGetLastError());
}
