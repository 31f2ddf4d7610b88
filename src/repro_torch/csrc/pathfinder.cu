// Pathfinder (Rodinia), the row-by-row dynamic program, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/pathfinder.py:43 (pathfinder,
// pallas_call at :46), which kept the running cost row in VMEM across a
// sequential grid of one step per wall row: cost = wall[0], then for every
// later row cost = wall[i] + min(cost, cost shifted left, cost shifted
// right), the ends treated as +inf; the result is the last cost row, float32
// [C], from an int32 or float32 wall [R, C].
//
// Bound on an H100: bytes.  The wall is read once (642 MB at 1,604 rows x
// 100,000 columns of int32: 0.19 ms) against 3 operations a cell.  The rows
// are a sequential dependency, and blocks cannot wait for each other, so
// the design is Rodinia's ghost-zone pyramid: a block of 256 threads owns
// a strip of 256 columns and advances PYRAMID rows in shared memory with
// one __syncthreads per row.  After h rows only the columns at least h from
// the strip's ends are right, so strips overlap by PYRAMID on each side and
// each writes its middle 256 - 2 * PYRAMID columns; one launch advances
// PYRAMID rows (ceil((R - 1) / PYRAMID) launches, all from one call).  Each
// thread loads its PYRAMID wall values before the first row, so a block
// keeps 20 loads a thread in flight.  Columns outside [0, C) hold +inf.
//
// min is exact and each row adds once, so the result equals the plain
// version (repro_torch/kernels/ref.py:pathfinder) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;      // columns (threads) per block
constexpr int PYRAMID = 20;    // rows per launch (Rodinia's pyramid_height)
constexpr int STRIDE = TILE - 2 * PYRAMID;   // columns a block writes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int32_t v) { return (float)v; }

// torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Rows row0 .. row0 + nrows - 1 (nrows <= PYRAMID) over the cost row `in`
// into `out`; `in` == nullptr starts from wall row 0.
template <typename W>
__global__ void __launch_bounds__(TILE)
pathfinder_kernel(const W* __restrict__ wall, const float* __restrict__ in,
                  float* __restrict__ out, long long row0, int nrows, int C) {
  __shared__ float buf[2][TILE];
  const int t = threadIdx.x;
  const long long col = (long long)blockIdx.x * STRIDE - PYRAMID + t;
  const bool live = col >= 0 && col < C;
  float w[PYRAMID];
#pragma unroll
  for (int i = 0; i < PYRAMID; ++i)
    w[i] = (live && i < nrows) ? to_f(wall[(row0 + i) * C + col]) : 0.0f;
  float v = INFINITY;
  if (live) v = in ? in[col] : to_f(wall[col]);
  buf[0][t] = v;
#pragma unroll
  for (int i = 0; i < PYRAMID; ++i) {
    if (i >= nrows) break;   // nrows is the same for the whole block
    __syncthreads();
    const float* cur = buf[i & 1];
    const float left = t > 0 ? cur[t - 1] : INFINITY;
    const float right = t < TILE - 1 ? cur[t + 1] : INFINITY;
    v = live ? w[i] + tmin(v, tmin(left, right)) : INFINITY;
    buf[(i + 1) & 1][t] = v;
  }
  if (live && t >= PYRAMID && t < TILE - PYRAMID) out[col] = v;
}

long long steps(long long r) {
  return r > 1 ? (r - 1 + PYRAMID - 1) / PYRAMID : 1;
}

template <typename W>
int launch(const W* wall, float* out, float* scratch, long long r, int c,
           cudaStream_t stream) {
  const long long n = steps(r);
  const unsigned blocks = (unsigned)((c + STRIDE - 1) / STRIDE);
  const float* in = nullptr;
  for (long long s = 0; s < n; ++s) {
    const long long row0 = 1 + s * PYRAMID;
    const long long left = r - row0;
    const int nrows = (int)(left < PYRAMID ? (left > 0 ? left : 0) : PYRAMID);
    // the last launch writes `out`
    float* dst = ((n - 1 - s) % 2 == 0) ? out : scratch;
    pathfinder_kernel<W><<<blocks, TILE, 0, stream>>>(wall, in, dst, row0,
                                                      nrows, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = dst;
  }
  return 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of kernel launches pathfinder_launch makes for r rows.
extern "C" long long pathfinder_launches(long long r) { return steps(r); }

// The last cost row of the [r, c] wall (int32 if `is_int`, else float32)
// into `out` [c]; `scratch` is a second [c] float buffer.  Launches on
// `stream`; returns cudaGetLastError() of the first failed launch (0 on
// success).
extern "C" int pathfinder_launch(const void* wall, int is_int, float* out,
                                 float* scratch, long long r, int c,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch(static_cast<const int32_t*>(wall), out, scratch, r, c, s);
  return launch(static_cast<const float*>(wall), out, scratch, r, c, s);
}
