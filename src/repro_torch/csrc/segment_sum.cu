// Segment sums in a fixed order for Hopper (sm_90a), plain C interface:
// the embedding table's gradient (models/layers.py, embed_fwd's backward).
//
// Replaces no Pallas kernel.  The reference takes this gradient by
// autodiff of a gather (a scatter-add); on the card the port's scatter-add
// (index_add_ / index_put_ with accumulate) adds by atomics in an order
// that changes from run to run, so two training steps from the same state
// differed in their last bits.  Here each row of the output that an index
// points at is written once: out[r] = the rows[order[j]] whose sorted key
// keys[j] is r, summed in j's order in float32 and rounded once to the
// table's type.  The host sorts the indices with a stable sort, so `order`
// is each index's positions in position order, and zero-fills `out`
// first; the sum is the same bits on every run.
//
// Bound on an H100: bytes, the gradient's rows read once and the whole
// table written once (qwen2.5-3b: 8,192 rows x 2,048 bf16 read, 151,936 x
// 2,048 bf16 written, 0.66 GB, 0.20 ms at 3.35 TB/s), most of it the
// host's zero fill.  One block a sorted position and 512 columns: a block
// whose position does not start a run of equal keys exits at once, so
// only the ~U distinct tokens' blocks work, and no block waits for empty
// rows.  A run is walked with 16 positions' loads in flight before their
// adds (which follow in position order), every load unconditional (with
// the loads under the guards, each position waited for its own, 0.8 us a
// position): a token seen ~2,300 times in a Zipf batch is the longest
// walk, ~150 steps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;      // columns a thread sums (THREADS apart)
constexpr int UNROLL = 16;   // positions loaded at once

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half(x);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const TI* __restrict__ rows,
                   const long long* __restrict__ order,
                   const long long* __restrict__ keys,
                   const long long* __restrict__ ends, TO* __restrict__ out,
                   int D) {
  const long long j0 = blockIdx.x;
  if (j0 > 0 && keys[j0] == keys[j0 - 1]) return;   // not a run's start
  const long long j1 = ends[j0];
  // this thread's columns, clamped into the row so that every load below
  // is unconditional (the stores skip the clamped ones)
  const int c0 = blockIdx.y * (THREADS * COLS) + threadIdx.x;
  int cols[COLS];
#pragma unroll
  for (int u = 0; u < COLS; ++u) cols[u] = min(c0 + u * THREADS, D - 1);
  float acc[COLS];
#pragma unroll
  for (int u = 0; u < COLS; ++u) acc[u] = 0.0f;
  // UNROLL positions' index loads, then their rows' loads, all in flight
  // before the adds, which follow in position order (a position past the
  // run reloads the run's last row and is not added; the guards are the
  // same for the whole block)
  for (long long j = j0; j < j1; j += UNROLL) {
    long long at[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) at[q] = order[min(j + q, j1 - 1)] * D;
    float x[UNROLL][COLS];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
#pragma unroll
      for (int u = 0; u < COLS; ++u) x[q][u] = widen(rows[at[q] + cols[u]]);
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
      if (j + q < j1) {
#pragma unroll
        for (int u = 0; u < COLS; ++u) acc[u] += x[q][u];
      }
  }
  TO* orow = out + keys[j0] * D;
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    const int c = c0 + u * THREADS;
    if (c < D) orow[c] = narrow<TO>(acc[u]);
  }
}

template <typename TI>
int launch_out(const void* rows, const long long* order,
               const long long* keys, const long long* ends, void* out,
               int otype, long long N, int D, cudaStream_t st) {
  const auto* in = static_cast<const TI*>(rows);
  const dim3 grid((unsigned)N, (D + THREADS * COLS - 1) / (THREADS * COLS));
  switch (otype) {
    case 0:
      segment_sum_kernel<TI, float><<<grid, THREADS, 0, st>>>(
          in, order, keys, ends, static_cast<float*>(out), D);
      break;
    case 1:
      segment_sum_kernel<TI, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
          in, order, keys, ends, static_cast<__nv_bfloat16*>(out), D);
      break;
    default:
      segment_sum_kernel<TI, __half><<<grid, THREADS, 0, st>>>(
          in, order, keys, ends, static_cast<__half*>(out), D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [N, D] of `itype`, out [R, D] of `otype` (0 float32, 1 bfloat16, 2
// float16), both contiguous, out zero-filled; `keys` [N] int64 the indices
// sorted (each in [0, R)), `order` [N] int64 the positions they came from
// (a stable sort), `ends` [N] int64 the end of each key's run (searchsorted
// right): out[keys[j]] = the sum of rows[order[i]] over the run starting
// at j, in i's order.  Launches on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a type code or size it does
// not take.
extern "C" int segment_sum_launch(const void* rows, int itype,
                                  const long long* order,
                                  const long long* keys,
                                  const long long* ends, void* out,
                                  int otype, long long N, int D,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itype < 0 || itype > 2 || otype < 0 || otype > 2 || D < 1 || N < 0 ||
      N > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  switch (itype) {
    case 0:
      return launch_out<float>(rows, order, keys, ends, out, otype, N, D, st);
    case 1:
      return launch_out<__nv_bfloat16>(rows, order, keys, ends, out, otype, N,
                                       D, st);
    default:
      return launch_out<__half>(rows, order, keys, ends, out, otype, N, D,
                                st);
  }
}
