// Segment sums in a fixed order for Hopper (sm_90a), plain C interface:
// the embedding table's gradient (models/layers.py, embed_fwd's backward).
//
// Replaces no Pallas kernel.  The reference takes this gradient by
// autodiff of a gather (a scatter-add); on the card the port's scatter-add
// (index_add_ / index_put_ with accumulate) adds by atomics in an order
// that changes from run to run, so two training steps from the same state
// differed in their last bits.  Here out[r] = the rows[order[j]] whose
// sorted key keys[j] is r, summed in float32 in a fixed order and rounded
// once to the table's type; every row of the table, touched or not, is
// written once.  The host sorts the indices with a stable sort, so `order`
// lists each key's positions in position order.
//
// The order, two-level: a run of equal keys of at most `chunk` positions
// is summed directly, in position order from 0.0 (the bits of adding the
// rows one by one); a longer run is cut into chunks of `chunk` positions
// from its start, each summed in position order from 0.0, and the chunks'
// sums are added in chunk order from 0.0.  Two launches:
//   (1) chunk_kernel: a block a (window of `chunk` sorted positions, kind)
//       and 256 x 8 columns.  A window holds at most two chunk starts of
//       long runs: kind 0 the one of the run covering its first position
//       (a run that started before it), kind 1 the start of the run
//       covering its last position (a run that starts inside it); so a
//       chunk starting at sorted position p goes to partial slot 2 (p /
//       chunk) + (p is its run's start), and the buffer is 2 ceil(N /
//       chunk) rows;
//   (2) write_kernel: a block 16 output rows and 256 x 8 columns; 17
//       threads find the rows' run bounds by binary search in the sorted
//       keys, then each row is written once with 16-byte stores: zeros, a
//       short run's sum, or a long run's chunk sums.
// A hot token (a Zipf batch's first token, ~2,300 of 8,192 positions) is
// ~36 chunks summed by ~36 blocks at once: no block walks it alone.
//
// Bound on an H100: bytes, the gradient's rows read once and the whole
// table written once (qwen2.5-3b: 8,192 rows x 2,048 bf16 read, 151,936 x
// 2,048 bf16 written, 0.66 GB, 0.20 ms at 3.35 TB/s): the table's one
// write pass is the bound's own bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;     // output rows a block of the write pass
constexpr int UNROLL = 8;    // positions (or chunks) loaded at once

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

// V consecutive elements at p widened to float: V 8 by 16-byte loads
// (32 bytes for float32), V 1 one element.
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float* x) {
  if constexpr (V == 1) {
    x[0] = widen(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = widen(e[i]);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_v(T* p, const float* x) {
  if constexpr (V == 1) {
    *p = narrow<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = narrow<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The first j in [0, n) with keys[j] >= v (n if none).
__device__ __forceinline__ int lower_bound(const int* keys, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// acc += rows[order[j]][c .. c + V) for j in [j0, j1), in j's order.
// UNROLL positions' index loads, then their rows' loads, all in flight
// before the adds (a position past j1 reloads row j1 - 1 and is not added)
template <int V, typename TI>
__device__ __forceinline__ void run_sum(const TI* __restrict__ rows,
                                        const long long* __restrict__ order,
                                        int j0, int j1, int D, int c,
                                        float* acc) {
  for (int j = j0; j < j1; j += UNROLL) {
    long long at[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) at[q] = order[min(j + q, j1 - 1)] * D;
    float x[UNROLL][V];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) load_v<V>(rows + at[q] + c, x[q]);
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
      if (j + q < j1) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] += x[q][u];
      }
  }
}

// This thread's first column, clamped into the row so that every load is
// unconditional (the stores skip the clamped ones).
template <int V>
__device__ __forceinline__ int column(int D, bool* valid) {
  const int c = (blockIdx.y * THREADS + threadIdx.x) * V;
  *valid = c < D;
  return min(c, D - V);
}

template <int V, typename TI>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const TI* __restrict__ rows, const long long* __restrict__ order,
             const int* __restrict__ keys, float* __restrict__ partial,
             int N, int D, int chunk) {
  const int w = blockIdx.x >> 1, kind = blockIdx.x & 1;
  const int lo = w * chunk, hi = min(lo + chunk, N);
  const int key = keys[kind == 0 ? lo : hi - 1];
  const int s = lower_bound(keys, N, key), e = lower_bound(keys, N, key + 1);
  if (e - s <= chunk) return;                    // a short run
  if ((kind == 0) != (s < lo)) return;           // the other kind's
  const int p = kind == 0 ? s + (lo - s + chunk - 1) / chunk * chunk : s;
  if (p >= min(hi, e)) return;                   // no chunk starts here
  bool valid;
  const int c = column<V>(D, &valid);
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.0f;
  run_sum<V>(rows, order, p, min(p + chunk, e), D, c, acc);
  if (valid)
    store_v<V>(partial + (long long)(2 * w + kind) * D + c, acc);
}

template <int V, typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
write_kernel(const TI* __restrict__ rows, const long long* __restrict__ order,
             const int* __restrict__ keys, const float* __restrict__ partial,
             TO* __restrict__ out, int N, int D, int R, int chunk) {
  __shared__ int bound[ROWS + 1];
  const int r0 = blockIdx.x * ROWS;
  if (threadIdx.x <= ROWS)
    bound[threadIdx.x] = lower_bound(keys, N, min(r0 + (int)threadIdx.x, R));
  __syncthreads();
  bool valid;
  const int c = column<V>(D, &valid);
  if (!valid) return;
  for (int i = 0; i < ROWS && r0 + i < R; ++i) {
    const int s = bound[i], e = bound[i + 1];
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.0f;
    if (e - s <= chunk) {
      run_sum<V>(rows, order, s, e, D, c, acc);   // none: zeros
    } else {
      // the chunk sums in chunk order: chunk k starts at s + k chunk, in
      // slot 2 (p / chunk) + (k == 0)
      const int n = (e - s + chunk - 1) / chunk;
      for (int k = 0; k < n; k += UNROLL) {
        float x[UNROLL][V];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int kq = min(k + q, n - 1), p = s + kq * chunk;
          load_v<V>(partial + (long long)(2 * (p / chunk) + (kq == 0)) * D + c,
                    x[q]);
        }
#pragma unroll
        for (int q = 0; q < UNROLL; ++q)
          if (k + q < n) {
#pragma unroll
            for (int u = 0; u < V; ++u) acc[u] += x[q][u];
          }
      }
    }
    store_v<V>(out + (long long)(r0 + i) * D + c, acc);
  }
}

template <int V, typename TI>
int launch_in(const void* rows, const long long* order, const int* keys,
              float* partial, void* out, int otype, int N, int D, int R,
              int chunk, cudaStream_t st) {
  const auto* in = static_cast<const TI*>(rows);
  const unsigned stripes = (D + THREADS * V - 1) / (THREADS * V);
  const dim3 chunks(2 * ((N + chunk - 1) / chunk), stripes);
  chunk_kernel<V, TI><<<chunks, THREADS, 0, st>>>(in, order, keys, partial,
                                                  N, D, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 grid((R + ROWS - 1) / ROWS, stripes);
  switch (otype) {
    case 0:
      write_kernel<V, TI, float><<<grid, THREADS, 0, st>>>(
          in, order, keys, partial, static_cast<float*>(out), N, D, R, chunk);
      break;
    case 1:
      write_kernel<V, TI, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
          in, order, keys, partial, static_cast<__nv_bfloat16*>(out), N, D, R,
          chunk);
      break;
    default:
      write_kernel<V, TI, __half><<<grid, THREADS, 0, st>>>(
          in, order, keys, partial, static_cast<__half*>(out), N, D, R,
          chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_v(const void* rows, int itype, const long long* order,
             const int* keys, float* partial, void* out, int otype, int N,
             int D, int R, int chunk, cudaStream_t st) {
  switch (itype) {
    case 0:
      return launch_in<V, float>(rows, order, keys, partial, out, otype, N, D,
                                 R, chunk, st);
    case 1:
      return launch_in<V, __nv_bfloat16>(rows, order, keys, partial, out,
                                         otype, N, D, R, chunk, st);
    default:
      return launch_in<V, __half>(rows, order, keys, partial, out, otype, N,
                                  D, R, chunk, st);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows [N, D] of `itype`, out [R, D] of `otype` (0 float32, 1 bfloat16, 2
// float16), both contiguous; `keys` [N] int32 the indices sorted (each in
// [0, R)), `order` [N] int64 the positions they came from (a stable sort);
// `partial` float32 scratch of 2 * ceil(N / chunk) * D floats.  Writes
// every row of out: the sum of rows[order[j]] over the j with keys[j] = r,
// in the two-level order above (chunk >= 1).  Vector loads and stores
// where D % 8 == 0 and rows, partial and out are 16-byte aligned, else one
// element a thread.  Launches two kernels on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a type
// code or size it does not take.
extern "C" int segment_sum_launch(const void* rows, int itype,
                                  const long long* order, const int* keys,
                                  float* partial, void* out, int otype,
                                  long long N, int D, long long R, int chunk,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (itype < 0 || itype > 2 || otype < 0 || otype > 2 || D < 1 || N < 1 ||
      R < 1 || chunk < 1 || N > 0x7fffffffll || R > 0x7fffffffll - ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(rows) |
                                  reinterpret_cast<uintptr_t>(partial) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_v<8>(rows, itype, order, keys, partial, out, otype,
                           (int)N, D, (int)R, chunk, st)
             : launch_v<1>(rows, itype, order, keys, partial, out, otype,
                           (int)N, D, (int)R, chunk, st);
}
