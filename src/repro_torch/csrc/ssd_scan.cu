// Mamba-2 SSD chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:56 (ssd_scan,
// pallas_call at :66): for x [b, S, H, P], dt [b, S, H], A [H] and
// B, C [b, S, N], the selective-state-space recurrence
//     state_t = exp(dt_t A) state_{t-1} + dt_t x_t (x) B_t,  y_t = state_t C_t
// in its chunked (state-space dual) form: within a tile, the causal block
// (C B^T o exp(seg_t - seg_u)) (x dt) with seg the running sum of dt A, plus
// the carried state's term exp(seg_t) C_t . state; across tiles, the state
// update exp(seg_end) state + sum_u exp(seg_end - seg_u) B_u (x) (x dt)_u.
// Every input is float32 inside (x may be float32, bfloat16 or float16, the
// rest come widened to float32); y is written in x's type.  D-skip and gating
// stay outside, as in the Pallas kernel.
//
// Bound on an H100: operations.  The chunked form's count falls with the
// chunk length, to the recurrence's ~4 P N flops a step per head; at the
// suite's size (b 8, S 65,536, H 16, P 64, N 128) that is ~276 G flops,
// ~4.1 ms at the float32 peak, against ~4.9 GB moved once, ~1.5 ms.  This
// kernel does ~482 G (below), ~7.2 ms at the peak.
//
// Design.  One 256-thread block per (b, h, P-slice) walks the sequence in
// order, in tiles of L = 64 steps, with the head's state [P, N] in shared
// memory in float32 for the whole walk.  The result depends on the chunk length
// only through rounding, so the block uses its own tile length: a 256-step W
// block alone would take 256 KB of shared memory.  Per tile: the running sum
// of dt A (two warp scans), x dt, and B and C transposed to [N][L + 1] (the
// padding keeps the transposing stores and the reads off bank conflicts),
// each thread issuing 16 loads of a batch before it stores any (loads one
// at a time left the block waiting on ~50 round trips a tile);
// then W = (C B^T) o exp(seg_t - seg_u), formed only for u <= t, so the
// exponent is never positive and nothing overflows (the Pallas kernel
// exponentiates the whole difference and masks after, which a CUDA product
// of inf and 0 would turn into NaN); then y = W (x dt) + exp(seg_t) C state
// and last the state update.  Each product keeps a 4 x PJ register tile per
// thread (rows ty + 16 i, columns tx + 16 j), so a warp reads 16 consecutive
// floats and two broadcast ones per step, and the inner loops are unrolled
// four times so a warp keeps several steps' reads in flight.  (Contiguous
// 4 x 4 tiles read as float4, and the next tile's loads held in registers
// through the products, both measured slower on the H100: the second
// spills.)  C B^T is
// recomputed for every head (H times the least work; 2 L^2 N flops of
// every tile's ~3.7 M at the suite's size: C B^T 2 L^2 N on the full
// 64 x 64 square, W (x dt) 2 L^2 P, C state and the state update 2 L P N
// each).  Steps past S are zero (dt = 0,
// x = 0, B = C = 0), which leaves the state and the running sum unchanged.
// Each p column of the state (state[n][p]) is independent of the others, so
// a head wider than MAX_PS = 128 is split into ceil(P / 128) slices of
// equal width, one block each (C B^T is formed once a slice); a slice of at
// most 128 columns keeps a thread's tile at 4 x 8.
// A head-group block sharing C B^T, or a chunk-parallel pass with a
// sequential state pass and tensor-core products, is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int L = 64;        // steps per tile
constexpr int LP = L + 1;    // padded row of the transposed B, C and of W
constexpr int ROWS = 4;      // rows of a thread's register tile (t or n)
constexpr int LOADS = 16;    // global loads a thread keeps in flight
constexpr int MAX_PS = 128;  // columns of the state a block holds

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// The width of one block's P-slice: P split into ceil(P / MAX_PS) equal
// slices.
inline int slice_width(int P) {
  const int n = (P + MAX_PS - 1) / MAX_PS;
  return (P + n - 1) / n;
}

// Shared-memory floats of one block holding P columns of the state: state
// [N][P], x dt [L][P], B^T and C^T [N][LP], W [L][LP], and four [L] vectors
// (running sum, dt, exp(seg), exp(seg_end - seg)).
__host__ __device__ inline long long smem_floats(int P, int N) {
  return (long long)N * P + (long long)L * P + 2LL * N * LP +
         (long long)L * LP + 4LL * L;
}

// columns of a thread's tile: a slice of PS <= 16 * PJ columns of the head's
// Ptot; this block's slice starts at column PS * blockIdx.y
template <typename T, int PJ>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, T* __restrict__ y, int S, int H,
           int Ptot, int PS, int N) {
  const int p0 = PS * blockIdx.y;
  const int P = min(PS, Ptot - p0);   // this block's columns
  extern __shared__ float smem[];
  float* st = smem;                      // [N][P]
  float* xs = st + (long long)N * P;     // [L][P]
  float* bt = xs + L * P;                // [N][LP]
  float* ct = bt + N * LP;               // [N][LP]
  float* w = ct + N * LP;                // [L][LP]
  float* seg = w + L * LP;               // [L]
  float* dts = seg + L;                  // [L]
  float* edec = dts + L;                 // [L] exp(seg_t)
  float* sdec = edec + L;                // [L] exp(seg_end - seg_u)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float Ah = A[h];

  for (int i = tid; i < N * P; i += THREADS) st[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nt = min(L, S - t0);
    const long long row0 = (long long)b * S + t0;   // (b, t0) in [b, S]

    // ---- running sum of dt A over the tile: two warp scans -------------
    if (tid < L) {
      const float d = tid < nt ? dt[(row0 + tid) * H + h] : 0.0f;
      float a = d * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, a, o);
        if ((tid & 31) >= o) a += v;
      }
      seg[tid] = a;
      dts[tid] = d;
    }
    __syncthreads();
    if (tid >= 32 && tid < L) seg[tid] += seg[31];
    __syncthreads();
    if (tid < L) {
      edec[tid] = expf(seg[tid]);
      sdec[tid] = expf(seg[L - 1] - seg[tid]);
    }
    // ---- x dt [L][P] and B^T, C^T [N][LP]: a batch's loads all in flight
    // before its first store (the loads are latency bound, not bytes bound)
    for (int base = 0; base < L * P; base += THREADS * LOADS) {
      float r[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid, t = i / P;
        r[k] = i < L * P && t < nt
                   ? to_f(x[((row0 + t) * H + h) * Ptot + p0 + i % P])
                   : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid;
        if (i < L * P) xs[i] = r[k] * dts[i / P];
      }
    }
    for (int base = 0; base < L * N; base += THREADS * LOADS) {
      float rb[LOADS], rc[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid, t = i / N;
        const bool in = i < L * N && t < nt;
        const long long g = (row0 + t) * N + i % N;
        rb[k] = in ? Bm[g] : 0.0f;
        rc[k] = in ? Cm[g] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid, t = i / N, n = i % N;
        if (i < L * N) {
          bt[n * LP + t] = rb[k];
          ct[n * LP + t] = rc[k];
        }
      }
    }
    __syncthreads();

    // ---- W[t][u] = (C_t . B_u) exp(seg_t - seg_u) for u <= t, else 0 ----
    {
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[ROWS], bv[4];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) cv[i] = ct[n * LP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bt[n * LP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          w[t * LP + u] = u <= t ? acc[i][j] * expf(seg[t] - seg[u]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- y[t][p] = sum_u W[t][u] xd[u][p] + exp(seg_t) sum_n C[t][n] st[n][p]
    {
      float yi[ROWS][PJ], ys[ROWS][PJ];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yi[i][j] = ys[i][j] = 0.0f;
#pragma unroll 4
      for (int u = 0; u < L; ++u) {
        float wv[ROWS], xv[PJ];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) wv[i] = w[(ty + 16 * i) * LP + u];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? xs[u * P + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yi[i][j] += wv[i] * xv[j];
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[ROWS], sv[PJ];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) cv[i] = ct[n * LP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? st[n * P + p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) ys[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int t = ty + 16 * i;
        if (t >= nt) continue;
        T* yrow = y + ((row0 + t) * H + h) * Ptot + p0;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = from_f<T>(yi[i][j] + edec[t] * ys[i][j]);
        }
      }
    }
    __syncthreads();   // the state is read above and rewritten below
    // B^T is not read again by this tile's products: scale it in place by
    // exp(seg_end - seg_u) for the state update
    for (int i = tid; i < N * L; i += THREADS) {
      const int n = i / L, u = i % L;
      bt[n * LP + u] *= sdec[u];
    }
    __syncthreads();

    // ---- st[n][p] = exp(seg_end) st[n][p]
    //                  + sum_u exp(seg_end - seg_u) B[u][n] xd[u][p] -------
    {
      const float etot = expf(seg[L - 1]);
      for (int n0 = 0; n0 < N; n0 += 16 * ROWS) {
        float acc[ROWS][PJ];
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
        for (int u = 0; u < L; ++u) {
          float bv[ROWS], xv[PJ];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int n = n0 + ty + 16 * i;
            bv[i] = n < N ? bt[n * LP + u] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? xs[u * P + p] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] += bv[i] * xv[j];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int n = n0 + ty + 16 * i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tx + 16 * j;
            if (p < P) st[n * P + p] = etot * st[n * P + p] + acc[i][j];
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites xs, bt, ct and reads st
  }
}

template <typename T, int PJ>
int launch_t(const void* x, const float* dt, const float* A, const float* B,
             const float* C, void* y, int batch, int S, int H, int P, int N,
             cudaStream_t stream) {
  auto kern = ssd_kernel<T, PJ>;
  const int PS = slice_width(P);
  const size_t bytes = sizeof(float) * (size_t)smem_floats(PS, N);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)(batch * H), (unsigned)((P + PS - 1) / PS));
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(x), dt, A, B,
                                         C, static_cast<T*>(y), S, H, P, PS,
                                         N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* A, const float* B,
             const float* C, void* y, int batch, int S, int H, int P, int N,
             cudaStream_t stream) {
  const int PS = slice_width(P);
  if (PS <= 16)
    return launch_t<T, 1>(x, dt, A, B, C, y, batch, S, H, P, N, stream);
  if (PS <= 32)
    return launch_t<T, 2>(x, dt, A, B, C, y, batch, S, H, P, N, stream);
  if (PS <= 64)
    return launch_t<T, 4>(x, dt, A, B, C, y, batch, S, H, P, N, stream);
  return launch_t<T, 8>(x, dt, A, B, C, y, batch, S, H, P, N, stream);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory one block takes at (P, N): its P-slice's.
extern "C" long long ssd_scan_smem_bytes(int P, int N) {
  return (long long)sizeof(float) * smem_floats(slice_width(P), N);
}

// x and y: float32 (dtype 0), bfloat16 (1) or float16 (2); the rest float32.
// Any P >= 1, in slices of <= 128 columns.  Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const float* B, const float* C, void* y,
                               int batch, int S, int H, int P, int N,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, A, B, C, y, batch, S, H, P, N, s);
  if (dtype == 2)
    return launch_p<__half>(x, dt, A, B, C, y, batch, S, H, P, N, s);
  return launch_p<float>(x, dt, A, B, C, y, batch, S, H, P, N, s);
}
