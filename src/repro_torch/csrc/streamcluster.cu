// Streamcluster dist for Hopper (sm_90a), plain C interface: pairwise
// squared euclidean distances max(|p|^2 + |c|^2 - 2 p.c, 0), [M,D] x [N,D]
// -> [M,N] float32, inputs float32, bfloat16 or float16.
//
// Replaces the Pallas kernel repro/kernels/streamcluster.py:29
// (streamcluster_dist, pallas_call at :36), which put p.c on the TPU's
// matrix unit.  Bound on an H100: operations.  2*M*N*D multiply-adds
// (17.2 GFLOP at PARSEC simlarge's 16,384 points x 4,096 centers x 128
// dims: 0.26 ms at 67 TFLOP/s float32) against ~280 MB moved (0.08 ms).
// The tensor cores are not used: TF32 keeps ~3 decimal digits and misses
// the reference's 2e-4 bar, so this is a float32 SIMT product.
//
// Design: a row-norm pre-pass (one warp per row, into a scratch [M+N] buffer
// the wrapper allocates), then a tiled product whose epilogue forms the
// distance.  A 256-thread block owns a 128 x 128 output tile and walks D in
// steps of 16: each step stages the two [128,16] slices in shared memory
// k-major (the next step's slices are loaded into registers while this one is
// computed), and each thread accumulates an 8 x 8 sub-tile in registers from
// float4 reads of the staged slices.  bfloat16 and float16 inputs are widened
// to float32 as they are loaded; all sums are float32.  Ragged M, N and D are
// masked: out-of-range rows and columns load as 0 and are not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int PAD = 4;   // keeps the transposing shared stores ~conflict-free
constexpr int LOADS = BM * BK / THREADS;   // elements per thread per slice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__global__ void row_norms_kernel(const T* __restrict__ x,
                                 float* __restrict__ out, long long rows,
                                 int d) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // whole warps leave together
  const T* r = x + row * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) {
    const float v = to_f(r[k]);
    s += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// This thread's share of the [BM, BK] slice of P and the [BN, BK] slice of
// C at column k0, widened to float; 0 outside the matrices.
template <typename T>
__device__ __forceinline__ void load_slices(const T* __restrict__ P,
                                            const T* __restrict__ C,
                                            float (&ra)[LOADS],
                                            float (&rb)[LOADS], int tid,
                                            int m0, int n0, int k0, int M,
                                            int N, int D) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / BK, k = k0 + e % BK;
    ra[i] = (m0 + r < M && k < D) ? to_f(P[(long long)(m0 + r) * D + k])
                                  : 0.0f;
    rb[i] = (n0 + r < N && k < D) ? to_f(C[(long long)(n0 + r) * D + k])
                                  : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dist_kernel(const T* __restrict__ P, const T* __restrict__ C,
            const float* __restrict__ p2, const float* __restrict__ c2,
            float* __restrict__ out, int M, int N, int D) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;

  float ra[LOADS], rb[LOADS];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_slices(P, C, ra, rb, tid, m0, n0, 0, M, N, D);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * THREADS;
      As[e % BK][e / BK] = ra[i];
      Bs[e % BK][e / BK] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < D) load_slices(P, C, ra, rb, tid, m0, n0, k0 + BK, M, N, D);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  // sub-tile rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise
  const bool vec_ok = (N % 4) == 0;
  float cn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
    cn[j] = n < N ? c2[n] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    const float pm = p2[m];
    float* orow = out + (long long)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = fmaxf(pm + cn[h * 4 + j] - 2.0f * acc[i][h * 4 + j], 0.0f);
      if (vec_ok && n < N) {
        *reinterpret_cast<float4*>(orow + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) orow[n + j] = v[j];
      }
    }
  }
}

template <typename T>
int launch(const T* p, const T* c, float* norms, float* out, int m, int n,
           int d, cudaStream_t stream) {
  const int warps_per_block = 8;
  row_norms_kernel<T><<<(unsigned)((m + warps_per_block - 1) / warps_per_block),
                        32 * warps_per_block, 0, stream>>>(p, norms, m, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_norms_kernel<T><<<(unsigned)((n + warps_per_block - 1) / warps_per_block),
                        32 * warps_per_block, 0, stream>>>(c, norms + m, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  dist_kernel<T><<<(unsigned)tiles, THREADS, 0, stream>>>(
      p, c, norms, norms + m, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `norms` is scratch of m + n floats.  `dtype` selects the input type
// (0: float32, 1: bfloat16, 2: float16).  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int streamcluster_dist_launch(const void* p, const void* c,
                                         float* norms, float* out, int m,
                                         int n, int d, int dtype,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(p),
                  static_cast<const __nv_bfloat16*>(c), norms, out, m, n, d, s);
  if (dtype == 2)
    return launch(static_cast<const __half*>(p), static_cast<const __half*>(c),
                  norms, out, m, n, d, s);
  return launch(static_cast<const float*>(p), static_cast<const float*>(c),
                norms, out, m, n, d, s);
}
