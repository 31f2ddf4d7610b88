// Flash attention, forward, on the FMA pipes (SIMT), for Hopper (sm_90a),
// plain C interface: float32 past head width 256, the one case the
// tensor-core kernels do not take.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:65
// (flash_attention, pallas_call at :75) where csrc/flash_attention.cu does
// not reach: its 3xTF32 kernel holds tiles of at most 256 float32 columns
// (64 query rows of 256 columns, Q, K and V padded, take 200 KB; 512
// columns would not fit 227 KB), while its wgmma kernels take every
// 16-bit width.  Its entry point takes float32 at any width; the wrapper
// (kernels/flash_attention.py:path) sends it float32 past 256 only.
// softmax(q k^T / sqrt(D)) v over q, k, v [B, S, H, D], causal or not, with
// an online softmax over key tiles so the [S, S] scores never reach device
// memory.  Inputs, sums and output float32.
//
// Bound on an H100: operations, 4 * D flops (q.k and p.v) per (query, key)
// pair the mask keeps.  This is a float32 SIMT kernel, the design the port
// first ran at D <= 128 (before the tensor-core redesign), held against
// the 67 TFLOP/s float32 peak.
//
// Design.  One 256-thread block per (b * H + h, 64-query tile, slice of
// 256 output columns), walking the 64-key tiles in order; causal blocks
// stop at the diagonal tile (the tiles wholly above it are skipped, as the
// Pallas kernel does) and the query tiles with the most key tiles are
// launched first.  The layout is read in place: a row of one head is D
// contiguous values, rows H * D apart.  Q, K and V tiles sit in shared
// memory row-major with a 4-float pad (float4 reads, no bank conflicts),
// 256 columns wide (DM), zero past D (217 KB of shared memory a block).  A
// head wider than 256 is cut into output slices of 256 columns, one block
// each (grid z): each block forms the scores over all of D, 256 columns of
// Q and K at a time (Q reloaded for each), and P V for its own slice of V,
// as the SSD scan's P-slices share the work of a wide head.  A thread owns
// 4 query rows x 4 keys of the score tile (keys tx + 16 j, so the float4
// reads of K rows hit distinct banks) and the same 4 rows x DM / 16
// columns of the output accumulator, so the running max m, the sum l and
// the rescale stay in its registers; a row's 16 threads share a half-warp
// and reduce with shuffles.  The probabilities go through shared memory to
// the P V product.  Masked scores are the Pallas kernel's finite -1e30, a
// ragged last tile (any S) is masked the same way, and the output is acc /
// max(l, 1e-30) as there (flash_attention.py:58-61).

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int LP = BK + 4;           // row stride of the P tile
constexpr float NEG_INF = -1e30f;    // flash_attention.py:17

template <int DM>
constexpr int smem_bytes() {
  return (BQ * (DM + 4) + 2 * BK * (DM + 4) + BQ * LP) * (int)sizeof(float);
}

// Rows [r0, r0 + n) of one head (rows `stride` apart, D values each) into a
// [n][DM + 4] shared tile; rows past S and columns past D are 0.
template <int DM, int N>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S, int D,
                                          long long stride) {
#pragma unroll 4
  for (int e = threadIdx.x; e < N * DM; e += THREADS) {
    const int r = e / DM, d = e % DM;
    dst[r * (DM + 4) + d] = (r0 + r < S && d < D)
                                ? src[(long long)(r0 + r) * stride + d]
                                : 0.0f;
  }
}

template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int D, float scale, int causal) {
  constexpr int LD = DM + 4;
  constexpr int NC = DM / 64;    // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long stride = (long long)H * D;
  const long long head = (long long)b * S * stride + (long long)h * D;
  const int n_dc = (D + DM - 1) / DM;        // DM-column chunks of D
  const int c0 = blockIdx.z * DM;            // this block's output slice
  const int dv = min(DM, D - c0);            // its columns

  if (n_dc == 1) load_tile<DM, BQ>(Qs, q + head, q0, S, D, stride);

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's P V is done with Ks, Vs, Ps
    load_tile<DM, BK>(Vs, v + head + c0, k0, S, dv, stride);

    // scores of rows ty*4 + i against keys tx + 16 j, over D's chunks
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = dc * DM, dd = min(DM, D - d0);
      if (dc > 0) __syncthreads();   // the last chunk's scores are done
      if (n_dc > 1)
        load_tile<DM, BQ>(Qs, q + head + d0, q0, S, dd, stride);
      load_tile<DM, BK>(Ks, k + head + d0, k0, S, dd, stride);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DM; d += 4) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] =
              *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kb[j] =
              *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] += qa[i].x * kb[j].x + qa[i].y * kb[j].y +
                       qa[i].z * kb[j].z + qa[i].w * kb[j].w;
      }
    }

    // online softmax over this tile; a row's 16 threads are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, columns g * 64 + tx * 4 + {0..3}
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x
                          : u == 1 ? pa[i].y
                          : u == 2 ? pa[i].z : pa[i].w;
            acc[i][g * 4 + 0] += p * vv.x;
            acc[i][g * 4 + 1] += p * vv.y;
            acc[i][g * 4 + 2] += p * vv.z;
            acc[i][g * 4 + 3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + head + c0 + (long long)row * stride;
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < dv) orow[d] = acc[i][g * 4 + c] / denom;
      }
  }
}

template <int DM>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H),
                  (unsigned)((D + DM - 1) / DM));
  flash_fwd_kernel<DM><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, S, H, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o contiguous float32 [b, s, h, d] (d >= 1), `dtype` 0 (the
// flash_attention_launch code of float32, the one type it takes); `scale`
// multiplies the scores.  Launches on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a width or type it does
// not take.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int s, int h, int d, float scale,
                                           int causal, int dtype,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || b * h > 65535 || (d + 255) / 256 > 65535 || dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<256>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o), b,
                     s, h, d, scale, causal, st);
}
