// Flash decoding (one query token against a KV cache) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:51
// (decode_attention, pallas_call at :57): for q [B, H, D] and a float32
// cache k, v [B, S, H, D], softmax(q k^T / sqrt(D)) v over the keys
// ki < kv_len[b], with an online softmax in float32.  Keys past kv_len are
// masked with the Pallas kernel's finite -1e30, so at kv_len <= 0 every key
// is masked alike and the result is the mean of V over all S positions
// (the reference's jnp oracle gives NaN there; the port follows the
// kernel).
//
// Bound on an H100: bytes.  The keys and values a batch needs are read
// once: min(kv_len, S) rows of K and V (only V, all S rows, at
// kv_len <= 0), D float32 each per head, against ~4 D flops a key.
//
// Design.  One 256-thread block per (b, h); its 8 warps take the keys
// round-robin, 8 at a time, with all 16 row loads of a group (8 K, 8 V)
// issued before the first is used.  A lane holds D / 32 of the query, of a
// key row and of its accumulator (elements lane + 32 e: each load of a row
// is one 128-byte transaction); a warp reduces q.k with shuffles and keeps
// its own running max, sum and accumulator.  Keys past kv_len are not read
// (they would add exp(-1e30 - m) = 0); at kv_len <= 0, K is not read and
// every score is the same, so each key weighs 1.  The 8 warps' partial
// softmaxes are merged in shared memory: out = sum_w acc_w e^(m_w - M) /
// max(sum_w l_w e^(m_w - M), 1e-30), as the Pallas kernel's epilogue.
// Splitting one (b, h) across blocks with a combine pass (the Hopper
// split-KV design) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS, UNROLL = 8;
constexpr float NEG_INF = -1e30f;   // decode_attention.py:16

template <int EPL>   // elements of a D-row per lane: D <= 32 * EPL
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int32_t* __restrict__ lens,
              float* __restrict__ o, int S, int H, int D, float scale) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][32 * EPL];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long stride = (long long)H * D;
  const long long head = (long long)b * S * stride + (long long)h * D;
  const float* kb = k + head;
  const float* vb = v + head;

  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    qv[e] = d < D ? q[(long long)blockIdx.x * D + d] : 0.0f;
  }
  const int len = lens[b];
  const bool all_masked = len <= 0;
  const int n = all_masked ? S : min(len, S);

  float m = NEG_INF, l = 0.0f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;

  for (int base = warp * UNROLL; base < n; base += WARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = base + u < n;
      const long long row = (long long)(base + u) * stride;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        const bool in = valid && d < D;
        kr[u][e] = (in && !all_masked) ? __ldg(kb + row + d) : 0.0f;
        vr[u][e] = in ? __ldg(vb + row + d) : 0.0f;
      }
    }
    float s[UNROLL];
    float mt = NEG_INF;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qv[e] * kr[u][e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      // key base + u < n always holds for u == 0, so mt is finite
      s[u] = base + u < n ? (all_masked ? 0.0f : dot * scale) : -INFINITY;
      mt = fmaxf(mt, s[u]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += p * vr[u][e];
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  float M = NEG_INF;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.0f;
  float wt[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = expf(sm_m[w] - M);   // 0 for a warp that saw no key
    L += sm_l[w] * wt[w];
  }
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_acc[w][d] * wt[w];
    o[(long long)blockIdx.x * D + d] = a / denom;
  }
}

template <int EPL>
int launch(const float* q, const float* k, const float* v,
           const int32_t* lens, float* o, int B, int S, int H, int D,
           float scale, cudaStream_t stream) {
  decode_kernel<EPL><<<(unsigned)(B * H), THREADS, 0, stream>>>(
      q, k, v, lens, o, S, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o [b, h, d]; k, v [b, s, h, d]; lens int32 [b]; all float32,
// contiguous, d <= 128.  Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int decode_attention_launch(const float* q, const float* k,
                                       const float* v, const int32_t* lens,
                                       float* o, int b, int s, int h, int d,
                                       float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<1>(q, k, v, lens, o, b, s, h, d, scale, st);
  if (d <= 64) return launch<2>(q, k, v, lens, o, b, s, h, d, scale, st);
  return launch<4>(q, k, v, lens, o, b, s, h, d, scale, st);
}
