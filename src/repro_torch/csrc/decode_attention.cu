// Flash decoding (one query token against a KV cache) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:51
// (decode_attention, pallas_call at :57): for q [B, H, D] and a cache k, v
// [B, S, H, D], softmax(q k^T / sqrt(D)) v over the keys ki < kv_len[b],
// with an online softmax in float32.  q and the cache are each float32,
// bfloat16 or float16 (k and v of one type), widened as they are loaded, so
// a 16-bit cache moves half the bytes; the output has q's type.  Keys past
// kv_len are masked with the Pallas kernel's finite -1e30, so at
// kv_len <= 0 every key is masked alike and the result is the mean of V
// over all S positions (the reference's jnp oracle gives NaN there; the
// port follows the kernel).
//
// Bound on an H100: bytes.  The keys and values a batch needs are read
// once: min(kv_len, S) rows of K and V (only V, all S rows, at
// kv_len <= 0), D values each per head, against ~4 D flops a key.
//
// Design.  One 256-thread block per (b, h); its 8 warps take the keys
// round-robin, 8 at a time (16 from a 16-bit cache, 4 at D > 128), with
// all the row loads of a group (K and V) issued before the first is used.
// A lane holds D / 32 of the query, of a key row and of its accumulator, up
// to 8 elements at D 256 (elements lane + 32 e, or for a 16-bit cache the
// pairs 2 (lane + 32 e) and the next, read as 4 bytes: each load of a row
// is one contiguous 128-byte piece in float32 and in 16 bits); a warp
// reduces q.k with shuffles and keeps its own running max, sum and
// accumulator.  Keys past kv_len are not read
// (they would add exp(-1e30 - m) = 0); at kv_len <= 0, K is not read and
// every score is the same, so each key weighs 1.  The 8 warps' partial
// softmaxes are merged in shared memory: out = sum_w acc_w e^(m_w - M) /
// max(sum_w l_w e^(m_w - M), 1e-30), as the Pallas kernel's epilogue.
// Splitting one (b, h) across blocks with a combine pass (the Hopper
// split-KV design) is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;   // decode_attention.py:16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
// Elements d and d + 1 of a 16-bit row as one 4-byte load (d even, the
// row 4-byte aligned), widened exactly.
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load2(const __half* p, float& a, float& b) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  a = __ldg(p);
  b = __ldg(p + 1);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

// EPL: elements of a D-row per lane, D <= 32 * EPL; VEC: elements a lane
// loads at once (2: a 16-bit cache read 4 bytes a lane, so a warp's load
// of a row is one 128-byte piece), so the lane holds elements
// VEC (lane + 32 e2) + j; TQ: q's and the output's type; TC: the cache's
template <typename TQ, typename TC, int EPL, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
              const TC* __restrict__ v, const int32_t* __restrict__ lens,
              TQ* __restrict__ o, int S, int H, int D, float scale) {
  // keys a warp loads at once: 8, 16 from a 16-bit cache (half the bytes
  // a key, so as many bytes in flight), 4 at D > 128 (registers)
  constexpr int UNROLL = EPL > 4 ? 4 : sizeof(TC) == 2 ? 16 : 8;
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][32 * EPL];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long stride = (long long)H * D;
  const long long head = (long long)b * S * stride + (long long)h * D;
  const TC* kb = k + head;
  const TC* vb = v + head;

  // the D-index of this lane's element e
  auto dim = [&](int e) { return VEC * (lane + 32 * (e / VEC)) + e % VEC; };
  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = dim(e);
    qv[e] = d < D ? to_f(q[(long long)blockIdx.x * D + d]) : 0.0f;
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
      for (int e = 0; e < EPL; e += VEC) {
        const int d = dim(e);
        const bool in = valid && d < D;
        if constexpr (VEC == 2) {
          kr[u][e] = kr[u][e + 1] = vr[u][e] = vr[u][e + 1] = 0.0f;
          if (in && !all_masked) load2(kb + row + d, kr[u][e], kr[u][e + 1]);
          if (in) load2(vb + row + d, vr[u][e], vr[u][e + 1]);
        } else {
          kr[u][e] = (in && !all_masked) ? to_f(__ldg(kb + row + d)) : 0.0f;
          vr[u][e] = in ? to_f(__ldg(vb + row + d)) : 0.0f;
        }
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
  for (int e = 0; e < EPL; ++e) sm_acc[warp][dim(e)] = acc[e];
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
    store(o + (long long)blockIdx.x * D + d, a / denom);
  }
}

template <typename TQ, typename TC, int EPL, int VEC>
int launch(const void* q, const void* k, const void* v, const int32_t* lens,
           void* o, int B, int S, int H, int D, float scale,
           cudaStream_t stream) {
  decode_kernel<TQ, TC, EPL, VEC><<<(unsigned)(B * H), THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), lens, static_cast<TQ*>(o), S, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// float32 caches one element a load; 16-bit caches two where D is even and
// k and v are 4-byte aligned (each row then is too), else one
template <typename TQ, typename TC>
int by_width(const void* q, const void* k, const void* v, const int32_t* lens,
             void* o, int B, int S, int H, int D, float scale,
             cudaStream_t st) {
  const bool pairs = sizeof(TC) == 2 && D % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 4 == 0;
  if (pairs) {
    if (D <= 64)
      return launch<TQ, TC, 2, 2>(q, k, v, lens, o, B, S, H, D, scale, st);
    if (D <= 128)
      return launch<TQ, TC, 4, 2>(q, k, v, lens, o, B, S, H, D, scale, st);
    return launch<TQ, TC, 8, 2>(q, k, v, lens, o, B, S, H, D, scale, st);
  }
  if (D <= 32)
    return launch<TQ, TC, 1, 1>(q, k, v, lens, o, B, S, H, D, scale, st);
  if (D <= 64)
    return launch<TQ, TC, 2, 1>(q, k, v, lens, o, B, S, H, D, scale, st);
  if (D <= 128)
    return launch<TQ, TC, 4, 1>(q, k, v, lens, o, B, S, H, D, scale, st);
  return launch<TQ, TC, 8, 1>(q, k, v, lens, o, B, S, H, D, scale, st);
}

template <typename TQ>
int by_cache(const void* q, const void* k, const void* v, const int32_t* lens,
             void* o, int B, int S, int H, int D, float scale, int kv_type,
             cudaStream_t st) {
  if (kv_type == 1)
    return by_width<TQ, __nv_bfloat16>(q, k, v, lens, o, B, S, H, D, scale, st);
  if (kv_type == 2)
    return by_width<TQ, __half>(q, k, v, lens, o, B, S, H, D, scale, st);
  return by_width<TQ, float>(q, k, v, lens, o, B, S, H, D, scale, st);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o [b, h, d] of type `q_type`; k, v [b, s, h, d] of type `kv_type`
// (0 float32, 1 bfloat16, 2 float16); lens int32 [b]; all contiguous,
// 1 <= d <= 256.  Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a width or type it does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int32_t* lens,
                                       void* o, int b, int s, int h, int d,
                                       float scale, int q_type, int kv_type,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256 || q_type < 0 || q_type > 2 || kv_type < 0 ||
      kv_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_type == 1)
    return by_cache<__nv_bfloat16>(q, k, v, lens, o, b, s, h, d, scale,
                                   kv_type, st);
  if (q_type == 2)
    return by_cache<__half>(q, k, v, lens, o, b, s, h, d, scale, kv_type, st);
  return by_cache<float>(q, k, v, lens, o, b, s, h, d, scale, kv_type, st);
}
