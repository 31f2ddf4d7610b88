// Flash decoding (one query token against a KV cache) for Hopper (sm_90a),
// plain C interface: split-KV, then a combine pass.
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
// Design (split-KV).  The keys of each batch entry are cut into splits of
// `len` positions (the wrapper picks it from S, B, the head groups and the
// SM count, so that the grid fills the card at any shape); one 256-thread
// block takes one (split, b, head group).  A key position's rows of all
// the group's heads are one contiguous run of HG * D values, which the
// block reads as such: thread (kl, hh, j) holds NV vectors of VEC elements
// (16 bytes where D % VEC == 0 and the cache is 16-byte aligned, else one
// element) of head hh, columns (i * TPH + j) * VEC + e, and the block's
// KPAR = 256 / (HG * TPH) key lanes kl take the split's keys round-robin,
// UNROLL keys a thread with all their K and V loads issued before the
// first is used.  q.k is reduced over a head's TPH lanes with shuffles,
// and each thread keeps its own running max, sum and accumulator.  The key
// lanes are merged in shared memory in a fixed order and the split writes
// its partial (m, l, acc[D]) per head to a float32 workspace.  A split
// that starts at or past kv_len writes the neutral (m = -1e30, l = 0, sums
// 0) and exits; keys past kv_len are never read, nor is K at kv_len <= 0 (every
// score is the mask's -1e30 there, so each key weighs 1).
//
// The combine kernel (a warp per (b, h)) merges its splits below kv_len in
// split order, the Pallas kernel's epilogue: out = sum_s acc_s e^(m_s - M) / max(sum_s
// l_s e^(m_s - M), 1e-30), so the result has the same bits every call (no
// atomics).  Heads wider than 512 are cut into pieces of 512 columns: each
// block forms q.k over all the pieces and accumulates P V for one piece of
// V, a slice of the output columns (grid z).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_E = 16;            // columns of a head a thread holds
constexpr int COMBINE_THREADS = 64;   // two warps, a (b, h) each
constexpr float NEG_INF = -1e30f;    // decode_attention.py:16

struct Plan {
  int S, H, D;
  float scale;
  int len, NS;        // keys a split, splits a batch entry
  int TPH, HG;        // threads a head, heads a block
  int groups;         // head groups, ceil(H / HG)
  int pieces;         // pieces of TPH * NV * VEC columns (1 unless D > 512)
  int q_type;         // 0 float32, 1 bfloat16, 2 float16
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

// Element `i` of q as float32.
__device__ __forceinline__ float load_q(const void* q, int q_type,
                                        long long i) {
  if (q_type == 1) return to_f(static_cast<const __nv_bfloat16*>(q)[i]);
  if (q_type == 2) return to_f(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}

// VEC elements of the cache, read as one load (16 bytes, or one element),
// kept in their own type until used.
template <typename TC, int VEC>
struct alignas(VEC * sizeof(TC)) Pack {
  TC x[VEC];
};

template <typename TC, int VEC>
__device__ __forceinline__ Pack<TC, VEC> load_pack(const TC* ptr, bool ok) {
  Pack<TC, VEC> r;
  if constexpr (VEC * sizeof(TC) == 16) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = __ldg(reinterpret_cast<const uint4*>(ptr));
    static_assert(sizeof(r) == sizeof(u), "a 16-byte pack");
    __builtin_memcpy(&r, &u, sizeof(u));
  } else {
    static_assert(VEC == 1, "one element or 16 bytes");
    r.x[0] = ok ? __ldg(ptr) : TC(0.0f);
  }
  return r;
}

// Online-softmax update of one thread's (m, l, acc) by UNROLL scores and
// the matching value packs.
template <typename TC, int VEC, int NV, int UNROLL>
__device__ __forceinline__ void update(float& m, float& l, float* acc,
                                       const float* s,
                                       Pack<TC, VEC> (*vr)[NV]) {
  float mt = s[0];
#pragma unroll
  for (int u = 1; u < UNROLL; ++u) mt = fmaxf(mt, s[u]);
  const float m_new = fmaxf(m, mt);
  const float corr = expf(m - m_new);
  l *= corr;
#pragma unroll
  for (int c = 0; c < NV * VEC; ++c) acc[c] *= corr;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const float pr = expf(s[u] - m_new);
    l += pr;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i * VEC + e] += pr * to_f(vr[u][i].x[e]);
  }
  m = m_new;
}

// One block: split blockIdx.x % NS of batch entry blockIdx.x / NS, head
// group and column slice blockIdx.z.  ws_ml [B, NS, H, 2] holds (m, l), ws_acc [B,
// NS, H, D] the unnormalised sums.  MULTI (D > 512): q.k over `pieces`
// pieces of P columns, P V over the slice of P columns this block owns.
template <typename TC, int VEC, int NV, bool MULTI>
__global__ void __launch_bounds__(THREADS)
split_kernel(const void* __restrict__ q, const TC* __restrict__ k,
             const TC* __restrict__ v, const int32_t* __restrict__ lens,
             float* __restrict__ ws_ml, float* __restrict__ ws_acc,
             const Plan p) {
  constexpr int E = NV * VEC;
  constexpr int UNROLL = E <= 4 ? 8 : E <= 8 ? 4 : 2;
  extern __shared__ float smem[];
  const int S = p.S, H = p.H, D = p.D, TPH = p.TPH, HG = p.HG;
  const int P = TPH * E;                      // columns a piece
  const int KPAR = THREADS / (TPH * HG);      // key lanes of the block
  const int split = blockIdx.x % p.NS, b = blockIdx.x / p.NS;
  const int g = blockIdx.z % p.groups, slice = blockIdx.z / p.groups;
  const int tid = threadIdx.x, j = tid % TPH, hh = (tid / TPH) % HG;
  const int kl = tid / (TPH * HG);
  const int h = g * HG + hh;
  const bool head_ok = h < H;
  const long long part = ((long long)b * p.NS + split) * H;   // (b, split, 0)

  const int dv0 = slice * P;                  // first column of the slice
  const int kv_len = lens[b];
  const bool all_masked = kv_len <= 0;
  const int n = all_masked ? S : min(kv_len, S);
  const int k_lo = split * p.len;
  if (k_lo >= n) {   // the neutral partial: m = -1e30, l = 0, sums 0
    if (slice == 0 && kl == 0 && j == 0 && head_ok) {
      ws_ml[(part + h) * 2] = NEG_INF;
      ws_ml[(part + h) * 2 + 1] = 0.0f;
    }
    for (int idx = tid; idx < HG * P; idx += THREADS) {
      const int hd = g * HG + idx / P, d = dv0 + idx % P;
      if (hd < H && d < D) ws_acc[(part + hd) * D + d] = 0.0f;
    }
    return;
  }
  const int k_hi = (int)min((long long)k_lo + p.len, (long long)n);
  const long long row = (long long)H * D;     // elements a key position
  const long long qrow = ((long long)b * H + h) * D;
  const TC* kb = k + (long long)b * S * row + (long long)h * D;
  const TC* vb = v + (long long)b * S * row + (long long)h * D + dv0;

  float qv[E], acc[E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = (i * TPH + j) * VEC + e;
      qv[i * VEC + e] = !MULTI && head_ok && d < D
                            ? load_q(q, p.q_type, qrow + d)
                            : 0.0f;
      acc[i * VEC + e] = 0.0f;
    }
  float m = NEG_INF, l = 0.0f;

  for (int base = k_lo; base < k_hi; base += KPAR * UNROLL) {
    Pack<TC, VEC> kr[UNROLL][NV], vr[UNROLL][NV];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int key = base + u * KPAR + kl;
      ok[u] = head_ok && key < k_hi;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * TPH + j) * VEC;
        if constexpr (!MULTI)
          kr[u][i] = load_pack<TC, VEC>(kb + key * row + c,
                                        ok[u] && !all_masked && c < D);
        vr[u][i] = load_pack<TC, VEC>(vb + key * row + c,
                                      ok[u] && dv0 + c < D);
      }
    }
    float dot[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dot[u] = 0.0f;
    if constexpr (MULTI) {   // q.k over the pieces, q read as it is needed
      for (int pc = 0; pc < p.pieces; ++pc) {
        const int d0 = pc * P;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int key = base + u * KPAR + kl;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int c = d0 + (i * TPH + j) * VEC;
            kr[u][i] = load_pack<TC, VEC>(kb + key * row + c,
                                          ok[u] && !all_masked && c < D);
          }
        }
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = d0 + (i * TPH + j) * VEC + e;
            qv[i * VEC + e] = head_ok && d < D ? load_q(q, p.q_type, qrow + d)
                                               : 0.0f;
          }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[u] += qv[i * VEC + e] * to_f(kr[u][i].x[e]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot[u] += qv[i * VEC + e] * to_f(kr[u][i].x[e]);
    }
    float s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      // a head's TPH lanes are an aligned group of one warp
      for (int off = TPH >> 1; off > 0; off >>= 1)
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      const int key = base + u * KPAR + kl;
      s[u] = key < k_hi ? (all_masked ? NEG_INF : dot[u] * p.scale)
                        : -INFINITY;
    }
    update<TC, VEC, NV, UNROLL>(m, l, acc, s, vr);
  }

  // merge the key lanes: smem [KPAR][HG][P] sums, then [KPAR][HG] m and l
  float* sm_acc = smem;
  float* sm_m = smem + THREADS * E;
  float* sm_l = sm_m + KPAR * HG;
  const int lane_head = kl * HG + hh;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[lane_head * P + (i * TPH + j) * VEC + e] = acc[i * VEC + e];
  if (j == 0) {
    sm_m[lane_head] = m;
    sm_l[lane_head] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < HG * P; idx += THREADS) {
    const int h2 = idx / P, dl = idx % P;
    const int hd = g * HG + h2, d = dv0 + dl;
    if (hd >= H || d >= D) continue;
    float M = NEG_INF;
    for (int r = 0; r < KPAR; ++r) M = fmaxf(M, sm_m[r * HG + h2]);
    float a = 0.0f, L = 0.0f;
    for (int r = 0; r < KPAR; ++r) {
      const float w = expf(sm_m[r * HG + h2] - M);
      a += sm_acc[(r * HG + h2) * P + dl] * w;
      L += sm_l[r * HG + h2] * w;
    }
    ws_acc[(part + hd) * D + d] = a;
    if (dl == 0 && slice == 0) {
      ws_ml[(part + hd) * 2] = M;
      ws_ml[(part + hd) * 2 + 1] = L;
    }
  }
}

// One warp per (b, h): the splits below kv_len merged in split order.
// Lanes take the splits 32 apart for the max M and the sum l (reduced in a
// fixed order), then the columns 32 apart, CPL at a time, each lane
// walking all the splits with their weights e^(m_s - M).
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ ws_ml,
               const float* __restrict__ ws_acc,
               const int32_t* __restrict__ lens, TQ* __restrict__ o, int S,
               int H, int D, int len, int NS, int BH) {
  constexpr int CPL = 4;   // columns a lane holds at once
  const int bh = blockIdx.x * (COMBINE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bh >= BH) return;
  const int b = bh / H, h = bh % H;
  const int kv_len = lens[b];
  const int n = kv_len <= 0 ? S : min(kv_len, S);
  const int ns = (n + len - 1) / len;
  const long long first = (long long)b * NS * H + h;   // (b, 0, h)
  float M = NEG_INF;
  for (int s = lane; s < ns; s += 32)
    M = fmaxf(M, ws_ml[(first + (long long)s * H) * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.0f;
  for (int s = lane; s < ns; s += 32) {
    const long long ph = (first + (long long)s * H) * 2;
    L += ws_ml[ph + 1] * expf(ws_ml[ph] - M);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  const float denom = fmaxf(L, 1e-30f);
  for (int d0 = 0; d0 < D; d0 += 32 * CPL) {
    float a[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) a[c] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const long long ph = first + (long long)s * H;
      const float w = expf(ws_ml[ph * 2] - M);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = d0 + lane + 32 * c;
        if (d < D) a[c] += ws_acc[ph * D + d] * w;
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d = d0 + lane + 32 * c;
      if (d < D) store(o + (long long)bh * D + d, a[c] / denom);
    }
  }
}

template <typename TC, int VEC, int NV, bool MULTI>
int launch_split(const void* q, const void* k, const void* v,
                 const int32_t* lens, float* ws, int B, const Plan& p,
                 cudaStream_t st) {
  const int kpar = THREADS / (p.TPH * p.HG);
  const int smem = (THREADS * NV * VEC + 2 * kpar * p.HG) * (int)sizeof(float);
  const dim3 grid((unsigned)((long long)p.NS * B), 1u,
                  (unsigned)(p.groups * p.pieces));
  float* ws_ml = ws;
  float* ws_acc = ws + 2ll * B * p.NS * p.H;
  split_kernel<TC, VEC, NV, MULTI><<<grid, THREADS, smem, st>>>(
      q, static_cast<const TC*>(k), static_cast<const TC*>(v), lens, ws_ml,
      ws_acc, p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: 16-byte packs with NV 1, 2 (and 4 for float32), one
// element with NV 1, 2, 4, 8, 16; MULTI only at 16 columns a thread.
template <typename TC>
int by_pack(const void* q, const void* k, const void* v, const int32_t* lens,
            float* ws, int B, const Plan& p, int vec, int nv,
            cudaStream_t st) {
  constexpr int V16 = 16 / (int)sizeof(TC);
  const bool multi = p.pieces > 1;
  if (vec == V16) {
    if (multi && nv * V16 == MAX_E)
      return launch_split<TC, V16, MAX_E / V16, true>(q, k, v, lens, ws, B,
                                                      p, st);
    if (!multi && nv == 1)
      return launch_split<TC, V16, 1, false>(q, k, v, lens, ws, B, p, st);
    if (!multi && nv == 2)
      return launch_split<TC, V16, 2, false>(q, k, v, lens, ws, B, p, st);
    if constexpr (V16 == 4)
      if (!multi && nv == 4)
        return launch_split<TC, 4, 4, false>(q, k, v, lens, ws, B, p, st);
  } else if (vec == 1) {
    if (multi && nv == MAX_E)
      return launch_split<TC, 1, MAX_E, true>(q, k, v, lens, ws, B, p, st);
    if (!multi) {
      if (nv == 1)
        return launch_split<TC, 1, 1, false>(q, k, v, lens, ws, B, p, st);
      if (nv == 2)
        return launch_split<TC, 1, 2, false>(q, k, v, lens, ws, B, p, st);
      if (nv == 4)
        return launch_split<TC, 1, 4, false>(q, k, v, lens, ws, B, p, st);
      if (nv == 8)
        return launch_split<TC, 1, 8, false>(q, k, v, lens, ws, B, p, st);
      if (nv == 16)
        return launch_split<TC, 1, 16, false>(q, k, v, lens, ws, B, p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int launch_combine(const float* ws, const int32_t* lens, void* o, int B,
                   int S, int H, int D, int len, int NS, cudaStream_t st) {
  constexpr int WARPS = COMBINE_THREADS / 32;
  const long long bh = (long long)B * H;
  combine_kernel<TQ><<<(unsigned)((bh + WARPS - 1) / WARPS), COMBINE_THREADS,
                       0, st>>>(ws, ws + 2ll * B * NS * H, lens,
                                static_cast<TQ*>(o), S, H, D, len, NS,
                                (int)bh);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The split kernel: q [b, h, d] of type `q_type`, k, v [b, s, h, d] of
// type `kv_type` (0 float32, 1 bfloat16, 2 float16), lens int32 [b], all
// contiguous, into the float32 workspace `ws` of b * ns * h * (d + 2)
// values ((m, l) of every (b, split, h), then the sums).  The plan (the
// wrapper's): splits of `len` keys, `ns` = ceil(s / len) a batch entry;
// `vec` elements a load (16 bytes: d % vec == 0 and k, v 16-byte aligned;
// or 1), `nv` loads a thread a head, `tph` threads a head (a power of two
// <= 32), `hg` heads a block (tph * hg divides 256), `pieces` column pieces
// of tph * nv * vec (1 unless nv * vec is 16 and d is wider).  Launches on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan or type it does not take.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, const int32_t* lens,
    float* ws, int b, int s, int h, int d, float scale, int q_type,
    int kv_type, int len, int ns, int vec, int nv, int tph, int hg,
    int pieces, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || s < 1 || h < 1 || d < 1 || q_type < 0 || q_type > 2 ||
      kv_type < 0 || kv_type > 2 || len < 1 || ns != (s + len - 1) / len ||
      !pow2(tph) || tph > 32 || !pow2(hg) || tph * hg > THREADS ||
      !pow2(nv) || nv * vec > MAX_E || pieces < 1 ||
      (long long)ns * b > 0x7fffffffll)
    return bad;
  const int piece = tph * nv * vec;
  if ((long long)piece * pieces < d || (pieces > 1 && nv * vec != MAX_E))
    return bad;
  const int size = kv_type == 0 ? 4 : 2;
  if (vec != 1 && (vec * size != 16 || d % vec ||
                   reinterpret_cast<uintptr_t>(k) % 16 ||
                   reinterpret_cast<uintptr_t>(v) % 16))
    return bad;
  const int groups = (h + hg - 1) / hg;
  if ((long long)groups * pieces > 65535) return bad;
  const Plan p{s, h, d, scale, len, ns, tph, hg, groups, pieces, q_type};
  if (kv_type == 1)
    return by_pack<__nv_bfloat16>(q, k, v, lens, ws, b, p, vec, nv, st);
  if (kv_type == 2)
    return by_pack<__half>(q, k, v, lens, ws, b, p, vec, nv, st);
  return by_pack<float>(q, k, v, lens, ws, b, p, vec, nv, st);
}

// The combine kernel: the split kernel's workspace `ws` (same b, s, h, d,
// len, ns) and lens into o [b, h, d] of type `o_type`.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_combine_launch(const float* ws,
                                               const int32_t* lens, void* o,
                                               int b, int s, int h, int d,
                                               int len, int ns, int o_type,
                                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || h < 1 || d < 1 || len < 1 ||
      ns != (s + len - 1) / len || o_type < 0 || o_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (o_type == 1)
    return launch_combine<__nv_bfloat16>(ws, lens, o, b, s, h, d, len, ns,
                                         st);
  if (o_type == 2)
    return launch_combine<__half>(ws, lens, o, b, s, h, d, len, ns, st);
  return launch_combine<float>(ws, lens, o, b, s, h, d, len, ns, st);
}
