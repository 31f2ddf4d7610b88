// Flash attention, backward, for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference differentiates its plain
// attention (repro/models/layers.py:142 _exact_attn, :159 _chunked_attn),
// and the port's route until this kernel was the plain route's
// vector-Jacobian product under autograd (layers.FlashAttention.backward).
// For q, k, v, out, dout [B, S, H, D] (k and v already repeated to H
// heads) and the forward's row log-sum-exp lse [B, H, S] of the scaled
// scores, it writes dq, dk, dv of softmax(q k^T * scale, causal) v:
//
//   P = exp(S * scale - lse),  dV = P^T dO,  dP = dO V^T,
//   Delta = rowsum(dO o O),    dS = P o (dP - Delta),
//   dQ = dS K * scale,         dK = dS^T Q * scale,
//
// with float32 sums, the outputs in the inputs' type (as
// kernels/ref.py:flash_attention_bwd spells it out).  D <= 128, a multiple
// of 8, and 16-byte aligned rows (the wrapper zero-pads other D: zero
// columns add nothing to any product).
//
// Deterministic by construction: no atomics.  Two passes, each output
// written by one block in a fixed order of sums.
//   (1) the dQ pass: a block owns (b * H + h, 128 query rows) and walks the
//       key tiles up to the causal diagonal; it also forms Delta for its
//       rows and writes Delta and lse * log2(e) per 64-row tile to a
//       scratch buffer (`stats`) for pass (2);
//   (2) the dK/dV pass: a block owns (b * H + h, 128 keys), keeps dK and dV
//       in registers and walks the query tiles from the diagonal on.
// S and dP are formed twice (once a pass): 14 D flops a kept pair against
// the 10 D of a backward that adds dQ by atomics, the price of repeatable
// training steps.  The bound stays the least work, 10 D a kept pair.
//
// bfloat16 and float16: the products on wgmma with float32 accumulators,
// both passes shaped like the forward kernel (flash_attention.cu): a loader
// warpgroup issuing TMA copies into a ring of two stages (mbarriers "full"
// and "empty"), two consumer warpgroups of 64 rows (pass 1: query rows;
// pass 2: keys) each.  Tiles are 64-column panels of 128-byte rows,
// 128-byte swizzled.  Pass 1: S = Q K^T and dP = dO V^T on m64n64k16 with
// both operands K-major; dQ += dS K with dS as wgmma's register A operand
// and K the MN-major B operand of the same tile (transpose bit).  Pass 2
// forms the transposed products directly, S^T = K Q^T and dP^T = V dO^T
// (keys as M), so dV += P^T dO and dK += dS^T Q take P^T and dS^T from
// registers and dO and Q as MN-major B operands: no transposed copy.  The
// key tiles above the causal diagonal are never loaded.
//
// float32: 3xTF32 on mma.sync.m16n8k8 (csrc/tf32.cuh), four warps of 16
// rows a block (64 query rows in pass 1, 64 keys in pass 2), 32-row tiles
// of the other side double-buffered by 16-byte cp.async; an accumulator
// fragment is the A fragment of the next product by reading the B rows in
// the matching order, as the forward's P V does.
//
// Bound on an H100 (B 2, S 4,096, H 16, D 128 bf16, causal, qwen2.5-3b's
// training shape): operations, 10 D flops a kept pair, 0.344 TFLOP, 0.3475
// ms at 989 TFLOP/s; the kernel does 14 D.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int THREADS = 384;        // 16-bit: warpgroup 0 loads, 1, 2 compute
constexpr int THREADS_F32 = 128;    // float32: four warps, all load
constexpr int BQ = 128;             // pass 1: query rows a block
constexpr int BK = 64;              // pass 1: keys a tile
constexpr int BKV = 128;            // pass 2: keys a block
constexpr int BQ2 = 64;             // pass 2: query rows a tile
constexpr int ST = 2;               // stages of the ring
constexpr int STAT = 64;            // query rows a tile of `stats`
constexpr int BF = 64;              // float32: rows a block
constexpr int TF = 32;              // float32: rows a tile of the other side
// pass 2's consumers at D 128 (dK and dV, 128 registers, beside S^T and
// dP^T) spill 896 bytes, at 232 as at 240 (24 for the loader)
constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // [B, H, S], natural log
  void* dq;
  void* dk;
  void* dv;
  // [B * H][stiles][2][STAT]: each 64-row tile's lse * log2(e), then its
  // Delta (rows past S: +inf and 0, so pass 2 gives them P = 0, dS = 0)
  float* stats;
  int S, H, D;
  float scale, scale_log2;
  int causal, BH, stiles;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// The head of (bh = b * H + h): element (b, 0, h, 0) and the row stride.
struct Head {
  long long base, rstride;
  int bh;
};

__device__ __forceinline__ Head head_of(const Params& p, int bh) {
  Head hd;
  hd.bh = bh;
  hd.rstride = (long long)p.H * p.D;
  hd.base = (long long)(bh / p.H) * p.S * hd.rstride +
            (long long)(bh % p.H) * p.D;
  return hd;
}

// Rows `row` and `row + 8` of a tile's accumulator fragments (N floats:
// columns 8 j + 2 t, + 1 of row, then of row + 8) times `mul` into `out`.
template <typename T, int N>
__device__ __forceinline__ void store_acc(void* out, const Params& p,
                                          const Head& hd, const float* acc,
                                          int col0, int row, int t,
                                          float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= p.S) continue;
    T* orow = static_cast<T*>(out) + hd.base + (long long)rr * hd.rstride;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      store_pair(orow, col0 + 8 * j + 2 * t, p.D, acc[4 * j + 2 * r] * mul,
                 acc[4 * j + 2 * r + 1] * mul);
  }
}

// Delta = rowsum(dO o O) of row `row` (0 past S), summed in a fixed order
// by the four threads of a quad (t), 16 bytes at a time, then across the
// quad; every thread of the quad gets it.
template <typename T>
__device__ __forceinline__ float row_delta(const Params& p, const Head& hd,
                                           int row, int t) {
  constexpr int V = 16 / sizeof(T);
  float s = 0.0f;
  if (row < p.S) {
    const long long off = hd.base + (long long)row * hd.rstride;
    const T* o = static_cast<const T*>(p.o) + off;
    const T* d = static_cast<const T*>(p.dout) + off;
    for (int c = V * t; c < p.D; c += 4 * V) {
      const uint4 xv = *reinterpret_cast<const uint4*>(o + c);
      const uint4 yv = *reinterpret_cast<const uint4*>(d + c);
      const T* x = reinterpret_cast<const T*>(&xv);
      const T* y = reinterpret_cast<const T*>(&yv);
#pragma unroll
      for (int e = 0; e < V; ++e) s = fmaf(widen(x[e]), widen(y[e]), s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Pass 1's per-row statistics for rows `row`, `row + 8`: lse2 = lse *
// log2(e) and Delta, written to `stats` by one thread of the quad.
template <typename T>
__device__ __forceinline__ void row_stats(const Params& p, const Head& hd,
                                          int row, int t, float* lse2,
                                          float* delta) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    delta[r] = row_delta<T>(p, hd, rr, t);
    lse2[r] = rr < p.S ? p.lse[(long long)hd.bh * p.S + rr] * LOG2E
                       : __int_as_float(0x7f800000);   // +inf
    if (t == 0) {
      float* st = p.stats + ((long long)hd.bh * p.stiles + rr / STAT) * 2 *
                                STAT + rr % STAT;
      st[0] = lse2[r];
      st[STAT] = delta[r];
    }
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Blocks start in blockIdx order: the heaviest tiles of every head first
// (pass 1: the last query tiles; pass 2, causal: the first key tiles).
__device__ __forceinline__ void block_of(const Params& p, int n_tiles,
                                         bool last_first, int* bh,
                                         int* tile) {
  const int r = blockIdx.x / p.BH;
  *bh = blockIdx.x % p.BH;
  *tile = last_first ? n_tiles - 1 - r : r;
}

// ---- bfloat16 / float16: shared memory -------------------------------------

// Pass 1: Q and dO [NP panels][128 rows][128 B], then ST stages of K and V
// [NP][64][128 B], then the barriers: [0] Q and dO full, [1 + s] K and V
// full, [1 + ST + s] empty.
template <int NP>
struct DqSmem {
  static constexpr int PQ = BQ * 128, PK = BK * 128;
  static constexpr int Q = 0, DO = Q + NP * PQ;
  static constexpr int K = DO + NP * PQ;
  static constexpr int V = K + ST * NP * PK;
  static constexpr int BAR = V + ST * NP * PK;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST) + 1024;
};

// Pass 2: K and V [NP][128 rows][128 B], then ST stages of Q and dO
// [NP][64][128 B] and of the query tile's stats (2 x 64 floats), then the
// barriers: [0] K and V full, [1 + s] Q, dO and stats full, [1 + ST + s]
// empty.
template <int NP>
struct DkvSmem {
  static constexpr int PKV = BKV * 128, PQ = BQ2 * 128;
  static constexpr int K = 0, V = K + NP * PKV;
  static constexpr int Q = V + NP * PKV;
  static constexpr int DO = Q + ST * NP * PQ;
  static constexpr int STATS = DO + ST * NP * PQ;
  static constexpr int BAR = STATS + ST * 2 * STAT * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST) + 1024;
};

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + ST; ++i) mbar_init(&bars[i], 1);
    for (int s = 0; s < ST; ++s) mbar_init(&bars[1 + ST + s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// dS (or P) of a 64 x 64 accumulator tile as wgmma's register A operand:
// k16 step kk covers columns 16 kk .. + 15, the accumulator's column
// groups 2 kk and 2 kk + 1.
template <typename T16>
__device__ __forceinline__ void pack_a(const float* x, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * (2 * kk + h2) + 2 * r;
        a[kk][2 * h2 + r] = pack2(x[i], x[i + 1], static_cast<T16*>(nullptr));
      }
}

// ---- pass 1, bfloat16 / float16 ----------------------------------------------

template <int NP, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
dq_h16_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DqSmem<NP>;
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const int n_qt = (p.S + BQ - 1) / BQ;
  int bh, qt;
  block_of(p, n_qt, true, &bh, &qt);
  const int q0 = qt * BQ;
  int n_kt = (p.S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  const int b = bh / p.H, h = bh % p.H;
  init_bars(bars);

  if (threadIdx.x < 128) {   // ---- the loader warpgroup: one thread ----
    regs_dealloc<LOADER_REGS>();
    if (threadIdx.x != 0) return;
    mbar_expect_tx(&bars[0], 2 * NP * L::PQ);
    for (int pn = 0; pn < NP; ++pn) {
      tma_load_4d(smem + L::Q + pn * L::PQ, &tq, &bars[0], pn * 64, h, q0, b);
      tma_load_4d(smem + L::DO + pn * L::PQ, &tdo, &bars[0], pn * 64, h, q0,
                  b);
    }
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % ST, k0 = it * BK;
      if (it >= ST) mbar_wait(&bars[1 + ST + s], (it / ST - 1) & 1);
      mbar_expect_tx(&bars[1 + s], 2 * NP * L::PK);
      for (int pn = 0; pn < NP; ++pn) {
        tma_load_4d(smem + L::K + (s * NP + pn) * L::PK, &tk, &bars[1 + s],
                    pn * 64, h, k0, b);
        tma_load_4d(smem + L::V + (s * NP + pn) * L::PK, &tv, &bars[1 + s],
                    pn * 64, h, k0, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: 64 query rows each ----
  regs_alloc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128 - 1, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = q0 + 64 * wg + 16 * w + g;   // and row + 8
  const Head hd = head_of(p, bh);
  const int S = p.S;
  const bool causal = p.causal != 0;
  float lse2[2], delta[2];
  row_stats<T16>(p, hd, row, t, lse2, delta);
  float acc[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.0f;
  float sc[32], dp[32];
  uint32_t dsa[4][4];
  const uint8_t* qs = smem + L::Q + wg * 64 * 128;
  const uint8_t* dos = smem + L::DO + wg * 64 * 128;
  const uint64_t dq_ = sw128_desc(qs, 16), ddo = sw128_desc(dos, 16);
  const uint64_t dk = sw128_desc(smem + L::K, 16);
  const uint64_t dv = sw128_desc(smem + L::V, 16);
  const uint64_t dkt = sw128_desc(smem + L::K, 1024);   // K as MN-major B
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_kt; ++it) {
    const int s = it % ST, k0 = it * BK;
    const uint64_t so = s * (NP * L::PK / 16);
    mbar_wait(&bars[1 + s], (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // S = Q K^T: 64 rows x 64 keys
        wgmma_ss_n64<F16>(sc, dq_ + (pn * L::PQ + 32 * j) / 16,
                          dk + so + (pn * L::PK + 32 * j) / 16, pn + j > 0);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // dP = dO V^T
        wgmma_ss_n64<F16>(dp, ddo + (pn * L::PQ + 32 * j) / 16,
                          dv + so + (pn * L::PK + 32 * j) / 16, pn + j > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence<32>(sc);
    reg_fence<32>(dp);
    // only the tiles past S or above this warp's first row mask
    const bool mask = k0 + BK > S || (causal && k0 + BK - 1 > row - g);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = fast_exp2(fmaf(sc[i], p.scale_log2, -lse2[r]));
      if (mask) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        x = (col >= S) | (causal & (col > row + 8 * r)) ? 0.0f : x;
      }
      dp[i] = x * (dp[i] - delta[r]);   // dS
    }
    pack_a<T16>(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)   // dQ += dS K
        wgmma_rs_n64_tb<F16>(acc[pn], dsa[kk],
                             dkt + so + (pn * L::PK + 2048 * kk) / 16);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) reg_fence<32>(acc[pn]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[1 + ST + s]);
  }
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
    store_acc<T16, 32>(p.dq, p, hd, acc[pn], 64 * pn, row, t, p.scale);
}

// ---- pass 2, bfloat16 / float16 ----------------------------------------------

template <int NP, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
dkv_h16_kernel(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = DkvSmem<NP>;
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const int n_kt = (p.S + BKV - 1) / BKV;
  int bh, kt;
  block_of(p, n_kt, false, &bh, &kt);
  const int k0 = kt * BKV;
  const int qt0 = p.causal ? k0 / BQ2 : 0;          // the first query tile
  const int n_it = (p.S + BQ2 - 1) / BQ2 - qt0;
  const int b = bh / p.H, h = bh % p.H;
  init_bars(bars);

  if (threadIdx.x < 128) {   // ---- the loader warpgroup: one thread ----
    regs_dealloc<LOADER_REGS>();
    if (threadIdx.x != 0) return;
    mbar_expect_tx(&bars[0], 2 * NP * L::PKV);
    for (int pn = 0; pn < NP; ++pn) {
      tma_load_4d(smem + L::K + pn * L::PKV, &tk, &bars[0], pn * 64, h, k0, b);
      tma_load_4d(smem + L::V + pn * L::PKV, &tv, &bars[0], pn * 64, h, k0, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST, qt = qt0 + it;
      if (it >= ST) mbar_wait(&bars[1 + ST + s], (it / ST - 1) & 1);
      mbar_expect_tx(&bars[1 + s], 2 * NP * L::PQ + 2 * STAT * 4);
      for (int pn = 0; pn < NP; ++pn) {
        tma_load_4d(smem + L::Q + (s * NP + pn) * L::PQ, &tq, &bars[1 + s],
                    pn * 64, h, qt * BQ2, b);
        tma_load_4d(smem + L::DO + (s * NP + pn) * L::PQ, &tdo, &bars[1 + s],
                    pn * 64, h, qt * BQ2, b);
      }
      bulk_load(smem + L::STATS + s * 2 * STAT * 4,
                p.stats + ((long long)bh * p.stiles + qt) * 2 * STAT,
                2 * STAT * 4, &bars[1 + s]);
    }
    return;
  }

  // ---- the consumer warpgroups: 64 keys each ----
  regs_alloc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128 - 1, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int key = k0 + 64 * wg + 16 * w + g;   // and key + 8
  const Head hd = head_of(p, bh);
  const bool causal = p.causal != 0;
  float ak[NP][32], av[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) ak[pn][i] = av[pn][i] = 0.0f;
  float st[32], dpt[32];
  uint32_t pa[4][4], dsa[4][4];
  const uint8_t* ks = smem + L::K + wg * 64 * 128;
  const uint8_t* vs = smem + L::V + wg * 64 * 128;
  const uint64_t dk = sw128_desc(ks, 16), dv = sw128_desc(vs, 16);
  const uint64_t dq_ = sw128_desc(smem + L::Q, 16);
  const uint64_t ddo = sw128_desc(smem + L::DO, 16);
  const uint64_t dqt = sw128_desc(smem + L::Q, 1024);    // MN-major B
  const uint64_t ddot = sw128_desc(smem + L::DO, 1024);
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST, q0 = (qt0 + it) * BQ2;
    const uint64_t so = s * (NP * L::PQ / 16);
    const float* stats =
        reinterpret_cast<const float*>(smem + L::STATS + s * 2 * STAT * 4);
    mbar_wait(&bars[1 + s], (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // S^T = K Q^T: 64 keys x 64 queries
        wgmma_ss_n64<F16>(st, dk + (pn * L::PKV + 32 * j) / 16,
                          dq_ + so + (pn * L::PQ + 32 * j) / 16, pn + j > 0);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // dP^T = V dO^T
        wgmma_ss_n64<F16>(dpt, dv + (pn * L::PKV + 32 * j) / 16,
                          ddo + so + (pn * L::PQ + 32 * j) / 16, pn + j > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence<32>(st);
    reg_fence<32>(dpt);
    // causal: only the tiles with a query below this warp's last key mask
    // (queries past S have lse2 = +inf and Delta = 0: P = 0, dS = 0)
    const bool mask = causal && q0 < key - g + 15;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      float x = fast_exp2(fmaf(st[i], p.scale_log2, -stats[c]));
      if (mask) x = q0 + c < key + 8 * ((i >> 1) & 1) ? 0.0f : x;
      st[i] = x;                                   // P^T
      dpt[i] = x * (dpt[i] - stats[STAT + c]);     // dS^T
    }
    pack_a<T16>(st, pa);
    pack_a<T16>(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        // dV += P^T dO, dK += dS^T Q
        wgmma_rs_n64_tb<F16>(av[pn], pa[kk],
                             ddot + so + (pn * L::PQ + 2048 * kk) / 16);
        wgmma_rs_n64_tb<F16>(ak[pn], dsa[kk],
                             dqt + so + (pn * L::PQ + 2048 * kk) / 16);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      reg_fence<32>(av[pn]);
      reg_fence<32>(ak[pn]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[1 + ST + s]);
  }
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
    store_acc<T16, 32>(p.dk, p, hd, ak[pn], 64 * pn, key, t, p.scale);
    store_acc<T16, 32>(p.dv, p, hd, av[pn], 64 * pn, key, t, 1.0f);
  }
}

// ---- float32: 3xTF32 ----------------------------------------------------------

// Rows [row0, row0 + R) of one float32 head into a [R][ld] tile by 16-byte
// cp.async from the block's 128 threads; rows past S and columns past D
// (up to `cols`) are zero.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          const Params& p, const Head& hd,
                                          int row0, int cols) {
  const int c4 = cols / 4;
  for (int e = threadIdx.x; e < R * c4; e += THREADS_F32) {
    const int r = e / c4, c = (e % c4) * 4;
    const bool ok = row0 + r < p.S && c < p.D;
    cp_async<16>(dst + r * ld + c,
                 ok ? src + hd.base + (long long)(row0 + r) * hd.rstride + c
                    : src,
                 ok);
  }
}

// acc[4 nt ..] += X B over the 8 keys (or queries) of each group kk, X in
// accumulator order (x[kk][e]: row g + 8 (e / 2), column 2 t + e % 2 of
// group kk) used as the A fragment, with B's rows read in the matching
// order: b(r, c) is B's row r of the group, column c.
template <int NT, int NK, typename FB>
__device__ __forceinline__ void mma_acc_a(float* acc, const float (*x)[4],
                                          FB b, int n, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const SplitA a = split_a(x[kk][0], x[kk][2], x[kk][1], x[kk][3]);
    float b0[NT], b1[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b0[nt] = nt < n ? b(8 * kk + 2 * t, 8 * nt + g) : 0.0f;
      b1[nt] = nt < n ? b(8 * kk + 2 * t + 1, 8 * nt + g) : 0.0f;
    }
    mma_3xtf32<NT>(acc, a, b0, b1, n);
  }
}

// Pass 1, float32: 64 query rows a block, 16 a warp; 32-key tiles.
template <int NP>
__global__ void __launch_bounds__(THREADS_F32)
dq_f32_kernel(const Params p) {
  constexpr int DM = 64 * NP, LD = DM + 4, NT = TF / 8;
  extern __shared__ uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(aligned_smem(smem_raw));
  float* DOs = Qs + BF * LD;
  float* Ks = DOs + BF * LD;        // [2][TF][LD]
  float* Vs = Ks + 2 * TF * LD;     // [2][TF][LD]
  const int n_qt = (p.S + BF - 1) / BF;
  int bh, qt;
  block_of(p, n_qt, true, &bh, &qt);
  const int q0 = qt * BF;
  int n_kt = (p.S + TF - 1) / TF;
  if (p.causal) n_kt = min(n_kt, (q0 + BF - 1) / TF + 1);
  const Head hd = head_of(p, bh);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * w + g;   // and row + 8
  const int S = p.S;
  const bool causal = p.causal != 0;
  const auto* q = static_cast<const float*>(p.q);
  const auto* k = static_cast<const float*>(p.k);
  const auto* v = static_cast<const float*>(p.v);
  const auto* dout = static_cast<const float*>(p.dout);
  load_rows<BF>(Qs, LD, q, p, hd, q0, DM);
  load_rows<BF>(DOs, LD, dout, p, hd, q0, DM);
  load_rows<TF>(Ks, LD, k, p, hd, 0, DM);
  load_rows<TF>(Vs, LD, v, p, hd, 0, DM);
  cp_async_commit();
  float lse2[2], delta[2];
  row_stats<float>(p, hd, row, t, lse2, delta);
  const int n_dt = p.D / 8;   // 8-column tiles of D
  float acc[DM / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * TF;
    float* ks = Ks + (it & 1) * TF * LD;
    float* vs = Vs + (it & 1) * TF * LD;
    if (it + 1 < n_kt) {
      load_rows<TF>(Ks + ((it + 1) & 1) * TF * LD, LD, k, p, hd, k0 + TF, DM);
      load_rows<TF>(Vs + ((it + 1) & 1) * TF * LD, LD, v, p, hd, k0 + TF, DM);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[1][NT][4] = {}, dp[1][NT][4] = {};
    const float* qs = Qs + 16 * w * LD;
    const float* dos = DOs + 16 * w * LD;
    mma_tiles<1, NT>(
        sc, [&](int, int r, int c) { return qs[r * LD + c]; },
        [&](int j, int c, int n) { return ks[(8 * j + n) * LD + c]; }, p.D,
        1, NT, g, t);
    mma_tiles<1, NT>(
        dp, [&](int, int r, int c) { return dos[r * LD + c]; },
        [&](int j, int c, int n) { return vs[(8 * j + n) * LD + c]; }, p.D,
        1, NT, g, t);
    const bool mask = k0 + TF > S || (causal && k0 + TF - 1 > row - g);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = fast_exp2(fmaf(sc[0][j][e], p.scale_log2, -lse2[r]));
        if (mask) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          x = (col >= S) | (causal & (col > row + 8 * r)) ? 0.0f : x;
        }
        dp[0][j][e] = x * (dp[0][j][e] - delta[r]);   // dS
      }
    // dQ += dS K
    mma_acc_a<DM / 8, NT>(
        acc, dp[0], [&](int r, int c) { return ks[r * LD + c]; }, n_dt, g,
        t);
    __syncthreads();
  }
  store_acc<float, DM / 2>(p.dq, p, hd, acc, 0, row, t, p.scale);
}

// Pass 2, float32: 64 keys a block, 16 a warp; 32-query tiles.
template <int NP>
__global__ void __launch_bounds__(THREADS_F32)
dkv_f32_kernel(const Params p) {
  constexpr int DM = 64 * NP, LD = DM + 4, NT = TF / 8;
  extern __shared__ uint8_t smem_raw[];
  float* Ks = reinterpret_cast<float*>(aligned_smem(smem_raw));
  float* Vs = Ks + BF * LD;
  float* Qs = Vs + BF * LD;         // [2][TF][LD]
  float* DOs = Qs + 2 * TF * LD;    // [2][TF][LD]
  float* Ss = DOs + 2 * TF * LD;    // [2][2][TF]: lse2, then Delta
  const int n_kt = (p.S + BF - 1) / BF;
  int bh, kt;
  block_of(p, n_kt, false, &bh, &kt);
  const int k0 = kt * BF;
  const int qt0 = p.causal ? k0 / TF : 0;
  const int n_it = (p.S + TF - 1) / TF - qt0;
  const Head hd = head_of(p, bh);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 16 * w + g;   // and key + 8
  const bool causal = p.causal != 0;
  const auto* q = static_cast<const float*>(p.q);
  const auto* k = static_cast<const float*>(p.k);
  const auto* v = static_cast<const float*>(p.v);
  const auto* dout = static_cast<const float*>(p.dout);
  // a query tile's lse2 and Delta: half of one of `stats`' 64-row tiles
  auto load_stats = [&](float* dst, int q0) {
    const float* src = p.stats +
                       ((long long)bh * p.stiles + q0 / STAT) * 2 * STAT +
                       q0 % STAT;
    if (threadIdx.x < 2 * TF / 4) {
      const int half = threadIdx.x / (TF / 4), c = (threadIdx.x % (TF / 4)) * 4;
      cp_async<16>(dst + half * TF + c, src + half * STAT + c, true);
    }
  };
  load_rows<BF>(Ks, LD, k, p, hd, k0, DM);
  load_rows<BF>(Vs, LD, v, p, hd, k0, DM);
  load_rows<TF>(Qs, LD, q, p, hd, qt0 * TF, DM);
  load_rows<TF>(DOs, LD, dout, p, hd, qt0 * TF, DM);
  load_stats(Ss, qt0 * TF);
  cp_async_commit();
  const int n_dt = p.D / 8;
  float ak[DM / 2], av[DM / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) ak[i] = av[i] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it) * TF, buf = it & 1;
    const float* qs = Qs + buf * TF * LD;
    const float* dos = DOs + buf * TF * LD;
    const float* ss = Ss + buf * 2 * TF;
    if (it + 1 < n_it) {
      const int nb = buf ^ 1;
      load_rows<TF>(Qs + nb * TF * LD, LD, q, p, hd, q0 + TF, DM);
      load_rows<TF>(DOs + nb * TF * LD, LD, dout, p, hd, q0 + TF, DM);
      load_stats(Ss + nb * 2 * TF, q0 + TF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float st[1][NT][4] = {}, dpt[1][NT][4] = {};
    const float* ks = Ks + 16 * w * LD;
    const float* vs = Vs + 16 * w * LD;
    mma_tiles<1, NT>(
        st, [&](int, int r, int c) { return ks[r * LD + c]; },
        [&](int j, int c, int n) { return qs[(8 * j + n) * LD + c]; }, p.D,
        1, NT, g, t);
    mma_tiles<1, NT>(
        dpt, [&](int, int r, int c) { return vs[r * LD + c]; },
        [&](int j, int c, int n) { return dos[(8 * j + n) * LD + c]; }, p.D,
        1, NT, g, t);
    const bool mask = causal && q0 < key - g + 15;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = fast_exp2(fmaf(st[0][j][e], p.scale_log2, -ss[c]));
        if (mask) x = q0 + c < key + 8 * (e >> 1) ? 0.0f : x;
        st[0][j][e] = x;                                // P^T
        dpt[0][j][e] = x * (dpt[0][j][e] - ss[TF + c]);  // dS^T
      }
    // dV += P^T dO, dK += dS^T Q
    mma_acc_a<DM / 8, NT>(
        av, st[0], [&](int r, int c) { return dos[r * LD + c]; }, n_dt, g,
        t);
    mma_acc_a<DM / 8, NT>(
        ak, dpt[0], [&](int r, int c) { return qs[r * LD + c]; }, n_dt, g,
        t);
    __syncthreads();
  }
  store_acc<float, DM / 2>(p.dk, p, hd, ak, 0, key, t, p.scale);
  store_acc<float, DM / 2>(p.dv, p, hd, av, 0, key, t, 1.0f);
}

template <int NP>
constexpr int f32_dq_bytes() {
  return (2 * BF + 4 * TF) * (64 * NP + 4) * 4 + 1024;
}
template <int NP>
constexpr int f32_dkv_bytes() {
  return (2 * BF + 4 * TF) * (64 * NP + 4) * 4 + 2 * 2 * TF * 4 + 1024;
}

// ---- host side -----------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int smem, unsigned blocks,
           cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, bool F16>
int launch_h16(const Params& p, int b, unsigned dq_blocks, unsigned kv_blocks,
               cudaStream_t st) {
  // tensor maps: Q and dO by 128 rows and K and V by 64 (pass 1), K and V
  // by 128 and Q and dO by 64 (pass 2)
  const void* ptrs[4] = {p.q, p.dout, p.k, p.v};
  CUtensorMap m1[4], m2[4];
  for (int i = 0; i < 4; ++i) {
    int err = make_map(&m1[i], ptrs[i], b, p.S, p.H, p.D, F16,
                       i < 2 ? BQ : BK);
    if (!err)
      err = make_map(&m2[i], ptrs[i], b, p.S, p.H, p.D, F16,
                     i < 2 ? BQ2 : BKV);
    if (err) return err;
  }
  int err = launch(dq_h16_kernel<NP, F16>, THREADS, DqSmem<NP>::BYTES,
                   dq_blocks, st, m1[0], m1[1], m1[2], m1[3], p);
  if (err) return err;
  return launch(dkv_h16_kernel<NP, F16>, THREADS, DkvSmem<NP>::BYTES,
                kv_blocks, st, m2[2], m2[3], m2[0], m2[1], p);
}

template <int NP>
int launch_f32(const Params& p, unsigned blocks, cudaStream_t st) {
  const int err = launch(dq_f32_kernel<NP>, THREADS_F32, f32_dq_bytes<NP>(),
                         blocks, st, p);
  if (err) return err;
  return launch(dkv_f32_kernel<NP>, THREADS_F32, f32_dkv_bytes<NP>(), blocks,
                st, p);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward of flash attention: q, k, v, o (the forward's output), dout,
// dq, dk, dv contiguous [b, s, h, d] of `dtype` (0 float32, 1 bfloat16, 2
// float16), 8 <= d <= 128 with d % 8 == 0 and every pointer 16-byte
// aligned; lse [b, h, s] float32 from the forward (natural log); `stats`
// float32 scratch of b * h * stat_tiles(s) * 128 floats, stat_tiles(s) =
// 2 * ceil(s / 128).  `scale` multiplies the scores.  Launches the dQ pass
// and then the dK/dV pass on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for operands it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* stats, int b, int s, int h, int d, float scale, int causal,
    int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[10] = {q, k, v, o, dout, lse, dq, dk, dv, stats};
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  if (d < 8 || d > 128 || d % 8 || dtype < 0 || dtype > 2 || s < 1 ||
      b < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,     v, o, dout, lse, dq, dk, dv, stats, s, h, d, scale,
           scale * LOG2E, causal, b * h, 2 * ((s + BQ - 1) / BQ)};
  if (dtype == 0) {
    const long long blocks = (long long)((s + BF - 1) / BF) * b * h;
    if (blocks > 0x7fffffffll)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    return d <= 64 ? launch_f32<1>(p, (unsigned)blocks, st)
                   : launch_f32<2>(p, (unsigned)blocks, st);
  }
  const long long dq_blocks = (long long)((s + BQ - 1) / BQ) * b * h;
  const long long kv_blocks = (long long)((s + BKV - 1) / BKV) * b * h;
  if (dq_blocks > 0x7fffffffll || kv_blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned nq = (unsigned)dq_blocks, nk = (unsigned)kv_blocks;
  if (dtype == 2)
    return d <= 64 ? launch_h16<1, true>(p, b, nq, nk, st)
                   : launch_h16<2, true>(p, b, nq, nk, st);
  return d <= 64 ? launch_h16<1, false>(p, b, nq, nk, st)
                 : launch_h16<2, false>(p, b, nq, nk, st);
}
