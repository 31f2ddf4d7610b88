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
// bfloat16 and float16: one pass over the kept pairs, three kernels.
//   (1) stats_kernel: each query row's Delta and lse * log2(e), per 64-row
//       tile into a scratch buffer (`stats`); it reads O and dO once.
//   (2) bwd_h16_kernel: a block owns (b * H + h, 128 keys), keeps dK and dV
//       in registers and walks the query tiles of 64 rows between the
//       causal diagonal and the last.  It forms S^T = K Q^T and dP^T =
//       V dO^T once a tile (keys as wgmma's M), and from them dV += P^T dO,
//       dK += dS^T Q and the tile's share of dQ, dS K: 10 D flops a kept
//       pair, the bound's own count.  dS^T goes to shared memory (16-bit,
//       128-byte swizzled), where it is the K-major A operand of dK and,
//       read transposed, the MN-major A operand of dQ; each consumer
//       warpgroup forms half of dQ's columns (64 at D 128, 32 at D <= 64).
//       The first product of each chain overwrites its accumulator, so S^T,
//       dP^T and dQ hold no registers across tiles and the consumers stay
//       within their 240.  The tile's dQ (float32) is staged in shared
//       memory and added into a float32 workspace `dq_acc` by one bulk
//       copy (cp.reduce.async.bulk .add.f32) that a writer thread of the
//       loader warpgroup issues.
//   (3) dq_post_kernel: dq = T16(dq_acc * scale).
//
// Deterministic: every dq_acc element's adds come in ascending key-block
// order on every run.  An int32 counter per (head, 64-row query tile)
// counts the key blocks that have added into it; key block j's writer
// waits (acquire) until it reads j, adds, waits for the add to complete,
// and increments it (release).  Key block 0 stores instead of adding, so
// dq_acc needs no zero fill.  The counters are reset by a memset on the
// stream before each call (B * H * ceil(S / 64) ints).  Blocks start in
// blockIdx order with key block 0 of every head first (`block_of`), and a
// block waits only on blocks of lower key index, so of lower blockIdx,
// which started before it; the spin traps after ~2^33 cycles, as
// wait_bar does, so a wrong order fails the launch instead of hanging the
// card.  A block walks its query tiles from the last down to the diagonal:
// then every key block of a head reaches a tile at about the same time,
// where walking up from the diagonal would make key block j wait for block
// 0 to walk 2 j tiles first (a list-scheduling model of the training
// shape's 1,024 blocks on 132 SMs: 258.6 tile times downward, as without
// the waits, against 278.8 upward).
//
// Inside a block (384 threads): warpgroups 0 and 1 compute, 64 keys each
// (240 registers a thread by setmaxnreg); warpgroup 2 (24) loads (one
// thread: K and V once, then a ring of three stages of Q, dO and the
// tile's stats by TMA; mbarriers "full" and "empty") and writes dQ (one
// thread).  A tile: S^T and dP^T are issued, the
// exponentials run under dP^T's products, dV's products run under dS^T's
// stores to shared memory, then dK and dQ; the stage goes back to the
// loader once its last product is done.  Two named barriers pace the two
// consumer warpgroups over the shared dS^T: "ready" (both halves written)
// and "free" (both warpgroups' products of the last tile done).
//
// float32: 3xTF32 on mma.sync.m16n8k8 (csrc/tf32.cuh), two passes without
// atomics, four warps of 16 rows a block: (1) the dQ pass (64 query rows a
// block, walking the key tiles to the diagonal; it also writes `stats`),
// (2) the dK/dV pass (64 keys a block, walking the query tiles from the
// diagonal); 32-row tiles of the other side double-buffered by 16-byte
// cp.async; an accumulator fragment is the A fragment of the next product
// by reading the B rows in the matching order, as the forward's P V does.
//
// Bound on an H100 (B 2, S 4,096, H 16, D 128 bf16, causal, qwen2.5-3b's
// training shape): operations, 10 D flops a kept pair, 0.344 TFLOP, 0.3475
// ms at 989 TFLOP/s.

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

// 16-bit: two consumer warpgroups (threads 0-255), then the producer
// warpgroup (a TMA thread and a dQ writer thread)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
// the producers at 24, the consumers at 240: 24 * 128 + 240 * 256 = 64,512
constexpr int LOADER_REGS = 24, CONSUMER_REGS = 240;
constexpr int THREADS_F32 = 128;    // float32: four warps, all load
constexpr int BKV = 128;            // 16-bit: keys a block
constexpr int BQ2 = 64;             // 16-bit: query rows a tile
constexpr int ST = 3;               // 16-bit: stages of the ring
constexpr int STAT = 64;            // query rows a tile of `stats`
constexpr int STATS_THREADS = 4 * STAT;   // stats_kernel: a quad a row
constexpr int POST_THREADS = 256;
constexpr int DQ_PANEL = 64 * 64;   // floats of a 64 x 64 panel of dq_acc
constexpr int BF = 64;              // float32: rows a block
constexpr int TF = 32;              // float32: rows a tile of the other side
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
  // Delta (rows past S: +inf and 0, so P = 0 and dS = 0 there)
  float* stats;
  // 16-bit: [B * H][qtiles][NP][64][64] float32 dQ sums (each panel's
  // 16-byte chunks swizzled: chunk c of row r at c ^ (r % 8)), and
  // [B * H][qtiles] int32 counters
  float* dq_acc;
  int* dq_count;
  int S, H, D;
  float scale, scale_log2;
  int causal, BH, stiles, qtiles;
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

// Row `row`'s lse2 = lse * log2(e) (+inf past S) and Delta, written to
// `stats` by one thread of the quad.
template <typename T>
__device__ __forceinline__ void row_stat(const Params& p, const Head& hd,
                                         int row, int t, float* lse2,
                                         float* delta) {
  *delta = row_delta<T>(p, hd, row, t);
  *lse2 = row < p.S ? p.lse[(long long)hd.bh * p.S + row] * LOG2E
                    : __int_as_float(0x7f800000);   // +inf
  if (t == 0) {
    float* st = p.stats + ((long long)hd.bh * p.stiles + row / STAT) * 2 *
                              STAT + row % STAT;
    st[0] = *lse2;
    st[STAT] = *delta;
  }
}

// The float32 dQ pass's statistics for rows `row`, `row + 8`.
template <typename T>
__device__ __forceinline__ void row_stats(const Params& p, const Head& hd,
                                          int row, int t, float* lse2,
                                          float* delta) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_stat<T>(p, hd, row + 8 * r, t, &lse2[r], &delta[r]);
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
// (the float32 dQ pass: the last query tiles; the key-block kernels,
// causal: the first key tiles).
__device__ __forceinline__ void block_of(const Params& p, int n_tiles,
                                         bool last_first, int* bh,
                                         int* tile) {
  const int r = blockIdx.x / p.BH;
  *bh = blockIdx.x % p.BH;
  *tile = last_first ? n_tiles - 1 - r : r;
}

// ---- bfloat16 / float16: dQ's ordered adds -----------------------------------

// A wait that never ends is a fault of the kernel: trap after ~2^33 cycles
// (~4 s) so the launch fails instead of hanging the card.  The trap sits in
// a function of its own: inlined into the consumers' loop (hopper.cuh's
// mbar_wait), it kept ptxas from allocating past the launch bound's 168
// registers a thread, setmaxnreg's 240 unused (916 bytes of spills, every
// wgmma serialized).
__device__ __noinline__ void hang() { __trap(); }

__device__ __forceinline__ void wait_bar(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 33)) hang();
}

// `bytes` of shared memory at `src` stored to (add = false) or added
// element-wise in float32 into (add = true) global memory at `dst`, as one
// bulk copy of the async proxy, committed as a bulk group.
__device__ __forceinline__ void bulk_out(float* dst, uint32_t src,
                                         uint32_t bytes, bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;" ::"l"(dst), "r"(src), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            dst),
        "r"(src), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until the counter reads `want` (acquire, GPU scope); trap after
// ~2^33 cycles, as wait_bar does.  Then order the async proxy's coming
// accesses after it.
__device__ __forceinline__ void wait_count(const int* count, int want) {
  const long long t0 = clock64();
  for (;;) {
    int n;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(n)
                 : "l"(count)
                 : "memory");
    if (n == want) break;
    if (clock64() - t0 > (1ll << 33)) hang();
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// After the bulk group's writes complete: one more on the counter
// (release, GPU scope).
__device__ __forceinline__ void bump_count(int* count) {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;" ::"l"(count)
               : "memory");
}

// The two consumer warpgroups' named barriers (0 is __syncthreads).
constexpr int BAR_DS_READY = 1, BAR_DS_FREE = 2;
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

// wgmma with both operands in shared memory, m64nNk16 (N 64: d[32]; N
// 32: d[16]), f32 sums; A and B K-major ("0") or MN-major ("1", the
// transpose bits).  ACC true adds into d ("+f"); ACC false overwrites it
// ("=f", scale-d 0): the first product of a chain, so that d's old values
// are dead and need no registers across the loop.
#define WG_D16(C)                                                              \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),      \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),      \
      C(d[15])
#define WG_D32(C)                                                              \
  WG_D16(C), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]),       \
      C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]),    \
      C(d[29]), C(d[30]), C(d[31])
#define WG_SS64(TY, TA, TB, C)                                                 \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %34, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, %32, %33, p, 1, 1, " TA ", " TB ";\n}\n"                \
      : WG_D32(C)                                                              \
      : "l"(da), "l"(db), "r"(ACC ? 1 : 0))
#define WG_SS32(TY, TA, TB, C)                                                 \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %18, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15}, %16, %17, p, 1, 1, " TA ", " TB ";\n}\n"                          \
      : WG_D16(C)                                                              \
      : "l"(da), "l"(db), "r"(ACC ? 1 : 0))
#define WG_PICK(MAC, C)                                                        \
  if constexpr (F16 && TA && TB) MAC("f16", "1", "1", C);                      \
  else if constexpr (F16 && TA) MAC("f16", "1", "0", C);                       \
  else if constexpr (F16 && TB) MAC("f16", "0", "1", C);                       \
  else if constexpr (F16) MAC("f16", "0", "0", C);                             \
  else if constexpr (TA && TB) MAC("bf16", "1", "1", C);                       \
  else if constexpr (TA) MAC("bf16", "1", "0", C);                             \
  else if constexpr (TB) MAC("bf16", "0", "1", C);                             \
  else MAC("bf16", "0", "0", C)

template <int N, bool F16, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 32, "m64n64k16 or m64n32k16");
  if constexpr (N == 64 && ACC) {
    WG_PICK(WG_SS64, "+f");
  } else if constexpr (N == 64) {
    WG_PICK(WG_SS64, "=f");
  } else if constexpr (ACC) {
    WG_PICK(WG_SS32, "+f");
  } else {
    WG_PICK(WG_SS32, "=f");
  }
}

// ---- bfloat16 / float16: shared memory ---------------------------------------

// K and V [NP panels][128 rows][128 B], ST stages of Q and dO [NP][64][128
// B], dS^T [128 keys][64 queries] (16-bit, 128-byte swizzled), the dQ
// staging tile [NP][64][64] float32 (chunks swizzled as dq_acc's), ST
// stages of the tile's stats (2 x 64 floats), then the barriers: [0] K and
// V full, [1 + s] stage s full, [1 + ST + s] stage s empty, [1 + 2 ST] dQ
// staged, [2 + 2 ST] dQ staging free.  D 128: 215,624 bytes.
template <int NP>
struct BwdSmem {
  static constexpr int PKV = BKV * 128, PQ = BQ2 * 128;
  static constexpr int K = 0, V = K + NP * PKV;
  static constexpr int Q = V + NP * PKV;
  static constexpr int DO = Q + ST * NP * PQ;
  static constexpr int DS = DO + ST * NP * PQ;
  static constexpr int DQ = DS + BKV * 128;
  static constexpr int STATS = DQ + NP * DQ_PANEL * 4;
  static constexpr int BAR = STATS + ST * 2 * STAT * 4;
  static constexpr int DQ_FULL = 1 + 2 * ST, DQ_EMPTY = 2 + 2 * ST;
  static constexpr int BYTES = BAR + 8 * (3 + 2 * ST) + 1024;
};

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

// ---- (1) the statistics pre-pass ---------------------------------------------

// A block: one 64-row tile of `stats` (blockIdx.x = bh * stiles + tile), a
// quad of threads a row.
template <typename T16>
__global__ void __launch_bounds__(STATS_THREADS)
stats_kernel(const Params p) {
  const int bh = blockIdx.x / p.stiles, tile = blockIdx.x % p.stiles;
  const Head hd = head_of(p, bh);
  float lse2, delta;
  row_stat<T16>(p, hd, tile * STAT + threadIdx.x / 4, threadIdx.x % 4, &lse2,
                &delta);
}

// ---- (2) the main kernel, bfloat16 / float16 ---------------------------------

template <int NP, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
bwd_h16_kernel(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = BwdSmem<NP>;
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const int n_kt = (p.S + BKV - 1) / BKV;
  int bh, kt;
  block_of(p, n_kt, false, &bh, &kt);
  const int k0 = kt * BKV;
  const int qt_last = p.qtiles - 1;
  const int n_it = qt_last + 1 - (p.causal ? k0 / BQ2 : 0);
  const int b = bh / p.H, h = bh % p.H;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + ST + s], 8);
    }
    mbar_init(&bars[L::DQ_FULL], 8);   // dQ staged: every consumer warp
    mbar_init(&bars[L::DQ_EMPTY], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // ---- the producer warpgroup ----
    regs_dealloc<LOADER_REGS>();
    if (threadIdx.x == CONSUMERS) {   // the TMA loads
      mbar_expect_tx(&bars[0], 2 * NP * L::PKV);
      for (int pn = 0; pn < NP; ++pn) {
        tma_load_4d(smem + L::K + pn * L::PKV, &tk, &bars[0], pn * 64, h, k0,
                    b);
        tma_load_4d(smem + L::V + pn * L::PKV, &tv, &bars[0], pn * 64, h, k0,
                    b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % ST, qt = qt_last - it;
        if (it >= ST) wait_bar(&bars[1 + ST + s], (it / ST - 1) & 1);
        mbar_expect_tx(&bars[1 + s], 2 * NP * L::PQ + 2 * STAT * 4);
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_4d(smem + L::Q + (s * NP + pn) * L::PQ, &tq, &bars[1 + s],
                      pn * 64, h, qt * BQ2, b);
          tma_load_4d(smem + L::DO + (s * NP + pn) * L::PQ, &tdo,
                      &bars[1 + s], pn * 64, h, qt * BQ2, b);
        }
        bulk_load(smem + L::STATS + s * 2 * STAT * 4,
                  p.stats + ((long long)bh * p.stiles + qt) * 2 * STAT,
                  2 * STAT * 4, &bars[1 + s]);
      }
    } else if (threadIdx.x == CONSUMERS + 32) {   // the dQ writer
      int* count = p.dq_count + (long long)bh * p.qtiles;
      float* acc = p.dq_acc + (long long)bh * p.qtiles * NP * DQ_PANEL;
      const uint32_t staged = smem_u32(smem + L::DQ);
      for (int it = 0; it < n_it; ++it) {
        const int qt = qt_last - it;
        wait_bar(&bars[L::DQ_FULL], it & 1);
        if (kt > 0) wait_count(count + qt, kt);
        bulk_out(acc + (long long)qt * NP * DQ_PANEL, staged,
                 NP * DQ_PANEL * 4, kt > 0);
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        mbar_arrive(&bars[L::DQ_EMPTY]);
        bump_count(count + qt);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: 64 keys each ----
  regs_alloc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int key = k0 + 64 * wg + 16 * w + g;   // and key + 8
  const Head hd = head_of(p, bh);
  const bool causal = p.causal != 0;
  const bool past_s = k0 + BKV > p.S;   // keys past S: P^T = 0 there
  float ak[NP][32], av[NP][32];
#pragma unroll
  for (int pn = 0; pn < NP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) ak[pn][i] = av[pn][i] = 0.0f;
  // dQ's columns of this warpgroup: D 128, its own 64-column panel; D <=
  // 64, half of the one panel (32 columns, B from 64 bytes into K's rows)
  constexpr int DQN = NP == 2 ? 64 : 32;
  const int dq_col = NP == 2 ? 64 * wg : 32 * wg;
  float st[32], dpt[32], dqa[DQN / 2];
  uint32_t pa[4][4];
  uint8_t* ds = smem + L::DS;
  float* staged = reinterpret_cast<float*>(smem + L::DQ);
  const uint64_t dk = sw128_desc(smem + L::K + wg * 64 * 128, 16);
  const uint64_t dv = sw128_desc(smem + L::V + wg * 64 * 128, 16);
  const uint64_t dq_ = sw128_desc(smem + L::Q, 16);
  const uint64_t ddo = sw128_desc(smem + L::DO, 16);
  const uint64_t dqt = sw128_desc(smem + L::Q, 1024);    // MN-major B
  const uint64_t ddot = sw128_desc(smem + L::DO, 1024);
  const uint64_t dsk = sw128_desc(ds + wg * 64 * 128, 16);  // dS^T, K-major A
  const uint64_t dsm = sw128_desc(ds, 1024);    // dS, MN-major A
  const uint64_t dkt = sw128_desc(smem + L::K, 1024);    // K, MN-major B
  wait_bar(&bars[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST, q0 = (qt_last - it) * BQ2;
    const uint64_t so = s * (NP * L::PQ / 16);
    const float* stats =
        reinterpret_cast<const float*>(smem + L::STATS + s * 2 * STAT * 4);
    wait_bar(&bars[1 + s], (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // S^T = K Q^T: 64 keys x 64 queries
        const uint64_t a = dk + (pn * L::PKV + 32 * j) / 16;
        const uint64_t b = dq_ + so + (pn * L::PQ + 32 * j) / 16;
        if (pn + j == 0)
          wgmma_ss<64, F16, false, false, false>(st, a, b);
        else
          wgmma_ss<64, F16, false, false, true>(st, a, b);
      }
    wgmma_commit();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // dP^T = V dO^T
        const uint64_t a = dv + (pn * L::PKV + 32 * j) / 16;
        const uint64_t b = ddo + so + (pn * L::PQ + 32 * j) / 16;
        if (pn + j == 0)
          wgmma_ss<64, F16, false, false, false>(dpt, a, b);
        else
          wgmma_ss<64, F16, false, false, true>(dpt, a, b);
      }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<32>(st);
    // P^T under dP^T's products.  Causal: only the tiles with a query below
    // this warp's last key mask (queries past S have lse2 = +inf: P = 0)
    const bool mask = causal && q0 < key - g + 15;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1), r = (i >> 1) & 1;
      float x = fast_exp2(fmaf(st[i], p.scale_log2, -stats[c]));
      if (mask) x = q0 + c < key + 8 * r ? 0.0f : x;
      if (past_s) x = key + 8 * r >= p.S ? 0.0f : x;
      st[i] = x;
    }
    wgmma_wait<0>();
    reg_fence<32>(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      dpt[i] = st[i] * (dpt[i] - stats[STAT + c]);   // dS^T
    }
    pack_a<T16>(st, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)   // dV += P^T dO
        wgmma_rs_n64_tb<F16>(av[pn], pa[kk],
                             ddot + so + (pn * L::PQ + 2048 * kk) / 16);
    wgmma_commit();
    // dS^T into shared memory under dV's products, once both warpgroups'
    // products of the last tile are done with it
    if (it > 0) consumers_sync(BAR_DS_FREE);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * wg + 16 * w + g + 8 * r;
        *reinterpret_cast<uint32_t*>(ds + swz<BKV>(row, 8 * j + 2 * t)) =
            pack2(dpt[4 * j + 2 * r], dpt[4 * j + 2 * r + 1],
                  static_cast<T16*>(nullptr));
      }
    fence_proxy_async();
    consumers_sync(BAR_DS_READY);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)   // dK += dS^T Q
        wgmma_ss<64, F16, false, true, true>(
            ak[pn], dsk + (32 * kk) / 16,
            dqt + so + (pn * L::PQ + 2048 * kk) / 16);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {   // dQ = dS K over 128 keys
      const uint64_t a = dsm + (2048 * kk) / 16;
      const uint64_t b = dkt + ((dq_col / 64) * L::PKV + 2 * (dq_col % 64) +
                                2048 * kk) / 16;
      if (kk == 0)
        wgmma_ss<DQN, F16, true, true, false>(dqa, a, b);
      else
        wgmma_ss<DQN, F16, true, true, true>(dqa, a, b);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      reg_fence<32>(av[pn]);
      reg_fence<32>(ak[pn]);
    }
    reg_fence<DQN / 2>(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[1 + ST + s]);
    // dQ into the staging tile, once the writer has read the last one
    if (it > 0) wait_bar(&bars[L::DQ_EMPTY], (it - 1) & 1);
    float* panel = staged + (dq_col / 64) * DQ_PANEL;
#pragma unroll
    for (int j = 0; j < DQN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * w + g + 8 * r;
        const int chunk = ((dq_col % 64) / 4 + 2 * j + (t >> 1)) ^ (row & 7);
        *reinterpret_cast<float2*>(panel + row * 64 + 4 * chunk +
                                   2 * (t & 1)) =
            make_float2(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
      }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[L::DQ_FULL]);
  }
#pragma unroll
  for (int pn = 0; pn < NP; ++pn) {
    store_acc<T16, 32>(p.dk, p, hd, ak[pn], 64 * pn, key, t, p.scale);
    store_acc<T16, 32>(p.dv, p, hd, av[pn], 64 * pn, key, t, 1.0f);
  }
}

// ---- (3) the dQ post-pass ----------------------------------------------------

// A block: one 64-row query tile (blockIdx.x = bh * qtiles + qt); a thread
// 8 columns of a row at a time, two 16-byte chunks of dq_acc in, 16 bytes
// of dq out.
template <int NP, typename T16>
__global__ void __launch_bounds__(POST_THREADS)
dq_post_kernel(const Params p) {
  const int bh = blockIdx.x / p.qtiles, qt = blockIdx.x % p.qtiles;
  const Head hd = head_of(p, bh);
  const float* acc = p.dq_acc + (long long)blockIdx.x * NP * DQ_PANEL;
  for (int e = threadIdx.x; e < 64 * NP * 8; e += POST_THREADS) {
    const int r = e / (NP * 8), pn = (e / 8) % NP, c8 = e % 8;
    const int row = qt * 64 + r, col = 64 * pn + 8 * c8;
    if (row >= p.S || col >= p.D) continue;
    const float* src = acc + pn * DQ_PANEL + r * 64;
    const float4 x = *reinterpret_cast<const float4*>(
        src + 4 * ((2 * c8) ^ (r & 7)));
    const float4 y = *reinterpret_cast<const float4*>(
        src + 4 * ((2 * c8 + 1) ^ (r & 7)));
    T16* const tag = nullptr;
    uint4 o;
    o.x = pack2(x.x * p.scale, x.y * p.scale, tag);
    o.y = pack2(x.z * p.scale, x.w * p.scale, tag);
    o.z = pack2(y.x * p.scale, y.y * p.scale, tag);
    o.w = pack2(y.z * p.scale, y.w * p.scale, tag);
    *reinterpret_cast<uint4*>(static_cast<T16*>(p.dq) + hd.base +
                              (long long)row * hd.rstride + col) = o;
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

// The counters' reset, the statistics pre-pass, the main kernel and the
// dQ post-pass, in stream order.
template <int NP, bool F16>
int launch_h16(const Params& p, int b, cudaStream_t st) {
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  // tensor maps: K and V by 128 rows, Q and dO by 64
  const void* ptrs[4] = {p.k, p.v, p.q, p.dout};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) {
    const int err = make_map(&m[i], ptrs[i], b, p.S, p.H, p.D, F16,
                             i < 2 ? BKV : BQ2);
    if (err) return err;
  }
  const long long kv_blocks = (long long)((p.S + BKV - 1) / BKV) * p.BH;
  const long long stat_blocks = (long long)p.stiles * p.BH;
  const long long post_blocks = (long long)p.qtiles * p.BH;
  if (std::max(kv_blocks, std::max(stat_blocks, post_blocks)) > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int err = static_cast<int>(cudaMemsetAsync(
      p.dq_count, 0, sizeof(int) * (size_t)post_blocks, st));
  if (err) return err;
  stats_kernel<T16><<<(unsigned)stat_blocks, STATS_THREADS, 0, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch(bwd_h16_kernel<NP, F16>, THREADS, BwdSmem<NP>::BYTES,
               (unsigned)kv_blocks, st, m[0], m[1], m[2], m[3], p);
  if (err) return err;
  dq_post_kernel<NP, T16><<<(unsigned)post_blocks, POST_THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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
// 2 * ceil(s / 128).  16-bit only (null for float32): `dq_acc` float32
// scratch of b * h * ceil(s / 64) * np * 4096 floats, np = 1 for d <= 64
// and 2 above, and `dq_count` int32 scratch of b * h * ceil(s / 64) ints.
// `scale` multiplies the scores.  Launches on `stream` (16-bit: a memset
// and three kernels; float32: the dQ pass and the dK/dV pass); returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for operands
// it does not take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* stats, float* dq_acc, int* dq_count, int b, int s, int h, int d,
    float scale, int causal, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[12] = {q, k, v, o, dout, lse, dq, dk, dv, stats, dq_acc,
                          dq_count};
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  if (d < 8 || d > 128 || d % 8 || dtype < 0 || dtype > 2 || s < 1 ||
      b < 1 || h < 1 || (dtype != 0 && (dq_acc == nullptr ||
                                        dq_count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,     k,      v,         o,         dout,  lse,
           dq,    dk,     dv,        stats,     dq_acc, dq_count,
           s,     h,      d,         scale,     scale * LOG2E,
           causal, b * h, 2 * ((s + 127) / 128), (s + 63) / 64};
  if (dtype == 0) {
    const long long blocks = (long long)((s + BF - 1) / BF) * b * h;
    if (blocks > 0x7fffffffll)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    return d <= 64 ? launch_f32<1>(p, (unsigned)blocks, st)
                   : launch_f32<2>(p, (unsigned)blocks, st);
  }
  if (dtype == 2)
    return d <= 64 ? launch_h16<1, true>(p, b, st)
                   : launch_h16<2, true>(p, b, st);
  return d <= 64 ? launch_h16<1, false>(p, b, st)
                 : launch_h16<2, false>(p, b, st);
}
