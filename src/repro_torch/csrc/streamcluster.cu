// Streamcluster dist for Hopper (sm_90a), plain C interface: pairwise
// squared euclidean distances max(|p|^2 + |c|^2 - 2 p.c, 0), [M,D] x [N,D]
// -> [M,N] float32, inputs float32, bfloat16 or float16.
//
// Replaces the Pallas kernel repro/kernels/streamcluster.py:29
// (streamcluster_dist, pallas_call at :36), which put p.c on the TPU's
// matrix unit.  At PARSEC simlarge (16,384 points x 4,096 centers x 128
// dimensions) the output alone is 268 MB of float32 (0.080 ms at 3.35
// TB/s), the products 17.2 GFLOP (0.017 ms at the dense 16-bit tensor rate
// of 989 TFLOP/s; 0.104 ms as three TF32 products at 495): a 16-bit call
// is bound by its output's bytes, a float32 one by its 3xTF32 products.
//
// One kernel for the three types (streamcluster_kernel): 256 threads (two
// warpgroups) per 128 x 128 output tile, D walked in panels of 128-byte
// rows (64 columns of a 16-bit type, 32 of float32): the tile's 128 P rows
// and 128 C rows, 128-byte swizzled, K-major both (as flash attention's Q
// and K), in a ring of two stages.  Warpgroup w multiplies P rows 64 w ..
// 64 w + 63 by all 128 C rows on wgmma (m64n128, float32 sums).  The
// panels come by TMA (a 2-D tensor map over [rows, D], box 128 bytes x 128
// rows, its out-of-bounds zero fill covering the ragged edges) where the
// rows are 16-byte aligned (D a multiple of 16 bytes, aligned bases);
// otherwise every thread writes the same swizzled panel with plain loads,
// one panel at a time.  The row norms are fused: each thread forms the
// float32 |x|^2 of one of the tile's rows from the panels it holds.
//
// The output write is the bound, so the CTAs are persistent (one an SM,
// each walking its tiles, its panels one stream through the stages: the
// next tile's load while this one's products and epilogue run), and the
// epilogue stages the tile's distances in shared memory as four
// 128-byte-swizzled boxes of 32 columns, which one thread stores by TMA
// while the next tile's products run (rows not 16-byte aligned: 8-byte
// stores from the accumulators).  Ragged M, N and D: rows and columns past
// them load as 0 and are not stored.
//
// bfloat16 / float16: m64n128k16, a 16-bit product exact in float32.
//
// float32: 3xTF32 (split_tf32 of tf32.cuh: each operand x = big + small,
// two TF32 values, and each product small*big + big*small + big*big with
// float32 sums, float32's accuracy; plain TF32 misses the 2e-4 bar) on
// m64n128k8.tf32.  When a panel lands, each thread splits its row in place
// (big) and into a second panel (small), while forming its norm; the
// panel's three products then sum on the tensor cores from zero and are
// added to the running sums in float32: the tensor cores' own sums
// truncate, and at a distance of 0 (a point among the centers) p.c cancels
// |p|^2 + |c|^2 ~ 43, where sums over all of D left ~3e-4.

#include <cuda.h>   // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int BM = 128, BN = 128, THREADS = 256;
// How the kernel fills its panels (the wrapper picks, the entry point
// checks): by TMA or by plain loads.
enum Load { LOAD_TMA = 0, LOAD_LD = 2 };

// Shared memory, by type (TY 0 float32, 1 bfloat16, 2 float16): a stage
// holds a panel of 128 P rows and one of 128 C rows, 16 KB each (float32:
// then their small halves, 16 KB each); then the output tile staged for
// its TMA store (four 32-column boxes of 128 rows, 64 KB), two full
// barriers and the 256 row norms.
constexpr int PANEL = 128 * 128;
template <int TY>
struct Smem {
  static constexpr int STAGE = (TY == 0 ? 4 : 2) * PANEL;
  static constexpr int OUT = 2 * STAGE;
  static constexpr int BARS = OUT + 4 * PANEL;
  static constexpr int NORMS = BARS + 64;
  static constexpr int BYTES = NORMS + 256 * 4 + 1024;   // + alignment
};

// ---- barriers, copies, fences -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `parity` has completed; trap after ~2^33 cycles
// (~4 s), so a load that never lands fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// The box at (c0, c1) of `map` from shared memory at `src` (a bulk group).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled K-major tile at
// `p`: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64] (+)= A(smem desc) * B(smem desc), m64n128 (K a 32-byte step:
// k16 of f16 or bf16, k8 of tf32), f32 sums; both operands K-major.  `acc`
// 0 overwrites d.  TAIL: the transpose operands, which tf32 has not.
#define WGMMA_SS_N128(SHAPE, TY, TAIL)                                         \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %66, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " "              \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                 \
      "}, %64, %65, p, 1, 1" TAIL ";\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "l"(da), "l"(db), "r"(acc))

template <int TY>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db, int acc) {
  if constexpr (TY == 2)
    WGMMA_SS_N128("m64n128k16", "f16", ", 0, 0");
  else if constexpr (TY == 1)
    WGMMA_SS_N128("m64n128k16", "bf16", ", 0, 0");
  else
    WGMMA_SS_N128("m64n128k8", "tf32", "");
}

// ---- the epilogue -----------------------------------------------------------

// max(|p|^2 + |c|^2 - 2 acc, 0) for a thread's two neighbouring columns
// (n, n + 1) of output row m, stored as one 8-byte store where both lie in
// the row and N is even (8-byte aligned), else one by one.
__device__ __forceinline__ void store_pair(float* out, int M, int N, int m,
                                           int n, float pm, const float* cn,
                                           float a0, float a1) {
  if (m >= M || n >= N) return;
  const float v0 = fmaxf(pm + cn[0] - 2.0f * a0, 0.0f);
  const float v1 = fmaxf(pm + cn[1] - 2.0f * a1, 0.0f);
  float* o = out + (long long)m * N + n;
  if (n + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (n + 1 < N) o[1] = v1;
  }
}

// ---- the kernel ----------------------------------------------------------

// Byte offset of the 16-byte chunk ch of row r of a panel of 128-byte rows,
// 128-byte swizzled: at chunk ch ^ (r % 8), as TMA writes it.
__device__ __forceinline__ int swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// Rows [row0, row0 + 128) of a [rows, D] matrix of `EL`-byte elements,
// the panel's 128 / EL columns from col0, into a swizzled panel by plain
// loads, zero past `rows` and D.
template <int EL>
__device__ __forceinline__ void load_panel(uint8_t* dst, const void* src,
                                           int row0, int rows, int col0,
                                           int D, int tid) {
  using U = typename std::conditional<EL == 4, uint32_t, uint16_t>::type;
  constexpr int PW = 128 / EL;   // elements a panel row
  for (int e = tid; e < 128 * PW; e += THREADS) {
    const int r = e / PW, c = e % PW;
    U x = 0;
    if (row0 + r < rows && col0 + c < D)
      x = static_cast<const U*>(src)[(long long)(row0 + r) * D + col0 + c];
    *reinterpret_cast<U*>(dst + swz(r, c * EL / 16) + c * EL % 16) = x;
  }
}

template <int TY>
__device__ __forceinline__ float widen(uint32_t x, int half) {
  const unsigned short h = half ? (unsigned short)(x >> 16)
                                : (unsigned short)(x & 0xffffu);
  if constexpr (TY == 2)
    return __half2float(__ushort_as_half(h));
  else
    return __bfloat162float(__ushort_as_bfloat16(h));
}

// Thread 0: panel kp of the tile's P rows (from m0) and C rows (from n0)
// by TMA into stage u % 2 (u counts the CTA's panels over its tiles),
// signalled on that stage's full barrier.
template <int TY>
__device__ __forceinline__ void issue_panel(uint8_t* smem, uint64_t* full,
                                            const CUtensorMap* tp,
                                            const CUtensorMap* tc, int u,
                                            int kp, int m0, int n0) {
  constexpr int PW = TY == 0 ? 32 : 64;   // elements a panel row
  uint8_t* st = smem + (u & 1) * Smem<TY>::STAGE;
  mbar_expect_tx(&full[u & 1], 2 * PANEL);
  tma_load_2d(st, tp, &full[u & 1], kp * PW, m0);
  tma_load_2d(st + PANEL, tc, &full[u & 1], kp * PW, n0);
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ...; the panels of its
// tiles form one stream through the two stages.  `tma_out`: the output
// tile goes out by TMA from its staged copy, which is written again only
// once that store has read it.
template <int TY>
__global__ void __launch_bounds__(THREADS, 1)
streamcluster_kernel(const __grid_constant__ CUtensorMap tp,
                     const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap to,
                     const void* __restrict__ P, const void* __restrict__ C,
                     float* __restrict__ out, int M, int N, int D, int load,
                     int tma_out, int tiles_n, int tiles) {
  using L = Smem<TY>;
  constexpr bool F32 = TY == 0;
  constexpr int EL = F32 ? 4 : 2, PW = 128 / EL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staged = smem + L::OUT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  float* norms = reinterpret_cast<float*>(smem + L::NORMS);
  const int tid = threadIdx.x, wg = tid / 128;
  const int npan = (D + PW - 1) / PW;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;   // this CTA's tiles
  const int total = mine * npan;     // and their panels
  const bool tma = load == LOAD_TMA;
  auto corner = [&](int i, int& m0, int& n0) {   // the CTA's i-th tile
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    m0 = (t / tiles_n) * BM;
    n0 = (t % tiles_n) * BN;
  };
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tma && tid == 0)
    for (int u = 0; u < min(2, total); ++u) {
      int m0, n0;
      corner(u / npan, m0, n0);
      issue_panel<TY>(smem, full, &tp, &tc, u, u % npan, m0, n0);
    }

  // this thread's norm: P row tid (tid < 128) or C row tid - 128
  const int nrow = tid & 127;
  const int nsel = tid < 128 ? 0 : PANEL;
  const int w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  // panel u of the stream in its stage: landed (TMA) or loaded (plain
  // loads; the caller synchronizes after a 16-bit load)
  auto arrive = [&](int u) {
    uint8_t* st = smem + (u & 1) * L::STAGE;
    if (tma) {
      mbar_wait(&full[u & 1], (u >> 1) & 1);
    } else {
      int m0, n0;
      corner(u / npan, m0, n0);
      load_panel<EL>(st, P, m0, M, (u % npan) * PW, D, tid);
      load_panel<EL>(st + PANEL, C, n0, N, (u % npan) * PW, D, tid);
    }
  };
  // float32: panel u landed, then this thread's row split in place (big)
  // and into the small panel two panels on; returns the row's share of
  // its norm.  The caller fences and synchronizes before the products.
  auto split = [&](int u) {
    uint8_t* st = smem + (u & 1) * L::STAGE;
    arrive(u);
    if (!tma) __syncthreads();
    float nrm = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      float4* x = reinterpret_cast<float4*>(st + nsel + swz(nrow, ch));
      const float4 v = *x;
      nrm += v.x * v.x;
      nrm += v.y * v.y;
      nrm += v.z * v.z;
      nrm += v.w * v.w;
      uint32_t b[4], sm[4];
      split_tf32(v.x, b[0], sm[0]);
      split_tf32(v.y, b[1], sm[1]);
      split_tf32(v.z, b[2], sm[2]);
      split_tf32(v.w, b[3], sm[3]);
      *x = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                       __uint_as_float(b[2]), __uint_as_float(b[3]));
      *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(x) +
                                 2 * PANEL) =
          make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                      __uint_as_float(sm[2]), __uint_as_float(sm[3]));
    }
    return nrm;
  };
  // float32 splits the stream's next panel while this one's products run;
  // a panel of the next tile keeps its norm share for that tile
  float nrm_next = 0.0f;
  if (F32 && total > 0) {
    nrm_next = split(0);
    fence_proxy_async();   // the split panels visible to wgmma
    __syncthreads();
  }
  for (int i = 0; i < mine; ++i) {
    int m0, n0;
    corner(i, m0, n0);
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    float nrm = nrm_next;
    nrm_next = 0.0f;
    for (int kp = 0; kp < npan; ++kp) {
      const int u = i * npan + kp;
      uint8_t* st = smem + (u & 1) * L::STAGE;
      const uint64_t da = sw128_desc(st + wg * 64 * 128);
      const uint64_t db = sw128_desc(st + PANEL);
      if constexpr (F32) {
        // the panel's products from zero, then into acc in float32
        float part[64];
        const uint64_t das = da + 2 * PANEL / 16, dbs = db + 2 * PANEL / 16;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // 8 columns of D a step
          wgmma_n128<TY>(part, das + 2 * j, db + 2 * j, j);
          wgmma_n128<TY>(part, da + 2 * j, dbs + 2 * j, 1);
          wgmma_n128<TY>(part, da + 2 * j, db + 2 * j, 1);
        }
        wgmma_commit();
        if (u + 1 < total) {   // the other stage
          const float share = split(u + 1);
          if (kp + 1 < npan)
            nrm += share;
          else
            nrm_next += share;
        }
        wgmma_wait0();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          asm volatile("" : "+f"(part[e])::"memory");
          acc[e] += part[e];
        }
        fence_proxy_async();   // the next panel's split visible to wgmma
      } else {
        arrive(u);
        if (!tma) {
          fence_proxy_async();
          __syncthreads();
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)   // 16 columns of D a step
          wgmma_n128<TY>(acc, da + 2 * j, db + 2 * j, 1);
        wgmma_commit();
        // the norms' share of this panel while the products run
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              st + nsel + swz(nrow, ch));
          const uint32_t x4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float x = widen<TY>(x4[q / 2], q & 1);
            nrm += x * x;
          }
        }
        wgmma_wait0();
#pragma unroll
        for (int e = 0; e < 64; ++e)
          asm volatile("" : "+f"(acc[e])::"memory");
      }
      __syncthreads();   // both warpgroups are done with the stage
      if (tma && tid == 0 && u + 2 < total) {   // the stream's next panel
        int m1, n1;
        corner((u + 2) / npan, m1, n1);
        issue_panel<TY>(smem, full, &tp, &tc, u + 2, (u + 2) % npan, m1,
                        n1);
      }
    }
    // the staged tile is free once the last tile's store has read it
    if (tma_out && tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    norms[tid] = nrm;
    __syncthreads();

    // accumulator d[4 j + 2 h + e]: row 16 w + g + 8 h of the warpgroup's
    // 64, column 8 j + 2 t + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + 16 * w + g + 8 * h;
      const float pm = norms[r];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;
        const float* cn = norms + 128 + c;
        if (tma_out) {
          // box c / 32, row r, its 16-byte chunk (c % 32) / 4
          float* o = reinterpret_cast<float*>(
              staged + (c >> 5) * PANEL + swz(r, (c & 31) >> 2) +
              (c & 3) * 4);
          *reinterpret_cast<float2*>(o) = make_float2(
              fmaxf(pm + cn[0] - 2.0f * acc[4 * j + 2 * h], 0.0f),
              fmaxf(pm + cn[1] - 2.0f * acc[4 * j + 2 * h + 1], 0.0f));
        } else {
          store_pair(out, M, N, m0 + r, n0 + c, pm, cn, acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
        }
      }
    }
    if (tma_out) {
      fence_proxy_async();   // the staged tile visible to the TMA store
      __syncthreads();
      if (tid == 0) {
        for (int b = 0; b < 4 && n0 + 32 * b < N; ++b)
          tma_store_2d(&to, staged + b * PANEL, n0 + 32 * b, m0);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      __syncthreads();   // the norms are written again for the next tile
    }
  }
  if (tma_out && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is looked
// up in the libcuda.so.1 the process has loaded, so this library links
// against the runtime only.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A 2-D map over a [rows, cols] matrix of `type` (`size` bytes an element):
// dims innermost first (cols, rows), box 128 bytes x 128 rows, 128-byte
// swizzle, zero fill past the edges on loads (a store past them writes
// nothing).
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
             CUtensorMapDataType type, int size) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * size};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / size), 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// One CTA an SM, each walking its tiles; the output by TMA where its rows
// are 16-byte aligned (n % 4 == 0, an aligned base).
template <int TY>
int launch(const void* p, const void* c, float* out, int m, int n, int d,
           int load, int tiles, int tiles_n, cudaStream_t st) {
  const CUtensorMapDataType type = TY == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : TY == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int el = TY == 0 ? 4 : 2;
  CUtensorMap maps[3] = {};
  int e = 0;
  if (load == LOAD_TMA) {
    e = make_map(&maps[0], p, m, d, type, el);
    if (!e) e = make_map(&maps[1], c, n, d, type, el);
  }
  const bool tma_out = n % 4 == 0 && aligned(out, 16);
  if (!e && tma_out)
    e = make_map(&maps[2], out, m, n, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  if (e) return e;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto kern = streamcluster_kernel<TY>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<TY>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = tiles < sms ? tiles : sms;
  kern<<<grid, THREADS, Smem<TY>::BYTES, st>>>(
      maps[0], maps[1], maps[2], p, c, out, m, n, d, load, tma_out ? 1 : 0,
      tiles_n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Distances of p [m, d] to c [n, d] (m, n, d >= 1) into out [m, n],
// `dtype` 0 float32, 1 bfloat16 or 2 float16.  `load` is how the panels
// are filled: 0 (TMA: rows of a multiple of 16 bytes, 16-byte aligned
// bases) or 2 (plain loads).  Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a `load`
// the operands do not allow.
extern "C" int streamcluster_dist_launch(const void* p, const void* c,
                                         float* out, int m, int n, int d,
                                         int dtype, int load, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || n < 1 || d < 1 || dtype < 0 || dtype > 2) return bad;
  const int tiles_n = (n + BN - 1) / BN;
  const long long tiles = (long long)((m + BM - 1) / BM) * tiles_n;
  if (tiles > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int el = dtype == 0 ? 4 : 2;
  const bool ok16 = (long long)d * el % 16 == 0 && aligned(p, 16) &&
                    aligned(c, 16);
  if ((load == LOAD_TMA && !ok16) || (load != LOAD_TMA && load != LOAD_LD))
    return bad;
  if (dtype == 1)
    return launch<1>(p, c, out, m, n, d, load, (int)tiles, tiles_n, st);
  if (dtype == 2)
    return launch<2>(p, c, out, m, n, d, load, (int)tiles, tiles_n, st);
  return launch<0>(p, c, out, m, n, d, load, (int)tiles, tiles_n, st);
}
