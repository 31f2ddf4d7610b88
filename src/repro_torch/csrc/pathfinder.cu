// Pathfinder (Rodinia), the row-by-row dynamic program, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/pathfinder.py:43 (pathfinder,
// pallas_call at :46), which kept the running cost row in VMEM across a
// sequential grid of one step per wall row: cost = wall[0], then for every
// later row cost = wall[i] + min(cost, cost shifted left, cost shifted
// right), the columns past both ends holding the Pallas kernel's _INF,
// 3.0e38 (END below; not +inf, which repro/kernels/ref.py pads with); the
// result is the last cost row, float32 [C], from an int32 or float32 wall
// [R, C].
//
// Bound on an H100: bytes.  The wall is read once (642 MB at 1,604 rows x
// 100,000 columns of int32: 0.19 ms) against 3 operations a cell.  The rows
// are a sequential dependency; two routes carry it across the card.
//
// The strip route (pathfinder_strips_kernel), one cooperative launch for
// all rows.  CTA g owns the columns [g S, (g + 1) S) of every row and holds
// them in registers from row 0 to the end.  The rows go in phases of H:
// each row warp holds a window of 256 columns, eight a lane (neighbours by
// shuffles), and runs the phase's H rows over it, so after H rows its
// middle 256 - 2 H columns are right (Rodinia's ghost zone, at the scale
// of a warp); the warps' middles tile the strip and no warp waits on
// another inside a phase.  Between phases the middles meet in shared
// memory (one barrier of the row warps), and a CTA needs only its two
// neighbours' H edge values of the row the phase starts from: the lanes
// holding a strip's first and last H columns store them into a slot of
// device memory (two slots, by the phase's parity), each value beside its
// phase number in one 8-byte word, so a single-copy-atomic relaxed store
// publishes it and a relaxed load that sees the tag sees the value (no
// flag, no fence).  A slot is written again two phases later only after
// the writer has read the reader's next edges, which the reader writes
// after reading the slot.  One more warp loads: the wall streams in by TMA
// bulk copies, one a row of the window, into a ring of slabs of SR rows
// with a "full" and an "empty" mbarrier each, so the row warps never
// issue a copy (at Rodinia's size: 0.62 ms with per-phase tiles by
// cp.async from the computing warps and flags, 0.35 with TMA issued by one
// of them, 0.29 with the loading warp; scripts/pathfinder_variants.py,
// NVIDIA H100 80GB HBM3, 700 W).  Where C or the wall is not 16-byte
// aligned, the loading warp copies 4 bytes at a time.  Co-residency: the
// launch is cooperative, so a grid that cannot be resident fails
// (cudaErrorCooperativeLaunchTooLarge) instead of deadlocking.  The edge
// words are zeroed by a memset on the same stream before the kernel: two
// device operations a call.  The host picks S, H, SR and the CTA count
// (repro_torch/kernels/pathfinder.py:route).
//
// The pyramid route (pathfinder_pyramid_kernel): the strip route's ghost
// zone at the scale of a warp, with no block barrier, no shared memory and
// no edge words.  Warp g owns a window of 32 K columns, K consecutive a
// lane (neighbours by shuffles), from column g M - G, and runs h rows over
// it; the ghost zone G is h rounded up to 4 columns a side, so after h
// rows the middle M = 32 K - 2 G columns are right, and the middles tile
// the row (K = 8: windows of 256 columns, middles of 176 or more).  The
// wall's rows come into a ring of D = 8 rows in registers: row i + D is
// loaded when row i is done, so D rows' loads are in flight while one is
// computed.  The rows are a chain of dependent steps in each warp, and
// only about C / M warps exist (3.5 an SM at Rodinia's width), so the
// step is kept short: only the two windows that reach past the wall's
// ends mask their outside columns to END after every row (a warp-uniform
// branch), and over an int32 wall, whose costs are never NaN or -0, the
// mins are the hardware's (cmin).  Loads and stores are 16 bytes wide
// where C is a multiple of 4 and the wall starts on 16 bytes (G, M and K
// are multiples of 4, so a window's groups of four columns are wholly in
// or out of the wall), 4 bytes wide otherwise.  One launch runs every
// wall of at most 41 rows (h = R - 1 <= 40: no scratch row); a longer one
// takes ceil((R - 1) / 40) launches of equal h, each reading the cost row
// the last wrote (two buffers in turn).  The host's plan
// (repro_torch/kernels/pathfinder.py:pyramid_plan) gives h, G, M, the
// windows and the launches; the launch checks it against the window of 32
// K columns and rejects one that does not tile the row.  Rodinia's own
// pyramid (256-column blocks, 20 rows a launch, one __syncthreads a row)
// took 0.0069 ms of device time on the first 21 rows of its wall and
// 0.6537 ms in 81 launches on all 1,604 (scripts/pathfinder_variants.py,
// which keeps it to time beside this one as `rodinia`; NVIDIA H100 80GB
// HBM3, 700 W).  The pyramid takes walls of at most 41 rows, those of at
// most 81 rows and 100,000 columns, and the walls whose strips do not
// fit a CTA (pathfinder.py: route).
//
// Both take min in the plain version's order with torch.minimum's NaN rule
// (the pyramid, over an int32 wall, with the hardware's min: the same
// bits there) and add each row once, so both equal the plain version
// (repro_torch/kernels/ref.py:pathfinder) bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float END = 3.0e38f;   // past both ends: the Pallas kernel's _INF

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int32_t v) { return (float)v; }

// torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// One row of the dynamic program at a column: w + min(v, min(l, r)).
__device__ __forceinline__ float step(float w, float v, float l, float r) {
  return w + tmin(v, tmin(l, r));
}

// ---- the pyramid route ------------------------------------------------------

// The pyramid's windows: PYR_K columns a lane (a window of 256), a ring
// of PYR_D wall rows in registers, one warp a block.  Four columns a
// lane (more warps, more ghost columns), rings of 4 and 16 rows and blocks
// of 4 warps were no faster over walls of 21 and 41 rows
// (scripts/pathfinder_variants.py, NVIDIA H100 80GB HBM3, 700 W).
constexpr int PYR_K = 8, PYR_D = 8, PYR_WARPS = 1;

// Four columns in one 16-byte load.
template <typename W> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int32_t> { using T = int4; };

// K columns of row `p` (a wall row or a cost row) from column x into `w`,
// the columns whose bit of `inside` is set (0 in the others): 16 bytes at
// a time where `vec` (then a group of four columns is wholly inside or
// wholly out), else one column at a time.
template <int K, typename W>
__device__ __forceinline__ void load_cols(const W* __restrict__ p,
                                          long long x, unsigned inside,
                                          bool vec, W* w) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      typename Vec4<W>::T u = {0, 0, 0, 0};
      if (inside >> q & 1u)
        u = *reinterpret_cast<const typename Vec4<W>::T*>(p + x + q);
      w[q] = u.x;
      w[q + 1] = u.y;
      w[q + 2] = u.z;
      w[q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = inside >> j & 1u ? p[x + j] : W(0);
  }
}

// The min of two costs as torch.minimum takes it.  Over a float wall:
// tmin (NaN if either is NaN, else the smaller, b where they compare
// equal: -0 and +0).  An int32 wall's costs are finite and never NaN or
// -0 (its values widened to float, sums of them and of the ends'
// 3.0e38), so there the hardware's min (one instruction, where tmin takes
// three) gives the same bits.
template <typename W> __device__ __forceinline__ float cmin(float a, float b);
template <> __device__ __forceinline__ float cmin<float>(float a, float b) {
  return tmin(a, b);
}
template <> __device__ __forceinline__ float cmin<int32_t>(float a, float b) {
  return fminf(a, b);
}

// The rows row0 .. row0 + nrows - 1 over this lane's K columns `v`, the
// wall's first D of them already in the ring `w` and `next` at row
// row0 + D: row i + D is loaded as soon as row i is done, so D rows are in
// flight while one is computed.  EDGE: some lane's columns lie past an
// end of the wall, and hold END after every row (the bits of `inside`); a
// window inside the wall skips that mask and loads unpredicated.
template <typename W, int K, int D, bool EDGE>
__device__ __forceinline__ void pyramid_rows(const W* __restrict__ next,
                                             int nrows, int C, long long x,
                                             unsigned inside, bool vec,
                                             int lane, float (&v)[K],
                                             W (&w)[D][K]) {
  if (!EDGE) inside = (1u << K) - 1;
  for (int i0 = 0; i0 < nrows; i0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (i0 + d >= nrows) break;   // the same for the whole grid
      float l = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
      float r = __shfl_down_sync(0xffffffffu, v[0], 1);
      if (lane == 0) l = END;     // the window's ends: its ghost zone
      if (lane == 31) r = END;
      float n[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        n[j] = to_f(w[d][j]) +
               cmin<W>(v[j], cmin<W>(j == 0 ? l : v[j - 1],
                                     j == K - 1 ? r : v[j + 1]));
#pragma unroll
      for (int j = 0; j < K; ++j)
        v[j] = !EDGE || inside >> j & 1u ? n[j] : END;
      if (i0 + d + D < nrows) {
        load_cols<K>(next, x, inside, vec, w[d]);
        next += C;
      }
    }
  }
}

// One launch of the pyramid: rows row0 .. row0 + nrows - 1 over the cost
// row `in` (wall row 0 where `in` is null) into `out`.  Warp g owns the
// window of 32 K columns from g M - G (M = 32 K - 2 G, G >= nrows), K
// consecutive columns a lane, neighbours by shuffles; after nrows rows
// the window's middle M columns are right and the middles tile the row.
template <typename W, int K, int D>
__global__ void __launch_bounds__(PYR_WARPS * 32)
pathfinder_pyramid_kernel(const W* __restrict__ wall,
                          const float* __restrict__ in,
                          float* __restrict__ out, long long row0, int nrows,
                          int C, int G, int M, long long windows, int vec) {
  const int lane = threadIdx.x & 31;
  const long long g =
      (long long)blockIdx.x * PYR_WARPS + (threadIdx.x >> 5);
  if (g >= windows) return;   // the whole warp
  const long long x = g * M - G + lane * K;   // this lane's first column
  unsigned inside = 0;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (x + j >= 0 && x + j < C) inside |= 1u << j;
  float v[K];
  if (in) {
    load_cols<K>(in, x, inside, vec != 0, v);
  } else {
    W w0[K];
    load_cols<K>(wall, x, inside, vec != 0, w0);
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = to_f(w0[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = inside >> j & 1u ? v[j] : END;
  W w[D][K];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < nrows) load_cols<K>(wall + (row0 + d) * C, x, inside, vec != 0,
                                w[d]);
  const W* next = wall + (row0 + D) * C;
  if (__any_sync(0xffffffffu, inside != (1u << K) - 1))
    pyramid_rows<W, K, D, true>(next, nrows, C, x, inside, vec != 0, lane,
                                v, w);
  else
    pyramid_rows<W, K, D, false>(next, nrows, C, x, inside, vec != 0, lane,
                                 v, w);
  // the middle: window columns [G, G + M)
#pragma unroll
  for (int q = 0; q < K; q += 4) {
    const int m = lane * K + q - G;
    if (m < 0 || m >= M) continue;   // four columns wholly in or out
    if (vec && (inside >> q & 0xfu) == 0xfu) {
      *reinterpret_cast<float4*>(out + x + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
#pragma unroll
      for (int j = q; j < q + 4; ++j)
        if (inside >> j & 1u) out[x + j] = v[j];
    }
  }
}

// The host's plan (repro_torch/kernels/pathfinder.py:pyramid_plan), held
// to this kernel's window: h rows a launch over n launches covering the r
// - 1 rows after the first, ghost zones of g >= h columns a side (a
// multiple of 4), middles of m = 32 PYR_K - 2 g columns, `windows` of
// them tiling the c columns, and a scratch row where n > 1.
bool pyramid_plan_fits(long long r, int c, int h, int g, int m,
                       long long windows, long long n, const float* scratch) {
  const long long rows = r > 1 ? r - 1 : 0;
  return r >= 1 && c >= 1 && h >= 0 && h <= g && g % 4 == 0 &&
         m == 32 * PYR_K - 2 * g && m > 0 && windows >= 1 &&
         (windows - 1) * m < c && c <= windows * m && n >= 1 &&
         (rows == 0 ? n == 1 : (n - 1) * h < rows && rows <= n * h) &&
         (n == 1 || scratch != nullptr);
}

template <typename W>
int pyramid_launch(const W* wall, float* out, float* scratch, long long r,
                   int c, int h, int g, int m, long long windows,
                   long long n, cudaStream_t stream) {
  if (!pyramid_plan_fits(r, c, h, g, m, windows, n, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores where every row starts on 16 bytes
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(wall) % 16 == 0;
  const long long blocks = (windows + PYR_WARPS - 1) / PYR_WARPS;
  const float* in = nullptr;
  for (long long s = 0; s < n; ++s) {
    const long long row0 = 1 + s * h;
    const long long left = r - row0;
    const int nrows = (int)(left < h ? (left > 0 ? left : 0) : h);
    // the last launch writes `out`
    float* dst = ((n - 1 - s) % 2 == 0) ? out : scratch;
    pathfinder_pyramid_kernel<W, PYR_K, PYR_D>
        <<<(unsigned)blocks, PYR_WARPS * 32, 0, stream>>>(
            wall, in, dst, row0, nrows, c, g, m, windows, vec ? 1 : 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in = dst;
  }
  return 0;
}

// ---- the strip route --------------------------------------------------------

constexpr int K = 8;               // window columns a lane
constexpr int WARP_COLS = 32 * K;  // a warp's window: 256 columns
constexpr int MAX_WARPS = 15;         // row warps; one more loads the wall
constexpr int SLABS = 4;           // the wall ring: SLABS slabs of SR rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The slab's mbarrier arrives once every earlier cp.async of this thread
// has landed (its count includes this thread's arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the mbarrier's phase of `parity` has completed; trap after
// ~2^35 cycles (~17 s), so a copy that never lands fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// One bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, counted by `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// An edge value with its phase tag in one 8-byte word: a single-copy-
// atomic store and load, so a reader that sees the tag sees the value,
// with no fence and no flag.
__device__ __forceinline__ void put_edge(unsigned long long* p, float v,
                                         int tag) {
  const unsigned long long w =
      ((unsigned long long)(unsigned)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

// Four edge values of phase `tag` (16-byte aligned), spinning until all
// four carry the tag.  A wait of ~2^35 cycles (~17 s) is a fault, not a
// wait: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ float4 get_edges(const unsigned long long* p,
                                            int tag) {
  const long long t0 = clock64();
  for (;;) {
    unsigned long long a, b, c, d;
    asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
                 : "=l"(a), "=l"(b)
                 : "l"(p)
                 : "memory");
    asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
                 : "=l"(c), "=l"(d)
                 : "l"(p + 2)
                 : "memory");
    const unsigned t = (unsigned)tag;
    if ((a >> 32) == t && (b >> 32) == t && (c >> 32) == t &&
        (d >> 32) == t)
      return make_float4(__uint_as_float((unsigned)a),
                         __uint_as_float((unsigned)b),
                         __uint_as_float((unsigned)c),
                         __uint_as_float((unsigned)d));
    __nanosleep(20);
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Eight wall values as floats from shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const int32_t* p, float* w) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  w[0] = (float)a.x; w[1] = (float)a.y; w[2] = (float)a.z; w[3] = (float)a.w;
  w[4] = (float)b.x; w[5] = (float)b.y; w[6] = (float)b.z; w[7] = (float)b.w;
}

// The wall rows [row, row + rows) of the window's columns [0, E) that lie
// in [0, C) (window column j is wall column x0 + j) into `slab`, rows P
// apart, counted by the slab's mbarrier `bar`; run by the loading warp.
// Where `vec` (x0, E and C multiples of 4, the wall 16-byte aligned), one
// bulk copy a row issued by lane 0, which arrives with the bytes to
// expect; else 4-byte cp.async by every lane, each arriving once its
// copies land.
template <typename W>
__device__ __forceinline__ void stage(W* slab, const W* __restrict__ wall,
                                      long long row, int rows, long long x0,
                                      int E, int P, int C, bool vec,
                                      uint64_t* bar, int lane) {
  const int lo = x0 < 0 ? (int)-x0 : 0;
  const int hi = C - x0 < E ? (int)(C - x0) : E;
  if (vec) {
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(hi - lo) * sizeof(W);
      mbar_expect_tx(bar, bytes * rows);
      for (int r = 0; r < rows; ++r)
        bulk_copy(slab + r * P + lo, wall + (row + r) * C + x0 + lo, bytes,
                  bar);
    }
  } else {
    for (int r = 0; r < rows; ++r)
      for (int j = lo + lane; j < hi; j += 32)
        cp_async4(slab + r * P + j, wall + (row + r) * C + x0 + j);
    cp_async_arrive(bar);
  }
}

// All R - 1 row steps of the strip [g S, (g + 1) S) of CTA g, in phases of
// H rows.  The CTA's window is the strip and H ghost columns a side (E =
// S + 2 H columns, window column j = wall column g S - H + j).  Row warp q
// holds the window columns [q V, q V + 256), eight a lane, V = 256 - 2 H:
// after a phase of H rows its middle V columns, [q V + H, q V + H + V),
// are right (its own ghost zone), and the warps' middles tile the strip,
// so the row warps never exchange values inside a phase.  At a phase's end
// the middles meet in shared memory (`crow`, by the phase's parity, behind
// a barrier of the row warps) and the lanes holding the strip's first and
// last H columns store them, with the phase's tag, into `edges` [2 slots]
// [G][2 sides][H] (zero at the launch); at the next phase's start each
// row warp reads its window back, the lanes of the ghost columns from the
// neighbours' edges once their tags show.  The last warp loads: the wall
// streams through a ring of SLABS slabs of SR rows, each behind a "full"
// mbarrier (the copies landed) and an "empty" one (every row warp is done
// with it), so no row warp waits on a copy's issue.  A column past the
// wall's ends (or the window's) holds END: its bits are masked in after
// every row (no predicate, so the mins keep the predicate registers).
// Dynamic shared memory: the ring [SLABS][SR][P], two cost rows [P] (P =
// row warps V + 2 H) and 2 SLABS mbarriers.
template <typename W>
__global__ void __launch_bounds__((MAX_WARPS + 1) * 32)
pathfinder_strips_kernel(const W* __restrict__ wall, float* __restrict__ out,
                         unsigned long long* edges, long long R, int C, int S,
                         int H, int SR, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = (blockDim.x >> 5) - 1;   // row warps
  const int V = WARP_COLS - 2 * H;
  const int P = warps * V + 2 * H;
  const int E = S + 2 * H;
  W* ring = reinterpret_cast<W*>(smem);
  float* crow = reinterpret_cast<float*>(ring + SLABS * SR * P);
  uint64_t* full = reinterpret_cast<uint64_t*>(crow + 2 * P);
  uint64_t* empty = full + SLABS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = blockIdx.x, G = gridDim.x;
  const long long x0 = (long long)g * S - H;
  const long long nsteps = R - 1;
  const int phases = (int)((nsteps + H - 1) / H);
  const long long slabs = (nsteps + SR - 1) / SR;
  if (t == 0) {
    for (int b = 0; b < SLABS; ++b) {
      mbar_init(full + b, vec ? 1 : 32);
      mbar_init(empty + b, warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == warps) {   // the loading warp
    for (long long k = 0; k < slabs; ++k) {
      const int b = (int)(k % SLABS);
      if (k >= SLABS) mbar_wait(empty + b, (int)((k / SLABS - 1) & 1));
      const long long left = nsteps - k * SR;
      stage(ring + b * SR * P, wall, 1 + k * SR, (int)(left < SR ? left : SR),
            x0, E, P, C, vec != 0, full + b, lane);
    }
    return;
  }
  const int j0 = warp * V + lane * K;   // this lane's window columns
  const int m0 = lane * K;              // ... within its warp's window
  // column c of this lane: v = (v & keep[c]) | end[c], END where outside
  unsigned keep[K], end[K];
  float v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const long long col = x0 + j0 + c;
    const bool o = j0 + c >= E || col < 0 || col >= C;
    keep[c] = o ? 0u : ~0u;
    end[c] = o ? __float_as_uint(END) : 0u;
    v[c] = o ? END : to_f(wall[col]);
  }
  auto mask = [&](int c, float x) {
    return __uint_as_float((__float_as_uint(x) & keep[c]) | end[c]);
  };
  long long k = 0;   // the slab of the next row
  for (int p = 0; p < phases; ++p) {
    const long long r0 = (long long)p * H;
    const int rows = (int)(nsteps - r0 < H ? nsteps - r0 : H);
    if (p > 0) {   // this lane's window of cost row r0
      const float* cr = crow + (p & 1) * P;
      const unsigned long long* slot = edges + (long long)(p & 1) * G * 2 * H;
#pragma unroll
      for (int q = 0; q < K; q += 4) {
        const int j = j0 + q;
        float4 e;
        if (j < H && g > 0)
          e = get_edges(slot + ((g - 1) * 2 + 1) * H + j, p);
        else if (j >= H + S && j < E && g < G - 1)
          e = get_edges(slot + (g + 1) * 2 * H + (j - H - S), p);
        else
          e = *reinterpret_cast<const float4*>(cr + j);
        v[q] = mask(q, e.x);
        v[q + 1] = mask(q + 1, e.y);
        v[q + 2] = mask(q + 2, e.z);
        v[q + 3] = mask(q + 3, e.w);
      }
    }
    for (int i0 = 0; i0 < rows; i0 += SR, ++k) {
      const int b = (int)(k % SLABS);
      mbar_wait(full + b, (int)((k / SLABS) & 1));
      const W* slab = ring + b * SR * P + j0;
      const int n_rows = rows - i0 < SR ? rows - i0 : SR;
      for (int i = 0; i < n_rows; ++i) {
        float w[K];
        load8(slab + i * P, w);
        float l = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
        float r = __shfl_down_sync(0xffffffffu, v[0], 1);
        if (lane == 0) l = END;    // the warp window's ends: its ghost zone
        if (lane == 31) r = END;
        float n[K];
        n[0] = step(w[0], v[0], l, v[1]);
#pragma unroll
        for (int c = 1; c < K - 1; ++c)
          n[c] = step(w[c], v[c], v[c - 1], v[c + 1]);
        n[K - 1] = step(w[K - 1], v[K - 1], v[K - 2], r);
#pragma unroll
        for (int c = 0; c < K; ++c) v[c] = mask(c, n[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + b);   // this warp is done with it
    }
    if (p + 1 < phases) {
      // the strip's edges of row r0 + H to the neighbours, then the
      // warp's middle into the next cost row
      unsigned long long* slot =
          edges + (long long)((p + 1) & 1) * G * 2 * H;
      float* cr = crow + ((p + 1) & 1) * P;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int j = j0 + c;
        if (m0 + c < H || m0 + c >= H + V) continue;   // not its middle
        if (j >= H && j < 2 * H) put_edge(slot + g * 2 * H + (j - H), v[c], p + 1);
        if (j >= S && j < S + H)
          put_edge(slot + (g * 2 + 1) * H + (j - S), v[c], p + 1);
        cr[j] = v[c];
      }
      // the row warps' barrier: the cost row is whole
      asm volatile("bar.sync 1, %0;" ::"r"(warps * 32) : "memory");
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int j = j0 + c;
    if (m0 + c >= H && m0 + c < H + V && j >= H && j < H + S && keep[c])
      out[x0 + j] = v[c];
  }
}

// The strip launch's row warps (eight window columns a lane, the warps'
// middles covering the strip; one more warp loads) and dynamic shared
// memory.
int strip_warps(int s, int h) {
  const int v = WARP_COLS - 2 * h;
  return (s + v - 1) / v;
}

size_t strip_smem(int s, int h, int sr) {
  const size_t p = (size_t)strip_warps(s, h) * (WARP_COLS - 2 * h) + 2 * h;
  return (size_t)SLABS * sr * p * 4 + 2 * p * 4 + 2 * SLABS * 8;
}

template <typename W>
int strips_prepare(size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      (const void*)pathfinder_strips_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <typename W>
int strips_launch(const W* wall, float* out, unsigned long long* edges,
                  long long r, int c, int s, int h, int sr, int ctas, int vec,
                  cudaStream_t stream) {
  if (s <= 0 || h <= 0 || sr <= 0 || s % 4 || h % 4 || h % sr || s < h ||
      2 * h >= WARP_COLS || ctas <= 0 || strip_warps(s, h) > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  int e = strips_prepare<W>(strip_smem(s, h, sr));
  if (e) return e;
  // the edges' tags start at 0; phases are numbered from 1
  if ((e = static_cast<int>(cudaMemsetAsync(
           edges, 0, sizeof(unsigned long long) * 4 * (size_t)ctas * h,
           stream))))
    return e;
  // cooperative: the launch fails (cudaErrorCooperativeLaunchTooLarge)
  // where the CTAs cannot all be resident, instead of deadlocking
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3((unsigned)(32 * (strip_warps(s, h) + 1)));
  cfg.dynamicSmemBytes = strip_smem(s, h, sr);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pathfinder_strips_kernel<W>, wall, out, edges, r, c, s, h, sr,
      vec);
  // a refused launch is reported here, not again by the next launch's
  // cudaGetLastError
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

template <typename W>
int strips_fit(int s, int h, int sr, int* count) {
  int e = strips_prepare<W>(strip_smem(s, h, sr)), per_sm = 0, dev = 0,
      sms = 0;
  if (e) return e;
  if ((e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pathfinder_strips_kernel<W>, 32 * (strip_warps(s, h) + 1),
           strip_smem(s, h, sr)))))
    return e;
  if ((e = static_cast<int>(cudaGetDevice(&dev)))) return e;
  if ((e = static_cast<int>(cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev))))
    return e;
  *count = per_sm * sms;
  return 0;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The pyramid route: the last cost row of the [r, c] wall (int32 if
// `is_int`, else float32) into `out` [c], in `launches` launches of h
// rows over `windows` windows of 256 columns, each with ghost zones of
// `ghost` columns a side and a middle of `middle` (the host's
// pyramid_plan, checked here against the kernel's window); `scratch`, a
// second [c] float buffer, only where that is more than one launch (else
// null).  Launches on `stream`; returns cudaErrorInvalidValue for a plan
// that does not fit, else cudaGetLastError() of the first failed launch
// (0 on success).
extern "C" int pathfinder_pyramid_launch(const void* wall, int is_int,
                                         float* out, float* scratch,
                                         long long r, int c, int h, int ghost,
                                         int middle, long long windows,
                                         int launches, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return pyramid_launch(static_cast<const int32_t*>(wall), out, scratch, r,
                          c, h, ghost, middle, windows, launches, s);
  return pyramid_launch(static_cast<const float*>(wall), out, scratch, r, c,
                        h, ghost, middle, windows, launches, s);
}

// How many strip CTAs of `strip` columns, `h` rows a phase and slabs of
// `sr` rows the card holds at once (the occupancy of one SM times the
// SMs) into *count; 0 or a CUDA error code.
extern "C" int pathfinder_strips_fit(int strip, int h, int sr, int is_int,
                                     int* count) {
  return is_int ? strips_fit<int32_t>(strip, h, sr, count)
                : strips_fit<float>(strip, h, sr, count);
}

// The current device's SMs and the most dynamic shared memory a CTA may
// opt in to, into *sms and *smem; 0 or a CUDA error code.
extern "C" int pathfinder_card(int* sms, int* smem) {
  int dev = 0, e = static_cast<int>(cudaGetDevice(&dev));
  if (e) return e;
  if ((e = static_cast<int>(cudaDeviceGetAttribute(
           sms, cudaDevAttrMultiProcessorCount, dev))))
    return e;
  return static_cast<int>(cudaDeviceGetAttribute(
      smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}

// The strip route: a memset of `edges` (4 * ctas * h 8-byte words, 16-byte
// aligned) and one cooperative launch of `ctas` CTAs of `strip` columns,
// `h` rows a phase, the wall in slabs of `sr` rows.  `vec`: the wall's
// rows are read in 16-byte chunks (c % 4 == 0 and a 16-byte aligned
// wall).  Returns 0 or the first CUDA error
// (cudaErrorCooperativeLaunchTooLarge where the CTAs cannot all be
// resident).
extern "C" int pathfinder_strips_launch(const void* wall, int is_int,
                                        float* out, void* edges, long long r,
                                        int c, int strip, int h, int sr,
                                        int ctas, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* e = static_cast<unsigned long long*>(edges);
  if (is_int)
    return strips_launch(static_cast<const int32_t*>(wall), out, e, r, c,
                         strip, h, sr, ctas, vec, s);
  return strips_launch(static_cast<const float*>(wall), out, e, r, c, strip,
                       h, sr, ctas, vec, s);
}
