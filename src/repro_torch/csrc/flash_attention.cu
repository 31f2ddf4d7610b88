// Flash attention, forward, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:65
// (flash_attention, pallas_call at :75): softmax(q k^T / sqrt(D)) v over
// q, k, v [B, S, H, D], causal or not, with an online softmax over key
// tiles so the [S, S] scores never reach device memory.  Inputs float32,
// bfloat16 or float16, all sums float32, the output in the inputs' type.
// Routes by (type, D): float32 at D 1..128 and 129..256 the 3xTF32 kernel
// (NP = 1, 2 and 4 panels), past 256 the 3xTF32 sliced kernel; bfloat16
// and float16 the wgmma kernel, instantiated for D 1..64, 65..128,
// 129..256 and 257..512 (NP = 1, 2, 4, 8 panels of 64 columns), and past
// 512 its sliced kernel (both sliced kernels through
// flash_attention_sliced_launch).
//
// Bound on an H100: operations, 4 * D flops (q.k and p.v) per (query, key)
// pair the mask keeps, on the tensor cores: 17.2 GFLOP causal at B 4, H 8,
// S 2,048, D 64 (0.0174 ms at the dense bf16 rate of 989 TFLOP/s); in
// float32 three TF32 products per product (3 x 17.2 G at 495 TFLOP/s,
// 0.104 ms).  At D 64 the exponentials (one per pair, 16 a clock per SM)
// take nearly as long as the bf16 products; at D 256 (gemma-7b: H 16, S
// 4,096, 137.5 GFLOP causal, 0.139 ms) the products take four times the
// exponentials' time.
//
// Design.  One block of three warpgroups per (b * H + h, 128-query tile);
// the query tiles with the most key tiles are launched first, across the
// heads of a group whose K and V fit in L2 (tile_of), and causal blocks
// stop at the diagonal (tiles wholly above it are skipped).
// Warpgroup 0 loads: the Q tile once, then K and V tiles into a ring of
// stages in shared memory, each signalled by its own mbarrier ("full") and
// handed back by the 8 consumer warps ("empty").  Warpgroups 1 and 2 each
// own 64 query rows; `setmaxnreg` moves registers from the loader to them.
// The consumers walk the key tiles from the last (the diagonal, or the
// ragged tail: the only ones masked, on a branch of their own) to the
// first.  The layout is read in place: a row of one head is D contiguous
// values, rows H * D apart.
//
// What bounds it on the card: not the loads (the TMA ring alone runs in
// about a third of the kernel's time) but the consumers' instruction
// stream.  Only two consumer warps share each scheduler, so the softmax
// (scale, mask, max, exp2, sum, rescale, pack) is kept lean: the mask is a
// uniform branch taken on the masked tiles only (a per-element test cost
// ~64 branch regions on every tile), exp2 is one MUFU.EX2 with the scale
// folded into an FFMA, and the max and sum run in four partials a row.
//
// bfloat16 and float16 (one kernel, instantiated for each 16-bit type and
// for NP = 1, 2 or 4 64-column panels of D): S = Q K^T and O += P V on
// wgmma (m64n128k16 and m64n64k16, f32 sums), the two
// consumer warpgroups taking turns to issue them (FA3's ping-pong, named
// barriers 1 and 2) so that one's softmax overlaps the other's products.  Tiles
// sit in shared memory as 64-column panels of 128-byte rows, 128-byte swizzled;
// Q and K are K-major operands, V the MN-major B operand of P V in its natural
// [keys, D] layout (transpose bit), so no transposed copy is made.  P is
// rounded to the inputs' 16-bit type in registers and is wgmma's register A
// operand (the plain version rounds the probabilities to q's type too).
// The tiles come by TMA through a 4-D tensor map over [B, S, H, D] (box 64
// x 1 x rows x 1, a block's query rows for Q, a key tile's for K and V; its
// out-of-bounds zero fill covers a ragged tile and D < 64 or < 128) when
// the rows are 16-byte aligned (D % 8 == 0); otherwise the loader
// warpgroup writes the same swizzled tiles with cp.async (4-byte pieces, D
// even) or plain loads (D odd).  At D 129..256 (NP = 4) the Q
// tile alone takes 64 KB, so the key tiles hold 48 keys (S on m64n48k16
// over 16 k-steps) in a ring of three stages: Q 64 KB + 3 x (K 24 KB + V 24
// KB) = 208 KB; a consumer warpgroup's 64 x 256 float32 output takes 128
// registers a thread, its 64 x 48 scores 24.  64-key tiles in two stages
// (192 KB, FA3's shape at D 256) ran 5 % slower on an H100 (PERF.md).  Panels
// wholly past D are neither loaded nor multiplied.
//
// At D 257..512 (NP = 8) a 128-row block's output alone would need 256
// accumulator registers a thread.  So a block owns 64 query rows, and both
// consumer warpgroups work on them: each computes the same S = Q K^T over
// every live panel of D (m64n32k16 over up to 32 k-steps), in the same
// order, so both hold the same bits of m, l and P with no exchange, and
// each runs O += P V on its own half of the live output panels (at D 512
// warpgroup 0 columns 0..255, warpgroup 1 256..511; with an odd count of
// live panels, at D 257..320 and 385..448, both multiply the middle one,
// so that every wgmma's guard is the same for the whole block: one that
// differs between warpgroups makes ptxas serialize every wgmma of the
// kernel).  That does the q.k products twice, 1.5x the counted flops at D
// 512.  Tiles of 32 keys in two stages: Q 64 KB + 2 x (K 32 KB + V 32 KB)
// = 192 KB; a consumer holds 4 x 32 output floats, 16 scores and 8 words
// of P.  The warpgroups ping-pong as below; a turn holds K of one tile and
// V of the one before, so K and V have "empty" barriers apart (K's freed
// once S is done, V's once P V is): with one for both, two stages left the
// loader waiting for every tile.  The loads take every path the D-256
// instantiation takes (TMA box 64 columns x 64 rows for Q, 32 for K and
// V), and the cp.async and plain-load paths fill only the live panels.
//
// float32: 3xTF32 on mma.sync.m16n8k8: each operand x splits into big =
// tf32(x) and small = tf32(x - big) (by masks, see split_tf32), and each
// product is big*small + small*big + big*big with float32 sums, which
// keeps float32's accuracy (plain TF32 keeps ~3 digits and misses the 2e-4
// bar); each of the three passes runs over all n-tiles of a k-step, so no
// HMMA waits on the one before it.  64-key tiles,
// rows padded by 4 floats (conflict-free fragment reads), loaded with
// cp.async (16-byte pieces when D % 4 == 0, else 4-byte).  Each consumer
// warp owns 16 query rows; P's accumulator fragment is reused as the A
// fragment of P V by reading V's key rows in the matching order.  At D
// 129..256 (NP 4) 128 query rows of Q alone would take 133 KB, so a block
// holds 64 query rows and walks 32-key tiles in two stages: Q 66.6 KB + 2
// x (K 33.3 KB + V 33.3 KB) = 200 KB.  Two warps hold each 16 rows: both
// compute the same S (the same bits of m, l and P) and each runs P V for
// its half of the output's columns, 64 accumulator registers a thread;
// q.k is done twice, 1.5x the counted flops.
//
// 16-bit heads past 512 (the sliced kernel).  The output is cut into
// slices of at most eight 64-column panels, the same count each where D
// allows (D 640: 2 x 320 columns, not 512 + 128), one block per (query
// tile, slice); a query tile's slices are neighbours in blockIdx, so they
// read the same K tiles from L2 at about the same time, and the heaviest
// query tiles still go first.  A block owns 64 query rows, and both
// consumer warpgroups compute the same S = Q K^T over all of D's panels,
// in order (the same bits of m, l and P with no exchange), then O += P V
// on their halves of the slice's panels (both multiply the middle one of
// an odd count, so every wgmma guard is uniform over the block), as the
// D-512 instantiation does.  S's operands come through a ring of chunks;
// the slice's V panels come in two stages of their own.  Q's panels stay
// in shared memory while Q and two key tiles of K fit beside V's stages:
// up to D 704 (11 panels: Q 88 KB + V 2 x 24 KB + K 2 x 44 KB, 224 KB).
// A chunk is then a whole key tile's K (32 keys, 4 KB a panel) in a ring
// of two stages, and the warpgroups take turns (ping-pong) as the D-512
// instantiation's do.  Wider, a chunk carries three panels of K and the
// three of Q beside them (36 KB), Q re-read from L2 for every key tile,
// and the warpgroups walk the ring in lockstep: turns would hold every
// chunk of a key tile until the second warpgroup is done with it, which
// a ring shorter than two key tiles cannot.  There a chunk's products
// are committed as a group and the chunk before it freed once only that
// group is left in flight.  The host plans the slices, whether Q stays, the
// chunk and the ring (kernels/flash_attention.py:slice_plan); the entry
// point checks the plan.  The work is (slices x 2 + 1) x 2D flops a pair
// against the counted 4D: 2.5x at D 640.
//
// float32 heads past 256 (the 3xTF32 sliced kernel).  64 query rows of
// D 512 alone take 132 KB, so a block owns 32 query rows and walks key
// tiles of 16: Q 66 KB resident, K 33 KB and V 33 KB a tile.  The output
// is cut into slices of at most eight 64-column panels as the 16-bit
// sliced kernel cuts it (one slice up to D 512, D 640 2 x 320), one block
// per (query tile, slice).  The 8 consumer warps are two row groups of 16
// rows, four warps each; each warp holds a quarter of the slice's output
// columns (at most 128, 64 accumulator registers a thread) and computes
// the scores of its 16 rows over a quarter of every panel of D (k-steps
// 2j and 2j + 1 of 8); the four partial score tiles go through shared
// memory (two buffers, one named barrier a key tile) and each warp adds
// them in the same order, so all four hold the same bits of S, m, l and
// P with no product done twice within a slice: at D 512 the work is the
// counted 4D a pair.  K (and Q, where it is streamed) comes through a ring
// of chunks of panels by cp.async; the slice's V rows in two stages of
// their own; the loader signals each group of copies once the next is
// issued, so two are in flight.  Q stays resident while it fits beside
// two chunks of three panels (to D 896): at D 512 a chunk is a
// whole key tile and the ring its two stages (Q 68 KB + V 2 x 32 KB + K 2
// x 34 KB + the partial scores 16 KB = 219 KB with the barriers and
// the alignment); wider, Q is streamed
// beside K in chunks of three panels.  The host plans it
// (kernels/flash_attention.py:tf32_slice_plan).
//
// Masked scores are the Pallas kernel's finite -1e30 (so a row masked so
// far gives no NaN), zero-filled key rows past S are masked explicitly, and
// the output is acc / max(l, 1e-30) as there (flash_attention.py:58-61).
// The softmax runs in base 2 with the scale folded into scale * log2(e).

#include <cuda.h>   // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int BQ = 128;              // query rows a block
constexpr int THREADS = 384;         // warpgroup 0 loads, 1 and 2 compute
constexpr int BK32 = 64;             // key rows a tile, float32

// key rows a tile, 16-bit types, at NP 64-column panels of D
template <int NP>
__host__ __device__ constexpr int bk16() {
  return NP == 8 ? 32 : NP == 4 ? 48 : 128;
}
// query rows a block, 16-bit types: both consumer warpgroups on the same
// 64 rows at NP 8, 64 rows each below
template <int NP>
__host__ __device__ constexpr int bq16() {
  return NP == 8 ? 64 : BQ;
}
constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;
// The D-512 instantiation's loader walks the live panels one at a time
// and spills at 40 and at 72 registers, not at 88; 208 are enough for its
// consumers.  Both pairs hand over exactly the block's launch share, 384
// threads x 168 registers.
constexpr int LOADER_REGS8 = 88, CONSUMER_REGS8 = 208;
// The sliced kernel's loader (runtime ring positions and layout) spills at
// 88 and its consumers need no more than 192; the float32 D-256
// instantiation's loader spills at 40, not at 72.  Each pair hands over
// the same 384 x 168.
constexpr int LOADER_REGS_SL = 120, CONSUMER_REGS_SL = 192;
constexpr int LOADER_REGS_F4 = 72, CONSUMER_REGS_F4 = 216;
// The float32 sliced kernel's (runtime ring positions, three load loops)
// spills 40 bytes at 72 / 216 and 16 at 88 / 208, none at 104 / 200 or
// 120 / 192, which ran fastest (scripts/wide_attention_and_decode_
// variants.py --only f32-sliced).
constexpr int LOADER_REGS_FS = 120, CONSUMER_REGS_FS = 192;
constexpr float NEG_INF = -1e30f;    // flash_attention.py:17
constexpr float LOG2E = 1.4426950408889634f;

// How the loader fills a tile (the wrapper picks, the entry point checks).
enum Load { LOAD_TMA = 0, LOAD_LD2 = 2, LOAD_CP4 = 4, LOAD_CP16 = 16 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, D;
  float scale_log2;
  int causal, load;
  int BH, group;   // B * H heads, scheduled `group` heads at a time
  // the sliced kernel's plan (slice_plan): output slices a query tile,
  // 64-column panels a slice, panels a chunk, chunks in the ring, Q
  // resident (1) or not
  int slices = 1, panels = 0, cpanels = 0, ring = 0, qres = 0;
};

// K and V bytes a group of heads may hold in the 50 MB L2 while its
// blocks run (Q tiles and outputs stream through the rest).
constexpr double L2_GROUP_BYTES = 40e6;

// ---- barriers, copies, fences -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
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

// Wait until the phase of `parity` has completed.  A phase that never
// completes is a fault of the kernel: trap after ~2^33 cycles (~4 s) so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// N-byte cp.async; `valid` false writes N zero bytes and reads nothing.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// The block's shared memory, aligned to 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes, and wgmma and TMA read it from
// aligned tiles).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Named barriers 1 and 2 order the consumer warpgroups' turns: a turn
// waits on its own barrier, and the other warpgroup arrives there.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait0() { wgmma_wait<0>(); }

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (placed after its wait).
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile starting at
// `p`: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset).  The leading byte offset is unused by the K-major operands
// (16, by convention) and, for V's single 64-column MN-major panel, it is
// set equal to the 8-row stride.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64] (+)= A(smem desc) * B(smem desc), m64n128k16, 16-bit in (F16:
// float16, else bfloat16), f32 sums; both operands K-major.  `acc` 0
// overwrites d.
#define WGMMA_SS_N128(TY)                                                      \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %66, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "             \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                 \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
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

template <bool F16>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (F16)
    WGMMA_SS_N128("f16");
  else
    WGMMA_SS_N128("bf16");
}

// d[24] (+)= A(smem desc) * B(smem desc), m64n48k16, both K-major, for
// the D-256 kernel's 48-key tiles.
#define WGMMA_SS_N48(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %26, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " "              \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23"                                 \
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])                     \
      : "l"(da), "l"(db), "r"(acc))

template <bool F16>
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (F16)
    WGMMA_SS_N48("f16");
  else
    WGMMA_SS_N48("bf16");
}

// d[16] (+)= A(smem desc) * B(smem desc), m64n32k16, both K-major, for
// the D-512 kernel's 32-key tiles.
#define WGMMA_SS_N32(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %18, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "              \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                   \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15])                                                            \
      : "l"(da), "l"(db), "r"(acc))

template <bool F16>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (F16)
    WGMMA_SS_N32("f16");
  else
    WGMMA_SS_N32("bf16");
}

// d[32] += A(registers, 16-bit x2 a[4]) * B(smem desc), m64n64k16; B
// MN-major (transpose bit set).
#define WGMMA_RS_N64_TB(TY)                                                    \
  asm volatile(                                                                \
      "{\n.reg .pred p;\n"                                                     \
      "setp.ne.b32 p, %37, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{"                                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                 \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool F16>
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (F16)
    WGMMA_RS_N64_TB("f16");
  else
    WGMMA_RS_N64_TB("bf16");
}

// ---- 3xTF32: split_tf32, mma_tf32, split_a, mma_3xtf32 (tf32.cuh) ------

// ---- shared-memory layouts -------------------------------------------------

// 16-bit types: Q [NP panels][bq16 rows][128 B], then STAGES K tiles and
// STAGES V tiles [NP panels][bk16 rows][128 B], then the barriers: Q full,
// K full x STAGES, V full x STAGES, empty x STAGES (at NP 8 K's, then V's
// empty x STAGES).
template <int NP>
struct Bf16Smem {
  // as many stages as fit beside Q (at D 256, 48-key tiles three; at D
  // 512, 32-key tiles two)
  static constexpr int BK = bk16<NP>();
  static constexpr int STAGES = NP == 1 ? 4 : NP == 8 ? 2 : 3;
  static constexpr int PANEL_Q = bq16<NP>() * 128, PANEL_KV = BK * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + NP * PANEL_Q;
  static constexpr int V = K + STAGES * NP * PANEL_KV;
  static constexpr int BAR = V + STAGES * NP * PANEL_KV;
  static constexpr int EMPTY = NP == 8 ? 2 : 1;   // rings of empty barriers
  static constexpr int BYTES = BAR + 8 * (1 + (2 + EMPTY) * STAGES) + 1024;
};

// float32: Q [BQF][LD], STAGES x K [BKF][LD], STAGES x V [BKF][LD] floats
// (LD = 64 NP + 4), then the barriers as above; at NP 4 (D 129..256) 64
// query rows and 32-key tiles, below it 128 and 64.
template <int NP>
struct F32Smem {
  static constexpr int STAGES = NP == 1 ? 3 : 2;
  static constexpr int DM = 64 * NP, LD = DM + 4;
  static constexpr int BQF = NP == 4 ? 64 : BQ, BKF = NP == 4 ? 32 : BK32;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQF * LD * 4;
  static constexpr int V = K + STAGES * BKF * LD * 4;
  static constexpr int BAR = V + STAGES * BKF * LD * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// The sliced kernel's shared memory, from its plan: the barriers (1024
// bytes: Q full, ring full x R, ring empty x R, V full x 2, V empty x 2),
// Q's panels when resident, two stages of the slice's V panels, then the
// ring of R chunks, each `cpanels` of a key tile's panels of K and, when Q
// is streamed, as many of Q's after them.  Every panel is 1024-byte
// aligned.
constexpr int SL_BK = 32;                  // keys a tile
constexpr int SL_PANEL_Q = 64 * 128;       // a panel of the 64 query rows
constexpr int SL_PANEL_K = SL_BK * 128;    // a panel of a key tile
constexpr int SL_BARS = 1024, SL_RING_MAX = 48;
constexpr int SMEM_MAX = 232448;           // bytes a block may use

struct SlicedSmem {
  int q, v, ring, chunk, bytes;
  __host__ __device__ static SlicedSmem of(int nq, int panels, int cpanels,
                                           int ring, int qres) {
    SlicedSmem s;
    s.q = SL_BARS;
    s.v = s.q + (qres ? nq * SL_PANEL_Q : 0);
    s.ring = s.v + 2 * panels * SL_PANEL_K;
    s.chunk = cpanels * (SL_PANEL_K + (qres ? 0 : SL_PANEL_Q));
    s.bytes = s.ring + ring * s.chunk + 1024;   // + the alignment
    return s;
  }
};

// The float32 sliced kernel's shared memory, from its plan: the barriers
// (as above), two buffers of the consumer warps' partial scores (8 warps x
// 16 rows x 16 keys each), Q's panels when resident, two stages of the
// slice's V rows, then the ring of R chunks, each `cpanels` of a key
// tile's panels of K and, when Q is streamed, as many of Q's after them.
// A panel is 64 columns of float32 rows padded by 4 floats (conflict-free
// fragment reads); V's rows hold the slice's columns, padded by 4.
constexpr int FS_BQ = 32, FS_BK = 16;      // query rows a block, keys a tile
constexpr int FS_LD = 68;                  // floats a panel's row
constexpr int FS_PANEL_Q = FS_BQ * FS_LD * 4, FS_PANEL_K = FS_BK * FS_LD * 4;
constexpr int FS_XCHG = 2 * 8 * 16 * 16 * 4;

struct F32SlicedSmem {
  int xchg, q, v, vld, ring, chunk, bytes;
  __host__ __device__ static F32SlicedSmem of(int nq, int panels,
                                              int cpanels, int ring,
                                              int qres) {
    F32SlicedSmem s;
    s.xchg = SL_BARS;
    s.q = s.xchg + FS_XCHG;
    s.v = s.q + (qres ? nq * FS_PANEL_Q : 0);
    s.vld = 64 * panels + 4;
    s.ring = s.v + 2 * FS_BK * s.vld * 4;
    s.chunk = cpanels * (FS_PANEL_K + (qres ? 0 : FS_PANEL_Q));
    s.bytes = s.ring + ring * s.chunk + 1024;   // + the alignment
    return s;
  }
};

// Byte offset of element (r, c) in a 2-byte tile of R rows stored as
// 64-column panels of 128-byte rows, 128-byte swizzled: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8), as TMA writes it.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  const int cc = c & 63;
  return (c >> 6) * (R * 128) + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) +
         (cc & 7) * 2;
}

// Rows [row0, row0 + R) of one 16-bit head (element `base` is (b, 0, h, 0),
// rows `rstride` apart) into the swizzled tile; rows past S and columns
// past D are zero.  LOAD_CP4 needs D even and 4-byte aligned rows.
template <int NP, int R>
__device__ __forceinline__ void load_bf16_tile(uint8_t* dst,
                                               const __nv_bfloat16* src,
                                               long long base, int row0,
                                               int S, int D,
                                               long long rstride, int mode,
                                               int tid) {
  constexpr int COLS = 64 * NP;
  if (mode == LOAD_CP4) {
    for (int e = tid; e < R * COLS / 2; e += 128) {
      const int r = e / (COLS / 2), c = (e % (COLS / 2)) * 2;
      const bool ok = row0 + r < S && c < D;
      const __nv_bfloat16* g =
          ok ? src + base + (long long)(row0 + r) * rstride + c : src;
      cp_async<4>(dst + swz<R>(r, c), g, ok);
    }
  } else {
    for (int e = tid; e < R * COLS; e += 128) {
      const int r = e / COLS, c = e % COLS;
      unsigned short x = 0;
      if (row0 + r < S && c < D)
        x = reinterpret_cast<const unsigned short*>(
            src)[base + (long long)(row0 + r) * rstride + c];
      *reinterpret_cast<unsigned short*>(dst + swz<R>(r, c)) = x;
    }
  }
}

// The same tile as the kernel of NP panels lays it out: at NP 8 (D
// 257..512) the `npan` panels below D one at a time, none past them;
// below NP 8 whole.
template <int NP, int R>
__device__ __forceinline__ void load_h16_panels(uint8_t* dst,
                                                const __nv_bfloat16* src,
                                                long long base, int row0,
                                                int S, int D,
                                                long long rstride, int mode,
                                                int tid, int npan) {
  if constexpr (NP == 8) {
    for (int pn = 0; pn < npan; ++pn)
      load_bf16_tile<1, R>(dst + pn * R * 128, src, base + 64 * pn, row0, S,
                           D - 64 * pn, rstride, mode, tid);
  } else {
    load_bf16_tile<NP, R>(dst, src, base, row0, S, D, rstride, mode, tid);
  }
}

// The float32 counterpart into a [R][64 NP + 4] tile; LOAD_CP16 needs D % 4
// == 0 and 16-byte aligned rows.
template <int NP, int R>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              long long base, int row0, int S,
                                              int D, long long rstride,
                                              int mode, int tid) {
  constexpr int DM = 64 * NP, LD = DM + 4;
  if (mode == LOAD_CP16) {
    for (int e = tid; e < R * DM / 4; e += 128) {
      const int r = e / (DM / 4), c = (e % (DM / 4)) * 4;
      const bool ok = row0 + r < S && c < D;
      cp_async<16>(dst + r * LD + c,
                   ok ? src + base + (long long)(row0 + r) * rstride + c : src,
                   ok);
    }
  } else {
    for (int e = tid; e < R * DM; e += 128) {
      const int r = e / DM, c = e % DM;
      const bool ok = row0 + r < S && c < D;
      cp_async<4>(dst + r * LD + c,
                  ok ? src + base + (long long)(row0 + r) * rstride + c : src,
                  ok);
    }
  }
}

// ---- the kernels ------------------------------------------------------------

// Rows [row0, row0 + R) of one float32 head, `cols` columns from element
// `base` on, into a [R][ld] tile by cp.async; rows past S and columns past
// `live` are zero.  LOAD_CP16 needs cols, live and the rows' alignment
// multiples of 4 floats.
template <int R>
__device__ __forceinline__ void load_f32_rows(float* dst, int ld,
                                              const float* src,
                                              long long base, int row0,
                                              int S, int cols, int live,
                                              long long rstride, int mode,
                                              int tid) {
  if (mode == LOAD_CP16) {
    const int c4 = cols / 4;
    for (int e = tid; e < R * c4; e += 128) {
      const int r = e / c4, c = (e % c4) * 4;
      const bool ok = row0 + r < S && c < live;
      cp_async<16>(dst + r * ld + c,
                   ok ? src + base + (long long)(row0 + r) * rstride + c : src,
                   ok);
    }
  } else {
    for (int e = tid; e < R * cols; e += 128) {
      const int r = e / cols, c = e % cols;
      const bool ok = row0 + r < S && c < live;
      cp_async<4>(dst + r * ld + c,
                  ok ? src + base + (long long)(row0 + r) * rstride + c : src,
                  ok);
    }
  }
}


struct Tile {          // what every thread of a block knows of its work
  int q0, b, h, n_kt;
  long long base;      // element (b, 0, h, 0)
  long long rstride;   // H * D
};

// Blocks start in blockIdx order, so the order below is the schedule: the
// heads go in groups whose K and V fit in L2, and inside a group the query
// tiles with the most key tiles go first for all its heads (a head's
// tiles one after another would leave the last heads' heaviest tiles for
// the last wave).  A block holds R query rows and walks BK-key tiles;
// the sliced kernel's `slices` blocks of one query tile are neighbours.
template <int R, int BK>
__device__ __forceinline__ Tile tile_of(Params p) {
  Tile t;
  const int n_qt = (p.S + R - 1) / R;
  const long long per_group = (long long)p.group * n_qt;
  const unsigned blk = blockIdx.x / p.slices;   // a query tile's slices
  const int g = (int)(blk / per_group);
  const int r = (int)(blk % per_group);
  const int heads = min(p.group, p.BH - g * p.group);
  const int bh = g * p.group + r % heads;
  t.q0 = (n_qt - 1 - r / heads) * R;   // heaviest tiles first
  t.b = bh / p.H;
  t.h = bh % p.H;
  t.rstride = (long long)p.H * p.D;
  t.base = (long long)t.b * p.S * t.rstride + (long long)t.h * p.D;
  t.n_kt = (p.S + BK - 1) / BK;
  if (p.causal) t.n_kt = min(t.n_kt, (t.q0 + R - 1) / BK + 1);
  return t;
}

// Barriers: [0] Q full, [1 + s] K full, [1 + ST + s] V full, [1 + 2 ST + s]
// empty (with EMPTY 2: K's, and [1 + 3 ST + s] V's).  Loads by TMA arrive
// once (with the bytes); loads by the loader warpgroup's threads arrive 128
// times.  The 8 consumer warps free a stage.
template <int ST, int EMPTY = 1>
__device__ __forceinline__ void init_barriers(uint64_t* bars, int load) {
  if (threadIdx.x == 0) {
    const int n = load == LOAD_TMA ? 1 : 128;
    for (int i = 0; i < 1 + 2 * ST; ++i) mbar_init(&bars[i], n);
    for (int s = 0; s < EMPTY * ST; ++s) mbar_init(&bars[1 + 2 * ST + s], 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// 2^x on the exponential unit (one MUFU.EX2; exp2f adds a range fix-up of
// three instructions).  2^-1e30 is 0 and 2^0 is 1, as the mask needs.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax step for the two rows (g, g + 8) a thread holds of a score
// tile in mma accumulator order: s[4j + e] is row g + 8 (e / 2), column
// 8 j + 2 t + e % 2.  Scales into base 2, masks (causal and keys past S,
// when `mask`), updates m, returns the rescale factor of each row in corr
// and replaces the scores by exp2(s - m); rs gets each row's partial sum.
// The max and the sum run over four partials a row (shorter chains).  An
// unmasked tile takes its max on the raw scores (the scale is positive) and
// folds the scale into one FFMA an element: its scores are all real, so its
// m is too, and 2^(s sl - m) never meets the -1e30 - -1e30 that a row
// masked so far needs to be 2^0.
template <int N>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* corr,
                                               float* rs, float scale_log2,
                                               int S, bool causal, int row,
                                               int k0, int t, bool mask) {
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mx[r][u] = NEG_INF;
      sum[r][u] = 0.0f;
    }
  if (mask) {   // one uniform branch; selects, not a branch an element
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale_log2;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool out = (col >= S) | (causal & (col > row + 8 * (e >> 1)));
        s[4 * j + e] = out ? NEG_INF : s[4 * j + e];
      }
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& u = mx[e >> 1][(j & 1) * 2 + (e & 1)];
      u = fmaxf(u, s[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m[r], mask ? v : v * scale_log2);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
  if (mask) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * j + e];
        x = fast_exp2(x - m[e >> 1]);
        sum[e >> 1][(j & 1) * 2 + (e & 1)] += x;
      }
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * j + e];
        x = fast_exp2(fmaf(x, scale_log2, -m[e >> 1]));
        sum[e >> 1][(j & 1) * 2 + (e & 1)] += x;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rs[r] = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int D, float a,
                                           float b);
template <>
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int D,
                                           float a, float b) {
  if ((D & 1) == 0 && col + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(a, b);
  } else {
    if (col < D) row[col] = __float2bfloat16(a);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(b);
  }
}
template <>
__device__ __forceinline__ void store_pair(__half* row, int col, int D,
                                           float a, float b) {
  if ((D & 1) == 0 && col + 1 < D) {
    *reinterpret_cast<__half2*>(row + col) = __floats2half2_rn(a, b);
  } else {
    if (col < D) row[col] = __float2half(a);
    if (col + 1 < D) row[col + 1] = __float2half(b);
  }
}
template <>
__device__ __forceinline__ void store_pair(float* row, int col, int D, float a,
                                           float b) {
  if ((D & 1) == 0 && col + 1 < D) {
    *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
  } else {
    if (col < D) row[col] = a;
    if (col + 1 < D) row[col + 1] = b;
  }
}

// Rows `row` and `row + 8` of the output from accumulator fragments
// o[8 j + ...] (N floats: columns 8 j + 2 t, + 1 of row, then of row + 8).
template <typename T, int N>
__device__ __forceinline__ void store_rows(void* out, int S, int D, Tile tl,
                                           const float* o, int col0, int row,
                                           int t, const float* l) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* orow = static_cast<T*>(out) + tl.base + (long long)rr * tl.rstride;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      store_pair(orow, col0 + 8 * j + 2 * t, D, o[4 * j + 2 * r] * inv,
                 o[4 * j + 2 * r + 1] * inv);
  }
}

// Two 16-bit values rounded to T16 (bfloat16 or float16) as one register.
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16*) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  const __half2 x = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The 16-bit kernel: F16 float16, else bfloat16 (the loads move bytes and
// are the same for both).
template <int NP, bool F16>
__global__ void __launch_bounds__(THREADS, 1)
flash_h16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Bf16Smem<NP>;
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  constexpr int ST = L::STAGES, BK = bk16<NP>(), BQH = bq16<NP>();
  // NP 8: both consumer warpgroups on the same 64 rows, each holding OP of
  // the output's panels
  constexpr bool SPLIT = NP == 8;
  constexpr int OP = SPLIT ? NP / 2 : NP;
  // K's and V's stages freed apart (K's after S, V's after P V)
  constexpr bool KV_APART = L::EMPTY == 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const Tile tl = tile_of<BQH, BK>(p);
  // the panels that hold columns below D (all NP but at D 129..192 and
  // 257..448); a constant below NP 4, so the D <= 128 kernel's loops test
  // nothing
  const int npan = NP < 4 ? NP : min(NP, (p.D + 63) / 64);
  init_barriers<ST, L::EMPTY>(bars, p.load);

  if (threadIdx.x < 128) {   // ---- the loader warpgroup ----
    regs_dealloc<NP == 8 ? LOADER_REGS8 : LOADER_REGS>();
    if (p.load == LOAD_TMA) {
      if (threadIdx.x != 0) return;
      mbar_expect_tx(&bars[0], npan * L::PANEL_Q);
      for (int pn = 0; pn < npan; ++pn)
        tma_load_4d(smem + L::Q + pn * L::PANEL_Q, &tq, &bars[0], pn * 64,
                    tl.h, tl.q0, tl.b);
      for (int it = 0; it < tl.n_kt; ++it) {
        const int s = it % ST, k0 = (tl.n_kt - 1 - it) * BK;
        if (it >= ST) mbar_wait(&bars[1 + 2 * ST + s], (it / ST - 1) & 1);
        mbar_expect_tx(&bars[1 + s], npan * L::PANEL_KV);
        for (int pn = 0; pn < npan; ++pn)
          tma_load_4d(smem + L::K + (s * NP + pn) * L::PANEL_KV, &tk,
                      &bars[1 + s], pn * 64, tl.h, k0, tl.b);
        if (KV_APART && it >= ST)
          mbar_wait(&bars[1 + 3 * ST + s], (it / ST - 1) & 1);
        mbar_expect_tx(&bars[1 + ST + s], npan * L::PANEL_KV);
        for (int pn = 0; pn < npan; ++pn)
          tma_load_4d(smem + L::V + (s * NP + pn) * L::PANEL_KV, &tv,
                      &bars[1 + ST + s], pn * 64, tl.h, k0, tl.b);
      }
      return;
    }
    const int tid = threadIdx.x;
    const auto* q = static_cast<const __nv_bfloat16*>(p.q);
    const auto* k = static_cast<const __nv_bfloat16*>(p.k);
    const auto* v = static_cast<const __nv_bfloat16*>(p.v);
    load_h16_panels<NP, BQH>(smem + L::Q, q, tl.base, tl.q0, p.S, p.D,
                             tl.rstride, p.load, tid, npan);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(&bars[0]);
    for (int it = 0; it < tl.n_kt; ++it) {
      const int s = it % ST, k0 = (tl.n_kt - 1 - it) * BK;
      if (it >= ST) mbar_wait(&bars[1 + 2 * ST + s], (it / ST - 1) & 1);
      load_h16_panels<NP, BK>(smem + L::K + s * NP * L::PANEL_KV, k,
                              tl.base, k0, p.S, p.D, tl.rstride, p.load, tid,
                              npan);
      cp_async_commit();
      if constexpr (KV_APART) {   // K lands before V's stage is waited for
        cp_async_wait<0>();
        fence_proxy_async();
        mbar_arrive(&bars[1 + s]);
        if (it >= ST) mbar_wait(&bars[1 + 3 * ST + s], (it / ST - 1) & 1);
      }
      load_h16_panels<NP, BK>(smem + L::V + s * NP * L::PANEL_KV, v,
                              tl.base, k0, p.S, p.D, tl.rstride, p.load, tid,
                              npan);
      cp_async_commit();
      if constexpr (!KV_APART) {
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(&bars[1 + s]);
      }
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(&bars[1 + ST + s]);
    }
    return;
  }

  // ---- the consumer warpgroups: 64 query rows each (NP 8: the same 64) ----
  regs_alloc<NP == 8 ? CONSUMER_REGS8 : CONSUMER_REGS>();
  const int wg = threadIdx.x / 128 - 1, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = tl.q0 + (SPLIT ? 0 : 64 * wg) + 16 * w + g;   // and row + 8
  const uint8_t* qs = smem + L::Q + (SPLIT ? 0 : wg * 64 * 128);
  // The output panels this warpgroup multiplies: p0 .. p0 + nmul - 1.  At
  // NP 8 each takes half of the live panels, rounded up, the second the
  // last ones: with an odd count both multiply the middle panel (the same
  // bits, from the same P and V) and the first stores it.  nmul is the
  // same for both warpgroups: a wgmma under a branch that differs between
  // them makes ptxas serialize every wgmma of the kernel.
  const int half = (npan + 1) / 2;
  const int nmul = SPLIT ? half : npan;
  const int p0 = SPLIT && wg == 1 ? npan - half : 0;
  const int S = p.S;
  const float scale_log2 = p.scale_log2;
  const bool causal = p.causal != 0;
  float o[OP][32];
#pragma unroll
  for (int pn = 0; pn < OP; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pn][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  mbar_wait(&bars[0], 0);

  // Ping-pong (FA3): the two warpgroups take turns issuing their products
  // (named barriers 1 and 2), so one's softmax runs while the other's wgmma
  // do.  Turn `it` issues O += P(it - 1) V(it - 1) and S = Q K(it); the
  // softmax of tile it follows, outside the turn.
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  // descriptors of the tiles' first bytes; a descriptor addresses shared
  // memory in 16-byte units in its low bits, so an offset is added as is
  const uint64_t dq = sw128_desc(qs, 16), dk = sw128_desc(smem + L::K, 16);
  const uint64_t dv = sw128_desc(smem + L::V, 1024);
  auto issue_qk = [&](int it) {   // S = Q K^T: 64 rows x BK keys
    const uint64_t dks = dk + (it % ST) * (NP * L::PANEL_KV / 16);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      if (pn >= npan) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // D in k16 steps of 32 bytes a panel
        const uint64_t a = dq + (pn * L::PANEL_Q + 32 * j) / 16;
        const uint64_t b = dks + (pn * L::PANEL_KV + 32 * j) / 16;
        if constexpr (BK == 128)
          wgmma_ss_n128<F16>(sc, a, b, pn + j > 0);
        else if constexpr (BK == 48)
          wgmma_ss_n48<F16>(sc, a, b, pn + j > 0);
        else
          wgmma_ss_n32<F16>(sc, a, b, pn + j > 0);
      }
    }
  };
  auto issue_pv = [&](int it) {   // O += P V, V's [keys][D] panel MN-major
    const uint64_t dvs = dv + (it % ST) * (NP * L::PANEL_KV / 16);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < OP; ++pn)
        if (pn < nmul)
          wgmma_rs_n64_tb<F16>(
              o[pn], pa[kk], dvs + ((p0 + pn) * L::PANEL_KV + 2048 * kk) / 16);
  };
  auto softmax = [&](int it) {
    const int k0 = (tl.n_kt - 1 - it) * BK;
    // only the tiles that reach past S or above this warp's first row mask
    const bool mask = k0 + BK > S || (causal && k0 + BK - 1 > row - g);
    float corr[2], rs[2];
    online_softmax<BK / 2>(sc, m, corr, rs, scale_log2, S, causal, row, k0,
                           t, mask);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int pn = 0; pn < OP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] *= corr[(i >> 1) & 1];
    // P as the register A operand: k16 step kk covers keys 16 kk .. + 15,
    // the accumulator's column groups 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * (2 * kk + h2) + 2 * r;
          pa[kk][2 * h2 + r] =
              pack2(sc[i], sc[i + 1], static_cast<T16*>(nullptr));
        }
  };

  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) named_arrive(1);   // warpgroup 0 goes first
  for (int it = 0; it <= tl.n_kt; ++it) {
    const bool qk = it < tl.n_kt, pv = it > 0;
    if (qk) mbar_wait(&bars[1 + it % ST], (it / ST) & 1);
    if (pv) mbar_wait(&bars[1 + ST + (it - 1) % ST], ((it - 1) / ST) & 1);
    named_sync(my_turn);
    wgmma_fence();
    if (pv) issue_pv(it - 1);
    if (qk) issue_qk(it);
    wgmma_commit();
    // every sync is matched: warpgroup 1's last turn hands over to no one
    if (wg == 0 || it < tl.n_kt) named_arrive(their_turn);
    wgmma_wait0();
    reg_fence<BK / 2>(sc);
#pragma unroll
    for (int pn = 0; pn < OP; ++pn) reg_fence<32>(o[pn]);
    if (pv) {
      __syncwarp();
      if (lane == 0)
        mbar_arrive(&bars[1 + (KV_APART ? 3 : 2) * ST + (it - 1) % ST]);
    }
    if (KV_APART && qk) {   // S of this tile is done: free K's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[1 + 2 * ST + it % ST]);
    }
    if (qk) softmax(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int pn = 0; pn < OP; ++pn)
    if (!SPLIT || (pn < nmul && p0 + pn >= wg * half))
      store_rows<T16, 32>(p.o, S, p.D, tl, o[pn], 64 * (p0 + pn), row, t, l);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const Params p) {
  using L = F32Smem<NP>;
  constexpr int ST = L::STAGES, DM = L::DM, LD = L::LD;
  constexpr int BQF = L::BQF, BKF = L::BKF;
  // NP 4: two warps on each 16 query rows, each holding OC of the output's
  // columns; below it one warp holds all of them
  constexpr bool CSPLIT = NP == 4;
  constexpr int OC = CSPLIT ? DM / 2 : DM, NKT = BKF / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  const Tile tl = tile_of<BQF, BKF>(p);
  init_barriers<ST>(bars, LOAD_CP16);

  if (threadIdx.x < 128) {   // ---- the loader warpgroup ----
    regs_dealloc<NP == 4 ? LOADER_REGS_F4 : LOADER_REGS>();
    const int tid = threadIdx.x;
    const auto* q = static_cast<const float*>(p.q);
    const auto* k = static_cast<const float*>(p.k);
    const auto* v = static_cast<const float*>(p.v);
    load_f32_tile<NP, BQF>(Qs, q, tl.base, tl.q0, p.S, p.D, tl.rstride,
                           p.load, tid);
    cp_async_commit();
    cp_async_wait<0>();
    mbar_arrive(&bars[0]);
    for (int it = 0; it < tl.n_kt; ++it) {
      const int s = it % ST, k0 = (tl.n_kt - 1 - it) * BKF;
      if (it >= ST) mbar_wait(&bars[1 + 2 * ST + s], (it / ST - 1) & 1);
      load_f32_tile<NP, BKF>(Ks + s * BKF * LD, k, tl.base, k0, p.S, p.D,
                             tl.rstride, p.load, tid);
      cp_async_commit();
      load_f32_tile<NP, BKF>(Vs + s * BKF * LD, v, tl.base, k0, p.S, p.D,
                             tl.rstride, p.load, tid);
      cp_async_commit();
      cp_async_wait<1>();
      mbar_arrive(&bars[1 + s]);
      cp_async_wait<0>();
      mbar_arrive(&bars[1 + ST + s]);
    }
    return;
  }

  // ---- the consumer warps: 16 query rows each (NP 4: two on each 16) ----
  regs_alloc<NP == 4 ? CONSUMER_REGS_F4 : CONSUMER_REGS>();
  const int cw = threadIdx.x / 32 - 4;
  const int rw = CSPLIT ? cw % 4 : cw;          // the warp's 16 rows
  const int c0 = CSPLIT ? (cw / 4) * OC : 0;    // its first output column
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = tl.q0 + 16 * rw + g;   // and row + 8
  const float* qs = Qs + 16 * rw * LD;
  const int n_dt = (p.D + 7) / 8;   // 8-column tiles of D
  // the warp's output column tiles below D
  const int n_ot = min(OC / 8, max(0, n_dt - c0 / 8));
  const int S = p.S;
  const float scale_log2 = p.scale_log2;
  const bool causal = p.causal != 0;
  float o[OC / 2];
#pragma unroll
  for (int i = 0; i < OC / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < tl.n_kt; ++it) {
    const int s = it % ST, ph = (it / ST) & 1;
    const int k0 = (tl.n_kt - 1 - it) * BKF;
    const float* ks = Ks + s * BKF * LD;
    const float* vs = Vs + s * BKF * LD;

    // S = Q K^T: 16 rows x BKF keys, D in k8 steps (those past D skipped)
    float sc[BKF / 2];
#pragma unroll
    for (int i = 0; i < BKF / 2; ++i) sc[i] = 0.0f;
    mbar_wait(&bars[1 + s], ph);
#pragma unroll
    for (int kk = 0; kk < DM / 8; ++kk) {
      if (kk >= n_dt) break;
      const int c = 8 * kk + t;
      const SplitA a = split_a(qs[g * LD + c], qs[(g + 8) * LD + c],
                               qs[g * LD + c + 4], qs[(g + 8) * LD + c + 4]);
      float b0[NKT], b1[NKT];
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        b0[nt] = ks[(8 * nt + g) * LD + c];
        b1[nt] = ks[(8 * nt + g) * LD + c + 4];
      }
      mma_3xtf32<NKT>(sc, a, b0, b1, NKT);
    }

    const bool mask = k0 + BKF > S || (causal && k0 + BKF - 1 > row - g);
    float corr[2], rs[2];
    online_softmax<BKF / 2>(sc, m, corr, rs, scale_log2, S, causal, row, k0,
                            t, mask);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: k8 step kk covers keys 8 kk .. + 7; the accumulator holds
    // keys 2t and 2t + 1 of each row, so the A fragment's columns t and
    // t + 4 are read as keys 2t and 2t + 1, and V's rows in that order
    mbar_wait(&bars[1 + ST + s], ph);
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      const SplitA a = split_a(sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                               sc[4 * kk + 3]);
      const float* v0 = vs + (8 * kk + 2 * t) * LD + c0 + g;
      float b0[OC / 8], b1[OC / 8];   // column tiles past D are skipped
#pragma unroll
      for (int nt = 0; nt < OC / 8; ++nt) {
        b0[nt] = nt < n_ot ? v0[8 * nt] : 0.0f;
        b1[nt] = nt < n_ot ? v0[LD + 8 * nt] : 0.0f;
      }
      mma_3xtf32<OC / 8>(o, a, b0, b1, n_ot);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[1 + 2 * ST + s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows<float, OC / 2>(p.o, S, p.D, tl, o, c0, row, t, l);
}

// The sliced kernel, 16-bit heads past 512 (F16: float16, else
// bfloat16): one block per (query tile of 64 rows, output slice); see the
// header for the design.
template <bool F16>
__global__ void __launch_bounds__(THREADS, 1)
flash_h16_sliced_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using T16 = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int nq = (p.D + 63) / 64, R = p.ring;   // panels of D, chunks
  const int G = p.cpanels;                        // panels a chunk
  const bool qres = p.qres != 0;
  const SlicedSmem L = SlicedSmem::of(nq, p.panels, G, R, p.qres);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // [0]: Q full
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + R;
  uint64_t* vfull = bars + 1 + 2 * R;
  uint64_t* vempty = bars + 3 + 2 * R;
  const Tile tl = tile_of<64, SL_BK>(p);
  // this block's slice: V's panels vp0 .. vp0 + nv - 1
  const int vp0 = (blockIdx.x % p.slices) * p.panels;
  const int nv = min(p.panels, nq - vp0);
  if (threadIdx.x == 0) {
    const int n = p.load == LOAD_TMA ? 1 : 128;
    for (int i = 0; i < 1 + R; ++i) mbar_init(&bars[i], n);
    for (int i = 0; i < R; ++i) mbar_init(&empty[i], 8);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&vfull[i], n);
      mbar_init(&vempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the ring's position: chunk `slot` in its `round`-th use
  int slot = 0, round = 0;
  auto next = [&] {
    if (++slot == R) {
      slot = 0;
      ++round;
    }
  };

  if (threadIdx.x < 128) {   // ---- the loader warpgroup ----
    regs_dealloc<LOADER_REGS_SL>();
    // a chunk's bytes of K (and Q) a panel, and its Q panels' offset
    const int pbytes = SL_PANEL_K + (qres ? 0 : SL_PANEL_Q);
    const int qoff = G * SL_PANEL_K;
    if (p.load == LOAD_TMA) {   // one thread issues every copy
      if (threadIdx.x != 0) return;
      if (qres) {
        mbar_expect_tx(&bars[0], nq * SL_PANEL_Q);
        for (int pn = 0; pn < nq; ++pn)
          tma_load_4d(smem + L.q + pn * SL_PANEL_Q, &tq, &bars[0], pn * 64,
                      tl.h, tl.q0, tl.b);
      }
      for (int it = 0; it < tl.n_kt; ++it) {
        const int k0 = (tl.n_kt - 1 - it) * SL_BK;
        for (int pn0 = 0; pn0 < nq; pn0 += G, next()) {   // a chunk
          const int cnt = min(G, nq - pn0);
          if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
          uint8_t* c = smem + L.ring + slot * L.chunk;
          mbar_expect_tx(&full[slot], cnt * pbytes);
          for (int j = 0; j < cnt; ++j) {
            tma_load_4d(c + j * SL_PANEL_K, &tk, &full[slot],
                        (pn0 + j) * 64, tl.h, k0, tl.b);
            if (!qres)
              tma_load_4d(c + qoff + j * SL_PANEL_Q, &tq, &full[slot],
                          (pn0 + j) * 64, tl.h, tl.q0, tl.b);
          }
        }
        const int s = it & 1;
        if (it >= 2) mbar_wait(&vempty[s], ((it >> 1) - 1) & 1);
        uint8_t* vs = smem + L.v + s * p.panels * SL_PANEL_K;
        mbar_expect_tx(&vfull[s], nv * SL_PANEL_K);
        for (int j = 0; j < nv; ++j)
          tma_load_4d(vs + j * SL_PANEL_K, &tv, &vfull[s], (vp0 + j) * 64,
                      tl.h, k0, tl.b);
      }
      return;
    }
    // cp.async or plain loads by the 128 threads; each group of copies
    // lands, then reaches the consumers' wgmma
    const int tid = threadIdx.x;
    const auto* q = static_cast<const __nv_bfloat16*>(p.q);
    const auto* k = static_cast<const __nv_bfloat16*>(p.k);
    const auto* v = static_cast<const __nv_bfloat16*>(p.v);
    auto landed = [&](uint64_t* bar) {
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(bar);
    };
    if (qres) {
      for (int pn = 0; pn < nq; ++pn)
        load_bf16_tile<1, 64>(smem + L.q + pn * SL_PANEL_Q, q,
                              tl.base + 64 * pn, tl.q0, p.S, p.D - 64 * pn,
                              tl.rstride, p.load, tid);
      landed(&bars[0]);
    }
    for (int it = 0; it < tl.n_kt; ++it) {
      const int k0 = (tl.n_kt - 1 - it) * SL_BK;
      for (int pn0 = 0; pn0 < nq; pn0 += G, next()) {   // a chunk
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        uint8_t* c = smem + L.ring + slot * L.chunk;
        for (int pn = pn0; pn < min(pn0 + G, nq); ++pn) {
          load_bf16_tile<1, SL_BK>(c + (pn - pn0) * SL_PANEL_K, k,
                                   tl.base + 64 * pn, k0, p.S, p.D - 64 * pn,
                                   tl.rstride, p.load, tid);
          if (!qres)
            load_bf16_tile<1, 64>(c + qoff + (pn - pn0) * SL_PANEL_Q, q,
                                  tl.base + 64 * pn, tl.q0, p.S,
                                  p.D - 64 * pn, tl.rstride, p.load, tid);
        }
        landed(&full[slot]);
      }
      const int s = it & 1;
      if (it >= 2) mbar_wait(&vempty[s], ((it >> 1) - 1) & 1);
      uint8_t* vs = smem + L.v + s * p.panels * SL_PANEL_K;
      for (int j = 0; j < nv; ++j)
        load_bf16_tile<1, SL_BK>(vs + j * SL_PANEL_K, v,
                                 tl.base + 64 * (vp0 + j), k0, p.S,
                                 p.D - 64 * (vp0 + j), tl.rstride, p.load,
                                 tid);
      landed(&vfull[s]);
    }
    return;
  }

  // ---- the consumer warpgroups, both on the same 64 rows ----
  regs_alloc<CONSUMER_REGS_SL>();
  const int wg = threadIdx.x / 128 - 1, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = tl.q0 + 16 * w + g;   // and row + 8
  // the slice's panels this warpgroup multiplies: p0 .. p0 + half - 1
  // (both the middle one of an odd count; warpgroup 0 stores it)
  const int half = (nv + 1) / 2, p0 = wg == 1 ? nv - half : 0;
  const int S = p.S;
  const float scale_log2 = p.scale_log2;
  const bool causal = p.causal != 0;
  float o[4][32];
#pragma unroll
  for (int pn = 0; pn < 4; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pn][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float sc[SL_BK / 2];
  uint32_t pa[SL_BK / 16][4];
  const uint64_t dq = sw128_desc(smem + L.q, 16);
  const uint64_t dr = sw128_desc(smem + L.ring, 16);
  const uint64_t dv = sw128_desc(smem + L.v, 1024);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (qres) mbar_wait(&bars[0], 0);

  // Iteration `it` issues O += P(it - 1) V(it - 1), then S = Q K(it) a
  // chunk at a time; the softmax of tile it follows.  With Q resident a key
  // tile is one chunk of two stages, and the warpgroups take turns to
  // issue (FA3's ping-pong, named barriers 1 and 2, as the D-512
  // instantiation does) so that one's softmax overlaps the other's
  // products.  With Q streamed they walk the chunks in lockstep, each
  // chunk freed once the next one's products are in flight.
  const bool pp = qres && G >= nq;
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (pp && wg == 1) named_arrive(1);   // warpgroup 0 goes first
  for (int it = 0; it <= tl.n_kt; ++it) {
    const bool qk = it < tl.n_kt;
    const int vs = (it - 1) & 1;   // V's stage of tile it - 1
    if (it > 0) mbar_wait(&vfull[vs], ((it - 1) >> 1) & 1);
    if (pp) {
      if (qk) mbar_wait(&full[slot], round & 1);
      named_sync(my_turn);
    }
    wgmma_fence();
    if (it > 0) {
      const uint64_t dvs = dv + vs * (p.panels * SL_PANEL_K / 16);
#pragma unroll
      for (int kk = 0; kk < SL_BK / 16; ++kk)
#pragma unroll
        for (int pn = 0; pn < 4; ++pn)
          if (pn < half)
            wgmma_rs_n64_tb<F16>(
                o[pn], pa[kk],
                dvs + ((p0 + pn) * SL_PANEL_K + 2048 * kk) / 16);
      wgmma_commit();
    }
    int prev = -1;   // the chunk issued last
    for (int pn0 = 0; qk && pn0 < nq; pn0 += G) {   // a chunk of the ring
      const int cnt = min(G, nq - pn0);
      mbar_wait(&full[slot], round & 1);
      const uint64_t kb = dr + slot * (L.chunk / 16);
      const uint64_t qb = qres ? dq + pn0 * (SL_PANEL_Q / 16)
                               : kb + G * (SL_PANEL_K / 16);
      for (int j = 0; j < cnt; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // 32 bytes a k16 step
          wgmma_ss_n32<F16>(sc, qb + j * (SL_PANEL_Q / 16) + 2 * kk,
                            kb + j * (SL_PANEL_K / 16) + 2 * kk,
                            pn0 + j + kk > 0);
      wgmma_commit();
      if (!pp) {
        // all but this chunk's products are done: free the chunk before
        // it (at the first chunk, V's stage of tile it - 1)
        wgmma_wait<1>();
        if (prev >= 0)
          release(&empty[prev]);
        else if (it > 0)
          release(&vempty[vs]);
      }
      prev = slot;
      next();
    }
    // every sync is matched: warpgroup 1's last turn hands over to no one
    if (pp && (wg == 0 || qk)) named_arrive(their_turn);
    wgmma_wait0();
    reg_fence<SL_BK / 2>(sc);
#pragma unroll
    for (int pn = 0; pn < 4; ++pn) reg_fence<32>(o[pn]);
    if (prev >= 0) release(&empty[prev]);
    if (it > 0 && (pp || !qk)) release(&vempty[vs]);
    if (!qk) break;

    const int k0 = (tl.n_kt - 1 - it) * SL_BK;
    // only the tiles that reach past S or above this warp's first row mask
    const bool mask = k0 + SL_BK > S || (causal && k0 + SL_BK - 1 > row - g);
    float corr[2], rs[2];
    online_softmax<SL_BK / 2>(sc, m, corr, rs, scale_log2, S, causal, row, k0,
                              t, mask);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int pn = 0; pn < 4; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] *= corr[(i >> 1) & 1];
    // P as the register A operand: k16 step kk covers keys 16 kk .. + 15
#pragma unroll
    for (int kk = 0; kk < SL_BK / 16; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * (2 * kk + h2) + 2 * r;
          pa[kk][2 * h2 + r] =
              pack2(sc[i], sc[i + 1], static_cast<T16*>(nullptr));
        }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int pn = 0; pn < 4; ++pn)
    if (pn < half && p0 + pn >= wg * half)
      store_rows<T16, 32>(p.o, S, p.D, tl, o[pn], 64 * (vp0 + p0 + pn), row,
                          t, l);
}

// The float32 sliced kernel, heads past 256: one block per (query tile of
// 32 rows, output slice); see the header for the design.
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_sliced_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int nq = (p.D + 63) / 64, R = p.ring;   // panels of D, chunks
  const int G = p.cpanels;                        // panels a chunk
  const bool qres = p.qres != 0;
  const F32SlicedSmem L = F32SlicedSmem::of(nq, p.panels, G, R, p.qres);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // [0]: Q full
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + R;
  uint64_t* vfull = bars + 1 + 2 * R;
  uint64_t* vempty = bars + 3 + 2 * R;
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  const Tile tl = tile_of<FS_BQ, FS_BK>(p);
  // this block's slice: V's panels vp0 .. vp0 + nv - 1
  const int vp0 = (blockIdx.x % p.slices) * p.panels;
  const int nv = min(p.panels, nq - vp0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + R; ++i) mbar_init(&bars[i], 128);
    for (int i = 0; i < R; ++i) mbar_init(&empty[i], 8);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&vfull[i], 128);
      mbar_init(&vempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the ring's position: chunk `slot` in its `round`-th use
  int slot = 0, round = 0;
  auto next = [&] {
    if (++slot == R) {
      slot = 0;
      ++round;
    }
  };

  if (threadIdx.x < 128) {   // ---- the loader warpgroup ----
    regs_dealloc<LOADER_REGS_FS>();
    const int tid = threadIdx.x;
    const auto* q = static_cast<const float*>(p.q);
    const auto* k = static_cast<const float*>(p.k);
    const auto* v = static_cast<const float*>(p.v);
    // each group of copies is signalled once the group after it is
    // issued, so two are in flight
    uint64_t* pending = nullptr;
    auto issued = [&](uint64_t* bar) {
      cp_async_commit();
      if (pending != nullptr) {
        cp_async_wait<1>();
        mbar_arrive(pending);
      }
      pending = bar;
    };
    if (qres) {
      for (int pn = 0; pn < nq; ++pn)
        load_f32_rows<FS_BQ>(Qs + pn * (FS_PANEL_Q / 4), FS_LD, q,
                             tl.base + 64 * pn, tl.q0, p.S, 64,
                             p.D - 64 * pn, tl.rstride, p.load, tid);
      issued(&bars[0]);
    }
    for (int it = 0; it < tl.n_kt; ++it) {
      const int k0 = (tl.n_kt - 1 - it) * FS_BK;
      for (int pn0 = 0; pn0 < nq; pn0 += G, next()) {   // a chunk
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        float* c = reinterpret_cast<float*>(smem + L.ring + slot * L.chunk);
        for (int pn = pn0; pn < min(pn0 + G, nq); ++pn) {
          load_f32_rows<FS_BK>(c + (pn - pn0) * (FS_PANEL_K / 4), FS_LD, k,
                               tl.base + 64 * pn, k0, p.S, 64, p.D - 64 * pn,
                               tl.rstride, p.load, tid);
          if (!qres)
            load_f32_rows<FS_BQ>(
                c + (G * FS_PANEL_K + (pn - pn0) * FS_PANEL_Q) / 4, FS_LD, q,
                tl.base + 64 * pn, tl.q0, p.S, 64, p.D - 64 * pn, tl.rstride,
                p.load, tid);
        }
        issued(&full[slot]);
      }
      const int s = it & 1;
      if (it >= 2) mbar_wait(&vempty[s], ((it >> 1) - 1) & 1);
      load_f32_rows<FS_BK>(Vs + s * FS_BK * L.vld, L.vld, v,
                           tl.base + 64 * vp0, k0, p.S, 64 * nv,
                           p.D - 64 * vp0, tl.rstride, p.load, tid);
      issued(&vfull[s]);
    }
    cp_async_wait<0>();
    if (pending != nullptr) mbar_arrive(pending);
    return;
  }

  // ---- the consumer warps: two row groups of 16 rows, four warps each ----
  regs_alloc<CONSUMER_REGS_FS>();
  const int cw = threadIdx.x / 32 - 4, rg = cw >> 2, qj = cw & 3;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = tl.q0 + 16 * rg + g;   // and row + 8
  // the warp's output: n-tiles (8 columns) qj * ntq .. of the slice's live
  // ones, from column c0
  const int ntq = 2 * p.panels;
  const int n_live = min(8 * nv, (p.D - 64 * vp0 + 7) / 8);
  const int n_ot = min(ntq, max(0, n_live - qj * ntq));
  const int c0 = 8 * qj * ntq;   // within the slice
  const int S = p.S;
  const float scale_log2 = p.scale_log2;
  const bool causal = p.causal != 0;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float* xchg = reinterpret_cast<float*>(smem + L.xchg);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (qres) mbar_wait(&bars[0], 0);

  for (int it = 0; it < tl.n_kt; ++it) {
    const int k0 = (tl.n_kt - 1 - it) * FS_BK;
    // S = Q K^T over the warp's quarter of each panel's columns (k-steps
    // 2 qj and 2 qj + 1 of 8), chunk by chunk through the ring
    float sc[FS_BK / 2];
#pragma unroll
    for (int i = 0; i < FS_BK / 2; ++i) sc[i] = 0.0f;
    for (int pn0 = 0; pn0 < nq; pn0 += G) {
      const int cnt = min(G, nq - pn0);
      mbar_wait(&full[slot], round & 1);
      const float* c =
          reinterpret_cast<const float*>(smem + L.ring + slot * L.chunk);
      for (int j = 0; j < cnt; ++j) {
        const int pn = pn0 + j;
        const float* kp = c + j * (FS_PANEL_K / 4);
        const float* qp = (qres ? Qs + pn * (FS_PANEL_Q / 4)
                                : c + (G * FS_PANEL_K + j * FS_PANEL_Q) / 4) +
                          16 * rg * FS_LD;
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int col = 8 * (2 * qj + kq) + t;
          if (64 * pn + col - t >= p.D) break;   // columns past D
          const SplitA a = split_a(qp[g * FS_LD + col], qp[(g + 8) * FS_LD + col],
                                   qp[g * FS_LD + col + 4],
                                   qp[(g + 8) * FS_LD + col + 4]);
          float b0[2], b1[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            b0[nt] = kp[(8 * nt + g) * FS_LD + col];
            b1[nt] = kp[(8 * nt + g) * FS_LD + col + 4];
          }
          mma_3xtf32<2>(sc, a, b0, b1, 2);
        }
      }
      release(&empty[slot]);
      next();
    }
    // the row group's four partial sums, added in one order by all four
    // warps, so they hold the same bits of S, m, l and P
    float* xb = xchg + (it & 1) * 8 * 256;
#pragma unroll
    for (int i = 0; i < 8; ++i) xb[cw * 256 + i * 32 + lane] = sc[i];
    named_sync(1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* x0 = xb + 4 * rg * 256 + i * 32 + lane;
      sc[i] = ((x0[0] + x0[256]) + x0[512]) + x0[768];
    }

    // only the tiles that reach past S or above this row group's first row
    // mask
    const bool mask = k0 + FS_BK > S || (causal && k0 + FS_BK - 1 > row - g);
    float corr[2], rs[2];
    online_softmax<FS_BK / 2>(sc, m, corr, rs, scale_log2, S, causal, row,
                              k0, t, mask);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V, the accumulator fragment reused as the A fragment (keys 2t
    // and 2t + 1 as columns t and t + 4, V's rows read in that order)
    const int s = it & 1;
    mbar_wait(&vfull[s], (it >> 1) & 1);
    const float* vs = Vs + s * FS_BK * L.vld;
#pragma unroll
    for (int kk = 0; kk < FS_BK / 8; ++kk) {
      const SplitA a = split_a(sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                               sc[4 * kk + 3]);
      const float* v0 = vs + (8 * kk + 2 * t) * L.vld + c0 + g;
      float b0[16], b1[16];   // column tiles past the warp's are skipped
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        b0[nt] = nt < n_ot ? v0[8 * nt] : 0.0f;
        b1[nt] = nt < n_ot ? v0[L.vld + 8 * nt] : 0.0f;
      }
      mma_3xtf32<16>(o, a, b0, b1, n_ot);
    }
    release(&vempty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* orow = static_cast<float*>(p.o) + tl.base + (long long)rr * tl.rstride;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      if (nt < n_ot)
        store_pair(orow, 64 * vp0 + c0 + 8 * nt + 2 * t, p.D,
                   o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
  }
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

// The 4-D map over a 16-bit [B, S, H, D] tensor: dims innermost first
// (D, H, S, B), box (64, 1, rows, 1), 128-byte swizzle, zero fill.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             bool f16, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The 16-bit kernel of `np` panels (1, 2, 4 or 8).
template <bool F16>
int launch_h16(int np, const CUtensorMap* m, dim3 grid, cudaStream_t st,
               const Params& p) {
  switch (np) {
    case 1:
      return launch(flash_h16_kernel<1, F16>, Bf16Smem<1>::BYTES, grid, st,
                    m[0], m[1], m[2], p);
    case 2:
      return launch(flash_h16_kernel<2, F16>, Bf16Smem<2>::BYTES, grid, st,
                    m[0], m[1], m[2], p);
    case 4:
      return launch(flash_h16_kernel<4, F16>, Bf16Smem<4>::BYTES, grid, st,
                    m[0], m[1], m[2], p);
    default:
      return launch(flash_h16_kernel<8, F16>, Bf16Smem<8>::BYTES, grid, st,
                    m[0], m[1], m[2], p);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o contiguous [b, s, h, d] (1 <= d <= 256 in float32, <= 512 in
// the 16-bit types), `dtype` 0 float32, 1 bfloat16 or 2 float16; `scale`
// multiplies the scores.  `load` is how the
// tiles are loaded: 16-bit types 0 (TMA: d % 8 == 0 and 16-byte aligned
// pointers), 4 (cp.async: d even, 4-byte aligned) or 2 (plain loads);
// float32 16 (cp.async: d % 4 == 0, 16-byte aligned) or 4.  Launches on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a `load` the operands do not allow.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int s,
                                      int h, int d, float scale, int causal,
                                      int dtype, int load, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool h16 = dtype == 1 || dtype == 2, f16 = dtype == 2;
  const long long kv_head = 2ll * s * d * (h16 ? 2 : 4);
  const int group = (int)std::max(
      1ll, std::min((long long)b * h, (long long)(L2_GROUP_BYTES / kv_head)));
  const Params p{q, k, v, o, s, h, d, scale * LOG2E, causal, load, b * h,
                 group};
  // query rows a block
  const int bq = (h16 && d > 256) || (!h16 && d > 128) ? 64 : BQ;
  const long long blocks = (long long)((s + bq - 1) / bq) * b * h;
  if (blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((unsigned)blocks);
  auto all_aligned = [&](int n) {
    return aligned(q, n) && aligned(k, n) && aligned(v, n);
  };
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (d < 1 || d > (h16 ? 512 : 256) || dtype < 0 || dtype > 2) return bad;
  if (h16) {
    if ((load == LOAD_TMA && (d % 8 || !all_aligned(16))) ||
        (load == LOAD_CP4 && (d % 2 || !all_aligned(4))) ||
        (load != LOAD_TMA && load != LOAD_CP4 && load != LOAD_LD2))
      return bad;
    const int np = d <= 64 ? 1 : d <= 128 ? 2 : d <= 256 ? 4 : 8;
    const int bk = np == 8   ? bk16<8>()
                   : np == 4 ? bk16<4>()
                             : bk16<1>();   // key rows a tile
    CUtensorMap maps[3] = {};
    if (load == LOAD_TMA) {
      const void* ptrs[3] = {q, k, v};
      for (int i = 0; i < 3; ++i) {
        const int err =
            make_map(&maps[i], ptrs[i], b, s, h, d, f16, i == 0 ? bq : bk);
        if (err) return err;
      }
    }
    return f16 ? launch_h16<true>(np, maps, grid, st, p)
               : launch_h16<false>(np, maps, grid, st, p);
  }
  if ((load == LOAD_CP16 && (d % 4 || !all_aligned(16))) ||
      (load != LOAD_CP16 && load != LOAD_CP4))
    return bad;
  if (d <= 64)
    return launch(flash_f32_kernel<1>, F32Smem<1>::BYTES, grid, st, p);
  if (d <= 128)
    return launch(flash_f32_kernel<2>, F32Smem<2>::BYTES, grid, st, p);
  return launch(flash_f32_kernel<4>, F32Smem<4>::BYTES, grid, st, p);
}

// The sliced kernels: q, k, v, o contiguous [b, s, h, d] of `dtype` 1
// bfloat16 or 2 float16 (the wgmma kernel, meant for d > 512) or 0 float32
// (the 3xTF32 kernel, meant for d > 256); any d >= 1 runs.  `load` as
// above, and the plan (kernels/flash_attention.py:slice_plan, and
// tf32_slice_plan for float32): `slices` output slices of `panels`
// 64-column panels (the last may hold fewer), `ring` chunks of `cpanels`
// panels, Q resident in shared memory when `qres` is 1.  Returns
// cudaErrorInvalidValue for a plan that does not cover d, leaves a slice
// empty or does not fit shared memory.
extern "C" int flash_attention_sliced_launch(
    const void* q, const void* k, const void* v, void* o, int b, int s,
    int h, int d, float scale, int causal, int dtype, int load, int slices,
    int panels, int cpanels, int ring, int qres, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int nq = (d + 63) / 64;
  const bool f32 = dtype == 0;
  if (d < 1 || dtype < 0 || dtype > 2 || panels < 1 || panels > 8 ||
      slices < 1 || (long long)slices * panels < nq ||
      (slices - 1) * panels >= nq || ring < 2 || ring > SL_RING_MAX ||
      cpanels < 1 || cpanels > nq || (qres != 0 && qres != 1) ||
      (f32 ? F32SlicedSmem::of(nq, panels, cpanels, ring, qres).bytes
           : SlicedSmem::of(nq, panels, cpanels, ring, qres).bytes) >
          SMEM_MAX)
    return bad;
  auto all_aligned = [&](int n) {
    return aligned(q, n) && aligned(k, n) && aligned(v, n);
  };
  if (f32) {
    if ((load == LOAD_CP16 && (d % 4 || !all_aligned(16))) ||
        (load != LOAD_CP16 && load != LOAD_CP4))
      return bad;
    const long long kv_head = 2ll * s * d * 4;
    const int group = (int)std::max(
        1ll, std::min((long long)b * h, (long long)(L2_GROUP_BYTES / kv_head)));
    Params p{q, k, v, o, s, h, d, scale * LOG2E, causal, load, b * h, group};
    p.slices = slices;
    p.panels = panels;
    p.cpanels = cpanels;
    p.ring = ring;
    p.qres = qres;
    const long long blocks =
        (long long)((s + FS_BQ - 1) / FS_BQ) * b * h * slices;
    if (blocks > 0x7fffffffll)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    return launch(flash_f32_sliced_kernel,
                  F32SlicedSmem::of(nq, panels, cpanels, ring, qres).bytes,
                  dim3((unsigned)blocks), st, p);
  }
  if ((load == LOAD_TMA && (d % 8 || !all_aligned(16))) ||
      (load == LOAD_CP4 && (d % 2 || !all_aligned(4))) ||
      (load != LOAD_TMA && load != LOAD_CP4 && load != LOAD_LD2))
    return bad;
  const bool f16 = dtype == 2;
  const long long kv_head = 2ll * s * d * 2;
  const int group = (int)std::max(
      1ll, std::min((long long)b * h, (long long)(L2_GROUP_BYTES / kv_head)));
  Params p{q, k, v, o, s, h, d, scale * LOG2E, causal, load, b * h, group};
  p.slices = slices;
  p.panels = panels;
  p.cpanels = cpanels;
  p.ring = ring;
  p.qres = qres;
  const long long blocks = (long long)((s + 63) / 64) * b * h * slices;
  if (blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap maps[3] = {};
  if (load == LOAD_TMA) {
    const void* ptrs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      const int err =
          make_map(&maps[i], ptrs[i], b, s, h, d, f16, i == 0 ? 64 : SL_BK);
      if (err) return err;
    }
  }
  const int bytes = SlicedSmem::of(nq, panels, cpanels, ring, qres).bytes;
  const dim3 grid((unsigned)blocks);
  return f16 ? launch(flash_h16_sliced_kernel<true>, bytes, grid, st, maps[0],
                      maps[1], maps[2], p)
             : launch(flash_h16_sliced_kernel<false>, bytes, grid, st,
                      maps[0], maps[1], maps[2], p);
}
