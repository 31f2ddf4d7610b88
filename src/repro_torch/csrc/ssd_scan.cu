// Mamba-2 SSD chunk scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py:56 (ssd_scan,
// pallas_call at :66): for x [b, S, H, P], dt [b, S, H], A [H] and
// B, C [b, S, N], the selective-state-space recurrence
//     state_t = exp(dt_t A) state_{t-1} + dt_t x_t (x) B_t,  y_t = state_t C_t
// in its chunked (state-space dual) form.  Every input is float32 inside (x
// may be float32, bfloat16 or float16, the rest come widened to float32); y
// is written in x's type.  D-skip and gating stay outside, as in the Pallas
// kernel.
//
// Bound on an H100: the recurrence's least count is ~4 P N flops a step
// per head, ~276 G at the suite's size (b 8, S 65,536, H 16, P 64, N 128):
// 1.67 ms as 3xTF32 (three TF32 products a product at 495 TFLOP/s) against
// ~4.9 GB moved once, 1.46 ms.
//
// Design: three passes, chunk-parallel, every product on the tensor cores
// (mma.sync m16n8k8 in 3xTF32, tf32.cuh).  The sequence is cut into chunks
// of CHUNK = 512 steps; the result depends on the chunking only through
// rounding, so the chunk is the kernels' own, not the caller's.
//  (a) chunk pass, one block per (b, chunk, head, P-slice): the chunk's own
//      end state from zero, Z_c = sum_u exp(seg_end - seg_u) (x dt)_u (x)
//      B_u, and its sum of dt A, into a [b, chunks, H, P, N] float32 buffer
//      (0.54 GB at the suite's size) and a [b, chunks, H] one;
//  (b) state pass, one thread per (b, h, state element), elementwise over
//      the chunks in order: Z_c is replaced by the state the chunk starts
//      from, s_{c+1} = exp(sum_c) s_c + Z_c (no atomics: every sum is taken
//      by one thread in a fixed order, so repeated calls give the same
//      bits);
//  (c) output pass, one block per (b, chunk, group of up to four heads,
//      P-slice), from the chunk's start state: y_t = sum_{u <= t} (C_t .
//      B_u) exp(seg_t - seg_u) (x dt)_u + exp(seg_t) C_t . state.
// Passes (a) and (c) walk their chunk in tiles of T = 32 or 64 steps (the
// host's plan: the output pass takes four heads a block in 32-step tiles
// where they fit, the chunk pass one head in 64-step tiles), the state of
// each head [PS][N] in shared memory, carried from tile to tile as the
// one-block kernel did: within a tile, G = C B^T (shared by the heads of
// the group, kept in registers), every head's W = G o exp(seg_t - seg_u)
// formed only for u <= t, then Y = W (x dt) + exp(seg_t) (C state^T) and
// state = exp(seg_end) state + (x dt o exp(seg_end - seg))^T B for all
// heads at once, a warp taking whole units of one head (two m-tiles x
// four n-tiles of Y; every m-tile x four n-tiles of the state), so a tile
// needs two barriers past its loads whatever the heads.  seg is the
// running sum of dt A within the tile,
// so every exponent is seg_t - seg_u with t >= u, seg_t, or seg_end - seg_u:
// none is positive (A < 0), and a chunk's earlier tiles reach a later one
// only through the carried state, i.e. the decay of an off-diagonal
// sub-block is factored at the tile boundary between them.  (The Pallas
// kernel exponentiates the whole difference and masks after, which a CUDA
// product of inf and 0 would turn into NaN.)  Steps past S are zero (dt = 0,
// x = 0, B = C = 0), which leaves the state and the running sum unchanged.
// A head wider than MAX_PS = 64 columns is split into ceil(P / 64) slices
// of equal width, one block each (each column of the state is independent).
// Shared-memory rows are padded so that every fragment read is free of bank
// conflicts; B, read both along N (for C B^T) and along the steps (for the
// state update), has its columns swizzled per row instead (bswz).
//
// A state too wide for one block (32-step tiles of one head past 227 KB:
// N > 416 at P >= 64) is split along N into panels of NW columns (a
// multiple of 8; the last may hold fewer), one block each, as P is split:
// each column of the state, and so each of its end states and start
// states, depends on its own columns of B alone, so passes (a) and (b)
// take the panels as they are.  y needs all of N: y = sum over the panels
// of (C_p B_p^T o decay) (x dt) + exp(seg) C_p state_p^T, each panel's
// share formed by the same code on its own columns of B and C, written as
// float32 to its own slice of a [panels, b, S, H, P] buffer (x comes
// widened to float32 on this route) and added by pass (d), one thread an
// output element, the panels in order: no atomics, so a call repeats bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
// steps a chunk, the state buffer's grain: 512 moved 0.8 of 23.5 ms off
// 256 at the suite's size, half of it in the state pass
// (scripts/ssd_scan_variants.py)
constexpr int CHUNK = 512;
constexpr int MAX_PS = 64;   // state rows (p) a block holds
constexpr int LOADS = 8;     // global loads a thread keeps in flight
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// N-byte cp.async (N 4 or 16); `valid` false writes N zero bytes and reads
// nothing.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// B's column n of row u sits at n ^ bswz(u) (within its group of 32): the
// fragment reads along N (rows g, columns t) and along the steps (rows t,
// columns g) then both hit 32 distinct banks.
__device__ __forceinline__ int bswz(int u) {
  return ((u & 3) << 3) | (((u >> 2) & 1) << 2);
}

// A block's shared memory, in floats: the heads' states [hg][ps16][lds],
// B [T][ldb] (swizzled), C [T][ldc] (output pass), x dt [hg][T][ldx], W
// [hg][T][ldw] (output pass), and per head the running sum, dt, exp(seg)
// and exp(seg_end - seg) [hg][4][T].  A stride of 4 mod 8 floats makes the reads
// of rows g, columns t conflict-free, 8 mod 16 those of rows t, columns g.
struct Layout {
  int lds, ldb, ldc, ldx, ldw;
  int s, b, c, x, w, vec, floats;
  __host__ __device__ static Layout of(int T, int PS, int N, int hg,
                                       bool out) {
    Layout L;
    const int n8 = round_up(N, 8), ps16 = round_up(PS, 16);
    L.lds = n8 + 4;
    L.ldb = round_up(n8, 32);
    L.ldc = n8 + 4;
    L.ldx = ps16 + 8;
    L.ldw = T + 4;
    L.s = 0;
    L.b = L.s + hg * ps16 * L.lds;
    L.c = L.b + T * L.ldb;
    L.x = L.c + (out ? T * L.ldc : 0);
    L.w = L.x + hg * T * L.ldx;
    L.vec = L.w + (out ? hg * T * L.ldw : 0);
    L.floats = L.vec + 4 * hg * T;
    return L;
  }
};

// Passes (a) (OUT false) and (c) (OUT true) for tiles of T steps; one block
// per (b, chunk, head group of hg, P-slice of PS), the P-slice fastest, so
// the blocks sharing a chunk's B and C run together and read them from L2.
// Pass (a) starts from zero and writes the end state to Z and the chunk's
// sum of dt A to segsum; pass (c) starts from Z (zero where Z is null) and
// writes y.
// The output pass's block takes most of an SM's shared memory at the
// suite's size (four heads' states), so it is bound for one block an SM
// (up to 255 registers a thread: its products run two k-steps an
// iteration); the chunk pass's for two (128 registers: one k-step; ptxas
// spills up to 28 bytes there, and two blocks an SM still ran faster than
// one with room for two stages of a tile's operands).
// N is the state's width (the row length of B, C and Z), NW a panel's
// (N on the one-panel route); pass (c) writes panel p's y at y + p ypanel.
template <typename Tx, int T, bool OUT>
__global__ void __launch_bounds__(THREADS, OUT ? 1 : 2)
ssd_chunk_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ Z,
                 float* __restrict__ segsum, Tx* __restrict__ y, int S,
                 int H, int P, int N, int PS, int hg, int NW,
                 long long ypanel) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = Layout::of(T, PS, NW, hg, OUT);
  const int nc = (S + CHUNK - 1) / CHUNK, nps = (P + PS - 1) / PS;
  const int ngroups = (H + hg - 1) / hg, npan = (N + NW - 1) / NW;
  unsigned blk = blockIdx.x;
  const int ps = blk % nps;
  blk /= nps;
  const int pan = blk % npan;
  blk /= npan;
  const int grp = blk % ngroups;
  blk /= ngroups;
  const int c = blk % nc, b = blk / nc;
  const int p0 = ps * PS, np = min(PS, P - p0);   // this block's state rows
  const int n0 = pan * NW, nn = min(NW, N - n0);  // and columns
  const int h0 = grp * hg, nh = min(hg, H - h0);  // and heads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n8 = round_up(NW, 8), ps16 = round_up(PS, 16);
  const long long PN = (long long)P * N;
  float* st = smem + L.s;
  float* bs = smem + L.b;
  float* cs = smem + L.c;
  float* xs = smem + L.x;
  float* ws = smem + L.w;
  float* vec = smem + L.vec;

  // Rows go to shared memory by cp.async, a warp a row, 16 bytes a lane
  // where the row's length and alignment allow it, else 4; everything past
  // a row's end, S, the slice or the heads is zero-filled.
  const bool v4 = N % 4 == 0 && NW % 4 == 0 && aligned16(Bm) &&
                  (!OUT || aligned16(Cm)) &&
                  (!OUT || Z == nullptr || aligned16(Z));
  constexpr bool XF = sizeof(Tx) == 4;   // float32 x: by cp.async too
  const bool xv4 = XF && P % 4 == 0 && PS % 4 == 0 && aligned16(x);
  auto copy_row = [&](float* dst, const float* src, int len, int width,
                      bool in, auto swz) {
    if (v4) {
      for (int n = 4 * lane; n < width; n += 128)
        cp_async<16>(dst + swz(n), in && n < len ? src + n : src,
                     in && n < len);
    } else {
      for (int n = lane; n < width; n += 32)
        cp_async<4>(dst + swz(n), in && n < len ? src + n : src,
                    in && n < len);
    }
  };
  const auto flat = [](int n) { return n; };

  // the start state: Z's rows of this slice (output pass), else zero
  for (int r = warp; r < hg * ps16; r += WARPS) {
    const int hh = r / ps16, p = r % ps16;
    float* dst = st + r * L.lds;
    if (OUT && Z != nullptr) {
      copy_row(dst,
               Z + (((long long)b * nc + c) * H + h0 + min(hh, nh - 1)) * PN +
                   (long long)(p0 + min(p, np - 1)) * N + n0,
               nn, n8, hh < nh && p < np, flat);
    } else {
      for (int n = lane; n < n8; n += 32) dst[n] = 0.0f;
    }
  }
  float lsum = 0.0f;   // pass (a): thread hh's sum of dt A over the chunk

  // The chunk pass's state update of head hh: S = exp(seg_end) S + (x dt o
  // sd)^T B over the tile, [ps16 x n8] in m-tile pairs x groups of 4
  // n-tiles over all eight warps (one head a block).
  auto update = [&](int hh) {
    const float* v = vec + hh * 4 * T;
    const float* xh = xs + hh * T * L.ldx;
    float* sh = st + hh * ps16 * L.lds;
    const float a = v[2 * T + T - 1];
    const int mt = ps16 / 16, nt8 = n8 / 8;
    const bool two = mt > 2;   // two m-tile pairs: warps split by parity
    const int mp = two ? (warp & 1) : 0;
    const int um = min(2, mt - 2 * mp);
    for (int ng = two ? warp >> 1 : warp; 4 * ng < nt8; ng += two ? 4 : 8) {
      const int un = min(4, nt8 - 4 * ng);
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i < um && j < un) {
              const int p = 16 * (2 * mp + i) + g + 8 * (e >> 1);
              const int n = 8 * (4 * ng + j) + 2 * t4 + (e & 1);
              acc[i][j][e] = a * sh[p * L.lds + n];
            }
      mma_tiles<2, 4, OUT ? 2 : 1>(
          acc,
          [&](int i, int r, int k) {
            return xh[k * L.ldx + 16 * (2 * mp + i) + r] * v[3 * T + k];
          },
          [&](int j, int k, int col) {
            const int n = 8 * (4 * ng + j) + col;
            return bs[k * L.ldb + (n ^ bswz(k))];
          },
          T, um, un, g, t4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i < um && j < un) {
              const int p = 16 * (2 * mp + i) + g + 8 * (e >> 1);
              const int n = 8 * (4 * ng + j) + 2 * t4 + (e & 1);
              sh[p * L.lds + n] = acc[i][j][e];
            }
    }
  };

  // The tile at t0's B (and C) [T][n8] and a float32 x [hg][T][ps16], all
  // in flight at once.
  auto issue = [&](int t0) {
    const int nt = min(T, S - t0);
    const long long row0 = (long long)b * S + t0;
    for (int u = warp; u < T; u += WARPS) {
      const long long gi = (row0 + min(u, nt - 1)) * N + n0;
      copy_row(bs + u * L.ldb, Bm + gi, nn, n8, u < nt,
               [&](int n) { return n ^ bswz(u); });
      if (OUT) copy_row(cs + u * L.ldc, Cm + gi, nn, n8, u < nt, flat);
    }
    if constexpr (XF) {
      for (int r = warp; r < hg * T; r += WARPS) {
        const int hh = r / T, u = r % T;
        const float* src = reinterpret_cast<const float*>(x) +
                           ((row0 + min(u, nt - 1)) * H + h0 +
                            min(hh, nh - 1)) * P + p0;
        const bool in = hh < nh && u < nt;
        float* dst = xs + r * L.ldx;
        if (xv4) {
          for (int p = 4 * lane; p < ps16; p += 128)
            cp_async<16>(dst + p, in && p < np ? src + p : src,
                         in && p < np);
        } else {
          for (int p = lane; p < ps16; p += 32)
            cp_async<4>(dst + p, in && p < np ? src + p : src, in && p < np);
        }
      }
    }
  };

  const int t_begin = c * CHUNK, t_end = min(S, t_begin + CHUNK);
  for (int t0 = t_begin; t0 < t_end; t0 += T) {
    const int nt = min(T, S - t0);
    const long long row0 = (long long)b * S + t0;   // (b, t0) in [b, S]
    const bool last = t0 + T >= t_end;
    __syncthreads();   // the previous tile is done with everything below
    issue(t0);   // in flight while the running sum is taken
    asm volatile("cp.async.commit_group;" ::: "memory");

    // ---- dt and the running sum of dt A: a warp scan a 32 steps --------
    if (tid < hg * T) {
      const int hh = tid / T, i = tid % T;
      const float d = hh < nh && i < nt ? dt[(row0 + i) * H + h0 + hh] : 0.0f;
      float s = d * (hh < nh ? A[h0 + hh] : 0.0f);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += u;
      }
      vec[hh * 4 * T + i] = s;
      vec[hh * 4 * T + T + i] = d;
    }
    __syncthreads();
    if (T > 32 && tid < hg * T && tid % T >= 32)
      vec[(tid / T) * 4 * T + tid % T] += vec[(tid / T) * 4 * T + 31];

    // ---- a 16-bit x, widened and times dt: a batch's loads all in flight
    // before its first store --------------------------------------------
    for (int base = 0; !XF && base < hg * T * ps16;
         base += THREADS * LOADS) {
      float r[LOADS];
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid;
        const int hh = i / (T * ps16), u = (i / ps16) % T, p = i % ps16;
        r[k] = i < hg * T * ps16 && hh < nh && u < nt && p < np
                   ? to_f(x[((row0 + u) * H + h0 + hh) * P + p0 + p])
                   : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int i = base + k * THREADS + tid;
        const int hh = i / (T * ps16), u = (i / ps16) % T, p = i % ps16;
        if (i < hg * T * ps16)
          xs[(hh * T + u) * L.ldx + p] = r[k] * vec[hh * 4 * T + T + u];
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (tid < hg * T) {   // exp(seg_t) and exp(seg_end - seg_t)
      float* v = vec + (tid / T) * 4 * T;
      const int i = tid % T;
      v[2 * T + i] = expf(v[i]);
      v[3 * T + i] = expf(v[T - 1] - v[i]);
    }
    if (!OUT && tid < nh) lsum += vec[tid * 4 * T + T - 1];
    if constexpr (XF) {   // x dt
      for (int r = warp; r < hg * T; r += WARPS) {
        const float d = vec[(r / T) * 4 * T + T + r % T];
        for (int p = lane; p < ps16; p += 32) xs[r * L.ldx + p] *= d;
      }
    }
    __syncthreads();

    if constexpr (!OUT) {
      for (int hh = 0; hh < nh; ++hh) update(hh);
    } else {
      // ---- G = C B^T, the n-tiles on or below the diagonal ----------------
      constexpr int NTG = T == 64 ? 4 : 1, GW = T / 8 / NTG;
      const int gm = warp / GW, gn0 = (warp % GW) * NTG;
      const int gn = min(NTG, max(0, 2 * gm + 2 - gn0));
      float gacc[1][NTG][4];
#pragma unroll
      for (int j = 0; j < NTG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[0][j][e] = 0.0f;
      mma_tiles<1, NTG>(
          gacc, [&](int, int r, int k) { return cs[(16 * gm + r) * L.ldc + k]; },
          [&](int j, int k, int col) {
            const int u = 8 * (gn0 + j) + col;
            return bs[u * L.ldb + (k ^ bswz(u))];
          },
          n8, 1, gn, g, t4);
      // ---- W of every head: G o exp(seg_t - seg_u) for u <= t, else 0 ----
      for (int hh = 0; hh < hg; ++hh) {
        const float* v = vec + hh * 4 * T;
        float* wh = ws + hh * T * L.ldw;
#pragma unroll
        for (int j = 0; j < NTG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * gm + g + 8 * (e >> 1);
            const int u = 8 * (gn0 + j) + 2 * t4 + (e & 1);
            wh[t * L.ldw + u] = hh < nh && j < gn && u <= t
                                    ? gacc[0][j][e] * expf(v[t] - v[u])
                                    : 0.0f;
          }
      }
      __syncthreads();
      // ---- y = W (x dt) + exp(seg_t) C S^T: a warp's unit is two m-tiles
      // x four n-tiles (of p) of one head ---------------------------------
      {
        const int per_head = T / 32 * 2, nlive = (np + 7) / 8;
        for (int unit = warp; unit < nh * per_head; unit += WARPS) {
          const int hh = unit / per_head, mp = unit % per_head / 2;
          const int ng = unit % 2, yn = min(4, nlive - 4 * ng);
          if (yn <= 0) continue;
          const float* v = vec + hh * 4 * T;
          const float* wh = ws + hh * T * L.ldw;
          const float* xh = xs + hh * T * L.ldx;
          const float* sh = st + hh * ps16 * L.lds;
          float yi[2][4][4], ys[2][4][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) yi[i][j][e] = ys[i][j][e] = 0.0f;
          // W is zero right of the diagonal: k stops at the m-tiles' end
          mma_tiles<2, 4>(
              yi,
              [&](int i, int r, int k) {
                return wh[(32 * mp + 16 * i + r) * L.ldw + k];
              },
              [&](int j, int k, int col) {
                return xh[k * L.ldx + 8 * (4 * ng + j) + col];
              },
              32 * (mp + 1), 2, yn, g, t4);
          mma_tiles<2, 4>(
              ys,
              [&](int i, int r, int k) {
                return cs[(32 * mp + 16 * i + r) * L.ldc + k];
              },
              [&](int j, int k, int col) {
                return sh[(8 * (4 * ng + j) + col) * L.lds + k];
              },
              n8, 2, yn, g, t4);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int t = 32 * mp + 16 * i + g + 8 * r;
              if (t >= nt) continue;
              const float e = v[2 * T + t];
              Tx* yrow =
                  y + pan * ypanel + ((row0 + t) * H + h0 + hh) * P + p0;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int p = 8 * (4 * ng + j) + 2 * t4;
                if (j < yn && p < np)
                  yrow[p] = from_f<Tx>(yi[i][j][2 * r] + e * ys[i][j][2 * r]);
                if (j < yn && p + 1 < np)
                  yrow[p + 1] = from_f<Tx>(yi[i][j][2 * r + 1] +
                                           e * ys[i][j][2 * r + 1]);
              }
            }
        }
      }
      __syncthreads();   // W and the states are read above, rewritten below
      // ---- the states' updates: a warp's unit is every m-tile x four
      // n-tiles of one head ------------------------------------------------
      if (!last) {
        const int mt = ps16 / 16, nt8 = n8 / 8, per_head = (nt8 + 3) / 4;
        for (int unit = warp; unit < nh * per_head; unit += WARPS) {
          const int hh = unit / per_head, ng = unit % per_head;
          const int un = min(4, nt8 - 4 * ng);
          const float* v = vec + hh * 4 * T;
          const float* xh = xs + hh * T * L.ldx;
          float* sh = st + hh * ps16 * L.lds;
          const float a = v[2 * T + T - 1];
          float acc[4][4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (i < mt && j < un)
                  acc[i][j][e] = a * sh[(16 * i + g + 8 * (e >> 1)) * L.lds +
                                        8 * (4 * ng + j) + 2 * t4 + (e & 1)];
          mma_tiles<4, 4, 1>(
              acc,
              [&](int i, int r, int k) {
                return xh[k * L.ldx + 16 * i + r] * v[3 * T + k];
              },
              [&](int j, int k, int col) {
                const int n = 8 * (4 * ng + j) + col;
                return bs[k * L.ldb + (n ^ bswz(k))];
              },
              T, mt, un, g, t4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (i < mt && j < un)
                  sh[(16 * i + g + 8 * (e >> 1)) * L.lds + 8 * (4 * ng + j) +
                     2 * t4 + (e & 1)] = acc[i][j][e];
        }
      }
    }
  }

  if constexpr (!OUT) {   // the chunk's end state and sum of dt A
    __syncthreads();
    for (int i = tid; i < nh * ps16 * L.lds; i += THREADS) {
      const int hh = i / (ps16 * L.lds), r = i % (ps16 * L.lds);
      const int p = r / L.lds, n = r % L.lds;
      if (p < np && n < nn)
        Z[(((long long)b * nc + c) * H + h0 + hh) * PN +
          (long long)(p0 + p) * N + n0 + n] = st[i];
    }
    if (pan == 0 && tid < nh)
      segsum[((long long)b * nc + c) * H + h0 + tid] = lsum;
  }
}

// Pass (b): Z[b, c, h] (each chunk's own end state) becomes the state the
// chunk starts from, in chunk order, one thread per (b, h, state element);
// each thread keeps U chunks' loads in flight.
__global__ void __launch_bounds__(256)
ssd_state_kernel(float* __restrict__ Z, const float* __restrict__ segsum,
                 int nc, int H, long long PN, long long total) {
  constexpr int U = 8;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / PN, i = e % PN;
  const long long b = bh / H, h = bh % H;
  float cur = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += U) {
    float z[U], d[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long ch = (b * nc + c0 + k) * H + h;
      z[k] = c0 + k < nc ? Z[ch * PN + i] : 0.0f;
      d[k] = c0 + k < nc ? segsum[ch] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (c0 + k < nc) {
        Z[((b * nc + c0 + k) * H + h) * PN + i] = cur;
        cur = expf(d[k]) * cur + z[k];
      }
  }
}

// Pass (d), the panel route's last: y[i] = the sum of part[p][i] over the
// panels p in order, rounded once to y's type; one thread an element.
template <typename Ty>
__global__ void __launch_bounds__(256)
ssd_panel_sum_kernel(const float* __restrict__ part, Ty* __restrict__ y,
                     int panels, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int p = 1; p < panels; ++p) s += part[p * total + i];
  y[i] = from_f<Ty>(s);
}

template <typename Tx, int T, bool OUT>
int launch_chunks(const void* x, const float* dt, const float* A,
                  const float* B, const float* C, float* Z, float* segsum,
                  void* y, int batch, int S, int H, int P, int N, int PS,
                  int hg, int NW, long long ypanel, cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<Tx, T, OUT>;
  const size_t bytes =
      sizeof(float) * (size_t)Layout::of(T, PS, NW, hg, OUT).floats;
  if (bytes > (size_t)SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (long long)batch * ((S + CHUNK - 1) / CHUNK) *
                           ((H + hg - 1) / hg) * ((N + NW - 1) / NW) *
                           ((P + PS - 1) / PS);
  if (blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kern<<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const Tx*>(x), dt, A, B, C, Z, segsum, static_cast<Tx*>(y),
      S, H, P, N, PS, hg, NW, ypanel);
  return static_cast<int>(cudaGetLastError());
}

template <bool OUT>
int launch_typed(const void* x, const float* dt, const float* A,
                 const float* B, const float* C, float* Z, float* segsum,
                 void* y, int batch, int S, int H, int P, int N, int dtype,
                 int T, int PS, int hg, int NW, long long ypanel,
                 cudaStream_t s) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 1 || PS < 1 ||
      PS > MAX_PS || (P + PS - 1) / PS * PS - P >= PS || hg < 1 || hg > 4 ||
      (T != 32 && T != 64) || dtype < 0 || dtype > 2 || NW < 1 || NW > N ||
      (NW < N && (NW % 8 != 0 || dtype != 0 || (OUT && ypanel < 1))))
    return bad;
#define SSD_LAUNCH(TX, TT)                                                   \
  return launch_chunks<TX, TT, OUT>(x, dt, A, B, C, Z, segsum, y, batch, S,  \
                                    H, P, N, PS, hg, NW, ypanel, s)
  if (dtype == 1) {
    if (T == 64) SSD_LAUNCH(__nv_bfloat16, 64);
    SSD_LAUNCH(__nv_bfloat16, 32);
  }
  if (dtype == 2) {
    if (T == 64) SSD_LAUNCH(__half, 64);
    SSD_LAUNCH(__half, 32);
  }
  if (T == 64) SSD_LAUNCH(float, 64);
  SSD_LAUNCH(float, 32);
#undef SSD_LAUNCH
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory one block of the output pass (out 1) or
// of the chunk pass (out 0) takes at tiles of T steps, P-slices of PS,
// state width N and hg heads a block.
extern "C" long long ssd_scan_smem_bytes(int T, int PS, int N, int hg,
                                         int out) {
  return (long long)sizeof(float) * Layout::of(T, PS, N, hg, out != 0).floats;
}

// Pass (a): x (dtype 0 float32, 1 bfloat16, 2 float16), dt, A, B float32;
// Z [batch, ceil(S / 512), H, P, N] and segsum [batch, ceil(S / 512), H]
// float32 written; one head a block, tiles of T (32 or 64) steps, P-slices
// of PS (<= 64, equal but the last), N-panels of NW columns (N: one panel;
// else a multiple of 8, float32 x only).  Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int ssd_chunk_states_launch(const void* x, const float* dt,
                                       const float* A, const float* B,
                                       float* Z, float* segsum, int batch,
                                       int S, int H, int P, int N, int dtype,
                                       int T, int PS, int NW, void* stream) {
  return launch_typed<false>(x, dt, A, B, nullptr, Z, segsum, nullptr, batch,
                             S, H, P, N, dtype, T, PS, 1, NW, 0,
                             static_cast<cudaStream_t>(stream));
}

// Pass (b): in place, each chunk's end state in Z becomes the state the
// chunk starts from; `nc` chunks, state elements PN = P * N a head.
extern "C" int ssd_state_pass_launch(float* Z, const float* segsum, int batch,
                                     int nc, int H, long long PN,
                                     void* stream) {
  if (batch < 1 || nc < 1 || H < 1 || PN < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)batch * H * PN;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  ssd_state_kernel<<<(unsigned)blocks, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(Z, segsum, nc, H,
                                                          PN, total);
  return static_cast<int>(cudaGetLastError());
}

// Pass (c): y [batch, S, H, P] in x's type from the start states in Z (as
// pass (b) leaves it; null: one chunk, from zero), hg (1 to 4) heads a
// block, tiles, P-slices and N-panels as pass (a); with N-panels, each
// panel's share of y at y + p ypanel (ypanel >= batch S H P), float32.
extern "C" int ssd_output_launch(const void* x, const float* dt,
                                 const float* A, const float* B,
                                 const float* C, const float* Z, void* y,
                                 int batch, int S, int H, int P, int N,
                                 int dtype, int T, int PS, int hg, int NW,
                                 long long ypanel, void* stream) {
  return launch_typed<true>(x, dt, A, B, C, const_cast<float*>(Z), nullptr,
                            y, batch, S, H, P, N, dtype, T, PS, hg, NW,
                            ypanel, static_cast<cudaStream_t>(stream));
}

// Pass (d): y (`dtype` 0 float32, 1 bfloat16, 2 float16) [total] = the
// sum of the `panels` float32 [total] slices of `part`, in order.
extern "C" int ssd_panel_sum_launch(const float* part, void* y, int panels,
                                    long long total, int dtype,
                                    void* stream) {
  if (panels < 1 || total < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    ssd_panel_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(y), panels, total);
  else if (dtype == 2)
    ssd_panel_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        part, static_cast<__half*>(y), panels, total);
  else
    ssd_panel_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        part, static_cast<float*>(y), panels, total);
  return static_cast<int>(cudaGetLastError());
}
