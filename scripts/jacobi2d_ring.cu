// A design of Jacobi-2D's one-sweep kernel timed beside the committed one
// by scripts/jacobi2d_variants.py (--only step); not part of the port.
//
// A ring of rows in shared memory fed by 16-byte cp.async from one loading
// warp, for grids on the vector route (C a multiple of 16 bytes' points,
// both pointers 16-byte aligned).  A CTA takes a strip of 32 V columns (V
// = 16 bytes' points) and RUN = NW x PHASES rows.  The loading warp copies
// the rows, each with V columns a side as far as they lie in the grid, in
// groups of NW rows into SLOTS group slots, each with a "full" mbarrier
// (every lane's copies landed) and a "done" one (every compute warp
// finished the phase that last reads the group).  In phase p compute warp
// w takes the tile's row p NW + w: a lane reads its 16 bytes of the rows
// above, at and below and its two neighbours from shared memory, sums in
// float32 in the plain version's order (-fmad=false) and stores 16 bytes
// with a streaming hint, so it equals the plain version bit for bit.
//
//     C entry: jacobi2d_launch(a, out, r, c, dtype, width, stream), width
//     16 bytes' points only.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                  // compute warps: rows a phase
constexpr int PHASES = 8;              // phases a tile
constexpr int SLOTS = 4;               // row groups in the ring
constexpr int RUN = NW * PHASES;       // rows a tile
constexpr int THREADS = 32 * (NW + 1);

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

// trap after ~2^35 cycles, so a copy that never lands fails the launch
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the mbarrier arrives once every earlier cp.async of this thread landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

template <typename T> __device__ __forceinline__ float widen(uint32_t b);
template <> __device__ __forceinline__ float widen<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float widen<__half>(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}

template <typename T> __device__ __forceinline__ uint32_t narrow(float v);
template <> __device__ __forceinline__ uint32_t narrow<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint32_t narrow<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
template <> __device__ __forceinline__ uint32_t narrow<__half>(float v) {
  return __half_as_ushort(__float2half(v));
}

template <typename T>
__device__ __forceinline__ uint32_t bits(const T* p) {
  if constexpr (sizeof(T) == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const unsigned short*>(p);
}

// element j of a 16-byte chunk's words
template <typename T>
__device__ __forceinline__ uint32_t word_bits(const uint4& u, int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) return w[j];
  else return (w[j / 2] >> (16 * (j & 1))) & 0xffffu;
}

template <typename T>
__device__ __forceinline__ void set_word_bits(uint4& u, int j, uint32_t b) {
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
    w[j] = b;
  } else {
    const int s = 16 * (j & 1);
    w[j / 2] = (w[j / 2] & ~(0xffffu << s)) | (b << s);
  }
  u = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_kernel(const T* __restrict__ a, T* __restrict__ out, int R, int C,
            int nstrips) {
  constexpr int V = 16 / sizeof(T);
  constexpr int W = 32 * V;           // strip columns
  constexpr int PITCH = W + 2 * V;    // a ring row: V columns a side
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);          // [SLOTS][NW][PITCH]
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + SLOTS * NW * PITCH);
  uint64_t* const done = full + SLOTS;
  const int strip = (int)(blockIdx.x % nstrips);
  const int r0 = (int)(blockIdx.x / nstrips) * RUN;
  const int c0 = strip * W;
  const int lo = max(c0 - V, 0), hi = min(c0 + W + V, C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&done[s], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // local row i is grid row r0 - 1 + i; group g holds local rows g NW ..
  // g NW + NW - 1; phase p computes local rows p NW + 1 .. p NW + NW, so it
  // reads groups p and p + 1
  if (warp == NW) {
    const int chunks = (hi - lo) / V;   // 16-byte chunks a row
    for (int g = 0; g <= PHASES; ++g) {
      const int s = g % SLOTS;
      // the slot's last group is read by phases up to g - SLOTS
      if (g >= SLOTS) mbar_wait(&done[s], (g / SLOTS - 1) & 1);
      int first = r0 - 1 + g * NW, last = first + NW - 1;
      last = min(last, min(R - 1, r0 + RUN));   // rows past RUN + 1 unread
      first = max(first, 0);
      for (int k = lane; k < (last - first + 1) * chunks; k += 32) {
        const int row = first + k / chunks, x = lo + k % chunks * V;
        const int j = row - (r0 - 1 + g * NW);
        cp_async16(ring + (s * NW + j) * PITCH + (x - (c0 - V)),
                   a + (long long)row * C + x);
      }
      cp_async_arrive(&full[s]);
    }
    return;
  }
  const int c = c0 + lane * V;          // the lane's first column
  const bool have = c < C;
  for (int p = 0; p < PHASES; ++p) {
    const int i = p * NW + 1 + warp;    // the local row computed
    const int row = r0 - 1 + i;
    // every warp waits and arrives each phase, with a row or without, so
    // no arrival runs ahead into a later phase of the same slot
    mbar_wait(&full[p % SLOTS], (p / SLOTS) & 1);
    mbar_wait(&full[(p + 1) % SLOTS], ((p + 1) / SLOTS) & 1);
    if (have && row < R) {
      auto at = [&](int x) {   // local row x's chunk in the ring
        return ring + ((x / NW) % SLOTS * NW + x % NW) * PITCH + V + lane * V;
      };
      const T* mid = at(i);
      uint4 res = *reinterpret_cast<const uint4*>(mid);
      if (row > 0 && row < R - 1) {
        const uint4 up = *reinterpret_cast<const uint4*>(at(i - 1));
        const uint4 dn = *reinterpret_cast<const uint4*>(at(i + 1));
        const uint4 m = res;
        const uint32_t lft = bits(mid - 1), rgt = bits(mid + V);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if ((j == 0 && c == 0) || (j == V - 1 && c + V == C)) continue;
          const float l = widen<T>(j > 0 ? word_bits<T>(m, j - 1) : lft);
          const float r = widen<T>(j < V - 1 ? word_bits<T>(m, j + 1) : rgt);
          const float sum = (((widen<T>(word_bits<T>(m, j)) + l) + r) +
                             widen<T>(word_bits<T>(up, j))) +
                            widen<T>(word_bits<T>(dn, j));
          set_word_bits<T>(res, j, narrow<T>(sum * 0.2f));
        }
      }
      asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(
                       out + (long long)row * C + c),
                   "r"(res.x), "r"(res.y), "r"(res.z), "r"(res.w)
                   : "memory");
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[p % SLOTS]);
  }
}

template <typename T>
int launch(const void* a, void* out, int r, int c, int width,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (width != V || c % V || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nstrips = (c + 32 * V - 1) / (32 * V);
  const long long ctas = (long long)nstrips * ((r + RUN - 1) / RUN);
  const size_t bytes = (size_t)SLOTS * NW * (32 * V + 2 * V) * sizeof(T) +
                       2 * SLOTS * sizeof(uint64_t);
  ring_kernel<T><<<(unsigned)ctas, THREADS, bytes, st>>>(
      static_cast<const T*>(a), static_cast<T*>(out), r, c, nstrips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jacobi2d_launch(const void* a, void* out, int r, int c,
                               int dtype, int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch<__nv_bfloat16>(a, out, r, c, width, st);
  if (dtype == 2) return launch<__half>(a, out, r, c, width, st);
  return launch<float>(a, out, r, c, width, st);
}
