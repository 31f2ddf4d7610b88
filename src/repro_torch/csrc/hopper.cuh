// Hopper building blocks shared by the flash-attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): mbarriers,
// TMA and cp.async copies, register hand-over, wgmma with shared-memory
// descriptors of 128-byte-swizzled tiles, the swizzle itself, 16-bit
// packing and stores, and the host's tensor-map encoder.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

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

// Byte offset of element (r, c) in a 2-byte tile of R rows stored as
// 64-column panels of 128-byte rows, 128-byte swizzled: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8), as TMA writes it.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  const int cc = c & 63;
  return (c >> 6) * (R * 128) + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) +
         (cc & 7) * 2;
}

// 2^x on the exponential unit (one MUFU.EX2; exp2f adds a range fix-up of
// three instructions).  2^-1e30 is 0 and 2^0 is 1, as the mask needs.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// Two 16-bit values rounded to T16 (bfloat16 or float16) as one register.
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16*) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half*) {
  const __half2 x = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&x);
}

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

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace
