// 3xTF32 on mma.sync.m16n8k8 (sm_80 and later), shared by the float32
// flash-attention kernels (flash_attention.cu) and the SSD scan
// (ssd_scan.cu).
//
// Each float32 operand x splits into big = tf32(x) and small = tf32(x - big)
// (by masks, see split_tf32), and each product is big*small + small*big +
// big*big with float32 sums, which keeps float32's accuracy (plain TF32
// keeps ~3 digits).
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row major)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8)
// b0 (k t, column g), b1 (k t + 4, column g); the sums c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once

#include <stdint.h>

namespace {

// x ~ big + small, each a TF32 value (the low 13 mantissa bits zero): big
// is x truncated, x - big is exact, and small is that rest truncated, so
// the split loses under 2^-20 |x|.  Masks, not cvt.rna.tf32.f32: that
// conversion costs four instructions a value, and the split runs for every
// fragment element.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment split once into its big and small halves.
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA s;
  split_tf32(a0, s.big[0], s.small[0]);
  split_tf32(a1, s.big[1], s.small[1]);
  split_tf32(a2, s.big[2], s.small[2]);
  split_tf32(a3, s.big[3], s.small[3]);
  return s;
}

// d[4 nt ..] += a * b(nt) in 3xTF32 for the n-tiles nt < n (of NT), B
// fragment (b0[nt], b1[nt]): the two cross terms first, then big * big.
// Each pass runs over all the tiles, so the three products into one
// accumulator sit n instructions apart (an HMMA's latency is ~30 cycles).
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float* d, const SplitA& a,
                                           const float* b0, const float* b1,
                                           int n) {
  uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    split_tf32(b0[nt], bb[nt][0], bs[nt][0]);
    split_tf32(b1[nt], bb[nt][1], bs[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(&d[4 * nt], a.small, bb[nt][0], bb[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(&d[4 * nt], a.big, bs[nt][0], bs[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(&d[4 * nt], a.big, bb[nt][0], bb[nt][1]);
}

// acc[i][j] += A(m-tile i) B(n-tile j) over k in [0, K) (K a multiple of
// 8), for the m-tiles i < m (of MT) and n-tiles j < n (of NT) a warp owns,
// in 3xTF32.  a(i, r, k) is A's element at row r (0..15) of m-tile i and
// column k; b(j, k, c) is B's at row k and column c (0..7) of n-tile j.
// Each A fragment's split serves NT products and each B fragment's MT.
// m and n must be the same over the warp.  U k-steps a loop iteration (1
// or 2): two let a k-step's loads overlap the products of the one before,
// for the registers they hold.
template <int MT, int NT, int U = 2, typename FA, typename FB>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4], FA a,
                                          FB b, int K, int m, int n, int g,
                                          int t) {
  auto step = [&](int k0) {
    SplitA sa[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < m)
        sa[i] = split_a(a(i, g, k0 + t), a(i, g + 8, k0 + t),
                        a(i, g, k0 + t + 4), a(i, g + 8, k0 + t + 4));
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < n) {
        split_tf32(b(j, k0 + t, g), bb[j][0], bs[j][0]);
        split_tf32(b(j, k0 + t + 4, g), bb[j][1], bs[j][1]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (i < m && j < n) mma_tf32(acc[i][j], sa[i].small, bb[j][0], bb[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (i < m && j < n) mma_tf32(acc[i][j], sa[i].big, bs[j][0], bs[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (i < m && j < n) mma_tf32(acc[i][j], sa[i].big, bb[j][0], bb[j][1]);
  };
  int k0 = 0;
  if constexpr (U == 2) {
#pragma unroll 1
    for (; k0 + 8 < K; k0 += 16) {
      step(k0);
      step(k0 + 8);
    }
  }
#pragma unroll 1
  for (; k0 < K; k0 += 8) step(k0);
}

}  // namespace
