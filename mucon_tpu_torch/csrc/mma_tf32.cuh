// Tensor-core building blocks with f32 parity ("3xTF32"), and the bf16-operand
// mode beside them, for NVIDIA Hopper (sm_90a; `mma.sync` TF32 / bf16 and
// `cp.async` exist from sm_80 on).
//
// An f32 product on the tensor cores: each operand x is split into
//   hi = tf32(x)        (round to nearest, ties away, to a 10-bit mantissa)
//   lo = tf32(x - hi)   (the next 11 bits; x - hi is exact in f32)
// (the rounding of cvt.rna.tf32.f32, done on the bits with two integer
// operations: `cvt` runs at a quarter of their rate,
// and cost the MS-TCN++ stage 1.2 of 6.2 ms on the H100)
// and a b is accumulated in f32 as lo_a hi_b + hi_a lo_b + hi_a hi_b (small
// terms first; lo_a lo_b, of relative size 2^-22, is dropped).  Three
// `mma.sync.m16n8k8` TF32 products per f32 product: 495 / 3 = 165 TFLOP/s
// against the FMA pipe's 67.  `ops/tf32.py` states the same arithmetic in
// PyTorch.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A [16 x 8], row-major:  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B [ 8 x 8], k x n:      b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C [16 x 8]:             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// Shared-memory tiles are f32, row-major, with padded row strides so that a
// fragment load touches 32 banks: an A tile's stride = 4 (mod 32) floats
// (bank 4g + t), a B (weight) tile's stride = 8 (mod 32) (bank 8t + g).  An
// A operand read transposed from a row-major [K][M] tile (`load_at_split`,
// for A^T B over a long k of rows) takes the B tile's stride (bank 8t + g).
//
// The bf16-operand mode (`kernel_mm_dtype=bfloat16`, `warp_gemm2<..., BF16 =
// true>`): each operand is rounded to bf16 (to nearest, ties to even, by
// `cvt.rn.bf16x2.f32`, as `.to(torch.bfloat16)` rounds) as its fragment
// leaves the same f32 tiles, and a 16-deep k-step is one
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` accumulated in f32:
// the products of two bf16 numbers are exact, the sum is f32.  No split, no
// small terms (`small` is left as it is).  `ops/bf16.py` states the same
// arithmetic in PyTorch.
//
// Fragment layouts of m16n8k16 with bf16 operands (g = lane / 4, t = lane %
// 4; a 32-bit register holds two bf16, the lower k in its low half):
//   A [16 x 16], row-major:  a0 (g, 2t | 2t + 1)      a1 (g + 8, 2t | 2t + 1)
//                            a2 (g, 2t + 8 | 2t + 9)  a3 (g + 8, 2t + 8 | 2t + 9)
//   B [16 x 8],  k x n:      b0 (k = 2t | 2t + 1, n = g)
//                            b1 (k = 2t + 8 | 2t + 9, n = g)
//   C [16 x 8]:              as m16n8k8's (c0 (g, 2t) ... c3 (g + 8, 2t + 1))
// An A fragment takes two neighbouring columns of a row (a B fragment two
// neighbouring rows of a column), so its loads meet 2-way bank conflicts on
// the strides above: the mode is simple first (a bf16 tile in shared memory
// and `wgmma` are later work).
//
// Also here: the `cp.async` wrappers that fill such tiles (16-byte copies,
// zero-filled where the source row does not exist).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tf32 {

__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Build knobs (defaults are what ships; `scripts/probe_mstcnpp_variants.py`
// times the others):
//   MMA_TF32_SPLIT     0: both halves by cvt.rna.tf32.f32; 1: by integer
//                      arithmetic on the bits (add half an ulp of TF32, clear
//                      the 13 dropped bits: the same rounding for finite x);
//                      2: as 1, but lo left unrounded (the tensor core reads
//                      the top 19 bits of an operand: lo is then truncated)
//   MMA_TF32_PRODUCTS  3: the compensated product; 1: hi_a hi_b alone (plain
//                      TF32, for timing only: it does not hold f32 parity)
#ifndef MMA_TF32_SPLIT
#define MMA_TF32_SPLIT 1
#endif
#ifndef MMA_TF32_PRODUCTS
#define MMA_TF32_PRODUCTS 3
#endif

// tf32(x) for finite x (an infinity would become a NaN where cvt.rna keeps
// it; the kernels' operands are finite)
__device__ __forceinline__ uint32_t round_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#if MMA_TF32_SPLIT == 0
  hi = cvt_rna(x);
  lo = cvt_rna(x - __uint_as_float(hi));
#elif MMA_TF32_SPLIT == 1
  hi = round_bits(x);
  lo = round_bits(x - __uint_as_float(hi));
#else
  hi = round_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
#endif
}

// d += a b for one m16n8k8 block of TF32 fragments
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// {lo, hi} rounded to bf16 (nearest, ties to even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b for one m16n8k16 block of bf16 fragments, f32 accumulation
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 A fragment of the 16 x 16 block at (row0, k0) of a row-major f32 tile
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4], const float* A, int lda, int row0,
                                            int k0, int lane) {
  const float* p = A + (row0 + (lane >> 2)) * lda + k0 + 2 * (lane & 3);
  a[0] = pack_bf16(p[0], p[1]);
  a[1] = pack_bf16(p[8 * lda], p[8 * lda + 1]);
  a[2] = pack_bf16(p[8], p[9]);
  a[3] = pack_bf16(p[8 * lda + 8], p[8 * lda + 9]);
}

// bf16 A fragment of the 16 x 16 block at (m0, k0) of A^T, A a row-major f32
// [K][M] tile: element (m, k) = A[k][m]
__device__ __forceinline__ void load_at_bf16(uint32_t (&a)[4], const float* A, int lda, int m0,
                                             int k0, int lane) {
  const float* p = A + (k0 + 2 * (lane & 3)) * lda + m0 + (lane >> 2);
  a[0] = pack_bf16(p[0], p[lda]);
  a[1] = pack_bf16(p[8], p[lda + 8]);
  a[2] = pack_bf16(p[8 * lda], p[9 * lda]);
  a[3] = pack_bf16(p[8 * lda + 8], p[9 * lda + 8]);
}

// bf16 B fragment of the 16 x 8 block at (k0, n0) of a row-major f32 [K][N] tile
__device__ __forceinline__ void load_b_bf16(uint32_t (&b)[2], const float* W, int ldw, int k0,
                                            int n0, int lane) {
  const float* p = W + (k0 + 2 * (lane & 3)) * ldw + n0 + (lane >> 2);
  b[0] = pack_bf16(p[0], p[ldw]);
  b[1] = pack_bf16(p[8 * ldw], p[9 * ldw]);
}

// split A fragment of the 16 x 8 block at (row0, k0) of a row-major tile
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float* A, int lda, int row0, int k0,
                                             int lane) {
  const float* p = A + (row0 + (lane >> 2)) * lda + k0 + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[8 * lda], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * lda + 4], hi[3], lo[3]);
}

// split A fragment of the 16 x 8 block at (m0, k0) of A^T, A a row-major
// [K][M] tile: element (m, k) = A[k][m]
__device__ __forceinline__ void load_at_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float* A, int lda, int m0, int k0,
                                              int lane) {
  const float* p = A + (k0 + (lane & 3)) * lda + m0 + (lane >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[8], hi[1], lo[1]);
  split(p[4 * lda], hi[2], lo[2]);
  split(p[4 * lda + 8], hi[3], lo[3]);
}

// split B fragment of the 8 x 8 block at (k0, n0) of a row-major [K][N] tile
__device__ __forceinline__ void load_b_split(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                             const float* W, int ldw, int k0, int n0,
                                             int lane) {
  const float* p = W + (k0 + (lane & 3)) * ldw + n0 + (lane >> 2);
  split(p[0], hi[0], lo[0]);
  split(p[4 * ldw], hi[1], lo[1]);
}

// acc[mt][nt] += A[a_row0 + 16 mt .., a_col0 .. a_col0 + KC) W[0 .. KC, n0 + 8 nt ..)
// for one warp: MT x NTL blocks of 16 x 8 outputs, KC a multiple of 8 (with
// AT, A^T: rows a_col0 .. of the [K][M] tile A, columns a_row0 + 16 mt ..).  The
// three products of the split run as three passes over all MT x NTL blocks,
// so that two `mma` into one accumulator lie MT x NTL `mma` apart: the two
// small ones into `small`, hi_a hi_b into `big` (the same array in
// `warp_gemm`).  An `mma` rounds its f32 sum toward zero, so each one into
// an accumulator adds an error of up to an ulp of it, of one sign; a caller
// that needs f32 accuracy over a long k keeps the small terms apart and
// adds a short k's `big` into its sum with an f32 add (round to nearest).
// (ptxas interleaves the next k-step's loads and splits with this step's
// `mma` by itself: pipelining them by hand in the source changed nothing.)
// With BF16, every product is one bf16 `mma` a 16-deep k-step into `big`
// (KC a multiple of 16); `small` is not touched.
template <int MT, int NTL, int KC, bool AT = false, bool BF16 = false>
__device__ __forceinline__ void warp_gemm2(float (&small)[MT][NTL][4],
                                           float (&big)[MT][NTL][4], const float* A, int lda,
                                           int a_row0, int a_col0, const float* W, int ldw,
                                           int n0, int lane) {
  if constexpr (BF16) {
    static_assert(KC % 16 == 0, "a bf16 k-step is 16 deep");
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[MT][4], b[NTL][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (AT)
          load_at_bf16(a[mt], A, lda, a_row0 + 16 * mt, a_col0 + kk, lane);
        else
          load_a_bf16(a[mt], A, lda, a_row0 + 16 * mt, a_col0 + kk, lane);
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) load_b_bf16(b[nt], W, ldw, kk, n0 + 8 * nt, lane);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_m16n8k16_bf16(big[mt][nt], a[mt], b[nt]);
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NTL][2], bl[NTL][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (AT)
        load_at_split(ah[mt], al[mt], A, lda, a_row0 + 16 * mt, a_col0 + kk, lane);
      else
        load_a_split(ah[mt], al[mt], A, lda, a_row0 + 16 * mt, a_col0 + kk, lane);
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) load_b_split(bh[nt], bl[nt], W, ldw, kk, n0 + 8 * nt, lane);
#if MMA_TF32_PRODUCTS == 3
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_m16n8k8(small[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_m16n8k8(small[mt][nt], ah[mt], bl[nt]);
#endif
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_m16n8k8(big[mt][nt], ah[mt], bh[nt]);
  }
}

template <int MT, int NTL, int KC, bool AT = false, bool BF16 = false>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NTL][4], const float* A, int lda,
                                          int a_row0, int a_col0, const float* W, int ldw,
                                          int n0, int lane) {
  warp_gemm2<MT, NTL, KC, AT, BF16>(acc, acc, A, lda, a_row0, a_col0, W, ldw, n0, lane);
}

// 16-byte asynchronous copy global -> shared; zeros when !valid (the source
// address must still be a mapped one)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace mma_tf32
