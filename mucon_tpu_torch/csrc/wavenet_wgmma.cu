// The eval stacks above C = 512 channels on Hopper's own tensor-core path
// (sm_90a): the WaveNet eval stack's layer and out-projection and the
// MS-TCN++ stage's layer and projection, each in 3xTF32 and in the
// bf16-operand mode.  C is a runtime argument, a multiple of the 128-column
// slab (the wrappers zero-pad another C to it, `cuda.stack_width`).
//
// Replaces, above C = 512, the TPU kernels `wavenet_stack_pallas_v2`
// (mucon_tpu/ops/wavenet_pallas_v2.py:151) and `mstcnpp_stack_pallas`
// (mucon_tpu/ops/mstcnpp_pallas.py:151).  The trainable stack's wide rows
// keep `wide_gemm` (wavenet_wide.cu): the v2 sweep recomputes a pooled
// layer's u with that body's pass 2 and must repeat the forward's bits.
//
// A layer is two GEMM-shaped passes, as in wavenet_wide.cu:
//
//   WaveNet   pass 1  h = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)
//             pass 2  y = mask(h W1 + b1 + x), or its pool
//             proj    z = mask(nonlin(x) Wl + bl)
//   MS-TCN++  pass 1  [conv_d1(f) W3a + b3a, conv_d2(f) W3b + b3b]  ([rows x 2C])
//             pass 2  y = mask(relu(ybuf [W1t; W1b] + b1) + f), or its max pool
//             proj    z = mask(f Wl + bl)
//
// Bound: the tensor cores.  A layer is 8 C^2 f32 operations a valid row
// (MS-TCN++ 16 C^2), three TF32 products each in 3xTF32 (495 / 3 TFLOP/s on
// the H100) or one bf16 product (989); the activations cross device memory
// a few times a layer (x, h, y: 12 C bytes a row and more), small beside
// the products at these widths.  What held the `mma.sync` body back was its
// feed: 256 threads filling a 2-deep `cp.async` ring with their own address
// arithmetic, two barriers a 32-deep chunk, both operands split in registers
// at every k-step.
//
// Design.
// * Warp specialised, one persistent CTA an SM (384 threads): warpgroup 0
//   produces (one thread issues TMA tile loads into a ring of STAGES
//   stages, each tracked by a full and an empty `mbarrier`; its other warps
//   write the zeros of the rows past each video's live tiles), warpgroups 1
//   and 2 consume (`setmaxnreg` moves registers from the producer to them).
//   No `__syncthreads()` in the k-loop.
// * An item is (a pair of live 64-row tiles, a 128-column slab): each
//   consumer warpgroup owns one tile of the pair (rows of one video; the two
//   may be different videos), both read the same weight slab.  The live
//   tiles of every video are listed in order (a tile whose first row is at
//   or past min(T, length) is left out, so short videos after the pools
//   pair up instead of computing zeros) and items run pair-major, so that the
//   CTAs of a wave share their activation tiles in L2 and every slab's
//   weights stay there (the hi and lo planes at C = 768 are 14 MB a layer).
// * Products are `wgmma.mma_async` m64n128: B (the weights) from shared
//   memory through a descriptor of the 128B-swizzled tile TMA wrote; A (the
//   activations) from registers, read from the swizzled f32 tile (the
//   swizzle makes the fragment loads conflict-free) with the rows outside
//   [0, min(T, length)) zeroed, nonlin applied for the WaveNet
//   out-projection, and, in 3xTF32, split into TF32 hi and lo (`split`,
//   cvt.rna's rounding) once a chunk for all 128 columns.  `wgmma` takes
//   TF32 operands K-major only, so the weights come as [N x K] planes: the
//   wrapper transposes and splits them once a call (`ops/tf32.py
//   tf32_split`; bf16: one plane rounded by `.to(torch.bfloat16)`).
// * The sums keep the `mma.sync` bodies' order: each 32-deep k-chunk's
//   hi x hi products are a fresh partial (the chunk's first `wgmma` with
//   scale-d = 0), added to the sum in f32; the small products (lo x hi, then
//   hi x lo, a k-step at a time) are a sum of their own, added last.  The
//   bf16 mode: one partial a chunk, no small sum.
// * Registers: a consumer thread holds the sum, the small sum and the
//   partial (64 floats each at 64 x 128) and one k-step pair's A fragments;
//   a chunk's `wgmma`s are issued in two groups of two k-steps, each waited
//   for before its A registers are reused.  The other warpgroup's group
//   keeps the tensor cores busy meanwhile.
// * A tap no row of either tile reaches (|d| past the tile within [0, lim))
//   is not loaded; a tap one tile does not reach is not multiplied there.
// * The epilogues are the narrow kernels': a warp's share of an m64n128
//   accumulator has the m16n8 fragment layout, rows 2k and 2k + 1 in lanes
//   l and l ^ 4 (`for_each_pair`, `store_pooled`, max keeping the first of a
//   tie).
//
// Shared memory: STAGES x (two 8 KiB A tiles + the weight chunk: 32 KiB of
// hi and lo planes, 8 KiB bf16) = 192 KiB in both modes (4 stages, 8 in
// bf16), the barriers, and the live tiles' prefix over the videos (4 bytes
// a video).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavenet_layer.cuh"

namespace {

constexpr int GM = 64;           // rows a consumer warpgroup's tile
constexpr int GN = 128;          // output columns a slab
constexpr int GK = 32;           // k a chunk (one 128-byte row of f32)
constexpr int G_THREADS = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int A_BYTES = GM * GK * 4;   // an A tile's chunk, 8 KiB
constexpr int BT_BYTES = GN * GK * 4;  // a TF32 plane's chunk, 16 KiB
constexpr int BB_BYTES = GN * GK * 2;  // the bf16 plane's chunk, 8 KiB
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int G_MAX_SMEM = 232448;     // the H100's opt-in limit a block
static_assert(PRODUCER_REGS * 128 + 2 * CONSUMER_REGS * 128 <= 65536, "registers an SM");

template <bool BF>
struct Ring {
  static constexpr int STAGES = BF ? 8 : 4;
  static constexpr int B_BYTES = BF ? BB_BYTES : 2 * BT_BYTES;
  static constexpr int STAGE = 2 * A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int BYTES = STAGES * STAGE;
};

enum Kind { K_CONV, K_RES, K_PROJ, K_MS_CONV, K_MS_RES };

// taps a kind's item may have: the dilated conv's three, the MS-TCN++
// 1x1's two k-halves ([W1t; W1b] read as two blocks), else one
template <int KIND>
__host__ __device__ constexpr int max_taps() {
  return (KIND == K_CONV || KIND == K_MS_CONV) ? 3 : (KIND == K_MS_RES ? 2 : 1);
}

struct GArgs {
  const int* lengths;
  const float* x;      // the residual (K_RES: the layer input; K_MS_RES: f)
  float* out;          // h, y, z or the MS-TCN++ [rows x 2C] buffer
  const float* bias;   // b3, b1, bl (K_MS_CONV: b3a)
  const float* bias2;  // K_MS_CONV: b3b
  int B, T, C, slabs;  // slabs: output columns / GN
  int d, d2;           // dilations (K_MS_CONV: d1, d2)
  int blk, nblk;       // the pass's first weight block; blocks a plane
  int shift, pool, pool_mean, leaky, a_nonlin;
};

using Acc = float[1][16][4];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait for the phase of parity `parity` to complete; trap rather than hang
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 24)) __trap();
  }
}

// one box of a 2D tensor map (c0: the contiguous coordinate) into shared memory
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a wgmma descriptor of a K-major tile in shared memory: 8-row groups SBO
// bytes apart, swizzle mode `mode` (1: 128B, 2: 64B)
__device__ __forceinline__ uint64_t desc_of(uint32_t addr, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// an asynchronous `wgmma`
__device__ __forceinline__ void reg_fence(Acc& d) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[0][j][e])::"memory");
}

__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// d (+)= a b: m64n128, A from registers, B a K-major descriptor; scale_d = 0
// starts d afresh
__device__ __forceinline__ void wgmma_tf32(Acc& d, const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3]),
        "+f"(d[0][10][0]), "+f"(d[0][10][1]), "+f"(d[0][10][2]), "+f"(d[0][10][3]),
        "+f"(d[0][11][0]), "+f"(d[0][11][1]), "+f"(d[0][11][2]), "+f"(d[0][11][3]),
        "+f"(d[0][12][0]), "+f"(d[0][12][1]), "+f"(d[0][12][2]), "+f"(d[0][12][3]),
        "+f"(d[0][13][0]), "+f"(d[0][13][1]), "+f"(d[0][13][2]), "+f"(d[0][13][3]),
        "+f"(d[0][14][0]), "+f"(d[0][14][1]), "+f"(d[0][14][2]), "+f"(d[0][14][3]),
        "+f"(d[0][15][0]), "+f"(d[0][15][1]), "+f"(d[0][15][2]), "+f"(d[0][15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

__device__ __forceinline__ void wgmma_bf16(Acc& d, const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3]),
        "+f"(d[0][10][0]), "+f"(d[0][10][1]), "+f"(d[0][10][2]), "+f"(d[0][10][3]),
        "+f"(d[0][11][0]), "+f"(d[0][11][1]), "+f"(d[0][11][2]), "+f"(d[0][11][3]),
        "+f"(d[0][12][0]), "+f"(d[0][12][1]), "+f"(d[0][12][2]), "+f"(d[0][12][3]),
        "+f"(d[0][13][0]), "+f"(d[0][13][1]), "+f"(d[0][13][2]), "+f"(d[0][13][3]),
        "+f"(d[0][14][0]), "+f"(d[0][14][1]), "+f"(d[0][14][2]), "+f"(d[0][14][3]),
        "+f"(d[0][15][0]), "+f"(d[0][15][1]), "+f"(d[0][15][2]), "+f"(d[0][15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// f32 element (r, k) of a 64 x 32 tile in the 128B-swizzled layout TMA
// writes (16-byte chunk k / 4 of row r stored at chunk (k / 4) ^ (r % 8))
__device__ __forceinline__ int swz(int r, int k) {
  return r * GK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// the TF32 A fragment of k-step ks (8 deep) of this warp's 16 rows r0, r0 + 8
// (rows outside [0, lim) zero: ok0, ok1), nonlin applied if act, split
__device__ __forceinline__ void a_split(const float* A, int ks, int r0, int tq, bool ok0, bool ok1,
                                        bool act, int leaky, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int k = 8 * ks + tq;
  float v[4] = {ok0 ? A[swz(r0, k)] : 0.f, ok1 ? A[swz(r0 + 8, k)] : 0.f,
                ok0 ? A[swz(r0, k + 4)] : 0.f, ok1 ? A[swz(r0 + 8, k + 4)] : 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) split(act ? nonlin(v[e], leaky) : v[e], hi[e], lo[e]);
}

// the bf16 A fragment of k-step ks (16 deep): two neighbouring k a register
__device__ __forceinline__ void a_bf16(const float* A, int ks, int r0, int tq, bool ok0, bool ok1,
                                       bool act, int leaky, uint32_t (&a)[4]) {
  const int k = 16 * ks + 2 * tq;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + 8 * (e & 1), kk = k + 8 * (e >> 1);
    const bool ok = (e & 1) ? ok1 : ok0;
    float2 v = ok ? *reinterpret_cast<const float2*>(A + swz(r, kk)) : make_float2(0.f, 0.f);
    if (act) v = make_float2(nonlin(v.x, leaky), nonlin(v.y, leaky));
    a[e] = pack_bf16(v.x, v.y);
  }
}

// one 32-deep chunk into the sums (see the top): 3xTF32
__device__ __forceinline__ void chunk_tf32(Acc& acc, Acc& small, Acc& p, const float* A,
                                           uint64_t dhi, uint64_t dlo, int r0, int tq, bool ok0,
                                           bool ok1, bool act, int leaky) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      a_split(A, 2 * half + kk, r0, tq, ok0, ok1, act, leaky, ah[kk], al[kk]);
    reg_fence(small);
    reg_fence(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * half + kk;  // 32 bytes of K a k-step: 2 in the descriptor's units
      wgmma_tf32(small, al[kk], dhi + 2 * ks, 1);
      wgmma_tf32(small, ah[kk], dlo + 2 * ks, 1);
      wgmma_tf32(p, ah[kk], dhi + 2 * ks, ks > 0);
    }
    wg_commit();
    wg_wait0();
    reg_fence(small);
    reg_fence(p);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      reg_fence(ah[kk]);
      reg_fence(al[kk]);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += p[0][j][e];
}

// one 32-deep chunk, bf16 operands: one partial, two k-steps of 16
__device__ __forceinline__ void chunk_bf16(Acc& acc, Acc& p, const float* A, uint64_t db, int r0,
                                           int tq, bool ok0, bool ok1, bool act, int leaky) {
  uint32_t a[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) a_bf16(A, ks, r0, tq, ok0, ok1, act, leaky, a[ks]);
  reg_fence(p);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) wgmma_bf16(p, a[ks], db + 2 * ks, ks > 0);
  wg_commit();
  wg_wait0();
  reg_fence(p);
  reg_fence(a[0]);
  reg_fence(a[1]);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += p[0][j][e];
}

// a row tile: video b's rows t0 .. t0 + 63, its length and min(T, length)
struct GTile {
  int b, t0, lim, len;
  bool has;
};

// an item: its two tiles, its slab's first output column, the dilation and
// first weight block and row its slab reads
struct GItem {
  GTile t[2];
  int n0, dd, blk, nrow;
};

template <int KIND>
__device__ __forceinline__ void decode(const GArgs& a, const int* pre, int item, GItem& it) {
  const int pair = item / a.slabs, slab = item - pair * a.slabs;
  const int total = pre[a.B];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int tile = 2 * pair + w;
    int lo = 0, hi = a.B - 1;  // the last video with pre[b] <= tile: the one that holds it
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= tile) lo = mid;
      else hi = mid - 1;
    }
    GTile& tl = it.t[w];
    tl.has = tile < total;
    tl.b = lo;
    tl.t0 = tl.has ? (tile - pre[lo]) * GM : 0;
    tl.len = __ldg(a.lengths + lo) >> a.shift;
    tl.lim = min(a.T, tl.len);
  }
  it.n0 = slab * GN;
  it.dd = a.d;
  it.blk = a.blk;
  it.nrow = it.n0;
  if (KIND == K_MS_CONV && it.n0 >= a.C) {  // the d2 conv: W3b's blocks
    it.dd = a.d2;
    it.blk = a.blk + 3;
    it.nrow = it.n0 - a.C;
  }
  if (KIND == K_MS_RES) it.blk = a.blk + 6;  // [W1t; W1b]
}

template <int KIND>
__device__ __forceinline__ int tap_off(const GItem& it, int j) {
  return (KIND == K_CONV || KIND == K_MS_CONV) ? (j - 1) * it.dd : 0;
}

// tap j reaches a row of the tile within [0, lim)
template <int KIND>
__device__ __forceinline__ bool tap_live(const GItem& it, int j, const GTile& tl) {
  const int off = tap_off<KIND>(it, j);
  return tl.has && tl.t0 + GM + off > 0 && tl.t0 + off < tl.lim;
}

// ---------------------------------------------------------------------------
// the epilogues: a consumer warpgroup's 64 x 128 outputs, from the registers
// ---------------------------------------------------------------------------

template <int KIND>
__device__ __forceinline__ void epilogue(const GArgs& a, Acc& acc, const GItem& it,
                                         const GTile& tl, int row0, int lane) {
  const int T = a.T, C = a.C, b = tl.b, t0 = tl.t0, lim = tl.lim, len = tl.len;
  const int n0 = it.n0;
  if constexpr (KIND == K_CONV) {
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      if (t < lim)
        st2(a.out + ((size_t)b * T + t) * C + n0 + col,
            nonlin(v0 + __ldg(a.bias + n0 + col), a.leaky),
            nonlin(v1 + __ldg(a.bias + n0 + col + 1), a.leaky));
    });
  } else if constexpr (KIND == K_MS_CONV) {
    const float* bias = n0 >= C ? a.bias2 : a.bias;
    const int nc = it.nrow;
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      if (t < lim)
        st2(a.out + ((size_t)b * T + t) * 2 * C + n0 + col, v0 + __ldg(bias + nc + col),
            v1 + __ldg(bias + nc + col + 1));
    });
  } else if constexpr (KIND == K_PROJ) {
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      if (t < T)
        st2(a.out + ((size_t)b * T + t) * C + n0 + col,
            t < len ? v0 + __ldg(a.bias + n0 + col) : 0.f,
            t < len ? v1 + __ldg(a.bias + n0 + col + 1) : 0.f);
    });
  } else {  // K_RES, K_MS_RES: bias, residual, mask, then the rows or their pool
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      if (KIND == K_RES ? t >= lim : t >= len) {
        v0 = v1 = 0.f;
        return;
      }
      const float2 xv = t < lim ? ld2(a.x + ((size_t)b * T + t) * C + n0 + col)
                                : make_float2(0.f, 0.f);
      const float c0 = v0 + __ldg(a.bias + n0 + col), c1 = v1 + __ldg(a.bias + n0 + col + 1);
      v0 = (KIND == K_RES ? c0 : fmaxf(c0, 0.f)) + xv.x;
      v1 = (KIND == K_RES ? c1 : fmaxf(c1, 0.f)) + xv.y;
    });
    if (!a.pool) {
      for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
        if (t0 + row < T) st2(a.out + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
      });
    } else {
      store_pooled<0>(a.out, acc, b, t0, T, len, row0, n0, lane,
                      KIND == K_RES ? a.pool_mean : 0, C);
    }
  }
}

// ---------------------------------------------------------------------------
// the pass kernel
// ---------------------------------------------------------------------------

template <bool BF, int KIND>
__global__ void __launch_bounds__(G_THREADS, 1)
    wg_pass_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, const GArgs a) {
  using R = Ring<BF>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + R::BYTES, empty0 = full0 + 8 * R::STAGES;
  int* pre = reinterpret_cast<int*>(smem + R::BYTES + 16 * R::STAGES);  // [B + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (warp == 0) {  // live tiles a video, prefix-summed: pre[b] tiles before video b
    int carry = 0;
    for (int b0 = 0; b0 < a.B; b0 += 32) {
      const int b = b0 + lane;
      int n = 0;
      if (b < a.B) n = (min(a.T, __ldg(a.lengths + b) >> a.shift) + GM - 1) / GM;
      n = max(n, 0);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, n, o);
        if (lane >= o) n += y;
      }
      if (b < a.B) pre[b + 1] = carry + n;
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
    if (lane == 0) {
      pre[0] = 0;
      for (int s = 0; s < R::STAGES; ++s) {
        bar_init(full0 + 8 * s, 1);
        bar_init(empty0 + 8 * s, 8);  // a lane of each consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  const int n_items = ((pre[a.B] + 1) / 2) * a.slabs;
  const int kpt = a.C / GK;  // chunks a tap

  if (warp < 4) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t q = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        GItem it;
        decode<KIND>(a, pre, item, it);
#pragma unroll
        for (int j = 0; j < max_taps<KIND>(); ++j) {
          if (!tap_live<KIND>(it, j, it.t[0]) && !tap_live<KIND>(it, j, it.t[1])) continue;
          const int off = tap_off<KIND>(it, j);
          const int acol = KIND == K_MS_RES ? j * a.C : 0;
          const int r0 = it.t[0].b * a.T + it.t[0].t0 + off;
          const int r1 = it.t[1].has ? it.t[1].b * a.T + it.t[1].t0 + off : r0;
          const int wr = (it.blk + j) * a.C + it.nrow;  // the slab's first row in plane 0
          for (int kc = 0; kc < kpt; ++kc, ++q) {
            const int s = q % R::STAGES;
            const uint32_t stage = base + s * R::STAGE, full = full0 + 8 * s;
            bar_wait(empty0 + 8 * s, ((q / R::STAGES) & 1) ^ 1);
            bar_expect(full, R::STAGE);
            tma_2d(stage, &amap, full, acol + kc * GK, r0);
            tma_2d(stage + A_BYTES, &amap, full, acol + kc * GK, r1);
            tma_2d(stage + 2 * A_BYTES, &wmap, full, kc * GK, wr);
            if (!BF)
              tma_2d(stage + 2 * A_BYTES + BT_BYTES, &wmap, full, kc * GK, wr + a.nblk * a.C);
          }
        }
      }
    } else if (warp > 0 && (KIND == K_RES || KIND == K_PROJ || KIND == K_MS_RES)) {
      // zeros for each video's rows past its live tiles
      const bool pooled = KIND != K_PROJ && a.pool;
      const int Tout = pooled ? a.T / 2 : a.T, per = pooled ? GM / 2 : GM, c4 = a.C / 4;
      for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
        const int first = min(Tout, (pre[b + 1] - pre[b]) * per);
        float4* y = reinterpret_cast<float4*>(a.out + ((size_t)b * Tout + first) * a.C);
        const long n = (long)(Tout - first) * c4;
        for (long i = threadIdx.x - 32; i < n; i += 96) y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int w = warp / 4 - 1, wi = warp & 3, g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * wi + g;  // this thread's first row of the tile (and r0 + 8)
  const bool act = KIND == K_PROJ && a.a_nonlin;
  uint32_t q = 0;
  Acc acc, small, p;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[0][j][e] = 0.f;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    GItem it;
    decode<KIND>(a, pre, item, it);
    const GTile me = w ? it.t[1] : it.t[0], other = w ? it.t[0] : it.t[1];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = small[0][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < max_taps<KIND>(); ++j) {
      const bool mine = tap_live<KIND>(it, j, me);
      if (!mine && !tap_live<KIND>(it, j, other)) continue;
      const int t = me.t0 + tap_off<KIND>(it, j) + r0;
      const bool ok0 = mine && t >= 0 && t < me.lim;
      const bool ok1 = mine && t + 8 >= 0 && t + 8 < me.lim;
      for (int kc = 0; kc < kpt; ++kc, ++q) {
        const int s = q % R::STAGES;
        const uint32_t stage = base + s * R::STAGE;
        bar_wait(full0 + 8 * s, (q / R::STAGES) & 1);
        if (mine) {
          const float* A = reinterpret_cast<const float*>(smem + s * R::STAGE + w * A_BYTES);
          if constexpr (BF) {
            chunk_bf16(acc, p, A, desc_of(stage + 2 * A_BYTES, 512, 2), r0, tq, ok0, ok1, act,
                       a.leaky);
          } else {
            chunk_tf32(acc, small, p, A, desc_of(stage + 2 * A_BYTES, 1024, 1),
                       desc_of(stage + 2 * A_BYTES + BT_BYTES, 1024, 1), r0, tq, ok0, ok1, act,
                       a.leaky);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(empty0 + 8 * s);
      }
    }
    if (!me.has) continue;
    if (!BF) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] += small[0][j][e];
    }
    epilogue<KIND>(a, acc, it, me, 16 * wi, lane);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &got);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows x cols] tensor in boxes of box_rows x 32 elements
cudaError_t tensor_map(CUtensorMap* m, const void* ptr, bool bf16, long rows, int cols,
                       int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)GK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m,
                         bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         2, const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool BF>
int pass_smem(int B) {
  return Ring<BF>::BYTES + 1024 + 16 * Ring<BF>::STAGES + 4 * (B + 1);
}

template <bool BF, int KIND>
cudaError_t pass_launch(const CUtensorMap& amap, const CUtensorMap& wmap, const GArgs& a,
                        cudaStream_t stream) {
  const int smem = pass_smem<BF>(a.B);
  if (smem > G_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wg_pass_kernel<BF, KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  wg_pass_kernel<BF, KIND><<<sms, G_THREADS, smem, stream>>>(amap, wmap, a);
  return cudaGetLastError();
}

// the weight planes' map: [P x nblk x C x C] (P = 2 TF32 planes, 1 bf16), rows of C k
template <bool BF>
cudaError_t weight_map(CUtensorMap* m, const void* wt, int nblk, int C) {
  return tensor_map(m, wt, BF, (long)(BF ? 1 : 2) * nblk * C, C, GN);
}

template <bool BF>
cudaError_t layer_launch(const float* x, float* y, float* h, const int* lengths, const void* wt,
                         int nblk, int blk, const float* b3, const float* b1, int B, int T, int C,
                         int d, int len_shift, int pool, int pool_mean, int leaky,
                         cudaStream_t stream) {
  CUtensorMap wmap, xmap, hmap;
  cudaError_t err = weight_map<BF>(&wmap, wt, nblk, C);
  if (err == cudaSuccess) err = tensor_map(&xmap, x, false, (long)B * T, C, GM);
  if (err == cudaSuccess) err = tensor_map(&hmap, h, false, (long)B * T, C, GM);
  if (err != cudaSuccess) return err;
  GArgs a{lengths, nullptr, h, b3, nullptr, B, T, C, C / GN, d, 0, blk, nblk, len_shift, 0, 0,
          leaky, 0};
  err = pass_launch<BF, K_CONV>(xmap, wmap, a, stream);
  if (err != cudaSuccess) return err;
  a = GArgs{lengths, x, y, b1, nullptr, B, T, C, C / GN, 0, 0, blk + 3, nblk, len_shift, pool,
            pool_mean, leaky, 0};
  return pass_launch<BF, K_RES>(hmap, wmap, a, stream);
}

template <bool BF>
cudaError_t proj_launch(const float* x, float* z, const int* lengths, const void* wt, int nblk,
                        int blk, const float* bl, int B, int T, int C, int len_shift,
                        int a_nonlin, int leaky, cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  cudaError_t err = weight_map<BF>(&wmap, wt, nblk, C);
  if (err == cudaSuccess) err = tensor_map(&xmap, x, false, (long)B * T, C, GM);
  if (err != cudaSuccess) return err;
  const GArgs a{lengths, nullptr, z, bl, nullptr, B, T, C, C / GN, 0, 0, blk, nblk, len_shift,
                0, 0, leaky, a_nonlin};
  return pass_launch<BF, K_PROJ>(xmap, wmap, a, stream);
}

template <bool BF>
cudaError_t ms_layer_launch(const float* f, float* y, float* ybuf, const int* lengths,
                            const void* wt, int nblk, int blk, const float* b3a, const float* b3b,
                            const float* b1, int B, int T, int C, int d1, int d2, int len_shift,
                            int pool, cudaStream_t stream) {
  CUtensorMap wmap, fmap, ymap;
  cudaError_t err = weight_map<BF>(&wmap, wt, nblk, C);
  if (err == cudaSuccess) err = tensor_map(&fmap, f, false, (long)B * T, C, GM);
  if (err == cudaSuccess) err = tensor_map(&ymap, ybuf, false, (long)B * T, 2 * C, GM);
  if (err != cudaSuccess) return err;
  GArgs a{lengths, nullptr, ybuf, b3a, b3b, B, T, C, 2 * C / GN, d1, d2, blk, nblk, len_shift,
          0, 0, 0, 0};
  err = pass_launch<BF, K_MS_CONV>(fmap, wmap, a, stream);
  if (err != cudaSuccess) return err;
  a = GArgs{lengths, f, y, b1, nullptr, B, T, C, C / GN, 0, 0, blk, nblk, len_shift, pool, 0, 0,
            0};
  return pass_launch<BF, K_MS_RES>(ymap, wmap, a, stream);
}

bool bad_args(int B, int T, int C, int nblk, int blk, int need) {
  return B <= 0 || T <= 0 || C <= 512 || C % GN || blk < 0 || blk + need > nblk;
}

template <bool BF, int KIND>
void attrs_of(cudaFuncAttributes* at, cudaError_t* err) {
  if (*err == cudaSuccess) *err = cudaFuncGetAttributes(at, wg_pass_kernel<BF, KIND>);
}

}  // namespace

// One WaveNet eval layer at C > 512 channels (a multiple of 128): pass 1
// into h (nonlin(z) at rows t < len), then pass 2 into y.  wt holds the
// stack's weights as [N x K] blocks, `nblk` a plane (2 TF32 planes, hi and
// lo; bf16: one plane): blocks blk .. blk + 2 the conv's taps, blk + 3 W1.
extern "C" int mucon_wgmma_layer(const float* x, float* y, float* h, const int* lengths,
                                 const void* wt, int nblk, int blk, const float* b3,
                                 const float* b1, int B, int T, int channels, int d,
                                 int len_shift, int pool, int pool_mean, int leaky, int bf16,
                                 cudaStream_t stream) {
  if (bad_args(B, T, channels, nblk, blk, 4) || (pool && T % 2) || !h)
    return cudaErrorInvalidValue;
  return bf16 ? layer_launch<true>(x, y, h, lengths, wt, nblk, blk, b3, b1, B, T, channels, d,
                                   len_shift, pool, pool_mean, leaky, stream)
              : layer_launch<false>(x, y, h, lengths, wt, nblk, blk, b3, b1, B, T, channels, d,
                                    len_shift, pool, pool_mean, leaky, stream);
}

// The out-projection z = mask(act(x) Wl + bl) at C > 512, Wl block blk of
// wt: a_nonlin = 1 takes nonlin(x) (WaveNet, `leaky`), 0 x itself (MS-TCN++).
extern "C" int mucon_wgmma_proj(const float* x, float* z, const int* lengths, const void* wt,
                                int nblk, int blk, const float* bl, int B, int T, int channels,
                                int len_shift, int a_nonlin, int leaky, int bf16,
                                cudaStream_t stream) {
  if (bad_args(B, T, channels, nblk, blk, 1)) return cudaErrorInvalidValue;
  return bf16 ? proj_launch<true>(x, z, lengths, wt, nblk, blk, bl, B, T, channels, len_shift,
                                  a_nonlin, leaky, stream)
              : proj_launch<false>(x, z, lengths, wt, nblk, blk, bl, B, T, channels, len_shift,
                                   a_nonlin, leaky, stream);
}

// One MS-TCN++ layer (d1, d2) at C > 512: blocks blk .. blk + 7 of wt are
// W3a's three taps, W3b's, W1t and W1b; ybuf [B, T, 2C] scratch between the passes.
extern "C" int mucon_wgmma_mstcnpp_layer(const float* f, float* y, float* ybuf,
                                         const int* lengths, const void* wt, int nblk, int blk,
                                         const float* b3a, const float* b3b, const float* b1,
                                         int B, int T, int channels, int d1, int d2,
                                         int len_shift, int pool, int bf16, cudaStream_t stream) {
  if (bad_args(B, T, channels, nblk, blk, 8) || (pool && T % 2) || !ybuf)
    return cudaErrorInvalidValue;
  return bf16 ? ms_layer_launch<true>(f, y, ybuf, lengths, wt, nblk, blk, b3a, b3b, b1, B, T,
                                      channels, d1, d2, len_shift, pool, stream)
              : ms_layer_launch<false>(f, y, ybuf, lengths, wt, nblk, blk, b3a, b3b, b1, B, T,
                                       channels, d1, d2, len_shift, pool, stream);
}

// The most videos a pass takes in the mode bf16 (its prefix of live tiles
// lives in shared memory beside the ring)
extern "C" int mucon_wgmma_max_videos(int bf16) {
  return (G_MAX_SMEM - (bf16 ? pass_smem<true>(0) : pass_smem<false>(0))) / 4;
}

// The pass kernels of the mode bf16, in the order conv, res, proj, MS-TCN++
// conv, MS-TCN++ res: out[5 k ..] = {registers a thread, local (spill)
// bytes a thread, dynamic shared memory at B = 128, threads, CTAs an SM}
extern "C" int mucon_wgmma_attrs(int bf16, int* out) {
  cudaFuncAttributes at[5];
  cudaError_t err = cudaSuccess;
  if (bf16) {
    attrs_of<true, K_CONV>(&at[0], &err);
    attrs_of<true, K_RES>(&at[1], &err);
    attrs_of<true, K_PROJ>(&at[2], &err);
    attrs_of<true, K_MS_CONV>(&at[3], &err);
    attrs_of<true, K_MS_RES>(&at[4], &err);
  } else {
    attrs_of<false, K_CONV>(&at[0], &err);
    attrs_of<false, K_RES>(&at[1], &err);
    attrs_of<false, K_PROJ>(&at[2], &err);
    attrs_of<false, K_MS_CONV>(&at[3], &err);
    attrs_of<false, K_MS_RES>(&at[4], &err);
  }
  if (err != cudaSuccess) return err;
  for (int k = 0; k < 5; ++k) {
    out[5 * k] = at[k].numRegs;
    out[5 * k + 1] = (int)at[k].localSizeBytes;
    out[5 * k + 2] = bf16 ? pass_smem<true>(128) : pass_smem<false>(128);
    out[5 * k + 3] = G_THREADS;
    out[5 * k + 4] = 1;
  }
  return cudaSuccess;
}
