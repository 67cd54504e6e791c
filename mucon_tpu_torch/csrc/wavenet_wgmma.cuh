// The `wgmma` pass bodies above C = 512 channels on Hopper (sm_90a): one
// k-loop and its epilogues, shared by the eval stacks (wavenet_wgmma.cu, a
// kernel a pass) and the trainable stack (wavenet_wgmma_train.cu, a
// cooperative kernel that runs a program of passes with a grid barrier
// between them).  Each source that includes this file gets its own copy.
//
// A pass is GEMM-shaped: rows (a video's frames) times a [C x C] weight
// block, or, for the weight gradients, channels times channels summed over
// the rows.  Its kinds:
//
//   K_CONV     h = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)
//   K_RES      u = mask(m (h W1 + b1) + x); y = u or its pool (m: dropout or
//              none; a pooled layer's u kept if asked; y none: u only)
//   K_PROJ     z = mask(act(x) Wl + bl)
//   K_MS_CONV  MS-TCN++ pass 1: [conv_d1(f) W3a + b3a, conv_d2(f) W3b + b3b]
//   K_MS_RES   MS-TCN++ pass 2: y = mask(relu(ybuf [W1t; W1b] + b1) + f), or its max pool
//   K_DZ       dz = (dy W1^T) nonlin'(h), masked (the out-projection's: the
//              gradient at x_fin, every row past the length zero)
//   K_DX       g_in = mask(dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   K_WGRAD    a part of the rows of dW1 = h^T dy, dW3[k] = x[t+(k-1)d]^T dz
//              (proj: nonlin(x_fin)^T gz)
//   K_DY       dy = mask(g, or g routed through the pool by u) m  (elementwise)
//   K_TRANS    dy and dz (proj: gz) transposed into K-major planes for
//              K_WGRAD, and their column sums over runs of 32-row chunks
//   K_REDUCE   the weight gradients: the parts' partials added in order, the
//              biases the chunks' column sums in order
//
// Design (the pass kinds but the elementwise three).
// * Warp specialised, one persistent CTA an SM (384 threads): warpgroup 0
//   produces (one thread issues TMA tile loads into a ring of stages, each
//   tracked by a full and an empty `mbarrier`; its other warps write the
//   zeros of the rows past each video's live tiles), warpgroups 1 and 2
//   consume (`setmaxnreg` moves registers from the producer to them).
// * The row kinds: an item is (a pair of live 64-row tiles, a 128-column
//   slab); each consumer warpgroup owns one tile of the pair (rows of one
//   video; the two may be different videos), both read the same weight
//   slab.  The live tiles of every video are listed in order (a tile whose
//   first row is at or past min(T, length) is left out) and items run
//   pair-major, so that the CTAs of a wave share their activation tiles in
//   L2 and every slab's weights stay there.
// * Products are `wgmma.mma_async` m64n128: B from shared memory through a
//   descriptor of a 128B-swizzled K-major tile (64B in bf16); A from
//   registers, read from the swizzled f32 tile TMA wrote (the swizzle makes
//   the fragment loads conflict-free) with the rows outside [0, min(T,
//   length)) zeroed, nonlin applied where the pass asks, and, in 3xTF32,
//   split into TF32 hi and lo (`split`) once a chunk.  `wgmma` takes TF32
//   operands K-major only, so the weights come as [N x K] planes: the
//   wrapper splits them once a call (the forward's blocks transposed, the
//   sweep's as they are: dz and dx multiply by W^T).
// * The weight gradients: an item is (a part of the rows, a job, a 128 x
//   128 output block: A's band of 128 channels, a 64-row tile a consumer
//   warpgroup, by B's band of 128).  The rows are every video's rows t <
//   min(T, length) in 32-row chunks, video by video, cut into `parts` equal
//   runs of chunks (so that items x parts fill the card's SMs).  `wgmma`
//   takes TF32 B K-major only and B (dy or dz) lies with its channels
//   contiguous, so K_TRANS first writes each of them once a layer
//   transposed into K-major planes in device memory (3xTF32: hi and lo,
//   split; bf16: rounded; zero past each length).  A chunk is then 32 rows
//   of A's band (four 32 x 32 boxes) and B's planes' [128 x 32] box, a
//   stage of a ring of their own (4 stages of 48 KiB; bf16: 8 of 24 KiB); A
//   (h or x) goes in from registers, read transposed from its boxes, zero
//   where its row or its shifted row is past the length.  The chunks move
//   from L2, not the tensor cores, set the pace (3 bytes an output a row).
//   A part's sum runs over thousands of rows, so it keeps the row kinds'
//   order (below): the tensor cores' adds truncate, and a chunk's partial
//   added in f32 rounds to nearest once a chunk.  The parts are a function
//   of C alone (`parts_for`, sized for 132 SMs), so the gradients' bits do
//   not depend on the card's SM count.  Each item writes its partial, and
//   K_REDUCE adds the parts in order, and the biases from K_TRANS's run
//   sums in order: two calls agree bit for bit.
// * The sums keep the `mma.sync` bodies' order: each 32-deep k-chunk's hi
//   x hi products are a fresh partial (the chunk's first `wgmma` with
//   scale-d = 0), added to the sum in f32; the small products (lo x hi,
//   then hi x lo, a k-step at a time) are a sum of their own, added last.
//   The bf16 mode: one partial a chunk, no small sum.
// * Registers: a consumer thread holds the sum, the small sum and the
//   partial (64 floats each at 64 x 128) and one k-step pair's A
//   fragments; a chunk's `wgmma`s are issued in two groups of two k-steps,
//   each waited for before its A registers are reused.
// * A tap no row of either tile reaches is not loaded; a tap one tile does
//   not reach is not multiplied there.
// * The epilogues are the narrow kernels': a warp's share of an m64n128
//   accumulator has the m16n8 fragment layout, rows 2k and 2k + 1 in lanes
//   l and l ^ 4 (`for_each_pair`, `store_pooled`, max keeping the first of a
//   tie).  Reads of activations go through L2 (`__ldcg`): a program's pass
//   may read what an earlier pass of the same launch wrote.
//
// Shared memory: RING_BYTES = 192 KiB of stages (4 stages of two 8 KiB A
// tiles and a 32 KiB chunk of hi and lo planes; bf16: 8 stages, an 8 KiB
// plane; the weight gradients' 3 of a 32 KiB A band and 32 KiB of B's
// planes, bf16 4 of 40 KiB), the barriers and the live units' prefix (4
// bytes a video).  A thread tracks each barrier's parity, so passes of
// different stage counts follow each other in one launch.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavenet_sweep.cuh"

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
constexpr int RING_BYTES = 196608;     // every pass kind's stages
constexpr int MAX_STAGES = 8;
// the weight gradients: an item's output rows, A's band (each consumer
// warpgroup one 64-row tile of it); a chunk of it, GK rows in WA / GK
// boxes of GK x GK
constexpr int WA = 128;
constexpr int BOX_BYTES = GK * GK * 4, WA_BYTES = (WA / GK) * BOX_BYTES;

// the weight gradients' ring: A's band and B's planes a stage
template <bool BF>
struct WRing {
  static constexpr int STAGES = BF ? 8 : 4;
  static constexpr int B_BYTES = BF ? BB_BYTES : 2 * BT_BYTES;
  static constexpr int STAGE = WA_BYTES + B_BYTES;  // a multiple of 1024
};
static_assert(WRing<false>::STAGES * WRing<false>::STAGE <= RING_BYTES &&
                  WRing<true>::STAGES * WRing<true>::STAGE <= RING_BYTES,
              "the weight gradients' ring");
constexpr int BARS = 2 * MAX_STAGES;  // a full and an empty barrier a stage
static_assert(PRODUCER_REGS * 128 + 2 * CONSUMER_REGS * 128 <= 65536, "registers an SM");

template <bool BF>
struct Ring {
  static constexpr int STAGES = BF ? 8 : 4;
  static constexpr int B_BYTES = BF ? BB_BYTES : 2 * BT_BYTES;
  static constexpr int STAGE = 2 * A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int BYTES = STAGES * STAGE;
};
static_assert(Ring<false>::BYTES == RING_BYTES && Ring<true>::BYTES == RING_BYTES, "one ring");

enum Kind {
  K_CONV, K_RES, K_PROJ, K_MS_CONV, K_MS_RES, K_DZ, K_DX, K_WGRAD, K_DY, K_TRANS, K_REDUCE
};

// taps a kind's item may have: the dilated convs' three (the sweep's dx
// mirrored), the MS-TCN++ 1x1's two k-halves ([W1t; W1b] read as two
// blocks), else one
template <int KIND>
__host__ __device__ constexpr int max_taps() {
  return (KIND == K_CONV || KIND == K_MS_CONV || KIND == K_DX) ? 3 : (KIND == K_MS_RES ? 2 : 1);
}

struct GArgs {
  const int* lengths;
  const float* x;      // K_RES, K_MS_RES: the residual; K_DZ: h (nonlin'); K_DX, K_DY: g
  float* out;          // h, y (K_RES: null, u only), z, ybuf, dz, g_in, dy; K_WGRAD,
                       // K_REDUCE: the partials
  const float* bias;   // b3, b1, bl (K_MS_CONV: b3a)
  const float* bias2;  // K_MS_CONV: b3b
  const float* drop;   // K_RES, K_DY: the dropout mask, or null
  float* u_out;        // K_RES: a pooled layer's pre-pool u (rows t < min(T, len)), or null
  const float* u;      // K_DX, K_DY: the pre-pool u the max pool routes g by
  float *dw1, *db1, *dw3, *db3;  // K_REDUCE (the out-projection's: dWl, dbl in dw1, db1)
  int B, T, C, slabs;  // slabs: output columns / GN
  int d, d2;           // dilations (K_MS_CONV: d1, d2)
  int blk, nblk;       // the pass's first weight block; blocks a plane
  int shift, pool, pool_mean, leaky, a_nonlin;
  int proj;            // K_DZ, K_WGRAD: the out-projection's sweep
  int jobs, parts;     // K_WGRAD, K_REDUCE: products and parts of the rows
  // the weight gradients' B operands (K_TRANS writes, K_WGRAD and K_REDUCE
  // read): bt, `tensors` (dy, dz; the out-projection's: gz) transposed into
  // K-major planes of C (bf16) or 2C (3xTF32: hi, lo) rows of B x tc floats
  // (tc: T rounded up to 32 rows), `plane` floats apart; bsum, their column
  // sums over each run of RUN 32-row chunks, `nck` runs x C floats apart
  float *bt, *bsum;
  int tensors, tc, plane, nck;
};

// the tensor maps a pass reads: K_WGRAD: A of job 0 (h, or nonlin(x_fin)),
// of jobs 1-3 (x); B's planes of job 0 (dy, or gz), of jobs 1-3 (dz); the others: A
// and the weight planes (a2, w2 unused)
struct Maps {
  const CUtensorMap *a, *a2, *w, *w2;
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

// a thread's place in the ring: the chunks it has passed and the parity of
// each stage barrier's next wait (bit s)
struct RingPos {
  uint32_t q, phase;
};

// wait for stage q % stages of the ring (full or empty barriers from bar0)
__device__ __forceinline__ int ring_wait(RingPos& pos, int stages, uint32_t bar0) {
  const int s = pos.q % stages;
  bar_wait(bar0 + 8 * s, (pos.phase >> s) & 1);
  pos.phase ^= 1u << s;
  ++pos.q;
  return s;
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

// generic-proxy writes of this thread before, async-proxy (TMA, wgmma) reads after
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// f32 element (r, k) of a rows x 32 tile in the 128B-swizzled layout TMA
// writes (16-byte chunk k / 4 of row r stored at chunk (k / 4) ^ (r % 8))
__device__ __forceinline__ int swz(int r, int k) {
  return r * GK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// byte offset of bf16 element (n, k) of a rows x 32 K-major plane in the
// 64B-swizzled layout (16-byte chunk k / 8 of row n at chunk (k / 8) ^ ((n / 2) % 4))
__device__ __forceinline__ int swz_bf16(int n, int k) {
  return n * 64 + ((((k >> 3) ^ ((n >> 1) & 3))) << 4) + ((k & 7) << 1);
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

// A's fragments from a row tile TMA wrote (rows of the tile, k along its
// 32 columns): load(ks, hi, lo) in 3xTF32, load(ks, a) in bf16
struct RowA {
  const float* A;
  int r0, tq;
  bool ok0, ok1, act;
  int leaky;
  __device__ __forceinline__ void operator()(int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    a_split(A, ks, r0, tq, ok0, ok1, act, leaky, hi, lo);
  }
  __device__ __forceinline__ void operator()(int ks, uint32_t (&a)[4]) const {
    a_bf16(A, ks, r0, tq, ok0, ok1, act, leaky, a);
  }
};

// A's fragments read transposed from a weight-gradient chunk's box (k along
// its 32 rows, this thread's output rows its columns c, c + 8), the rows
// outside [vlo, vhi) zero
struct ColA {
  const float* A;
  int c, tq, vlo, vhi;
  bool act;
  int leaky;
  __device__ __forceinline__ float at(int t, int col) const {
    const float v = t >= vlo && t < vhi ? A[swz(t, col)] : 0.f;
    return act ? nonlin(v, leaky) : v;
  }
  __device__ __forceinline__ void operator()(int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    const int t = 8 * ks + tq;
    split(at(t, c), hi[0], lo[0]);
    split(at(t, c + 8), hi[1], lo[1]);
    split(at(t + 4, c), hi[2], lo[2]);
    split(at(t + 4, c + 8), hi[3], lo[3]);
  }
  __device__ __forceinline__ void operator()(int ks, uint32_t (&a)[4]) const {
    const int k = 16 * ks + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c + 8 * (e & 1), kk = k + 8 * (e >> 1);
      a[e] = pack_bf16(at(kk, col), at(kk + 1, col));
    }
  }
};

// one 32-deep chunk into the sums (see the top): 3xTF32.  load(ks, hi, lo)
// gives k-step ks's A fragments.
template <class LoadA>
__device__ __forceinline__ void chunk_tf32(Acc& acc, Acc& small, Acc& p, uint64_t dhi,
                                           uint64_t dlo, const LoadA& load) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) load(2 * half + kk, ah[kk], al[kk]);
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
template <class LoadA>
__device__ __forceinline__ void chunk_bf16(Acc& acc, Acc& p, uint64_t db, const LoadA& load) {
  uint32_t a[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) load(ks, a[ks]);
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

__device__ __forceinline__ void zero(Acc& d) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[0][j][e] = 0.f;
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

// the last video b with pre[b] <= unit: the one that holds it
__device__ __forceinline__ int video_of(const int* pre, int B, int unit) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= unit) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <int KIND>
__device__ __forceinline__ void decode(const GArgs& a, const int* pre, int item, GItem& it) {
  const int pair = item / a.slabs, slab = item - pair * a.slabs;
  const int total = pre[a.B];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int tile = 2 * pair + w;
    const int b = video_of(pre, a.B, tile);
    GTile& tl = it.t[w];
    tl.has = tile < total;
    tl.b = b;
    tl.t0 = tl.has ? (tile - pre[b]) * GM : 0;
    tl.len = __ldg(a.lengths + b) >> a.shift;
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

// the row offset of tap j: the forward convs' (j - 1) d, the sweep's dx mirrored
template <int KIND>
__device__ __forceinline__ int tap_off(const GItem& it, int j) {
  return (KIND == K_CONV || KIND == K_MS_CONV) ? (j - 1) * it.dd
                                               : (KIND == K_DX ? (1 - j) * it.dd : 0);
}

// tap j reaches a row of the tile within [0, lim)
template <int KIND>
__device__ __forceinline__ bool tap_live(const GItem& it, int j, const GTile& tl) {
  const int off = tap_off<KIND>(it, j);
  return tl.has && tl.t0 + GM + off > 0 && tl.t0 + off < tl.lim;
}

// g's value at row t of a layer's output, channels col, col + 1 (`grad_at`
// at a runtime width, through L2): g itself, or a pooled layer's g [B, T/2,
// C] routed through the pool (max: to the first maximum of the pair in u;
// sum: to both); zero at t >= len and where the forward masked the pair
__device__ __forceinline__ float2 grad_rt(const float* g, const float* u, int b, int t, int T,
                                          int len, int col, int pooled, int pool_mean, int C) {
  if (t >= len) return make_float2(0.f, 0.f);
  if (!pooled) return ld2_l2(g + ((size_t)b * T + t) * C + col);
  const int T2 = T / 2, j = t >> 1;
  if (j >= T2 || j >= (len >> 1)) return make_float2(0.f, 0.f);
  const float2 gv = ld2_l2(g + ((size_t)b * T2 + j) * C + col);
  if (pool_mean) return gv;
  const float2 u0 = ld2_l2(u + ((size_t)b * T + 2 * j) * C + col);
  const float2 u1 = ld2_l2(u + ((size_t)b * T + 2 * j + 1) * C + col);
  if (t & 1) return make_float2(u1.x > u0.x ? gv.x : 0.f, u1.y > u0.y ? gv.y : 0.f);
  return make_float2(u1.x > u0.x ? 0.f : gv.x, u1.y > u0.y ? 0.f : gv.y);
}

// ---------------------------------------------------------------------------
// the epilogues of the row kinds: a consumer warpgroup's 64 x 128 outputs
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
  } else if constexpr (KIND == K_DZ) {  // * nonlin'(h), masked
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      const float2 hv = t < lim ? ld2_l2(a.x + ((size_t)b * T + t) * C + n0 + col)
                                : make_float2(0.f, 0.f);
      v0 = t < lim ? v0 * nonlin_grad(hv.x, a.leaky) : 0.f;
      v1 = t < lim ? v1 * nonlin_grad(hv.y, a.leaky) : 0.f;
    });
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < T) st2(a.out + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
    });
  } else if constexpr (KIND == K_DX) {  // + gm, masked
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      const float2 gm = t < lim ? grad_rt(a.x, a.u, b, t, T, len, n0 + col, a.pool,
                                          a.pool_mean, C)
                                : make_float2(0.f, 0.f);
      v0 = t < lim ? v0 + gm.x : 0.f;
      v1 = t < lim ? v1 + gm.y : 0.f;
    });
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < T) st2(a.out + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
    });
  } else {  // K_RES, K_MS_RES: bias, (dropout,) residual, mask, then the rows or their pool
    for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
      const int t = t0 + row;
      if (KIND == K_RES ? t >= lim : t >= len) {
        v0 = v1 = 0.f;
        return;
      }
      const size_t o = ((size_t)b * T + t) * C + n0 + col;
      const float2 xv = t < lim ? ld2_l2(a.x + o) : make_float2(0.f, 0.f);
      const float c0 = v0 + __ldg(a.bias + n0 + col), c1 = v1 + __ldg(a.bias + n0 + col + 1);
      if (KIND == K_RES && a.drop) {
        const float2 m = ld2(a.drop + o);
        v0 = c0 * m.x + xv.x;
        v1 = c1 * m.y + xv.y;
      } else {
        v0 = (KIND == K_RES ? c0 : fmaxf(c0, 0.f)) + xv.x;
        v1 = (KIND == K_RES ? c1 : fmaxf(c1, 0.f)) + xv.y;
      }
    });
    if (KIND == K_RES && a.pool && a.u_out)
      for_each_pair(acc, row0, 0, lane, [&](float& v0, float& v1, int row, int col) {
        if (t0 + row < lim) st2(a.u_out + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
      });
    if (!a.out) return;
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
// a CTA's shared memory and its set-up
// ---------------------------------------------------------------------------

struct GShared {
  uint8_t* smem;      // the ring (1024-aligned)
  uint32_t base;      // its shared address
  uint32_t full0, empty0;
  int* pre;           // [B + 1]: the live units before each video
};

__host__ __device__ constexpr int pass_smem(int B) {
  return RING_BYTES + 1024 + 8 * BARS + 4 * (B + 1);
}

// the ring's barriers initialised (every thread calls; one __syncthreads)
__device__ __forceinline__ GShared shared_setup(uint8_t* smem_raw) {
  GShared sh;
  const uint32_t raw = smem_u32(smem_raw);
  sh.smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  sh.base = smem_u32(sh.smem);
  sh.full0 = sh.base + RING_BYTES;
  sh.empty0 = sh.full0 + 8 * MAX_STAGES;
  sh.pre = reinterpret_cast<int*>(sh.smem + RING_BYTES + 8 * BARS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      bar_init(sh.full0 + 8 * s, 1);
      bar_init(sh.empty0 + 8 * s, 8);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return sh;
}

// live units of `unit` rows a video, prefix-summed: pre[b] before video b
// (warp 0)
__device__ __forceinline__ void live_prefix(const GArgs& a, int* pre, int unit) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    int n = 0;
    if (b < a.B) n = (min(a.T, __ldg(a.lengths + b) >> a.shift) + unit - 1) / unit;
    n = max(n, 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, n, o);
      if (lane >= o) n += y;
    }
    if (b < a.B) pre[b + 1] = carry + n;
    carry += __shfl_sync(0xffffffffu, n, 31);
  }
  if (lane == 0) pre[0] = 0;
}

template <int KIND>
__host__ __device__ constexpr int pass_unit() {
  return (KIND == K_WGRAD || KIND == K_TRANS || KIND == K_REDUCE) ? GK : GM;
}

// ---------------------------------------------------------------------------
// the row kinds' producer and consumers
// ---------------------------------------------------------------------------

template <bool BF, int KIND>
__device__ __forceinline__ void produce_rows(const GArgs& a, const Maps& m, const GShared& sh,
                                             RingPos& pos) {
  using R = Ring<BF>;
  const int* pre = sh.pre;
  const int n_items = ((pre[a.B] + 1) / 2) * a.slabs;
  const int kpt = a.C / GK;  // chunks a tap
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
      for (int kc = 0; kc < kpt; ++kc) {
        const int s = ring_wait(pos, R::STAGES, sh.empty0);
        const uint32_t stage = sh.base + s * R::STAGE, full = sh.full0 + 8 * s;
        bar_expect(full, R::STAGE);
        tma_2d(stage, m.a, full, acol + kc * GK, r0);
        tma_2d(stage + A_BYTES, m.a, full, acol + kc * GK, r1);
        tma_2d(stage + 2 * A_BYTES, m.w, full, kc * GK, wr);
        if (!BF) tma_2d(stage + 2 * A_BYTES + BT_BYTES, m.w, full, kc * GK, wr + a.nblk * a.C);
      }
    }
  }
}

// zeros for each video's rows past its live tiles (warps 1..3 of the producer)
template <int KIND>
__device__ __forceinline__ void zero_rest(const GArgs& a, const int* pre) {
  const bool any = (KIND == K_RES && a.out) || KIND == K_PROJ || KIND == K_MS_RES ||
                   (KIND == K_DZ && a.proj) || KIND == K_DX;
  if (!any) return;
  const bool pooled = (KIND == K_RES || KIND == K_MS_RES) && a.pool;
  const int Tout = pooled ? a.T / 2 : a.T, per = pooled ? GM / 2 : GM, c4 = a.C / 4;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int first = min(Tout, (pre[b + 1] - pre[b]) * per);
    float4* y = reinterpret_cast<float4*>(a.out + ((size_t)b * Tout + first) * a.C);
    const long n = (long)(Tout - first) * c4;
    for (long i = threadIdx.x - 32; i < n; i += 96) y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool BF, int KIND>
__device__ __forceinline__ void consume_rows(const GArgs& a, const GShared& sh, RingPos& pos) {
  using R = Ring<BF>;
  const int* pre = sh.pre;
  const int n_items = ((pre[a.B] + 1) / 2) * a.slabs;
  const int kpt = a.C / GK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp / 4 - 1, wi = warp & 3, tq = lane & 3;
  const int r0 = 16 * wi + (lane >> 2);  // this thread's first row of the tile (and r0 + 8)
  const bool act = KIND == K_PROJ && a.a_nonlin;
  Acc acc, small, p;
  zero(p);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    GItem it;
    decode<KIND>(a, pre, item, it);
    const GTile me = w ? it.t[1] : it.t[0], other = w ? it.t[0] : it.t[1];
    zero(acc);
    zero(small);
#pragma unroll
    for (int j = 0; j < max_taps<KIND>(); ++j) {
      const bool mine = tap_live<KIND>(it, j, me);
      if (!mine && !tap_live<KIND>(it, j, other)) continue;
      const int t = me.t0 + tap_off<KIND>(it, j) + r0;
      const bool ok0 = mine && t >= 0 && t < me.lim;
      const bool ok1 = mine && t + 8 >= 0 && t + 8 < me.lim;
      for (int kc = 0; kc < kpt; ++kc) {
        const int s = ring_wait(pos, R::STAGES, sh.full0);
        const uint32_t stage = sh.base + s * R::STAGE;
        if (mine) {
          const RowA load{reinterpret_cast<const float*>(sh.smem + s * R::STAGE + w * A_BYTES),
                          r0, tq, ok0, ok1, act, a.leaky};
          if constexpr (BF) {
            chunk_bf16(acc, p, desc_of(stage + 2 * A_BYTES, 512, 2), load);
          } else {
            chunk_tf32(acc, small, p, desc_of(stage + 2 * A_BYTES, 1024, 1),
                       desc_of(stage + 2 * A_BYTES + BT_BYTES, 1024, 1), load);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(sh.empty0 + 8 * s);
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
// the weight gradients' producer and consumers
// ---------------------------------------------------------------------------

// item k of a weight-gradient pass: part g of the rows (chunks [c_lo,
// c_hi)), job, output block (bm: A's WA-column band, the output rows, the
// last cut at C; bn: B's 128-column band, the output columns).  Part-major,
// so that a wave's CTAs read the same rows.
struct WItem {
  int g, job, bm, bn, c_lo, c_hi;
};

__host__ __device__ constexpr int wa_bands(int C) { return (C + WA - 1) / WA; }

__device__ __forceinline__ WItem wdecode(const GArgs& a, int item, int chunks) {
  const int nb = a.C / GN, na = wa_bands(a.C);
  WItem w;
  w.bm = item % na;
  int r = item / na;
  w.bn = r % nb;
  r /= nb;
  w.job = r % a.jobs;
  w.g = r / a.jobs;
  w.c_lo = (int)((long)w.g * chunks / a.parts);
  w.c_hi = (int)((long)(w.g + 1) * chunks / a.parts);
  return w;
}

// the row offset of job j's A: dW3[0] takes x[t - d], dW3[2] x[t + d]
__device__ __forceinline__ int job_off(int job, int d) {
  return job == 1 ? -d : (job == 3 ? d : 0);
}

template <bool BF>
__device__ __forceinline__ void produce_wgrad(const GArgs& a, const Maps& m, const GShared& sh,
                                              RingPos& pos) {
  using R = WRing<BF>;
  const int* pre = sh.pre;
  const int chunks = pre[a.B];
  const int n_items = a.parts * a.jobs * wa_bands(a.C) * (a.C / GN);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const WItem w = wdecode(a, item, chunks);
    const CUtensorMap* am = w.job == 0 ? m.a : m.a2;
    const CUtensorMap* bm = w.job == 0 ? m.w : m.w2;
    const int off = job_off(w.job, a.d);
    int b = w.c_lo < chunks ? video_of(pre, a.B, w.c_lo) : 0;
    for (int c = w.c_lo; c < w.c_hi; ++c) {
      while (c >= pre[b + 1]) ++b;
      const int t0 = (c - pre[b]) * GK;
      const int s = ring_wait(pos, R::STAGES, sh.empty0);
      const uint32_t stage = sh.base + s * R::STAGE, full = sh.full0 + 8 * s;
      bar_expect(full, R::STAGE);
      // A's band: rows t0 + off .., WA / GK 32-column boxes (past C: zeros)
#pragma unroll
      for (int x = 0; x < WA / GK; ++x)
        tma_2d(stage + x * BOX_BYTES, am, full, w.bm * WA + x * GK, b * a.T + t0 + off);
      // B's planes: the band's 128 channels (rows), 32 rows of the video (columns)
      tma_2d(stage + WA_BYTES, bm, full, b * a.tc + t0, w.bn * GN);
      if (!BF) tma_2d(stage + WA_BYTES + BT_BYTES, bm, full, b * a.tc + t0, a.C + w.bn * GN);
    }
  }
}

template <bool BF>
__device__ __forceinline__ void consume_wgrad(const GArgs& a, const GShared& sh, RingPos& pos) {
  using R = WRing<BF>;
  const int* pre = sh.pre;
  const int tid = threadIdx.x - 128, lane = tid & 31, wi = (tid >> 5) & 3, w = tid >> 7;
  const int tq = lane & 3, C = a.C, chunks = pre[a.B];
  const int n_items = a.parts * a.jobs * wa_bands(C) * (C / GN);
  const bool act = a.proj;  // the out-projection's A: nonlin(x_fin)
  Acc acc, small, p;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const WItem wt = wdecode(a, item, chunks);
    const int off = job_off(wt.job, a.d);
    const int r0 = wt.bm * WA + GM * w;  // this warpgroup's first output row
    zero(acc);
    if (!BF) zero(small);
    int b = wt.c_lo < chunks ? video_of(pre, a.B, wt.c_lo) : 0;
    for (int c = wt.c_lo; c < wt.c_hi; ++c) {
      while (c >= pre[b + 1]) ++b;
      const int t0 = (c - pre[b]) * GK;
      const int lim = min(a.T, __ldg(a.lengths + b) >> a.shift);
      const int s = ring_wait(pos, R::STAGES, sh.full0);
      // A's valid rows of the chunk: t0 + t < lim and 0 <= t0 + t + off < lim
      // (B's planes are zero past lim); this thread's output rows: channels
      // 64 w + 16 wi + g (+ 8) of the band, in one 32-column box
      const int vlo = max(0, -off - t0), vhi = min(lim - t0, lim - off - t0);
      const float* band = reinterpret_cast<const float*>(sh.smem + s * R::STAGE);
      const int ch = GM * w + 16 * wi + (lane >> 2);
      const ColA load{band + (ch >> 5) * (GK * GK), ch & 31, tq, vlo, vhi, act, a.leaky};
      const uint32_t bp = sh.base + s * R::STAGE + WA_BYTES;
      if constexpr (BF)
        chunk_bf16(acc, p, desc_of(bp, 512, 2), load);
      else
        chunk_tf32(acc, small, p, desc_of(bp, 1024, 1), desc_of(bp + BT_BYTES, 1024, 1), load);
      __syncwarp();
      if (lane == 0) bar_arrive(sh.empty0 + 8 * s);
    }
    if constexpr (!BF) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][j][e] += small[0][j][e];
    }
    float* part = a.out + (size_t)(wt.g * a.jobs + wt.job) * part_f(C);
    for_each_pair(acc, 16 * wi, 0, lane, [&](float& v0, float& v1, int row, int col) {
      st2(part + (size_t)(r0 + row) * C + wt.bn * GN + col, v0, v1);
    });
  }
}

// ---------------------------------------------------------------------------
// the elementwise kinds (the consumer warpgroups, grid-stride)
// ---------------------------------------------------------------------------

// dy = (g, or g routed by u) m at the rows t < min(T, len): a warp a row,
// its lanes along the channels
__device__ __forceinline__ void consume_dy(const GArgs& a) {
  const int C = a.C, lane = threadIdx.x & 31;
  const int warps = gridDim.x * 8, rows = a.B * a.T;
  for (int r = blockIdx.x * 8 + (threadIdx.x - 128) / 32; r < rows; r += warps) {
    const int b = r / a.T, t = r - b * a.T;
    const int len = __ldg(a.lengths + b) >> a.shift;
    if (t >= min(a.T, len)) continue;
    const size_t o = (size_t)r * C;
    for (int col = 2 * lane; col < C; col += 64) {
      float2 v = grad_rt(a.x, a.u, b, t, a.T, len, col, a.pool, a.pool_mean, C);
      if (a.drop) {
        const float2 m = ld2(a.drop + o + col);
        v = make_float2(v.x * m.x, v.y * m.y);
      }
      st2(a.out + o + col, v.x, v.y);
    }
  }
}

// the weight gradients' B operands: a warp a unit of (tensor, run of RUN
// 32-row chunks, 32 channels): each chunk's 32 rows (zero past lim) read a
// row at a time (a lane a channel), turned through the warp's tile of
// shared memory and written a channel at a time (a lane a row) into the
// K-major planes (3xTF32: hi, lo; bf16: rounded); the run's column sums,
// row by row, into bsum
constexpr int RUN = 8;

template <bool BF>
__device__ __forceinline__ void consume_trans(const GArgs& a, const GShared& sh) {
  const int* pre = sh.pre;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x - 128) / 32;
  const int cb = a.C / 32, chunks = pre[a.B];
  const int runs = (chunks + RUN - 1) / RUN, n = a.tensors * runs * cb;
  float* tile = reinterpret_cast<float*>(sh.smem) + warp * 32 * 33;  // [32][33]
  for (int u = blockIdx.x * 8 + warp; u < n; u += gridDim.x * 8) {
    const int tensor = u / (runs * cb), rest = u - tensor * runs * cb;
    const int run = rest / cb, j0 = (rest - run * cb) * 32;
    const float* base = tensor ? a.u : a.x;
    float* planes = a.bt + (size_t)tensor * a.plane;
    const size_t stride = (size_t)a.B * a.tc;  // a plane row's elements
    float sum = 0.f;
    int b = video_of(pre, a.B, run * RUN);
    for (int c = run * RUN; c < min(chunks, (run + 1) * RUN); ++c) {
      while (c >= pre[b + 1]) ++b;
      const int t0 = (c - pre[b]) * GK;
      const int lim = min(a.T, __ldg(a.lengths + b) >> a.shift);
      const float* src = base + ((size_t)b * a.T + t0) * a.C + j0 + lane;
      float v[GK];
#pragma unroll
      for (int r = 0; r < GK; ++r) v[r] = t0 + r < lim ? __ldcg(src + (size_t)r * a.C) : 0.f;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < GK; ++r) {
        sum += v[r];
        tile[r * 33 + lane] = v[r];
      }
      __syncwarp();
      const size_t col = (size_t)b * a.tc + t0 + lane;  // this lane's row of the chunk
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        const float x = tile[lane * 33 + jj];
        const size_t o = (size_t)(j0 + jj) * stride + col;
        if constexpr (BF) {
          reinterpret_cast<uint16_t*>(planes)[o] = (uint16_t)(pack_bf16(x, 0.f) & 0xFFFF);
        } else {
          uint32_t hi, lo;
          split(x, hi, lo);
          reinterpret_cast<uint32_t*>(planes)[o] = hi;
          reinterpret_cast<uint32_t*>(planes)[o + (size_t)a.C * stride] = lo;
        }
      }
    }
    a.bsum[((size_t)tensor * a.nck + run) * a.C + j0 + lane] = sum;
  }
}

// the weight gradients, a warp a unit: 128 columns of a row of a job's C x
// C weight gradient (a lane four), its parts' partials added in order; or
// 32 columns of a bias, B's column sums over its runs of chunks in order
__device__ __forceinline__ void consume_reduce(const GArgs& a, const int* pre) {
  const int C = a.C, pf = part_f(C), lane = threadIdx.x & 31, slabs = C / GN;
  const int runs = (pre[a.B] + RUN - 1) / RUN, weights = a.jobs * C * slabs;
  const int units = weights + (a.jobs == 4 ? 2 : 1) * (C / 32);
  for (int u = blockIdx.x * 8 + (threadIdx.x - 128) / 32; u < units; u += gridDim.x * 8) {
    if (u >= weights) {  // dy's (the out-projection's gz) for db1, dz's for db3
      const int v = u - weights, tensor = v / (C / 32), col = (v % (C / 32)) * 32 + lane;
      const float* p = a.bsum + (size_t)tensor * a.nck * C + col;
      float s = 0.f;
      int r = 0;
      for (; r + 8 <= runs; r += 8) {  // eight loads in flight, added in order
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __ldcg(p + (size_t)(r + i) * C);
#pragma unroll
        for (int i = 0; i < 8; ++i) s += x[i];
      }
      for (; r < runs; ++r) s += __ldcg(p + (size_t)r * C);
      (tensor ? a.db3 : a.db1)[col] = s;
      continue;
    }
    const int job = u / (C * slabs), rest = u - job * C * slabs;
    const int row = rest / slabs, k = row * C + (rest - row * slabs) * GN + lane;
    const float* p = a.out + (size_t)job * pf + k;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < a.parts; ++g, p += (size_t)a.jobs * pf) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __ldcg(p + 32 * i);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += x[i];
    }
    float* out = (job == 0 ? a.dw1 : a.dw3 + (size_t)(job - 1) * C * C) + k;
#pragma unroll
    for (int i = 0; i < 4; ++i) out[32 * i] = s[i];
  }
}

// a pass's arguments (the rest zero)
__host__ __device__ inline GArgs rows(const int* lengths, const float* x, float* out,
                                      const float* bias, int B, int T, int C, int slabs, int blk,
                                      int nblk, int shift) {
  GArgs a{};
  a.lengths = lengths;
  a.x = x;
  a.out = out;
  a.bias = bias;
  a.B = B;
  a.T = T;
  a.C = C;
  a.slabs = slabs;
  a.blk = blk;
  a.nblk = nblk;
  a.shift = shift;
  return a;
}

// ---------------------------------------------------------------------------
// a pass, in each role
// ---------------------------------------------------------------------------

// the producer warpgroup: thread 0 issues the loads, warps 1..3 write zeros
template <bool BF, int KIND>
__device__ __forceinline__ void produce(const GArgs& a, const Maps& m, const GShared& sh,
                                        RingPos& pos) {
  if constexpr (KIND == K_DY || KIND == K_TRANS || KIND == K_REDUCE) {
    return;
  } else if constexpr (KIND == K_WGRAD) {
    if (threadIdx.x == 0) produce_wgrad<BF>(a, m, sh, pos);
  } else {
    if (threadIdx.x == 0) produce_rows<BF, KIND>(a, m, sh, pos);
    else if (threadIdx.x >= 32) zero_rest<KIND>(a, sh.pre);
  }
}

template <bool BF, int KIND>
__device__ __forceinline__ void consume(const GArgs& a, const GShared& sh, RingPos& pos) {
  if constexpr (KIND == K_DY) consume_dy(a);
  else if constexpr (KIND == K_TRANS) consume_trans<BF>(a, sh);
  else if constexpr (KIND == K_REDUCE) consume_reduce(a, sh.pre);
  else if constexpr (KIND == K_WGRAD) consume_wgrad<BF>(a, sh, pos);
  else consume_rows<BF, KIND>(a, sh, pos);
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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
inline cudaError_t tensor_map(CUtensorMap* m, const void* ptr, bool bf16, long rows, int cols,
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

// the weight planes' map: [P x nblk x C x C] (P = 2 TF32 planes, 1 bf16), rows of C k
template <bool BF>
cudaError_t weight_map(CUtensorMap* m, const void* wt, int nblk, int C) {
  return tensor_map(m, wt, BF, (long)(BF ? 1 : 2) * nblk * C, C, GN);
}

}  // namespace
