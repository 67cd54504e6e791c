// One residual layer of the WaveNet stack on the tensor cores, and the row
// tile it is built from, for NVIDIA Hopper (sm_90a).  The eval stack
// (wavenet_stack.cu, 64-row tiles, no stash) and the trainable stack's
// forward (wavenet_train.cu, tiles chosen from the shape, with its stash and
// dropout) launch the same kernel, so the two round a layer alike; the
// trainable stack's sweep kernels are built from the same tile helpers.  The
// v2 stack's cooperative kernels (wavenet_train_v2.cu) run the same tile
// bodies (`layer_tile`, `proj_tile`) over a chunk of layers.
//
//   z  = x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3   ([TM,3C] @ [3C,C])
//   h  = nonlin(z)                                         (-> hs, if given)
//   u  = mask (m * (h W1 + b1) + x)        (m: dropout mask, if given; else 1)
//   y  = u, or pool2(u) masked at len/2 (max: first of a tie; sum: mean * 2);
//        a pooled layer writes u too, if given
//
// The stashes hs and u hold the rows t < len only.  An odd T pools to T / 2
// (the last row has no pair and is dropped).
//
// Design:
//
// * Every product is `mma.sync.m16n8k8` TF32 on hi/lo-split operands, three
//   products per f32 product (mma_tf32.cuh); the tiles stay f32 in shared
//   memory.  The bf16-operand mode (template BF = true, the JAX package's
//   `kernel_mm_dtype=bfloat16`) instead rounds both operands of every
//   product to bf16 as their fragments leave the same tiles and runs one
//   `mma.sync.m16n8k16` bf16 product a 16-deep k-step; the sums, bias,
//   residual, dropout, mask and pool stay f32 (`warp_gemm2<..., BF16>`).
//   A CTA owns TM rows of one video x all C columns, 8 warps as WM x WN of
//   16 MT x 8 NTL outputs.  C is a template parameter of
//   every body (128, 256 and 512 are built; the wrappers zero-pad another
//   width up to the next of them, which is exact: see cuda/__init__.py).
// * One k-loop (`tap_loop`): the layer's [3C x C] conv and its [C x C] 1x1
//   are weight rows streamed in chunks of KC through a 2-deep `cp.async`
//   ring.  The three tap tiles t-d, t, t+d are staged by `cp.async`,
//   zero-filled outside [0, min(T, len)); nonlin(z + b3) overwrites the t-d
//   tile and re-enters as the 1x1's A operand.
// * Padding is skipped: a tile whose first row is at or past its video's
//   length writes its zeros and returns.  A tile whose rows all have
//   t - d < 0, or all t + d >= len, skips that tap's chunks (a layer whose d
//   reaches past T does the centre tap alone): what is left out are
//   products of zeros.
// * f32 accuracy: an `mma` rounds its sum toward zero, so each weight
//   chunk's hi x hi products go to a fresh partial that is added to the sum
//   in f32, and the small products to a sum of their own (`warp_gemm2`).
//   nonlin(z) then errs less than an f32 FMA loop does, and the ReLU sides
//   and max-pool ties that the trainable stack's sweep routes by stay the
//   f32 twin's.
// * The epilogue stays in the accumulators: bias, dropout mask, residual,
//   length mask, the stashes, and the pool of row pairs.  In the m16n8k8 C
//   layout lane l holds rows l / 4 and l / 4 + 8, so rows 2k and 2k + 1 sit
//   in lanes l and l ^ 4: one `__shfl_xor_sync` pairs them.  u is written
//   from the registers that are pooled, so a reader of u compares the pair
//   the pool compared.
//
// Shared memory at C = 128, TM = 64: three row tiles of TM x (C + 4) floats
// (99 KiB; the stride keeps A-fragment loads conflict-free) and two KC x
// (C + 8) weight buffers (68 KiB) = 167 KiB, one CTA of 8 warps an SM; at
// TM = 32 and 16 (KC = 32) two CTAs an SM.  The rows a tile may take shrink
// as C grows, so that a tile still fits an SM (`tile_ok`): at C = 256, 32 or
// 16 rows on 32-row chunks (163.5 KiB at TM = 32); at C = 512, 16 rows on
// 16-row chunks (161.8 KiB).  One CTA an SM above C = 128.
//
// Each source that includes this file gets its own copy of what it uses.

#pragma once

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int NT = 256;                 // threads per CTA of a row-tile kernel

// row tile and weight chunk strides (floats) at C channels
__host__ __device__ constexpr int lda(int C) { return C + 4; }
__host__ __device__ constexpr int ldw(int C) { return C + 8; }

// the row tiles a width takes: 64, 32, 16 rows at C = 128; 32, 16 at 256;
// 16 at 512
__host__ __device__ constexpr bool tile_ok(int C, int TM) { return TM * C <= 128 * 64; }

// a tile's default weight chunk: 64 rows on a 64-row tile, 32 below it, 16 at C = 512
__host__ __device__ constexpr int default_kc(int C, int TM) {
  return C >= 512 ? 16 : (TM == 64 ? 64 : 32);
}

// A row tile of TM rows x C columns, 8 warps as WM x WN of 16 MT x 8 NTL outputs,
// its weight rows summed KC a chunk and staged KS a ring buffer.  An output
// element's sum depends on KC (each chunk's hi x hi products are one partial,
// see `tap_loop`) and not on TM or KS: a product that must repeat another bit
// for bit takes that one's KC.
template <int C_, int TM_, int KC_ = default_kc(C_, TM_), int KS_ = KC_>
struct Tile {
  static constexpr int C = C_;
  static constexpr int LDA = lda(C), LDW = ldw(C);
  static constexpr int TM = TM_;
  static constexpr int MT = TM == 16 ? 1 : 2;
  static constexpr int WM = TM / (16 * MT);
  static constexpr int WN = (NT / 32) / WM;
  static constexpr int NTL = C / (8 * WN);
  static constexpr int KC = KC_;                 // weight rows a chunk
  static constexpr int KS = KS_;                 // weight rows a ring buffer
  static constexpr int SUB = KC / KS;            // ring buffers a chunk
  static constexpr int CPB = C / KC;             // chunks a [C x C] block
  static constexpr int TILE_F = TM * LDA;
  static constexpr int WBUF_F = KS * LDW;
  static constexpr int TAPS_SMEM = (3 * TILE_F + 2 * WBUF_F) * 4;  // three tiles, the ring
  static constexpr int ONE_SMEM = (TILE_F + 2 * WBUF_F) * 4;       // one tile, the ring
  static constexpr int MIN_BLOCKS = (TM == 64 || C > 128) ? 1 : 2;
  static_assert(LDA % 32 == 4 && LDW % 32 == 8, "bank-conflict-free strides");
  static_assert(tile_ok(C, TM), "a tile of this many rows does not fit an SM at this width");
  static_assert(WM * WN * 32 == NT && TM == 16 * MT * WM && C == 8 * NTL * WN, "tiling");
  static_assert(CPB >= 2, "tap 1 spans two chunks (see tap_loop)");
  static_assert(KC % KS == 0 && KS % 8 == 0, "a chunk is whole ring buffers of k-steps");
};

__device__ __forceinline__ float nonlin(float v, int leaky) {
  return leaky ? (v > 0.f ? v : 0.01f * v) : fmaxf(v, 0.f);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// KC weight rows (row-major, C wide) into one ring buffer
template <int C, int KC>
__device__ __forceinline__ void stage_weights(float* Wb, const float* __restrict__ w) {
  constexpr int LDW = ldw(C);
  for (int i = threadIdx.x; i < KC * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    cp_async16(Wb + r * LDW + 4 * c4, w + (size_t)r * C + 4 * c4, true);
  }
}

// rows t_first .. t_first + TM of one video into a row tile; zeros outside [0, lim)
template <int C, int TM>
__device__ __forceinline__ void stage_rows(float* X, const float* __restrict__ xb,
                                           int t_first, int lim) {
  constexpr int LDA = lda(C);
  for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    const int t = t_first + r;
    const bool ok = t >= 0 && t < lim;
    cp_async16(X + r * LDA + 4 * c4, xb + (size_t)(ok ? t : 0) * C + 4 * c4, ok);
  }
}

// zeros for rows [first, first + rows) of video b's [Tout][C] output, t < Tout
template <int C>
__device__ __forceinline__ void store_zeros(float* __restrict__ y, int b, int first, int rows,
                                            int Tout) {
  for (int i = threadIdx.x; i < rows * (C / 4); i += NT) {
    const int t = first + i / (C / 4);
    if (t >= Tout) break;
    reinterpret_cast<float4*>(y + ((size_t)b * Tout + t) * C)[i % (C / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// visits this thread's accumulators two columns at a time:
// fn(element at col, element at col + 1, row, col)
template <int MT, int NTL, typename Fn>
__device__ __forceinline__ void for_each_pair(float (&acc)[MT][NTL][4], int row0, int col0,
                                              int lane, Fn fn) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], row0 + 16 * mt + (lane >> 2) + 8 * h,
           col0 + 8 * nt + 2 * (lane & 3));
}

// the finished rows (bias, residual and mask in) pooled in pairs (2k, 2k + 1)
// by one shuffle into y [B, T/2, C], zeroed at t/2 >= len/2; an odd T's last
// row has no pair and is dropped.  CT: the width C as a template, or 0 for a
// runtime width c_rt (the `wgmma` bodies of wavenet_wgmma.cuh).
template <int CT, int MT, int NTL>
__device__ __forceinline__ void store_pooled(float* __restrict__ y, float (&acc)[MT][NTL][4],
                                             int b, int t0, int T, int len, int row0,
                                             int col0, int lane, int pool_mean, int c_rt = 0) {
  const int C = CT ? CT : c_rt;
  const int g = lane >> 2, T2 = T / 2, len2 = len >> 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[NTL][2];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[mt][nt][2 * h + e];
          const float c = __shfl_xor_sync(0xffffffffu, a, 4);  // row g ^ 1
          p[nt][e] = pool_mean ? ((a + c) * 0.5f) * 2.0f : (c > a ? c : a);
        }
      const int t2 = (t0 + row0 + 16 * mt + g + 8 * h) >> 1;
      if ((g & 1) || t2 >= T2) continue;  // the odd row's lane holds the pair too
      float* yr = y + ((size_t)b * T2 + t2) * C + col0 + 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        st2(yr + 8 * nt, t2 < len2 ? p[nt][0] : 0.f, t2 < len2 ? p[nt][1] : 0.f);
    }
}

// acc += the dilated conv of one row tile and, where W[3] is given, the 1x1
// after it: blocks of C weight rows, tap k (A[k] times W[k]) for k = 0, 1, 2
// where present (tap 1 always; tap 0 if `first`, tap 2 if `last`), then
// block 3 (A[0] times W[3]).  `mid(acc)` runs after the last conv chunk,
// when every warp is done with A[0] as a tap (tap 1 has at least two
// chunks), and may rewrite it.  The row tiles' copies are issued before.
// Each chunk's hi_a hi_b products go to a fresh partial that is added to
// acc in f32, the small products to their own sum (`warp_gemm2`): the
// tensor cores' truncation then errs by KC / 8 ulps of a chunk's partial,
// not 3 x 8 C / 8 ulps of the whole sum.  A chunk's partial is added one
// chunk later (two partials, by the chunk's parity), when its products
// have landed: added at once, it would hold every warp at the chunk's
// barrier until the tensor cores drain.  A chunk may be staged as SUB ring
// buffers of KS rows (Tile<C, TM, KC, KS>): the partials, and so the sums, are
// the same, in less shared memory.
template <int C, int TM, int KC_ = Tile<C, TM>::KC, int KS_ = KC_, bool BF = false, class Mid>
__device__ __forceinline__ void tap_loop(float (&acc)[Tile<C, TM>::MT][Tile<C, TM>::NTL][4],
                                         float* const (&A)[3], const float* const (&W)[4],
                                         bool first, bool last, float* Wr, int row0,
                                         int col0, int lane, Mid mid) {
  using TL = Tile<C, TM, KC_, KS_>;
  constexpr int KC = TL::KC, KS = TL::KS, SUB = TL::SUB, CPB = TL::CPB, MT = TL::MT,
                NTL = TL::NTL, LDA = TL::LDA, LDW = TL::LDW;
  const int conv_chunks = (1 + first + last) * CPB;
  const int chunks = conv_chunks + (W[3] ? CPB : 0);  // even: CPB is
  auto block_of = [&](int c) {
    const int k = c / CPB + !first;
    return k == 2 && !last ? 3 : k;
  };
  // ring buffer q's weight rows (selects, not an index: the pointer arrays
  // stay in registers)
  auto weights_of = [&](int q) {
    const int c = q / SUB, k = block_of(c);
    const float* w = k == 0 ? W[0] : (k == 1 ? W[1] : (k == 2 ? W[2] : W[3]));
    return w + ((size_t)(c % CPB) * KC + (q % SUB) * KS) * C;
  };
  float small[MT][NTL][4] = {}, part0[MT][NTL][4] = {}, part1[MT][NTL][4] = {};
  auto fold = [&](float (&from)[MT][NTL][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] += from[mt][nt][e];
          from[mt][nt][e] = 0.f;
        }
  };
  auto step = [&](int c, float (&cur)[MT][NTL][4], float (&prev)[MT][NTL][4]) {
    const int k = block_of(c);
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      const int q = c * SUB + s;
      cp_async_wait<0>();  // buffer q (and the row tiles) have landed
      __syncthreads();     // ... for every thread; buffer q - 1 is consumed
      if (q + 1 < chunks * SUB)
        stage_weights<C, KS>(Wr + ((q + 1) & 1) * TL::WBUF_F, weights_of(q + 1));
      cp_async_commit();
      warp_gemm2<MT, NTL, KS, false, BF>(small, cur, k == 1 ? A[1] : (k == 2 ? A[2] : A[0]), LDA, row0,
                              (c % CPB) * KC + s * KS, Wr + (q & 1) * TL::WBUF_F, LDW, col0,
                              lane);
      if (s == 0) fold(prev);  // chunk c - 1's partial
    }
    if (c == conv_chunks - 1) {
      fold(cur);
      fold(small);
      mid(acc);
    }
  };
  stage_weights<C, KS>(Wr, weights_of(0));
  cp_async_commit();
  for (int c = 0; c < chunks; c += 2) {
    step(c, part0, part1);
    step(c + 1, part1, part0);
  }
  fold(part1);
  fold(small);
}

// u = mask (m * (acc + b1) + x) in the accumulators, x from the row tile XC
// (row t0 + r at XC[r]): the layer's output before the pool.  The forward
// and the v2 sweep's recompute of u both take it from here, so that the
// recompute rounds as the forward did.
template <int C, int MT, int NTL>
__device__ __forceinline__ void residual(float (&acc)[MT][NTL][4], const float* XC,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ drop, int b, int T, int t0,
                                         int lim, int row0, int col0, int lane) {
  constexpr int LDA = lda(C);
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    if (t >= lim) {
      v0 = v1 = 0.f;
      return;
    }
    const float2 m = drop ? ld2(drop + ((size_t)b * T + t) * C + col) : make_float2(1.f, 1.f);
    v0 = (v0 + __ldg(b1 + col)) * m.x + XC[row * LDA + col];
    v1 = (v1 + __ldg(b1 + col + 1)) * m.y + XC[row * LDA + col + 1];
  });
}

// One row tile of a layer: rows [t0, t0 + TM) of video b (shared memory:
// Tile<C, TM>::TAPS_SMEM bytes at smem).  The layer input x is read through
// `cp.async` (L2) only, so a cooperative kernel may read rows that other CTAs
// wrote earlier in the same launch.  BF: the bf16-operand mode.
template <int C, int TM, bool BF = false>
__device__ __forceinline__ void layer_tile(
    const float* __restrict__ x,      // [B, T, C] layer input (masked)
    float* __restrict__ y,            // [B, T or T/2, C] layer output
    float* __restrict__ u_out,        // [B, T, C] pre-pool output or null
    float* __restrict__ hs,           // [B, T, C] stash: nonlin(z), or null
    const int* __restrict__ lengths,  // [B] input frame counts
    const float* __restrict__ w3,     // [3, C, C]: taps -d, 0, +d
    const float* __restrict__ b3,     // [C]
    const float* __restrict__ w1,     // [C, C]
    const float* __restrict__ b1,     // [C]
    const float* __restrict__ drop,   // [B, T, C] dropout mask or null
    int b, int t0, int T, int d, int len_shift, int pool, int pool_mean, int leaky,
    float* smem) {
  using TL = Tile<C, TM>;
  constexpr int LDA = TL::LDA;
  float* X0 = smem;               // t-d, then nonlin(z)
  float* XC = X0 + TL::TILE_F;    // t (A operand and residual)
  float* X1 = XC + TL::TILE_F;    // t+d
  float* Wr = X1 + TL::TILE_F;    // [2][KC][LDW] weight ring

  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {  // all padding: zeros, nothing staged or multiplied
    if (pool) store_zeros<C>(y, b, t0 / 2, TM / 2, T / 2);
    else store_zeros<C>(y, b, t0, TM, T);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);
  const float* xb = x + (size_t)b * T * C;
  const int lim = min(T, len);
  const bool first = t0 + TM > d, last = t0 + d < lim;  // some row has x[t-d], x[t+d]

  if (first) stage_rows<C, TM>(X0, xb, t0 - d, lim);
  stage_rows<C, TM>(XC, xb, t0, lim);
  if (last) stage_rows<C, TM>(X1, xb, t0 + d, lim);

  float acc[TL::MT][TL::NTL][4] = {};
  float* const taps[3] = {X0, XC, X1};
  const float* const ws[4] = {w3, w3 + C * C, w3 + 2 * C * C, w1};
  tap_loop<C, TM, TL::KC, TL::KC, BF>(acc, taps, ws, first, last, Wr, row0, col0, lane,
                                      [&](auto& a) {
    // h = nonlin(z + b3): over the t-d tile as the 1x1's A, and to the stash
    for_each_pair(a, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
      const float h0 = nonlin(v0 + __ldg(b3 + col), leaky);
      const float h1 = nonlin(v1 + __ldg(b3 + col + 1), leaky);
      X0[row * LDA + col] = h0;
      X0[row * LDA + col + 1] = h1;
      if (hs && t0 + row < lim) st2(hs + ((size_t)b * T + t0 + row) * C + col, h0, h1);
      v0 = v1 = 0.f;
    });
  });

  // y = mask (m * (acc + b1) + x): the t tile is only read
  residual<C>(acc, XC, b1, drop, b, T, t0, lim, row0, col0, lane);
  if (!pool) {
    for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < T) st2(y + ((size_t)b * T + t0 + row) * C + col, v0, v1);
    });
    return;
  }
  if (u_out)
    for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < lim) st2(u_out + ((size_t)b * T + t0 + row) * C + col, v0, v1);
    });
  store_pooled<C>(y, acc, b, t0, T, len, row0, col0, lane, pool_mean);
}

// z = mask(nonlin(x) Wl + bl) for rows [t0, t0 + TM) of video b: the
// out-projection (Tile<C, TM>::ONE_SMEM bytes: one row tile, nonlin applied in
// place once it has landed, and the weight ring; BF: the bf16-operand mode)
template <int C, int TM, bool BF = false>
__device__ __forceinline__ void proj_tile(const float* __restrict__ x, float* __restrict__ z,
                                          const int* __restrict__ lengths,
                                          const float* __restrict__ w_last,
                                          const float* __restrict__ b_last, int b, int t0,
                                          int T, int len_shift, int leaky, float* smem) {
  using TL = Tile<C, TM>;
  constexpr int LDA = TL::LDA;
  float* XC = smem;                // [TM][LDA]
  float* Wr = XC + TL::TILE_F;     // [2][KC][LDW]

  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    store_zeros<C>(z, b, t0, TM, T);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);

  stage_rows<C, TM>(XC, x + (size_t)b * T * C, t0, min(T, len));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < TM * C; i += NT) {  // nonlin in place
    float* p = XC + (i / C) * LDA + i % C;
    *p = nonlin(*p, leaky);
  }
  float acc[TL::MT][TL::NTL][4] = {};
  float* const tiles[3] = {XC, XC, XC};
  const float* const ws[4] = {nullptr, w_last, nullptr, nullptr};  // one block, as a centre tap
  tap_loop<C, TM, TL::KC, TL::KC, BF>(acc, tiles, ws, false, false, Wr, row0, col0, lane,
                                       [](auto&) {});
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    if (t < T)
      st2(z + ((size_t)b * T + t) * C + col, t < len ? v0 + __ldg(b_last + col) : 0.f,
          t < len ? v1 + __ldg(b_last + col + 1) : 0.f);
  });
}

template <int C, int TM, bool BF>
__global__ void __launch_bounds__(NT, Tile<C, TM>::MIN_BLOCKS) wavenet_layer_kernel(
    const float* __restrict__ x, float* __restrict__ y, float* __restrict__ u_out,
    float* __restrict__ hs, const int* __restrict__ lengths, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ drop, int T, int d, int len_shift, int pool, int pool_mean,
    int leaky) {
  extern __shared__ float4 smem4[];
  layer_tile<C, TM, BF>(x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, blockIdx.y,
                     blockIdx.x * TM, T, d, len_shift, pool, pool_mean, leaky,
                     reinterpret_cast<float*>(smem4));
}

// one layer of B videos x T frames on TM-row tiles (BF: the bf16-operand mode)
template <int C, int TM, bool BF = false>
cudaError_t launch_layer(const float* x, float* y, float* u_out, float* hs, const int* lengths,
                         const float* w3, const float* b3, const float* w1, const float* b1,
                         const float* drop, int B, int T, int d, int len_shift, int pool,
                         int pool_mean, int leaky, cudaStream_t stream) {
  constexpr int smem = Tile<C, TM>::TAPS_SMEM;
  cudaError_t err = cudaFuncSetAttribute(wavenet_layer_kernel<C, TM, BF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wavenet_layer_kernel<C, TM, BF><<<dim3((T + TM - 1) / TM, B), NT, smem, stream>>>(
      x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, T, d, len_shift, pool, pool_mean, leaky);
  return cudaGetLastError();
}

}  // namespace
