// Fused MS-TCN++ first stage (eval) on the tensor cores, one launch per
// dual-dilation layer plus one for the out-projection, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_mstcnpp_kernel` / `mstcnpp_stack_pallas`
// (mucon_tpu/ops/mstcnpp_pallas.py:72, :151).  That kernel kept the whole
// [B x T x C] batch in VMEM and ran all layers in one program; here a CTA owns
// TM = 64 output rows of one video x all C = 128 channels of one layer.
// Layer i (d1 = 2^(L-1-i), d2 = 2^i):
//
//   y1 = f[t-d1] W3a[0] + f[t] W3a[1] + f[t+d1] W3a[2] + b3a
//   y2 = f[t-d2] W3b[0] + f[t] W3b[1] + f[t+d2] W3b[2] + b3b
//   f' = relu(y1 W1t + y2 W1b + b1) + f[t], zeroed at t >= length
//   pool layers: max of row pairs, zeroed at t/2 >= length/2
//
// The out-projection launch computes f Wout + bout with NO nonlinearity
// (unlike WaveNet's), masked.
//
// Design.  A layer is eight [TM x C] x [C x C] products whose weights the
// caller passes as one [8C x C] matrix (W3a, W3b, W1t, W1b stacked), so the
// kernel is one k-loop over 8C weight rows in chunks of KC = 64:
//
// * Tensor cores with f32 parity: every product is `mma.sync.m16n8k8` TF32 on
//   hi/lo-split operands, three products per f32 product (mma_tf32.cuh).
//   The split is taken as a fragment leaves shared memory: the tiles stay
//   f32, so a weight chunk costs half the shared memory and L2 traffic of a
//   pre-split one.  8 warps as 2 x 4, each a 32-row x 32-column output block
//   (2 x 4 fragments, 32 accumulators): the shape that loads and splits the
//   fewest fragment elements per `mma` (16 for 24).
// * Padding is skipped: a CTA whose first row is at or past the video's
//   length writes its zeros and returns before staging anything.
// * Three row tiles, not five: t-d1, t, t+d1 are staged first; the t-d1 tile
//   is refilled with t-d2 once its 128 weight rows are consumed, the t+d1
//   tile with t+d2 likewise, both by `cp.async` many chunks before their
//   use.  y1 waits in registers during the d2 conv; then y1 and y2 overwrite
//   the two outer tiles and re-enter as A operands of the 1x1.
// * Overlap: weight chunks (and the refills) arrive by `cp.async` into a ring
//   of STAGES = 2 buffers, the next chunk in flight while this one is
//   multiplied; one `__syncthreads` per chunk (16 a layer: on the H100,
//   chunks of 32 rows cost 0.35 ms more per stage call, a deeper ring bought
//   nothing).
// * Taps outside [0, T) or past the video's length are zero-filled by the
//   copy itself, so d >= T (d = 512, 1024 at T = 160) needs no special case.
//
// Shared memory per CTA: three row tiles of TM x (C + 4) floats (99 KiB; the
// stride keeps A-fragment loads conflict-free) and two KC x (C + 8) weight
// buffers (68 KiB) = 167 KiB: one CTA of 8 warps per SM.  The out-projection
// holds one row tile and the ring (101 KiB).
//
// Bound: the tensor cores at three TF32 products per f32 product (16 C^2
// f32 operations per valid row and layer).
//
// bf16 = 1 launches the bf16-operand mode (the JAX kernel's
// `mm_dtype=bfloat16`, mstcnpp_pallas.py:60-96): the same kernels with every
// product's operands rounded to bf16 as their fragments leave the f32 tiles
// and one bf16 `mma.sync.m16n8k16` a 16-deep k-step (mma_tf32.cuh); sums,
// biases, residual, mask and pool stay f32.  Bound by the dense bf16 rate.
//
// The #define knobs below are for `scripts/probe_mstcnpp_variants.py`, which
// times other tilings; the defaults are what ships.

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int C = 128;                  // channels (the model's hidden_size)
#ifndef MSTCNPP_TM
#define MSTCNPP_TM 64
#endif
constexpr int TM = MSTCNPP_TM;          // pre-pool output rows per CTA
#ifndef MSTCNPP_MT
#define MSTCNPP_MT 2
#endif
#ifndef MSTCNPP_KC
#define MSTCNPP_KC 64
#endif
constexpr int MT = MSTCNPP_MT, NTL = 4;  // 16 x 8 fragments per warp
constexpr int WM = TM / (16 * MT), WN = 128 / (8 * NTL);  // warps along rows, columns
constexpr int NT = 32 * WM * WN;        // threads per CTA
constexpr int KC = MSTCNPP_KC;          // weight rows per chunk
#ifndef MSTCNPP_STAGES
#define MSTCNPP_STAGES 2
#endif
#ifndef MSTCNPP_SKIP_PADDING
#define MSTCNPP_SKIP_PADDING 1
#endif
// (MSTCNPP_SKIP_PADDING 0 multiplies the all-padding tiles too)
constexpr int STAGES = MSTCNPP_STAGES;  // weight ring depth
constexpr int LDA = C + 4;              // row tile stride (floats)
constexpr int LDW = C + 8;              // weight chunk stride (floats)
constexpr int TILE_F = TM * LDA;
constexpr int WBUF_F = KC * LDW;
constexpr int LAYER_SMEM = (3 * TILE_F + STAGES * WBUF_F) * 4;
constexpr int PROJ_SMEM = (TILE_F + STAGES * WBUF_F) * 4;
constexpr int LAYER_CHUNKS = 8 * C / KC;  // 8 [C x C] blocks
constexpr int PROJ_CHUNKS = C / KC;
constexpr int CPB = C / KC;               // chunks per [C x C] block

static_assert(C % KC == 0 && KC % 8 == 0 && TM == 16 * MT * WM && C == 8 * NTL * WN, "tiling");
static_assert(LDA % 32 == 4 && LDW % 32 == 8 && STAGES >= 2, "bank-conflict-free strides");

// KC weight rows (row-major, C wide) into one ring buffer
__device__ __forceinline__ void stage_weights(float* Wb, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < KC * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    cp_async16(Wb + r * LDW + 4 * c4, w + (size_t)r * C + 4 * c4, true);
  }
}

// rows t_first .. t_first + TM of one video into a row tile; zeros outside [0, lim)
__device__ __forceinline__ void stage_rows(float* X, const float* __restrict__ fb,
                                           int t_first, int lim) {
  for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    const int t = t_first + r;
    const bool ok = t >= 0 && t < lim;
    cp_async16(X + r * LDA + 4 * c4, fb + (size_t)(ok ? t : 0) * C + 4 * c4, ok);
  }
}

// the tile's output rows from a finished row tile V (rows >= len already
// zero); with `pool` the max of row pairs, zeroed at t/2 >= len/2.  V null
// writes zeros (a tile past the video's length).
__device__ __forceinline__ void store_rows(float* __restrict__ y, const float* V, int b,
                                           int t0, int T, int len, int pool) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!pool) {
    for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
      const int r = i / (C / 4), c4 = i % (C / 4);
      const int t = t0 + r;
      if (t >= T) break;
      reinterpret_cast<float4*>(y + ((size_t)b * T + t) * C)[c4] =
          V ? reinterpret_cast<const float4*>(V + r * LDA)[c4] : zero;
    }
    return;
  }
  const int T2 = T / 2, len2 = len >> 1;
  for (int i = threadIdx.x; i < (TM / 2) * (C / 4); i += NT) {
    const int r2 = i / (C / 4), c4 = i % (C / 4);
    const int t2 = (t0 >> 1) + r2;
    if (t2 >= T2) break;
    float4 p = zero;
    if (V && t2 < len2) {
      const float4 a = reinterpret_cast<const float4*>(V + (2 * r2) * LDA)[c4];
      const float4 c = reinterpret_cast<const float4*>(V + (2 * r2 + 1) * LDA)[c4];
      p = make_float4(fmaxf(a.x, c.x), fmaxf(a.y, c.y), fmaxf(a.z, c.z), fmaxf(a.w, c.w));
    }
    reinterpret_cast<float4*>(y + ((size_t)b * T2 + t2) * C)[c4] = p;
  }
}

// visits the accumulator elements of this thread: fn(acc element, row, col)
template <typename Fn>
__device__ __forceinline__ void for_each_acc(float (&acc)[MT][NTL][4], int row0, int col0,
                                             int lane, Fn fn) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(acc[mt][nt][e], row0 + 16 * mt + (lane >> 2) + 8 * (e >> 1),
           col0 + 8 * nt + 2 * (lane & 3) + (e & 1));
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) mstcnpp_layer_kernel(
    const float* __restrict__ f,        // [B, T, C] layer input (masked)
    float* __restrict__ y,              // [B, T or T/2, C] layer output
    const int* __restrict__ lengths,    // [B] input frame counts
    const float* __restrict__ w,        // [8C, C]: W3a [3C], W3b [3C], W1t [C], W1b [C]
    const float* __restrict__ b3a,      // [C]
    const float* __restrict__ b3b,      // [C]
    const float* __restrict__ b1,       // [C]
    int T, int d1, int d2, int len_shift, int pool) {
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // t-d1, then t-d2, then y1
  float* XC = X0 + TILE_F;                       // t, then the output rows
  float* X1 = XC + TILE_F;                       // t+d1, then t+d2, then y2
  float* Wr = X1 + TILE_F;                       // [STAGES][KC][LDW] weight ring

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (MSTCNPP_SKIP_PADDING && t0 >= len) {  // all padding: zeros, nothing staged or multiplied
    store_rows(y, nullptr, b, t0, T, len, pool);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / WN) * (16 * MT), col0 = (warp % WN) * (8 * NTL);
  const float* fb = f + (size_t)b * T * C;
  const int lim = min(T, len);

  stage_rows(X0, fb, t0 - d1, lim);
  stage_rows(XC, fb, t0, lim);
  stage_rows(X1, fb, t0 + d1, lim);
  for (int s = 0; s < STAGES - 1; ++s) {
    stage_weights(Wr + s * WBUF_F, w + (size_t)s * KC * C);
    cp_async_commit();
  }

  float acc[MT][NTL][4] = {}, y1[MT][NTL][4];
  for (int c = 0; c < LAYER_CHUNKS; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c (and what was staged with it) has landed
    __syncthreads();              // ... for every thread; chunk c - 1 is consumed
    const int nc = c + STAGES - 1;
    if (nc < LAYER_CHUNKS) stage_weights(Wr + (nc % STAGES) * WBUF_F, w + (size_t)nc * KC * C);
    if (c == CPB) stage_rows(X0, fb, t0 - d2, lim);      // W3a[0] done with t-d1
    if (c == 3 * CPB) stage_rows(X1, fb, t0 + d2, lim);  // W3a[2] done with t+d1
    cp_async_commit();

    // block 0..7 of the weight rows: taps -d, 0, +d of each conv, then y1, y2
    const int blk = c / CPB;
    const float* A = (blk == 1 || blk == 4) ? XC : (blk % 3 == 0 ? X0 : X1);
    warp_gemm<MT, NTL, KC, false, BF>(acc, A, LDA, row0, (c % CPB) * KC,
                                      Wr + (c % STAGES) * WBUF_F, LDW, col0, lane);

    if (c == 3 * CPB - 1) {  // y1 complete: it waits in registers
      for_each_acc(acc, row0, col0, lane, [&](float& v, int, int col) { v += __ldg(b3a + col); });
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y1[mt][nt][e] = acc[mt][nt][e];
            acc[mt][nt][e] = 0.f;
          }
    }
    if (c == 6 * CPB - 1) {  // y2 complete: y1 and y2 become the 1x1's A tiles
      __syncthreads();       // every warp is done with t-d2 and t+d2
      for_each_acc(y1, row0, col0, lane, [&](float& v, int row, int col) {
        X0[row * LDA + col] = v;
      });
      for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
        X1[row * LDA + col] = v + __ldg(b3b + col);
        v = 0.f;
      });
    }
  }

  // relu, residual and mask, in place over the center tile (one owner an element)
  for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
    float* x = XC + row * LDA + col;
    *x = t0 + row < len ? fmaxf(v + __ldg(b1 + col), 0.f) + *x : 0.f;
  });
  __syncthreads();
  store_rows(y, XC, b, t0, T, len, pool);
}

// z = mask(f Wout + bout): the out-projection, no nonlinearity
template <bool BF>
__global__ void __launch_bounds__(NT, 1) mstcnpp_proj_kernel(
    const float* __restrict__ f, float* __restrict__ z, const int* __restrict__ lengths,
    const float* __restrict__ w_out, const float* __restrict__ b_out, int T, int len_shift) {
  extern __shared__ float4 smem4[];
  float* XC = reinterpret_cast<float*>(smem4);  // [TM][LDA]
  float* Wr = XC + TILE_F;                       // [STAGES][KC][LDW]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (MSTCNPP_SKIP_PADDING && t0 >= len) {
    store_rows(z, nullptr, b, t0, T, len, 0);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / WN) * (16 * MT), col0 = (warp % WN) * (8 * NTL);

  stage_rows(XC, f + (size_t)b * T * C, t0, min(T, len));
  for (int s = 0; s < STAGES - 1; ++s) {
    stage_weights(Wr + s * WBUF_F, w_out + (size_t)s * KC * C);
    cp_async_commit();
  }
  float acc[MT][NTL][4] = {};
  for (int c = 0; c < PROJ_CHUNKS; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nc = c + STAGES - 1;
    if (nc < PROJ_CHUNKS) stage_weights(Wr + (nc % STAGES) * WBUF_F, w_out + (size_t)nc * KC * C);
    cp_async_commit();
    warp_gemm<MT, NTL, KC, false, BF>(acc, XC, LDA, row0, c * KC, Wr + (c % STAGES) * WBUF_F,
                                      LDW, col0, lane);
  }
  __syncthreads();  // every warp is done reading the input rows
  for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
    XC[row * LDA + col] = t0 + row < len ? v + __ldg(b_out + col) : 0.f;
  });
  __syncthreads();
  store_rows(z, XC, b, t0, T, len, 0);
}

template <bool BF>
int mstcnpp_layer(const float* f, float* y, const int* lengths, const float* w,
                  const float* b3a, const float* b3b, const float* b1, int B, int T, int d1,
                  int d2, int len_shift, int pool, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mstcnpp_layer_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, LAYER_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TM - 1) / TM, B);
  mstcnpp_layer_kernel<BF><<<grid, NT, LAYER_SMEM, stream>>>(f, y, lengths, w, b3a, b3b, b1, T,
                                                             d1, d2, len_shift, pool);
  return cudaGetLastError();
}

template <bool BF>
int mstcnpp_proj(const float* f, float* z, const int* lengths, const float* w_out,
                 const float* b_out, int B, int T, int len_shift, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mstcnpp_proj_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, PROJ_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TM - 1) / TM, B);
  mstcnpp_proj_kernel<BF><<<grid, NT, PROJ_SMEM, stream>>>(f, z, lengths, w_out, b_out, T,
                                                           len_shift);
  return cudaGetLastError();
}

}  // namespace

// rows a CTA of the stage's kernels owns (a tile past a video's length is skipped)
extern "C" int mucon_mstcnpp_tile_rows() { return TM; }

// One dual-dilation layer (d1, d2); `w` is the layer's [8C, C] weight matrix
// (W3a, W3b, W1t, W1b stacked).  T must be even when pool = 1.  bf16 = 1: the
// bf16-operand mode.
extern "C" int mucon_mstcnpp_layer(const float* f, float* y, const int* lengths,
                                   const float* w, const float* b3a, const float* b3b,
                                   const float* b1, int B, int T, int channels, int d1,
                                   int d2, int len_shift, int pool, int bf16,
                                   cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && (T % 2))) return cudaErrorInvalidValue;
  if (bf16)
    return mstcnpp_layer<true>(f, y, lengths, w, b3a, b3b, b1, B, T, d1, d2, len_shift, pool,
                               stream);
  return mstcnpp_layer<false>(f, y, lengths, w, b3a, b3b, b1, B, T, d1, d2, len_shift, pool,
                              stream);
}

// The out-projection z = mask(f Wout + bout).  bf16 = 1: the bf16-operand mode.
extern "C" int mucon_mstcnpp_proj(const float* f, float* z, const int* lengths,
                                  const float* w_out, const float* b_out, int B, int T,
                                  int channels, int len_shift, int bf16, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (bf16) return mstcnpp_proj<true>(f, z, lengths, w_out, b_out, B, T, len_shift, stream);
  return mstcnpp_proj<false>(f, z, lengths, w_out, b_out, B, T, len_shift, stream);
}
