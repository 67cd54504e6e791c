// Fused WaveNet eval stack on the tensor cores, one launch per residual layer
// (plus one for the out-projection), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_stack_kernel_v2` / `wavenet_stack_pallas_v2`
// (mucon_tpu/ops/wavenet_pallas_v2.py:67, :151).  That kernel kept the whole
// [B x T x C] batch in VMEM and ran all layers in one program; here a CTA owns
// TM = 64 output rows of one video x all C = 128 channels of one layer:
//
//   z = x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3   ([TM,3C] @ [3C,C])
//   y = nonlin(z) W1 + b1 + x[t], zeroed at t >= length
//   pool layers: max (or mean * 2) of row pairs, zeroed at t/2 >= length/2
//
// The out-projection launch (final_proj = 1) computes nonlin(x) Wl + bl,
// masked.
//
// Design (the recipe of the MS-TCN++ stage, csrc/mstcnpp.cu):
//
// * Tensor cores with f32 parity: every product is `mma.sync.m16n8k8` TF32 on
//   hi/lo-split operands, three products per f32 product (mma_tf32.cuh).  The
//   tiles stay f32 in shared memory and a fragment is split as it leaves.
//   8 warps as 2 x 4, each a 32-row x 32-column output block.
// * One k-loop: the layer's [3C x C] conv and its [C x C] 1x1 are 4C weight
//   rows streamed in chunks of KC = 64 through a `cp.async` ring of two
//   buffers, the next chunk in flight while this one is multiplied (one
//   `__syncthreads` a chunk).  The three tap tiles t-d, t, t+d are staged by
//   `cp.async`, zero-filled where the row lies outside [0, T) or past the
//   video's length, so d >= T (d = 512, 1024 at T = 160) needs no special
//   case.  nonlin(z + b3) overwrites the t-d tile, read last two chunks
//   before, and re-enters as the 1x1's A operand.
// * Padding is skipped: a CTA whose first row is at or past the video's
//   length writes its zeros (pooled rows where it pools) and returns before
//   staging anything.
// * The epilogue stays in the accumulators: bias, the residual from the t
//   tile, the mask, and the pool of row pairs.  In the m16n8k8 C layout lane
//   l holds rows l / 4 and l / 4 + 8, so rows 2k and 2k + 1 sit in lanes l
//   and l ^ 4: one `__shfl_xor_sync` pairs them and the even row's lane
//   stores the max (or the mean * 2, rounded as the f32 twin rounds it).
//
// Shared memory per CTA: three row tiles of TM x (C + 4) floats (99 KiB; the
// stride keeps A-fragment loads conflict-free) and two KC x (C + 8) weight
// buffers (68 KiB) = 167 KiB: one CTA of 8 warps per SM.  The out-projection
// holds one row tile and the ring (101 KiB).
//
// Bound: the tensor cores at three TF32 products per f32 product (8 C^2 f32
// operations per valid row and layer, 2 C^2 for the out-projection).

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int C = 128;                  // channels (the model's hidden_size)
constexpr int TM = 64;                  // pre-pool output rows per CTA
constexpr int MT = 2, NTL = 4;          // 16 x 8 fragments per warp
constexpr int WM = TM / (16 * MT), WN = C / (8 * NTL);  // warps along rows, columns
constexpr int NT = 32 * WM * WN;        // threads per CTA (256)
constexpr int KC = 64;                  // weight rows per chunk
constexpr int STAGES = 2;               // weight ring depth
constexpr int LDA = C + 4;              // row tile stride (floats)
constexpr int LDW = C + 8;              // weight chunk stride (floats)
constexpr int TILE_F = TM * LDA;
constexpr int WBUF_F = KC * LDW;
constexpr int LAYER_SMEM = (3 * TILE_F + STAGES * WBUF_F) * 4;
constexpr int PROJ_SMEM = (TILE_F + STAGES * WBUF_F) * 4;
constexpr int CPB = C / KC;             // chunks per [C x C] block
constexpr int CONV_CHUNKS = 3 * CPB;    // the k = 3 conv
constexpr int LAYER_CHUNKS = 4 * CPB;   // and the 1x1

static_assert(C % KC == 0 && KC % 8 == 0 && TM == 16 * MT * WM && C == 8 * NTL * WN, "tiling");
static_assert(LDA % 32 == 4 && LDW % 32 == 8, "bank-conflict-free strides");
static_assert(TM % 2 == 0, "row pairs of a pool lie in one tile");

__device__ __forceinline__ float nonlin(float v, int leaky) {
  return leaky ? (v > 0.f ? v : 0.01f * v) : fmaxf(v, 0.f);
}

// KC weight rows (row-major, C wide) into one ring buffer
__device__ __forceinline__ void stage_weights(float* Wb, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < KC * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    cp_async16(Wb + r * LDW + 4 * c4, w + (size_t)r * C + 4 * c4, true);
  }
}

// rows t_first .. t_first + TM of one video into a row tile; zeros outside [0, lim)
__device__ __forceinline__ void stage_rows(float* X, const float* __restrict__ xb,
                                           int t_first, int lim) {
  for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    const int t = t_first + r;
    const bool ok = t >= 0 && t < lim;
    cp_async16(X + r * LDA + 4 * c4, xb + (size_t)(ok ? t : 0) * C + 4 * c4, ok);
  }
}

// zeros for the output rows of a tile past the video's length
__device__ __forceinline__ void store_zeros(float* __restrict__ y, int b, int t0, int T,
                                            int pool) {
  const int rows = pool ? TM / 2 : TM, first = pool ? t0 / 2 : t0, Tout = pool ? T / 2 : T;
  for (int i = threadIdx.x; i < rows * (C / 4); i += NT) {
    const int t = first + i / (C / 4);
    if (t >= Tout) break;
    reinterpret_cast<float4*>(y + ((size_t)b * Tout + t) * C)[i % (C / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Writes the finished accumulators (bias, residual and mask already in):
// rows t0 + row < T as they are, or with `pool` the pairs (2k, 2k + 1)
// pooled by one shuffle, zeroed at t/2 >= len/2.
__device__ __forceinline__ void store_acc(float* __restrict__ y, float (&acc)[MT][NTL][4],
                                          int b, int t0, int T, int len, int row0, int col0,
                                          int lane, int pool, int pool_mean) {
  const int g = lane >> 2;
  if (!pool) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + row0 + 16 * mt + g + 8 * h;
        if (t >= T) continue;
        float* yr = y + ((size_t)b * T + t) * C + col0 + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
          *reinterpret_cast<float2*>(yr + 8 * nt) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    return;
  }
  const int T2 = T / 2, len2 = len >> 1;
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
        *reinterpret_cast<float2*>(yr + 8 * nt) =
            t2 < len2 ? make_float2(p[nt][0], p[nt][1]) : make_float2(0.f, 0.f);
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

__global__ void __launch_bounds__(NT, 1) wavenet_layer_kernel(
    const float* __restrict__ x,        // [B, T, C] layer input
    float* __restrict__ y,              // [B, T or T/2, C] layer output
    const int* __restrict__ lengths,    // [B] input frame counts
    const float* __restrict__ w3,       // [3C, C]: taps -d, 0, +d
    const float* __restrict__ b3,       // [C]
    const float* __restrict__ w1,       // [C, C]
    const float* __restrict__ b1,       // [C]
    int T, int d, int len_shift, int pool, int pool_mean, int leaky) {
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // t-d, then nonlin(z)
  float* XC = X0 + TILE_F;                       // t (A operand and residual)
  float* X1 = XC + TILE_F;                       // t+d
  float* Wr = X1 + TILE_F;                       // [STAGES][KC][LDW] weight ring

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {  // all padding: zeros, nothing staged or multiplied
    store_zeros(y, b, t0, T, pool);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / WN) * (16 * MT), col0 = (warp % WN) * (8 * NTL);
  const float* xb = x + (size_t)b * T * C;
  const int lim = min(T, len);

  stage_rows(X0, xb, t0 - d, lim);
  stage_rows(XC, xb, t0, lim);
  stage_rows(X1, xb, t0 + d, lim);
  stage_weights(Wr, w3);
  cp_async_commit();

  float acc[MT][NTL][4] = {};
  for (int c = 0; c < LAYER_CHUNKS; ++c) {
    cp_async_wait<0>();  // chunk c (and the row tiles) have landed
    __syncthreads();     // ... for every thread; chunk c - 1 is consumed
    const int nc = c + 1;
    if (nc < LAYER_CHUNKS)
      stage_weights(Wr + (nc % STAGES) * WBUF_F,
                    nc < CONV_CHUNKS ? w3 + (size_t)nc * KC * C
                                     : w1 + (size_t)(nc - CONV_CHUNKS) * KC * C);
    cp_async_commit();

    const int blk = c / CPB;  // taps -d, 0, +d, then nonlin(z)
    const float* A = blk == 1 ? XC : (blk == 2 ? X1 : X0);
    warp_gemm<MT, NTL, KC>(acc, A, LDA, row0, (c % CPB) * KC, Wr + (c % STAGES) * WBUF_F, LDW,
                           col0, lane);

    if (c == CONV_CHUNKS - 1) {  // z complete; every warp is done with t-d (chunk CPB - 1)
      for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
        X0[row * LDA + col] = nonlin(v + __ldg(b3 + col), leaky);
        v = 0.f;
      });
    }
  }

  // bias, residual and mask in the accumulators (the t tile is only read)
  for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
    v = t0 + row < len ? (v + __ldg(b1 + col)) + XC[row * LDA + col] : 0.f;
  });
  store_acc(y, acc, b, t0, T, len, row0, col0, lane, pool, pool_mean);
}

// z = mask(nonlin(x) Wl + bl): the out-projection
__global__ void __launch_bounds__(NT, 1) wavenet_proj_kernel(
    const float* __restrict__ x, float* __restrict__ z, const int* __restrict__ lengths,
    const float* __restrict__ w_last, const float* __restrict__ b_last, int T, int len_shift,
    int leaky) {
  extern __shared__ float4 smem4[];
  float* XC = reinterpret_cast<float*>(smem4);  // [TM][LDA]
  float* Wr = XC + TILE_F;                       // [STAGES][KC][LDW]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    store_zeros(z, b, t0, T, 0);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / WN) * (16 * MT), col0 = (warp % WN) * (8 * NTL);

  stage_rows(XC, x + (size_t)b * T * C, t0, min(T, len));
  cp_async_commit();
  stage_weights(Wr, w_last);
  cp_async_commit();
  cp_async_wait<1>();  // the rows have landed (the first chunk may be in flight)
  __syncthreads();
  for (int i = threadIdx.x; i < TM * C; i += NT) {  // nonlin in place
    float* p = XC + (i / C) * LDA + i % C;
    *p = nonlin(*p, leaky);
  }
  float acc[MT][NTL][4] = {};
  for (int c = 0; c < CPB; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < CPB) stage_weights(Wr + ((c + 1) % STAGES) * WBUF_F, w_last + (size_t)(c + 1) * KC * C);
    cp_async_commit();
    warp_gemm<MT, NTL, KC>(acc, XC, LDA, row0, c * KC, Wr + (c % STAGES) * WBUF_F, LDW, col0,
                           lane);
  }
  for_each_acc(acc, row0, col0, lane, [&](float& v, int row, int col) {
    v = t0 + row < len ? v + __ldg(b_last + col) : 0.f;
  });
  store_acc(z, acc, b, t0, T, len, row0, col0, lane, 0, 0);
}

}  // namespace

// rows a CTA of the stack's kernels owns (a tile past a video's length is skipped)
extern "C" int mucon_wavenet_tile_rows() { return TM; }

// One layer of the stack (final_proj = 0) or the out-projection
// (final_proj = 1, w1/b1 = Wl/bl; w3/b3 unused).  T must be even when pool = 1.
extern "C" int mucon_wavenet_layer(const float* x, float* y, const int* lengths,
                                   const float* w3, const float* b3,
                                   const float* w1, const float* b1, int B, int T,
                                   int channels, int d, int len_shift, int pool,
                                   int pool_mean, int leaky, int final_proj,
                                   cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && (T % 2)) || (final_proj && pool))
    return cudaErrorInvalidValue;
  const dim3 grid((T + TM - 1) / TM, B);
  cudaError_t err;
  if (final_proj) {
    err = cudaFuncSetAttribute(wavenet_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PROJ_SMEM);
    if (err != cudaSuccess) return err;
    wavenet_proj_kernel<<<grid, NT, PROJ_SMEM, stream>>>(x, y, lengths, w1, b1, T, len_shift,
                                                         leaky);
  } else {
    err = cudaFuncSetAttribute(wavenet_layer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LAYER_SMEM);
    if (err != cudaSuccess) return err;
    wavenet_layer_kernel<<<grid, NT, LAYER_SMEM, stream>>>(x, y, lengths, w3, b3, w1, b1, T, d,
                                                           len_shift, pool, pool_mean, leaky);
  }
  return cudaGetLastError();
}
