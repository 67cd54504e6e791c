// The trainable stack's kernels above C = 512 channels ("wide bodies"),
// for NVIDIA Hopper (sm_90a): its forward and sweep (v3, one launch a layer;
// v2, one cooperative launch a chunk of layers) and its out-projection, each
// in 3xTF32 and in the bf16-operand mode.  C is a runtime argument, a
// multiple of the 128-column slab (the wrappers zero-pad another C to it,
// `cuda.stack_width`): one instance a mode, whatever the width.  The eval
// stacks above 512 (WaveNet and MS-TCN++) run on wavenet_wgmma.cu's `wgmma`
// body; these keep `wide_gemm`, because the v2 sweep recomputes a pooled
// layer's u with pass 2 and must repeat the forward's bits.
//
// Replaces the same TPU kernels as the 128 / 256 / 512 instances
// (wavenet_train.cu, wavenet_train_v2.cu): the
// JAX kernels check no C, only bytes a video, so at a short T they take any
// width.  Those instances hold all C columns of three row tiles in shared
// memory, which at C = 1024 is 64 KiB a 16-row tile; here a residual layer
// is two GEMM-shaped passes over tiles of WTM = 64 rows x WNC = 128 output
// columns, both operands streamed through shared memory in chunks:
//
//   pass 1:  h = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)  -> h
//   pass 2:  u = mask(m (h W1 + b1) + x);  y = u, or its pool (u -> u_out)
//   proj:    z = mask(nonlin(x) Wl + bl)
//
// and the sweep, one layer:
//
//   dy:   dy = mask(g, or g routed through the pool by u) m   (elementwise)
//   dz:   dz = (dy W1^T) nonlin'(h)
//   dx:   g_in = mask(dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   wgrad, reduce: wavenet_sweep.cuh's bodies at the runtime width
//
// Design.  `wide_gemm` streams KC = WKC = 32 k-rows of A (the tile's rows of
// each tap, at the tap's row offset, zero outside [0, min(T, len))) and of
// the weights' 128-column slab through a 2-deep `cp.async` ring; 8 warps as
// 2 x 4 of 32 x 32 outputs (the C = 128 tile's warp shape); every product
// `mma.sync.m16n8k8` on hi/lo-split TF32 (mma_tf32.cuh), each 32-row
// chunk's hi x hi products a fresh partial added in f32 one chunk later and
// the small products a sum of their own, as `tap_loop`'s.  So an element's
// sum depends on KC = 32 and not on the tile or the slab.  The epilogues
// are the narrow kernels' in the accumulators' layout (rows 2k, 2k + 1 of a
// pool in lanes l, l ^ 4, paired by one shuffle; max keeps the first of a
// tie; u written from the registers pooled).  A tile at or past its video's
// length writes its zeros and returns; a tap no row of the tile has is
// skipped (products of zeros).  Every read of a buffer written earlier in
// the same launch (the v2 kernels) goes through L2 (`cp.async.cg`,
// `__ldcg`).
//
// v2 runs the same bodies in one cooperative launch a chunk, with a grid
// barrier between passes, and recomputes each pooled layer's u with pass 2
// from the stash: z and every gradient equal v3's bit for bit.
//
// Shared memory: 2 x (64 x 36 + 32 x 136) floats = 52 KiB a tile CTA; the
// weight-gradient CTAs are wavenet_sweep.cuh's (68 KiB).
//
// Bound: the tensor cores, at three TF32 products per f32 product (495 / 3
// TFLOP/s) or the dense bf16 rate; 8 C^2 f32 operations per valid row and
// layer forward, 16 C^2 backward.  The h buffer between the passes adds
// 8 C bytes a row of traffic, small beside the products at these widths.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "wavenet_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WNC = 128;  // output columns a tile (a slab)
constexpr int WTM = 64;   // rows a tile
constexpr int WKC = 32;   // k-rows a chunk
constexpr int W_LDA = WKC + 4, W_LDW = WNC + 8;
constexpr int W_MT = 2, W_NTL = 4, W_WN = 4;  // 8 warps as 2 x 4 of 32 x 32
constexpr int W_ABUF = WTM * W_LDA, W_WBUF = WKC * W_LDW;
constexpr int WIDE_SMEM = 2 * (W_ABUF + W_WBUF) * 4;
constexpr int WIDE_WG_NT = 512;  // threads of the v3 weight-gradient kernel
constexpr int WIDE_PARTS = 2;    // a v2 weight-gradient item: half a block's outputs
static_assert(W_LDA % 32 == 4 && W_LDW % 32 == 8, "bank-conflict-free strides");
static_assert(WIDE_SMEM <= WG_SMEM, "the cooperative kernels' shared memory is WG_SMEM");

using Acc = float[W_MT][W_NTL][4];

// one tap: rows (t + off) of A (row stride lda) times the weight rows w [K x ldw]
struct WTap {
  const float* a;
  const float* w;
  int off;
};

__device__ __forceinline__ void wfold(Acc& acc, Acc& from) {
#pragma unroll
  for (int mt = 0; mt < W_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W_NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] += from[mt][nt][e];
        from[mt][nt][e] = 0.f;
      }
}

__device__ __forceinline__ int wrow0() { return ((threadIdx.x >> 5) / W_WN) * 32; }
__device__ __forceinline__ int wcol0() { return ((threadIdx.x >> 5) % W_WN) * 32; }

// acc += sum over the ntaps taps of A_tap[t0 .., k] w_tap[k, n0 ..], k < K
// (a multiple of WKC), rows outside [0, lim) of A zero; a_nonlin: nonlin(A)
// (applied in shared memory once a chunk has landed).  Chunk by chunk, tap
// by tap in order; each chunk's hi x hi products one partial (see the top).
template <bool BF>
__device__ void wide_gemm(Acc& acc, const WTap (&taps)[3], int ntaps, int K, int lda, int ldw,
                          int n0, int t0, int lim, bool a_nonlin, int leaky, float* smem) {
  float* As = smem;               // [2][WTM][W_LDA]
  float* Ws = smem + 2 * W_ABUF;  // [2][WKC][W_LDW]
  const int lane = threadIdx.x & 31, row0 = wrow0(), col0 = wcol0();
  const int cpt = K / WKC, chunks = ntaps * cpt;
  auto stage = [&](int q, int buf) {
    const int k = q / cpt, k0 = (q - k * cpt) * WKC;
    const float* a = k == 0 ? taps[0].a : (k == 1 ? taps[1].a : taps[2].a);
    const float* w = k == 0 ? taps[0].w : (k == 1 ? taps[1].w : taps[2].w);
    const int off = k == 0 ? taps[0].off : (k == 1 ? taps[1].off : taps[2].off);
    float* A = As + buf * W_ABUF;
    float* W = Ws + buf * W_WBUF;
    for (int i = threadIdx.x; i < WTM * (WKC / 4); i += NT) {
      const int r = i / (WKC / 4), c4 = i % (WKC / 4);
      const int t = t0 + r + off;
      const bool ok = t >= 0 && t < lim;
      cp_async16(A + r * W_LDA + 4 * c4, a + (size_t)(ok ? t : 0) * lda + k0 + 4 * c4, ok);
    }
    for (int i = threadIdx.x; i < WKC * (WNC / 4); i += NT) {
      const int r = i / (WNC / 4), c4 = i % (WNC / 4);
      cp_async16(W + r * W_LDW + 4 * c4, w + (size_t)(k0 + r) * ldw + n0 + 4 * c4, true);
    }
  };
  Acc small = {}, p0 = {}, p1 = {};
  auto step = [&](int q, Acc& cur, Acc& prev) {
    cp_async_wait<0>();  // chunk q has landed
    __syncthreads();     // ... for every thread; chunk q - 1 is consumed
    float* A = As + (q & 1) * W_ABUF;
    if (a_nonlin) {
      for (int i = threadIdx.x; i < WTM * WKC; i += NT) {
        float* p = A + (i / WKC) * W_LDA + i % WKC;
        *p = nonlin(*p, leaky);
      }
      __syncthreads();
    }
    if (q + 1 < chunks) stage(q + 1, (q + 1) & 1);
    cp_async_commit();
    warp_gemm2<W_MT, W_NTL, WKC, false, BF>(small, cur, A, W_LDA, row0, 0,
                                            Ws + (q & 1) * W_WBUF, W_LDW, col0, lane);
    wfold(acc, prev);  // chunk q - 1's partial
  };
  stage(0, 0);
  cp_async_commit();
  for (int q = 0; q < chunks; q += 2) {
    step(q, p0, p1);
    if (q + 1 < chunks) step(q + 1, p1, p0);
  }
  wfold(acc, p0);
  wfold(acc, p1);
  wfold(acc, small);
  __syncthreads();  // the ring is free for the caller's next tile
}

// zeros for rows [first, first + rows) of video b's [Tout][C] output, slab n0, t < Tout
__device__ __forceinline__ void wide_zeros(float* y, int b, int first, int rows, int Tout, int C,
                                           int n0) {
  for (int i = threadIdx.x; i < rows * (WNC / 4); i += NT) {
    const int t = first + i / (WNC / 4);
    if (t >= Tout) break;
    reinterpret_cast<float4*>(y + ((size_t)b * Tout + t) * C + n0)[i % (WNC / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// fn(v0, v1, row, col) over this thread's accumulators (col within the slab)
template <class Fn>
__device__ __forceinline__ void wpairs(Acc& acc, Fn fn) {
  for_each_pair(acc, wrow0(), wcol0(), threadIdx.x & 31, fn);
}

// g's value at row t of a layer's output (`grad_at` at a runtime width, read
// through L2: u may be a buffer the same launch wrote)
__device__ __forceinline__ float2 wgrad_at(const float* g, const float* u, int b, int t, int T,
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

// the three taps of a dilated conv of video rows xb at dilation d, taps
// (-d, 0, +d) with weights w3[0..2] (sign = -1: (+d, 0, -d), the sweep's dx);
// a tap no row of [t0, t0 + WTM) has (within [0, lim)) is left out
__device__ __forceinline__ int conv_taps(WTap (&taps)[3], const float* xb, const float* w3,
                                         size_t blk, int t0, int d, int lim, int sign) {
  int n = 0;
  const int lo = -sign * d, hi = sign * d;  // the offsets of w3[0] and w3[2]
  if (t0 + WTM + lo > 0 && t0 + lo < lim) taps[n++] = WTap{xb, w3, lo};
  taps[n++] = WTap{xb, w3 + blk, 0};
  if (t0 + WTM + hi > 0 && t0 + hi < lim) taps[n++] = WTap{xb, w3 + 2 * blk, hi};
  return n;
}

// ---------------------------------------------------------------------------
// the bodies: one (row tile, slab) each
// ---------------------------------------------------------------------------

// pass 1: h = nonlin(conv(x) + b3) for the rows t < lim (the stash hs)
template <bool BF>
__device__ void conv_body(const float* x, float* h, const int* __restrict__ lengths,
                          const float* __restrict__ w3, const float* __restrict__ b3, int b,
                          int t0, int n0, int T, int C, int d, int len_shift, int leaky,
                          float* smem) {
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) return;
  const int lim = min(T, len);
  WTap taps[3] = {};
  const int n = conv_taps(taps, x + (size_t)b * T * C, w3, (size_t)C * C, t0, d, lim, 1);
  Acc acc = {};
  wide_gemm<BF>(acc, taps, n, C, C, C, n0, t0, lim, false, 0, smem);
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    if (t < lim)
      st2(h + ((size_t)b * T + t) * C + n0 + col, nonlin(v0 + __ldg(b3 + n0 + col), leaky),
          nonlin(v1 + __ldg(b3 + n0 + col + 1), leaky));
  });
}

// pass 2: u = mask(m (h W1 + b1) + x); y = u or pool2(u) (y null: u_out
// only, the v2 sweep's recompute); a pooled layer's u to u_out if given
template <bool BF>
__device__ void res_body(const float* x, const float* h, float* y, float* u_out,
                         const int* __restrict__ lengths, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ drop, int b,
                         int t0, int n0, int T, int C, int len_shift, int pool, int pool_mean,
                         float* smem) {
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    if (y) {
      if (pool) wide_zeros(y, b, t0 / 2, WTM / 2, T / 2, C, n0);
      else wide_zeros(y, b, t0, WTM, T, C, n0);
    }
    return;
  }
  const int lim = min(T, len);
  const WTap taps[3] = {WTap{h + (size_t)b * T * C, w1, 0}, WTap{}, WTap{}};
  Acc acc = {};
  wide_gemm<BF>(acc, taps, 1, C, C, C, n0, t0, lim, false, 0, smem);
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    if (t >= lim) {
      v0 = v1 = 0.f;
      return;
    }
    const size_t o = ((size_t)b * T + t) * C + n0 + col;
    const float2 m = drop ? ld2(drop + o) : make_float2(1.f, 1.f);
    const float2 xv = ld2_l2(x + o);
    v0 = (v0 + __ldg(b1 + n0 + col)) * m.x + xv.x;
    v1 = (v1 + __ldg(b1 + n0 + col + 1)) * m.y + xv.y;
  });
  if (!pool) {
    if (y)
      wpairs(acc, [&](float& v0, float& v1, int row, int col) {
        if (t0 + row < T) st2(y + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
      });
    return;
  }
  if (u_out)
    wpairs(acc, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < lim) st2(u_out + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
    });
  if (y)
    store_pooled<0>(y, acc, b, t0, T, len, wrow0(), n0 + wcol0(), threadIdx.x & 31, pool_mean,
                    C);
}

// the out-projection z = mask(nonlin(x) Wl + bl)
template <bool BF>
__device__ void proj_body(const float* x, float* z, const int* __restrict__ lengths,
                          const float* __restrict__ wl, const float* __restrict__ bl, int b,
                          int t0, int n0, int T, int C, int len_shift, int leaky,
                          float* smem) {
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    wide_zeros(z, b, t0, WTM, T, C, n0);
    return;
  }
  const WTap taps[3] = {WTap{x + (size_t)b * T * C, wl, 0}, WTap{}, WTap{}};
  Acc acc = {};
  wide_gemm<BF>(acc, taps, 1, C, C, C, n0, t0, min(T, len), true, leaky, smem);
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    if (t < T)
      st2(z + ((size_t)b * T + t) * C + n0 + col, t < len ? v0 + __ldg(bl + n0 + col) : 0.f,
          t < len ? v1 + __ldg(bl + n0 + col + 1) : 0.f);
  });
}

// sweep dy: dy = (g, or g routed by u) m for the tile's rows t < lim, all C columns
__device__ void dy_body(const float* g, const float* u, const float* __restrict__ drop,
                        const int* __restrict__ lengths, float* dy, int b, int t0, int T, int C,
                        int len_shift, int pooled, int pool_mean) {
  const int len = lengths[b] >> len_shift, lim = min(T, len);
  for (int i = threadIdx.x; i < WTM * (C / 2); i += NT) {
    const int r = i / (C / 2), col = 2 * (i % (C / 2)), t = t0 + r;
    if (t >= lim) break;
    float2 v = wgrad_at(g, u, b, t, T, len, col, pooled, pool_mean, C);
    const size_t o = ((size_t)b * T + t) * C + col;
    if (drop) {
      const float2 m = ld2(drop + o);
      v = make_float2(v.x * m.x, v.y * m.y);
    }
    st2(dy + o, v.x, v.y);
  }
}

// sweep dz = (dy W1^T) nonlin'(h), masked (proj: the gradient at x_fin, its
// padding tiles zero too)
template <bool BF>
__device__ void dz_body(const float* dy, const float* h, const float* __restrict__ w1t,
                        const int* __restrict__ lengths, float* dz, int b, int t0, int n0, int T,
                        int C, int len_shift, int leaky, int proj, float* smem) {
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    if (proj) wide_zeros(dz, b, t0, WTM, T, C, n0);
    return;
  }
  const int lim = min(T, len);
  const WTap taps[3] = {WTap{dy + (size_t)b * T * C, w1t, 0}, WTap{}, WTap{}};
  Acc acc = {};
  wide_gemm<BF>(acc, taps, 1, C, C, C, n0, t0, lim, false, 0, smem);
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    const float2 hv = t < lim ? ld2_l2(h + ((size_t)b * T + t) * C + n0 + col)
                              : make_float2(0.f, 0.f);
    v0 = t < lim ? v0 * nonlin_grad(hv.x, leaky) : 0.f;
    v1 = t < lim ? v1 * nonlin_grad(hv.y, leaky) : 0.f;
  });
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    if (t0 + row < T) st2(dz + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
  });
}

// sweep dx: g_in = mask(dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
template <bool BF>
__device__ void dx_body(const float* dz, const float* g, const float* u,
                        const int* __restrict__ lengths, const float* __restrict__ w3t,
                        float* g_in, int b, int t0, int n0, int T, int C, int d, int len_shift,
                        int pooled, int pool_mean, float* smem) {
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    wide_zeros(g_in, b, t0, WTM, T, C, n0);
    return;
  }
  const int lim = min(T, len);
  WTap taps[3] = {};
  const int n = conv_taps(taps, dz + (size_t)b * T * C, w3t, (size_t)C * C, t0, d, lim, -1);
  Acc acc = {};
  wide_gemm<BF>(acc, taps, n, C, C, C, n0, t0, lim, false, 0, smem);
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    const float2 gm = t < lim ? wgrad_at(g, u, b, t, T, len, n0 + col, pooled, pool_mean, C)
                              : make_float2(0.f, 0.f);
    v0 = t < lim ? v0 + gm.x : 0.f;
    v1 = t < lim ? v1 + gm.y : 0.f;
  });
  wpairs(acc, [&](float& v0, float& v1, int row, int col) {
    if (t0 + row < T) st2(g_in + ((size_t)b * T + t0 + row) * C + n0 + col, v0, v1);
  });
}

// ---------------------------------------------------------------------------
// v3: one kernel a body, grid (row tiles, slabs, videos)
// ---------------------------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_conv_kernel(
    const float* x, float* h, const int* __restrict__ lengths, const float* __restrict__ w3,
    const float* __restrict__ b3, int T, int C, int d, int len_shift, int leaky) {
  extern __shared__ float4 smem4[];
  conv_body<BF>(x, h, lengths, w3, b3, blockIdx.z, blockIdx.x * WTM, blockIdx.y * WNC, T, C, d,
                len_shift, leaky, reinterpret_cast<float*>(smem4));
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_res_kernel(
    const float* x, const float* h, float* y, float* u_out, const int* __restrict__ lengths,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ drop,
    int T, int C, int len_shift, int pool, int pool_mean) {
  extern __shared__ float4 smem4[];
  res_body<BF>(x, h, y, u_out, lengths, w1, b1, drop, blockIdx.z, blockIdx.x * WTM,
               blockIdx.y * WNC, T, C, len_shift, pool, pool_mean,
               reinterpret_cast<float*>(smem4));
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_proj_kernel(
    const float* x, float* z, const int* __restrict__ lengths, const float* __restrict__ wl,
    const float* __restrict__ bl, int T, int C, int len_shift, int leaky) {
  extern __shared__ float4 smem4[];
  proj_body<BF>(x, z, lengths, wl, bl, blockIdx.z, blockIdx.x * WTM, blockIdx.y * WNC, T, C,
                len_shift, leaky, reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(NT) wide_dy_kernel(const float* g, const float* u,
                                                     const float* __restrict__ drop,
                                                     const int* __restrict__ lengths, float* dy,
                                                     int T, int C, int len_shift, int pooled,
                                                     int pool_mean) {
  dy_body(g, u, drop, lengths, dy, blockIdx.y, blockIdx.x * WTM, T, C, len_shift, pooled,
          pool_mean);
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_dz_kernel(
    const float* dy, const float* h, const float* __restrict__ w1t,
    const int* __restrict__ lengths, float* dz, int T, int C, int len_shift, int leaky,
    int proj) {
  extern __shared__ float4 smem4[];
  dz_body<BF>(dy, h, w1t, lengths, dz, blockIdx.z, blockIdx.x * WTM, blockIdx.y * WNC, T, C,
              len_shift, leaky, proj, reinterpret_cast<float*>(smem4));
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_dx_kernel(
    const float* dz, const float* g, const float* u, const int* __restrict__ lengths,
    const float* __restrict__ w3t, float* g_in, int T, int C, int d, int len_shift, int pooled,
    int pool_mean) {
  extern __shared__ float4 smem4[];
  dx_body<BF>(dz, g, u, lengths, w3t, g_in, blockIdx.z, blockIdx.x * WTM, blockIdx.y * WNC, T,
              C, d, len_shift, pooled, pool_mean, reinterpret_cast<float*>(smem4));
}

// CTA (span s, video b, job x (C / WB)^2 blocks + block)
template <bool BF>
__global__ void __launch_bounds__(WIDE_WG_NT, 1) wide_wgrad_kernel(
    const float* h, const float* x, const float* dy, const float* dz,
    const int* __restrict__ lengths, float* work, int T, int C, int span, int d, int len_shift,
    int proj, int leaky) {
  extern __shared__ float4 smem4[];
  const int NB = (C / WB) * (C / WB);
  wgrad_span<0, WIDE_WG_NT, 1, BF>(h, x, dy, dz, lengths, work, T, span, gridDim.x,
                                   gridDim.z / NB, d, len_shift, proj, leaky, blockIdx.x,
                                   blockIdx.y, blockIdx.z / NB, 0, blockIdx.z % NB,
                                   reinterpret_cast<float*>(smem4), C);
}

__global__ void wide_reduce_kernel(const float* work, const int* __restrict__ lengths, int B,
                                   int T, int C, int span, int spans, int len_shift, int jobs,
                                   float* dw1, float* db1, float* dw3, float* db3) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (long)jobs * part_f(C))
    reduce_entry<0>(work, lengths, B, T, span, spans, len_shift, jobs, (int)e, dw1, db1, dw3,
                    db3, C);
}

// The weight-gradient span of a layer at C channels: the largest power of
// two of at least 32 rows whose spans, jobs and (C / WB)^2 output blocks
// give SPAN_CTAS CTAs (`plan_for`'s rule, counting the blocks).
struct WidePlan {
  int span, spans;
};

WidePlan wide_plan(int B, int T, int C, int jobs) {
  const long nb = (long)(C / WB) * (C / WB);
  WidePlan p{32, 0};
  int top = 32;
  while (top < T) top *= 2;
  for (int s = top; s >= 32; s /= 2)
    if ((long)B * ((T + s - 1) / s) * jobs * nb >= SPAN_CTAS) {
      p.span = s;
      break;
    }
  p.spans = (T + p.span - 1) / p.span;
  return p;
}

bool bad_width(int C) { return C <= 512 || C % WNC; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

dim3 tiles(int T, int slabs, int B) { return dim3((T + WTM - 1) / WTM, slabs, B); }

template <bool BF>
cudaError_t layer_launch(const float* x, float* y, float* u_out, float* h, const int* lengths,
                         const float* w3, const float* b3, const float* w1, const float* b1,
                         const float* drop, int B, int T, int C, int d, int len_shift, int pool,
                         int pool_mean, int leaky, cudaStream_t stream) {
  cudaError_t err = prepare(wide_conv_kernel<BF>, WIDE_SMEM);
  if (err == cudaSuccess) err = prepare(wide_res_kernel<BF>, WIDE_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid = tiles(T, C / WNC, B);
  wide_conv_kernel<BF><<<grid, NT, WIDE_SMEM, stream>>>(x, h, lengths, w3, b3, T, C, d,
                                                         len_shift, leaky);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_res_kernel<BF><<<grid, NT, WIDE_SMEM, stream>>>(x, h, y, u_out, lengths, w1, b1, drop, T,
                                                        C, len_shift, pool, pool_mean);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t proj_launch(const float* x, float* z, const int* lengths, const float* wl,
                        const float* bl, int B, int T, int C, int len_shift, int leaky,
                        cudaStream_t stream) {
  cudaError_t err = prepare(wide_proj_kernel<BF>, WIDE_SMEM);
  if (err != cudaSuccess) return err;
  wide_proj_kernel<BF><<<tiles(T, C / WNC, B), NT, WIDE_SMEM, stream>>>(
      x, z, lengths, wl, bl, T, C, len_shift, leaky);
  return cudaGetLastError();
}

template <bool BF>
cudaError_t sweep_launch(const float* g, const float* u, const float* x, const float* h,
                         const float* drop, const int* lengths, const float* w1t,
                         const float* w3t, float* dy, float* dz, float* g_in, float* work,
                         float* dw1, float* db1, float* dw3, float* db3, int B, int T, int C,
                         int d, int len_shift, int pooled, int pool_mean, int leaky, int proj,
                         cudaStream_t stream) {
  const int jobs = proj ? 1 : 4;
  const WidePlan p = wide_plan(B, T, C, jobs);
  cudaError_t err = prepare(wide_dz_kernel<BF>, WIDE_SMEM);
  if (err == cudaSuccess) err = prepare(wide_dx_kernel<BF>, WIDE_SMEM);
  if (err == cudaSuccess) err = prepare(wide_wgrad_kernel<BF>, WG_SMEM);
  if (err != cudaSuccess) return err;
  wide_dy_kernel<<<dim3((T + WTM - 1) / WTM, B), NT, 0, stream>>>(g, u, drop, lengths, dy, T, C,
                                                                  len_shift, pooled, pool_mean);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid = tiles(T, C / WNC, B);
  wide_dz_kernel<BF><<<grid, NT, WIDE_SMEM, stream>>>(dy, h, w1t, lengths, dz, T, C, len_shift,
                                                       leaky, proj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!proj) {
    wide_dx_kernel<BF><<<grid, NT, WIDE_SMEM, stream>>>(dz, g, u, lengths, w3t, g_in, T, C, d,
                                                         len_shift, pooled, pool_mean);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int nb = (C / WB) * (C / WB);
  wide_wgrad_kernel<BF><<<dim3(p.spans, B, jobs * nb), WIDE_WG_NT, WG_SMEM, stream>>>(
      h, x, dy, dz, lengths, work, T, C, p.span, d, len_shift, proj, leaky);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)jobs * part_f(C);
  wide_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      work, lengths, B, T, C, p.span, p.spans, len_shift, jobs, dw1, db1, dw3, db3);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// v2: one cooperative kernel a chunk of layers, the same bodies
// ---------------------------------------------------------------------------

struct WFwdLayer {
  const float* x;
  float* y;
  float* hs;
  const float* drop;
  float* u;
  int T, d, shift, pool;
};

struct WFwdArgs {
  WFwdLayer layer[MAX_LAYERS];
  const float *w3, *b3, *w1, *b1, *wl, *bl;
  float* z;
  const int* lengths;
  int n, B, C, t_fin, shift_fin, leaky;
};

struct WSweepLayer {
  const float* x;
  const float* h;
  const float* drop;
  const float* g;
  float* g_in;
  float* u;  // the recomputed pre-pool output: a check's copy, or null (scratch)
  int T, d, shift, pool, span, spans;
};

struct WSweepArgs {
  WSweepLayer layer[MAX_LAYERS];
  const float *w3t, *w1, *w1t, *b1;
  float *dw3, *db3, *dw1, *db1;
  const float *gz, *x_fin, *wlt;
  float *dwl, *dbl, *g_proj;
  float *us, *dy, *dz, *work;  // scratch: recomputed u, dy, dz; the partials
  const int* lengths;
  int n, B, C, t_fin, shift_fin, leaky, span_fin, spans_fin;
};

// (video, first row, first column) of item k of a pass over T rows, `slabs` slabs
__device__ __forceinline__ int3 tile_of(int k, int T, int slabs) {
  const int per = (T + WTM - 1) / WTM;
  const int s = k % slabs, rest = k / slabs;
  return make_int3(rest / per, (rest % per) * WTM, s * WNC);
}

__device__ __forceinline__ int n_tiles(int B, int T, int slabs) {
  return B * ((T + WTM - 1) / WTM) * slabs;
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_v2_fwd_kernel(const __grid_constant__ WFwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, slabs = C / WNC;
  for (int j = 0; j < a.n; ++j) {
    const WFwdLayer& L = a.layer[j];
    const size_t cc = (size_t)C * C;
    grid_items(n_tiles(a.B, L.T, slabs), [&](int k) {
      const int3 t = tile_of(k, L.T, slabs);
      conv_body<BF>(L.x, L.hs, a.lengths, a.w3 + (size_t)j * 3 * cc, a.b3 + (size_t)j * C, t.x,
                    t.y, t.z, L.T, C, L.d, L.shift, a.leaky, smem);
    });
    grid.sync();  // h is read by other CTAs' pass 2
    grid_items(n_tiles(a.B, L.T, slabs), [&](int k) {
      const int3 t = tile_of(k, L.T, slabs);
      res_body<BF>(L.x, L.hs, L.y, L.u, a.lengths, a.w1 + (size_t)j * cc, a.b1 + (size_t)j * C,
                   L.drop, t.x, t.y, t.z, L.T, C, L.shift, L.pool, 0, smem);
    });
    if (j + 1 < a.n || a.z) grid.sync();  // the layer's output, read at t +- d
  }
  if (a.z)
    grid_items(n_tiles(a.B, a.t_fin, slabs), [&](int k) {
      const int3 t = tile_of(k, a.t_fin, slabs);
      proj_body<BF>(a.layer[a.n - 1].y, a.z, a.lengths, a.wl, a.bl, t.x, t.y, t.z, a.t_fin, C,
                    a.shift_fin, a.leaky, smem);
    });
}

// a layer's (j < 0: the out-projection's) weight-gradient items and their sum
template <bool BF>
__device__ void v2_wgrad(const WSweepArgs& a, int j, float* smem, cg::grid_group& grid) {
  const int C = a.C, nb = (C / WB) * (C / WB), per = nb * WIDE_PARTS;
  const bool proj = j < 0;
  const int jobs = proj ? 1 : 4, T = proj ? a.t_fin : a.layer[j].T;
  const int span = proj ? a.span_fin : a.layer[j].span, spans = proj ? a.spans_fin : a.layer[j].spans;
  const int shift = proj ? a.shift_fin : a.layer[j].shift;
  grid_items(a.B * spans * jobs * per, [&](int w) {
    const int part = w % WIDE_PARTS, blk = (w % per) / WIDE_PARTS, job = (w / per) % jobs;
    const int sb = w / (per * jobs), s = sb % spans, b = sb / spans;
    if (proj)
      wgrad_span<0, NT, WIDE_PARTS, BF>(a.x_fin, a.x_fin, a.gz, nullptr, a.lengths, a.work, T,
                                        span, spans, 1, 0, shift, 1, a.leaky, s, b, 0, part, blk,
                                        smem, C);
    else
      wgrad_span<0, NT, WIDE_PARTS, BF>(a.layer[j].h, a.layer[j].x, a.dy, a.dz, a.lengths,
                                        a.work, T, span, spans, 4, a.layer[j].d, shift, 0,
                                        a.leaky, s, b, job, part, blk, smem, C);
  });
  grid.sync();  // every partial
  const size_t cc = (size_t)C * C;
  for (long e = (long)blockIdx.x * NT + threadIdx.x; e < (long)jobs * part_f(C);
       e += (long)gridDim.x * NT) {
    if (proj)
      reduce_entry<0>(a.work, a.lengths, a.B, T, span, spans, shift, 1, (int)e, a.dwl, a.dbl,
                      nullptr, nullptr, C);
    else
      reduce_entry<0>(a.work, a.lengths, a.B, T, span, spans, shift, 4, (int)e,
                      a.dw1 + (size_t)j * cc, a.db1 + (size_t)j * C, a.dw3 + (size_t)j * 3 * cc,
                      a.db3 + (size_t)j * C, C);
  }
  grid.sync();  // work is free again
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1) wide_v2_sweep_kernel(
    const __grid_constant__ WSweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, slabs = C / WNC;
  const size_t cc = (size_t)C * C;
  if (a.gz) {  // the out-projection: dy = gz, dz = the gradient at x_fin
    grid_items(a.B * ((a.t_fin + WTM - 1) / WTM), [&](int k) {
      const int per = (a.t_fin + WTM - 1) / WTM;
      dy_body(a.gz, nullptr, nullptr, a.lengths, a.dy, k / per, (k % per) * WTM, a.t_fin, C,
              a.shift_fin, 0, 0);
    });
    grid.sync();
    grid_items(n_tiles(a.B, a.t_fin, slabs), [&](int k) {
      const int3 t = tile_of(k, a.t_fin, slabs);
      dz_body<BF>(a.dy, a.x_fin, a.wlt, a.lengths, a.g_proj, t.x, t.y, t.z, a.t_fin, C,
                  a.shift_fin, a.leaky, 1, smem);
    });
    v2_wgrad<BF>(a, -1, smem, grid);
  }
  for (int j = a.n - 1; j >= 0; --j) {
    const WSweepLayer& L = a.layer[j];
    float* u = L.u ? L.u : a.us;
    if (L.pool) {  // u recomputed from the stash, as the forward's pass 2 made it
      grid_items(n_tiles(a.B, L.T, slabs), [&](int k) {
        const int3 t = tile_of(k, L.T, slabs);
        res_body<BF>(L.x, L.h, nullptr, u, a.lengths, a.w1 + (size_t)j * cc,
                     a.b1 + (size_t)j * C, L.drop, t.x, t.y, t.z, L.T, C, L.shift, 1, 0, smem);
      });
      grid.sync();
    }
    grid_items(a.B * ((L.T + WTM - 1) / WTM), [&](int k) {
      const int per = (L.T + WTM - 1) / WTM;
      dy_body(L.g, u, L.drop, a.lengths, a.dy, k / per, (k % per) * WTM, L.T, C, L.shift,
              L.pool, 0);
    });
    grid.sync();
    grid_items(n_tiles(a.B, L.T, slabs), [&](int k) {
      const int3 t = tile_of(k, L.T, slabs);
      dz_body<BF>(a.dy, L.h, a.w1t + (size_t)j * cc, a.lengths, a.dz, t.x, t.y, t.z, L.T, C,
                  L.shift, a.leaky, 0, smem);
    });
    grid.sync();  // dz is read at t +- d
    grid_items(n_tiles(a.B, L.T, slabs), [&](int k) {
      const int3 t = tile_of(k, L.T, slabs);
      dx_body<BF>(a.dz, L.g, u, a.lengths, a.w3t + (size_t)j * 3 * cc, L.g_in, t.x, t.y, t.z,
                  L.T, C, L.d, L.shift, L.pool, 0, smem);
    });
    v2_wgrad<BF>(a, j, smem, grid);  // (its first barrier also orders g_in for layer j - 1)
  }
}

template <bool BF>
int v2_fwd(void* const* ptrs, const int* ints, int n, const float* w3, const float* b3,
           const float* w1, const float* b1, const float* wl, const float* bl, float* z,
           const int* lengths, int B, int C, int t_fin, int shift_fin, int leaky,
           cudaStream_t stream) {
  WFwdArgs a = {};
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    if (T <= 0) return cudaErrorInvalidValue;
    a.layer[j] = WFwdLayer{static_cast<const float*>(ptrs[5 * j]),
                           static_cast<float*>(ptrs[5 * j + 1]),
                           static_cast<float*>(ptrs[5 * j + 2]),
                           static_cast<const float*>(ptrs[5 * j + 3]),
                           static_cast<float*>(ptrs[5 * j + 4]),
                           T, ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3]};
  }
  a.w3 = w3; a.b3 = b3; a.w1 = w1; a.b1 = b1; a.wl = wl; a.bl = bl; a.z = z;
  a.lengths = lengths; a.n = n; a.B = B; a.C = C; a.t_fin = t_fin; a.shift_fin = shift_fin;
  a.leaky = leaky;
  return launch_cooperative(wide_v2_fwd_kernel<BF>, WG_SMEM, &a, stream);
}

template <bool BF>
int v2_sweep(void* const* ptrs, const int* ints, int n, const float* w3t, const float* w1,
             const float* w1t, const float* b1, float* dw3, float* db3, float* dw1, float* db1,
             const float* gz, const float* x_fin, const float* wlt, float* dwl, float* dbl,
             float* scratch, long rows, float* work, long work_floats, const int* lengths,
             int B, int C, int t_fin, int shift_fin, int leaky, cudaStream_t stream) {
  WSweepArgs a = {};
  long need = 0;
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    if (T <= 0 || (long)B * T > rows) return cudaErrorInvalidValue;
    const WidePlan p = wide_plan(B, T, C, 4);
    a.layer[j] = WSweepLayer{static_cast<const float*>(ptrs[6 * j]),
                             static_cast<const float*>(ptrs[6 * j + 1]),
                             static_cast<const float*>(ptrs[6 * j + 2]),
                             static_cast<const float*>(ptrs[6 * j + 3]),
                             static_cast<float*>(ptrs[6 * j + 4]),
                             static_cast<float*>(ptrs[6 * j + 5]),
                             T, ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3], p.span,
                             p.spans};
    need = std::max(need, (long)B * p.spans * 4 * part_f(C));
  }
  const WidePlan pf = wide_plan(B, t_fin, C, 1);
  if (gz) {
    if ((long)B * t_fin > rows) return cudaErrorInvalidValue;
    need = std::max(need, (long)B * pf.spans * part_f(C));
  }
  if (need > work_floats) return cudaErrorInvalidValue;
  a.w3t = w3t; a.w1 = w1; a.w1t = w1t; a.b1 = b1;
  a.dw3 = dw3; a.db3 = db3; a.dw1 = dw1; a.db1 = db1;
  a.gz = gz; a.x_fin = x_fin; a.wlt = wlt; a.dwl = dwl; a.dbl = dbl;
  a.g_proj = gz ? static_cast<float*>(ptrs[6 * (n - 1) + 3]) : nullptr;
  a.us = scratch;
  a.dy = scratch + rows * C;
  a.dz = scratch + 2 * rows * C;
  a.work = work; a.lengths = lengths;
  a.n = n; a.B = B; a.C = C; a.t_fin = t_fin; a.shift_fin = shift_fin; a.leaky = leaky;
  a.span_fin = pf.span; a.spans_fin = pf.spans;
  return launch_cooperative(wide_v2_sweep_kernel<BF>, WG_SMEM, &a, stream);
}

}  // namespace

// The wide bodies' grid of a layer of B videos x T frames x C channels:
// out = {row tile, weight-gradient span, spans a video}; the sweep's `work`
// holds B * spans * jobs * (C + 1) * C floats (jobs = 4, 1 for the
// out-projection).
extern "C" int mucon_wide_plan(int B, int T, int channels, int jobs, int* out) {
  if (B <= 0 || T <= 0 || jobs <= 0 || bad_width(channels)) return cudaErrorInvalidValue;
  const WidePlan p = wide_plan(B, T, channels, jobs);
  out[0] = WTM;
  out[1] = p.span;
  out[2] = p.spans;
  return cudaSuccess;
}

// One residual layer at C > 512 channels (a multiple of 128): pass 1 into
// h (nonlin(z), rows t < len: the stash, or the caller's scratch), then pass
// 2 into y (and a pooled layer's u into u_out, if given).  drop may be null.
extern "C" int mucon_wide_layer(const float* x, float* y, float* u_out, float* h,
                                const int* lengths, const float* w3, const float* b3,
                                const float* w1, const float* b1, const float* drop, int B,
                                int T, int channels, int d, int len_shift, int pool,
                                int pool_mean, int leaky, int bf16, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || (pool && T % 2) || bad_width(channels) || !h)
    return cudaErrorInvalidValue;
  return bf16 ? layer_launch<true>(x, y, u_out, h, lengths, w3, b3, w1, b1, drop, B, T,
                                   channels, d, len_shift, pool, pool_mean, leaky, stream)
              : layer_launch<false>(x, y, u_out, h, lengths, w3, b3, w1, b1, drop, B, T,
                                    channels, d, len_shift, pool, pool_mean, leaky, stream);
}

// The trainable stack's out-projection z = mask(nonlin(x) Wl + bl) at C > 512.
extern "C" int mucon_wide_proj(const float* x, float* z, const int* lengths, const float* wl,
                               const float* bl, int B, int T, int channels, int len_shift,
                               int leaky, int bf16, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || bad_width(channels)) return cudaErrorInvalidValue;
  return bf16 ? proj_launch<true>(x, z, lengths, wl, bl, B, T, channels, len_shift, leaky,
                                  stream)
              : proj_launch<false>(x, z, lengths, wl, bl, B, T, channels, len_shift, leaky,
                                   stream);
}

// One layer of the v3 sweep (or the out-projection's, proj = 1) at C > 512;
// arguments as `mucon_wavenet_train_sweep`, `work` sized by `mucon_wide_plan`.
extern "C" int mucon_wide_sweep(const float* g, const float* u, const float* x, const float* h,
                                const float* drop, const int* lengths, const float* w1t,
                                const float* w3t, float* dy, float* dz, float* g_in,
                                float* work, float* dw1, float* db1, float* dw3, float* db3,
                                int B, int T, int channels, int d, int len_shift, int pooled,
                                int pool_mean, int leaky, int proj, int bf16,
                                cudaStream_t stream) {
  if (B <= 0 || T <= 0 || (pooled && !u) || (proj && pooled) || bad_width(channels))
    return cudaErrorInvalidValue;
  return bf16 ? sweep_launch<true>(g, u, x, h, drop, lengths, w1t, w3t, dy, dz, g_in, work, dw1,
                                   db1, dw3, db3, B, T, channels, d, len_shift, pooled,
                                   pool_mean, leaky, proj, stream)
              : sweep_launch<false>(g, u, x, h, drop, lengths, w1t, w3t, dy, dz, g_in, work,
                                    dw1, db1, dw3, db3, B, T, channels, d, len_shift, pooled,
                                    pool_mean, leaky, proj, stream);
}

// The v2 chunk launches at C > 512: tables and arguments as
// `mucon_wavenet_train_v2_fwd` / `_sweep` (the sweep's scratch holds the
// recomputed u, dy and dz, `rows` x C floats each).
extern "C" int mucon_wide_v2_fwd(void* const* ptrs, const int* ints, int n, const float* w3,
                                 const float* b3, const float* w1, const float* b1,
                                 const float* wl, const float* bl, float* z, const int* lengths,
                                 int B, int channels, int t_fin, int shift_fin, int leaky,
                                 int bf16, cudaStream_t stream) {
  if (B <= 0 || n < 1 || n > MAX_LAYERS || bad_width(channels)) return cudaErrorInvalidValue;
  return bf16 ? v2_fwd<true>(ptrs, ints, n, w3, b3, w1, b1, wl, bl, z, lengths, B, channels,
                             t_fin, shift_fin, leaky, stream)
              : v2_fwd<false>(ptrs, ints, n, w3, b3, w1, b1, wl, bl, z, lengths, B, channels,
                              t_fin, shift_fin, leaky, stream);
}

extern "C" int mucon_wide_v2_sweep(
    void* const* ptrs, const int* ints, int n, const float* w3t, const float* w1,
    const float* w1t, const float* b1, float* dw3, float* db3, float* dw1, float* db1,
    const float* gz, const float* x_fin, const float* wlt, float* dwl, float* dbl,
    float* scratch, long rows, float* work, long work_floats, const int* lengths, int B,
    int channels, int t_fin, int shift_fin, int leaky, int bf16, cudaStream_t stream) {
  if (B <= 0 || n < 1 || n > MAX_LAYERS || t_fin <= 0 || bad_width(channels))
    return cudaErrorInvalidValue;
  return bf16 ? v2_sweep<true>(ptrs, ints, n, w3t, w1, w1t, b1, dw3, db3, dw1, db1, gz, x_fin,
                               wlt, dwl, dbl, scratch, rows, work, work_floats, lengths, B,
                               channels, t_fin, shift_fin, leaky, stream)
              : v2_sweep<false>(ptrs, ints, n, w3t, w1, w1t, b1, dw3, db3, dw1, db1, gz, x_fin,
                                wlt, dwl, dbl, scratch, rows, work, work_floats, lengths, B,
                                channels, t_fin, shift_fin, leaky, stream);
}

// The wide v2 kernels' cooperative grids in the mode bf16: out = {CTAs an SM
// of the forward kernel, of the sweep kernel, SMs, shared memory a CTA}.
extern "C" int mucon_wide_v2_grid(int bf16, int* out) {
  int sms = 0;
  cudaError_t err = bf16 ? coop_grid(wide_v2_fwd_kernel<true>, WG_SMEM, &out[0], &sms)
                         : coop_grid(wide_v2_fwd_kernel<false>, WG_SMEM, &out[0], &sms);
  if (err == cudaSuccess)
    err = bf16 ? coop_grid(wide_v2_sweep_kernel<true>, WG_SMEM, &out[1], &sms)
               : coop_grid(wide_v2_sweep_kernel<false>, WG_SMEM, &out[1], &sms);
  out[2] = sms;
  out[3] = WG_SMEM;
  return err;
}
