// Trainable WaveNet residual stack, forward with activation stash and
// backward sweep, on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU programs of `wavenet_stack_train_v3`
// (mucon_tpu/ops/wavenet_train_pallas_v3.py): `_fwd_kernel_v3` /
// `_fwd_call_v3` (:134, :358), `_sweep_kernel_v3` / `_sweep_call_v3` (:200,
// :449) and the XLA pool glue between them (`_pool2_fwd_xla` :91,
// `_pool2_bwd_xla` :103).  The TPU version groups equal-T layers into one
// program only to fit Mosaic's compile budget; here every launch is one
// layer, and the pool and its gradient routing are fused into the layer
// kernels.  The forward's layer kernel is the eval stack's
// (wavenet_layer.cuh).
//
// Forward, one launch per layer (layer i: t frames, dilation d, dropout mask
// m [B, t, C] or none):
//   h  = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)   -> stash hs
//   u  = mask (m * (h W1 + b1) + x)                 (pooled layer: -> stash)
//   x' = u, or pool2(u) masked at len/2 (max: first of a tie; sum: mean * 2)
// The layer input x is the previous launch's output and stays in memory as
// the stash the sweep reads; nothing else is copied.  The out-projection
// runs as the eval kernel's final_proj launch.  The stashes hs and u hold
// the rows t < len only (the sweep reads no other).
//
// Backward, one `mucon_wavenet_train_sweep` call per layer (last first), four
// kernels:
//   1. dz:  gm = mask (g, or g routed through the pool with the stashed u),
//           dy = gm * m,  dz = (dy W1^T) * nonlin'(h)          (writes dy, dz)
//   2. dx:  g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   3. wgrad partials: dW1 = h^T dy, dW3[k] = shift(x, (k-1) d)^T dz and the
//           bias sums, one CTA per (span of one video's rows, product)
//   4. reduce: the spans' partials summed in (video, span) order.
// The out-projection's sweep is the same call with proj = 1: h = x_fin,
// W1 = Wl, no dropout, and kernel 1's dz is the gradient at x_fin.
//
// Design (the row tile of wavenet_layer.cuh, shared with the eval stack; the
// four sweep kernels run the bodies of wavenet_sweep.cuh, which the v2
// stack's cooperative kernels run too):
//
// * Every product is `mma.sync.m16n8k8` TF32 on hi/lo-split operands, three
//   products per f32 product (mma_tf32.cuh), tiles f32 in shared memory.
//   The forward is `wavenet_layer_kernel` with the stash and the dropout
//   mask.  Kernels 1 and 2 stream their [3C; C] (or [C]) weight rows in
//   chunks through the same 2-deep `cp.async` ring (`tap_loop`), with the
//   same chunk-wise f32 sum, so that the ReLU sides and max-pool routing
//   stay the f32 twin's.  Kernel 3 is A^T B over rows: A's fragments are
//   read transposed from its row-major [rows][C] tile (`load_at_split`),
//   16 warps as 4 x 4 over the C x C output, 32 rows a chunk through a ring
//   of (A, B) tile pairs.
// * nonlin'(h) and the routed gradient happen in the accumulators' layout
//   (rows 2k, 2k + 1 of a pool sit in lanes l, l ^ 4).  The forward writes
//   u from the registers that are pooled, so the sweep's routing compares
//   the pair the forward compared.
// * Padding is skipped: a row tile at or past its video's length writes its
//   zeros (y; g_in; dz of the out-projection, which the next sweep reads)
//   and returns; a weight-gradient span past the length writes no partial,
//   and the reduction skips it.  Tap chunks a whole tile lacks are skipped,
//   and the shifted-row products of kernel 3 walk only the rows whose
//   shifted row exists: what is left out are products of zeros.
// * The grid fills the card at the train batch (B = 8), chosen from the
//   shape (`plan_for`, `mucon_wavenet_train_plan`): the row tile is the
//   largest of 64 and 32 rows that still gives enough CTAs, else 16 (1, 2
//   and 3 CTAs an SM); the span of kernel 3 the largest power of two of at
//   least 32 rows that gives a wave of CTAs.
// * The weight gradients are bitwise repeatable: each partial is one CTA's
//   fixed-order sum over its span, and kernel 4 adds them in a fixed order
//   with no atomics.
// * Widths: every kernel is built for C = 128, 256 and 512 channels (the
//   wrapper zero-pads another C up to 512; above it, the `wgmma` bodies of
//   wavenet_wgmma_train.cu run).  The row tiles shrink as C
//   grows (`tile_ok`: at most 32 rows at 256, 16 at 512, one CTA an SM),
//   and kernel 3 cuts a C x C gradient into (C / 128)^2 blocks of 128 x 128,
//   one CTA each (its A and B bands staged 128 columns wide), so that every
//   width stages the tiles and sums the rows that C = 128 does.
//
// Bound: the tensor cores at three TF32 products per f32 product (495 / 3
// TFLOP/s on the H100); per valid row and layer the forward does 8 C^2 f32
// operations and the backward 16 C^2, fewer where a tap's rows do not exist.
//
// bf16 = 1 (the JAX package's `mm_dtype=bfloat16`,
// wavenet_train_pallas_v3.py:170-191 forward, :241-270 and :383-386 sweep)
// runs every kernel here in its bf16-operand mode (template BF): each
// product's operands rounded to bf16 as their fragments leave the f32
// tiles, one bf16 `mma` a 16-deep k-step, f32 sums; the stashes, dropout,
// pool routing and bias sums stay f32.  Bound then by the dense bf16 rate.

#include <cuda_runtime.h>

#include <type_traits>

#include "wavenet_sweep.cuh"

namespace {

constexpr int WG_NT = 512;              // threads of kernel 3: 16 warps of 32 x 32

template <int N>
using ic = std::integral_constant<int, N>;

// f(ic<TM>) for a row tile tm that fits an SM at C channels (`plan_for` picks no other)
template <int C, class F>
cudaError_t with_tile(int tm, F f) {
  if constexpr (tile_ok(C, 64))
    if (tm == 64) return f(ic<64>{});
  if constexpr (tile_ok(C, 32))
    if (tm == 32) return f(ic<32>{});
  return f(ic<16>{});
}

// ---------------------------------------------------------------------------
// the sweep's four kernels, one CTA a body (wavenet_sweep.cuh)
// ---------------------------------------------------------------------------

template <int C, int TM, bool BF>
__global__ void __launch_bounds__(NT, Tile<C, TM>::MIN_BLOCKS) sweep_dz_kernel(
    const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ h,      // [B, T, C] nonlin(z) (proj: x_fin)
    const float* __restrict__ drop,   // [B, T, C] or null
    const int* __restrict__ lengths,
    const float* __restrict__ w1t,    // [C, C] = W1^T
    float* __restrict__ dy, float* __restrict__ dz,
    int T, int len_shift, int pooled, int pool_mean, int leaky, int proj) {
  extern __shared__ float4 smem4[];
  constexpr int KC = Tile<C, TM>::KC;
  dz_tile<C, TM, KC, KC, BF>(g, u, h, drop, lengths, w1t, dy, dz, blockIdx.y, blockIdx.x * TM,
                             T, len_shift, pooled, pool_mean, leaky, proj,
                             reinterpret_cast<float*>(smem4));
}

template <int C, int TM, bool BF>
__global__ void __launch_bounds__(NT, Tile<C, TM>::MIN_BLOCKS) sweep_dx_kernel(
    const float* __restrict__ dz, const float* __restrict__ g,
    const float* __restrict__ u, const int* __restrict__ lengths,
    const float* __restrict__ w3t,    // [3, C, C]: W3[k]^T
    float* __restrict__ g_in, int T, int d, int len_shift, int pooled, int pool_mean) {
  extern __shared__ float4 smem4[];
  constexpr int KC = Tile<C, TM>::KC;
  dx_tile<C, TM, KC, KC, BF>(dz, g, u, lengths, w3t, g_in, blockIdx.y, blockIdx.x * TM, T, d,
                             len_shift, pooled, pool_mean, reinterpret_cast<float*>(smem4));
}

// CTA (span s, video b, job x (C / WB)^2 output blocks + block)
template <int C, bool BF>
__global__ void __launch_bounds__(WG_NT, 1) sweep_wgrad_kernel(
    const float* __restrict__ h, const float* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const int* __restrict__ lengths, float* __restrict__ work, int T, int span, int d,
    int len_shift, int proj, int leaky) {
  extern __shared__ float4 smem4[];
  constexpr int NB = (C / WB) * (C / WB);
  wgrad_span<C, WG_NT, 1, BF>(h, x, dy, dz, lengths, work, T, span, gridDim.x, gridDim.z / NB,
                              d, len_shift, proj, leaky, blockIdx.x, blockIdx.y,
                              blockIdx.z / NB, 0, blockIdx.z % NB,
                              reinterpret_cast<float*>(smem4));
}

template <int C>
__global__ void sweep_reduce_kernel(const float* __restrict__ work,
                                    const int* __restrict__ lengths, int B, int T, int span,
                                    int spans, int len_shift, int jobs,
                                    float* __restrict__ dw1, float* __restrict__ db1,
                                    float* __restrict__ dw3, float* __restrict__ db3) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < jobs * part_f(C))
    reduce_entry<C>(work, lengths, B, T, span, spans, len_shift, jobs, e, dw1, db1, dw3, db3);
}

// sweep kernels 1 and 2 (kernel 2 not for the out-projection)
template <int C, int TM, bool BF>
cudaError_t launch_rows(const float* g, const float* u, const float* h, const float* drop,
                        const int* lengths, const float* w1t, const float* w3t, float* dy,
                        float* dz, float* g_in, int B, int T, int d, int len_shift, int pooled,
                        int pool_mean, int leaky, int proj, cudaStream_t stream) {
  using TL = Tile<C, TM>;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_dz_kernel<C, TM, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::ONE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_dx_kernel<C, TM, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TL::TAPS_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 tiles((T + TM - 1) / TM, B);
  sweep_dz_kernel<C, TM, BF><<<tiles, NT, TL::ONE_SMEM, stream>>>(
      g, u, h, drop, lengths, w1t, dy, dz, T, len_shift, pooled, pool_mean, leaky, proj);
  err = cudaGetLastError();
  if (err != cudaSuccess || proj) return err;
  sweep_dx_kernel<C, TM, BF><<<tiles, NT, TL::TAPS_SMEM, stream>>>(
      dz, g, u, lengths, w3t, g_in, T, d, len_shift, pooled, pool_mean);
  return cudaGetLastError();
}

template <int C, bool BF>
int train_fwd(const float* x, float* y, float* u_out, float* hs, const int* lengths,
              const float* w3, const float* b3, const float* w1, const float* b1,
              const float* drop, int B, int T, int d, int len_shift, int pool, int pool_mean,
              int leaky, cudaStream_t stream) {
  return with_tile<C>(plan_for(B, T, C, 4).fwd_tm, [&](auto tm) {
    return launch_layer<C, decltype(tm)::value, BF>(x, y, u_out, hs, lengths, w3, b3, w1, b1,
                                                    drop, B, T, d, len_shift, pool, pool_mean,
                                                    leaky, stream);
  });
}

template <int C, bool BF>
int train_sweep(const float* g, const float* u, const float* x, const float* h,
                const float* drop, const int* lengths, const float* w1t, const float* w3t,
                float* dy, float* dz, float* g_in, float* work, float* dw1, float* db1,
                float* dw3, float* db3, int B, int T, int d, int len_shift, int pooled,
                int pool_mean, int leaky, int proj, cudaStream_t stream) {
  const int jobs = proj ? 1 : 4;
  const Plan p = plan_for(B, T, C, jobs);
  cudaError_t err = with_tile<C>(p.tm, [&](auto tm) {
    return launch_rows<C, decltype(tm)::value, BF>(g, u, h, drop, lengths, w1t, w3t, dy, dz,
                                                   g_in, B, T, d, len_shift, pooled, pool_mean,
                                                   leaky, proj, stream);
  });
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_wgrad_kernel<C, BF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  constexpr int NB = (C / WB) * (C / WB);
  sweep_wgrad_kernel<C, BF><<<dim3(p.spans, B, jobs * NB), WG_NT, WG_SMEM, stream>>>(
      h, x, dy, dz, lengths, work, T, p.span, d, len_shift, proj, leaky);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = jobs * part_f(C);
  sweep_reduce_kernel<C><<<(n + 255) / 256, 256, 0, stream>>>(
      work, lengths, B, T, p.span, p.spans, len_shift, jobs, dw1, db1, dw3, db3);
  return cudaGetLastError();
}

}  // namespace

// The grid a layer of B videos x T frames x C channels takes (see
// `plan_for`): out = {forward row tile, sweep row tile, weight-gradient
// span, spans a video}.  The sweep's `work` holds B * spans * jobs *
// (C + 1) * C floats (jobs = 4, or 1 for the out-projection).
extern "C" int mucon_wavenet_train_plan(int B, int T, int channels, int jobs, int* out) {
  if (B <= 0 || T <= 0 || jobs <= 0 || channels <= 0) return cudaErrorInvalidValue;
  const Plan p = plan_for(B, T, channels, jobs);
  out[0] = p.fwd_tm;
  out[1] = p.tm;
  out[2] = p.span;
  out[3] = p.spans;
  return cudaSuccess;
}

// One layer of the stack's forward (see the top of the file) at C = 128, 256
// or 512 channels.  `u_out` is written only when pool = 1; `drop` may be null
// (no dropout).  An odd T pools to T / 2 (the last frame is dropped).
// bf16 = 1: the bf16-operand mode.
extern "C" int mucon_wavenet_train_fwd(const float* x, float* y, float* u_out,
                                       float* hs, const int* lengths,
                                       const float* w3, const float* b3,
                                       const float* w1, const float* b1,
                                       const float* drop, int B, int T, int channels,
                                       int d, int len_shift, int pool, int pool_mean,
                                       int leaky, int bf16, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || (pool && !u_out)) return cudaErrorInvalidValue;
#define FWD(C, BF)                                                                          \
  train_fwd<C, BF>(x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, B, T, d, len_shift, pool, \
                   pool_mean, leaky, stream)
  switch (channels) {
    case 128: return bf16 ? FWD(128, true) : FWD(128, false);
    case 256: return bf16 ? FWD(256, true) : FWD(256, false);
    case 512: return bf16 ? FWD(512, true) : FWD(512, false);
    default: return cudaErrorInvalidValue;  // the wrapper pads another width to one of these
  }
#undef FWD
}

// One layer of the backward sweep (proj = 0) or the out-projection's
// (proj = 1: h = x = x_fin, w1t = Wl^T, drop = null, w3t / g_in / dw3 / db3
// unused, and dz receives the gradient at x_fin).  g is [B, T/2, C] when
// pooled = 1 (the layer pooled; u is its pre-pool output), else [B, T, C].
// `work` is sized by `mucon_wavenet_train_plan`.  bf16 = 1: the bf16-operand mode.
extern "C" int mucon_wavenet_train_sweep(
    const float* g, const float* u, const float* x, const float* h,
    const float* drop, const int* lengths, const float* w1t, const float* w3t,
    float* dy, float* dz, float* g_in, float* work, float* dw1, float* db1,
    float* dw3, float* db3, int B, int T, int channels, int d, int len_shift,
    int pooled, int pool_mean, int leaky, int proj, int bf16, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || (pooled && !u) || (proj && pooled)) return cudaErrorInvalidValue;
#define SWEEP(C, BF)                                                                         \
  train_sweep<C, BF>(g, u, x, h, drop, lengths, w1t, w3t, dy, dz, g_in, work, dw1, db1, dw3, \
                     db3, B, T, d, len_shift, pooled, pool_mean, leaky, proj, stream)
  switch (channels) {
    case 128: return bf16 ? SWEEP(128, true) : SWEEP(128, false);
    case 256: return bf16 ? SWEEP(256, true) : SWEEP(256, false);
    case 512: return bf16 ? SWEEP(512, true) : SWEEP(512, false);
    default: return cudaErrorInvalidValue;
  }
#undef SWEEP
}
