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
// A layer is `wavenet_layer_kernel<64>` of wavenet_layer.cuh with no stash
// and no dropout: the kernel the trainable stack's forward launches, so the
// two round a layer alike (the design is described there).
//
// The out-projection launch (final_proj = 1) computes nonlin(x) Wl + bl,
// masked, on the same tile (`proj_tile`): one row tile (nonlin applied in
// place once it has landed) and the weight ring (101 KiB).
//
// Bound: the tensor cores at three TF32 products per f32 product (8 C^2 f32
// operations per valid row and layer, fewer where a tap's rows do not
// exist; 2 C^2 for the out-projection).
//
// bf16 = 1 launches the bf16-operand mode of the same kernels (the JAX
// package's `mm_dtype=bfloat16`, `_matmul_bt` wavenet_pallas_v2.py:44-63):
// every product's operands rounded to bf16, one bf16 `mma` a 16-deep k-step,
// f32 sums and state (mma_tf32.cuh); bound by the tensor cores at the dense
// bf16 rate.

#include <cuda_runtime.h>

#include "wavenet_layer.cuh"

namespace {

constexpr int TM = 64;                  // pre-pool output rows per CTA
using TL = Tile<TM>;

// z = mask(nonlin(x) Wl + bl): the out-projection
template <bool BF>
__global__ void __launch_bounds__(NT, 1) wavenet_proj_kernel(
    const float* __restrict__ x, float* __restrict__ z, const int* __restrict__ lengths,
    const float* __restrict__ w_last, const float* __restrict__ b_last, int T, int len_shift,
    int leaky) {
  extern __shared__ float4 smem4[];
  proj_tile<TM, BF>(x, z, lengths, w_last, b_last, blockIdx.y, blockIdx.x * TM, T, len_shift,
                leaky, reinterpret_cast<float*>(smem4));
}

}  // namespace

// rows a CTA of the stack's kernels owns (a tile past a video's length is skipped)
extern "C" int mucon_wavenet_tile_rows() { return TM; }

// One layer of the stack (final_proj = 0) or the out-projection
// (final_proj = 1, w1/b1 = Wl/bl; w3/b3 unused).  T must be even when pool = 1.
// bf16 = 1: the bf16-operand mode.
namespace {

template <bool BF>
int wavenet_layer(const float* x, float* y, const int* lengths, const float* w3,
                  const float* b3, const float* w1, const float* b1, int B, int T, int d,
                  int len_shift, int pool, int pool_mean, int leaky, int final_proj,
                  cudaStream_t stream) {
  if (!final_proj)
    return launch_layer<TM, BF>(x, y, nullptr, nullptr, lengths, w3, b3, w1, b1, nullptr, B, T,
                                d, len_shift, pool, pool_mean, leaky, stream);
  cudaError_t err = cudaFuncSetAttribute(wavenet_proj_kernel<BF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TL::ONE_SMEM);
  if (err != cudaSuccess) return err;
  wavenet_proj_kernel<BF><<<dim3((T + TM - 1) / TM, B), NT, TL::ONE_SMEM, stream>>>(
      x, y, lengths, w1, b1, T, len_shift, leaky);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mucon_wavenet_layer(const float* x, float* y, const int* lengths,
                                   const float* w3, const float* b3,
                                   const float* w1, const float* b1, int B, int T,
                                   int channels, int d, int len_shift, int pool,
                                   int pool_mean, int leaky, int final_proj, int bf16,
                                   cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && (T % 2)) || (final_proj && pool))
    return cudaErrorInvalidValue;
  if (bf16)
    return wavenet_layer<true>(x, y, lengths, w3, b3, w1, b1, B, T, d, len_shift, pool,
                               pool_mean, leaky, final_proj, stream);
  return wavenet_layer<false>(x, y, lengths, w3, b3, w1, b1, B, T, d, len_shift, pool,
                              pool_mean, leaky, final_proj, stream);
}
