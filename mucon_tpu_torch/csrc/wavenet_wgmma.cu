// The eval stacks above C = 512 channels on Hopper's own tensor-core path
// (sm_90a): the WaveNet eval stack's layer and out-projection and the
// MS-TCN++ stage's layer and projection, each in 3xTF32 and in the
// bf16-operand mode.  C is a runtime argument, a multiple of the 128-column
// slab (the wrappers zero-pad another C to it, `cuda.stack_width`).
//
// Replaces, above C = 512, the TPU kernels `wavenet_stack_pallas_v2`
// (mucon_tpu/ops/wavenet_pallas_v2.py:151) and `mstcnpp_stack_pallas`
// (mucon_tpu/ops/mstcnpp_pallas.py:151).  The pass bodies live in
// wavenet_wgmma.cuh, which the trainable stack's kernels above 512
// (wavenet_wgmma_train.cu) share.  The trainable stack's v3 forward runs on
// this file's entry points too (`mucon_wgmma_layer` with its dropout mask
// and pre-pool u): an eval layer is a trainable layer's forward without
// dropout, bit for bit.
//
// A layer is two GEMM-shaped passes:
//
//   WaveNet   pass 1  h = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)
//             pass 2  y = mask(m (h W1 + b1) + x), or its pool (m: the
//                     dropout mask of a trainable layer, or none)
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
// Design: wavenet_wgmma.cuh (warp specialised, one persistent CTA an SM,
// a TMA ring, `wgmma` m64n128 with A from registers and the weights as
// K-major TF32 or bf16 planes the wrapper prepares once a call).  Here, a
// kernel a pass.

#include "wavenet_wgmma.cuh"

namespace {

template <bool BF, int KIND>
__global__ void __launch_bounds__(G_THREADS, 1)
    wg_pass_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, const GArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const GShared sh = shared_setup(smem_raw);
  if (threadIdx.x < 32) live_prefix(a, sh.pre, GM);
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    RingPos pos{0, ~0u};
    produce<BF, KIND>(a, Maps{&amap, nullptr, &wmap, nullptr}, sh, pos);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  RingPos pos{0, 0};
  consume<BF, KIND>(a, sh, pos);
}

template <bool BF, int KIND>
cudaError_t pass_launch(const CUtensorMap& amap, const CUtensorMap& wmap, const GArgs& a,
                        cudaStream_t stream) {
  const int smem = pass_smem(a.B);
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

template <bool BF>
cudaError_t layer_launch(const float* x, float* y, float* u_out, float* h, const int* lengths,
                         const void* wt, int nblk, int blk, const float* b3, const float* b1,
                         const float* drop, int B, int T, int C, int d, int len_shift, int pool,
                         int pool_mean, int leaky, cudaStream_t stream) {
  CUtensorMap wmap, xmap, hmap;
  cudaError_t err = weight_map<BF>(&wmap, wt, nblk, C);
  if (err == cudaSuccess) err = tensor_map(&xmap, x, false, (long)B * T, C, GM);
  if (err == cudaSuccess) err = tensor_map(&hmap, h, false, (long)B * T, C, GM);
  if (err != cudaSuccess) return err;
  GArgs a = rows(lengths, nullptr, h, b3, B, T, C, C / GN, blk, nblk, len_shift);
  a.d = d;
  a.leaky = leaky;
  err = pass_launch<BF, K_CONV>(xmap, wmap, a, stream);
  if (err != cudaSuccess) return err;
  a = rows(lengths, x, y, b1, B, T, C, C / GN, blk + 3, nblk, len_shift);
  a.pool = pool;
  a.pool_mean = pool_mean;
  a.leaky = leaky;
  a.drop = drop;
  a.u_out = u_out;
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
  GArgs a = rows(lengths, nullptr, z, bl, B, T, C, C / GN, blk, nblk, len_shift);
  a.leaky = leaky;
  a.a_nonlin = a_nonlin;
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
  GArgs a = rows(lengths, nullptr, ybuf, b3a, B, T, C, 2 * C / GN, blk, nblk, len_shift);
  a.bias2 = b3b;
  a.d = d1;
  a.d2 = d2;
  err = pass_launch<BF, K_MS_CONV>(fmap, wmap, a, stream);
  if (err != cudaSuccess) return err;
  a = rows(lengths, f, y, b1, B, T, C, C / GN, blk, nblk, len_shift);
  a.pool = pool;
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

// One WaveNet layer at C > 512 channels (a multiple of 128), eval or
// trainable: pass 1 into h (nonlin(z) at rows t < len: a trainable layer's
// stash), then pass 2 into y (and a pooled layer's pre-pool u into u_out,
// if given); drop, the dropout mask, may be null.  wt holds the stack's
// weights as [N x K] blocks, `nblk` a plane (2 TF32 planes, hi and lo;
// bf16: one plane): blocks blk .. blk + 2 the conv's taps, blk + 3 W1.
extern "C" int mucon_wgmma_layer(const float* x, float* y, float* u_out, float* h,
                                 const int* lengths, const void* wt, int nblk, int blk,
                                 const float* b3, const float* b1, const float* drop, int B,
                                 int T, int channels, int d, int len_shift, int pool,
                                 int pool_mean, int leaky, int bf16, cudaStream_t stream) {
  if (bad_args(B, T, channels, nblk, blk, 4) || (pool && T % 2) || !h)
    return cudaErrorInvalidValue;
  return bf16 ? layer_launch<true>(x, y, u_out, h, lengths, wt, nblk, blk, b3, b1, drop, B, T,
                                   channels, d, len_shift, pool, pool_mean, leaky, stream)
              : layer_launch<false>(x, y, u_out, h, lengths, wt, nblk, blk, b3, b1, drop, B, T,
                                    channels, d, len_shift, pool, pool_mean, leaky, stream);
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
  (void)bf16;
  return (G_MAX_SMEM - pass_smem(0)) / 4;
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
    out[5 * k + 2] = pass_smem(128);
    out[5 * k + 3] = G_THREADS;
    out[5 * k + 4] = 1;
  }
  return cudaSuccess;
}
