// Two-direction masked LSTM recurrence as one persistent kernel, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bilstm_kernel` / `bilstm_recurrence_pallas`
// (mucon_tpu/ops/lstm_pallas.py:33, :90), which held w_hh, xp and the state in
// VMEM and ran the time loop in-kernel.  Here the grid is 2 directions x
// ceil(B / BT) batch tiles; each CTA runs the whole T loop for its tile with
// h, c and the [BT x 4H] gate scratch in shared memory (24 KiB at H = 128).
//
//   gates = xp[t, dir, b] + h @ w_hh[dir]          (b_ih, b_hh folded in xp)
//   i, f, o = sigmoid, g = tanh;  c' = f c + i g;  h' = o tanh(c')
//   h = m h' + (1 - m) h,  c = m c' + (1 - m) c    (state freezes where m = 0)
//   outs[t, dir, b] = h                            (written every step)
//
// Bound: the sequential chain.  w_hh per direction (128 x 512 f32 = 256 KiB)
// exceeds shared memory, so every step reads it from global memory, where it
// stays resident in L2; one thread per gate column reads it coalesced and
// reuses each value for the BT rows of its tile.  A cluster / DSMEM split of
// w_hh is later work.

#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;  // batch rows per CTA

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void bilstm_kernel(const float* __restrict__ xp,    // [T, 2, B, 4H]
                              const float* __restrict__ m,     // [T, B]
                              const float* __restrict__ w_hh,  // [2, H, 4H]
                              float* __restrict__ outs,        // [T, 2, B, H]
                              float* __restrict__ h_fin,       // [2, B, H]
                              float* __restrict__ c_fin,       // [2, B, H]
                              int T, int B, int H) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* hs = sm;           // [BT][H]
  float* cs = hs + BT * H;  // [BT][H]
  float* gs = cs + BT * H;  // [BT][G]

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const float* w = w_hh + (size_t)dir * H * G;

  for (int i = threadIdx.x; i < 2 * BT * H; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xpt = xp + (((size_t)t * 2 + dir) * B + b0) * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wv = __ldg(w + (size_t)k * G + g);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hs[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (r < nb) gs[r * G + g] = xpt[(size_t)r * G + g] + acc[r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      const float* gr = gs + r * G;
      const float ig = sigmoidf(gr[j]);
      const float fg = sigmoidf(gr[H + j]);
      const float gg = tanhf(gr[2 * H + j]);
      const float og = sigmoidf(gr[3 * H + j]);
      const float c_new = fg * cs[i] + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float mt = m[(size_t)t * B + b0 + r];
      const float h = mt * h_new + (1.f - mt) * hs[i];
      cs[i] = mt * c_new + (1.f - mt) * cs[i];
      hs[i] = h;
      outs[(((size_t)t * 2 + dir) * B + b0 + r) * H + j] = h;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H;
    h_fin[((size_t)dir * B + b0 + r) * H + j] = hs[i];
    c_fin[((size_t)dir * B + b0 + r) * H + j] = cs[i];
  }
}

}  // namespace

extern "C" int mucon_bilstm_recurrence(const float* xp, const float* m,
                                       const float* w_hh, float* outs, float* h_fin,
                                       float* c_fin, int T, int B, int H,
                                       cudaStream_t stream) {
  if (T < 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  const size_t smem = (size_t)(2 * BT * H + BT * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, h_fin, c_fin,
                                                 T, B, H);
  return cudaGetLastError();
}
