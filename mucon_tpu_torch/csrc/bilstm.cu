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
//
// Training (replaces `_bilstm_train_fwd_kernel` / `_bilstm_train_call` and
// `_bilstm_bwd_kernel` / `_bilstm_train_bwd_rule`, lstm_pallas.py:137, :249,
// :177, :275): the same forward kernel also writes the cell trajectory cs
// [T, 2, B, H] when given a pointer; `bilstm_bwd_kernel` runs the reverse
// (dh, dc) chain over t = T-1 .. 0 per direction and batch tile:
//
//   replay the gates from h_prev = outs[t-1], c_prev = cs[t-1] (0 at t = 0)
//   dh_t = dh + douts[t];  split by the freeze mask m into the step's share
//   (m dh_t, m dc) and the carried share ((1-m) dh_t, (1-m) dc)
//   dxp[t] = dgate = (di i(1-i), df f(1-f), dg (1-g^2), do o(1-o))
//   dh <- dgate w_hh^T + (1-m) dh_t,  dc <- dct f + (1-m) dc
//
// dgate w_hh^T reads w_hh along its rows; the wrapper passes a transposed
// copy w_hh^T [2, 4H, H] so that thread j (an output column) reads it
// coalesced, with the 4H-long sum split over 4 thread groups and added in
// shared memory.  Both products of a step are in the kernel; the w_hh
// gradient (a sum over T of h_prev^T dgate) is left to the caller, as the
// JAX package leaves it to XLA.

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
                              float* __restrict__ cs_out,      // [T, 2, B, H] or null
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
      const size_t o = (((size_t)t * 2 + dir) * B + b0 + r) * H + j;
      outs[o] = h;
      if (cs_out) cs_out[o] = cs[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H;
    h_fin[((size_t)dir * B + b0 + r) * H + j] = hs[i];
    c_fin[((size_t)dir * B + b0 + r) * H + j] = cs[i];
  }
}

__global__ void bilstm_bwd_kernel(const float* __restrict__ xp,     // [T, 2, B, 4H]
                                  const float* __restrict__ m,      // [T, B]
                                  const float* __restrict__ w_hh,   // [2, H, 4H]
                                  const float* __restrict__ w_hht,  // [2, 4H, H]
                                  const float* __restrict__ outs,   // [T, 2, B, H]
                                  const float* __restrict__ cs,     // [T, 2, B, H]
                                  const float* __restrict__ douts,  // [T, 2, B, H]
                                  const float* __restrict__ dh_fin, // [2, B, H]
                                  const float* __restrict__ dc_fin, // [2, B, H]
                                  float* __restrict__ dxp,          // [T, 2, B, 4H]
                                  int T, int B, int H) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* hp = sm;            // [BT][H] h_prev
  float* cp = hp + BT * H;   // [BT][H] c_prev
  float* dh = cp + BT * H;   // [BT][H] carried dh
  float* dc = dh + BT * H;   // [BT][H] carried dc
  float* gs = dc + BT * H;   // [BT][G] gates, then dgate
  float* red = gs + BT * G;  // [4][BT][H] partial sums of dgate w_hh^T

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const float* w = w_hh + (size_t)dir * H * G;
  const float* wt = w_hht + (size_t)dir * G * H;

  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H;
    dh[i] = dh_fin[((size_t)dir * B + b0 + r) * H + j];
    dc[i] = dc_fin[((size_t)dir * B + b0 + r) * H + j];
  }
  for (int t = T - 1; t >= 0; --t) {
    for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      float hv = 0.f, cv = 0.f;
      if (t > 0 && r < nb) {
        const size_t o = (((size_t)(t - 1) * 2 + dir) * B + b0 + r) * H + j;
        hv = outs[o];
        cv = cs[o];
      }
      hp[i] = hv;
      cp[i] = cv;
    }
    __syncthreads();
    const float* xpt = xp + (((size_t)t * 2 + dir) * B + b0) * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {  // replay the gates
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wv = __ldg(w + (size_t)k * G + g);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hp[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (r < nb) gs[r * G + g] = xpt[(size_t)r * G + g] + acc[r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      float* gr = gs + r * G;
      const float ig = sigmoidf(gr[j]);
      const float fg = sigmoidf(gr[H + j]);
      const float gg = tanhf(gr[2 * H + j]);
      const float og = sigmoidf(gr[3 * H + j]);
      const float tc = tanhf(fg * cp[i] + ig * gg);
      const size_t o = (((size_t)t * 2 + dir) * B + b0 + r) * H + j;
      const float mt = m[(size_t)t * B + b0 + r];
      const float dht = dh[i] + douts[o];
      const float dhn = dht * mt, dcn = dc[i] * mt;
      const float dct = dhn * og * (1.f - tc * tc) + dcn;
      const float d_i = dct * gg * ig * (1.f - ig);
      const float d_f = dct * cp[i] * fg * (1.f - fg);
      const float d_g = dct * ig * (1.f - gg * gg);
      const float d_o = dhn * tc * og * (1.f - og);
      gr[j] = d_i;
      gr[H + j] = d_f;
      gr[2 * H + j] = d_g;
      gr[3 * H + j] = d_o;
      float* dxr = dxp + (((size_t)t * 2 + dir) * B + b0 + r) * G;
      dxr[j] = d_i;
      dxr[H + j] = d_f;
      dxr[2 * H + j] = d_g;
      dxr[3 * H + j] = d_o;
      dc[i] = dct * fg + dc[i] * (1.f - mt);
      dh[i] = dht * (1.f - mt);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * H; i += blockDim.x) {  // dgate w_hh^T
      const int q = i / H, j = i - q * H;
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      for (int g = q * H; g < (q + 1) * H; ++g) {
        const float wv = __ldg(wt + (size_t)g * H + j);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(gs[r * G + g], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) red[(q * BT + r) * H + j] = acc[r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      dh[i] += ((red[r * H + j] + red[(BT + r) * H + j]) + red[(2 * BT + r) * H + j]) +
               red[(3 * BT + r) * H + j];
    }
    __syncthreads();
  }
}

int set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Forward recurrence; `cs` (the cell trajectory [T, 2, B, H]) may be null.
extern "C" int mucon_bilstm_recurrence(const float* xp, const float* m,
                                       const float* w_hh, float* outs, float* h_fin,
                                       float* c_fin, float* cs, int T, int B, int H,
                                       cudaStream_t stream) {
  if (T < 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  const size_t smem = (size_t)(2 * BT * H + BT * G) * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem((const void*)bilstm_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, h_fin, c_fin, cs,
                                                 T, B, H);
  return cudaGetLastError();
}

// Reverse chain of the training recurrence: dxp [T, 2, B, 4H] from the
// stashed outs / cs and the cotangents of outs, h_fin and c_fin.
extern "C" int mucon_bilstm_backward(const float* xp, const float* m,
                                     const float* w_hh, const float* w_hht,
                                     const float* outs, const float* cs,
                                     const float* douts, const float* dh_fin,
                                     const float* dc_fin, float* dxp, int T, int B,
                                     int H, cudaStream_t stream) {
  if (T < 0 || B <= 0 || H <= 0 || 4 * H > 1024) return cudaErrorInvalidValue;
  const int G = 4 * H;
  const int threads = ((G + 31) / 32) * 32;
  const size_t smem = (size_t)(4 * BT * H + BT * G + 4 * BT * H) * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem((const void*)bilstm_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_bwd_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, w_hht, outs, cs, douts,
                                                     dh_fin, dc_fin, dxp, T, B, H);
  return cudaGetLastError();
}
