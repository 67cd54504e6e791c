// Fused mutual-consistency ("flint") loss with the box template, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_flint_kernel` (mucon_tpu/ops/mucon_loss_pallas.py:69,
// called at :177), which built every video's [N, T] box masks in VMEM, ran the
// [N, T] x [T, M] window product on the MXU and emitted the per-video NLL.
//
// Per video b (one CTA), from the per-segment placement the caller computes
// (scale, xloc and the divisor, `ops/mucon_loss.py flint_prep`):
//   c[n, t]   = (scale[n] g(t) + xloc[n] + 1) (W - 1) / 2,  g(t) = -1 + 2t / max(T_b - 1, 1)
//   mask[n,t] = clip(min(c + 1, W - c), 0, 1), 0 where c <= -1 or c >= W,
//               and 0 for n >= N_b or t >= T_b                     (W = 100)
//   window    = mask seg_b / sdiv[n]                                [N, M]
//   loss[b]   = - sum_n w_n log_softmax(window[n])[tgt_n] / sum_n w_n,
//               w_n = class_weight[tgt_n] (or 1) for n < N_b, else 0
//
// The kernel walks the video's valid frames in tiles of TT: it stages the
// tile of seg in shared memory, builds the tile's mask rows in closed form,
// and each thread adds the tile into the (n, m) window entries it owns, in
// frame order, in shared memory.  The masks never touch device memory; seg is
// read once.  Fixed-order sums and no atomics: the kernel repeats bit for bit.
//
// Bound on this card: the N M T_b multiply-adds from shared memory, on B
// CTAs; at B = 8, T = 2560, N = 30, M = 48 that is a few tens of
// microseconds of one SM each, against a bytes bound (seg once, 3.9 MB) of
// about a microsecond over the whole card.  One CTA per video is the simple
// design; splitting T over CTAs (with a second pass to add the splits) is
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TT = 64;       // frames per tile
constexpr float TW = 100.f;  // template width

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void flint_kernel(const float* __restrict__ scale,  // [B, N]
                             const float* __restrict__ xloc,   // [B, N]
                             const float* __restrict__ sdiv,   // [B, N]
                             const float* __restrict__ seg,    // [B, T, M]
                             const int* __restrict__ tgt,      // [B, N]
                             const int* __restrict__ n_len,    // [B]
                             const int* __restrict__ t_valid,  // [B]
                             const float* __restrict__ cw,     // [M] or null
                             float* __restrict__ out,          // [B]
                             int N, int T, int M) {
  extern __shared__ float sm[];
  float* acc = sm;              // [N, M] window sums
  float* segt = acc + N * M;    // [TT, M]
  float* mk = segt + TT * M;    // [N, TT]
  float* num = mk + N * TT;     // [N]
  float* den = num + N;         // [N]

  const int b = blockIdx.x;
  const int nv = min(n_len[b], N);
  const int tvi = t_valid[b];
  const int tv = min(tvi, T);
  const float gden = fmaxf((float)tvi - 1.f, 1.f);
  const float* sb = seg + (size_t)b * T * M;

  for (int i = threadIdx.x; i < N * M; i += blockDim.x) acc[i] = 0.f;
  for (int t0 = 0; t0 < tv; t0 += TT) {
    const int nt = min(TT, tv - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * M; i += blockDim.x) segt[i] = sb[(size_t)t0 * M + i];
    for (int i = threadIdx.x; i < N * TT; i += blockDim.x) {
      const int n = i / TT, tt = i - n * TT;
      float m = 0.f;
      if (n < nv && tt < nt) {
        const float g = -1.f + 2.f * (float)(t0 + tt) / gden;
        const float c = (scale[b * N + n] * g + xloc[b * N + n] + 1.f) * 0.5f * (TW - 1.f);
        m = (c <= -1.f || c >= TW) ? 0.f : fminf(fmaxf(fminf(c + 1.f, TW - c), 0.f), 1.f);
      }
      mk[i] = m;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < nv * M; p += blockDim.x) {
      const int n = p / M, m = p - n * M;
      const float* mr = mk + n * TT;
      float a = acc[p];
      for (int tt = 0; tt < nt; ++tt) a = fmaf(mr[tt], segt[tt * M + m], a);
      acc[p] = a;
    }
  }
  __syncthreads();

  // one warp per segment row: log-softmax over M, the target's NLL term
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int n = warp; n < N; n += nw) {
    const float d = sdiv[b * N + n];
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, acc[n * M + m] / d);
    mx = warp_max(mx);
    float se = 0.f;
    for (int m = lane; m < M; m += 32) se += expf(acc[n * M + m] / d - mx);
    se = warp_sum(se);
    if (lane == 0) {
      const int t = min(max(tgt[b * N + n], 0), M - 1);
      const float w = n < nv ? (cw ? cw[t] : 1.f) : 0.f;
      num[n] = w * (acc[n * M + t] / d - mx - logf(se));
      den[n] = w;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, w = 0.f;
    for (int n = 0; n < N; ++n) {
      s += num[n];
      w += den[n];
    }
    out[b] = -s / fmaxf(w, 1e-12f);
  }
}

}  // namespace

extern "C" int mucon_flint(const float* scale, const float* xloc, const float* sdiv,
                           const float* seg, const int* tgt, const int* n_len,
                           const int* t_valid, const float* class_weights, float* out,
                           int B, int N, int T, int M, cudaStream_t stream) {
  if (B < 1 || N < 1 || T < 1 || M < 1) return cudaErrorInvalidValue;
  const int threads = 512;
  const size_t smem = (size_t)(N * M + TT * M + N * TT + 2 * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute((const void*)flint_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  flint_kernel<<<B, threads, smem, stream>>>(scale, xloc, sdiv, seg, tgt, n_len, t_valid,
                                             class_weights, out, N, T, M);
  return cudaGetLastError();
}
