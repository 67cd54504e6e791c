// Fused mutual-consistency ("flint") loss with the box template, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_flint_kernel` (mucon_tpu/ops/mucon_loss_pallas.py:69,
// called at :177), which built every video's [N, T] box masks in VMEM, ran the
// [N, T] x [T, M] window product on the MXU and emitted the per-video NLL.
//
// Per video b, from the per-segment placement the caller computes
// (scale, xloc and the divisor, `ops/mucon_loss.py flint_prep`):
//   c[n, t]   = (scale[n] g(t) + xloc[n] + 1) (W - 1) / 2,  g(t) = -1 + 2t / max(T_b - 1, 1)
//   mask[n,t] = clip(min(c + 1, W - c), 0, 1), 0 where c <= -1 or c >= W,
//               and 0 for n >= N_b or t >= T_b                     (W = 100)
//   window    = mask seg_b / sdiv[n]                                [N, M]
//   loss[b]   = - sum_n w_n log_softmax(window[n])[tgt_n] / sum_n w_n,
//               w_n = class_weight[tgt_n] (or 1) for n < N_b, else 0
//
// Per video, a thread-block cluster of CL CTAs (CL <= 16, `cuda.flint_plan`:
// B CL fills the card's 132 SMs at the train batch B = 8) splits the valid
// frames into CL runs of ceil(T_b / CL).  Each CTA walks its run in tiles of
// TT: it stages the tile of seg in shared memory, builds the tile's mask
// rows in closed form, and each thread adds the tile into the (n, m) window
// entries it owns, in frame order, in its own [N, M] partial.  After a
// cluster barrier, CTA r sums the r-th slice of the (n, m) entries over the
// CL partials in rank order, through distributed shared memory, into rank
// 0's partial; after a second barrier rank 0 takes the log-softmax NLL.  The
// masks never touch device memory and seg is read once.  Fixed-order sums
// and no atomics: the kernel repeats bit for bit.
//
// Bound on this card: the N M T_b multiply-adds from shared memory (4.9
// MFLOP a video at N = 30, M = 48, T_b = 1700) on B CL SMs, against a bytes
// bound (seg's valid frames once, ~2.6 MB at B = 8) of under a microsecond.

#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

constexpr int TT = 64;       // frames per tile
constexpr int NTF = 256;     // threads a CTA
constexpr int MAX_CL = 16;   // CTAs a cluster (above 8: non-portable size)
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

__global__ void __launch_bounds__(NTF) flint_kernel(
    const float* __restrict__ scale,  // [B, N]
    const float* __restrict__ xloc,   // [B, N]
    const float* __restrict__ sdiv,   // [B, N]
    const float* __restrict__ seg,    // [B, T, M]
    const int* __restrict__ tgt,      // [B, N]
    const int* __restrict__ n_len,    // [B]
    const int* __restrict__ t_valid,  // [B]
    const float* __restrict__ cw,     // [M] or null
    float* __restrict__ out,          // [B]
    int N, int T, int M, int cl) {
  extern __shared__ float sm[];
  float* acc = sm;              // [N, M] this CTA's window sums
  float* segt = acc + N * M;    // [TT, M]
  float* mk = segt + TT * M;    // [N, TT]
  float* num = mk + N * TT;     // [N]
  float* den = num + N;         // [N]

  const int b = blockIdx.x / cl;
  const int rank = (int)cluster::cluster_rank();
  const int nv = min(n_len[b], N);
  const int tvi = t_valid[b];
  const int tv = min(tvi, T);
  const float gden = fmaxf((float)tvi - 1.f, 1.f);
  const float* sb = seg + (size_t)b * T * M;
  const int run = (max(tv, 0) + cl - 1) / cl;
  const int t_lo = rank * run, t_hi = min(tv, t_lo + run);

  for (int i = threadIdx.x; i < N * M; i += NTF) acc[i] = 0.f;
  for (int t0 = t_lo; t0 < t_hi; t0 += TT) {
    const int nt = min(TT, t_hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * M; i += NTF) segt[i] = sb[(size_t)t0 * M + i];
    for (int i = threadIdx.x; i < N * TT; i += NTF) {
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
    for (int p = threadIdx.x; p < nv * M; p += NTF) {
      const int n = p / M, m = p - n * M;
      const float* mr = mk + n * TT;
      float a = acc[p];
      for (int tt = 0; tt < nt; ++tt) a = fmaf(mr[tt], segt[tt * M + m], a);
      acc[p] = a;
    }
  }

  // rank r sums slice r of the entries over the ranks' partials, in rank
  // order, into rank 0's partial
  cluster::cluster_sync();
  const int P = nv * M, slice = (P + cl - 1) / cl;
  float* acc0 = cluster::cluster_peer(acc, 0);
  for (int p = rank * slice + threadIdx.x; p < min(P, (rank + 1) * slice); p += NTF) {
    float a = acc0[p];
    for (int r = 1; r < cl; ++r) a += cluster::cluster_peer(acc, r)[p];
    acc0[p] = a;
  }
  cluster::cluster_sync();
  if (rank != 0) return;

  // one warp per segment row: log-softmax over M, the target's NLL term
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < N; n += NTF / 32) {
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

// cl: the cluster width, a power of two <= 16 (`cuda.flint_plan`)
extern "C" int mucon_flint(const float* scale, const float* xloc, const float* sdiv,
                           const float* seg, const int* tgt, const int* n_len,
                           const int* t_valid, const float* class_weights, float* out,
                           int B, int N, int T, int M, int cl, cudaStream_t stream) {
  if (B < 1 || N < 1 || T < 1 || M < 1 || cl < 1 || cl > MAX_CL || (cl & (cl - 1)))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(N * M + TT * M + N * TT + 2 * N) * sizeof(float);
  static bool wide = false;  // clusters above 8 CTAs allowed (once a process)
  if (cl > 8 && !wide) {
    cudaError_t err = cudaFuncSetAttribute(
        flint_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  return cluster::launch_cluster(flint_kernel, dim3(B * cl), dim3(NTF), cl, smem, stream,
                                 scale, xloc, sdiv, seg, tgt, n_len, t_valid, class_weights,
                                 out, N, T, M, cl);
}
