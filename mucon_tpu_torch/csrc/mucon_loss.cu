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
// masks never touch device memory.  Fixed-order sums and no atomics: the
// kernel repeats bit for bit.
//
// Where the [N, M] partial, seg's [TT, M] tile and the [N, TT] mask rows
// do not fit a CTA's shared memory (M above ~590 classes at N = 31, or N
// above ~480 segments), the kernel walks the window in chunks of mc classes
// (and, where N alone is too large, of nc segments), `cuda.flint_plan`:
// each chunk is the pass above on its [nc, mc] columns, seg's chunk read
// once a chunk.  Rank 0 carries each row's log-softmax across the class
// chunks as a running max and a sum of exp(logit - max), rescaled where the
// max grows, and the target's logit from the chunk that holds it.  One
// chunk (the default shape) is the same adds in the same order as the
// single pass.
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

// Shared-memory floats of a CTA at chunks of nc segments and mc classes:
// the [nc, mc] window partial, seg's [TT, mc] tile, the [nc, TT] mask rows
// and five [nc] vectors (running max, running sum, target logit, NLL term,
// weight)
size_t flint_floats(int nc, int mc) {
  return (size_t)nc * mc + (size_t)TT * mc + (size_t)nc * TT + (size_t)5 * nc;
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
    int N, int T, int M, int cl, int nc, int mc) {
  extern __shared__ float sm[];
  float* acc = sm;               // [nc, mc] this CTA's window sums of the chunk
  float* segt = acc + nc * mc;   // [TT, mc]
  float* mk = segt + TT * mc;    // [nc, TT]
  float* rmx = mk + nc * TT;     // [nc] running max of the rows' logits
  float* rse = rmx + nc;         // [nc] running sum of exp(logit - max)
  float* rxt = rse + nc;         // [nc] the target's logit
  float* num = rxt + nc;         // [nc]
  float* den = num + nc;         // [nc]

  const int b = blockIdx.x / cl;
  const int rank = (int)cluster::cluster_rank();
  const int nv = min(n_len[b], N);
  const int tvi = t_valid[b];
  const int tv = min(tvi, T);
  const float gden = fmaxf((float)tvi - 1.f, 1.f);
  const float* sb = seg + (size_t)b * T * M;
  const int run = (max(tv, 0) + cl - 1) / cl;
  const int t_lo = rank * run, t_hi = min(tv, t_lo + run);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s_all = 0.f, w_all = 0.f;  // thread 0 of rank 0: the NLL sums, in segment order

  for (int n0 = 0; n0 < N; n0 += nc) {
    const int ncn = min(nc, N - n0);                // the chunk's segments
    const int ncv = max(0, min(ncn, nv - n0));      // of them valid
    for (int m0 = 0; m0 < M; m0 += mc) {
      const int mcn = min(mc, M - m0);              // the chunk's classes
      __syncthreads();  // rank 0 has read the previous chunk's sums
      for (int i = threadIdx.x; i < ncn * mcn; i += NTF) acc[i] = 0.f;
      for (int t0 = t_lo; t0 < t_hi; t0 += TT) {
        const int nt = min(TT, t_hi - t0);
        __syncthreads();  // the previous tile is consumed
        if (mcn == M) {
          for (int i = threadIdx.x; i < nt * M; i += NTF) segt[i] = sb[(size_t)t0 * M + i];
        } else {
          for (int i = threadIdx.x; i < nt * mcn; i += NTF) {
            const int tt = i / mcn, m = i - tt * mcn;
            segt[i] = sb[(size_t)(t0 + tt) * M + m0 + m];
          }
        }
        for (int i = threadIdx.x; i < ncn * TT; i += NTF) {
          const int n = i / TT, tt = i - n * TT;
          float m = 0.f;
          if (n < ncv && tt < nt) {
            const int bn = b * N + n0 + n;
            const float g = -1.f + 2.f * (float)(t0 + tt) / gden;
            const float c = (scale[bn] * g + xloc[bn] + 1.f) * 0.5f * (TW - 1.f);
            m = (c <= -1.f || c >= TW) ? 0.f : fminf(fmaxf(fminf(c + 1.f, TW - c), 0.f), 1.f);
          }
          mk[i] = m;
        }
        __syncthreads();
        for (int p = threadIdx.x; p < ncv * mcn; p += NTF) {
          const int n = p / mcn, m = p - n * mcn;
          const float* mr = mk + n * TT;
          float a = acc[p];
          for (int tt = 0; tt < nt; ++tt) a = fmaf(mr[tt], segt[tt * mcn + m], a);
          acc[p] = a;
        }
      }

      // rank r sums slice r of the entries over the ranks' partials, in rank
      // order, into rank 0's partial
      cluster::cluster_sync();
      const int P = ncv * mcn, slice = (P + cl - 1) / cl;
      float* acc0 = cluster::cluster_peer(acc, 0);
      for (int p = rank * slice + threadIdx.x; p < min(P, (rank + 1) * slice); p += NTF) {
        float a = acc0[p];
        for (int r = 1; r < cl; ++r) a += cluster::cluster_peer(acc, r)[p];
        acc0[p] = a;
      }
      cluster::cluster_sync();
      if (rank != 0) continue;

      // one warp per segment row: the log-softmax's max and sum over M,
      // carried from chunk to chunk of classes (one chunk: the row's own)
      const bool first = m0 == 0, last = m0 + mcn == M;
      for (int n = warp; n < ncn; n += NTF / 32) {
        const int bn = b * N + n0 + n;
        const float d = sdiv[bn];
        const float* row = acc + n * mcn;
        float cmx = -INFINITY;
        for (int m = lane; m < mcn; m += 32) cmx = fmaxf(cmx, row[m] / d);
        cmx = warp_max(cmx);
        const float mx = first ? cmx : fmaxf(rmx[n], cmx);
        float se = 0.f;
        for (int m = lane; m < mcn; m += 32) se += expf(row[m] / d - mx);
        se = warp_sum(se);
        if (lane == 0) {
          if (!first) se += rse[n] * expf(rmx[n] - mx);
          rmx[n] = mx;
          rse[n] = se;
          const int t = min(max(tgt[bn], 0), M - 1);
          if (t >= m0 && t < m0 + mcn) rxt[n] = row[t - m0] / d;
          if (last) {
            const float w = n0 + n < nv ? (cw ? cw[t] : 1.f) : 0.f;
            num[n] = w * (rxt[n] - mx - logf(se));
            den[n] = w;
          }
        }
      }
      if (last) {
        __syncthreads();
        if (threadIdx.x == 0)
          for (int n = 0; n < ncn; ++n) {
            s_all += num[n];
            w_all += den[n];
          }
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) out[b] = -s_all / fmaxf(w_all, 1e-12f);
}

}  // namespace

extern "C" size_t mucon_flint_smem(int nc, int mc) {
  return flint_floats(nc, mc) * sizeof(float);
}

// cl: the cluster width, a power of two <= 16; nc, mc: the segments and
// classes of a chunk (`cuda.flint_plan`)
extern "C" int mucon_flint(const float* scale, const float* xloc, const float* sdiv,
                           const float* seg, const int* tgt, const int* n_len,
                           const int* t_valid, const float* class_weights, float* out,
                           int B, int N, int T, int M, int cl, int nc, int mc,
                           cudaStream_t stream) {
  if (B < 1 || N < 1 || T < 1 || M < 1 || cl < 1 || cl > MAX_CL || (cl & (cl - 1)) ||
      nc < 1 || nc > N || mc < 1 || mc > M)
    return cudaErrorInvalidValue;
  const size_t smem = flint_floats(nc, mc) * sizeof(float);  // `cuda.flint_plan` checks the limit
  static bool wide = false;  // clusters above 8 CTAs allowed (once a process)
  if (cl > 8 && !wide) {
    cudaError_t err = cudaFuncSetAttribute(
        flint_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  return cluster::launch_cluster(flint_kernel, dim3(B * cl), dim3(NTF), cl, smem, stream,
                                 scale, xloc, sdiv, seg, tgt, n_len, t_valid, class_weights,
                                 out, N, T, M, cl, nc, mc);
}
