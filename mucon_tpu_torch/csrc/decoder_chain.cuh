// What the decoder chain's kernels share (csrc/decoder_chain.cu, the
// cluster kernels; csrc/decoder_persistent.cu, the card-wide persistent
// ones): the widths, the splits that fix every sum's order, the step's
// elementwise arithmetic and the warp reductions.  The persistent kernels
// sum in the cluster kernels' orders (each a function of H, and of Tz for
// the frames), so both routes give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace dchain {

constexpr float NEG = -1e30f;
constexpr int MAX_CL = 8;          // the forward's cluster above H = MAX_H
constexpr int MAX_H = 512;         // the widest hidden size of the narrow reverse chain
constexpr int MAX_H_WIDE = 2048;   // the widest hidden size the chains take
constexpr int NTB = 256;           // threads per CTA of the chain (the even split)
constexpr int NTW = 512;           // threads per CTA of the chain (the ragged split)

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// f c + i g, rounded as one fused product-add of f c onto the rounded i g
__device__ __forceinline__ float cell(float f, float c, float i, float g) {
  return __fmaf_rn(f, c, __fmul_rn(i, g));
}

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

// sum over k = k0, k0 + G, ... < K of x[k] w[k ldw], in four interleaved
// chains added in a fixed order
__device__ __forceinline__ float dot_strided(const float* x, const float* w, int ldw, int k0,
                                             int K, int G) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = k0;
  for (; k + 3 * G < K; k += 4 * G) {
    a0 = fmaf(x[k], w[k * ldw], a0);
    a1 = fmaf(x[k + G], w[(k + G) * ldw], a1);
    a2 = fmaf(x[k + 2 * G], w[(k + 2 * G) * ldw], a2);
    a3 = fmaf(x[k + 3 * G], w[(k + 3 * G) * ldw], a3);
  }
  for (; k < K; k += G) a0 = fmaf(x[k], w[k * ldw], a0);
  return (a0 + a1) + (a2 + a3);
}

// How the forward splits H over a cluster: CL = cluster::ragged_width(H)
// CTAs (8 from H = 64), CTA r taking the units cluster::units_of(r, CL, H)
// and frames [r Tz / CL, (r + 1) Tz / CL); HS the largest share.  The
// persistent forward keeps CL as the ranks of its sums: q's partials over
// each rank's units and the softmax partials over each rank's frames,
// added in rank order.
struct FwdPlan {
  int cl, hs;
};

inline bool fwd_plan(int H, FwdPlan& p) {
  if (H < 1 || H > MAX_H_WIDE) return false;
  p.cl = H > MAX_H ? MAX_CL : cluster::ragged_width(H);
  p.hs = (H + p.cl - 1) / p.cl;
  return true;
}

// How the reverse chain splits H over a cluster.  The even split: CL =
// cluster::width_for(H) CTAs of HS units, HS a multiple of 4 (16-byte copies
// of u's columns); [dgate] x [Wih; Whh]^T for the CTA's 2 HS output columns
// (its units' dcomb and dh parts) over NQ groups of RQ dgate rows (a
// multiple of 4, at most 64: the weights a thread keeps in registers); one
// thread per unit (H <= NTB).  Where that does not hold (H = 96, 100, an odd
// H, H above 128), the ragged split (gw): CL = cluster::ragged_width(H) CTAs, CTA r
// taking units [r H / CL, (r + 1) H / CL) (HS the most), on NTW threads (a
// thread a unit up to MAX_H), u's columns copied 4 bytes at a time, and the
// [Wih; Whh] rows and Wl2's columns read from L2 every step.  Above MAX_H
// the ragged split with NQ = NTW / HS.  The persistent reverse chain keeps
// (CL, HS, NQ, RQ) as the ranks and row groups of its sums.
struct BwdPlan {
  int cl, hs, nq, rq, nt;
  bool gw;
};

inline bool bwd_plan(int H, BwdPlan& p) {
  if (H < 1 || H > MAX_H_WIDE) return false;
  if (H > MAX_H) {  // NQ groups so that the products make about two passes
    p.cl = cluster::ragged_width(H);
    p.hs = (H + p.cl - 1) / p.cl;
    p.nt = NTW;
    p.gw = true;
    p.nq = NTW / p.hs > 1 ? NTW / p.hs : 1;
    p.rq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
    return true;
  }
  p.cl = cluster::width_for(H);
  p.hs = H / p.cl;
  p.nt = NTB;
  p.gw = false;
  if (H >= 4 && H <= NTB && p.hs % 4 == 0 && p.hs <= 32) {
    p.nq = NTB / (2 * p.hs);
    p.rq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
    if (p.rq <= 64) return true;
  }
  p.cl = cluster::ragged_width(H);
  p.hs = (H + p.cl - 1) / p.cl;
  p.nt = NTW;
  p.gw = true;
  p.nq = NTW / (2 * p.hs);
  p.rq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
  return true;
}

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// The persistent kernels' launches (csrc/decoder_persistent.cu); each
// returns the launch's error, cudaErrorCooperativeLaunchTooLarge where the
// card cannot hold the grid at once.
struct PersistFwdIO {
  const float *emb, *enc, *pre, *maskf, *h0, *c0;  // items' e [S][NI][H], h0 and c0 [NI][H]
  const float *wl2T, *bl2, *v, *wcT, *bc, *wgT, *bl;
  float *hs, *cs, *comb;               // the forward's [S][NI][H], or null
  float *acts, *cpre, *a, *u, *cell;   // the replay's (NI = S B items of one step), or null
  int NI, S, B, Tz, H, E;
};

cudaError_t persist_fwd(const PersistFwdIO& io, float* scratch, long scratch_floats, int ctas,
                        cudaStream_t stream);
long persist_fwd_scratch(int NI, int H, int E, int Tz, bool replay);

struct PersistBwdIO {
  const float *acts, *cpre, *a, *u, *c_in, *enc, *v, *wc2, *wg, *wl2, *dh_ext, *dc_ext,
      *dcomb_ext;
  float *dgate, *dcpre, *dsc, *dh0, *dc0;
  int S, B, Tz, H, E;
};

cudaError_t persist_bwd(const PersistBwdIO& io, float* scratch, long scratch_floats, int ctas,
                        cudaStream_t stream);
long persist_bwd_scratch(int B, int H, int Tz);

}  // namespace dchain
