// Two-direction masked LSTM recurrence and its reverse chain, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bilstm_kernel` / `bilstm_recurrence_pallas`
// (mucon_tpu/ops/lstm_pallas.py:33, :90), which held w_hh, xp and the state in
// VMEM and ran the time loop in-kernel.
//
//   gates = xp[t, dir, b] + h @ w_hh[dir]          (b_ih, b_hh folded in xp)
//   i, f, o = sigmoid, g = tanh;  c' = f c + i g;  h' = o tanh(c')
//   h = m h' + (1 - m) h,  c = m c' + (1 - m) c    (state freezes where m = 0)
//   outs[t, dir, b] = h                            (written every step)
//
// Bound: the sequential chain, T dependent steps of a [BT x H] x [H x 4H]
// product.  w_hh per direction (128 x 512 f32 = 256 KiB) exceeds one SM's
// shared memory, so `bilstm_fwd_kernel` runs one thread-block cluster per
// (direction, tile of BT videos) and keeps w_hh in the cluster's REGISTERS
// for all T steps.  CTA r of a cluster of CL owns the HS = H / CL hidden
// units j in [r HS, (r+1) HS) and so the 4 HS gate columns {j, H+j, 2H+j,
// 3H+j}: all four gates of its units, so the activations and the c, h update
// are local.  Its threads are NK k-groups x 4 HS columns; thread (kq, col)
// holds w_hh[kq KC : (kq+1) KC, col] (KC = 32 at H = 128, CL = 8: 256
// threads, 32 weights a thread).  Each step:
//   1. every thread's partial products of its KC k-rows for the BT videos,
//      h read from shared memory as float4 (broadcast within a warp);
//   2. `__syncthreads`; the owner of (video, unit) adds the NK partials in
//      group order (no atomics: two calls agree bit for bit), adds xp,
//      applies the gates and the masked update, writes outs (and cs);
//   3. it writes h into every peer's h buffer through distributed shared
//      memory (two buffers, so one cluster barrier a step is enough),
//      loads the next step's xp and m, and the cluster synchronises.
// The width, threads and k-groups follow from H (`fwd_plan`, mirrored by
// `cuda.bilstm_fwd_plan`).  At H = 128 the kernel keeps to 80 registers a
// thread, so three CTAs share an SM and the 32 clusters of the serving
// batch (B = 128) run in one wave (`mucon_bilstm_fwd_plan` reports the
// clusters the card holds at once).
// Every H from 1 to 512 on this kernel (above: `bilstm_fwd_wide_kernel`,
// below): where CL does not divide H into CTAs of at least
// 16 units that fit the threads (an odd H above 64, H = 300), the split is
// ragged: CL = 8 CTAs (fewer below H = 64), CTA r taking units
// [r H / CL, (r + 1) H / CL), ceil(H / CL) or floor(H / CL) of them.  Where a
// thread's KC rows are more than its 64 registers hold (H above 256, or a
// ragged split of few k-groups), the kernel reads its w_hh column from L2
// every step instead (`GW`): the same rows, the same FMA order.
//
// Training (replaces `_bilstm_train_fwd_kernel` / `_bilstm_train_call` and
// `_bilstm_bwd_kernel` / `_bilstm_train_bwd_rule`, lstm_pallas.py:137, :249,
// :177, :275): the same forward kernel also writes the cell trajectory cs
// [T, 2, B, H] when given a pointer.  The reverse (dh, dc) chain over
// t = T-1 .. 0 is two kernels:
//
// 1. `bilstm_coefs_kernel`, parallel over every (t, dir, b) on the whole
//    card.  h_prev = outs[t-1] and c_prev = cs[t-1] are stashed for every t
//    (0 at t = 0), so the gate replay is not sequential: it computes
//    gates = xp[t] + h_prev w_hh (summed in the forward kernel's order, so
//    its gates and cell are the forward's bit for bit), i, f, o = sigmoid,
//    g = tanh, tc = tanh(f c_prev + i g), and writes the six factors of the chain with
//    the freeze mask m folded in, coefs [6, T, 2, B, H]:
//      A = m o (1 - tc^2)   Ci = g i (1 - i)   Cf = c_prev f (1 - f)
//      Cg = i (1 - g^2)     Co = m tc o (1 - o)   F = f
// 2. `bilstm_chain_kernel`, the sequential part, one thread-block cluster
//    per (direction, tile of BT videos):
//      dht = dh + douts[t];  dct = dht A + m dc
//      dxp[t] = dgate = (dct Ci, dct Cf, dct Cg, dht Co)
//      dc <- dct F + (1-m) dc;  dh <- dgate w_hh^T + (1-m) dht
//    (a padded step, m = 0, has dgate = 0 and passes dh + douts[t] and dc on
//    unchanged).  CTA r of a cluster of CL owns the HS = H / CL columns j of
//    dh and dc and keeps its [4H x HS] slice of w_hh^T in REGISTERS for all
//    T steps: thread (q, j) holds the gate rows [q GPQ, (q+1) GPQ) of column
//    j, read once from w_hh (contiguous there, so no transposed copy).
//    dgate's columns {j, H+j, 2H+j, 3H+j} depend on the owner's dh[j] and
//    dc[j] alone, so each step the owner computes them, writes them to dxp
//    and into every CTA's dgate buffer through distributed shared memory;
//    one cluster barrier (two dgate buffers, so one barrier a step is
//    enough); then every thread's partial product of its gate rows for the
//    BT videos from shared memory, and the partial sums added in a fixed
//    order (no atomics: two calls agree bit for bit).  No weight traffic,
//    one cluster barrier and one `__syncthreads` in a step.  The next step's
//    coefficients are loaded before the barrier.  CL follows from H
//    (`chain_plan`): 8 at H = 128 (HS = 16, 32 weights a thread), 1 where H
//    is too small to split.  Where that even split leaves more than 32
//    columns a CTA (an odd H above 32, H above 256), the split is ragged as
//    the forward's, the CTA takes 512 threads (a thread per video and
//    column up to 64 columns) and reads its w_hh rows from L2 every step.
//
// Above H = 512 (up to MAX_H_WIDE = 2048; the JAX package's byte gates stop
// its kernels at H = 1447) both recurrences take a ragged split of CL = 8
// CTAs on NTW = 512 threads that stride over the CTA's (k-group, gate
// column) products and its (video, unit) elements, the state in shared
// memory and the weights read from L2 / device memory every step:
// `bilstm_fwd_wide_kernel` keeps the forward's exchange of h (distributed
// shared memory, two buffers); `bilstm_chain_wide_kernel` exchanges dgate
// through dxp itself (written by the owners, a fence and a cluster barrier,
// then staged GC gate rows at a time into shared memory), so that no
// [BT x 4H] buffer bounds H.  The sums run in the narrow kernels' orders:
// the forward's NK groups of KC rows, the chain's NQ groups of GPQ rows
// (its FMA chain carried across staged chunks through shared memory, which
// rounds nothing), so the twins' split orders hold as they are.
//
// The w_hh gradient (a sum over T of h_prev^T dgate) is left to the caller,
// as the JAX package leaves it to XLA.

#include <cuda_runtime.h>

#include <algorithm>

#include "cluster.cuh"

namespace {

constexpr int BT = 8;  // videos per cluster of the forward and the reverse chain

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// f c + i g, rounded as one fused product-add of f c onto the rounded i g;
// the forward and the coefficient pass both use it, so the replayed cell
// is the stashed one bit for bit
__device__ __forceinline__ float cell(float f, float c, float i, float g) {
  return __fmaf_rn(f, c, __fmul_rn(i, g));
}

constexpr int MAX_H = 512;        // the widest hidden size of the narrow kernels
constexpr int MAX_H_WIDE = 2048;  // the widest hidden size the kernels take
constexpr int WIDE_CL = 8;        // the wide kernels' cluster (a ragged split)
constexpr int NTW = 512;          // threads per CTA of the chain on a ragged split, and
                                  // of both wide kernels

// How the forward splits a hidden size H: CL CTAs of at most HS units, NT
// threads each; NK groups of KC k-rows (a multiple of 4) for each of the
// 4 HS gate columns.  NT is the least of 256, 512 that holds the columns,
// one thread per (video, unit) for BT = 8 videos, and KC <= 64 (the weights
// a thread keeps in registers; the kernel's launch bound is 512).  The even
// split (cluster::width_for) first; where no NT holds it, the ragged split
// (cluster::ragged_width), its weights in registers where KC <= 64, else read from
// L2 (gw).
struct FwdPlan {
  int cl, hs, nt, nk, kc;
  bool gw, wide;
};

bool fwd_split(int H, int cl, int hs, bool any_kc, FwdPlan& p) {
  p.cl = cl;
  p.hs = hs;
  const int cols = 4 * p.hs;
  for (p.nt = 256; p.nt <= 512; p.nt *= 2) {
    if (cols > p.nt || 8 * p.hs > p.nt) continue;
    p.nk = p.nt / cols;
    p.kc = ((H + p.nk - 1) / p.nk + 3) & ~3;
    p.gw = p.kc > 64;
    if (!p.gw || (any_kc && p.nt == 512)) return true;
  }
  return false;
}

bool fwd_plan(int H, FwdPlan& p) {
  if (H <= 0 || H > MAX_H_WIDE) return false;
  p.wide = H > MAX_H;
  if (p.wide) {  // NK groups so that the products are about two passes of the threads
    p.cl = WIDE_CL;
    p.hs = (H + WIDE_CL - 1) / WIDE_CL;
    p.nt = NTW;
    p.nk = std::max(1, 2 * NTW / (4 * p.hs));
    p.kc = ((H + p.nk - 1) / p.nk + 3) & ~3;
    p.gw = true;
    return true;
  }
  const int cl = cluster::width_for(H);
  if (fwd_split(H, cl, H / cl, false, p)) return true;
  const int rl = cluster::ragged_width(H);
  return fwd_split(H, rl, (H + rl - 1) / rl, true, p);
}

// One cluster per (direction, tile of BT videos); grid (CL, tiles, 2),
// cluster (CL, 1, 1).  KC: the register array, >= the plan's kc; at KC = 32
// (256 threads) three CTAs fit an SM, at most 80 registers a thread.  GW:
// no register array, each step reads the thread's kc rows from L2.  RAGGED:
// the CTA's units from `cluster::units_of` (hs is the most a CTA takes);
// else the even split's hs units a CTA.
template <int KC, bool GW = false, bool RAGGED = false>
__global__ void __launch_bounds__(KC <= 32 ? 256 : 512, KC <= 32 ? 3 : 1) bilstm_fwd_kernel(
    const float* __restrict__ xp,    // [T, 2, B, 4H]
    const float* __restrict__ m,     // [T, B]
    const float* __restrict__ w_hh,  // [2, H, 4H]
    float* __restrict__ outs,        // [T, 2, B, H]
    float* __restrict__ h_fin,       // [2, B, H]
    float* __restrict__ c_fin,       // [2, B, H]
    float* __restrict__ cs_out,      // [T, 2, B, H] or null
    int T, int B, int H, int hs, int nk, int kc) {
  extern __shared__ float4 smf4[];
  int j0 = cluster::cluster_rank() * hs;  // this CTA's units
  if constexpr (RAGGED) cluster::units_of(cluster::cluster_rank(), gridDim.x, H, j0, hs);
  const int G = 4 * H, cols = 4 * hs, hp = nk * kc;  // hp: h row stride, 0 past H
  float* hb = reinterpret_cast<float*>(smf4);  // [2][BT][hp] h of the step, all units
  float* red = hb + 2 * BT * hp;               // [nk][BT][cols] partial sums

  const int cl = gridDim.x;
  const int b0 = blockIdx.y * BT;
  const int dir = blockIdx.z;
  const int tid = threadIdx.x;

  // product role: k-rows [k0, k0 + kn) of gate column gcol, weights in registers
  const int pc = tid % cols, kq = tid / cols;
  const bool prod = kq < nk;
  const int gcol = (pc / hs) * H + j0 + pc % hs;
  const int k0 = kq * kc;
  const int kn = prod ? max(0, min(kc, H - k0)) : 0;
  float w[GW ? 1 : KC];
  if constexpr (!GW) {
#pragma unroll
    for (int i = 0; i < KC; ++i)
      w[i] = i < kn ? w_hh[((size_t)dir * H + k0 + i) * G + gcol] : 0.f;
  }

  // element role: (h, c) of video b0 + eb, unit j0 + ej
  const int eb = tid / hs, ej = tid - eb * hs;
  const int bb = b0 + eb, j = j0 + ej;
  const bool active = eb < BT && bb < B;
  float h = 0.f, c = 0.f;
  for (int i = tid; i < 2 * BT * hp; i += blockDim.x) hb[i] = 0.f;  // absent videos stay 0
  cluster::cluster_sync();  // before any peer writes here

  float x[4] = {}, mt = 0.f;  // the step's xp and mask, loaded a step ahead
  auto fetch = [&](int t) {
    const float* xr = xp + (((size_t)t * 2 + dir) * B + bb) * G + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = __ldg(xr + q * H);
    mt = __ldg(m + (size_t)t * B + bb);
  };
  if (active && T > 0) fetch(0);

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (prod) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      const float* hr = hb + buf * BT * hp + k0;
      if constexpr (GW) {
        const float* wcol = w_hh + ((size_t)dir * H + k0) * G + gcol;  // row k0 + i at i G
        for (int i = 0; i < kn; i += 4) {
          float wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) wv[q] = i + q < kn ? __ldg(wcol + (size_t)(i + q) * G) : 0.f;
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(hr + r * hp + i);
            acc[r] = fmaf(v.x, wv[0], acc[r]);
            if (i + 1 < kn) acc[r] = fmaf(v.y, wv[1], acc[r]);
            if (i + 2 < kn) acc[r] = fmaf(v.z, wv[2], acc[r]);
            if (i + 3 < kn) acc[r] = fmaf(v.w, wv[3], acc[r]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < KC; i += 4) {
          if (i < kn) {
#pragma unroll
            for (int r = 0; r < BT; ++r) {
              const float4 v = *reinterpret_cast<const float4*>(hr + r * hp + i);
              acc[r] = fmaf(v.x, w[i], acc[r]);
              if (i + 1 < kn) acc[r] = fmaf(v.y, w[i + 1], acc[r]);
              if (i + 2 < kn) acc[r] = fmaf(v.z, w[i + 2], acc[r]);
              if (i + 3 < kn) acc[r] = fmaf(v.w, w[i + 3], acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) red[(kq * BT + r) * cols + pc] = acc[r];
    }
    __syncthreads();
    if (active) {
      float gt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* rp = red + eb * cols + q * hs + ej;
        float s = rp[0];
        for (int k = 1; k < nk; ++k) s += rp[k * BT * cols];
        gt[q] = __fadd_rn(x[q], s);
      }
      const float c_new = cell(sigmoidf(gt[1]), c, sigmoidf(gt[0]), tanhf(gt[2]));
      const float h_new = sigmoidf(gt[3]) * tanhf(c_new);
      h = mt * h_new + (1.f - mt) * h;
      c = mt * c_new + (1.f - mt) * c;
      const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
      outs[o] = h;
      if (cs_out) cs_out[o] = c;
      const int at = ((buf ^ 1) * BT + eb) * hp + j;
      for (int p = 0; p < cl; ++p) cluster::cluster_peer(hb, p)[at] = h;
      if (t + 1 < T) fetch(t + 1);
    }
    cluster::cluster_sync();  // every unit of h[t] is in every CTA's buffer
  }
  if (active) {
    h_fin[((size_t)dir * B + bb) * H + j] = h;
    c_fin[((size_t)dir * B + bb) * H + j] = c;
  }
}

// H above 512: CTA r of CL = 8 takes units_of(r) (hs of them); its threads
// stride over the nk x 4 hs (k-group, gate column) products and the BT x hs
// (video, unit) elements; h of the step in two buffers as above, the cell
// of its elements in shared memory; w_hh read from L2 every step.  The same
// FMA order and group order as `bilstm_fwd_kernel` (GW).
__global__ void __launch_bounds__(NTW, 1) bilstm_fwd_wide_kernel(
    const float* __restrict__ xp, const float* __restrict__ m, const float* __restrict__ w_hh,
    float* __restrict__ outs, float* __restrict__ h_fin, float* __restrict__ c_fin,
    float* __restrict__ cs_out, int T, int B, int H, int, int nk, int kc) {
  extern __shared__ float4 smf4[];
  int j0, hs;
  cluster::units_of(cluster::cluster_rank(), gridDim.x, H, j0, hs);
  const int G = 4 * H, cols = 4 * hs, hp = nk * kc;
  float* hb = reinterpret_cast<float*>(smf4);  // [2][BT][hp] h of the step, all units
  float* red = hb + 2 * BT * hp;               // [nk][BT][cols] partial sums
  float* cst = red + nk * BT * cols;           // [BT][hs] the cell of the CTA's elements
  const int cl = gridDim.x, b0 = blockIdx.y * BT, dir = blockIdx.z, tid = threadIdx.x;
  for (int i = tid; i < 2 * BT * hp; i += NTW) hb[i] = 0.f;  // absent videos stay 0
  for (int i = tid; i < BT * hs; i += NTW) cst[i] = 0.f;
  cluster::cluster_sync();  // before any peer writes here

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    for (int v = tid; v < nk * cols; v += NTW) {
      const int pc = v % cols, kq = v / cols;
      const int gcol = (pc / hs) * H + j0 + pc % hs, k0 = kq * kc;
      const int kn = max(0, min(kc, H - k0));
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      const float* hr = hb + buf * BT * hp + k0;
      const float* wcol = w_hh + ((size_t)dir * H + k0) * G + gcol;
      for (int i = 0; i < kn; i += 4) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = i + q < kn ? __ldg(wcol + (size_t)(i + q) * G) : 0.f;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(hr + r * hp + i);
          acc[r] = fmaf(hv.x, wv[0], acc[r]);
          if (i + 1 < kn) acc[r] = fmaf(hv.y, wv[1], acc[r]);
          if (i + 2 < kn) acc[r] = fmaf(hv.z, wv[2], acc[r]);
          if (i + 3 < kn) acc[r] = fmaf(hv.w, wv[3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) red[(kq * BT + r) * cols + pc] = acc[r];
    }
    __syncthreads();
    for (int e = tid; e < BT * hs; e += NTW) {
      const int eb = e / hs, ej = e - eb * hs, bb = b0 + eb, j = j0 + ej;
      if (bb >= B) break;
      const float* xr = xp + (((size_t)t * 2 + dir) * B + bb) * G + j;
      const float mt = __ldg(m + (size_t)t * B + bb);
      float gt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* rp = red + eb * cols + q * hs + ej;
        float s = rp[0];
        for (int k = 1; k < nk; ++k) s += rp[k * BT * cols];
        gt[q] = __fadd_rn(__ldg(xr + q * H), s);
      }
      const float h = hb[(buf * BT + eb) * hp + j], c = cst[e];
      const float c_new = cell(sigmoidf(gt[1]), c, sigmoidf(gt[0]), tanhf(gt[2]));
      const float h_new = sigmoidf(gt[3]) * tanhf(c_new);
      const float h2 = mt * h_new + (1.f - mt) * h, c2 = mt * c_new + (1.f - mt) * c;
      const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
      outs[o] = h2;
      if (cs_out) cs_out[o] = c2;
      cst[e] = c2;
      const int at = ((buf ^ 1) * BT + eb) * hp + j;
      for (int p = 0; p < cl; ++p) cluster::cluster_peer(hb, p)[at] = h2;
    }
    cluster::cluster_sync();  // every unit of h[t] is in every CTA's buffer
  }
  for (int e = tid; e < BT * hs; e += NTW) {
    const int eb = e / hs, ej = e - eb * hs, bb = b0 + eb, j = j0 + ej;
    if (bb >= B) break;
    h_fin[((size_t)dir * B + bb) * H + j] = hb[((T & 1) * BT + eb) * hp + j];
    c_fin[((size_t)dir * B + bb) * H + j] = cst[e];
  }
}

using FwdKernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                           float*, int, int, int, int, int, int);

// KC = 32 takes 256 threads only (its launch bound)
FwdKernel fwd_kernel(const FwdPlan& p, int H) {
  if (p.wide) return bilstm_fwd_wide_kernel;
  if (p.gw) return bilstm_fwd_kernel<64, true, true>;
  if (p.cl * p.hs != H)
    return p.kc <= 32 && p.nt == 256 ? bilstm_fwd_kernel<32, false, true>
                                     : bilstm_fwd_kernel<64, false, true>;
  return p.kc <= 32 && p.nt == 256 ? bilstm_fwd_kernel<32> : bilstm_fwd_kernel<64>;
}

size_t fwd_smem(const FwdPlan& p) {
  return (size_t)(2 * BT * p.nk * p.kc + p.nk * BT * 4 * p.hs + (p.wide ? BT * p.hs : 0)) *
         sizeof(float);
}

// The forward's launch for B videos: the plan of H, the clusters of the
// grid and how many of them the card holds at once (a grid of more runs in
// waves).
cudaError_t fwd_launch_plan(int B, int H, FwdPlan& p, int& clusters, int& active) {
  if (B <= 0 || !fwd_plan(H, p)) return cudaErrorInvalidValue;
  clusters = 2 * ((B + BT - 1) / BT);
  return cluster::max_active_clusters(fwd_kernel(p, H), dim3(p.cl, clusters / 2, 2), dim3(p.nt),
                                      p.cl, fwd_smem(p), &active);
}

constexpr int RB = 8;     // (t, b) rows per CTA of the coefficient pass
constexpr int NTC = 256;  // threads per CTA of the chain

// The chain's six factors for every (t, dir, b, j) at once: a tiled
// [T B x H] x [H x 4H] product per direction (each thread the four gate
// columns of one j for RB rows), then the activations.  The k terms are
// summed as the forward kernel sums them: an FMA chain over each of its nk
// groups of kc rows, the groups' sums added in group order, then xp; the
// cell is `cell`'s.  So the replayed gates and cell are the forward's, bit
// for bit; `cell_out` (debug, may be null) receives the replayed cell.
__global__ void bilstm_coefs_kernel(const float* __restrict__ xp,    // [T, 2, B, 4H]
                                    const float* __restrict__ m,     // [T, B]
                                    const float* __restrict__ w_hh,  // [2, H, 4H]
                                    const float* __restrict__ outs,  // [T, 2, B, H]
                                    const float* __restrict__ cs,    // [T, 2, B, H]
                                    float* __restrict__ coefs,       // [6, T, 2, B, H]
                                    float* __restrict__ cell_out,    // [T, 2, B, H] or null
                                    int T, int B, int H, int nk, int kc) {
  extern __shared__ float sm[];  // [RB][H] h_prev
  const int G = 4 * H;
  const int dir = blockIdx.y;
  const int row_first = blockIdx.x * RB;
  const int rows = T * B;
  const float* w = w_hh + (size_t)dir * H * G;

  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) {
    const int r = i / H, k = i - r * H;
    const int row = row_first + r;
    const int t = row / B, bb = row - t * B;
    sm[i] = (row < rows && t > 0) ? outs[(((size_t)(t - 1) * 2 + dir) * B + bb) * H + k] : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)T * 2 * B * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float sum[RB][4];
    for (int g = 0; g < nk; ++g) {
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const int k1 = min(H, (g + 1) * kc);
#pragma unroll 2
      for (int k = g * kc; k < k1; ++k) {
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) wv[q] = __ldg(w + (size_t)k * G + q * H + j);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float h = sm[r * H + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(h, wv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[r][q] = g == 0 ? acc[r][q] : sum[r][q] + acc[r][q];
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int row = row_first + r;
      if (row >= rows) break;
      const int t = row / B, bb = row - t * B;
      const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
      const float* xr = xp + (((size_t)t * 2 + dir) * B + bb) * G;
      const float ig = sigmoidf(__fadd_rn(xr[j], sum[r][0]));
      const float fg = sigmoidf(__fadd_rn(xr[H + j], sum[r][1]));
      const float gg = tanhf(__fadd_rn(xr[2 * H + j], sum[r][2]));
      const float og = sigmoidf(__fadd_rn(xr[3 * H + j], sum[r][3]));
      const float c_prev = t > 0 ? cs[o - (size_t)2 * B * H] : 0.f;
      const float c_new = cell(fg, c_prev, ig, gg);
      if (cell_out) cell_out[o] = c_new;
      const float tc = tanhf(c_new);
      const float mt = m[(size_t)t * B + bb];
      coefs[o] = mt * og * (1.f - tc * tc);
      coefs[plane + o] = gg * ig * (1.f - ig);
      coefs[2 * plane + o] = c_prev * fg * (1.f - fg);
      coefs[3 * plane + o] = ig * (1.f - gg * gg);
      coefs[4 * plane + o] = mt * tc * og * (1.f - og);
      coefs[5 * plane + o] = fg;
    }
  }
}

// How the chain splits a hidden size H over a cluster: CL CTAs of at most HS
// columns; NQ = NT / HS thread groups of GPQ gate rows each (a multiple of
// 4).  The even split (cluster::width_for) on NTC threads, GPQ <= 128 the
// weights a thread keeps in registers; where it leaves more than 32 columns
// a CTA, the ragged split (cluster::ragged_width) on NTW threads, its w_hh rows read
// from L2 (gw).  One thread per (video, column) either way.
struct ChainPlan {
  int cl, hs, nq, gpq, nt;
  bool gw, wide;
};

constexpr int GC = 1024;  // gate rows of dgate the wide chain stages at a time

bool chain_plan(int H, ChainPlan& p) {
  if (H <= 0 || H > MAX_H_WIDE) return false;
  p.wide = H > MAX_H;
  if (p.wide) {  // NQ groups so that the products are about two passes of the threads
    p.cl = WIDE_CL;
    p.hs = (H + WIDE_CL - 1) / WIDE_CL;
    p.nt = NTW;
    p.gw = true;
    p.nq = std::max(1, 2 * NTW / p.hs);
    p.gpq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
    return true;
  }
  p.cl = cluster::width_for(H);
  p.hs = H / p.cl;
  p.nt = NTC;
  p.gw = BT * p.hs > NTC;
  if (p.gw) {
    p.cl = cluster::ragged_width(H);
    p.hs = (H + p.cl - 1) / p.cl;
    p.nt = NTW;
  }
  p.nq = p.nt / p.hs;
  p.gpq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
  return p.gw || p.gpq <= 128;
}

// One cluster per (direction, batch tile); grid (CL, tiles, 2), cluster (CL, 1, 1).
// WPT: weights per thread, >= gpq (registers, NTC threads); GW: none, the
// rows read from L2 each step (NTW threads).
template <int WPT, bool GW = false>
__global__ void __launch_bounds__(GW ? NTW : NTC) bilstm_chain_kernel(
    const float* __restrict__ coefs,   // [6, T, 2, B, H]
    const float* __restrict__ m,       // [T, B]
    const float* __restrict__ w_hh,    // [2, H, 4H]
    const float* __restrict__ douts,   // [T, 2, B, H]
    const float* __restrict__ dh_fin,  // [2, B, H]
    const float* __restrict__ dc_fin,  // [2, B, H]
    float* __restrict__ dxp,           // [T, 2, B, 4H]
    int T, int B, int H, int hs, int nq, int gpq) {
  constexpr int NT = GW ? NTW : NTC;
  extern __shared__ float4 sm4[];
  const int G = 4 * H;
  float* dg = reinterpret_cast<float*>(sm4);  // [2][BT][G] dgate of a step, all columns
  float* red = dg + 2 * BT * G;                // [nq][BT][hs] partial sums

  const int cl = gridDim.x;
  int j0 = cluster::cluster_rank() * hs;  // this CTA's columns (GW: of a ragged split)
  if constexpr (GW) cluster::units_of(cluster::cluster_rank(), cl, H, j0, hs);
  const int b0 = blockIdx.y * BT;
  const int dir = blockIdx.z;
  const int tid = threadIdx.x;

  // product role: gate rows [g0, g1) of column j0 + pj, weights in registers
  // (GW: read from the row, contiguous in w_hh, every step)
  const bool prod = tid < nq * hs;
  const int pj = tid % hs, kq = tid / hs;
  const int g0 = kq * gpq, g1 = min(G, g0 + gpq);
  float wreg[GW ? 1 : WPT];
  if constexpr (!GW) {
#pragma unroll
    for (int i = 0; i < WPT; ++i)
      wreg[i] = (prod && g0 + i < g1) ? w_hh[((size_t)dir * H + j0 + pj) * G + g0 + i] : 0.f;
  }

  // element role: (dh, dc) of video b0 + eb, column j0 + ej
  const int eb = tid / hs, ej = tid - eb * hs;
  const int bb = b0 + eb, j = j0 + ej;
  const bool active = tid < BT * hs && bb < B;
  float dh = 0.f, dc = 0.f;
  if (active) {
    dh = dh_fin[((size_t)dir * B + bb) * H + j];
    dc = dc_fin[((size_t)dir * B + bb) * H + j];
  }
  for (int i = tid; i < 2 * BT * G; i += NT) dg[i] = 0.f;  // rows of absent videos stay 0
  cluster::cluster_sync();  // before any peer writes here

  const size_t plane = (size_t)T * 2 * B * H;
  float cf[6] = {}, dout = 0.f, mt = 0.f;  // the step's factors, loaded a step ahead
  auto fetch = [&](int t) {
    const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
#pragma unroll
    for (int k = 0; k < 6; ++k) cf[k] = __ldg(coefs + k * plane + o);
    dout = __ldg(douts + o);
    mt = __ldg(m + (size_t)t * B + bb);
  };
  if (active && T > 0) fetch(T - 1);

  for (int t = T - 1; t >= 0; --t) {
    const int buf = (T - 1 - t) & 1;
    float dhp = 0.f;
    if (active) {
      const float dht = dh + dout;
      const float dct = dht * cf[0] + mt * dc;
      const float dq[4] = {dct * cf[1], dct * cf[2], dct * cf[3], dht * cf[4]};
      dc = dct * cf[5] + (1.f - mt) * dc;
      dhp = (1.f - mt) * dht;
      float* dxr = dxp + (((size_t)t * 2 + dir) * B + bb) * G + j;
      for (int p = 0; p < cl; ++p) {
        float* pd = cluster::cluster_peer(dg, p) + (buf * BT + eb) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) pd[q * H] = dq[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dxr[q * H] = dq[q];
      if (t > 0) fetch(t - 1);
    }
    cluster::cluster_sync();  // every column of dgate[t] is in every CTA's buffer

    if (prod) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      const float* dgb = dg + buf * BT * G + g0;
      if constexpr (GW) {
        const float* wrow = w_hh + ((size_t)dir * H + j0 + pj) * G + g0;
        for (int i = 0; g0 + i < g1; i += 4) {  // g1 - g0 is a multiple of 4
          const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + i));
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 d = *reinterpret_cast<const float4*>(dgb + r * G + i);
            acc[r] = fmaf(d.x, w.x, acc[r]);
            acc[r] = fmaf(d.y, w.y, acc[r]);
            acc[r] = fmaf(d.z, w.z, acc[r]);
            acc[r] = fmaf(d.w, w.w, acc[r]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < WPT; i += 4) {
          if (g0 + i < g1) {
#pragma unroll
            for (int r = 0; r < BT; ++r) {
              const float4 d = *reinterpret_cast<const float4*>(dgb + r * G + i);
              acc[r] = fmaf(d.x, wreg[i], acc[r]);
              acc[r] = fmaf(d.y, wreg[i + 1], acc[r]);
              acc[r] = fmaf(d.z, wreg[i + 2], acc[r]);
              acc[r] = fmaf(d.w, wreg[i + 3], acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) red[(kq * BT + r) * hs + pj] = acc[r];
    }
    __syncthreads();
    if (active) {
      float s = red[eb * hs + ej];
      for (int q = 1; q < nq; ++q) s += red[(q * BT + eb) * hs + ej];
      dh = dhp + s;
    }
  }
  cluster::cluster_sync();  // no CTA leaves while a peer may still write to it
}

// H above 512: CTA r of CL = 8 owns the columns units_of(r) (hs of them); its
// threads stride over the BT x hs (video, column) elements (dh, dc and the
// masked dh part in shared memory) and the nq x hs (row group, column)
// products.  A step: the owners write dgate[t] to dxp; a fence and a cluster
// barrier; then every CTA stages dxp[t]'s rows of its videos GC gate rows at
// a time and each product carries its FMA chain over its rows through the
// chunks (red holds it between them); the groups added in order.  The
// narrow GW kernel's FMA and group orders.
__global__ void __launch_bounds__(NTW, 1) bilstm_chain_wide_kernel(
    const float* __restrict__ coefs, const float* __restrict__ m,
    const float* __restrict__ w_hh, const float* __restrict__ douts,
    const float* __restrict__ dh_fin, const float* __restrict__ dc_fin, float* dxp, int T, int B,
    int H, int, int nq, int gpq) {
  extern __shared__ float4 sm4[];
  int j0, hs;
  cluster::units_of(cluster::cluster_rank(), gridDim.x, H, j0, hs);
  const int G = 4 * H, b0 = blockIdx.y * BT, dir = blockIdx.z, tid = threadIdx.x;
  const int nb = min(BT, B - b0);
  float* dgs = reinterpret_cast<float*>(sm4);  // [BT][GC] a chunk of dgate rows
  float* red = dgs + BT * GC;                  // [nq][BT][hs] the products' sums
  float* dhs = red + nq * BT * hs;             // [BT][hs] dh
  float* dcs = dhs + BT * hs;                  // [BT][hs] dc
  float* dhp = dcs + BT * hs;                  // [BT][hs] dh's masked part
  for (int e = tid; e < BT * hs; e += NTW) {
    const int eb = e / hs, j = j0 + e - eb * hs;
    const bool ok = eb < nb;
    dhs[e] = ok ? dh_fin[((size_t)dir * B + b0 + eb) * H + j] : 0.f;
    dcs[e] = ok ? dc_fin[((size_t)dir * B + b0 + eb) * H + j] : 0.f;
  }
  const size_t plane = (size_t)T * 2 * B * H;
  for (int t = T - 1; t >= 0; --t) {
    __syncthreads();  // dhs of the last step, from every thread
    for (int e = tid; e < BT * hs; e += NTW) {
      const int eb = e / hs, ej = e - eb * hs, bb = b0 + eb, j = j0 + ej;
      if (eb >= nb) break;
      const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
      float cf[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cf[k] = __ldg(coefs + k * plane + o);
      const float mt = __ldg(m + (size_t)t * B + bb);
      const float dht = dhs[e] + __ldg(douts + o);
      const float dct = dht * cf[0] + mt * dcs[e];
      const float dq[4] = {dct * cf[1], dct * cf[2], dct * cf[3], dht * cf[4]};
      dcs[e] = dct * cf[5] + (1.f - mt) * dcs[e];
      dhp[e] = (1.f - mt) * dht;
      float* dxr = dxp + (((size_t)t * 2 + dir) * B + bb) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) dxr[q * H] = dq[q];
    }
    for (int i = tid; i < nq * BT * hs; i += NTW) red[i] = 0.f;
    __threadfence();          // dgate[t] in device memory before the barrier's release
    cluster::cluster_sync();  // every column of dgate[t] is written
    const float* dgt = dxp + (((size_t)t * 2 + dir) * B + b0) * G;
    for (int c0 = 0; c0 < G; c0 += GC) {
      const int cn = min(GC, G - c0);
      for (int i = tid; i < BT * cn; i += NTW) {
        const int r = i / cn, g = i - r * cn;
        dgs[r * GC + g] = r < nb ? __ldcg(dgt + (size_t)r * G + c0 + g) : 0.f;
      }
      __syncthreads();
      for (int v = tid; v < nq * hs; v += NTW) {
        const int pj = v % hs, kq = v / hs;
        const int lo = max(kq * gpq, c0), hi = min(min(G, kq * gpq + gpq), c0 + cn);
        if (lo >= hi) continue;
        float acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = red[(kq * BT + r) * hs + pj];
        const float* wrow = w_hh + ((size_t)dir * H + j0 + pj) * G;
        for (int g = lo; g < hi; g += 4) {  // lo, hi are multiples of 4
          const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + g));
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float4 d = *reinterpret_cast<const float4*>(dgs + r * GC + g - c0);
            acc[r] = fmaf(d.x, w.x, acc[r]);
            acc[r] = fmaf(d.y, w.y, acc[r]);
            acc[r] = fmaf(d.z, w.z, acc[r]);
            acc[r] = fmaf(d.w, w.w, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) red[(kq * BT + r) * hs + pj] = acc[r];
      }
      __syncthreads();  // the chunk is consumed
    }
    for (int e = tid; e < BT * hs; e += NTW) {
      const int eb = e / hs, ej = e - eb * hs;
      if (eb >= nb) break;
      float s = red[eb * hs + ej];
      for (int q = 1; q < nq; ++q) s += red[(q * BT + eb) * hs + ej];
      dhs[e] = dhp[e] + s;
    }
  }
}

size_t chain_wide_smem(const ChainPlan& p) {
  return (size_t)(BT * GC + p.nq * BT * p.hs + 3 * BT * p.hs) * sizeof(float);
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
  FwdPlan p;
  if (T < 0 || B <= 0 || !fwd_plan(H, p)) return cudaErrorInvalidValue;
  return cluster::launch_cluster(fwd_kernel(p, H), dim3(p.cl, (B + BT - 1) / BT, 2), dim3(p.nt),
                                 p.cl, fwd_smem(p), stream, xp, m, w_hh, outs, h_fin, c_fin,
                                 cs, T, B, H, p.hs, p.nk, p.kc);
}

// The forward's launch for (B, H): out = {CL, NT, NK, KC, clusters, clusters
// the card holds at once} (KC above 64: the weights are read from L2).
// Returns a cudaError (H refused:
// cudaErrorInvalidValue).
extern "C" int mucon_bilstm_fwd_plan(int B, int H, int* out) {
  FwdPlan p;
  int clusters = 0, active = 0;
  const cudaError_t err = fwd_launch_plan(B, H, p, clusters, active);
  if (err == cudaSuccess) {
    const int v[6] = {p.cl, p.nt, p.nk, p.kc, clusters, active};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
  }
  return err;
}

// The chain's factors coefs [6, T, 2, B, H] (A, Ci, Cf, Cg, Co, F) from the
// stashed trajectory: the parallel pass of the reverse chain.  `cell` (may
// be null) receives the replayed cell f c_prev + i g [T, 2, B, H].
extern "C" int mucon_bilstm_bwd_coefs(const float* xp, const float* m, const float* w_hh,
                                      const float* outs, const float* cs, float* coefs,
                                      float* cell, int T, int B, int H, cudaStream_t stream) {
  FwdPlan p;
  if (T < 0 || B <= 0 || !fwd_plan(H, p)) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const int threads = H < 128 ? ((H + 31) / 32) * 32 : 128;
  const size_t smem = (size_t)RB * H * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem((const void*)bilstm_coefs_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T * B + RB - 1) / RB, 2);
  bilstm_coefs_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, cs, coefs, cell, T,
                                                       B, H, p.nk, p.kc);
  return cudaGetLastError();
}

// The cluster width the chain takes for a hidden size H (0: H is refused).
extern "C" int mucon_bilstm_chain_width(int H) {
  ChainPlan p;
  return chain_plan(H, p) ? p.cl : 0;
}

// The sequential pass of the reverse chain: dxp [T, 2, B, 4H] from the
// factors and the cotangents of outs, h_fin and c_fin.
extern "C" int mucon_bilstm_bwd_chain(const float* coefs, const float* m, const float* w_hh,
                                      const float* douts, const float* dh_fin,
                                      const float* dc_fin, float* dxp, int T, int B, int H,
                                      cudaStream_t stream) {
  ChainPlan p;
  if (T < 0 || B <= 0 || !chain_plan(H, p)) return cudaErrorInvalidValue;
  const dim3 grid(p.cl, (B + BT - 1) / BT, 2);
  if (p.wide)
    return cluster::launch_cluster(bilstm_chain_wide_kernel, grid, dim3(p.nt), p.cl,
                                   chain_wide_smem(p), stream, coefs, m, w_hh, douts, dh_fin,
                                   dc_fin, dxp, T, B, H, p.hs, p.nq, p.gpq);
  const size_t smem = (size_t)(2 * BT * 4 * H + p.nq * BT * p.hs) * sizeof(float);
  auto kernel = p.gw ? bilstm_chain_kernel<4, true>
                     : (p.gpq <= 32 ? bilstm_chain_kernel<32> : bilstm_chain_kernel<128>);
  return cluster::launch_cluster(kernel, grid, dim3(p.nt), p.cl, smem, stream, coefs, m, w_hh,
                                 douts, dh_fin, dc_fin, dxp, T, B, H, p.hs, p.nq, p.gpq);
}
