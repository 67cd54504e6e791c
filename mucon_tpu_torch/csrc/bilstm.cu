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
// Every H from 1 to 256 on this kernel (above: the persistent kernel,
// below): where CL does not divide H into CTAs of at least 16 units that fit
// the threads (an odd H above 64), the split is ragged: CL = 8 CTAs (fewer
// below H = 64), CTA r taking units [r H / CL, (r + 1) H / CL), ceil(H / CL)
// or floor(H / CL) of them.
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
//    columns a CTA (an odd H above 32), the split is ragged as the
//    forward's, the CTA takes 512 threads (a thread per video and column up
//    to 64 columns) and reads its w_hh rows from L2 every step.
//
// Above H = 256 (up to MAX_H_WIDE = 2048; the JAX package's byte gates stop
// its kernels at H = 1447) a cluster's registers no longer hold w_hh, and a
// cluster per 8 videos would read its direction's whole w_hh every step.
// There both recurrences run as one persistent kernel over the whole card
// (`bilstm_persistent_kernel`, one cooperative launch for both directions,
// one CTA an SM): CTA r of a direction's P owns the units units_of(r, P, H)
// for every video, and so the forward's 4 u gate columns {j, H+j, 2H+j, 3H+j}
// (the cell update stays local) or the chain's u columns of dh and dc.  Its
// slice of w_hh (16 H u bytes) is loaded into shared memory once and stays
// there for all T steps, as far as shared memory holds it; the rest is
// streamed through a ring of `cp.async` chunks every step (at B = 2, H =
// 1447 about a quarter stays).  A step: every CTA stages the step's operand
// rows (h[t-1], or dgate[t] for the chain) from a double-buffered exchange
// array in device memory (`cp.async.cg`, L2 only: other CTAs wrote them),
// chunk by chunk, one or more chunks ahead; its threads each own a tile of
// (videos x columns) of one k-group and run that group's FMA chain; the
// owners add the groups in order, apply the cell update, write outs (cs) and
// their units' h[t] into the exchange array; then a step barrier over the
// direction's CTAs (a release add and an acquire spin on a counter).  The
// chain's owners write dgate[t] to dxp and the exchange array the same way.
// The sums keep the cluster kernels' orders, a function of H alone
// (`persist_order`), so the coefficient pass still replays the stashed cell
// bit for bit and the outputs are those of the kernels the persistent one
// replaced.
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

constexpr int MAX_H = 512;        // the hidden size up to which the sum orders take R = 512
constexpr int NARROW_H = 256;     // the widest hidden size of the cluster kernels
constexpr int MAX_H_WIDE = 2048;  // the widest hidden size the kernels take
constexpr int NTW = 512;          // threads per CTA of the chain on a ragged split

// How the forward splits a hidden size H up to NARROW_H: CL CTAs of at most
// HS units, NT threads each; NK groups of KC k-rows (a multiple of 4) for
// each of the 4 HS gate columns.  NT is the least of 256, 512 that holds the
// columns, one thread per (video, unit) for BT = 8 videos, and KC <= 64 (the
// weights a thread keeps in registers; the kernel's launch bound is 512).
// The even split (cluster::width_for) first; where no NT holds it, the
// ragged split (cluster::ragged_width).  Above NARROW_H: the persistent
// kernel (`persistent`, the order of `persist_order`).
struct FwdPlan {
  int cl, hs, nt, nk, kc;
  bool persistent;
};

// The sum orders above NARROW_H, a function of H alone (those of the cluster
// kernels the persistent ones replaced, so that their outputs stayed the same
// bit for bit): with hs = ceil(H / 8) and R = 512 up to H = 512, 1024 above,
// the forward's NK = max(1, R / (4 hs)) groups of KC = ceil4(H / NK) k-rows,
// the chain's NQ = max(1, R / hs) groups of GPQ = ceil4(4H / NQ) gate rows.
void persist_order(bool chain, int H, int& nk, int& kc) {
  const int hs = (H + 7) / 8, r = H <= MAX_H ? 512 : 1024, K = chain ? 4 * H : H;
  nk = std::max(1, r / (chain ? hs : 4 * hs));
  kc = ((K + nk - 1) / nk + 3) & ~3;
}

bool fwd_split(int H, int cl, int hs, FwdPlan& p) {
  p.cl = cl;
  p.hs = hs;
  const int cols = 4 * p.hs;
  for (p.nt = 256; p.nt <= 512; p.nt *= 2) {
    if (cols > p.nt || 8 * p.hs > p.nt) continue;
    p.nk = p.nt / cols;
    p.kc = ((H + p.nk - 1) / p.nk + 3) & ~3;
    if (p.kc <= 64) return true;
  }
  return false;
}

bool fwd_plan(int H, FwdPlan& p) {
  if (H <= 0 || H > MAX_H_WIDE) return false;
  p.persistent = H > NARROW_H;
  if (p.persistent) {
    p.cl = p.hs = 0;
    p.nt = 512;
    persist_order(false, H, p.nk, p.kc);
    return true;
  }
  const int cl = cluster::width_for(H);
  if (fwd_split(H, cl, H / cl, p)) return true;
  const int rl = cluster::ragged_width(H);
  return fwd_split(H, rl, (H + rl - 1) / rl, p);
}

// One cluster per (direction, tile of BT videos); grid (CL, tiles, 2),
// cluster (CL, 1, 1).  KC: the register array, >= the plan's kc; at KC = 32
// (256 threads) three CTAs fit an SM, at most 80 registers a thread.
// RAGGED: the CTA's units from `cluster::units_of` (hs is the most a CTA
// takes); else the even split's hs units a CTA.
template <int KC, bool RAGGED = false>
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
  float w[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i)
    w[i] = i < kn ? w_hh[((size_t)dir * H + k0 + i) * G + gcol] : 0.f;

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

using FwdKernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                           float*, int, int, int, int, int, int);

// KC = 32 takes 256 threads only (its launch bound)
FwdKernel fwd_kernel(const FwdPlan& p, int H) {
  if (p.cl * p.hs != H)
    return p.kc <= 32 && p.nt == 256 ? bilstm_fwd_kernel<32, true> : bilstm_fwd_kernel<64, true>;
  return p.kc <= 32 && p.nt == 256 ? bilstm_fwd_kernel<32> : bilstm_fwd_kernel<64>;
}

size_t fwd_smem(const FwdPlan& p) {
  return (size_t)(2 * BT * p.nk * p.kc + p.nk * BT * 4 * p.hs) * sizeof(float);
}

constexpr int RB = 8;     // (t, b) rows per CTA of the coefficient pass
constexpr int NTC = 256;  // threads per CTA of the chain

// The chain's six factors for every (t, dir, b, j) at once: a tiled
// [T B x H] x [H x 4H] product per direction (each thread the four gate
// columns of one j for RB rows; grid (row tiles, 2, column blocks)), then
// the activations.  The k terms are
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
  for (int j = blockIdx.z * blockDim.x + threadIdx.x; j < H; j += gridDim.z * blockDim.x) {
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

// How the chain splits a hidden size H up to NARROW_H over a cluster: CL
// CTAs of at most HS columns; NQ = NT / HS thread groups of GPQ gate rows
// each (a multiple of 4).  The even split (cluster::width_for) on NTC
// threads, GPQ <= 128 the weights a thread keeps in registers; where it
// leaves more than 32 columns a CTA, the ragged split (cluster::ragged_width)
// on NTW threads, its w_hh rows read from L2 (gw).  One thread per (video,
// column) either way.  Above NARROW_H: the persistent kernel (the order of
// `persist_order`).
struct ChainPlan {
  int cl, hs, nq, gpq, nt;
  bool gw, persistent;
};

bool chain_plan(int H, ChainPlan& p) {
  if (H <= 0 || H > MAX_H_WIDE) return false;
  p.persistent = H > NARROW_H;
  if (p.persistent) {
    p.cl = p.hs = 0;
    p.nt = 512;
    p.gw = false;
    persist_order(true, H, p.nq, p.gpq);
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

// ---------------------------------------------------------------------------
// The persistent kernels: both recurrences above NARROW_H.

constexpr int NTP = 512;            // threads a CTA
constexpr int SMEM_MAX = 232448;    // the shared memory a block may take (H100, opt-in)
constexpr int EXCH_PAD = 256;       // an exchange row holds NK KC + EXCH_PAD floats
constexpr int MAX_STAGES = 8;       // ring slots at most
constexpr int RING_FLOATS = 12288;  // 48 KiB: what a streaming ring keeps in flight

// A persistent launch: P CTAs a direction, CTA r owning the units
// units_of(r, P, H) (at most U) for every video; NK groups of KC rows of the
// contraction over K = H (forward) or 4H (chain); NC columns a CTA (4U gate
// columns, or U columns of dh); each thread a tile of RV videos x RC columns
// of one k-group, NVG x NCG x NK threads a pass over BV videos (TILES passes
// cover B); each group's rows staged KCH at a time (NCH chunks a pass, chunk
// i holding rows [i KCH, (i + 1) KCH) of every group); the first CR chunks of
// the CTA's w_hh slice resident in shared memory for the whole launch, the
// others streamed every step through the ring of STAGES slots; SA the row
// stride of a staged chunk (NK KCH + 4 floats: 4 mod 8, so the float4 rows
// of 8 lanes fall in distinct banks).
//
// The tile minimises a step's modelled cycles an SM (`tile_cycles`): a
// thread's four rows of a group take RV + RC float4 shared-memory loads and
// 4 RV RC FMAs, so a pass costs the larger of the issue (four warps an SM
// partition), the wavefronts of a warp's distinct float4 loads (8 a
// wavefront) and the 16-cycle FMA chain of four rows, times the rows.  Then
// KCH minimises its chunks' modelled cycles (`chunk_cycles`): each pass over
// a chunk CHUNK_CYCLES + 24 BV of syncs, copies and exposed waits, its
// streamed w_hh 40 bytes a cycle and the first staged chunk (under no
// product) 32 bytes a cycle.  A streaming ring keeps ~RING_FLOATS in
// flight.  The constants are fitted to the chunk sizes the measured steps
// preferred (PERF.md); the models rank plans, they do not predict
// their cycles.
struct PPlan {
  int ctas, units, nk, kc, nc, rv, rc, nvg, ncg, bv, tiles, kch, nch, cr, stages, sa;
  int smem;  // bytes
};

constexpr int NTILES = 8;
constexpr int TILES[NTILES][2] = {{1, 1}, {2, 1}, {4, 1}, {8, 1}, {2, 2}, {4, 2}, {4, 4}, {8, 4}};
constexpr long CHUNK_CYCLES = 300;

// modelled cycles of a step's products with an RV x RC tile (0: no pass fits)
long tile_cycles(int rv, int rc, int B, int nc, int nk, int kc, int& nvg, int& tiles) {
  const int ncg = (nc + rc - 1) / rc, most = NTP / (ncg * nk), groups = (B + rv - 1) / rv;
  if (most < 1) return 0;
  tiles = (groups + most - 1) / most;
  nvg = (groups + tiles - 1) / tiles;
  const long warps = (nvg * ncg * nk + 31) / 32;
  const long wfw = (std::min(32, ncg) + 7) / 8, wfa = (std::min(nvg, (32 + ncg - 1) / ncg) + 7) / 8;
  const long issue = (warps + 3) / 4 * (rv + rc + 4 * rv * rc + 4);
  const long smem = warps * (rc * wfw + rv * wfa);
  return tiles * std::max(16L, std::max(issue, smem)) * ((kc + 3) / 4);
}

// Chunks of KCH rows a group for a tile of BV videos: the resident chunks
// CR, the ring's slots and the shared-memory bytes where they fit, and the
// chunks' modelled cycles a step (-1: they do not fit)
long chunk_cycles(int kch, int bv, int tiles, long ncp, int nk, int kc, int& nch, int& cr,
                  int& stages, int& smem) {
  const long budget = SMEM_MAX / 4, red = (long)nk * bv * ncp, sa = (long)nk * kch + 4;
  const long act = bv * sa, w = ncp * sa;
  nch = (kc + kch - 1) / kch;
  cr = nch;
  stages = std::min(nch, 2);
  if (red + stages * act + nch * w > budget) {
    stages = std::min(std::min(nch, MAX_STAGES),
                      std::max(2, (int)((RING_FLOATS + act + w - 1) / (act + w))));
    const long fixed = red + stages * (act + w);
    if (fixed > budget) return -1;
    cr = (int)std::min<long>(nch - 1, (budget - fixed) / w);
  }
  smem = (int)(4 * (red + cr * w + stages * (act + (cr < nch ? w : 0))));
  return tiles * ((CHUNK_CYCLES + 24L * bv) * nch + 4 * (nch - cr) * w / 40 + 4 * act / 32);
}

bool persist_plan(bool chain, int B, int H, int ctas, PPlan& p) {
  if (B <= 0 || H <= NARROW_H || H > MAX_H_WIDE || ctas < 1) return false;
  p.ctas = std::min(ctas, H);
  p.units = (H + p.ctas - 1) / p.ctas;
  persist_order(chain, H, p.nk, p.kc);
  p.nc = chain ? p.units : 4 * p.units;
  if (p.nc > NTP) return false;
  long least = 0;
  for (const auto& t : TILES) {  // ties keep the earlier tile
    int nvg, tiles;
    const long c = tile_cycles(t[0], t[1], B, p.nc, p.nk, p.kc, nvg, tiles);
    if (c > 0 && (least == 0 || c < least)) {
      least = c;
      p.rv = t[0];
      p.rc = t[1];
      p.nvg = nvg;
      p.tiles = tiles;
    }
  }
  if (least == 0) return false;
  p.ncg = (p.nc + p.rc - 1) / p.rc;
  p.bv = p.nvg * p.rv;
  const int kmax = (p.kc + 7) & ~7;
  const int cands[7] = {kmax, 256, 128, 64, 32, 16, 8};
  long best = -1;
  for (int kch : cands) {  // ties keep the larger
    int nch, cr, stages, smem;
    if (kch > kmax) continue;
    const long c = chunk_cycles(kch, p.bv, p.tiles, (long)p.ncg * p.rc, p.nk, p.kc, nch, cr,
                                stages, smem);
    if (c < 0 || (best >= 0 && c >= best)) continue;
    best = c;
    p.kch = kch;
    p.sa = p.nk * kch + 4;
    p.nch = nch;
    p.cr = cr;
    p.stages = stages;
    p.smem = smem;
  }
  return best >= 0;
}

// The launch's inputs, outputs and scratch (one struct: the kernel's only
// parameter).  Forward: xp, m, w_hh -> outs, h_fin, c_fin (and cs); chain:
// coefs, m, w_hh, douts, dh_fin, dc_fin -> dxp.
struct PArgs {
  const float* xp;      // [T, 2, B, 4H]
  const float* m;       // [T, B]
  const float* w_hh;    // [2, H, 4H]
  float* outs;          // [T, 2, B, H]
  float* h_fin;         // [2, B, H]
  float* c_fin;         // [2, B, H]
  float* cs;            // [T, 2, B, H] or null
  const float* coefs;   // [6, T, 2, B, H]
  const float* douts;   // [T, 2, B, H]
  const float* dh_fin;  // [2, B, H]
  const float* dc_fin;  // [2, B, H]
  float* dxp;           // [T, 2, B, 4H]
  unsigned* cnt;        // [2] the directions' step counters, 0 at launch
  float* xch;           // [2 buffers][2][B][kp] exchange rows (h or dgate), 0 at launch
  float* st;            // state, 0 at launch: forward c [2][B][H]; chain dc, dh's masked
                        // part [2][2][B][H]
  float* wpk;           // forward, streaming: [2P][4U][kw] the CTAs' w_hh columns as rows
  int T, B, H, kp, kw;
  PPlan p;
};

// the scratch floats a launch zeroes: the counters (4), the exchange rows and
// the state, rounded up to 4 (the packed rows after them take 16-byte copies)
long persist_zeroed_floats(const PPlan& p, bool chain, int B, int H) {
  return (4 + 4L * B * (p.nk * p.kc + EXCH_PAD) + (chain ? 4L : 2L) * B * H + 3) & ~3L;
}

// scratch floats of a launch: the zeroed part, then the forward's packed
// rows where it streams
long persist_scratch_floats(const PPlan& p, bool chain, int B, int H) {
  const long packed = !chain && p.cr < p.nch ? 2L * p.ctas * 4 * p.units * ((H + 3) & ~3) : 0;
  return persist_zeroed_floats(p, chain, B, H) + packed;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// read-only inputs (w_hh): 4 bytes, any alignment
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 16 bytes through L2 only: rows other CTAs wrote (the L1 is not coherent)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most n (< MAX_STAGES) of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The direction's step barrier: every CTA's writes before it are visible to
// every CTA after it.  Once the CTA is done (bar.sync), thread 0 adds one to
// the counter with release semantics (cumulative: it orders the writes the
// barrier showed it), then spins with acquire loads until all P CTAs have
// (target = P times the barriers so far); traps rather than hang.
__device__ __forceinline__ void step_barrier(unsigned* cnt, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(cnt) : "memory");
    unsigned v, tries = 0;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(cnt) : "memory");
      if (v >= target) break;
      if (++tries > (1u << 24)) __trap();
    }
  }
  __syncthreads();
}

// Thread tid's elements e = tid + n NTP of an [na][nb][nr] index space (r
// fastest), stepped without divisions: the start and the step, split into
// the three indices once.
struct Walk {
  int r, b, a, dr, db, da, nr, nb;
  __device__ Walk(int nb_, int nr_) : nr(nr_), nb(nb_) {
    const int q = threadIdx.x / nr, dq = NTP / nr;
    r = threadIdx.x - q * nr;
    b = q % nb;
    a = q / nb;
    dr = NTP - dq * nr;
    db = dq % nb;
    da = dq / nb;
  }
  template <class F>
  __device__ __forceinline__ void each(int na, F f) const {
    int x = r, y = b, z = a;
    while (z < na) {
      f(z, y, x);
      x += dr;
      const int cx = x >= nr;
      x -= cx ? nr : 0;
      y += db + cx;
      const int cy = y >= nb;
      y -= cy ? nb : 0;
      z += da + cy;
    }
  }
};

// n (1-4) rows kk.. of one group: acc[r][s] += a[r][k] w[s][k], an FMA chain in k
template <int RV, int RC>
__device__ __forceinline__ void fma_rows(float (&acc)[RV][RC], const float* as, const float* ws,
                                         int kk, int astep, int wstep, int n) {
  float4 av[RV], wv[RC];
#pragma unroll
  for (int r = 0; r < RV; ++r) av[r] = *reinterpret_cast<const float4*>(as + r * astep + kk);
#pragma unroll
  for (int s = 0; s < RC; ++s) wv[s] = *reinterpret_cast<const float4*>(ws + s * wstep + kk);
#pragma unroll
  for (int r = 0; r < RV; ++r)
#pragma unroll
    for (int s = 0; s < RC; ++s) {
      acc[r][s] = fmaf(av[r].x, wv[s].x, acc[r][s]);
      if (n > 1) acc[r][s] = fmaf(av[r].y, wv[s].y, acc[r][s]);
      if (n > 2) acc[r][s] = fmaf(av[r].z, wv[s].z, acc[r][s]);
      if (n > 3) acc[r][s] = fmaf(av[r].w, wv[s].w, acc[r][s]);
    }
}

// grid 2P (direction = blockIdx.x / P), NTP threads, cooperative launch only:
// every CTA must be resident, or the step barrier never opens.
template <bool CHAIN, int RV, int RC>
__global__ void __launch_bounds__(NTP, 1) bilstm_persistent_kernel(const PArgs a) {
  extern __shared__ float4 smp[];
  float* const sm = reinterpret_cast<float*>(smp);
  const PPlan& p = a.p;
  const int P = p.ctas, dir = blockIdx.x / P;
  int j0, u;
  cluster::units_of(blockIdx.x - dir * P, P, a.H, j0, u);
  const int H = a.H, G = 4 * H, B = a.B, T = a.T, kp = a.kp, tid = threadIdx.x;
  const int K = CHAIN ? G : H, ncr = CHAIN ? u : 4 * u;
  const int nk = p.nk, kc = p.kc, kch = p.kch, sa = p.sa, nvg = p.nvg, ncg = p.ncg, bv = p.bv;
  const int ncp = ncg * RC, wch = ncp * sa, ach = bv * sa;
  const int slot = ach + (p.cr < p.nch ? wch : 0);
  float* const wres = sm;                     // [cr][ncp][sa] resident chunks of w_hh
  float* const ring = wres + p.cr * wch;      // [stages] staged rows (+ a streamed chunk)
  float* const red = ring + p.stages * slot;  // [nk][bv][ncp] the groups' partial sums
  const float* const w = a.w_hh + (size_t)dir * H * G;
  unsigned* const cnt = a.cnt + dir;
  const size_t xbuf = (size_t)2 * B * kp;          // buffer b of the direction at b xbuf
  float* const xch = a.xch + (size_t)dir * B * kp;
  const size_t splane = (size_t)2 * B * H;         // state s at s splane
  float* const st = a.st + (size_t)dir * B * H;

  // row c of the CTA's w_hh slice, its k contiguous: the chain's rows j0 + c
  // of w_hh; the forward's columns (c / u) H + j0 + c % u, packed as rows
  // (below) where it streams
  const float* const wrows =
      CHAIN ? w + (size_t)j0 * G : a.wpk + (size_t)blockIdx.x * 4 * p.units * a.kw;
  const int wstride = CHAIN ? G : a.kw;
  const Walk walk(nk, kch / 4);  // (row, group, 4 rows) of a chunk
  // chunk i of the CTA's w_hh slice (rows i kch .. of every group) into dst
  // [ncp][sa]: 16-byte copies from the rows; the forward's resident chunks
  // 4-byte copies from w_hh's columns, a warp on adjacent columns
  auto stage_w = [&](int i, float* dst) {
    if (CHAIN || i >= p.cr) {
      walk.each(ncr, [&](int c, int g, int q) {
        const int off = i * kch + 4 * q, k = g * kc + off;
        if (off < kc && k < K)
          cp_async16(dst + c * sa + g * kch + 4 * q, wrows + (size_t)c * wstride + k);
      });
    } else {
      const int per = NTP / ncr, c = tid % ncr, r0 = tid / ncr;
      if (r0 < per) {
        const float* wc = w + (c / u) * H + j0 + c % u;
        for (int g = 0; g < nk; ++g)
          for (int r = r0; r < kch; r += per) {
            const int off = i * kch + r, k = g * kc + off;
            if (off < kc && k < K) cp_async4(dst + c * sa + g * kch + r, wc + (size_t)k * G);
          }
      }
    }
  };
  // chunk i of the exchange rows X of videos [b0, b0 + nb) into dst [bv][sa]
  auto stage_a = [&](int i, float* dst, const float* X, int b0, int nb) {
    walk.each(nb, [&](int v, int g, int q) {
      cp_async16(dst + v * sa + g * kch + 4 * q,
                 X + (size_t)(b0 + v) * kp + g * kc + i * kch + 4 * q);
    });
  };

  // this thread's task: videos vg + r nvg, columns cg + s ncg, k-group gq
  const int cg = tid % ncg, vg = (tid / ncg) % nvg, gq = tid / (ncg * nvg);
  const bool on = gq < nk;
  // every (video, column) of videos [b0, b0 + nb) summed over each k-group
  // of the rows X, into red: the chunks staged two (or the ring's slots)
  // ahead, each group an FMA chain over its rows in order
  auto products = [&](const float* X, int b0, int nb) {
    float acc[RV][RC];
#pragma unroll
    for (int r = 0; r < RV; ++r)
#pragma unroll
      for (int s = 0; s < RC; ++s) acc[r][s] = 0.f;
    const int D = p.stages - 1;
    // loads of later rows under the FMAs, as far as the registers hold them
    constexpr int UNROLL = RV * RC >= 32 ? 1 : RV * RC >= 8 ? 2 : 4;
    auto issue = [&](int i) {
      float* s = ring + (i % p.stages) * slot;
      stage_a(i, s, X, b0, nb);
      if (i >= p.cr) stage_w(i, s + ach);
    };
    for (int i = 0; i < D; ++i) {
      issue(i);
      cp_commit();
    }
    for (int i = 0; i < p.nch; ++i) {
      if (i + D < p.nch) issue(i + D);
      cp_commit();
      cp_wait(D);  // chunk i is in
      __syncthreads();
      const int k0 = gq * kc + i * kch;
      const int kn = on ? max(0, min(kch, min((gq + 1) * kc, K) - k0)) : 0;
      const float* s0 = ring + (i % p.stages) * slot;
      const float* as = s0 + gq * kch + vg * sa;
      const float* ws = (i < p.cr ? wres + i * wch : s0 + ach) + gq * kch + cg * sa;
      int kk = 0;
#pragma unroll(UNROLL)
      for (; kk + 4 <= kn; kk += 4) fma_rows<RV, RC>(acc, as, ws, kk, nvg * sa, ncg * sa, 4);
      if (kk < kn) fma_rows<RV, RC>(acc, as, ws, kk, nvg * sa, ncg * sa, kn - kk);
      __syncthreads();  // the slot is free
    }
    if (on) {
#pragma unroll
      for (int r = 0; r < RV; ++r)
#pragma unroll
        for (int s = 0; s < RC; ++s)
          red[(gq * bv + vg + r * nvg) * ncp + cg + s * ncg] = acc[r][s];
    }
  };
  // the groups' sums of (video v, column c), added in group order
  auto fold = [&](int v, int c) {
    const float* rp = red + v * ncp + c;
    float s = rp[0];
    for (int g = 1; g < nk; ++g) s += rp[g * bv * ncp];
    return s;
  };

  if (!CHAIN && p.cr < p.nch) {
    // the streamed rows of the forward's columns, packed as rows: 32 rows at
    // a time through shared memory ([ncr][33]), read along the columns and
    // written along the rows, both coalesced
    const int per = NTP / ncr, c = tid % ncr, r0 = tid / ncr;
    const float* wc = w + (c / u) * H + j0 + c % u;
    float* const pk = a.wpk + (size_t)blockIdx.x * 4 * p.units * a.kw;
    for (int g = 0; g < nk; ++g) {
      const int k1 = min((g + 1) * kc, K);
      for (int k0 = g * kc + p.cr * kch; k0 < k1; k0 += 32) {
        if (r0 < per)
          for (int r = r0; r < 32 && k0 + r < k1; r += per)
            sm[c * 33 + r] = __ldg(wc + (size_t)(k0 + r) * G);
        __syncthreads();
        for (int e = tid; e < ncr * 32; e += NTP) {
          const int cc = e >> 5, r = e & 31;
          if (k0 + r < k1) pk[(size_t)cc * a.kw + k0 + r] = sm[cc * 33 + r];
        }
        __syncthreads();
      }
    }
    __threadfence();  // in L2 before this CTA's cp.async.cg reads them
  }
  for (int i = tid; i < p.smem / 4; i += NTP) sm[i] = 0.f;  // padded columns stay 0
  __syncthreads();  // packed and zeroed before any copy lands
  for (int i = 0; i < p.cr; ++i) stage_w(i, wres + i * wch);
  cp_commit();
  cp_wait(0);
  __syncthreads();
  unsigned bar = 0;

  if constexpr (!CHAIN) {
    struct In {
      float x[4], mt, h, c;
    };
    auto load_in = [&](int t, int b, int j, const float* Xr) {
      In in;
      const float* xr = a.xp + (((size_t)t * 2 + dir) * B + b) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.x[q] = __ldg(xr + q * H);
      in.mt = __ldg(a.m + (size_t)t * B + b);
      in.h = __ldcg(Xr + (size_t)b * kp + j);
      in.c = st[(size_t)b * H + j];
      return in;
    };
    for (int t = 0; t < T; ++t) {
      const float* Xr = xch + (t & 1) * xbuf;  // h[t - 1] (0 at t = 0)
      float* Xw = xch + ((t + 1) & 1) * xbuf;  // h[t]
      for (int b0 = 0; b0 < B; b0 += bv) {
        const int nb = min(bv, B - b0), ne = nb * u;
        In pre = {};  // the first element's inputs, loaded under the products
        if (tid < ne) pre = load_in(t, b0 + tid / u, j0 + tid % u, Xr);
        products(Xr, b0, nb);
        __syncthreads();
        for (int e = tid; e < ne; e += NTP) {
          const int v = e / u, jj = e - v * u, b = b0 + v, j = j0 + jj;
          const In in = e == tid ? pre : load_in(t, b, j, Xr);
          float gt[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) gt[q] = __fadd_rn(in.x[q], fold(v, q * u + jj));
          const float c_new = cell(sigmoidf(gt[1]), in.c, sigmoidf(gt[0]), tanhf(gt[2]));
          const float h_new = sigmoidf(gt[3]) * tanhf(c_new);
          const float h = in.mt * h_new + (1.f - in.mt) * in.h;
          const float c = in.mt * c_new + (1.f - in.mt) * in.c;
          const size_t o = (((size_t)t * 2 + dir) * B + b) * H + j;
          a.outs[o] = h;
          if (a.cs) a.cs[o] = c;
          Xw[(size_t)b * kp + j] = h;
          st[(size_t)b * H + j] = c;
          if (t == T - 1) {
            a.h_fin[((size_t)dir * B + b) * H + j] = h;
            a.c_fin[((size_t)dir * B + b) * H + j] = c;
          }
        }
      }
      step_barrier(cnt, ++bar * P);
    }
    if (T == 0)
      for (int e = tid; e < B * u; e += NTP) {
        const size_t o = ((size_t)dir * B + e / u) * H + j0 + e % u;
        a.h_fin[o] = 0.f;
        a.c_fin[o] = 0.f;
      }
  } else {
    struct In {
      float cf[6], dout, mt, dc, dhp;
    };
    const size_t plane = (size_t)T * 2 * B * H;
    auto load_in = [&](int t, int b, int j) {
      In in;
      const size_t o = (((size_t)t * 2 + dir) * B + b) * H + j;
#pragma unroll
      for (int k = 0; k < 6; ++k) in.cf[k] = __ldg(a.coefs + k * plane + o);
      in.dout = __ldg(a.douts + o);
      in.mt = __ldg(a.m + (size_t)t * B + b);
      in.dc = st[(size_t)b * H + j];
      in.dhp = st[splane + (size_t)b * H + j];
      return in;
    };
    // step t of (b, j) from dh: dgate[t] into dxp and Xw; dc and dh's masked part kept
    auto chain_step = [&](int t, int b, int j, float dh, const In& in, float* Xw) {
      const float dht = dh + in.dout;
      const float dct = dht * in.cf[0] + in.mt * in.dc;
      const float dq[4] = {dct * in.cf[1], dct * in.cf[2], dct * in.cf[3], dht * in.cf[4]};
      st[(size_t)b * H + j] = dct * in.cf[5] + (1.f - in.mt) * in.dc;
      st[splane + (size_t)b * H + j] = (1.f - in.mt) * dht;
      float* dxr = a.dxp + (((size_t)t * 2 + dir) * B + b) * G + j;
      float* xw = Xw + (size_t)b * kp + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dxr[q * H] = dq[q];
        xw[q * H] = dq[q];
      }
    };
    if (T > 0) {  // step T - 1 from the cotangents of h_fin and c_fin
      float* Xw = xch + ((T - 1) & 1) * xbuf;
      for (int e = tid; e < B * u; e += NTP) {
        const int b = e / u, j = j0 + e - b * u;
        In in = load_in(T - 1, b, j);
        in.dc = __ldg(a.dc_fin + ((size_t)dir * B + b) * H + j);
        chain_step(T - 1, b, j, __ldg(a.dh_fin + ((size_t)dir * B + b) * H + j), in, Xw);
      }
      step_barrier(cnt, ++bar * P);
    }
    for (int t = T - 1; t >= 1; --t) {  // dh after step t, then step t - 1
      const float* Xr = xch + (t & 1) * xbuf;  // dgate[t]
      float* Xw = xch + ((t - 1) & 1) * xbuf;  // dgate[t - 1]
      for (int b0 = 0; b0 < B; b0 += bv) {
        const int nb = min(bv, B - b0), ne = nb * u;
        In pre = {};
        if (tid < ne) pre = load_in(t - 1, b0 + tid / u, j0 + tid % u);
        products(Xr, b0, nb);
        __syncthreads();
        for (int e = tid; e < ne; e += NTP) {
          const int v = e / u, jj = e - v * u, b = b0 + v, j = j0 + jj;
          const In in = e == tid ? pre : load_in(t - 1, b, j);
          chain_step(t - 1, b, j, in.dhp + fold(v, jj), in, Xw);
        }
      }
      step_barrier(cnt, ++bar * P);
    }
  }
}

using PKernel = void (*)(PArgs);

template <bool CHAIN>
PKernel persist_kernel(const PPlan& p) {
  switch (p.rv * 8 + p.rc) {
    case 9: return bilstm_persistent_kernel<CHAIN, 1, 1>;
    case 17: return bilstm_persistent_kernel<CHAIN, 2, 1>;
    case 33: return bilstm_persistent_kernel<CHAIN, 4, 1>;
    case 65: return bilstm_persistent_kernel<CHAIN, 8, 1>;
    case 18: return bilstm_persistent_kernel<CHAIN, 2, 2>;
    case 34: return bilstm_persistent_kernel<CHAIN, 4, 2>;
    case 36: return bilstm_persistent_kernel<CHAIN, 4, 4>;
    default: return bilstm_persistent_kernel<CHAIN, 8, 4>;
  }
}

// The persistent launch of B videos at H: the plan at one CTA an SM (its
// shared memory is budgeted to one), the CTAs an SM the card holds at the
// plan's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the
// SMs.  The grid is 2P = the SMs (rounded down to even) when an SM holds one.
cudaError_t persist_launch_plan(bool chain, int B, int H, PPlan& p, PKernel& kernel,
                                int& per_sm, int& sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (!persist_plan(chain, B, H, sms / 2, p)) return cudaErrorInvalidValue;
  kernel = chain ? persist_kernel<true>(p) : persist_kernel<false>(p);
  err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTP, p.smem);
  return err;
}

// One cooperative launch: raises (returns the error) where the card cannot
// hold the grid at once; never another kernel.
cudaError_t persist_launch(bool chain, PArgs& a, float* scratch, long scratch_floats,
                           cudaStream_t stream) {
  PKernel kernel;
  int per_sm = 0, sms = 0;
  cudaError_t err = persist_launch_plan(chain, a.B, a.H, a.p, kernel, per_sm, sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (!scratch || scratch_floats < persist_scratch_floats(a.p, chain, a.B, a.H))
    return cudaErrorInvalidValue;
  a.kp = a.p.nk * a.p.kc + EXCH_PAD;
  a.kw = (a.H + 3) & ~3;
  a.cnt = reinterpret_cast<unsigned*>(scratch);
  a.xch = scratch + 4;
  a.st = a.xch + 4L * a.B * a.kp;
  a.wpk = scratch + persist_zeroed_floats(a.p, chain, a.B, a.H);
  err = cudaMemsetAsync(scratch, 0, (size_t)(a.wpk - scratch) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * a.p.ctas), dim3(NTP), args,
                                    a.p.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

using ChainKernel = void (*)(const float*, const float*, const float*, const float*,
                             const float*, const float*, float*, int, int, int, int, int, int);

ChainKernel chain_kernel(const ChainPlan& p) {
  return p.gw ? bilstm_chain_kernel<4, true>
              : (p.gpq <= 32 ? bilstm_chain_kernel<32> : bilstm_chain_kernel<128>);
}

size_t chain_smem(const ChainPlan& p, int H) {
  return (size_t)(2 * BT * 4 * H + p.nq * BT * p.hs) * sizeof(float);
}

// A launch's report, out[16] = {persistent, CL or P (CTAs a direction),
// threads, NK or NQ, KC or GPQ, clusters or U (most units a CTA), clusters or
// CTAs the card holds at once, RV, RC, BV, tiles, KCH, chunks, resident
// chunks, ring stages, shared memory bytes a CTA}; the cluster kernels leave
// the last nine 0 but the shared memory.
cudaError_t launch_report(bool chain, int B, int H, int* out) {
  for (int i = 0; i < 16; ++i) out[i] = 0;
  FwdPlan f;
  ChainPlan c;
  if (B <= 0 || !(chain ? chain_plan(H, c) : fwd_plan(H, f))) return cudaErrorInvalidValue;
  if (chain ? c.persistent : f.persistent) {
    PPlan p;
    PKernel kernel;
    int per_sm = 0, sms = 0;
    const cudaError_t err = persist_launch_plan(chain, B, H, p, kernel, per_sm, sms);
    if (err != cudaSuccess) return err;
    const int v[16] = {1, p.ctas, NTP, p.nk, p.kc, p.units, std::min(per_sm, 1) * sms, p.rv,
                       p.rc, p.bv, p.tiles, p.kch, p.nch, p.cr, p.stages, p.smem};
    for (int i = 0; i < 16; ++i) out[i] = v[i];
    return cudaSuccess;
  }
  const int clusters = 2 * ((B + BT - 1) / BT);
  int active = 0;
  const dim3 grid(chain ? c.cl : f.cl, clusters / 2, 2);
  const size_t smem = chain ? chain_smem(c, H) : fwd_smem(f);
  const cudaError_t err =
      chain ? cluster::max_active_clusters(chain_kernel(c), grid, dim3(c.nt), c.cl, smem, &active)
            : cluster::max_active_clusters(fwd_kernel(f, H), grid, dim3(f.nt), f.cl, smem,
                                           &active);
  const int v[7] = {0, chain ? c.cl : f.cl, chain ? c.nt : f.nt, chain ? c.nq : f.nk,
                    chain ? c.gpq : f.kc, clusters, active};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  out[15] = (int)smem;
  return err;
}

}  // namespace

// Forward recurrence; `cs` (the cell trajectory [T, 2, B, H]) may be null.
// Above H = 256 the persistent kernel, which takes `scratch` (at least
// mucon_bilstm_scratch_floats(0, B, H) floats; null below).
extern "C" int mucon_bilstm_recurrence(const float* xp, const float* m, const float* w_hh,
                                       float* outs, float* h_fin, float* c_fin, float* cs,
                                       float* scratch, long scratch_floats, int T, int B, int H,
                                       cudaStream_t stream) {
  FwdPlan p;
  if (T < 0 || B <= 0 || !fwd_plan(H, p)) return cudaErrorInvalidValue;
  if (p.persistent) {
    PArgs a = {};
    a.xp = xp;
    a.m = m;
    a.w_hh = w_hh;
    a.outs = outs;
    a.h_fin = h_fin;
    a.c_fin = c_fin;
    a.cs = cs;
    a.T = T;
    a.B = B;
    a.H = H;
    return persist_launch(false, a, scratch, scratch_floats, stream);
  }
  return cluster::launch_cluster(fwd_kernel(p, H), dim3(p.cl, (B + BT - 1) / BT, 2), dim3(p.nt),
                                 p.cl, fwd_smem(p), stream, xp, m, w_hh, outs, h_fin, c_fin,
                                 cs, T, B, H, p.hs, p.nk, p.kc);
}

// The scratch a persistent launch takes (floats; 0: the cluster kernels take
// none; -1: no plan on this card).
extern "C" long mucon_bilstm_scratch_floats(int chain, int B, int H) {
  if (H <= NARROW_H || H > MAX_H_WIDE || B <= 0) return 0;
  PPlan p;
  PKernel kernel;
  int per_sm = 0, sms = 0;
  if (persist_launch_plan(chain, B, H, p, kernel, per_sm, sms) != cudaSuccess) return -1;
  return persist_scratch_floats(p, chain, B, H);
}

// The forward's launch for (B, H): `launch_report`.  Returns a cudaError
// (H refused: cudaErrorInvalidValue).
extern "C" int mucon_bilstm_fwd_plan(int B, int H, int* out) {
  return launch_report(false, B, H, out);
}

// The reverse chain's launch for (B, H): `launch_report`.
extern "C" int mucon_bilstm_chain_plan(int B, int H, int* out) {
  return launch_report(true, B, H, out);
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
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // where the (t, b) row tiles are too few for two CTAs an SM, the columns
  // split over grid.z too (each CTA its own j: the same sums)
  const int tiles = (T * B + RB - 1) / RB;
  const int jz = std::max(1, std::min((H + threads - 1) / threads, sms / tiles));
  const dim3 grid(tiles, 2, jz);
  bilstm_coefs_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, cs, coefs, cell, T,
                                                       B, H, p.nk, p.kc);
  return cudaGetLastError();
}

// The sequential pass of the reverse chain: dxp [T, 2, B, 4H] from the
// factors and the cotangents of outs, h_fin and c_fin.  Above H = 256 the
// persistent kernel, which takes `scratch` (mucon_bilstm_scratch_floats(1, B, H)).
extern "C" int mucon_bilstm_bwd_chain(const float* coefs, const float* m, const float* w_hh,
                                      const float* douts, const float* dh_fin,
                                      const float* dc_fin, float* dxp, float* scratch,
                                      long scratch_floats, int T, int B, int H,
                                      cudaStream_t stream) {
  ChainPlan p;
  if (T < 0 || B <= 0 || !chain_plan(H, p)) return cudaErrorInvalidValue;
  if (p.persistent) {
    if (T == 0) return cudaSuccess;
    PArgs a = {};
    a.m = m;
    a.w_hh = w_hh;
    a.coefs = coefs;
    a.douts = douts;
    a.dh_fin = dh_fin;
    a.dc_fin = dc_fin;
    a.dxp = dxp;
    a.T = T;
    a.B = B;
    a.H = H;
    return persist_launch(true, a, scratch, scratch_floats, stream);
  }
  return cluster::launch_cluster(chain_kernel(p), dim3(p.cl, (B + BT - 1) / BT, 2), dim3(p.nt),
                                 p.cl, chain_smem(p, H), stream, coefs, m, w_hh, douts, dh_fin,
                                 dc_fin, dxp, T, B, H, p.hs, p.nq, p.gpq);
}
