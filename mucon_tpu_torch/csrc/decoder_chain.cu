// Teacher-forced attention-decoder chain, forward and reverse, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_chain_fwd_kernel` (mucon_tpu/ops/decoder_pallas.py:93,
// called at :236) and `_chain_bwd_kernel` (:139, called at :298).  Those held
// the encoder block, the attention tables and every weight in VMEM for the
// whole trajectory.  Here the f32 weights alone are 768 KiB at H = 128 (Wl2 and
// Wc1 64 KiB each, Wc2 128 KiB, Wih and Whh 256 KiB each) and one video's
// tables (pre [Tz, H], enc [Tz, E]) 240 KiB at Tz = 160: neither fits a block's
// 227 KiB of shared memory.
//
// Forward design: one CTA per video (the videos are independent; only the weights are
// shared).  Weights and tables are read from global memory every step, where
// they stay resident in L2 (about 2.7 MB in all at B = 8, against 50 MB of L2);
// the state vectors (h, c, q, ctx, comb, gates) and the [Tz] score row live in
// shared memory.  Every Tz loop is strided, so any Tz works up to the score
// rows that shared memory holds (the wrapper states the limit);
// u = tanh(pre + q) is recomputed in each pass over pre instead of storing
// [Tz, H].
//
// Forward step (decoder_pallas.py:113-129), from the carry (h, c):
//   q = h Wl2 + bl2;  sc[t] = v . tanh(pre[t] + q), masked to -1e30;
//   a = softmax(sc) * maskf;  ctx = a enc;
//   cpre = [e; ctx] [Wc1; Wc2] + bc;  comb = relu(cpre);
//   gates = [comb; h] [Wih; Whh] + bl;  c = f c + i g;  h = o tanh(c)
// It stashes hs, cs and comb [S, B, H].
//
// Reverse chain (decoder_pallas.py:160-210), s = S-1 .. 0, in two passes.
// The stash holds every step's input state (h_in[s] = hs[s-1], c_in[s] =
// cs[s-1]), so the forward step need not be replayed inside the chain:
//  1. `chain_replay_kernel`, one CTA per (s, b), all at once: the forward
//     step from h_in[s] / c_in[s] through the forward kernel's own compiled
//     `forward_step` (same block size, so the same sums in the same order:
//     its cpre and cell are the forward's bit for bit), writing the gate
//     activations and tanh c, cpre, the attention weights a and
//     u = tanh(pre + q).
//  2. `chain_bwd_kernel`, the sequential (dh, dc) chain on one thread-block
//     cluster per video: [Wih; Whh]^T, Wl2^T and K = enc Wc2 spread over
//     the cluster's registers and shared memory for all S steps, the step's
//     vectors exchanged through distributed shared memory, two cluster
//     barriers a step (see the kernel).  It emits dgate, dcpre, dsc and, at
//     the end, dh0 and dc0.
// The weight gradients are left to the caller, as the JAX package leaves
// them to XLA.
//
// Bound on this card: 31 dependent steps a video.  The forward is latency
// on B CTAs (about 1 MB of weights from L2 a step); the reverse chain is
// two cluster barriers and a few short products a step, its weights
// resident.  Each forward product splits its K terms over the thread groups
// that the block has to spare and adds the groups' partial sums in group
// order; every other sum is a warp butterfly or a fixed-order loop.  No
// atomics: the kernels repeat bit for bit.  Accurate expf / tanhf
// throughout (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// f c + i g, rounded as one fused product-add of f c onto the rounded i g
// (the forward kernel and the replay pass both)
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

// Block-wide sum (or max) of one value per thread; every thread gets the
// same result, added in warp order.  `red` holds >= 32 floats.
__device__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// out[n] = bias[n] + sum_{k < K} x[k] W[k, n] for n < N (W row-major [K, N],
// bias may be null).  The K terms are split over G = blockDim / N thread
// groups, whose partial sums (in red, >= G * N floats) are added in group
// order.  x and out may be in shared memory; the call synchronises before it
// reads x and after it writes out.
__device__ void matvec(const float* x, int K, const float* __restrict__ W, int N,
                       const float* __restrict__ bias, float* out, float* red) {
  const int G = max(1, (int)blockDim.x / N);
  const int chunk = (K + G - 1) / G;
  __syncthreads();
  for (int i = threadIdx.x; i < G * N; i += blockDim.x) {
    const int g = i / N, n = i - g * N;
    const int k1 = min(K, (g + 1) * chunk);
    float acc = 0.f;
    for (int k = g * chunk; k < k1; ++k) acc = fmaf(x[k], __ldg(W + (size_t)k * N + n), acc);
    red[i] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = bias ? __ldg(bias + n) : 0.f;
    for (int g = 0; g < G; ++g) acc += red[g * N + n];
    out[n] = acc;
  }
  __syncthreads();
}

struct Chain {  // one video's tables and the shared weights
  const float* enc;    // [Tz, E]
  const float* pre;    // [Tz, H]
  const float* maskf;  // [Tz]
  const float* wl2;    // [H, H]
  const float* bl2;    // [H]
  const float* v;      // [H]
  const float* wcat;   // [H + E, H]: [Wc1; Wc2]
  const float* bc;     // [H]
  const float* wg;     // [2H, 4H]: [Wih; Whh]
  const float* bl;     // [4H]
  int Tz, H, E;
};

struct Smem {  // the step's vectors in shared memory
  float* x1;     // [H + E]: [e; ctx]
  float* x2;     // [2H]: [comb; h]
  float* c;      // [H] cell state
  float* q;      // [H]
  float* cpre;   // [H]
  float* gates;  // [4H] (dgate in the reverse step)
  float* sc;     // [Tz] scores, then the attention weights a
  float* red;    // [blockDim] matvec partials and reductions
};

// Replays one forward step from the carry h = x2[H:], c = sm.c: fills q, a
// (in sc), ctx, cpre, comb and gates.  e = x1[:H] is loaded by the caller.
// Not inlined: the forward kernel and the replay pass run one compiled
// body, so the replay's cpre, gates and cell are the forward's bit for bit.
__device__ __noinline__ void forward_step(const Chain& ch, const Smem& sm) {
  const int H = ch.H, E = ch.E, Tz = ch.Tz;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  matvec(sm.x2 + H, H, ch.wl2, H, ch.bl2, sm.q, sm.red);
  for (int t = warp; t < Tz; t += nw) {  // scores: one warp per frame
    const float* pr = ch.pre + (size_t)t * H;
    float acc = 0.f;
    for (int j = lane; j < H; j += 32) acc = fmaf(__ldg(ch.v + j), tanhf(pr[j] + sm.q[j]), acc);
    acc = warp_sum(acc);
    if (lane == 0) sm.sc[t] = ch.maskf[t] > 0.f ? acc : NEG;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = threadIdx.x; t < Tz; t += blockDim.x) m = fmaxf(m, sm.sc[t]);
  m = block_reduce(m, true, sm.red);
  float s = 0.f;
  for (int t = threadIdx.x; t < Tz; t += blockDim.x) {
    const float ex = expf(sm.sc[t] - m) * ch.maskf[t];
    sm.sc[t] = ex;
    s += ex;
  }
  s = block_reduce(s, false, sm.red);
  for (int t = threadIdx.x; t < Tz; t += blockDim.x) sm.sc[t] = sm.sc[t] / s;
  matvec(sm.sc, Tz, ch.enc, E, nullptr, sm.x1 + H, sm.red);           // ctx
  matvec(sm.x1, H + E, ch.wcat, H, ch.bc, sm.cpre, sm.red);           // cpre
  for (int j = threadIdx.x; j < H; j += blockDim.x) sm.x2[j] = fmaxf(sm.cpre[j], 0.f);
  matvec(sm.x2, 2 * H, ch.wg, 4 * H, ch.bl, sm.gates, sm.red);        // gates
}

__device__ Smem carve(float* base, int H, int E, int Tz) {
  Smem sm;
  sm.x1 = base;
  sm.x2 = sm.x1 + H + E;
  sm.c = sm.x2 + 2 * H;
  sm.q = sm.c + H;
  sm.cpre = sm.q + H;
  sm.gates = sm.cpre + H;
  sm.sc = sm.gates + 4 * H;
  sm.red = sm.sc + Tz;
  return sm;
}

__global__ void chain_fwd_kernel(Chain ch, const float* __restrict__ emb,  // [S, B, H]
                                 const float* __restrict__ h0,            // [B, H]
                                 const float* __restrict__ c0,            // [B, H]
                                 float* __restrict__ hs, float* __restrict__ cs,
                                 float* __restrict__ comb, int S, int B) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, H = ch.H;
  ch.enc += (size_t)b * ch.Tz * ch.E;
  ch.pre += (size_t)b * ch.Tz * H;
  ch.maskf += (size_t)b * ch.Tz;
  const Smem sm = carve(smem, H, ch.E, ch.Tz);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    sm.x2[H + j] = h0[(size_t)b * H + j];
    sm.c[j] = c0[(size_t)b * H + j];
  }
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)s * B + b) * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) sm.x1[j] = emb[o + j];
    forward_step(ch, sm);  // ends synchronised
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float* g = sm.gates;
      const float c = cell(sigmoidf(g[H + j]), sm.c[j], sigmoidf(g[j]), tanhf(g[2 * H + j]));
      const float h = sigmoidf(g[3 * H + j]) * tanhf(c);
      sm.c[j] = c;
      sm.x2[H + j] = h;
      hs[o + j] = h;
      cs[o + j] = c;
      comb[o + j] = sm.x2[j];
    }
  }
}

// Pass 1 of the reverse chain, parallel over every (s, b): one CTA replays
// step s of video b from the stash (h_in[s] = hs[s-1], c_in[s] = cs[s-1])
// with `forward_step`, on as many threads as the forward kernel, and writes
// what the chain needs of the step: acts [5, S, B, H] = (i, f, g, o,
// tanh c_out), cpre [S, B, H], the attention weights a [S, B, Tzp] (0 past
// Tz) and u = tanh(pre + q) [S, B, Tz, H]; `cell` (debug, may be null)
// receives c_out [S, B, H].
__global__ void chain_replay_kernel(Chain ch, const float* __restrict__ emb,  // [S, B, H]
                                    const float* __restrict__ h_in,          // [S, B, H]
                                    const float* __restrict__ c_in,          // [S, B, H]
                                    float* __restrict__ acts, float* __restrict__ cpre,
                                    float* __restrict__ a_out, float* __restrict__ u_out,
                                    float* __restrict__ cell_out, int S, int B, int Tzp) {
  extern __shared__ float smem[];
  const int s = blockIdx.x / B, b = blockIdx.x - s * B, H = ch.H, Tz = ch.Tz;
  ch.enc += (size_t)b * Tz * ch.E;
  ch.pre += (size_t)b * Tz * H;
  ch.maskf += (size_t)b * Tz;
  const Smem sm = carve(smem, H, ch.E, Tz);
  const size_t o = ((size_t)s * B + b) * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    sm.x1[j] = emb[o + j];
    sm.x2[H + j] = h_in[o + j];
    sm.c[j] = c_in[o + j];
  }
  forward_step(ch, sm);  // ends synchronised
  const size_t plane = (size_t)S * B * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float* g = sm.gates;
    const float ig = sigmoidf(g[j]), fg = sigmoidf(g[H + j]);
    const float gg = tanhf(g[2 * H + j]), og = sigmoidf(g[3 * H + j]);
    const float c = cell(fg, sm.c[j], ig, gg);
    const float v[5] = {ig, fg, gg, og, tanhf(c)};
#pragma unroll
    for (int q = 0; q < 5; ++q) acts[q * plane + o + j] = v[q];
    cpre[o + j] = sm.cpre[j];
    if (cell_out) cell_out[o + j] = c;
  }
  float* ar = a_out + ((size_t)s * B + b) * Tzp;
  for (int t = threadIdx.x; t < Tzp; t += blockDim.x) ar[t] = t < Tz ? sm.sc[t] : 0.f;
  float* ur = u_out + ((size_t)s * B + b) * Tz * H;
  for (int i = threadIdx.x; i < Tz * H; i += blockDim.x)
    ur[i] = tanhf(ch.pre[i] + sm.q[i % H]);
}

constexpr int NTB = 256;  // threads per CTA of the chain

// How the chain splits H over a cluster: CL = cluster::width_for(H) CTAs
// of HS units, HS a
// multiple of 4 (16-byte copies of u's columns); [dgate] x [Wih; Whh]^T for
// the CTA's 2 HS output columns (its units' dcomb and dh parts) over NQ
// groups of RQ dgate rows (a multiple of 4, at most 64: the weights a
// thread keeps in registers); one thread per unit (H <= NTB).
struct BwdPlan {
  int cl, hs, nq, rq;
};

bool bwd_plan(int H, BwdPlan& p) {
  p.cl = cluster::width_for(H);
  p.hs = H / p.cl;
  if (H < 4 || H > NTB || p.hs % 4) return false;
  p.nq = NTB / (2 * p.hs);
  p.rq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
  return p.rq <= 64 && p.hs <= 32;
}

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// the chain's shared memory, in floats (each region a multiple of 4)
struct BwdSmem {
  float *dg, *red, *dhp, *dcp, *dq, *rd, *K, *X1, *ds, *a, *u, *X2, *DH;
};

__host__ __device__ inline size_t bwd_carve(float* base, const BwdPlan& p, int H, int Tz,
                                            BwdSmem* sm) {
  const int Tzp = up4(Tz);
  const int sizes[13] = {p.nq * p.rq, NTB, 2 * p.hs, p.hs, p.hs, 32, Tz * p.hs,
                         up4(p.cl * Tz), Tzp, Tzp, Tz * p.hs, p.cl * H, H};
  float** slots[13] = {&sm->dg, &sm->red, &sm->dhp, &sm->dcp, &sm->dq, &sm->rd, &sm->K,
                       &sm->X1, &sm->ds, &sm->a, &sm->u, &sm->X2, &sm->DH};
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    *slots[i] = base + off;
    off += up4(sizes[i]);
  }
  return off;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Pass 2, the sequential chain: one cluster of CL CTAs per video, grid (CL,
// B).  CTA r owns units J = [r HS, (r+1) HS).  Resident for all S steps:
// its 2 HS rows of [Wih; Whh] (= the columns of the transposed product) in
// registers, RQ a thread; Wl2's columns J in registers, HS a thread; and
// K = enc Wc2 [Tz x HS] for its units in shared memory (computed once:
// da = enc (dcpre Wc2^T) = (enc Wc2) dcpre).  A step, from dh and dc of
// every unit (all CTAs compute the elementwise part for all H units alike,
// so dc never needs an exchange):
//   dgate (4H);  dhp = dgate [Wih; Whh]^T for its 2 HS columns;  dcpre
//   for J;  partial da over J for every frame -> every peer (DSMEM);
//   cluster barrier 1;
//   da = sum of the CL partials (rank order); <a, da>; dsc (every CTA
//   alike);  dq for J (u's columns J were copied in at the step's start by
//   cp.async);  partial dq Wl2^T over J for every unit, and dh's part of
//   dhp for J -> every peer;  cluster barrier 2;
// then the next step's dh = dhh + sum of the partials.  Two cluster
// barriers a step; every sum in a fixed order, no atomics.  The next
// step's factors are loaded a step ahead.
template <int RQ, int WL>
__global__ void __launch_bounds__(NTB) chain_bwd_kernel(
    const float* __restrict__ acts,       // [5, S, B, H]: i, f, g, o, tanh c_out
    const float* __restrict__ cpre,       // [S, B, H]
    const float* __restrict__ a_in,       // [S, B, Tzp]
    const float* __restrict__ u_in,       // [S, B, Tz, H]
    const float* __restrict__ c_in,       // [S, B, H]
    const float* __restrict__ enc,        // [B, Tz, E]
    const float* __restrict__ v,          // [H]
    const float* __restrict__ wc2,        // [E, H]
    const float* __restrict__ wg,         // [2H, 4H]: [Wih; Whh]
    const float* __restrict__ wl2,        // [H, H]
    const float* __restrict__ dh_ext,     // [S, B, H]
    const float* __restrict__ dc_ext,     // [S, B, H]
    const float* __restrict__ dcomb_ext,  // [S, B, H]
    float* __restrict__ dgate_out,        // [S, B, 4H]
    float* __restrict__ dcpre_out,        // [S, B, H]
    float* __restrict__ dsc_out,          // [S, B, Tz]
    float* __restrict__ dh0, float* __restrict__ dc0,  // [B, H]
    int S, int B, int Tz, int H, int E, int hs, int nq, int rq) {
  extern __shared__ float4 smb4[];
  const BwdPlan p{(int)gridDim.x, hs, nq, rq};
  BwdSmem sm;
  bwd_carve(reinterpret_cast<float*>(smb4), p, H, Tz, &sm);
  const int cl = p.cl, Tzp = up4(Tz), G = 4 * H;
  const int rank = cluster::cluster_rank(), j0 = rank * hs;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // product role: dgate rows [k0, k0 + kn) of output column n
  const int ncol = 2 * hs;
  const int pc = tid % ncol, kq = tid / ncol;
  const int n = pc < hs ? j0 + pc : H + j0 + pc - hs;
  const int k0 = kq * rq;
  const int kn = kq < nq ? max(0, min(rq, G - k0)) : 0;
  float wr[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) wr[i] = i < kn ? wg[(size_t)n * G + k0 + i] : 0.f;
  // unit role (tid < H): Wl2[tid, J] for the partial dq Wl2^T
  float wl[WL];
#pragma unroll
  for (int i = 0; i < WL; ++i) wl[i] = (tid < H && i < hs) ? wl2[(size_t)tid * H + j0 + i] : 0.f;
  const float v_own = tid < hs ? v[j0 + tid] : 0.f;

  // K[t][jj] = sum_e enc[b, t, e] Wc2[e, j0 + jj]
  const float* eb = enc + (size_t)b * Tz * E;
  for (int i = tid; i < Tz * hs; i += NTB) {
    const int t = i / hs, jj = i - t * hs;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) acc = fmaf(eb[(size_t)t * E + e], wc2[(size_t)e * H + j0 + jj], acc);
    sm.K[i] = acc;
  }
  for (int i = tid; i < p.nq * rq; i += NTB) sm.dg[i] = 0.f;  // rows past 4H stay 0
  for (int i = tid; i < cl * H; i += NTB) sm.X2[i] = 0.f;
  for (int i = tid; i < H; i += NTB) sm.DH[i] = 0.f;
  cluster::cluster_sync();  // before any peer writes here

  // the step's factors and cotangents (unit tid), loaded a step ahead
  const size_t plane = (size_t)S * B * H;
  float f_i = 0.f, f_f = 0.f, f_g = 0.f, f_o = 0.f, f_tc = 0.f, f_c = 0.f, e_h = 0.f,
        e_c = 0.f, own_cpre = 0.f, own_dcomb = 0.f;
  auto fetch = [&](int s) {
    const size_t o = ((size_t)s * B + b) * H;
    if (tid < H) {
      f_i = __ldg(acts + o + tid);
      f_f = __ldg(acts + plane + o + tid);
      f_g = __ldg(acts + 2 * plane + o + tid);
      f_o = __ldg(acts + 3 * plane + o + tid);
      f_tc = __ldg(acts + 4 * plane + o + tid);
      f_c = __ldg(c_in + o + tid);
      e_h = __ldg(dh_ext + o + tid);
      e_c = __ldg(dc_ext + o + tid);
    }
    if (tid < hs) {
      own_cpre = __ldg(cpre + o + j0 + tid);
      own_dcomb = __ldg(dcomb_ext + o + j0 + tid);
    }
  };
  fetch(S - 1);
  float dc_c = 0.f;  // every CTA carries dc of unit tid alike

  for (int s = S - 1; s >= 0; --s) {
    const size_t o = ((size_t)s * B + b) * H;
    {  // this step's a and u[:, J], for the dsc and dq phases
      const float* ar = a_in + ((size_t)s * B + b) * Tzp;
      for (int i = tid; i < Tzp / 4; i += NTB) cp_async16(sm.a + 4 * i, ar + 4 * i);
      const float* ur = u_in + ((size_t)s * B + b) * Tz * H + j0;
      const int q4 = hs / 4;
      for (int i = tid; i < Tz * q4; i += NTB) {
        const int t = i / q4, c = i - t * q4;
        cp_async16(sm.u + t * hs + 4 * c, ur + (size_t)t * H + 4 * c);
      }
    }
    if (tid < H) {  // dh and dc of unit tid, then its four dgate rows
      float dql = sm.X2[tid];
      for (int r = 1; r < cl; ++r) dql += sm.X2[r * H + tid];
      const float dh = (sm.DH[tid] + dql) + e_h;
      const float dc = dc_c + e_c;
      const float dct = dh * f_o * (1.f - f_tc * f_tc) + dc;
      dc_c = dct * f_f;
      const float dq4[4] = {dct * f_g * f_i * (1.f - f_i), dct * f_c * f_f * (1.f - f_f),
                            dct * f_i * (1.f - f_g * f_g), dh * f_tc * f_o * (1.f - f_o)};
      const bool own = tid >= j0 && tid < j0 + hs;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sm.dg[q * H + tid] = dq4[q];
        if (own) dgate_out[o * 4 + q * H + tid] = dq4[q];
      }
    }
    const float cp_own = own_cpre, dcomb_own = own_dcomb;
    if (s > 0) fetch(s - 1);
    __syncthreads();
    if (kq < nq) {  // partial dhp of column n over the group's rows
      float acc = 0.f;
      const float* dr = sm.dg + k0;
#pragma unroll
      for (int i = 0; i < RQ; i += 4) {
        if (i < kn) {
          const float4 d = *reinterpret_cast<const float4*>(dr + i);
          acc = fmaf(d.x, wr[i], acc);
          acc = fmaf(d.y, wr[i + 1], acc);
          acc = fmaf(d.z, wr[i + 2], acc);
          acc = fmaf(d.w, wr[i + 3], acc);
        }
      }
      sm.red[kq * ncol + pc] = acc;
    }
    __syncthreads();
    if (tid < ncol) {
      float d = sm.red[tid];
      for (int q = 1; q < nq; ++q) d += sm.red[q * ncol + tid];
      if (tid < hs) {
        d = cp_own > 0.f ? d + dcomb_own : 0.f;
        sm.dcp[tid] = d;
        dcpre_out[o + j0 + tid] = d;
      } else {
        sm.dhp[tid] = d;  // dh's part of unit j0 + tid - hs
      }
    }
    __syncthreads();
    for (int t = tid; t < Tz; t += NTB) {  // partial da over J, to every peer
      const float* kr = sm.K + t * hs;
      float acc = 0.f;
      for (int jj = 0; jj < hs; ++jj) acc = fmaf(sm.dcp[jj], kr[jj], acc);
      for (int r = 0; r < cl; ++r) cluster::cluster_peer(sm.X1, r)[rank * Tz + t] = acc;
    }
    cp_async_wait_all();
    cluster::cluster_sync();  // barrier 1: every partial da, and a and u, are here

    float ad = 0.f;
    for (int t = tid; t < Tz; t += NTB) {
      float da = sm.X1[t];
      for (int r = 1; r < cl; ++r) da += sm.X1[r * Tz + t];
      sm.ds[t] = da;
      ad = fmaf(sm.a[t], da, ad);
    }
    ad = warp_sum(ad);
    if (lane == 0) sm.rd[warp] = ad;
    __syncthreads();
    ad = sm.rd[0];
    for (int w = 1; w < NTB / 32; ++w) ad += sm.rd[w];
    const int tz0 = rank * ((Tz + cl - 1) / cl), tz1 = min(Tz, tz0 + (Tz + cl - 1) / cl);
    for (int t = tid; t < Tz; t += NTB) {
      const float d = sm.a[t] * (sm.ds[t] - ad);
      sm.ds[t] = d;
      if (t >= tz0 && t < tz1) dsc_out[((size_t)s * B + b) * Tz + t] = d;
    }
    __syncthreads();
    {  // dq[jj] = v[j] sum_t dsc[t] (1 - u[t, j]^2): the t terms over NTB / hs groups
      const int ng = NTB / hs, jj = tid % hs, gi = tid / hs;
      const int chunk = (Tz + ng - 1) / ng;
      const int t1 = min(Tz, (gi + 1) * chunk);
      float acc = 0.f;
      for (int t = gi * chunk; t < t1; ++t) {
        const float u = sm.u[t * hs + jj];
        acc = fmaf(sm.ds[t], 1.f - u * u, acc);
      }
      sm.red[gi * hs + jj] = acc;
      __syncthreads();
      if (tid < hs) {
        float q = sm.red[tid];
        for (int g = 1; g < ng; ++g) q += sm.red[g * hs + tid];
        sm.dq[tid] = v_own * q;
      }
      __syncthreads();
    }
    if (tid < H) {  // partial dq Wl2^T over J for unit tid, to every peer
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < WL; ++i)
        if (i < hs) acc = fmaf(sm.dq[i], wl[i], acc);
      for (int r = 0; r < cl; ++r) cluster::cluster_peer(sm.X2, r)[rank * H + tid] = acc;
    }
    if (tid >= hs && tid < ncol)
      for (int r = 0; r < cl; ++r)
        cluster::cluster_peer(sm.DH, r)[j0 + tid - hs] = sm.dhp[tid];
    cluster::cluster_sync();  // barrier 2: every partial of dh is here
  }
  if (rank == 0 && tid < H) {
    float dql = sm.X2[tid];
    for (int r = 1; r < cl; ++r) dql += sm.X2[r * H + tid];
    dh0[(size_t)b * H + tid] = sm.DH[tid] + dql;
    dc0[(size_t)b * H + tid] = dc_c;
  }
}

int threads_for(int H, int E) {
  const int n = max(4 * H, E);
  return max(64, (n + 31) / 32 * 32);
}

size_t fwd_smem(int H, int E, int Tz, int threads) {
  return (size_t)((H + E) + 2 * H + 3 * H + 4 * H + Tz + threads) * sizeof(float);
}

size_t chain_smem(const BwdPlan& p, int H, int Tz) {
  BwdSmem sm;
  return bwd_carve(nullptr, p, H, Tz, &sm) * sizeof(float);
}

cudaError_t check_smem(size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return smem > (size_t)max_smem ? cudaErrorInvalidValue : cudaSuccess;
}

int launch_setup(const void* fn, size_t smem) {
  const cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int S, int B, int Tz, int H, int E) {
  return S < 1 || B < 1 || Tz < 1 || H < 1 || E < 1 || threads_for(H, E) > 1024;
}

}  // namespace

// Bytes of shared memory a block of the forward kernel (reverse = 0) or of
// the larger of the reverse chain's two passes (reverse = 1) needs; -1
// where the reverse chain refuses H.  The wrapper checks it against the
// card's limit before it launches.
extern "C" int mucon_decoder_chain_smem(int H, int E, int Tz, int reverse) {
  const size_t fwd = fwd_smem(H, E, Tz, threads_for(H, E));
  if (!reverse) return (int)fwd;
  BwdPlan p;
  if (!bwd_plan(H, p)) return -1;
  const size_t chain = chain_smem(p, H, Tz);
  return (int)(fwd > chain ? fwd : chain);
}

// The cluster width the reverse chain takes for a hidden size H (0: refused).
extern "C" int mucon_decoder_chain_width(int H) {
  BwdPlan p;
  return bwd_plan(H, p) ? p.cl : 0;
}

extern "C" int mucon_decoder_chain_fwd(const float* emb, const float* enc, const float* pre,
                                       const float* maskf, const float* h0, const float* c0,
                                       const float* wl2, const float* bl2, const float* v,
                                       const float* wcat, const float* bc, const float* wg,
                                       const float* bl, float* hs, float* cs, float* comb,
                                       int S, int B, int Tz, int H, int E,
                                       cudaStream_t stream) {
  if (bad_shape(S, B, Tz, H, E)) return cudaErrorInvalidValue;
  const int threads = threads_for(H, E);
  const size_t smem = fwd_smem(H, E, Tz, threads);
  cudaError_t err = (cudaError_t)launch_setup((const void*)chain_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const Chain ch{enc, pre, maskf, wl2, bl2, v, wcat, bc, wg, bl, Tz, H, E};
  chain_fwd_kernel<<<B, threads, smem, stream>>>(ch, emb, h0, c0, hs, cs, comb, S, B);
  return cudaGetLastError();
}

// Pass 1 of the reverse chain: every step replayed at once (see
// `chain_replay_kernel`); `cell` may be null.
extern "C" int mucon_decoder_chain_replay(const float* emb, const float* enc, const float* pre,
                                          const float* maskf, const float* h_in,
                                          const float* c_in, const float* wl2,
                                          const float* bl2, const float* v, const float* wcat,
                                          const float* bc, const float* wg, const float* bl,
                                          float* acts, float* cpre, float* a, float* u,
                                          float* cell, int S, int B, int Tz, int H, int E,
                                          cudaStream_t stream) {
  if (bad_shape(S, B, Tz, H, E)) return cudaErrorInvalidValue;
  const int threads = threads_for(H, E);
  const size_t smem = fwd_smem(H, E, Tz, threads);
  cudaError_t err = (cudaError_t)launch_setup((const void*)chain_replay_kernel, smem);
  if (err != cudaSuccess) return err;
  const Chain ch{enc, pre, maskf, wl2, bl2, v, wcat, bc, wg, bl, Tz, H, E};
  chain_replay_kernel<<<S * B, threads, smem, stream>>>(ch, emb, h_in, c_in, acts, cpre, a, u,
                                                        cell, S, B, up4(Tz));
  return cudaGetLastError();
}

// Pass 2: the sequential chain on one cluster per video (see
// `chain_bwd_kernel`) -> dgate, dcpre, dsc, dh0, dc0.
extern "C" int mucon_decoder_chain_bwd(const float* acts, const float* cpre, const float* a,
                                       const float* u, const float* c_in, const float* enc,
                                       const float* v, const float* wc2, const float* wg,
                                       const float* wl2, const float* dh_ext,
                                       const float* dc_ext, const float* dcomb_ext,
                                       float* dgate, float* dcpre, float* dsc, float* dh0,
                                       float* dc0, int S, int B, int Tz, int H, int E,
                                       cudaStream_t stream) {
  BwdPlan p;
  if (bad_shape(S, B, Tz, H, E) || !bwd_plan(H, p)) return cudaErrorInvalidValue;
  const size_t smem = chain_smem(p, H, Tz);
  const cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  auto kernel = p.rq <= 16 ? chain_bwd_kernel<16, 32> : chain_bwd_kernel<64, 32>;
  return cluster::launch_cluster(kernel, dim3(p.cl, B), dim3(NTB), p.cl, smem, stream, acts,
                                 cpre, a, u, c_in, enc, v, wc2, wg, wl2, dh_ext, dc_ext,
                                 dcomb_ext, dgate, dcpre, dsc, dh0, dc0, S, B, Tz, H, E, p.hs,
                                 p.nq, p.rq);
}
