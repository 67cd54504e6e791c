// Teacher-forced attention-decoder chain, forward and reverse, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels `_chain_fwd_kernel` (mucon_tpu/ops/decoder_pallas.py:93,
// called at :236) and `_chain_bwd_kernel` (:139, called at :298).  Those held
// the encoder block, the attention tables and every weight in VMEM for the
// whole trajectory.  Here the f32 weights are 768 KiB at H = 128 (Wl2 and Wc1
// 64 KiB each, Wc2 128 KiB, Wih and Whh 256 KiB each) and one video's tables
// (pre [Tz, H], enc [Tz, E]) 240 KiB at Tz = 160: neither fits a block's
// 227 KiB of shared memory, so both chains split them over a thread-block
// cluster.
//
// Forward step (decoder_pallas.py:113-129), from the carry (h, c):
//   q = h Wl2 + bl2;  sc[t] = v . tanh(pre[t] + q), masked to -1e30;
//   a = softmax(sc) * maskf;  ctx = a enc;
//   cpre = [e; ctx] [Wc1; Wc2] + bc;  comb = relu(cpre);
//   gates = [comb; h] [Wih; Whh] + bl;  c = f c + i g;  h = o tanh(c)
// It stashes hs, cs and comb [S, B, H].
//
// Forward design (`chain_fwd_kernel`): one cluster of CL = cluster::ragged_width(H)
// CTAs per video (8 from H = 64), CTA r owning the hidden units
// cluster::units_of(r, CL, H) (H / CL each where CL divides H, as at H =
// 128; else ceil or floor of H / CL, the regions sized by the largest share
// HS) and frames [r Tz / CL, (r + 1) Tz / CL).  Resident in each CTA's shared memory
// for all S steps, loaded from L2 once a call where they fit (at H = 128,
// E = 256 they do): its units' rows of Wl2 (HS x H), the [Wih; Whh] columns
// of its units' four gates (2H x 4 HS, 64 KiB at H = 128) and the [Wc1; Wc2]
// columns of its units ((H + E) x HS, 24 KiB), the last two by column so
// that a warp's lanes read 32 consecutive k; where they do not (H = 256),
// the step reads the same columns from the wrapper's transposed copies in
// L2.  Then, where they fit, its frames' rows of maskf, pre and enc (30 KiB
// at Tz = 160; beyond that they are read from L2 every step).  Where the
// operands live changes no sum.  A step (`cluster_step`) exchanges four
// things through distributed shared memory:
//   1. the scores of the rank's frames from q; its softmax partials m_r =
//      max, s_r = sum of exp(sc - m_r) maskf and ctx_r = sum ex enc [E]
//      -> every rank;
//   2. ctx = sum_r w_r ctx_r / sum_r w_r s_r with w_r = exp(m_r - m), the
//      ranks in rank order (a rank with no valid frame, or none at all,
//      weighs 0); cpre for the rank's units -> relu(cpre) to every rank;
//   3. the gates, the cell and h of the rank's units -> h to every rank
//      (two buffers, by step parity);
//   4. with h, the rank's partial of the next step's q, its units' rows of
//      h Wl2 [H] -> every rank; q = their sum in rank order + bl2.
// Each exchange is `st.async` stores into the peers' shared memory that
// complete transaction bytes on the peer's mbarrier, which the peer arms
// for the bytes it expects and waits on: no cluster barrier and no memory
// fence a step (a cluster barrier's release is a GPU-wide MEMBAR and its
// acquire invalidates L1).  What a step reads of a peer's buffer is written
// again only after the peer has had the reader's next exchange, so one
// buffer an exchange is enough (two for h, which the next step reads while
// this one's arrives).  The products that need no peer's data (e Wc1 of
// cpre, h Whh of the gates) run while an exchange is in flight.  The
// combine layer and the gates are warp GEMVs: a warp's lanes split k, and a
// fixed shuffle reduce-scatter adds them; 8 warps take 32 combine columns
// and 128 gate columns (32 units) a pass, and a share above 32 units (H
// above 256) takes more passes.  Every sum is in a fixed order,
// no atomics: two calls agree bit for bit.  The step is compiled for the
// model's shape (H = 128, E = 256, CL = 8: every loop bound a constant) and
// for any other.
//
// Reverse chain (decoder_pallas.py:160-210), s = S-1 .. 0, in two passes.
// The stash holds every step's input state (h_in[s] = hs[s-1], c_in[s] =
// cs[s-1]), so the forward step need not be replayed inside the chain:
//  1. `chain_replay_kernel`, the forward step of every (s, b) at once, on
//     clusters of the forward's shape through the forward's own compiled
//     `cluster_step` and `send_q_partials` (`__noinline__`, same width,
//     same block size, so the same sums in the same order: its cpre and cell
//     are the forward's bit for bit).  Each cluster loads the weights once
//     and then takes (s, b) items in turn, as many clusters as the card
//     holds at once, the next item's inputs and table rows copied in by
//     `cp.async` during the current one.  It writes the gate activations
//     and tanh c, cpre, the attention weights a and u = tanh(pre + q).
//  2. `chain_bwd_kernel`, the sequential (dh, dc) chain on one thread-block
//     cluster per video: [Wih; Whh]^T, Wl2^T and K = enc Wc2 spread over
//     the cluster's registers and shared memory for all S steps, the step's
//     vectors exchanged through distributed shared memory, two cluster
//     barriers a step (see the kernel).  It emits dgate, dcpre, dsc and, at
//     the end, dh0 and dc0.
// The weight gradients are left to the caller, as the JAX package leaves
// them to XLA.
//
// Widths: every H from 1 to 512 on the kernels above (past 512, see
// below).  The forward takes its ragged split at every H (a CTA's threads
// stride over its share of units, its passes of 32 columns), so no H runs
// on fewer than 8 CTAs from H = 64 on; the replay copies its next item's e
// in only after the passes that read this one's.
// The reverse chain takes the split above where its registers hold it, else
// a ragged one (`bwd_plan`, gw): CL = cluster::ragged_width(H) CTAs of uneven shares,
// 512 threads (a thread a unit), the [Wih; Whh] rows and Wl2's columns read
// from L2 every step, u's columns copied 4 bytes at a time.
//
// Above a width that depends on B (`CROSSINGS`: at B = 8, H = 432 for the
// forward and the replay pass and 256 for the reverse chain), up to
// MAX_H_WIDE = 2048 (the JAX package's byte gates stop its
// kernel at H = 1181), and wherever the forward's rows of maskf, pre and
// enc or the reverse chain's [Tz x HS] tables K and u and its [CL x Tz]
// partials would not fit a block's shared memory (long Tz, at any H), the
// chain runs on the persistent kernels of csrc/decoder_persistent.cu
// (`mucon_decoder_chain_route`), which sum in these kernels' orders.  The
// cluster forward and replay pass take any H their shared memory holds.
//
// Bound on this card: 31 dependent steps a video, each a few short products
// from shared memory, the tanh table of the rank's frames and four
// exchanges (forward), or two cluster barriers (reverse).  Accurate expf /
// tanhf throughout (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "decoder_chain.cuh"

namespace {

using namespace dchain;

constexpr int NTF = 256;     // threads per CTA of the forward chain and the replay pass

// The forward's exchanges: `st.async` stores into a peer's shared memory
// that complete transaction bytes on the peer's mbarrier, which the peer
// arms for the bytes it expects and waits on (acquire at cluster scope).
// No cluster-wide barrier and no memory fence on the path.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `addr` (this CTA's) in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async(uint32_t raddr, float v, uint32_t rmbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(raddr), "r"(__float_as_uint(v)), "r"(rmbar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes)
               : "memory");
}

// waits for phase `parity` of the mbarrier; traps (an error, not a hang)
// if it has not completed after ~2^22 tries
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    if (done) return;
    if (tries > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

static_assert(NTF == 256, "8 warps: 4 columns of cpre and 8 gate columns a warp a pass");
static_assert((MAX_H_WIDE + 7) / 8 <= NTF, "a thread a unit of a CTA's share, 8 CTAs or more");

// frames of rank r: [r Tz / CL, (r + 1) Tz / CL); at most ceil(Tz / CL)
__host__ __device__ inline int rank_rows(int Tz, int cl) { return (Tz + cl - 1) / cl; }

// One CTA's shared memory (floats): when `weights`, the resident weights,
// each matrix stored by column (k fastest, so that a warp's lanes read 32
// consecutive k); the step's vectors; when `tables`, its frames' rows of
// maskf, pre and enc.  A region left out is null, and read from L2.
struct FwdSmem {
  float *mbar;  // [8]: four mbarriers (u64), one an exchange
  float *xe;    // [2H] the next step's e (forward) or h_in and c_in (replay), prefetched
  float *wl2;   // [HS][H] or null: the rank's rows j0 .. j0 + HS - 1 of Wl2
  float *wg;    // [4 HS][2H + 1] or null: [Wih; Whh] column q H + j0 + jj at 4 jj + q
  float *wc;    // [HS][H + E + 1] or null: [Wc1; Wc2] column j0 + jj
  float *vec;   // v [H], bl2 [H], bc [HS] and bl [4 HS] (the rank's, at 4 jj + q)
  float *x1;    // [H + E]: [e; ctx]
  float *comb;  // [H] relu(cpre), every unit
  float *hb;    // [2][H] h, every unit, by step parity
  float *q;     // [H]
  float *c;     // [HS] the cell of the rank's units
  float *cp;    // [HS] cpre of the rank's units
  float *act;   // [6][HS] i, f, g, o, tanh c, h of the rank's units
  float *ms;    // [4] the rank's m_r, s_r
  float *part;  // [CL][E + 2] every rank's (m_r, s_r, ctx_r)
  float *qp;    // [CL][H] every rank's partial q (its units' rows of h Wl2)
  float *sc;    // [rows] the rank's scores, then exp(sc - m_r) maskf
  float *mk;    // [rows] or null: the rank's rows of maskf
  float *pre;   // [rows][H] or null
  float *enc;   // [rows][E] or null
};

__host__ __device__ inline size_t fwd_carve(float* base, int cl, int hs, int H, int E, int Tz,
                                            bool weights, bool tables, FwdSmem* sm) {
  const size_t rows = rank_rows(Tz, cl), w = weights, t = tables;
  const size_t sizes[20] = {8, (size_t)2 * H, w * hs * H, w * 4 * hs * (2 * H + 1),
                            w * hs * (H + E + 1),
                            (size_t)2 * H + 5 * hs, (size_t)(H + E), (size_t)H, (size_t)2 * H,
                            (size_t)H, (size_t)hs, (size_t)hs, (size_t)6 * hs, 4,
                            (size_t)cl * (E + 2), (size_t)cl * H, rows, t * rows,
                            t * rows * H, t * rows * E};
  float** slots[20] = {&sm->mbar, &sm->xe, &sm->wl2, &sm->wg, &sm->wc, &sm->vec, &sm->x1,
                       &sm->comb, &sm->hb,
                       &sm->q, &sm->c, &sm->cp, &sm->act, &sm->ms, &sm->part, &sm->qp,
                       &sm->sc, &sm->mk, &sm->pre, &sm->enc};
  size_t off = 0;
  for (int i = 0; i < 20; ++i) {
    *slots[i] = sizes[i] ? base + off : nullptr;
    off += (sizes[i] + 1) & ~(size_t)1;  // 8-byte aligned regions
  }
  return off;
}

struct Chain {  // the shared weights and the sizes (hs: the largest share of units)
  const float* enc;    // [B, Tz, E]
  const float* pre;    // [B, Tz, H]
  const float* maskf;  // [B, Tz]
  const float* wl2;    // [H, H]
  const float* bl2;    // [H]
  const float* v;      // [H]
  const float* wcT;    // [H, H + E]: [Wc1; Wc2] transposed
  const float* bc;     // [H]
  const float* wgT;    // [H, 4, 2H]: [Wih; Whh] column q H + j at row 4 j + q
  const float* bl;     // [4H]
  int Tz, H, E;
  int cl, hs;
  int weights, tables;  // the rank's weights / rows of maskf, pre, enc in shared memory
};

struct Rank {  // this CTA's place in its cluster: its units [j0, j0 + hs), its frames
  int rank, j0, hs, t0, t1;
};

__device__ inline Rank this_rank(const Chain& ch) {
  Rank r;
  r.rank = cluster::cluster_rank();
  cluster::units_of(r.rank, ch.cl, ch.H, r.j0, r.hs);
  r.t0 = r.rank * ch.Tz / ch.cl;
  r.t1 = (r.rank + 1) * ch.Tz / ch.cl;
  return r;
}

__device__ inline FwdSmem carve(float* smem, const Chain& ch) {
  FwdSmem sm;
  fwd_carve(smem, ch.cl, ch.hs, ch.H, ch.E, ch.Tz, ch.weights, ch.tables, &sm);
  return sm;
}

// The rank's weights, resident or in L2, each by column with its stride.
struct Weights {
  const float *wl2, *wg, *wc;  // [HS][H], [4 HS][ldg], [HS][ldc]
  int ldg, ldc;
};

__device__ __forceinline__ Weights weights_of(const Chain& ch, const Rank& rk,
                                              const FwdSmem& sm) {
  const int H = ch.H, K1 = H + ch.E;
  if (sm.wg) return Weights{sm.wl2, sm.wg, sm.wc, 2 * H + 1, K1 + 1};
  return Weights{ch.wl2 + (size_t)rk.j0 * H, ch.wgT + (size_t)rk.j0 * 8 * H,
                 ch.wcT + (size_t)rk.j0 * K1, 2 * H, K1};
}

// The rank's biases, and its slices of the weights where they are
// resident, into shared memory (once a kernel): each column of the
// transposed copies is contiguous, so the copy is coalesced, into rows of
// K + 1 (the odd stride keeps a warp's column reads conflict-free).
__device__ void load_weights(const Chain& ch, const Rank& rk, const FwdSmem& sm) {
  const int H = ch.H, E = ch.E, hs = rk.hs, K1 = H + E;
  if (sm.wg) {
    for (int i = threadIdx.x; i < hs * H; i += NTF)
      sm.wl2[i] = __ldg(ch.wl2 + (size_t)rk.j0 * H + i);
    const float* wg = ch.wgT + (size_t)rk.j0 * 8 * H;
    for (int i = threadIdx.x; i < 8 * H * hs; i += NTF)  // column i / 2H, row k
      sm.wg[i / (2 * H) * (2 * H + 1) + i % (2 * H)] = __ldg(wg + i);
    const float* wc = ch.wcT + (size_t)rk.j0 * K1;
    for (int i = threadIdx.x; i < K1 * hs; i += NTF)
      sm.wc[i / K1 * (K1 + 1) + i % K1] = __ldg(wc + i);
  }
  for (int i = threadIdx.x; i < H; i += NTF) {
    sm.vec[i] = __ldg(ch.v + i);
    sm.vec[H + i] = __ldg(ch.bl2 + i);
  }
  for (int i = threadIdx.x; i < hs; i += NTF) sm.vec[2 * H + i] = __ldg(ch.bc + rk.j0 + i);
  for (int i = threadIdx.x; i < 4 * hs; i += NTF)
    sm.vec[2 * H + hs + i] = __ldg(ch.bl + (i & 3) * H + rk.j0 + (i >> 2));
}

// The rank's rows of video b's maskf, pre and enc, when they fit, into
// shared memory.
__device__ void load_tables(const Chain& ch, const Rank& rk, int b, const FwdSmem& sm) {
  if (!ch.tables) return;
  const int n = rk.t1 - rk.t0;
  const size_t row0 = (size_t)b * ch.Tz + rk.t0;
  for (int i = threadIdx.x; i < n; i += NTF) sm.mk[i] = __ldg(ch.maskf + row0 + i);
  for (int i = threadIdx.x; i < n * ch.H; i += NTF) sm.pre[i] = __ldg(ch.pre + row0 * ch.H + i);
  for (int i = threadIdx.x; i < n * ch.E; i += NTF) sm.enc[i] = __ldg(ch.enc + row0 * ch.E + i);
}

// The replay pass's next (s, b) item, prefetched by `cp.async` during this
// one: b < 0 for none (the forward).
struct Next {
  int b;              // its video
  const float* emb;   // [H] its e
  const float* h;     // [H] its h_in
  const float* c;     // [HS] its c_in, the rank's units
};

// Starts the copies of an item's inputs: maskf, pre and enc rows (when
// staged) into their regions, e into x1[:H], h_in into xe[:H] and c_in into
// xe[H:] (the caller moves those two once this thread's copies have landed).
__device__ void prefetch_item(const Chain& ch, const Rank& rk, const Next& nx, const FwdSmem& sm) {
  const int n = rk.t1 - rk.t0, H = ch.H, E = ch.E, tid = threadIdx.x;
  const size_t row0 = (size_t)nx.b * ch.Tz + rk.t0;
  if (ch.tables) {
    for (int i = tid; i < n; i += NTF) cp_async4(sm.mk + i, ch.maskf + row0 + i);
    for (int i = tid; i < n * H; i += NTF) cp_async4(sm.pre + i, ch.pre + row0 * H + i);
    for (int i = tid; i < n * E; i += NTF) cp_async4(sm.enc + i, ch.enc + row0 * E + i);
  }
  for (int j = tid; j < H; j += NTF) {
    cp_async4(sm.x1 + j, nx.emb + j);
    cp_async4(sm.xe + j, nx.h + j);
  }
  if (tid < rk.hs) cp_async4(sm.xe + H + tid, nx.c + tid);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// acc[c] += sum over k = k0 + lane, k0 + lane + 32, ... < k1 of x[k] wT[(col0 + c) ldk + k]
// for the C columns col0 .. col0 + C - 1 below ncol: a warp's lanes split k.
// U k-steps are unrolled together, their loads in flight at once (the sums
// keep their order): 4 at the model's shape, 8 at any other (where the
// weights may stream from L2).
template <int C, int U>
__device__ __forceinline__ void warp_gemv(float (&acc)[C], const float* x, const float* wT,
                                          int ldk, int col0, int ncol, int k0, int k1,
                                          int lane) {
  if (col0 >= ncol) return;
  if (col0 + C <= ncol) {  // a full block of columns: no guard
#pragma unroll U
    for (int k = k0 + lane; k < k1; k += 32) {
      const float xk = x[k];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(xk, wT[(col0 + c) * ldk + k], acc[c]);
    }
    return;
  }
  for (int k = k0 + lane; k < k1; k += 32) {
    const float xk = x[k];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col0 + c < ncol) acc[c] = fmaf(xk, wT[(col0 + c) * ldk + k], acc[c]);
  }
}

// The sums over the warp's 32 lanes of acc[0 .. C): lane l returns column
// ((l / (32 / C)) of them (a reduce-scatter by shuffles in a fixed order,
// then a butterfly over the 32 / C lanes that share a column).
template <int C>
__device__ __forceinline__ float warp_reduce_scatter(float (&acc)[C], int lane) {
#pragma unroll
  for (int o = 16, n = C; n > 1; o >>= 1, n >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? acc[i] : acc[i + n / 2];
      const float keep = up ? acc[i + n / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float v = acc[0];
#pragma unroll
  for (int o = 16 / C; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rank's partial q for the next step, qp[rank][n] = sum over its units
// jj of h[j0 + jj] Wl2[j0 + jj, n] (h_own: the units' h in shared memory),
// to every rank.  Not inlined: the forward's step and the replay pass's
// prologue run one compiled body, so both sum q alike.
__device__ __noinline__ void send_q_partials(const Chain ch, const Rank rk, const float* h_own) {
  extern __shared__ float smem[];
  const FwdSmem sm = carve(smem, ch);
  const int H = ch.H, hs = rk.hs;
  const float* wl2 = weights_of(ch, rk, sm).wl2;
  const uint32_t mb4 = smem_addr(sm.mbar) + 24, slot = smem_addr(sm.qp + rk.rank * H);
  for (int n = threadIdx.x; n < H; n += NTF) {
    const float q = dot_strided(h_own, wl2 + n, H, 0, hs, 1);
    for (int p = 0; p < ch.cl; ++p) st_async(peer_addr(slot + 4 * n, p), q, peer_addr(mb4, p));
  }
}

// One forward step of video b on its cluster (the exchanges' mbarriers at
// phase `ph`), from h = hb[par] (every unit), sm.c (the rank's units), the
// ranks' partials of q (sent by the previous step, or by the replay pass
// before it) and e = x1[:H] loaded by the caller.  Leaves the new cell in
// sm.c, (i, f, g, o, tanh c, h) in sm.act and cpre in sm.cp for the rank's
// units, relu(cpre) of every unit in sm.comb and h of every unit in
// hb[par ^ 1] of every CTA; with `tail_q`, sends the next step's partial q.
// With a_out / u_out (the replay pass) it also writes the rank's rows of a
// and u = tanh(pre + q); with nx.b >= 0, starts copying the replay's next
// item in.  The products that need no peer's data (cpre's e half, the
// gates' h half) run while an exchange is in flight, their sums held in
// registers.  Compiled for the model's shape (HT, ET, CLT = 128, 256, 8:
// every loop bound a constant) and for any other (0, 0, 0: read from ch);
// `step` picks one by the shape.  Not inlined: the forward kernel and the
// replay pass run one compiled body, so the replay's cpre and cell are the
// forward's bit for bit.
template <int HT, int ET, int CLT>
__device__ __noinline__ void cluster_step(const Chain ch, const Rank rk, int b, int par, int ph,
                                          bool tail_q, float* a_out, float* u_out,
                                          const Next nx) {
  extern __shared__ float smem[];
  const FwdSmem sm = carve(smem, ch);
  const int H = HT ? HT : ch.H, E = ET ? ET : ch.E, cl = CLT ? CLT : ch.cl;
  constexpr int U = HT ? 4 : 8;  // a GEMV's k-steps in flight (`warp_gemv`)
  int hs = rk.hs;  // the rank's units (the model's shape: H / CL, a constant)
  if constexpr (CLT > 0) hs = HT / CLT;
  const int j0 = rk.j0, K1 = H + E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t mb1 = smem_addr(sm.mbar), mb2 = mb1 + 8, mb3 = mb1 + 16, mb4 = mb1 + 24;
  if (tid == 32) {  // this step's bytes: every rank's (m_r, s_r, ctx_r), comb, h and q slices
    mbar_expect(mb1, 4u * cl * (E + 2));
    mbar_expect(mb2, 4u * H);
    mbar_expect(mb3, 4u * H);
    mbar_expect(mb4, 4u * cl * H);
  }
  const float* h = sm.hb + par * H;
  const float *v = sm.vec, *bl2 = sm.vec + H, *bc = sm.vec + 2 * H, *bl = bc + hs;
  // the rank's weights; the model's shape runs with them resident (`step`),
  // at strides the compiler knows
  const Weights W = weights_of(ch, rk, sm);
  const float *wc = HT ? sm.wc : W.wc, *wg = HT ? sm.wg : W.wg;
  const int ldc = HT ? K1 + 1 : W.ldc, ldg = HT ? 2 * H + 1 : W.ldg;

  // q = h Wl2 + bl2: the ranks' partials, in rank order
  mbar_wait(mb4, ph);
  for (int n = tid; n < H; n += NTF) {
    float q = sm.qp[n];
    for (int r = 1; r < cl; ++r) q += sm.qp[r * H + n];
    sm.q[n] = q + bl2[n];
  }
  __syncthreads();

  // the scores of the rank's frames: a warp a frame, four frames at once
  const int n = rk.t1 - rk.t0;
  const size_t row0 = (size_t)b * ch.Tz + rk.t0;
  const float* mk = sm.mk ? sm.mk : ch.maskf + row0;
  constexpr int NW = NTF / 32;
  auto scores = [&](const float* pre) {  // pre: the rank's rows, staged or in L2
    for (int i0 = warp; i0 < n; i0 += 4 * NW) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jc = 0; jc < H; jc += 128) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r * NW;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = jc + 32 * jj + lane;
            if (i < n && j < H) {
              const float u = tanhf(pre[(size_t)i * H + j] + sm.q[j]);
              if (u_out) u_out[(size_t)i * H + j] = u;
              acc[r] = fmaf(v[j], u, acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
      if (lane < 4 && i0 + lane * NW < n) {
        const int i = i0 + lane * NW;
        const float a = lane == 0 ? acc[0] : lane == 1 ? acc[1] : lane == 2 ? acc[2] : acc[3];
        sm.sc[i] = mk[i] > 0.f ? a : NEG;
      }
    }
  };
  if (sm.pre)
    scores(sm.pre);
  else
    scores(ch.pre + row0 * H);
  __syncthreads();
  if (warp == 0) {  // the rank's softmax partials (m_r = -inf, s_r = 0 without frames)
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sm.sc[i]);
    m = warp_max(m);
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float ex = expf(sm.sc[i] - m) * mk[i];
      sm.sc[i] = ex;
      s += ex;
    }
    s = warp_sum(s);
    if (lane == 0) {
      sm.ms[0] = m;
      sm.ms[1] = s;
    }
  }
  __syncthreads();

  // exchange 1: (m_r, s_r, ctx_r) to every rank's slot `rank`
  const int ps = E + 2;
  const uint32_t slot = smem_addr(sm.part + rk.rank * ps);
  auto ctx_partial = [&](const float* enc) {  // enc: the rank's rows, staged or in L2
    for (int e = tid; e < E; e += NTF) {
      const float acc = dot_strided(sm.sc, enc + e, E, 0, n, 1);
      for (int p = 0; p < cl; ++p)
        st_async(peer_addr(slot + 4 * (2 + e), p), acc, peer_addr(mb1, p));
    }
  };
  if (sm.enc)
    ctx_partial(sm.enc);
  else
    ctx_partial(ch.enc + row0 * E);
  if (tid < 2)
    for (int p = 0; p < cl; ++p) st_async(peer_addr(slot + 4 * tid, p), sm.ms[tid], peer_addr(mb1, p));
  // cpre = e Wc1 + ctx Wc2 + bc: pass p, warp w the columns 32 p + 4 w .. + 3;
  // the first pass's e half now
  float cacc[4] = {};
  warp_gemv<4, U>(cacc, sm.x1, wc, ldc, 4 * warp, hs, 0, H, lane);
  mbar_wait(mb1, ph);

  // ctx from the ranks' partials, in rank order; a rank with s_r = 0 weighs
  // 0.  Lane r of every warp holds rank r's (m_r, s_r) and weight w_r.
  {
    const bool has = lane < cl && sm.part[lane * ps + 1] > 0.f;
    const float m = warp_max(has ? sm.part[lane * ps] : -INFINITY);
    const float w_lane = has ? expf(sm.part[lane * ps] - m) : 0.f;
    const float s_lane = lane < cl ? sm.part[lane * ps + 1] : 0.f;
    float w[MAX_CL], tot = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CL; ++r) {
      w[r] = __shfl_sync(0xffffffffu, w_lane, r);
      if (r < cl) tot = fmaf(w[r], __shfl_sync(0xffffffffu, s_lane, r), tot);
    }
    for (int e = tid; e < E; e += NTF) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CL; ++r)
        if (r < cl) acc = fmaf(w[r], sm.part[r * ps + 2 + e], acc);
      sm.x1[H + e] = acc / tot;
    }
    if (a_out) {
      const float w_own = __shfl_sync(0xffffffffu, w_lane, rk.rank);
      for (int i = tid; i < n; i += NTF) a_out[i] = (sm.sc[i] * w_own) / tot;
    }
  }
  __syncthreads();  // pre, enc and maskf are read for the last time above
  // the replay's next item overwrites x1[:H] (e): now where the first cpre
  // pass took every column (HS <= 32), else after the passes that read it
  const bool late = hs > 4 * NW;
  if (nx.b >= 0 && !late) prefetch_item(ch, rk, nx, sm);

  // exchange 2: the ctx half of cpre; relu(cpre) to every rank.  A pass
  // after the first (HS above 32) takes both halves now, in the same order.
  auto cpre_pass = [&](float(&acc)[4], int col0) {
    warp_gemv<4, U>(acc, sm.x1, wc, ldc, col0, hs, H, K1, lane);
    const float cp = warp_reduce_scatter<4>(acc, lane);
    const int jj = col0 + (lane >> 3);
    if (!(lane & 7) && jj < hs) {
      const float c = cp + bc[jj];
      sm.cp[jj] = c;
      const float cb = fmaxf(c, 0.f);
      const uint32_t dst = smem_addr(sm.comb + j0 + jj);
      for (int p = 0; p < cl; ++p) st_async(peer_addr(dst, p), cb, peer_addr(mb2, p));
    }
  };
  cpre_pass(cacc, 4 * warp);
  for (int col0 = 4 * warp + 4 * NW; col0 < hs; col0 += 4 * NW) {
    float acc[4] = {};
    warp_gemv<4, U>(acc, sm.x1, wc, ldc, col0, hs, 0, H, lane);
    cpre_pass(acc, col0);
  }
  if (nx.b >= 0 && late) {
    __syncthreads();  // every pass has read e
    prefetch_item(ch, rk, nx, sm);
  }
  // gates = comb Wih + h Whh + bl: pass t, warp w the columns 64 t + 8 w .. + 7
  // (units 16 t + 2 w and 16 t + 2 w + 1, gates i, f, g, o each); the first
  // two passes' h half now
  const int ncol = 4 * hs;
  float gacc[2][8] = {};
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (64 * t < ncol) warp_gemv<8, U>(gacc[t], h - H, wg, ldg, 64 * t + 8 * warp, ncol, H, 2 * H,
                                    lane);
  mbar_wait(mb2, ph);

  // exchange 3: the comb half, the cell of the rank's units; h to every rank.
  // A pass after the second (HS above 32) takes both halves now, in the
  // same order.
  auto gate_pass = [&](float(&acc)[8], int t) {
    warp_gemv<8, U>(acc, sm.comb, wg, ldg, 64 * t + 8 * warp, ncol, 0, H, lane);
    const float g = warp_reduce_scatter<8>(acc, lane);  // column 64 t + 8 w + lane / 4
    const float gf = __shfl_down_sync(0xffffffffu, g, 4);
    const float gg = __shfl_down_sync(0xffffffffu, g, 8);
    const float go = __shfl_down_sync(0xffffffffu, g, 12);
    const int jj = 16 * t + 2 * warp + (lane >> 4);
    if (!(lane & 15) && jj < hs) {
      const float* bj = bl + 4 * jj;
      const float ig = sigmoidf(g + bj[0]), fg = sigmoidf(gf + bj[1]);
      const float gt = tanhf(gg + bj[2]), og = sigmoidf(go + bj[3]);
      const float c = cell(fg, sm.c[jj], ig, gt);
      const float tc = tanhf(c);
      const float hn = og * tc;
      sm.c[jj] = c;
      const float v6[6] = {ig, fg, gt, og, tc, hn};
#pragma unroll
      for (int qg = 0; qg < 6; ++qg) sm.act[qg * hs + jj] = v6[qg];
      const uint32_t dst = smem_addr(sm.hb + (par ^ 1) * H + j0 + jj);
      for (int p = 0; p < cl; ++p) st_async(peer_addr(dst, p), hn, peer_addr(mb3, p));
    }
  };
  gate_pass(gacc[0], 0);
  if (ncol > 64) gate_pass(gacc[1], 1);
  for (int t = 2; 64 * t < ncol; ++t) {
    float acc[8] = {};
    warp_gemv<8, U>(acc, h - H, wg, ldg, 64 * t + 8 * warp, ncol, H, 2 * H, lane);
    gate_pass(acc, t);
  }
  if (tail_q) {  // the next step's partial q, from the units' new h
    __syncthreads();
    send_q_partials(ch, rk, sm.act + 5 * hs);
  }
  mbar_wait(mb3, ph);
  __syncthreads();  // sm.act and sm.c for the caller
}

__device__ __forceinline__ void step(const Chain& ch, const Rank& rk, int b, int par, int ph,
                                     bool tail_q, float* a_out, float* u_out, const Next& nx) {
  if (ch.H == 128 && ch.E == 256 && ch.cl == 8 && ch.weights)
    cluster_step<128, 256, 8>(ch, rk, b, par, ph, tail_q, a_out, u_out, nx);
  else
    cluster_step<0, 0, 0>(ch, rk, b, par, ph, tail_q, a_out, u_out, nx);
}

// The four exchange mbarriers, initialised before any peer can send
// (the caller's cluster_sync follows).
__device__ __forceinline__ void init_exchanges(const FwdSmem& sm) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_addr(sm.mbar) + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// One cluster per video: grid (CL, B), cluster (CL, 1, 1).
__global__ void __launch_bounds__(NTF, 1) chain_fwd_kernel(
    Chain ch, const float* __restrict__ emb,  // [S, B, H]
    const float* __restrict__ h0,             // [B, H]
    const float* __restrict__ c0,             // [B, H]
    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ comb, int S, int B) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, H = ch.H, tid = threadIdx.x;
  const Rank rk = this_rank(ch);
  const FwdSmem sm = carve(smem, ch);
  load_weights(ch, rk, sm);
  load_tables(ch, rk, b, sm);
  for (int j = tid; j < H; j += NTF) sm.hb[j] = h0[(size_t)b * H + j];
  for (int j = tid; j < rk.hs; j += NTF) sm.c[j] = c0[(size_t)b * H + rk.j0 + j];
  for (int j = tid; j < H; j += NTF) sm.x1[j] = emb[(size_t)b * H + j];
  init_exchanges(sm);
  cluster::cluster_sync();  // every CTA has started, and armed nothing yet, before any peer sends
  send_q_partials(ch, rk, sm.hb + rk.j0);  // step 0's q, from h0
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)s * B + b) * H;
    if (s + 1 < S) {  // the next step's e, in flight during this step
      for (int j = tid; j < H; j += NTF) cp_async4(sm.xe + j, emb + o + (size_t)B * H + j);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    step(ch, rk, b, s & 1, s & 1, s + 1 < S, nullptr, nullptr,
         Next{-1, nullptr, nullptr, nullptr});
    for (int jj = tid; jj < rk.hs; jj += NTF) {
      const int j = rk.j0 + jj;
      hs[o + j] = sm.act[5 * rk.hs + jj];
      cs[o + j] = sm.c[jj];
      comb[o + j] = sm.comb[j];
    }
    if (s + 1 < S) {  // x1 is read before the step's second exchange
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      for (int j = tid; j < H; j += NTF) sm.x1[j] = sm.xe[j];  // this thread's own copies
    }
  }
}

// Pass 1 of the reverse chain: the forward step of every (s, b) from the
// stash (h_in[s] = hs[s-1], c_in[s] = cs[s-1]) through `cluster_step`, on
// clusters of the forward's shape; grid (CL, clusters), each cluster taking
// items s B + b in turn, the next item's inputs and rows of pre and enc
// copied in (`cp.async`) during the current one.
// Writes acts [5, S, B, H] = (i, f, g, o, tanh c_out), cpre [S, B, H], the
// attention weights a [S, B, Tzp] (0 past Tz) and u = tanh(pre + q)
// [S, B, Tz, H]; `cell_out` (debug, may be null) receives c_out [S, B, H].
__global__ void __launch_bounds__(NTF, 1) chain_replay_kernel(
    Chain ch, const float* __restrict__ emb,  // [S, B, H]
    const float* __restrict__ h_in,           // [S, B, H]
    const float* __restrict__ c_in,           // [S, B, H]
    float* __restrict__ acts, float* __restrict__ cpre, float* __restrict__ a_out,
    float* __restrict__ u_out, float* __restrict__ cell_out, int S, int B, int Tzp) {
  extern __shared__ float smem[];
  const int H = ch.H, Tz = ch.Tz, tid = threadIdx.x;
  const Rank rk = this_rank(ch);
  const int hs = rk.hs;
  const FwdSmem sm = carve(smem, ch);
  load_weights(ch, rk, sm);
  init_exchanges(sm);
  const int items = S * B, step_items = gridDim.y;
  auto next = [&](int item) {
    const size_t o = (size_t)item * H;
    return Next{item % B, emb + o, h_in + o, c_in + o + rk.j0};
  };
  if ((int)blockIdx.y < items) prefetch_item(ch, rk, next(blockIdx.y), sm);
  cluster::cluster_sync();  // every CTA has started before any peer sends
  const size_t plane = (size_t)S * B * H;
  int ph = 0;
  for (int item = blockIdx.y; item < items; item += step_items, ph ^= 1) {
    const size_t o = (size_t)item * H;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    for (int j = tid; j < H; j += NTF) sm.hb[j] = sm.xe[j];  // this thread's own copies
    if (tid < hs) sm.c[tid] = sm.xe[H + tid];
    __syncthreads();
    send_q_partials(ch, rk, sm.hb + rk.j0);  // the item's q, from h_in as the forward's
    float* ar = a_out + (size_t)item * Tzp;
    const int nxt = item + step_items;
    step(ch, rk, item % B, 0, ph, false, ar + rk.t0, u_out + ((size_t)item * Tz + rk.t0) * H,
         nxt < items ? next(nxt) : Next{-1, nullptr, nullptr, nullptr});
    auto store = [&](int jj) {
      const size_t j = o + rk.j0 + jj;
#pragma unroll
      for (int q = 0; q < 5; ++q) acts[q * plane + j] = sm.act[q * hs + jj];
      cpre[j] = sm.cp[jj];
      if (cell_out) cell_out[j] = sm.c[jj];
    };
    if (tid < hs) store(tid);
    if (rk.rank == ch.cl - 1)
      for (int t = Tz + tid; t < Tzp; t += NTF) ar[t] = 0.f;
  }
}

// the chain's shared memory, in floats (each region a multiple of 4)
struct BwdSmem {
  float *dg, *red, *dhp, *dcp, *dq, *rd, *K, *X1, *ds, *a, *u, *X2, *DH;
};

__host__ __device__ inline size_t bwd_carve(float* base, const BwdPlan& p, int H, int Tz,
                                            BwdSmem* sm) {
  const int Tzp = up4(Tz);
  const int sizes[13] = {p.nq * p.rq, p.nt, 2 * p.hs, p.hs, p.hs, 32, Tz * p.hs,
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
// step's factors are loaded a step ahead.  GW (the ragged split, NTW
// threads): the CTA's units are [r H / CL, (r + 1) H / CL), its dgate rows
// and Wl2's columns are read from L2 every step, u's columns copied 4 bytes
// at a time.
template <int RQ, int WL, bool GW = false>
__global__ void __launch_bounds__(GW ? NTW : NTB) chain_bwd_kernel(
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
  constexpr int NT = GW ? NTW : NTB;
  extern __shared__ float4 smb4[];
  const BwdPlan p{(int)gridDim.x, hs, nq, rq, NT, GW};
  BwdSmem sm;
  bwd_carve(reinterpret_cast<float*>(smb4), p, H, Tz, &sm);
  const int cl = p.cl, Tzp = up4(Tz), G = 4 * H;
  int rank = cluster::cluster_rank(), j0 = rank * hs;  // this CTA's units
  if constexpr (GW) cluster::units_of(rank, cl, H, j0, hs);  // (of a ragged split)
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // product role: dgate rows [k0, k0 + kn) of output column n
  const int ncol = 2 * hs;
  const int pc = tid % ncol, kq = tid / ncol;
  const int n = pc < hs ? j0 + pc : H + j0 + pc - hs;
  const int k0 = kq * rq;
  const int kn = kq < nq ? max(0, min(rq, G - k0)) : 0;
  const float* wrow = wg + (size_t)n * G + k0;      // (GW: read every step)
  const float* wlrow = wl2 + (size_t)tid * H + j0;  // (GW: read every step)
  float wr[GW ? 1 : RQ];
  if constexpr (!GW) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) wr[i] = i < kn ? wg[(size_t)n * G + k0 + i] : 0.f;
  }
  // unit role (tid < H): Wl2[tid, J] for the partial dq Wl2^T
  float wl[GW ? 1 : WL];
  if constexpr (!GW) {
#pragma unroll
    for (int i = 0; i < WL; ++i) wl[i] = (tid < H && i < hs) ? wl2[(size_t)tid * H + j0 + i] : 0.f;
  }
  const float v_own = tid < hs ? v[j0 + tid] : 0.f;

  // K[t][jj] = sum_e enc[b, t, e] Wc2[e, j0 + jj]
  const float* eb = enc + (size_t)b * Tz * E;
  for (int i = tid; i < Tz * hs; i += NT) {
    const int t = i / hs, jj = i - t * hs;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) acc = fmaf(eb[(size_t)t * E + e], wc2[(size_t)e * H + j0 + jj], acc);
    sm.K[i] = acc;
  }
  for (int i = tid; i < p.nq * rq; i += NT) sm.dg[i] = 0.f;  // rows past 4H stay 0
  for (int i = tid; i < cl * H; i += NT) sm.X2[i] = 0.f;
  for (int i = tid; i < H; i += NT) sm.DH[i] = 0.f;
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
      for (int i = tid; i < Tzp / 4; i += NT) cp_async16(sm.a + 4 * i, ar + 4 * i);
      const float* ur = u_in + ((size_t)s * B + b) * Tz * H + j0;
      if constexpr (GW) {  // j0 and hs need not be multiples of 4
        for (int i = tid; i < Tz * hs; i += NT) {
          const int t = i / hs, c = i - t * hs;
          cp_async4(sm.u + i, ur + (size_t)t * H + c);
        }
      } else {
        const int q4 = hs / 4;
        for (int i = tid; i < Tz * q4; i += NT) {
          const int t = i / q4, c = i - t * q4;
          cp_async16(sm.u + t * hs + 4 * c, ur + (size_t)t * H + 4 * c);
        }
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
      if constexpr (GW) {
        for (int i = 0; i < kn; i += 4) {  // kn is a multiple of 4
          const float4 d = *reinterpret_cast<const float4*>(dr + i);
          const float4 w = __ldg(reinterpret_cast<const float4*>(wrow + i));
          acc = fmaf(d.x, w.x, acc);
          acc = fmaf(d.y, w.y, acc);
          acc = fmaf(d.z, w.z, acc);
          acc = fmaf(d.w, w.w, acc);
        }
      } else {
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
    for (int t = tid; t < Tz; t += NT) {  // partial da over J, to every peer
      const float* kr = sm.K + t * hs;
      float acc = 0.f;
      for (int jj = 0; jj < hs; ++jj) acc = fmaf(sm.dcp[jj], kr[jj], acc);
      for (int r = 0; r < cl; ++r) cluster::cluster_peer(sm.X1, r)[rank * Tz + t] = acc;
    }
    cp_async_wait_all();
    cluster::cluster_sync();  // barrier 1: every partial da, and a and u, are here

    float ad = 0.f;
    for (int t = tid; t < Tz; t += NT) {
      float da = sm.X1[t];
      for (int r = 1; r < cl; ++r) da += sm.X1[r * Tz + t];
      sm.ds[t] = da;
      ad = fmaf(sm.a[t], da, ad);
    }
    ad = warp_sum(ad);
    if (lane == 0) sm.rd[warp] = ad;
    __syncthreads();
    ad = sm.rd[0];
    for (int w = 1; w < NT / 32; ++w) ad += sm.rd[w];
    const int tz0 = rank * ((Tz + cl - 1) / cl), tz1 = min(Tz, tz0 + (Tz + cl - 1) / cl);
    for (int t = tid; t < Tz; t += NT) {
      const float d = sm.a[t] * (sm.ds[t] - ad);
      sm.ds[t] = d;
      if (t >= tz0 && t < tz1) dsc_out[((size_t)s * B + b) * Tz + t] = d;
    }
    __syncthreads();
    {  // dq[jj] = v[j] sum_t dsc[t] (1 - u[t, j]^2): the t terms over NTB / hs groups
      const int ng = NT / hs, jj = tid % hs, gi = tid / hs;
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
      if constexpr (GW) {
        for (int i = 0; i < hs; ++i) acc = fmaf(sm.dq[i], __ldg(wlrow + i), acc);
      } else {
#pragma unroll
        for (int i = 0; i < WL; ++i)
          if (i < hs) acc = fmaf(sm.dq[i], wl[i], acc);
      }
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

int max_smem() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return n;
}

// The forward's (and the replay pass's) shared memory in bytes under
// `limit`, and what it keeps there: the rank's weights where they fit, then
// its rows of maskf, pre and enc where they fit too.  Where nothing fits,
// the least it needs (above the limit).
struct FwdLayout {
  size_t bytes;
  bool weights, tables;
};

FwdLayout fwd_smem(const FwdPlan& p, int H, int E, int Tz, size_t limit) {
  FwdSmem sm;
  FwdLayout l{};
  for (int i = 0; i < 4; ++i) {
    l.weights = i < 2;
    l.tables = !(i & 1);
    l.bytes = fwd_carve(nullptr, p.cl, p.hs, H, E, Tz, l.weights, l.tables, &sm) * sizeof(float);
    if (l.bytes <= limit) break;
  }
  return l;
}

size_t chain_smem(const BwdPlan& p, int H, int Tz) {
  BwdSmem sm;
  return bwd_carve(nullptr, p, H, Tz, &sm) * sizeof(float);
}

cudaError_t check_smem(size_t smem) {
  const int n = max_smem();
  if (n == 0) return cudaErrorInvalidDevice;
  return smem > (size_t)n ? cudaErrorInvalidValue : cudaSuccess;
}

bool bad_shape(int S, int B, int Tz, int H, int E, FwdPlan& p) {
  return S < 1 || B < 1 || Tz < 1 || H < 1 || E < 1 || !fwd_plan(H, p);
}

// The forward's (or the replay pass's) operands and shared memory for one
// launch, or an error.
cudaError_t fwd_setup(const float* enc, const float* pre, const float* maskf, const float* wl2,
                      const float* bl2, const float* v, const float* wcT, const float* bc,
                      const float* wgT, const float* bl, int Tz, int H, int E, FwdPlan& p,
                      Chain& ch, size_t& smem) {
  const FwdLayout l = fwd_smem(p, H, E, Tz, (size_t)max_smem());
  smem = l.bytes;
  ch = Chain{enc, pre, maskf, wl2, bl2, v, wcT, bc, wgT, bl, Tz, H, E, p.cl, p.hs, l.weights,
             l.tables};
  return check_smem(smem);
}

}  // namespace

// Bytes of shared memory a block of the forward kernel (reverse = 0) or of
// the larger of the reverse chain's two passes (reverse = 1) needs on this
// card (the forward keeps its weights and its frames' rows of maskf, pre and
// enc in it where they fit); -1 where a kernel refuses H.  The wrapper
// checks it against the card's limit before it launches.
extern "C" int mucon_decoder_chain_smem(int H, int E, int Tz, int reverse) {
  FwdPlan fp;
  if (!fwd_plan(H, fp)) return -1;
  const size_t fwd = fwd_smem(fp, H, E, Tz, (size_t)max_smem()).bytes;
  if (!reverse) return (int)fwd;
  BwdPlan p;
  if (!bwd_plan(H, p)) return -1;
  const size_t chain = chain_smem(p, H, Tz);
  return (int)(fwd > chain ? fwd : chain);
}

// The widest H of each direction's cluster route at B videos, at a Tz its
// shared memory holds; above it the persistent kernels, which sum in the
// same orders (the same bits), take it.  Timed in turns on an H100 with
// each route forced (`scripts/probe_decoder_persistent.py`, Tz = 160, E =
// 2H, S = 31) at H = 256, 384 and 512 and B = 1, 8, 32 and 128; a B in
// between takes the band of the measured B nearest by ratio.  The forward
// with its replay pass: the lines cross near H = 335 at B = 1, 430 at 8,
// 384 at 32, and at 512 at 128 (there the forward alone is faster on the
// clusters).  The reverse chain: faster on the persistent kernel from H =
// 256 up at B <= 32 (a tie at 8); at 128 on the clusters at 256 and
// persistent at 384, crossing near 296.  Above 512 both directions run
// the persistent kernels at every B (unmeasured on the clusters at B > 8).
struct Crossing {
  int b, fwd, bwd;  // up to b videos: the widest cluster H of each direction
};
constexpr Crossing CROSSINGS[] = {{2, 335, 256}, {16, 432, 256}, {64, 384, 256},
                                  {1 << 30, 512, 296}};

// Which kernels take the chain at (B, H, E, Tz), decided before the launch
// from the shape alone: out[0] = 1 where the forward and the replay pass
// run the persistent kernel (csrc/decoder_persistent.cu): H above B's
// CROSSINGS fwd, or the cluster forward's rows of maskf, pre and enc (or
// its whole layout) past this card's shared memory; out[1] = 1 where the
// reverse chain does: H above B's CROSSINGS bwd, or the cluster chain's
// [Tz x HS] tables past shared memory.  0: the cluster kernels.
extern "C" int mucon_decoder_chain_route(int B, int H, int E, int Tz, int* out) {
  FwdPlan fp;
  BwdPlan bp;
  if (B < 1 || Tz < 1 || E < 1 || !fwd_plan(H, fp) || !bwd_plan(H, bp))
    return cudaErrorInvalidValue;
  const size_t limit = (size_t)max_smem();
  if (!limit) return cudaErrorInvalidDevice;
  const FwdLayout l = fwd_smem(fp, H, E, Tz, limit);
  const Crossing* c = CROSSINGS;
  while (B > c->b) ++c;
  out[0] = H > c->fwd || !l.tables || l.bytes > limit;
  out[1] = H > c->bwd || chain_smem(bp, H, Tz) > limit;
  return cudaSuccess;
}

// The cluster width the reverse chain takes for a hidden size H (0: refused).
extern "C" int mucon_decoder_chain_width(int H) {
  BwdPlan p;
  return bwd_plan(H, p) ? p.cl : 0;
}

// The forward's launch for (B, H, E, Tz): out = {CL, HS, threads, clusters
// (one a video), clusters the card holds at once, the rank's weights in
// shared memory (1) or read from L2 (0), its rows of maskf / pre / enc the
// same}.
extern "C" int mucon_decoder_chain_fwd_launch(int B, int H, int E, int Tz, int* out) {
  FwdPlan p;
  if (bad_shape(1, B, Tz, H, E, p)) return cudaErrorInvalidValue;
  Chain ch;
  size_t smem = 0;
  cudaError_t err = fwd_setup(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, Tz, H, E, p, ch, smem);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cluster::max_active_clusters(chain_fwd_kernel, dim3(p.cl, B), dim3(NTF), p.cl, smem,
                                     &active);
  if (err != cudaSuccess) return err;
  const int v[7] = {p.cl, p.hs, NTF, B, active, ch.weights, ch.tables};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}

extern "C" int mucon_decoder_chain_fwd(const float* emb, const float* enc, const float* pre,
                                       const float* maskf, const float* h0, const float* c0,
                                       const float* wl2, const float* bl2, const float* v,
                                       const float* wcT, const float* bc, const float* wgT,
                                       const float* bl, float* hs, float* cs, float* comb,
                                       int S, int B, int Tz, int H, int E,
                                       cudaStream_t stream) {
  FwdPlan p;
  if (bad_shape(S, B, Tz, H, E, p)) return cudaErrorInvalidValue;
  Chain ch;
  size_t smem = 0;
  const cudaError_t err =
      fwd_setup(enc, pre, maskf, wl2, bl2, v, wcT, bc, wgT, bl, Tz, H, E, p, ch, smem);
  if (err != cudaSuccess) return err;
  return cluster::launch_cluster(chain_fwd_kernel, dim3(p.cl, B), dim3(NTF), p.cl, smem, stream,
                                 ch, emb, h0, c0, hs, cs, comb, S, B);
}

// Pass 1 of the reverse chain: every step replayed (see
// `chain_replay_kernel`) on as many clusters as the card holds at once;
// `cell` may be null.
extern "C" int mucon_decoder_chain_replay(const float* emb, const float* enc, const float* pre,
                                          const float* maskf, const float* h_in,
                                          const float* c_in, const float* wl2,
                                          const float* bl2, const float* v, const float* wcT,
                                          const float* bc, const float* wgT, const float* bl,
                                          float* acts, float* cpre, float* a, float* u,
                                          float* cell, int S, int B, int Tz, int H, int E,
                                          cudaStream_t stream) {
  FwdPlan p;
  if (bad_shape(S, B, Tz, H, E, p)) return cudaErrorInvalidValue;
  Chain ch;
  size_t smem = 0;
  cudaError_t err =
      fwd_setup(enc, pre, maskf, wl2, bl2, v, wcT, bc, wgT, bl, Tz, H, E, p, ch, smem);
  if (err != cudaSuccess) return err;
  int active = 0;
  err = cluster::max_active_clusters(chain_replay_kernel, dim3(p.cl, S * B), dim3(NTF), p.cl,
                                     smem, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  const int clusters = S * B < active ? S * B : active;
  return cluster::launch_cluster(chain_replay_kernel, dim3(p.cl, clusters), dim3(NTF), p.cl,
                                 smem, stream, ch, emb, h_in, c_in, acts, cpre, a, u, cell, S,
                                 B, up4(Tz));
}

// Pass 2: the sequential chain on one cluster per video (see
// `chain_bwd_kernel`) -> dgate, dcpre, dsc, dh0, dc0.  Refuses (H, Tz) where
// its tables pass shared memory, or H above MAX_H: the persistent reverse
// chain takes those (`mucon_decoder_chain_route`).
extern "C" int mucon_decoder_chain_bwd(const float* acts, const float* cpre, const float* a,
                                       const float* u, const float* c_in, const float* enc,
                                       const float* v, const float* wc2, const float* wg,
                                       const float* wl2, const float* dh_ext,
                                       const float* dc_ext, const float* dcomb_ext,
                                       float* dgate, float* dcpre, float* dsc, float* dh0,
                                       float* dc0, int S, int B, int Tz, int H, int E,
                                       cudaStream_t stream) {
  BwdPlan p;
  FwdPlan fp;
  if (bad_shape(S, B, Tz, H, E, fp) || !bwd_plan(H, p) || H > MAX_H)
    return cudaErrorInvalidValue;
  const size_t smem = chain_smem(p, H, Tz);
  const cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  auto kernel = p.gw ? chain_bwd_kernel<4, 1, true>
                     : (p.rq <= 16 ? chain_bwd_kernel<16, 32> : chain_bwd_kernel<64, 32>);
  return cluster::launch_cluster(kernel, dim3(p.cl, B), dim3(p.nt), p.cl, smem, stream, acts,
                                 cpre, a, u, c_in, enc, v, wc2, wg, wl2, dh_ext, dc_ext,
                                 dcomb_ext, dgate, dcpre, dsc, dh0, dc0, S, B, Tz, H, E, p.hs,
                                 p.nq, p.rq);
}
