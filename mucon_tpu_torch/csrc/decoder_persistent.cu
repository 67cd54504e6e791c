// The teacher-forced decoder chain at wide H and long Tz as card-wide
// persistent kernels, for NVIDIA Hopper (sm_90a).
//
// Replaces, at those shapes, the cluster kernels of csrc/decoder_chain.cu
// (the port of `_chain_fwd_kernel`, mucon_tpu/ops/decoder_pallas.py:93,
// called at :236, and `_chain_bwd_kernel`, :139, called at :298).  Those run
// one cluster of 8 CTAs a video: at B = 1 or 2 they leave 116-124 of the
// card's 132 SMs idle, and above H = 512 each cluster reads its video's
// share of the weights ([Wih; Whh], [Wc1; Wc2], Wl2: 67 MB at H = 1181, E =
// 2H) from L2 or HBM every step, B times a step for B videos.  Here one
// cooperative launch holds one CTA an SM for the whole chain, and each
// weight is read once a step for all videos, from the CTA's shared memory
// where it is resident.
//
// Forward (`chain_persistent_fwd_kernel`).  CTA r of P owns the units
// units_of(r, P, H) of every item (video): their rows of q = h Wl2 + bl2
// (Wl2's columns), of cpre = [e; ctx] [Wc1; Wc2] + bc and their four gate
// columns of [comb; h] [Wih; Whh] + bl, each column resident in its shared
// memory as far as that holds (the rest read from L2 every step, once for
// a tile of up to 8 items).  A step is six phases, each ended by a grid
// barrier (a release add and an acquire spin on one counter, as in the
// BiLSTM's persistent kernel): the scores of blocks of an item's frames;
// each (item, rank) pair's softmax partials (m_r, s_r, ctx_r), rank r the
// frames [r Tz / CL, (r + 1) Tz / CL) of the cluster kernel's CL ranks, in
// chunks of channels; ctx from the ranks' partials in rank order; cpre and
// relu(cpre); the gates, the cell and h; then the next step's q.  The
// blocks, pairs and chunks are dealt round-robin over the CTAs.
// Everything a phase hands on goes through device memory (scratch the
// wrapper allocates), written with plain stores and read through L2
// (`ld.global.cg`: the L1 is not coherent), several loads a thread in
// flight.  Each sum is the cluster kernel's: the GEMVs split k over a
// warp's lanes (lane l adds k = l, l + 32, ... in order, the h half of the
// gates before the comb half) and add the lanes by the butterfly its
// reduce-scatter makes; q and the softmax add their ranks' partials in rank
// order, each partial in the cluster kernel's chains.  So the outputs are
// the cluster kernel's bit for bit, and `chain_replay_kernel` of a
// forward here (or this kernel's replay of a cluster forward) replays the
// stashed cell and cpre exactly.
//
// The replay pass is the same kernel on S B items of one step each (item
// s B + b from h_in[s], c_in[s], e[s] and video b's tables): it writes the
// gate activations and tanh c, cpre, the attention weights a and u = tanh(pre
// + q) instead of the trajectory.
//
// Reverse (`chain_persistent_bwd_kernel`), s = S-1 .. 0, in the sum orders
// of the reverse plan (`bwd_plan`: CL ranks of units, NQ groups of RQ dgate
// rows, 512 threads' partials of <a, da>), CTA r owning units
// units_of(r, P, H) of every video: its 2 U rows of [Wih; Whh] (dcomb and
// dh parts) and U rows of Wl2 resident as far as shared memory holds them.
// K = enc Wc2 [B, Tz, H] is computed once (a tiled product, each element one
// chain over e in order).  Four phases a step, each ended by a grid barrier:
// the owners' dh (dh's part of the last step plus dq Wl2^T by ranks), dc and
// dgate; the owners' dcomb and dh parts of dgate [Wih; Whh]^T (its dcpre);
// da = K dcpre by ranks for the (video, frame) pairs, in even ranges over
// the CTAs; <a, da>, dsc and the owners' dq, videos in tiles.
//
// Bound on this card: the weights once a step (bytes) and the grid
// barriers' latency; the products are GEMVs of B items.  Accurate expf /
// tanhf (no --use_fast_math); no atomics in a sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "decoder_chain.cuh"

namespace dchain {
namespace {

constexpr int NTP = 512;               // threads a CTA
constexpr int NWP = NTP / 32;          // warps a CTA
constexpr int SMEM_FLOATS = 232448 / 4;  // the shared memory a block may take (H100, opt-in)
constexpr int GC = 2;                  // columns of a GEMV task (a warp)
constexpr int GV = 8;                  // items of a GEMV task
constexpr int XBUDGET = 20480;         // floats of a tile's staged inputs (80 KiB)
constexpr int KT = 64, KE = 32;        // K = enc Wc2: tiles of KT x KT, KE of e at a time
constexpr int KTILE = KT * (KE + 1) + KE * KT;

__host__ __device__ inline int odd(int n) { return n | 1; }
inline long lmin(long a, long b) { return a < b ? a : b; }
inline int imax(int a, int b) { return a > b ? a : b; }
inline int imin(int a, int b) { return a < b ? a : b; }

// The grid's barrier: every CTA's writes before it are visible to every CTA
// after it (the release is cumulative over what the CTA's bar.sync showed
// thread 0); traps rather than hang.
__device__ __forceinline__ void grid_barrier(unsigned* cnt, unsigned target) {
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

// ---------------------------------------------------------------------------
// Forward.

// A forward launch: P CTAs of at most U units; CL the cluster kernel's ranks
// (`fwd_plan`); tiles of BV items staged [BV][LDX] for the GEMVs; resident
// columns RQ of Wl2 (rows LDQ), RC of [Wc1; Wc2] (LDC), RG gate columns of
// [Wih; Whh] (LDG); ROWS the most frames of a rank; RED the GEMVs' sums;
// PCH the channels of a pair's chunk in the softmax partials (PC: four
// threads a channel, where the pairs' chunks of PC channels are few for the
// card, as at long Tz; else NTP, one).
struct PFPlan {
  int P, U, vcl, bv, ldx, ldq, ldc, ldg, rq, rc, rg, rows, red, pch, smem;
};

constexpr int FB = 2 * NWP;  // frames of a block of the scores
constexpr int PC = NTP / 4;  // channels of a pair's chunk split four ways

bool pf_plan(int NI, int H, int E, int Tz, int ctas, PFPlan& p) {
  FwdPlan fp;
  if (NI < 1 || Tz < 1 || E < 1 || ctas < 1 || !fwd_plan(H, fp)) return false;
  p.P = ctas;
  p.U = (H + ctas - 1) / ctas;
  p.vcl = fp.cl;
  p.ldx = up4(H + (E > H ? E : H));
  p.bv = NI < GV ? NI : GV;
  while (p.bv > 1 && p.bv * p.ldx > XBUDGET) --p.bv;
  const int tiles = (NI + p.bv - 1) / p.bv;
  p.bv = (NI + tiles - 1) / tiles;  // tiles of even size
  p.rows = (Tz + p.vcl - 1) / p.vcl;
  p.pch = (long)NI * p.vcl * ((E + PC - 1) / PC) <= 2L * ctas ? PC : NTP;
  p.red = up4(imax(imax(p.bv * 4 * p.U, p.bv * p.U * p.vcl), NTP));
  p.ldq = odd(H);
  p.ldc = odd(H + E);
  p.ldg = odd(2 * H);
  const long fixed = up4(p.bv * p.ldx) + p.red + 2 * up4(H) + up4(p.rows) + 4;
  long left = SMEM_FLOATS - fixed;
  if (left < 0) return false;
  auto take = [&](int want, int ld) {
    const int n = (int)lmin(want, left / ld);
    left -= (long)n * ld;
    return n;
  };
  p.rq = take(p.U, p.ldq);
  p.rc = take(p.U, p.ldc);
  p.rg = take(4 * p.U, p.ldg);
  p.smem = (int)(4 * (SMEM_FLOATS - left));
  return true;
}

struct PFArgs {
  PersistFwdIO io;
  unsigned* cnt;  // the barrier's counter, 0 at launch
  float *Xh;      // [2][NI][H] h by step parity
  float *Xq;      // [NI][H]
  float *Xsc;     // [NI][Tz] the scores
  float *Xpart;   // [NI][CL][E + 2] each rank's (m_r, s_r, ctx_r)
  float *Xex;     // [NI][Tz] exp(sc - m_r) maskf (the replay's a), or null
  float *Xctx;    // [NI][E]
  float *Xcomb;   // [NI][H] relu(cpre)
  float *Xc;      // [NI][H] the cell (its owners only)
  PFPlan p;
};

long fwd_scratch(const PFPlan& p, int NI, int H, int E, int Tz, bool replay) {
  return 4 + (long)up4(2 * NI * H) + up4(NI * H) + up4(NI * Tz) + up4(NI * p.vcl * (E + 2)) +
         (replay ? up4(NI * Tz) : 0) + up4(NI * E) + 2L * up4(NI * H);
}

void fwd_carve(PFArgs& a, float* scratch, bool replay) {
  const PersistFwdIO& io = a.io;
  float* s = scratch + 4;
  auto take = [&](long n) {
    float* r = s;
    s += up4((int)n);
    return r;
  };
  a.cnt = reinterpret_cast<unsigned*>(scratch);
  a.Xh = take(2L * io.NI * io.H);
  a.Xq = take((long)io.NI * io.H);
  a.Xsc = take((long)io.NI * io.Tz);
  a.Xpart = take((long)io.NI * a.p.vcl * (io.E + 2));
  a.Xex = replay ? take((long)io.NI * io.Tz) : nullptr;
  a.Xctx = take((long)io.NI * io.E);
  a.Xcomb = take((long)io.NI * io.H);
  a.Xc = take((long)io.NI * io.H);
}

// *dst(e) = *src(e) for e < n over the CTA's threads, through L2 only
// (`ld.global.cg`: the exchange rows other CTAs wrote), SU loads a thread in
// flight before their stores
template <class Src, class Dst>
__device__ __forceinline__ void stage_in(int n, Src src, Dst dst) {
  constexpr int SU = 8;
  int e = threadIdx.x;
  for (; e + (SU - 1) * NTP < n; e += SU * NTP) {
    float r[SU];
#pragma unroll
    for (int i = 0; i < SU; ++i) r[i] = __ldcg(src(e + i * NTP));
#pragma unroll
    for (int i = 0; i < SU; ++i) *dst(e + i * NTP) = r[i];
  }
  for (; e < n; e += NTP) *dst(e) = __ldcg(src(e));
}

// acc[c][v] += sum over k = k0 + lane, k0 + lane + 32, ... < k1 of
// x[v][k] w[c][k]: a warp's lanes split k, each lane's chain in k order.
// The weights of KD k-steps are loaded before their products, so that a
// lane keeps C KD loads in flight where they stream from L2.
template <int C, int V>
__device__ __forceinline__ void lane_chain(float (&acc)[C][V], const float* const (&w)[C],
                                           const float* x, int ldx, int nv, int k0, int k1,
                                           int lane) {
  constexpr int KD = 8;
  int k = k0 + lane;
  for (; k + 32 * (KD - 1) < k1; k += 32 * KD) {
    float wk[KD][C];
#pragma unroll
    for (int d = 0; d < KD; ++d)
#pragma unroll
      for (int c = 0; c < C; ++c) wk[d][c] = w[c][k + 32 * d];
#pragma unroll
    for (int d = 0; d < KD; ++d)
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < nv) {
          const float xv = x[v * ldx + k + 32 * d];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c][v] = fmaf(xv, wk[d][c], acc[c][v]);
        }
  }
  for (; k < k1; k += 32) {
    float wk[C];
#pragma unroll
    for (int c = 0; c < C; ++c) wk[c] = w[c][k];
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) {
        const float xv = x[v * ldx + k];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c][v] = fmaf(xv, wk[c], acc[c][v]);
      }
  }
}

// The GEMV of a tile: out[v][c] = sum over k of x[v][k] w_c[k] for the ncol
// columns (col(c) points at column c, k contiguous) and nv staged items,
// each lane's chain over [k0, k1) then [k2, k3), the lanes added by the
// butterfly.  Tasks of GC columns x GV items over the warps, the columns
// outermost (warps at once share columns: streamed weights hit L1).
template <class Col>
__device__ __forceinline__ void tile_gemv(int ncol, Col col, int k0, int k1, int k2, int k3,
                                          const float* xs, int ldx, int nv, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncg = (ncol + GC - 1) / GC, nig = (nv + GV - 1) / GV;
  for (int t = warp; t < ncg * nig; t += NWP) {
    const int cg = t / nig, ig = t - cg * nig, c0 = cg * GC, v0 = ig * GV;
    const int nvv = min(GV, nv - v0);
    const float* w[GC];
#pragma unroll
    for (int c = 0; c < GC; ++c) w[c] = col(min(c0 + c, ncol - 1));
    float acc[GC][GV];
#pragma unroll
    for (int c = 0; c < GC; ++c)
#pragma unroll
      for (int v = 0; v < GV; ++v) acc[c][v] = 0.f;
    const float* x = xs + (size_t)v0 * ldx;
    lane_chain<GC, GV>(acc, w, x, ldx, nvv, k0, k1, lane);
    if (k2 < k3) lane_chain<GC, GV>(acc, w, x, ldx, nvv, k2, k3, lane);
#pragma unroll
    for (int c = 0; c < GC; ++c)
#pragma unroll
      for (int v = 0; v < GV; ++v) {
        const float s = warp_sum(acc[c][v]);
        if (lane == 0 && c0 + c < ncol && v < nvv) out[(v0 + v) * ncol + c0 + c] = s;
      }
  }
}

// grid P, NTP threads, cooperative launch only: every CTA must be resident,
// or the grid barrier never opens.
__global__ void __launch_bounds__(NTP, 1) chain_persistent_fwd_kernel(const PFArgs a) {
  extern __shared__ float4 smf4[];
  float* const sm = reinterpret_cast<float*>(smf4);
  const PersistFwdIO& io = a.io;
  const PFPlan& p = a.p;
  const int H = io.H, E = io.E, K1 = H + E, NI = io.NI, Tz = io.Tz, P = p.P, vcl = p.vcl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int j0, u;
  cluster::units_of(blockIdx.x, P, H, j0, u);
  float* const xs = sm;                       // [BV][LDX] a tile's inputs
  float* const red = xs + up4(p.bv * p.ldx);  // the GEMVs' sums, q's partials
  float* const qv = red + p.red;              // [H] an item's q
  float* const vv = qv + up4(H);              // [H] v
  float* const sc = vv + up4(H);              // [ROWS] a rank's scores, then exp
  float* const ms = sc + up4(p.rows);         // (m_r, s_r)
  float* const wq = ms + 4;                   // [RQ][LDQ] Wl2's columns
  float* const wc = wq + p.rq * p.ldq;        // [RC][LDC] [Wc1; Wc2]'s columns
  float* const wg = wc + p.rc * p.ldc;        // [RG][LDG] gate columns (4 jj + q)
  const int rq = min(p.rq, u), rc = min(p.rc, u), rg = min(p.rg, 4 * u);
  for (int i = tid; i < rq * H; i += NTP) {
    const int c = i / H, k = i - c * H;
    wq[c * p.ldq + k] = __ldg(io.wl2T + (size_t)(j0 + c) * H + k);
  }
  for (int i = tid; i < rc * K1; i += NTP) {
    const int c = i / K1, k = i - c * K1;
    wc[c * p.ldc + k] = __ldg(io.wcT + (size_t)(j0 + c) * K1 + k);
  }
  for (int i = tid; i < rg * 2 * H; i += NTP) {
    const int c = i / (2 * H), k = i - c * 2 * H;
    wg[c * p.ldg + k] = __ldg(io.wgT + (size_t)(4 * j0 + c) * 2 * H + k);
  }
  for (int j = tid; j < H; j += NTP) vv[j] = __ldg(io.v + j);
  __syncthreads();
  auto qcol = [&](int c) -> const float* {
    return c < rq ? wq + c * p.ldq : io.wl2T + (size_t)(j0 + c) * H;
  };
  auto ccol = [&](int c) -> const float* {
    return c < rc ? wc + c * p.ldc : io.wcT + (size_t)(j0 + c) * K1;
  };
  auto gcol = [&](int c) -> const float* {
    return c < rg ? wg + c * p.ldg : io.wgT + (size_t)(4 * j0 + c) * 2 * H;
  };
  unsigned bar = 0;
  auto sync_grid = [&]() { grid_barrier(a.cnt, ++bar * P); };
  const size_t plane = (size_t)NI * H;

  // q of the CTA's columns for every item from h [NI][H]: per rank, the
  // cluster kernel's partial over its units (`send_q_partials`), added in
  // rank order
  auto phase_q = [&](const float* hsrc) {
    for (int i0 = 0; i0 < NI; i0 += p.bv) {
      const int nv = min(p.bv, NI - i0);
      stage_in(nv * H, [&](int e) { return hsrc + (size_t)i0 * H + e; },
               [&](int e) { return xs + e / H * p.ldx + e % H; });
      __syncthreads();
      for (int e = tid; e < nv * u * vcl; e += NTP) {
        const int jj = e % u, r = (e / u) % vcl, v = e / (u * vcl);
        int rj0, rhs;
        cluster::units_of(r, vcl, H, rj0, rhs);
        red[(v * u + jj) * vcl + r] = dot_strided(xs + v * p.ldx + rj0, qcol(jj) + rj0, 1, 0,
                                                  rhs, 1);
      }
      __syncthreads();
      for (int e = tid; e < nv * u; e += NTP) {
        const int v = e / u, jj = e - v * u;
        const float* rp = red + e * vcl;
        float q = rp[0];
        for (int r = 1; r < vcl; ++r) q += rp[r];
        a.Xq[(size_t)(i0 + v) * H + j0 + jj] = q + __ldg(io.bl2 + j0 + jj);
      }
      __syncthreads();
    }
  };

  // the scores of an item's block of FB frames, two a warp at once, each
  // frame's sum as the cluster kernel's (a warp's lanes split H, then the
  // butterfly); the replay also writes u = tanh(pre + q)
  auto phase_s = [&]() {
    const int nfb = (Tz + FB - 1) / FB;
    for (int w = blockIdx.x; w < NI * nfb; w += P) {
      const int i = w / nfb, f0 = (w - i * nfb) * FB, f1 = min(Tz, f0 + FB), b = i % io.B;
      __syncthreads();  // the last block's q is read
      stage_in(H, [&](int e) { return a.Xq + (size_t)i * H + e; }, [&](int e) { return qv + e; });
      __syncthreads();
      // JD k-steps of both frames' pre rows loaded before their products
      constexpr int JD = 8;
      float acc[2] = {0.f, 0.f};
      auto score = [&](int r2, int j, float pre_j) {
        const int f = f0 + warp + r2 * NWP;
        const float uu = tanhf(pre_j + qv[j]);
        if (io.u) io.u[((size_t)i * Tz + f) * H + j] = uu;
        acc[r2] = fmaf(vv[j], uu, acc[r2]);
      };
      const float* pr[2];
      bool ok[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int f = f0 + warp + r2 * NWP;
        ok[r2] = f < f1;
        pr[r2] = io.pre + ((size_t)b * Tz + (ok[r2] ? f : f0)) * H;
      }
      int j = lane;
      for (; j + 32 * (JD - 1) < H; j += 32 * JD) {
        float pj[2][JD];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
          for (int d = 0; d < JD; ++d) pj[r2][d] = ok[r2] ? __ldg(pr[r2] + j + 32 * d) : 0.f;
#pragma unroll
        for (int d = 0; d < JD; ++d)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
            if (ok[r2]) score(r2, j + 32 * d, pj[r2][d]);
      }
      for (; j < H; j += 32)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
          if (ok[r2]) score(r2, j, __ldg(pr[r2] + j));
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float sum = warp_sum(acc[r2]);
        const int f = f0 + warp + r2 * NWP;
        if (lane == 0 && f < f1)
          a.Xsc[(size_t)i * Tz + f] = __ldg(io.maskf + (size_t)b * Tz + f) > 0.f ? sum : NEG;
      }
    }
  };

  // the (item, rank) pairs' softmax partials (m_r, s_r) and ctx_r, rank r
  // the frames [r Tz / CL, (r + 1) Tz / CL) (`cluster_step`'s first
  // exchange), in chunks of channels dealt over the CTAs: `dot_strided`'s
  // four chains of channel e in one thread, or (split4) in four, thread
  // (e, c) the c-th (the tail in the first), added as it adds them; the
  // replay also keeps each frame's exp(sc - m_r) maskf
  const bool split4 = p.pch == PC;
  auto phase_p = [&]() {
    const int nch = (E + p.pch - 1) / p.pch;
    for (int w = blockIdx.x; w < NI * vcl * nch; w += P) {
      const int ir = w / nch, ch = w - ir * nch, i = ir / vcl, r = ir - i * vcl;
      const int t0 = r * Tz / vcl, n = (r + 1) * Tz / vcl - t0;
      const size_t row0 = (size_t)(i % io.B) * Tz + t0;
      __syncthreads();  // the last pair's exp and partials are read
      stage_in(n, [&](int f) { return a.Xsc + (size_t)i * Tz + t0 + f; },
               [&](int f) { return sc + f; });
      __syncthreads();
      if (warp == 0) {  // m_r = -inf, s_r = 0 without frames
        float m = -INFINITY;
        for (int f = lane; f < n; f += 32) m = fmaxf(m, sc[f]);
        m = warp_max(m);
        float sum = 0.f;
        for (int f = lane; f < n; f += 32) {
          const float ex = expf(sc[f] - m) * __ldg(io.maskf + row0 + f);
          sc[f] = ex;
          sum += ex;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          ms[0] = m;
          ms[1] = sum;
        }
      }
      __syncthreads();
      float* const part = a.Xpart + (size_t)ir * (E + 2);
      if (ch == 0) {
        if (tid < 2) part[tid] = ms[tid];
        if (a.Xex)
          for (int f = tid; f < n; f += NTP) a.Xex[(size_t)i * Tz + t0 + f] = sc[f];
      }
      const int n4 = n & ~3;
      if (!split4) {
        const int e = ch * NTP + tid;
        if (e < E) {
          const float* er = io.enc + row0 * E + e;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          int k = 0;
#pragma unroll 2
          for (; k < n4; k += 4) {
            a0 = fmaf(sc[k], __ldg(er + (size_t)k * E), a0);
            a1 = fmaf(sc[k + 1], __ldg(er + (size_t)(k + 1) * E), a1);
            a2 = fmaf(sc[k + 2], __ldg(er + (size_t)(k + 2) * E), a2);
            a3 = fmaf(sc[k + 3], __ldg(er + (size_t)(k + 3) * E), a3);
          }
          for (; k < n; ++k) a0 = fmaf(sc[k], __ldg(er + (size_t)k * E), a0);
          part[2 + e] = (a0 + a1) + (a2 + a3);
        }
        continue;
      }
      const int e = ch * PC + tid % PC, c = tid / PC;
      float acc = 0.f;
      if (e < E) {
        const float* er = io.enc + row0 * E + e;
#pragma unroll 8
        for (int k = c; k < n4; k += 4) acc = fmaf(sc[k], __ldg(er + (size_t)k * E), acc);
        if (c == 0)
          for (int k = n4; k < n; ++k) acc = fmaf(sc[k], __ldg(er + (size_t)k * E), acc);
      }
      red[tid] = acc;
      __syncthreads();
      if (tid < PC && e < E)
        part[2 + e] = (red[tid] + red[PC + tid]) + (red[2 * PC + tid] + red[3 * PC + tid]);
    }
  };

  // ctx from the ranks' partials in rank order (a rank with s_r = 0 weighs
  // 0), E in chunks of NTP over the CTAs; the replay's a = ex w_r / sum
  auto phase_x = [&]() {
    const int nch = (E + NTP - 1) / NTP, ps = E + 2, Tzp = up4(Tz);
    for (int w = blockIdx.x; w < NI * nch; w += P) {
      const int i = w / nch, ch = w - i * nch;
      const float* pr = a.Xpart + (size_t)i * vcl * ps;
      const float mr = lane < vcl ? __ldcg(pr + (size_t)lane * ps) : 0.f;
      const float sr = lane < vcl ? __ldcg(pr + (size_t)lane * ps + 1) : 0.f;
      const bool has = lane < vcl && sr > 0.f;
      const float m = warp_max(has ? mr : -INFINITY);
      const float w_lane = has ? expf(mr - m) : 0.f;
      float wr[MAX_CL], tot = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CL; ++r) {
        wr[r] = __shfl_sync(0xffffffffu, w_lane, r);
        const float s_r = __shfl_sync(0xffffffffu, sr, r);
        if (r < vcl) tot = fmaf(wr[r], s_r, tot);
      }
      const int e = ch * NTP + tid;
      if (e < E) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_CL; ++r)
          if (r < vcl) acc = fmaf(wr[r], __ldcg(pr + (size_t)r * ps + 2 + e), acc);
        a.Xctx[(size_t)i * E + e] = acc / tot;
      }
      if (io.a && ch == 0)
        for (int t = tid; t < Tzp; t += NTP) {
          float val = 0.f;
          if (t < Tz) {
            int r = 0;
            while ((r + 1) * Tz / vcl <= t) ++r;
            float wo = 0.f;
#pragma unroll
            for (int rr = 0; rr < MAX_CL; ++rr)
              if (rr == r) wo = wr[rr];
            val = (__ldcg(a.Xex + (size_t)i * Tz + t) * wo) / tot;
          }
          io.a[(size_t)i * Tzp + t] = val;
        }
    }
  };

  // cpre = [e; ctx] [Wc1; Wc2] + bc of the CTA's units, relu(cpre) to every CTA
  auto phase_c = [&](int s) {
    for (int i0 = 0; i0 < NI; i0 += p.bv) {
      const int nv = min(p.bv, NI - i0);
      stage_in(nv * K1, [&](int e) {
        const int v = e / K1, k = e - v * K1, i = i0 + v;
        return k < H ? io.emb + ((size_t)s * NI + i) * H + k : a.Xctx + (size_t)i * E + k - H;
      }, [&](int e) { return xs + e / K1 * p.ldx + e % K1; });
      __syncthreads();
      tile_gemv(u, ccol, 0, H, H, K1, xs, p.ldx, nv, red);  // the e half, then the ctx half
      __syncthreads();
      for (int e = tid; e < nv * u; e += NTP) {
        const int v = e / u, jj = e - v * u, i = i0 + v, j = j0 + jj;
        const float c = red[v * u + jj] + __ldg(io.bc + j);
        const float cb = fmaxf(c, 0.f);
        a.Xcomb[(size_t)i * H + j] = cb;
        if (io.comb) io.comb[((size_t)s * NI + i) * H + j] = cb;
        if (io.cpre) io.cpre[(size_t)i * H + j] = c;
      }
      __syncthreads();
    }
  };

  // gates = [comb; h] [Wih; Whh] + bl (the h half first), the cell and h of
  // the CTA's units
  auto phase_g = [&](int s) {
    const float* hprev = a.Xh + (size_t)(s & 1) * plane;
    float* hnext = a.Xh + (size_t)((s + 1) & 1) * plane;
    for (int i0 = 0; i0 < NI; i0 += p.bv) {
      const int nv = min(p.bv, NI - i0);
      stage_in(nv * 2 * H, [&](int e) {
        const int v = e / (2 * H), k = e - v * 2 * H;
        const size_t o = (size_t)(i0 + v) * H;
        return k < H ? a.Xcomb + o + k : (s == 0 ? io.h0 : hprev) + o + k - H;
      }, [&](int e) { return xs + e / (2 * H) * p.ldx + e % (2 * H); });
      __syncthreads();
      tile_gemv(4 * u, gcol, H, 2 * H, 0, H, xs, p.ldx, nv, red);
      __syncthreads();
      for (int e = tid; e < nv * u; e += NTP) {
        const int v = e / u, jj = e - v * u, i = i0 + v, j = j0 + jj;
        const size_t o = (size_t)i * H + j;
        const float* g = red + v * 4 * u + 4 * jj;
        const float ig = sigmoidf(g[0] + __ldg(io.bl + j));
        const float fg = sigmoidf(g[1] + __ldg(io.bl + H + j));
        const float gt = tanhf(g[2] + __ldg(io.bl + 2 * H + j));
        const float og = sigmoidf(g[3] + __ldg(io.bl + 3 * H + j));
        const float cprev = s == 0 ? __ldg(io.c0 + o) : __ldcg(a.Xc + o);
        const float c = cell(fg, cprev, ig, gt);
        const float tc = tanhf(c);
        const float hn = og * tc;
        a.Xc[o] = c;
        hnext[o] = hn;
        if (io.hs) {
          const size_t so = (size_t)s * plane + o;
          io.hs[so] = hn;
          io.cs[so] = c;
        }
        if (io.acts) {
          const float v5[5] = {ig, fg, gt, og, tc};
#pragma unroll
          for (int q = 0; q < 5; ++q) io.acts[q * plane + o] = v5[q];
          if (io.cell) io.cell[o] = c;
        }
      }
      __syncthreads();
    }
  };

  phase_q(io.h0);  // step 0's q, from h0
  sync_grid();
  for (int s = 0; s < io.S; ++s) {
    phase_s();
    sync_grid();
    phase_p();
    sync_grid();
    phase_x();
    sync_grid();
    phase_c(s);
    sync_grid();
    phase_g(s);
    if (s + 1 < io.S) {
      sync_grid();
      phase_q(a.Xh + (size_t)((s + 1) & 1) * plane);
      sync_grid();
    }
  }
}

// ---------------------------------------------------------------------------
// Reverse chain.

// A reverse launch: P CTAs of at most U units; the reverse plan's ranks CL,
// NQ groups of RQ dgate rows; tiles of BVD videos' dgate ([4H] each) and
// BVA videos' dq ([H]) staged; resident RW of the CTA's 2 U rows of [Wih;
// Whh] (LDW floats apart: an odd number of 16-byte units) and RL of its U
// rows of Wl2; NGMAX the most t groups of a unit's dq.
struct PBPlan {
  int P, U, vcl, nq, rq, bvd, bva, bvz, ldw, ldl, rw, rl, stage, red, ngmax, smem;
};

constexpr int DV = 8;             // videos of a tile of the reverse chain's dsc and dq phase
constexpr int RD = DV * NWP + DV;  // their warps' sums of <a, da>, then <a, da>

int tile_of(int want, int B) {
  int bv = want < 1 ? 1 : (want > B ? B : want);
  const int tiles = (B + bv - 1) / bv;
  return (B + tiles - 1) / tiles;
}

bool pb_plan(int B, int H, int Tz, int ctas, PBPlan& p) {
  BwdPlan bp;
  if (B < 1 || Tz < 1 || ctas < 1 || !bwd_plan(H, bp)) return false;
  const int G = 4 * H;
  p.P = ctas;
  p.U = (H + ctas - 1) / ctas;
  p.vcl = bp.cl;
  p.nq = bp.nq;
  p.rq = bp.rq;
  p.bvd = tile_of(XBUDGET / G, B);
  p.bva = tile_of(XBUDGET / H, B);
  const int hsmin = H / p.vcl > 1 ? H / p.vcl : 1;
  p.ngmax = NTP / hsmin > 1 ? NTP / hsmin : 1;
  if (p.U * p.ngmax > NTP) return false;  // a thread a t group of the CTA's dq
  // the dsc and dq phase: BVZ videos a tile, each with its dsc [Tz] and u's
  // columns of the CTA's units over all Tz frames where XBUDGET holds them
  // (else in chunks of frames)
  p.bvz = tile_of(imin(DV, NTP / (p.U * p.ngmax)), B);
  while (p.bvz > 1 && p.bvz * (up4(Tz) + p.U) > XBUDGET) p.bvz = tile_of(p.bvz - 1, B);
  const int frames = imax(1, imin(Tz, (XBUDGET / p.bvz - up4(Tz)) / p.U));
  const int dq_stage = p.bvz * (up4(Tz) + p.U * frames);
  // dgate, dq, K's tiles, dsc with u's columns, or K's rows and dcpre
  p.stage = up4(imax(imax(p.bvd * G, p.bva * H), imax(dq_stage, KTILE)));
  p.red = up4(imax(imax(p.bvd * 2 * p.U * p.nq, p.bva * p.U * p.vcl),
                   imax(NTP, p.bvz * p.U * p.ngmax)));
  p.ldw = 4 * (H % 2 ? H : H + 1);
  p.ldl = odd(H);
  const long fixed = (long)p.stage + p.red + RD + up4(2 * p.U + 2);
  long left = SMEM_FLOATS - fixed;
  if (left < 0) return false;
  p.rl = (int)lmin(p.U, left / p.ldl);
  left -= (long)p.rl * p.ldl;
  p.rw = (int)lmin(2 * p.U, left / p.ldw);
  left -= (long)p.rw * p.ldw;
  p.smem = (int)(4 * (SMEM_FLOATS - left));
  return true;
}

struct PBArgs {
  PersistBwdIO io;
  unsigned* cnt;
  float *K;     // [B][Tz][H] enc Wc2
  float *Xdg;   // [B][4H] dgate
  float *Xdcp;  // [B][H] dcpre
  float *Xda;   // [B][Tz] da
  float *Xdq;   // [B][H] dq
  float *Dh;    // [B][H] dh's part of dgate [Wih; Whh]^T (its owners only)
  float *Dc;    // [B][H] dc carried (its owners only)
  PBPlan p;
};

long bwd_scratch(int B, int H, int Tz) {
  return 4 + (long)up4(B * Tz * H) + up4(4 * B * H) + 4L * up4(B * H) + up4(B * Tz);
}

void bwd_carve(PBArgs& a, float* scratch) {
  const PersistBwdIO& io = a.io;
  float* s = scratch + 4;
  auto take = [&](long n) {
    float* r = s;
    s += up4((int)n);
    return r;
  };
  a.cnt = reinterpret_cast<unsigned*>(scratch);
  a.K = take((long)io.B * io.Tz * io.H);
  a.Xdg = take(4L * io.B * io.H);
  a.Xdcp = take((long)io.B * io.H);
  a.Xda = take((long)io.B * io.Tz);
  a.Xdq = take((long)io.B * io.H);
  a.Dh = take((long)io.B * io.H);
  a.Dc = take((long)io.B * io.H);
}

__global__ void __launch_bounds__(NTP, 1) chain_persistent_bwd_kernel(const PBArgs a) {
  extern __shared__ float4 smb4[];
  float* const sm = reinterpret_cast<float*>(smb4);
  const PersistBwdIO& io = a.io;
  const PBPlan& p = a.p;
  const int H = io.H, E = io.E, B = io.B, Tz = io.Tz, S = io.S, G = 4 * H, P = p.P;
  const int vcl = p.vcl, nq = p.nq, rq = p.rq, Tzp = up4(Tz);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int j0, u;
  cluster::units_of(blockIdx.x, P, H, j0, u);
  float* const wres = sm;                      // [RW][LDW] rows of [Wih; Whh]
  float* const stage = wres + p.rw * p.ldw;    // dgate, dq, dsc or K's tiles
  float* const red = stage + p.stage;
  float* const rd = red + p.red;               // [RD] the warps' sums of <a, da>
  int* const ngt = reinterpret_cast<int*>(rd + RD);  // [U] t groups, [U + 1] their offsets
  float* const wl = rd + RD + up4(2 * p.U + 2);      // [RL][LDL] rows of Wl2
  const int rw = min(p.rw, 2 * u), rl = min(p.rl, u);
  // row pc of the CTA's [Wih; Whh] rows: its units' Wih rows, then their Whh rows
  auto wrow = [&](int pc) -> const float* {
    if (pc < rw) return wres + pc * p.ldw;
    return io.wg + (size_t)(pc < u ? j0 + pc : H + j0 + pc - u) * G;
  };
  auto lrow = [&](int jj) -> const float* {
    return jj < rl ? wl + jj * p.ldl : io.wl2 + (size_t)(j0 + jj) * H;
  };
  for (int i = tid; i < rw * G; i += NTP) {
    const int pc = i / G, k = i - pc * G;
    wres[pc * p.ldw + k] = __ldg(io.wg + (size_t)(pc < u ? j0 + pc : H + j0 + pc - u) * G + k);
  }
  for (int i = tid; i < rl * H; i += NTP) {
    const int jj = i / H, k = i - jj * H;
    wl[jj * p.ldl + k] = __ldg(io.wl2 + (size_t)(j0 + jj) * H + k);
  }
  if (tid == 0) {  // each unit's t groups (`chain_bwd_wide_kernel`: NTW / its rank's HS)
    int off = 0;
    for (int jj = 0; jj < u; ++jj) {
      int r = 0;
      while ((r + 1) * H / vcl <= j0 + jj) ++r;
      const int hs = (r + 1) * H / vcl - r * H / vcl;
      ngt[jj] = NTP / hs > 1 ? NTP / hs : 1;
      ngt[p.U + jj] = off;
      off += ngt[jj];
    }
    ngt[p.U + u] = off;
  }
  for (int e = tid; e < B * u; e += NTP) {
    const size_t o = (size_t)(e / u) * H + j0 + e % u;
    a.Dh[o] = 0.f;
    a.Dc[o] = 0.f;
  }

  // K[b][t][j] = sum_e enc[b, t, e] Wc2[e, j], each a chain over e in order,
  // in KT x KT tiles dealt over the CTAs; thread (ty, tx) the rows ty, ty +
  // 32 and the columns tx + 16 q
  {
    const int R = B * Tz, nrt = (R + KT - 1) / KT, nct = (H + KT - 1) / KT;
    float* const As = stage;               // [KT][KE + 1]
    float* const Bs = stage + KT * (KE + 1);  // [KE][KT]
    const int ty = tid / 16, tx = tid % 16;
    for (int tile = blockIdx.x; tile < nrt * nct; tile += P) {
      const int r0 = tile / nct * KT, c0 = tile % nct * KT;
      float acc[2][4] = {};
      for (int e0 = 0; e0 < E; e0 += KE) {
        for (int i = tid; i < KT * KE; i += NTP) {
          const int rr = i / KE, ee = i - rr * KE;
          As[rr * (KE + 1) + ee] = r0 + rr < R && e0 + ee < E
                                       ? __ldg(io.enc + (size_t)(r0 + rr) * E + e0 + ee) : 0.f;
          const int er = i / KT, cc = i - er * KT;
          Bs[er * KT + cc] = e0 + er < E && c0 + cc < H
                                 ? __ldg(io.wc2 + (size_t)(e0 + er) * H + c0 + cc) : 0.f;
        }
        __syncthreads();
        const int ne = min(KE, E - e0);
        for (int ee = 0; ee < ne; ++ee) {
          const float a0 = As[ty * (KE + 1) + ee], a1 = As[(ty + 32) * (KE + 1) + ee];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float bq = Bs[ee * KT + tx + 16 * q];
            acc[0][q] = fmaf(a0, bq, acc[0][q]);
            acc[1][q] = fmaf(a1, bq, acc[1][q]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + ty + 32 * h, c = c0 + tx + 16 * q;
          if (r < R && c < H) a.K[(size_t)r * H + c] = acc[h][q];
        }
    }
  }
  unsigned bar = 0;
  auto sync_grid = [&]() { grid_barrier(a.cnt, ++bar * P); };
  sync_grid();

  // dq Wl2^T of the CTA's units by the ranks' partials, for a tile of
  // videos [b0, b0 + nv) from Xdq, into red[(v u + jj) CL + r]
  auto dq_partials = [&](int b0, int nv) {
    stage_in(nv * H, [&](int e) { return a.Xdq + (size_t)b0 * H + e; },
             [&](int e) { return stage + e; });
    __syncthreads();
    for (int e = tid; e < nv * u * vcl; e += NTP) {
      const int jj = e % u, r = (e / u) % vcl, v = e / (u * vcl);
      int rj0, rhs;
      cluster::units_of(r, vcl, H, rj0, rhs);
      const float* dq = stage + v * H + rj0;
      const float* w = lrow(jj) + rj0;
      float acc = 0.f;
      for (int i = 0; i < rhs; ++i) acc = fmaf(dq[i], w[i], acc);
      red[(v * u + jj) * vcl + r] = acc;
    }
    __syncthreads();
  };
  auto dql_of = [&](int v, int jj) {
    const float* rp = red + (v * u + jj) * vcl;
    float q = rp[0];
    for (int r = 1; r < vcl; ++r) q += rp[r];
    return q;
  };

  const size_t plane = (size_t)S * B * H;
  for (int s = S - 1; s >= 0; --s) {
    // A: dh and dc of the CTA's units, then their four dgate rows
    for (int b0 = 0; b0 < B; b0 += p.bva) {
      const int nv = min(p.bva, B - b0);
      if (s < S - 1) dq_partials(b0, nv);
      for (int e = tid; e < nv * u; e += NTP) {
        const int v = e / u, jj = e - v * u, b = b0 + v, n = j0 + jj;
        const size_t o = ((size_t)s * B + b) * H, d = (size_t)b * H + n;
        const float dql = s < S - 1 ? dql_of(v, jj) : 0.f;
        const float dh = (__ldcg(a.Dh + d) + dql) + __ldg(io.dh_ext + o + n);
        const float dc = __ldcg(a.Dc + d) + __ldg(io.dc_ext + o + n);
        const float f_i = __ldg(io.acts + o + n), f_f = __ldg(io.acts + plane + o + n);
        const float f_g = __ldg(io.acts + 2 * plane + o + n);
        const float f_o = __ldg(io.acts + 3 * plane + o + n);
        const float f_tc = __ldg(io.acts + 4 * plane + o + n), f_c = __ldg(io.c_in + o + n);
        const float dct = dh * f_o * (1.f - f_tc * f_tc) + dc;
        a.Dc[d] = dct * f_f;
        const float dq4[4] = {dct * f_g * f_i * (1.f - f_i), dct * f_c * f_f * (1.f - f_f),
                              dct * f_i * (1.f - f_g * f_g), dh * f_tc * f_o * (1.f - f_o)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a.Xdg[(size_t)b * G + q * H + n] = dq4[q];
          io.dgate[o * 4 + q * H + n] = dq4[q];
        }
      }
      __syncthreads();
    }
    sync_grid();

    // B: dgate [Wih; Whh]^T for the CTA's 2 U rows over NQ groups of RQ
    // rows, added in group order: its units' dcpre, and dh's part for the
    // next step
    for (int b0 = 0; b0 < B; b0 += p.bvd) {
      const int nv = min(p.bvd, B - b0);
      for (int e = tid; e < nv * G / 4; e += NTP)
        reinterpret_cast<float4*>(stage)[e] =
            __ldcg(reinterpret_cast<const float4*>(a.Xdg + (size_t)b0 * G) + e);
      __syncthreads();
      const int ncol = 2 * u;
      for (int e = tid; e < nv * ncol * nq; e += NTP) {
        const int pc = e % ncol, kq = (e / ncol) % nq, v = e / (ncol * nq);
        const int k0 = kq * rq, kn = max(0, min(rq, G - k0));
        const float* wr = wrow(pc) + k0;
        const float* dr = stage + (size_t)v * G + k0;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < kn; i += 4) {  // kn is a multiple of 4
          const float4 d = *reinterpret_cast<const float4*>(dr + i);
          const float4 w = *reinterpret_cast<const float4*>(wr + i);
          acc = fmaf(d.x, w.x, acc);
          acc = fmaf(d.y, w.y, acc);
          acc = fmaf(d.z, w.z, acc);
          acc = fmaf(d.w, w.w, acc);
        }
        red[(v * ncol + pc) * nq + kq] = acc;
      }
      __syncthreads();
      for (int e = tid; e < nv * ncol; e += NTP) {
        const int v = e / ncol, pc = e - v * ncol, b = b0 + v;
        const float* rp = red + e * nq;
        float d = rp[0];
        for (int q = 1; q < nq; ++q) d += rp[q];
        const size_t o = ((size_t)s * B + b) * H;
        if (pc < u) {
          const int j = j0 + pc;
          d = __ldg(io.cpre + o + j) > 0.f ? d + __ldg(io.dcomb_ext + o + j) : 0.f;
          a.Xdcp[(size_t)b * H + j] = d;
          io.dcpre[o + j] = d;
        } else {
          a.Dh[(size_t)b * H + j0 + pc - u] = d;
        }
      }
      __syncthreads();
    }
    sync_grid();

    // C: da[b][t] = K[b][t] dcpre[b] by the ranks' partials, added in rank
    // order; the (video, frame) pairs in even ranges over the CTAs, their
    // rows of K and their videos' dcpre staged CAP pairs at a time
    {
      const int R = B * Tz, r0 = (int)((long)blockIdx.x * R / P);
      const int r1 = (int)((long)(blockIdx.x + 1) * R / P);
      const int cap = min(NTP / vcl, p.stage / (2 * H));
      float* const kst = stage;            // [CAP][H] rows of K
      float* const dst = stage + cap * H;  // [videos][H] their dcpre
      for (int i0 = r0; i0 < r1; i0 += cap) {
        const int ni = min(cap, r1 - i0), bf = i0 / Tz, nb = (i0 + ni - 1) / Tz - bf + 1;
        stage_in(ni * H, [&](int e) { return a.K + (size_t)i0 * H + e; },
                 [&](int e) { return kst + e; });
        stage_in(nb * H, [&](int e) { return a.Xdcp + (size_t)bf * H + e; },
                 [&](int e) { return dst + e; });
        __syncthreads();
        if (tid < ni * vcl) {
          const int it = tid / vcl, r = tid % vcl;
          int rj0, rhs;
          cluster::units_of(r, vcl, H, rj0, rhs);
          const float* kr = kst + it * H + rj0;
          const float* dc = dst + ((i0 + it) / Tz - bf) * H + rj0;
          float acc = 0.f;
          for (int jj = 0; jj < rhs; ++jj) acc = fmaf(dc[jj], kr[jj], acc);
          red[tid] = acc;
        }
        __syncthreads();
        if (tid < ni) {
          float da = red[tid * vcl];
          for (int r = 1; r < vcl; ++r) da += red[tid * vcl + r];
          a.Xda[i0 + tid] = da;
        }
        __syncthreads();
      }
    }
    sync_grid();

    // D, BVZ videos at a time: <a, da> in the cluster kernel's order (thread
    // t's partial over t, t + NTP, ..., its warps' sums added in order) and
    // dsc of every frame (every CTA alike; CTA b mod P writes video b's),
    // then the CTA's units' dq over t groups, a thread a (video, group),
    // over u's columns staged TC frames at a time
    for (int b0 = 0; b0 < B; b0 += p.bvz) {
      const int nv = min(p.bvz, B - b0);
      const float* const ar = io.a + ((size_t)s * B + b0) * Tzp;
      const float* const da = a.Xda + (size_t)b0 * Tz;
      float adv[DV];
#pragma unroll
      for (int v = 0; v < DV; ++v) {
        adv[v] = 0.f;
        if (v < nv)
          for (int t = tid; t < Tz; t += NTP)
            adv[v] = fmaf(__ldg(ar + (size_t)v * Tzp + t), __ldcg(da + (size_t)v * Tz + t), adv[v]);
      }
#pragma unroll
      for (int v = 0; v < DV; ++v) {
        const float w_sum = warp_sum(adv[v]);
        if (lane == 0 && v < nv) rd[v * NWP + warp] = w_sum;
      }
      __syncthreads();
      if (tid < nv) {
        float ad = rd[tid * NWP];
        for (int w = 1; w < NWP; ++w) ad += rd[tid * NWP + w];
        rd[DV * NWP + tid] = ad;
      }
      __syncthreads();
      float* const dsc = stage;  // [BVZ][Tzp]
      for (int e = tid; e < nv * Tz; e += NTP) {
        const int v = e / Tz, t = e - v * Tz;
        const float d = __ldg(ar + (size_t)v * Tzp + t) * (__ldcg(da + e) - rd[DV * NWP + v]);
        dsc[v * Tzp + t] = d;
        if ((b0 + v) % P == (int)blockIdx.x) io.dsc[((size_t)s * B + b0 + v) * Tz + t] = d;
      }
      const int ntask = ngt[p.U + u];
      int tv = tid / max(ntask, 1), tj = 0, ta = 0, tb = 0;
      const bool mine = ntask > 0 && tv < nv;
      if (mine) {
        const int e = tid - tv * ntask;
        while (ngt[p.U + tj + 1] <= e) ++tj;
        const int ng = ngt[tj], gi = e - ngt[p.U + tj], chunk = (Tz + ng - 1) / ng;
        ta = gi * chunk;
        tb = min(Tz, ta + chunk);
      }
      float acc = 0.f;
      if (u > 0) {
        float* const ust = stage + nv * Tzp;  // [BVZ][TC][u] u's columns of the CTA's units
        const int tc = (p.stage - nv * Tzp) / (nv * u);
        for (int c0 = 0; c0 < Tz; c0 += tc) {
          const int nc = min(tc, Tz - c0), per = nc * u;
          __syncthreads();  // dsc is written, the last chunk read
          stage_in(nv * per, [&](int e) {
            const int v = e / per, t = (e - v * per) / u;
            return io.u + (((size_t)s * B + b0 + v) * Tz + c0 + t) * H + j0 + (e - v * per - t * u);
          }, [&](int e) { return ust + e; });
          __syncthreads();
          if (mine) {
            const int t1 = min(tb, c0 + nc);
            for (int t = max(ta, c0); t < t1; ++t) {
              const float uu = ust[tv * per + (t - c0) * u + tj];
              acc = fmaf(dsc[tv * Tzp + t], 1.f - uu * uu, acc);
            }
          }
        }
      }
      if (mine) red[tid] = acc;
      __syncthreads();
      for (int e = tid; e < nv * u; e += NTP) {
        const int v = e / u, jj = e - v * u;
        const float* rp = red + v * ntask + ngt[p.U + jj];
        float q = rp[0];
        for (int g = 1; g < ngt[jj]; ++g) q += rp[g];
        a.Xdq[(size_t)(b0 + v) * H + j0 + jj] = __ldg(io.v + j0 + jj) * q;
      }
      __syncthreads();
    }
    sync_grid();
  }
  // dh0 = dh's part of step 0 + dq Wl2^T; dc0
  for (int b0 = 0; b0 < B; b0 += p.bva) {
    const int nv = min(p.bva, B - b0);
    dq_partials(b0, nv);
    for (int e = tid; e < nv * u; e += NTP) {
      const int v = e / u, jj = e - v * u;
      const size_t d = (size_t)(b0 + v) * H + j0 + jj;
      io.dh0[d] = __ldcg(a.Dh + d) + dql_of(v, jj);
      io.dc0[d] = __ldcg(a.Dc + d);
    }
    __syncthreads();
  }
}

// The launch's kernel attributes and whether the card holds P CTAs of it at
// once (`co`: the CTAs it holds).
cudaError_t coop_fit(const void* kernel, int smem, int P, int& co) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTP, smem);
  if (err != cudaSuccess) return err;
  co = per_sm * sms;
  if (!coop) return cudaErrorNotSupported;
  return co < P ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

long persist_fwd_scratch(int NI, int H, int E, int Tz, bool replay) {
  PFPlan p;
  FwdPlan fp;
  if (NI < 1 || Tz < 1 || E < 1 || !fwd_plan(H, fp)) return -1;
  p.vcl = fp.cl;
  return fwd_scratch(p, NI, H, E, Tz, replay);
}

cudaError_t persist_fwd(const PersistFwdIO& io, float* scratch, long scratch_floats, int ctas,
                        cudaStream_t stream) {
  PFArgs a{};
  a.io = io;
  if (ctas <= 0) ctas = card_sms();
  const bool replay = io.acts != nullptr;
  if (io.S < 1 || io.B < 1 || (replay && (!io.cpre || !io.a || !io.u)) ||
      (!replay && (!io.hs || !io.cs || !io.comb)) ||
      !pf_plan(io.NI, io.H, io.E, io.Tz, ctas, a.p))
    return cudaErrorInvalidValue;
  if (!scratch || scratch_floats < fwd_scratch(a.p, io.NI, io.H, io.E, io.Tz, replay))
    return cudaErrorInvalidValue;
  fwd_carve(a, scratch, replay);
  int co = 0;
  cudaError_t err = coop_fit((const void*)chain_persistent_fwd_kernel, a.p.smem, ctas, co);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, 4 * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)chain_persistent_fwd_kernel, dim3(ctas),
                                    dim3(NTP), args, a.p.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

long persist_bwd_scratch(int B, int H, int Tz) {
  BwdPlan p;
  if (B < 1 || Tz < 1 || !bwd_plan(H, p)) return -1;
  return bwd_scratch(B, H, Tz);
}

cudaError_t persist_bwd(const PersistBwdIO& io, float* scratch, long scratch_floats, int ctas,
                        cudaStream_t stream) {
  PBArgs a{};
  a.io = io;
  if (ctas <= 0) ctas = card_sms();
  if (io.S < 1 || io.E < 1 || !pb_plan(io.B, io.H, io.Tz, ctas, a.p))
    return cudaErrorInvalidValue;
  if (!scratch || scratch_floats < bwd_scratch(io.B, io.H, io.Tz)) return cudaErrorInvalidValue;
  bwd_carve(a, scratch);
  int co = 0;
  cudaError_t err = coop_fit((const void*)chain_persistent_bwd_kernel, a.p.smem, ctas, co);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, 4 * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)chain_persistent_bwd_kernel, dim3(ctas),
                                    dim3(NTP), args, a.p.smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace dchain

using namespace dchain;

// The scratch floats of a persistent launch (reverse = 0: the forward of NI
// items, `replay` its replay pass; 1: the reverse chain of B = NI videos);
// -1 where no plan fits.
extern "C" long mucon_decoder_chain_persistent_scratch(int reverse, int NI, int H, int E, int Tz,
                                                       int replay) {
  return reverse ? persist_bwd_scratch(NI, H, Tz) : persist_fwd_scratch(NI, H, E, Tz, replay);
}

// A persistent launch's plan on this card (ctas <= 0: one CTA an SM):
// out = {P, U, CL, the CTAs the card holds at once, shared memory bytes,
// then forward: BV, resident columns of Wl2, [Wc1; Wc2], the gates, and U,
// U, 4U, the columns a CTA owns, then how the attention is dealt: frames of
// a scores block, channels of a pair's chunk (PCH), channels of a ctx
// chunk; reverse: NQ, RQ, BVD, BVA, resident rows of [Wih; Whh] of 2U, of
// Wl2 of U, the side of K's tiles}.  Returns the error where the card
// cannot hold the grid (the fields are filled all the same).
extern "C" int mucon_decoder_chain_persistent_plan(int reverse, int NI, int H, int E, int Tz,
                                                   int ctas, int* out) {
  if (ctas <= 0) ctas = card_sms();
  int co = 0;
  cudaError_t err;
  if (reverse) {
    PBPlan p;
    if (!pb_plan(NI, H, Tz, ctas, p)) return cudaErrorInvalidValue;
    err = coop_fit((const void*)chain_persistent_bwd_kernel, p.smem, ctas, co);
    const int v[15] = {p.P, p.U, p.vcl, co, p.smem, p.nq, p.rq, p.bvd, p.bva, p.rw, p.rl, KT,
                       0, 0, 0};
    for (int i = 0; i < 15; ++i) out[i] = v[i];
  } else {
    PFPlan p;
    if (!pf_plan(NI, H, E, Tz, ctas, p)) return cudaErrorInvalidValue;
    err = coop_fit((const void*)chain_persistent_fwd_kernel, p.smem, ctas, co);
    const int v[15] = {p.P, p.U, p.vcl, co, p.smem, p.bv, p.rq, p.rc, p.rg, p.U, p.U, 4 * p.U,
                       FB, p.pch, NTP};
    for (int i = 0; i < 15; ++i) out[i] = v[i];
  }
  return err;
}

// The forward chain (`replay` 0: S steps of B = NI videos from h0, c0 ->
// hs, cs, comb) or the replay pass (NI = S B items of one step from h_in,
// c_in -> acts, cpre, a, u, cell) on the persistent kernel.
extern "C" int mucon_decoder_chain_persistent_fwd(
    const float* emb, const float* enc, const float* pre, const float* maskf, const float* h0,
    const float* c0, const float* wl2T, const float* bl2, const float* v, const float* wcT,
    const float* bc, const float* wgT, const float* bl, float* hs, float* cs, float* comb,
    float* acts, float* cpre, float* a, float* u, float* cell, float* scratch,
    long scratch_floats, int NI, int S, int B, int Tz, int H, int E, int ctas,
    cudaStream_t stream) {
  const PersistFwdIO io{emb, enc, pre, maskf, h0, c0, wl2T, bl2, v, wcT, bc, wgT, bl, hs, cs,
                        comb, acts, cpre, a, u, cell, NI, S, B, Tz, H, E};
  return persist_fwd(io, scratch, scratch_floats, ctas, stream);
}

// The reverse chain on the persistent kernel -> dgate, dcpre, dsc, dh0, dc0.
extern "C" int mucon_decoder_chain_persistent_bwd(
    const float* acts, const float* cpre, const float* a, const float* u, const float* c_in,
    const float* enc, const float* v, const float* wc2, const float* wg, const float* wl2,
    const float* dh_ext, const float* dc_ext, const float* dcomb_ext, float* dgate,
    float* dcpre, float* dsc, float* dh0, float* dc0, float* scratch, long scratch_floats,
    int S, int B, int Tz, int H, int E, int ctas, cudaStream_t stream) {
  const PersistBwdIO io{acts, cpre, a, u, c_in, enc, v, wc2, wg, wl2, dh_ext, dc_ext,
                        dcomb_ext, dgate, dcpre, dsc, dh0, dc0, S, B, Tz, H, E};
  return persist_bwd(io, scratch, scratch_floats, ctas, stream);
}
