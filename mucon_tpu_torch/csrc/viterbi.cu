// Dense single-transcript Viterbi DP and its pointer walk in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `_viterbi_batched_kernel` /
// `dense_viterbi_pallas_batched` (mucon_tpu/ops/viterbi_pallas.py:109, :231)
// and the per-video grid `_viterbi_kernel` / `dense_viterbi_pallas` (:47,
// :290), and the walk the JAX package runs after them in the same program
// (`traceback_positions_device`, mucon_tpu/ops/viterbi.py:405).  Per window k:
//
//   exit[n]  = max_l (s[n][l] + pois[n][l]), first-index argmax -> bp[n+1]
//   s'[n][0] = exit[n-1] + W[k][n-1]     (advance, scored with the OLD label;
//                                         NEG at n = 0 and n >= n_valid)
//   s'[n][l] = (stay_ok(l-1) ? s[n][l-1] : NEG) + W[k][n]      (stay, l >= 1)
//   rows n >= n_valid -> NEG;  windows k >= k_valid keep s unchanged
//
// bp rows are written for every k in 1..K-1, with bp = 0 at n = 0 exactly as
// the scan (mucon_tpu/ops/viterbi.py:210); the batched TPU kernel wrapped the
// previous video's last position into that slot.  The same f32 adds in the
// same order as the scan make scores and backpointers bit-identical to it.
// Finalize: the max and first-index argmax of row clip(n_valid - 1) of
// s + pois.  Then one thread walks the backpointers from (n_valid - 1,
// best_l + 1) to the window positions pos [B, K] (int64), with the clamps of
// `ops/viterbi.py traceback_positions`.
//
// Bound: the K-step chain's latency; the work is ~4 N L operations a
// window and the bytes a few tens of kB a video.  Three bodies:
//
// * warp body (N <= 32, L <= 72; the default shape N = 30, L = 66): one
//   warp a video, lane n holding row n's L cells and its pois row in
//   registers (LC = 72 cells, the rest -inf).  A window is a register
//   add, an argmax tree in groups of 8 (strict >, so the lower index wins a
//   tie), one __shfl_up_sync for the advance and a register shift for the
//   stay (with no per-cell gate where every cell may grow, as at the default
//   max_len / S = L): no block barrier, no shared-memory round trip of the
//   state, no integer divide.  Windows past k_valid keep the state, so their
//   backpointers are one argmax, written once a window.
// * cluster body (any other N, L whose cells a cluster of up to 16 CTAs
//   holds in registers; frame_sampling 1-3 at N = 30, N = 300 at L = 66):
//   a thread-block cluster of CL CTAs a video splits L into CL slices of
//   WC = TPR x 16 columns; in a CTA, TPR threads (lanes of one warp) share
//   a row's slice, each holding 16 consecutive cells of RPT rows (and their
//   pois) in registers.  A window: each thread's argmax tree over its
//   cells, a butterfly over the row's TPR lanes (the lower index wins a
//   tie); lane 0 of the row stores the slice's (max, argmax) into rank 0's
//   slot for this rank, the row's last lane its last cell into the next
//   rank's edge slot (distributed shared memory); one cluster barrier,
//   split: the stays within a thread and from its left lane
//   (__shfl_up_sync) run between its arrive and its wait; after the wait a
//   row's first thread takes its first cell from the edge slot, or, at
//   rank 0, the advance: row n - 1's partials merged in rank order (strict
//   >, so the lower rank wins a tie) give the exit and the backpointer.
//   The slots are double-buffered by window parity, so one barrier a
//   window orders every exchange.  No state leaves the registers, no
//   integer divide a cell, no __syncthreads between windows.  The host
//   picks (CL, TPR, RPT) (`cuda.viterbi_plan`): the fewest rows a thread,
//   then the narrowest cluster, 8 CTAs or fewer before 16.
// * global body (no cluster of 16 holds the cells: N = 300 at L = 2000):
//   one 256-thread CTA a video with its two [N x L] state buffers in
//   device memory (scratch the wrapper allocates, [B, 2, N, L]) and pois
//   read where it lies; its threads stride over the N rows.
// Every body makes the same f32 adds and first-index argmaxes as the plain
// DP, so the same bits.
//
// All three stage W[b] in shared memory `staged` windows at a time (at most
// KC; fewer where the rest of shared memory leaves less room) before the
// windows that read it (the whole [K, N] block at the default shape), so no
// global load of W sits inside a window, and keep each window's argmaxes in
// a uint16 table in shared memory for the walk, which reads at most N of
// them; where the table does not fit (K N above ~100k), and in the cluster
// body (whose every CTA would carry rank 0's table), the walk reads the
// int32 backpointers it wrote to device memory instead.  The host chooses the body, the staged windows and the
// table's place (`cuda.viterbi_plan`) and this file checks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 256;  // threads of the cluster and global bodies
constexpr int KC = 128;  // windows of W staged at a time
constexpr int LANE_CELLS = 72;  // cells a lane of the warp body holds (LC)
constexpr int CELLS = 16;       // cells of a row a thread of the cluster body holds
constexpr int MAX_CL = 16;      // the widest cluster (above 8: non-portable size)
constexpr unsigned FULL = 0xffffffffu;

enum Body { WARP = 0, CLUSTER = 1, GLOBAL = 2 };

// Shared-memory bytes of a launch staging `staged` windows of W at a time:
// the warp body nothing more; the cluster body the ranks' [2][cl][N] row
// maxima and argmaxes and the [2][N] edge column; the global body its [N]
// exits and argmaxes.  `table` puts the walk's [K-1 x N] uint16 table there
// too.
size_t viterbi_smem(int K, int N, int body, int cl, int table, int staged) {
  const size_t state = body == CLUSTER ? (size_t)4 * cl * N + 2 * N
                                       : (body == GLOBAL ? (size_t)2 * N : 0);
  const size_t floats = (size_t)staged * N + state;
  return floats * sizeof(float) + (table ? (size_t)(K - 1) * N * sizeof(uint16_t) : 0);
}

// The walk of `traceback_positions`: positions newest first, a backpointer
// read only on a transition; `tab` null reads the device-memory copy.
__device__ void walk(const uint16_t* tab, const int* bps_b, int K, int N, int kv, int nv,
                     int best_l, long long* pos_b) {
  int n = nv - 1, l = best_l + 1;
  for (int k = K - 1; k >= 1; --k) {
    pos_b[k] = n;
    if (k < kv) {
      if (l > 1) {
        --l;
      } else {
        const size_t at = (size_t)(k - 1) * N + min(max(n, 0), N - 1);
        l = (tab ? (int)tab[at] : bps_b[at]) + 1;
        --n;
      }
    }
  }
  pos_b[0] = max(n, 0);
}

// window k's backpointer row from the exit argmaxes: column c <- arg[c - 1],
// column 0 <- 0
__device__ __forceinline__ void put_bp(int* bps_b, uint16_t* tab, int k, int N, int c,
                                       int v) {
  const size_t at = (size_t)(k - 1) * N + c;
  bps_b[at] = v;
  if (tab) tab[at] = (uint16_t)v;
}

// (max, first argmax) of s + p over a lane's LC cells: trees of 8, merged in
// ascending order; strict > keeps the lower index on a tie
template <int LC>
__device__ __forceinline__ void row_best(const float (&s)[LC], const float (&p)[LC],
                                         float& best, int& arg) {
#pragma unroll
  for (int g = 0; g < LC / 8; ++g) {
    float v[8];
    int a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = s[8 * g + j] + p[8 * g + j];
      a[j] = 8 * g + j;
    }
#pragma unroll
    for (int w = 1; w < 8; w *= 2)
#pragma unroll
      for (int j = 0; j + w < 8; j += 2 * w)
        if (v[j + w] > v[j]) {
          v[j] = v[j + w];
          a[j] = a[j + w];
        }
    if (g == 0 || v[0] > best) {
      best = v[0];
      arg = a[0];
    }
  }
}

template <int LC>
__global__ void __launch_bounds__(32) viterbi_warp_kernel(
    const float* __restrict__ W,        // [B, K, N]
    const float* __restrict__ pois,     // [B, N, L]
    const int* __restrict__ k_valid,    // [B]
    const int* __restrict__ n_valid,    // [B]
    float* __restrict__ score_out,      // [B]
    int* __restrict__ best_l_out,       // [B]
    int* __restrict__ bps,              // [B, K-1, N]
    long long* __restrict__ pos,        // [B, K]
    float*, int K, int N, int L, int S, int max_len, int table, int staged) {
  extern __shared__ float sm[];
  float* wsm = sm;  // [staged, N]
  uint16_t* tab = table ? reinterpret_cast<uint16_t*>(wsm + staged * N) : nullptr;

  const int b = blockIdx.x, n = threadIdx.x;
  const int kv = k_valid[b], nv = n_valid[b];
  const bool row = n < N;
  const float* Wb = W + (size_t)b * K * N;
  int* bps_b = bps + (size_t)b * (K - 1) * N;

  int ls = -1;  // cells l <= ls may grow from l - 1: (l + 1) S <= max_len
  for (int l = 0; l < LC; ++l)
    if ((l + 1) * S <= max_len) ls = l;

  float s[LC], p[LC];
  const float* pb = pois + ((size_t)b * N + n) * L;
#pragma unroll
  for (int l = 0; l < LC; ++l) {
    p[l] = row && l < L ? pb[l] : -INFINITY;
    s[l] = NEG;
  }
  if (n == 0) s[0] = Wb[0];  // window 0 puts (n=0, l=1) at W[0][0]

  const int kend = min(max(kv, 1), K);  // live windows: 1 .. kend - 1
  for (int k0 = 1; k0 < kend; k0 += staged) {
    const int cnt = min(staged, kend - k0);
    __syncwarp();
    for (int i = n; i < cnt * N; i += 32) wsm[i] = Wb[(size_t)k0 * N + i];
    __syncwarp();
    for (int k = k0; k < k0 + cnt; ++k) {
      float best;
      int arg;
      row_best<LC>(s, p, best, arg);
      const float w = row ? wsm[(k - k0) * N + n] : 0.f;
      const float up = __shfl_up_sync(FULL, best + w, 1);
      if (n == 0) put_bp(bps_b, tab, k, N, 0, 0);
      if (n + 1 < N) put_bp(bps_b, tab, k, N, n + 1, arg);
      if (row && n < nv) {
        if (ls >= L - 1) {  // every cell may grow (the default shape): no gate
#pragma unroll
          for (int l = LC - 1; l >= 1; --l) s[l] = s[l - 1] + w;
        } else {
#pragma unroll
          for (int l = LC - 1; l >= 1; --l) s[l] = (l <= ls ? s[l - 1] : NEG) + w;
        }
        s[0] = n == 0 ? NEG : up;
      } else if (k == 1) {  // rows past n_valid: NEG from the first live window on
#pragma unroll
        for (int l = 0; l < LC; ++l) s[l] = NEG;
      }
    }
  }

  float best;
  int arg;
  row_best<LC>(s, p, best, arg);
  for (int k = kend; k < K; ++k) {  // frozen windows: one argmax for all
    if (n == 0) put_bp(bps_b, tab, k, N, 0, 0);
    if (n + 1 < N) put_bp(bps_b, tab, k, N, n + 1, arg);
  }
  __syncwarp();  // orders the table's and bps' writes before the walk's reads
  if (n == min(max(nv - 1, 0), N - 1)) {
    score_out[b] = best;
    best_l_out[b] = arg;
    walk(tab, bps_b, K, N, kv, nv, arg, pos + (size_t)b * K);
  }
}

// (best, arg) over one row by one warp; ties keep the lowest index
__device__ __forceinline__ void row_argmax(const float* s, const float* p, int L,
                                           int lane, float& best, int& arg) {
  best = -INFINITY;
  arg = L;
  for (int l = lane; l < L; l += 32) {
    const float v = s[l] + p[l];
    if (v > best) {
      best = v;
      arg = l;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(FULL, best, off);
    const int oa = __shfl_down_sync(FULL, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
}

// (max, first argmax) of a row over the TPR lanes that share it (a
// butterfly; every lane ends with the result; ties keep the lower index)
__device__ __forceinline__ void lanes_best(float& best, int& arg, int tpr) {
  for (int o = 1; o < tpr; o <<= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oa = __shfl_xor_sync(FULL, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
}

// row n's (max, first argmax) over the ranks' slices, merged in rank
// order: strict >, so the lower rank (the lower columns) wins a tie
__device__ __forceinline__ void ranks_best(const float* pbest, const int* parg, int cl,
                                           int N, int n, float& best, int& arg) {
  best = pbest[n];
  arg = parg[n];
  for (int r = 1; r < cl; ++r) {
    const float v = pbest[r * N + n];
    if (v > best) {
      best = v;
      arg = parg[r * N + n];
    }
  }
}

// The cluster body (see the head of the file): grid B CL CTAs, a cluster of
// CL a video; thread t holds rows g + i NT / TPR (i < RPT, g = t / TPR) at
// columns rank WC + (t % TPR) CELLS .. + CELLS - 1, WC = TPR CELLS.
template <int RPT>
__global__ void __launch_bounds__(NT) viterbi_cluster_kernel(
    const float* __restrict__ W, const float* __restrict__ pois,
    const int* __restrict__ k_valid, const int* __restrict__ n_valid,
    float* __restrict__ score_out, int* __restrict__ best_l_out, int* __restrict__ bps,
    long long* __restrict__ pos, int K, int N, int L, int S, int max_len, int table,
    int staged, int cl, int tpr) {
  extern __shared__ float sm[];
  float* wsm = sm;                                             // [staged, N]
  float* pbest = wsm + staged * N;                             // [2][cl][N] (rank 0's)
  int* parg = reinterpret_cast<int*>(pbest + 2 * cl * N);      // [2][cl][N] (rank 0's)
  float* edge = reinterpret_cast<float*>(parg + 2 * cl * N);   // [2][N] left rank's column
  uint16_t* tab = table ? reinterpret_cast<uint16_t*>(edge + 2 * N) : nullptr;

  const int rank = (int)cluster::cluster_rank();
  const int b = blockIdx.x / cl, tid = threadIdx.x;
  const int c = tid & (tpr - 1), g = tid / tpr, G = NT / tpr;
  const int l0 = rank * tpr * CELLS + c * CELLS;  // this thread's first column
  const int kv = k_valid[b], nv = n_valid[b];
  const int ls = max_len / S - 1;  // cells l <= ls may grow from l - 1: (l + 1) S <= max_len
  const float* Wb = W + (size_t)b * K * N;
  int* bps_b = bps + (size_t)b * (K - 1) * N;
  float* pbest0 = cluster::cluster_peer(pbest, 0);
  int* parg0 = cluster::cluster_peer(parg, 0);
  float* edge1 = cluster::cluster_peer(edge, rank + 1 < cl ? rank + 1 : rank);

  float s[RPT][CELLS], p[RPT][CELLS];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = g + i * G;
    const float* pb = pois + ((size_t)b * N + min(n, N - 1)) * L;
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      p[i][j] = n < N && l0 + j < L ? pb[l0 + j] : -INFINITY;
      s[i][j] = NEG;
    }
  }
  if (l0 == 0 && g == 0) s[0][0] = Wb[0];  // window 0 puts (n=0, l=1) at W[0][0]
  cluster::cluster_sync();  // every CTA runs before a peer stores into it

  // a row's slice: (max, first argmax) over the row's TPR lanes; lane 0 of
  // the row stores it into rank 0's slot `rank` of parity `par`
  auto publish = [&](int par) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = g + i * G;
      float best;
      int arg;
      row_best<CELLS>(s[i], p[i], best, arg);
      arg += l0;
      lanes_best(best, arg, tpr);
      if (c == 0 && n < N) {
        pbest0[(par * cl + rank) * N + n] = best;
        parg0[(par * cl + rank) * N + n] = arg;
      }
    }
  };

  const int kend = min(max(kv, 1), K);  // live windows: 1 .. kend - 1
  int par = 0;
  for (int k0 = 1; k0 < kend; k0 += staged) {
    const int cnt = min(staged, kend - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < cnt * N; i += NT) wsm[i] = Wb[(size_t)k0 * N + i];
    __syncthreads();
    for (int k = k0; k < k0 + cnt; ++k, par ^= 1) {
      const float* wk = wsm + (k - k0) * N;
      publish(par);
      float up[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = g + i * G;
        up[i] = __shfl_up_sync(FULL, s[i][CELLS - 1], 1);  // the left lane's last cell
        if (c == tpr - 1 && rank + 1 < cl && n < N) edge1[par * N + n] = s[i][CELLS - 1];
      }
      cluster::cluster_arrive();
      // the stays that need no peer: every cell but a row slice's first
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = g + i * G;
        if (n < nv) {
          const float w = wk[min(n, N - 1)];
#pragma unroll
          for (int j = CELLS - 1; j >= 1; --j) s[i][j] = (l0 + j <= ls ? s[i][j - 1] : NEG) + w;
          if (c > 0) s[i][0] = (l0 <= ls ? up[i] : NEG) + w;
        } else {
#pragma unroll
          for (int j = 0; j < CELLS; ++j) s[i][j] = NEG;
        }
      }
      cluster::cluster_wait();
      if (c == 0) {  // a slice's first cell: the left rank's edge, or the advance
        const float* pb = pbest + par * cl * N;
        const int* pa = parg + par * cl * N;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int n = g + i * G;
          if (n >= N) continue;
          if (rank == 0) {  // column n of the window's backpointers: row n - 1's argmax
            float v = NEG;
            int a = 0;
            if (n > 0) {
              ranks_best(pb, pa, cl, N, n - 1, v, a);
              v += wk[n - 1];
            }
            put_bp(bps_b, tab, k, N, n, a);
            if (n < nv) s[i][0] = n > 0 ? v : NEG;
          } else if (n < nv) {
            s[i][0] = (l0 <= ls ? edge[par * N + n] : NEG) + wk[n];
          }
        }
      }
    }
  }

  // the final state's argmaxes: the frozen windows' backpointers, the score
  publish(par);
  cluster::cluster_sync();  // the last exchange; no peer stores after it
  if (rank != 0) return;
  int* fa = reinterpret_cast<int*>(edge);  // [N] the rows' argmaxes
  const int last = min(max(nv - 1, 0), N - 1);
  int walk_arg = -1;
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = g + i * G;
      if (n >= N) continue;
      float best;
      int arg;
      ranks_best(pbest + par * cl * N, parg + par * cl * N, cl, N, n, best, arg);
      fa[n] = arg;
      if (n == last) {
        score_out[b] = best;
        best_l_out[b] = arg;
        walk_arg = arg;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < (K - kend) * N; i += NT) {
    const int k = kend + i / N, col = i - (k - kend) * N;
    put_bp(bps_b, tab, k, N, col, col == 0 ? 0 : fa[col - 1]);
  }
  __syncthreads();  // orders the table's and bps' writes before the walk's reads
  if (walk_arg >= 0) walk(tab, bps_b, K, N, kv, nv, walk_arg, pos + (size_t)b * K);
}

// The global body: video b's two state buffers at gstate + 2 N L b
__global__ void __launch_bounds__(NT) viterbi_global_kernel(
    const float* __restrict__ W, const float* __restrict__ pois,
    const int* __restrict__ k_valid, const int* __restrict__ n_valid,
    float* __restrict__ score_out, int* __restrict__ best_l_out, int* __restrict__ bps,
    long long* __restrict__ pos, float* gstate, int K, int N, int L, int S, int max_len,
    int table, int staged) {
  extern __shared__ float sm[];
  const int NL = N * L;
  float* cur = gstate + (size_t)2 * NL * blockIdx.x;
  float* nxt = cur + NL;
  const float* ps = pois + (size_t)blockIdx.x * NL;
  float* ex_best = sm;                                // [N]
  int* ex_arg = reinterpret_cast<int*>(ex_best + N);  // [N]
  float* wsm = reinterpret_cast<float*>(ex_arg + N);  // [staged, N]
  uint16_t* tab = table ? reinterpret_cast<uint16_t*>(wsm + staged * N) : nullptr;

  const int b = blockIdx.x;
  const int kv = k_valid[b];
  const int nv = n_valid[b];
  const float* Wb = W + (size_t)b * K * N;
  int* bps_b = bps + (size_t)b * (K - 1) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < NL; i += NT) cur[i] = i == 0 ? Wb[0] : NEG;

  const int kend = min(max(kv, 1), K);
  for (int k0 = 1; k0 < kend; k0 += staged) {
    const int cnt = min(staged, kend - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < cnt * N; i += NT) wsm[i] = Wb[(size_t)k0 * N + i];
    __syncthreads();
    for (int k = k0; k < k0 + cnt; ++k) {
      for (int n = warp; n < N; n += NT / 32) {
        float best;
        int arg;
        row_argmax(cur + n * L, ps + n * L, L, lane, best, arg);
        if (lane == 0) {
          ex_best[n] = best;
          ex_arg[n] = arg;
        }
      }
      __syncthreads();
      const float* wk = wsm + (k - k0) * N;
      for (int i = threadIdx.x; i < NL; i += NT) {
        const int n = i / L, l = i - n * L;
        float v;
        if (n >= nv) {
          v = NEG;
        } else if (l == 0) {
          v = n == 0 ? NEG : ex_best[n - 1] + wk[n - 1];
        } else {
          v = ((l + 1) * S <= max_len ? cur[i - 1] : NEG) + wk[n];
        }
        nxt[i] = v;
      }
      for (int c = threadIdx.x; c < N; c += NT)
        put_bp(bps_b, tab, k, N, c, c == 0 ? 0 : ex_arg[c - 1]);
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  __syncthreads();

  // frozen windows: the argmaxes of the final state, once
  for (int n = warp; n < N; n += NT / 32) {
    float best;
    int arg;
    row_argmax(cur + n * L, ps + n * L, L, lane, best, arg);
    if (lane == 0) ex_arg[n] = arg;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (K - kend) * N; i += NT) {
    const int k = kend + i / N, c = i - (k - kend) * N;
    put_bp(bps_b, tab, k, N, c, c == 0 ? 0 : ex_arg[c - 1]);
  }
  __syncthreads();

  if (warp == 0) {
    const int last = min(max(nv - 1, 0), N - 1);
    float best;
    int arg;
    row_argmax(cur + last * L, ps + last * L, L, lane, best, arg);
    if (lane == 0) {
      score_out[b] = best;
      best_l_out[b] = arg;
      walk(tab, bps_b, K, N, kv, nv, arg, pos + (size_t)b * K);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int B, int threads, size_t smem, cudaStream_t stream,
                   const float* W, const float* pois, const int* k_valid,
                   const int* n_valid, float* score, int* best_l, int* bps, long long* pos,
                   float* gstate, int K, int N, int L, int S, int max_len, int table,
                   int staged) {
  if (smem > 48 * 1024) {  // above the default limit: opt in
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, stream>>>(W, pois, k_valid, n_valid, score, best_l, bps, pos,
                                       gstate, K, N, L, S, max_len, table, staged);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t launch_cluster_body(int B, size_t smem, cudaStream_t stream, const float* W,
                                const float* pois, const int* k_valid, const int* n_valid,
                                float* score, int* best_l, int* bps, long long* pos, int K,
                                int N, int L, int S, int max_len, int table, int staged,
                                int cl, int tpr) {
  static bool wide = false;  // clusters above 8 CTAs allowed (once a process)
  if (cl > 8 && !wide) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_cluster_kernel<RPT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  return cluster::launch_cluster(viterbi_cluster_kernel<RPT>, dim3(B * cl), dim3(NT), cl, smem,
                                 stream, W, pois, k_valid, n_valid, score, best_l, bps, pos, K,
                                 N, L, S, max_len, table, staged, cl, tpr);
}

}  // namespace

extern "C" size_t mucon_viterbi_smem(int K, int N, int body, int cl, int table, int staged) {
  return viterbi_smem(K, N, body, cl, table, staged);
}

// body: 0 the warp body (N <= 32, L <= 72), 1 the cluster body (a cluster of
// cl CTAs a video, tpr threads a row slice, rpt rows a thread), 2 the global
// body (gstate: its [B, 2, N, L] state); table: 1 keeps the walk's table in
// shared memory; staged: windows of W staged at a time, 1 to KC
// (`cuda.viterbi_plan`)
extern "C" int mucon_dense_viterbi(const float* W, const float* pois,
                                   const int* k_valid, const int* n_valid,
                                   float* score, int* best_l, int* bps, long long* pos,
                                   float* gstate, int B, int K, int N, int L, int S,
                                   int max_len, int body, int cl, int tpr, int rpt, int table,
                                   int staged, cudaStream_t stream) {
  if (B <= 0 || K < 1 || N < 1 || L < 1 || S < 1 || staged < 1 || staged > KC ||
      (table && L > 65536))
    return cudaErrorInvalidValue;
  const size_t smem = viterbi_smem(K, N, body, cl, table, staged);
  if (body == WARP) {
    if (N > 32 || L > LANE_CELLS || gstate) return cudaErrorInvalidValue;
    return launch(viterbi_warp_kernel<LANE_CELLS>, B, 32, smem, stream, W, pois, k_valid,
                  n_valid, score, best_l, bps, pos, gstate, K, N, L, S, max_len, table, staged);
  }
  if (body == GLOBAL) {
    if (!gstate) return cudaErrorInvalidValue;
    return launch(viterbi_global_kernel, B, NT, smem, stream, W, pois, k_valid, n_valid,
                  score, best_l, bps, pos, gstate, K, N, L, S, max_len, table, staged);
  }
  // the cluster body: rows and columns covered, a power-of-two row slice
  if (body != CLUSTER || cl < 1 || cl > MAX_CL || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) ||
      (long long)(NT / tpr) * rpt < N || (long long)cl * tpr * CELLS < L)
    return cudaErrorInvalidValue;
  switch (rpt) {
    case 1:
      return launch_cluster_body<1>(B, smem, stream, W, pois, k_valid, n_valid, score, best_l,
                                    bps, pos, K, N, L, S, max_len, table, staged, cl, tpr);
    case 2:
      return launch_cluster_body<2>(B, smem, stream, W, pois, k_valid, n_valid, score, best_l,
                                    bps, pos, K, N, L, S, max_len, table, staged, cl, tpr);
    case 4:
      return launch_cluster_body<4>(B, smem, stream, W, pois, k_valid, n_valid, score, best_l,
                                    bps, pos, K, N, L, S, max_len, table, staged, cl, tpr);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* mucon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
