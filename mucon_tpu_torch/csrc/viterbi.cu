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
// Bound: the work is ~4 N L operations a window and the bytes a few tens of
// kB a video; what sets the time is the DP's dependent chain.  Walked by
// windows (the scan's order) it is K windows deep; walked by transcript
// positions it is N rows deep.  Three bodies (`cuda.viterbi_plan` routes):
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
// * cluster body (many rows, few cells: e.g. N = 300 at L = 66): a
//   thread-block cluster of CL CTAs a video splits L into CL slices of
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
//   window orders every exchange.  The host picks (CL, TPR, RPT): the
//   fewest rows a thread, then the narrowest cluster, 8 CTAs or fewer
//   before 16.
// * position body (every other shape: long L, e.g. frame_sampling 1-3, few
//   positions, and any N, K, L past the others): the same DP walked by transcript
//   positions.  Row n's cell at window k and length l is
//     entry[n][k-l] + W[k-l+1][n] + ... + W[k][n]   (added left to right)
//   with entry[n][j] = exit[n-1](j-1) + W[j][n-1], so row n depends only on
//   row n-1's exits: the batch runs N row barriers instead of K window
//   steps, and within a row every entry window's running sum is
//   independent.  One 512-thread CTA a video, rows in sequence, two
//   __syncthreads a row (its candidates merged, then its epilogue).
//   - A row: each lane of a warp owns R consecutive entry windows j (a task
//     is a warp's 32 R of them); v = entry[j], then for l = 1 up to the
//     last cell that may grow ((l + 1) S <= max_len) and the last live
//     window: v += W[j + l][n], the scan's adds in the scan's order (no
//     prefix sums).  The candidate v + pois[n][l] belongs to target window
//     j + l.  Tasks are dealt longest first in a snake over the SM's four
//     schedulers.
//   - The diagonal max, deterministic: a lane holds one running (max,
//     argmax) for each of its R targets; after every step the one whose
//     candidates are done moves a lane down (__shfl_down_sync), so each
//     merges its candidates in increasing l (strict >: the first index
//     wins a tie).  What leaves lane 0 is the warp's finished partial for
//     target j0 + l; a warp's ring of 32 flushes them after each block of
//     32 steps by a 64-bit atomicMax in shared memory on a packed key: the
//     float's order-preserving bits high, then 0x7fffffff - l (and -0's
//     sign bit): the largest value wins, on a tie the lowest l.  The order
//     is total, so the result does not depend on the warps' timing.  W and
//     pois come in as vectors of R, loaded one group of R steps ahead.
//   - Cells no entry reaches hold exactly NEG in the scan (NEG + W rounds to
//     NEG for |W| < 2^75: every table of log-probability sums), so their
//     candidates are NEG + pois[l] whatever the window.  Entries before the
//     row's first one that is not exactly NEG (as a rule the first n; at
//     rows n >= n_valid all of them) skip their sweep: their targets take
//     the best of NEG + pois[l] over every l (a reduction by all threads a
//     row).  A later target takes the best over its unreached lengths only
//     where its reached best lies below that (a serial scan, rare: a
//     reachable cell is finite).
//   - Frozen windows: bp rows from k_valid - 1 on repeat the argmaxes of
//     the state at window kend - 1 (kend = clip(k_valid, 1, K)), copied
//     once at the end; the final reads the same state.
//   - Staging: row n's W column (W handed over transposed, [B, N, K]) and
//     pois row sit in shared memory, row n + 1's copied by cp.async (4
//     bytes each, so no alignment asks a padded copy of pois) while row n
//     sweeps.  Where those buffers pass shared memory (K or L of many
//     thousands) they are read where they lie and the entries and keys sit
//     in device scratch (L2-resident); the host says so (`rows`).
//   The host picks R (`entries`: 2 or 4) from K (`cuda._viterbi_entries`).
// Every body makes the same f32 adds and first-index argmaxes as the plain
// DP, so the same bits.
//
// The warp and cluster bodies stage W[b] in shared memory `staged` windows
// at a time (at most KC; fewer where the rest of shared memory leaves less
// room) before the windows that read it (the whole [K, N] block at the
// default shape), so no global load of W sits inside a window.  The warp
// and position bodies keep each window's argmaxes in a uint16 table in
// shared memory for the walk, which reads at most N of them; where the
// table does not fit (K N above ~100k), and in the cluster body (whose
// every CTA would carry rank 0's table), the walk reads the int32
// backpointers written to device memory instead.  The host chooses the
// body and its layout (`cuda.viterbi_plan`) and this file checks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 256;  // threads of the cluster body
constexpr int KC = 128;  // windows of W staged at a time (warp and cluster bodies)
constexpr int LANE_CELLS = 72;  // cells a lane of the warp body holds (LC)
constexpr int CELLS = 16;       // cells of a row a thread of the cluster body holds
constexpr int MAX_CL = 16;      // the widest cluster (above 8: non-portable size)
constexpr int PT = 512;         // threads of the position body
constexpr int PW = PT / 32;     // its warps
constexpr int PSCALARS = 8;     // its per-row scalars, 8 bytes each
constexpr unsigned FULL = 0xffffffffu;

// mucon_dense_viterbi's bodies; the position body has an entry point of its own
enum Body { WARP = 0, CLUSTER = 1 };

// Shared-memory bytes of a warp- or cluster-body launch staging `staged`
// windows of W at a time: the warp body nothing more; the cluster body the
// ranks' [2][cl][N] row maxima and argmaxes and the [2][N] edge column.
// `table` puts the walk's [K-1 x N] uint16 table there too.
size_t viterbi_smem(int K, int N, int body, int cl, int table, int staged) {
  const size_t state = body == CLUSTER ? (size_t)4 * cl * N + 2 * N : 0;
  const size_t floats = (size_t)staged * N + state;
  return floats * sizeof(float) + (table ? (size_t)(K - 1) * N * sizeof(uint16_t) : 0);
}

// The position body's row buffers (floats; `cuda._viterbi_position_layout`):
// W columns padded past the last task's reads (Kp, also the row stride of
// the transposed W), pois rows (Lp), the entries (EB), the keys (KK, even)
__host__ __device__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ int pos_wb(int K, int R) { return round4(K + 34 * R); }
__host__ __device__ int pos_pb(int L, int R) { return round4(L + 2 * R); }
__host__ __device__ int pos_eb(int K, int R) { return round4(K + 32 * R); }
__host__ __device__ int pos_kk(int K) { return K + (K & 1); }

// Shared-memory bytes of a position-body launch: the warps' rings and the
// scalars, with `rows` the keys, the two W columns and pois rows and the
// entries, and with `table` the walk's table
size_t position_smem(int K, int N, int L, int R, int rows, int table) {
  size_t bytes = (size_t)PW * 32 * 8 + PSCALARS * 8;
  if (rows)
    bytes += (size_t)8 * pos_kk(K) +
             (size_t)4 * (2 * pos_wb(K, R) + 2 * pos_pb(L, R) + pos_eb(K, R));
  return bytes + (table ? (size_t)(K - 1) * N * sizeof(uint16_t) : 0);
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
    int K, int N, int L, int S, int max_len, int table, int staged) {
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

// ---- the position body ----------------------------------------------------

// A candidate's key: the float's order-preserving bits high (-0 ordered as
// +0), then 0x7fffffff - l and -0's sign in the low word, so the larger key
// is the larger value and, on a tie, the lower l.  NaN (no candidate) is 0.
__device__ __forceinline__ unsigned long long pos_key(float v, int l) {
  if (v != v) return 0ull;
  unsigned u = __float_as_uint(v);
  const unsigned neg0 = u == 0x80000000u;
  if (neg0) u = 0u;
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | ((unsigned)(0x7fffffff - l) << 1) | neg0;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  const unsigned u = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
  return (key & 1ull) ? -0.0f : __uint_as_float(u);
}

__device__ __forceinline__ int key_arg(unsigned long long key) {
  return 0x7fffffff - (int)((unsigned)key >> 1);
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_key_max(unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) k = key_max(k, __shfl_xor_sync(FULL, k, o));
  return k;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// R consecutive floats from an R-aligned index (one vector load)
template <int R>
__device__ __forceinline__ void load_r(float (&d)[R], const float* s) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
    static_assert(R == 2, "the position body's lanes own 2 or 4 entry windows");
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  }
}

// One group of R steps of a task, l = lg .. lg + R - 1 (lg a multiple of
// R; HEAD: lg = 0, whose first step adds no W; TAIL: the steps past l_last
// skipped).  wb holds W[base + lg ..] (this group's block and the next)
// and pv pois[lg ..], both loaded one group ahead; the group after's are
// loaded first.  Lane 0 keeps each step's outgoing partial in slot[u] of
// its warp's ring.
template <int R, bool HEAD, bool TAIL>
__device__ __forceinline__ void sweep_group(int lg, int l_last, const float* wnext,
                                            const float* pnext, float (&v)[R],
                                            float (&wb)[2 * R], float (&pv)[R], float (&av)[R],
                                            int (&aa)[R], float2* slot, bool lane0, bool top) {
  float nb[R], np[R];
  load_r<R>(nb, wnext);  // W[base + lg + 2R ..] and pois[lg + R ..]: the group after's
  load_r<R>(np, pnext);
  const float none = __int_as_float(0x7fffffff);  // NaN: no candidate
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int l = lg + u;
    if (TAIL && l > l_last) break;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!HEAD || u > 0) v[r] += wb[u + r];
      const float c = v[r] + pv[u];
      const int p = (r + u) % R;
      if (!(c <= av[p])) {  // strict >, and a NaN slot takes its first candidate
        av[p] = c;
        aa[p] = l;
      }
    }
    if (lane0) slot[u] = make_float2(av[u], __int_as_float(aa[u]));
    const float sv = __shfl_down_sync(FULL, av[u], 1);
    aa[u] = __shfl_down_sync(FULL, aa[u], 1);
    av[u] = top ? none : sv;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wb[r] = wb[R + r];
    wb[R + r] = nb[r];
    pv[r] = np[r];
  }
}

// One task of a row: lane t owns the entries base .. base + R - 1 (base =
// j0 + R t) and walks l = 0 .. l_last in blocks of 32 steps.  Its running
// maxima av / aa are indexed physically: at step l, target base + r + l
// sits in slot (r + l) % R, so the slot whose target is done (r = 0, slot
// l % R) moves to the lane below in place and the lane above's takes its
// slot.  Lane 0's outgoing slot is the warp's partial for target j0 + l:
// kept in the warp's ring, flushed after each block.
template <int R>
__device__ __forceinline__ void sweep_task(int j0, int l_last, const float* wcol,
                                           const float* prow, const float* entry,
                                           unsigned long long* keys, float2* ring, int kend,
                                           int lane) {
  const int base = j0 + R * lane;
  const bool lane0 = lane == 0, top = lane == 31;
  float v[R], wb[2 * R], pv[R], av[R];
  int aa[R];
  load_r<R>(v, entry + base);
  float w0[R], w1[R];
  load_r<R>(w0, wcol + base);
  load_r<R>(w1, wcol + base + R);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    wb[r] = w0[r];
    wb[R + r] = w1[r];
  }
  load_r<R>(pv, prow);
#pragma unroll
  for (int p = 0; p < R; ++p) {
    av[p] = __int_as_float(0x7fffffff);  // NaN: no candidate yet
    aa[p] = 0;
  }
  for (int lb = 0; lb <= l_last; lb += 32) {
    const int steps = min(32, l_last - lb + 1);
    const float* w = wcol + base + lb + 2 * R;
    const float* q = prow + lb + R;
    const int full = steps / R;  // groups of R steps; then the tail's
    int g0 = 0;
    if (lb == 0) {
      if (steps >= R)
        sweep_group<R, true, false>(0, l_last, w, q, v, wb, pv, av, aa, ring, lane0, top);
      else
        sweep_group<R, true, true>(0, l_last, w, q, v, wb, pv, av, aa, ring, lane0, top);
      g0 = 1;
    }
    // kept rolled: unrolled, this loop built on the card gave wrong partials
    // at 1 and 2 entry windows a lane (the 4-lane build held)
#pragma unroll 1
    for (int g = g0; g < full; ++g)
      sweep_group<R, false, false>(lb + g * R, l_last, w + g * R, q + g * R, v, wb, pv, av, aa,
                                   ring + g * R, lane0, top);
    if (full * R < steps && full >= g0)
      sweep_group<R, false, true>(lb + full * R, l_last, w + full * R, q + full * R, v, wb, pv,
                                  av, aa, ring + full * R, lane0, top);
    __syncwarp();
    if (lane < steps) {
      const int k = j0 + lb + lane;
      const float2 e = ring[lane];
      const unsigned long long key = pos_key(e.x, __float_as_int(e.y));
      if (k < kend && key) atomicMax(keys + k, key);
    }
    __syncwarp();
  }
  // the maxima still in the lanes: slot p holds target base + l_last + 1 + i
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const int i = ((p - (l_last + 1)) % R + R) % R;
    const int k = base + l_last + 1 + i;
    const unsigned long long key = pos_key(av[p], aa[p]);
    if (k < kend && key) atomicMax(keys + k, key);
  }
}

// The position body (see the head of the file): grid B, PT threads a video.
// Wt [B, N, wstride] the transposed W (rows padded to pos_wb); pois rows
// pstride apart.  ROWS: the row buffers, entries and keys in shared memory;
// else read in place, the entries and keys in gentry / gkeys ([B, pos_eb]
// and [B, pos_kk]).
template <int R, bool ROWS>
__global__ void __launch_bounds__(PT, 1) viterbi_position_kernel(
    const float* __restrict__ Wt, const float* __restrict__ pois,
    const int* __restrict__ k_valid, const int* __restrict__ n_valid,
    float* __restrict__ score_out, int* __restrict__ best_l_out, int* __restrict__ bps,
    long long* __restrict__ pos, float* gentry, unsigned long long* gkeys, int K, int N,
    int L, int wstride, int pstride, int S, int max_len, int table) {
  extern __shared__ __align__(16) unsigned char smraw[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int WB = pos_wb(K, R), PB = pos_pb(L, R), EB = pos_eb(K, R), KK = pos_kk(K);
  unsigned long long* keys;
  float2* rings;
  float *wbuf = nullptr, *pbuf = nullptr, *entry;
  unsigned char* tail;
  if constexpr (ROWS) {
    keys = reinterpret_cast<unsigned long long*>(smraw);
    rings = reinterpret_cast<float2*>(keys + KK);
    unsigned long long* sc = reinterpret_cast<unsigned long long*>(rings + PW * 32);
    wbuf = reinterpret_cast<float*>(sc + PSCALARS);
    pbuf = wbuf + 2 * WB;
    entry = pbuf + 2 * PB;
    tail = reinterpret_cast<unsigned char*>(entry + EB);
  } else {
    keys = gkeys + (size_t)b * KK;
    entry = gentry + (size_t)b * EB;
    rings = reinterpret_cast<float2*>(smraw);
    tail = reinterpret_cast<unsigned char*>(rings + PW * 32) + PSCALARS * 8;
  }
  // per-row scalars by row parity: the best key of NEG + pois[n][l] over
  // every length, the next row's first entry that is not NEG
  unsigned long long* s_ph = reinterpret_cast<unsigned long long*>(rings + PW * 32);
  int* s_js = reinterpret_cast<int*>(s_ph + 2);
  int* s_best = s_js + 2;
  uint16_t* tab = table ? reinterpret_cast<uint16_t*>(tail) : nullptr;
  float2* ring = rings + warp * 32;

  const int kv = k_valid[b], nv = n_valid[b];
  const int kend = min(max(kv, 1), K);             // live windows: 1 .. kend - 1
  const int lmax = min(max(max_len / S - 1, 0), L - 1);  // the last cell that may grow
  const int last = min(max(nv - 1, 0), N - 1);
  const float* Wb = Wt + (size_t)b * N * wstride;
  const float* pb = pois + (size_t)b * N * pstride;
  int* bps_b = bps + (size_t)b * (K - 1) * N;
  const float w00 = Wb[0];

  for (int k = tid; k < kend; k += PT) {
    keys[k] = 0ull;
    entry[k] = k == 0 ? w00 : NEG;  // row 0: window 0 puts (n=0, l=1) at W[0][0]
  }
  if (tid == 0) {
    s_ph[0] = s_ph[1] = 0ull;
    s_js[0] = __float_as_uint(w00) != __float_as_uint(NEG) ? 0 : kend;
    s_js[1] = kend;
  }
  if constexpr (ROWS) {
    for (int i = tid; i < kend; i += PT) cp_async4(wbuf + i, Wb + i);
    for (int i = tid; i < L; i += PT) cp_async4(pbuf + i, pb + i);
    cp_commit();
    cp_wait_all();
  }
  __syncthreads();

  for (int n = 0; n < N; ++n) {
    const int par = n & 1;
    const float* wcol = ROWS ? wbuf + par * WB : Wb + (size_t)n * wstride;
    const float* prow = ROWS ? pbuf + par * PB : pb + (size_t)n * pstride;
    if constexpr (ROWS) {  // row n + 1's column (where it sweeps) and pois row
      if (n + 1 < N) {
        float* wd = wbuf + (par ^ 1) * WB;
        float* pd = pbuf + (par ^ 1) * PB;
        if (n + 1 < nv)
          for (int i = tid; i < kend; i += PT)
            cp_async4(wd + i, Wb + (size_t)(n + 1) * wstride + i);
        for (int i = tid; i < L; i += PT) cp_async4(pd + i, pb + (size_t)(n + 1) * pstride + i);
        cp_commit();
      }
    }
    if (tid == 0) {  // row n + 1's scalars (last read in row n - 1's epilogue)
      s_ph[par ^ 1] = 0ull;
      s_js[par ^ 1] = kend;
    }
    const int js = n < nv ? s_js[par] : kend;  // entries before js are NEG
    {  // the cells no entry reaches: NEG + pois[n][l] at any window
      unsigned long long t = 0;
      for (int l = tid; l < L; l += PT) t = key_max(t, pos_key(NEG + prow[l], l));
      t = warp_key_max(t);
      if (lane == 0 && t) atomicMax(s_ph + par, t);
    }
    if (n == 0 && nv <= 0 && tid == 0)  // row 0 is masked only from window 1 on
      atomicMax(keys, pos_key(w00 + prow[0], 0));
    if (js < kend) {
      // tasks of 32 R entries from js rounded down, longest first; warp w
      // takes them in a snake over the SM's four schedulers (w % 4), then
      // round robin over each scheduler's warps
      const int jb = js - js % (32 * R), ntask = (kend - jb + 32 * R - 1) / (32 * R);
      const int s = warp & 3;
      for (int q = warp >> 2; 4 * q < ntask; q += PW / 4) {
        const int i = 4 * q + ((q & 1) ? 3 - s : s);
        if (i >= ntask) continue;
        const int j0 = jb + 32 * R * i;
        sweep_task<R>(j0, min(lmax, kend - 1 - j0), wcol, prow, entry, keys, ring, kend, lane);
      }
    }
    __syncthreads();  // row n's candidates merged

    // epilogue: exits, backpointers (column n + 1), row n + 1's entries
    const unsigned long long ph = s_ph[par];
    const bool next = n + 1 < nv && n + 1 < N;
    int first = kend;
    for (int k = tid; k < kend; k += PT) {
      unsigned long long key;
      if constexpr (ROWS)
        key = keys[k];
      else  // the atomics' results from L2, past this SM's L1
        key = __ldcg(keys + k);
      if (k < js) {  // every length is unreached (or an entry's that is NEG)
        key = key_max(key, ph);
      } else if ((key >> 32) < (ph >> 32)) {  // then the unreached lengths may win
        for (int l = min(k - js, lmax) + 1; l < L; ++l)
          key = key_max(key, pos_key(NEG + prow[l], l));
      }
      keys[k] = 0ull;
      const float e = key_value(key);
      const int a = key_arg(key);
      if (n + 1 < N && k < K - 1) {
        const size_t at = (size_t)k * N + n + 1;
        if (tab)
          tab[at] = (uint16_t)a;
        else
          bps_b[at] = a;
      }
      if (next && k + 1 < kend) {
        const float en = e + wcol[k + 1];
        entry[k + 1] = en;
        if (__float_as_uint(en) != __float_as_uint(NEG)) first = min(first, k + 1);
      }
      if (n == last && k == kend - 1) {
        score_out[b] = e;
        best_l_out[b] = a;
        *s_best = a;
      }
    }
    if (next) {
      if (tid == 0) entry[0] = NEG;
      first = __reduce_min_sync(FULL, first);
      if (lane == 0 && first < kend) atomicMin(s_js + (par ^ 1), first);
    }
    if constexpr (ROWS) cp_wait_all();
    __syncthreads();  // row n + 1's entries, buffers and scalars in place
  }

  // frozen windows: bp rows kend .. K - 2 repeat row kend - 1; column 0 is 0
  for (int i = tid; i < (K - 1) * N; i += PT) {
    const int r = i / N, c = i - r * N;
    int v;
    if (c == 0)
      v = 0;
    else {
      const size_t at = (size_t)min(r, kend - 1) * N + c;
      v = tab ? (int)tab[at] : bps_b[at];
    }
    if (tab) {
      bps_b[i] = v;
      if (r >= kend || c == 0) tab[i] = (uint16_t)v;
    } else if (r >= kend || c == 0) {
      bps_b[i] = v;
    }
  }
  __syncthreads();  // orders the table's and bps' writes before the walk's reads
  if (tid == 0) walk(tab, bps_b, K, N, kv, nv, *s_best, pos + (size_t)b * K);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int B, int threads, size_t smem, cudaStream_t stream,
                   const float* W, const float* pois, const int* k_valid,
                   const int* n_valid, float* score, int* best_l, int* bps, long long* pos,
                   int K, int N, int L, int S, int max_len, int table, int staged) {
  if (smem > 48 * 1024) {  // above the default limit: opt in
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, stream>>>(W, pois, k_valid, n_valid, score, best_l, bps, pos, K,
                                       N, L, S, max_len, table, staged);
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

template <int R, bool ROWS>
cudaError_t launch_position(int B, size_t smem, cudaStream_t stream, const float* Wt,
                            const float* pois, const int* k_valid, const int* n_valid,
                            float* score, int* best_l, int* bps, long long* pos, float* gentry,
                            unsigned long long* gkeys, int K, int N, int L, int wstride,
                            int pstride, int S, int max_len, int table) {
  auto kernel = viterbi_position_kernel<R, ROWS>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, PT, smem, stream>>>(Wt, pois, k_valid, n_valid, score, best_l, bps, pos, gentry,
                                  gkeys, K, N, L, wstride, pstride, S, max_len, table);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t mucon_viterbi_smem(int K, int N, int body, int cl, int table, int staged) {
  return viterbi_smem(K, N, body, cl, table, staged);
}

// The position body's shared-memory bytes, and its row buffers' floats:
// out = {pos_wb (the transposed W's row stride), pos_pb (pois' row stride
// where the rows are read in place), pos_eb, pos_kk}
extern "C" size_t mucon_viterbi_position_smem(int K, int N, int L, int entries, int rows,
                                              int table, int* out) {
  out[0] = pos_wb(K, entries);
  out[1] = pos_pb(L, entries);
  out[2] = pos_eb(K, entries);
  out[3] = pos_kk(K);
  return position_smem(K, N, L, entries, rows, table);
}

// body: 0 the warp body (N <= 32, L <= 72), 1 the cluster body (a cluster of
// cl CTAs a video, tpr threads a row slice, rpt rows a thread); table: 1
// keeps the walk's table in shared memory; staged: windows of W staged at
// a time, 1 to KC (`cuda.viterbi_plan`)
extern "C" int mucon_dense_viterbi(const float* W, const float* pois,
                                   const int* k_valid, const int* n_valid,
                                   float* score, int* best_l, int* bps, long long* pos,
                                   int B, int K, int N, int L, int S,
                                   int max_len, int body, int cl, int tpr, int rpt, int table,
                                   int staged, cudaStream_t stream) {
  if (B <= 0 || K < 1 || N < 1 || L < 1 || S < 1 || staged < 1 || staged > KC ||
      (table && L > 65536))
    return cudaErrorInvalidValue;
  const size_t smem = viterbi_smem(K, N, body, cl, table, staged);
  if (body == WARP) {
    if (N > 32 || L > LANE_CELLS) return cudaErrorInvalidValue;
    return launch(viterbi_warp_kernel<LANE_CELLS>, B, 32, smem, stream, W, pois, k_valid,
                  n_valid, score, best_l, bps, pos, K, N, L, S, max_len, table, staged);
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

// The position body: Wt [B, N, wstride] (W transposed, wstride =
// pos_wb(K, entries)), pois rows pstride apart; entries (R): 2 or 4;
// gentry / gkeys null: the row buffers, entries and keys in shared memory,
// else the rows read in place (pstride = pos_pb(L, entries), a padded copy)
// and the entries and keys in that scratch ([B, pos_eb] floats, [B, pos_kk]
// 64-bit keys); table: 1 keeps the walk's table in shared memory
extern "C" int mucon_viterbi_position(const float* Wt, const float* pois, const int* k_valid,
                                      const int* n_valid, float* score, int* best_l, int* bps,
                                      long long* pos, float* gentry, unsigned long long* gkeys,
                                      int B, int K, int N, int L, int wstride, int pstride,
                                      int S, int max_len, int entries, int table,
                                      cudaStream_t stream) {
  const int rows = gentry == nullptr;
  if (B <= 0 || K < 1 || N < 1 || L < 1 || S < 1 || (table && L > 65536) ||
      (entries != 2 && entries != 4) || wstride != pos_wb(K, entries) ||
      (rows ? pstride < L : pstride != pos_pb(L, entries)) || (rows != (gkeys == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = position_smem(K, N, L, entries, rows, table);
#define MUCON_POSITION(R, ROWS)                                                              \
  launch_position<R, ROWS>(B, smem, stream, Wt, pois, k_valid, n_valid, score, best_l, bps, \
                           pos, gentry, gkeys, K, N, L, wstride, pstride, S, max_len, table)
  switch (entries * 2 + rows) {
    case 4: return MUCON_POSITION(2, false);
    case 5: return MUCON_POSITION(2, true);
    case 8: return MUCON_POSITION(4, false);
    default: return MUCON_POSITION(4, true);
  }
#undef MUCON_POSITION
}

extern "C" const char* mucon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
