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
// window and the bytes a few tens of kB a video.  Two bodies:
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
// * block body (any other N, L whose state fits): one 256-thread CTA a
//   video with the [N x L] state double-buffered in shared memory (the
//   port's first design, which the chain forward's generic body also kept);
//   its threads stride over the N rows (N above 256 too).
// * global body (the state does not fit a block's shared memory: L = 2000 /
//   frame_sampling at frame_sampling <= 3 and N = 30, or a large N): the
//   block body with its two [N x L] state buffers in device memory (scratch
//   the wrapper allocates, [B, 2, N, L]) and pois read where it lies; the
//   same f32 adds and argmaxes in the same order, so the same bits.
//
// All three stage W[b] in shared memory `staged` windows at a time (at most
// KC; fewer where the block body's state leaves less room) before the
// windows that read it (the whole [K, N] block at the default shape), so no
// global load of W sits inside a window, and keep each window's argmaxes in
// a uint16 table in shared memory for the walk, which reads at most N of
// them; where the table does not fit (K N above ~100k) the walk reads the
// int32 backpointers it wrote to device memory instead.  The host chooses
// the body, the staged windows and the table's place (`cuda.viterbi_plan`)
// and this file checks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 256;  // threads of the block body
constexpr int KC = 128;  // windows of W staged at a time
constexpr int LANE_CELLS = 72;  // cells a lane of the warp body holds (LC)
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory bytes of a launch (lc = 0: block body; glob: its state in
// device memory) staging `staged` windows of W at a time; `table` puts the
// walk's [K-1 x N] uint16 table there too.
size_t viterbi_smem(int K, int N, int L, int lc, int table, int glob, int staged) {
  const size_t state = lc ? 0 : (glob ? (size_t)2 * N : (size_t)3 * N * L + 2 * N);
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

// gstate null: the block body (state in shared memory); else the global
// body, video b's two state buffers at gstate + 2 N L b
__global__ void __launch_bounds__(NT) viterbi_block_kernel(
    const float* __restrict__ W, const float* __restrict__ pois,
    const int* __restrict__ k_valid, const int* __restrict__ n_valid,
    float* __restrict__ score_out, int* __restrict__ best_l_out, int* __restrict__ bps,
    long long* __restrict__ pos, float* gstate, int K, int N, int L, int S, int max_len,
    int table, int staged) {
  extern __shared__ float sm[];
  const int NL = N * L;
  const bool glob = gstate != nullptr;
  float* cur = glob ? gstate + (size_t)2 * NL * blockIdx.x : sm;
  float* nxt = cur + NL;
  const float* ps = glob ? pois + (size_t)blockIdx.x * NL : nxt + NL;
  float* ex_best = glob ? sm : sm + 3 * NL;           // [N]
  int* ex_arg = reinterpret_cast<int*>(ex_best + N);  // [N]
  float* wsm = reinterpret_cast<float*>(ex_arg + N);  // [staged, N]
  uint16_t* tab = table ? reinterpret_cast<uint16_t*>(wsm + staged * N) : nullptr;

  const int b = blockIdx.x;
  const int kv = k_valid[b];
  const int nv = n_valid[b];
  const float* Wb = W + (size_t)b * K * N;
  int* bps_b = bps + (size_t)b * (K - 1) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < NL; i += NT) {
    if (!glob) sm[2 * NL + i] = pois[(size_t)b * NL + i];
    cur[i] = i == 0 ? Wb[0] : NEG;
  }

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

}  // namespace

extern "C" size_t mucon_viterbi_smem(int K, int N, int L, int lc, int table, int glob,
                                     int staged) {
  return viterbi_smem(K, N, L, lc, table, glob, staged);
}

// lc: cells a lane of the warp body holds (72), 0 for the block body;
// gstate: the global body's [B, 2, N, L] state (null: the state in shared
// memory); table: 1 keeps the walk's table in shared memory; staged: windows
// of W staged at a time, 1 to KC (`cuda.viterbi_plan`)
extern "C" int mucon_dense_viterbi(const float* W, const float* pois,
                                   const int* k_valid, const int* n_valid,
                                   float* score, int* best_l, int* bps, long long* pos,
                                   float* gstate, int B, int K, int N, int L, int S,
                                   int max_len, int lc, int table, int staged,
                                   cudaStream_t stream) {
  if (B <= 0 || K < 1 || N < 1 || L < 1 || S < 1 || staged < 1 || staged > KC ||
      (table && L > 65536))
    return cudaErrorInvalidValue;
  const size_t smem = viterbi_smem(K, N, L, lc, table, gstate != nullptr, staged);
  if (lc == 0)
    return launch(viterbi_block_kernel, B, NT, smem, stream, W, pois, k_valid, n_valid,
                  score, best_l, bps, pos, gstate, K, N, L, S, max_len, table, staged);
  if (lc != LANE_CELLS || N > 32 || L > LANE_CELLS || gstate) return cudaErrorInvalidValue;
  return launch(viterbi_warp_kernel<LANE_CELLS>, B, 32, smem, stream, W, pois, k_valid,
                n_valid, score, best_l, bps, pos, gstate, K, N, L, S, max_len, table, staged);
}

extern "C" const char* mucon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
