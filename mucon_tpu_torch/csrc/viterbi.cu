// Dense single-transcript Viterbi DP, one CTA per video, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_viterbi_batched_kernel` /
// `dense_viterbi_pallas_batched` (mucon_tpu/ops/viterbi_pallas.py:109, :231)
// and the per-video grid `_viterbi_kernel` / `dense_viterbi_pallas` (:47,
// :290).  The batched TPU program laid the whole batch across vector lanes to
// hide its sequential grid; on the card the B videos run as B independent
// CTAs, each with its [N x L] state double-buffered in shared memory and the
// K window loop inside the kernel.  Per window k:
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
// s + pois.
//
// Bound: latency of the K-step chain (two block barriers per window over
// ~2k cells); the work is tiny, so B CTAs cover the card's 132 SMs at B = 128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NT = 256;

// (best, arg) over one row; ties keep the lowest index
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
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
}

__global__ void __launch_bounds__(NT) dense_viterbi_kernel(
    const float* __restrict__ W,        // [B, K, N]
    const float* __restrict__ pois,     // [B, N, L]
    const int* __restrict__ k_valid,    // [B]
    const int* __restrict__ n_valid,    // [B]
    float* __restrict__ score_out,      // [B]
    int* __restrict__ best_l_out,       // [B]
    int* __restrict__ bps,              // [B, K-1, N]
    int K, int N, int L, int S, int max_len) {
  extern __shared__ float sm[];
  const int NL = N * L;
  float* cur = sm;
  float* nxt = cur + NL;
  float* ps = nxt + NL;
  float* ex_best = ps + NL;                              // [N]
  int* ex_arg = reinterpret_cast<int*>(ex_best + N);     // [N]

  const int b = blockIdx.x;
  const int kv = k_valid[b];
  const int nv = n_valid[b];
  const float* Wb = W + (size_t)b * K * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < NL; i += NT) {
    ps[i] = pois[(size_t)b * NL + i];
    cur[i] = i == 0 ? Wb[0] : NEG;  // window 0 puts (n=0, l=1) at W[0][0]
  }
  __syncthreads();

  for (int k = 1; k < K; ++k) {
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
    const float* wk = Wb + (size_t)k * N;
    const bool live = k < kv;
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
      nxt[i] = live ? v : cur[i];
    }
    if (threadIdx.x < N)
      bps[((size_t)b * (K - 1) + (k - 1)) * N + threadIdx.x] =
          threadIdx.x == 0 ? 0 : ex_arg[threadIdx.x - 1];
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (warp == 0) {
    const int last = min(max(nv - 1, 0), N - 1);
    float best;
    int arg;
    row_argmax(cur + last * L, ps + last * L, L, lane, best, arg);
    if (lane == 0) {
      score_out[b] = best;
      best_l_out[b] = arg;
    }
  }
}

}  // namespace

extern "C" int mucon_dense_viterbi(const float* W, const float* pois,
                                   const int* k_valid, const int* n_valid,
                                   float* score, int* best_l, int* bps, int B,
                                   int K, int N, int L, int S, int max_len,
                                   cudaStream_t stream) {
  if (B <= 0 || K < 1 || N < 1 || N > NT || L < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * N * L + 2 * N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dense_viterbi_kernel<<<B, NT, smem, stream>>>(W, pois, k_valid, n_valid, score,
                                                best_l, bps, K, N, L, S, max_len);
  return cudaGetLastError();
}

extern "C" const char* mucon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
