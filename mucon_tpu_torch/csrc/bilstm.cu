// Two-direction masked LSTM recurrence as one persistent kernel, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bilstm_kernel` / `bilstm_recurrence_pallas`
// (mucon_tpu/ops/lstm_pallas.py:33, :90), which held w_hh, xp and the state in
// VMEM and ran the time loop in-kernel.  Here the grid is 2 directions x
// ceil(B / BT) batch tiles; each CTA runs the whole T loop for its tile with
// h, c and the [BT x 4H] gate scratch in shared memory (24 KiB at H = 128).
//
//   gates = xp[t, dir, b] + h @ w_hh[dir]          (b_ih, b_hh folded in xp)
//   i, f, o = sigmoid, g = tanh;  c' = f c + i g;  h' = o tanh(c')
//   h = m h' + (1 - m) h,  c = m c' + (1 - m) c    (state freezes where m = 0)
//   outs[t, dir, b] = h                            (written every step)
//
// Bound: the sequential chain.  w_hh per direction (128 x 512 f32 = 256 KiB)
// exceeds shared memory, so every step reads it from global memory, where it
// stays resident in L2; one thread per gate column reads it coalesced and
// reuses each value for the BT rows of its tile.  A cluster / DSMEM split of
// w_hh is later work.
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
//    gates = xp[t] + h_prev w_hh, i, f, o = sigmoid, g = tanh,
//    tc = tanh(f c_prev + i g), and writes the six factors of the chain with
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
//    is too small to split.
//
// The w_hh gradient (a sum over T of h_prev^T dgate) is left to the caller,
// as the JAX package leaves it to XLA.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

constexpr int BT = 8;  // batch rows per CTA

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void bilstm_kernel(const float* __restrict__ xp,    // [T, 2, B, 4H]
                              const float* __restrict__ m,     // [T, B]
                              const float* __restrict__ w_hh,  // [2, H, 4H]
                              float* __restrict__ outs,        // [T, 2, B, H]
                              float* __restrict__ h_fin,       // [2, B, H]
                              float* __restrict__ c_fin,       // [2, B, H]
                              float* __restrict__ cs_out,      // [T, 2, B, H] or null
                              int T, int B, int H) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* hs = sm;           // [BT][H]
  float* cs = hs + BT * H;  // [BT][H]
  float* gs = cs + BT * H;  // [BT][G]

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const float* w = w_hh + (size_t)dir * H * G;

  for (int i = threadIdx.x; i < 2 * BT * H; i += blockDim.x) sm[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* xpt = xp + (((size_t)t * 2 + dir) * B + b0) * G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float wv = __ldg(w + (size_t)k * G + g);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(hs[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (r < nb) gs[r * G + g] = xpt[(size_t)r * G + g] + acc[r];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int r = i / H, j = i - r * H;
      const float* gr = gs + r * G;
      const float ig = sigmoidf(gr[j]);
      const float fg = sigmoidf(gr[H + j]);
      const float gg = tanhf(gr[2 * H + j]);
      const float og = sigmoidf(gr[3 * H + j]);
      const float c_new = fg * cs[i] + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float mt = m[(size_t)t * B + b0 + r];
      const float h = mt * h_new + (1.f - mt) * hs[i];
      cs[i] = mt * c_new + (1.f - mt) * cs[i];
      hs[i] = h;
      const size_t o = (((size_t)t * 2 + dir) * B + b0 + r) * H + j;
      outs[o] = h;
      if (cs_out) cs_out[o] = cs[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int r = i / H, j = i - r * H;
    h_fin[((size_t)dir * B + b0 + r) * H + j] = hs[i];
    c_fin[((size_t)dir * B + b0 + r) * H + j] = cs[i];
  }
}

constexpr int RB = 8;     // (t, b) rows per CTA of the coefficient pass
constexpr int NTC = 256;  // threads per CTA of the chain

// The chain's six factors for every (t, dir, b, j) at once: a tiled
// [T B x H] x [H x 4H] product per direction (each thread the four gate
// columns of one j for RB rows), then the activations.  Same arithmetic and
// order as the forward kernel's step, so the replayed gates are its gates.
__global__ void bilstm_coefs_kernel(const float* __restrict__ xp,    // [T, 2, B, 4H]
                                    const float* __restrict__ m,     // [T, B]
                                    const float* __restrict__ w_hh,  // [2, H, 4H]
                                    const float* __restrict__ outs,  // [T, 2, B, H]
                                    const float* __restrict__ cs,    // [T, 2, B, H]
                                    float* __restrict__ coefs,       // [6, T, 2, B, H]
                                    int T, int B, int H) {
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
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
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
    for (int r = 0; r < RB; ++r) {
      const int row = row_first + r;
      if (row >= rows) break;
      const int t = row / B, bb = row - t * B;
      const size_t o = (((size_t)t * 2 + dir) * B + bb) * H + j;
      const float* xr = xp + (((size_t)t * 2 + dir) * B + bb) * G;
      const float ig = sigmoidf(xr[j] + acc[r][0]);
      const float fg = sigmoidf(xr[H + j] + acc[r][1]);
      const float gg = tanhf(xr[2 * H + j] + acc[r][2]);
      const float og = sigmoidf(xr[3 * H + j] + acc[r][3]);
      const float c_prev = t > 0 ? cs[o - (size_t)2 * B * H] : 0.f;
      const float tc = tanhf(fg * c_prev + ig * gg);
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

// How the chain splits a hidden size H over a cluster: CL CTAs of HS = H / CL
// columns; NQ = NTC / HS thread groups of GPQ gate rows each (a multiple of
// 4, at most 128: the weights a thread keeps in registers).
struct ChainPlan {
  int cl, hs, nq, gpq;
};

bool chain_plan(int H, ChainPlan& p) {
  p.cl = 1;
  for (int c = 8; c > 1; c /= 2)
    if (H % c == 0 && H / c >= 16) {
      p.cl = c;
      break;
    }
  p.hs = H / p.cl;
  if (H <= 0 || BT * p.hs > NTC) return false;  // one thread per (video, column)
  p.nq = NTC / p.hs;
  p.gpq = ((4 * H + p.nq - 1) / p.nq + 3) & ~3;
  return p.gpq <= 128;
}

// One cluster per (direction, batch tile); grid (CL, tiles, 2), cluster (CL, 1, 1).
template <int WPT>  // weights per thread: >= gpq
__global__ void __launch_bounds__(NTC) bilstm_chain_kernel(
    const float* __restrict__ coefs,   // [6, T, 2, B, H]
    const float* __restrict__ m,       // [T, B]
    const float* __restrict__ w_hh,    // [2, H, 4H]
    const float* __restrict__ douts,   // [T, 2, B, H]
    const float* __restrict__ dh_fin,  // [2, B, H]
    const float* __restrict__ dc_fin,  // [2, B, H]
    float* __restrict__ dxp,           // [T, 2, B, 4H]
    int T, int B, int H, int hs, int nq, int gpq) {
  extern __shared__ float4 sm4[];
  const int G = 4 * H;
  float* dg = reinterpret_cast<float*>(sm4);  // [2][BT][G] dgate of a step, all columns
  float* red = dg + 2 * BT * G;                // [nq][BT][hs] partial sums

  const int cl = gridDim.x;
  const int j0 = cluster::cluster_rank() * hs;
  const int b0 = blockIdx.y * BT;
  const int dir = blockIdx.z;
  const int tid = threadIdx.x;

  // product role: gate rows [g0, g1) of column j0 + pj, weights in registers
  const bool prod = tid < nq * hs;
  const int pj = tid % hs, kq = tid / hs;
  const int g0 = kq * gpq, g1 = min(G, g0 + gpq);
  float wreg[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i)
    wreg[i] = (prod && g0 + i < g1) ? w_hh[((size_t)dir * H + j0 + pj) * G + g0 + i] : 0.f;

  // element role: (dh, dc) of video b0 + eb, column j0 + ej
  const int eb = tid / hs, ej = tid - eb * hs;
  const int bb = b0 + eb, j = j0 + ej;
  const bool active = tid < BT * hs && bb < B;
  float dh = 0.f, dc = 0.f;
  if (active) {
    dh = dh_fin[((size_t)dir * B + bb) * H + j];
    dc = dc_fin[((size_t)dir * B + bb) * H + j];
  }
  for (int i = tid; i < 2 * BT * G; i += NTC) dg[i] = 0.f;  // rows of absent videos stay 0
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
  if (T < 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  const int G = 4 * H;
  const int threads = G < 1024 ? ((G + 31) / 32) * 32 : 1024;
  const size_t smem = (size_t)(2 * BT * H + BT * G) * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem((const void*)bilstm_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, h_fin, c_fin, cs,
                                                 T, B, H);
  return cudaGetLastError();
}

// The chain's factors coefs [6, T, 2, B, H] (A, Ci, Cf, Cg, Co, F) from the
// stashed trajectory: the parallel pass of the reverse chain.
extern "C" int mucon_bilstm_bwd_coefs(const float* xp, const float* m, const float* w_hh,
                                      const float* outs, const float* cs, float* coefs,
                                      int T, int B, int H, cudaStream_t stream) {
  if (T < 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const int threads = H < 128 ? ((H + 31) / 32) * 32 : 128;
  const size_t smem = (size_t)RB * H * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem((const void*)bilstm_coefs_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T * B + RB - 1) / RB, 2);
  bilstm_coefs_kernel<<<grid, threads, smem, stream>>>(xp, m, w_hh, outs, cs, coefs, T, B, H);
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
  const size_t smem = (size_t)(2 * BT * 4 * H + p.nq * BT * p.hs) * sizeof(float);
  const dim3 grid(p.cl, (B + BT - 1) / BT, 2);
  if (p.gpq <= 32)
    return cluster::launch_cluster(bilstm_chain_kernel<32>, grid, dim3(NTC), p.cl, smem, stream,
                                   coefs, m, w_hh, douts, dh_fin, dc_fin, dxp, T, B, H, p.hs,
                                   p.nq, p.gpq);
  return cluster::launch_cluster(bilstm_chain_kernel<128>, grid, dim3(NTC), p.cl, smem, stream,
                                 coefs, m, w_hh, douts, dh_fin, dc_fin, dxp, T, B, H, p.hs,
                                 p.nq, p.gpq);
}
