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
// Design: one CTA per video (the videos are independent; only the weights are
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
// Reverse step (decoder_pallas.py:160-210) at s = S-1 .. 0: replays the
// forward step from h_in[s] / c_in[s], then runs the (dh, dc) chain with four
// transposed products (dgate Wih^T and dgate Whh^T as one product over the
// transposed copy [Wih; Whh]^T, dcpre Wc2^T, dq Wl2^T) and the attention
// backward (da, dsc, dq), and emits dgate, dcpre, dsc and, at the end, dh0 and
// dc0.  The weight gradients are left to the caller, as the JAX package
// leaves them to XLA.
//
// Bound on this card: 31 dependent steps a video, each a few matrix-vector
// products whose weights come from L2 (about 1 MB a step forward, 2 MB in
// reverse), on B CTAs only: latency, not the card's FLOP or HBM rate.  Each
// product splits its K terms over the thread groups that the block has to
// spare and adds the groups' partial sums in group order; every other sum is
// a warp butterfly or a fixed-order loop.  No atomics: the kernels repeat bit
// for bit.  Accurate expf / tanhf throughout (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

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
__device__ void forward_step(const Chain& ch, const Smem& sm) {
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
      const float c = sigmoidf(g[H + j]) * sm.c[j] + sigmoidf(g[j]) * tanhf(g[2 * H + j]);
      const float h = sigmoidf(g[3 * H + j]) * tanhf(c);
      sm.c[j] = c;
      sm.x2[H + j] = h;
      hs[o + j] = h;
      cs[o + j] = c;
      comb[o + j] = sm.x2[j];
    }
  }
}

__global__ void chain_bwd_kernel(Chain ch, const float* __restrict__ emb,  // [S, B, H]
                                 const float* __restrict__ h_in,          // [S, B, H]
                                 const float* __restrict__ c_in,          // [S, B, H]
                                 const float* __restrict__ wgt,   // [4H, 2H]: [Wih; Whh]^T
                                 const float* __restrict__ wc2t,  // [H, E]: Wc2^T
                                 const float* __restrict__ wl2t,  // [H, H]: Wl2^T
                                 const float* __restrict__ dh_ext,     // [S, B, H]
                                 const float* __restrict__ dc_ext,     // [S, B, H]
                                 const float* __restrict__ dcomb_ext,  // [S, B, H]
                                 float* __restrict__ dgate_out,        // [S, B, 4H]
                                 float* __restrict__ dcpre_out,        // [S, B, H]
                                 float* __restrict__ dsc_out,          // [S, B, Tz]
                                 float* __restrict__ dh0, float* __restrict__ dc0,  // [B, H]
                                 int S, int B) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, H = ch.H, E = ch.E, Tz = ch.Tz;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  ch.enc += (size_t)b * Tz * E;
  ch.pre += (size_t)b * Tz * H;
  ch.maskf += (size_t)b * Tz;
  const Smem sm = carve(smem, H, E, Tz);
  float* dhp = sm.red + blockDim.x;  // [2H]: [dcomb - dcomb_ext; dh_p]
  float* dcpre = dhp + 2 * H;        // [H]
  float* dctx = dcpre + H;           // [E]
  float* dq = dctx + E;              // [H]
  float* dql = dq + H;               // [H]: dq Wl2^T
  float* dh_c = dql + H;             // [H]
  float* dc_c = dh_c + H;            // [H]
  float* da = dc_c + H;              // [Tz]: da, then dsc

  for (int j = threadIdx.x; j < H; j += blockDim.x) dh_c[j] = dc_c[j] = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const size_t o = ((size_t)s * B + b) * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      sm.x1[j] = emb[o + j];
      sm.x2[H + j] = h_in[o + j];
      sm.c[j] = c_in[o + j];
    }
    forward_step(ch, sm);  // replay; ends synchronised
    float* g = sm.gates;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float ig = sigmoidf(g[j]), fg = sigmoidf(g[H + j]);
      const float gg = tanhf(g[2 * H + j]), og = sigmoidf(g[3 * H + j]);
      const float c = sm.c[j];
      const float tc = tanhf(fg * c + ig * gg);
      const float dh = dh_c[j] + dh_ext[o + j];
      const float dct = dh * og * (1.f - tc * tc) + (dc_c[j] + dc_ext[o + j]);
      dc_c[j] = dct * fg;
      g[j] = dct * gg * ig * (1.f - ig);
      g[H + j] = dct * c * fg * (1.f - fg);
      g[2 * H + j] = dct * ig * (1.f - gg * gg);
      g[3 * H + j] = dh * tc * og * (1.f - og);
    }
    __syncthreads();
    float* dgr = dgate_out + ((size_t)s * B + b) * 4 * H;
    for (int k = threadIdx.x; k < 4 * H; k += blockDim.x) dgr[k] = g[k];
    matvec(g, 4 * H, wgt, 2 * H, nullptr, dhp, sm.red);  // [dgate Wih^T; dgate Whh^T]
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float d = sm.cpre[j] > 0.f ? dhp[j] + dcomb_ext[o + j] : 0.f;
      dcpre[j] = d;
      dcpre_out[o + j] = d;
    }
    matvec(dcpre, H, wc2t, E, nullptr, dctx, sm.red);  // dctx = dcpre Wc2^T
    for (int t = warp; t < Tz; t += nw) {               // da = enc dctx
      const float* er = ch.enc + (size_t)t * E;
      float acc = 0.f;
      for (int e = lane; e < E; e += 32) acc = fmaf(dctx[e], er[e], acc);
      acc = warp_sum(acc);
      if (lane == 0) da[t] = acc;
    }
    __syncthreads();
    float ad = 0.f;
    for (int t = threadIdx.x; t < Tz; t += blockDim.x) ad += sm.sc[t] * da[t];
    ad = block_reduce(ad, false, sm.red);
    float* dsr = dsc_out + ((size_t)s * B + b) * Tz;
    for (int t = threadIdx.x; t < Tz; t += blockDim.x) {
      const float d = sm.sc[t] * (da[t] - ad);
      da[t] = d;
      dsr[t] = d;
    }
    __syncthreads();
    {  // dq[j] = v[j] sum_t dsc[t] (1 - u[t, j]^2), the t terms over G groups
      const int G = max(1, (int)blockDim.x / H);
      const int chunk = (Tz + G - 1) / G;
      for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
        const int gi = i / H, j = i - gi * H;
        const int t1 = min(Tz, (gi + 1) * chunk);
        const float qj = sm.q[j];
        float acc = 0.f;
        for (int t = gi * chunk; t < t1; ++t) {
          const float u = tanhf(ch.pre[(size_t)t * H + j] + qj);
          acc = fmaf(da[t], 1.f - u * u, acc);
        }
        sm.red[i] = acc;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float acc = 0.f;
        for (int gi = 0; gi < G; ++gi) acc += sm.red[gi * H + j];
        dq[j] = __ldg(ch.v + j) * acc;
      }
    }
    matvec(dq, H, wl2t, H, nullptr, dql, sm.red);  // dq Wl2^T
    for (int j = threadIdx.x; j < H; j += blockDim.x) dh_c[j] = dhp[H + j] + dql[j];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    dh0[(size_t)b * H + j] = dh_c[j];
    dc0[(size_t)b * H + j] = dc_c[j];
  }
}

int threads_for(int H, int E) {
  const int n = max(4 * H, E);
  return max(64, (n + 31) / 32 * 32);
}

size_t fwd_smem(int H, int E, int Tz, int threads) {
  return (size_t)((H + E) + 2 * H + 3 * H + 4 * H + Tz + threads) * sizeof(float);
}

size_t bwd_smem(int H, int E, int Tz, int threads) {
  return fwd_smem(H, E, Tz, threads) + (size_t)(2 * H + H + E + 4 * H + Tz) * sizeof(float);
}

int launch_setup(const void* fn, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int S, int B, int Tz, int H, int E) {
  return S < 1 || B < 1 || Tz < 1 || H < 1 || E < 1 || threads_for(H, E) > 1024;
}

}  // namespace

// Bytes of shared memory the reverse kernel (the larger) needs; the wrapper
// checks it against the card's limit before it launches.
extern "C" int mucon_decoder_chain_smem(int H, int E, int Tz) {
  return (int)bwd_smem(H, E, Tz, threads_for(H, E));
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

extern "C" int mucon_decoder_chain_bwd(const float* emb, const float* enc, const float* pre,
                                       const float* maskf, const float* h_in,
                                       const float* c_in, const float* wl2, const float* bl2,
                                       const float* v, const float* wcat, const float* bc,
                                       const float* wg, const float* bl, const float* wgt,
                                       const float* wc2t, const float* wl2t,
                                       const float* dh_ext, const float* dc_ext,
                                       const float* dcomb_ext, float* dgate, float* dcpre,
                                       float* dsc, float* dh0, float* dc0, int S, int B,
                                       int Tz, int H, int E, cudaStream_t stream) {
  if (bad_shape(S, B, Tz, H, E)) return cudaErrorInvalidValue;
  const int threads = threads_for(H, E);
  const size_t smem = bwd_smem(H, E, Tz, threads);
  cudaError_t err = (cudaError_t)launch_setup((const void*)chain_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const Chain ch{enc, pre, maskf, wl2, bl2, v, wcat, bc, wg, bl, Tz, H, E};
  chain_bwd_kernel<<<B, threads, smem, stream>>>(ch, emb, h_in, c_in, wgt, wc2t, wl2t,
                                                 dh_ext, dc_ext, dcomb_ext, dgate, dcpre,
                                                 dsc, dh0, dc0, S, B);
  return cudaGetLastError();
}
