// Trainable WaveNet residual stack, forward with activation stash and
// backward sweep, on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU programs of `wavenet_stack_train_v3`
// (mucon_tpu/ops/wavenet_train_pallas_v3.py): `_fwd_kernel_v3` /
// `_fwd_call_v3` (:134, :358), `_sweep_kernel_v3` / `_sweep_call_v3` (:200,
// :449) and the XLA pool glue between them (`_pool2_fwd_xla` :91,
// `_pool2_bwd_xla` :103).  The TPU version groups equal-T layers into one
// program only to fit Mosaic's compile budget; here every launch is one
// layer, and the pool and its gradient routing are fused into the layer
// kernels.  The forward's layer kernel is the eval stack's
// (wavenet_layer.cuh).
//
// Forward, one launch per layer (layer i: t frames, dilation d, dropout mask
// m [B, t, C] or none):
//   h  = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)   -> stash hs
//   u  = mask (m * (h W1 + b1) + x)                 (pooled layer: -> stash)
//   x' = u, or pool2(u) masked at len/2 (max: first of a tie; sum: mean * 2)
// The layer input x is the previous launch's output and stays in memory as
// the stash the sweep reads; nothing else is copied.  The out-projection
// runs as the eval kernel's final_proj launch.  The stashes hs and u hold
// the rows t < len only (the sweep reads no other).
//
// Backward, one `mucon_wavenet_train_sweep` call per layer (last first), four
// kernels:
//   1. dz:  gm = mask (g, or g routed through the pool with the stashed u),
//           dy = gm * m,  dz = (dy W1^T) * nonlin'(h)          (writes dy, dz)
//   2. dx:  g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   3. wgrad partials: dW1 = h^T dy, dW3[k] = shift(x, (k-1) d)^T dz and the
//           bias sums, one CTA per (span of one video's rows, product)
//   4. reduce: the spans' partials summed in (video, span) order.
// The out-projection's sweep is the same call with proj = 1: h = x_fin,
// W1 = Wl, no dropout, and kernel 1's dz is the gradient at x_fin.
//
// Design (the row tile of wavenet_layer.cuh, shared with the eval stack):
//
// * Every product is `mma.sync.m16n8k8` TF32 on hi/lo-split operands, three
//   products per f32 product (mma_tf32.cuh), tiles f32 in shared memory.
//   The forward is `wavenet_layer_kernel` with the stash and the dropout
//   mask.  Kernels 1 and 2 stream their [3C; C] (or [C]) weight rows in
//   chunks through the same 2-deep `cp.async` ring (`tap_loop`), with the
//   same chunk-wise f32 sum, so that the ReLU sides and max-pool routing
//   stay the f32 twin's.  Kernel 3 is A^T B over rows: A's fragments are
//   read transposed from its row-major [rows][C] tile (`load_at_split`),
//   16 warps as 4 x 4 over the C x C output, 32 rows a chunk through a ring
//   of (A, B) tile pairs.
// * nonlin'(h) and the routed gradient happen in the accumulators' layout
//   (rows 2k, 2k + 1 of a pool sit in lanes l, l ^ 4).  The forward writes
//   u from the registers that are pooled, so the sweep's routing compares
//   the pair the forward compared.
// * Padding is skipped: a row tile at or past its video's length writes its
//   zeros (y; g_in; dz of the out-projection, which the next sweep reads)
//   and returns; a weight-gradient span past the length writes no partial,
//   and the reduction skips it.  Tap chunks a whole tile lacks are skipped,
//   and the shifted-row products of kernel 3 walk only the rows whose
//   shifted row exists: what is left out are products of zeros.
// * The grid fills the card at the train batch (B = 8), chosen from the
//   shape (`plan_for`, `mucon_wavenet_train_plan`): the row tile is the
//   largest of 64 and 32 rows that still gives enough CTAs, else 16 (1, 2
//   and 3 CTAs an SM); the span of kernel 3 the largest power of two of at
//   least 32 rows that gives a wave of CTAs.
// * The weight gradients are bitwise repeatable: each partial is one CTA's
//   fixed-order sum over its span, and kernel 4 adds them in a fixed order
//   with no atomics.
//
// Bound: the tensor cores at three TF32 products per f32 product (495 / 3
// TFLOP/s on the H100); per valid row and layer the forward does 8 C^2 f32
// operations and the backward 16 C^2, fewer where a tap's rows do not exist.

#include <cuda_runtime.h>

#include "wavenet_layer.cuh"

namespace {

// The grids a shape should reach on the H100's 132 SMs (`plan_for`).  Sweep
// kernels 1 and 2: two CTAs an SM.  The forward moves four weight blocks
// through every tile, and the weight traffic from L2 (1 / tile rows) costs
// more than idle SMs down to 80 tiles (PERF.md: forced tiles, timed a layer
// at a time).  Kernel 3 holds an SM a CTA: one wave, and no more partials
// than that.
constexpr int ROW_CTAS = 2 * 132, FWD_CTAS = 80, SPAN_CTAS = 132;
constexpr int KR = 32;                  // rows per chunk of kernel 3
constexpr int WG_NT = 512;              // threads of kernel 3: 16 warps of 32 x 32
constexpr int WG_SMEM = 2 * 2 * KR * LDW * 4;  // ring of two (A, B) chunk pairs
constexpr int PART_F = (C + 1) * C;     // one partial: C x C, then the bias row

// nonlin'(z) from h = nonlin(z): both keep the sign of z
__device__ __forceinline__ float nonlin_grad(float h, int leaky) {
  return h > 0.f ? 1.f : (leaky ? 0.01f : 0.f);
}

// The gradient at a layer's (masked) output, row t of video b, channels
// col, col + 1: g itself, or for a pooled layer g_half [B, t/2, C] routed
// through the pool: max sends it to the first maximum of the pair in the
// stashed pre-pool u (torch max_pool1d), sum ("mean * 2") to both; an odd
// trailing frame, and a pair the forward masked (t/2 >= len/2), get 0.
// Zero at t >= len.
__device__ __forceinline__ float2 grad_at(const float* __restrict__ g,
                                          const float* __restrict__ u, int b, int t, int T,
                                          int len, int col, int pooled, int pool_mean) {
  if (t >= len) return make_float2(0.f, 0.f);
  if (!pooled) return ld2(g + ((size_t)b * T + t) * C + col);
  const int T2 = T / 2, j = t >> 1;
  if (j >= T2 || j >= (len >> 1)) return make_float2(0.f, 0.f);
  const float2 gv = ld2(g + ((size_t)b * T2 + j) * C + col);
  if (pool_mean) return gv;
  const float2 u0 = ld2(u + ((size_t)b * T + 2 * j) * C + col);
  const float2 u1 = ld2(u + ((size_t)b * T + 2 * j + 1) * C + col);
  if (t & 1) return make_float2(u1.x > u0.x ? gv.x : 0.f, u1.y > u0.y ? gv.y : 0.f);
  return make_float2(u1.x > u0.x ? 0.f : gv.x, u1.y > u0.y ? 0.f : gv.y);
}

// ---------------------------------------------------------------------------
// sweep 1: dy = gm * m, dz = (dy W1^T) * nonlin'(h), masked
// ---------------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(NT, Tile<TM>::MIN_BLOCKS) sweep_dz_kernel(
    const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ h,      // [B, T, C] nonlin(z) (proj: x_fin)
    const float* __restrict__ drop,   // [B, T, C] or null
    const int* __restrict__ lengths,
    const float* __restrict__ w1t,    // [C, C] = W1^T
    float* __restrict__ dy, float* __restrict__ dz,
    int T, int len_shift, int pooled, int pool_mean, int leaky, int proj) {
  using TL = Tile<TM>;
  extern __shared__ float4 smem4[];
  float* Ds = reinterpret_cast<float*>(smem4);  // [TM][LDA] dy tile
  float* Wr = Ds + TL::TILE_F;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {  // the out-projection's dz is the next sweep's g: zeros
    if (proj) store_zeros(dz, b, t0, TM, T);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);
  const int lim = min(T, len);

  // the dy tile: every load issued before the first store
  constexpr int PER = TM * (C / 2) / NT;  // column pairs a thread
  float2 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NT, t = t0 + i / (C / 2), col = 2 * (i % (C / 2));
    v[k] = make_float2(0.f, 0.f);
    if (t < lim) {
      v[k] = grad_at(g, u, b, t, T, len, col, pooled, pool_mean);
      if (drop) {
        const float2 m = ld2(drop + ((size_t)b * T + t) * C + col);
        v[k] = make_float2(v[k].x * m.x, v[k].y * m.y);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NT, r = i / (C / 2), col = 2 * (i % (C / 2));
    if (t0 + r < lim) st2(dy + ((size_t)b * T + t0 + r) * C + col, v[k].x, v[k].y);
    st2(Ds + r * LDA + col, v[k].x, v[k].y);
  }

  float acc[TL::MT][TL::NTL][4] = {};
  float* const tiles[3] = {Ds, Ds, Ds};
  const float* const ws[4] = {nullptr, w1t, nullptr, nullptr};  // one block, as a centre tap
  tap_loop<TM>(acc, tiles, ws, false, false, Wr, row0, col0, lane, [](auto&) {});
  // * nonlin'(h), masked: every load issued before the first store
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    const float2 hv = t < lim ? ld2(h + ((size_t)b * T + t) * C + col) : make_float2(0.f, 0.f);
    v0 = t < lim ? v0 * nonlin_grad(hv.x, leaky) : 0.f;
    v1 = t < lim ? v1 * nonlin_grad(hv.y, leaky) : 0.f;
  });
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    if (t0 + row < T) st2(dz + ((size_t)b * T + t0 + row) * C + col, v0, v1);
  });
}

// ---------------------------------------------------------------------------
// sweep 2: g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
// ---------------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(NT, Tile<TM>::MIN_BLOCKS) sweep_dx_kernel(
    const float* __restrict__ dz, const float* __restrict__ g,
    const float* __restrict__ u, const int* __restrict__ lengths,
    const float* __restrict__ w3t,    // [3, C, C]: W3[k]^T
    float* __restrict__ g_in, int T, int d, int len_shift, int pooled, int pool_mean) {
  using TL = Tile<TM>;
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // dz[t+d]
  float* XC = X0 + TL::TILE_F;                   // dz[t]
  float* X1 = XC + TL::TILE_F;                   // dz[t-d]
  float* Wr = X1 + TL::TILE_F;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    store_zeros(g_in, b, t0, TM, T);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);
  const float* zb = dz + (size_t)b * T * C;
  const int lim = min(T, len);
  const bool first = t0 + d < lim, last = t0 + TM > d;  // some row has dz[t+d], dz[t-d]

  if (first) stage_rows<TM>(X0, zb, t0 + d, lim);
  stage_rows<TM>(XC, zb, t0, lim);
  if (last) stage_rows<TM>(X1, zb, t0 - d, lim);

  float acc[TL::MT][TL::NTL][4] = {};
  float* const taps[3] = {X0, XC, X1};
  const float* const ws[4] = {w3t, w3t + C * C, w3t + 2 * C * C, nullptr};
  tap_loop<TM>(acc, taps, ws, first, last, Wr, row0, col0, lane, [](auto&) {});
  // + gm, masked: every load issued before the first store
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    const float2 gm = t < lim ? grad_at(g, u, b, t, T, len, col, pooled, pool_mean)
                              : make_float2(0.f, 0.f);
    v0 = t < lim ? v0 + gm.x : 0.f;
    v1 = t < lim ? v1 + gm.y : 0.f;
  });
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    if (t0 + row < T) st2(g_in + ((size_t)b * T + t0 + row) * C + col, v0, v1);
  });
}

// ---------------------------------------------------------------------------
// sweep 3 + 4: weight gradients, partials per row span, then a fixed-order sum
// ---------------------------------------------------------------------------

// Job j of a layer: (A, row offset, B) with dW_j = sum_rows A[row + off]^T B[row]
//   0: (h, 0, dy) -> dW1, db1     1: (x, -d, dz) -> dW3[0]
//   2: (x, 0, dz) -> dW3[1], db3  3: (x, +d, dz) -> dW3[2]
// proj (one job): (nonlin(x_fin), 0, dy) -> dWl, dbl.
// CTA (span s, video b, job): rows [s span, (s + 1) span) of video b below its
// length; work[b][s][job] = [C + 1][C], row C the column sums of B.
__global__ void __launch_bounds__(WG_NT, 1) sweep_wgrad_kernel(
    const float* __restrict__ h, const float* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const int* __restrict__ lengths, float* __restrict__ work, int T, int span, int d,
    int len_shift, int proj, int leaky) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [2][A, B][KR][LDW]

  const int s = blockIdx.x, b = blockIdx.y, job = blockIdx.z;
  const int len = min(T, lengths[b] >> len_shift);
  const int r_lo = s * span;
  if (r_lo >= len) return;  // padding: no partial, the sum skips this span
  const int r_hi = min(r_lo + span, len);
  const float* A = (job == 0 ? h : x) + (size_t)b * T * C;  // proj: h = x_fin, A = nonlin(x_fin)
  const float* Bm = (job == 0 ? dy : dz) + (size_t)b * T * C;
  const int off = (job == 1) ? -d : (job == 3 ? d : 0);
  // the rows whose shifted row exists (the others add products of zeros;
  // jobs 1 and 3 keep no bias sum)
  const int a_lo = max(r_lo, -off), a_hi = min(r_hi, len - off);
  const int chunks = a_lo < a_hi ? (a_hi - a_lo + KR - 1) / KR : 0;

  auto stage = [&](int buf, int r0) {
    float* As = ring + buf * 2 * KR * LDW;
    float* Bs = As + KR * LDW;
    for (int i = threadIdx.x; i < KR * (C / 4); i += WG_NT) {
      const int rr = i / (C / 4), c4 = i % (C / 4);
      const int t = r0 + rr;
      const bool ok = t < a_hi;
      cp_async16(Bs + rr * LDW + 4 * c4, Bm + (size_t)(ok ? t : 0) * C + 4 * c4, ok);
      const float* src = A + (size_t)(ok ? t + off : 0) * C + 4 * c4;
      if (proj) {
        float4 a = ok ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.f, 0.f, 0.f, 0.f);
        a = make_float4(nonlin(a.x, leaky), nonlin(a.y, leaky), nonlin(a.z, leaky),
                        nonlin(a.w, leaky));
        *reinterpret_cast<float4*>(As + rr * LDW + 4 * c4) = a;
      } else {
        cp_async16(As + rr * LDW + 4 * c4, src, ok);
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp >> 2) * 32, n0 = (warp & 3) * 32;  // 4 x 4 warps
  float acc[2][4][4] = {};
  float bsum = 0.f;
  if (chunks) stage(0, a_lo);
  cp_async_commit();
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i landed for every thread; chunk i - 1 consumed
    if (i + 1 < chunks) stage((i + 1) & 1, a_lo + (i + 1) * KR);
    cp_async_commit();
    const float* As = ring + (i & 1) * 2 * KR * LDW;
    const float* Bs = As + KR * LDW;
    if (threadIdx.x < C)
      for (int rr = 0; rr < KR; ++rr) bsum += Bs[rr * LDW + threadIdx.x];
    warp_gemm<2, 4, KR, true>(acc, As, LDW, m0, 0, Bs, LDW, n0, lane);
  }
  float* out = work + ((size_t)(b * gridDim.x + s) * gridDim.z + job) * PART_F;
  for_each_pair(acc, m0, n0, lane, [&](float& v0, float& v1, int row, int col) {
    st2(out + (size_t)row * C + col, v0, v1);
  });
  if (threadIdx.x < C) out[(size_t)C * C + threadIdx.x] = bsum;
}

__global__ void sweep_reduce_kernel(const float* __restrict__ work,
                                    const int* __restrict__ lengths, int B, int T, int span,
                                    int spans, int len_shift, int jobs,
                                    float* __restrict__ dw1, float* __restrict__ db1,
                                    float* __restrict__ dw3, float* __restrict__ db3) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= jobs * PART_F) return;
  const int job = e / PART_F, k = e % PART_F;
  const size_t stride = (size_t)jobs * PART_F;  // from one span's partial to the next
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const int n = (min(T, lengths[b] >> len_shift) + span - 1) / span;  // spans with rows
    const float* p = work + (size_t)b * spans * stride + (size_t)job * PART_F + k;
    int sp = 0;
    for (; sp + 8 <= n; sp += 8) {  // eight loads in flight, added in span order
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = p[(sp + i) * stride];
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
    for (; sp < n; ++sp) s += p[sp * stride];
  }
  if (k < C * C) {
    if (job == 0) dw1[k] = s;
    else dw3[(size_t)(job - 1) * C * C + k] = s;
  } else if (job == 0) {
    db1[k - C * C] = s;
  } else if (job == 2) {
    db3[k - C * C] = s;
  }
}

struct Plan {
  int fwd_tm, tm, span, spans;
};

// the largest of 64 and 32 rows a tile that still gives `ctas` tiles, else 16
int tile_for(int B, int T, int ctas) {
  for (int tm = 64; tm >= 32; tm /= 2)
    if ((long)B * ((T + tm - 1) / tm) >= ctas) return tm;
  return 16;
}

// The grid of a layer of B videos x T frames, from the shape alone: the row
// tile of the forward (FWD_CTAS) and of sweep kernels 1 and 2 (ROW_CTAS),
// and the row span of kernel 3: the largest power of two of at least 32
// rows with SPAN_CTAS CTAs over `jobs` products, and the spans a video.
Plan plan_for(int B, int T, int jobs) {
  Plan p{tile_for(B, T, FWD_CTAS), tile_for(B, T, ROW_CTAS), 32, 0};
  int top = 32;
  while (top < T) top *= 2;
  for (int s = top; s >= 32; s /= 2)
    if ((long)B * ((T + s - 1) / s) * jobs >= SPAN_CTAS) {
      p.span = s;
      break;
    }
  p.spans = (T + p.span - 1) / p.span;
  return p;
}

// sweep kernels 1 and 2 (kernel 2 not for the out-projection)
template <int TM>
cudaError_t launch_rows(const float* g, const float* u, const float* h, const float* drop,
                        const int* lengths, const float* w1t, const float* w3t, float* dy,
                        float* dz, float* g_in, int B, int T, int d, int len_shift, int pooled,
                        int pool_mean, int leaky, int proj, cudaStream_t stream) {
  using TL = Tile<TM>;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_dz_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::ONE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_dx_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TL::TAPS_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 tiles((T + TM - 1) / TM, B);
  sweep_dz_kernel<TM><<<tiles, NT, TL::ONE_SMEM, stream>>>(
      g, u, h, drop, lengths, w1t, dy, dz, T, len_shift, pooled, pool_mean, leaky, proj);
  err = cudaGetLastError();
  if (err != cudaSuccess || proj) return err;
  sweep_dx_kernel<TM><<<tiles, NT, TL::TAPS_SMEM, stream>>>(dz, g, u, lengths, w3t, g_in, T, d,
                                                           len_shift, pooled, pool_mean);
  return cudaGetLastError();
}

}  // namespace

// The grid a layer of B videos x T frames takes (see `plan_for`):
// out = {forward row tile, sweep row tile, weight-gradient span, spans a
// video}.  The sweep's `work`
// holds B * spans * jobs * (C + 1) * C floats (jobs = 4, or 1 for the
// out-projection).
extern "C" int mucon_wavenet_train_plan(int B, int T, int jobs, int* out) {
  if (B <= 0 || T <= 0 || jobs <= 0) return cudaErrorInvalidValue;
  const Plan p = plan_for(B, T, jobs);
  out[0] = p.fwd_tm;
  out[1] = p.tm;
  out[2] = p.span;
  out[3] = p.spans;
  return cudaSuccess;
}

// One layer of the stack's forward (see the top of the file).  `u_out` is
// written only when pool = 1; `drop` may be null (no dropout).  An odd T
// pools to T / 2 (the last frame is dropped).
extern "C" int mucon_wavenet_train_fwd(const float* x, float* y, float* u_out,
                                       float* hs, const int* lengths,
                                       const float* w3, const float* b3,
                                       const float* w1, const float* b1,
                                       const float* drop, int B, int T, int channels,
                                       int d, int len_shift, int pool, int pool_mean,
                                       int leaky, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && !u_out)) return cudaErrorInvalidValue;
  switch (plan_for(B, T, 4).fwd_tm) {
    case 64:
      return launch_layer<64>(x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, B, T, d,
                              len_shift, pool, pool_mean, leaky, stream);
    case 32:
      return launch_layer<32>(x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, B, T, d,
                              len_shift, pool, pool_mean, leaky, stream);
    default:
      return launch_layer<16>(x, y, u_out, hs, lengths, w3, b3, w1, b1, drop, B, T, d,
                              len_shift, pool, pool_mean, leaky, stream);
  }
}

// One layer of the backward sweep (proj = 0) or the out-projection's
// (proj = 1: h = x = x_fin, w1t = Wl^T, drop = null, w3t / g_in / dw3 / db3
// unused, and dz receives the gradient at x_fin).  g is [B, T/2, C] when
// pooled = 1 (the layer pooled; u is its pre-pool output), else [B, T, C].
// `work` is sized by `mucon_wavenet_train_plan`.
extern "C" int mucon_wavenet_train_sweep(
    const float* g, const float* u, const float* x, const float* h,
    const float* drop, const int* lengths, const float* w1t, const float* w3t,
    float* dy, float* dz, float* g_in, float* work, float* dw1, float* db1,
    float* dw3, float* db3, int B, int T, int channels, int d, int len_shift,
    int pooled, int pool_mean, int leaky, int proj, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pooled && !u) || (proj && pooled))
    return cudaErrorInvalidValue;
  const int jobs = proj ? 1 : 4;
  const Plan p = plan_for(B, T, jobs);
  cudaError_t err;
  switch (p.tm) {
    case 64:
      err = launch_rows<64>(g, u, h, drop, lengths, w1t, w3t, dy, dz, g_in, B, T, d, len_shift,
                            pooled, pool_mean, leaky, proj, stream);
      break;
    case 32:
      err = launch_rows<32>(g, u, h, drop, lengths, w1t, w3t, dy, dz, g_in, B, T, d, len_shift,
                            pooled, pool_mean, leaky, proj, stream);
      break;
    default:
      err = launch_rows<16>(g, u, h, drop, lengths, w1t, w3t, dy, dz, g_in, B, T, d, len_shift,
                            pooled, pool_mean, leaky, proj, stream);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WG_SMEM);
  if (err != cudaSuccess) return err;
  sweep_wgrad_kernel<<<dim3(p.spans, B, jobs), WG_NT, WG_SMEM, stream>>>(
      h, x, dy, dz, lengths, work, T, p.span, d, len_shift, proj, leaky);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = jobs * PART_F;
  sweep_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(work, lengths, B, T, p.span, p.spans,
                                                          len_shift, jobs, dw1, db1, dw3, db3);
  return cudaGetLastError();
}
