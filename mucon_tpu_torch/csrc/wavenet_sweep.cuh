// The trainable WaveNet stack's backward sweep, one layer's bodies, on the
// tensor cores of NVIDIA Hopper (sm_90a), and the grid a layer takes.  The
// v3 stack launches each body as a kernel of its own (wavenet_train.cu); the
// v2 stack runs the same bodies inside one cooperative kernel a chunk of
// layers (wavenet_train_v2.cu), so that the two round every product alike.
//
//   dz:     gm = mask (g, or g routed through the pool), dy = gm * m,
//           dz = (dy W1^T) * nonlin'(h)                     (dy, dz to memory)
//   dx:     g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   wgrad:  one span of one video's rows of dW1 = h^T dy, dW3[k] =
//           shift(x, (k-1) d)^T dz and the bias sums: a [C + 1] x C partial
//   reduce: one entry of the gradients, the spans' partials added in
//           (video, span) order
//
// Reads of what a cooperative sweep writes earlier in the same launch (g,
// the routed gm, dy, dz, the partials) go through L2 (`cp.async.cg`,
// `__ldcg`): the read-only path (`__ldg`) is not coherent within a kernel.
//
// Template BF selects the bf16-operand mode of every product (mma_tf32.cuh;
// the JAX sweep's `mm_dtype=bfloat16`, wavenet_train_pallas_v3.py:241-270):
// dy, dz, x, h and the weights rounded to bf16 as their fragments are
// loaded, the sums, the bias sums and the routed gradients f32.
//
// Each source that includes this file gets its own copy of what it uses.

#pragma once

#include "wavenet_layer.cuh"

namespace {

// The grids a shape should reach on the H100's 132 SMs (`plan_for`).  Sweep
// kernels dz and dx: two CTAs an SM.  The forward moves four weight blocks
// through every tile, and the weight traffic from L2 (1 / tile rows) costs
// more than idle SMs down to 80 tiles (PERF.md: forced tiles, timed a layer
// at a time).  The weight-gradient spans: one wave of CTAs, and no more
// partials than that.
constexpr int ROW_CTAS = 2 * 132, FWD_CTAS = 80, SPAN_CTAS = 132;
constexpr int KR = 32;                          // rows a chunk of the weight gradients
constexpr int WB = 128;                         // a weight-gradient block: WB x WB outputs
constexpr int WG_LD = ldw(WB);                  // its staged A and B bands' stride
constexpr int WG_SMEM = 2 * 2 * KR * WG_LD * 4; // ring of two (A, B) chunk pairs

// one partial of a C x C weight gradient: C x C, then the bias row
__host__ __device__ constexpr int part_f(int C) { return (C + 1) * C; }

// nonlin'(z) from h = nonlin(z): both keep the sign of z
__device__ __forceinline__ float nonlin_grad(float h, int leaky) {
  return h > 0.f ? 1.f : (leaky ? 0.01f : 0.f);
}

// two floats through L2 (coherent with what other CTAs wrote before a grid barrier)
__device__ __forceinline__ float2 ld2_l2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

// The gradient at a layer's (masked) output, row t of video b, channels
// col, col + 1: g itself, or for a pooled layer g_half [B, t/2, C] routed
// through the pool: max sends it to the first maximum of the pair in the
// stashed pre-pool u (torch max_pool1d), sum ("mean * 2") to both; an odd
// trailing frame, and a pair the forward masked (t/2 >= len/2), get 0.
// Zero at t >= len.
template <int C>
__device__ __forceinline__ float2 grad_at(const float* g, const float* __restrict__ u, int b,
                                          int t, int T, int len, int col, int pooled,
                                          int pool_mean) {
  if (t >= len) return make_float2(0.f, 0.f);
  if (!pooled) return ld2_l2(g + ((size_t)b * T + t) * C + col);
  const int T2 = T / 2, j = t >> 1;
  if (j >= T2 || j >= (len >> 1)) return make_float2(0.f, 0.f);
  const float2 gv = ld2_l2(g + ((size_t)b * T2 + j) * C + col);
  if (pool_mean) return gv;
  const float2 u0 = ld2(u + ((size_t)b * T + 2 * j) * C + col);
  const float2 u1 = ld2(u + ((size_t)b * T + 2 * j + 1) * C + col);
  if (t & 1) return make_float2(u1.x > u0.x ? gv.x : 0.f, u1.y > u0.y ? gv.y : 0.f);
  return make_float2(u1.x > u0.x ? 0.f : gv.x, u1.y > u0.y ? 0.f : gv.y);
}

// dz = (Ds W1^T) * nonlin'(h), masked, for rows [t0, t0 + TM) of video b:
// Ds the finished dy tile (rows at t >= lim zero), Wr the weight ring (of
// KC-row chunks staged KS rows a buffer: the bodies take a chunk other than
// their tile's default where they must repeat another tile's sums bit for bit)
template <int C, int TM, int KC = Tile<C, TM>::KC, int KS = KC, bool BF = false>
__device__ __forceinline__ void dz_rows(float* Ds, float* Wr, const float* __restrict__ w1t,
                                        const float* __restrict__ h, float* __restrict__ dz,
                                        int b, int t0, int T, int lim, int leaky) {
  using TL = Tile<C, TM, KC, KS>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);
  float acc[TL::MT][TL::NTL][4] = {};
  float* const tiles[3] = {Ds, Ds, Ds};
  const float* const ws[4] = {nullptr, w1t, nullptr, nullptr};  // one block, as a centre tap
  tap_loop<C, TM, KC, KS, BF>(acc, tiles, ws, false, false, Wr, row0, col0, lane, [](auto&) {});
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

// The dz body, rows [t0, t0 + TM) of video b (Tile<C, TM, KC, KS>::ONE_SMEM bytes):
// dy = gm * m, dz = (dy W1^T) * nonlin'(h), masked.  The out-projection's
// (proj = 1: h = x_fin, W1^T = Wl^T, no dropout) writes the gradient at x_fin
// to dz, zeros past the length included: the next layer reads it as its g.
template <int C, int TM, int KC = Tile<C, TM>::KC, int KS = KC, bool BF = false>
__device__ __forceinline__ void dz_tile(const float* g, const float* __restrict__ u,
                                        const float* __restrict__ h,
                                        const float* __restrict__ drop,
                                        const int* __restrict__ lengths,
                                        const float* __restrict__ w1t, float* dy, float* dz,
                                        int b, int t0, int T, int len_shift, int pooled,
                                        int pool_mean, int leaky, int proj, float* smem) {
  using TL = Tile<C, TM, KC, KS>;
  constexpr int LDA = TL::LDA;
  float* Ds = smem;               // [TM][LDA] dy tile
  float* Wr = Ds + TL::TILE_F;

  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {  // the out-projection's dz is the next sweep's g: zeros
    if (proj) store_zeros<C>(dz, b, t0, TM, T);
    return;
  }
  const int lim = min(T, len);

  // the dy tile: every load issued before the first store
  constexpr int PER = TM * (C / 2) / NT;  // column pairs a thread
  float2 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * NT, t = t0 + i / (C / 2), col = 2 * (i % (C / 2));
    v[k] = make_float2(0.f, 0.f);
    if (t < lim) {
      v[k] = grad_at<C>(g, u, b, t, T, len, col, pooled, pool_mean);
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
  dz_rows<C, TM, KC, KS, BF>(Ds, Wr, w1t, h, dz, b, t0, T, lim, leaky);
}

// The dx body, rows [t0, t0 + TM) of video b (Tile<C, TM, KC, KS>::TAPS_SMEM bytes):
// g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
template <int C, int TM, int KC = Tile<C, TM>::KC, int KS = KC, bool BF = false>
__device__ __forceinline__ void dx_tile(const float* dz, const float* g,
                                        const float* __restrict__ u,
                                        const int* __restrict__ lengths,
                                        const float* __restrict__ w3t,  // [3, C, C]: W3[k]^T
                                        float* __restrict__ g_in, int b, int t0, int T, int d,
                                        int len_shift, int pooled, int pool_mean, float* smem) {
  using TL = Tile<C, TM, KC, KS>;
  float* X0 = smem;               // dz[t+d]
  float* XC = X0 + TL::TILE_F;    // dz[t]
  float* X1 = XC + TL::TILE_F;    // dz[t-d]
  float* Wr = X1 + TL::TILE_F;

  const int len = lengths[b] >> len_shift;
  if (t0 >= len) {
    store_zeros<C>(g_in, b, t0, TM, T);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TL::WN) * (16 * TL::MT), col0 = (warp % TL::WN) * (8 * TL::NTL);
  const float* zb = dz + (size_t)b * T * C;
  const int lim = min(T, len);
  const bool first = t0 + d < lim, last = t0 + TM > d;  // some row has dz[t+d], dz[t-d]

  if (first) stage_rows<C, TM>(X0, zb, t0 + d, lim);
  stage_rows<C, TM>(XC, zb, t0, lim);
  if (last) stage_rows<C, TM>(X1, zb, t0 - d, lim);

  float acc[TL::MT][TL::NTL][4] = {};
  float* const taps[3] = {X0, XC, X1};
  const float* const ws[4] = {w3t, w3t + C * C, w3t + 2 * C * C, nullptr};
  tap_loop<C, TM, KC, KS, BF>(acc, taps, ws, first, last, Wr, row0, col0, lane, [](auto&) {});
  // + gm, masked: every load issued before the first store
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    const int t = t0 + row;
    const float2 gm = t < lim ? grad_at<C>(g, u, b, t, T, len, col, pooled, pool_mean)
                              : make_float2(0.f, 0.f);
    v0 = t < lim ? v0 + gm.x : 0.f;
    v1 = t < lim ? v1 + gm.y : 0.f;
  });
  for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
    if (t0 + row < T) st2(g_in + ((size_t)b * T + t0 + row) * C + col, v0, v1);
  });
}

// The weight-gradient body (WG_SMEM bytes), one CTA of NTH threads: job j
// of a layer is (A, row offset, B) with dW_j = sum_rows A[row + off]^T B[row]
//   0: (h, 0, dy) -> dW1, db1     1: (x, -d, dz) -> dW3[0]
//   2: (x, 0, dz) -> dW3[1], db3  3: (x, +d, dz) -> dW3[2]
// proj (one job): (nonlin(x_fin), 0, dy) -> dWl, dbl.
// Span s of video b: rows [s span, (s + 1) span) below its length;
// work[b][s][job] = [C + 1][C], row C the column sums of B.  The C x C
// output is (C / WB)^2 blocks of WB x WB (one at C = 128): block `blk` =
// (bm, bn) takes A's columns bm WB .. and B's columns bn WB .., staged
// WB wide.  A block is 4 x 4 tiles of 32 x 32, a CTA's PARTS-th of them
// (its `part`, a band of output rows; part 0 of a bm = 0 block also sums
// B's columns): 16 warps of one tile, or 8 warps of one (PARTS = 2) or two
// (each its own product).  Each output's sum over rows runs in the same
// order whichever way it is cut.
// CT: the width C (128, 256, 512).
template <int CT, int NTH, int PARTS = 1, bool BF = false>
__device__ __forceinline__ void wgrad_span(const float* __restrict__ h,
                                           const float* __restrict__ x, const float* dy,
                                           const float* dz, const int* __restrict__ lengths,
                                           float* __restrict__ work, int T, int span,
                                           int spans, int jobs, int d, int len_shift, int proj,
                                           int leaky, int s, int b, int job, int part,
                                           int blk, float* ring) {
  const int C = CT;
  constexpr int WARPS = NTH / 32, MB = 16 / (WARPS * PARTS);  // 32-row blocks a warp
  constexpr int LDW = WG_LD;
  const int bm = blk / (C / WB), bn = blk % (C / WB);
  static_assert(WARPS * MB * PARTS == 16, "4 x 4 blocks of 32 x 32 outputs");
  const int len = min(T, lengths[b] >> len_shift);
  const int r_lo = s * span;
  if (r_lo >= len) return;  // padding: no partial, the sum skips this span
  const int r_hi = min(r_lo + span, len);
  // proj: h = x_fin, A = nonlin(x_fin); the block's column bands
  const float* A = (job == 0 ? h : x) + (size_t)b * T * C + bm * WB;
  const float* Bm = (job == 0 ? dy : dz) + (size_t)b * T * C + bn * WB;
  const int off = (job == 1) ? -d : (job == 3 ? d : 0);
  // the rows whose shifted row exists (the others add products of zeros;
  // jobs 1 and 3 keep no bias sum)
  const int a_lo = max(r_lo, -off), a_hi = min(r_hi, len - off);
  const int chunks = a_lo < a_hi ? (a_hi - a_lo + KR - 1) / KR : 0;

  auto stage = [&](int buf, int r0) {
    float* As = ring + buf * 2 * KR * LDW;
    float* Bs = As + KR * LDW;
    for (int i = threadIdx.x; i < KR * (WB / 4); i += NTH) {
      const int rr = i / (WB / 4), c4 = i % (WB / 4);
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
  const int m0 = part * (WB / PARTS) + (warp >> 2) * 32 * MB, n0 = (warp & 3) * 32;
  const bool bias = part == 0 && bm == 0 && threadIdx.x < WB;  // sums B's band's columns
  float acc[MB][2][4][4] = {};
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
    if (bias)
      for (int rr = 0; rr < KR; ++rr) bsum += Bs[rr * LDW + threadIdx.x];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
      warp_gemm<2, 4, KR, true, BF>(acc[mb], As, LDW, m0 + 32 * mb, 0, Bs, LDW, n0, lane);
  }
  float* out = work + ((size_t)(b * spans + s) * jobs + job) * part_f(C);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
    for_each_pair(acc[mb], m0 + 32 * mb, n0, lane, [&](float& v0, float& v1, int row, int col) {
      st2(out + (size_t)(bm * WB + row) * C + bn * WB + col, v0, v1);
    });
  if (bias) out[(size_t)C * C + bn * WB + threadIdx.x] = bsum;
}

// Entry e < jobs * PART_F of a layer's gradients: the spans' partials
// (those with rows) added in (video, span) order.  jobs = 4: dW1 / db1,
// dW3[0..2], db3; jobs = 1 (the out-projection): dw1 = dWl, db1 = dbl.
template <int CT>
__device__ __forceinline__ void reduce_entry(const float* work,
                                             const int* __restrict__ lengths, int B, int T,
                                             int span, int spans, int len_shift, int jobs,
                                             int e, float* __restrict__ dw1,
                                             float* __restrict__ db1, float* __restrict__ dw3,
                                             float* __restrict__ db3) {
  const int C = CT;
  const int PART_F = part_f(C);
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
      for (int i = 0; i < 8; ++i) v[i] = __ldcg(p + (sp + i) * stride);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
    for (; sp < n; ++sp) s += __ldcg(p + sp * stride);
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

// the largest of 64 and 32 rows a tile that fits an SM at C channels
// (`tile_ok`) and still gives `ctas` tiles, else 16
inline int tile_for(int B, int T, int C, int ctas) {
  for (int tm = 64; tm >= 32; tm /= 2)
    if (tile_ok(C, tm) && (long)B * ((T + tm - 1) / tm) >= ctas) return tm;
  return 16;
}

// The grid of a layer of B videos x T frames x C channels, from the shape
// alone: the row tile of the forward (FWD_CTAS) and of the dz and dx bodies
// (ROW_CTAS),
// and the row span of the weight gradients: the largest power of two of at
// least 32 rows with SPAN_CTAS CTAs over `jobs` products, and the spans a
// video.
inline Plan plan_for(int B, int T, int C, int jobs) {
  Plan p{tile_for(B, T, C, FWD_CTAS), tile_for(B, T, C, ROW_CTAS), 32, 0};
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

// The cooperative kernels' shared parts (wavenet_train_v2.cu; the layers a
// chunk holds also wavenet_wgmma_train.cu's): the layers a chunk's argument
// table holds, the grid-stride walk over a pass's items, the grid and the
// launch.
constexpr int MAX_LAYERS = 32;

// items [0, n) in grid-stride order, the shared memory free at each start
template <class F>
__device__ __forceinline__ void grid_items(int n, F f) {
  for (int item = blockIdx.x; item < n; item += gridDim.x) {
    __syncthreads();
    f(item);
  }
}

// CTAs an SM of a cooperative kernel at `smem` bytes, and the SMs
template <typename Kernel>
cudaError_t coop_grid(Kernel kernel, int smem, int* per_sm, int* sms) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, coop = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, smem);
  return err;
}

template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int smem, void* arg, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = coop_grid(kernel, smem, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {arg};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
