// Trainable WaveNet residual stack, v2: one cooperative kernel per chunk of
// layers, on the tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU programs of `wavenet_stack_train_v2`
// (mucon_tpu/ops/wavenet_train_pallas_v2.py): the forward chunk
// `_fwd_chunk_kernel` / `_fwd_call` (:110, :430) and the backward chunk
// `_sweep_kernel` / `_sweep_call` (:184, :557).  What sets v2 apart from v3
// (wavenet_train.cu, one launch per layer) is kept: ONE launch covers a chunk
// of layers [lo, hi), and the sweep recomputes each pooled layer's pre-pool
// output u from the stash instead of reading a stashed u.
//
// A chunk is one cooperative launch (cudaLaunchCooperativeKernel) of as many
// CTAs as the card holds at once; the CTAs walk the chunk's work items (row
// tiles of one video, or weight-gradient spans) in grid-stride order and
// meet at a grid-wide barrier (cooperative_groups grid.sync()) wherever the
// next step reads rows that other CTAs wrote.  Every item is a body that v3
// launches as a kernel of its own (wavenet_layer.cuh, wavenet_sweep.cuh),
// on v3's weight chunks and weight-gradient spans (`plan_for`).  An output
// element's sum then runs in v3's order, whichever CTA computes it, and z
// and every gradient equal v3's bit for bit.
//
// Forward chunk, per layer: `layer_tile` (h to the stash hs, the dropout
// mask, the pool; no u stash) over the layer's tiles, then a grid barrier;
// the chunk that ends the stack then runs the out-projection (`proj_tile`,
// 64 rows: the eval kernel's).  Barriers: one between layers, one before
// the out-projection.
//
// Sweep chunk, the out-projection first on the last chunk (the dz body with
// proj = 1, and its weight-gradient spans, which read gz itself: gz equals
// v3's dy of the out-projection on every row it reads), then per layer,
// last first:
//   A: the dz body.  On a pooled layer u = mask((h W1 + b1) m + x) is first
//      recomputed for the tile's rows from the stash, with the forward's
//      weight chunk (Tile<TM, KC of the forward's tile>: an `mma` rounds its
//      sum toward zero, so a partial's value depends on the chunk) and the
//      forward's epilogue (`residual`), from the same f32 h (the stash holds
//      the h that re-entered the 1x1 as its A operand): u equals the u the
//      forward pooled, bit for bit.  g is routed to the first maximum of
//      each pair in the accumulators (rows 2k, 2k + 1 in lanes l, l ^ 4);
//      gm (for dx) and dy = gm m (for dW1) go to scratch.
//      Also: the previous layer's (or the out-projection's) partials summed
//      in a fixed order.
//   grid barrier
//   B: the dx tiles (g_in = mask(conv3^T(dz) + gm)) and the weight-gradient
//      spans of dW1, db1, dW3[k], db3, in one grid-stride walk
//   grid barrier
// and after the last layer of the chunk its partials' sum.  No atomics: two
// sweeps agree bit for bit.
//
// One kernel has one block size, one shared-memory size and one register
// budget for all its phases, and all its CTAs must be resident.  An output's
// sum depends on the weight chunk a tile streams (Tile<TM, KC>), not on its
// rows, so each kernel may cut v3's tiles in rows as long as it keeps v3's
// chunk, and it may stage a chunk in smaller ring buffers (Tile<TM, KC, KS>).
// The forward takes v3's tiles: 64 rows, 167 KiB a CTA, one CTA of 8 warps
// an SM.  The sweep runs two CTAs an SM (16 warps, as v3's weight-gradient
// kernel): its tiles have at most 32 rows on v3's chunks (64 rows where
// v3's tile had 64), staged 32 rows a buffer (84 KiB a CTA); a
// weight-gradient item is half the C x C outputs of a span (8 warps of 32 x
// 32, as v3's 16).  At two CTAs an SM a thread has 128 registers: the
// sweep's items are calls, each with a register allocation of its own
// (inlined into one body they spilled more; the forward's stay inlined: as
// calls they ran slower).  PERF.md records the other grids' times.  The
// grids are sized from `cudaOccupancyMaxActiveBlocksPerMultiprocessor`; the
// wrapper refuses a chunk of more layers than the argument table holds.
//
// Work items are dealt out live first: the row tiles (and spans) that hold
// rows of their video, then the padding ones, which return at once.  A
// grid-stride walk over tiles in video order would give some CTAs three
// live tiles where the hardware's scheduler gives v3 two.
//
// Widths and modes: both kernels are built for C = 128, 256 and 512 (the
// wrapper zero-pads another C) and in both of v3's modes, 3xTF32 and the
// bf16-operand mode (BF: the JAX v2 kernel's `mm_dtype=bfloat16`,
// wavenet_train_pallas_v2.py:82-97, :444-467, every product on bf16-rounded
// operands, the out-projection's sweep included).  The grids are sized
// from each instance's occupancy (`V2Cfg<C>`): above C = 128 a tile fills
// an SM's shared memory, and both kernels run one CTA an SM on v3's tiles.
//
// Bound: the tensor cores at three TF32 products per f32 product (495 / 3
// TFLOP/s on the H100), as v3; the sweep adds one [rows x C] x [C x C]
// product per pooled layer to recompute u.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "wavenet_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

template <int N>
using ic = std::integral_constant<int, N>;

constexpr int WG_PARTS = 2;       // a weight-gradient item half a block's outputs

// The grids at C channels.  C = 128: the forward on v3's tiles (up to 64
// rows), one CTA an SM; the sweep two CTAs an SM on tiles of at most 32
// rows, each chunk staged 32 rows a buffer.  Above C = 128 a tile of 32
// rows (C = 256) or 16 (C = 512) fills an SM's shared memory: both kernels
// run one CTA an SM, the sweep on v3's tiles.
template <int C>
struct V2Cfg {
  static constexpr int FWD_MAX_TM = C >= 512 ? 16 : (C >= 256 ? 32 : 64);
  static constexpr int SWEEP_CTAS = C > 128 ? 1 : 2;
  static constexpr int SWEEP_MAX_TM = C >= 512 ? 16 : 32;
  static constexpr int SWEEP_KS = C >= 512 ? 16 : 32;
  // the forward: its largest tile's three row tiles and weight ring
  static constexpr int FWD_SMEM = Tile<C, FWD_MAX_TM>::TAPS_SMEM;
  // the sweep: its largest tile's three row tiles and ring (the dx body; the
  // pooled dz body's dy, h and x tiles and its ring of SWEEP_KS-row buffers)
  static constexpr int SWEEP_SMEM =
      Tile<C, SWEEP_MAX_TM, default_kc(C, SWEEP_MAX_TM), SWEEP_KS>::TAPS_SMEM;
  static_assert(WG_SMEM <= SWEEP_SMEM && Tile<C, FWD_MAX_TM>::ONE_SMEM <= FWD_SMEM &&
                    Tile<C, SWEEP_MAX_TM, default_kc(C, FWD_MAX_TM), SWEEP_KS>::TAPS_SMEM <=
                        SWEEP_SMEM &&
                    SWEEP_CTAS * (SWEEP_SMEM + 1024) <= 233472,
                "every body fits its kernel's shared memory, SWEEP_CTAS times an SM");
};

struct FwdLayer {
  const float* x;      // [B, T, C] layer input (masked): the stash x_i
  float* y;            // [B, T or T/2, C] layer output
  float* hs;           // [B, T, C] stash: nonlin(z)
  const float* drop;   // [B, T, C] dropout mask or null
  float* u;            // [B, T, C] pre-pool output (a check's copy) or null
  int T, d, shift, pool, tm;
};

struct FwdArgs {
  FwdLayer layer[MAX_LAYERS];
  const float *w3, *b3, *w1, *b1;  // the chunk's layers, first layer first
  const float *wl, *bl;
  float* z;                        // [B, t_fin, C] or null (not the last chunk)
  const int* lengths;
  int n, B, t_fin, shift_fin, leaky;
};

struct SweepLayer {
  const float* x;      // [B, T, C] stash: the layer's input
  const float* h;      // [B, T, C] stash: nonlin(z)
  const float* drop;   // [B, T, C] or null
  const float* g;      // gradient at the layer's output ([B, T/2, C] if pooled)
  float* g_in;         // [B, T, C] gradient at the layer's input
  float* u;            // [B, T, C] recomputed pre-pool output (a check's copy) or null
  int T, d, shift, pool;
  int tm, kc;          // the dz and dx row tile, v3's weight chunk
  int kc_f;            // the forward's weight chunk (the u recompute)
  int span, spans;     // weight-gradient rows a span, spans a video
};

struct SweepArgs {
  SweepLayer layer[MAX_LAYERS];      // layer order; the sweep walks it backwards
  const float *w3t, *w1, *w1t, *b1;  // the chunk's layers: W3[k]^T, W1, W1^T, b1
  float *dw3, *db3, *dw1, *db1;      // the chunk's slices of the gradients
  const float *gz, *x_fin, *wlt;     // out-projection (gz null: not the last chunk)
  float *dwl, *dbl, *g_proj;         // g_proj = layer[n - 1].g, written here
  float *gm, *dy, *dz, *work;        // scratch
  const int* lengths;
  int n, B, t_fin, shift_fin, leaky;
  int tm_fin, kc_fin, span_fin, spans_fin;  // the out-projection's sweep grid
};

// f(ic<TM>) for the forward's row tile tm (64, 32 or 16, as C allows)
template <int C, class F>
__device__ __forceinline__ void with_fwd_tile(int tm, F f) {
  if constexpr (tile_ok(C, 64))
    if (tm == 64) return f(ic<64>{});
  if constexpr (tile_ok(C, 32))
    if (tm == 32) return f(ic<32>{});
  f(ic<16>{});
}

// f(ic<TM>, ic<KC>) for a sweep body of row tile tm on v3's chunk kc
template <int C, class F>
__device__ __forceinline__ void with_sweep_tile(int tm, int kc, F f) {
  constexpr int MAX_TM = V2Cfg<C>::SWEEP_MAX_TM;
  if constexpr (C == 128)
    if (kc == 64) return f(ic<MAX_TM>{}, ic<64>{});  // v3's 64-row tile (cut in rows)
  if constexpr (MAX_TM >= 32)
    if (tm == 32) return f(ic<32>{}, ic<default_kc(C, 32)>{});
  f(ic<16>{}, ic<default_kc(C, 16)>{});
}

// Block k of B videos x ceil(T / rows) blocks of `rows` rows: the blocks
// that hold rows of their video (t0 < len) first, video by video, then the
// others (padding: they return at once), so that the grid-stride walk deals
// the costly blocks out evenly (a launch a layer gets that from the
// hardware's CTA scheduler).  -> (video, first row)
__device__ __forceinline__ int2 live_first(int k, int B, int T, int rows, int shift,
                                           const int* lengths) {
  const int per = (T + rows - 1) / rows;
  for (int pass = 0; pass < 2; ++pass)
    for (int b = 0; b < B; ++b) {
      const int live = min(per, ((lengths[b] >> shift) + rows - 1) / rows);
      const int n = pass ? per - live : live;
      if (k < n) return make_int2(b, ((pass ? live : 0) + k) * rows);
      k -= n;
    }
  return make_int2(0, T);  // k >= B * per: none
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int C, int TM, bool BF>
__device__ void fwd_layer(const FwdArgs& a, int j, float* smem) {
  const FwdLayer& L = a.layer[j];
  grid_items(a.B * ((L.T + TM - 1) / TM), [&](int item) {
    const int2 bt = live_first(item, a.B, L.T, TM, L.shift, a.lengths);
    layer_tile<C, TM, BF>(L.x, L.y, L.u, L.hs, a.lengths, a.w3 + (size_t)j * 3 * C * C,
                   a.b3 + (size_t)j * C, a.w1 + (size_t)j * C * C, a.b1 + (size_t)j * C,
                   L.drop, bt.x, bt.y, L.T, L.d, L.shift, L.pool, 0, a.leaky, smem);
  });
}

template <int C, bool BF>
__global__ void __launch_bounds__(NT, Tile<C, V2Cfg<C>::FWD_MAX_TM>::MIN_BLOCKS)
    v2_fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int FWD_MAX_TM = V2Cfg<C>::FWD_MAX_TM;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int j = 0; j < a.n; ++j) {
    with_fwd_tile<C>(a.layer[j].tm,
                     [&](auto tm) { fwd_layer<C, decltype(tm)::value, BF>(a, j, smem); });
    // layer j's output is read at t +- d by the next layer's other CTAs
    if (j + 1 < a.n || a.z) grid.sync();
  }
  if (a.z) {
    grid_items(a.B * ((a.t_fin + FWD_MAX_TM - 1) / FWD_MAX_TM), [&](int item) {
      const int2 bt = live_first(item, a.B, a.t_fin, FWD_MAX_TM, a.shift_fin, a.lengths);
      proj_tile<C, FWD_MAX_TM, BF>(a.layer[a.n - 1].y, a.z, a.lengths, a.wl, a.bl, bt.x, bt.y,
                            a.t_fin, a.shift_fin, a.leaky, smem);
    });
  }
}

// ---------------------------------------------------------------------------
// sweep
// ---------------------------------------------------------------------------

// Step A of pooled layer j, rows [t0, t0 + TM) of video b: u recomputed with
// the forward's weight chunk KCF, g routed to the first max of each pair
// (0 at an odd trailing frame and past len / 2), gm and dy = gm m to
// scratch, then the dz body's product on the dy tile in v3's chunk KC.
// Both products stage SWEEP_KS-row ring buffers (Tile<C, TM, KCF, SWEEP_KS>::TAPS_SMEM).
template <int C, int TM, int KC, int KCF, bool BF>
__device__ void dz_pooled_tile(const SweepArgs& a, int j, int b, int t0, float* smem) {
  constexpr int SWEEP_KS = V2Cfg<C>::SWEEP_KS;
  using TU = Tile<C, TM, KCF, SWEEP_KS>;
  constexpr int LDA = TU::LDA;
  const SweepLayer& L = a.layer[j];
  float* Ds = smem;               // [TM][LDA] dy
  float* Hs = Ds + TU::TILE_F;    // [TM][LDA] h
  float* Xs = Hs + TU::TILE_F;    // [TM][LDA] x (the residual)
  float* Wr = Xs + TU::TILE_F;    // [2][32][LDW] weight ring
  const int T = L.T, len = a.lengths[b] >> L.shift;
  if (t0 >= len) return;
  const int lim = min(T, len);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (warp / TU::WN) * (16 * TU::MT), col0 = (warp % TU::WN) * (8 * TU::NTL);
  const size_t base = (size_t)b * T * C;

  stage_rows<C, TM>(Hs, L.h + base, t0, lim);
  stage_rows<C, TM>(Xs, L.x + base, t0, lim);
  float acc[TU::MT][TU::NTL][4] = {};
  float* const tiles[3] = {Hs, Hs, Hs};
  const float* const ws[4] = {nullptr, a.w1 + (size_t)j * C * C, nullptr, nullptr};
  tap_loop<C, TM, KCF, SWEEP_KS, BF>(acc, tiles, ws, false, false, Wr, row0, col0, lane,
                                      [](auto&) {});
  residual<C>(acc, Xs, a.b1 + (size_t)j * C, L.drop, b, T, t0, lim, row0, col0, lane);
  if (L.u)
    for_each_pair(acc, row0, col0, lane, [&](float& v0, float& v1, int row, int col) {
      if (t0 + row < lim) st2(L.u + base + (size_t)(t0 + row) * C + col, v0, v1);
    });

  const int g4 = lane >> 2, T2 = T / 2, len2 = len >> 1;
  const bool odd = g4 & 1;  // this lane's row is the pair's second; the first is in lane ^ 4
#pragma unroll
  for (int mt = 0; mt < TU::MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 16 * mt + g4 + 8 * hh, t = t0 + row, t2 = t >> 1;
      const bool live = t < len && t2 < T2 && t2 < len2;
#pragma unroll
      for (int nt = 0; nt < TU::NTL; ++nt) {
        const int col = col0 + 8 * nt + 2 * (lane & 3);
        const float2 gv = live ? ld2_l2(L.g + ((size_t)b * T2 + t2) * C + col)
                               : make_float2(0.f, 0.f);
        float gm[2], dy[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mine = acc[mt][nt][2 * hh + e];
          const float other = __shfl_xor_sync(0xffffffffu, mine, 4);
          const bool second = odd ? mine > other : other > mine;  // ties route to the first
          gm[e] = second == odd ? (e ? gv.y : gv.x) : 0.f;
          dy[e] = gm[e];
        }
        if (t < lim) {
          st2(a.gm + base + (size_t)t * C + col, gm[0], gm[1]);
          if (L.drop) {
            const float2 m = ld2(L.drop + base + (size_t)t * C + col);
            dy[0] = gm[0] * m.x;
            dy[1] = gm[1] * m.y;
          }
          st2(a.dy + base + (size_t)t * C + col, dy[0], dy[1]);
        }
        st2(Ds + row * LDA + col, t < lim ? dy[0] : 0.f, t < lim ? dy[1] : 0.f);
      }
    }
  // (the product's first chunk waits at a barrier for every warp's dy rows;
  // its ring's first buffer held a chunk every warp has consumed)
  dz_rows<C, TM, KC, SWEEP_KS, BF>(Ds, Wr, a.w1t + (size_t)j * C * C, L.h, a.dz, b, t0, T, lim,
                                   a.leaky);
}

// a dz tile of layer j
template <int C, int TM, int KC, bool BF>
__device__ __noinline__ void dz_item(const SweepArgs& a, int j, int b, int t0, float* smem) {
  const SweepLayer& L = a.layer[j];
  if (!L.pool) {
    dz_tile<C, TM, KC, V2Cfg<C>::SWEEP_KS, BF>(L.g, nullptr, L.h, L.drop, a.lengths,
                                               a.w1t + (size_t)j * C * C, a.dy, a.dz, b, t0,
                                               L.T, L.shift, 0, 0, a.leaky, 0, smem);
  } else if (L.kc_f == 64) {
    if constexpr (C == 128) dz_pooled_tile<C, TM, KC, 64, BF>(a, j, b, t0, smem);
  } else if constexpr (KC <= 32) {  // (v3's 64-row sweep tile follows a 64-row
    dz_pooled_tile<C, TM, KC, KC, BF>(a, j, b, t0, smem);  // forward tile; else kc_f = KC)
  }
}

// step A of layer j: its dz tiles
template <int C, int TM, int KC, bool BF>
__device__ void dz_layer(const SweepArgs& a, int j, float* smem) {
  const SweepLayer& L = a.layer[j];
  grid_items(a.B * ((L.T + TM - 1) / TM), [&](int item) {
    const int2 bt = live_first(item, a.B, L.T, TM, L.shift, a.lengths);
    dz_item<C, TM, KC, BF>(a, j, bt.x, bt.y, smem);
  });
}

// the weight-gradient items of a span: the (C / WB)^2 output blocks, each in WG_PARTS
template <int C>
__host__ __device__ constexpr int span_items() { return (C / WB) * (C / WB) * WG_PARTS; }

// weight-gradient item w of layer j (j < 0: of the out-projection, one job):
// (span, video) pairs live first, then the job, then the block and part
template <int C, bool BF>
__device__ __noinline__ void wgrad_item(const SweepArgs& a, int j, int w, float* smem) {
  constexpr int PER = span_items<C>();
  const int part = w % WG_PARTS, blk = (w % PER) / WG_PARTS, jobs = j < 0 ? 1 : 4,
            job = (w / PER) % jobs;
  w /= PER * jobs;
  if (j < 0) {
    const int2 bs = live_first(w, a.B, a.t_fin, a.span_fin, a.shift_fin, a.lengths);
    wgrad_span<C, NT, WG_PARTS, BF>(a.x_fin, a.x_fin, a.gz, nullptr, a.lengths, a.work,
                                    a.t_fin, a.span_fin, a.spans_fin, 1, 0, a.shift_fin, 1,
                                    a.leaky, bs.y / a.span_fin, bs.x, 0, part, blk, smem);
    return;
  }
  const SweepLayer& L = a.layer[j];
  const int2 bs = live_first(w, a.B, L.T, L.span, L.shift, a.lengths);
  wgrad_span<C, NT, WG_PARTS, BF>(L.h, L.x, a.dy, a.dz, a.lengths, a.work, L.T, L.span,
                                  L.spans, 4, L.d, L.shift, 0, a.leaky, bs.y / L.span, bs.x,
                                  job, part, blk, smem);
}

// a dx tile of layer j
template <int C, int TM, int KC, bool BF>
__device__ __noinline__ void dx_item(const SweepArgs& a, int j, int b, int t0, float* smem) {
  const SweepLayer& L = a.layer[j];
  dx_tile<C, TM, KC, V2Cfg<C>::SWEEP_KS, BF>(a.dz, L.pool ? a.gm : L.g, nullptr, a.lengths,
                                             a.w3t + (size_t)j * 3 * C * C, L.g_in, b, t0, L.T,
                                             L.d, L.shift, 0, 0, smem);
}

// step B of layer j: the dx tiles, then the weight-gradient spans
template <int C, int TM, int KC, bool BF>
__device__ void dx_wgrad_layer(const SweepArgs& a, int j, float* smem) {
  const SweepLayer& L = a.layer[j];
  const int n_tiles = a.B * ((L.T + TM - 1) / TM);
  grid_items(n_tiles + a.B * L.spans * 4 * span_items<C>(), [&](int item) {
    if (item < n_tiles) {
      const int2 bt = live_first(item, a.B, L.T, TM, L.shift, a.lengths);
      dx_item<C, TM, KC, BF>(a, j, bt.x, bt.y, smem);
    } else {
      wgrad_item<C, BF>(a, j, item - n_tiles, smem);
    }
  });
}

// the out-projection: its dz body (the gradient at x_fin) and its spans
template <int C, int TM, int KC, bool BF>
__device__ __noinline__ void proj_dz_item(const SweepArgs& a, int b, int t0, float* smem) {
  dz_tile<C, TM, KC, V2Cfg<C>::SWEEP_KS, BF>(a.gz, nullptr, a.x_fin, nullptr, a.lengths, a.wlt,
                                             a.dy, a.g_proj, b, t0, a.t_fin, a.shift_fin, 0, 0,
                                             a.leaky, 1, smem);
}

template <int C, int TM, int KC, bool BF>
__device__ void proj_sweep(const SweepArgs& a, float* smem) {
  const int n_tiles = a.B * ((a.t_fin + TM - 1) / TM);
  grid_items(n_tiles + a.B * a.spans_fin * span_items<C>(), [&](int item) {
    if (item < n_tiles) {
      const int2 bt = live_first(item, a.B, a.t_fin, TM, a.shift_fin, a.lengths);
      proj_dz_item<C, TM, KC, BF>(a, bt.x, bt.y, smem);
    } else {
      wgrad_item<C, BF>(a, -1, item - n_tiles, smem);
    }
  });
}

// layer j's partials (j < 0: the out-projection's) summed into its gradients
template <int C>
__device__ void reduce_layer(const SweepArgs& a, int j) {
  const int jobs = j < 0 ? 1 : 4;
  for (int e = blockIdx.x * NT + threadIdx.x; e < jobs * part_f(C); e += gridDim.x * NT) {
    if (j < 0) {
      reduce_entry<C>(a.work, a.lengths, a.B, a.t_fin, a.span_fin, a.spans_fin, a.shift_fin, 1, e,
                   a.dwl, a.dbl, nullptr, nullptr);
    } else {
      const SweepLayer& L = a.layer[j];
      reduce_entry<C>(a.work, a.lengths, a.B, L.T, L.span, L.spans, L.shift, 4, e,
                   a.dw1 + (size_t)j * C * C, a.db1 + (size_t)j * C,
                   a.dw3 + (size_t)j * 3 * C * C, a.db3 + (size_t)j * C);
    }
  }
}

#define TILE_ARGS C, decltype(tm)::value, decltype(kc)::value, BF

template <int C, bool BF>
__global__ void __launch_bounds__(NT, V2Cfg<C>::SWEEP_CTAS)
    v2_sweep_kernel(const __grid_constant__ SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  int pending = a.n;  // the layer just swept (-1: the out-projection) awaits its sum; n: none
  if (a.gz) {
    with_sweep_tile<C>(a.tm_fin, a.kc_fin,
                    [&](auto tm, auto kc) { proj_sweep<TILE_ARGS>(a, smem); });
    grid.sync();  // g_proj is read by the last layer
    pending = -1;
  }
  for (int j = a.n - 1; j >= 0; --j) {
    const SweepLayer& L = a.layer[j];
    with_sweep_tile<C>(L.tm, L.kc, [&](auto tm, auto kc) { dz_layer<TILE_ARGS>(a, j, smem); });
    if (pending < a.n) reduce_layer<C>(a, pending);
    grid.sync();  // dz is read at t +- d; gm, dy, dz by the weight gradients
    with_sweep_tile<C>(L.tm, L.kc,
                       [&](auto tm, auto kc) { dx_wgrad_layer<TILE_ARGS>(a, j, smem); });
    grid.sync();  // g_in feeds the layer below; the partials their sum
    pending = j;
  }
  reduce_layer<C>(a, 0);
}

#undef TILE_ARGS

// A v2 layer's grid at C channels: v3's (`plan_for`), the sweep's tile cut
// to SWEEP_MAX_TM rows on v3's chunk
struct V2Plan {
  int fwd_tm, kc_f, tm, kc, span, spans;
};

template <int C>
V2Plan v2_plan(int B, int T, int jobs) {
  const Plan p = plan_for(B, T, C, jobs);
  V2Plan v;
  v.fwd_tm = p.fwd_tm;
  v.kc_f = default_kc(C, v.fwd_tm);  // Tile<C, fwd_tm>::KC
  v.kc = default_kc(C, p.tm);        // Tile<C, v3's sweep tile>::KC
  v.tm = std::min(p.tm, V2Cfg<C>::SWEEP_MAX_TM);
  v.span = p.span;
  v.spans = p.spans;
  return v;
}

template <int C, bool BF>
int v2_grid(int* out) {
  using K = V2Cfg<C>;
  int sms = 0;
  cudaError_t err = coop_grid(v2_fwd_kernel<C, BF>, K::FWD_SMEM, &out[2], &sms);
  if (err == cudaSuccess) err = coop_grid(v2_sweep_kernel<C, BF>, K::SWEEP_SMEM, &out[3], &sms);
  out[0] = K::FWD_MAX_TM;
  out[1] = K::SWEEP_MAX_TM;
  out[4] = sms;
  out[5] = K::FWD_SMEM;
  out[6] = K::SWEEP_SMEM;
  out[7] = MAX_LAYERS;
  return err;
}

template <int C, bool BF>
int v2_fwd(void* const* ptrs, const int* ints, int n, const float* w3, const float* b3,
           const float* w1, const float* b1, const float* wl, const float* bl, float* z,
           const int* lengths, int B, int t_fin, int shift_fin, int leaky, cudaStream_t stream) {
  FwdArgs a = {};
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    if (T <= 0) return cudaErrorInvalidValue;
    a.layer[j] = FwdLayer{static_cast<const float*>(ptrs[5 * j]),
                          static_cast<float*>(ptrs[5 * j + 1]),
                          static_cast<float*>(ptrs[5 * j + 2]),
                          static_cast<const float*>(ptrs[5 * j + 3]),
                          static_cast<float*>(ptrs[5 * j + 4]),
                          T, ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3],
                          v2_plan<C>(B, T, 4).fwd_tm};
  }
  a.w3 = w3; a.b3 = b3; a.w1 = w1; a.b1 = b1; a.wl = wl; a.bl = bl; a.z = z;
  a.lengths = lengths; a.n = n; a.B = B; a.t_fin = t_fin; a.shift_fin = shift_fin;
  a.leaky = leaky;
  return launch_cooperative(v2_fwd_kernel<C, BF>, V2Cfg<C>::FWD_SMEM, &a, stream);
}

template <int C, bool BF>
int v2_sweep(void* const* ptrs, const int* ints, int n, const float* w3t, const float* w1,
             const float* w1t, const float* b1, float* dw3, float* db3, float* dw1, float* db1,
             const float* gz, const float* x_fin, const float* wlt, float* dwl, float* dbl,
             float* scratch, long rows, float* work, long work_floats, const int* lengths,
             int B, int t_fin, int shift_fin, int leaky, cudaStream_t stream) {
  SweepArgs a = {};
  long need = 0;
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    if (T <= 0 || (long)B * T > rows) return cudaErrorInvalidValue;
    const V2Plan p = v2_plan<C>(B, T, 4);
    a.layer[j] = SweepLayer{static_cast<const float*>(ptrs[6 * j]),
                            static_cast<const float*>(ptrs[6 * j + 1]),
                            static_cast<const float*>(ptrs[6 * j + 2]),
                            static_cast<const float*>(ptrs[6 * j + 3]),
                            static_cast<float*>(ptrs[6 * j + 4]),
                            static_cast<float*>(ptrs[6 * j + 5]),
                            T, ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3],
                            p.tm, p.kc, p.kc_f, p.span, p.spans};
    need = std::max(need, (long)B * p.spans * 4 * part_f(C));
  }
  const V2Plan pf = v2_plan<C>(B, t_fin, 1);
  if (gz) {
    if ((long)B * t_fin > rows) return cudaErrorInvalidValue;
    need = std::max(need, (long)B * pf.spans * part_f(C));
  }
  if (need > work_floats) return cudaErrorInvalidValue;
  a.w3t = w3t; a.w1 = w1; a.w1t = w1t; a.b1 = b1;
  a.dw3 = dw3; a.db3 = db3; a.dw1 = dw1; a.db1 = db1;
  a.gz = gz; a.x_fin = x_fin; a.wlt = wlt; a.dwl = dwl; a.dbl = dbl;
  a.g_proj = gz ? static_cast<float*>(ptrs[6 * (n - 1) + 3]) : nullptr;
  a.gm = scratch;
  a.dy = scratch + rows * C;
  a.dz = scratch + 2 * rows * C;
  a.work = work; a.lengths = lengths;
  a.n = n; a.B = B; a.t_fin = t_fin; a.shift_fin = shift_fin; a.leaky = leaky;
  a.tm_fin = pf.tm; a.kc_fin = pf.kc; a.span_fin = pf.span; a.spans_fin = pf.spans;
  return launch_cooperative(v2_sweep_kernel<C, BF>, V2Cfg<C>::SWEEP_SMEM, &a, stream);
}

// f(ic<C>, bool) for channels 128, 256, 512 and the mode; another width is refused
template <class F>
int with_width(int channels, int bf16, F f) {
  switch (channels) {
    case 128: return bf16 ? f(ic<128>{}, std::true_type{}) : f(ic<128>{}, std::false_type{});
    case 256: return bf16 ? f(ic<256>{}, std::true_type{}) : f(ic<256>{}, std::false_type{});
    case 512: return bf16 ? f(ic<512>{}, std::true_type{}) : f(ic<512>{}, std::false_type{});
    default: return cudaErrorInvalidValue;  // the wrapper pads another width to one of these
  }
}

}  // namespace

// The cooperative grids at C channels in the mode bf16: out = {the
// forward's largest row tile, the sweep's, CTAs an SM of the forward kernel,
// of the sweep kernel, SMs, shared memory a CTA of the forward and of the
// sweep (bytes), layers a chunk at most}.
extern "C" int mucon_wavenet_train_v2_grid(int channels, int bf16, int* out) {
  return with_width(channels, bf16, [&](auto c, auto bf) {
    return v2_grid<decltype(c)::value, decltype(bf)::value>(out);
  });
}

// The grid of a v2 layer of B videos x T frames x C channels: out = {forward
// row tile, its weight chunk, the sweep's row tile, its weight chunk (v3's),
// weight-gradient span, spans a video}.  The sweep's `work` holds B * spans
// * jobs * (C + 1) * C floats for its largest layer (jobs = 4, or 1 for the
// out-projection).
extern "C" int mucon_wavenet_train_v2_plan(int B, int T, int channels, int jobs, int* out) {
  if (B <= 0 || T <= 0 || jobs <= 0) return cudaErrorInvalidValue;
  return with_width(channels, 0, [&](auto c, auto) {
    const V2Plan p = v2_plan<decltype(c)::value>(B, T, jobs);
    const int v[6] = {p.fwd_tm, p.kc_f, p.tm, p.kc, p.span, p.spans};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return (int)cudaSuccess;
  });
}

// One forward chunk (see the top of the file) at C = 128, 256 or 512
// channels; bf16 = 1: the bf16-operand mode.  Host tables, per layer of the
// chunk in order: ptrs[5 j ..] = x, y, hs, drop, u (drop and u may be null; u
// is written only on a pooled layer), ints[4 j ..] = T, d, pools before it,
// pooled.  w3 / b3 / w1 / b1 point at the chunk's first layer; z (with wl,
// bl) is null except on the last chunk.
extern "C" int mucon_wavenet_train_v2_fwd(void* const* ptrs, const int* ints, int n,
                                          const float* w3, const float* b3, const float* w1,
                                          const float* b1, const float* wl, const float* bl,
                                          float* z, const int* lengths, int B, int channels,
                                          int t_fin, int shift_fin, int leaky, int bf16,
                                          cudaStream_t stream) {
  if (B <= 0 || n < 1 || n > MAX_LAYERS) return cudaErrorInvalidValue;
  return with_width(channels, bf16, [&](auto c, auto bf) {
    return v2_fwd<decltype(c)::value, decltype(bf)::value>(ptrs, ints, n, w3, b3, w1, b1, wl,
                                                           bl, z, lengths, B, t_fin, shift_fin,
                                                           leaky, stream);
  });
}

// One sweep chunk (bf16 = 1: the bf16-operand mode, the out-projection's
// sweep included, as the JAX v2 kernel).  Host tables, per layer of the chunk
// in layer order: ptrs[6 j ..] = x, h, drop (or null), g, g_in, u (a copy of
// the recomputed pre-pool output, or null); ints[4 j ..] = T, d, pools
// before it, pooled.  On the last chunk gz (with x_fin, wlt = Wl^T, dwl, dbl)
// is given and the kernel writes the last layer's g itself; otherwise gz is
// null.  scratch holds three buffers of `rows` x C floats (gm, dy, dz; rows
// >= B x the longest T), work `work_floats` (`mucon_wavenet_train_v2_plan`).
extern "C" int mucon_wavenet_train_v2_sweep(
    void* const* ptrs, const int* ints, int n, const float* w3t, const float* w1,
    const float* w1t, const float* b1, float* dw3, float* db3, float* dw1, float* db1,
    const float* gz, const float* x_fin, const float* wlt, float* dwl, float* dbl,
    float* scratch, long rows, float* work, long work_floats, const int* lengths, int B,
    int channels, int t_fin, int shift_fin, int leaky, int bf16, cudaStream_t stream) {
  if (B <= 0 || n < 1 || n > MAX_LAYERS || t_fin <= 0) return cudaErrorInvalidValue;
  return with_width(channels, bf16, [&](auto c, auto bf) {
    return v2_sweep<decltype(c)::value, decltype(bf)::value>(
        ptrs, ints, n, w3t, w1, w1t, b1, dw3, db3, dw1, db1, gz, x_fin, wlt, dwl, dbl, scratch,
        rows, work, work_floats, lengths, B, t_fin, shift_fin, leaky, stream);
  });
}
