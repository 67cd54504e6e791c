// Trainable WaveNet residual stack, v2: one program per chunk of layers, for
// NVIDIA Hopper (sm_90a).
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
// CTAs as the card holds at once; the CTAs walk the chunk's work items (tiles
// of TM rows of one video, or weight-gradient spans) in grid-stride order and
// meet at a grid-wide barrier (cooperative_groups grid.sync()) wherever the
// next step reads rows that other CTAs wrote: a layer reads its input at
// t - d and t + d.
//
// Forward chunk, per layer i (t frames, dilation d, dropout mask m or none):
//   h  = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)    -> stash hs
//   x' = mask((h W1 + b1) m + x), max-pooled in row pairs on pooled layers
//        (first of a tie), masked at len/2
//   grid barrier
// The layer inputs x_i stay in memory as the stash; the chunk that ends the
// stack also writes z = mask(nonlin(x_L) Wl + bl) after a last barrier.
//
// Sweep chunk, the out-projection first on the last chunk (gz -> g, dWl,
// dbl), then per layer, last first:
//   A: on pooled layers u = mask((h W1 + b1) m + x) recomputed for the
//      tile's rows; gm = mask(g routed to the first max of each pair, 0 at
//      an odd trailing frame), or mask(g); dy = gm m;
//      dz = (dy W1^T) nonlin'(h)                        (gm, dz to scratch)
//      also: the fixed-order sum of the previous layer's weight partials
//   grid barrier
//   B: g_in = mask(dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//      and, in other work items, the per-span partials of dW1 = h^T dy,
//      db1, dW3[k] = shift(x, (k-1) d)^T dz, db3
//   grid barrier
// Weight gradients: each span of the B * t rows keeps one C x C partial in
// registers (8 x 8 per thread); the spans are added in span order, one
// thread per entry.  No atomics: two sweeps agree bit for bit.
//
// Shared memory: 80 KiB a CTA in the forward (three tap tiles, a weight
// chunk, the nonlin(z) tile), 64 KiB in the sweep (three dz tap tiles and a
// weight chunk); two CTAs of 256 threads fit an SM.  The wrapper refuses a
// chunk the card cannot hold resident (cooperative launch).
//
// Bound: f32 FMAs on the CUDA cores, as the v3 kernels; the sweep adds one
// [rows x C] x [C x C] product per pooled layer to recompute u.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 128;                  // channels (the model's hidden_size)
constexpr int TM = 32;                  // rows per tile
constexpr int NT = 256;                 // threads per CTA
constexpr int KC = 32;                  // weight rows staged per chunk
constexpr int RPT = TM / (NT / 32);     // rows per thread (4)
constexpr int KR = 32;                  // rows staged per chunk in the weight gradients
constexpr int MAX_SPLITS = 128;
constexpr int MAX_LAYERS = 32;
constexpr int FWD_SMEM = (3 * TM * C + KC * C + TM * C) * 4;
constexpr int SWEEP_SMEM = (3 * TM * C + KC * C) * 4;

static_assert(C == 128, "one warp covers C as 32 lanes x float4");
static_assert(C % KC == 0 && RPT % 2 == 0 && TM % 2 == 0, "chunking and row pairs");
static_assert(2 * TM * C + KC * C <= 3 * TM * C + KC * C && 2 * KR * C <= 3 * TM * C + KC * C,
              "every sweep step fits SWEEP_SMEM");

struct FwdLayer {
  const float* x;      // [B, T, C] layer input (masked): the stash x_i
  float* y;            // [B, T or T/2, C] layer output
  float* hs;           // [B, T, C] stash: nonlin(z)
  const float* drop;   // [B, T, C] dropout mask or null
  int T, d, shift, pool;
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
  int T, d, shift, pool;
};

struct SweepArgs {
  SweepLayer layer[MAX_LAYERS];      // layer order; the sweep walks it backwards
  const float *w3t, *w1, *w1t, *b1;  // the chunk's layers: W3[k]^T, W1, W1^T, b1
  float *dw3, *db3, *dw1, *db1;      // the chunk's slices of the gradients
  const float *gz, *x_fin, *wlt;     // out-projection (gz null: not the last chunk)
  float *dwl, *dbl, *g_proj;         // g_proj = layer[n - 1].g, written here
  float *gm, *dz, *work;             // scratch
  const int* lengths;
  int n, B, t_fin, shift_fin, leaky;
};

__device__ __forceinline__ float nonlin(float v, int leaky) {
  return leaky ? (v > 0.f ? v : 0.01f * v) : fmaxf(v, 0.f);
}

// nonlin'(z) from h = nonlin(z): both keep the sign of z
__device__ __forceinline__ float nonlin_grad(float h, int leaky) {
  return h > 0.f ? 1.f : (leaky ? 0.01f : 0.f);
}

__device__ __forceinline__ float4 f4zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 f4ld(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 f4mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ void f4st(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// (Rows written earlier in the same launch are read with plain loads, not
// __ldg: the read-only path is not coherent within a kernel.)
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * (C / 4); i += NT) d[i] = s[i];
}

// acc[r][q] += sum_kk A[row0 + r][a_col0 + kk] * Ws[kk][4 * tx + q]
__device__ __forceinline__ void mma_chunk(float (&acc)[RPT][4], const float* A,
                                          int a_col0, const float* Ws, int tx,
                                          int row0) {
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const float4 w = reinterpret_cast<const float4*>(Ws + kk * C)[tx];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float a = A[(row0 + r) * C + a_col0 + kk];
      acc[r][0] = fmaf(a, w.x, acc[r][0]);
      acc[r][1] = fmaf(a, w.y, acc[r][1]);
      acc[r][2] = fmaf(a, w.z, acc[r][2]);
      acc[r][3] = fmaf(a, w.w, acc[r][3]);
    }
  }
}

// acc += A[0..rows_k) W (W [rows_k][C] in global memory), A a shared tile
// (or the three tap tiles back to back for rows_k = 3 C)
__device__ __forceinline__ void matmul_acc(float (&acc)[RPT][4], const float* A, float* Ws,
                                           const float* w, int rows_k, int tx, int row0) {
  for (int kc = 0; kc < rows_k; kc += KC) {
    __syncthreads();  // A staged / previous chunk consumed
    stage_rows(Ws, w + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, A + (kc / C) * TM * C, kc % C, Ws, tx, row0);
  }
}

// Stage the three dilated taps of rows [t0, t0 + TM) of one video:
// tile j holds src[t + (j - 1) * d], zero outside [0, T) and at t >= len.
__device__ __forceinline__ void stage_taps(float* As, const float* src, int t0, int T,
                                           int d, int len) {
  for (int i = threadIdx.x; i < 3 * TM * (C / 4); i += NT) {
    const int j = i / (TM * C / 4);
    const int r = (i / (C / 4)) % TM;
    const int c4 = i % (C / 4);
    const int t = t0 + r + (j - 1) * d;
    float4 v = f4zero();
    if (t >= 0 && t < T && t < len) v = reinterpret_cast<const float4*>(src + (size_t)t * C)[c4];
    reinterpret_cast<float4*>(As)[i] = v;
  }
}

__device__ __forceinline__ int n_splits(int rows) {
  const int s = rows / 256;
  return s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__device__ void fwd_tile(const FwdArgs& a, int j, int b, int t0, float* smem) {
  const FwdLayer& L = a.layer[j];
  float* As = smem;               // [3][TM][C] taps t-d, t, t+d
  float* Ws = As + 3 * TM * C;    // [KC][C]
  float* Zs = Ws + KC * C;        // [TM][C] nonlin(z)
  const int T = L.T;
  const int len = a.lengths[b] >> L.shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  const float* b3 = a.b3 + (size_t)j * C;
  const float* b1 = a.b1 + (size_t)j * C;

  stage_taps(As, L.x + (size_t)b * T * C, t0, T, L.d, len);
  float acc[RPT][4] = {};
  matmul_acc(acc, As, Ws, a.w3 + (size_t)j * 3 * C * C, 3 * C, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float hv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      hv[q] = nonlin(acc[r][q] + b3[col], a.leaky);
      Zs[(row0 + r) * C + col] = hv[q];
      acc[r][q] = 0.f;
    }
    const int t = t0 + row0 + r;
    if (t < T) f4st(L.hs + ((size_t)b * T + t) * C + 4 * tx, hv);
  }
  matmul_acc(acc, Zs, Ws, a.w1 + (size_t)j * C * C, C, tx, row0);

  float v[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
    if (L.drop && t < T) m = f4ld(L.drop + ((size_t)b * T + t) * C + 4 * tx);
    const float mq[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      const float val = (acc[r][q] + b1[col]) * mq[q] + As[TM * C + (row0 + r) * C + col];
      v[r][q] = t < len ? val : 0.f;
    }
  }
  if (!L.pool) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = t0 + row0 + r;
      if (t < T) f4st(L.y + ((size_t)b * T + t) * C + 4 * tx, v[r]);
    }
    return;
  }
  const int T2 = T / 2, len2 = len >> 1;
#pragma unroll
  for (int r = 0; r < RPT; r += 2) {
    const int t2 = (t0 + row0 + r) >> 1;
    if (t2 >= T2) continue;  // an odd trailing frame is dropped
    float p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float u0 = v[r][q], u1 = v[r + 1][q];
      p[q] = t2 < len2 ? (u1 > u0 ? u1 : u0) : 0.f;
    }
    f4st(L.y + ((size_t)b * T2 + t2) * C + 4 * tx, p);
  }
}

// z = mask(nonlin(x_fin) Wl + bl) for rows [t0, t0 + TM) of video b
__device__ void fwd_proj_tile(const FwdArgs& a, const float* x_fin, int b, int t0,
                              float* smem) {
  float* Zs = smem;              // [TM][C] nonlin(x_fin)
  float* Ws = Zs + TM * C;
  const int T = a.t_fin;
  const int len = a.lengths[b] >> a.shift_fin;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  for (int i = threadIdx.x; i < TM * C; i += NT) {
    const int t = t0 + i / C;
    Zs[i] = (t < T && t < len) ? nonlin(x_fin[((size_t)b * T + t) * C + i % C], a.leaky) : 0.f;
  }
  float acc[RPT][4] = {};
  matmul_acc(acc, Zs, Ws, a.wl, C, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = t < len ? acc[r][q] + a.bl[4 * tx + q] : 0.f;
    f4st(a.z + ((size_t)b * T + t) * C + 4 * tx, o);
  }
}

__global__ void __launch_bounds__(NT, 2) v2_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int j = 0; j < a.n; ++j) {
    const int tiles = (a.layer[j].T + TM - 1) / TM;
    for (int item = blockIdx.x; item < a.B * tiles; item += gridDim.x) {
      __syncthreads();  // the previous item's shared reads are done
      fwd_tile(a, j, item / tiles, (item % tiles) * TM, smem);
    }
    // layer j's output is read at t +- d by the next layer's other CTAs
    if (j + 1 < a.n || a.z) grid.sync();
  }
  if (!a.z) return;
  const float* x_fin = a.layer[a.n - 1].y;
  const int tiles = (a.t_fin + TM - 1) / TM;
  for (int item = blockIdx.x; item < a.B * tiles; item += gridDim.x) {
    __syncthreads();
    fwd_proj_tile(a, x_fin, item / tiles, (item % tiles) * TM, smem);
  }
}

// ---------------------------------------------------------------------------
// sweep
// ---------------------------------------------------------------------------

// Per-span weight-gradient partial: dW = sum_rows A[row + off]^T Bm[row] and
// the column sums of Bm, over span `split` of the B * T rows.  Bm is scaled
// by `bmul` (the dropout mask) where given and zeroed at t >= len where
// `mask_b` (the out-projection's gz, the only unmasked operand); A goes
// through nonlin where `a_nonlin` (nonlin(x_fin)).
// Output: work[(split * jobs + job)][C + 1][C], row C the column sums.
__device__ void wgrad_item(const float* A, const float* Bm, const float* bmul, int off,
                           int a_nonlin, int mask_b, int T, int shift, const int* lengths,
                           int rows, int split, int job, int jobs, int leaky, float* work,
                           float* smem) {
  float* As = smem;          // [KR][C]
  float* Bs = As + KR * C;   // [KR][C]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // 16 x 16 threads
  const int splits = n_splits(rows);
  const int span = ((rows + splits - 1) / splits + KR - 1) / KR * KR;
  float acc[8][8] = {};
  float bsum = 0.f;
  const int r_lo = split * span;
  const int r_hi = min(rows, r_lo + span);
  for (int r0 = r_lo; r0 < r_hi; r0 += KR) {
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < KR * (C / 4); i += NT) {
      const int rr = i / (C / 4), c4 = i % (C / 4);
      const int row = r0 + rr;
      float4 av = f4zero(), bv = f4zero();
      if (row < r_hi) {
        const int t = row % T;
        if (!mask_b || t < (lengths[row / T] >> shift)) {
          bv = f4ld(Bm + (size_t)row * C + 4 * c4);
          if (bmul) bv = f4mul(bv, f4ld(bmul + (size_t)row * C + 4 * c4));
        }
        const int ts = t + off;
        if (ts >= 0 && ts < T) {
          av = f4ld(A + ((size_t)(row - t) + ts) * C + 4 * c4);
          if (a_nonlin)
            av = make_float4(nonlin(av.x, leaky), nonlin(av.y, leaky), nonlin(av.z, leaky),
                             nonlin(av.w, leaky));
        }
      }
      reinterpret_cast<float4*>(As)[i] = av;
      reinterpret_cast<float4*>(Bs)[i] = bv;
    }
    __syncthreads();
    if (threadIdx.x < C)
      for (int rr = 0; rr < KR; ++rr) bsum += Bs[rr * C + threadIdx.x];
#pragma unroll 4
    for (int rr = 0; rr < KR; ++rr) {
      const float4* ar = reinterpret_cast<const float4*>(As + rr * C);
      const float4* br = reinterpret_cast<const float4*>(Bs + rr * C);
      const float4 a0 = ar[ty], a1 = ar[16 + ty];
      const float4 b0 = br[tx], b1 = br[16 + tx];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(av[i], bw[k], acc[i][k]);
    }
  }
  float* out = work + ((size_t)split * jobs + job) * (C + 1) * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4) ? 4 * ty + i : 64 + 4 * ty + (i - 4);
    float4* o = reinterpret_cast<float4*>(out + (size_t)row * C);
    o[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[16 + tx] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (threadIdx.x < C) out[(size_t)C * C + threadIdx.x] = bsum;
}

// The fixed-order sum of the spans' partials of layer j (jobs 0-3 -> dW1 /
// db1, dW3[0..2], db3) or, for j < 0, of the out-projection (job 0 -> dWl,
// dbl); one thread per entry, grid-strided.
__device__ void reduce_partials(const SweepArgs& a, int j) {
  const bool proj = j < 0;
  const int rows = a.B * (proj ? a.t_fin : a.layer[j].T);
  const int splits = n_splits(rows), jobs = proj ? 1 : 4;
  const int per_job = (C + 1) * C;
  for (int e = blockIdx.x * NT + threadIdx.x; e < jobs * per_job; e += gridDim.x * NT) {
    const int job = e / per_job, k = e % per_job;
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += a.work[((size_t)i * jobs + job) * per_job + k];
    if (proj) {
      if (k < C * C) a.dwl[k] = s;
      else a.dbl[k - C * C] = s;
    } else if (k < C * C) {
      if (job == 0) a.dw1[(size_t)j * C * C + k] = s;
      else a.dw3[((size_t)j * 3 + job - 1) * C * C + k] = s;
    } else if (job == 0) {
      a.db1[(size_t)j * C + k - C * C] = s;
    } else if (job == 2) {
      a.db3[(size_t)j * C + k - C * C] = s;
    }
  }
}

// Out-projection sweep tile: g_proj = ((mask gz) Wl^T) nonlin'(nonlin(x_fin))
__device__ void proj_sweep_tile(const SweepArgs& a, int b, int t0, float* smem) {
  float* Ds = smem;
  float* Ws = Ds + TM * C;
  const int T = a.t_fin;
  const int len = a.lengths[b] >> a.shift_fin;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  for (int i = threadIdx.x; i < TM * C; i += NT) {
    const int t = t0 + i / C;
    Ds[i] = (t < T && t < len) ? a.gz[((size_t)b * T + t) * C + i % C] : 0.f;
  }
  float acc[RPT][4] = {};
  matmul_acc(acc, Ds, Ws, a.wlt, C, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    const float4 xv = f4ld(a.x_fin + ((size_t)b * T + t) * C + 4 * tx);
    const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = acc[r][q] * nonlin_grad(nonlin(xq[q], a.leaky), a.leaky);
    f4st(a.g_proj + ((size_t)b * T + t) * C + 4 * tx, o);
  }
}

// Step A of layer j, rows [t0, t0 + TM) of video b: gm and dz (see the top)
__device__ void sweep_a_tile(const SweepArgs& a, int j, int b, int t0, float* smem) {
  const SweepLayer& L = a.layer[j];
  float* Hs = smem;               // [TM][C] h (pooled layers: for u)
  float* Ds = Hs + TM * C;        // [TM][C] dy
  float* Ws = Ds + TM * C;        // [KC][C]
  const int T = L.T;
  const int len = a.lengths[b] >> L.shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  const size_t base = (size_t)b * T * C;
  float gmv[RPT][4];
  float acc[RPT][4] = {};
  if (L.pool) {
    for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
      const int t = t0 + i / (C / 4);
      reinterpret_cast<float4*>(Hs)[i] =
          t < T ? f4ld(L.h + base + (size_t)t * C + 4 * (i % (C / 4))) : f4zero();
    }
    matmul_acc(acc, Hs, Ws, a.w1 + (size_t)j * C * C, C, tx, row0);
    const float* b1 = a.b1 + (size_t)j * C;
    const int T2 = T / 2;
#pragma unroll
    for (int r = 0; r < RPT; r += 2) {
      const int t = t0 + row0 + r;  // even: the pair (t, t + 1)
      float u[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int ts = t + s;
        float4 m = make_float4(1.f, 1.f, 1.f, 1.f), xv = f4zero();
        if (ts < T) {
          if (L.drop) m = f4ld(L.drop + base + (size_t)ts * C + 4 * tx);
          xv = f4ld(L.x + base + (size_t)ts * C + 4 * tx);
        }
        const float mq[4] = {m.x, m.y, m.z, m.w}, xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[s][q] = ts < len ? (acc[r + s][q] + b1[4 * tx + q]) * mq[q] + xq[q] : 0.f;
      }
      const int j2 = t >> 1;
      float4 gv = f4zero();
      if (j2 < T2) gv = f4ld(L.g + ((size_t)b * T2 + j2) * C + 4 * tx);
      const float gq[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool second = u[1][q] > u[0][q];  // ties route to the first
        gmv[r][q] = (t < len && !second) ? gq[q] : 0.f;
        gmv[r + 1][q] = (t + 1 < len && second) ? gq[q] : 0.f;
        acc[r][q] = acc[r + 1][q] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = t0 + row0 + r;
      float4 gv = f4zero();
      if (t < T && t < len) gv = f4ld(L.g + base + (size_t)t * C + 4 * tx);
      gmv[r][0] = gv.x;
      gmv[r][1] = gv.y;
      gmv[r][2] = gv.z;
      gmv[r][3] = gv.w;
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
    if (t < T) {
      f4st(a.gm + base + (size_t)t * C + 4 * tx, gmv[r]);
      if (L.drop) m = f4ld(L.drop + base + (size_t)t * C + 4 * tx);
    }
    const float mq[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) Ds[(row0 + r) * C + 4 * tx + q] = gmv[r][q] * mq[q];
  }
  matmul_acc(acc, Ds, Ws, a.w1t + (size_t)j * C * C, C, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < len) {
      const float4 hv = f4ld(L.h + base + (size_t)t * C + 4 * tx);
      const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = acc[r][q] * nonlin_grad(hq[q], a.leaky);
    }
    f4st(a.dz + base + (size_t)t * C + 4 * tx, o);
  }
}

// Step B's dx tile of layer j: g_in = mask(conv3^T(dz) + gm)
__device__ void sweep_dx_tile(const SweepArgs& a, int j, int b, int t0, float* smem) {
  const SweepLayer& L = a.layer[j];
  float* As = smem;              // [3][TM][C] dz[t+d], dz[t], dz[t-d]
  float* Ws = As + 3 * TM * C;
  const int T = L.T;
  const int len = a.lengths[b] >> L.shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  const size_t base = (size_t)b * T * C;
  stage_taps(As, a.dz + base, t0, T, -L.d, len);
  float acc[RPT][4] = {};
  matmul_acc(acc, As, Ws, a.w3t + (size_t)j * 3 * C * C, 3 * C, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < len) {
      const float4 gm = f4ld(a.gm + base + (size_t)t * C + 4 * tx);
      o[0] = acc[r][0] + gm.x;
      o[1] = acc[r][1] + gm.y;
      o[2] = acc[r][2] + gm.z;
      o[3] = acc[r][3] + gm.w;
    }
    f4st(L.g_in + base + (size_t)t * C + 4 * tx, o);
  }
}

__global__ void __launch_bounds__(NT, 2) v2_sweep_kernel(const __grid_constant__ SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  bool pending = false;  // the layer (or out-projection) just swept awaits its reduce
  if (a.gz) {
    const int tiles = (a.t_fin + TM - 1) / TM, rows = a.B * a.t_fin;
    const int n_tiles = a.B * tiles, items = n_tiles + n_splits(rows);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      __syncthreads();
      if (item < n_tiles)
        proj_sweep_tile(a, item / tiles, (item % tiles) * TM, smem);
      else
        wgrad_item(a.x_fin, a.gz, nullptr, 0, 1, 1, a.t_fin, a.shift_fin, a.lengths, rows,
                   item - n_tiles, 0, 1, a.leaky, a.work, smem);
    }
    grid.sync();  // g_proj is read by the last layer; the partials by its reduce
    pending = true;
  }
  for (int j = a.n - 1; j >= 0; --j) {
    const SweepLayer& L = a.layer[j];
    const int tiles = (L.T + TM - 1) / TM, n_tiles = a.B * tiles;
    for (int item = blockIdx.x; item < n_tiles; item += gridDim.x) {
      __syncthreads();
      sweep_a_tile(a, j, item / tiles, (item % tiles) * TM, smem);
    }
    if (pending) reduce_partials(a, (j + 1 < a.n) ? j + 1 : -1);
    grid.sync();  // dz is read at t +- d; gm, dz by the weight gradients
    const int rows = a.B * L.T, items = n_tiles + 4 * n_splits(rows);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      __syncthreads();
      if (item < n_tiles) {
        sweep_dx_tile(a, j, item / tiles, (item % tiles) * TM, smem);
      } else {
        // jobs: 0 (h, dy) -> dW1, db1; 1-3 (x shifted by -d, 0, +d, dz) -> dW3[k], db3
        const int w = item - n_tiles, split = w / 4, job = w % 4;
        const int off = job == 1 ? -L.d : (job == 3 ? L.d : 0);
        wgrad_item(job == 0 ? L.h : L.x, job == 0 ? a.gm : a.dz, job == 0 ? L.drop : nullptr,
                   off, 0, 0, L.T, L.shift, a.lengths, rows, split, job, 4, a.leaky, a.work,
                   smem);
      }
    }
    grid.sync();  // g_in feeds the layer below; the partials its reduce
    pending = true;
  }
  reduce_partials(a, 0);
}

template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int smem, void* arg, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {arg};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(NT), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One forward chunk (see the top of the file).  Host tables, per layer of
// the chunk in order: ptrs[4 j ..] = x, y, hs, drop (drop may be null),
// ints[4 j ..] = T, d, pools before it, pooled.  w3 / b3 / w1 / b1 point at
// the chunk's first layer; z (with wl, bl) is null except on the last chunk.
extern "C" int mucon_wavenet_train_v2_fwd(void* const* ptrs, const int* ints, int n,
                                          const float* w3, const float* b3, const float* w1,
                                          const float* b1, const float* wl, const float* bl,
                                          float* z, const int* lengths, int B, int channels,
                                          int t_fin, int shift_fin, int leaky,
                                          cudaStream_t stream) {
  if (channels != C || B <= 0 || n < 1 || n > MAX_LAYERS) return cudaErrorInvalidValue;
  FwdArgs a = {};
  for (int j = 0; j < n; ++j) {
    a.layer[j] = FwdLayer{static_cast<const float*>(ptrs[4 * j]),
                          static_cast<float*>(ptrs[4 * j + 1]),
                          static_cast<float*>(ptrs[4 * j + 2]),
                          static_cast<const float*>(ptrs[4 * j + 3]),
                          ints[4 * j], ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3]};
    if (a.layer[j].T <= 0) return cudaErrorInvalidValue;
  }
  a.w3 = w3; a.b3 = b3; a.w1 = w1; a.b1 = b1; a.wl = wl; a.bl = bl; a.z = z;
  a.lengths = lengths; a.n = n; a.B = B; a.t_fin = t_fin; a.shift_fin = shift_fin;
  a.leaky = leaky;
  return launch_cooperative(v2_fwd_kernel, FWD_SMEM, &a, stream);
}

// Floats of the sweep's `work` buffer for layers of at most `rows` = B * T rows.
extern "C" int mucon_wavenet_train_v2_work_floats(int rows) {
  const int s = rows / 256;
  return (s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s)) * 4 * (C + 1) * C;
}

// One sweep chunk.  Host tables, per layer of the chunk in layer order:
// ptrs[5 j ..] = x, h, drop (or null), g, g_in; ints[4 j ..] = T, d, pools
// before it, pooled.  On the last chunk gz (with x_fin, wlt = Wl^T, dwl,
// dbl) is given and the kernel writes the last layer's g itself; otherwise
// gz is null.  scratch holds 2 * B * T_lo * C floats (gm, dz).
extern "C" int mucon_wavenet_train_v2_sweep(
    void* const* ptrs, const int* ints, int n, const float* w3t, const float* w1,
    const float* w1t, const float* b1, float* dw3, float* db3, float* dw1, float* db1,
    const float* gz, const float* x_fin, const float* wlt, float* dwl, float* dbl,
    float* scratch, float* work, const int* lengths, int B, int channels, int t_fin,
    int shift_fin, int leaky, cudaStream_t stream) {
  if (channels != C || B <= 0 || n < 1 || n > MAX_LAYERS) return cudaErrorInvalidValue;
  SweepArgs a = {};
  for (int j = 0; j < n; ++j) {
    a.layer[j] = SweepLayer{static_cast<const float*>(ptrs[5 * j]),
                            static_cast<const float*>(ptrs[5 * j + 1]),
                            static_cast<const float*>(ptrs[5 * j + 2]),
                            static_cast<const float*>(ptrs[5 * j + 3]),
                            static_cast<float*>(ptrs[5 * j + 4]),
                            ints[4 * j], ints[4 * j + 1], ints[4 * j + 2], ints[4 * j + 3]};
    if (a.layer[j].T <= 0 || a.layer[j].T > a.layer[0].T) return cudaErrorInvalidValue;
  }
  a.w3t = w3t; a.w1 = w1; a.w1t = w1t; a.b1 = b1;
  a.dw3 = dw3; a.db3 = db3; a.dw1 = dw1; a.db1 = db1;
  a.gz = gz; a.x_fin = x_fin; a.wlt = wlt; a.dwl = dwl; a.dbl = dbl;
  a.g_proj = gz ? static_cast<float*>(ptrs[5 * (n - 1) + 3]) : nullptr;
  a.gm = scratch;
  a.dz = scratch + (size_t)B * a.layer[0].T * C;
  a.work = work; a.lengths = lengths;
  a.n = n; a.B = B; a.t_fin = t_fin; a.shift_fin = shift_fin; a.leaky = leaky;
  return launch_cooperative(v2_sweep_kernel, SWEEP_SMEM, &a, stream);
}
