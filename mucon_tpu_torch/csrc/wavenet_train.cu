// Trainable WaveNet residual stack, forward with activation stash and
// backward sweep, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU programs of `wavenet_stack_train_v3`
// (mucon_tpu/ops/wavenet_train_pallas_v3.py): `_fwd_kernel_v3` /
// `_fwd_call_v3` (:134, :358), `_sweep_kernel_v3` / `_sweep_call_v3` (:200,
// :449) and the XLA pool glue between them (`_pool2_fwd_xla` :91,
// `_pool2_bwd_xla` :103).  The TPU version groups equal-T layers into one
// program only to fit Mosaic's compile budget; here every launch is one
// layer, as in the eval kernel (wavenet_stack.cu), and the pool and its
// gradient routing are fused into the layer kernels.
//
// Forward, one launch per layer (layer i: t frames, dilation d, dropout mask
// m [B, t, C] or none):
//   h  = nonlin(x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3)   -> stash hs
//   u  = mask (m * (h W1 + b1) + x)                 (pooled layer: -> stash)
//   x' = u, or pool2(u) masked at len/2 (max: first of a tie; sum: mean * 2)
// The layer input x is the previous launch's output and stays in memory as
// the stash the sweep reads; nothing else is copied.  The out-projection
// runs as the eval kernel's final_proj launch.
//
// Backward, one `mucon_wavenet_train_sweep` call per layer (last first), four
// kernels:
//   1. dz:  gm = mask (g, or g routed through the pool with the stashed u),
//           dy = gm * m,  dz = (dy W1^T) * nonlin'(h)          (writes dy, dz)
//   2. dx:  g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
//   3. wgrad partials: dW1 = h^T dy, dW3[k] = shift(x, (k-1) d)^T dz and the
//           bias sums, each CTA over one span of the B*t rows
//   4. reduce: the spans' partials summed in span order.
// The out-projection's sweep is the same call with proj = 1: h = x_fin,
// W1 = Wl, no dropout, and kernel 1's dz is the gradient at x_fin.
//
// Weight gradients: each CTA of kernel 3 walks a contiguous span of rows and
// keeps one C x C partial in registers (8 x 8 per thread, outer products
// from shared memory); kernel 4 adds the spans in a fixed order.  No atomics,
// so every gradient is bitwise repeatable from run to run.
//
// Bound: f32 FMAs on the CUDA cores, as the eval kernel (no tensor cores);
// the backward does about twice the forward's multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int C = 128;                  // channels (the model's hidden_size)
constexpr int TM = 32;                  // rows per CTA in the row-tile kernels
constexpr int NT = 256;                 // threads per CTA
constexpr int KC = 32;                  // weight rows staged per chunk
constexpr int RPT = TM / (NT / 32);     // rows per thread (4)
constexpr int FWD_SMEM = (3 * TM * C + KC * C + TM * C) * 4;
constexpr int DZ_SMEM = (TM * C + KC * C) * 4;
constexpr int DX_SMEM = (3 * TM * C + KC * C) * 4;
constexpr int KR = 32;                  // rows staged per chunk in wgrad
constexpr int WG_SMEM = 2 * KR * C * 4;
constexpr int MAX_SPLITS = 128;

static_assert(C == 128, "one warp covers C as 32 lanes x float4");
static_assert(C % KC == 0 && RPT % 2 == 0, "chunking and row pairs");

__device__ __forceinline__ float nonlin(float v, int leaky) {
  return leaky ? (v > 0.f ? v : 0.01f * v) : fmaxf(v, 0.f);
}

// nonlin'(z) from h = nonlin(z): both keep the sign of z
__device__ __forceinline__ float nonlin_grad(float h, int leaky) {
  return h > 0.f ? 1.f : (leaky ? 0.01f : 0.f);
}

__device__ __forceinline__ float4 f4zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 f4ld(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int rows) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < rows * (C / 4); i += NT) d[i] = __ldg(s + i);
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

// Stage the three dilated taps of rows [t0, t0 + TM) of video b:
// tile j holds src[t + (j - 1) * d], zero outside [0, T) and at t >= len.
__device__ __forceinline__ void stage_taps(float* As, const float* __restrict__ src,
                                           int t0, int T, int d, int len) {
  for (int i = threadIdx.x; i < 3 * TM * (C / 4); i += NT) {
    const int j = i / (TM * C / 4);
    const int r = (i / (C / 4)) % TM;
    const int c4 = i % (C / 4);
    const int t = t0 + r + (j - 1) * d;
    float4 v = f4zero();
    if (t >= 0 && t < T && t < len)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)t * C) + c4);
    reinterpret_cast<float4*>(As)[i] = v;
  }
}

// acc = sum over the 3 taps of As[j] @ W[j] (W [3][C][C] in global memory)
__device__ __forceinline__ void conv3_acc(float (&acc)[RPT][4], const float* As,
                                          float* Ws, const float* __restrict__ w,
                                          int tx, int row0) {
  for (int kc = 0; kc < 3 * C; kc += KC) {
    if (kc) __syncthreads();  // previous chunk consumed
    stage_rows(Ws, w + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, As + (kc / C) * TM * C, kc % C, Ws, tx, row0);
  }
}

// The gradient at a layer's (masked) output, row t of video b, channels
// [4 c4, 4 c4 + 4): g itself, or for a pooled layer g_half [B, t/2, C] routed
// through the pool: max sends it to the first maximum of the pair in the
// stashed pre-pool u (torch max_pool1d), sum ("mean * 2") to both; an odd
// trailing frame gets 0.  Zero at t >= len.
__device__ __forceinline__ float4 grad_at(const float* __restrict__ g,
                                          const float* __restrict__ u, int b, int t,
                                          int T, int len, int c4, int pooled,
                                          int pool_mean) {
  if (t >= len) return f4zero();
  if (!pooled) return f4ld(g + ((size_t)b * T + t) * C + 4 * c4);
  const int T2 = T / 2, j = t >> 1;
  if (j >= T2) return f4zero();
  const float4 gv = f4ld(g + ((size_t)b * T2 + j) * C + 4 * c4);
  if (pool_mean) return gv;
  const float4 u0 = f4ld(u + ((size_t)b * T + 2 * j) * C + 4 * c4);
  const float4 u1 = f4ld(u + ((size_t)b * T + 2 * j + 1) * C + 4 * c4);
  if (t & 1)
    return make_float4(u1.x > u0.x ? gv.x : 0.f, u1.y > u0.y ? gv.y : 0.f,
                       u1.z > u0.z ? gv.z : 0.f, u1.w > u0.w ? gv.w : 0.f);
  return make_float4(u1.x > u0.x ? 0.f : gv.x, u1.y > u0.y ? 0.f : gv.y,
                     u1.z > u0.z ? 0.f : gv.z, u1.w > u0.w ? 0.f : gv.w);
}

__device__ __forceinline__ float4 f4mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// ---------------------------------------------------------------------------
// forward: one layer
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) train_fwd_kernel(
    const float* __restrict__ x,      // [B, T, C] layer input (masked)
    float* __restrict__ y,            // [B, T or T/2, C] layer output
    float* __restrict__ u_out,        // [B, T, C] pre-pool output (pool only)
    float* __restrict__ hs,           // [B, T, C] stash: nonlin(z)
    const int* __restrict__ lengths,  // [B] input frame counts
    const float* __restrict__ w3,     // [3, C, C]
    const float* __restrict__ b3,     // [C]
    const float* __restrict__ w1,     // [C, C]
    const float* __restrict__ b1,     // [C]
    const float* __restrict__ drop,   // [B, T, C] dropout mask or null
    int T, int d, int len_shift, int pool, int pool_mean, int leaky) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [3][TM][C] taps t-d, t, t+d
  float* Ws = As + 3 * TM * C;                   // [KC][C] weight chunk
  float* Zs = Ws + KC * C;                       // [TM][C] nonlin(z)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;

  stage_taps(As, x + (size_t)b * T * C, t0, T, d, len);
  __syncthreads();

  float acc[RPT][4] = {};
  conv3_acc(acc, As, Ws, w3, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float hv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      hv[q] = nonlin(acc[r][q] + b3[col], leaky);
      Zs[(row0 + r) * C + col] = hv[q];
      acc[r][q] = 0.f;
    }
    const int t = t0 + row0 + r;
    if (t < T)
      reinterpret_cast<float4*>(hs + ((size_t)b * T + t) * C)[tx] =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
  }

  for (int kc = 0; kc < C; kc += KC) {
    __syncthreads();  // Zs complete / previous chunk consumed
    stage_rows(Ws, w1 + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, Zs, kc, Ws, tx, row0);
  }

  float v[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
    if (drop && t < T) m = f4ld(drop + ((size_t)b * T + t) * C + 4 * tx);
    const float mq[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      const float val = (acc[r][q] + b1[col]) * mq[q] + As[TM * C + (row0 + r) * C + col];
      v[r][q] = t < len ? val : 0.f;
    }
  }

  float* full = pool ? u_out : y;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t < T)
      reinterpret_cast<float4*>(full + ((size_t)b * T + t) * C)[tx] =
          make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }
  if (!pool) return;
  const int T2 = T / 2;
  const int len2 = len >> 1;
#pragma unroll
  for (int r = 0; r < RPT; r += 2) {
    const int t2 = (t0 + row0 + r) >> 1;
    if (t2 >= T2) continue;
    float p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a = v[r][q], c = v[r + 1][q];
      const float pv = pool_mean ? ((a + c) * 0.5f) * 2.0f : (c > a ? c : a);
      p[q] = t2 < len2 ? pv : 0.f;
    }
    reinterpret_cast<float4*>(y + ((size_t)b * T2 + t2) * C)[tx] =
        make_float4(p[0], p[1], p[2], p[3]);
  }
}

// ---------------------------------------------------------------------------
// sweep 1: dy = gm * m, dz = (dy W1^T) * nonlin'(h), masked
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) sweep_dz_kernel(
    const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ h,      // [B, T, C] nonlin(z) (proj: x_fin)
    const float* __restrict__ drop,   // [B, T, C] or null
    const int* __restrict__ lengths,
    const float* __restrict__ w1t,    // [C, C] = W1^T
    float* __restrict__ dy, float* __restrict__ dz,
    int T, int len_shift, int pooled, int pool_mean, int leaky) {
  extern __shared__ float4 smem4[];
  float* Ds = reinterpret_cast<float*>(smem4);  // [TM][C] dy tile
  float* Ws = Ds + TM * C;                       // [KC][C]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;

  for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = i % (C / 4);
    const int t = t0 + r;
    float4 v = f4zero();
    if (t < T) {
      v = grad_at(g, u, b, t, T, len, c4, pooled, pool_mean);
      if (drop) v = f4mul(v, f4ld(drop + ((size_t)b * T + t) * C + 4 * c4));
      reinterpret_cast<float4*>(dy + ((size_t)b * T + t) * C)[c4] = v;
    }
    reinterpret_cast<float4*>(Ds)[i] = v;
  }

  float acc[RPT][4] = {};
  for (int kc = 0; kc < C; kc += KC) {
    __syncthreads();
    stage_rows(Ws, w1t + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, Ds, kc, Ws, tx, row0);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < len) {
      const float4 hv = f4ld(h + ((size_t)b * T + t) * C + 4 * tx);
      const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = acc[r][q] * nonlin_grad(hq[q], leaky);
    }
    reinterpret_cast<float4*>(dz + ((size_t)b * T + t) * C)[tx] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------------------
// sweep 2: g_in = mask (dz[t+d] W3[0]^T + dz[t] W3[1]^T + dz[t-d] W3[2]^T + gm)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) sweep_dx_kernel(
    const float* __restrict__ dz, const float* __restrict__ g,
    const float* __restrict__ u, const int* __restrict__ lengths,
    const float* __restrict__ w3t,    // [3, C, C]: W3[k]^T
    float* __restrict__ g_in, int T, int d, int len_shift, int pooled,
    int pool_mean) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [3][TM][C] dz[t+d], dz[t], dz[t-d]
  float* Ws = As + 3 * TM * C;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;

  stage_taps(As, dz + (size_t)b * T * C, t0, T, -d, len);
  __syncthreads();
  float acc[RPT][4] = {};
  conv3_acc(acc, As, Ws, w3t, tx, row0);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < len) {
      const float4 gm = grad_at(g, u, b, t, T, len, tx, pooled, pool_mean);
      o[0] = acc[r][0] + gm.x;
      o[1] = acc[r][1] + gm.y;
      o[2] = acc[r][2] + gm.z;
      o[3] = acc[r][3] + gm.w;
    }
    reinterpret_cast<float4*>(g_in + ((size_t)b * T + t) * C)[tx] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------------------
// sweep 3 + 4: weight gradients, partials per row span, then a fixed-order sum
// ---------------------------------------------------------------------------

// Job j of a layer: (A, row offset, B) with dW_j = sum_rows A[row + off]^T B[row]
//   0: (h, 0, dy) -> dW1, db1     1: (x, -d, dz) -> dW3[0]
//   2: (x, 0, dz) -> dW3[1], db3  3: (x, +d, dz) -> dW3[2]
// proj (one job): (nonlin(x_fin), 0, dy) -> dWl, dbl.
// work: [splits][jobs][C + 1][C]; row C holds the column sums of B.
__global__ void __launch_bounds__(NT) sweep_wgrad_kernel(
    const float* __restrict__ h, const float* __restrict__ x,
    const float* __restrict__ dy, const float* __restrict__ dz,
    float* __restrict__ work, int T, int rows, int span, int d, int proj,
    int leaky) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [KR][C]
  float* Bs = As + KR * C;                       // [KR][C]

  const int split = blockIdx.x, job = blockIdx.y, jobs = gridDim.y;
  const float* A = (job == 0) ? h : x;  // proj: h = x_fin, A = nonlin(x_fin)
  const float* Bm = (job == 0) ? dy : dz;
  const int off = (job == 1) ? -d : (job == 3 ? d : 0);
  const int a_nonlin = proj;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // 16 x 16 threads

  float acc[8][8] = {};
  float bsum = 0.f;
  const int r_lo = split * span;
  const int r_hi = min(rows, r_lo + span);
  for (int r0 = r_lo; r0 < r_hi; r0 += KR) {
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < KR * (C / 4); i += NT) {
      const int rr = i / (C / 4), c4 = i % (C / 4);
      const int row = r0 + rr;
      float4 a = f4zero(), bv = f4zero();
      if (row < r_hi) {
        bv = f4ld(Bm + (size_t)row * C + 4 * c4);
        const int t = row % T, ts = t + off;
        if (ts >= 0 && ts < T) {
          a = f4ld(A + ((size_t)(row - t) + ts) * C + 4 * c4);
          if (a_nonlin)
            a = make_float4(nonlin(a.x, leaky), nonlin(a.y, leaky),
                            nonlin(a.z, leaky), nonlin(a.w, leaky));
        }
      }
      reinterpret_cast<float4*>(As)[i] = a;
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
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
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

__global__ void sweep_reduce_kernel(const float* __restrict__ work, int splits,
                                    int jobs, float* __restrict__ dw1,
                                    float* __restrict__ db1, float* __restrict__ dw3,
                                    float* __restrict__ db3) {
  const int per_job = (C + 1) * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= jobs * per_job) return;
  const int job = e / per_job, k = e % per_job;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += work[((size_t)i * jobs + job) * per_job + k];
  if (k < C * C) {
    if (job == 0) dw1[k] = s;
    else dw3[(size_t)(job - 1) * C * C + k] = s;
  } else if (job == 0) {
    db1[k - C * C] = s;
  } else if (job == 2) {
    db3[k - C * C] = s;
  }
}

}  // namespace

// One layer of the stack's forward (see the top of the file).  `u_out` is
// written only when pool = 1; `drop` may be null (no dropout).
extern "C" int mucon_wavenet_train_fwd(const float* x, float* y, float* u_out,
                                       float* hs, const int* lengths,
                                       const float* w3, const float* b3,
                                       const float* w1, const float* b1,
                                       const float* drop, int B, int T, int channels,
                                       int d, int len_shift, int pool, int pool_mean,
                                       int leaky, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && !u_out)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TM - 1) / TM, B);
  train_fwd_kernel<<<grid, NT, FWD_SMEM, stream>>>(x, y, u_out, hs, lengths, w3, b3, w1,
                                                   b1, drop, T, d, len_shift, pool,
                                                   pool_mean, leaky);
  return cudaGetLastError();
}

// Rows per span of the weight-gradient reduction for `rows` = B * T rows
// (the caller sizes `work` as splits * jobs * (C + 1) * C floats).
extern "C" int mucon_wavenet_train_splits(int rows) {
  const int s = rows / 256;
  return s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

// One layer of the backward sweep (proj = 0) or the out-projection's
// (proj = 1: h = x = x_fin, w1t = Wl^T, drop = null, w3t / g_in / dw3 / db3
// unused, and dz receives the gradient at x_fin).  g is [B, T/2, C] when
// pooled = 1 (the layer pooled; u is its pre-pool output), else [B, T, C].
extern "C" int mucon_wavenet_train_sweep(
    const float* g, const float* u, const float* x, const float* h,
    const float* drop, const int* lengths, const float* w1t, const float* w3t,
    float* dy, float* dz, float* g_in, float* work, float* dw1, float* db1,
    float* dw3, float* db3, int B, int T, int channels, int d, int len_shift,
    int pooled, int pool_mean, int leaky, int proj, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pooled && !u) || (proj && pooled))
    return cudaErrorInvalidValue;
  const void* fns[3] = {(const void*)sweep_dz_kernel, (const void*)sweep_dx_kernel,
                        (const void*)sweep_wgrad_kernel};
  const int smem[3] = {DZ_SMEM, DX_SMEM, WG_SMEM};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
    if (err != cudaSuccess) return err;
  }
  const dim3 tiles((T + TM - 1) / TM, B);
  sweep_dz_kernel<<<tiles, NT, DZ_SMEM, stream>>>(g, u, h, drop, lengths, w1t, dy, dz, T,
                                                 len_shift, pooled, pool_mean, leaky);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!proj) {
    sweep_dx_kernel<<<tiles, NT, DX_SMEM, stream>>>(dz, g, u, lengths, w3t, g_in, T, d,
                                                   len_shift, pooled, pool_mean);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int rows = B * T;
  const int splits = mucon_wavenet_train_splits(rows);
  const int span = ((rows + splits - 1) / splits + KR - 1) / KR * KR;
  const int jobs = proj ? 1 : 4;
  sweep_wgrad_kernel<<<dim3(splits, jobs), NT, WG_SMEM, stream>>>(
      h, x, dy, dz, work, T, rows, span, d, proj, leaky);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = jobs * (C + 1) * C;
  sweep_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(work, splits, jobs, dw1, db1,
                                                          dw3, db3);
  return cudaGetLastError();
}
