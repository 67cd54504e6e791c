// Fused WaveNet eval stack, one launch per residual layer (plus one for the
// out-projection), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_stack_kernel_v2` / `wavenet_stack_pallas_v2`
// (mucon_tpu/ops/wavenet_pallas_v2.py:67, :151).  That kernel kept the whole
// [B x T x C] batch in VMEM and ran all layers in one program; here a CTA owns
// TM output rows of one video x all C = 128 channels of one layer:
//
//   z = x[t-d] W3[0] + x[t] W3[1] + x[t+d] W3[2] + b3   ([TM,3C] @ [3C,C])
//   y = nonlin(z) W1 + b1 + x[t], zeroed at t >= length
//   pool layers: max (or mean * 2) of row pairs, zeroed at t/2 >= length/2
//
// The three shifted input tiles, one weight chunk and the nonlin(z) tile live
// in shared memory (80 KiB); taps outside [0, T) or past the video's length
// read zeros, so |d| >= T (d = 512, 1024 at T = 160) needs no special case.
// The final launch (final_proj = 1) computes nonlin(x) Wl + bl, masked.
//
// Bound: f32 FMAs on the CUDA cores (~0.5 GFLOP per [row x layer] batch of
// 128 videos), no tensor cores yet; each activation row is read three times
// from L2/HBM per layer and written once.  Plain SIMT tiling: each thread
// keeps a 4-row x 4-column accumulator tile, weights are staged KC rows at a
// time and read as float4, input rows are shared-memory broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int C = 128;                  // channels (the model's hidden_size)
constexpr int TM = 32;                  // pre-pool output rows per CTA
constexpr int NT = 256;                 // threads per CTA
constexpr int KC = 32;                  // weight rows staged per chunk
constexpr int RPT = TM / (NT / 32);     // rows per thread (4)
constexpr int SMEM_BYTES = (3 * TM * C + KC * C + TM * C) * 4;

static_assert(C == 128, "one warp covers C as 32 lanes x float4");
static_assert(C % KC == 0 && RPT % 2 == 0, "chunking and row pairs");

__device__ __forceinline__ float nonlin(float v, int leaky) {
  return leaky ? (v > 0.f ? v : 0.01f * v) : fmaxf(v, 0.f);
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

__global__ void __launch_bounds__(NT) wavenet_layer_kernel(
    const float* __restrict__ x,        // [B, T, C]
    float* __restrict__ y,              // [B, T or T/2, C]
    const int* __restrict__ lengths,    // [B] input frame counts
    const float* __restrict__ w3,       // [3, C, C] (unused when final_proj)
    const float* __restrict__ b3,       // [C]
    const float* __restrict__ w1,       // [C, C]
    const float* __restrict__ b1,       // [C]
    int T, int d, int len_shift, int pool, int pool_mean, int leaky,
    int final_proj) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [3][TM][C] taps t-d, t, t+d
  float* Ws = As + 3 * TM * C;                   // [KC][C] weight chunk
  float* Zs = Ws + KC * C;                       // [TM][C] nonlin(z)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  const float* xb = x + (size_t)b * T * C;

  for (int i = threadIdx.x; i < 3 * TM * (C / 4); i += NT) {
    const int j = i / (TM * C / 4);
    const int r = (i / (C / 4)) % TM;
    const int c4 = i % (C / 4);
    const int t = t0 + r + (j - 1) * d;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((j == 1 || !final_proj) && t >= 0 && t < T && t < len)
      v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C) + c4);
    reinterpret_cast<float4*>(As)[i] = v;
  }
  __syncthreads();

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  if (!final_proj) {
    for (int kc = 0; kc < 3 * C; kc += KC) {
      if (kc) __syncthreads();  // previous chunk consumed
      stage_rows(Ws, w3 + (size_t)kc * C, KC);
      __syncthreads();
      mma_chunk(acc, As + (kc / C) * TM * C, kc % C, Ws, tx, row0);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 4 * tx + q;
        Zs[(row0 + r) * C + col] = nonlin(acc[r][q] + b3[col], leaky);
        acc[r][q] = 0.f;
      }
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = (row0 + r) * C + 4 * tx + q;
        Zs[idx] = nonlin(As[TM * C + idx], leaky);
      }
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
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      float val = acc[r][q] + b1[col];
      if (!final_proj) val += As[TM * C + (row0 + r) * C + col];  // residual
      v[r][q] = t < len ? val : 0.f;
    }
  }

  if (!pool) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = t0 + row0 + r;
      if (t < T)
        reinterpret_cast<float4*>(y + ((size_t)b * T + t) * C)[tx] =
            make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
    }
    return;
  }
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
      const float pv = pool_mean ? ((a + c) * 0.5f) * 2.0f : fmaxf(a, c);
      p[q] = t2 < len2 ? pv : 0.f;
    }
    reinterpret_cast<float4*>(y + ((size_t)b * T2 + t2) * C)[tx] =
        make_float4(p[0], p[1], p[2], p[3]);
  }
}

}  // namespace

// One layer of the stack (final_proj = 0) or the out-projection
// (final_proj = 1, w1/b1 = Wl/bl).  T must be even when pool = 1.
extern "C" int mucon_wavenet_layer(const float* x, float* y, const int* lengths,
                                   const float* w3, const float* b3,
                                   const float* w1, const float* b1, int B, int T,
                                   int channels, int d, int len_shift, int pool,
                                   int pool_mean, int leaky, int final_proj,
                                   cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && (T % 2))) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TM - 1) / TM, B);
  wavenet_layer_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      x, y, lengths, w3, b3, w1, b1, T, d, len_shift, pool, pool_mean, leaky,
      final_proj);
  return cudaGetLastError();
}
