// Fused MS-TCN++ first stage (eval), one launch per dual-dilation layer plus
// one for the out-projection, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_mstcnpp_kernel` / `mstcnpp_stack_pallas`
// (mucon_tpu/ops/mstcnpp_pallas.py:72, :151).  That kernel kept the whole
// [B x T x C] batch in VMEM and ran all layers in one program; here a CTA owns
// TM output rows of one video x all C = 128 channels of one layer, as the
// WaveNet eval kernel (wavenet_stack.cu) does.  Layer i (d1 = 2^(L-1-i),
// d2 = 2^i):
//
//   y1 = f[t-d1] W3a[0] + f[t] W3a[1] + f[t+d1] W3a[2] + b3a
//   y2 = f[t-d2] W3b[0] + f[t] W3b[1] + f[t+d2] W3b[2] + b3b
//   f' = relu(y1 W1t + y2 W1b + b1) + f[t], zeroed at t >= length
//   pool layers: max of row pairs, zeroed at t/2 >= length/2
//
// The five input rows of an output row (t-d1, t+d1, t-d2, t+d2 and t) are
// staged in shared memory; taps outside [0, T) or past the video's length
// read zeros, so d >= T (d2 = 512, 1024 at T = 160) needs no special case.
// y1 and y2 go to two shared tiles; the concat-then-1x1 is the two halves
// of the 2C -> C kernel, summed.  The out-projection launch computes
// f Wout + bout with NO nonlinearity (unlike WaveNet's), masked.
//
// Shared memory per CTA at TM = 32: five tap tiles (80 KiB), two y tiles
// (32 KiB) and one KC x C weight chunk (16 KiB) = 128 KiB, one CTA per SM.
//
// Bound: f32 FMAs on the CUDA cores (16 C^2 operations per valid row and
// layer, twice WaveNet's), no tensor cores yet.  Plain SIMT tiling: each
// thread keeps a 4-row x 4-column accumulator tile, weights are staged KC
// rows at a time and read as float4, input rows are shared-memory broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int C = 128;                  // channels (the model's hidden_size)
constexpr int TM = 32;                  // pre-pool output rows per CTA
constexpr int NT = 256;                 // threads per CTA
constexpr int KC = 32;                  // weight rows staged per chunk
constexpr int RPT = TM / (NT / 32);     // rows per thread (4)
constexpr int LAYER_SMEM = (5 * TM * C + 2 * TM * C + KC * C) * 4;
constexpr int PROJ_SMEM = (TM * C + KC * C) * 4;

static_assert(C == 128, "one warp covers C as 32 lanes x float4");
static_assert(C % KC == 0 && RPT % 2 == 0, "chunking and row pairs");

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

// acc += A[0] W[0] + A[1] W[1] + A[2] W[2] for the three tap tiles A[k]
// (W [3][C][C] in global memory), one KC-row weight chunk at a time
__device__ __forceinline__ void conv3_acc(float (&acc)[RPT][4], const float* const (&A)[3],
                                          float* Ws, const float* __restrict__ w,
                                          int tx, int row0) {
  for (int kc = 0; kc < 3 * C; kc += KC) {
    __syncthreads();  // taps staged / previous chunk consumed
    stage_rows(Ws, w + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, A[kc / C], kc % C, Ws, tx, row0);
  }
}

// Y[row0 + r][4 tx + q] = acc + b, then acc = 0
__device__ __forceinline__ void store_tile(float (&acc)[RPT][4], float* Y,
                                           const float* __restrict__ b, int tx, int row0) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      Y[(row0 + r) * C + col] = acc[r][q] + b[col];
      acc[r][q] = 0.f;
    }
}

__global__ void __launch_bounds__(NT) mstcnpp_layer_kernel(
    const float* __restrict__ f,        // [B, T, C] layer input (masked)
    float* __restrict__ y,              // [B, T or T/2, C] layer output
    const int* __restrict__ lengths,    // [B] input frame counts
    const float* __restrict__ w3a,      // [3, C, C] d1 conv
    const float* __restrict__ b3a,      // [C]
    const float* __restrict__ w3b,      // [3, C, C] d2 conv
    const float* __restrict__ b3b,      // [C]
    const float* __restrict__ w1t,      // [C, C] top half of the 2C -> C kernel
    const float* __restrict__ w1b,      // [C, C] bottom half
    const float* __restrict__ b1,       // [C]
    int T, int d1, int d2, int len_shift, int pool) {
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);  // [5][TM][C] t-d1, t+d1, t-d2, t+d2, t
  float* Y1 = Fs + 5 * TM * C;                   // [TM][C] y1
  float* Y2 = Y1 + TM * C;                       // [TM][C] y2
  float* Ws = Y2 + TM * C;                       // [KC][C] weight chunk

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  const float* fb = f + (size_t)b * T * C;
  const int offs[5] = {-d1, d1, -d2, d2, 0};

  for (int i = threadIdx.x; i < 5 * TM * (C / 4); i += NT) {
    const int j = i / (TM * C / 4);
    const int r = (i / (C / 4)) % TM;
    const int c4 = i % (C / 4);
    const int t = t0 + r + offs[j];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T && t < len)
      v = __ldg(reinterpret_cast<const float4*>(fb + (size_t)t * C) + c4);
    reinterpret_cast<float4*>(Fs)[i] = v;
  }
  const float* center = Fs + 4 * TM * C;

  float acc[RPT][4] = {};
  // tap order shift(-d) W[0] + x W[1] + shift(+d) W[2] (mstcnpp_pallas.py:60)
  const float* const taps1[3] = {Fs, center, Fs + TM * C};
  conv3_acc(acc, taps1, Ws, w3a, tx, row0);
  store_tile(acc, Y1, b3a, tx, row0);
  const float* const taps2[3] = {Fs + 2 * TM * C, center, Fs + 3 * TM * C};
  conv3_acc(acc, taps2, Ws, w3b, tx, row0);
  store_tile(acc, Y2, b3b, tx, row0);

  for (int kc = 0; kc < 2 * C; kc += KC) {
    __syncthreads();  // Y1 / Y2 complete / previous chunk consumed
    stage_rows(Ws, (kc < C ? w1t + (size_t)kc * C : w1b + (size_t)(kc - C) * C), KC);
    __syncthreads();
    mma_chunk(acc, kc < C ? Y1 : Y2, kc % C, Ws, tx, row0);
  }

  float v[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * tx + q;
      const float val = fmaxf(acc[r][q] + b1[col], 0.f) + center[(row0 + r) * C + col];
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
    for (int q = 0; q < 4; ++q) p[q] = t2 < len2 ? fmaxf(v[r][q], v[r + 1][q]) : 0.f;
    reinterpret_cast<float4*>(y + ((size_t)b * T2 + t2) * C)[tx] =
        make_float4(p[0], p[1], p[2], p[3]);
  }
}

// z = mask(f Wout + bout): the out-projection, no nonlinearity
__global__ void __launch_bounds__(NT) mstcnpp_proj_kernel(
    const float* __restrict__ f, float* __restrict__ z, const int* __restrict__ lengths,
    const float* __restrict__ w_out, const float* __restrict__ b_out, int T, int len_shift) {
  extern __shared__ float4 smem4[];
  float* Fs = reinterpret_cast<float*>(smem4);  // [TM][C]
  float* Ws = Fs + TM * C;                       // [KC][C]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int len = lengths[b] >> len_shift;
  const int tx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  for (int i = threadIdx.x; i < TM * (C / 4); i += NT) {
    const int t = t0 + i / (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T && t < len)
      v = __ldg(reinterpret_cast<const float4*>(f + ((size_t)b * T + t) * C) + i % (C / 4));
    reinterpret_cast<float4*>(Fs)[i] = v;
  }
  float acc[RPT][4] = {};
  for (int kc = 0; kc < C; kc += KC) {
    __syncthreads();
    stage_rows(Ws, w_out + (size_t)kc * C, KC);
    __syncthreads();
    mma_chunk(acc, Fs, kc, Ws, tx, row0);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + row0 + r;
    if (t >= T) continue;
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = t < len ? acc[r][q] + b_out[4 * tx + q] : 0.f;
    reinterpret_cast<float4*>(z + ((size_t)b * T + t) * C)[tx] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// One dual-dilation layer (d1, d2); T must be even when pool = 1.
extern "C" int mucon_mstcnpp_layer(const float* f, float* y, const int* lengths,
                                   const float* w3a, const float* b3a, const float* w3b,
                                   const float* b3b, const float* w1t, const float* w1b,
                                   const float* b1, int B, int T, int channels, int d1,
                                   int d2, int len_shift, int pool, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0 || (pool && (T % 2))) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mstcnpp_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LAYER_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TM - 1) / TM, B);
  mstcnpp_layer_kernel<<<grid, NT, LAYER_SMEM, stream>>>(
      f, y, lengths, w3a, b3a, w3b, b3b, w1t, w1b, b1, T, d1, d2, len_shift, pool);
  return cudaGetLastError();
}

// The out-projection z = mask(f Wout + bout).
extern "C" int mucon_mstcnpp_proj(const float* f, float* z, const int* lengths,
                                  const float* w_out, const float* b_out, int B, int T,
                                  int channels, int len_shift, cudaStream_t stream) {
  if (channels != C || B <= 0 || T <= 0) return cudaErrorInvalidValue;
  const dim3 grid((T + TM - 1) / TM, B);
  mstcnpp_proj_kernel<<<grid, NT, PROJ_SMEM, stream>>>(f, z, lengths, w_out, b_out, T,
                                                       len_shift);
  return cudaGetLastError();
}
