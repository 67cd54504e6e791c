// The trainable WaveNet stack above C = 512 channels on Hopper's own
// tensor-core path (sm_90a): v2's forward (a launch a chunk of layers, the
// out-projection in the last) and the sweep (v3: a launch a layer, and one
// for the out-projection; v2: a launch a chunk, u recomputed), each in
// 3xTF32 and in the bf16-operand mode.  v3's forward runs on the eval
// stacks' entry points (wavenet_wgmma.cu `mucon_wgmma_layer`, which takes
// the dropout mask and keeps the stash, and `mucon_wgmma_proj`).  C is a
// runtime argument, a multiple of the 128-column slab (the wrappers
// zero-pad another C to it, `cuda.stack_width`).
//
// Replaces, above C = 512, the TPU kernels of wavenet_train_pallas_v3.py
// (`_fwd_kernel_v3` :134, `pallas_call` :358; `_sweep_kernel_v3` :200,
// `pallas_call` :449) and wavenet_train_pallas_v2.py (:430, :557), as the
// 128 / 256 / 512 instances of wavenet_train.cu and wavenet_train_v2.cu do
// at those widths.
//
// Every launch is one cooperative kernel that runs a program of passes
// (wavenet_wgmma.cuh's kinds) with a grid barrier between them.  The host
// writes the program, every pass's arguments and tensor maps, into the
// kernel's parameters (`Prog`, read-only in the constant bank, so that a
// pass's arguments take no registers from the products' sums):
//
//   v2 forward, a layer:  K_CONV (h, the stash), K_RES (y; u of a pooled
//                      layer) ... then K_PROJ where the chunk holds the out-projection
//   sweep, the out-projection (proj):  K_TRANS (gz), K_DZ (the gradient at
//                      x_fin, from gz and Wl), K_WGRAD (dWl), K_REDUCE (dbl too)
//   sweep, a layer:    [K_RES, u recomputed from the stash: v2's pooled
//                      layers], K_DY, K_DZ, K_TRANS, K_DX, K_WGRAD, K_REDUCE
//
// v3 and v2 run the same passes on the same planes: z and every gradient
// of v2 equal v3's bit for bit, and the recomputed u the forward's, so the
// max pool routes alike.  A pass that reads what an earlier pass of the
// launch wrote does so after the grid barrier, whose every thread fences
// its generic writes against the async proxy (`fence.proxy.async.global`),
// as does the producer before its next TMA load.
//
// Bound: the tensor cores, 8 C^2 f32 operations a valid row and layer
// forward, 16 C^2 in the sweep, three TF32 products each in 3xTF32 (495 / 3
// TFLOP/s) or one bf16 product (989 TFLOP/s).
//
// The persistent CTAs (one an SM, 384 threads, pass_smem(B) bytes) must all
// be resident: launched only through `cudaLaunchCooperativeKernel`, which
// refuses a grid the card cannot hold.  A stuck barrier traps after ~2^24
// polls rather than hang the card.

#include <algorithm>

#include "wavenet_wgmma.cuh"

namespace {

// every CTA's writes before it are visible to every CTA after it, TMA loads
// included; traps rather than hang
__device__ __forceinline__ void grid_barrier(unsigned* cnt, unsigned target) {
  fence_async_global();
  __syncwarp();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(cnt) : "memory");
    unsigned v, tries = 0;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(cnt) : "memory");
      if (v >= target) break;
      if (++tries > (1u << 24)) __trap();
    }
    fence_async_global();
  }
  __syncthreads();
}

// A thread's state across a program's passes.
struct Ctx {
  GShared sh;
  RingPos pos;
  unsigned passes;  // passes started
  unsigned* cnt;
};

// One pass of a program, in the role P (the producer warpgroup, or the
// consumers): the grid barrier (but before the first pass), the live units'
// prefix, then the role's share.  Every thread runs the same passes in order.
template <bool BF, bool P, int KIND>
__device__ __forceinline__ void pass(const GArgs& a, const Maps& m, Ctx& c) {
  if (c.passes) grid_barrier(c.cnt, c.passes * gridDim.x);
  ++c.passes;
  if (threadIdx.x < 32) live_prefix(a, c.sh.pre, pass_unit<KIND>());
  __syncwarp();
  __syncthreads();
  if constexpr (P) produce<BF, KIND>(a, m, c.sh, c.pos);
  else consume<BF, KIND>(a, c.sh, c.pos);
}

// a program's pass: its kind, its arguments and its tensor maps (slots of
// Prog::maps: A, A of jobs 1-3, the weight planes or B, B of jobs 1-3)
struct PassDesc {
  GArgs a;
  int kind, ma, ma2, mw, mw2;
};

// The largest programs: a v2 forward chunk of MAX_LAYERS layers (2 passes a
// layer and the out-projection; maps: the planes and each layer's x and h,
// the out-projection's input), a v2 sweep chunk of SWEEP_LAYERS (7 passes
// a layer and 4 for the out-projection; maps: 9 shared and 3 a layer).
// Kernel parameters take at most 32764 bytes.
constexpr int SWEEP_LAYERS = 12;
constexpr int P_MAPS = 2 + 2 * MAX_LAYERS;
constexpr int P_PASSES = 7 * SWEEP_LAYERS + 4;
static_assert(9 + 3 * SWEEP_LAYERS <= P_MAPS && 2 * MAX_LAYERS + 1 <= P_PASSES, "a program");

struct Prog {
  CUtensorMap maps[P_MAPS];
  PassDesc pass[P_PASSES];
  unsigned* cnt;                  // the grid barrier's counter, 0 at launch
  int n, B;                       // passes, videos
};
static_assert(sizeof(Prog) <= 32764, "kernel parameters");

template <bool BF, bool P>
__device__ __forceinline__ void run_program(const Prog& p, Ctx& c) {
  for (int i = 0; i < p.n; ++i) {
    const PassDesc& d = p.pass[i];
    const Maps m{&p.maps[d.ma], &p.maps[d.ma2], &p.maps[d.mw], &p.maps[d.mw2]};
    switch (d.kind) {
      case K_CONV: pass<BF, P, K_CONV>(d.a, m, c); break;
      case K_RES: pass<BF, P, K_RES>(d.a, m, c); break;
      case K_PROJ: pass<BF, P, K_PROJ>(d.a, m, c); break;
      case K_DY: pass<BF, P, K_DY>(d.a, m, c); break;
      case K_TRANS: pass<BF, P, K_TRANS>(d.a, m, c); break;
      case K_DZ: pass<BF, P, K_DZ>(d.a, m, c); break;
      case K_DX: pass<BF, P, K_DX>(d.a, m, c); break;
      case K_WGRAD: pass<BF, P, K_WGRAD>(d.a, m, c); break;
      default: pass<BF, P, K_REDUCE>(d.a, m, c); break;
    }
  }
}

// the program in both roles: `setmaxnreg` moves registers from the producer
// warpgroup to the consumers once, for the whole launch
template <bool BF>
__global__ void __launch_bounds__(G_THREADS, 1) wgt_kernel(const __grid_constant__ Prog p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Ctx c{shared_setup(smem_raw), RingPos{0, 0}, 0, p.cnt};
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    c.pos.phase = ~0u;  // the empty barriers' first waits pass
    run_program<BF, true>(p, c);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    run_program<BF, false>(p, c);
  }
}

// ---------------------------------------------------------------------------
// host side: writing the programs
// ---------------------------------------------------------------------------

// a program being written: its maps and passes (nullptr maps stay unset)
struct Writer {
  Prog& p;
  int maps;
  cudaError_t err;

  // a map slot of an f32 [rows x C] activation in boxes of box_rows x 32
  int act(const void* ptr, long rows, int C, int box_rows, bool bf16 = false) {
    if (err != cudaSuccess) return 0;
    if (maps >= P_MAPS) {
      err = cudaErrorInvalidValue;
      return 0;
    }
    err = tensor_map(&p.maps[maps], ptr, bf16, rows, C, box_rows);
    return maps++;
  }
  template <bool BF>
  int planes(const void* wt, int nblk, int C) {
    if (err != cudaSuccess) return 0;
    err = weight_map<BF>(&p.maps[maps], wt, nblk, C);
    return maps++;
  }
  void add(int kind, const GArgs& a, int ma, int ma2 = 0, int mw = 0, int mw2 = 0) {
    if (p.n >= P_PASSES) {
      err = cudaErrorInvalidValue;
      return;
    }
    p.pass[p.n++] = PassDesc{a, kind, ma, ma2, mw, mw2};
  }
};

// a forward layer: x [B x T x C] -> y; h the stash; u a pooled layer's pre-pool u
struct FLayer {
  const float* x;
  float *y, *h, *u;
  const float* drop;
  int T, d, shift, pool;
};

// the forward's passes: each layer's conv and res, then (z non-null) the
// out-projection of the last layer's output; layer j's blocks at blk0 + 4j
template <bool BF>
void write_fwd(Writer& w, const FLayer* layers, int n, const void* wt, int nblk, int blk0,
               const float* b3, const float* b1, const float* bl, float* z, const int* lengths,
               int B, int C, int t_fin, int shift_fin, int leaky, int pool_mean) {
  const int planes = w.planes<BF>(wt, nblk, C);
  for (int j = 0; j < n; ++j) {
    const FLayer& L = layers[j];
    const long rows_j = (long)B * L.T;
    GArgs a = rows(lengths, nullptr, L.h, b3 + (size_t)j * C, B, L.T, C, C / GN, blk0 + 4 * j,
                   nblk, L.shift);
    a.d = L.d;
    a.leaky = leaky;
    w.add(K_CONV, a, w.act(L.x, rows_j, C, GM), 0, planes);
    a = rows(lengths, L.x, L.y, b1 + (size_t)j * C, B, L.T, C, C / GN, blk0 + 4 * j + 3, nblk,
             L.shift);
    a.pool = L.pool;
    a.pool_mean = pool_mean;
    a.leaky = leaky;
    a.drop = L.drop;
    a.u_out = L.u;
    w.add(K_RES, a, w.act(L.h, rows_j, C, GM), 0, planes);
  }
  if (z) {
    GArgs a = rows(lengths, nullptr, z, bl, B, t_fin, C, C / GN, nblk - 1, nblk, shift_fin);
    a.leaky = leaky;
    a.a_nonlin = 1;
    w.add(K_PROJ, a, w.act(layers[n - 1].y, (long)B * t_fin, C, GM), 0, planes);
  }
}

// a sweep layer: its input, stash, mask, the gradient at its output; the
// gradient at its input; the pre-pool u (the stash, or where the recompute
// writes it); its weight gradients
struct SLayer {
  const float *x, *h, *drop, *g;
  float *g_in, *u;
  float *dw3, *db3, *dw1, *db1;
  int T, d, shift, pool;
};

// the sweep's shared state: planes (swt the sweep's; fwt the forward's, for
// v2's recompute of u, or null), the dy and dz scratch of `rows` rows, the
// weight gradients' partials (work) and parts; and their B operands (see
// GArgs): K-major planes of tensors B x tc rows long (tc: the longest
// layer's T rounded up to 32) `plane` floats apart at bt, the runs'
// column sums at bsum, `nck` runs a tensor
struct SweepAt {
  const void *swt, *fwt;
  int nblk;
  float *dy, *dz, *work;
  long rows;
  int parts, parts_fin;
  const int* lengths;
  int B, C, leaky, pool_mean;
  float *bt, *bsum;
  int tc, plane, nck;
};

// a pass's B-operand fields
void set_bt(GArgs& a, const SweepAt& s, int tensors) {
  a.bt = s.bt;
  a.bsum = s.bsum;
  a.tensors = tensors;
  a.tc = s.tc;
  a.plane = s.plane;
  a.nck = s.nck;
}

// the map of B's planes of tensor i: C (bf16) or 2C (hi, lo) rows of B tc
template <bool BF>
int bt_map(Writer& w, const SweepAt& s, int i) {
  return w.act(s.bt + (size_t)i * s.plane, (long)(BF ? 1 : 2) * s.C, s.B * s.tc, GN, BF);
}

// the out-projection's sweep: its gradient at x_fin into g_proj (from gz
// and Wl, block blk), dWl and dbl
template <bool BF>
void write_proj_sweep(Writer& w, const SweepAt& s, int splanes, const float* gz,
                      const float* x_fin, float* g_proj, float* dwl, float* dbl, int blk,
                      int t_fin, int shift_fin) {
  const long n_rows = (long)s.B * t_fin;
  GArgs a = rows(s.lengths, gz, nullptr, nullptr, s.B, t_fin, s.C, 0, 0, 0, shift_fin);
  set_bt(a, s, 1);
  w.add(K_TRANS, a, 0);
  a = rows(s.lengths, x_fin, g_proj, nullptr, s.B, t_fin, s.C, s.C / GN, blk, s.nblk,
           shift_fin);
  a.leaky = s.leaky;
  a.proj = 1;
  w.add(K_DZ, a, w.act(gz, n_rows, s.C, GM), 0, splanes);
  a = rows(s.lengths, nullptr, s.work, nullptr, s.B, t_fin, s.C, 0, 0, 0, shift_fin);
  a.leaky = s.leaky;
  a.proj = 1;
  a.jobs = 1;
  a.parts = s.parts_fin;
  set_bt(a, s, 1);
  const int xf32 = w.act(x_fin, n_rows, s.C, GK), gzt = bt_map<BF>(w, s, 0);
  w.add(K_WGRAD, a, xf32, 0, gzt);
  a.dw1 = dwl;
  a.db1 = dbl;
  w.add(K_REDUCE, a, 0);
}

// layers n - 1 .. 0 of a sweep (layer j's blocks at blk0 + 4j; fplanes >= 0:
// each pooled layer's u recomputed first)
template <bool BF>
void write_sweep(Writer& w, const SweepAt& s, int splanes, int fplanes, const SLayer* layers,
                 int n, int blk0, const float* b1) {
  const int C = s.C, slabs = C / GN;
  const int dy64 = w.act(s.dy, s.rows, C, GM), dz64 = w.act(s.dz, s.rows, C, GM);
  const int dyt = bt_map<BF>(w, s, 0), dzt = bt_map<BF>(w, s, 1);
  for (int j = n - 1; j >= 0; --j) {
    const SLayer& L = layers[j];
    const long rows_j = (long)s.B * L.T;
    if (fplanes >= 0 && L.pool) {
      GArgs a = rows(s.lengths, L.x, nullptr, b1 + (size_t)j * C, s.B, L.T, C, slabs,
                     blk0 + 4 * j + 3, s.nblk, L.shift);
      a.pool = 1;
      a.pool_mean = s.pool_mean;
      a.leaky = s.leaky;
      a.drop = L.drop;
      a.u_out = L.u;
      w.add(K_RES, a, w.act(L.h, rows_j, C, GM), 0, fplanes);
    }
    GArgs a = rows(s.lengths, L.g, s.dy, nullptr, s.B, L.T, C, 0, 0, 0, L.shift);
    a.drop = L.drop;
    a.u = L.u;
    a.pool = L.pool;
    a.pool_mean = s.pool_mean;
    w.add(K_DY, a, 0);
    a = rows(s.lengths, L.h, s.dz, nullptr, s.B, L.T, C, slabs, blk0 + 4 * j + 3, s.nblk,
             L.shift);
    a.leaky = s.leaky;
    w.add(K_DZ, a, dy64, 0, splanes);
    a = rows(s.lengths, s.dy, nullptr, nullptr, s.B, L.T, C, 0, 0, 0, L.shift);
    a.u = s.dz;
    set_bt(a, s, 2);
    w.add(K_TRANS, a, 0);
    a = rows(s.lengths, L.g, L.g_in, nullptr, s.B, L.T, C, slabs, blk0 + 4 * j, s.nblk,
             L.shift);
    a.d = L.d;
    a.u = L.u;
    a.pool = L.pool;
    a.pool_mean = s.pool_mean;
    w.add(K_DX, a, dz64, 0, splanes);
    a = rows(s.lengths, nullptr, s.work, nullptr, s.B, L.T, C, 0, 0, 0, L.shift);
    a.d = L.d;
    a.leaky = s.leaky;
    a.jobs = 4;
    a.parts = s.parts;
    set_bt(a, s, 2);
    const int h32 = w.act(L.h, rows_j, C, GK), x32 = w.act(L.x, rows_j, C, GK);
    w.add(K_WGRAD, a, h32, x32, dyt, dzt);
    a.dw1 = L.dw1;
    a.db1 = L.db1;
    a.dw3 = L.dw3;
    a.db3 = L.db3;
    w.add(K_REDUCE, a, 0);
  }
}

// The weight gradients' parts of the rows at C channels and `jobs` products:
// the fewest that give items x parts a wave's 85% of PART_SMS SMs (the
// H100 SXM's), else the best of 1 .. 16 (the items of a part: jobs x
// (C / 128)^2 output blocks).  Not the card's own count: the
// parts set the weight gradients' sum order, which stays that of C alone.
constexpr int PART_SMS = 132;

int parts_for(int C, int jobs) {
  const int sms = PART_SMS;
  const long items = (long)jobs * wa_bands(C) * (C / GN);
  int best = 1;
  double top = 0.0;
  for (int P = 1; P <= 16; ++P) {
    const long n = items * P, waves = (n + sms - 1) / sms;
    const double eff = (double)n / (double)(waves * sms);
    if (eff >= 0.85) return P;
    if (eff > top + 1e-9) {
      top = eff;
      best = P;
    }
  }
  return best;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// CTAs an SM of the kernel at B videos' shared memory (cooperative launch checked)
template <bool BF>
cudaError_t coop_fit(int B, int* per_sm) {
  const int smem = pass_smem(B);
  if (smem > G_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(wgt_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, coop = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, wgt_kernel<BF>, G_THREADS, smem);
}

template <bool BF>
cudaError_t launch(Prog& p, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = coop_fit<BF>(p.B, &per_sm);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(p.cnt, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Prog*>(&p)};
  err = cudaLaunchCooperativeKernel((const void*)wgt_kernel<BF>, dim3(sms), dim3(G_THREADS), args,
                                    pass_smem(p.B), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool BF>
cudaError_t fwd_launch(Prog& p, const FLayer* layers, int n, const void* wt, int nblk, int blk0,
                       const float* b3, const float* b1, const float* bl, float* z,
                       const int* lengths, int B, int C, int t_fin, int shift_fin, int leaky,
                       int pool_mean, cudaStream_t stream) {
  Writer w{p, 0, cudaSuccess};
  write_fwd<BF>(w, layers, n, wt, nblk, blk0, b3, b1, bl, z, lengths, B, C, t_fin, shift_fin,
                leaky, pool_mean);
  return w.err != cudaSuccess ? w.err : launch<BF>(p, stream);
}

long round32(long n) { return (n + 31) / 32 * 32; }

// A sweep launch's scratch `work` at C channels, B videos of at most T rows:
// the weight gradients' partials (parts x jobs x (C + 1) x C, the most a
// layer's or the out-projection's take), then the chunks' column sums of
// two tensors, then two tensors' planes; s's parts and layout set from it.
// Returns the floats it takes.
long work_layout(SweepAt& s, int T, bool bf16) {
  s.parts = parts_for(s.C, 4);
  s.parts_fin = parts_for(s.C, 1);
  s.tc = (int)round32(T);
  s.nck = (s.B * s.tc / GK + RUN - 1) / RUN;
  s.plane = (int)round32((long)(bf16 ? 1 : 4) * s.C * s.B * s.tc / 2);
  const long pf = part_f(s.C);
  const long parts = round32(std::max((long)s.parts * 4 * pf, (long)s.parts_fin * pf));
  const long sums = round32(2L * s.nck * s.C);
  s.bsum = s.work ? s.work + parts : nullptr;
  s.bt = s.work ? s.work + parts + sums : nullptr;
  return parts + sums + 2L * s.plane;
}

bool bad_width(int C) { return C <= 512 || C % GN; }

cudaError_t set_layout(SweepAt& s, int T, bool bf16, long work_floats) {
  return work_layout(s, T, bf16) > work_floats ? cudaErrorInvalidValue : cudaSuccess;
}

// the layers' tables of a v2 chunk: ptrs (x, y, hs, drop, u) and ints (T, d, shift, pool)
bool fwd_layers(FLayer* out, void* const* ptrs, const int* ints, int n) {
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    out[j] = FLayer{static_cast<const float*>(ptrs[5 * j]), static_cast<float*>(ptrs[5 * j + 1]),
                    static_cast<float*>(ptrs[5 * j + 2]), static_cast<float*>(ptrs[5 * j + 4]),
                    static_cast<const float*>(ptrs[5 * j + 3]), T, ints[4 * j + 1],
                    ints[4 * j + 2], ints[4 * j + 3]};
    if (T <= 0 || (out[j].pool && T % 2) || !out[j].h) return false;
  }
  return true;
}

template <bool BF>
int grid(int* out) {
  int sms = 0;
  cudaFuncAttributes at;
  cudaError_t err = coop_fit<BF>(128, &out[0]);
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&at, wgt_kernel<BF>);
  if (err != cudaSuccess) return err;
  out[1] = sms;
  out[2] = pass_smem(128);
  out[3] = at.numRegs;
  out[4] = (int)at.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

// One layer of the sweep at C > 512 (proj = 1: the out-projection's, g =
// gz, x = h = x_fin, its gradient at x_fin into dz, dWl and dbl into dw1 and
// db1), on the sweep's planes wt (`cuda.wgmma_sweep_planes`: the blocks as
// they are, block blk .. blk + 2 W3's taps and blk + 3 W1; proj: block blk
// Wl).  dy: scratch of B x T x C floats; work: `work_floats` floats of the
// weight gradients' partials (`mucon_wgt_work_floats`).
extern "C" int mucon_wgt_sweep(const float* g, const float* u, const float* x, const float* h,
                               const float* drop, const int* lengths, const void* wt, int nblk,
                               int blk, float* dy, float* dz, float* g_in, float* work,
                               long work_floats, float* dw1, float* db1, float* dw3, float* db3,
                               unsigned* cnt, int B, int T, int channels, int d, int len_shift,
                               int pooled, int pool_mean, int leaky, int proj, int bf16,
                               cudaStream_t stream) {
  if (B <= 0 || T <= 0 || (pooled && !u) || (proj && pooled) || bad_width(channels) || !cnt ||
      blk < 0 || blk + (proj ? 1 : 4) > nblk)
    return cudaErrorInvalidValue;
  SweepAt s{wt, nullptr, nblk, dy, dz, work, (long)B * T, 0, 0, lengths, B, channels, leaky,
            pool_mean, nullptr, nullptr, 0, 0, 0};
  const cudaError_t err = set_layout(s, T, bf16, work_floats);
  if (err != cudaSuccess) return err;
  Prog p{};
  p.cnt = cnt;
  p.B = B;
  Writer w{p, 0, cudaSuccess};
  const int splanes = bf16 ? w.planes<true>(wt, nblk, channels)
                           : w.planes<false>(wt, nblk, channels);
  if (proj) {
    (bf16 ? write_proj_sweep<true> : write_proj_sweep<false>)(w, s, splanes, g, x, dz, dw1, db1,
                                                              blk, T, len_shift);
  } else {
    const SLayer L{x, h, drop, g, g_in, const_cast<float*>(u), dw3, db3, dw1, db1, T, d,
                   len_shift, pooled};
    (bf16 ? write_sweep<true> : write_sweep<false>)(w, s, splanes, -1, &L, 1, blk, nullptr);
  }
  if (w.err != cudaSuccess) return w.err;
  return bf16 ? launch<true>(p, stream) : launch<false>(p, stream);
}

// The v2 chunk launches at C > 512: tables as `mucon_wavenet_train_v2_fwd`
// (ptrs x, y, hs, drop, u and ints T, d, shift, pool a layer) on the
// forward's planes (layer lo's blocks from blk0, the out-projection's last);
// z non-null in the chunk that ends the stack.
extern "C" int mucon_wgt_v2_fwd(void* const* ptrs, const int* ints, int n, const void* wt,
                                int nblk, int blk0, const float* b3, const float* b1,
                                const float* bl, float* z, const int* lengths, unsigned* cnt,
                                int B, int channels, int t_fin, int shift_fin, int leaky,
                                int bf16, cudaStream_t stream) {
  FLayer layers[MAX_LAYERS];
  if (B <= 0 || n < 1 || n > MAX_LAYERS || bad_width(channels) || !cnt || blk0 < 0 ||
      blk0 + 4 * n > nblk - 1 || (z && t_fin <= 0) || !fwd_layers(layers, ptrs, ints, n))
    return cudaErrorInvalidValue;
  Prog p{};
  p.cnt = cnt;
  p.B = B;
  return bf16 ? fwd_launch<true>(p, layers, n, wt, nblk, blk0, b3, b1, bl, z, lengths, B,
                                 channels, t_fin, shift_fin, leaky, 0, stream)
              : fwd_launch<false>(p, layers, n, wt, nblk, blk0, b3, b1, bl, z, lengths, B,
                                  channels, t_fin, shift_fin, leaky, 0, stream);
}

// ... and its sweep (at most `mucon_wgt_v2_sweep_layers()` layers): ptrs x,
// h, drop, g, g_in, u and ints T, d, shift, pool a layer; fwt / swt the
// forward's and the sweep's planes; the gradients' bases at layer lo; gz
// non-null in the chunk that ends the stack (its out-projection's gradient
// at x_fin is the last layer's g); scratch: 3 x rows x C floats (the
// recomputed u where a layer gives none, dy, dz).
extern "C" int mucon_wgt_v2_sweep(void* const* ptrs, const int* ints, int n, const void* fwt,
                                  const void* swt, int nblk, int blk0, const float* b1,
                                  float* dw3, float* db3, float* dw1, float* db1,
                                  const float* gz, const float* x_fin, float* dwl, float* dbl,
                                  float* scratch, long rows, float* work, long work_floats,
                                  const int* lengths, unsigned* cnt, int B, int channels,
                                  int t_fin, int shift_fin, int leaky, int bf16,
                                  cudaStream_t stream) {
  if (B <= 0 || n < 1 || n > SWEEP_LAYERS || t_fin <= 0 || bad_width(channels) || !cnt ||
      blk0 < 0 || blk0 + 4 * n > nblk - 1 || (gz && (long)B * t_fin > rows))
    return cudaErrorInvalidValue;
  const int C = channels;
  const size_t cc = (size_t)C * C;
  SLayer layers[SWEEP_LAYERS];
  for (int j = 0; j < n; ++j) {
    const int T = ints[4 * j];
    if (T <= 0 || (long)B * T > rows) return cudaErrorInvalidValue;
    float* u = static_cast<float*>(ptrs[6 * j + 5]);
    layers[j] = SLayer{static_cast<const float*>(ptrs[6 * j]),
                       static_cast<const float*>(ptrs[6 * j + 1]),
                       static_cast<const float*>(ptrs[6 * j + 2]),
                       static_cast<const float*>(ptrs[6 * j + 3]),
                       static_cast<float*>(ptrs[6 * j + 4]),
                       u ? u : scratch,
                       dw3 + (size_t)j * 3 * cc, db3 + (size_t)j * C, dw1 + (size_t)j * cc,
                       db1 + (size_t)j * C, T, ints[4 * j + 1], ints[4 * j + 2],
                       ints[4 * j + 3]};
  }
  SweepAt s{swt, fwt, nblk, scratch + rows * C, scratch + 2 * rows * C, work, rows, 0, 0,
            lengths, B, C, leaky, 0, nullptr, nullptr, 0, 0, 0};
  const cudaError_t err = set_layout(s, (int)(rows / B), bf16, work_floats);
  if (err != cudaSuccess) return err;
  Prog p{};
  p.cnt = cnt;
  p.B = B;
  Writer w{p, 0, cudaSuccess};
  const int splanes = bf16 ? w.planes<true>(swt, nblk, C) : w.planes<false>(swt, nblk, C);
  const int fplanes = bf16 ? w.planes<true>(fwt, nblk, C) : w.planes<false>(fwt, nblk, C);
  if (gz)
    (bf16 ? write_proj_sweep<true> : write_proj_sweep<false>)(
        w, s, splanes, gz, x_fin, const_cast<float*>(layers[n - 1].g), dwl, dbl, nblk - 1,
        t_fin, shift_fin);
  (bf16 ? write_sweep<true> : write_sweep<false>)(w, s, splanes, fplanes, layers, n, blk0, b1);
  if (w.err != cudaSuccess) return w.err;
  return bf16 ? launch<true>(p, stream) : launch<false>(p, stream);
}

// The most layers a v2 sweep chunk takes above 512 channels (its program
// lives in the kernel's parameters).
extern "C" int mucon_wgt_v2_sweep_layers() { return SWEEP_LAYERS; }

// The weight gradients' parts at C > 512 with `jobs` products (4 a layer,
// 1 the out-projection).  0 on an error.
extern "C" int mucon_wgt_parts(int channels, int jobs) {
  if (bad_width(channels) || jobs < 1) return 0;
  return parts_for(channels, jobs);
}

// The floats of a sweep launch's `work` at C > 512, B videos of at most T
// rows, in the mode bf16: the weight gradients' partials, the chunks' column
// sums and the K-major planes of dy and dz.  0 on an error.
extern "C" long mucon_wgt_work_floats(int channels, int B, int T, int bf16) {
  if (bad_width(channels) || B <= 0 || T <= 0) return 0;
  SweepAt s{};
  s.B = B;
  s.C = channels;
  return work_layout(s, T, bf16);
}

// The kernel of the mode bf16 (the most videos a launch takes is the eval
// stacks' `mucon_wgmma_max_videos`: the same shared memory) and its
// cooperative grid: out = {CTAs an SM, SMs, shared memory a CTA at B = 128,
// registers a thread, local (spill) bytes a thread}.
extern "C" int mucon_wgt_grid(int bf16, int* out) {
  return bf16 ? grid<true>(out) : grid<false>(out);
}
