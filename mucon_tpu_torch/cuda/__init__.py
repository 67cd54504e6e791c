"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

On first use the `.cu` sources are compiled with
`nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC`
into one shared library under `<repo>/build/mucon_tpu_torch/`, named by
the sha256 of the sources, the headers (`csrc/*.cuh`) and the flags (a
changed source or header builds anew).  The
library exports `extern "C"` launchers that take raw device pointers,
sizes and a `cudaStream_t` and return the `cudaGetLastError()` of the
launch; it is loaded with ctypes, so no PyTorch headers are compiled and
no `ninja` is needed.  A failed build or launch raises: there is no
fallback.

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream without synchronising, and adds one to
`launch_counts[<kernel>]` per kernel launch — the count a run reads to
show that its path went through the kernels.  `wavenet_train_sweep`
counts one per layer sweep: its C launcher runs that layer's four
kernels (dz, dx, weight-gradient partials, their fixed-order sum; the
out-projection's sweep runs three, no dx).
`bilstm_train_bwd` counts one per `bilstm_train_backward` call: that call
launches the reverse chain's two kernels (the parallel coefficient pass,
then the cluster chain); `decoder_chain_bwd` likewise one per
`decoder_chain_backward` call (the parallel replay pass, then the cluster
chain).
`wavenet_train_v2_fwd` and `wavenet_train_v2_sweep` count one per chunk:
each is one cooperative launch over a chunk of layers.

The thirteen kernels: `wavenet_layer`, `mstcnpp_stack`, `bilstm_recurrence`
and `dense_viterbi` (serving; the DP and its pointer walk in one launch);
`wavenet_train_fwd`, `wavenet_train_sweep`, `bilstm_train_fwd`,
`bilstm_train_bwd`, `decoder_chain_fwd`, `decoder_chain_bwd` and
`mucon_flint` (the train step);
`wavenet_train_v2_fwd` and `wavenet_train_v2_sweep` (the v2 trainable
stack, `ops/wavenet_stack_train_v2.py`).  The stack kernels' bf16-operand
mode (`mm_dtype=torch.bfloat16`, the JAX package's
`tpu.kernel_mm_dtype=bfloat16`: every product's operands rounded to bf16,
one bf16 tensor-core product a 16-deep k-step, f32 sums and state) counts
under its own name: `wavenet_layer_bf16`, `wavenet_train_fwd_bf16`,
`wavenet_train_sweep_bf16`, `mstcnpp_stack_bf16`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("wavenet_stack.cu", "bilstm.cu", "viterbi.cu", "wavenet_train.cu",
           "decoder_chain.cu", "mucon_loss.cu", "mstcnpp.cu", "wavenet_train_v2.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mucon_tpu_torch"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a", "-I", str(CSRC),
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = (
    "wavenet_layer", "bilstm_recurrence", "dense_viterbi",
    "wavenet_train_fwd", "wavenet_train_sweep", "bilstm_train_fwd", "bilstm_train_bwd",
    "decoder_chain_fwd", "decoder_chain_bwd", "mucon_flint", "mstcnpp_stack",
    "wavenet_train_v2_fwd", "wavenet_train_v2_sweep",
    "wavenet_layer_bf16", "wavenet_train_fwd_bf16", "wavenet_train_sweep_bf16",
    "mstcnpp_stack_bf16",
)
# the decoder chain's weights a CTA keeps, its [Tz / CL] score rows and the
# reverse chain's [Tz x H / CL] slices live in shared memory: a kernel's need
# for (H, E, Tz) must fit the H100's per-block opt-in limit (227 KiB)
MAX_SMEM_BYTES = 232448

launch_counts = {name: 0 for name in KERNELS}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    its path.  nvcc's output (including -Xptxas -v register and shared
    memory use) is kept beside it as `<lib>.log`.  The environment variable
    MUCON_NVCC_FLAGS adds flags (hashed like the rest)."""
    srcs = [CSRC / s for s in SOURCES]
    # extra flags (the kernels' -D build knobs) for a probe of variants
    flags = (*NVCC_FLAGS, *os.environ.get("MUCON_NVCC_FLAGS", "").split())
    # the include path is the checkout's own: hash the flags without it
    h = hashlib.sha256(" ".join(f for f in flags if f != str(CSRC)).encode())
    for s in (*srcs, *sorted(CSRC.glob("*.cuh"))):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libmucon_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    # one nvcc per source, all at once, then one link
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    compile_flags = [f for f in flags if f != "-shared"]
    procs = [
        subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    results = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in results)
    if all(rc == 0 for _, rc in results):
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        results.append((log, proc.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text(log)
    bad = [rc for _, rc in results if rc != 0]
    if bad:
        raise RuntimeError(f"nvcc failed with code {bad[0]}:\n{log[-6000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build races benignly
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.mucon_wavenet_layer.argtypes = [P] * 7 + [I] * 10 + [P]
            lib.mucon_wavenet_tile_rows.argtypes = []
            lib.mucon_bilstm_recurrence.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.mucon_dense_viterbi.argtypes = [P] * 8 + [I] * 8 + [P]
            lib.mucon_viterbi_smem.argtypes = [I] * 5
            lib.mucon_viterbi_smem.restype = ctypes.c_size_t
            lib.mucon_wavenet_train_fwd.argtypes = [P] * 10 + [I] * 9 + [P]
            lib.mucon_wavenet_train_sweep.argtypes = [P] * 16 + [I] * 10 + [P]
            lib.mucon_wavenet_train_plan.argtypes = [I, I, I, ctypes.POINTER(I)]
            lib.mucon_bilstm_fwd_plan.argtypes = [I, I, ctypes.POINTER(I)]
            lib.mucon_bilstm_bwd_coefs.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.mucon_bilstm_bwd_chain.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.mucon_bilstm_chain_width.argtypes = [I]
            lib.mucon_decoder_chain_fwd.argtypes = [P] * 16 + [I] * 5 + [P]
            lib.mucon_decoder_chain_replay.argtypes = [P] * 18 + [I] * 5 + [P]
            lib.mucon_decoder_chain_bwd.argtypes = [P] * 18 + [I] * 5 + [P]
            lib.mucon_decoder_chain_smem.argtypes = [I] * 4
            lib.mucon_decoder_chain_width.argtypes = [I]
            lib.mucon_decoder_chain_fwd_launch.argtypes = [I] * 4 + [ctypes.POINTER(I)]
            lib.mucon_flint.argtypes = [P] * 9 + [I] * 5 + [P]
            lib.mucon_mstcnpp_layer.argtypes = [P] * 7 + [I] * 8 + [P]
            lib.mucon_mstcnpp_tile_rows.argtypes = []
            lib.mucon_mstcnpp_proj.argtypes = [P] * 5 + [I] * 5 + [P]
            # per-layer pointer and int tables are host arrays
            PP, IP = ctypes.POINTER(P), ctypes.POINTER(I)
            lib.mucon_wavenet_train_v2_fwd.argtypes = [PP, IP, I] + [P] * 8 + [I] * 5 + [P]
            L = ctypes.c_long
            lib.mucon_wavenet_train_v2_sweep.argtypes = ([PP, IP, I] + [P] * 14 + [L, P, L, P]
                                                         + [I] * 5 + [P])
            lib.mucon_wavenet_train_v2_grid.argtypes = [IP]
            lib.mucon_wavenet_train_v2_plan.argtypes = [I, I, I, IP]
            for fn in (lib.mucon_wavenet_layer, lib.mucon_wavenet_tile_rows,
                       lib.mucon_bilstm_recurrence,
                       lib.mucon_dense_viterbi, lib.mucon_wavenet_train_fwd,
                       lib.mucon_wavenet_train_sweep, lib.mucon_wavenet_train_plan,
                       lib.mucon_bilstm_fwd_plan,
                       lib.mucon_bilstm_bwd_coefs, lib.mucon_bilstm_bwd_chain,
                       lib.mucon_bilstm_chain_width, lib.mucon_mstcnpp_tile_rows,
                       lib.mucon_decoder_chain_fwd, lib.mucon_decoder_chain_replay,
                       lib.mucon_decoder_chain_bwd, lib.mucon_decoder_chain_smem,
                       lib.mucon_decoder_chain_width, lib.mucon_decoder_chain_fwd_launch,
                       lib.mucon_flint, lib.mucon_mstcnpp_layer, lib.mucon_mstcnpp_proj,
                       lib.mucon_wavenet_train_v2_fwd, lib.mucon_wavenet_train_v2_sweep,
                       lib.mucon_wavenet_train_v2_grid, lib.mucon_wavenet_train_v2_plan):
                fn.restype = I
            lib.mucon_cuda_error_string.argtypes = [I]
            lib.mucon_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_launch(lib, err: int, name: str, count: bool = True) -> None:
    """Raise on a refused launch; else add one to the kernel's count (not
    for the first of two kernels that count as one call)."""
    if err != 0:
        msg = lib.mucon_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    launch_counts[name] += count


def _require(device, dtype, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {t.device}")
    return t.device


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lengths_i32(lengths, B, device, name) -> torch.Tensor:
    """int32 copy of an integer [B] length vector (the kernels read int32)."""
    if (lengths.dtype not in (torch.int32, torch.int64) or lengths.device != device
            or lengths.shape != (B,)):
        raise ValueError(f"{name} must be an integer [{B}] tensor on {device}")
    return lengths.to(torch.int32).contiguous()


def _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last) -> torch.device:
    dev = _cuda_device(x)
    B, T, C = x.shape
    L = len(stages)
    if C != 128:
        raise ValueError(f"the wavenet kernels take C=128, got {C}")
    if w3.shape != (L, 3, C, C) or w1.shape != (L, C, C) or b3.shape != (L, C) \
            or b1.shape != (L, C) or w_last.shape != (C, C) or b_last.shape != (C,):
        raise ValueError("packed wavenet weights do not match x / stages")
    _require(dev, torch.float32, x=x, w3=w3, b3=b3, w1=w1, b1=b1,
             w_last=w_last, b_last=b_last)
    return dev


def bf16_mode(mm_dtype) -> bool:
    """True for the stack kernels' bf16-operand mode (`mm_dtype` is
    torch.bfloat16), False for their 3xTF32 f32 mode (None); raises on any
    other operand dtype."""
    if mm_dtype is None:
        return False
    if mm_dtype == torch.bfloat16:
        return True
    raise ValueError(f"the stack kernels take mm_dtype None or torch.bfloat16, got {mm_dtype}")


def _mode(name: str, bf16: bool) -> str:
    """The launch-count name of kernel `name` in the mode `bf16`."""
    return f"{name}_bf16" if bf16 else name


def _ptr(t) -> int:
    """data_ptr of an optional tensor (0, a null pointer, for None)."""
    return 0 if t is None else t.data_ptr()


def wavenet_tile_rows() -> int:
    """Rows a CTA of `wavenet_layer` owns (csrc/wavenet_stack.cu TM); a
    tile at or past its video's length is skipped."""
    return load().mucon_wavenet_tile_rows()


def _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16) -> torch.Tensor:
    """z = mask(nonlin(h) Wl + bl): the eval kernel's final_proj launch."""
    B, t, C = h.shape
    out = torch.empty(B, t, C, device=h.device, dtype=torch.float32)
    err = lib.mucon_wavenet_layer(
        h.data_ptr(), out.data_ptr(), lens.data_ptr(), w_last.data_ptr(),
        b_last.data_ptr(), w_last.data_ptr(), b_last.data_ptr(),
        B, t, C, 0, shift, 0, 0, int(leaky), 1, int(bf16), stream,
    )
    _check_launch(lib, err, _mode("wavenet_layer", bf16))
    return out


def wavenet_stack(x, lengths, w3, b3, w1, b1, w_last, b_last, *, stages,
                  pooling_layers, pooling_type, leaky, mm_dtype=None):
    """The eval stack of `ops/wavenet_stack.py` on the card: one
    `wavenet_layer` launch per layer and one for the out-projection
    (`mm_dtype=torch.bfloat16`: the bf16-operand mode, `wavenet_layer_bf16`).
    x [B x T x 128] f32 -> (z [B x T/2^p x 128], lengths >> p)."""
    bf16 = bf16_mode(mm_dtype)
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    B, T, C = x.shape
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    h, t, shift = x, T, 0
    for i, d in enumerate(stages):
        pool = i in pooling_layers
        if pool and t % 2:
            raise ValueError(f"pooling layer {i} needs an even length, got {t}")
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        err = lib.mucon_wavenet_layer(
            h.data_ptr(), out.data_ptr(), lens.data_ptr(), w3[i].data_ptr(),
            b3[i].data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
            B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), 0, int(bf16), stream,
        )
        _check_launch(lib, err, _mode("wavenet_layer", bf16))
        if pool:
            t, shift = t // 2, shift + 1
        h = out
    return (_out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16),
            lengths >> shift)


def wavenet_train_plan(B: int, T: int, jobs: int = 4) -> dict:
    """The grid of a `wavenet_train.cu` layer of B videos x T frames
    (`plan_for`, chosen from the shape alone): the rows a CTA of the
    forward (`fwd_tile_rows`) and of the sweep's dz and dx kernels
    (`tile_rows`) owns (64, 32 or 16), and the rows a weight-gradient CTA
    sums (`span_rows`, `spans` a video) with `jobs` products a layer (4;
    1 for the out-projection)."""
    out = (ctypes.c_int * 4)()
    lib = load()
    err = lib.mucon_wavenet_train_plan(B, T, jobs, out)
    if err:
        raise ValueError(f"no wavenet_train grid for B={B}, T={T}, jobs={jobs}")
    return dict(fwd_tile_rows=out[0], tile_rows=out[1], span_rows=out[2], spans=out[3])


def _work_floats(plan, B: int, layers) -> int:
    """Floats of the sweep's weight-gradient partials: B x spans x jobs
    partials of (C + 1) x C (C = 128), for the largest of `layers` ((T,
    jobs) pairs)."""
    return max(B * plan(B, t, jobs)["spans"] * jobs for t, jobs in layers) * (128 + 1) * 128


def wavenet_train_forward(x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, *,
                          stages, pooling_layers, pooling_type, leaky, mm_dtype=None):
    """Forward of the trainable stack on the card: one `wavenet_train_fwd`
    launch per layer and one `wavenet_layer` out-projection launch (in the
    bf16-operand mode with `mm_dtype=torch.bfloat16`: `wavenet_train_fwd_bf16`
    and `wavenet_layer_bf16`).
    x [B x T x 128] (masked), drop_masks one [B x t_i x 128] mask per layer
    or None -> (z, stash) with stash = (xs, hs, us, x_fin): each layer's
    input, nonlin(z) and (pooled layers, by index) pre-pool output.  hs and
    us hold the rows t < length only (the sweep reads no other); their rows
    at t >= length are undefined."""
    bf16 = bf16_mode(mm_dtype)
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    B, T, C = x.shape
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    xs, hs, us = [], [], {}
    h, t, shift = x, T, 0
    for i, d in enumerate(stages):
        pool = i in pooling_layers
        m = None if drop_masks is None else drop_masks[i]
        if m is not None:
            if m.shape != (B, t, C):
                raise ValueError(f"dropout mask {i} has shape {tuple(m.shape)}, "
                                 f"expected {(B, t, C)}")
            _require(dev, torch.float32, mask=m)
        hs_i = torch.empty(B, t, C, device=dev, dtype=torch.float32)
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        u = torch.empty(B, t, C, device=dev, dtype=torch.float32) if pool else None
        err = lib.mucon_wavenet_train_fwd(
            h.data_ptr(), out.data_ptr(), _ptr(u), hs_i.data_ptr(), lens.data_ptr(),
            w3[i].data_ptr(), b3[i].data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
            _ptr(m), B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), int(bf16), stream,
        )
        _check_launch(lib, err, _mode("wavenet_train_fwd", bf16))
        xs.append(h)
        hs.append(hs_i)
        if pool:
            us[i] = u
            t, shift = t // 2, shift + 1
        h = out
    z = _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16)
    return z, (xs, hs, us, h)


def wavenet_train_backward(gz, stash, lengths, w3, w1, w_last, drop_masks, *,
                           stages, pooling_layers, pooling_type, leaky, mm_dtype=None):
    """Backward sweep of the trainable stack on the card: the
    out-projection's sweep, then one `wavenet_train_sweep` per layer, last
    first.  gz [B x t_fin x 128] -> (gx, dw3, db3, dw1, db1, dw_last, db_last).
    `mm_dtype=torch.bfloat16` runs the bf16-operand mode
    (`wavenet_train_sweep_bf16`), except for the out-projection's sweep when
    the last layer pools: the JAX package then takes that projection's
    gradient in f32 outside its kernel (wavenet_train_pallas_v3.py:504-515),
    and so does this sweep."""
    bf16 = bf16_mode(mm_dtype)
    xs, hs, us, x_fin = stash
    dev = _cuda_device(gz)
    B, T, C = xs[0].shape
    L = len(stages)
    if gz.shape != x_fin.shape:
        raise ValueError(f"gz {tuple(gz.shape)} does not match z {tuple(x_fin.shape)}")
    gz = gz.contiguous()
    _require(dev, torch.float32, gz=gz)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    # W^T copies (once per call) so that the kernels read them row-major
    w3t = w3.transpose(-1, -2).contiguous()
    w1t = w1.transpose(-1, -2).contiguous()
    wlt = w_last.t().contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    dw3 = torch.empty(L, 3, C, C, **f32)
    db3 = torch.empty(L, C, **f32)
    dw1 = torch.empty(L, C, C, **f32)
    db1 = torch.empty(L, C, **f32)
    dwl = torch.empty(C, C, **f32)
    dbl = torch.empty(C, **f32)
    n_pools = len(us)
    t_fin = x_fin.shape[1]
    dy = torch.empty(B, T, C, **f32)  # scratch, sized for the longest layer
    work = torch.empty(_work_floats(wavenet_train_plan, B, ((x_fin.shape[1], 1),
                                                         *((x.shape[1], 4) for x in xs))),
                       **f32)

    def sweep(g, u, x, h, m, w1t_i, w3t_i, dz, g_in, dw1_i, db1_i, dw3_i, db3_i,
              t, d, shift, pooled, proj, bf16):
        err = lib.mucon_wavenet_train_sweep(
            g.data_ptr(), _ptr(u), x.data_ptr(), h.data_ptr(), _ptr(m),
            lens.data_ptr(), w1t_i.data_ptr(), _ptr(w3t_i), dy.data_ptr(),
            dz.data_ptr(), _ptr(g_in), work.data_ptr(), dw1_i.data_ptr(),
            db1_i.data_ptr(), _ptr(dw3_i), _ptr(db3_i), B, t, C, int(d), shift,
            int(pooled), pool_mean, int(leaky), int(proj), int(bf16), stream,
        )
        _check_launch(lib, err, _mode("wavenet_train_sweep", bf16))

    g = torch.empty(B, t_fin, C, **f32)  # gradient at x_fin
    sweep(gz, None, x_fin, x_fin, None, wlt, None, g, None, dwl, dbl, None, None,
          t_fin, 0, n_pools, False, True, bf16 and (L - 1) not in us)
    shift = n_pools
    for i in reversed(range(L)):
        x_i = xs[i]
        t = x_i.shape[1]
        pooled = i in us
        if pooled:
            shift -= 1
        m = None if drop_masks is None else drop_masks[i]
        dz = torch.empty(B, t, C, **f32)
        g_in = torch.empty(B, t, C, **f32)
        sweep(g, us.get(i), x_i, hs[i], m, w1t[i], w3t[i], dz, g_in, dw1[i], db1[i],
              dw3[i], db3[i], t, stages[i], shift, pooled, False, bf16)
        g = g_in
    return g, dw3, db3, dw1, db1, dwl, dbl


def _cluster_width(H: int) -> int:
    """The widest of 8, 4, 2 CTAs that leaves each at least 16 hidden
    units, else 1 (`cluster::width_for` in csrc/cluster.cuh)."""
    return next((c for c in (8, 4, 2) if H % c == 0 and H // c >= 16), 1)


def bilstm_fwd_plan(H: int) -> tuple:
    """How the forward recurrence splits a hidden size H (`fwd_plan` in
    csrc/bilstm.cu): (cluster width CL, hidden units per CTA HS, threads
    per CTA NT, k-groups NK, k-rows per group KC).  Each CTA's 4 HS gate
    columns times NK groups of KC rows (a multiple of 4) cover the
    [H x 4H] w_hh slice, KC weights a thread in registers.  NT is the least
    of 256, 512 that holds the columns, a thread per unit for 8
    videos, and KC <= 64; raises for an H that no NT fits."""
    if H >= 1:
        cl = _cluster_width(H)
        hs = H // cl
        for nt in (256, 512):
            if 4 * hs > nt or 8 * hs > nt:
                continue
            nk = nt // (4 * hs)
            kc = (-(-H // nk) + 3) // 4 * 4
            if kc <= 64:
                return cl, hs, nt, nk, kc
    raise ValueError(f"the forward recurrence cannot split H={H} over a cluster "
                     f"(at most 64 weights a thread)")


BILSTM_FWD_PLAN_KEYS = ("cl", "threads", "nk", "kc", "clusters", "active")


def bilstm_fwd_launch(B: int, H: int) -> dict:
    """The forward's launch at B videos (`mucon_bilstm_fwd_plan`): the
    plan's CL, NT, NK, KC, the clusters of the grid (one per direction and
    8 videos) and how many the card holds at once (more run in waves)."""
    lib = load()
    out = (ctypes.c_int * 6)()
    err = lib.mucon_bilstm_fwd_plan(B, H, out)
    if err != 0:
        raise RuntimeError(f"bilstm forward plan failed: "
                           f"{lib.mucon_cuda_error_string(err).decode()}")
    return dict(zip(BILSTM_FWD_PLAN_KEYS, out))


def _check_bilstm(xp, m, w_hh):
    dev = _cuda_device(xp)
    T, two, B, G = xp.shape
    H = G // 4
    if two != 2 or G != 4 * H or m.shape != (T, B) or w_hh.shape != (2, H, G):
        raise ValueError(f"bad shapes xp {tuple(xp.shape)} m {tuple(m.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    _require(dev, torch.float32, xp=xp, m=m, w_hh=w_hh)
    bilstm_fwd_plan(H)
    return dev, T, B, H


def _bilstm_forward(xp, m, w_hh, stash: bool, name: str):
    dev, T, B, H = _check_bilstm(xp, m, w_hh)
    f32 = dict(device=dev, dtype=torch.float32)
    outs = torch.empty(T, 2, B, H, **f32)
    h = torch.empty(2, B, H, **f32)
    c = torch.empty(2, B, H, **f32)
    cs = torch.empty(T, 2, B, H, **f32) if stash else None
    lib = load()
    err = lib.mucon_bilstm_recurrence(
        xp.data_ptr(), m.data_ptr(), w_hh.data_ptr(), outs.data_ptr(),
        h.data_ptr(), c.data_ptr(), _ptr(cs), T, B, H, _stream(dev),
    )
    _check_launch(lib, err, name)
    return outs, h, c, cs


def bilstm_recurrence(xp, m, w_hh):
    """xp [T x 2 x B x 4H], m [T x B], w_hh [2 x H x 4H] (f32) ->
    (outs [T x 2 x B x H], h [2 x B x H], c [2 x B x H]): one
    thread-block cluster per direction and 8 videos, w_hh resident in its
    registers (`bilstm_fwd_plan`)."""
    return _bilstm_forward(xp, m, w_hh, False, "bilstm_recurrence")[:3]


def bilstm_train_forward(xp, m, w_hh):
    """`bilstm_recurrence` that also returns the cell trajectory
    cs [T x 2 x B x H] the reverse chain replays from."""
    return _bilstm_forward(xp, m, w_hh, True, "bilstm_train_fwd")


# the chain kernel's tiling (csrc/bilstm.cu): videos per cluster, threads per CTA
BILSTM_CHAIN_BT, BILSTM_CHAIN_THREADS = 8, 256


def bilstm_chain_plan(H: int) -> tuple:
    """How the reverse chain splits a hidden size H (`chain_plan` in
    csrc/bilstm.cu): (cluster width CL, columns per CTA HS, thread groups
    NQ, gate rows per group GPQ).  CL is `_cluster_width(H)`.  Raises for
    an H the kernel does not take: more than 32 columns a CTA (one thread
    per video and column) or more than 128 weights a thread."""
    cl = _cluster_width(H)
    hs = H // cl
    if H < 1 or BILSTM_CHAIN_BT * hs > BILSTM_CHAIN_THREADS:
        raise ValueError(f"the reverse chain cannot split H={H}: {hs} columns a CTA, "
                         f"at most {BILSTM_CHAIN_THREADS // BILSTM_CHAIN_BT}")
    nq = BILSTM_CHAIN_THREADS // hs
    gpq = (-(-4 * H // nq) + 3) // 4 * 4
    if gpq > 128:
        raise ValueError(f"the reverse chain takes at most 128 weights a thread, "
                         f"H={H} needs {gpq}")
    return cl, hs, nq, gpq


def _check_bilstm_bwd(dev, T, B, H, **tensors):
    """The reverse chain's H limits and the shapes of its inputs:
    [T x 2 x B x H] each, but dh and dc [2 x B x H] and coefs
    [6 x T x 2 x B x H]."""
    if 4 * H > 1024:
        raise ValueError(f"the reverse chain takes 4H <= 1024, got H={H}")
    bilstm_chain_plan(H)
    for name, t in tensors.items():
        shape = {"dh": (2, B, H), "dc": (2, B, H), "coefs": (6, T, 2, B, H)}.get(
            name, (T, 2, B, H))
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(dev, torch.float32, **tensors)


def bilstm_bwd_coefs(xp, m, w_hh, outs, cs, *, count: bool = True, cell: bool = False):
    """The parallel pass of the reverse chain (`ops/lstm_recurrence.py
    bilstm_bwd_coefs_plain`): coefs [6 x T x 2 x B x H], the chain's factors
    A, Ci, Cf, Cg, Co, F for every step at once.  With `cell` also the
    replayed cell f c_prev + i g [T x 2 x B x H], which equals the forward's
    stash cs at every valid step bit for bit: returns (coefs, cell)."""
    dev, T, B, H = _check_bilstm(xp, m, w_hh)
    _check_bilstm_bwd(dev, T, B, H, outs=outs, cs=cs)
    coefs = torch.empty(6, T, 2, B, H, device=dev, dtype=torch.float32)
    replay = torch.empty(T, 2, B, H, device=dev, dtype=torch.float32) if cell else None
    lib = load()
    err = lib.mucon_bilstm_bwd_coefs(
        xp.data_ptr(), m.data_ptr(), w_hh.data_ptr(), outs.data_ptr(), cs.data_ptr(),
        coefs.data_ptr(), _ptr(replay), T, B, H, _stream(dev))
    _check_launch(lib, err, "bilstm_train_bwd", count)
    return (coefs, replay) if cell else coefs


def bilstm_bwd_chain(coefs, m, w_hh, douts, dh, dc):
    """The sequential pass (`bilstm_bwd_chain_plain`) on a thread-block
    cluster per direction and 8 videos: dxp [T x 2 x B x 4H]."""
    dev = _cuda_device(douts)
    if douts.dim() != 4 or douts.shape[1] != 2:
        raise ValueError(f"douts must be [T x 2 x B x H], got {tuple(douts.shape)}")
    T, _, B, H = douts.shape
    if m.shape != (T, B) or w_hh.shape != (2, H, 4 * H):
        raise ValueError(f"bad shapes m {tuple(m.shape)} w_hh {tuple(w_hh.shape)} for "
                         f"douts {tuple(douts.shape)}")
    _require(dev, torch.float32, m=m, w_hh=w_hh)
    _check_bilstm_bwd(dev, T, B, H, coefs=coefs, douts=douts, dh=dh, dc=dc)
    dxp = torch.empty(T, 2, B, 4 * H, device=dev, dtype=torch.float32)
    lib = load()
    err = lib.mucon_bilstm_bwd_chain(
        coefs.data_ptr(), m.data_ptr(), w_hh.data_ptr(), douts.data_ptr(), dh.data_ptr(),
        dc.data_ptr(), dxp.data_ptr(), T, B, H, _stream(dev))
    _check_launch(lib, err, "bilstm_train_bwd")
    return dxp


def bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc):
    """Reverse (dh, dc) chain: dxp [T x 2 x B x 4H] from the stash and the
    cotangents of (outs, h_fin, c_fin).  Two kernels, counted as one
    `bilstm_train_bwd` launch: the coefficient pass over all steps at once
    (`bilstm_bwd_coefs`, into scratch allocated here), then the cluster
    chain (`bilstm_bwd_chain`)."""
    coefs = bilstm_bwd_coefs(xp, m, w_hh, outs, cs, count=False)
    return bilstm_bwd_chain(coefs, m, w_hh, douts, dh, dc)


# csrc/viterbi.cu: windows of W staged in shared memory at a time, threads
# of the block body, cells a lane of the warp body holds
VITERBI_KC, VITERBI_BLOCK_THREADS, VITERBI_LANE_CELLS = 128, 256, 72


def viterbi_plan(B: int, N: int, L: int, K=None) -> dict:
    """The DP's launch (`csrc/viterbi.cu`): the warp body (one warp a
    video, lane n holding row n's cells in registers: `lc` = 72 of them)
    where N <= 32 and L <= 72, else the block body (one 256-thread CTA
    a video, the state in shared memory); `ctas` = B either way.  With K,
    also the dynamic shared memory a CTA takes (`smem`: W staged
    VITERBI_KC windows at a time, the block body's state) and where the
    walk's [K-1 x N] uint16 table lives: "shared" where it fits beside the
    rest under MAX_SMEM_BYTES, else "global" (the walk reads the int32
    bps).  Raises for N above 256, or a block body whose state does not
    fit."""
    if min(B, N, L) < 1 or N > VITERBI_BLOCK_THREADS:
        raise ValueError(f"the DP takes B, L >= 1 and 1 <= N <= "
                         f"{VITERBI_BLOCK_THREADS}; got B={B} N={N} L={L}")
    lc = VITERBI_LANE_CELLS if N <= 32 and L <= VITERBI_LANE_CELLS else 0
    threads = 32 if lc else VITERBI_BLOCK_THREADS
    plan = dict(body="warp" if lc else "block", lc=lc, threads=threads, warps=threads // 32,
                ctas=B)
    if K is not None:
        if K < 1:
            raise ValueError("the DP needs at least one window")
        staged = min(VITERBI_KC, max(K - 1, 1))
        base = 4 * (staged * N + (0 if lc else 3 * N * L + 2 * N))
        if base > MAX_SMEM_BYTES:
            raise ValueError(f"the DP's state for N={N} L={L} needs {base} bytes of shared "
                             f"memory; the limit is {MAX_SMEM_BYTES}")
        table = base + 2 * (K - 1) * N <= MAX_SMEM_BYTES
        plan.update(smem=base + (2 * (K - 1) * N if table else 0),
                    table="shared" if table else "global")
    return plan


def viterbi_smem(K: int, N: int, L: int, lc: int, table: bool) -> int:
    """The kernel file's own count of a launch's shared memory (a check of
    `viterbi_plan`)."""
    return load().mucon_viterbi_smem(K, N, L, lc, int(table))


def dense_viterbi_decode(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int):
    """W [B x K x N], pois [B x N x L] (f32), k_valid / n_valid [B] ->
    (score [B], best_l [B] int32, bps [B x K-1 x N] int32, pos [B x K]
    int64): the DP and the pointer walk in one launch (`viterbi_plan`)."""
    dev = _cuda_device(W)
    B, K, N = W.shape
    L = pois.shape[2]
    if pois.shape != (B, N, L):
        raise ValueError(f"pois {tuple(pois.shape)} does not match W {tuple(W.shape)}")
    if frame_sampling < 1:
        raise ValueError(f"frame_sampling must be >= 1, got {frame_sampling}")
    plan = viterbi_plan(B, N, L, K)
    _require(dev, torch.float32, W=W, pois=pois)
    kv = _lengths_i32(k_valid, B, dev, "k_valid")
    nv = _lengths_i32(n_valid, B, dev, "n_valid")
    score = torch.empty(B, device=dev, dtype=torch.float32)
    best_l = torch.empty(B, device=dev, dtype=torch.int32)
    bps = torch.empty(B, K - 1, N, device=dev, dtype=torch.int32)
    pos = torch.empty(B, K, device=dev, dtype=torch.int64)
    lib = load()
    err = lib.mucon_dense_viterbi(
        W.data_ptr(), pois.data_ptr(), kv.data_ptr(), nv.data_ptr(),
        score.data_ptr(), best_l.data_ptr(), bps.data_ptr(), pos.data_ptr(),
        B, K, N, L, int(frame_sampling), int(max_len), plan["lc"],
        int(plan["table"] == "shared"), _stream(dev),
    )
    _check_launch(lib, err, "dense_viterbi")
    return score, best_l, bps, pos


def dense_viterbi(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int):
    """`dense_viterbi_decode` without the positions: (score, best_l, bps)."""
    return dense_viterbi_decode(W, pois, k_valid, n_valid, frame_sampling, max_len)[:3]


def _check_chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl,
                 reverse: bool = False):
    """Shapes of the decoder chain's inputs -> (device, S, B, Tz, H, E);
    with `reverse`, also the reverse chain's limits (`decoder_chain_plan`)."""
    dev = _cuda_device(emb)
    S, B, H = emb.shape
    Tz, E = enc.shape[1], enc.shape[2]
    want = dict(enc=(B, Tz, E), pre=(B, Tz, H), maskf=(B, Tz), h0=(B, H), c0=(B, H),
                wl2=(H, H), bl2=(H,), v=(H,), wc1=(H, H), wc2=(E, H), bc=(H,),
                wih=(H, 4 * H), whh=(H, 4 * H), bl=(4 * H,))
    got = dict(enc=enc, pre=pre, maskf=maskf, h0=h0, c0=c0, wl2=wl2, bl2=bl2, v=v,
               wc1=wc1, wc2=wc2, bc=bc, wih=wih, whh=whh, bl=bl)
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, expected {shape}")
    if min(S, B, Tz, E) < 1:
        raise ValueError(f"the chain kernels take S, B, Tz, E >= 1; got S={S} B={B} Tz={Tz} "
                         f"E={E}")
    decoder_chain_fwd_plan(H)
    if reverse:
        decoder_chain_plan(H)
    _require(dev, torch.float32, emb=emb, **got)
    lib = load()
    need = lib.mucon_decoder_chain_smem(H, E, Tz, int(reverse))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"H={H} E={E} Tz={Tz} needs {need} bytes of shared memory a block; "
                         f"the limit is {MAX_SMEM_BYTES}")
    return dev, S, B, Tz, H, E


# the forward chain's and the replay pass's threads per CTA (csrc/decoder_chain.cu NTF)
DECODER_CHAIN_FWD_THREADS = 256


def decoder_chain_fwd_plan(H: int) -> tuple:
    """How the forward chain splits a hidden size H over a cluster
    (`fwd_plan` in csrc/decoder_chain.cu): (cluster width CL, units per CTA
    HS, threads per CTA).  CL is `_cluster_width(H)`.  A CTA sends every
    rank its units' rows of h Wl2 (q is their sum, in rank order); the
    combine layer and the gates are warp GEMVs (a warp's lanes split k):
    in pass p, warp w takes the combine layer's columns 32 p + 4 w .. + 3
    of the CTA's HS and the gate columns 64 p + 8 w .. + 7 of its 4 HS.
    Raises for an H the kernel does not take: H above 256 (a thread a
    unit where a CTA writes its units' state)."""
    if 1 <= H <= DECODER_CHAIN_FWD_THREADS:
        cl = _cluster_width(H)
        return cl, H // cl, DECODER_CHAIN_FWD_THREADS
    raise ValueError(f"the forward decoder chain cannot split H={H} over a cluster")


DECODER_CHAIN_FWD_LAUNCH_KEYS = ("cl", "hs", "threads", "clusters", "active", "weights",
                                 "tables")


def decoder_chain_fwd_launch(B: int, H: int, E: int, Tz: int) -> dict:
    """The forward chain's launch at B videos (`mucon_decoder_chain_fwd_launch`):
    its CL, HS and threads, the clusters of the grid (one a video), how many
    the card holds at once (more run in waves), whether each CTA's weights
    sit in shared memory (1) or are read from L2 (0), and its rows of
    maskf, pre and enc the same."""
    decoder_chain_fwd_plan(H)
    lib = load()
    out = (ctypes.c_int * len(DECODER_CHAIN_FWD_LAUNCH_KEYS))()
    err = lib.mucon_decoder_chain_fwd_launch(B, H, E, Tz, out)
    if err != 0:
        raise RuntimeError(f"decoder chain forward plan failed: "
                           f"{lib.mucon_cuda_error_string(err).decode()}")
    return dict(zip(DECODER_CHAIN_FWD_LAUNCH_KEYS, out))


def _chain_columns(wc1, wc2, wih, whh):
    """The forward step's weights by column, as its CTAs read them (k
    fastest): [Wc1; Wc2]^T [H x (H + E)] and [Wih; Whh] as [H x 4 x 2H],
    row 4 j + q the column q H + j (gate q of unit j)."""
    H = whh.shape[0]
    wcT = torch.cat([wc1, wc2]).t().contiguous()
    wgT = torch.cat([wih, whh]).view(2 * H, 4, H).permute(2, 1, 0).contiguous()
    return wcT, wgT


def decoder_chain_forward(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih,
                          whh, bl):
    """The teacher-forced chain's forward (one thread-block cluster per
    video, `decoder_chain_fwd_plan`) -> (hs, cs, comb), each [S x B x H].
    Arguments as `ops/decoder_chain.py`."""
    dev, S, B, Tz, H, E = _check_chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1,
                                       wc2, bc, wih, whh, bl)
    wcT, wgT = _chain_columns(wc1, wc2, wih, whh)
    hs, cs, comb = (torch.empty(S, B, H, device=dev, dtype=torch.float32) for _ in range(3))
    lib = load()
    err = lib.mucon_decoder_chain_fwd(
        emb.data_ptr(), enc.data_ptr(), pre.data_ptr(), maskf.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), wl2.data_ptr(), bl2.data_ptr(), v.data_ptr(), wcT.data_ptr(),
        bc.data_ptr(), wgT.data_ptr(), bl.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        comb.data_ptr(), S, B, Tz, H, E, _stream(dev),
    )
    _check_launch(lib, err, "decoder_chain_fwd")
    return hs, cs, comb


# the reverse chain's threads per CTA (csrc/decoder_chain.cu NTB)
DECODER_CHAIN_THREADS = 256


def decoder_chain_plan(H: int) -> tuple:
    """How the reverse chain splits a hidden size H over a cluster
    (`bwd_plan` in csrc/decoder_chain.cu): (cluster width CL, units per CTA
    HS, dgate row groups NQ, rows per group RQ).  CL is `_cluster_width(H)`;
    a CTA's 2 HS output columns of dgate [Wih; Whh]^T take NQ = 256 / (2 HS)
    groups of RQ rows (a multiple of 4).  Raises for an H the kernel does
    not take: HS not a multiple of 4 or above 32, H above 256 (a thread a
    unit), or RQ above 64 (the weights a thread keeps in registers)."""
    cl = _cluster_width(H)
    hs = H // cl
    if 4 <= H <= DECODER_CHAIN_THREADS and hs % 4 == 0 and hs <= 32:
        nq = DECODER_CHAIN_THREADS // (2 * hs)
        rq = (-(-4 * H // nq) + 3) // 4 * 4
        if rq <= 64:
            return cl, hs, nq, rq
    raise ValueError(f"the reverse decoder chain cannot split H={H} over a cluster")


def decoder_chain_replay(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc, wih,
                         whh, bl, *, count: bool = True, cell: bool = False):
    """Pass 1 of the reverse chain (`ops/decoder_chain.py
    decoder_chain_replay_plain`): every step and video at once, on clusters
    of the forward's shape through its step function
    -> (acts [5 x S x B x H], cpre [S x B x H], a [S x B x Tz],
    u [S x B x Tz x H]); with `cell` also the replayed cell [S x B x H].
    cpre and the cell equal the forward kernel's (relu(cpre) its comb, the
    cell its cs) bit for bit.  `a` is a view of rows padded to a multiple
    of 4 frames."""
    dev, S, B, Tz, H, E = _check_chain(emb, enc, pre, maskf, h_in[0], c_in[0], wl2, bl2, v,
                                       wc1, wc2, bc, wih, whh, bl, reverse=True)
    for name, t in (("h_in", h_in), ("c_in", c_in)):
        if tuple(t.shape) != (S, B, H):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(S, B, H)}")
    _require(dev, torch.float32, h_in=h_in, c_in=c_in)
    wcT, wgT = _chain_columns(wc1, wc2, wih, whh)
    f32 = dict(device=dev, dtype=torch.float32)
    acts = torch.empty(5, S, B, H, **f32)
    cpre = torch.empty(S, B, H, **f32)
    a = torch.empty(S, B, -(-Tz // 4) * 4, **f32)
    u = torch.empty(S, B, Tz, H, **f32)
    replay = torch.empty(S, B, H, **f32) if cell else None
    lib = load()
    err = lib.mucon_decoder_chain_replay(
        emb.data_ptr(), enc.data_ptr(), pre.data_ptr(), maskf.data_ptr(), h_in.data_ptr(),
        c_in.data_ptr(), wl2.data_ptr(), bl2.data_ptr(), v.data_ptr(), wcT.data_ptr(),
        bc.data_ptr(), wgT.data_ptr(), bl.data_ptr(), acts.data_ptr(), cpre.data_ptr(),
        a.data_ptr(), u.data_ptr(), _ptr(replay), S, B, Tz, H, E, _stream(dev))
    _check_launch(lib, err, "decoder_chain_bwd", count)
    out = (acts, cpre, a[..., :Tz], u)
    return (*out, replay) if cell else out


def decoder_chain_bwd_chain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2, dhs, dcs,
                            dcomb):
    """Pass 2 of the reverse chain (`decoder_chain_bwd_chain_plain`) on one
    thread-block cluster per video -> (dgate [S x B x 4H], dcpre [S x B x H],
    dsc [S x B x Tz], dh0 [B x H], dc0 [B x H]).  `a` as
    `decoder_chain_replay` returns it (rows padded to a multiple of 4)."""
    dev = _cuda_device(c_in)
    S, B, H = c_in.shape
    Tz, E = enc.shape[1], enc.shape[2]
    Tzp = -(-Tz // 4) * 4
    decoder_chain_plan(H)
    want = dict(acts=(5, S, B, H), cpre=(S, B, H), a=(S, B, Tz), u=(S, B, Tz, H),
                enc=(B, Tz, E), v=(H,), wc2=(E, H), wih=(H, 4 * H), whh=(H, 4 * H),
                wl2=(H, H), dhs=(S, B, H), dcs=(S, B, H), dcomb=(S, B, H))
    got = dict(acts=acts, cpre=cpre, a=a, u=u, enc=enc, v=v, wc2=wc2, wih=wih, whh=whh,
               wl2=wl2, dhs=dhs, dcs=dcs, dcomb=dcomb)
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, expected {shape}")
    if a.stride() != (B * Tzp, Tzp, 1) or a.device != dev or a.dtype != torch.float32:
        raise ValueError("a must be decoder_chain_replay's (f32 rows padded to 4 frames)")
    _require(dev, torch.float32, c_in=c_in, **{k: t for k, t in got.items() if k != "a"})
    lib = load()
    if lib.mucon_decoder_chain_smem(H, E, Tz, 1) > MAX_SMEM_BYTES:
        raise ValueError(f"Tz={Tz} needs more shared memory than {MAX_SMEM_BYTES} bytes")
    wg = torch.cat([wih, whh])  # [2H, 4H]: row n is column n of [Wih; Whh]^T
    f32 = dict(device=dev, dtype=torch.float32)
    dgate = torch.empty(S, B, 4 * H, **f32)
    dcpre = torch.empty(S, B, H, **f32)
    dsc = torch.empty(S, B, Tz, **f32)
    dh0 = torch.empty(B, H, **f32)
    dc0 = torch.empty(B, H, **f32)
    err = lib.mucon_decoder_chain_bwd(
        acts.data_ptr(), cpre.data_ptr(), a.data_ptr(), u.data_ptr(), c_in.data_ptr(),
        enc.data_ptr(), v.data_ptr(), wc2.data_ptr(), wg.data_ptr(), wl2.data_ptr(),
        dhs.data_ptr(), dcs.data_ptr(), dcomb.data_ptr(), dgate.data_ptr(), dcpre.data_ptr(),
        dsc.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), S, B, Tz, H, E, _stream(dev))
    _check_launch(lib, err, "decoder_chain_bwd")
    return dgate, dcpre, dsc, dh0, dc0


def decoder_chain_backward(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc,
                           wih, whh, bl, dhs, dcs, dcomb):
    """The reverse (dh, dc) chain from the step inputs h_in / c_in and the
    cotangents of (hs, cs, comb) -> (dgate [S x B x 4H], dcpre [S x B x H],
    dsc [S x B x Tz], dh0 [B x H], dc0 [B x H]).  Two kernels, counted as one
    `decoder_chain_bwd` launch: the replay of every step at once
    (`decoder_chain_replay`, into scratch allocated here), then the cluster
    chain (`decoder_chain_bwd_chain`)."""
    acts, cpre, a, u = decoder_chain_replay(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v,
                                            wc1, wc2, bc, wih, whh, bl, count=False)
    return decoder_chain_bwd_chain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2, dhs,
                                   dcs, dcomb)


# csrc/mucon_loss.cu: frames a tile, the widest cluster, the card's SMs
FLINT_TILE, FLINT_MAX_CL, SMS = 64, 16, 132


def flint_plan(B: int, T: int) -> dict:
    """The flint kernel's launch at B videos of T padded frames: a cluster
    of `width` CTAs a video, the widest power of two <= 16 with B width <=
    132 (the card's SMs) and no more CTAs than T has 64-frame tiles (at
    least 1); `ctas` = B width; a CTA takes at most `frames` = ceil(T /
    width) of its video's frames (the kernel splits a video's valid frames
    T_b into runs of ceil(T_b / width))."""
    if B < 1 or T < 1:
        raise ValueError(f"the flint kernel takes B, T >= 1; got B={B} T={T}")
    cap = min(FLINT_MAX_CL, SMS // B, -(-T // FLINT_TILE))
    width = 1
    while 2 * width <= cap:
        width *= 2
    return dict(width=width, ctas=B * width, frames=-(-T // width))


def mucon_flint(scale, xloc, sdiv, seg, target, n_len, t_valid, class_weights=None):
    """Per-video flint losses [B] of the box template from the segment
    placement scale / xloc / sdiv [B x N] (`ops/mucon_loss.py flint_prep`),
    the frame logits seg [B x T x M], the targets [B x N] and the lengths;
    `class_weights` [M] or None.  A thread-block cluster a video
    (`flint_plan`)."""
    dev = _cuda_device(seg)
    B, T, M = seg.shape
    N = scale.shape[1]
    for name, t in (("scale", scale), ("xloc", xloc), ("sdiv", sdiv), ("target", target)):
        if tuple(t.shape) != (B, N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, N)}")
    if class_weights is not None:
        if tuple(class_weights.shape) != (M,):
            raise ValueError(f"class_weights must be [{M}]")
        _require(dev, torch.float32, class_weights=class_weights)
    _require(dev, torch.float32, scale=scale, xloc=xloc, sdiv=sdiv, seg=seg)
    if target.device != dev:
        raise ValueError(f"target is on {target.device}, expected {dev}")
    tgt = target.to(torch.int32).contiguous()
    nl = _lengths_i32(n_len, B, dev, "n_len")
    tv = _lengths_i32(t_valid, B, dev, "t_valid")
    out = torch.empty(B, device=dev, dtype=torch.float32)
    lib = load()
    err = lib.mucon_flint(
        scale.data_ptr(), xloc.data_ptr(), sdiv.data_ptr(), seg.data_ptr(), tgt.data_ptr(),
        nl.data_ptr(), tv.data_ptr(), _ptr(class_weights), out.data_ptr(), B, N, T, M,
        flint_plan(B, T)["width"], _stream(dev),
    )
    _check_launch(lib, err, "mucon_flint")
    return out


def mstcnpp_tile_rows() -> int:
    """Rows of a video that one CTA of the MS-TCN++ kernels owns; a tile whose
    first row is at or past the video's length is skipped."""
    return load().mucon_mstcnpp_tile_rows()


def mstcnpp_stack(x, lengths, w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out, *,
                  pooling_layers, mm_dtype=None):
    """The eval MS-TCN++ stage of `ops/mstcnpp_stack.py` on the card: one
    `mstcnpp_stack` launch per layer (d1 = 2^(L-1-i), d2 = 2^i) and one for
    the out-projection, each on the tensor cores in error-compensated TF32
    (`ops/tf32.py`), or with `mm_dtype=torch.bfloat16` in the bf16-operand
    mode (`mstcnpp_stack_bf16`).  x [B x T x 128] f32 -> (z [B x T/2^p x 128],
    lengths >> p)."""
    bf16 = bf16_mode(mm_dtype)
    dev = _cuda_device(x)
    if x.dim() != 3:
        raise ValueError(f"x must be [B x T x C], got {tuple(x.shape)}")
    B, T, C = x.shape
    L = w3a.shape[0]
    if C != 128:
        raise ValueError(f"the MS-TCN++ kernel takes C=128, got {C}")
    for name, t, shape in (("w3a", w3a, (L, 3, C, C)), ("b3a", b3a, (L, C)),
                           ("w3b", w3b, (L, 3, C, C)), ("b3b", b3b, (L, C)),
                           ("w1t", w1t, (L, C, C)), ("w1b", w1b, (L, C, C)), ("b1", b1, (L, C)),
                           ("w_out", w_out, (C, C)), ("b_out", b_out, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(dev, torch.float32, x=x, w3a=w3a, b3a=b3a, w3b=w3b, b3b=b3b, w1t=w1t, w1b=w1b,
             b1=b1, w_out=w_out, b_out=b_out)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    # a layer's eight [C x C] blocks as one [8C x C] matrix: the kernel's k-loop
    # streams its rows in order (once per call; 4 MiB at 11 layers)
    w = torch.cat([w3a.reshape(L, 3 * C, C), w3b.reshape(L, 3 * C, C), w1t, w1b], dim=1)
    h, t, shift = x, T, 0
    for i in range(L):
        pool = i in pooling_layers
        if pool and t % 2:
            raise ValueError(f"pooling layer {i} needs an even length, got {t}")
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        err = lib.mucon_mstcnpp_layer(
            h.data_ptr(), out.data_ptr(), lens.data_ptr(), w[i].data_ptr(),
            b3a[i].data_ptr(), b3b[i].data_ptr(), b1[i].data_ptr(), B, t, C,
            2 ** (L - 1 - i), 2 ** i, shift, int(pool), int(bf16), stream,
        )
        _check_launch(lib, err, _mode("mstcnpp_stack", bf16))
        if pool:
            t, shift = t // 2, shift + 1
        h = out
    z = torch.empty(B, t, C, device=dev, dtype=torch.float32)
    err = lib.mucon_mstcnpp_proj(h.data_ptr(), z.data_ptr(), lens.data_ptr(),
                                 w_out.data_ptr(), b_out.data_ptr(), B, t, C, shift, int(bf16),
                                 stream)
    _check_launch(lib, err, _mode("mstcnpp_stack", bf16))
    return z, lengths >> shift


def _tables(ptrs, ints):
    """Host pointer and int tables of a v2 chunk launch."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints)


# the layers one v2 launch takes at most (`MAX_LAYERS` of csrc/wavenet_train_v2.cu)
V2_CHUNK_LAYERS = 32
V2_GRID_KEYS = ("fwd_max_tile_rows", "sweep_max_tile_rows", "fwd_ctas_per_sm",
                "sweep_ctas_per_sm", "sms", "fwd_smem_bytes", "sweep_smem_bytes", "chunk_layers")
V2_PLAN_KEYS = ("fwd_tile_rows", "fwd_chunk_rows", "sweep_tile_rows", "sweep_chunk_rows",
                "span_rows", "spans")


def wavenet_train_v2_grid() -> dict:
    """The v2 kernels' cooperative grids (`mucon_wavenet_train_v2_grid`):
    the forward's and the sweep's largest row tiles, the CTAs an SM that
    each kernel keeps resident (its grid is that times the SMs), the SMs,
    each kernel's shared memory a CTA and the most layers a chunk holds."""
    lib = load()
    out = (ctypes.c_int * 8)()
    err = lib.mucon_wavenet_train_v2_grid(out)
    if err:
        raise RuntimeError(f"wavenet_train_v2 grid: {lib.mucon_cuda_error_string(err).decode()}")
    return dict(zip(V2_GRID_KEYS, out))


def wavenet_train_v2_plan(B: int, T: int, jobs: int = 4) -> dict:
    """The grid of a v2 layer of B videos x T frames
    (`mucon_wavenet_train_v2_plan`): v3's (`wavenet_train_plan`), the
    forward's row tile and its weight chunk, the sweep's row tile on v3's
    weight chunk (cut in rows to fit two CTAs an SM), and the
    weight-gradient span (`spans` a video).  An output's sum depends on
    the chunk, not on the rows: on v3's chunks v2 adds as v3 does."""
    out = (ctypes.c_int * 6)()
    if load().mucon_wavenet_train_v2_plan(B, T, jobs, out):
        raise ValueError(f"no wavenet_train_v2 grid for B={B}, T={T}, jobs={jobs}")
    return dict(zip(V2_PLAN_KEYS, out))


def _check_chunks(bounds) -> None:
    for lo, hi in bounds:
        if hi - lo > V2_CHUNK_LAYERS:
            raise ValueError(f"a v2 chunk of {hi - lo} layers: one cooperative launch takes "
                             f"at most {V2_CHUNK_LAYERS}")


def wavenet_train_v2_forward(x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, *,
                             stages, pooling_layers, leaky, bounds, u_out=None):
    """Forward of the v2 trainable stack (max pooling): one cooperative
    `wavenet_train_v2_fwd` launch per chunk [lo, hi) of `bounds`.  x
    [B x T x 128] (masked), drop_masks one [B x t_i x 128] mask per layer or
    None -> (z, stash) with stash = (xs, hs): the L + 1 layer inputs (xs[L]
    the out-projection's input) and the L nonlin(z).  Given a dict
    `u_out`, each pooled layer's pre-pool output is written to u_out[i]
    too (rows t < length; the others undefined), for a check."""
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    B, T, C = x.shape
    L = len(stages)
    _check_chunks(bounds)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    t_ins, pooled, shifts, t_fin = stack_plan(stages, pooling_layers, T)
    n_pools = sum(pooled)
    f32 = dict(device=dev, dtype=torch.float32)
    xs, hs, z = [x], [], None
    for lo, hi in bounds:
        ptrs, ints = [], []
        for i in range(lo, hi):
            t, shift, pool = t_ins[i], shifts[i], pooled[i]
            m = None if drop_masks is None else drop_masks[i]
            if m is not None:
                if m.shape != (B, t, C):
                    raise ValueError(f"dropout mask {i} has shape {tuple(m.shape)}, "
                                     f"expected {(B, t, C)}")
                _require(dev, torch.float32, mask=m)
            hs.append(torch.empty(B, t, C, **f32))
            xs.append(torch.empty(B, t // 2 if pool else t, C, **f32))
            u = None
            if u_out is not None and pool:
                u = u_out[i] = torch.empty(B, t, C, **f32)
            ptrs += [xs[i].data_ptr(), xs[i + 1].data_ptr(), hs[i].data_ptr(), _ptr(m), _ptr(u)]
            ints += [t, int(stages[i]), shift, int(pool)]
        last = hi == L
        if last:
            z = torch.empty(B, t_fin, C, **f32)
        err = lib.mucon_wavenet_train_v2_fwd(
            *_tables(ptrs, ints), hi - lo, w3[lo].data_ptr(), b3[lo].data_ptr(),
            w1[lo].data_ptr(), b1[lo].data_ptr(), _ptr(w_last if last else None),
            _ptr(b_last if last else None), _ptr(z if last else None), lens.data_ptr(),
            B, C, t_fin, n_pools, int(leaky), stream,
        )
        _check_launch(lib, err, "wavenet_train_v2_fwd")
    return z, (xs, hs)


def wavenet_train_v2_backward(gz, stash, lengths, w3, w1, b1, w_last, drop_masks, *,
                              stages, pooling_layers, leaky, bounds, u_out=None):
    """Backward of the v2 trainable stack: one cooperative
    `wavenet_train_v2_sweep` launch per chunk, last chunk first (it also
    sweeps the out-projection).  gz [B x t_fin x 128] -> (gx, dw3, db3, dw1,
    db1, dw_last, db_last).  Given a dict `u_out`, each pooled layer's
    pre-pool output as the sweep recomputed it is written to u_out[i] (rows
    t < length), for a check."""
    xs, hs = stash
    dev = _cuda_device(gz)
    B, T, C = xs[0].shape
    L = len(stages)
    if gz.shape != xs[L].shape:
        raise ValueError(f"gz {tuple(gz.shape)} does not match z {tuple(xs[L].shape)}")
    _check_chunks(bounds)
    gz = gz.contiguous()
    _require(dev, torch.float32, gz=gz)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    t_ins, pooled, shifts, t_fin = stack_plan(stages, pooling_layers, T)
    n_pools = sum(pooled)
    # W^T copies (once per call) so that the kernels read them row-major
    w3t = w3.transpose(-1, -2).contiguous()
    w1t = w1.transpose(-1, -2).contiguous()
    wlt = w_last.t().contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    dw3, dw1 = torch.empty(L, 3, C, C, **f32), torch.empty(L, C, C, **f32)
    db3, db1 = torch.empty(L, C, **f32), torch.empty(L, C, **f32)
    dwl, dbl = torch.empty(C, C, **f32), torch.empty(C, **f32)
    scratch = torch.empty(3 * B * T * C, **f32)  # gm, dy and dz of the longest layer
    work = torch.empty(_work_floats(wavenet_train_v2_plan, B,
                                    ((t_fin, 1), *((t, 4) for t in t_ins))), **f32)
    g_in = [torch.empty(B, t, C, **f32) for t in t_ins]
    g_proj = torch.empty(B, t_fin, C, **f32)  # the gradient at x_fin
    for lo, hi in reversed(bounds):
        proj = hi == L
        ptrs, ints = [], []
        for i in range(lo, hi):
            t, shift, pool = t_ins[i], shifts[i], pooled[i]
            g = g_proj if i == L - 1 else g_in[i + 1]
            m = None if drop_masks is None else drop_masks[i]
            u = None
            if u_out is not None and pool:
                u = u_out[i] = torch.empty(B, t, C, **f32)
            ptrs += [xs[i].data_ptr(), hs[i].data_ptr(), _ptr(m), g.data_ptr(),
                     g_in[i].data_ptr(), _ptr(u)]
            ints += [t, int(stages[i]), shift, int(pool)]
        err = lib.mucon_wavenet_train_v2_sweep(
            *_tables(ptrs, ints), hi - lo, w3t[lo].data_ptr(), w1[lo].data_ptr(),
            w1t[lo].data_ptr(), b1[lo].data_ptr(), dw3[lo].data_ptr(), db3[lo].data_ptr(),
            dw1[lo].data_ptr(), db1[lo].data_ptr(), _ptr(gz if proj else None),
            _ptr(xs[L] if proj else None), _ptr(wlt if proj else None),
            _ptr(dwl if proj else None), _ptr(dbl if proj else None), scratch.data_ptr(),
            B * T, work.data_ptr(), work.numel(), lens.data_ptr(), B, C, t_fin, n_pools,
            int(leaky), stream,
        )
        _check_launch(lib, err, "wavenet_train_v2_sweep")
    return g_in[0], dw3, db3, dw1, db1, dwl, dbl
