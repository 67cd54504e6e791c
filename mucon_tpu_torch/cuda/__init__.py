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
then the cluster or persistent chain); `decoder_chain_bwd` likewise one per
`decoder_chain_backward` call (the parallel replay pass, then the chain,
each on the cluster or the persistent route).  `chain_launches` counts
each of the decoder chain's CUDA kernels by name where it is launched (a
wrapper's `count=False` keeps the call out of `launch_counts` only).
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
`wavenet_train_sweep_bf16`, `mstcnpp_stack_bf16`, `wavenet_train_v2_fwd_bf16`,
`wavenet_train_v2_sweep_bf16`.

Widths.  The stack kernels are built for C = 128, 256 and 512 channels
(`STACK_WIDTHS`; the row tile shrinks as C grows, so that a tile still fits
an SM); a wrapper given another C up to 512 zero-pads x, the weights, the
biases and the dropout masks to the next built width (`stack_width`) and
slices the outputs and gradients back.  That is exact: a padded channel is
0 through the conv, the (leaky) ReLU, the residual and the pool, its
weights' rows and columns are 0, and a +0 product changes no f32 partial.
Above 512 the stacks run on the wide bodies (C a runtime argument, padded
to a multiple of WIDE_SLAB = 128; a layer is two GEMM-shaped passes,
counted as one launch of its kernel's name), the `wgmma` passes of
csrc/wavenet_wgmma.cuh (TMA ring, weights split into TF32 planes once a
call, `wgmma_planes`): the eval stacks a kernel a pass
(csrc/wavenet_wgmma.cu), the trainable stack a cooperative kernel a call
that runs its passes with a grid barrier between them
(csrc/wavenet_wgmma_train.cu; the sweep on `wgmma_sweep_planes`).
`wide_launches` counts each of their C entry points where it launches.  The
recurrences take every H up to MAX_H_WIDE = 2048 as it is: the BiLSTM up
to 256 on an even or a ragged split of the units over a cluster, above on
its persistent kernels (one cooperative launch over the whole card, w_hh
resident in shared memory as far as it fits, `bilstm_fwd_launch`); the
decoder chain on a cluster a video (its forward on a ragged split of 8
CTAs from H = 64, its reverse chain on a cluster split) up to a width
that depends on B (at B = 8, H = 432 forward and 256 reverse chain; above
512 at every B), above on its persistent kernels (one
cooperative launch over the card, `decoder_chain_route`), which also take
any Tz whose rows pass a cluster's shared memory.  The DP takes any N, L
and K (`viterbi_plan`: one warp a video at the default shape, its cells in
registers across a cluster of up to 16 CTAs where many positions have few
cells, else the transcript positions walked in sequence by one CTA a
video, its row buffers in device memory past shared memory).  A width
outside these raises a ValueError that names the limit.
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from mucon_tpu_torch.ops.tf32 import tf32_split
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("wavenet_stack.cu", "bilstm.cu", "viterbi.cu", "wavenet_train.cu",
           "decoder_chain.cu", "decoder_persistent.cu", "mucon_loss.cu", "mstcnpp.cu",
           "wavenet_train_v2.cu", "wavenet_wgmma.cu", "wavenet_wgmma_train.cu")
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
    "mstcnpp_stack_bf16", "wavenet_train_v2_fwd_bf16", "wavenet_train_v2_sweep_bf16",
)
# the decoder chain's weights a CTA keeps, its [Tz / CL] score rows and the
# reverse chain's [Tz x H / CL] slices live in shared memory: a kernel's need
# for (H, E, Tz) must fit the H100's per-block opt-in limit (227 KiB)
MAX_SMEM_BYTES = 232448

launch_counts = {name: 0 for name in KERNELS}
# the stack kernels' C entry points above 512 channels, each counted where it
# launches: the eval stacks' (csrc/wavenet_wgmma.cu; the trainable stack's
# v3 forward runs on them too) and the trainable stack's sweep and v2
# chunks (csrc/wavenet_wgmma_train.cu)
WIDE_ENTRIES = ("mucon_wgmma_layer", "mucon_wgmma_proj", "mucon_wgmma_mstcnpp_layer",
                "mucon_wgt_sweep", "mucon_wgt_v2_fwd", "mucon_wgt_v2_sweep")
wide_launches = {name: 0 for name in WIDE_ENTRIES}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for name in CHAIN_KERNELS:
        chain_launches[name] = 0
    for name in WIDE_ENTRIES:
        wide_launches[name] = 0


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
    bad = [(out, rc) for out, rc in results if rc != 0]
    if bad:  # the failing commands' output, not the others'
        raise RuntimeError(f"nvcc failed with code {bad[0][1]}:\n"
                           f"{''.join(out for out, _ in bad)[-6000:]}")
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
            lib.mucon_wavenet_tile_rows.argtypes = [I]
            L = ctypes.c_long
            lib.mucon_bilstm_recurrence.argtypes = [P] * 8 + [L] + [I] * 3 + [P]
            lib.mucon_dense_viterbi.argtypes = [P] * 8 + [I] * 12 + [P]
            lib.mucon_viterbi_smem.argtypes = [I] * 6
            lib.mucon_viterbi_smem.restype = ctypes.c_size_t
            lib.mucon_viterbi_position.argtypes = [P] * 10 + [I] * 10 + [P]
            lib.mucon_viterbi_position_smem.argtypes = [I] * 6 + [ctypes.POINTER(I)]
            lib.mucon_viterbi_position_smem.restype = ctypes.c_size_t
            lib.mucon_wavenet_train_fwd.argtypes = [P] * 10 + [I] * 9 + [P]
            lib.mucon_wavenet_train_sweep.argtypes = [P] * 16 + [I] * 10 + [P]
            lib.mucon_wavenet_train_plan.argtypes = [I, I, I, I, ctypes.POINTER(I)]
            lib.mucon_bilstm_fwd_plan.argtypes = [I, I, ctypes.POINTER(I)]
            lib.mucon_bilstm_bwd_coefs.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.mucon_bilstm_bwd_chain.argtypes = [P] * 8 + [L] + [I] * 3 + [P]
            lib.mucon_bilstm_chain_plan.argtypes = [I, I, ctypes.POINTER(I)]
            lib.mucon_bilstm_scratch_floats.argtypes = [I, I, I]
            lib.mucon_bilstm_scratch_floats.restype = L
            lib.mucon_decoder_chain_fwd.argtypes = [P] * 16 + [I] * 5 + [P]
            lib.mucon_decoder_chain_replay.argtypes = [P] * 18 + [I] * 5 + [P]
            lib.mucon_decoder_chain_bwd.argtypes = [P] * 18 + [I] * 5 + [P]
            lib.mucon_decoder_chain_route.argtypes = [I] * 4 + [ctypes.POINTER(I)]
            lib.mucon_decoder_chain_persistent_scratch.argtypes = [I] * 6
            lib.mucon_decoder_chain_persistent_scratch.restype = L
            lib.mucon_decoder_chain_persistent_plan.argtypes = [I] * 6 + [ctypes.POINTER(I)]
            lib.mucon_decoder_chain_persistent_fwd.argtypes = [P] * 22 + [L] + [I] * 7 + [P]
            lib.mucon_decoder_chain_persistent_bwd.argtypes = [P] * 19 + [L] + [I] * 6 + [P]
            lib.mucon_decoder_chain_smem.argtypes = [I] * 4
            lib.mucon_decoder_chain_width.argtypes = [I]
            lib.mucon_decoder_chain_fwd_launch.argtypes = [I] * 4 + [ctypes.POINTER(I)]
            lib.mucon_flint.argtypes = [P] * 9 + [I] * 7 + [P]
            lib.mucon_flint_smem.argtypes = [I, I]
            lib.mucon_flint_smem.restype = ctypes.c_size_t
            lib.mucon_mstcnpp_layer.argtypes = [P] * 7 + [I] * 8 + [P]
            lib.mucon_mstcnpp_tile_rows.argtypes = [I]
            lib.mucon_mstcnpp_proj.argtypes = [P] * 5 + [I] * 5 + [P]
            # per-layer pointer and int tables are host arrays
            PP, IP = ctypes.POINTER(P), ctypes.POINTER(I)
            lib.mucon_wavenet_train_v2_fwd.argtypes = [PP, IP, I] + [P] * 8 + [I] * 6 + [P]
            lib.mucon_wavenet_train_v2_sweep.argtypes = ([PP, IP, I] + [P] * 14 + [L, P, L, P]
                                                         + [I] * 6 + [P])
            lib.mucon_wavenet_train_v2_grid.argtypes = [I, I, IP]
            lib.mucon_wavenet_train_v2_plan.argtypes = [I, I, I, I, IP]
            lib.mucon_wgt_sweep.argtypes = ([P] * 7 + [I] * 2 + [P] * 4 + [L] + [P] * 5
                                            + [I] * 10 + [P])
            lib.mucon_wgt_v2_fwd.argtypes = [PP, IP, I, P, I, I] + [P] * 6 + [I] * 6 + [P]
            lib.mucon_wgt_v2_sweep.argtypes = ([PP, IP, I, P, P, I, I] + [P] * 10 + [L, P, L]
                                               + [P] * 2 + [I] * 6 + [P])
            lib.mucon_wgt_parts.argtypes = [I, I]
            lib.mucon_wgt_work_floats.argtypes = [I, I, I, I]
            lib.mucon_wgt_work_floats.restype = L
            lib.mucon_wgt_v2_sweep_layers.argtypes = []
            lib.mucon_wgt_grid.argtypes = [I, IP]
            lib.mucon_wgmma_layer.argtypes = [P] * 6 + [I] * 2 + [P] * 3 + [I] * 9 + [P]
            lib.mucon_wgmma_proj.argtypes = [P] * 4 + [I] * 2 + [P] + [I] * 7 + [P]
            lib.mucon_wgmma_mstcnpp_layer.argtypes = [P] * 5 + [I] * 2 + [P] * 3 + [I] * 8 + [P]
            lib.mucon_wgmma_max_videos.argtypes = [I]
            lib.mucon_wgmma_attrs.argtypes = [I, IP]
            for fn in (lib.mucon_wavenet_layer, lib.mucon_wavenet_tile_rows,
                       lib.mucon_bilstm_recurrence,
                       lib.mucon_dense_viterbi, lib.mucon_viterbi_position,
                       lib.mucon_wavenet_train_fwd,
                       lib.mucon_wavenet_train_sweep, lib.mucon_wavenet_train_plan,
                       lib.mucon_bilstm_fwd_plan,
                       lib.mucon_bilstm_bwd_coefs, lib.mucon_bilstm_bwd_chain,
                       lib.mucon_bilstm_chain_plan, lib.mucon_mstcnpp_tile_rows,
                       lib.mucon_decoder_chain_fwd, lib.mucon_decoder_chain_replay,
                       lib.mucon_decoder_chain_bwd, lib.mucon_decoder_chain_smem,
                       lib.mucon_decoder_chain_width, lib.mucon_decoder_chain_fwd_launch,
                       lib.mucon_decoder_chain_route, lib.mucon_decoder_chain_persistent_plan,
                       lib.mucon_decoder_chain_persistent_fwd,
                       lib.mucon_decoder_chain_persistent_bwd,
                       lib.mucon_flint, lib.mucon_mstcnpp_layer, lib.mucon_mstcnpp_proj,
                       lib.mucon_wavenet_train_v2_fwd, lib.mucon_wavenet_train_v2_sweep,
                       lib.mucon_wavenet_train_v2_grid, lib.mucon_wavenet_train_v2_plan,
                       lib.mucon_wgt_sweep, lib.mucon_wgt_v2_fwd, lib.mucon_wgt_v2_sweep,
                       lib.mucon_wgt_parts, lib.mucon_wgt_grid, lib.mucon_wgt_v2_sweep_layers,
                       lib.mucon_wgmma_layer, lib.mucon_wgmma_proj,
                       lib.mucon_wgmma_mstcnpp_layer, lib.mucon_wgmma_max_videos,
                       lib.mucon_wgmma_attrs):
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


# the channel widths the stack kernels are built for (csrc/wavenet_layer.cuh,
# mstcnpp.cu); another C up to the last is zero-padded to the next of them.
# Above the last, the wide bodies (csrc/wavenet_wgmma.cuh) take C as a runtime
# argument, a multiple of the WIDE_SLAB-column slab their tiles cover.
STACK_WIDTHS = (128, 256, 512)
WIDE_SLAB = 128


def stack_width(C: int) -> int:
    """The width a stack kernel runs C channels at: the least of
    `STACK_WIDTHS` not below C (C itself at 128, 256, 512); above 512, C
    rounded up to a multiple of WIDE_SLAB (the wide bodies; 768 and 1024 as
    they are).  Raises below 1."""
    if C < 1:
        raise ValueError(f"the stack kernels take C >= 1 channels, got C={C}")
    if C > STACK_WIDTHS[-1]:
        return -(-C // WIDE_SLAB) * WIDE_SLAB
    return next(w for w in STACK_WIDTHS if w >= C)


def is_wide(C: int) -> bool:
    """True where a stack kernel runs C (padded) channels on the wide bodies."""
    return C > STACK_WIDTHS[-1]


def pad_channels(t, Cp: int, dims):
    """t with each dimension in `dims` zero-padded at its end to Cp (t
    itself where none is short; None stays None)."""
    if t is None or all(t.shape[d] == Cp for d in dims):
        return t
    shape = list(t.shape)
    for d in dims:
        shape[d] = Cp
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pad_stack(Cp, x, w3, b3, w1, b1, w_last, b_last):
    """A WaveNet stack's input and packed weights zero-padded to Cp channels."""
    return (pad_channels(x, Cp, (2,)), pad_channels(w3, Cp, (2, 3)), pad_channels(b3, Cp, (1,)),
            pad_channels(w1, Cp, (1, 2)), pad_channels(b1, Cp, (1,)),
            pad_channels(w_last, Cp, (0, 1)), pad_channels(b_last, Cp, (0,)))


def _pad_masks(drop_masks, Cp):
    return None if drop_masks is None else [pad_channels(m, Cp, (2,)) for m in drop_masks]


def _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last) -> torch.device:
    dev = _cuda_device(x)
    B, T, C = x.shape
    L = len(stages)
    stack_width(C)
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


# rows a tile of the wide bodies takes and k a chunk (csrc/wavenet_wgmma.cuh
# GM, GK: an element's sum depends on the chunk; the weight gradients sum
# their rows in chunks of GK)
WIDE_TILE_ROWS, WIDE_CHUNK_ROWS = 64, 32


def wavenet_tile_rows(C: int = 128) -> int:
    """Rows a CTA of `wavenet_layer` owns at C channels (csrc/wavenet_stack.cu
    `eval_tm` of `stack_width(C)`: 64, 32 at 256, 16 at 512; 64 on the wide
    bodies, a tile of 128 columns); a tile at or past its video's length is
    skipped."""
    Cp = stack_width(C)
    return WIDE_TILE_ROWS if is_wide(Cp) else load().mucon_wavenet_tile_rows(Cp)


def _wide_call(lib, name: str, *args) -> int:
    """Call the wide entry point `name` (one of WIDE_ENTRIES) of lib; counted
    in `wide_launches` where it launched (returned 0)."""
    err = getattr(lib, name)(*args)
    wide_launches[name] += err == 0
    return err


def wgmma_planes(blocks, bf16: bool) -> torch.Tensor:
    """A stack's weights as the `wgmma` bodies read them above 512 channels
    (csrc/wavenet_wgmma.cuh): blocks [NB x K x N] (each [C x C] product's
    input rows by output columns) transposed to [NB x N x K], K contiguous
    (`wgmma` takes TF32 operands K-major only); then the TF32 hi and lo
    planes of `ops/tf32.py tf32_split`, [2 x NB x N x K], or in the
    bf16-operand mode one plane rounded to bf16, [1 x NB x N x K].  Once a
    call, for every layer."""
    wt = blocks.transpose(-1, -2).contiguous()
    if bf16:
        return wt.to(torch.bfloat16)[None]
    return torch.stack(tf32_split(wt))


def wgmma_sweep_planes(w3, w1, w_last, bf16: bool) -> torch.Tensor:
    """The trainable stack's weights as its sweep reads them above 512
    channels (csrc/wavenet_wgmma_train.cu): dz = dy W1^T and dx = sum_k
    dz[t - (k-1) d] W3[k]^T multiply by the transposed blocks, so each [N x
    K] plane is a block as it is: `wgmma_planes` of the transposed blocks of
    `wavenet_wgmma_blocks` (layer i's taps at 4i .. 4i + 2, its W1 at
    4i + 3, Wl last)."""
    return wgmma_planes(wavenet_wgmma_blocks(w3, w1, w_last).transpose(-1, -2), bf16)


def wavenet_wgmma_blocks(w3, w1, w_last) -> torch.Tensor:
    """The WaveNet eval stack's [C x C] blocks in the `wgmma` body's order:
    layer i's conv taps at 4i .. 4i + 2 and its 1x1 at 4i + 3, then the
    out-projection (4L)."""
    L, C = w3.shape[0], w_last.shape[0]
    return torch.cat([torch.cat([w3, w1[:, None]], dim=1).reshape(4 * L, C, C), w_last[None]])


def mstcnpp_wgmma_blocks(w, w_out) -> torch.Tensor:
    """The MS-TCN++ stage's [C x C] blocks in the `wgmma` body's order: layer
    i's [8C x C] matrix (W3a's taps, W3b's, W1t, W1b) at 8i .. 8i + 7, then
    the projection (8L)."""
    C = w_out.shape[0]
    return torch.cat([w.reshape(-1, C, C), w_out[None]])


def wgmma_items(lengths, T: int, shift: int, slabs: int) -> list:
    """The items of one `wgmma` pass over len(lengths) videos x T rows, in the
    order its persistent CTAs walk them (csrc/wavenet_wgmma.cu `decode`):
    item k is pair k // slabs of the live WIDE_TILE_ROWS-row tiles (video by
    video; a tile whose first row is at or past min(T, length >> shift) is
    left out) at slab k % slabs.  Each entry (slab, (b, t0), (b, t0) or None:
    the pair's second tile, missing after an odd count)."""
    B = len(lengths)
    pre = [0]  # live tiles before video b, as the kernel's prefix in shared memory
    for n in lengths:
        pre.append(pre[-1] + -(-min(T, int(n) >> shift) // WIDE_TILE_ROWS))

    def tile(i):
        if i >= pre[-1]:
            return None
        b = bisect.bisect_right(pre, i, 0, B) - 1  # the last video with pre[b] <= i
        return b, (i - pre[b]) * WIDE_TILE_ROWS

    return [(k % slabs, tile(2 * (k // slabs)), tile(2 * (k // slabs) + 1))
            for k in range((pre[-1] + 1) // 2 * slabs)]


def _check_wgmma_batch(B: int, bf16: bool) -> None:
    """Raise where B videos pass the `wgmma` bodies' shared memory (every
    pass kind's, the eval and the trainable stacks')."""
    most = load().mucon_wgmma_max_videos(int(bf16))
    if B > most:
        raise ValueError(f"the `wgmma` stacks take at most {most} videos above 512 channels, "
                         f"got B={B}")


_grid_words = {}


def _grid_word(dev) -> torch.Tensor:
    """A device word for the grid barrier of the trainable stack's
    cooperative launches above 512 channels on the current stream of dev:
    each launch zeroes it on that stream first, so that a launch queued on
    another stream cannot reset a running launch's barrier."""
    key = (dev, _stream(dev))
    if key not in _grid_words:
        _grid_words[key] = torch.zeros(4, device=dev, dtype=torch.int32)
    return _grid_words[key]


def _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16,
              planes=None) -> torch.Tensor:
    """z = mask(nonlin(h) Wl + bl): the eval kernel's final_proj launch, a
    `wavenet_layer` count (above 512 channels the `wgmma` body's projection
    on the stack's forward `planes`, its last block)."""
    B, t, C = h.shape
    out = torch.empty(B, t, C, device=h.device, dtype=torch.float32)
    if is_wide(C):
        nblk = planes.shape[1]
        err = _wide_call(lib, "mucon_wgmma_proj", h.data_ptr(), out.data_ptr(), lens.data_ptr(),
                         planes.data_ptr(), nblk, nblk - 1, b_last.data_ptr(), B, t, C, shift, 1,
                         int(leaky), int(bf16), stream)
    else:
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
    (`mm_dtype=torch.bfloat16`: the bf16-operand mode, `wavenet_layer_bf16`;
    above 512 channels a layer is the `wgmma` body's two passes,
    `mucon_wgmma_layer`, counted as one launch).  x [B x T x C] f32, any C
    (zero-padded to `stack_width(C)`) -> (z [B x T/2^p x C], lengths >> p)."""
    bf16 = bf16_mode(mm_dtype)
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    C0 = x.shape[2]
    x, w3, b3, w1, b1, w_last, b_last = _pad_stack(stack_width(C0), x, w3, b3, w1, b1, w_last,
                                                   b_last)
    B, T, C = x.shape
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    wide = is_wide(C)
    if wide:
        _check_wgmma_batch(B, bf16)
        hbuf = torch.empty(B, T, C, device=dev, dtype=torch.float32)
        planes = wgmma_planes(wavenet_wgmma_blocks(w3, w1, w_last), bf16)
        nblk = planes.shape[1]
    h, t, shift = x, T, 0
    for i, d in enumerate(stages):
        pool = i in pooling_layers
        if pool and t % 2:
            raise ValueError(f"pooling layer {i} needs an even length, got {t}")
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        if wide:
            err = _wide_call(lib, "mucon_wgmma_layer", h.data_ptr(), out.data_ptr(), 0,
                             hbuf.data_ptr(), lens.data_ptr(), planes.data_ptr(), nblk, 4 * i,
                             b3[i].data_ptr(), b1[i].data_ptr(), 0, B, t, C, int(d), shift,
                             int(pool), pool_mean, int(leaky), int(bf16), stream)
        else:
            err = lib.mucon_wavenet_layer(
                h.data_ptr(), out.data_ptr(), lens.data_ptr(), w3[i].data_ptr(),
                b3[i].data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
                B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), 0, int(bf16), stream,
            )
        _check_launch(lib, err, _mode("wavenet_layer", bf16))
        if pool:
            t, shift = t // 2, shift + 1
        h = out
    if wide:
        z = torch.empty(B, t, C, device=dev, dtype=torch.float32)
        err = _wide_call(lib, "mucon_wgmma_proj", h.data_ptr(), z.data_ptr(), lens.data_ptr(),
                         planes.data_ptr(), nblk, nblk - 1, b_last.data_ptr(), B, t, C, shift, 1,
                         int(leaky), int(bf16), stream)
        _check_launch(lib, err, _mode("wavenet_layer", bf16))
    else:
        z = _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16)
    return (z if C == C0 else z[..., :C0].contiguous()), lengths >> shift


def wide_parts(C: int, jobs: int = 4) -> int:
    """The parts the trainable stack's weight gradients cut the rows into
    above 512 channels (`mucon_wgt_parts`: items x parts fill 132 SMs, the
    items of a part jobs x (C / 128)^2 output blocks; a
    function of C alone, so that the gradients' bits do not depend on the
    card), at `stack_width(C)`."""
    parts = load().mucon_wgt_parts(stack_width(C), jobs)
    if parts < 1:
        raise ValueError(f"no wide weight-gradient parts for C={C}, jobs={jobs}")
    return parts


def wgrad_chunks(lengths, T: int, shift: int, parts: int) -> list:
    """The rows of each part of a weight-gradient pass above 512 channels, in
    the order its items sum them (csrc/wavenet_wgmma.cuh `wdecode`): every
    video's rows t < min(T, length >> shift) in WIDE_CHUNK_ROWS-row chunks,
    video by video, cut into `parts` runs of chunks [g N / parts, (g + 1) N
    / parts).  Entry g: the (video, first row) of part g's chunks."""
    chunks = [(b, t0) for b, n in enumerate(lengths)
              for t0 in range(0, min(T, int(n) >> shift), WIDE_CHUNK_ROWS)]
    N = len(chunks)
    return [chunks[g * N // parts:(g + 1) * N // parts] for g in range(parts)]


# the output rows of a weight-gradient item above 512 channels (csrc/wavenet_wgmma.cuh WA)
WGRAD_BAND = 128


def wgrad_items(C: int, jobs: int, parts: int) -> list:
    """The items of a weight-gradient pass above 512 channels in the order
    its persistent CTAs walk them (csrc/wavenet_wgmma.cuh `wdecode`): item k
    is (part g, job, bm, bn), part-major, then the job, B's 128-column band
    bn (the output columns), A's WGRAD_BAND-column band bm (the output rows,
    the last cut at C), at `stack_width(C)`."""
    Cp = stack_width(C)
    return [(g, job, bm, bn) for g in range(parts) for job in range(jobs)
            for bn in range(Cp // WIDE_SLAB) for bm in range(-(-Cp // WGRAD_BAND))]


def wavenet_train_plan(B: int, T: int, jobs: int = 4, C: int = 128) -> dict:
    """The grid of a `wavenet_train.cu` layer of B videos x T frames x C
    channels (`plan_for`, chosen from the shape alone, at `stack_width(C)`):
    the rows a CTA of the forward (`fwd_tile_rows`) and of the sweep's dz
    and dx kernels (`tile_rows`) owns (64, 32 or 16, as many as fit an SM
    at that width), and the rows a weight-gradient CTA sums (`span_rows`,
    `spans` a video) with `jobs` products a layer (4; 1 for the
    out-projection).  Above 512 channels (the `wgmma` bodies): 64-row tiles,
    and the weight gradients' WIDE_CHUNK_ROWS-row chunks cut into `spans` =
    `wide_parts` parts of all the rows."""
    if is_wide(stack_width(C)):
        return dict(fwd_tile_rows=WIDE_TILE_ROWS, tile_rows=WIDE_TILE_ROWS,
                    span_rows=WIDE_CHUNK_ROWS, spans=wide_parts(C, jobs))
    out = (ctypes.c_int * 4)()
    lib = load()
    err = lib.mucon_wavenet_train_plan(B, T, stack_width(C), jobs, out)
    if err:
        raise ValueError(f"no wavenet_train grid for B={B}, T={T}, jobs={jobs}")
    return dict(fwd_tile_rows=out[0], tile_rows=out[1], span_rows=out[2], spans=out[3])


def _work_floats(plan, B: int, C: int, layers) -> int:
    """Floats of the sweep's weight-gradient partials: B x spans x jobs
    partials of (C + 1) x C, for the largest of `layers` ((T, jobs) pairs)."""
    return max(B * plan(B, t, jobs, C)["spans"] * jobs for t, jobs in layers) * (C + 1) * C


def wavenet_train_forward(x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, *,
                          stages, pooling_layers, pooling_type, leaky, mm_dtype=None):
    """Forward of the trainable stack on the card: one `wavenet_train_fwd`
    launch per layer and one `wavenet_layer` out-projection launch (in the
    bf16-operand mode with `mm_dtype=torch.bfloat16`: `wavenet_train_fwd_bf16`
    and `wavenet_layer_bf16`; above 512 channels the eval stacks' `wgmma`
    entry points, `mucon_wgmma_layer` with the mask and the stash, and
    `mucon_wgmma_proj`).
    x [B x T x C] (masked), drop_masks one [B x t_i x C] mask per layer
    or None -> (z, stash) with stash = (xs, hs, us, x_fin): each layer's
    input, nonlin(z) and (pooled layers, by index) pre-pool output, at
    `stack_width(C)` channels (zero-padded).  hs and us hold the rows
    t < length only (the sweep reads no other); their rows at t >= length
    are undefined."""
    bf16 = bf16_mode(mm_dtype)
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    C0 = x.shape[2]
    Cp = stack_width(C0)
    x, w3, b3, w1, b1, w_last, b_last = _pad_stack(Cp, x, w3, b3, w1, b1, w_last, b_last)
    B, T, C = x.shape
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    planes = None
    if is_wide(C):  # the `wgmma` bodies: the stack's planes once a call
        _check_wgmma_batch(B, bf16)
        planes = wgmma_planes(wavenet_wgmma_blocks(w3, w1, w_last), bf16)
    xs, hs, us = [], [], {}
    h, t, shift = x, T, 0
    for i, d in enumerate(stages):
        pool = i in pooling_layers
        m = None if drop_masks is None else drop_masks[i]
        if m is not None:
            if m.shape != (B, t, C0):
                raise ValueError(f"dropout mask {i} has shape {tuple(m.shape)}, "
                                 f"expected {(B, t, C0)}")
            m = pad_channels(m, C, (2,))
            _require(dev, torch.float32, mask=m)
        hs_i = torch.empty(B, t, C, device=dev, dtype=torch.float32)
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        u = torch.empty(B, t, C, device=dev, dtype=torch.float32) if pool else None
        if is_wide(C):
            err = _wide_call(lib, "mucon_wgmma_layer", h.data_ptr(), out.data_ptr(), _ptr(u),
                             hs_i.data_ptr(), lens.data_ptr(), planes.data_ptr(),
                             planes.shape[1], 4 * i, b3[i].data_ptr(), b1[i].data_ptr(), _ptr(m),
                             B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), int(bf16),
                             stream)
        else:
            err = lib.mucon_wavenet_train_fwd(
                h.data_ptr(), out.data_ptr(), _ptr(u), hs_i.data_ptr(), lens.data_ptr(),
                w3[i].data_ptr(), b3[i].data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
                _ptr(m), B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), int(bf16),
                stream,
            )
        _check_launch(lib, err, _mode("wavenet_train_fwd", bf16))
        xs.append(h)
        hs.append(hs_i)
        if pool:
            us[i] = u
            t, shift = t // 2, shift + 1
        h = out
    z = _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky, bf16, planes)
    return (z if C == C0 else z[..., :C0].contiguous()), (xs, hs, us, h)


def wavenet_train_backward(gz, stash, lengths, w3, w1, w_last, drop_masks, *,
                           stages, pooling_layers, pooling_type, leaky, mm_dtype=None):
    """Backward sweep of the trainable stack on the card: the
    out-projection's sweep, then one `wavenet_train_sweep` per layer, last
    first.  gz [B x t_fin x C] -> (gx, dw3, db3, dw1, db1, dw_last, db_last),
    at C channels (the stash's are `stack_width(C)`, sliced back here).
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
    C0 = w_last.shape[0]
    gz = pad_channels(gz, C, (2,))
    w3, w1, w_last = (pad_channels(w3, C, (2, 3)), pad_channels(w1, C, (1, 2)),
                      pad_channels(w_last, C, (0, 1)))
    drop_masks = _pad_masks(drop_masks, C)
    if gz.shape != x_fin.shape:
        raise ValueError(f"gz {tuple(gz.shape)} does not match z {tuple(x_fin.shape)}")
    gz = gz.contiguous()
    _require(dev, torch.float32, gz=gz)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    pool_mean = int(pooling_type != "max")
    f32 = dict(device=dev, dtype=torch.float32)
    wide = is_wide(C)
    proj_bf16 = bf16 and (L - 1) not in us
    if wide:  # the `wgmma` bodies: the blocks as they are, split once a call
        _check_wgmma_batch(B, bf16)
        planes = wgmma_sweep_planes(w3, w1, w_last, bf16)
        # the out-projection's sweep in f32 where the last layer pools (above)
        proj_w = ((planes, planes.shape[1] - 1) if proj_bf16 == bf16
                  else (wgmma_planes(w_last.t()[None], False), 0))
        layer_w = [(planes, 4 * i) for i in range(L)]
        cnt = _grid_word(dev)
        # the partials, the chunks' column sums and dy's and dz's K-major
        # planes, at the longest layer (f32 planes: the larger)
        work = torch.empty(lib.mucon_wgt_work_floats(C, B, T, 0), **f32)
    else:  # W^T copies (once per call) so that the kernels read them row-major
        w3t = w3.transpose(-1, -2).contiguous()
        w1t = w1.transpose(-1, -2).contiguous()
        proj_w = (w_last.t().contiguous(), None)
        layer_w = list(zip(w1t, w3t))
        work = torch.empty(_work_floats(wavenet_train_plan, B, C, ((x_fin.shape[1], 1),
                                                                *((x.shape[1], 4) for x in xs))),
                           **f32)
    dw3 = torch.empty(L, 3, C, C, **f32)
    db3 = torch.empty(L, C, **f32)
    dw1 = torch.empty(L, C, C, **f32)
    db1 = torch.empty(L, C, **f32)
    dwl = torch.empty(C, C, **f32)
    dbl = torch.empty(C, **f32)
    n_pools = len(us)
    t_fin = x_fin.shape[1]
    dy = torch.empty(B, T, C, **f32)  # scratch, sized for the longest layer

    def sweep(g, u, x, h, m, w, dz, g_in, dw1_i, db1_i, dw3_i, db3_i,
              t, d, shift, pooled, proj, bf16):
        if wide:  # w: the planes and the layer's first block
            err = _wide_call(
                lib, "mucon_wgt_sweep", g.data_ptr(), _ptr(u), x.data_ptr(), h.data_ptr(),
                _ptr(m), lens.data_ptr(), w[0].data_ptr(), w[0].shape[1], w[1], dy.data_ptr(),
                dz.data_ptr(), _ptr(g_in), work.data_ptr(), work.numel(), dw1_i.data_ptr(),
                db1_i.data_ptr(), _ptr(dw3_i), _ptr(db3_i), cnt.data_ptr(), B, t, C, int(d),
                shift, int(pooled), pool_mean, int(leaky), int(proj), int(bf16), stream)
        else:  # w: W1^T and W3^T (Wl^T for the out-projection)
            err = lib.mucon_wavenet_train_sweep(
                g.data_ptr(), _ptr(u), x.data_ptr(), h.data_ptr(), _ptr(m),
                lens.data_ptr(), w[0].data_ptr(), _ptr(w[1]), dy.data_ptr(),
                dz.data_ptr(), _ptr(g_in), work.data_ptr(), dw1_i.data_ptr(),
                db1_i.data_ptr(), _ptr(dw3_i), _ptr(db3_i), B, t, C, int(d), shift,
                int(pooled), pool_mean, int(leaky), int(proj), int(bf16), stream,
            )
        _check_launch(lib, err, _mode("wavenet_train_sweep", bf16))

    g = torch.empty(B, t_fin, C, **f32)  # gradient at x_fin
    sweep(gz, None, x_fin, x_fin, None, proj_w, g, None, dwl, dbl, None, None,
          t_fin, 0, n_pools, False, True, proj_bf16)
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
        sweep(g, us.get(i), x_i, hs[i], m, layer_w[i], dz, g_in, dw1[i], db1[i],
              dw3[i], db3[i], t, stages[i], shift, pooled, False, bf16)
        g = g_in
    return _unpad_grads(C0, g, dw3, db3, dw1, db1, dwl, dbl)


def _unpad_grads(C0, gx, dw3, db3, dw1, db1, dwl, dbl):
    """A stack's gradients at C0 channels, from those at its padded width."""
    if gx.shape[2] == C0:
        return gx, dw3, db3, dw1, db1, dwl, dbl
    c = slice(0, C0)
    return (gx[..., c].contiguous(), dw3[..., c, c].contiguous(), db3[:, c].contiguous(),
            dw1[:, c, c].contiguous(), db1[:, c].contiguous(), dwl[c, c].contiguous(),
            dbl[c].contiguous())


# the widest hidden size of the recurrences' narrow kernels, and the widest
# they take (csrc/bilstm.cu, decoder_chain.cu MAX_H, MAX_H_WIDE; the JAX
# package's byte gates admit its kernels up to H = 1447)
MAX_H, MAX_H_WIDE = 512, 2048
# the BiLSTM's cluster kernels take H up to BILSTM_NARROW_H; above it the
# persistent kernels (csrc/bilstm.cu NARROW_H, NTP): PERSISTENT is the cluster
# width a plan reports for them (no cluster: the whole card)
BILSTM_NARROW_H, PERSISTENT, PERSISTENT_THREADS = 256, 0, 512


def _check_width(H: int, what: str) -> None:
    if not 1 <= H <= MAX_H_WIDE:
        raise ValueError(f"{what} takes a hidden size from 1 to {MAX_H_WIDE} (MAX_H_WIDE), "
                         f"got H={H}")


def _cluster_width(H: int) -> int:
    """The widest of 8, 4, 2 CTAs that leaves each at least 16 hidden
    units, else 1 (`cluster::width_for` in csrc/cluster.cuh)."""
    return next((c for c in (8, 4, 2) if H % c == 0 and H // c >= 16), 1)


def _ragged_width(H: int) -> int:
    """The cluster of a ragged split (`ragged_width` in csrc/bilstm.cu and
    decoder_chain.cu): 8 CTAs from H = 64, 4 from 32, 2 from 16, else 1;
    CTA r takes units [r H / CL, (r + 1) H / CL)."""
    return 8 if H >= 64 else 4 if H >= 32 else 2 if H >= 16 else 1


def units_of(rank: int, cl: int, H: int) -> range:
    """The hidden units CTA `rank` of a cluster of `cl` takes (`units_of`):
    the even split where cl divides H, else ceil or floor of H / cl."""
    return range(rank * H // cl, (rank + 1) * H // cl)


def _fwd_split(H: int, cl: int, hs: int):
    for nt in (256, 512):
        if 4 * hs > nt or 8 * hs > nt:
            continue
        nk = nt // (4 * hs)
        kc = (-(-H // nk) + 3) // 4 * 4
        if kc <= 64:
            return cl, hs, nt, nk, kc
    return None


def bilstm_persistent_order(H: int, chain: bool) -> tuple:
    """The sum order above BILSTM_NARROW_H (`persist_order` in
    csrc/bilstm.cu), a function of H alone: (groups, rows a group) of the
    contraction over K = H (the forward: NK groups of KC k-rows) or 4H (the
    reverse chain: NQ groups of GPQ gate rows), each a multiple of 4.  With
    hs = ceil(H / 8) and R = 512 up to H = 512, 1024 above: NK = max(1, R /
    (4 hs)), NQ = max(1, R / hs); the orders of the cluster kernels the
    persistent ones replaced."""
    hs, r, K = -(-H // 8), 512 if H <= MAX_H else 1024, 4 * H if chain else H
    n = max(1, r // (hs if chain else 4 * hs))
    return n, (-(-K // n) + 3) // 4 * 4


def bilstm_fwd_plan(H: int) -> tuple:
    """How the forward recurrence splits a hidden size H (`fwd_plan` in
    csrc/bilstm.cu): (cluster width CL, most hidden units a CTA HS, threads
    per CTA NT, k-groups NK, k-rows per group KC).  Up to H = 256 a cluster:
    each CTA's 4 HS gate columns times NK groups of KC rows (a multiple of 4)
    cover the [H x 4H] w_hh slice, KC <= 64 the weights a thread keeps in
    registers; NT is the least of 256, 512 that holds the columns and a
    thread per unit for 8 videos; the even split (`_cluster_width`, CL | H)
    where it holds, else the ragged split (`_ragged_width`, `units_of`).
    Above H = 256 the persistent kernel: CL = PERSISTENT, HS = 0 (the units
    are split over the whole card's CTAs, `bilstm_fwd_launch`), 512
    threads, the order of `bilstm_persistent_order`.  Every H from 1 to
    MAX_H_WIDE; raises above."""
    _check_width(H, "the forward recurrence")
    if H > BILSTM_NARROW_H:
        return (PERSISTENT, 0, PERSISTENT_THREADS, *bilstm_persistent_order(H, False))
    cl = _cluster_width(H)
    rl = _ragged_width(H)
    return _fwd_split(H, cl, H // cl) or _fwd_split(H, rl, -(-H // rl))


BILSTM_CLUSTER_LAUNCH_KEYS = ("cl", "threads", "nk", "kc", "clusters", "active")
BILSTM_PERSISTENT_LAUNCH_KEYS = ("ctas", "threads", "nk", "kc", "units", "co_resident",
                                 "rv", "rc", "bv", "tiles", "kch", "chunks", "resident",
                                 "stages", "smem")


def _bilstm_launch(B: int, H: int, chain: bool) -> dict:
    lib = load()
    out = (ctypes.c_int * 16)()
    err = (lib.mucon_bilstm_chain_plan if chain else lib.mucon_bilstm_fwd_plan)(B, H, out)
    if err != 0:
        raise RuntimeError(f"bilstm {'chain' if chain else 'forward'} plan failed: "
                           f"{lib.mucon_cuda_error_string(err).decode()}")
    if not out[0]:
        return dict(kind="cluster", **dict(zip(BILSTM_CLUSTER_LAUNCH_KEYS, out[1:7])),
                    smem=out[15])
    launch = dict(kind="persistent", **dict(zip(BILSTM_PERSISTENT_LAUNCH_KEYS, out[1:16])))
    launch["w_hh"] = ("shared memory" if launch["resident"] == launch["chunks"] else
                      "streamed" if launch["resident"] == 0 else "shared memory + streamed")
    return launch


def bilstm_fwd_launch(B: int, H: int) -> dict:
    """The forward's launch at B videos (`mucon_bilstm_fwd_plan`).  Up to H
    = 256 (`kind` "cluster"): the plan's CL, NT, NK, KC, the clusters of
    the grid (one per direction and 8 videos) and how many the card holds
    at once (more run in waves).  Above (`kind` "persistent"): `ctas` a
    direction (the grid is twice that, one cooperative launch), the plan's
    fields (`persist_plan` in csrc/bilstm.cu: `units` a CTA at most; a
    thread's tile of `rv` videos x `rc` columns of one of `nk` groups of
    `kc` rows, `bv` videos a pass and `tiles` passes; each group's rows
    staged `kch` at a time in `chunks` chunks, of which `resident` stay in
    shared memory and the rest stream through a ring of `stages` slots;
    `smem` the bytes a CTA takes), `co_resident` the
    CTAs the card holds at once (at one an SM: its SMs) and `w_hh`: where
    the weights live ("shared memory", "shared memory + streamed",
    "streamed")."""
    return _bilstm_launch(B, H, False)


def bilstm_chain_launch(B: int, H: int) -> dict:
    """The reverse chain's launch at B videos (`mucon_bilstm_chain_plan`),
    as `bilstm_fwd_launch` (NK, KC: the chain's NQ, GPQ)."""
    return _bilstm_launch(B, H, True)


def _scratch(B: int, H: int, chain: bool, dev):
    """The scratch of a persistent launch (`mucon_bilstm_scratch_floats`: its
    step counters, exchange rows and state, which the launch zeroes, and the
    forward's packed w_hh rows where it streams); none up to H = 256."""
    n = load().mucon_bilstm_scratch_floats(int(chain), B, H)
    if n < 0:
        raise RuntimeError(f"no persistent BiLSTM plan on this card at B={B}, H={H}")
    return (torch.empty(n, device=dev, dtype=torch.float32), n) if n else (None, 0)


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
    scratch, n = _scratch(B, H, False, dev)
    lib = load()
    err = lib.mucon_bilstm_recurrence(
        xp.data_ptr(), m.data_ptr(), w_hh.data_ptr(), outs.data_ptr(),
        h.data_ptr(), c.data_ptr(), _ptr(cs), _ptr(scratch), n, T, B, H, _stream(dev),
    )
    _check_launch(lib, err, name)
    return outs, h, c, cs


def bilstm_recurrence(xp, m, w_hh):
    """xp [T x 2 x B x 4H], m [T x B], w_hh [2 x H x 4H] (f32) ->
    (outs [T x 2 x B x H], h [2 x B x H], c [2 x B x H]): up to H = 256 one
    thread-block cluster per direction and 8 videos, w_hh resident in its
    registers; above, one cooperative launch of the persistent kernel over
    the whole card, w_hh resident in its CTAs' shared memory as far as it
    holds and streamed for the rest (`bilstm_fwd_launch`)."""
    return _bilstm_forward(xp, m, w_hh, False, "bilstm_recurrence")[:3]


def bilstm_train_forward(xp, m, w_hh):
    """`bilstm_recurrence` that also returns the cell trajectory
    cs [T x 2 x B x H] the reverse chain replays from."""
    return _bilstm_forward(xp, m, w_hh, True, "bilstm_train_fwd")


# the chain kernel's tiling (csrc/bilstm.cu): videos per cluster, threads per
# CTA of the even split (NTC) and of the ragged one (NTW)
BILSTM_CHAIN_BT, BILSTM_CHAIN_THREADS, BILSTM_CHAIN_WIDE_THREADS = 8, 256, 512


def bilstm_chain_plan(H: int) -> tuple:
    """How the reverse chain splits a hidden size H (`chain_plan` in
    csrc/bilstm.cu): (cluster width CL, most columns a CTA HS, thread groups
    NQ, gate rows per group GPQ).  Up to H = 256 a cluster: the even split
    (`_cluster_width`) on 256 threads, GPQ <= 128 weights a thread in
    registers, where it leaves at most 32 columns a CTA (a thread per video
    and column); else the ragged split (`_ragged_width`, `units_of`) on 512
    threads, each reading its GPQ rows of w_hh from L2 every step.  Above H =
    256 the persistent kernel: CL = PERSISTENT, HS = 0 and the order of
    `bilstm_persistent_order`.  Every H from 1 to MAX_H_WIDE; raises
    above."""
    _check_width(H, "the reverse chain")
    if H > BILSTM_NARROW_H:
        return (PERSISTENT, 0, *bilstm_persistent_order(H, True))
    cl = _cluster_width(H)
    hs, nt = H // cl, BILSTM_CHAIN_THREADS
    if BILSTM_CHAIN_BT * hs > nt:
        cl = _ragged_width(H)
        hs, nt = -(-H // cl), BILSTM_CHAIN_WIDE_THREADS
    nq = nt // hs
    return cl, hs, nq, (-(-4 * H // nq) + 3) // 4 * 4


def _check_bilstm_bwd(dev, T, B, H, **tensors):
    """The reverse chain's H limit and the shapes of its inputs:
    [T x 2 x B x H] each, but dh and dc [2 x B x H] and coefs
    [6 x T x 2 x B x H]."""
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
    """The sequential pass (`bilstm_bwd_chain_plain`): dxp [T x 2 x B x 4H],
    on a thread-block cluster per direction and 8 videos up to H = 256, on
    one cooperative launch of the persistent kernel above
    (`bilstm_chain_launch`)."""
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
    scratch, n = _scratch(B, H, True, dev)
    lib = load()
    err = lib.mucon_bilstm_bwd_chain(
        coefs.data_ptr(), m.data_ptr(), w_hh.data_ptr(), douts.data_ptr(), dh.data_ptr(),
        dc.data_ptr(), dxp.data_ptr(), _ptr(scratch), n, T, B, H, _stream(dev))
    _check_launch(lib, err, "bilstm_train_bwd")
    return dxp


def bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc):
    """Reverse (dh, dc) chain: dxp [T x 2 x B x 4H] from the stash and the
    cotangents of (outs, h_fin, c_fin).  Two kernels, counted as one
    `bilstm_train_bwd` launch: the coefficient pass over all steps at once
    (`bilstm_bwd_coefs`, into scratch allocated here), then the chain
    (`bilstm_bwd_chain`)."""
    coefs = bilstm_bwd_coefs(xp, m, w_hh, outs, cs, count=False)
    return bilstm_bwd_chain(coefs, m, w_hh, douts, dh, dc)


# csrc/viterbi.cu: windows of W staged in shared memory at a time, threads
# of the cluster body, cells a lane of the warp body holds, cells of a row a
# thread of the cluster body holds, its widest cluster and the rows a thread
# may hold (its instances); the position body's threads, its warps' rings of
# 32 partials and its per-row scalars (8 bytes each), and the entry windows
# a lane may own (its instances)
VITERBI_KC, VITERBI_BLOCK_THREADS, VITERBI_LANE_CELLS = 128, 256, 72
VITERBI_CELLS, VITERBI_MAX_CL, VITERBI_ROWS = 16, 16, (1, 2, 4)
VITERBI_POS_THREADS, VITERBI_POS_SCALARS, VITERBI_ENTRIES = 512, 8, (2, 4)
VITERBI_BODIES = {"warp": 0, "cluster": 1}  # mucon_dense_viterbi's bodies


def _viterbi_state(body: str, N: int, cl: int) -> int:
    """Floats of shared memory the warp or cluster body takes beside W's
    staged windows (`viterbi_smem` in csrc/viterbi.cu)."""
    return {"warp": 0, "cluster": 4 * cl * N + 2 * N}[body]


def _viterbi_cluster(N: int, L: int):
    """The cluster body's split of a video's [N x L] cells, (CL, TPR, RPT):
    TPR threads a row slice (a power of two up to a warp), RPT rows a thread
    (VITERBI_ROWS), 16 cells of each, CL = ceil(L / (16 TPR)) CTAs; the
    fewest rows a thread, then the narrowest cluster, 8 CTAs or fewer (a
    portable cluster) before 16; one where its slots and a staged window
    fit MAX_SMEM_BYTES.  None where no cluster of 16 holds the cells."""
    for widest in (8, VITERBI_MAX_CL):
        for rpt in VITERBI_ROWS:
            best = None
            for tpr in (1, 2, 4, 8, 16, 32):
                if VITERBI_BLOCK_THREADS // tpr * rpt < N:
                    break
                cl = -(-L // (tpr * VITERBI_CELLS))
                fits = 4 * (N + _viterbi_state("cluster", N, cl)) <= MAX_SMEM_BYTES
                if cl <= widest and fits and (best is None or cl < best[0]):
                    best = (cl, tpr, rpt)
            if best:
                return best
    return None


def _viterbi_position_layout(K: int, L: int, R: int) -> tuple:
    """The position body's row buffers in floats (`pos_wb`, `pos_pb`,
    `pos_eb`, `pos_kk` in csrc/viterbi.cu): (Kp, the transposed W's row
    stride, its column padded past the last task's reads; Lp, a pois row's
    where the rows are read in place; the entries; the 64-bit keys, K
    rounded up to even)."""
    r4 = lambda x: (x + 3) & ~3  # noqa: E731
    return r4(K + 34 * R), r4(L + 2 * R), r4(K + 32 * R), K + (K & 1)


def _viterbi_position_smem(K: int, N: int, L: int, R: int, rows: bool, table: bool) -> int:
    """Shared-memory bytes of a position-body launch (`position_smem`): its
    warps' rings and scalars; with `rows` its keys, two W columns, two pois
    rows and entries; with `table` the walk's [K-1 x N] uint16 table."""
    Kp, Lp, EB, KK = _viterbi_position_layout(K, L, R)
    warps = VITERBI_POS_THREADS // 32
    nbytes = warps * 32 * 8 + VITERBI_POS_SCALARS * 8
    if rows:
        nbytes += 8 * KK + 4 * (2 * Kp + 2 * Lp + EB)
    return nbytes + (2 * (K - 1) * N if table else 0)


def _viterbi_entries(K: int) -> int:
    """Entry windows a lane of the position body owns (VITERBI_ENTRIES): 4
    where K windows make at least five tasks of 128 entries (K >= 640),
    else 2 (twice the tasks, so the row's longest chain shares its SM with
    fewer idle schedulers).  Device ms, 2 / 4 entries (measured on one
    NVIDIA H100 80GB HBM3, 700.00 W): 4.831 / 3.125 at frame_sampling
    1 (K = 2560), 0.888 / 0.732 at frame_sampling 3 (K = 853); 1.014 / 1.206
    at N = 300, L = 400, K = 512 (128 videos), 0.377 / 0.423 at N = 300, L
    = 66, K = 85, 0.439 / 0.488 at N = 300, L = 2000, K = 40 (6 videos)."""
    return 4 if K >= 640 else 2


def viterbi_position_tasks(kend: int, js: int, lmax: int, entries: int) -> list:
    """The position body's split of a row (its mirror; csrc/viterbi.cu):
    for each of its 16 warps the tasks it takes, (j0, l_last) each.  A task
    is 32 `entries` entry windows from j0 (lane t owns j0 + entries t ..
    + entries - 1), walked for l = 0 .. l_last = min(lmax, kend - 1 - j0);
    the tasks start at js rounded down to a task and end past kend - 1,
    longest first, dealt in a snake over the SM's four schedulers (warp w
    on w % 4), then round robin over each scheduler's warps.  None at a row
    whose entries are all NEG (js = kend)."""
    warps, span = VITERBI_POS_THREADS // 32, 32 * entries
    out = [[] for _ in range(warps)]
    if js >= kend:
        return out
    jb = js - js % span
    ntask = -(-(kend - jb) // span)
    for w in range(warps):
        s, q = w % 4, w // 4
        while 4 * q < ntask:
            i = 4 * q + (3 - s if q % 2 else s)
            if i < ntask:
                j0 = jb + span * i
                out[w].append((j0, min(lmax, kend - 1 - j0)))
            q += warps // 4
    return out


# The DP's crossings (measured on one H100 with
# `scripts/probe_viterbi_flint.py --grid`, device ms by torch.profiler,
# each shape on each body, K = 1.28 L; NVIDIA H100 80GB HBM3, 700.00 W): by B (at most; None: any), by N (at
# most), the L from which the position body beats the cluster body (None:
# it never does where a cluster holds the cells).  E.g. at N = 33, 6 videos,
# 0.143 against 0.187 ms at L = 133 and 0.132 against 0.084 at L = 66; at N
# = 300, 128 videos, 0.488 against 0.536 at L = 66; at N = 300, 6 videos,
# 1.528 against 1.460 at L = 400; at N = 16 0.057-0.095 against 0.153-0.649
# from L = 133.
VITERBI_CROSSINGS = ((8, ((16, 1), (33, 133), (64, 200), (128, 400), (None, None))),
                     (None, ((16, 1), (33, 133), (64, 200), (128, 200), (None, 66))))
# Within the warp body's shapes (N <= 32, L <= 72), by N (at most), the L
# from which the position body beats it (the same probe): at N = 8 from L =
# 20 (0.020 / 0.018 ms against 0.021 / 0.023 at 6 / 128 videos), at N = 16
# from L = 66 (0.057 / 0.050 against 0.064 / 0.058; at L = 20 0.022 / 0.027
# against 0.019 / 0.020); at N = 30 the warp body (requests A and B: 0.124 /
# 0.063 against 0.060 / 0.061).
VITERBI_WARP_CROSSINGS = ((8, 1), (16, 66))


def viterbi_route(B: int, N: int, L: int) -> str:
    """The DP's body for B videos of N transcript positions and L cells a
    row, by the crossings measured on the card: the warp body where a warp
    holds a video (N <= 32, L <= 72) and L lies below
    VITERBI_WARP_CROSSINGS' L for N; the cluster body where a cluster of at
    most 16 CTAs holds the cells and L lies below VITERBI_CROSSINGS' L for
    (B, N); else the position body."""
    if N <= 32 and L <= VITERBI_LANE_CELLS:
        cross = next((c for n, c in VITERBI_WARP_CROSSINGS if N <= n), None)
        return "warp" if cross is None or L < cross else "position"
    if _viterbi_cluster(N, L) is None:
        return "position"
    rows = next(r for b, r in VITERBI_CROSSINGS if b is None or B <= b)
    cross = next(c for n, c in rows if n is None or N <= n)
    return "cluster" if cross is None or L < cross else "position"


def viterbi_plan(B: int, N: int, L: int, K=None, body=None, entries=None) -> dict:
    """The DP's launch (`csrc/viterbi.cu`), on the body `viterbi_route`
    picks (or `body`, as tests and probes force it): the warp body (one
    warp a video, lane n holding row n's cells in registers: `lc` = 72 of
    them); the cluster body (a cluster of `cl` CTAs of 256 threads a video,
    `tpr` threads a row slice of 16 `tpr` columns, `rpt` rows a thread, `lc`
    = 16 cells of each in registers, `_viterbi_cluster`); the position body
    (one CTA of 512 threads a video walking the rows in sequence).  `ctas` = B cl.  With K,
    also the dynamic shared memory a CTA takes (`smem`) and where the walk's
    [K-1 x N] uint16 table lives: "shared" where it fits beside the rest
    (the warp and position bodies), else "global" (the walk reads the int32
    bps; the cluster body always, so that its CTAs stay small enough to
    share an SM); for the warp and cluster bodies the windows of W staged
    at a time (`staged`: VITERBI_KC, fewer where the K - 1 windows are fewer
    or the body's slots leave less room); for the position body the entry
    windows a lane owns (`entries`, `_viterbi_entries`, or as given) and
    where its row buffers, entries and keys live (`rows`: "shared", else
    "device" where they pass shared memory: read in place, the entries and
    keys in device scratch).  Every N, L, K >= 1."""
    if min(B, N, L) < 1:
        raise ValueError(f"the DP takes B, N, L >= 1; got B={B} N={N} L={L}")
    body = body or viterbi_route(B, N, L)
    if body == "warp":
        if N > 32 or L > VITERBI_LANE_CELLS:
            raise ValueError(f"the warp body takes N <= 32, L <= 72; got N={N} L={L}")
        lc, threads, cl, tpr, rpt = VITERBI_LANE_CELLS, 32, 1, 0, 0
    elif body == "cluster":
        split = _viterbi_cluster(N, L)
        if split is None:
            raise ValueError(f"no cluster of 16 CTAs holds N={N} x L={L} cells")
        lc, threads = VITERBI_CELLS, VITERBI_BLOCK_THREADS
        cl, tpr, rpt = split
    elif body == "position":
        lc, threads, cl, tpr, rpt = 0, VITERBI_POS_THREADS, 1, 0, 0
    else:
        raise ValueError(f"unknown DP body {body!r}")
    plan = dict(body=body, lc=lc, threads=threads, warps=threads // 32, ctas=B * cl, cl=cl,
                tpr=tpr, rpt=rpt)
    if K is None:
        return plan
    if K < 1:
        raise ValueError("the DP needs at least one window")
    if body == "position":
        R = entries or _viterbi_entries(K)
        if R not in VITERBI_ENTRIES:
            raise ValueError(f"the position body takes entries in {VITERBI_ENTRIES}; got {R}")
        rows = _viterbi_position_smem(K, N, L, R, True, False) <= MAX_SMEM_BYTES
        with_table = _viterbi_position_smem(K, N, L, R, rows, True)
        table = with_table <= MAX_SMEM_BYTES and L <= 65536
        plan.update(entries=R, rows="shared" if rows else "device",
                    smem=_viterbi_position_smem(K, N, L, R, rows, table),
                    table="shared" if table else "global")
        return plan
    state = _viterbi_state(body, N, cl)
    staged = min(VITERBI_KC, max(K - 1, 1), (MAX_SMEM_BYTES // 4 - state) // N)
    base = 4 * (staged * N + state)
    # the cluster body's CTAs would each hold rank 0's table: its walk
    # reads the int32 bps (at most N of them, from L2)
    table = (body != "cluster" and base + 2 * (K - 1) * N <= MAX_SMEM_BYTES
             and L <= 65536)
    plan.update(staged=staged, smem=base + (2 * (K - 1) * N if table else 0),
                table="shared" if table else "global")
    return plan


def viterbi_smem(K: int, N: int, body: str, cl: int, table: bool, staged=None, L: int = 1,
                 entries: int = 4, rows: bool = True) -> int:
    """The kernel file's own count of a launch's shared memory (a check of
    `viterbi_plan`): the warp and cluster bodies' (`staged` defaults to
    min(VITERBI_KC, K - 1)), or the position body's at L cells, `entries`
    a lane and `rows` in shared memory."""
    if body == "position":
        out = (ctypes.c_int * 4)()
        return load().mucon_viterbi_position_smem(K, N, L, entries, int(rows), int(table), out)
    staged = min(VITERBI_KC, max(K - 1, 1)) if staged is None else staged
    return load().mucon_viterbi_smem(K, N, VITERBI_BODIES[body], cl, int(table), staged)


def dense_viterbi_decode(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int,
                         body=None, entries=None):
    """W [B x K x N], pois [B x N x L] (f32), k_valid / n_valid [B] ->
    (score [B], best_l [B] int32, bps [B x K-1 x N] int32, pos [B x K]
    int64): the DP and the pointer walk in one launch (`viterbi_plan`;
    `body` / `entries` force a body / the position body's entries a lane,
    as the tests and probes do).  The position body takes W transposed
    ([B x N x Kp], a copy a call) and, where its rows pass shared memory,
    pois padded to Lp columns and scratch for its entries and keys."""
    dev = _cuda_device(W)
    B, K, N = W.shape
    L = pois.shape[2]
    if pois.shape != (B, N, L):
        raise ValueError(f"pois {tuple(pois.shape)} does not match W {tuple(W.shape)}")
    if frame_sampling < 1:
        raise ValueError(f"frame_sampling must be >= 1, got {frame_sampling}")
    plan = viterbi_plan(B, N, L, K, body=body, entries=entries)
    _require(dev, torch.float32, W=W, pois=pois)
    kv = _lengths_i32(k_valid, B, dev, "k_valid")
    nv = _lengths_i32(n_valid, B, dev, "n_valid")
    score = torch.empty(B, device=dev, dtype=torch.float32)
    best_l = torch.empty(B, device=dev, dtype=torch.int32)
    bps = torch.empty(B, K - 1, N, device=dev, dtype=torch.int32)
    pos = torch.empty(B, K, device=dev, dtype=torch.int64)
    lib = load()
    table = int(plan["table"] == "shared")
    if plan["body"] == "position":
        R = plan["entries"]
        Kp, Lp, EB, KK = _viterbi_position_layout(K, L, R)
        Wt = torch.empty(B, N, Kp, device=dev, dtype=torch.float32)
        Wt[:, :, :K].copy_(W.transpose(1, 2))
        entry = keys = None
        if plan["rows"] == "device":
            padded = torch.empty(B, N, Lp, device=dev, dtype=torch.float32)
            padded[:, :, :L].copy_(pois)
            pois, pstride = padded, Lp
            entry = torch.empty(B, EB, device=dev, dtype=torch.float32)
            keys = torch.empty(B, KK, device=dev, dtype=torch.int64)
        else:
            pstride = L
        err = lib.mucon_viterbi_position(
            Wt.data_ptr(), pois.data_ptr(), kv.data_ptr(), nv.data_ptr(), score.data_ptr(),
            best_l.data_ptr(), bps.data_ptr(), pos.data_ptr(), _ptr(entry), _ptr(keys),
            B, K, N, L, Kp, pstride, int(frame_sampling), int(max_len), R, table, _stream(dev))
    else:
        err = lib.mucon_dense_viterbi(
            W.data_ptr(), pois.data_ptr(), kv.data_ptr(), nv.data_ptr(),
            score.data_ptr(), best_l.data_ptr(), bps.data_ptr(), pos.data_ptr(),
            B, K, N, L, int(frame_sampling), int(max_len), VITERBI_BODIES[plan["body"]],
            plan["cl"], plan["tpr"], plan["rpt"], table, plan["staged"], _stream(dev))
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
    return dev, S, B, Tz, H, E


def _check_cluster_smem(H: int, E: int, Tz: int, reverse: bool) -> None:
    """The cluster kernels keep the CTA's weights, its [Tz / CL] score rows
    and the reverse chain's [Tz x H / CL] slices in shared memory: their
    need for (H, E, Tz) must fit the H100's per-block opt-in limit."""
    need = load().mucon_decoder_chain_smem(H, E, Tz, int(reverse))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"H={H} E={E} Tz={Tz} needs {need} bytes of shared memory a block on "
                         f"the cluster kernels; the limit is {MAX_SMEM_BYTES}")


# the forward chain's and the replay pass's threads per CTA (csrc/decoder_chain.cu NTF)
DECODER_CHAIN_FWD_THREADS = 256


def decoder_chain_fwd_plan(H: int) -> tuple:
    """How the forward chain splits a hidden size H over a cluster
    (`fwd_plan` in csrc/decoder_chain.cuh): (cluster width CL, most units a
    CTA HS, threads per CTA).  The ragged split: CL = `_ragged_width(H)`
    (8 from H = 64), CTA r taking the units `units_of(r, CL, H)` (the even split where CL
    divides H, as at H = 128), HS = ceil(H / CL) sizing its shared-memory
    regions.  A CTA sends every rank its units' rows of h Wl2
    (q is their sum, in rank order); the combine layer and the gates are
    warp GEMVs (a warp's lanes split k): in pass p, warp w takes the
    combine layer's columns 32 p + 4 w .. + 3 of the CTA's units and the
    gate columns 64 p + 8 w .. + 7 of its 4 units' gates.  Every H from 1
    to MAX_H_WIDE (a CTA's threads stride over its units where it writes
    their state; its shared memory bounds the widest H at a given E,
    `_check_cluster_smem`); raises above.  The persistent forward keeps CL
    as the ranks of its sums (`decoder_chain_persistent_split`)."""
    _check_width(H, "the forward decoder chain")
    cl = _ragged_width(H)
    return cl, -(-H // cl), DECODER_CHAIN_FWD_THREADS


DECODER_CHAIN_FWD_LAUNCH_KEYS = ("cl", "hs", "threads", "clusters", "active", "weights",
                                 "tables")


def decoder_chain_fwd_launch(B: int, H: int, E: int, Tz: int) -> dict:
    """The cluster forward's launch at B videos (`mucon_decoder_chain_fwd_launch`):
    its CL, HS and threads, the clusters of the grid (one a video), how many
    the card holds at once (more run in waves), whether each CTA's weights
    sit in shared memory (1) or are read from L2 (0), and its rows of
    maskf, pre and enc the same.  Where `decoder_chain_route` sends the
    forward to the persistent kernel, `decoder_chain_persistent_launch`
    reports that launch."""
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


# the decoder chain's two routes (`decoder_chain_route`) and the CUDA kernels
# behind its two launch counts, each counted by name in `chain_launches`
DECODER_CHAIN_ROUTES = ("cluster", "persistent")
CHAIN_KERNELS = ("chain_fwd_kernel", "chain_replay_kernel", "chain_bwd_kernel",
                 "chain_persistent_fwd_kernel", "chain_persistent_bwd_kernel")
chain_launches = {name: 0 for name in CHAIN_KERNELS}
# threads a CTA of the persistent kernels (csrc/decoder_persistent.cu NTP)
DECODER_PERSISTENT_THREADS = 512


def decoder_chain_route(B: int, H: int, E: int, Tz: int) -> dict:
    """Which kernels take the decoder chain at B videos of Tz frames, hidden
    size H and E encoder channels (`mucon_decoder_chain_route`), decided
    before the launch from the shape alone: {"fwd": the forward's and the
    replay pass's, "bwd": the reverse chain's}, each "cluster" (a cluster of
    CTAs a video, csrc/decoder_chain.cu) or "persistent" (one cooperative
    launch over the card, csrc/decoder_persistent.cu).  The persistent
    kernels take each direction above the H where they were faster in turns
    on an H100 at the nearest measured B (`CROSSINGS` in
    csrc/decoder_chain.cu, PERF.md: the forward and the replay pass above
    335, 432, 384 and 512 at B <= 2, <= 16, <= 64 and above; the reverse
    chain above 256, and 296 above B = 64), and the
    shapes whose Tz-long rows pass the cluster kernels' shared memory (the
    forward's frames' rows of maskf, pre and enc; the reverse chain's
    [Tz x HS] tables).  Both routes sum in the same order, so they give the
    same bits.  Each decision is logged once on
    `mucon_tpu_torch.kernel_routing`."""
    decoder_chain_fwd_plan(H)
    decoder_chain_plan(H)
    lib = load()
    out = (ctypes.c_int * 2)()
    err = lib.mucon_decoder_chain_route(B, H, E, Tz, out)
    if err != 0:
        raise ValueError(f"no decoder chain route at B={B} H={H} E={E} Tz={Tz}: "
                         f"{lib.mucon_cuda_error_string(err).decode()}")
    route = {"fwd": DECODER_CHAIN_ROUTES[out[0]], "bwd": DECODER_CHAIN_ROUTES[out[1]]}
    from mucon_tpu_torch.models.routing import log_route

    log_route(f"decoder chain at B={B} H={H} E={E} Tz={Tz}: the forward and the replay pass on the "
              f"{route['fwd']} kernel, the reverse chain on the {route['bwd']} kernel")
    return route


def _route(route, kind: str, B: int, H: int, E: int, Tz: int) -> str:
    """The given route, or `decoder_chain_route`'s for the shape."""
    if route is None:
        return decoder_chain_route(B, H, E, Tz)[kind]
    if route not in DECODER_CHAIN_ROUTES:
        raise ValueError(f"route must be one of {DECODER_CHAIN_ROUTES}, got {route!r}")
    return route


# csrc/decoder_persistent.cu: frames of a scores block (FB), channels of a
# pair's chunk split four ways (PC), the side of K = enc Wc2's tiles (KT)
DECODER_PERSISTENT_FB, DECODER_PERSISTENT_PC, DECODER_PERSISTENT_KT = 32, 128, 64


def decoder_chain_persistent_chunks(NI: int, H: int, E: int, ctas: int = 132) -> dict:
    """How a persistent forward launch of `ctas` CTAs over NI items deals
    its attention (`pf_plan` in csrc/decoder_persistent.cu; the launch
    reports the same, `decoder_chain_persistent_launch`): frames of a scores
    block, channels of an (item, rank) pair's chunk of the softmax partials
    (DECODER_PERSISTENT_PC, four threads a channel, where the pairs' chunks
    of that many are at most two a CTA, else one thread a channel, 512) and
    channels of a ctx chunk."""
    cl = decoder_chain_fwd_plan(H)[0]
    pc = DECODER_PERSISTENT_PC
    few = NI * cl * -(-E // pc) <= 2 * ctas
    return dict(frames_block=DECODER_PERSISTENT_FB,
                pair_channels=pc if few else DECODER_PERSISTENT_THREADS,
                ctx_channels=DECODER_PERSISTENT_THREADS)


def _dealt(r: int, n: int, ctas: int):
    """The work units r, r + ctas, ... < n: CTA r's of n dealt round-robin."""
    return range(r, n, ctas)


def decoder_chain_persistent_split(NI: int, H: int, E: int, Tz: int, ctas: int = 132,
                                   reverse: bool = False) -> list:
    """What each CTA of a persistent launch of `ctas` takes, phase by phase
    as csrc/decoder_persistent.cu deals it, one dict a CTA.  Forward (NI
    items): its units `units_of(r, ctas, H)` of every item, so their gate
    columns 4 j + q ("gates"), cpre and q columns; the scores' blocks
    (item, frames) of `frames_block` frames (`phase_s`), the softmax
    partials' (item, rank, frames, channels) units (`phase_p`: rank the
    frames [rank Tz / CL, (rank + 1) Tz / CL) of the cluster forward's CL
    ranks, `decoder_chain_fwd_plan`, its channels in chunks of
    `pair_channels`) and ctx's (item, channels) chunks (`phase_x`), each
    dealt round-robin over the CTAs in that order
    (`decoder_chain_persistent_chunks`).  Reverse (NI = B videos): its
    units (their [Wih; Whh] rows j and H + j, their dq), its tiles (rows,
    columns) of K = enc Wc2 [B Tz x H] dealt round-robin, its even range of
    the (video, frame) pairs of da and the videos whose dsc it writes
    (b mod ctas)."""
    out = []
    if reverse:
        kt, R = DECODER_PERSISTENT_KT, NI * Tz
        nct = -(-H // kt)
        for r in range(ctas):
            units = units_of(r, ctas, H)
            tiles = [(range(t // nct * kt, min(R, (t // nct + 1) * kt)),
                      range(t % nct * kt, min(H, (t % nct + 1) * kt)))
                     for t in _dealt(r, -(-R // kt) * nct, ctas)]
            out.append(dict(units=units, rows=[*units, *(H + j for j in units)], k=tiles,
                            da=range(r * R // ctas, (r + 1) * R // ctas),
                            dsc=list(range(r, NI, ctas))))
        return out
    cl = decoder_chain_fwd_plan(H)[0]
    chunks = decoder_chain_persistent_chunks(NI, H, E, ctas)
    fb, pch, xch = chunks["frames_block"], chunks["pair_channels"], chunks["ctx_channels"]
    nfb, npc, nxc = -(-Tz // fb), -(-E // pch), -(-E // xch)
    for r in range(ctas):
        units = units_of(r, ctas, H)
        blocks = [(w // nfb, range(w % nfb * fb, min(Tz, (w % nfb + 1) * fb)))
                  for w in _dealt(r, NI * nfb, ctas)]
        pairs = [(w // npc // cl, w // npc % cl,
                  range(w // npc % cl * Tz // cl, (w // npc % cl + 1) * Tz // cl),
                  range(w % npc * pch, min(E, (w % npc + 1) * pch)))
                 for w in _dealt(r, NI * cl * npc, ctas)]
        ctx = [(w // nxc, range(w % nxc * xch, min(E, (w % nxc + 1) * xch)))
               for w in _dealt(r, NI * nxc, ctas)]
        out.append(dict(units=units, gates=range(4 * units.start, 4 * units.stop),
                        cpre=units, q=units, scores=blocks, pairs=pairs, ctx=ctx))
    return out


DECODER_PERSISTENT_FWD_KEYS = ("ctas", "units", "ranks", "co_resident", "smem", "tile",
                               "resident_q", "resident_cpre", "resident_gates", "cols_q",
                               "cols_cpre", "cols_gates", "frames_block", "pair_channels",
                               "ctx_channels")
DECODER_PERSISTENT_BWD_KEYS = ("ctas", "units", "ranks", "co_resident", "smem", "nq", "rq",
                               "tile_dgate", "tile_dq", "resident_wg", "resident_wl2",
                               "k_tile")


def decoder_chain_persistent_launch(NI: int, H: int, E: int, Tz: int, reverse: bool = False,
                                    ctas=None) -> dict:
    """A persistent launch's plan on this card
    (`mucon_decoder_chain_persistent_plan`; `ctas` None: one CTA an SM):
    its CTAs, the most units a CTA, the cluster route's ranks (CL), the CTAs
    the card holds at once and the shared memory bytes a CTA; forward (NI
    items: B videos, or S B steps for the replay pass): the items a tile,
    the columns of Wl2, [Wc1; Wc2] and the gates a CTA keeps resident in
    shared memory against the columns it owns (the rest are read from L2 a
    tile a step); reverse (NI = B videos): NQ, RQ, the videos a tile of
    dgate and of dq, and the resident rows of [Wih; Whh] (of 2 U) and of
    Wl2 (of U), the side of K's tiles; the forward also how it deals the
    attention (`decoder_chain_persistent_chunks`).  `co_resident` below
    `ctas` means the cooperative launch is refused."""
    lib = load()
    out = (ctypes.c_int * 15)()
    err = lib.mucon_decoder_chain_persistent_plan(int(reverse), NI, H, E, Tz, ctas or 0, out)
    if err not in (0, COOPERATIVE_TOO_LARGE):
        raise RuntimeError(f"decoder chain persistent plan failed: "
                           f"{lib.mucon_cuda_error_string(err).decode()}")
    keys = DECODER_PERSISTENT_BWD_KEYS if reverse else DECODER_PERSISTENT_FWD_KEYS
    return dict(zip(keys, out))


# cudaErrorCooperativeLaunchTooLarge: the card cannot hold the grid at once
COOPERATIVE_TOO_LARGE = 720


def _check_persistent(lib, err: int, name: str, count: bool, ctas) -> None:
    """`_check_launch` for a persistent launch, naming what it needs where
    the card refuses the cooperative grid."""
    if err == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"{name} launch refused: the persistent decoder chain needs all "
                           f"{ctas or 'its'} CTAs resident at once (one an SM, a cooperative "
                           f"launch) and this card cannot hold them "
                           f"({lib.mucon_cuda_error_string(err).decode()})")
    _check_launch(lib, err, name, count)


def _persistent_scratch(reverse: bool, n: int, H: int, E: int, Tz: int, replay: bool, dev):
    k = load().mucon_decoder_chain_persistent_scratch(int(reverse), n, H, E, Tz, int(replay))
    if k < 0:
        raise ValueError(f"no persistent decoder chain plan fits shared memory at H={H} E={E} "
                         f"Tz={Tz}")
    return torch.empty(k, device=dev, dtype=torch.float32), k


def _persistent_fwd(dev, emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh,
                    bl, NI: int, S: int, B: int, outs, replay, ctas) -> int:
    """One persistent forward launch over NI items of S steps: the forward
    (`outs` = hs, cs, comb) or the replay pass (`replay` = acts, cpre, a, u,
    cell)."""
    Tz, H, E = enc.shape[1], wl2.shape[0], enc.shape[2]
    wcT, wgT = _chain_columns(wc1, wc2, wih, whh)
    wl2T = wl2.t().contiguous()
    scratch, n = _persistent_scratch(False, NI, H, E, Tz, replay is not None, dev)
    hs, cs, comb = outs or (None,) * 3
    acts, cpre, a, u, cell = replay or (None,) * 5
    return load().mucon_decoder_chain_persistent_fwd(
        emb.data_ptr(), enc.data_ptr(), pre.data_ptr(), maskf.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), wl2T.data_ptr(), bl2.data_ptr(), v.data_ptr(), wcT.data_ptr(),
        bc.data_ptr(), wgT.data_ptr(), bl.data_ptr(), _ptr(hs), _ptr(cs), _ptr(comb),
        _ptr(acts), _ptr(cpre), _ptr(a), _ptr(u), _ptr(cell), scratch.data_ptr(), n, NI, S, B,
        Tz, H, E, ctas or 0, _stream(dev))


def decoder_chain_forward(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih,
                          whh, bl, *, route=None, ctas=None):
    """The teacher-forced chain's forward -> (hs, cs, comb), each [S x B x H]:
    on `decoder_chain_route`'s kernel (`route` forces one): one
    thread-block cluster per video on the ragged split
    (`decoder_chain_fwd_plan`), or one persistent launch over the card
    (`ctas` CTAs, one an SM by default).  Arguments as
    `ops/decoder_chain.py`."""
    dev, S, B, Tz, H, E = _check_chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1,
                                       wc2, bc, wih, whh, bl)
    route = _route(route, "fwd", B, H, E, Tz)
    hs, cs, comb = (torch.empty(S, B, H, device=dev, dtype=torch.float32) for _ in range(3))
    lib = load()
    if route == "persistent":
        err = _persistent_fwd(dev, emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc,
                              wih, whh, bl, B, S, B, (hs, cs, comb), None, ctas)
        _check_persistent(lib, err, "decoder_chain_fwd", True, ctas)
        chain_launches["chain_persistent_fwd_kernel"] += 1
        return hs, cs, comb
    _check_cluster_smem(H, E, Tz, False)
    wcT, wgT = _chain_columns(wc1, wc2, wih, whh)
    err = lib.mucon_decoder_chain_fwd(
        emb.data_ptr(), enc.data_ptr(), pre.data_ptr(), maskf.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), wl2.data_ptr(), bl2.data_ptr(), v.data_ptr(), wcT.data_ptr(),
        bc.data_ptr(), wgT.data_ptr(), bl.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        comb.data_ptr(), S, B, Tz, H, E, _stream(dev),
    )
    _check_launch(lib, err, "decoder_chain_fwd")
    chain_launches["chain_fwd_kernel"] += 1
    return hs, cs, comb


# the reverse chain's threads per CTA (csrc/decoder_chain.cuh NTB, and NTW
# on a ragged split)
DECODER_CHAIN_THREADS, DECODER_CHAIN_WIDE_THREADS = 256, 512


def decoder_chain_plan(H: int) -> tuple:
    """How the reverse chain splits a hidden size H over a cluster
    (`bwd_plan` in csrc/decoder_chain.cuh): (cluster width CL, most units a
    CTA HS, dgate row groups NQ, rows per group RQ).  A CTA's 2 HS output
    columns of dgate [Wih; Whh]^T take NQ groups of RQ rows (a multiple of
    4).  The even split: CL = `_cluster_width(H)`, HS a multiple of 4 of at
    most 32, 256 threads (a thread a unit), NQ = 256 / (2 HS), RQ <= 64 (the
    weights a thread keeps in registers).  Where that does not hold, the
    ragged split: CL = `_ragged_width(H)` CTAs of `units_of`, 512 threads,
    NQ = 512 / (2 HS), the weights read from L2 every step.  Above H = 512
    the ragged split with NQ = 512 / HS.  The persistent reverse chain sums
    in these ranks and row groups (and, as the ragged split, over 512
    threads).  Every H from 1 to MAX_H_WIDE; raises above."""
    _check_width(H, "the reverse decoder chain")
    if H > MAX_H:
        cl = _ragged_width(H)
        hs = -(-H // cl)
        nq = max(1, DECODER_CHAIN_WIDE_THREADS // hs)
        return cl, hs, nq, (-(-4 * H // nq) + 3) // 4 * 4
    cl = _cluster_width(H)
    hs = H // cl
    if 4 <= H <= DECODER_CHAIN_THREADS and hs % 4 == 0 and hs <= 32:
        nq = DECODER_CHAIN_THREADS // (2 * hs)
        rq = (-(-4 * H // nq) + 3) // 4 * 4
        if rq <= 64:
            return cl, hs, nq, rq
    cl = _ragged_width(H)
    hs = -(-H // cl)
    nq = DECODER_CHAIN_WIDE_THREADS // (2 * hs)
    return cl, hs, nq, (-(-4 * H // nq) + 3) // 4 * 4


def decoder_chain_replay(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc, wih,
                         whh, bl, *, count: bool = True, cell: bool = False, route=None,
                         ctas=None):
    """Pass 1 of the reverse chain (`ops/decoder_chain.py
    decoder_chain_replay_plain`): every step and video at once, on the
    forward's route (`decoder_chain_route`; `route` forces one): clusters
    of the forward's shape through its step function, or the persistent
    forward kernel on S B items of one step
    -> (acts [5 x S x B x H], cpre [S x B x H], a [S x B x Tz],
    u [S x B x Tz x H]); with `cell` also the replayed cell [S x B x H].
    cpre and the cell equal the forward kernel's (relu(cpre) its comb, the
    cell its cs) bit for bit, on either route.  `a` is a view of rows
    padded to a multiple of 4 frames."""
    dev, S, B, Tz, H, E = _check_chain(emb, enc, pre, maskf, h_in[0], c_in[0], wl2, bl2, v,
                                       wc1, wc2, bc, wih, whh, bl, reverse=True)
    for name, t in (("h_in", h_in), ("c_in", c_in)):
        if tuple(t.shape) != (S, B, H):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(S, B, H)}")
    _require(dev, torch.float32, h_in=h_in, c_in=c_in)
    route = _route(route, "fwd", B, H, E, Tz)
    f32 = dict(device=dev, dtype=torch.float32)
    acts = torch.empty(5, S, B, H, **f32)
    cpre = torch.empty(S, B, H, **f32)
    a = torch.empty(S, B, -(-Tz // 4) * 4, **f32)
    u = torch.empty(S, B, Tz, H, **f32)
    replay = torch.empty(S, B, H, **f32) if cell else None
    lib = load()
    if route == "persistent":
        err = _persistent_fwd(dev, emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc,
                              wih, whh, bl, S * B, 1, B, None, (acts, cpre, a, u, replay), ctas)
        _check_persistent(lib, err, "decoder_chain_bwd", count, ctas)
        chain_launches["chain_persistent_fwd_kernel"] += 1
    else:  # the replay pass runs on the forward's clusters
        _check_cluster_smem(H, E, Tz, False)
        wcT, wgT = _chain_columns(wc1, wc2, wih, whh)
        err = lib.mucon_decoder_chain_replay(
            emb.data_ptr(), enc.data_ptr(), pre.data_ptr(), maskf.data_ptr(), h_in.data_ptr(),
            c_in.data_ptr(), wl2.data_ptr(), bl2.data_ptr(), v.data_ptr(), wcT.data_ptr(),
            bc.data_ptr(), wgT.data_ptr(), bl.data_ptr(), acts.data_ptr(), cpre.data_ptr(),
            a.data_ptr(), u.data_ptr(), _ptr(replay), S, B, Tz, H, E, _stream(dev))
        _check_launch(lib, err, "decoder_chain_bwd", count)
        chain_launches["chain_replay_kernel"] += 1
    out = (acts, cpre, a[..., :Tz], u)
    return (*out, replay) if cell else out


def decoder_chain_bwd_chain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2, dhs, dcs,
                            dcomb, *, route=None, ctas=None, count: bool = True):
    """Pass 2 of the reverse chain (`decoder_chain_bwd_chain_plain`) on
    `decoder_chain_route`'s kernel (`route` forces one): one thread-block
    cluster per video, or one persistent launch over the card
    -> (dgate [S x B x 4H], dcpre [S x B x H], dsc [S x B x Tz], dh0 [B x H],
    dc0 [B x H]).  `a` as `decoder_chain_replay` returns it (rows padded to
    a multiple of 4)."""
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
    route = _route(route, "bwd", B, H, E, Tz)
    lib = load()
    wg = torch.cat([wih, whh])  # [2H, 4H]: row n is column n of [Wih; Whh]^T
    f32 = dict(device=dev, dtype=torch.float32)
    dgate = torch.empty(S, B, 4 * H, **f32)
    dcpre = torch.empty(S, B, H, **f32)
    dsc = torch.empty(S, B, Tz, **f32)
    dh0 = torch.empty(B, H, **f32)
    dc0 = torch.empty(B, H, **f32)
    if route == "persistent":
        scratch, n = _persistent_scratch(True, B, H, E, Tz, False, dev)
        err = lib.mucon_decoder_chain_persistent_bwd(
            acts.data_ptr(), cpre.data_ptr(), a.data_ptr(), u.data_ptr(), c_in.data_ptr(),
            enc.data_ptr(), v.data_ptr(), wc2.data_ptr(), wg.data_ptr(), wl2.data_ptr(),
            dhs.data_ptr(), dcs.data_ptr(), dcomb.data_ptr(), dgate.data_ptr(),
            dcpre.data_ptr(), dsc.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            scratch.data_ptr(), n, S, B, Tz, H, E, ctas or 0, _stream(dev))
        _check_persistent(lib, err, "decoder_chain_bwd", count, ctas)
        chain_launches["chain_persistent_bwd_kernel"] += 1
        return dgate, dcpre, dsc, dh0, dc0
    if H > MAX_H:
        raise ValueError(f"the cluster reverse chain takes H up to {MAX_H}; H={H} runs on the "
                         f"persistent kernel")
    _check_cluster_smem(H, E, Tz, True)
    err = lib.mucon_decoder_chain_bwd(
        acts.data_ptr(), cpre.data_ptr(), a.data_ptr(), u.data_ptr(), c_in.data_ptr(),
        enc.data_ptr(), v.data_ptr(), wc2.data_ptr(), wg.data_ptr(), wl2.data_ptr(),
        dhs.data_ptr(), dcs.data_ptr(), dcomb.data_ptr(), dgate.data_ptr(), dcpre.data_ptr(),
        dsc.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), S, B, Tz, H, E, _stream(dev))
    _check_launch(lib, err, "decoder_chain_bwd", count)
    chain_launches["chain_bwd_kernel"] += 1
    return dgate, dcpre, dsc, dh0, dc0


def decoder_chain_backward(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc,
                           wih, whh, bl, dhs, dcs, dcomb, *, route=None, ctas=None):
    """The reverse (dh, dc) chain from the step inputs h_in / c_in and the
    cotangents of (hs, cs, comb) -> (dgate [S x B x 4H], dcpre [S x B x H],
    dsc [S x B x Tz], dh0 [B x H], dc0 [B x H]).  Two kernels, counted as one
    `decoder_chain_bwd` launch (and each under its name in
    `chain_launches`): the replay of every step at once
    (`decoder_chain_replay`, into scratch allocated here), then the chain
    (`decoder_chain_bwd_chain`), each on `decoder_chain_route`'s kernel
    (`route` forces both)."""
    acts, cpre, a, u = decoder_chain_replay(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v,
                                            wc1, wc2, bc, wih, whh, bl, count=False,
                                            route=route, ctas=ctas)
    return decoder_chain_bwd_chain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2, dhs,
                                   dcs, dcomb, route=route, ctas=ctas)


# csrc/mucon_loss.cu: frames a tile, the widest cluster, the card's SMs
FLINT_TILE, FLINT_MAX_CL, SMS = 64, 16, 132
# the fewest classes a chunk takes before the segments are chunked too
FLINT_MIN_CLASSES = 32


def flint_floats(nc: int, mc: int) -> int:
    """Shared-memory floats of a flint CTA at chunks of nc segments and mc
    classes (`flint_floats` in csrc/mucon_loss.cu): the [nc x mc] partial,
    seg's [64 x mc] tile, the [nc x 64] mask rows and five [nc] vectors."""
    return nc * mc + FLINT_TILE * mc + nc * FLINT_TILE + 5 * nc


def flint_plan(B: int, T: int, N: int, M: int) -> dict:
    """The flint kernel's launch at B videos of T padded frames, N segments
    and M classes: a cluster of `width` CTAs a video, the widest power of
    two <= 16 with B width <= 132 (the card's SMs) and no more CTAs than T
    has 64-frame tiles (at least 1); `ctas` = B width; a CTA takes at most
    `frames` = ceil(T / width) of its video's frames (the kernel splits a
    video's valid frames T_b into runs of ceil(T_b / width)).  The window
    is taken in chunks of `nc` segments by `mc` classes (`chunks` of them):
    the whole [N x M] where it fits MAX_SMEM_BYTES, else M cut into the
    fewest even chunks that fit, and where even FLINT_MIN_CLASSES classes
    do not (N above ~480), N cut the same way too; `smem` the bytes a CTA
    takes.  Raises a ValueError that names the limit where no chunk fits."""
    if min(B, T, N, M) < 1:
        raise ValueError(f"the flint kernel takes B, T, N, M >= 1; got B={B} T={T} N={N} M={M}")
    cap = min(FLINT_MAX_CL, SMS // B, -(-T // FLINT_TILE))
    width = 1
    while 2 * width <= cap:
        width *= 2
    plan = dict(width=width, ctas=B * width, frames=-(-T // width))
    # the fewest classes an even chunk of M takes: M itself up to
    # FLINT_MIN_CLASSES, else the smallest ceil(M / k) >= FLINT_MIN_CLASSES
    fewest = M if M <= FLINT_MIN_CLASSES else -(-M // ((M - 1) // (FLINT_MIN_CLASSES - 1)))
    room = MAX_SMEM_BYTES // 4
    # the most segments a chunk of `fewest` classes leaves room for
    most = (room - FLINT_TILE * fewest) // (fewest + FLINT_TILE + 5)
    if most >= 1:
        nc = -(-N // -(-N // min(N, most)))  # the fewest even chunks of N that fit
        widest = (room - (FLINT_TILE + 5) * nc) // (nc + FLINT_TILE)
        mc = -(-M // -(-M // min(M, widest)))  # then the fewest even chunks of M
        return dict(plan, nc=nc, mc=mc, chunks=-(-N // nc) * -(-M // mc),
                    smem=4 * flint_floats(nc, mc))
    raise ValueError(f"N={N} M={M}: no chunk of the flint window fits a block's "
                     f"{MAX_SMEM_BYTES} bytes of shared memory (MAX_SMEM_BYTES)")


def flint_smem(nc: int, mc: int) -> int:
    """The kernel file's own count of a CTA's shared memory at chunks of nc
    segments by mc classes (a check of `flint_plan`)."""
    return load().mucon_flint_smem(nc, mc)


def mucon_flint(scale, xloc, sdiv, seg, target, n_len, t_valid, class_weights=None):
    """Per-video flint losses [B] of the box template from the segment
    placement scale / xloc / sdiv [B x N] (`ops/mucon_loss.py flint_prep`),
    the frame logits seg [B x T x M], the targets [B x N] and the lengths;
    `class_weights` [M] or None.  A thread-block cluster a video, the
    window in chunks of segments and classes where it does not fit
    (`flint_plan`): every N and M."""
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
    plan = flint_plan(B, T, N, M)
    out = torch.empty(B, device=dev, dtype=torch.float32)
    lib = load()
    err = lib.mucon_flint(
        scale.data_ptr(), xloc.data_ptr(), sdiv.data_ptr(), seg.data_ptr(), tgt.data_ptr(),
        nl.data_ptr(), tv.data_ptr(), _ptr(class_weights), out.data_ptr(), B, N, T, M,
        plan["width"], plan["nc"], plan["mc"], _stream(dev),
    )
    _check_launch(lib, err, "mucon_flint")
    return out


def mstcnpp_tile_rows(C: int = 128) -> int:
    """Rows of a video that one CTA of the MS-TCN++ kernels owns at C
    channels (`Ms<stack_width(C)>::TM`: 64, 32 at 256, 16 at 512; 64 on the
    wide bodies); a tile whose first row is at or past the video's length is
    skipped."""
    Cp = stack_width(C)
    return WIDE_TILE_ROWS if is_wide(Cp) else load().mucon_mstcnpp_tile_rows(Cp)


def mstcnpp_stack(x, lengths, w3a, b3a, w3b, b3b, w1t, w1b, b1, w_out, b_out, *,
                  pooling_layers, mm_dtype=None):
    """The eval MS-TCN++ stage of `ops/mstcnpp_stack.py` on the card: one
    `mstcnpp_stack` launch per layer (d1 = 2^(L-1-i), d2 = 2^i) and one for
    the out-projection, each on the tensor cores in error-compensated TF32
    (`ops/tf32.py`), or with `mm_dtype=torch.bfloat16` in the bf16-operand
    mode (`mstcnpp_stack_bf16`; above 512 channels a layer is the wide
    bodies' two passes, counted as one launch).  x [B x T x C] f32, any C
    (zero-padded to `stack_width(C)`) -> (z [B x T/2^p x C], lengths >> p)."""
    bf16 = bf16_mode(mm_dtype)
    dev = _cuda_device(x)
    if x.dim() != 3:
        raise ValueError(f"x must be [B x T x C], got {tuple(x.shape)}")
    B, T, C = x.shape
    L = w3a.shape[0]
    Cp = stack_width(C)
    for name, t, shape in (("w3a", w3a, (L, 3, C, C)), ("b3a", b3a, (L, C)),
                           ("w3b", w3b, (L, 3, C, C)), ("b3b", b3b, (L, C)),
                           ("w1t", w1t, (L, C, C)), ("w1b", w1b, (L, C, C)), ("b1", b1, (L, C)),
                           ("w_out", w_out, (C, C)), ("b_out", b_out, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(dev, torch.float32, x=x, w3a=w3a, b3a=b3a, w3b=w3b, b3b=b3b, w1t=w1t, w1b=w1b,
             b1=b1, w_out=w_out, b_out=b_out)
    C0, C = C, Cp
    x, w3a, w3b, w1t, w1b, w_out = (pad_channels(t, C, dims) for t, dims in (
        (x, (2,)), (w3a, (2, 3)), (w3b, (2, 3)), (w1t, (1, 2)), (w1b, (1, 2)), (w_out, (0, 1))))
    b3a, b3b, b1, b_out = (pad_channels(t, C, (t.dim() - 1,)) for t in (b3a, b3b, b1, b_out))
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    # a layer's eight [C x C] blocks as one [8C x C] matrix: the kernel's k-loop
    # streams its rows in order (once per call; 4 MiB at 11 layers and C = 128)
    w = torch.cat([w3a.reshape(L, 3 * C, C), w3b.reshape(L, 3 * C, C), w1t, w1b], dim=1)
    wide = is_wide(C)
    if wide:
        _check_wgmma_batch(B, bf16)
        # the [B x T x 2C] buffer of both dilated convs between the passes
        ybuf = torch.empty(B, T, 2 * C, device=dev, dtype=torch.float32)
        planes = wgmma_planes(mstcnpp_wgmma_blocks(w, w_out), bf16)
        nblk = planes.shape[1]
    h, t, shift = x, T, 0
    for i in range(L):
        pool = i in pooling_layers
        if pool and t % 2:
            raise ValueError(f"pooling layer {i} needs an even length, got {t}")
        out = torch.empty(B, t // 2 if pool else t, C, device=dev, dtype=torch.float32)
        if wide:
            err = _wide_call(lib, "mucon_wgmma_mstcnpp_layer", h.data_ptr(), out.data_ptr(),
                             ybuf.data_ptr(), lens.data_ptr(), planes.data_ptr(), nblk, 8 * i,
                             b3a[i].data_ptr(), b3b[i].data_ptr(), b1[i].data_ptr(), B, t, C,
                             2 ** (L - 1 - i), 2 ** i, shift, int(pool), int(bf16), stream)
        else:
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
    if wide:
        err = _wide_call(lib, "mucon_wgmma_proj", h.data_ptr(), z.data_ptr(), lens.data_ptr(),
                         planes.data_ptr(), nblk, nblk - 1, b_out.data_ptr(), B, t, C, shift, 0,
                         0, int(bf16), stream)
    else:
        err = lib.mucon_mstcnpp_proj(h.data_ptr(), z.data_ptr(), lens.data_ptr(),
                                     w_out.data_ptr(), b_out.data_ptr(), B, t, C, shift,
                                     int(bf16), stream)
    _check_launch(lib, err, _mode("mstcnpp_stack", bf16))
    return (z if C == C0 else z[..., :C0].contiguous()), lengths >> shift


def _tables(ptrs, ints):
    """Host pointer and int tables of a v2 chunk launch."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints)


# the layers one v2 launch takes at most (`MAX_LAYERS` of csrc/wavenet_train_v2.cu)
V2_CHUNK_LAYERS = 32
V2_GRID_KEYS = ("fwd_max_tile_rows", "sweep_max_tile_rows", "fwd_ctas_per_sm",
                "sweep_ctas_per_sm", "sms", "fwd_smem_bytes", "sweep_smem_bytes", "chunk_layers")
V2_PLAN_KEYS = ("fwd_tile_rows", "fwd_chunk_rows", "sweep_tile_rows", "sweep_chunk_rows",
                "span_rows", "spans")


def wavenet_train_v2_grid(C: int = 128, mm_dtype=None) -> dict:
    """The v2 kernels' cooperative grids at C channels in the mode `mm_dtype`
    (`mucon_wavenet_train_v2_grid`, sized from the occupancy of the kernels
    built for `stack_width(C)`): the forward's and the sweep's largest row
    tiles, the CTAs an SM that each kernel keeps resident (its grid is that
    times the SMs), the SMs, each kernel's shared memory a CTA and the most
    layers a chunk holds."""
    lib = load()
    Cp, bf16 = stack_width(C), int(bf16_mode(mm_dtype))
    if is_wide(Cp):  # the `wgmma` bodies: one persistent kernel, shared memory at B = 128
        w = (ctypes.c_int * 5)()
        err = lib.mucon_wgt_grid(bf16, w)
        out = (WIDE_TILE_ROWS, WIDE_TILE_ROWS, w[0], w[0], w[1], w[2], w[2],
               lib.mucon_wgt_v2_sweep_layers())
    else:
        out = (ctypes.c_int * 8)()
        err = lib.mucon_wavenet_train_v2_grid(Cp, bf16, out)
    if err:
        raise RuntimeError(f"wavenet_train_v2 grid: {lib.mucon_cuda_error_string(err).decode()}")
    return dict(zip(V2_GRID_KEYS, out))


def wavenet_train_v2_plan(B: int, T: int, jobs: int = 4, C: int = 128) -> dict:
    """The grid of a v2 layer of B videos x T frames x C channels
    (`mucon_wavenet_train_v2_plan`): v3's (`wavenet_train_plan`), the
    forward's row tile and its weight chunk, the sweep's row tile on v3's
    weight chunk (at C = 128 cut in rows to fit two CTAs an SM), and the
    weight-gradient span (`spans` a video).  An output's sum depends on
    the chunk, not on the rows: on v3's chunks v2 adds as v3 does."""
    if is_wide(stack_width(C)):  # v3's wide grid, on its 32-deep chunks
        p = wavenet_train_plan(B, T, jobs, C)
        return dict(zip(V2_PLAN_KEYS, (WIDE_TILE_ROWS, WIDE_CHUNK_ROWS, WIDE_TILE_ROWS,
                                       WIDE_CHUNK_ROWS, p["span_rows"], p["spans"])))
    out = (ctypes.c_int * 6)()
    if load().mucon_wavenet_train_v2_plan(B, T, stack_width(C), jobs, out):
        raise ValueError(f"no wavenet_train_v2 grid for B={B}, T={T}, jobs={jobs}")
    return dict(zip(V2_PLAN_KEYS, out))


def _check_chunks(bounds, most: int = V2_CHUNK_LAYERS) -> None:
    for lo, hi in bounds:
        if hi - lo > most:
            raise ValueError(f"a v2 chunk of {hi - lo} layers: one cooperative launch takes "
                             f"at most {most}")


def wavenet_train_v2_forward(x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, *,
                             stages, pooling_layers, leaky, bounds, u_out=None, mm_dtype=None):
    """Forward of the v2 trainable stack (max pooling): one cooperative
    `wavenet_train_v2_fwd` launch per chunk [lo, hi) of `bounds`
    (`mm_dtype=torch.bfloat16`: the bf16-operand mode,
    `wavenet_train_v2_fwd_bf16`, the JAX v2 kernel's `mm_dtype`).  x
    [B x T x C] (masked), drop_masks one [B x t_i x C] mask per layer or
    None -> (z, stash) with stash = (xs, hs): the L + 1 layer inputs (xs[L]
    the out-projection's input) and the L nonlin(z), at `stack_width(C)`
    channels (zero-padded).  Given a dict `u_out`, each pooled layer's
    pre-pool output is written to u_out[i] too (rows t < length; the others
    undefined; padded channels), for a check."""
    bf16 = bf16_mode(mm_dtype)
    dev = _check_packed(x, stages, w3, b3, w1, b1, w_last, b_last)
    C0 = x.shape[2]
    x, w3, b3, w1, b1, w_last, b_last = _pad_stack(stack_width(C0), x, w3, b3, w1, b1, w_last,
                                                   b_last)
    B, T, C = x.shape
    L = len(stages)
    _check_chunks(bounds)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    t_ins, pooled, shifts, t_fin = stack_plan(stages, pooling_layers, T)
    n_pools = sum(pooled)
    f32 = dict(device=dev, dtype=torch.float32)
    wide = is_wide(C)
    if wide:  # the `wgmma` bodies: the stack's planes once a call
        _check_wgmma_batch(B, bf16)
        planes = wgmma_planes(wavenet_wgmma_blocks(w3, w1, w_last), bf16)
        cnt = _grid_word(dev)
    xs, hs, z = [x], [], None
    padded = {}
    for lo, hi in bounds:
        ptrs, ints = [], []
        for i in range(lo, hi):
            t, shift, pool = t_ins[i], shifts[i], pooled[i]
            m = None if drop_masks is None else drop_masks[i]
            if m is not None:
                if m.shape != (B, t, C0):
                    raise ValueError(f"dropout mask {i} has shape {tuple(m.shape)}, "
                                     f"expected {(B, t, C0)}")
                m = pad_channels(m, C, (2,))
                _require(dev, torch.float32, mask=m)
                if i not in padded:  # kept alive until the launch
                    padded[i] = m
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
        if wide:
            err = _wide_call(
                lib, "mucon_wgt_v2_fwd", *_tables(ptrs, ints), hi - lo, planes.data_ptr(),
                planes.shape[1], 4 * lo, b3[lo].data_ptr(), b1[lo].data_ptr(),
                _ptr(b_last if last else None), _ptr(z if last else None), lens.data_ptr(),
                cnt.data_ptr(), B, C, t_fin, n_pools, int(leaky), int(bf16), stream)
        else:
            err = lib.mucon_wavenet_train_v2_fwd(
                *_tables(ptrs, ints), hi - lo, w3[lo].data_ptr(), b3[lo].data_ptr(),
                w1[lo].data_ptr(), b1[lo].data_ptr(), _ptr(w_last if last else None),
                _ptr(b_last if last else None), _ptr(z if last else None), lens.data_ptr(),
                B, C, t_fin, n_pools, int(leaky), int(bf16), stream,
            )
        _check_launch(lib, err, _mode("wavenet_train_v2_fwd", bf16))
    return (z if C == C0 else z[..., :C0].contiguous()), (xs, hs)


def wavenet_train_v2_backward(gz, stash, lengths, w3, w1, b1, w_last, drop_masks, *,
                              stages, pooling_layers, leaky, bounds, u_out=None, mm_dtype=None):
    """Backward of the v2 trainable stack: one cooperative
    `wavenet_train_v2_sweep` launch per chunk, last chunk first (it also
    sweeps the out-projection; `mm_dtype=torch.bfloat16`: the bf16-operand
    mode, `wavenet_train_v2_sweep_bf16`, the out-projection's sweep in it
    too, as the JAX v2 kernel).  gz [B x t_fin x C] -> (gx, dw3, db3, dw1,
    db1, dw_last, db_last).  Given a dict `u_out`, each pooled layer's
    pre-pool output as the sweep recomputed it is written to u_out[i] (rows
    t < length), for a check."""
    bf16 = bf16_mode(mm_dtype)
    xs, hs = stash
    dev = _cuda_device(gz)
    B, T, C = xs[0].shape
    L = len(stages)
    C0 = w_last.shape[0]
    gz = pad_channels(gz, C, (2,))
    w3, w1, b1, w_last = (pad_channels(w3, C, (2, 3)), pad_channels(w1, C, (1, 2)),
                          pad_channels(b1, C, (1,)), pad_channels(w_last, C, (0, 1)))
    drop_masks = _pad_masks(drop_masks, C)
    if gz.shape != xs[L].shape:
        raise ValueError(f"gz {tuple(gz.shape)} does not match z {tuple(xs[L].shape)}")
    # above 512 channels a sweep chunk's program lives in the kernel's parameters
    _check_chunks(bounds, load().mucon_wgt_v2_sweep_layers() if is_wide(C) else V2_CHUNK_LAYERS)
    gz = gz.contiguous()
    _require(dev, torch.float32, gz=gz)
    lens = _lengths_i32(lengths, B, dev, "lengths")
    lib, stream = load(), _stream(dev)
    t_ins, pooled, shifts, t_fin = stack_plan(stages, pooling_layers, T)
    n_pools = sum(pooled)
    f32 = dict(device=dev, dtype=torch.float32)
    wide = is_wide(C)
    if wide:  # the `wgmma` bodies: the forward's planes (u recomputed) and the sweep's
        _check_wgmma_batch(B, bf16)
        fplanes = wgmma_planes(wavenet_wgmma_blocks(w3, w1, w_last), bf16)
        splanes = wgmma_sweep_planes(w3, w1, w_last, bf16)
        cnt = _grid_word(dev)
    else:  # W^T copies (once per call) so that the kernels read them row-major
        w3t = w3.transpose(-1, -2).contiguous()
        w1t = w1.transpose(-1, -2).contiguous()
        wlt = w_last.t().contiguous()
    dw3, dw1 = torch.empty(L, 3, C, C, **f32), torch.empty(L, C, C, **f32)
    db3, db1 = torch.empty(L, C, **f32), torch.empty(L, C, **f32)
    dwl, dbl = torch.empty(C, C, **f32), torch.empty(C, **f32)
    # gm (the wide bodies: the recomputed u), dy and dz of the longest layer
    scratch = torch.empty(3 * B * T * C, **f32)
    work = torch.empty(lib.mucon_wgt_work_floats(C, B, T, 0) if wide else
                       _work_floats(wavenet_train_v2_plan, B, C,
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
        if wide:
            err = _wide_call(
                lib, "mucon_wgt_v2_sweep", *_tables(ptrs, ints), hi - lo, fplanes.data_ptr(),
                splanes.data_ptr(), splanes.shape[1], 4 * lo, b1[lo].data_ptr(),
                dw3[lo].data_ptr(), db3[lo].data_ptr(), dw1[lo].data_ptr(), db1[lo].data_ptr(),
                _ptr(gz if proj else None), _ptr(xs[L] if proj else None),
                _ptr(dwl if proj else None), _ptr(dbl if proj else None), scratch.data_ptr(),
                B * T, work.data_ptr(), work.numel(), lens.data_ptr(), cnt.data_ptr(), B, C,
                t_fin, n_pools, int(leaky), int(bf16), stream)
        else:
            err = lib.mucon_wavenet_train_v2_sweep(
                *_tables(ptrs, ints), hi - lo, w3t[lo].data_ptr(), w1[lo].data_ptr(),
                w1t[lo].data_ptr(), b1[lo].data_ptr(), dw3[lo].data_ptr(), db3[lo].data_ptr(),
                dw1[lo].data_ptr(), db1[lo].data_ptr(), _ptr(gz if proj else None),
                _ptr(xs[L] if proj else None), _ptr(wlt if proj else None),
                _ptr(dwl if proj else None), _ptr(dbl if proj else None), scratch.data_ptr(),
                B * T, work.data_ptr(), work.numel(), lens.data_ptr(), B, C, t_fin, n_pools,
                int(leaky), int(bf16), stream,
            )
        _check_launch(lib, err, _mode("wavenet_train_v2_sweep", bf16))
    return _unpad_grads(C0, g_in[0], dw3, db3, dw1, db1, dwl, dbl)
