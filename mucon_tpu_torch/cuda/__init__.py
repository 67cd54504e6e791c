"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

On first use the `.cu` sources are compiled with
`nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC`
into one shared library under `<repo>/build/mucon_tpu_torch/`, named by
the sha256 of the sources and flags (a changed source builds anew).  The
library exports `extern "C"` launchers that take raw device pointers,
sizes and a `cudaStream_t` and return the `cudaGetLastError()` of the
launch; it is loaded with ctypes, so no PyTorch headers are compiled and
no `ninja` is needed.  A failed build or launch raises: there is no
fallback.

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream without synchronising, and adds one to
`launch_counts[<kernel>]` per kernel launch — the count a run reads to
show that its path went through the kernels.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("wavenet_stack.cu", "bilstm.cu", "viterbi.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mucon_tpu_torch"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("wavenet_layer", "bilstm_recurrence", "dense_viterbi")

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
    memory use) is kept beside it as `<lib>.log`."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libmucon_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
        capture_output=True, text=True,
    )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-6000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build races benignly
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.mucon_wavenet_layer.argtypes = [P] * 7 + [I] * 9 + [P]
            lib.mucon_bilstm_recurrence.argtypes = [P] * 6 + [I] * 3 + [P]
            lib.mucon_dense_viterbi.argtypes = [P] * 7 + [I] * 6 + [P]
            for fn in (lib.mucon_wavenet_layer, lib.mucon_bilstm_recurrence,
                       lib.mucon_dense_viterbi):
                fn.restype = I
            lib.mucon_cuda_error_string.argtypes = [I]
            lib.mucon_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.mucon_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    launch_counts[name] += 1


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


def wavenet_stack(x, lengths, w3, b3, w1, b1, w_last, b_last, *, stages,
                  pooling_layers, pooling_type, leaky):
    """The eval stack of `ops/wavenet_stack.py` on the card: one
    `wavenet_layer` launch per layer and one for the out-projection.
    x [B x T x 128] f32 -> (z [B x T/2^p x 128], lengths >> p)."""
    dev = _cuda_device(x)
    B, T, C = x.shape
    L = len(stages)
    if C != 128:
        raise ValueError(f"the wavenet_layer kernel takes C=128, got {C}")
    if w3.shape != (L, 3, C, C) or w1.shape != (L, C, C) or b3.shape != (L, C) \
            or b1.shape != (L, C) or w_last.shape != (C, C) or b_last.shape != (C,):
        raise ValueError("packed wavenet weights do not match x / stages")
    _require(dev, torch.float32, x=x, w3=w3, b3=b3, w1=w1, b1=b1,
             w_last=w_last, b_last=b_last)
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
            B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), 0, stream,
        )
        _check_launch(lib, err, "wavenet_layer")
        if pool:
            t, shift = t // 2, shift + 1
        h = out
    out = torch.empty(B, t, C, device=dev, dtype=torch.float32)
    err = lib.mucon_wavenet_layer(
        h.data_ptr(), out.data_ptr(), lens.data_ptr(), w_last.data_ptr(),
        b_last.data_ptr(), w_last.data_ptr(), b_last.data_ptr(),
        B, t, C, 0, shift, 0, 0, int(leaky), 1, stream,
    )
    _check_launch(lib, err, "wavenet_layer")
    return out, lengths >> shift


def bilstm_recurrence(xp, m, w_hh):
    """xp [T x 2 x B x 4H], m [T x B], w_hh [2 x H x 4H] (f32) ->
    (outs [T x 2 x B x H], h [2 x B x H], c [2 x B x H])."""
    dev = _cuda_device(xp)
    T, two, B, G = xp.shape
    H = G // 4
    if two != 2 or G != 4 * H or m.shape != (T, B) or w_hh.shape != (2, H, G):
        raise ValueError(f"bad shapes xp {tuple(xp.shape)} m {tuple(m.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    _require(dev, torch.float32, xp=xp, m=m, w_hh=w_hh)
    outs = torch.empty(T, 2, B, H, device=dev, dtype=torch.float32)
    h = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    c = torch.empty(2, B, H, device=dev, dtype=torch.float32)
    lib = load()
    err = lib.mucon_bilstm_recurrence(
        xp.data_ptr(), m.data_ptr(), w_hh.data_ptr(), outs.data_ptr(),
        h.data_ptr(), c.data_ptr(), T, B, H, _stream(dev),
    )
    _check_launch(lib, err, "bilstm_recurrence")
    return outs, h, c


def dense_viterbi(W, pois, k_valid, n_valid, frame_sampling: int, max_len: int):
    """W [B x K x N], pois [B x N x L] (f32), k_valid / n_valid [B] ->
    (score [B], best_l [B] int32, bps [B x K-1 x N] int32)."""
    dev = _cuda_device(W)
    B, K, N = W.shape
    L = pois.shape[2]
    if pois.shape != (B, N, L):
        raise ValueError(f"pois {tuple(pois.shape)} does not match W {tuple(W.shape)}")
    if K < 1:
        raise ValueError("the DP needs at least one window")
    _require(dev, torch.float32, W=W, pois=pois)
    kv = _lengths_i32(k_valid, B, dev, "k_valid")
    nv = _lengths_i32(n_valid, B, dev, "n_valid")
    score = torch.empty(B, device=dev, dtype=torch.float32)
    best_l = torch.empty(B, device=dev, dtype=torch.int32)
    bps = torch.empty(B, K - 1, N, device=dev, dtype=torch.int32)
    lib = load()
    err = lib.mucon_dense_viterbi(
        W.data_ptr(), pois.data_ptr(), kv.data_ptr(), nv.data_ptr(),
        score.data_ptr(), best_l.data_ptr(), bps.data_ptr(),
        B, K, N, L, int(frame_sampling), int(max_len), _stream(dev),
    )
    _check_launch(lib, err, "dense_viterbi")
    return score, best_l, bps
