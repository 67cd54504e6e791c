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
show that its path went through the kernels.  `wavenet_train_sweep`
counts one per layer sweep: its C launcher runs that layer's four
kernels (dz, dx, weight-gradient partials, their fixed-order sum).
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
SOURCES = ("wavenet_stack.cu", "bilstm.cu", "viterbi.cu", "wavenet_train.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mucon_tpu_torch"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = (
    "wavenet_layer", "bilstm_recurrence", "dense_viterbi",
    "wavenet_train_fwd", "wavenet_train_sweep", "bilstm_train_fwd", "bilstm_train_bwd",
)

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
    # one nvcc per source, all at once, then one link
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
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
            lib.mucon_wavenet_layer.argtypes = [P] * 7 + [I] * 9 + [P]
            lib.mucon_bilstm_recurrence.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.mucon_dense_viterbi.argtypes = [P] * 7 + [I] * 6 + [P]
            lib.mucon_wavenet_train_fwd.argtypes = [P] * 10 + [I] * 8 + [P]
            lib.mucon_wavenet_train_sweep.argtypes = [P] * 16 + [I] * 9 + [P]
            lib.mucon_wavenet_train_splits.argtypes = [I]
            lib.mucon_bilstm_backward.argtypes = [P] * 10 + [I] * 3 + [P]
            for fn in (lib.mucon_wavenet_layer, lib.mucon_bilstm_recurrence,
                       lib.mucon_dense_viterbi, lib.mucon_wavenet_train_fwd,
                       lib.mucon_wavenet_train_sweep, lib.mucon_wavenet_train_splits,
                       lib.mucon_bilstm_backward):
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


def _ptr(t) -> int:
    """data_ptr of an optional tensor (0, a null pointer, for None)."""
    return 0 if t is None else t.data_ptr()


def _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky) -> torch.Tensor:
    """z = mask(nonlin(h) Wl + bl): the eval kernel's final_proj launch."""
    B, t, C = h.shape
    out = torch.empty(B, t, C, device=h.device, dtype=torch.float32)
    err = lib.mucon_wavenet_layer(
        h.data_ptr(), out.data_ptr(), lens.data_ptr(), w_last.data_ptr(),
        b_last.data_ptr(), w_last.data_ptr(), b_last.data_ptr(),
        B, t, C, 0, shift, 0, 0, int(leaky), 1, stream,
    )
    _check_launch(lib, err, "wavenet_layer")
    return out


def wavenet_stack(x, lengths, w3, b3, w1, b1, w_last, b_last, *, stages,
                  pooling_layers, pooling_type, leaky):
    """The eval stack of `ops/wavenet_stack.py` on the card: one
    `wavenet_layer` launch per layer and one for the out-projection.
    x [B x T x 128] f32 -> (z [B x T/2^p x 128], lengths >> p)."""
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
            B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), 0, stream,
        )
        _check_launch(lib, err, "wavenet_layer")
        if pool:
            t, shift = t // 2, shift + 1
        h = out
    return _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky), lengths >> shift


def wavenet_train_forward(x, lengths, w3, b3, w1, b1, w_last, b_last, drop_masks, *,
                          stages, pooling_layers, pooling_type, leaky):
    """Forward of the trainable stack on the card: one `wavenet_train_fwd`
    launch per layer and one `wavenet_layer` out-projection launch.
    x [B x T x 128] (masked), drop_masks one [B x t_i x 128] mask per layer
    or None -> (z, stash) with stash = (xs, hs, us, x_fin): each layer's
    input, nonlin(z) and (pooled layers, by index) pre-pool output."""
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
            _ptr(m), B, t, C, int(d), shift, int(pool), pool_mean, int(leaky), stream,
        )
        _check_launch(lib, err, "wavenet_train_fwd")
        xs.append(h)
        hs.append(hs_i)
        if pool:
            us[i] = u
            t, shift = t // 2, shift + 1
        h = out
    z = _out_proj(lib, stream, h, lens, w_last, b_last, shift, leaky)
    return z, (xs, hs, us, h)


def wavenet_train_backward(gz, stash, lengths, w3, w1, w_last, drop_masks, *,
                           stages, pooling_layers, pooling_type, leaky):
    """Backward sweep of the trainable stack on the card: the
    out-projection's sweep, then one `wavenet_train_sweep` per layer, last
    first.  gz [B x t_fin x 128] -> (gx, dw3, db3, dw1, db1, dw_last, db_last)."""
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
    work = torch.empty(lib.mucon_wavenet_train_splits(B * T) * 4 * (C + 1) * C, **f32)

    def sweep(g, u, x, h, m, w1t_i, w3t_i, dz, g_in, dw1_i, db1_i, dw3_i, db3_i,
              t, d, shift, pooled, proj):
        err = lib.mucon_wavenet_train_sweep(
            g.data_ptr(), _ptr(u), x.data_ptr(), h.data_ptr(), _ptr(m),
            lens.data_ptr(), w1t_i.data_ptr(), _ptr(w3t_i), dy.data_ptr(),
            dz.data_ptr(), _ptr(g_in), work.data_ptr(), dw1_i.data_ptr(),
            db1_i.data_ptr(), _ptr(dw3_i), _ptr(db3_i), B, t, C, int(d), shift,
            int(pooled), pool_mean, int(leaky), int(proj), stream,
        )
        _check_launch(lib, err, "wavenet_train_sweep")

    g = torch.empty(B, t_fin, C, **f32)  # gradient at x_fin
    sweep(gz, None, x_fin, x_fin, None, wlt, None, g, None, dwl, dbl, None, None,
          t_fin, 0, n_pools, False, True)
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
              dw3[i], db3[i], t, stages[i], shift, pooled, False)
        g = g_in
    return g, dw3, db3, dw1, db1, dwl, dbl


def _check_bilstm(xp, m, w_hh):
    dev = _cuda_device(xp)
    T, two, B, G = xp.shape
    H = G // 4
    if two != 2 or G != 4 * H or m.shape != (T, B) or w_hh.shape != (2, H, G):
        raise ValueError(f"bad shapes xp {tuple(xp.shape)} m {tuple(m.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    _require(dev, torch.float32, xp=xp, m=m, w_hh=w_hh)
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
    (outs [T x 2 x B x H], h [2 x B x H], c [2 x B x H])."""
    return _bilstm_forward(xp, m, w_hh, False, "bilstm_recurrence")[:3]


def bilstm_train_forward(xp, m, w_hh):
    """`bilstm_recurrence` that also returns the cell trajectory
    cs [T x 2 x B x H] the reverse chain replays from."""
    return _bilstm_forward(xp, m, w_hh, True, "bilstm_train_fwd")


def bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc):
    """Reverse (dh, dc) chain: dxp [T x 2 x B x 4H] from the stash and the
    cotangents of (outs, h_fin, c_fin)."""
    dev, T, B, H = _check_bilstm(xp, m, w_hh)
    if 4 * H > 1024:
        raise ValueError(f"the reverse chain takes 4H <= 1024, got H={H}")
    for name, t, shape in (("outs", outs, (T, 2, B, H)), ("cs", cs, (T, 2, B, H)),
                           ("douts", douts, (T, 2, B, H)), ("dh", dh, (2, B, H)),
                           ("dc", dc, (2, B, H))):
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    _require(dev, torch.float32, outs=outs, cs=cs, douts=douts, dh=dh, dc=dc)
    w_hht = w_hh.transpose(1, 2).contiguous()  # [2, 4H, H], read along rows
    dxp = torch.empty_like(xp)
    lib = load()
    err = lib.mucon_bilstm_backward(
        xp.data_ptr(), m.data_ptr(), w_hh.data_ptr(), w_hht.data_ptr(),
        outs.data_ptr(), cs.data_ptr(), douts.data_ptr(), dh.data_ptr(),
        dc.data_ptr(), dxp.data_ptr(), T, B, H, _stream(dev),
    )
    _check_launch(lib, err, "bilstm_train_bwd")
    return dxp


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
