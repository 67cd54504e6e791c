"""Native (C++) host kernels, loaded with ctypes (mucon_tpu/native).

`collate.cpp` pad-copies a batch's per-video features and labels in one
call with the GIL released (the loader's collate thread overlaps the
training loop); `metrics.cpp` computes the eval's segment overlaps
(IoD / IoU), Levenshtein distances and matches, F1@k counts and edit
scores.  They are the port's own copies of the JAX package's sources.

At first use `g++ -O3 -shared -fPIC -std=c++17` builds them into
`build/mucon_tpu_torch/libmucon_native_<hash>.so`, the hash that of the
sources and the flags (as `mucon_tpu_torch/cuda` names the kernels'
library): a build takes a lock (the loader's thread and the main thread
both call it) and moves its output into place with one rename, so no
process maps a half-written library.

Every caller falls back to its Python version when the library does not
load: no g++ on the PATH, a failed build, or `MUCON_TPU_NO_NATIVE` set (read
at each call).  The choice is logged once on `mucon_tpu_torch.native`.
`calls` counts each native function's calls, so a run can show that it
took the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("mucon_tpu_torch.native")

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "metrics.cpp", _DIR / "collate.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mucon_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FUNCTIONS = ("overlap_score", "levenshtein", "levenshtein_matches", "f_scores_multi",
             "edit_score_norm", "pad_copy_f32", "pad_copy_i64_to_i32")

calls = {name: 0 for name in FUNCTIONS}

_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None  # why the library did not load; never retried
load_seconds: Optional[float] = None  # the first load's build (if any) and dlopen
_logged = set()
_lock = threading.Lock()


def reset_calls() -> None:
    for name in FUNCTIONS:
        calls[name] = 0


def library_path() -> Path:
    """Where the library of these sources and flags is built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in SOURCES:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libmucon_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has none yet; returns its
    path.  Raises when g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run([gxx, *FLAGS, *map(str, SOURCES), "-o", str(tmp)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: concurrent builders race benignly
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _log_once(msg: str) -> None:
    if msg not in _logged:
        _logged.add(msg)
        logger.info(msg)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (the caller takes its Python version)."""
    if os.environ.get("MUCON_TPU_NO_NATIVE"):
        _log_once("native host kernels off (MUCON_TPU_NO_NATIVE): Python collate and metrics")
        return None
    if _lib is not None:
        return _lib
    if _failed is not None:
        return None
    with _lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _failed, load_seconds
    if _lib is not None or _failed is not None:  # another thread won the race
        return _lib
    t0 = time.perf_counter()
    try:
        path = build()
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or e
        _failed = f"{type(e).__name__}: {detail}"
        _log_once(f"native host kernels not built ({_failed}): Python collate and metrics")
        return None
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    c_int, c_i64 = ctypes.c_int, ctypes.c_int64
    sigs = dict(
        overlap_score=(ctypes.c_double, [i64p, i64p, c_int, i64p, c_int, c_int]),
        levenshtein=(ctypes.c_double, [i64p, c_int, i64p, c_int]),
        levenshtein_matches=(None, [i64p, c_int, i64p, c_int, i64p, i64p]),
        f_scores_multi=(None, [i64p, i64p, c_int, i64p, c_int, dp, c_int, dp]),
        edit_score_norm=(ctypes.c_double, [i64p, i64p, c_int, i64p, c_int]),
        pad_copy_f32=(None, [f32p, ctypes.POINTER(f32p), i64p, c_i64, c_i64, c_i64]),
        pad_copy_i64_to_i32=(None, [i32p, ctypes.POINTER(i64p), i64p, c_i64, c_i64]),
    )
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    load_seconds = time.perf_counter() - t0
    _log_once(f"native host kernels loaded from {path}")
    return lib


def available() -> bool:
    return _load() is not None


def _as_i64(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def overlap_score_native(prediction, target, ignore_ids, union_denominator: bool):
    """The IoD / IoU of `metrics/segmentation.py _overlap_score`, or None
    (also for sequences of different lengths, which the kernel does not
    take)."""
    lib = _load()
    if lib is None:
        return None
    p, t = _as_i64(prediction), _as_i64(target)
    if len(p) != len(t):
        return None
    ig = _as_i64(list(ignore_ids))
    calls["overlap_score"] += 1
    return lib.overlap_score(_ptr(p), _ptr(t), len(t), _ptr(ig), len(ig),
                             int(union_denominator))


def levenshtein_native(a, b):
    """The unit-cost edit distance of two sequences, or None."""
    lib = _load()
    if lib is None:
        return None
    aa, bb = _as_i64(a), _as_i64(b)
    calls["levenshtein"] += 1
    return lib.levenshtein(_ptr(aa), len(aa), _ptr(bb), len(bb))


def levenshtein_matches_native(a, b):
    """(edit distance, matches) of a max-match minimal alignment, or None."""
    lib = _load()
    if lib is None:
        return None
    aa, bb = _as_i64(a), _as_i64(b)
    dist = np.zeros(1, np.int64)
    matches = np.zeros(1, np.int64)
    calls["levenshtein_matches"] += 1
    lib.levenshtein_matches(_ptr(aa), len(aa), _ptr(bb), len(bb), _ptr(dist), _ptr(matches))
    return int(dist[0]), int(matches[0])


def f_scores_multi_native(prediction, target, overlaps, bg_class):
    """(tp, fp, fn) at each IoU threshold in one call, or None."""
    lib = _load()
    if lib is None:
        return None
    p, t = _as_i64(prediction), _as_i64(target)
    if len(p) != len(t):
        return None
    bg = _as_i64(list(bg_class))
    ovl = np.ascontiguousarray(np.asarray(overlaps, np.float64))
    out = np.zeros((len(ovl), 3), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    calls["f_scores_multi"] += 1
    lib.f_scores_multi(_ptr(p), _ptr(t), len(t), _ptr(bg), len(bg), ovl.ctypes.data_as(dp),
                       len(ovl), out.ctypes.data_as(dp))
    return out


def edit_score_norm_native(prediction, target, bg_class):
    """The normalized segmental edit score (x100), or None."""
    lib = _load()
    if lib is None:
        return None
    p, t = _as_i64(prediction), _as_i64(target)
    if len(p) != len(t):
        return None
    bg = _as_i64(list(bg_class))
    calls["edit_score_norm"] += 1
    return lib.edit_score_norm(_ptr(p), _ptr(t), len(t), _ptr(bg), len(bg))


def pad_copy_feats_native(dst: np.ndarray, feats_list) -> bool:
    """Copy per-video [T_i x D] float32 features into the zeroed dst
    [B x T_pad x D] with the GIL released.  False when the library is not
    loaded or a layout does not match (the caller copies in numpy)."""
    lib = _load()
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        return False
    if any(f.dtype != np.float32 or not f.flags.c_contiguous or f.ndim != 2
           for f in feats_list):
        return False
    B, t_pad, D = dst.shape
    if any(f.shape[1] != D or f.shape[0] > t_pad for f in feats_list):
        return False
    f32p = ctypes.POINTER(ctypes.c_float)
    srcs = (f32p * B)(*[f.ctypes.data_as(f32p) for f in feats_list])
    lens = np.array([f.shape[0] for f in feats_list], np.int64)
    calls["pad_copy_f32"] += 1
    lib.pad_copy_f32(dst.ctypes.data_as(f32p), srcs, _ptr(lens), B, t_pad, D)
    return True


def pad_copy_labels_native(dst: np.ndarray, labels_list) -> bool:
    """Copy per-video int64 label vectors into the zeroed int32 dst
    [B x T_pad]; False as `pad_copy_feats_native`."""
    lib = _load()
    if lib is None or dst.dtype != np.int32 or not dst.flags.c_contiguous:
        return False
    if any(lb.dtype != np.int64 or not lb.flags.c_contiguous or lb.ndim != 1
           for lb in labels_list):
        return False
    B, t_pad = dst.shape
    if any(lb.shape[0] > t_pad for lb in labels_list):
        return False
    i64pp = ctypes.POINTER(ctypes.c_int64)
    srcs = (i64pp * B)(*[lb.ctypes.data_as(i64pp) for lb in labels_list])
    lens = np.array([lb.shape[0] for lb in labels_list], np.int64)
    calls["pad_copy_i64_to_i32"] += 1
    lib.pad_copy_i64_to_i32(dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), srcs,
                            _ptr(lens), B, t_pad)
    return True
