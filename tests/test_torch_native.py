"""PyTorch port: the native host kernels (`mucon_tpu_torch/native`, the
port's own copy of `mucon_tpu/native`).

Built by g++ into a directory of the test's own (the hash-named library
and its atomic rename), each function against the port's Python version
(`MUCON_TPU_NO_NATIVE` set) and against the JAX package's function on the
same seeded inputs: the segment overlaps (IoD / IoU, with and without
background ids; bit for bit against the JAX package's, whose kernel is the
same source, and within 1e-12 relative of the Python mean, which numpy
sums 8 lanes at a time), the Levenshtein distance and matches, the F1@k
counts and the edit score (bit for bit against both), through the metric
objects the evaluator feeds; `collate_padded` with the native pad-copies
against its numpy path and the JAX collate, byte for byte; the fallback
without g++; and two threads building at once.
"""

import threading

import numpy as np
import pytest

from mucon_tpu.data import collate_padded as jax_collate_padded
from mucon_tpu.metrics.fully_supervised import Edit as JaxEdit
from mucon_tpu.metrics.fully_supervised import F1Score as JaxF1Score
from mucon_tpu.metrics.fully_supervised import levenshtein as jax_levenshtein
from mucon_tpu.metrics.segmentation import iod as jax_iod
from mucon_tpu.metrics.segmentation import iou as jax_iou
from mucon_tpu.metrics.transcript import levenshtein_matches as jax_levenshtein_matches
from mucon_tpu_torch import native
from mucon_tpu_torch.data.batching import collate_padded
from mucon_tpu_torch.metrics.fully_supervised import Edit, F1Score, levenshtein
from mucon_tpu_torch.metrics.segmentation import iod, iou
from mucon_tpu_torch.metrics.transcript import levenshtein_matches
from tests.test_model import make_sample


@pytest.fixture(scope="module", autouse=True)
def own_build(tmp_path_factory):
    """The library built from the checkout's sources into a fresh
    directory (not the shared build/ of the checkout)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("native_build"))
    mp.setattr(native, "_lib", None)
    mp.setattr(native, "_failed", None)
    mp.delenv("MUCON_TPU_NO_NATIVE", raising=False)
    assert native.available()
    yield
    mp.undo()


def _labels(rng, n, k=5, runs=12):
    """Framewise labels of `runs` segments of random classes."""
    cuts = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False))
    lengths = np.diff(np.concatenate([[0], cuts, [n]]))
    return np.repeat(rng.randint(0, k, runs), lengths).astype(np.int64)


def _python(monkeypatch, fn, *args):
    monkeypatch.setenv("MUCON_TPU_NO_NATIVE", "1")
    try:
        return fn(*args)
    finally:
        monkeypatch.delenv("MUCON_TPU_NO_NATIVE")


def _counted(name, fn, *args):
    before = native.calls[name]
    out = fn(*args)
    assert native.calls[name] > before, name
    return out


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_python_and_jax_bit_for_bit(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    for n in (1, 37, 400):
        runs = min(12, n)
        t = _labels(rng, n, runs=runs) if n > 1 else np.zeros(1, np.int64)
        p = _labels(rng, n, runs=runs) if n > 1 else np.ones(1, np.int64)
        # (a target with no segment outside the background divides by zero
        # in the Python F1, as in the JAX package's: not drawn)
        for bg in ((), (0,), (0, 3)) if n > 1 else ((),):
            for ours, theirs in ((iod, jax_iod), (iou, jax_iou)):
                got = _counted("overlap_score", ours, p, t, bg)
                # numpy's mean sums 8 lanes at a time, the kernel in order
                np.testing.assert_allclose(got, _python(monkeypatch, ours, p, t, bg),
                                           rtol=1e-12)
                np.testing.assert_array_equal(got, theirs(p, t, bg))
            for ours, theirs in ((Edit, JaxEdit), (F1Score, JaxF1Score)):
                m, mp_, mj = ours(ignore_ids=bg), ours(ignore_ids=bg), theirs(ignore_ids=bg)
                name = "edit_score_norm" if ours is Edit else "f_scores_multi"
                got = _counted(name, m.add, t, p)
                assert got == _python(monkeypatch, mp_.add, t, p) == mj.add(t, p)
                assert m.summary() == mp_.summary() == mj.summary()
        a, b = list(rng.randint(0, 4, rng.randint(0, 9))), list(rng.randint(0, 4, 7))
        for norm in (False, True):
            got = _counted("levenshtein", levenshtein, a, b, norm)
            assert got == _python(monkeypatch, levenshtein, a, b, norm) == \
                jax_levenshtein(a, b, norm)
        got = _counted("levenshtein_matches", levenshtein_matches, a, b)
        assert got == _python(monkeypatch, levenshtein_matches, a, b) == \
            jax_levenshtein_matches(a, b)


def test_overlap_of_unequal_lengths_takes_python(monkeypatch):
    """`iod` / `iou` take a prediction shorter (or longer) than its target:
    the kernel reads both at the target's length, so the wrapper declines
    and the Python version answers."""
    rng = np.random.RandomState(5)
    t = _labels(rng, 200)
    for p in (_labels(rng, 150), _labels(rng, 260)):
        for fn in (iod, iou):
            before = native.calls["overlap_score"]
            got = fn(p, t, (0,))
            assert native.calls["overlap_score"] == before
            assert native.overlap_score_native(p, t, [0], fn is iou) is None
            assert got == _python(monkeypatch, fn, p, t, (0,))


def test_collate_native_equals_numpy_and_jax(monkeypatch):
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, t, n, f"v{i}") for i, (t, n) in
               enumerate([(61, 3), (44, 5), (30, 2), (1, 1)])]
    before = dict(native.calls)
    got = collate_padded(samples, n_max=8, pad_multiple=16)
    assert native.calls["pad_copy_f32"] == before["pad_copy_f32"] + 1
    assert native.calls["pad_copy_i64_to_i32"] == before["pad_copy_i64_to_i32"] + 1
    assert got.gt_label.dtype == np.int32  # what pad_copy_i64_to_i32 writes
    want = _python(monkeypatch, collate_padded, samples, 8, 16)
    ref = jax_collate_padded(samples, n_max=8, pad_multiple=16)
    for name in ("feats", "gt_label", "num_frames", "transcript", "tf_input", "tf_target"):
        a, b, c = getattr(got, name), getattr(want, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        np.testing.assert_array_equal(a, c, err_msg=name)
    # a layout the kernel does not take (f64 features) goes the numpy way
    odd = [dict(vars(s)) for s in samples]
    for s in odd:
        s["feats"] = s["feats"].astype(np.float64)
    from types import SimpleNamespace

    n_before = native.calls["pad_copy_f32"]
    mixed = collate_padded([SimpleNamespace(**s) for s in odd], n_max=8, pad_multiple=16)
    assert native.calls["pad_copy_f32"] == n_before
    np.testing.assert_array_equal(mixed.feats, want.feats)


def test_fallback_without_gxx(monkeypatch, tmp_path):
    """No g++ on the PATH: the build raises, the loader records why once and
    every caller takes its Python version."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert "g++ not found" in native._failed
    native.reset_calls()
    assert levenshtein_matches([1, 2, 3], [1, 3]) == (1, 2)
    assert iod(np.array([0, 0, 1]), np.array([0, 1, 1])) == pytest.approx(0.75)
    assert sum(native.calls.values()) == 0
    assert not list(tmp_path.iterdir())


def test_two_threads_build_at_once(monkeypatch, tmp_path):
    """Two threads load a library not built yet (the loader's prefetch
    thread and the main thread): one build under the lock, one library in
    place, no temporary file left; and two bare builds racing rename one
    complete file each over the same name."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    got, errors = [], []

    def load():
        try:
            got.append(native._load())
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(got) == 2 and got[0] is got[1] is not None
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
    native.library_path().unlink()
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert paths == [native.library_path()] * 2
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
