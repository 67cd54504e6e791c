"""PyTorch port: the metrics (numpy) against mucon_tpu's on seeded inputs.

Each metric class of the evaluator (MoF with and without ignore ids, IoD,
IoU, Edit, F1@{10,25,50}, the matching score, the abs length difference),
`make_same_size_interpolate` and the evaluator's
`create_segmentation_from_segments` are fed the same random label runs on
both sides; every summary and every per-call value is equal (exactly: both
sides compute in float64 in the same order, or count integers).
"""

import numpy as np
import pytest

from mucon_tpu import metrics as jax_metrics
from mucon_tpu.harness.evaluator import (
    create_segmentation_from_segments as jax_create_segmentation,
)
from mucon_tpu.utils import make_same_size_interpolate as jax_interpolate
from mucon_tpu_torch import metrics
from mucon_tpu_torch.harness.evaluator import create_segmentation_from_segments
from mucon_tpu_torch.utils import make_same_size_interpolate


def _runs(rng, T, M, mean_run):
    """A framewise label sequence of T frames made of runs of ~mean_run."""
    out = []
    while len(out) < T:
        out += [int(rng.randint(M))] * int(rng.randint(1, 2 * mean_run))
    return np.asarray(out[:T], np.int64)


def _pairs(seed, n=12):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        T = int(rng.randint(1, 200))
        out.append((_runs(rng, T, 6, 20), _runs(rng, T, 6, int(rng.choice([1, 5, 30])))))
    return out


CLASSES = [
    ("MoFAccuracyMetric", {}), ("MoFAccuracyMetric", {"ignore_ids": [0]}),
    ("IoDMetric", {}), ("IoDMetric", {"ignore_ids": [0]}),
    ("IoUMetric", {}), ("IoUMetric", {"ignore_ids": [0, 3]}),
    ("Edit", {}), ("Edit", {"ignore_ids": [0]}),
    ("F1Score", {}), ("F1Score", {"ignore_ids": [0]}),
]


@pytest.mark.parametrize("name,kw", CLASSES)
@pytest.mark.parametrize("seed", [0, 1])
def test_framewise_metric_equal(name, kw, seed):
    port, ref = getattr(metrics, name)(**kw), getattr(jax_metrics, name)(**kw)
    for targets, preds in _pairs(seed):
        a = port(targets=targets, predictions=preds)
        b = ref(targets=targets, predictions=preds)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.summary(), ref.summary())
    port.reset()
    ref.reset()
    np.testing.assert_array_equal(port.summary(), ref.summary())


@pytest.mark.parametrize("name", ["MatchingScoreMetric", "AbsLenDiffMetric"])
def test_transcript_metric_equal(name):
    rng = np.random.RandomState(2)
    port, ref = getattr(metrics, name)(), getattr(jax_metrics, name)()
    for _ in range(20):
        tgt = list(rng.randint(0, 6, size=rng.randint(0, 9)))
        pred = list(rng.randint(0, 6, size=rng.randint(0, 9)))
        assert port.add(target_transcript=tgt, predicted_transcript=pred) == \
            ref.add(target_transcript=tgt, predicted_transcript=pred)
    assert port.summary() == ref.summary()


def test_sizing_and_segmentation_equal():
    rng = np.random.RandomState(4)
    for _ in range(30):
        p = rng.randint(0, 5, size=rng.randint(1, 60))
        t = np.zeros(rng.randint(1, 90), np.int64)
        np.testing.assert_array_equal(make_same_size_interpolate(p, t), jax_interpolate(p, t))
        n = int(rng.randint(1, 6))
        actions = rng.randint(0, 5, size=n)
        lengths = rng.dirichlet(np.ones(n)).astype(np.float32)
        frames = int(rng.randint(1, 300))
        np.testing.assert_array_equal(
            create_segmentation_from_segments(actions, lengths, frames),
            jax_create_segmentation(actions, lengths, frames))
