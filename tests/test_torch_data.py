"""PyTorch port: its own copies of the host data helpers (`mucon_tpu_torch.data`,
`ops/viterbi.py Segment`) against the JAX package's: the padded collate
and the length-bucketed loader give equal arrays on the same samples, and
the records have the same fields."""

import dataclasses

import numpy as np
import pytest

from mucon_tpu.data import PaddedBatchLoader as JaxLoader
from mucon_tpu.data import collate_padded as jax_collate
from mucon_tpu.data.general_dataset import Sample as JaxSample
from mucon_tpu.data.utils import create_tf_input as jax_tf_input
from mucon_tpu.data.utils import create_tf_target as jax_tf_target
from mucon_tpu.decode.viterbi_host import Segment as JaxSegment
from mucon_tpu_torch.data import (
    PaddedBatch,
    PaddedBatchLoader,
    Sample,
    collate_padded,
    create_tf_input,
    create_tf_target,
)
from mucon_tpu_torch.ops.viterbi import Segment
from tests.test_model import NMAX, make_sample

FIELDS = ("feats", "num_frames", "gt_label", "transcript", "transcript_len", "tf_input",
          "tf_target", "absolute_lengths", "fully_supervised")


class ListDataset:
    """The least a loader needs: len, indexing, max_transcript_length."""

    def __init__(self, samples, with_num_frames: bool):
        self.samples = samples
        self.max_transcript_length = NMAX
        if with_num_frames:
            self.num_frames = lambda i: samples[i].feats.shape[0]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _samples(n=11, seed=0):
    rng = np.random.RandomState(seed)
    return [make_sample(rng, int(rng.randint(20, 90)), int(rng.randint(1, NMAX + 1)), f"v{i}")
            for i in range(n)]


def _assert_batches_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.video_names == b.video_names


def test_records_have_the_jax_fields():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(Sample) == names(JaxSample)
    assert names(Segment) == names(JaxSegment)
    assert names(PaddedBatch) == [f.name for f in dataclasses.fields(jax_collate(
        _samples(2), NMAX, 16).__class__)]
    np.testing.assert_array_equal(create_tf_input([3, 1], 9), jax_tf_input([3, 1], 9))
    np.testing.assert_array_equal(create_tf_target([3, 1], 8), jax_tf_target([3, 1], 8))


@pytest.mark.parametrize("pad_multiple", [16, 112])
def test_collate_padded_matches_jax(pad_multiple):
    samples = _samples()
    _assert_batches_equal(collate_padded(samples, NMAX, pad_multiple),
                          jax_collate(samples, NMAX, pad_multiple))


@pytest.mark.parametrize("prefetch,shuffle", [(0, True), (1, True), (1, False)])
def test_loader_matches_jax(prefetch, shuffle):
    """Two epochs of the same seed: the same batches in the same order, with
    the lengths read through `num_frames` or, without it, from the samples."""
    samples = _samples()
    kw = dict(batch_size=3, pad_multiple=16, seed=5, prefetch=prefetch, shuffle=shuffle)
    ref = JaxLoader(ListDataset(samples, True), **kw)
    for with_num_frames in (True, False):
        got = PaddedBatchLoader(ListDataset(samples, with_num_frames), **kw)
        assert len(got) == len(ref)
        for _ in range(2):
            want = list(ref)
            batches = list(got)
            assert len(batches) == len(want)
            for a, b in zip(batches, want):
                _assert_batches_equal(a, b)
        ref.epoch = 0
