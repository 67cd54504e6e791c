"""PyTorch port: the datasets and the batch loader against mucon_tpu's.

`materialize_synthetic_dataset` writes the same bytes; the synthetic and
the Breakfast-fixture datasets give the same samples (features, labels,
transcripts, teacher-forcing sequences), vocabulary and training-transcript
grammar; and the loader's batch plan (the videos of each batch, in order,
and each batch's padded arrays) is the JAX loader's for the same seed and
epoch, shuffled or not, with and without one `pad_to` for every batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import PaddedBatchLoader as JaxLoader
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.data.fixture import materialize_breakfast_fixture as jax_fixture
from mucon_tpu.data.synthetic import materialize_synthetic_dataset as jax_materialize
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import PaddedBatchLoader, handel_dataset
from mucon_tpu_torch.data.fixture import materialize_breakfast_fixture
from mucon_tpu_torch.data.synthetic import materialize_synthetic_dataset

torch.set_num_threads(1)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("kw", [dict(), dict(n_splits=4, train_fraction=0.5, noise=0.3)])
def test_synthetic_dataset_same_bytes(tmp_path, kw):
    args = dict(num_videos=7, num_classes=5, feat_dim=6, min_len=20, max_len=70, seed=3, **kw)
    a = materialize_synthetic_dataset(tmp_path / "port", **args)
    b = jax_materialize(tmp_path / "jax", **args)
    fa, fb = _files(a), _files(b)
    assert len(fa) == 7 * 4 + 2 * max(1, kw.get("n_splits", 1)) + 2  # + mapping, .complete
    assert fa == fb


def test_synthetic_dataset_written_by_two_ranks_at_once(tmp_path):
    """Two writers materialize the same dataset at once (the ranks of a
    multi-process run each do) while a reader loads whatever file exists:
    no read sees a file half written, no temporary file is left, and the
    bytes are one writer's."""
    import threading

    args = dict(num_videos=6, num_classes=5, feat_dim=4096, min_len=300, max_len=400, seed=3)
    root = tmp_path / "shared"
    (root / "features").mkdir(parents=True)
    errors, reads = [], [0]

    def write():
        try:
            materialize_synthetic_dataset(root, **args)
        except Exception as e:  # noqa: BLE001 - a failed write is the finding
            errors.append(f"writer: {e!r}")

    writers = [threading.Thread(target=write) for _ in range(2)]

    def read():
        while any(w.is_alive() for w in writers):
            for f in sorted((root / "features").glob("*.npy")):
                try:
                    np.load(f)
                    reads[0] += 1
                except Exception as e:  # noqa: BLE001 - any failed read is the finding
                    errors.append(f"{f.name}: {e!r}")

    reader = threading.Thread(target=read)
    for w in writers:
        w.start()
    reader.start()
    for t in (*writers, reader):
        t.join()
    assert not errors, errors[:3]
    assert reads[0] > 0
    assert not [p for p in root.rglob("*") if p.name.endswith(".tmp")]
    assert _files(root) == _files(materialize_synthetic_dataset(tmp_path / "alone", **args))


def _cfgs(name, root):
    out = []
    for cfg in (get_cfg_defaults(), jax_defaults()):
        cfg.dataset.name = name
        cfg.dataset.root = str(root)
        s = cfg.dataset.synthetic
        s.num_videos, s.num_classes, s.feat_dim, s.min_len, s.max_len = 9, 6, 8, 30, 90
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    materialize_breakfast_fixture(root / "port", num_videos=8, num_classes=7, min_len=30,
                                  max_len=80)
    jax_fixture(root / "jax", num_videos=8, num_classes=7, min_len=30, max_len=80)
    out = {}
    for name, roots in (("synthetic", (root / "syn", root / "syn")),
                        ("breakfast", (root / "port", root / "jax"))):
        for train in (True, False):
            pc, jc = _cfgs(name, roots[0])
            jc.dataset.root = str(roots[1])
            out[name, train] = (handel_dataset(pc, train), jax_dataset(jc, train))
    return out


@pytest.mark.parametrize("name", ["synthetic", "breakfast"])
@pytest.mark.parametrize("train", [True, False])
def test_samples_and_vocabulary_equal(datasets, name, train):
    port, ref = datasets[name, train]
    assert len(port) == len(ref) > 0
    for attr in ("file_names", "num_actions", "eos_token_id", "sos_token_id",
                 "action_id_to_name", "action_name_to_id", "max_transcript_length",
                 "background_class_ids", "convenient_name", "split", "feat_dim",
                 "training_transcripts_list"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.training_path_grammar.successors == ref.training_path_grammar.successors
    for i in range(len(port)):
        assert port.num_frames(i) == ref.num_frames(i)
        a, b = port[i], ref[i]
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name


OPTIONS = [
    dict(shuffle=True),
    dict(shuffle=False),
    dict(shuffle=True, batch_size=3),
    dict(shuffle=True, pad_to=112),
    dict(shuffle=False, pad_to=128),
]


@pytest.mark.parametrize("opts", OPTIONS)
def test_batch_plan_equal(datasets, opts):
    port_db, ref_db = datasets["synthetic", True]
    kw = dict(batch_size=2, pad_multiple=32, seed=5, prefetch=0)
    kw.update(opts)
    port, ref = PaddedBatchLoader(port_db, **kw), JaxLoader(ref_db, **kw)
    assert len(port) == len(ref)
    for _ in range(2):  # two epochs: the shuffle advances alike
        got, want = list(port), list(ref)
        assert [b.video_names for b in got] == [b.video_names for b in want]
        for a, b in zip(got, want):
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), f.name
    if opts.get("pad_to"):
        assert {b.feats.shape[1] for b in got} == {opts["pad_to"]}

