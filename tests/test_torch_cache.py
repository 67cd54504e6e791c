"""PyTorch port: the device batch cache, its replay and device prefetch
(mucon_tpu_torch/harness/{cache,trainer,evaluator}.py,
data/batching.py) against mucon_tpu's.

The port's versions of tests/test_cache_budget.py and
tests/test_harness_variants.py::test_device_prefetch_bit_identical:
`CacheBudget` against the JAX class on the same reservation sequences; the
loader's `fixed_batches` plan and `iter_cached_keys` against the JAX
loader's over 3 epochs; the trainer's replay (no collate after epoch 1, the
streaming run's trajectory bit for bit, the JAX trainer's with
`cache_batches` within the train tests' tolerance), its fallback rewinding
the shuffle, a half budget; the evaluator's shared and own budgets, its
replay and a budget miss; `tpu.device_prefetch` 0, 1 and 2 bit for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.data.batching import PaddedBatchLoader as JaxLoader
from mucon_tpu.harness.cache import CacheBudget as JaxBudget
from mucon_tpu.harness.cache import arrays_nbytes as jax_nbytes
from mucon_tpu.harness.trainer import SimpleTrainer as JaxTrainer
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.data import PaddedBatchLoader, handel_dataset
from mucon_tpu_torch.harness.cache import CacheBudget, arrays_nbytes
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.model import batch_to_host_tensors
from tests.test_model import make_sample

torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's step tolerance
LOSS_KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss")


def _sets(data_root, run_root, dropout: float = 0.25):
    """8 train videos (2 batches of 4) and 2 test videos, all padded to 192
    frames: one shape, one compile of each JAX program."""
    return [
        ("system.device", "cpu"), ("dataset.name", "synthetic"),
        ("dataset.root", str(data_root)), ("dataset.synthetic.num_videos", "10"),
        ("dataset.synthetic.num_classes", "6"), ("dataset.synthetic.feat_dim", "16"),
        ("dataset.synthetic.min_len", "130"), ("dataset.synthetic.max_len", "190"),
        ("trainer.root", str(run_root)), ("trainer.num_epochs", "3"),
        ("trainer.save_every", "100"), ("trainer.eval_every", "100"),
        ("model.ft.stages", "[1, 2, 4]"), ("model.ft.pooling_layers", "[0, 1]"),
        ("model.ft.hidden_size", "16"), ("model.ft.last_gn_num_groups", "4"),
        ("model.fs.encoder.hidden_size", "16"), ("model.fs.decoder.hidden_size", "16"),
        ("model.ft.dropout_rate", str(dropout)), ("model.ft.last_dropout_rate", str(dropout)),
        ("model.fs.decoder.embedding_dropout", str(dropout)),
        ("tpu.batch_size", "4"), ("tpu.pad_multiple", "64"), ("tpu.cache_batches", "True"),
        ("evaluator.viterbi.frame_sampling", "10"),
    ]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    data = tmp_path_factory.mktemp("data")
    cfg = get_cfg_defaults()
    cfg.merge_from_list([x for kv in _sets(data, "unused") for x in kv])
    db, test_db = handel_dataset(cfg, train=True), handel_dataset(cfg, train=False)
    return data, db, test_db


def _cfg(tiny, root, **sets):
    cfg = get_cfg_defaults()
    cfg.merge_from_list([x for kv in _sets(tiny[0], root) for x in kv])
    for k, v in sets.items():
        section, leaf = k.split("__")
        cfg[section][leaf] = v
    return cfg


def _trainer(tiny, root, seed_weights=0, evaluators=None, **sets):
    cfg = _cfg(tiny, root, **sets)
    db = tiny[1]
    model = create_model_from_cfg(cfg, db)
    return SimpleTrainer(cfg, "cache", db, model, evaluators=evaluators, seed=seed_weights)


def _weights(trainer):
    return {k: v.clone() for k, v in trainer.model.net.state_dict().items()}


def _assert_same_weights(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def collates(monkeypatch):
    """Counts `PaddedBatchLoader._make_batch` calls (collates)."""
    calls = {"n": 0}
    make = PaddedBatchLoader._make_batch

    def counted(self, idxs):
        calls["n"] += 1
        return make(self, idxs)

    monkeypatch.setattr(PaddedBatchLoader, "_make_batch", counted)
    return calls


# (budget, eval reserve, [(bytes, pool), ...]): tests/test_cache_budget.py's
# scenarios and a long mixed one
SEQUENCES = [
    (0, 0, [(1 << 40, "train"), (1 << 40, "train"), (5, "eval")]),
    (100, 0, [(60, "train"), (60, "train"), (40, "train"), (1, "eval")]),
    (100, 30, [(60, "train"), (20, "train"), (10, "train"), (25, "eval"), (10, "eval"),
               (5, "eval"), (1, "train")]),
    (100, 30, [(25, "eval"), (70, "train"), (10, "train"), (5, "eval"), (1, "eval")]),
    (100, 10, [(50, "eval"), (50, "train"), (1, "train"), (1, "eval")]),
    (1000, 250, [(n, "train" if n % 3 else "eval") for n in range(7, 200, 13)]),
]


@pytest.mark.parametrize("budget,reserve,seq", SEQUENCES)
def test_cache_budget_matches_jax(budget, reserve, seq, capsys):
    port, ref = CacheBudget(budget, reserve), JaxBudget(budget, reserve)
    for nbytes, pool in seq:
        got = port.try_reserve(nbytes, "batch", pool=pool)
        out_port = capsys.readouterr().out
        assert got == ref.try_reserve(nbytes, "batch", pool=pool), (nbytes, pool)
        assert out_port == capsys.readouterr().out
        assert (port.reserved_train, port.reserved_eval, port.reserved_bytes) == \
            (ref.reserved_train, ref.reserved_eval, ref.reserved_bytes)


def test_budget_from_config_and_nbytes():
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    for c in (cfg, jcfg):
        c.tpu.cache_budget_gb, c.tpu.cache_budget_eval_gb = 1.5, 0.25
    port, ref = CacheBudget.from_config(cfg), JaxBudget.from_config(jcfg)
    assert (port.budget_bytes, port.eval_reserve_bytes) == \
        (ref.budget_bytes, ref.eval_reserve_bytes) == (3 << 29, 1 << 28)
    arrays = {"a": np.zeros((3, 4), np.float32), "b": np.zeros((7,), np.int64),
              "c": np.zeros((5, 2), np.int8)}
    assert arrays_nbytes({k: torch.from_numpy(v) for k, v in arrays.items()}) \
        == jax_nbytes(arrays) == 48 + 56 + 10


class _Videos:
    """A train set of made-up videos with names and lengths."""

    max_transcript_length = 8

    def __init__(self, lengths):
        rng = np.random.RandomState(1)
        self.samples = [make_sample(rng, t, 3, f"v{i}") for i, t in enumerate(lengths)]
        self.file_names = [s.video_name for s in self.samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def num_frames(self, i):
        return self.samples[i].feats.shape[0]


def test_fixed_batches_plan_matches_jax():
    """Epochs 0 and 2 iterate, epoch 1 replays its keys: the same plans,
    keys and batches as the JAX loader's, and the same epoch counter."""
    db = _Videos([50, 31, 77, 31, 64, 90, 12, 45, 33, 70, 28])
    port = PaddedBatchLoader(db, batch_size=3, pad_multiple=16, seed=4, prefetch=0,
                             fixed_batches=True)
    ref = JaxLoader(db, batch_size=3, pad_multiple=16, seed=4, prefetch=0,
                    fixed_batches=True)
    assert len(port) == len(ref) == 4
    compositions = set()
    for epoch in range(3):
        plan = [list(b) for b in port._batch_indices()]
        assert plan == [list(b) for b in ref._batch_indices()]
        compositions |= {tuple(b) for b in plan}
        if epoch == 1:
            keys = list(port.iter_cached_keys())
            assert keys == list(ref.iter_cached_keys())
            assert [k for k, _ in keys] == [tuple(db.file_names[i] for i in b) for b in plan]
        else:
            got, want = list(port), list(ref)
            assert [b.video_names for b in got] == [b.video_names for b in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.feats, b.feats)
        assert port.epoch == ref.epoch == epoch + 1
    assert len(compositions) == 4  # the order moves, the composition does not
    with pytest.raises(ValueError):
        next(PaddedBatchLoader(db, batch_size=3).iter_cached_keys())


def test_replay_skips_collate_and_matches_streaming_and_jax(tiny, tmp_path, collates):
    """With every fixed batch cached after epoch 1, epochs 2-3 collate
    nothing and the trajectory is the streaming run's bit for bit (the same
    fixed batches, collated and copied every epoch); with dropout 0 it is
    the JAX trainer's with `cache_batches` within the train tolerance."""
    cached = _trainer(tiny, tmp_path / "cached")
    jcfg = jax_defaults()
    jcfg.merge_from_list([x for kv in _sets(tiny[0], tmp_path / "jax", 0.0) for x in kv])
    jdb = jax_dataset(jcfg, train=True)
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    jt = JaxTrainer(jcfg, "cache", jdb, jm, device="cpu")
    port0 = get_cfg_defaults()
    port0.merge_from_list([x for kv in _sets(tiny[0], tmp_path / "port0", 0.0) for x in kv])
    p0 = SimpleTrainer(port0, "cache", tiny[1], create_model_from_cfg(port0, tiny[1]))
    p0.model.load_jax_params(jax.device_get(jt.params))

    cached.train()
    n = len(cached.create_train_dataloader())
    assert collates["n"] == n and len(cached._batch_cache) == n
    streaming = _trainer(tiny, tmp_path / "stream")
    streaming._epoch_batches = streaming._prefetched  # never replay
    streaming.train()
    assert collates["n"] == 4 * n
    _assert_same_weights(_weights(cached), _weights(streaming))

    jt.train()
    p0.train()
    want = [e for e in map(json.loads, open(jt.run_folder / "events.jsonl"))
            if e["kind"] == "epoch"]
    got = [e for e in map(json.loads, open(p0.run_folder / "events.jsonl"))
           if e["kind"] == "epoch"]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], **TRAIN_TOL, err_msg=(a["step"], k))
    a = state_dict_to_params(p0.model.net.state_dict())
    b = jax.device_get(jt.params)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), **TRAIN_TOL)
    assert len(jt._batch_cache) == len(p0._batch_cache) == n


def test_replay_fallback_rewinds_the_shuffle(tiny, tmp_path):
    """A cache whose keys no longer match the plan falls back to the loader
    for the same epoch's order: the never-replayed run's trajectory."""
    poisoned = _trainer(tiny, tmp_path / "poison")
    batches = poisoned._epoch_batches

    def poison(loader):
        if poisoned._batch_cache:
            key = next(iter(poisoned._batch_cache))
            poisoned._batch_cache[("bogus",) + key] = poisoned._batch_cache.pop(key)
        return batches(loader)

    poisoned._epoch_batches = poison
    poisoned.train()
    plain = _trainer(tiny, tmp_path / "plain")
    plain._epoch_batches = plain._prefetched
    plain.train()
    assert poisoned.create_train_dataloader().epoch == plain.create_train_dataloader().epoch
    _assert_same_weights(_weights(poisoned), _weights(plain))


def test_half_budget_caches_half_and_still_trains(tiny, tmp_path, collates):
    probe = _trainer(tiny, tmp_path / "probe")
    loader = probe.create_train_dataloader()
    sizes = [sum(v.nbytes for v in batch_to_host_tensors(b).values()) for b in loader]
    n = len(sizes)
    half = sum(sizes) // 2  # room for some batches, never for all
    collates["n"] = 0
    t = _trainer(tiny, tmp_path / "half", tpu__cache_budget_gb=half / 2**30)
    t.train()
    assert 0 < len(t._batch_cache) < n
    assert t.cache_budget.reserved_train <= t.cache_budget.budget_bytes
    assert collates["n"] == 3 * n  # no replay: the uncached batches stream
    events = [e for e in map(json.loads, open(t.run_folder / "events.jsonl"))
              if e["kind"] == "epoch"]
    assert len(events) == 3 and all(np.isfinite(e["main"]) for e in events)
    full = _trainer(tiny, tmp_path / "full")
    full._epoch_batches = full._prefetched
    full.train()
    _assert_same_weights(_weights(t), _weights(full))


@pytest.mark.parametrize("budget_gb", [0.0, 1e-6])
def test_evaluator_budget_shared_or_its_own(tiny, tmp_path, budget_gb):
    cfg = _cfg(tiny, tmp_path, tpu__cache_budget_gb=budget_gb)
    model = create_model_from_cfg(cfg, tiny[1])
    shared = MuConEvaluator(cfg, tiny[2], model)
    trainer = SimpleTrainer(cfg, "shared", tiny[1], model, evaluators=[shared])
    assert shared.cache_budget is trainer.cache_budget
    alone = MuConEvaluator(cfg, tiny[2], model)
    assert alone.cache_budget is None
    result = alone.evaluate()
    assert alone.cache_budget is not None and alone.cache_budget is not trainer.cache_budget
    assert np.isfinite(result.s_mof)
    n = len(alone.create_dataloader())
    assert len(alone._array_cache) == (n if budget_gb == 0.0 else 0)


def test_evaluator_replay_skips_collate_and_equals_streaming(tiny, tmp_path, collates):
    cfg = _cfg(tiny, tmp_path)
    model = create_model_from_cfg(cfg, tiny[1])
    ev = MuConEvaluator(cfg, tiny[2], model)
    ev.viterbi_mode(True)
    r1 = ev.evaluate()
    n = len(ev.create_dataloader())
    assert collates["n"] == n and ev._replay is not None
    r2 = ev.evaluate()
    assert collates["n"] == n  # replayed: no dataset read, no collate
    assert all(b.feats.shape[2] == 0 and b.feats.shape[1] > 0 for b, _ in ev._replay)
    cfg_s = _cfg(tiny, tmp_path, tpu__cache_batches=False)
    streaming = MuConEvaluator(cfg_s, tiny[2], model)
    streaming.viterbi_mode(True)
    r3 = streaming.evaluate()
    assert dataclasses.asdict(r1) == dataclasses.asdict(r2) == dataclasses.asdict(r3)
    assert streaming._replay is None and not streaming._array_cache


def test_evaluator_budget_miss_disables_replay(tiny, tmp_path, collates):
    cfg = _cfg(tiny, tmp_path, tpu__cache_budget_gb=1e-6)  # nothing fits
    model = create_model_from_cfg(cfg, tiny[1])
    ev = MuConEvaluator(cfg, tiny[2], model)
    r1 = ev.evaluate()
    assert ev._replay is None and not ev._array_cache
    r2 = ev.evaluate()
    assert collates["n"] == 2 * len(ev.create_dataloader())
    assert dataclasses.asdict(r1) == dataclasses.asdict(r2)


def test_device_prefetch_bit_identical(tiny, tmp_path):
    """`tpu.device_prefetch` 0, 1 and 2: the same trajectory bit for bit
    (dropout on, streaming: the cache off)."""
    finals = []
    for ahead in (0, 1, 2):
        t = _trainer(tiny, tmp_path / str(ahead), tpu__device_prefetch=ahead,
                     tpu__cache_batches=False)
        t.train()
        finals.append(_weights(t))
    _assert_same_weights(finals[0], finals[1])
    _assert_same_weights(finals[0], finals[2])
