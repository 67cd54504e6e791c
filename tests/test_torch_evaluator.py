"""PyTorch port: `MuConEvaluator` against mucon_tpu's.

The JAX evaluator (its fused path: XLA on the CPU) and the port's (the
plain twins of its kernels on CPU tensors), given the same weights through
`convert.py` and the same test set, give the 24 fields within 1e-6, with
Viterbi off and on, and the same per-video pickles.  The weights' seed is
one whose decode has no near tie (a top-two margin of the argmax or of the
Viterbi path within f32 rounding), as in tests/test_torch_mstcnpp.py.
Single-shape eval (one padded (batch_size, T_max) shape, dummy rows) gives
the bucketed result exactly.
"""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.harness.evaluator import MuConEvaluator as JaxEvaluator
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator

torch.set_num_threads(1)
SEED = 2


def _configure(cfg, root):
    cfg.system.device = "cpu"
    cfg.dataset.name = "synthetic"
    cfg.dataset.root = str(root)
    s = cfg.dataset.synthetic
    s.num_videos, s.num_classes, s.feat_dim, s.min_len, s.max_len = 12, 6, 16, 120, 400
    s.train_fraction = 0.5
    ft = cfg.model.ft
    ft.stages, ft.pooling_layers, ft.hidden_size, ft.last_gn_num_groups = [1, 2, 4], [0, 1], 16, 4
    cfg.model.fs.encoder.hidden_size = cfg.model.fs.decoder.hidden_size = 16
    cfg.tpu.batch_size, cfg.tpu.pad_multiple = 4, 64
    cfg.evaluator.viterbi.frame_sampling = 10
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg, jcfg = _configure(get_cfg_defaults(), root), _configure(jax_defaults(), root)
    db, jdb = handel_dataset(cfg, train=False), jax_dataset(jcfg, train=False)
    assert len(db) == 6  # two batches of 4, the second with two dummy rows
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(SEED)))
    model = create_model_from_cfg(cfg, db)
    model.load_jax_params(params)
    return cfg, jcfg, db, jdb, jm, params, model


def _fields(result):
    out = {}
    for k, v in dataclasses.asdict(result).items():
        for i, x in enumerate(np.atleast_1d(v)):
            out[f"{k}[{i}]" if np.ndim(v) else k] = float(x)
    return out


def test_evaluator_matches_jax(setup, tmp_path):
    cfg, jcfg, db, jdb, jm, params, model = setup
    port, ref = MuConEvaluator(cfg, db, model), JaxEvaluator(jcfg, jdb, jm)
    for viterbi in (False, True):
        port.viterbi_mode(viterbi)
        ref.viterbi_mode(viterbi)
        got, want = _fields(port.evaluate()), _fields(ref.evaluate(params))
        # 24 fields, three of them F1 triples
        assert got.keys() == want.keys() and len(got) == 30
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), (viterbi, k)
        assert set(port.last_eval_phases) == {"stream", "first_dispatch", "dispatch",
                                              "consume", "finish"}
    for ev, name in ((port, "port"), (ref, "jax")):
        ev.set_name(name)
        ev.set_checkpointing_folder(tmp_path)
        ev.save_stuff()
    a = pickle.load(open(tmp_path / "data_port.pkl", "rb"))
    b = pickle.load(open(tmp_path / "data_jax.pkl", "rb"))
    assert a.keys() == b.keys()
    for k in ("y_segs", "s_segs", "vit_segs", "target_segs"):
        assert len(a[k]) == len(b[k]) == 6
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert a["s_transcript"] == b["s_transcript"]
    assert a["target_transcripts"] == [[int(t) for t in x] for x in b["target_transcripts"]]
    for x, y in zip(a["s_lens"], b["s_lens"]):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def test_single_shape_eval_matches_bucketed(setup):
    cfg, _, db, _, _, _, model = setup
    results = {}
    for single in (True, False):
        c = cfg.clone()
        c.tpu.eval_single_shape = single
        c.tpu.pad_multiple = 16  # bucketed: T_pad 368 and 384; single: 384
        ev = MuConEvaluator(c, db, model)
        ev.viterbi_mode(True)
        shapes = sorted(b.feats.shape[1] for b in ev.create_dataloader())
        assert shapes == ([384, 384] if single else [368, 384])
        results[single] = dataclasses.asdict(ev.evaluate())
    assert results[True] == results[False]
