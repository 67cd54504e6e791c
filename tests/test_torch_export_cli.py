"""PyTorch port: `python -m mucon_tpu_torch.cli.export_model` against
mucon_tpu/cli/export_model.py.

On a run folder of either package (the port's `model.pt` and JSON
config.yaml, or a JAX run's flax `model.msgpack` and YAML config; the JAX
run on the int8 wire) the entry point writes `model.pt2` and `meta.json`
and passes its selftest: the loaded artifact equals the live program bit
for bit on a seeded batch.  The artifact's predictions are the port's
`predict_videos` with the run's weights on the same wire, and, for the JAX
run, the JAX artifact's of the same run and wire.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.cli.export_model import main as jax_export_main
from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.harness.checkpoint import save_checkpoint as jax_save_checkpoint
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.serving import load_exported as jax_load_exported
from mucon_tpu_torch.cli import export_model
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.cli.predict import predict_videos
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.checkpoint import load_params, save_checkpoint
from mucon_tpu_torch.models.model import FEATS_DTYPES
from mucon_tpu_torch.serving import load_exported
from tests.test_torch_cli import _overrides
from tests.test_torch_predict import TOL
from tests.test_torch_serving import _assert_same_predictions

torch.set_num_threads(1)

ARGS = ["--batch-size", "2", "--pad-to", "128", "--viterbi-max-len", "400"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port run folder and a JAX run folder of the tiny synthetic config,
    each with one checkpoint of its own random weights."""
    data_root, root = tmp_path_factory.mktemp("data"), tmp_path_factory.mktemp("runs")
    pairs = [x for kv in _overrides(data_root, root) for x in kv]
    cfg = get_cfg_defaults()
    cfg.merge_from_list(pairs)
    db = handel_dataset(cfg, train=False)
    model = create_model_from_cfg(cfg, db)
    (root / "port_exp" / "0").mkdir(parents=True)
    cfg.dump_to_file(str(root / "port_exp" / "0" / "config.yaml"))
    save_checkpoint(root / "port_exp" / "0" / "checkpoints" / "epoch_1",
                    model.net.state_dict(), {}, {"epoch_num": 1})

    jcfg = jax_defaults()
    jcfg.merge_from_list(pairs)
    (root / "jax_exp" / "0").mkdir(parents=True)
    jcfg.dump_to_file(str(root / "jax_exp" / "0" / "config.yaml"))
    jm = create_jax_model(jcfg, num_classes=db.get_num_classes(),
                          max_decoding_steps=db.max_transcript_length + 1,
                          input_feature_size=db.feat_dim)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(3)))
    jax_save_checkpoint(root / "jax_exp" / "0" / "checkpoints" / "epoch_2", params, None,
                        {"epoch_num": 2})
    return root, cfg, db


@pytest.mark.parametrize("run, wire", [("port_exp/0/1", "float32"), ("jax_exp/0/2", "int8")])
def test_export_model_main_with_selftest(runs, tmp_path, capsys, run, wire):
    root, cfg, db = runs
    out = tmp_path / "artifact"
    args = ARGS + ["--feats-wire", wire]
    assert export_model.main([run, "--out", str(out), "--root", str(root)] + args) == str(out)
    printed = capsys.readouterr().out
    assert "selftest: exported == live program (bitwise)" in printed
    meta = json.loads((out / "meta.json").read_text())
    assert (out / "model.pt2").stat().st_size > 0
    assert (meta["batch_size"], meta["pad_to"], meta["device"], meta["feats_wire"]) == (
        2, 128, "cpu", wire)

    rng = np.random.default_rng(8)
    feats = [rng.standard_normal((t, db.feat_dim)).astype(np.float32) for t in (128, 90, 31)]
    got = load_exported(out).predict(feats)
    exp, number, epoch = run.split("/")
    model = create_model_from_cfg(cfg, db)
    model.net.load_state_dict(load_params(root, exp, number, int(epoch), "cpu"))
    want = predict_videos(model, feats, [f"video_{i}" for i in range(3)], db,
                          frame_sampling=10, batch_size=2, pad_multiple=64,
                          feats_dtype=FEATS_DTYPES[wire])
    _assert_same_predictions(got, want, dict(rtol=1e-5, atol=0))
    if exp == "jax_exp":  # the JAX artifact of the same run
        jax_out = tmp_path / "jax_artifact"
        jax_export_main([run, "--out", str(jax_out), "--root", str(root), "--no-selftest"]
                        + args)
        _assert_same_predictions(got, jax_load_exported(jax_out).predict(feats), TOL)
