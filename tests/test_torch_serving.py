"""PyTorch port: the serving export (`mucon_tpu_torch/serving.py`) against
`tests/test_export.py`'s cases and the JAX artifact.

The port's artifact is a `torch.export` program of the fused eval on its
plain routes with the sync-free decode.  It must reproduce the live program
bit for bit, for random weights and for weights whose every video emits EOS
at step 0; the sync-free decode must give the live loop's outputs bit for
bit (eager); and `ExportedMuCon.predict` on raw features must give the
port's `predict_videos` and the JAX artifact's predictions, on the same
converted weights.  The artifacts are shared by a module fixture.
"""

import json
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.cli.predict import predict_videos as jax_predict_videos
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.serving import export_serving as jax_export_serving
from mucon_tpu.serving import load_exported as jax_load_exported
from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.ops.eval_fused import EVAL_OUTPUTS
from mucon_tpu_torch.serving import (
    ExportedMuCon,
    build_serving_fn,
    export_serving,
    load_exported,
    same_bits,
)
from tests.test_model import D, M, NMAX, small_cfg
from tests.test_torch_predict import TOL

torch.set_num_threads(1)

B, PAD, MAX_LEN, FS = 2, 128, 400, 10
DB = SimpleNamespace(
    max_transcript_length=NMAX, sos_token_id=M + 1, eos_token_id=M, feat_dim=D,
    action_id_to_name={i: f"action_{i}" for i in range(M)}, get_num_classes=lambda: M,
)
FORWARD_FIELDS = ("transcript", "lengths", "segmentation", "tokens", "n_steps", "tz_lengths",
                  "segmentation_z")


def _cfg():
    cfg = small_cfg()
    cfg.tpu.pad_multiple = 64
    cfg.evaluator.viterbi.frame_sampling = FS
    return cfg


def _eos_first(params, shift):
    """The JAX parameter tree with the EOS logit's bias raised by `shift`."""
    params = jax.tree_util.tree_map(np.array, params)
    params["decoder"]["transcript_out"]["bias"][M] += shift
    return params


def _port(cfg, params):
    model = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    model.load_jax_params(params)
    return model


def _batch(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, D)).astype(np.float32) for t in lengths]


@pytest.fixture(scope="module")
def serving_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    cfg = _cfg()
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    weights = {"random": params, "eos_first": _eos_first(params, 1e3)}
    models = {k: _port(cfg, p) for k, p in weights.items()}
    for k, model in models.items():
        export_serving(model, cfg, DB, B, PAD, tmp / k, MAX_LEN, device="cpu")
    jax_export_serving(jm, params, cfg, DB, batch_size=B, pad_to=PAD,
                       out_dir=tmp / "jax", viterbi_max_len=MAX_LEN)
    served = {k: load_exported(tmp / k) for k in models}
    return SimpleNamespace(cfg=cfg, jm=jm, weights=weights, models=models, served=served,
                           tmp=tmp)


def test_artifact_files_and_meta(serving_setup):
    s = serving_setup
    out = s.tmp / "random"
    assert (out / "model.pt2").stat().st_size > 0
    meta = json.loads((out / "meta.json").read_text())
    assert meta["format"] == "mucon-tpu-torch-serving-v1"
    assert meta["batch_size"] == B and meta["pad_to"] == PAD
    assert meta["feat_dim"] == D and meta["feats_wire"] == "float32"
    assert meta["n_steps_dim"] == NMAX + 1 and meta["n_max"] == NMAX
    assert meta["frame_sampling"] == FS and meta["viterbi_max_len"] == MAX_LEN
    assert meta["num_classes"] == M
    assert meta["action_names"] == [DB.action_id_to_name[i] for i in range(M)]
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert meta["outputs"] == list(EVAL_OUTPUTS)
    # the JAX meta's fields, but for the renamed ones
    jax_meta = json.loads((s.tmp / "jax" / "meta.json").read_text())
    renamed = {"format", "platforms", "jax_version"}
    assert set(jax_meta) - renamed <= set(meta)
    for k in set(jax_meta) - renamed - {"num_frames_dtype"}:
        assert meta[k] == jax_meta[k], k


@pytest.mark.parametrize("weights", ["random", "eos_first"])
def test_exported_matches_live_program_bitwise(serving_setup, weights):
    s = serving_setup
    served = s.served[weights]
    feats = _batch((PAD, PAD), 1)
    padded, nf = served.pad_batch([feats[0][:120], feats[1][:77]])
    got = served(padded, nf)
    live = build_serving_fn(s.models[weights], s.cfg, DB, B, PAD, MAX_LEN)
    with torch.no_grad():
        want = live(*served.to_wire(padded), torch.from_numpy(nf))
    assert list(got) == list(EVAL_OUTPUTS)
    for k, w in zip(EVAL_OUTPUTS, want):
        assert same_bits(got[k], w), k
    steps = got["n_steps"].tolist()
    assert steps == ([1, 1] if weights == "eos_first" else [NMAX + 1] * B)


def _mixed(cfg, params, arrays):
    """Weights on which one video of `arrays` emits EOS at step 0 and the
    others do not: the EOS bias raised to between the two smallest step-0
    margins of the EOS logit."""
    fwd = _port(cfg, params).forward(arrays, use_kernels=False)
    lp0 = fwd.transcript[:, 0].double()
    margins = np.sort((lp0[:, :M].amax(dim=1) - lp0[:, M]).numpy())
    return _eos_first(params, float(margins[:2].mean()))


@pytest.mark.parametrize("weights", ["random", "eos_first", "mixed"])
def test_sync_free_decode_matches_the_loop(serving_setup, weights):
    """Eager, no export: the forward with `sync_free` (all S steps, the exit
    as a mask) gives the live loop's outputs bit for bit."""
    s = serving_setup
    feats = _batch((120, 77, 128, 33), 2)
    arrays = batch_to_tensors(collate_videos(feats, list("abcd"), DB, 64), "cpu")
    params = (_mixed(s.cfg, s.weights["random"], arrays) if weights == "mixed"
              else s.weights[weights])
    model = _port(s.cfg, params)
    loop = model.forward(arrays, use_kernels=False)
    free = model.forward(arrays, use_kernels=False, sync_free=True)
    for f in FORWARD_FIELDS:
        assert same_bits(getattr(free, f), getattr(loop, f)), f
    steps = loop.n_steps.tolist()
    if weights == "mixed":  # the decode runs on past a video that is done
        assert 1 in steps and max(steps) == NMAX + 1, steps
    else:
        assert len(set(steps)) == 1, steps


def _assert_same_predictions(got, want, tol):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert g["transcript"] == w["transcript"]
        assert g["transcript_names"] == w["transcript_names"]
        np.testing.assert_allclose(g["rel_lengths"], w["rel_lengths"], **tol)
        for k in ("vit_labels", "y_labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_predict_serves_raw_features(serving_setup):
    """Raw [T x D] arrays in (3 videos through a B=2 artifact, ragged),
    per-video predictions out: the port's predict_videos on the same
    weights, and the JAX artifact of the same weights."""
    s = serving_setup
    feats = _batch((120, 64, 100), 3)
    names = ["a", "b", "c"]
    got = s.served["random"].predict(feats, names=names)
    for r, f in zip(got, feats):
        assert len(r["transcript"]) >= 1
        assert abs(sum(r["rel_lengths"]) - 1.0) < 1e-5
        assert r["vit_labels"].shape == r["y_labels"].shape == (f.shape[0],)
        assert set(np.unique(r["vit_labels"])) <= set(r["transcript"])
    live = predict_videos(s.models["random"], feats, names, DB, frame_sampling=FS,
                          batch_size=B, pad_multiple=64)
    _assert_same_predictions(got, live, dict(rtol=1e-5, atol=0))
    ref = jax_load_exported(s.tmp / "jax").predict(feats, names=names)
    _assert_same_predictions(got, ref, TOL)


def test_predict_eos_first(serving_setup):
    """Every video emits EOS at step 0: the artifact's predictions equal
    the port's predict_videos and the JAX package's on the same weights."""
    s = serving_setup
    feats = _batch((128, 40, 97), 4)
    names = ["a", "b", "c"]
    got = s.served["eos_first"].predict(feats, names=names)
    live = predict_videos(s.models["eos_first"], feats, names, DB, frame_sampling=FS,
                          batch_size=B, pad_multiple=64)
    _assert_same_predictions(got, live, dict(rtol=1e-5, atol=0))
    ref = jax_predict_videos(s.jm, s.weights["eos_first"], feats, names,
                             s.cfg.clone(), DB)
    _assert_same_predictions(got, ref, TOL)
    assert all(len(r["transcript"]) == 1 for r in got)


def test_jax_artifact_refused_by_name(serving_setup):
    with pytest.raises(ValueError, match="mucon-tpu-serving-v1"):
        ExportedMuCon(serving_setup.tmp / "jax")


def test_cuda_artifact_refused_without_cuda(serving_setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: nothing to refuse")
    out = tmp_path / "cuda_meta"
    shutil.copytree(serving_setup.tmp / "random", out)
    meta = json.loads((out / "meta.json").read_text())
    (out / "meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(out)
