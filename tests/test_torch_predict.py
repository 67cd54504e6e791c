"""PyTorch port: the serving slice end to end against the JAX package —
forward, fused eval and predict_videos on the same converted weights."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.cli.predict import predict_videos as jax_predict_videos
from mucon_tpu.data import collate_padded
from mucon_tpu.models import batch_to_arrays, create_model as create_jax_model
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
from mucon_tpu_torch.models.model import (
    batch_to_tensors,
    create_model,
    model_fields_from_cfg,
)
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)

FS = 10  # frame_sampling
TOL = dict(rtol=1e-5, atol=1e-4)
FLOAT_KEYS = ("rel_lengths", "vit_score")
DB = SimpleNamespace(
    max_transcript_length=NMAX, sos_token_id=M + 1, eos_token_id=M,
    action_id_to_name={i: f"action_{i}" for i in range(M)},
)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = small_cfg()
    cfg.tpu.batch_size = 3
    cfg.tpu.pad_multiple = 16
    cfg.evaluator.viterbi.frame_sampling = FS
    rng = np.random.RandomState(5)
    samples = [make_sample(rng, 150, 3, "a"), make_sample(rng, 97, 4, "b"),
               make_sample(rng, 61, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jm.init_params(jax.random.PRNGKey(4), batch)
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(jax.device_get(params))
    return cfg, samples, batch, jm, params, tm


def test_forward_matches_jax(slice_setup):
    _, _, batch, jm, params, tm = slice_setup
    ref = jm.forward(params, batch_to_arrays(batch), train=False,
                     teacher_forcing=False)
    got = tm.forward(batch_to_tensors(batch, "cpu"))
    for f in ("transcript", "lengths", "segmentation", "segmentation_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f, **TOL)
    for f in ("tokens", "n_steps", "tz_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_fused_eval_matches_jax(slice_setup):
    _, _, batch, jm, params, tm = slice_setup
    run = jax_build_fused_eval(jm, False, frame_sampling=FS)
    ref = unpack_eval_wire(
        jax.device_get(run(params, batch_to_arrays(batch))),
        n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
        num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]),
    )
    got = build_fused_eval(tm, frame_sampling=FS)(batch_to_tensors(batch, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_collate_videos_with_transcripts_matches_collate_padded(slice_setup):
    _, samples, batch, _, _, _ = slice_setup
    got = collate_videos([s.feats for s in samples], [s.video_name for s in samples],
                         DB, 16, transcripts=[s.transcript for s in samples])
    assert got.video_names == batch.video_names
    for f in ("feats", "num_frames", "transcript", "transcript_len", "tf_input",
              "tf_target", "absolute_lengths", "fully_supervised"):
        np.testing.assert_array_equal(getattr(got, f), getattr(batch, f), err_msg=f)


def test_predict_videos_matches_jax(slice_setup):
    cfg, samples, _, jm, params, tm = slice_setup
    feats = [s.feats for s in samples]
    names = [s.video_name for s in samples]
    ref = jax_predict_videos(jm, params, feats, names, cfg, DB)
    got = predict_videos(tm, feats, names, DB, frame_sampling=FS,
                         batch_size=cfg.tpu.batch_size,
                         pad_multiple=cfg.tpu.pad_multiple)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g["name"] == r["name"]
        assert g["transcript"] == r["transcript"]
        assert g["transcript_names"] == r["transcript_names"]
        np.testing.assert_allclose(g["rel_lengths"], r["rel_lengths"], **TOL)
        for k in ("vit_labels", "y_labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
