"""PyTorch port: teacher-forced evaluation (the alignment task) against
mucon_tpu.

* The eval forward with teacher forcing (the decoder chain's forward under
  `torch.no_grad()`: `DecoderChain` with its plain twin on CPU tensors, and
  the plain loop) against JAX's `forward(train=False, teacher_forcing=True)`
  (its decoder scan), within 1e-5.
* The teacher-forced fused eval against JAX's
  `build_fused_eval(teacher_forcing=True)`: integer outputs equal, floats
  within 1e-5 relative.
* `MuConAlignmentEvaluator` against JAX's on a synthetic test set, on the
  fused path and on the per-batch path: the 24 fields within 1e-6, with
  `s_mat_score == 1.0` and `s_len_diff == 0.0` (the decoded transcript is
  the ground truth), as tests/test_harness_variants.py holds the JAX one.
"""

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.harness import MuConAlignmentEvaluator as JaxAlignment
from mucon_tpu.models import batch_to_arrays, create_model as create_jax_model
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu_torch.harness import MuConAlignmentEvaluator, MuConEvaluator
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from tests.test_model import D, M, NMAX, make_sample, small_cfg
from tests.test_torch_evaluator import _fields
from tests.test_torch_evaluator import setup as evaluator_setup  # noqa: F401 (a fixture)

torch.set_num_threads(1)

FS = 10
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def slice_setup():
    cfg = small_cfg()
    rng = np.random.RandomState(7)
    samples = [make_sample(rng, 150, 3, "a"), make_sample(rng, 97, 5, "b"),
               make_sample(rng, 61, 1, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jm.init_params(jax.random.PRNGKey(3), batch)
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(jax.device_get(params))
    return batch, jm, params, tm


@pytest.mark.parametrize("use_kernels", [True, False])
def test_teacher_forced_eval_forward_matches_jax(slice_setup, use_kernels):
    batch, jm, params, tm = slice_setup
    ref = jm.forward(params, batch_to_arrays(batch), train=False, teacher_forcing=True)
    got = tm.forward(batch_to_tensors(batch, "cpu"), use_kernels=use_kernels,
                     teacher_forcing=True)
    assert not got.transcript.requires_grad
    for f in ("transcript", "lengths", "segmentation", "segmentation_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)
    for f in ("tokens", "n_steps", "tz_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.n_steps.numpy(), batch.transcript_len + 1)


def test_teacher_forced_fused_eval_matches_jax(slice_setup):
    batch, jm, params, tm = slice_setup
    run = jax_build_fused_eval(jm, True, frame_sampling=FS)
    ref = unpack_eval_wire(
        jax.device_get(run(params, batch_to_arrays(batch))),
        n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
        num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]),
    )
    got = build_fused_eval(tm, teacher_forcing=True, frame_sampling=FS)(
        batch_to_tensors(batch, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("rel_lengths", "vit_score"):
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the decoded transcript is the ground truth's
    np.testing.assert_array_equal(got["n_dec"], batch.transcript_len)
    np.testing.assert_array_equal(got["transcripts"], batch.transcript)


@pytest.mark.parametrize("multi_length", [False, True])
def test_alignment_evaluator_matches_jax(evaluator_setup, multi_length):  # noqa: F811
    cfg, jcfg, db, jdb, jm, params, model = evaluator_setup
    cfg, jcfg = cfg.clone(), jcfg.clone()
    cfg.evaluator.viterbi.multi_length = jcfg.evaluator.viterbi.multi_length = multi_length
    port, ref = MuConAlignmentEvaluator(cfg, db, model), JaxAlignment(jcfg, jdb, jm)
    assert port._fused_backend() == (not multi_length)
    for viterbi in (False, True):
        port.viterbi_mode(viterbi)
        ref.viterbi_mode(viterbi)
        got, want = _fields(port.evaluate()), _fields(ref.evaluate(params))
        assert got.keys() == want.keys() and len(got) == 30
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), (viterbi, k)
        assert got["s_mat_score"] == 1.0 and got["s_len_diff"] == 0.0
        assert model.teacher_forcing is True
    # a free-decoding evaluator turns teacher forcing off again, and an
    # untrained model's own transcripts do not match the ground truth
    free = MuConEvaluator(cfg, db, model)
    assert free.evaluate().s_mat_score < 1.0
    assert model.teacher_forcing is False
    model.set_teacher_forcing(True)


@pytest.mark.parametrize("teacher_forcing", [False, True])
def test_predict_follows_the_forward(slice_setup, teacher_forcing):
    """`predict` outside an evaluator, on a model whose flag is left as
    built (True): it reads how the forward decoded, and equals JAX's
    `predict` with the flag set to match."""
    batch, jm, params, tm = slice_setup
    assert tm.teacher_forcing is True
    got = tm.predict(batch, tm.forward(batch_to_tensors(batch, "cpu"),
                                       teacher_forcing=teacher_forcing))
    jm.set_teacher_forcing(teacher_forcing)
    try:
        want = jm.predict(batch, jm.forward(params, batch_to_arrays(batch), train=False,
                                            teacher_forcing=teacher_forcing))
    finally:
        jm.set_teacher_forcing(True)
    assert len(got) == len(want) == batch.batch_size
    for g, w in zip(got, want):
        assert g.transcript == w.transcript
        np.testing.assert_allclose(g.lengths, w.lengths, **TOL)
        np.testing.assert_allclose(g.segmentation_logits, w.segmentation_logits, **TOL)
    if teacher_forcing:
        for i, g in enumerate(got):
            n = int(batch.transcript_len[i])
            assert g.transcript == [int(x) for x in batch.tf_target[i, : n + 1]]
