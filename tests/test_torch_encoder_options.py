"""PyTorch port: the encoder options against the JAX package.

A unidirectional LSTM encoder (`model.fs.encoder.bidirectional=False`: its
outputs and final state H wide, the encoder projections, the attention's W1
and the decoder's combine input H wide, mucon.py:301-308, 131-133) and the
last GroupNorm / ReLU each off (`model.ft.last_gn`, `model.ft.last_relu`,
mucon.py:277-282): the eval forward (free and teacher-forced), the fused
eval and a 3-step SGD trajectory against mucon_tpu at f32 on the same
converted weights, on its XLA path and (the forward) on its kernel path in
interpret mode; and a unidirectional bf16 forward (the precision tests'
tolerance).  Two settings the JAX package cannot run fail in the port too:
bf16 compute without the last GroupNorm (the JAX BiLSTM's scan refuses the
bf16 input's state) and unequal encoder / decoder hidden sizes (its init
fails in `DecoderCell`).
"""

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from tests.test_model import D, M, NMAX, make_sample
from tests.test_torch_precision import MODEL_ATOL
from tests.test_torch_train import LOSS_KEYS, STEPS, TOL, _cfg, _flatten, _jax_trajectory, port_cfg

torch.set_num_threads(1)

OPTIONS = {
    "unidirectional": ("model.fs.encoder.bidirectional", False),
    "no_last_gn": ("model.ft.last_gn", False),
    "no_last_relu": ("model.ft.last_relu", False),
}
FLAGS = ("use_pallas", "use_pallas_train", "use_pallas_lstm", "use_pallas_lstm_train",
         "use_pallas_decoder")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _option_cfg(option, kernels=False, compute="float32"):
    cfg = _cfg(0.0)
    for f in FLAGS:
        cfg.tpu[f] = kernels
    cfg.tpu.compute_dtype = compute
    cfg.evaluator.viterbi.frame_sampling = 10
    if option is not None:
        key, value = OPTIONS[option]
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    return collate_padded(samples, n_max=NMAX, pad_multiple=16)


def _models(cfg, batch):
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    tm = create_model(M, NMAX + 1, D, device="cpu", loss_cfg=loss_config_from_cfg(cfg),
                      **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)  # strict: the option's parameter tree is the JAX one
    return jm, params, tm


@pytest.mark.parametrize("kernels", [False, True], ids=["xla", "kernels"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_encoder_option_forward_matches_jax(batch, option, kernels):
    jm, params, tm = _models(_option_cfg(option, kernels), batch)
    if option == "unidirectional":
        assert tm.net.fs_decoder_attention_W1.shape[0] == 16
        assert not hasattr(tm.net.fs_encoder_lstm, "bwd")
    for tf in (False, True):
        ref = jm.forward(params, batch_to_arrays(batch), train=False, teacher_forcing=tf)
        got = tm.forward(batch_to_tensors(batch, "cpu"), use_kernels=kernels,
                         teacher_forcing=tf)
        for k in ("transcript", "lengths", "segmentation", "segmentation_z"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                       **FWD_TOL, err_msg=(tf, k))
        for k in ("tokens", "n_steps", "tz_lengths"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)), err_msg=(tf, k))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_encoder_option_fused_eval_matches_jax(batch, option):
    jm, params, tm = _models(_option_cfg(option), batch)
    run = jax_build_fused_eval(jm, False, frame_sampling=10)
    ref = unpack_eval_wire(jax.device_get(run(params, batch_to_arrays(batch))),
                           n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
                           num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]))
    got = build_fused_eval(tm, frame_sampling=10, use_kernels=False)(
        batch_to_tensors(batch, "cpu"))
    for k in ("tokens", "n_steps", "n_dec", "transcripts", "vit_best_l", "vit_pos",
              "vit_k_valid", "tz_len", "y_argmax_z", "y_argmax"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("rel_lengths", "vit_score"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), **FWD_TOL, err_msg=k)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_encoder_option_trajectory_matches_jax(batch, option, tmp_path):
    """3 SGD steps, tests/test_torch_train.py's tolerance."""
    cfg = _option_cfg(option)
    jm, params, tm = _models(cfg, batch)
    ref_losses, ref_params = _jax_trajectory(cfg, jm, params, batch)
    trainer = SimpleTrainer(port_cfg(cfg, tmp_path), "train", None, tm, seed=1)
    arrays = batch_to_tensors(batch, "cpu")
    for step in range(STEPS):
        got = trainer.train_step(arrays)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(got[k]), ref_losses[step][k], **TOL,
                                       err_msg=f"step {step} {k}")
    a = _flatten(jax.device_get(ref_params))
    b = _flatten(state_dict_to_params(tm.net.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)


@pytest.mark.parametrize("kernels", [False, True], ids=["xla", "kernels"])
def test_unidirectional_bf16_forward_matches_jax(batch, kernels):
    jm, params, tm = _models(_option_cfg("unidirectional", kernels, "bfloat16"), batch)
    ref = jm.forward(params, batch_to_arrays(batch), train=False, teacher_forcing=False)
    got = tm.forward(batch_to_tensors(batch, "cpu"), use_kernels=kernels)
    for k in ("transcript", "lengths", "segmentation"):
        r = np.asarray(getattr(ref, k))
        assert np.abs(getattr(got, k).numpy() - r).max() <= MODEL_ATOL * np.abs(r).max(), k
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_bf16_without_last_gn_fails_like_jax(batch):
    cfg = _option_cfg("no_last_gn", compute="bfloat16")
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    with pytest.raises(TypeError, match="carry"):
        jm.init_params(jax.random.PRNGKey(0), batch)
    with pytest.raises(ValueError, match="last_gn"):
        create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))


def test_unequal_hidden_sizes_fail_like_jax(batch):
    """ROADMAP item 6 once asked for unequal sizes: the JAX model cannot build
    them (DecoderCell's attention_l2, mucon.py:122, reads h0, which has the
    encoder's width, :302)."""
    cfg = _option_cfg(None)
    cfg.model.fs.encoder.hidden_size = 16
    cfg.model.fs.decoder.hidden_size = 8
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    with pytest.raises(TypeError, match="dot_general"):
        jm.init_params(jax.random.PRNGKey(0), batch)
    with pytest.raises(ValueError, match="hidden sizes"):
        model_fields_from_cfg(cfg)
