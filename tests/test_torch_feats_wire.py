"""PyTorch port: the feature wires (mucon_tpu_torch/models/model.py) against
mucon_tpu's (models/model.py:603-707, harness/trainer.py:148-165).

The int8 quantizer bit for bit (zero frames included), the host tensors of
every wire against the JAX `batch_to_host_arrays` (bfloat16 and float16
bit patterns equal), the dequantized features bit for bit, the eval
forward on the int8 wire against the JAX forward on it, an int8-wire train
step equal bit for bit to a float32 step fed the dequantized features,
`predict_videos` on the int8 wire against the JAX one, and the resolution of `tpu.feats_transfer_dtype` /
`tpu.eval_feats_transfer_dtype`: "auto" is float32 in the port, on a card
config too; a bad value raises the JAX package's ValueError.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.cli.predict import predict_videos as jax_predict_videos
from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import collate_padded
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays, batch_to_host_arrays
from mucon_tpu.models.model import dequantize_feats as jax_dequantize
from mucon_tpu.models.model import quantize_feats_int8 as jax_quantize
from mucon_tpu.models.model import resolve_eval_feats_dtype
from mucon_tpu_torch.cli.predict import predict_videos
from mucon_tpu_torch.config import ConfigNode, get_cfg_defaults
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import (
    batch_to_host_tensors,
    batch_to_tensors,
    create_model,
    dequantize_feats,
    model_fields_from_cfg,
    quantize_feats_int8,
    resolve_feats_dtype,
)
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)

WIRES = ("float32", "float16", "bfloat16", "int8")
JAX_WIRE = {"float32": None, "float16": jnp.float16, "bfloat16": jnp.bfloat16,
            "int8": "int8"}
TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_torch_predict.py's forward tolerance


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(7)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    samples[1].feats[5:9] = 0.0  # all-zero frames: the scale's 1e-12 floor
    samples[0].feats[:, 3] *= 1e3  # one large channel
    return collate_padded(samples, n_max=NMAX, pad_multiple=16)


def _bits(a):
    """The raw bytes of an array or tensor as a numpy array of uints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.element_size() == 2 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def test_quantize_int8_bit_for_bit(batch):
    feats = batch.feats.copy()
    feats[0, 7] = -feats[0, 7]
    q, scale = quantize_feats_int8(feats)
    jq, jscale = jax_quantize(feats)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))
    assert np.all(scale[1, 5:9] == np.float32(1e-12)) and np.all(q[1, 5:9] == 0)
    assert np.abs(q).max() == 127


@pytest.mark.parametrize("wire", WIRES)
def test_wire_tensors_match_jax(batch, wire):
    """The host tensors on each wire hold the JAX wire's bits, and both
    packages' dequantized features are equal bit for bit."""
    cfg = get_cfg_defaults()
    cfg.tpu.feats_transfer_dtype = wire
    host = batch_to_host_tensors(batch, feats_dtype=resolve_feats_dtype(cfg))
    ref = batch_to_host_arrays(batch, feats_dtype=JAX_WIRE[wire])
    assert set(host) == {"feats", "num_frames", "tf_input", "tf_target", "transcript",
                         "transcript_len"} | ({"feats_scale"} if wire == "int8" else set())
    assert host["feats"].dtype == {"float32": torch.float32, "float16": torch.float16,
                                   "bfloat16": torch.bfloat16, "int8": torch.int8}[wire]
    np.testing.assert_array_equal(_bits(host["feats"]), _bits(ref["feats"]))
    if wire == "int8":
        np.testing.assert_array_equal(_bits(host["feats_scale"]), _bits(ref["feats_scale"]))
    for k in ("num_frames", "tf_input", "tf_target", "transcript", "transcript_len"):
        np.testing.assert_array_equal(host[k].numpy(), ref[k])
    got = dequantize_feats(host)
    want = jax_dequantize({k: jnp.asarray(v) for k, v in ref.items()})
    assert "feats_scale" not in got and got["feats"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(got["feats"]),
                                  _bits(np.asarray(want["feats"], np.float32)))


@pytest.fixture(scope="module")
def models(batch):
    cfg = small_cfg()
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    tm = create_model(M, NMAX + 1, D, device="cpu", seed=4, **model_fields_from_cfg(cfg))
    params = state_dict_to_params(tm.net.state_dict())
    return cfg, jm, params, tm


def test_forward_on_the_int8_wire_matches_jax(batch, models):
    _, jm, params, tm = models
    ref = jax.jit(lambda p, a: jm.forward(p, a, train=False, teacher_forcing=False))(
        params, batch_to_arrays(batch, feats_dtype="int8"))
    got = tm.forward(batch_to_tensors(batch, "cpu", feats_dtype="int8"))
    f32 = tm.forward(batch_to_tensors(batch, "cpu"))
    for f in ("transcript", "lengths", "segmentation", "segmentation_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)
    for f in ("tokens", "n_steps", "tz_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # the wire is lossy: the float32 forward's segmentation differs
    assert not torch.equal(got.segmentation, f32.segmentation)


def test_predict_videos_on_the_int8_wire_matches_jax(batch, models):
    """`predict_videos` on the eval wire that `predict.main` resolves from
    `tpu.eval_feats_transfer_dtype`, against the JAX `predict_videos`
    (which reads the same key)."""
    cfg, jm, params, tm = models
    cfg = cfg.clone()
    cfg.tpu.eval_feats_transfer_dtype = "int8"
    cfg.tpu.batch_size, cfg.tpu.pad_multiple = 3, 16
    cfg.evaluator.viterbi.frame_sampling = 10
    pcfg = ConfigNode(cfg.to_dict())
    assert resolve_feats_dtype(pcfg, "eval_feats_transfer_dtype") == "int8"
    db = SimpleNamespace(max_transcript_length=NMAX, sos_token_id=M + 1, eos_token_id=M,
                         action_id_to_name={i: f"action_{i}" for i in range(M)})
    feats = [batch.feats[i, : batch.num_frames[i]] for i in range(3)]
    ref = jax_predict_videos(jm, params, feats, batch.video_names, cfg, db)
    got = predict_videos(tm, feats, batch.video_names, db, frame_sampling=10, batch_size=3,
                         pad_multiple=16, feats_dtype="int8")
    for g, r in zip(got, ref):
        assert g["transcript"] == r["transcript"]
        np.testing.assert_allclose(g["rel_lengths"], r["rel_lengths"], **TOL)
        for k in ("vit_labels", "y_labels"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_int8_train_step_equals_float32_fed_the_dequantized_features(batch, tmp_path):
    """One train step (dropout on, the same masks) on the int8 wire and one
    on float32 features equal to the dequantized ones: the same losses and
    parameters bit for bit."""
    cfg = small_cfg()
    arrays8 = batch_to_tensors(batch, "cpu", feats_dtype="int8")
    arrays32 = dict(arrays8, feats=arrays8["feats"].float() * arrays8["feats_scale"][..., None])
    del arrays32["feats_scale"]
    out, nets = [], []
    for i, arrays in enumerate((arrays8, arrays32)):
        pcfg = ConfigNode(cfg.to_dict())
        pcfg.system.device = "cpu"
        pcfg.trainer.root = str(tmp_path / str(i))
        tm = create_model(M, NMAX + 1, D, device="cpu", seed=3, **model_fields_from_cfg(cfg),
                          loss_cfg=loss_config_from_cfg(cfg))
        trainer = SimpleTrainer(pcfg, "wire", None, tm, seed=1)
        out.append({k: v.item() for k, v in trainer.train_step(arrays).items()})
        nets.append(tm.net.state_dict())
    assert out[0] == out[1]
    for k, v in nets[0].items():
        assert torch.equal(v, nets[1][k]), k


@pytest.mark.parametrize("key", ["feats_transfer_dtype", "eval_feats_transfer_dtype"])
def test_auto_is_float32_on_cpu_and_card_configs(key):
    for device in ("cpu", "cuda"):
        cfg = get_cfg_defaults()
        cfg.system.device = device
        assert cfg.tpu[key] == "auto"
        assert resolve_feats_dtype(cfg, key) is None
        cfg.tpu[key] = "float32"
        assert resolve_feats_dtype(cfg, key) is None


@pytest.mark.parametrize("key", ["feats_transfer_dtype", "eval_feats_transfer_dtype"])
def test_invalid_wire_raises_like_jax(key):
    cfg = get_cfg_defaults()
    cfg.tpu[key] = "float64"
    with pytest.raises(ValueError) as err:
        resolve_feats_dtype(cfg, key)
    want = (f"Invalid tpu.{key} 'float64' "
            "(use 'auto'|'float32'|'float16'|'bfloat16'|'int8')")
    assert str(err.value) == want
    if key == "eval_feats_transfer_dtype":
        ref = jax_defaults()
        ref.tpu[key] = "float64"
        with pytest.raises(ValueError) as jerr:
            resolve_eval_feats_dtype(ref)
        assert str(jerr.value) == want
