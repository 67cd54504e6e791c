"""PyTorch port: the fully and mixed supervised regimes against mucon_tpu.

* The two supervised loss terms and `compute_loss` of both variants on the
  same forward outputs (the JAX model's, fed to both), every field within
  1e-6 relative; a mixed batch with no supervised video adds exactly 0.
* The supervised datasets: samples equal to the JAX package's, and the
  mixed subset, drawn from `random.seed(f"{seed}-{count}")`, the same
  videos for several seeds and percentages.
* The weights: a JAX supervised model's tree loads into the port's
  supervised models through `convert.py` unchanged (strict), and comes back
  as the same tree.
* Three SGD steps of `SimpleTrainer.train_step` of each variant against the
  JAX step (`jax.grad` of its loss, its optax chain) from the same weights
  and batch, dropout 0, as `tests/test_torch_train.py` holds the weak one:
  all seven loss terms and every parameter within 1e-4 relative + 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.data.general_dataset import (
    GeneralFullySupervisedDataset as JaxFullDataset,
    GeneralMixedSupervisionDataset as JaxMixedDataset,
)
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models import (
    create_fully_supervised_model as create_jax_full,
    create_mixed_supervision_model as create_jax_mixed,
)
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.data import materialize_synthetic_dataset
from mucon_tpu_torch.data.general_dataset import (
    GeneralFullySupervisedDataset,
    GeneralMixedSupervisionDataset,
)
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.losses import compute_loss, loss_config_from_cfg
from mucon_tpu_torch.models.model import (
    MuConFullySupervisedModel,
    MuConMixedSupervisionModel,
    batch_to_tensors,
    create_model,
    model_fields_from_cfg,
)
from mucon_tpu_torch.models.outputs import MuConForwardOut, MuConFullySupervisedLoss
from tests.test_model import D, M, NMAX
from tests.test_supervised import make_sup_sample
from tests.test_torch_train import _cfg, _flatten, port_cfg

torch.set_num_threads(1)

STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's trajectory bound
KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss",
        "classification_loss", "supervised_length_loss")
VARIANTS = {"full": (create_jax_full, MuConFullySupervisedModel),
            "mixed": (create_jax_mixed, MuConMixedSupervisionModel)}


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(0.0)
    cfg.model.loss.fully_supervised.mul_classification = 0.7
    cfg.model.loss.fully_supervised.mul_supervised_length = 1.3
    rng = np.random.RandomState(0)
    samples = [make_sup_sample(rng, 61, 3, "a", supervised=True),
               make_sup_sample(rng, 44, 5, "b", supervised=False),
               make_sup_sample(rng, 30, 2, "c", supervised=True)]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_full(cfg, num_classes=M, max_decoding_steps=NMAX + 1, input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    return cfg, params, batch


def _port_model(variant, cfg, params):
    tm = create_model(M, NMAX + 1, D, device="cpu", model_cls=VARIANTS[variant][1],
                      loss_cfg=loss_config_from_cfg(cfg), **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    return tm


def _as_port_fwd(fwd) -> MuConForwardOut:
    return MuConForwardOut(**{f.name: torch.as_tensor(np.array(getattr(fwd, f.name)))
                              for f in dataclasses.fields(MuConForwardOut)
                              if f.name != "teacher_forced"}, teacher_forced=True)


@pytest.mark.parametrize("variant,flags", [
    ("full", None), ("mixed", None), ("mixed", (False, False, False)),
    ("mixed", (True, True, True)),
])
def test_supervised_loss_matches_jax(setup, variant, flags):
    cfg, params, batch = setup
    jm = VARIANTS[variant][0](cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                              input_feature_size=D)
    arrays = batch_to_arrays(batch)
    if flags is not None:
        arrays["fully_supervised"] = jnp.array(flags)
    fwd = jm.forward(params, arrays, train=False, teacher_forcing=True)
    ref = jm.loss(fwd, arrays, teacher_forcing=True)

    tm = _port_model(variant, cfg, params)
    t_arrays = batch_to_tensors(batch, "cpu", supervised=True)
    if flags is not None:
        t_arrays["fully_supervised"] = torch.tensor(flags)
    got = tm.loss(_as_port_fwd(fwd), t_arrays)
    assert isinstance(got, MuConFullySupervisedLoss)
    for k in KEYS:
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(ref, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if flags == (False, False, False):  # no supervised video: exactly the weak loss
        weak = compute_loss(tm.loss_cfg, _as_port_fwd(fwd), t_arrays["tf_target"],
                            t_arrays["transcript"], t_arrays["transcript_len"],
                            t_arrays["num_frames"])
        assert torch.equal(got.main, weak.main)
        assert float(got.classification_loss) > 0.0


def test_supervised_models_load_the_jax_tree(setup):
    """The supervised variants have the weak model's parameter tree: a JAX
    supervised model's weights load strictly and come back unchanged."""
    cfg, params, batch = setup
    for variant, cls in (("full", MuConFullySupervisedModel),
                         ("mixed", MuConMixedSupervisionModel)):
        tm = _port_model(variant, cfg, params)
        assert type(tm) is cls and tm.supervised and tm.mixed == (variant == "mixed")
        a, b = _flatten(params), _flatten(state_dict_to_params(tm.net.state_dict()))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_trajectory(variant, cfg, params, batch):
    jm = VARIANTS[variant][0](cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                              input_feature_size=D)
    arrays = batch_to_arrays(batch)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    opt_state = tx.init(params)

    def loss_fn(p):
        fwd = jm.forward(p, arrays, rng=None, train=True, teacher_forcing=True)
        loss = jm.loss(fwd, arrays, teacher_forcing=True)
        return loss.main, loss

    @jax.jit
    def step(params, opt_state):
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state)
        losses.append({k: float(getattr(loss, k)) for k in KEYS})
    return losses, params


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_supervised_train_trajectory_matches_jax(setup, variant, tmp_path):
    cfg, params, batch = setup
    ref_losses, ref_params = _jax_trajectory(variant, cfg, params, batch)
    trainer = SimpleTrainer(port_cfg(cfg, tmp_path), "train", None,
                            _port_model(variant, cfg, params), seed=1)
    arrays = batch_to_tensors(batch, "cpu", supervised=True)
    for step in range(STEPS):
        got = trainer.train_step(arrays)
        assert set(got) == set(KEYS)
        for k in KEYS:
            np.testing.assert_allclose(float(got[k]), ref_losses[step][k], **TOL,
                                       err_msg=f"step {step} {k}")
    a = _flatten(jax.device_get(ref_params))
    b = _flatten(state_dict_to_params(trainer.model.net.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "synthetic"
    materialize_synthetic_dataset(root, num_videos=20, num_classes=5, feat_dim=8,
                                  min_len=40, max_len=90, seed=3, train_fraction=0.75)
    return root


def _cfgs(seed):
    from mucon_tpu.config import get_cfg_defaults as jax_defaults

    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    cfg.system.seed = jcfg.system.seed = seed
    return cfg, jcfg


def test_fully_supervised_dataset_matches_jax(data_root):
    cfg, jcfg = _cfgs(0)
    ours = GeneralFullySupervisedDataset(cfg, data_root, "split1.train", feat_dim=8)
    ref = JaxFullDataset(jcfg, data_root, "split1.train", feat_dim=8)
    assert len(ours) == len(ref) == 15
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.video_name == b.video_name
        for f in ("feats", "gt_label", "transcript", "transcript_tf_input",
                  "transcript_tf_target", "absolute_lengths"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, "absolute_lengths").sum() == len(a.gt_label)


@pytest.mark.parametrize("seed,pct", [(0, 50.0), (1, 50.0), (7, 25.0), (3, 10.0),
                                      (11, 90.0), (0, 0.5)])
def test_mixed_subset_matches_jax(data_root, seed, pct):
    cfg, jcfg = _cfgs(seed)
    ours = GeneralMixedSupervisionDataset(cfg, data_root, pct, "split1.train", feat_dim=8)
    ref = JaxMixedDataset(jcfg, data_root, pct, "split1.train", feat_dim=8)
    assert ours.is_it_supervised == ref.is_it_supervised
    count = max(1, int(round(15 * pct / 100.0)))
    assert sum(ours.is_it_supervised) == ours.number_of_full_supervision_examples == count
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.fully_supervised == b.fully_supervised == ours.is_it_supervised[i]
        np.testing.assert_array_equal(a.absolute_lengths, b.absolute_lengths)
