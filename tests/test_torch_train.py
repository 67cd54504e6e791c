"""PyTorch port: the train step against the JAX train step.

Three SGD steps of the port's `SimpleTrainer.train_step` (teacher-forced
forward, loss, backward, encoder / decoder clip, SGD with coupled weight
decay) against the JAX step's math (mucon_tpu/harness/trainer.py:397-409:
`jax.grad` of the loss, the optax chain of `create_optimizer`) from the
same weights and batch, with every dropout rate at 0 so that both sides
compute the same function.  On CPU tensors the port runs the plain twins
of its kernels (the decoder through `DecoderChain`, its backward glue
included); JAX runs its XLA path, and in a second case the slice as a
whole: its fused decoder chain and flint loss kernels in interpret mode
(`tpu.use_pallas_decoder`, `tpu.use_pallas_loss`) against the port's
`use_loss_kernel` route.  Also one epoch of `SimpleTrainer.train()` on a
synthetic dataset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.data.synthetic import create_synthetic_dataset
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.harness.trainer import SimpleTrainer, TrainConfig, train_config_from_cfg
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)

STEPS = 3
# f32 on both sides; three updates of a 16-wide model through a 9-step
# decoder, two LSTMs and the mucon masks accumulate ~1e-6 relative
# differences in summation order
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss")


def _cfg(dropout: float):
    cfg = small_cfg()
    cfg.model.ft.stages = [1, 2, 4, 8]
    cfg.model.ft.dropout_rate = dropout
    cfg.model.ft.last_dropout_rate = dropout
    cfg.model.fs.decoder.embedding_dropout = dropout
    return cfg


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(0.0)
    rng = np.random.RandomState(0)
    # unequal T_i and N_i in one padded batch
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    return cfg, jm, params, batch


def _jax_trajectory(cfg, jm, params, batch):
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
        losses.append({k: float(getattr(loss, k)) for k in LOSS_KEYS})
    return losses, params


def _port_trainer(cfg, params, seed=1):
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg),
                      loss_cfg=loss_config_from_cfg(cfg))
    tm.load_jax_params(params)
    return SimpleTrainer(None, tm, train_config_from_cfg(cfg), seed=seed)


def _check_trajectory(cfg, jm, params, batch):
    ref_losses, ref_params = _jax_trajectory(cfg, jm, params, batch)

    trainer = _port_trainer(cfg, params)
    assert trainer.model.draw_masks(trainer.step_generator(), 3, 64) is not None
    arrays = batch_to_tensors(batch, "cpu")
    for step in range(STEPS):
        got = trainer.train_step(arrays)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(got[k]), ref_losses[step][k], **TOL,
                                       err_msg=f"step {step} {k}")
    a = _flatten(jax.device_get(ref_params))
    b = _flatten(state_dict_to_params(trainer.model.net.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)


def test_train_step_trajectory_matches_jax(setup):
    cfg, jm, params, batch = setup
    _check_trajectory(cfg, jm, params, batch)


def test_train_step_trajectory_matches_jax_kernel_route(setup):
    """JAX with the fused decoder chain and flint loss (interpret mode);
    the port with `use_loss_kernel` (routed from `tpu.use_pallas_loss`)."""
    cfg, _, params, batch = setup
    cfg = _cfg(0.0)
    cfg.tpu.use_pallas_decoder = True
    cfg.tpu.use_pallas_loss = True
    assert loss_config_from_cfg(cfg)["use_loss_kernel"]
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    _check_trajectory(cfg, jm, params, batch)


def test_state_dict_tree_feeds_the_jax_optimizer(setup):
    """The port's weights, brought back through the bridge, are a tree of
    the JAX parameters' structure that the JAX optimizer chain updates."""
    cfg, jm, params, batch = setup
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tree = state_dict_to_params(tm.net.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jax.device_get(params))
    tx = create_jax_optimizer(cfg, jm.param_partition(tree))
    state = tx.init(tree)
    grads = jax.tree.map(jnp.ones_like, tree)
    updates, _ = tx.update(grads, state, tree)
    new = optax.apply_updates(tree, updates)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(new)):
        assert np.all(np.asarray(b) < np.asarray(a) + 1e-6)


def test_param_partition_matches_jax(setup):
    cfg, jm, params, _ = setup
    trainer = _port_trainer(cfg, params)
    labels = _flatten(jm.param_partition(params))
    names = {id(p): n for n, p in trainer.model.net.named_parameters()}
    got = {names[id(p)].replace(".", "/"): lab
           for lab, ps in trainer.partition.items() for p in ps}
    assert got == {k: str(v) for k, v in labels.items()}


def test_dropout_masks_are_shared_by_seed(setup):
    """Two trainers with one seed draw the same masks at every step, and
    the masks have the rates' statistics."""
    cfg, _, params, _ = setup
    cfg = _cfg(0.25)
    t1, t2 = _port_trainer(cfg, params), _port_trainer(cfg, params)
    m1 = t1.model.draw_masks(t1.step_generator(), 3, 64)
    m2 = t2.model.draw_masks(t2.step_generator(), 3, 64)
    assert len(m1.stack) == 4 and m1.stack[1].shape == (3, 32, 16)
    assert m1.last.shape == (3, 16, 16) and m1.embedding.shape == (NMAX + 1, 3, 16)
    for a, b in zip([*m1.stack, m1.last, m1.embedding], [*m2.stack, m2.last, m2.embedding]):
        assert torch.equal(a, b)
    vals = torch.cat([m.flatten() for m in m1.stack])
    assert set(vals.unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))}
    assert abs((vals == 0).float().mean().item() - 0.25) < 0.02


def _set(cfg, path, value):
    *parents, leaf = path.split(".")
    node = cfg
    for p in parents:
        node = getattr(node, p)
    setattr(node, leaf, value)


# options that change the reference's run and that the port cannot follow
# yet: each raises from the config node instead of running another model
@pytest.mark.parametrize("path,value,reader", [
    ("trainer.scheduler.name", "plateau", train_config_from_cfg),
    ("tpu.compute_dtype", "bfloat16", model_fields_from_cfg),
    ("model.teacher_forcing", False, model_fields_from_cfg),
])
def test_unported_config_options_raise(path, value, reader):
    cfg = _cfg(0.0)
    reader(cfg)  # the default node reads
    _set(cfg, path, value)
    with pytest.raises(NotImplementedError):
        reader(cfg)


def test_plateau_trainer_config_raises():
    with pytest.raises(NotImplementedError, match="s_mof_nbg"):
        SimpleTrainer(None, create_model(M, NMAX + 1, D, device="cpu",
                                         **model_fields_from_cfg(_cfg(0.0))),
                      TrainConfig(scheduler="plateau"))


def test_train_one_epoch_on_synthetic_data(tmp_path):
    cfg = _cfg(0.25)
    cfg.dataset.name = "synthetic"
    cfg.dataset.root = str(tmp_path / "data")
    syn = cfg.dataset.synthetic
    syn.num_videos, syn.num_classes, syn.feat_dim = 8, M, D
    syn.min_len, syn.max_len = 40, 90
    db = create_synthetic_dataset(cfg, train=True)
    tm = create_model(db.num_actions, db.max_transcript_length + 1, D, device="cpu",
                      **model_fields_from_cfg(cfg), loss_cfg=loss_config_from_cfg(cfg))
    config = TrainConfig(num_epochs=1, batch_size=3, pad_multiple=16, log_every=1)
    trainer = SimpleTrainer(db, tm, config, seed=0)
    before = {k: v.clone() for k, v in tm.net.state_dict().items()}
    trainer.train()
    train_events = [e for e in trainer.events if e["event"] == "train"]
    assert len(train_events) == trainer.iter_num >= 2
    assert trainer.events[-1]["event"] == "epoch"
    for e in trainer.events:
        assert all(np.isfinite(e[k]) for k in LOSS_KEYS), e
    assert trainer.scheduler.epoch == 1
    changed = [k for k, v in tm.net.state_dict().items() if not torch.equal(v, before[k])]
    assert "ft.WaveNetLayer_0.DilatedConv3_0.kernel" in changed
    assert "decoder.lstm_cell.w_hh" in changed or any(k.startswith("decoder") for k in changed)
