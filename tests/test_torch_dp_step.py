"""PyTorch port: the data-parallel train step against the JAX mesh step.

`parallel/mesh.py make_sharded_train_step` on 2 gloo ranks
(`tests/torch_mesh_worker.py`), each on its 2 rows of a 4-video batch,
against JAX `make_sharded_train_step(model, tx, make_mesh(2, 1))` on the
8-virtual-device CPU mesh (mesh.py:188-277), from the same weights with
every dropout rate at 0: three steps, every loss term and every parameter
by `tests/test_torch_train.py`'s TOL, the two ranks' parameters equal bit
for bit (accumulation: `tests/test_torch_dp_accum.py`); then
`make_sharded_forward` on the same ranks against the single-process eval
forward of the whole batch.  The port runs
the kernel routes (their plain twins on CPU tensors); JAX runs its XLA
path, the kernels being off on the CPU.  And at world size 1 the sharded
step is `SimpleTrainer.train_step` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mucon_tpu.data import collate_padded
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mucon_tpu.parallel.mesh import make_sharded_train_step as jax_make_sharded_train_step
from mucon_tpu.parallel.mesh import shard_batch_arrays as jax_shard_batch_arrays
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.harness.optim import clip_gradients
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_host_tensors, model_fields_from_cfg
from mucon_tpu_torch.parallel import make_mesh, make_sharded_train_step
from tests.test_model import D, M, NMAX, make_sample
from tests.test_torch_train import LOSS_KEYS, TOL, _cfg, _flatten, _port_trainer, port_cfg
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(0.0)
    rng = np.random.RandomState(0)
    # unequal T_i and N_i; each rank's two rows are padded to the batch's T
    samples = [make_sample(rng, t, n, f"v{i}")
               for i, (t, n) in enumerate([(61, 3), (44, 5), (30, 2), (52, 4)])]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    return cfg, jm, params, samples


def _job(cfg, params, tmp_path, **kw):
    trainer = _port_trainer(cfg, params, tmp_path)
    return dict(cfg=port_cfg(cfg, tmp_path).to_dict(), dims=(M, NMAX + 1, D),
                fields=model_fields_from_cfg(cfg), loss_cfg=loss_config_from_cfg(cfg),
                state_dict=trainer.model.net.state_dict(), **kw)


def _check(results, ref_losses, ref_params):
    assert len(results) == 2
    for r in results:
        assert r["grads_zeroed"]
        assert len(r["losses"]) == len(ref_losses)
        for step, (got, want) in enumerate(zip(r["losses"], ref_losses)):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f"step {step} {k}")
    a, b = results[0]["state_dict"], results[1]["state_dict"]
    assert all(torch.equal(a[k], b[k]) for k in a)  # the replicas stay equal
    want = _flatten(jax.device_get(ref_params))
    got = _flatten(state_dict_to_params(a))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def _loss_dict(loss):
    return {k: float(getattr(loss, k)) for k in LOSS_KEYS}


def test_dp_train_step_matches_jax_mesh_step(setup, tmp_path):
    cfg, jm, params, samples = setup
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    mesh = jax_make_mesh(2, 1)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    p = jax.tree.map(jnp.array, params)
    opt_state = tx.init(p)
    step = jax_make_sharded_train_step(jm, tx, mesh, teacher_forcing=True)
    arrays = jax_shard_batch_arrays(mesh, batch_to_arrays(batch))
    ref_losses = []
    for _ in range(STEPS):
        p, opt_state, loss = step(p, opt_state, jax.random.PRNGKey(1), arrays)
        ref_losses.append(_loss_dict(loss))

    job = _job(cfg, params, tmp_path, k=1, steps=STEPS,
               arrays=batch_to_host_tensors(batch))
    results = spawn_ranks("dp_step", 2, tmp_path, job)
    _check(results, ref_losses, p)

    # make_sharded_forward: each rank's rows, gathered in rank order, are
    # the single-process eval forward of the whole batch
    tm = _port_trainer(cfg, params, tmp_path / "fwd").model
    tm.net.load_state_dict(results[0]["state_dict"])
    with torch.no_grad():
        want = tm.forward(batch_to_host_tensors(batch))
    for r in results:
        got = r["forward"]
        assert got["tokens"].shape[0] == 4
        for k in ("tokens", "n_steps", "tz_lengths"):
            assert torch.equal(got[k], getattr(want, k)), k
        for k in ("lengths", "segmentation"):
            np.testing.assert_allclose(got[k].numpy(), getattr(want, k).numpy(), **TOL,
                                       err_msg=k)


def test_world_one_step_is_the_trainer_step(setup, tmp_path):
    """On a mesh of one rank (a gloo group of one, made in process) the
    sharded step -- all-reduce and loss averaging included -- gives
    `SimpleTrainer.train_step`'s losses and parameters bit for bit."""
    cfg, _, params, samples = setup
    arrays = batch_to_host_tensors(collate_padded(samples, n_max=NMAX, pad_multiple=16))
    plain = _port_trainer(cfg, params, tmp_path / "plain")
    dp = _port_trainer(cfg, params, tmp_path / "dp")
    assert not dist.is_initialized()
    try:
        step = make_sharded_train_step(
            dp.model, dp.optimizer, make_mesh(), use_kernels=dp.use_kernels,
            clip=lambda: clip_gradients(dp.cfg.trainer, dp.partition))
        for _ in range(STEPS):
            a = plain.train_step(arrays)
            b = step(arrays, dp.step_generator())
            assert all(torch.equal(a[k], b[k]) for k in a)
    finally:
        dist.destroy_process_group()
    sa, sb = plain.model.net.state_dict(), dp.model.net.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
