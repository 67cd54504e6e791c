"""PyTorch port: the train step on meshes with a data axis of 2 and a
"seq" or "model" axis of 2, (data, seq, model) = (2,2,1) and (2,1,2), on 4
gloo ranks, against the JAX single-device step (rel = 2e-4, every loss
term) and the port's one-rank step (TOL, every parameter), as
`tests/test_torch_sp_step.py` holds the meshes with one data rank.  The
MS-TCN++ stage's masks are those of two data ranks drawing from one seed.
And the port's (1,2,2) WaveNet step against the JAX sharded step (GSPMD)
on the same mesh shape of the 8 virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mucon_tpu.parallel.mesh import make_sharded_train_step as jax_make_sharded_train_step
from mucon_tpu.parallel.mesh import shard_batch_arrays as jax_shard_batch_arrays
from mucon_tpu.parallel.mesh import shard_params as jax_shard_params
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.models.model import batch_to_host_tensors
from tests.test_torch_sp_step import STEPS, case_job, check_losses, make_refs, run_shape
from tests.test_torch_train import LOSS_KEYS, TOL, _flatten
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)
SHAPES = [(2, 2, 1), (2, 1, 2)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return make_refs(tmp_path_factory.mktemp("sp_refs_dp"), n_data=2)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_sp_train_step_with_data_axis_matches_single_device(refs, shape, tmp_path):
    run_shape(refs, shape, tmp_path)


def test_sp_step_matches_the_jax_sharded_step(refs, tmp_path):
    """The port's (1,2,2) WaveNet step against JAX `make_sharded_train_step`
    on make_mesh(1, 2, 2) of the virtual devices (GSPMD, model-sharded
    params): three steps' loss terms within rel = 2e-4, the parameters by
    TOL (the backbone's columns gathered on the port's side)."""
    batch, ref = refs
    r = ref["wavenet"]
    cfg, jm, params = r["cfg"], r["jm"], r["params"]
    mesh = jax_make_mesh(1, 2, 2)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    p = jax_shard_params(mesh, jax.tree.map(jnp.array, params))
    opt_state = tx.init(p)
    step = jax_make_sharded_train_step(jm, tx, mesh, teacher_forcing=True)
    arrays = jax_shard_batch_arrays(mesh, batch_to_arrays(batch))
    want = []
    for _ in range(STEPS):
        p, opt_state, loss = step(p, opt_state, jax.random.PRNGKey(1), arrays)
        want.append({k: float(getattr(loss, k)) for k in LOSS_KEYS})

    cases = [case_job("wavenet", cfg, params, tmp_path, steps=STEPS,
                      arrays=batch_to_host_tensors(batch))]
    results = spawn_ranks("sp_step", 4, tmp_path, dict(shape=(1, 2, 2), cases=cases))
    check_losses(results[0]["wavenet"]["losses"], want, 2e-4, "vs the JAX sharded step")
    got = _flatten(state_dict_to_params(results[0]["wavenet"]["state_dict"]))
    ref_p = _flatten(jax.device_get(p))
    assert got.keys() == ref_p.keys()
    for k in ref_p:
        np.testing.assert_allclose(got[k], ref_p[k], **TOL, err_msg=k)
