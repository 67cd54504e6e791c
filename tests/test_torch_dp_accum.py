"""PyTorch port: gradient accumulation over the mesh against the JAX mesh
grad step.

`parallel/mesh.py make_sharded_grad_step` with k = 2 then
`apply_gradients` on 2 gloo ranks (`tests/torch_mesh_worker.py`) against
JAX `make_sharded_grad_step(model, make_mesh(2, 1), True, 2)`
(mesh.py:280-349) and `tx.update` of the accumulated tree, from the same
weights with dropout 0 (`tests/test_torch_dp_step.py`'s setup): every
micro-step's loss terms and the parameters after each apply by
`tests/test_torch_train.py`'s TOL, the ranks' parameters equal bit for bit.
"""

import jax
import jax.numpy as jnp
import optax
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mucon_tpu.parallel.mesh import make_sharded_grad_step as jax_make_sharded_grad_step
from mucon_tpu.parallel.mesh import shard_batch_arrays as jax_shard_batch_arrays
from mucon_tpu_torch.models.model import batch_to_host_tensors
from tests.test_model import NMAX
from tests.test_torch_dp_step import _check, _job, _loss_dict, setup  # noqa: F401
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)


def test_dp_accumulation_matches_jax_mesh_grad_step(setup, tmp_path):
    """Two applies of two micro-batches (one video a rank each): the port
    all-reduces once an apply, JAX pmeans each micro-step's gradients
    and adds g / k; the same sum in another order."""
    cfg, jm, params, samples = setup
    # one padded length, one JAX compile
    micro = [collate_padded(samples[:2], n_max=NMAX, pad_multiple=64),
             collate_padded(samples[2:], n_max=NMAX, pad_multiple=64)]
    mesh = jax_make_mesh(2, 1)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    p = jax.tree.map(jnp.array, params)
    opt_state = tx.init(p)
    grad_step = jax_make_sharded_grad_step(jm, mesh, True, 2)
    ref_losses = []
    for _ in range(2):
        acc = jax.tree.map(jnp.zeros_like, p)
        for b in micro:
            acc, loss = grad_step(p, acc, jax.random.PRNGKey(1),
                                  jax_shard_batch_arrays(mesh, batch_to_arrays(b)))
            ref_losses.append(_loss_dict(loss))
        updates, opt_state = tx.update(acc, opt_state, p)
        p = optax.apply_updates(p, updates)

    job = _job(cfg, params, tmp_path, k=2, steps=2,
               micro=[batch_to_host_tensors(b) for b in micro])
    _check(spawn_ranks("dp_step", 2, tmp_path, job), ref_losses, p)
