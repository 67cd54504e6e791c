"""PyTorch port: the partitioned gradient clip, the optimizers and the
schedulers against the JAX package's optax chain and schedulers
(mucon_tpu/harness/optim.py) over three updates with the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.config.defaults import get_cfg_defaults
from mucon_tpu.harness import optim as jax_optim
from mucon_tpu_torch.harness.optim import (
    MultiStepScheduler,
    PlateauScheduler,
    clip_grad_norm_partitioned,
    create_optimizer,
)

torch.set_num_threads(1)

SHAPES = {"ft": {"kernel": (6, 4), "bias": (4,)}, "decoder": {"w": (5, 3)}}
LABELS = {"ft": {"kernel": "encode", "bias": "encode"}, "decoder": {"w": "decode"}}
STEPS = 3


def _leaves(tree):
    return [tree["ft"]["kernel"], tree["ft"]["bias"], tree["decoder"]["w"]]


@pytest.mark.parametrize("name,momentum", [("SGD", 0.0), ("SGD", 0.9), ("Adam", 0.0)])
def test_clip_and_update_match_optax(name, momentum):
    cfg = get_cfg_defaults()
    cfg.trainer.optimizer, cfg.trainer.momentum = name, momentum
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), SHAPES,
                          is_leaf=lambda s: isinstance(s, tuple))
    # the encoder group's norm (~300) is clipped to 100, the decoder's is not
    grads = [jax.tree.map(lambda s: (rng.randn(*s) * (60.0 if len(s) == 2 and s[0] == 6
                                                       else 2.0)).astype(np.float32),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(STEPS)]

    tx = jax_optim.create_optimizer(cfg, LABELS)
    state = tx.init(params)
    ref = params
    for g in grads:
        updates, state = tx.update(g, state, ref)
        ref = optax.apply_updates(ref, updates)

    ps = [torch.from_numpy(p.copy()).requires_grad_() for p in _leaves(params)]
    opt = create_optimizer(ps, name, cfg.trainer.learning_rate, momentum,
                           cfg.trainer.weight_decay)
    for g in grads:
        for p, gl in zip(ps, _leaves(g)):
            p.grad = torch.from_numpy(gl.copy())
        norms = clip_grad_norm_partitioned({"encode": ps[:2], "decode": ps[2:]}, 100.0)
        opt.step()
    assert norms["encode"] > 100.0 > norms["decode"]
    for p, r in zip(ps, _leaves(ref)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_schedulers_match_jax():
    steps = [MultiStepScheduler(0.1, [2, 4], 0.5), jax_optim.MultiStepScheduler(0.1, [2, 4], 0.5)]
    plateaus = [PlateauScheduler(0.1, "max", 0.5, 1), jax_optim.PlateauScheduler(0.1, "max", 0.5, 1)]
    for metric in [0.3, 0.2, 0.1, 0.4, 0.4, 0.35, 0.3]:
        for s in steps:
            s.step()
        for s in plateaus:
            s.step(metrics=metric)
        assert steps[0].lr == pytest.approx(steps[1].lr)
        assert plateaus[0].lr == pytest.approx(plateaus[1].lr)
        assert (plateaus[0].best, plateaus[0].num_bad) == (plateaus[1].best, plateaus[1].num_bad)
    assert steps[0].lr == pytest.approx(0.025) and plateaus[0].lr < 0.1
