"""PyTorch port: the partitioned gradient clip, the optimizers and the
schedulers against the JAX package's optax chain and schedulers
(mucon_tpu/harness/optim.py) over three updates with the same gradients,
and each package's `create_scheduler` stepped on one s_mof_nbg series."""

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
    create_scheduler,
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


# an s_mof_nbg series with rises, ties and falls
SERIES = [0.3, 0.2, 0.2, 0.45, 0.45, 0.44, 0.5, 0.1, 0.1, 0.1, 0.6, 0.2]


@pytest.mark.parametrize("name,mode,patience", [
    ("none", "max", 0), ("step", "max", 0), ("plateau", "max", 0),
    ("plateau", "max", 2), ("plateau", "min", 1),
])
def test_create_scheduler_matches_jax(name, mode, patience):
    """The scheduler that trainer.scheduler names, built from the config by
    each package and stepped as the trainers step it (on the first
    evaluator's s_mof_nbg): the same state (lr, and best and num_bad or the
    epoch) after every step."""
    cfg = get_cfg_defaults()
    cfg.trainer.scheduler.name = name
    cfg.trainer.scheduler.step.milestones = [2, 5]
    p = cfg.trainer.scheduler.plateau
    p.mode, p.patience, p.verbose = mode, patience, False
    port, ref = create_scheduler(cfg), jax_optim.create_scheduler(cfg)
    if name == "none":
        assert port is None and ref is None
        return
    for s in SERIES:
        port.step(metrics=s)
        ref.step(metrics=s)
        assert port.state_dict() == ref.state_dict(), s
    assert port.lr < cfg.trainer.learning_rate
