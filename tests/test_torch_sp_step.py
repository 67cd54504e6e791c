"""PyTorch port: the train step on meshes with "seq" and "model" axes.

`parallel/mesh.py make_sharded_train_step` on 2 or 4 gloo ranks
(`tests/torch_mesh_worker.py`) of the meshes (data, seq, model) = (1,2,1),
(1,1,2) and (1,2,2) (with a data axis of 2: `tests/test_torch_sp_step_dp.py`),
for the WaveNet and the MS-TCN++
backbones at the widths of `tests/test_torch_train.py` (4 layers, 2
pools, T_pad 64): each rank holds its rows and time block, and with
"model" above 1 its columns of the backbone's leaves
(`parallel/sharded_ft.py`).  Three steps from the same weights:

* every loss term against the JAX single-device step within rel = 2e-4
  (JAX's own bound for a sharded step, tests/test_parallel.py:87-91);
* every parameter, the backbone's columns gathered (`full_state`), by
  `tests/test_torch_train.py`'s TOL against the port's one-rank step;
* the replicated leaves equal bit for bit on every rank, and the
  backbone's columns on every rank of a model column.

The replicas stay equal also where the ranks' gradients differ before the
reduction (as a card's atomic adds make them): each rank scales its
gradients by its own factor, and the leaves still agree bit for bit.

WaveNet runs with every dropout at 0.  The MS-TCN++ stage drops at 0.5
whatever the config says: its masks are the ones the port draws from a
seeded generator (sliced to each rank's block and columns), injected into
the JAX forward with `flax.linen.intercept_methods`; each data rank draws
its rows' masks from the same seed, so with two data ranks the batch's are
one draw repeated.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_host_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.parallel.mesh import is_sharded_leaf, make_sharded_train_step
from tests.test_model import D, M, NMAX, make_sample
from tests.test_torch_train import LOSS_KEYS, TOL, _cfg, port_cfg
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)
STEPS = 3
MASK_SEED = 11
SHAPES = [(1, 2, 1), (1, 1, 2), (1, 2, 2)]  # (2,2,1), (2,1,2): test_torch_sp_step_dp.py
FT_TYPES = ("wavenet", "mstcnpp")


def sp_cfg(ft_type: str):
    cfg = _cfg(0.0)
    cfg.model.ft.type = ft_type
    return cfg


def sp_samples(lengths=((61, 3), (44, 5), (30, 2), (52, 4)), seed=0):
    rng = np.random.RandomState(seed)
    return [make_sample(rng, t, n, f"v{i}") for i, (t, n) in enumerate(lengths)]


def port_model(cfg, params):
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg),
                      loss_cfg=loss_config_from_cfg(cfg))
    tm.load_jax_params(params)
    return tm


def mask_seed(cfg):
    """The seed of the MS-TCN++ stage's masks (its 0.5 dropout); WaveNet
    draws none (every rate 0)."""
    return MASK_SEED if cfg.model.ft.type == "mstcnpp" else None


def port_masks(cfg, params, batch, n_data: int = 1):
    """The stage masks of a step from `mask_seed` (None for WaveNet): each
    of `n_data` data ranks draws them at its [B / n_data x T] from the same
    seed, so the batch's are that draw repeated, as numpy arrays."""
    seed = mask_seed(cfg)
    if seed is None:
        return None
    B, T = batch.feats.shape[:2]
    m = port_model(cfg, params).draw_masks(torch.Generator().manual_seed(seed), B // n_data, T)
    return [np.concatenate([t.numpy()] * n_data) for t in m.stack]


def injected(masks):
    """`intercept_methods` hook that replaces each rate > 0 dropout's
    output, in call order, by its input times the next of `masks`."""
    calls = []

    def hook(next_fun, args, kwargs, context):
        if masks is not None and isinstance(context.module, fnn.Dropout) \
                and context.module.rate > 0:
            calls.append(1)
            return args[0] * jnp.asarray(masks[len(calls) - 1])
        return next_fun(*args, **kwargs)

    return hook


def jax_steps(cfg, jm, params, batch, masks, steps=STEPS):
    """The JAX single-device step (XLA path), `steps` times: the losses and
    the final parameters."""
    arrays = batch_to_arrays(batch)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))

    def loss_fn(p):
        fwd = jm.forward(p, arrays, rng=None, train=True, teacher_forcing=True)
        loss = jm.loss(fwd, arrays, teacher_forcing=True)
        return loss.main, loss

    @jax.jit
    def step(p, opt_state):
        grads, loss = jax.grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    p, opt_state, losses = params, tx.init(params), []
    with fnn.intercept_methods(injected(masks)):
        for _ in range(steps):
            p, opt_state, loss = step(p, opt_state)
            losses.append({k: float(getattr(loss, k)) for k in LOSS_KEYS})
    return losses, p


def port_steps(cfg, params, arrays, tmp_path, steps=STEPS, masks=None):
    """The port's one-rank steps (no mesh) from the JAX weights, the
    MS-TCN++ stage with `masks` (`port_masks`): the losses and the final
    state dict."""
    tm = port_model(cfg, params)
    if masks is not None:
        draw = tm.draw_masks
        tm.draw_masks = lambda gen, B, T: dataclasses.replace(
            draw(gen, B, T), stack=[torch.from_numpy(m) for m in masks])
    tr = port_cfg(cfg, tmp_path).trainer
    opt = create_optimizer(tm.net.parameters(), tr.optimizer, tr.learning_rate, tr.momentum,
                           tr.weight_decay)
    partition = tm.param_partition()
    step = make_sharded_train_step(tm, opt, None, clip=lambda: clip_gradients(tr, partition))
    seed = mask_seed(cfg)
    losses = []
    for _ in range(steps):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        losses.append({k: float(v) for k, v in step(arrays, gen).items()})
    return losses, {n: v.clone() for n, v in tm.net.state_dict().items()}, opt


def case_job(name, cfg, params, tmp_path, **kw):
    tm = port_model(cfg, params)
    return dict(name=name, cfg=port_cfg(cfg, tmp_path).to_dict(), dims=(M, NMAX + 1, D),
                fields=model_fields_from_cfg(cfg), loss_cfg=loss_config_from_cfg(cfg),
                state_dict=tm.net.state_dict(), mask_seed=mask_seed(cfg), **kw)


def check_replicas(results, shape):
    """Replicated leaves equal bit for bit on every rank; the backbone's
    own columns equal on every rank of a model column."""
    for name in results[0]:
        if name == "coord":
            continue
        by_col = {}
        for r in results:
            by_col.setdefault(r["coord"][2], []).append(r[name]["local"])
        first = results[0][name]["local"]
        for r in results[1:]:
            for k, v in r[name]["local"].items():
                if not is_sharded_leaf(k):
                    assert torch.equal(v, first[k]), f"{name} {k} differs across ranks"
        for col in by_col.values():
            for sd in col[1:]:
                assert all(torch.equal(sd[k], col[0][k]) for k in sd), name
        # each rank holds 1 / n_model of a backbone leaf's columns
        assert first["ft.Conv1x1_0.bias"].shape[0] * shape[2] == \
            results[0][name]["state_dict"]["ft.Conv1x1_0.bias"].shape[0]


def check_losses(got, want, rel, what):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in LOSS_KEYS:
            assert g[k] == pytest.approx(w[k], rel=rel), f"{what} step {step} {k}"


def check_params(got_sd, want_sd, what):
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), **TOL,
                                   err_msg=f"{what} {k}")


def make_refs(tmp, n_data: int) -> tuple:
    """Per backbone: the JAX config, weights, batch, the JAX single-device
    losses and the port's one-rank losses and state, the MS-TCN++ masks
    those of `n_data` data ranks."""
    batch = collate_padded(sp_samples(), n_max=NMAX, pad_multiple=16)
    out = {}
    for ft_type in FT_TYPES:
        cfg = sp_cfg(ft_type)
        jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                              input_feature_size=D)
        params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
        masks = port_masks(cfg, params, batch, n_data)
        jax_losses, _ = jax_steps(cfg, jm, params, batch, masks)
        losses, state, _ = port_steps(cfg, params, batch_to_host_tensors(batch), tmp,
                                      masks=masks)
        out[ft_type] = dict(cfg=cfg, jm=jm, params=params, jax_losses=jax_losses,
                            port_losses=losses, port_state=state)
    return batch, out


def run_shape(refs, shape, tmp_path):
    """The mesh's steps for both backbones against the references."""
    batch, ref = refs
    arrays = batch_to_host_tensors(batch)
    cases = [case_job(t, ref[t]["cfg"], ref[t]["params"], tmp_path, steps=STEPS,
                      arrays=arrays) for t in FT_TYPES]
    results = spawn_ranks("sp_step", int(np.prod(shape)), tmp_path,
                          dict(shape=shape, cases=cases))
    check_replicas(results, shape)
    for t in FT_TYPES:
        for r in results:
            check_losses(r[t]["losses"], ref[t]["jax_losses"], 2e-4, f"{t} vs JAX")
            check_losses(r[t]["losses"], ref[t]["port_losses"], 2e-4, f"{t} vs one rank")
        check_params(results[0][t]["state_dict"], ref[t]["port_state"], t)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return make_refs(tmp_path_factory.mktemp("sp_refs"), n_data=1)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_sp_train_step_matches_single_device(refs, shape, tmp_path):
    run_shape(refs, shape, tmp_path)


def test_sp_replicas_stay_equal_when_rank_gradients_differ(refs, tmp_path):
    """Each rank of (1,2,2) scales its gradients by 1 + 1e-3 * rank before
    `apply_gradients`: the replicated leaves and each model column's
    backbone leaves are still equal bit for bit on every rank after three
    steps, and within TOL of the one-rank step."""
    batch, ref = refs
    r = ref["wavenet"]
    shape = (1, 2, 2)
    case = case_job("wavenet", r["cfg"], r["params"], tmp_path, steps=STEPS,
                    arrays=batch_to_host_tensors(batch), jitter=1e-3)
    results = spawn_ranks("sp_step", int(np.prod(shape)), tmp_path,
                          dict(shape=shape, cases=[case]))
    check_replicas(results, shape)
    for res in results:
        check_losses(res["wavenet"]["losses"], r["port_losses"], 2e-4, "jittered vs one rank")
