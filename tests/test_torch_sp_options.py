"""PyTorch port: the seq / model mesh's step options, each on gloo ranks
(`tests/torch_mesh_worker.py`) against the same steps on one rank
(`torch_mesh_worker.run_case` with no mesh) from the same weights:

* gradient accumulation (k = 2, two micro-batches an apply) on (1,2,2);
* WaveNet's 0.25 dropouts on (1,2,2): each layer's mask the one-rank
  run's, sliced to the rank's block and columns;
* the three clip modes (`trainer.clip_grad_norm_separate`, `_every_param`,
  neither) on (1,1,2), clipping at a norm of 1e-3 so every step clips:
  the encoder group mixes the split backbone with replicated leaves, and
  its norm before the clip equals the one-rank norm;
* the fully supervised regime on (1,2,1) (`gt_label` is split over "seq"
  and gathered for the replicated loss).

Loss terms within rel = 2e-4, parameters by `tests/test_torch_train.py`'s
TOL.  And the rules the mesh keeps: T_pad a multiple of 2^(pools) * seq,
and `tpu.mesh.multihost` with "model" above 1 over several processes
refused as the JAX package refuses it.
"""

import numpy as np
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.config.support import check_supported
from mucon_tpu_torch.models.model import batch_to_host_tensors, create_model
from mucon_tpu_torch.parallel.sharded_ft import check_time_split
from tests.test_model import NMAX
from tests.test_torch_sp_step import case_job, check_losses, check_params, sp_cfg, sp_samples
from tests.torch_mesh_worker import run_case, spawn_ranks

torch.set_num_threads(1)
STEPS = 2


def _weights(cfg):
    """JAX-free weights: the port's init of the config's model."""
    from mucon_tpu_torch.convert import state_dict_to_params
    from mucon_tpu_torch.models.model import model_fields_from_cfg
    from tests.test_model import D, M

    tm = create_model(M, NMAX + 1, D, device="cpu", seed=3, **model_fields_from_cfg(cfg))
    return state_dict_to_params(tm.net.state_dict())


def _check(results, refs, names):
    for name in names:
        for r in results:
            check_losses(r[name]["losses"], refs[name]["losses"], 2e-4, name)
        check_params(results[0][name]["state_dict"], refs[name]["state_dict"], name)


def _run(shape, cases, tmp_path):
    results = spawn_ranks("sp_step", int(np.prod(shape)), tmp_path,
                          dict(shape=shape, cases=cases))
    refs = {c["name"]: run_case(c, None) for c in cases}
    return results, refs


def test_accumulation_and_dropout_on_seq_and_model(tmp_path):
    batch = collate_padded(sp_samples(), n_max=NMAX, pad_multiple=16)
    samples = sp_samples()
    micro = [batch_to_host_tensors(collate_padded([samples[i] for i in pair], n_max=NMAX,
                                                  pad_multiple=16)) for pair in ((2, 1), (0, 3))]
    assert micro[0]["feats"].shape[1] != micro[1]["feats"].shape[1]
    cfg = sp_cfg("wavenet")
    drop = sp_cfg("wavenet")
    drop.model.ft.dropout_rate = drop.model.ft.last_dropout_rate = 0.25
    drop.model.fs.decoder.embedding_dropout = 0.25
    cases = [case_job("accum", cfg, _weights(cfg), tmp_path, k=2, steps=STEPS, micro=micro),
             dict(case_job("dropout", drop, _weights(drop), tmp_path, steps=STEPS,
                           arrays=batch_to_host_tensors(batch)), mask_seed=5)]
    results, refs = _run((1, 2, 2), cases, tmp_path)
    assert len(results[0]["accum"]["losses"]) == 2 * STEPS
    _check(results, refs, ("accum", "dropout"))


@pytest.mark.parametrize("mode", ["separate", "every_param", "global"])
def test_clip_modes_see_whole_leaves(mode, tmp_path):
    batch = batch_to_host_tensors(collate_padded(sp_samples(), n_max=NMAX, pad_multiple=16))
    cfg = sp_cfg("wavenet")
    cfg.trainer.clip_grad_norm_value = 1e-3
    cfg.trainer.clip_grad_norm_separate = mode == "separate"
    cfg.trainer.clip_grad_norm_every_param = mode == "every_param"
    cases = [case_job(mode, cfg, _weights(cfg), tmp_path, steps=STEPS, arrays=batch,
                      norms=True)]
    results, refs = _run((1, 1, 2), cases, tmp_path)
    _check(results, refs, (mode,))
    for r in results:
        for group, norm in refs[mode]["norms"].items():
            assert r[mode]["norms"][group] == pytest.approx(norm, rel=1e-5), group
    # the clip bites: the encoder group's norm is far above the bound
    assert refs[mode]["norms"]["encode"] > 100 * cfg.trainer.clip_grad_norm_value


def test_supervised_regime_on_seq(tmp_path):
    batch = collate_padded(sp_samples(), n_max=NMAX, pad_multiple=16)
    cfg = sp_cfg("wavenet")
    cases = [dict(case_job("full", cfg, _weights(cfg), tmp_path, steps=STEPS,
                           arrays=batch_to_host_tensors(batch, supervised=True)),
                  supervised=True)]
    results, refs = _run((1, 2, 1), cases, tmp_path)
    assert "classification_loss" in refs["full"]["losses"][0]
    for r in results:
        for got, want in zip(r["full"]["losses"], refs["full"]["losses"]):
            for k in ("classification_loss", "supervised_length_loss"):
                assert got[k] == pytest.approx(want[k], rel=2e-4), k
    _check(results, refs, ("full",))


def test_t_pad_must_split_into_whole_pooled_blocks():
    ft = create_model(6, 9, 12, device="cpu", stages=(1, 2, 4), pooling_layers=(0, 1, 5),
                      hidden_size=8, last_gn_num_groups=4, lstm_hidden_size=8).net.ft
    check_time_split(48, ft, 2)  # 2 pools (layer 5 does not exist): 4 * 2 divides 48
    with pytest.raises(ValueError, match=r"multiple of 2\^\(pooling layers\) \* seq"):
        check_time_split(36, ft, 2)
    with pytest.raises(ValueError, match="= 16"):
        check_time_split(40, ft, 4)


def test_multihost_with_model_axis_refused_over_processes():
    """trainer.py:186-196 mapped: every rank of the port is a process."""
    cfg = get_cfg_defaults()
    cfg.tpu.mesh.enable = True
    cfg.tpu.mesh.model = 2
    check_supported(cfg, world_size=2)  # one node, no multihost: runs
    cfg.tpu.mesh.multihost = True
    check_supported(cfg, world_size=1)
    with pytest.raises(NotImplementedError, match="model-sharded params"):
        check_supported(cfg, world_size=2)
    cfg.tpu.mesh.model, cfg.tpu.mesh.seq = 1, 2
    check_supported(cfg, world_size=2)


@pytest.mark.parametrize("ft_type", ["wavenet", "mstcnpp", "noft"])
def test_param_specs_split_the_jax_leaf_set(ft_type):
    """`param_specs` puts "model" on the last axis of exactly the leaves
    the JAX package's `param_specs` shards (mesh.py:68-87): every leaf
    under `ft`, none of `ft_last_gn` or after.  The port's state dict keys
    are the flax paths joined with dots (`convert.py`)."""
    import jax

    from mucon_tpu.models import create_model as create_jax_model
    from mucon_tpu.parallel.mesh import param_specs as jax_param_specs
    from mucon_tpu_torch.models.model import model_fields_from_cfg
    from mucon_tpu_torch.parallel.mesh import param_specs
    from tests.test_model import D, M

    cfg = sp_cfg(ft_type)
    batch = collate_padded(sp_samples(), n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_param_specs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}
    net = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg)).net
    got = param_specs(net)
    assert got.keys() == want.keys()
    for name, spec in got.items():
        assert ("model" in spec) == ("model" in want[name]) == name.startswith("ft."), name
        if spec:
            assert spec == want[name] and spec[-1] == "model", name
    assert any(spec for spec in got.values())
