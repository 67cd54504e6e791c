"""PyTorch port: sequence parallelism at the depths and lengths the JAX
package sells it for, on 2 gloo ranks of the mesh (1,2,1)
(`tests/torch_mesh_worker.py`) against the same step on one rank
(`torch_mesh_worker.run_case` with no mesh), from the same weights:

* the full-depth stack (11 layers, dilations 1-1024, 4 pools) at T = 2048
  (tests/test_parallel.py:481-531): the shifts cover d < T_local,
  d == T_local and d >= T_global;
* a video of 12,188 frames padded to 12,288 (tests/test_parallel.py:534-574),
  which the JAX package trains only with the time axis sharded: finite,
  and equal to one rank.

Loss terms within rel = 2e-4, parameters by `tests/test_torch_train.py`'s
TOL.
"""

import numpy as np
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.models.model import batch_to_host_tensors, create_model, model_fields_from_cfg
from tests.test_model import D, M, NMAX, make_sample, small_cfg
from tests.test_torch_sp_step import case_job, check_losses, check_params
from tests.test_torch_train import _cfg
from tests.torch_mesh_worker import run_case, spawn_ranks

torch.set_num_threads(1)


def _no_dropout(cfg):
    cfg.model.ft.dropout_rate = cfg.model.ft.last_dropout_rate = 0.0
    cfg.model.fs.decoder.embedding_dropout = 0.0
    return cfg


def test_full_depth_and_long_video_on_seq(tmp_path):
    deep = _no_dropout(_cfg(0.0))
    deep.model.ft.stages = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    deep.model.ft.pooling_layers = [1, 2, 4, 8]
    deep.model.ft.hidden_size = 32
    assert deep.model.ft.stages[-1] == 1024
    long = _no_dropout(small_cfg())
    rng = np.random.RandomState(0)
    deep_batch = collate_padded([make_sample(rng, 2048 - 100 * i, 4, f"deep{i}")
                                 for i in range(2)], n_max=NMAX, pad_multiple=2048)
    long_batch = collate_padded([make_sample(rng, 12288 - 100, 4, "long")], n_max=NMAX,
                                pad_multiple=2048)
    assert deep_batch.feats.shape[1] == 2048 and long_batch.feats.shape[1] == 12288
    cases = []
    for name, cfg, batch in (("deep", deep, deep_batch), ("long", long, long_batch)):
        tm = create_model(M, NMAX + 1, D, device="cpu", seed=1, **model_fields_from_cfg(cfg))
        cases.append(case_job(name, cfg, state_dict_to_params(tm.net.state_dict()), tmp_path,
                              steps=1, arrays=batch_to_host_tensors(batch)))
    results = spawn_ranks("sp_step", 2, tmp_path, dict(shape=(1, 2, 1), cases=cases),
                          timeout=400)
    for case in cases:
        ref = run_case(case, None)
        name = case["name"]
        assert all(np.isfinite(v) for v in results[0][name]["losses"][0].values())
        for r in results:
            check_losses(r[name]["losses"], ref["losses"], 2e-4, name)
        check_params(results[0][name]["state_dict"], ref["state_dict"], name)
