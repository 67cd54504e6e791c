"""PyTorch port: the serving export of the other models a run folder may
hold (`mucon_tpu_torch/serving.py`): an MS-TCN++ model and a model under
`tpu.compute_dtype=bfloat16` (configs/tpu_batched.yaml) export, as the JAX
export refuses neither, and the artifact equals the live program bit for
bit on the same inputs.  Weights are the JAX package's, carried over by
`load_jax_params`.
"""

import pytest
import torch

from tests.test_torch_serving import _batch, _cfg
from tests.test_torch_serving_wires import _export_and_check, _model

torch.set_num_threads(1)


@pytest.mark.parametrize("model_kind", ["mstcnpp", "bf16_compute"])
def test_other_models_export(tmp_path, model_kind):
    """The artifact equals the live program bit for bit, and serves raw
    features."""
    cfg = _cfg()
    if model_kind == "mstcnpp":
        cfg.model.ft.type = "mstcnpp"
    else:
        cfg.tpu.compute_dtype = "bfloat16"
    model = _model(cfg, seed=1)
    served, _, _ = _export_and_check(model, cfg, tmp_path / model_kind, "float32")
    res = served.predict(_batch((100, 128, 33), 7))
    assert [len(r["vit_labels"]) for r in res] == [100, 128, 33]
