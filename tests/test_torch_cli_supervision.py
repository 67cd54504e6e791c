"""PyTorch port: the fully and mixed supervised entry points end to end on
the CPU, as tests/test_cli_supervision.py drives the JAX package's (a tiny
model on the synthetic dataset, one epoch, the eval and the final Viterbi
eval): `python -m mucon_tpu_torch.cli.train_test_mucon_full`,
`..._mixed`, and `train_test_mucon --supervision full`.  Each prints 24
finite fields and logs the supervised loss terms in its `train` events;
the mixed run trains on the subset its dataset chose (the JAX dataset's).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mucon_tpu_torch.cli import train_test_mucon as train_cli
from mucon_tpu_torch.cli import train_test_mucon_full as full_cli
from mucon_tpu_torch.cli import train_test_mucon_mixed as mixed_cli
from mucon_tpu_torch.harness.evaluator import MuConEvaluatorResult
from tests.test_cli_supervision import _tiny_argv

torch.set_num_threads(1)


def _argv(tmp_path, exp, extra=()):
    return _tiny_argv(tmp_path / "data", tmp_path / "runs", exp,
                      extra=[("system.device", "cpu"), *extra])


def _events(tmp_path, exp, kind):
    lines = open(tmp_path / "runs" / exp / "0" / "events.jsonl")
    return [e for e in map(json.loads, lines) if e["kind"] == kind]


def _check(result, tmp_path, exp):
    assert isinstance(result, MuConEvaluatorResult)
    fields = dataclasses.asdict(result)
    assert len(fields) == 24
    for k, v in fields.items():
        assert np.all(np.isfinite(v)), k
    train = _events(tmp_path, exp, "train")
    assert train, "no train events logged"
    for e in train:
        assert e["classification_loss"] > 0.0 and np.isfinite(e["supervised_length_loss"])
    (final,) = _events(tmp_path, exp, "final_eval")
    assert final["eval_seconds"] > 0
    return train


def test_fully_supervised_cli(tmp_path):
    _check(full_cli.main(_argv(tmp_path, "full_e2e")), tmp_path, "full_e2e")


def test_mixed_supervision_cli(tmp_path, monkeypatch):
    from mucon_tpu.config import get_cfg_defaults as jax_defaults
    from mucon_tpu.data import handel_mixed_supervision_dataset as jax_mixed
    from mucon_tpu_torch.data import general_dataset

    chosen = []
    init = general_dataset.GeneralMixedSupervisionDataset.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        chosen.append(list(self.is_it_supervised))

    monkeypatch.setattr(general_dataset.GeneralMixedSupervisionDataset, "__init__", record)
    extra = [("dataset.mixed.full_supervision_percentage", "50.0")]
    _check(mixed_cli.main(_argv(tmp_path, "mixed_e2e", extra)), tmp_path, "mixed_e2e")

    argv = _argv(tmp_path, "mixed_e2e", extra)  # --exp-name E, then --set KEY VALUE ...
    jcfg = jax_defaults()
    jcfg.merge_from_list([x for k, v in zip(argv[3::3], argv[4::3])
                          if k.startswith("dataset.") for x in (k, v)])
    assert chosen == [jax_mixed(jcfg, train=True).is_it_supervised]
    assert sum(chosen[0]) == round(len(chosen[0]) / 2)

    # against the fully supervised run from the same weights and batches:
    # the same terms at step 0, and a smaller main loss (the first batch
    # holds an unsupervised video, whose supervised terms the gate drops)
    full_cli.main(_argv(tmp_path, "full_ref"))
    mixed, full = _events(tmp_path, "mixed_e2e", "train")[0], \
        _events(tmp_path, "full_ref", "train")[0]
    for k in full:
        if k.endswith("_loss"):
            assert mixed[k] == full[k], k
    assert mixed["main"] < full["main"]


def test_supervision_switch_on_generic_entry(tmp_path):
    """--supervision full on the generic entry point takes the same path."""
    argv = _argv(tmp_path, "switch_e2e") + ["--supervision", "full"]
    _check(train_cli.main(argv), tmp_path, "switch_e2e")
    with pytest.raises(SystemExit):  # the switch is the generic entry point's only
        full_cli.main(_argv(tmp_path, "x") + ["--supervision", "weak"])
