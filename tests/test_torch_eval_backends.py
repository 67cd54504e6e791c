"""PyTorch port: the evaluator's per-batch path against mucon_tpu's.

`evaluator.viterbi.backend="host"` (the numpy hypothesis DP, one video at
a time) and `evaluator.viterbi.multi_length=True` (the dense DP on full-T
tables: on CPU tensors the plain twins of the kernel and of the pointer
walk) each give the JAX evaluator's 24 fields with the same setting within
1e-6, Viterbi off and on, and the same per-video Viterbi labels; on the
same model the host backend lies within 2e-3 of the device backend and of
the fused path, as tests/test_e2e.py holds the JAX package's.  The weights'
seed (1) is one whose decode has no near tie and where no video's free
decode emits EOS first: on such a video (seed 2, the seed of
`tests/test_torch_evaluator.py`) the JAX package's per-batch Viterbi
decode raises, and the port decodes it against background alone, one
segment of the whole video, as both packages' fused paths do (ROADMAP
queue 3, F6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.harness.evaluator import MuConEvaluator as JaxEvaluator
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness import evaluator as port_evaluator
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from tests.test_torch_evaluator import _configure, _fields
from tests.test_torch_evaluator import setup as evaluator_setup  # noqa: F401 (a fixture)

torch.set_num_threads(1)
SEED = 1


@pytest.fixture(scope="module")
def seed1(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg, jcfg = _configure(get_cfg_defaults(), root), _configure(jax_defaults(), root)
    db, jdb = handel_dataset(cfg, train=False), jax_dataset(jcfg, train=False)
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(SEED)))
    model = create_model_from_cfg(cfg, db)
    model.load_jax_params(params)
    return cfg, jcfg, db, jdb, jm, params, model


SETTINGS = {"host": dict(backend="host", multi_length=False),
            "multi_length": dict(backend="device", multi_length=True)}


def _with(cfg, backend: str, multi_length: bool):
    cfg = cfg.clone()
    cfg.evaluator.viterbi.backend = backend
    cfg.evaluator.viterbi.multi_length = multi_length
    return cfg


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_per_batch_path_matches_jax(seed1, name):
    cfg, jcfg, db, jdb, jm, params, model = seed1
    port = MuConEvaluator(_with(cfg, **SETTINGS[name]), db, model)
    ref = JaxEvaluator(_with(jcfg, **SETTINGS[name]), jdb, jm)
    assert not port._fused_backend()
    for viterbi in (False, True):
        port.viterbi_mode(viterbi)
        ref.viterbi_mode(viterbi)
        got, want = _fields(port.evaluate()), _fields(ref.evaluate(params))
        assert got.keys() == want.keys() and len(got) == 30
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), (name, viterbi, k)
    # the last pass (Viterbi on) decoded the same labels, video for video
    for a, b in zip(port.to_save["vit_segs"], ref.to_save["vit_segs"]):
        np.testing.assert_array_equal(a, b)
    assert port.to_save["s_transcript"] == [list(t) for t in ref.to_save["s_transcript"]]
    for a, b in zip(port.to_save["s_lens"], ref.to_save["s_lens"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_host_backend_against_device_and_fused(seed1, monkeypatch):
    """The host oracle (float64) against the dense DP (f32, on full-T
    tables) and the fused path (tables from the pre-upsample log-probs):
    within 2e-3; the device backend runs the dense decode once a batch and
    no host decoder, the host backend the reverse, the fused path neither."""
    cfg, _, db, _, _, _, model = seed1
    calls = dict(dense=0, host=0)
    dense, decode = port_evaluator.dense_viterbi_decode_batch, port_evaluator.ViterbiDecoder.decode

    def counted_dense(*a, **k):
        calls["dense"] += 1
        return dense(*a, **k)

    def counted_host(self, *a, **k):
        calls["host"] += 1
        return decode(self, *a, **k)

    monkeypatch.setattr(port_evaluator, "dense_viterbi_decode_batch", counted_dense)
    monkeypatch.setattr(port_evaluator.ViterbiDecoder, "decode", counted_host)
    results = {}
    for name, kw in (("fused", dict(backend="device", multi_length=False)),
                     ("device", dict(backend="device", multi_length=True)),
                     ("host", dict(backend="host", multi_length=False))):
        calls.update(dense=0, host=0)
        ev = MuConEvaluator(_with(cfg, **kw), db, model)
        ev.viterbi_mode(True)
        results[name] = dataclasses.asdict(ev.evaluate())
        batches = len(list(ev.create_dataloader()))
        want = dict(fused=dict(dense=0, host=0), device=dict(dense=batches, host=0),
                    host=dict(dense=0, host=len(db)))[name]
        assert calls == want, name
    for other in ("device", "fused"):
        for k, v in results["host"].items():
            np.testing.assert_allclose(v, results[other][k], atol=2e-3, err_msg=(other, k))


@pytest.mark.parametrize("backend", ["host", "device"])
def test_eos_first_video_decodes_background(evaluator_setup, backend):  # noqa: F811
    """Seed 2's model emits EOS first on a test video: the JAX per-batch
    decode raises on it; the port's decodes it as one background segment,
    and every video's Viterbi labels are the fused path's (which decodes
    such a video against background too), as are the y-head's fields."""
    cfg, jcfg, db, jdb, jm, params, model = evaluator_setup
    kw = dict(backend=backend, multi_length=backend == "device")
    ref = JaxEvaluator(_with(jcfg, **kw), jdb, jm)
    ref.viterbi_mode(True)
    with pytest.raises(ValueError):
        ref.evaluate(params)
    port = MuConEvaluator(_with(cfg, **kw), db, model)
    fused = MuConEvaluator(cfg, db, model)
    results = {}
    for name, ev in (("port", port), ("fused", fused)):
        ev.viterbi_mode(True)
        results[name] = dataclasses.asdict(ev.evaluate())
    empty = [i for i, t in enumerate(port.to_save["s_transcript"]) if not t]
    assert empty, "no video emitted EOS first"
    for i in empty:
        assert not port.to_save["vit_segs"][i].any()  # background (class 0) throughout
    for a, b in zip(port.to_save["vit_segs"], fused.to_save["vit_segs"]):
        np.testing.assert_array_equal(a, b)
    for k, v in results["port"].items():
        if k.startswith(("vit_", "y_")):
            np.testing.assert_allclose(v, results["fused"][k], atol=1e-6, err_msg=k)
