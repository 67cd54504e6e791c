"""PyTorch port: checkpoints (mucon_tpu_torch/harness/checkpoint.py).

* save -> load round trip through `SimpleTrainer`: parameters, SGD
  momentum buffers, the scheduler's state and the counters;
* a crash before the model file's `os.replace` leaves no checkpoint that
  `latest_checkpoint` trusts;
* the async writer snapshots before it returns and its `join()` re-raises;
* a checkpoint written by `mucon_tpu.harness.checkpoint.save_checkpoint`
  from JAX-initialized parameters loads into the port with flax blocked and
  gives the JAX forward (1e-5).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.data import collate_padded as jax_collate
from mucon_tpu.harness.checkpoint import save_checkpoint as jax_save_checkpoint
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness import checkpoint
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_cfg(tmp_path, **over):
    """The port's config at the tests/test_e2e.py size, on the CPU."""
    cfg = get_cfg_defaults()
    sets = dict(dataset__name="synthetic", dataset__root=str(tmp_path / "data"),
                system__device="cpu", trainer__root=str(tmp_path / "runs"),
                trainer__num_epochs=2, trainer__save_every=1, trainer__eval_every=1,
                trainer__momentum=0.9, tpu__batch_size=4, tpu__pad_multiple=64,
                evaluator__viterbi__frame_sampling=10)
    sets.update(over)
    for k, v in sets.items():
        *parents, leaf = k.split("__")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = v
    s = cfg.dataset.synthetic
    s.num_videos, s.num_classes, s.feat_dim, s.min_len, s.max_len = 10, 6, 16, 120, 400
    ft = cfg.model.ft
    ft.stages, ft.pooling_layers, ft.hidden_size, ft.last_gn_num_groups = [1, 2, 4], [0, 1], 16, 4
    cfg.model.fs.encoder.hidden_size = cfg.model.fs.decoder.hidden_size = 16
    return cfg


def _trainer(cfg, exp="ckpt", **kw):
    db = handel_dataset(cfg, train=True)
    return SimpleTrainer(cfg, exp, db, create_model_from_cfg(cfg, db), **kw)


def test_save_load_round_trip(tmp_path):
    cfg = tiny_cfg(tmp_path, trainer__scheduler__step__milestones=[1])
    t1 = _trainer(cfg)
    t1.train()
    assert t1.scheduler.epoch == 2 and t1.scheduler.lr == pytest.approx(1e-3)
    folder = t1.run_folder / "checkpoints" / "epoch_1"
    assert sorted(p.name for p in folder.iterdir()) == [
        "model.pt", "optimizer.pt", "trainer_state.json"]

    t2 = _trainer(cfg, run_number=t1.run_number)
    assert t2.resume_latest() and t2.latest_checkpoint() == (str(t1.run_number), 1)
    assert (t2.epoch_num, t2.iter_num) == (2, t1.iter_num) and t1.iter_num == 4
    assert t2.scheduler.state_dict() == t1.scheduler.state_dict()
    assert t2.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    for (n, a), b in zip(t1.model.net.state_dict().items(), t2.model.net.state_dict().values()):
        assert torch.equal(a, b), n
    s1, s2 = t1.optimizer.state_dict()["state"], t2.optimizer.state_dict()["state"]
    assert s1.keys() == s2.keys() and len(s1) > 0
    for k in s1:
        assert torch.equal(s1[k]["momentum_buffer"], s2[k]["momentum_buffer"])
        assert s1[k]["momentum_buffer"].abs().sum() > 0


def test_crash_before_model_replace_leaves_no_trusted_checkpoint(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path, trainer__num_epochs=1)
    t = _trainer(cfg)
    t.save_training()  # epoch 0, complete
    t.epoch_num = 1
    real = checkpoint.os.replace

    def crash(src, dst):
        if str(dst).endswith(checkpoint.MODEL_FILE):
            raise OSError("crash before the model file is in place")
        real(src, dst)

    monkeypatch.setattr(checkpoint.os, "replace", crash)
    with pytest.raises(OSError, match="crash"):
        t.save_training()
    folder = t.run_folder / "checkpoints" / "epoch_1"
    assert (folder / "optimizer.pt").exists() and (folder / "trainer_state.json").exists()
    assert not (folder / "model.pt").exists()
    assert t.latest_checkpoint() == (str(t.run_number), 0)


def test_async_writer_snapshots_and_reraises(tmp_path, monkeypatch):
    p = torch.nn.Parameter(torch.ones(4))
    snap = checkpoint.snapshot({"w": p, "nested": [{"m": p}], "n": 3})
    assert snap["w"].data_ptr() != p.data_ptr() and snap["n"] == 3
    with torch.no_grad():
        p.add_(1.0)  # the optimizer's next in-place step
    assert torch.equal(snap["w"], torch.ones(4)) and torch.equal(snap["nested"][0]["m"],
                                                                  torch.ones(4))

    writer = checkpoint.save_checkpoint(tmp_path / "ok", {"w": p}, {}, {"epoch_num": 0},
                                        async_write=True)
    writer.join()
    assert torch.equal(torch.load(tmp_path / "ok" / "model.pt")["w"], p.detach())

    def full(obj, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoint.torch, "save", full)
    writer = checkpoint.save_checkpoint(tmp_path / "bad", {"w": p}, {}, {}, async_write=True)
    with pytest.raises(OSError, match="No space"):
        writer.join()
    assert not (tmp_path / "bad" / "model.pt").exists()


def test_jax_checkpoint_loads_without_flax(tmp_path, monkeypatch):
    cfg = small_cfg()
    rng = np.random.RandomState(0)
    batch = jax_collate([make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b")],
                        n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jm.init_params(jax.random.PRNGKey(3), batch)
    folder = checkpoint.checkpoint_folder(tmp_path, "jax_exp", 0, 4)
    jax_save_checkpoint(folder, params, None, {"epoch_num": 4, "iter_num": 9})
    assert (folder / "model.msgpack").exists()

    monkeypatch.setitem(sys.modules, "flax", None)
    monkeypatch.setitem(sys.modules, "flax.serialization", None)
    before = sorted(p.name for p in tmp_path.rglob("*"))
    state = checkpoint.load_params(tmp_path, "jax_exp", 0, 4, "cpu")
    assert sorted(p.name for p in tmp_path.rglob("*")) == before
    with pytest.raises(FileNotFoundError):
        checkpoint.load_params(tmp_path, "jax_exp", 0, 5, "cpu")
    assert not (tmp_path / "jax_exp" / "0" / "checkpoints" / "epoch_5").exists()

    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.net.load_state_dict(state, strict=True)
    ref = jm.forward(params, batch_to_arrays(batch), train=False, teacher_forcing=False)
    got = tm.forward(batch_to_tensors(batch, "cpu"))
    for f in ("transcript", "lengths", "segmentation"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **TOL)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
