"""PyTorch port: the trainer's options against mucon_tpu's.

* `trainer.accumulate_grad_every=2`: the port's `SimpleTrainer` and the
  JAX one from the same weights on the same data, 3 batches an epoch (the
  third's partial accumulation dropped at the end of each epoch), the
  same epoch losses and parameters (trainer.py:413-445, 554-602);
* the clip modes (joint, per-parameter, none, and the default separate
  clip) with SGD: the port's update against the JAX optax chain of
  `create_optimizer` on the same gradients, above and below the norm;
* free-decode training (`model.teacher_forcing=False`): the train forward,
  the loss (its mucon target the decoder's argmax, on the plain route and
  on the flint kernel's, interpret mode in JAX) and the gradients against
  `jax.grad` of the JAX forward and loss;
* `TrainerForTFExperiments` turning teacher forcing off at its epoch as
  the JAX one does;
* `model.teacher_forcing False` through `train_test_mucon`: no
  teacher-forced decode in training.

Every dropout rate is 0 where the two packages are compared (they draw
their masks apart).
"""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import collate_padded
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.harness.trainer import SimpleTrainer as JaxTrainer
from mucon_tpu.harness.trainer import TrainerForTFExperiments as JaxTFTrainer
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu_torch.cli import train_test_mucon as train_cli
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import ConfigNode, get_cfg_defaults
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer
from mucon_tpu_torch.harness.trainer import SimpleTrainer, TrainerForTFExperiments
from mucon_tpu_torch.models import mucon as port_mucon
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's step tolerance
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_mstcnpp.py's gradient tolerance
LOSS_KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss")
NO_DROPOUT = [("model.ft.dropout_rate", "0.0"), ("model.ft.last_dropout_rate", "0.0"),
              ("model.fs.decoder.embedding_dropout", "0.0")]


def _sets(data_root, run_root, **extra):
    """6 train videos (3 batches of 2) and 2 test videos, all padded to 192
    frames: one shape, one compile of each JAX program."""
    pairs = [
        ("system.device", "cpu"), ("dataset.name", "synthetic"),
        ("dataset.root", str(data_root)), ("dataset.synthetic.num_videos", "8"),
        ("dataset.synthetic.num_classes", "6"), ("dataset.synthetic.feat_dim", "16"),
        ("dataset.synthetic.min_len", "130"), ("dataset.synthetic.max_len", "190"),
        ("trainer.root", str(run_root)), ("trainer.num_epochs", "2"),
        ("trainer.save_every", "100"), ("trainer.eval_every", "100"),
        ("trainer.learning_rate", "0.05"), ("model.ft.stages", "[1, 2, 4]"),
        ("model.ft.pooling_layers", "[0, 1]"), ("model.ft.hidden_size", "16"),
        ("model.ft.last_gn_num_groups", "4"), ("model.fs.encoder.hidden_size", "16"),
        ("model.fs.decoder.hidden_size", "16"), ("tpu.batch_size", "2"),
        ("tpu.pad_multiple", "64"), ("evaluator.viterbi.frame_sampling", "10"),
    ] + NO_DROPOUT
    return pairs + [(k.replace("__", "."), str(v)) for k, v in extra.items()]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


def _epochs(run):
    return [e for e in map(json.loads, open(run / "events.jsonl")) if e["kind"] == "epoch"]


def _run_both(tmp_path, jax_cls, port_cls, sets, **kwargs):
    """The JAX and the port trainer of one config from the JAX trainer's
    initial weights, each trained; returns both."""
    flat = [x for kv in sets for x in kv]
    jcfg, pcfg = jax_defaults(), get_cfg_defaults()
    for cfg, name in ((jcfg, "jax"), (pcfg, "port")):
        cfg.merge_from_list(flat)
        cfg.trainer.root = str(tmp_path / name)
    jdb = jax_dataset(jcfg, train=True)
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    jt = jax_cls(jcfg, "opt", jdb, jm, device="cpu", **kwargs)
    db = handel_dataset(pcfg, train=True)
    model = create_model_from_cfg(pcfg, db)
    model.load_jax_params(jax.device_get(jt.params))
    pt = port_cls(pcfg, "opt", db, model, **kwargs)
    jt.train()
    pt.train()
    return jt, pt


def _check_same_run(jt, pt, tmp_path):
    want, got = (_epochs(tmp_path / n / "opt" / "0") for n in ("jax", "port"))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], **TRAIN_TOL, err_msg=(a["step"], k))
    assert pt.iter_num == jt.iter_num
    a = _flatten(jax.device_get(jt.params))
    b = _flatten(state_dict_to_params(pt.model.net.state_dict()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], **TRAIN_TOL, err_msg=k)


def test_gradient_accumulation_matches_jax(tmp_path):
    sets = _sets(tmp_path / "data", tmp_path, trainer__accumulate_grad_every=2)
    jt, pt = _run_both(tmp_path, JaxTrainer, SimpleTrainer, sets)
    n = len(pt.create_train_dataloader())
    assert n % 2 == 1  # a partial accumulation ends each epoch
    assert pt.accumulate_grad_every == jt.accumulate_grad_every == 2
    _check_same_run(jt, pt, tmp_path)
    # dropping the partial accumulation: an SGD run that applied it would
    # step n // 2 + 1 times an epoch, and the optimizer counted n // 2
    assert all(p.grad is None for p in pt.model.net.parameters())


@pytest.mark.parametrize("mode", ["separate", "joint", "every_param", "none"])
def test_clip_modes_match_the_optax_chain(mode):
    """One SGD update (momentum 0.9, coupled weight decay) from the same
    weights and gradients, at a gradient norm well above the clip value
    and one below it."""
    cfg = small_cfg()
    cfg.trainer.momentum = 0.9
    cfg.trainer.clip_grad_norm = mode != "none"
    cfg.trainer.clip_grad_norm_separate = mode == "separate"
    cfg.trainer.clip_grad_norm_every_param = mode == "every_param"
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    tm = create_model(M, NMAX + 1, D, device="cpu", seed=2, **model_fields_from_cfg(cfg))
    init = {n: p.detach().clone() for n, p in tm.net.named_parameters()}
    params = state_dict_to_params(init)
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    tr = cfg.trainer
    for scale in (1e3, 1e-2):  # clipped / not
        g = torch.Generator().manual_seed(int(scale * 100))
        grads = {n: torch.randn(p.shape, generator=g) * scale / p.numel() ** 0.5
                 for n, p in tm.net.named_parameters()}
        opt = create_optimizer(tm.net.parameters(), tr.optimizer, tr.learning_rate,
                               tr.momentum, tr.weight_decay)
        for n, p in tm.net.named_parameters():
            p.grad = grads[n].clone()
        clip_gradients(tr, tm.param_partition())
        opt.step()
        jgrads = state_dict_to_params(grads)
        updates, _ = tx.update(jgrads, tx.init(params), params)
        want = _flatten(jax.device_get(optax.apply_updates(params, updates)))
        got = _flatten(state_dict_to_params({n: p.detach() for n, p in
                                             tm.net.named_parameters()}))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=(mode, scale, k))
        with torch.no_grad():  # back to the start for the next scale
            for n, p in tm.net.named_parameters():
                p.copy_(init[n])


@pytest.fixture(scope="module")
def free_setup():
    cfg = small_cfg()
    for k, v in NO_DROPOUT:
        node = cfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = float(v)
    rng = np.random.RandomState(3)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    return cfg, batch


@pytest.mark.parametrize("loss_kernel", [False, True])
def test_free_decode_train_forward_loss_and_gradients_match_jax(free_setup, loss_kernel):
    """`forward(train=True, teacher_forcing=False)`: the decoder's argmax
    tokens, the outputs, the loss terms (the mucon target being those
    tokens, on the flint kernel's route with `loss_kernel`) and every
    parameter's gradient against `jax.grad`."""
    cfg, batch = free_setup
    cfg = cfg.clone()
    cfg.tpu.use_pallas_loss = loss_kernel
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    init = create_model(M, NMAX + 1, D, device="cpu", seed=5, **model_fields_from_cfg(cfg))
    params = state_dict_to_params(init.net.state_dict())
    arrays = batch_to_arrays(batch)

    def loss_fn(p):
        fwd = jm.forward(p, arrays, rng=None, train=True, teacher_forcing=False)
        loss = jm.loss(fwd, arrays, teacher_forcing=False)
        return loss.main, (loss, fwd)

    (_, (ref_loss, ref_fwd)), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    loss_cfg = loss_config_from_cfg(cfg)
    assert loss_cfg["use_loss_kernel"] == loss_kernel
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg),
                      loss_cfg=loss_cfg)
    tm.load_jax_params(jax.device_get(params))
    tm.set_teacher_forcing(False)
    t_arrays = batch_to_tensors(batch, "cpu")
    fwd = tm.forward(t_arrays, train=True)  # the model's flag: free decoding
    assert not fwd.teacher_forced
    np.testing.assert_array_equal(fwd.tokens.numpy(), np.asarray(ref_fwd.tokens))
    np.testing.assert_array_equal(fwd.n_steps.numpy(), np.asarray(ref_fwd.n_steps))
    assert not np.array_equal(fwd.tokens.numpy()[:, :NMAX], batch.transcript)
    for f in ("transcript", "lengths", "segmentation"):
        np.testing.assert_allclose(getattr(fwd, f).detach().numpy(),
                                   np.asarray(getattr(ref_fwd, f)), err_msg=f, **GRAD_TOL)
    loss = tm.loss(fwd, t_arrays)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(getattr(loss, k).item(), float(getattr(ref_loss, k)),
                                   err_msg=k, **GRAD_TOL)
    forced = tm.loss(fwd, t_arrays, teacher_forcing=True)  # the ground truth's target
    assert forced.mucon_loss.item() != loss.mucon_loss.item()
    loss.main.backward()
    a = _flatten(jax.device_get(ref_grads))
    b = _flatten(state_dict_to_params({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                       for n, p in tm.net.named_parameters()}))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **GRAD_TOL)


def test_tf_experiments_trainer_switches_like_jax(tmp_path, monkeypatch):
    """`TrainerForTFExperiments(turnoff_tf_after_epoch=1)`: epoch 0
    teacher-forced, epoch 1 free decoding, in both packages; the same
    epoch losses and parameters."""
    seen = []
    start = SimpleTrainer._train_one_epoch

    def spy(self):
        seen.append(self.model.teacher_forcing)
        return start(self)

    monkeypatch.setattr(SimpleTrainer, "_train_one_epoch", spy)
    # the default learning rate: at 0.05 a ReLU input within rounding of 0
    # in the encoder's third layer took the other side in one package by
    # the second epoch, moving 15 of that layer's 768 weights by 3.5e-5
    sets = _sets(tmp_path / "data", tmp_path, trainer__learning_rate=0.01)
    jt, pt = _run_both(tmp_path, JaxTFTrainer, TrainerForTFExperiments, sets,
                       turnoff_tf_after_epoch=1)
    assert seen == [True, False]
    assert set(jt._step_fns) == {True, False}  # the JAX trainer traced both modes
    _check_same_run(jt, pt, tmp_path)


def test_teacher_forcing_off_through_train_test_mucon(tmp_path, monkeypatch):
    """`--set model.teacher_forcing False`: every train step decodes freely
    (no teacher-forced decode runs in training; the evals decode freely
    anyway), and the run gives 24 finite fields."""
    calls = []
    forced = port_mucon.decoder_teacher_forced

    def spy(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return forced(*args, **kwargs)

    monkeypatch.setattr(port_mucon, "decoder_teacher_forced", spy)
    argv = ["--exp-name", "free"]
    for k, v in _sets(tmp_path / "data", tmp_path / "runs") + [
            ("trainer.num_epochs", "1"), ("trainer.eval_every", "1"),
            ("model.teacher_forcing", "False")]:
        argv += ["--set", k, v]
    result = train_cli.main(argv)
    assert calls == []
    fields = dataclasses.asdict(result)
    assert len(fields) == 24 and all(np.all(np.isfinite(v)) for v in fields.values())
    cfg = ConfigNode(json.loads((tmp_path / "runs" / "free" / "0" / "config.yaml").read_text()))
    assert cfg.model.teacher_forcing is False


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_unused_parameters_step_like_jax(tmp_path, optimizer):
    """The attention's `l3` parameters reach no loss.  The JAX optax chain
    still decays them (and moves Adam's moments) on their zero gradient;
    the port gives them a zero gradient before the update, so that torch's
    optimizer does too (it skips a parameter without a gradient, and they
    kept their initial values)."""
    cfg = small_cfg()
    cfg.trainer.optimizer = optimizer
    cfg.trainer.learning_rate, cfg.trainer.weight_decay = 0.5, 0.1
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    tm = create_model(M, NMAX + 1, D, device="cpu", seed=4, **model_fields_from_cfg(cfg))
    pcfg = ConfigNode(cfg.to_dict())
    pcfg.system.device, pcfg.trainer.root = "cpu", str(tmp_path)
    trainer = SimpleTrainer(pcfg, "unused", None, tm)
    params = state_dict_to_params({n: p.detach().clone() for n, p in tm.net.named_parameters()})
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.zeros_like(p) if "_l3_" in n else torch.randn(p.shape, generator=g)
             for n, p in tm.net.named_parameters()}
    for n, p in tm.net.named_parameters():
        p.grad = None if "_l3_" in n else grads[n].clone()
    trainer._apply()
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    updates, _ = tx.update(state_dict_to_params(grads), tx.init(params), params)
    want = _flatten(jax.device_get(optax.apply_updates(params, updates)))
    got = _flatten(state_dict_to_params(tm.net.state_dict()))
    before = _flatten(params)
    for k in ("fs_decoder_attention_l3_kernel", "fs_decoder_attention_l3_bias"):
        assert not np.allclose(got[k], before[k])
        # tests/test_torch_optim.py's tolerance
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
