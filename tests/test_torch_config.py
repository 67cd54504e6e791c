"""PyTorch port: the config tree (mucon_tpu_torch/config) against mucon_tpu's.

The defaults, the `--set` coercion (the port parses scalars without yaml)
and the `config.yaml` round trip in both directions are held to the JAX
package's; the port composes, dumps and reloads with yaml blocked; options
it does not run raise, and TPU-only options are logged once.  The options
it runs are accepted and change what it computes: the host Viterbi backend
and multi-length decoding (the evaluator's per-batch path), the device
batch cache, device prefetch, the feature wires, gradient accumulation,
every clip mode and free-decode training; the compute dtype, the two
matmul-operand knobs and any mix of the kernel flags resolve as the JAX
package resolves them.
"""

import logging
import sys
from types import SimpleNamespace

import pytest
import torch
import yaml

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.config import node as jax_node
from mucon_tpu_torch.config import get_cfg_defaults, update_config
from mucon_tpu_torch.config import node
from mucon_tpu_torch.config import support

# every kind of scalar the defaults and configs/*.yaml hold, and YAML 1.1's
# traps: `1e-5` and `1.0e5` are strings, `010` is octal, `yes` / `Off` bools
SCALARS = ["1", "-3", "+3", "0", "010", "0x1f", "0b11", "1_000", "1:30", "0o7",
           "1.5", ".5", "-2.5", "1.0e-5", "1.0e+5", "1e-5", "1.0e5", "1_0.5", "3:25.5",
           ".inf", "-.inf", "inf", "yes", "No", "on", "Off", "true", "True", "FALSE",
           "null", "~", "NULL", "[1, 2, 4]", "[]", "[0.5, -1, true, abc]", "[[1, 2], [3]]",
           "'a b'", '"c d"', "'it''s'", "abc", "float32", "bfloat16", "auto",
           "/data/root", "synthetic_smoke"]


@pytest.mark.parametrize("text", SCALARS)
def test_parse_scalar_matches_yaml_safe_load(text):
    assert node.parse_scalar(text) == yaml.safe_load(text)
    assert type(node.parse_scalar(text)) is type(yaml.safe_load(text))


def test_parse_scalar_nan():
    assert node.parse_scalar(".nan") != node.parse_scalar(".nan")


def test_defaults_equal_except_device():
    port, ref = get_cfg_defaults().to_dict(), jax_defaults().to_dict()
    assert port["system"].pop("device") == "cuda"
    assert ref["system"].pop("device") == "tpu"
    assert port == ref


# (key, value) overrides through merge_from_list: the coerced leaf is equal
SETS = [("trainer.learning_rate", "0.05"), ("trainer.learning_rate", "1"),
        ("trainer.learning_rate", "1.0e-5"), ("trainer.num_epochs", "2"),
        ("trainer.num_epochs", "010"), ("model.ft.stages", "[1, 2, 4]"),
        ("model.ft.pooling_layers", "[]"), ("tpu.use_pallas", "True"),
        ("tpu.use_pallas", "false"), ("tpu.use_pallas", "auto"), ("tpu.scan_unroll", "8"),
        ("tpu.use_pallas_loss", "yes"), ("tpu.use_pallas_loss", "0"),
        ("tpu.compilation_cache_dir", ""), ("dataset.root", "/tmp/x y"),
        ("dataset.name", "synthetic"), ("system.device", "cpu"),
        ("trainer.clip_grad_norm", "Off"), ("model.loss.mucon.overlap", "0.25")]


@pytest.mark.parametrize("key,value", SETS)
def test_set_coercion_matches_jax(key, value):
    port, ref = get_cfg_defaults(), jax_defaults()
    port.merge_from_list([key, value])
    ref.merge_from_list([key, value])
    a, b = port.to_dict(), ref.to_dict()
    for part in key.split("."):
        a, b = a[part], b[part]
    assert a == b and type(a) is type(b)


@pytest.mark.parametrize("key,value", [("dataset.name", "True"), ("trainer.num_epochs", "abc"),
                                       ("model.ft.stages", "3"), ("trainer.nope", "1")])
def test_bad_set_raises_like_jax(key, value):
    with pytest.raises((TypeError, KeyError)) as ref_err:
        jax_defaults().merge_from_list([key, value])
    with pytest.raises(ref_err.type):
        get_cfg_defaults().merge_from_list([key, value])


def _modified(cfg):
    cfg.trainer.learning_rate = 1e-05
    cfg.trainer.weight_decay = 5e-20
    cfg.trainer.clip_grad_norm_value = 1e22
    cfg.model.ft.stages = [1, 2]
    cfg.dataset.root = 'a "quoted" path with / and ü'
    cfg.tpu.compilation_cache_dir = ""
    cfg.tpu.use_pallas = False
    return cfg


def test_port_config_yaml_reads_back_in_jax(tmp_path):
    port = _modified(get_cfg_defaults())
    path = tmp_path / "config.yaml"
    port.dump_to_file(str(path))
    ref = jax_defaults()
    ref.merge_from_file(str(path))
    assert ref.to_dict() == port.to_dict()
    assert yaml.safe_load(path.read_text()) == port.to_dict()


def test_jax_config_yaml_reads_back_in_port(tmp_path):
    ref = _modified(jax_defaults())
    path = tmp_path / "config.yaml"
    ref.dump_to_file(str(path))
    port = get_cfg_defaults()
    port.merge_from_file(str(path))
    assert port.to_dict() == ref.to_dict()
    assert port.system.device == "tpu"
    assert support.device_from_cfg(_cpu(port)).type == "cpu"


def _cpu(cfg):
    cfg.system.device = "cpu"
    return cfg


def test_compose_dump_reload_without_yaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = update_config(get_cfg_defaults(), (), ["trainer.learning_rate", "1.0e-5",
                                                 "model.ft.stages", "[1, 2, 4]"])
    assert cfg.is_frozen() and cfg.trainer.learning_rate == 1e-5
    path = tmp_path / "config.yaml"
    cfg.clone().dump_to_file(str(path))
    again = update_config(get_cfg_defaults(), [str(path)])
    assert again.to_dict() == cfg.to_dict()
    (tmp_path / "block.yaml").write_text("trainer:\n  num_epochs: 3\n")
    with pytest.raises(ImportError):  # a block-style file needs pyyaml, imported lazily
        get_cfg_defaults().merge_from_file(str(tmp_path / "block.yaml"))


def _set_key(cfg, key, value):
    *parents, leaf = key.split(".")
    node_ = cfg
    for p in parents:
        node_ = node_[p]
    node_[leaf] = value


@pytest.mark.parametrize("key,value", [
    # multihost runs data-parallel; with a model axis over 2 ranks it raises
    ("tpu.mesh.multihost", True),
    ("model.name", "mucon_v2"),  # another model is not ported
])
def test_unported_keys_raise(key, value):
    cfg = get_cfg_defaults()
    support.check_supported(cfg)
    _set_key(cfg, key, value)
    world = 1
    if key == "tpu.mesh.multihost":
        support.check_supported(cfg, world_size=2)
        cfg.tpu.mesh.enable, cfg.tpu.mesh.model, world = True, 2, 2
        support.check_supported(cfg, world_size=1)
    with pytest.raises(NotImplementedError):
        support.check_supported(cfg, world_size=world)


def _jax_resolution(key, cfg):
    """What the JAX package reads `key` as: the model's compute dtype, the
    two operand knobs (None for f32), or the decoder chain's flag."""
    import jax.numpy as jnp

    from mucon_tpu.models import create_model as create_jax_model
    from mucon_tpu.models.routing import resolve_pallas_flag

    if key == "tpu.use_pallas_decoder":
        return resolve_pallas_flag(cfg.tpu.use_pallas_decoder)
    jm = create_jax_model(cfg, num_classes=6, max_decoding_steps=9, input_feature_size=12)
    got = {"tpu.compute_dtype": jm.net.dtype, "tpu.kernel_mm_dtype": jm._kernel_mm_dtype(),
           "tpu.in_proj_mm_dtype": jm._in_proj_mm_dtype()}[key]
    return None if got is None else str(jnp.dtype(got))


def _port_resolution(key, cfg):
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
    from mucon_tpu_torch.models.routing import routes_from_cfg

    if key == "tpu.use_pallas_decoder":
        return routes_from_cfg(cfg).decoder
    m = create_model(6, 9, 12, device="cpu", **model_fields_from_cfg(cfg))
    got = {"tpu.compute_dtype": m.net.dtype, "tpu.kernel_mm_dtype": m._kernel_mm_dtype(),
           "tpu.in_proj_mm_dtype": m._in_proj_mm_dtype()}[key]
    return None if got is None else str(got).split(".")[-1]


# each key passes `check_supported` and resolves as the JAX package resolves
# it (a kernel flag off alone leaves the other kernels on)
@pytest.mark.parametrize("key,value", [
    ("tpu.compute_dtype", "bfloat16"),
    ("tpu.kernel_mm_dtype", "bfloat16"), ("tpu.in_proj_mm_dtype", "bfloat16"),
    ("tpu.use_pallas_decoder", False),  # one kernel off, the others on
])
def test_ported_keys_accepted(key, value):
    cfg, jcfg = get_cfg_defaults(), jax_defaults()
    for c in (cfg, jcfg):
        c.model.ft.stages = [1, 2]
        c.model.ft.hidden_size = c.model.fs.encoder.hidden_size = 16
        c.model.fs.decoder.hidden_size = 16
        c.model.ft.last_gn_num_groups = 4
    before = _port_resolution(key, cfg)
    for c in (cfg, jcfg):
        _set_key(c, key, value)
    support.check_supported(cfg)
    after = _port_resolution(key, cfg)
    assert after != before, (key, before, after)
    assert after == _jax_resolution(key, jcfg), key


class _Videos(list):
    """A stand-in train set of 16-frame videos for the trainer's loader."""

    max_transcript_length = 3

    def num_frames(self, i):
        return 16


def _trainer(cfg, root):
    """A port trainer of a tiny CPU model, its run folder under `root`."""
    from tests.test_model import D, M, NMAX

    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.model import create_model

    cfg.system.device = "cpu"
    cfg.trainer.root = str(root)
    model = create_model(M, NMAX + 1, D, device="cpu", stages=(1, 2), hidden_size=16,
                         last_gn_num_groups=4, lstm_hidden_size=16)
    return SimpleTrainer(cfg, "accepted", _Videos([None] * 4), model)


def _batches_made_before_the_first_step(cfg, root):
    trainer = _trainer(cfg, root)
    made = []
    trainer._batch_arrays = lambda batch, stream=None: (made.append(batch), ({}, None))[1]
    next(trainer._prefetched([SimpleNamespace(video_names=(i,)) for i in range(4)]))
    return len(made)


def _clipped(cfg, root):
    """The gradients after `clip_gradients` from gradients of norm 1e3."""
    from mucon_tpu_torch.harness.optim import clip_gradients

    trainer = _trainer(cfg, root)
    g = torch.Generator().manual_seed(0)
    for p in trainer.model.net.parameters():
        p.grad = torch.randn(p.shape, generator=g) * 1e3 / p.numel() ** 0.5
    clip_gradients(cfg.trainer, trainer.partition)
    return [p.grad for p in trainer.model.net.parameters()]


def _per_batch_path(cfg, root):
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator

    ev = MuConEvaluator(cfg, SimpleNamespace(background_class_ids=[0]), None)
    if ev._single_shape():
        return "fused, single shape"
    assert not ev._fused_backend() and ev._eval_pad_to() is None
    return "per batch"


def _eval_wire(cfg, root):
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator

    return MuConEvaluator(cfg, SimpleNamespace(background_class_ids=[0]), None)._feats_dtype


def _teacher_forcing_in_training(cfg, root):
    from mucon_tpu_torch.models.model import model_fields_from_cfg

    model_fields_from_cfg(cfg)
    trainer = _trainer(cfg, root)
    trainer.on_start_epoch(0)
    return trainer.model.teacher_forcing


@pytest.mark.parametrize("key,value,read", [
    ("evaluator.viterbi.backend", "host", _per_batch_path),
    ("evaluator.viterbi.multi_length", True, _per_batch_path),
    ("tpu.cache_batches", True,
     lambda cfg, root: _trainer(cfg, root).create_train_dataloader().fixed_batches),
    ("trainer.accumulate_grad_every", 2,
     lambda cfg, root: _trainer(cfg, root).accumulate_grad_every),
    ("tpu.feats_transfer_dtype", "int8", lambda cfg, root: _trainer(cfg, root)._feats_dtype),
    ("tpu.eval_feats_transfer_dtype", "bfloat16", _eval_wire),
    ("tpu.device_prefetch", 0, _batches_made_before_the_first_step),
    ("trainer.clip_grad_norm_every_param", True, _clipped),
    ("model.teacher_forcing", False, _teacher_forcing_in_training),
])
def test_ported_eval_keys_accepted(key, value, read, tmp_path):
    """Each key passes `check_supported` and changes what the port
    computes: the two eval keys send the evaluator down the per-batch path
    (the fused path's single-shape padding off with it); the others change
    what the trainer or evaluator reads from the config.  With the JAX
    clip order, `clip_grad_norm_every_param` clips each parameter alone
    only once `clip_grad_norm_separate` is off."""
    before = read(get_cfg_defaults(), tmp_path / "default")
    cfg = get_cfg_defaults()
    *parents, leaf = key.split(".")
    node_ = cfg
    for p in parents:
        node_ = node_[p]
    node_[leaf] = value
    support.check_supported(cfg)
    after = read(cfg, tmp_path / "set")
    if key == "trainer.clip_grad_norm_every_param":
        # the separate clip comes first in the JAX order ...
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        cfg.trainer.clip_grad_norm_separate = False
        after = read(cfg, tmp_path / "per_param")
        assert all(float(torch.linalg.vector_norm(g)) <= 100.0 * (1 + 1e-6) for g in after)
        assert not all(torch.equal(a, b) for a, b in zip(after, before))
    else:
        assert after != before, (key, before, after)


def test_tpu_only_keys_are_logged_once(caplog):
    cfg = get_cfg_defaults()
    cfg.tpu.remat = True
    cfg.tpu.scan_unroll = 4
    support._logged.discard("tpu.remat")
    support._logged.discard("tpu.scan_unroll")
    with caplog.at_level(logging.INFO, logger="mucon_tpu_torch.config"):
        support.check_supported(cfg)
        support.check_supported(cfg)
    lines = [r.getMessage() for r in caplog.records]
    assert sum("tpu.remat" in m for m in lines) == 1
    assert sum("tpu.scan_unroll" in m for m in lines) == 1


def test_kernel_flags_and_device():
    """One route a kernel, each flag read as the JAX package reads it
    (model.py:134-169, mucon.py:207-213, evaluator.py:536): the eval stacks
    and the Viterbi DP follow `use_pallas`, the train stack needs it and
    `use_pallas_train`; any mix is accepted."""
    from mucon_tpu_torch.models.routing import KernelRoutes, routes_from_cfg

    cfg = get_cfg_defaults()
    assert routes_from_cfg(cfg) == KernelRoutes.every(True)  # "auto" everywhere
    off = {
        "tpu.use_pallas": dict(stack=False, stack_train=False, viterbi=False),
        "tpu.use_pallas_train": dict(stack_train=False),
        "tpu.use_pallas_lstm": dict(lstm=False),
        "tpu.use_pallas_lstm_train": dict(lstm_train=False),
        "tpu.use_pallas_decoder": dict(decoder=False),
    }
    assert set(off) == set(support.KERNEL_FLAGS)
    for key, want in off.items():
        cfg = get_cfg_defaults()
        _set_key(cfg, key, False)
        support.check_supported(cfg)
        assert routes_from_cfg(cfg) == KernelRoutes(**want), key
    cfg = get_cfg_defaults()
    for k in support.KERNEL_FLAGS:
        cfg.tpu[k.split(".")[1]] = False
    assert routes_from_cfg(cfg) == KernelRoutes.every(False)
    cfg.tpu.use_pallas = "sometimes"
    with pytest.raises(ValueError):
        support.check_supported(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            support.device_from_cfg(get_cfg_defaults())
    assert jax_node._coerce("1.0e-5", 0.01, "k") == node._coerce("1.0e-5", 0.01, "k")
