"""PyTorch port: the config tree (mucon_tpu_torch/config) against mucon_tpu's.

The defaults, the `--set` coercion (the port parses scalars without yaml)
and the `config.yaml` round trip in both directions are held to the JAX
package's; the port composes, dumps and reloads with yaml blocked; options
it does not run raise, and TPU-only options are logged once.
"""

import logging
import sys

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


@pytest.mark.parametrize("key,value", [
    ("tpu.cache_batches", True), ("trainer.accumulate_grad_every", 2),
    ("evaluator.viterbi.backend", "host"), ("evaluator.viterbi.multi_length", True),
    ("tpu.compute_dtype", "bfloat16"), ("tpu.feats_transfer_dtype", "int8"),
    ("tpu.eval_feats_transfer_dtype", "bfloat16"), ("tpu.device_prefetch", 0),
    ("trainer.clip_grad_norm_every_param", True), ("tpu.mesh.multihost", True),
    ("tpu.use_pallas_decoder", False),  # one kernel off, the others on
])
def test_unported_keys_raise(key, value):
    cfg = get_cfg_defaults()
    support.check_supported(cfg)
    *parents, leaf = key.split(".")
    node_ = cfg
    for p in parents:
        node_ = node_[p]
    node_[leaf] = value
    with pytest.raises(NotImplementedError):
        support.check_supported(cfg)


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
    cfg = get_cfg_defaults()
    assert support.use_kernels_from_cfg(cfg) is True
    for k in support.KERNEL_FLAGS:
        cfg.tpu[k.split(".")[1]] = False
    assert support.use_kernels_from_cfg(cfg) is False
    cfg.tpu.use_pallas = True
    with pytest.raises(NotImplementedError):
        support.use_kernels_from_cfg(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            support.device_from_cfg(get_cfg_defaults())
    assert jax_node._coerce("1.0e-5", 0.01, "k") == node._coerce("1.0e-5", 0.01, "k")
