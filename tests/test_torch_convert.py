"""PyTorch port: weight bridge, import hygiene, no silent CPU fallback."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch import cuda
from mucon_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
from tests.test_model import D, M, NMAX, small_cfg

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


def test_jax_params_round_trip_exactly():
    cfg = small_cfg()
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0)))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)  # strict: same key set, same shapes
    sd = tm.net.state_dict()
    assert "ft.WaveNetLayer_2.DilatedConv3_0.kernel" in sd
    assert set(sd) == set(params_to_state_dict(params))
    a, b = _flatten(params), _flatten(state_dict_to_params(sd))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ft_type,key", [
    ("mstcnpp", "ft.DilatedConv3_5.kernel"),  # layer 2's d2 conv
    ("noft", "ft.Conv1x1_0.kernel"),
])
def test_jax_params_round_trip_exactly_other_backbones(ft_type, key):
    cfg = small_cfg()
    cfg.model.ft.type = ft_type
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(1)))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    sd = tm.net.state_dict()
    assert key in sd and set(sd) == set(params_to_state_dict(params))
    a, b = _flatten(params), _flatten(state_dict_to_params(sd))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_imports_no_jax_or_flax():
    """Importing every module of the port (and chip_smoke.py) in a fresh
    process pulls in no jax, flax or mucon_tpu, and no yaml or msgpack:
    those two are imported only where a yaml or flax file is read."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mucon_tpu_torch\n"
        "for m in pkgutil.walk_packages(mucon_tpu_torch.__path__, 'mucon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'mucon_tpu', 'yaml', 'msgpack')]\n"
        "assert not bad, bad\n"
        "for m in ('cli.predict', 'harness.trainer', 'harness.optim', 'models.losses',\n"
        "          'models.masks', 'ops.wavenet_stack_train', 'ops.decoder_chain',\n"
        "          'ops.mucon_loss', 'data.batching', 'ops.mstcnpp_stack',\n"
        "          'ops.wavenet_stack_train_v2', 'config.node', 'config.defaults',\n"
        "          'config.support', 'decode.grammar', 'data.general_dataset',\n"
        "          'data.synthetic', 'data.breakfast', 'data.fixture', 'metrics.base',\n"
        "          'metrics.segmentation', 'metrics.transcript', 'metrics.fully_supervised',\n"
        "          'utils.sizing', 'harness.metrics_store', 'harness.logging',\n"
        "          'harness.checkpoint', 'harness.evaluator', 'cli.common',\n"
        "          'cli.train_test_mucon', 'cli.test_mucon', 'cli.train_test_mucon_full',\n"
        "          'cli.train_test_mucon_mixed', 'decode.length_model',\n"
        "          'decode.viterbi_host', 'harness.cache', 'harness.report',\n"
        "          'cli.inspect_run', 'models.routing', 'ops.bf16', 'serving',\n"
        "          'cli.export_model', 'ops.viterbi', 'ops.eval_fused', 'data.utils',\n"
        "          'parallel', 'parallel.mesh', 'parallel.multihost', 'parallel.halo',\n"
        "          'parallel.sharded_ft', 'parallel.transport', 'native'):\n"
        "    assert 'mucon_tpu_torch.' + m in sys.modules, m\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ), timeout=300)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        create_model(M, NMAX + 1, D, device="cuda", **model_fields_from_cfg(small_cfg()))
    # the kernel wrappers take CUDA tensors only; they never run the plain twin
    x = torch.zeros(1, 32, 128)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.bilstm_recurrence(torch.zeros(2, 2, 1, 32), torch.ones(2, 1),
                               torch.zeros(2, 8, 32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.wavenet_stack(x, torch.tensor([32]), *([x] * 6), stages=(1,),
                           pooling_layers=(), pooling_type="max", leaky=False)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()
    assert not (tmp_path / "kernels").exists()


def test_kernel_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """`cuda.build` starts one compiler process per source, links the
    objects into one library, keeps the compiler output as its log and
    removes the objects (a stand-in script plays nvcc)."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "out = args[args.index('-o') + 1]\n"
        "open(out, 'w').write(' '.join(args))\n"
        "print('ptxas info: ' + ('link' if '-shared' in args else args[-1]))\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "kernels")
    lib = cuda.build()
    assert lib.exists() and lib.parent == tmp_path / "kernels"
    link = lib.read_text().split()
    assert link[:2] == ["-shared", "-o"] and len(link) == 3 + len(cuda.SOURCES)
    log = lib.with_suffix(".log").read_text()
    for src in cuda.SOURCES:
        assert src in log
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.with_suffix(".log").name])
    assert cuda.build() == lib  # the same sources hash to the built library


def test_train_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 32, 128)
    w = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.bilstm_train_forward(torch.zeros(2, 2, 1, 32), torch.ones(2, 1), w)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.wavenet_train_forward(x, torch.tensor([32]), *([x] * 6), None, stages=(1,),
                                   pooling_layers=(), pooling_type="max", leaky=False)


def test_create_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        create_model(M, NMAX + 1, D, **model_fields_from_cfg(small_cfg()))


def test_decoder_and_loss_kernel_wrappers_refuse_cpu_tensors():
    S, B, Tz, H = 2, 1, 3, 8
    z = torch.zeros
    chain = (z(S, B, H), z(B, Tz, 2 * H), z(B, Tz, H), torch.ones(B, Tz), z(B, H), z(B, H),
             z(H, H), z(H), z(H), z(H, H), z(2 * H, H), z(H), z(H, 4 * H), z(H, 4 * H),
             z(4 * H))
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.decoder_chain_forward(*chain)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.decoder_chain_backward(*chain[:4], z(S, B, H), z(S, B, H), *chain[6:],
                                    *(z(S, B, H),) * 3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.mucon_flint(z(B, 4), z(B, 4), torch.ones(B, 4), z(B, 16, 5),
                         torch.zeros(B, 4, dtype=torch.long), torch.tensor([2]),
                         torch.tensor([16]))


def test_mstcnpp_and_v2_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 32, 128)
    w3, w, b = torch.zeros(1, 3, 128, 128), torch.zeros(1, 128, 128), torch.zeros(1, 128)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.mstcnpp_stack(x, torch.tensor([32]), w3, b, w3, b, w, w, b, w[0], b[0],
                           pooling_layers=())
    packed = (w3, b, w, b, w[0], b[0])
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.wavenet_train_v2_forward(x, torch.tensor([32]), *packed, None, stages=(1,),
                                      pooling_layers=(), leaky=False, bounds=[(0, 1)])
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.wavenet_train_v2_backward(x, ([x, x], [x]), torch.tensor([32]), w3, w, b, w[0],
                                       None, stages=(1,), pooling_layers=(), leaky=False,
                                       bounds=[(0, 1)])
