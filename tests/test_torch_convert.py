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
    tm = create_model(M, NMAX + 1, D, **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)  # strict: same key set, same shapes
    sd = tm.net.state_dict()
    assert "ft.WaveNetLayer_2.DilatedConv3_0.kernel" in sd
    assert set(sd) == set(params_to_state_dict(params))
    a, b = _flatten(params), _flatten(state_dict_to_params(sd))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_imports_no_jax_or_flax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mucon_tpu_torch\n"
        "for m in pkgutil.walk_packages(mucon_tpu_torch.__path__, 'mucon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')]\n"
        "assert not bad, bad\n"
        "for m in ('cli.predict', 'harness.trainer', 'harness.optim', 'models.losses',\n"
        "          'models.masks', 'ops.wavenet_stack_train'):\n"
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
