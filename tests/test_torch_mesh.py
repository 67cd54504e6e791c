"""PyTorch port: the mesh's data axis (`mucon_tpu_torch/parallel/mesh.py`,
`parallel/multihost.py`) and the loader's `batch_divisor`, against the JAX
package.

`make_mesh` on one rank (a group of one, made in process) and on four gloo
ranks (`tests/torch_mesh_worker.py`); `pad_batch_to_multiple` against the
JAX function; `process_batch_slice` + `shard_batch_arrays_multihost` equal
to `shard_batch_arrays` at world size 1 on the float32 and int8 wires; the
loader's plan with a data axis of 2 against `mucon_tpu.data.
PaddedBatchLoader`; and the configurations the port refuses.
"""

import logging
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mucon_tpu.data import PaddedBatchLoader as JaxLoader
from mucon_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad_batch_to_multiple
from mucon_tpu_torch.cli.common import compose_config, config_arg_parser
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.config.support import check_supported
from mucon_tpu_torch.data import PaddedBatchLoader, collate_padded
from mucon_tpu_torch.models.model import batch_to_host_tensors
from mucon_tpu_torch.parallel import (
    init_distributed,
    is_coordinator,
    make_mesh,
    make_multihost_mesh,
    mesh_from_config,
    mesh_is_data_only,
    pad_batch_to_multiple,
    process_batch_slice,
    shard_batch_arrays,
    shard_batch_arrays_multihost,
)
from mucon_tpu_torch.parallel.mesh import mesh_shape
from mucon_tpu_torch.parallel.multihost import run_mesh
from tests.test_model import NMAX
from tests.test_torch_data import ListDataset, _assert_batches_equal, _samples
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)


@pytest.fixture
def one_rank():
    """A process group of one rank for the test, taken down after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_launch_is_one_process(caplog):
    """Without a launcher's env `init_distributed` makes no group and
    returns (0, 1), logging the single-process line under `auto`; a config
    with `tpu.mesh.enable` alone builds no mesh on one process, so the run
    is the single-card run (trainer.py:172-173)."""
    assert not dist.is_initialized()
    with caplog.at_level(logging.INFO, logger="mucon_tpu_torch.multihost"):
        assert init_distributed() == (0, 1)
        assert not caplog.records
        assert init_distributed(auto=True) == (0, 1)
    assert "running single-process" in caplog.records[0].getMessage()
    assert run_mesh(_mesh_cfg()) is None
    assert not dist.is_initialized() and is_coordinator()


def test_make_mesh_one_rank(one_rank):
    mesh = make_mesh()
    assert mesh_shape(mesh) == {"data": 1, "seq": 1, "model": 1}
    assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    assert mesh_is_data_only(mesh) and tuple(mesh.get_coordinate()) == (0, 0, 0)
    assert mesh_shape(make_mesh(1, 1, 1, device_type="cpu")) == mesh_shape(mesh)
    assert mesh_shape(mesh_from_config(get_cfg_defaults())) == mesh_shape(mesh)
    assert mesh_shape(make_multihost_mesh()) == mesh_shape(mesh)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(2)
    with pytest.raises(ValueError, match="multiple"):
        make_mesh(-1, 2)


def test_make_mesh_four_ranks(tmp_path):
    """(data, seq, model) over 4 gloo ranks: n_data = -1 fills the world,
    each rank's coordinate and rows follow the row-major layout, and a
    shape that does not cover the world raises.  A trainer refuses a batch
    the data axis does not divide; an evaluator of several processes
    refuses the per-batch path and a run without the mesh."""
    shapes = [(-1,), (2, 2), (-1, 2, 1), (1, 4), (4, 1, 1)]
    res = spawn_ranks("mesh", 4, tmp_path, dict(shapes=shapes, root=str(tmp_path / "runs")))
    for r, out in enumerate(res):
        assert out[(-1,)]["shape"] == {"data": 4, "seq": 1, "model": 1}
        assert out[(-1,)]["rows"] == slice(2 * r, 2 * r + 2)
        assert out[(2, 2)]["shape"] == {"data": 2, "seq": 2, "model": 1}
        assert out[(2, 2)]["coord"] == (r // 2, r % 2, 0)
        assert out[(2, 2)]["rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert out[(-1, 2, 1)]["shape"] == out[(2, 2)]["shape"]
        assert out[(1, 4)]["coord"] == (0, r, 0) and out[(1, 4)]["rows"] == slice(0, 8)
        assert out[(4, 1, 1)] == out[(-1,)]
        assert out["multihost"]["shape"] == {"data": 4, "seq": 1, "model": 1}
        assert out["multihost"]["rows"] == slice(2 * r, 2 * r + 2)
        assert "does not cover the 4 ranks" in out["mismatch"]
        assert "tpu.batch_size (6) must be a multiple of the mesh data axis (4)" \
            in out["batch_refused"]
        assert "needs the mesh" in out["eval_without_mesh"]
        assert "fused device backend" in out["eval_per_batch"]


def _host_arrays(n: int, feats_dtype=None) -> dict:
    batch = collate_padded(_samples(n), NMAX, 16)
    return batch_to_host_tensors(batch, supervised=True, feats_dtype=feats_dtype)


@pytest.mark.parametrize("feats_dtype", [None, "int8"])
def test_pad_batch_to_multiple_matches_jax(feats_dtype):
    """Dummy videos of 16 frames and a transcript of one, the rest zeros,
    on every key of either wire; a divisible batch is returned as it is."""
    host = _host_arrays(3, feats_dtype)
    got = pad_batch_to_multiple(host, 4)
    want = jax_pad_batch_to_multiple({k: v.numpy() for k, v in host.items()}, 4)
    assert got.keys() == want.keys() and got["feats"].shape[0] == 4
    for k in got:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["num_frames"][3] == 16 and got["transcript_len"][3] == 1
    assert pad_batch_to_multiple(got, 2) is got


@pytest.mark.parametrize("feats_dtype", [None, "int8"])
def test_multihost_rows_equal_the_mesh_rows_at_world_one(one_rank, feats_dtype):
    """At world size 1 a process's slice is the whole batch, and the
    multihost assembly equals `shard_batch_arrays` bit for bit
    (tests/test_parallel.py:597-616)."""
    host = _host_arrays(8, feats_dtype)
    mesh = make_mesh()
    sl = process_batch_slice(8, mesh)
    assert sl == slice(0, 8)
    a = shard_batch_arrays(mesh, host, "cpu")
    b = shard_batch_arrays_multihost(mesh, {k: v[sl] for k, v in host.items()}, "cpu")
    assert a.keys() == b.keys() == host.keys()
    assert ("feats_scale" in a) == (feats_dtype == "int8")
    for k in a:
        assert a[k].dtype == b[k].dtype == host[k].dtype, k
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], host[k]), k
    with pytest.raises(ValueError, match="disagree"):
        shard_batch_arrays_multihost(mesh, dict(host, num_frames=host["num_frames"][:3]), "cpu")


class _NamedDataset(ListDataset):
    """A `ListDataset` with the `file_names` the cache replay reads."""

    @property
    def file_names(self):
        return [s.video_name for s in self.samples]


@pytest.mark.parametrize("n,fixed", [(11, False), (11, True), (10, True), (10, False)])
def test_loader_batch_divisor_matches_jax(n, fixed):
    """batch_size 4, data axis 2: of 11 videos the remainder batch of 3 is
    dropped, with one warning; of 10 the remainder of 2 is kept.  Two
    epochs give the JAX loader's batches, `__len__` counts the kept ones,
    and `iter_cached_keys` gives the plan an epoch streams."""
    samples = _samples(n)
    kw = dict(batch_size=4, pad_multiple=16, seed=3, prefetch=0, fixed_batches=fixed,
              batch_divisor=2)
    ref = JaxLoader(_NamedDataset(samples, True), **kw)
    got = PaddedBatchLoader(_NamedDataset(samples, True), **kw)
    assert len(got) == len(ref) == (2 if n == 11 else 3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            want, batches = list(ref), list(got)
            assert len(batches) == len(want) == len(got)
            for a, b in zip(batches, want):
                _assert_batches_equal(a, b)
    ours = [w for w in caught if "mesh data axis (2)" in str(w.message)]
    assert len(ours) == (2 if n == 11 else 0)  # one from each loader, once each
    if fixed:
        got.epoch = 1
        keys = list(got.iter_cached_keys())
        got.epoch = 1
        assert keys == [(tuple(b.video_names), b.batch_size) for b in got]
        assert all(size % 2 == 0 for _, size in keys)
    assert len(PaddedBatchLoader(_NamedDataset(samples, True), batch_size=4)) == 3


def _mesh_cfg(**mesh):
    cfg = get_cfg_defaults()
    cfg.tpu.mesh.enable = True
    for k, v in mesh.items():
        cfg.tpu.mesh[k] = v
    return cfg


@pytest.mark.parametrize("axis", ["seq", "model"])
def test_seq_and_model_axes_refused_on_several_ranks(axis):
    """seq or model above 1 on a mesh of 2 ranks runs (the sharded steps,
    `tests/test_torch_sp_step.py`); on one rank it is accepted, as the JAX
    package builds no mesh there.  What stays refused is the JAX package's
    own refusal (trainer.py:186-196): multihost with model > 1 over
    several processes."""
    cfg = _mesh_cfg(**{axis: 2})
    check_supported(cfg, world_size=1)
    check_supported(cfg, world_size=2)
    cfg.tpu.mesh.multihost = True
    if axis == "model":
        with pytest.raises(NotImplementedError, match="model-sharded params"):
            check_supported(cfg, world_size=2)
    else:
        check_supported(cfg, world_size=2)
    check_supported(_mesh_cfg(data=2, multihost=True), world_size=2)


def test_launch_of_several_processes_needs_the_mesh(monkeypatch):
    """A WORLD_SIZE > 1 launch without tpu.mesh.enable or multihost raises
    before any process group is made (cli/common.py:55-61)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = config_arg_parser("t").parse_args(["--set", "system.device", "cpu"])
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        compose_config(args)
    assert not dist.is_initialized()
