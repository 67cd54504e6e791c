"""PyTorch port: the trainer, the fused eval, the checkpoints and the CLI
on meshes with "seq" and "model" axes (tests/test_parallel.py:313-360 and
:410-478 for the JAX package).

Four gloo processes (`tests/torch_mesh_worker.py`, mode ``sp_trainer``)
run `SimpleTrainer` for an epoch of the synthetic set of
`tests/test_torch_multihost.py` (one 8-video batch, every dropout 0):

* on (2,2,1), then the gathered fused eval of a fresh model: the epoch
  loss within 2e-4 relative and the 24 fields within 1e-4 of one process
  without a mesh, the same on every rank;
* on (2,1,2), with SGD momentum so the optimizer has state, a save and a
  restore into a fresh trainer of another init: each rank's columns of
  the parameters and of the momentum equal to the saved bit for bit, the
  whole leaves too, one more epoch trains, and a one-process `test_mucon`
  reads the coordinator's files (whole leaves, as a one-rank run writes);
  then an evaluator handed a fresh whole model splits its columns and
  gives the one process's 24 fields within 1e-4.

And `torchrun --nproc-per-node 2 -m mucon_tpu_torch.cli.train_test_mucon
--set tpu.mesh.seq 2` on the CPU: both ranks log the sharded regime and
print the same 24 fields.
"""

import dataclasses
import json
import math

import pytest
import torch

from mucon_tpu_torch.cli import test_mucon
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from tests.test_torch_multihost import _close, _model, multihost_cfg
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)


def sp_trainer_cfg(data, runs, shape=None, momentum=0.0):
    cfg = multihost_cfg(data, runs, mesh=False)
    cfg.trainer.num_epochs = 1
    cfg.trainer.momentum = momentum
    if shape is not None:
        cfg.tpu.mesh.enable = True
        cfg.tpu.mesh.data, cfg.tpu.mesh.seq, cfg.tpu.mesh.model = shape
    return cfg


def _epoch_losses(t):
    return [json.loads(line)["main"] for line in open(t.run_folder / "events.jsonl")
            if json.loads(line)["kind"] == "epoch"]


def _one_process(cfg):
    """(epoch losses, 24 eval fields of a fresh model of seed + 1) of one
    process without a mesh; writes the shared dataset."""
    train_db, test_db = handel_dataset(cfg, train=True), handel_dataset(cfg, train=False)
    t = SimpleTrainer(cfg, "sp", train_db, _model(cfg, train_db))
    t.train()
    cfg.system.seed += 1
    ev_model = _model(cfg, test_db)
    cfg.system.seed -= 1
    ev = MuConEvaluator(cfg, test_db, ev_model)
    ev.viterbi_mode(True)
    return _epoch_losses(t), dataclasses.asdict(ev.evaluate(ev_model))


def test_trainer_and_fused_eval_on_data_and_seq(tmp_path):
    data = tmp_path / "data"
    losses, fields = _one_process(sp_trainer_cfg(data, tmp_path / "ref"))
    roots = [str(tmp_path / f"runs_p{r}") for r in range(4)]
    job = dict(cfg=sp_trainer_cfg(data, roots[0], (2, 2, 1)).to_dict(), roots=roots,
               what="eval")
    results = spawn_ranks("sp_trainer", 4, tmp_path, job)
    for r in results:
        assert r["losses"] == results[0]["losses"]
        assert r["eval"] == results[0]["eval"]
    assert results[0]["losses"] == pytest.approx(losses, rel=2e-4)
    assert len(results[0]["eval"]) == 24
    _close(results[0]["eval"], fields, 1e-4)


def test_checkpoint_round_trip_of_model_columns(tmp_path):
    data = tmp_path / "data"
    ref = sp_trainer_cfg(data, tmp_path / "ref", momentum=0.9)
    losses, fields = _one_process(ref)
    roots = [str(tmp_path / f"runs_p{r}") for r in range(4)]
    job = dict(cfg=sp_trainer_cfg(data, roots[0], (2, 1, 2), momentum=0.9).to_dict(),
               roots=roots, what="checkpoint")
    results = spawn_ranks("sp_trainer", 4, tmp_path, job)
    width = ref.model.ft.hidden_size
    for r in results:
        assert r["shard"] == width // 2
        assert r["local_equal"] and r["opt_local_equal"] and r["full_equal"]
        assert r["opt_state_keys"] == ["momentum_buffer"]
        assert r["losses"] == pytest.approx(losses, rel=2e-4)
        assert len(r["more"]) == 1 and math.isfinite(r["more"][0])
        assert r["more"] == results[0]["more"]
        assert r["eval_shard"] == width // 2 and r["eval"] == results[0]["eval"]
    _close(results[0]["eval"], fields, 1e-4)
    folder = tmp_path / "runs_p0" / "sp" / "0" / "checkpoints" / "epoch_0"
    saved = torch.load(folder / "model.pt", weights_only=True)
    assert saved["ft.Conv1x1_0.kernel"].shape[-1] == width
    opt = torch.load(folder / "optimizer.pt", weights_only=True)
    assert any(st["momentum_buffer"].shape[-1] == width for st in opt["state"].values())
    for r in range(1, 4):
        assert not (tmp_path / f"runs_p{r}" / "sp" / "0" / "checkpoints").exists()
    result = test_mucon.main(["sp/0/0", "--root", str(tmp_path / "runs_p0")])
    fields = dataclasses.asdict(result)
    assert len(fields) == 24
    assert all(math.isfinite(x) for v in fields.values()
               for x in (v if isinstance(v, tuple) else (v,)))


def test_torchrun_entry_point_on_seq(tmp_path):
    import os
    import subprocess
    import sys

    from tests.torch_mesh_worker import ROOT

    sets = dict(multihost_cfg(tmp_path / "data", tmp_path / "runs").to_dict())
    argv = ["--exp-name", "sp"]
    for key in ("system.device", "dataset.name", "dataset.root", "trainer.root",
                "dataset.synthetic.num_videos", "dataset.synthetic.num_classes",
                "dataset.synthetic.feat_dim", "dataset.synthetic.min_len",
                "dataset.synthetic.max_len", "model.ft.hidden_size",
                "model.ft.last_gn_num_groups", "model.fs.encoder.hidden_size",
                "model.fs.decoder.hidden_size", "tpu.batch_size", "tpu.pad_multiple",
                "evaluator.viterbi.frame_sampling"):
        node = sets
        for part in key.split("."):
            node = node[part]
        argv += ["--set", key, str(node)]
    argv += ["--set", "model.ft.stages", "[1, 2, 4]", "--set", "model.ft.pooling_layers",
             "[0, 1]", "--set", "tpu.mesh.enable", "True", "--set", "tpu.mesh.seq", "2",
             "--set", "trainer.num_epochs", "1"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    # each rank's stdout and stderr to files of its own: two ranks writing
    # to one pipe at once can splice their lines
    logs = tmp_path / "rank_logs"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "--log-dir", str(logs), "--redirects", "3", "-m",
         "mucon_tpu_torch.cli.train_test_mucon", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    outs = sorted(logs.rglob("stdout.log"))
    log = proc.stdout + proc.stderr + "".join(
        f.read_text() for f in sorted(logs.rglob("stderr.log")))
    assert proc.returncode == 0, log[-4000:]
    assert len(outs) == 2, sorted(map(str, logs.rglob("*")))
    results = [line for f in outs for line in f.read_text().splitlines()
               if line.startswith("MuConEvaluatorResult(")]
    assert len(results) == 2 and results[0] == results[1]
    assert log.count("sharded train step: mesh {'data': 1, 'seq': 2, 'model': 1}") == 2
