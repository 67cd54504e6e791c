"""PyTorch port: the trainer and the evaluator on two processes
(tests/test_parallel.py:810-930 for the JAX package).

Two gloo processes (`tests/torch_mesh_worker.py`, mode ``trainer``), each
with its own `trainer.root`, run `SimpleTrainer` with `tpu.mesh.multihost`
over a shared synthetic dataset for 2 epochs of one 8-video batch (4 rows a
rank), with the gathered fused eval after each epoch; then the gathered
eval of a fresh model of the config's seed (the 3 test videos padded to
the batch size, `tpu.eval_single_shape`, and to a multiple of the data
axis), and a resume from the
coordinator's epoch-1 checkpoint for one more epoch.  Held against one
process of the port without a mesh: the per-epoch losses identical across
ranks and within 2e-4 relative, the eval's 24 fields identical across
ranks and within 1e-4, checkpoints and eval pickles only in the
coordinator's run folder, the resumed losses identical across ranks and
within 2e-4, and the replicas' weights equal.  And a mesh of one rank
(`tpu.mesh.multihost` without a launcher) reproduces the run without a
mesh bit for bit.
"""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)


def multihost_cfg(data_root, run_root, mesh: bool = True):
    """tests/test_parallel.py multihost_trainer_cfg on the port, with a
    data axis of 2 ranks."""
    cfg = get_cfg_defaults()
    cfg.system.device = "cpu"
    cfg.dataset.name = "synthetic"
    cfg.dataset.root = str(data_root)
    # train_fraction .75 -> 8 train videos = one global batch, 3 test videos
    cfg.dataset.synthetic.num_videos = 11
    cfg.dataset.synthetic.num_classes = 6
    cfg.dataset.synthetic.feat_dim = 16
    cfg.dataset.synthetic.min_len = 100
    cfg.dataset.synthetic.max_len = 260
    cfg.trainer.root = str(run_root)
    cfg.trainer.num_epochs = 2
    cfg.trainer.save_every = 1
    cfg.model.ft.stages = [1, 2, 4]
    cfg.model.ft.pooling_layers = [0, 1]
    cfg.model.ft.hidden_size = 16
    cfg.model.ft.last_gn_num_groups = 4
    cfg.model.fs.encoder.hidden_size = 16
    cfg.model.fs.decoder.hidden_size = 16
    cfg.model.ft.dropout_rate = 0.0
    cfg.model.ft.last_dropout_rate = 0.0
    cfg.model.fs.decoder.embedding_dropout = 0.0
    cfg.tpu.batch_size = 8
    cfg.tpu.pad_multiple = 64
    cfg.tpu.mesh.enable = mesh
    cfg.tpu.mesh.data = 2 if mesh else -1
    cfg.tpu.mesh.multihost = mesh
    cfg.evaluator.viterbi.frame_sampling = 10  # videos are 100-260 frames
    return cfg


def _model(cfg, db):
    return create_model(db.get_num_classes(), db.max_transcript_length + 1, db.feat_dim,
                        device="cpu", seed=cfg.system.seed, loss_cfg=loss_config_from_cfg(cfg),
                        **model_fields_from_cfg(cfg))


def _epoch_losses(trainer):
    return [json.loads(line)["main"] for line in open(trainer.run_folder / "events.jsonl")
            if json.loads(line)["kind"] == "epoch"]


def _train_and_eval(cfg):
    """(epoch losses, eval fields after each epoch, the trainer) of one
    process."""
    train_db, test_db = handel_dataset(cfg, train=True), handel_dataset(cfg, train=False)
    model = _model(cfg, train_db)
    ev = MuConEvaluator(cfg, test_db, model)
    ev.set_name("test_eval")
    t = SimpleTrainer(cfg, "mh2proc", train_db, model, evaluators=[ev])
    t.train()
    t.wait_for_save()
    evals = [json.loads(line) for line in open(t.run_folder / "events.jsonl")
             if json.loads(line)["kind"] == "eval_0"]
    return _epoch_losses(t), evals, t


def _close(got: dict, want: dict, tol: float) -> None:
    for k, w in want.items():
        if isinstance(w, (tuple, list)):
            for a, b in zip(got[k], w):
                assert a == pytest.approx(b, abs=tol), k
        else:
            assert got[k] == pytest.approx(w, abs=tol), k


def test_two_process_trainer_and_eval(tmp_path):
    data = tmp_path / "data"
    cfg = multihost_cfg(data, tmp_path / "runs_ref", mesh=False)
    ref_losses, _, t = _train_and_eval(cfg)  # also writes the shared dataset
    assert len(ref_losses) == 2
    test_db = handel_dataset(cfg, train=False)
    ev_model = _model(cfg, test_db)
    ref_eval = {}
    for single in (True, False):
        cfg.tpu.eval_single_shape = single
        ev = MuConEvaluator(cfg, test_db, ev_model)
        ev.viterbi_mode(True)
        ref_eval[single] = dataclasses.asdict(ev.evaluate(ev_model))
    cfg.tpu.eval_single_shape = True
    c2 = multihost_cfg(data, tmp_path / "runs_ref", mesh=False)
    c2.trainer.num_epochs = 3
    t2 = SimpleTrainer(c2, "mh2proc", t.train_db, t.model, run_number=50)
    assert t2.resume_latest(run="0")
    t2.train()
    t2.wait_for_save()
    ref_resumed = _epoch_losses(t2)
    assert len(ref_resumed) == 1

    roots = [str(tmp_path / f"runs_p{r}") for r in range(2)]
    job = dict(cfg=multihost_cfg(data, roots[0]).to_dict(), roots=roots)
    r0, r1 = spawn_ranks("trainer", 2, tmp_path, job)
    # every rank logged the same (averaged) losses, the single-card math
    assert r0["train_losses"] == r1["train_losses"]
    assert r0["train_losses"] == pytest.approx(ref_losses, rel=2e-4)
    # one writer: checkpoints and eval pickles in the coordinator's folder
    assert r0["checkpoints"] == ["epoch_0", "epoch_1"] and r1["checkpoints"] == []
    assert r0["pickles"] == ["epoch_0", "epoch_1"] and r1["pickles"] == []
    # the gathered eval: the same 24 fields on every rank, the single-card
    # ones, with the 3 test videos padded to 8 rows or to 4
    assert r0["eval"] == r1["eval"]
    for single in (True, False):
        assert len(r0["eval"][single]) == 24
        _close(r0["eval"][single], ref_eval[single], 1e-4)
    # both ranks resumed from the coordinator's epoch-1 checkpoint
    assert r0["resumed_losses"] == r1["resumed_losses"]
    assert r0["resumed_losses"] == pytest.approx(ref_resumed, rel=2e-4)
    assert r0["checksum"] == r1["checksum"]


def test_one_rank_mesh_is_the_single_card_run(tmp_path):
    """`tpu.mesh.multihost` without a launcher: a mesh of one rank (a gloo
    group of one), whose all-reduce and gather are copies -- the epoch
    losses and the gathered evals equal the run without a mesh bit for
    bit."""
    data = tmp_path / "data"
    plain = multihost_cfg(data, tmp_path / "plain", mesh=False)
    losses, evals, t = _train_and_eval(plain)
    assert t.mesh is None
    one = multihost_cfg(data, tmp_path / "one", mesh=False)
    one.tpu.mesh.enable = one.tpu.mesh.multihost = True
    assert not dist.is_initialized()
    try:
        losses1, evals1, t1 = _train_and_eval(one)
        assert t1.mesh is not None and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert losses1 == losses
    drop = ("time", "eval_seconds", "eval_phases")
    assert [{k: v for k, v in e.items() if k not in drop} for e in evals1] == \
        [{k: v for k, v in e.items() if k not in drop} for e in evals]


def test_torchrun_entry_point_on_two_ranks(tmp_path):
    """`torchrun --nproc-per-node 2 -m mucon_tpu_torch.cli.train_test_mucon
    --set tpu.mesh.enable True` on the CPU (gloo; `--standalone` picks a
    free local port): both ranks log the data-parallel regime and print
    the same 24 fields, and only rank 0 writes checkpoints and pickles."""
    import os
    import subprocess
    import sys

    from tests.torch_mesh_worker import ROOT

    sets = dict(multihost_cfg(tmp_path / "data", tmp_path / "runs").to_dict())
    argv = ["--exp-name", "dp"]
    for key in ("system.device", "dataset.name", "dataset.root", "trainer.root",
                "dataset.synthetic.num_videos", "dataset.synthetic.num_classes",
                "dataset.synthetic.feat_dim", "dataset.synthetic.min_len",
                "dataset.synthetic.max_len", "model.ft.hidden_size",
                "model.ft.last_gn_num_groups", "model.fs.encoder.hidden_size",
                "model.fs.decoder.hidden_size", "tpu.batch_size", "tpu.pad_multiple",
                "evaluator.viterbi.frame_sampling", "trainer.save_every",
                "trainer.eval_every"):
        node = sets
        for part in key.split("."):
            node = node[part]
        argv += ["--set", key, str(node)]
    argv += ["--set", "model.ft.stages", "[1, 2, 4]", "--set", "model.ft.pooling_layers",
             "[0, 1]", "--set", "tpu.mesh.enable", "True", "--set", "trainer.num_epochs", "2"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "mucon_tpu_torch.cli.train_test_mucon", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    results = [line for line in proc.stdout.splitlines()
               if line.startswith("MuConEvaluatorResult(")]
    assert len(results) == 2 and results[0] == results[1]
    assert log.count("sharded train step: data-parallel over the data axis (n_data=2") == 2
    # a second writer would leave second copies, in a run folder of its own
    runs = tmp_path / "runs" / "dp"
    for name in ("model.pt", "data_test_eval.pkl"):
        assert sorted(p.parent.name for p in runs.rglob(name)) == ["epoch_0", "epoch_1"]
