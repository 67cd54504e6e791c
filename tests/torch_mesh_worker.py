"""Rank processes for the port's multi-process tests (not collected).

`spawn_ranks(mode, world, tmp_path, payload)` starts `world` processes of
this module, each one rank of a gloo group that meets through a file under
`tmp_path` (no TCP port: the suite runs on several workers at once), hands
each the pickled `payload` and returns what each wrote, in rank order.
This module imports torch and the port, never jax: the JAX side of a
comparison runs in the pytest process.

Modes:
* ``mesh`` -- `make_mesh` / `make_multihost_mesh` shapes and each rank's
  coordinate and batch rows;
* ``dp_step`` -- `make_sharded_train_step` (or, with ``k`` > 1,
  `make_sharded_grad_step` + `apply_gradients`) on the rank's rows of a
  host batch, from given weights;
* ``trainer`` -- `SimpleTrainer` with an evaluator for the config's
  epochs, the gathered eval of a fresh model, and a resume from the
  coordinator's checkpoint;
* ``halo`` -- `make_sp_dilated_conv` forward and backward on the rank's
  time block.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spawn_ranks(mode: str, world: int, tmp_path, payload, timeout: float = 240.0) -> list:
    tmp_path = Path(tmp_path)
    job = tmp_path / f"{mode}_job.pkl"
    job.write_bytes(pickle.dumps(payload))
    rdzv = tmp_path / f"{mode}_rdzv"
    rdzv.unlink(missing_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    outs = [tmp_path / f"{mode}_rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_worker", mode, str(r), str(world),
         f"file://{rdzv}", str(job), str(outs[r])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [pickle.loads(o.read_bytes()) for o in outs]


def _model(job):
    from mucon_tpu_torch.models.model import create_model

    model = create_model(*job["dims"], device="cpu", **job["fields"], loss_cfg=job["loss_cfg"])
    model.net.load_state_dict(job["state_dict"])
    return model


def run_mesh(job, world: int) -> dict:
    from mucon_tpu_torch.parallel.mesh import data_rows, make_mesh, mesh_shape
    from mucon_tpu_torch.parallel.multihost import make_multihost_mesh, process_batch_slice

    out = {}
    for shape in job["shapes"]:
        mesh = make_mesh(*shape)
        out[tuple(shape)] = dict(shape=mesh_shape(mesh), coord=tuple(mesh.get_coordinate()),
                                 rows=data_rows(mesh, 8))
    mh = make_multihost_mesh()
    out["multihost"] = dict(shape=mesh_shape(mh), rows=process_batch_slice(8, mh))
    try:
        make_mesh(world + 1)
    except ValueError as e:
        out["mismatch"] = str(e)

    from mucon_tpu_torch.config import get_cfg_defaults
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.model import create_model

    class TestSet:
        background_class_ids = (0,)

    model = create_model(6, 9, 12, device="cpu", stages=(1,), hidden_size=8,
                         last_gn_num_groups=4, lstm_hidden_size=8)
    for key, sets in (("batch_refused", dict(enable=True)),
                      ("eval_without_mesh", dict(enable=False)),
                      ("eval_per_batch", dict(enable=True))):
        cfg = get_cfg_defaults()
        cfg.tpu.batch_size = 6
        cfg.trainer.root = job["root"]
        for k, v in sets.items():
            cfg.tpu.mesh[k] = v
        cfg.evaluator.viterbi.backend = "host" if key == "eval_per_batch" else "device"
        try:
            if key == "batch_refused":
                SimpleTrainer(cfg, "refused", None, model)
            else:
                MuConEvaluator(cfg, TestSet(), model).evaluate()
        except (ValueError, RuntimeError) as e:
            out[key] = str(e)
    return out


def run_dp_step(job) -> dict:
    from mucon_tpu_torch.config import ConfigNode
    from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer
    from mucon_tpu_torch.parallel.mesh import (
        apply_gradients,
        make_mesh,
        make_sharded_forward,
        make_sharded_grad_step,
        make_sharded_train_step,
        shard_batch_arrays,
    )

    cfg = ConfigNode(job["cfg"])
    model = _model(job)
    tr = cfg.trainer
    opt = create_optimizer(model.net.parameters(), tr.optimizer, tr.learning_rate, tr.momentum,
                           tr.weight_decay)
    partition = model.param_partition()

    def clip():
        clip_gradients(tr, partition)

    mesh = make_mesh(-1)
    losses = []
    if job["k"] == 1:
        step = make_sharded_train_step(model, opt, mesh, use_kernels=True, clip=clip)
        arrays = shard_batch_arrays(mesh, job["arrays"], "cpu")
        for _ in range(job["steps"]):
            losses.append({k: float(v) for k, v in step(arrays).items()})
        fwd = make_sharded_forward(model, mesh)(arrays)
        forward = {k: getattr(fwd, k) for k in ("tokens", "n_steps", "lengths",
                                                 "segmentation", "tz_lengths")}
    else:
        grad_step = make_sharded_grad_step(model, mesh, accumulate_grad_every=job["k"])
        for _ in range(job["steps"]):
            for micro in job["micro"]:
                terms = grad_step(shard_batch_arrays(mesh, micro, "cpu"))
                losses.append({k: float(v) for k, v in terms.items()})
            apply_gradients(model.net, opt, mesh, clip)
    return dict(losses=losses, state_dict={k: v.clone() for k, v in
                                           model.net.state_dict().items()},
                grads_zeroed=all(p.grad is None for p in model.net.parameters()),
                forward=forward if job["k"] == 1 else None)


def run_trainer(job, rank: int) -> dict:
    import dataclasses

    from mucon_tpu_torch.config import ConfigNode
    from mucon_tpu_torch.data import handel_dataset
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
    from mucon_tpu_torch.parallel.mesh import mesh_shape

    def cfg_at(root, epochs):
        cfg = ConfigNode(job["cfg"])
        cfg.trainer.root = str(root)
        cfg.trainer.num_epochs = epochs
        return cfg

    def model_for(cfg, db):
        return create_model(db.get_num_classes(), db.max_transcript_length + 1, db.feat_dim,
                            device="cpu", seed=cfg.system.seed,
                            loss_cfg=loss_config_from_cfg(cfg), **model_fields_from_cfg(cfg))

    def epoch_losses(t):
        return [json.loads(line)["main"] for line in open(t.run_folder / "events.jsonl")
                if json.loads(line)["kind"] == "epoch"]

    cfg = cfg_at(Path(job["roots"][rank]), 2)
    train_db = handel_dataset(cfg, train=True)
    test_db = handel_dataset(cfg, train=False)
    model = model_for(cfg, train_db)
    ev = MuConEvaluator(cfg, test_db, model)
    ev.set_name("test_eval")
    t = SimpleTrainer(cfg, "mh2proc", train_db, model, evaluators=[ev])
    assert mesh_shape(t.mesh)["data"] == 2
    t.train()
    t.wait_for_save()
    ckpts = sorted(p.name for p in (t.run_folder / "checkpoints").glob("epoch_*")) \
        if (t.run_folder / "checkpoints").exists() else []
    pickles = sorted(p.parent.name for p in t.run_folder.rglob("data_test_eval.pkl"))

    # the gathered eval of a fresh model of the config's seed, on one
    # shape (rows padded to tpu.batch_size) and batch by batch (rows padded
    # to a multiple of the data axis)
    ev_model = model_for(cfg, test_db)
    eval_result = {}
    for single in (True, False):
        cfg.tpu.eval_single_shape = single
        fresh = MuConEvaluator(cfg, test_db, ev_model)
        fresh.viterbi_mode(True)
        eval_result[single] = dataclasses.asdict(fresh.evaluate(ev_model))
    cfg.tpu.eval_single_shape = True

    # every rank resumes from the coordinator's epoch-1 checkpoint
    c2 = cfg_at(Path(job["roots"][0]), 3)
    t2 = SimpleTrainer(c2, "mh2proc", train_db, model, run_number=50 + rank)
    assert t2.resume_latest(run="0") and t2.epoch_num == 2
    t2.train()
    t2.wait_for_save()
    checksum = float(sum(p.detach().abs().sum() for p in model.net.parameters()))
    return dict(train_losses=epoch_losses(t), checkpoints=ckpts, pickles=pickles,
                eval=eval_result, resumed_losses=epoch_losses(t2), checksum=checksum)


def run_halo(job) -> dict:
    import torch

    from mucon_tpu_torch.parallel.halo import make_sp_dilated_conv
    from mucon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, job["seq"])
    me = mesh.get_local_rank("seq")
    out = {}
    for d in job["dilations"]:
        x, w, b, dy = (torch.as_tensor(job[k]) for k in ("x", "w", "b", "dy"))
        t_local = x.shape[1] // job["seq"]
        x_local = x[:, me * t_local:(me + 1) * t_local].clone().requires_grad_(True)
        w.requires_grad_(True)
        b.requires_grad_(True)
        y = make_sp_dilated_conv(mesh, d)(x_local, w, b)
        y.backward(dy[:, me * t_local:(me + 1) * t_local])
        out[d] = dict(y=y.detach(), dx=x_local.grad, dw=w.grad, db=b.grad)
    return out


def main() -> None:
    mode, rank, world, rdzv, job_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from mucon_tpu_torch.parallel.multihost import init_distributed, is_coordinator

    assert init_distributed(rdzv, num_processes=world, process_id=rank,
                            backend="gloo") == (rank, world)
    assert is_coordinator() == (rank == 0)
    job = pickle.loads(Path(job_path).read_bytes())
    if mode == "mesh":
        out = run_mesh(job, world)
    elif mode == "dp_step":
        out = run_dp_step(job)
    elif mode == "trainer":
        out = run_trainer(job, rank)
    elif mode == "halo":
        out = run_halo(job)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    Path(out_path).write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
