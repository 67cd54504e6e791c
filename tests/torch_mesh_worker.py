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
  time block;
* ``shift`` -- `halo_shift` forward and backward on the rank's time block
  for each offset of the job;
* ``sp_step`` -- on a mesh of the job's shape, for each case: the weights
  split over "model" (`shard_params`) and broadcast, then train steps (or,
  with ``k`` > 1, grad steps + `apply_gradients`; with ``jitter``, grad
  steps whose gradients each rank scales by its own factor, then
  `apply_gradients`) on the rank's rows and time block, the clip's group norms of whole leaves, the gathered state
  (`full_state`) and the rank's own leaves; optionally the fused eval of
  a batch;
* ``sp_trainer`` -- `SimpleTrainer` and `MuConEvaluator` on a "seq" /
  "model" mesh: an epoch and the gathered eval, or the checkpoint round
  trip of the backbone's columns.
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
    failed = [(r, log) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    # the rank that failed first, not the ones its crash took down
    failed.sort(key=lambda rl: "Connection closed by peer" in rl[1])
    assert not failed, f"rank {failed[0][0]} failed:\n{failed[0][1][-4000:]}"
    return [pickle.loads(o.read_bytes()) for o in outs]


def _model(job):
    from mucon_tpu_torch.models.model import (
        MuConFullySupervisedModel,
        MuConModel,
        create_model,
    )

    model = create_model(*job["dims"], device="cpu", **job["fields"], loss_cfg=job["loss_cfg"],
                         model_cls=MuConFullySupervisedModel if job.get("supervised")
                         else MuConModel)
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


def run_shift(job) -> dict:
    import torch

    from mucon_tpu_torch.parallel import transport
    from mucon_tpu_torch.parallel.halo import halo_shift
    from mucon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, job["seq"])
    me = mesh.get_local_rank("seq")
    x, dy = torch.as_tensor(job["x"]), torch.as_tensor(job["dy"])
    t_local = x.shape[1] // job["seq"]
    out = {}
    for offset in job["offsets"]:
        x_local = x[:, me * t_local:(me + 1) * t_local].clone().requires_grad_(True)
        transport.reset_staged_bytes()
        y = halo_shift(x_local, offset, mesh.get_group("seq"))
        y.backward(dy[:, me * t_local:(me + 1) * t_local])
        out[offset] = dict(y=y.detach(), dx=x_local.grad, staged=dict(transport.staged_bytes))
    return out


def run_case(case, mesh) -> dict:
    """One case of ``sp_step`` on `mesh`, or with `mesh=None` the same
    steps on one rank (the reference the tests hold the mesh to)."""
    import torch

    from mucon_tpu_torch.config import ConfigNode
    from mucon_tpu_torch.harness.optim import (
        clip_grad_norm_partitioned,
        clip_gradients,
        create_optimizer,
        local_norm_sq,
    )
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval
    from mucon_tpu_torch.parallel.mesh import (
        apply_gradients,
        broadcast_module,
        full_state,
        make_sharded_grad_step,
        make_sharded_train_step,
        mesh_shape,
        model_norm_sq,
        reduce_gradients,
        shard_batch_arrays,
        shard_params,
    )

    cfg = ConfigNode(case["cfg"])
    model = _model(case)
    norm_sq = local_norm_sq
    if mesh is not None:
        if mesh_shape(mesh)["model"] > 1:
            shard_params(mesh, model.net)
            norm_sq = model_norm_sq(model.net, mesh)
        broadcast_module(model.net, mesh)
    tr = cfg.trainer
    opt = create_optimizer(model.net.parameters(), tr.optimizer, tr.learning_rate,
                           tr.momentum, tr.weight_decay)
    partition = model.param_partition()

    def clip():
        clip_gradients(tr, partition, norm_sq)

    def gen():
        seed = case.get("mask_seed")
        return None if seed is None else torch.Generator().manual_seed(seed)

    def local(arrays):
        return arrays if mesh is None else shard_batch_arrays(mesh, arrays, "cpu")

    losses, norms = [], None
    k = case.get("k", 1)
    if case.get("jitter"):
        # a card's gather / index backward adds with atomics, so the ranks
        # of a data row need not compute the replicated gradients bit for
        # bit alike: each rank scales its gradients by its own 1 + jitter * r
        grad_step = make_sharded_grad_step(model, mesh)
        scale = 1.0 + case["jitter"] * torch.distributed.get_rank()
        for _ in range(case["steps"]):
            opt.zero_grad(set_to_none=True)
            terms = grad_step(local(case["arrays"]), gen())
            losses.append({n: float(v) for n, v in terms.items()})
            for p in model.net.parameters():
                if p.grad is not None:
                    p.grad.mul_(scale)
            apply_gradients(model.net, opt, mesh, clip)
    elif k == 1:
        step = make_sharded_train_step(model, opt, mesh, clip=clip)
        for _ in range(case["steps"]):
            losses.append({n: float(v) for n, v in step(local(case["arrays"]), gen()).items()})
    else:
        grad_step = make_sharded_grad_step(model, mesh, accumulate_grad_every=k)
        for _ in range(case["steps"]):
            for micro in case["micro"]:
                terms = grad_step(local(micro), gen())
                losses.append({n: float(v) for n, v in terms.items()})
            apply_gradients(model.net, opt, mesh, clip)
    if case.get("norms"):
        # the clip's group norms of one more step's reduced gradients
        make_sharded_grad_step(model, mesh)(local(case["arrays"]), gen())
        for p in model.net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            reduce_gradients(model.net, mesh)
        norms = {n: float(v) for n, v in clip_grad_norm_partitioned(
            partition, float("inf"), norm_sq).items()}
        opt.zero_grad(set_to_none=True)
    model_sd, opt_sd = full_state(model.net, opt, mesh)
    result = dict(losses=losses, state_dict=model_sd, opt_state=opt_sd, norms=norms,
                  local={n: v.clone() for n, v in model.net.state_dict().items()})
    if case.get("eval"):
        run = build_fused_eval(model, frame_sampling=case["eval"]["frame_sampling"], mesh=mesh)
        result["eval"] = run(local(case["eval"]["arrays"]))
    return result


def run_sp_step(job) -> dict:
    from mucon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*job["shape"])
    out = dict(coord=tuple(mesh.get_coordinate()))
    for case in job["cases"]:
        out[case["name"]] = run_case(case, mesh)
    return out


def run_sp_trainer(job, rank: int) -> dict:
    """`SimpleTrainer` and `MuConEvaluator` on a mesh of the config's
    shape: with ``what`` "eval", one epoch of training then the gathered
    fused eval of a fresh model; with "checkpoint", an epoch and a save,
    then a fresh trainer on another init restored from the coordinator's
    checkpoint (its local and whole state against the saved), one more
    epoch, and the gathered fused eval of a fresh whole model."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from mucon_tpu_torch.config import ConfigNode
    from mucon_tpu_torch.data import handel_dataset
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg
    from mucon_tpu_torch.parallel.mesh import full_state

    def model_for(cfg, db, seed):
        return create_model(db.get_num_classes(), db.max_transcript_length + 1, db.feat_dim,
                            device="cpu", seed=seed, loss_cfg=loss_config_from_cfg(cfg),
                            **model_fields_from_cfg(cfg))

    def epoch_losses(t):
        return [json.loads(line)["main"] for line in open(t.run_folder / "events.jsonl")
                if json.loads(line)["kind"] == "epoch"]

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    cfg = ConfigNode(job["cfg"])
    cfg.trainer.root = job["roots"][rank]
    train_db, test_db = handel_dataset(cfg, train=True), handel_dataset(cfg, train=False)
    model = model_for(cfg, train_db, cfg.system.seed)
    t1 = SimpleTrainer(cfg, "sp", train_db, model)
    t1.train()
    t1.wait_for_save()
    out = dict(losses=epoch_losses(t1), shard=model.net.ft.Conv1x1_0.kernel.shape[-1])
    if job["what"] == "eval":
        ev_model = model_for(cfg, test_db, cfg.system.seed + 1)
        ev = MuConEvaluator(cfg, test_db, ev_model)
        ev.viterbi_mode(True)
        out["eval"] = dataclasses.asdict(ev.evaluate(ev_model))
        return out
    saved = full_state(model.net, t1.optimizer, t1.mesh)
    local = ({k: v.clone() for k, v in model.net.state_dict().items()},
             t1.optimizer.state_dict())
    dist.barrier()  # the coordinator's files are in place
    cfg.trainer.root = job["roots"][0]
    model2 = model_for(cfg, train_db, cfg.system.seed + 7)
    t2 = SimpleTrainer(cfg, "sp", train_db, model2, run_number=50 + rank)
    t2.load_training("0", 0)
    out["local_equal"] = equal(local[0], model2.net.state_dict())
    out["opt_local_equal"] = equal(local[1]["state"], t2.optimizer.state_dict()["state"])
    again = full_state(model2.net, t2.optimizer, t2.mesh)
    out["full_equal"] = equal(saved[0], again[0]) and equal(saved[1]["state"],
                                                           again[1]["state"])
    out["opt_state_keys"] = sorted({k for st in saved[1]["state"].values() for k in st})
    t2.epoch_num = 1
    t2._train_one_epoch()
    out["more"] = epoch_losses(t2)
    # an evaluator handed a whole net on this mesh splits it as the trainer does
    ev_model = model_for(cfg, test_db, cfg.system.seed + 1)
    ev = MuConEvaluator(cfg, test_db, ev_model)
    ev.viterbi_mode(True)
    out["eval"] = dataclasses.asdict(ev.evaluate(ev_model))
    out["eval_shard"] = ev_model.net.ft.Conv1x1_0.kernel.shape[-1]
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
    elif mode == "shift":
        out = run_shift(job)
    elif mode == "sp_step":
        out = run_sp_step(job)
    elif mode == "sp_trainer":
        out = run_sp_trainer(job, rank)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    Path(out_path).write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
