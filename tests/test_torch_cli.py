"""PyTorch port: the entry points end to end on the CPU (tests/test_e2e.py's
twins).

`python -m mucon_tpu_torch.cli.train_test_mucon` with the tiny overrides of
tests/test_e2e.py and `--set system.device cpu` trains, evaluates, prints
the 24-field result and writes the run folder contract (`model.pt` where the
JAX package writes `model.msgpack`); `test_mucon.single_main` reproduces
the result from the checkpoint alone within 1e-6 and changes nothing under
the run root; a restarted trainer resumes from the newest checkpoint; the
port's `SimpleTrainer` runs the JAX one's experiment loop (the same losses,
eval series, per-video pickles and trainer_state.json, epoch by epoch); and
`predict.py main()` segments feature files with a run folder of each
package.
"""

import dataclasses
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.harness.checkpoint import save_checkpoint as jax_save_checkpoint
from mucon_tpu.harness.evaluator import MuConEvaluator as JaxEvaluator
from mucon_tpu.harness.trainer import SimpleTrainer as JaxTrainer
from mucon_tpu.cli import predict as jax_predict_cli
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch.cli import predict as predict_cli
from mucon_tpu_torch.cli import test_mucon as test_mucon_cli
from mucon_tpu_torch.cli import train_test_mucon as train_cli
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator, MuConEvaluatorResult
from mucon_tpu_torch.harness.trainer import SimpleTrainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _overrides(data_root, run_root):
    return [
        ("system.device", "cpu"),
        ("dataset.name", "synthetic"),
        ("dataset.root", str(data_root)),
        ("dataset.synthetic.num_videos", "10"),
        ("dataset.synthetic.num_classes", "6"),
        ("dataset.synthetic.feat_dim", "16"),
        ("dataset.synthetic.min_len", "120"),
        ("dataset.synthetic.max_len", "400"),
        ("trainer.root", str(run_root)),
        ("trainer.num_epochs", "2"),
        ("trainer.save_every", "1"),
        ("trainer.eval_every", "1"),
        ("trainer.learning_rate", "0.05"),
        ("model.ft.stages", "[1, 2, 4]"),
        ("model.ft.pooling_layers", "[0, 1]"),
        ("model.ft.hidden_size", "16"),
        ("model.ft.last_gn_num_groups", "4"),
        ("model.fs.encoder.hidden_size", "16"),
        ("model.fs.decoder.hidden_size", "16"),
        ("tpu.batch_size", "4"),
        ("tpu.pad_multiple", "64"),
        ("evaluator.viterbi.frame_sampling", "10"),
    ]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    data_root = tmp_path_factory.mktemp("data")
    run_root = tmp_path_factory.mktemp("runs")
    pairs = _overrides(data_root, run_root)
    argv = ["--exp-name", "e2e_test"]
    for k, v in pairs:
        argv += ["--set", k, v]
    cfg = get_cfg_defaults()
    cfg.merge_from_list([x for kv in pairs for x in kv])
    return argv, cfg, data_root, run_root, pairs


def _tree_state(root):
    return sorted((str(p.relative_to(root)), p.stat().st_mtime_ns) for p in root.rglob("*"))


def test_train_test_resume(tiny):
    argv, _, data_root, run_root, _ = tiny
    result = train_cli.main(argv)
    assert isinstance(result, MuConEvaluatorResult)
    d = dataclasses.asdict(result)
    assert len(d) == 24
    for k, v in d.items():
        assert np.all(np.isfinite(v)), k
    assert 0.0 <= result.vit_mof <= 1.0 and 0.0 <= result.y_mof <= 1.0

    run_folder = run_root / "e2e_test" / "0"
    assert (run_folder / "config.yaml").exists()
    for f in ("model.pt", "optimizer.pt", "trainer_state.json", "data_test_eval.pkl"):
        assert (run_folder / "checkpoints" / "epoch_1" / f).exists(), f
    assert (run_folder / "metrics" / "eval_metric_1.pkl").exists()
    state = json.loads((run_folder / "checkpoints" / "epoch_1" / "trainer_state.json").read_text())
    assert state["epoch_num"] == 1 and state["iter_num"] == 4
    assert state["scheduler"] == {"lr": 0.05, "epoch": 2}

    all_events = [json.loads(line) for line in open(run_folder / "events.jsonl")]
    assert {"kind", "step", "time"} <= set(all_events[0])
    kinds = [e["kind"] for e in all_events]
    for kind in ("train", "epoch", "eval_0", "train_phases", "final_eval", "run_phases"):
        assert kind in kinds, kind
    events = [e for e in all_events if e["kind"] == "epoch"]
    assert len(events) == 2
    assert events[-1]["main"] < events[0]["main"]  # learnable synthetic data
    (tp,) = [e for e in all_events if e["kind"] == "train_phases"]
    for k in ("loop_seconds", "train_seconds", "eval_seconds", "residual_seconds",
              "metric_io_seconds", "checkpoint_start_seconds", "callbacks_seconds"):
        assert tp[k] >= 0.0, k
    assert tp["train_seconds"] <= tp["loop_seconds"]
    (rp,) = [e for e in all_events if e["kind"] == "run_phases"]
    for k in ("setup_seconds", "final_save_seconds", "save_stuff_seconds"):
        assert rp[k] >= 0.0, k

    # resume-and-evaluate from the checkpoint alone; read-only
    before = _tree_state(run_root)
    result2 = test_mucon_cli.single_main("e2e_test/0/1", root=str(run_root), data_root="")
    assert _tree_state(run_root) == before
    for k, v in dataclasses.asdict(result2).items():
        np.testing.assert_allclose(v, d[k], atol=1e-6, rtol=0, err_msg=k)


def test_resume_latest(tiny, tmp_path):
    _, cfg, _, _, _ = tiny
    cfg = cfg.clone()
    cfg.trainer.root = str(tmp_path)
    train_db = handel_dataset(cfg, train=True)
    model = create_model_from_cfg(cfg, train_db)
    t1 = SimpleTrainer(cfg, "resume_test", train_db, model)
    t1.train()

    # a "restarted" trainer picks up from the newest checkpoint
    model2 = create_model_from_cfg(cfg, train_db)
    t2 = SimpleTrainer(cfg, "resume_test", train_db, model2, run_number=0)
    assert t2.resume_latest() is True
    assert t2.epoch_num == 2  # both epochs done; the loop would be a no-op
    assert t2.latest_checkpoint() == ("0", 1)
    assert t2.iter_num == t1.iter_num
    for a, b in zip(model.net.parameters(), model2.net.parameters()):
        assert torch.equal(a, b)
    t3 = SimpleTrainer(cfg, "resume_test_empty", train_db, model)
    assert t3.resume_latest() is False


# the loop test: no dropout (the packages draw their masks apart), and the
# plateau scheduler with no patience, so that each eval's s_mof_nbg moves
# the rate of the next epoch
LOOP_SETS = [
    ("model.ft.dropout_rate", "0.0"),
    ("model.ft.last_dropout_rate", "0.0"),
    ("model.fs.decoder.embedding_dropout", "0.0"),
    ("trainer.scheduler.name", "plateau"),
    ("trainer.scheduler.plateau.patience", "0"),
    ("trainer.scheduler.plateau.verbose", "False"),
    ("trainer.num_epochs", "3"),
]
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's step tolerance


def _events(run, kind):
    return [e for e in map(json.loads, open(run / "events.jsonl")) if e["kind"] == kind]


def test_trainer_loop_matches_jax(tiny, tmp_path):
    """Both packages' SimpleTrainer, from the same weights (the JAX
    trainer's init through `load_jax_params`) on the same data, evaluating
    and saving after every epoch: the same train and epoch losses (the
    train-step tolerance), the same eval_metric series (1e-6, the
    evaluator's), the same per-video pickles and the same trainer_state.json
    (counters and the plateau scheduler's state) after each epoch; and a
    port trainer resumed from the epoch-1 checkpoint runs the last epoch as
    the uninterrupted JAX run did."""
    _, _, _, _, pairs = tiny
    sets = [x for kv in pairs + LOOP_SETS for x in kv]
    jcfg, pcfg = jax_defaults(), get_cfg_defaults()
    for cfg, name in ((jcfg, "jax"), (pcfg, "port")):
        cfg.merge_from_list(sets)
        cfg.trainer.root = str(tmp_path / name)
    jdb, jtest = jax_dataset(jcfg, train=True), jax_dataset(jcfg, train=False)
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    jev = JaxEvaluator(cfg=jcfg, test_db=jtest, model=jm, device="cpu")
    jev.set_name("test_eval")
    jt = JaxTrainer(jcfg, "loop", jdb, jm, device="cpu", evaluators=[jev])

    db, test_db = handel_dataset(pcfg, train=True), handel_dataset(pcfg, train=False)
    model = create_model_from_cfg(pcfg, db)
    model.load_jax_params(jax.device_get(jt.params))
    ev = MuConEvaluator(pcfg, test_db, model)
    ev.set_name("test_eval")
    pt = SimpleTrainer(pcfg, "loop", db, model, evaluators=[ev])
    jt.train()
    pt.train()

    runs = {name: tmp_path / name / "loop" / "0" for name in ("jax", "port")}
    for kind in ("train", "epoch"):
        want, got = _events(runs["jax"], kind), _events(runs["port"], kind)
        assert len(got) == len(want) == (3 if kind == "epoch" else 1)
        for a, b in zip(got, want):
            assert a["step"] == b["step"]
            keys = set(b) - {"time", "videos_per_sec", "epoch_seconds"}
            assert keys <= set(a)
            for k in keys - {"kind", "step"}:
                np.testing.assert_allclose(a[k], b[k], **TRAIN_TOL, err_msg=(kind, k))

    series = {}
    for name, run in runs.items():
        with open(run / "metrics" / "eval_metric_1.pkl", "rb") as f:
            series[name] = pickle.load(f)
    assert [e for e, _ in series["port"]] == [e for e, _ in series["jax"]] == [0, 1, 2]
    for (_, a), (e, b) in zip(series["port"], series["jax"]):
        for k, v in dataclasses.asdict(b).items():
            np.testing.assert_allclose(getattr(a, k), v, atol=1e-6, rtol=0, err_msg=(e, k))

    for epoch in range(3):
        folder = {n: r / "checkpoints" / f"epoch_{epoch}" for n, r in runs.items()}
        state = {n: json.loads((f / "trainer_state.json").read_text())
                 for n, f in folder.items()}
        assert state["port"] == state["jax"], epoch
        data = {n: pickle.load(open(f / "data_test_eval.pkl", "rb")) for n, f in folder.items()}
        for k in ("y_segs", "s_segs", "vit_segs", "target_segs"):
            for x, y in zip(data["port"][k], data["jax"][k]):
                np.testing.assert_array_equal(x, y, err_msg=(epoch, k))
        assert data["port"]["s_transcript"] == data["jax"]["s_transcript"]
    assert state["port"]["iter_num"] == pt.iter_num == jt.iter_num
    assert pt.optimizer.param_groups[0]["lr"] == jt.scheduler.lr

    # resumed from the port's epoch-1 checkpoint into run 1, the last epoch
    # is the uninterrupted JAX run's
    model2 = create_model_from_cfg(pcfg, db)
    ev2 = MuConEvaluator(pcfg, test_db, model2)
    ev2.set_name("test_eval")
    rt = SimpleTrainer(pcfg, "loop", db, model2, evaluators=[ev2], run_number=1)
    rt.load_training("0", 1)
    rt.epoch_num += 1
    rt.train()
    run1 = tmp_path / "port" / "loop" / "1"
    (got,), want = _events(run1, "epoch"), _events(runs["jax"], "epoch")[-1]
    for k in set(want) - {"kind", "time", "epoch_seconds"}:
        np.testing.assert_allclose(got[k], want[k], **TRAIN_TOL, err_msg=("resumed", k))
    assert json.loads((run1 / "checkpoints" / "epoch_2" / "trainer_state.json").read_text()) \
        == state["jax"]
    with open(run1 / "metrics" / "eval_metric_1.pkl", "rb") as f:
        ((e, a),) = pickle.load(f)
    assert e == 2
    for k, v in dataclasses.asdict(series["jax"][-1][1]).items():
        np.testing.assert_allclose(getattr(a, k), v, atol=1e-6, rtol=0, err_msg=("resumed", k))


def test_profile_epoch_writes_a_trace(tiny, tmp_path):
    """trainer.profile_epoch: that epoch runs under torch.profiler and its
    Chrome trace lands in the run folder."""
    _, cfg, _, _, _ = tiny
    cfg = cfg.clone()
    cfg.trainer.root = str(tmp_path)
    cfg.trainer.num_epochs, cfg.trainer.profile_epoch = 1, 0
    train_db = handel_dataset(cfg, train=True)
    t = SimpleTrainer(cfg, "profile_test", train_db, create_model_from_cfg(cfg, train_db))
    t.train()
    trace = json.loads((t.run_folder / "profile" / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def _write_features(folder, rng, lengths, D):
    folder.mkdir(parents=True, exist_ok=True)
    for i, t in enumerate(lengths):
        np.save(folder / f"video_{i}.npy", rng.standard_normal((t, D)).astype(np.float32))


def test_predict_main_on_a_port_run_folder(tiny, tmp_path):
    argv, _, _, run_root, _ = tiny
    if not (run_root / "e2e_test" / "0" / "checkpoints" / "epoch_1" / "model.pt").exists():
        train_cli.main(argv)
    _write_features(tmp_path / "feats", np.random.default_rng(0), (130, 257, 401), 16)
    before = _tree_state(run_root)
    results = predict_cli.main(["e2e_test/0/1", "--root", str(run_root), "--features",
                                str(tmp_path / "feats"), "--out", str(tmp_path / "out")])
    assert _tree_state(run_root) == before
    assert [r["name"] for r in results] == ["video_0", "video_1", "video_2"]
    for r, t in zip(results, (130, 257, 401)):
        labels = np.load(tmp_path / "out" / f"{r['name']}.labels.npy")
        assert labels.shape == (t,) and set(np.unique(labels)) <= set(r["transcript"])
        assert np.load(tmp_path / "out" / f"{r['name']}.y_labels.npy").shape == (t,)
        meta = json.loads((tmp_path / "out" / f"{r['name']}.json").read_text())
        assert meta["transcript"] == r["transcript"]
        assert abs(sum(meta["rel_lengths"]) - 1.0) < 1e-5


def _jax_run_folder(tiny, root):
    """A JAX run folder `jax_exp/0` under `root` (its block-style config.yaml
    and flax model.msgpack) with one checkpoint, epoch 3; returns its params."""
    _, cfg, _, _, pairs = tiny
    jcfg = jax_defaults()
    jcfg.merge_from_list([x for kv in pairs for x in kv])
    jcfg.trainer.root = str(root)
    run = root / "jax_exp" / "0"
    run.mkdir(parents=True)
    jcfg.dump_to_file(str(run / "config.yaml"))
    assert "device: cpu" in (run / "config.yaml").read_text()
    db = handel_dataset(cfg, train=False)
    jm = create_jax_model(jcfg, num_classes=db.get_num_classes(),
                          max_decoding_steps=db.max_transcript_length + 1,
                          input_feature_size=db.feat_dim)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(7)))
    jax_save_checkpoint(run / "checkpoints" / "epoch_3", params, None, {"epoch_num": 3})
    return params


def test_predict_main_on_a_jax_run_folder(tiny, tmp_path):
    """A JAX run folder (its block-style config.yaml and flax model.msgpack)
    read by the port's predict, against the port's own predict_videos with
    the same weights through `load_jax_params`."""
    _, cfg, _, _, _ = tiny
    params = _jax_run_folder(tiny, tmp_path / "runs")
    db = handel_dataset(cfg, train=False)

    _write_features(tmp_path / "feats", np.random.default_rng(1), (150, 333), 16)
    results = predict_cli.main(["jax_exp/0/3", "--root", str(tmp_path / "runs"),
                                "--features", str(tmp_path / "feats"),
                                "--out", str(tmp_path / "out")])
    model = create_model_from_cfg(cfg, db)
    model.load_jax_params(params)
    feats = [np.load(tmp_path / "feats" / f"video_{i}.npy") for i in range(2)]
    want = predict_cli.predict_videos(model, feats, ["video_0", "video_1"], db,
                                      frame_sampling=10, batch_size=4, pad_multiple=64)
    for r, w in zip(results, want):
        assert r["transcript"] == w["transcript"]
        np.testing.assert_array_equal(r["vit_labels"], w["vit_labels"])
        np.testing.assert_array_equal(r["y_labels"], w["y_labels"])


def test_predict_main_feats_wire_matches_the_jax_cli(tiny, tmp_path):
    """`predict --feats-wire int8` of both packages on one JAX run folder
    (mucon_tpu/cli/predict.py:127-141): the port's CLI takes the JAX command
    line and writes the same predictions."""
    _jax_run_folder(tiny, tmp_path / "runs")
    _write_features(tmp_path / "feats", np.random.default_rng(2), (150, 333, 64), 16)
    outs = {}
    for name, cli in (("port", predict_cli.main), ("jax", jax_predict_cli.main)):
        outs[name] = tmp_path / f"out_{name}"
        cli(["jax_exp/0/3", "--root", str(tmp_path / "runs"), "--features",
             str(tmp_path / "feats"), "--out", str(outs[name]), "--feats-wire", "int8"])
    for i in range(3):
        for suffix in ("labels.npy", "y_labels.npy"):
            np.testing.assert_array_equal(np.load(outs["port"] / f"video_{i}.{suffix}"),
                                          np.load(outs["jax"] / f"video_{i}.{suffix}"))
        got, want = (json.loads((outs[k] / f"video_{i}.json").read_text())
                     for k in ("port", "jax"))
        for k in ("name", "transcript", "transcript_names"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["rel_lengths"], want["rel_lengths"], rtol=1e-5,
                                   atol=1e-4)


def test_entry_points_run_as_modules():
    for entry in ("train_test_mucon", "test_mucon", "predict", "export_model"):
        out = subprocess.run([sys.executable, "-m", f"mucon_tpu_torch.cli.{entry}", "--help"],
                             cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "usage" in out.stdout, (entry, out.stderr)
