"""PyTorch port: the run-folder report and inspector
(mucon_tpu_torch/harness/report.py, cli/inspect_run.py) against mucon_tpu's.

On a port run folder (`train_test_mucon` on the CPU: `config.yaml` as JSON,
`events.jsonl`, `metrics/`, checkpoints with `model.pt`, the evaluator
pickles): the port's `render_report` equals the JAX one's string, and
`inspect_run` prints what the JAX inspector prints (with and without
`--videos`); the same on a JAX-style folder (YAML config, `*.msgpack`
checkpoints) and on folders without artifacts; `--html` writes the report
with every section.
"""

import pytest

from mucon_tpu.cli import inspect_run as jax_inspect
from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.harness.report import render_report as jax_render
from mucon_tpu_torch.cli import inspect_run
from mucon_tpu_torch.cli import train_test_mucon as train_cli
from mucon_tpu_torch.harness import render_report, write_report

SECTIONS = ("<h2>Config</h2>", "<h2>Training losses</h2>", "<h2>Eval metrics</h2>",
            "<h2>Segmentations</h2>")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run folder: 2 epochs, an eval and a checkpoint each."""
    root = tmp_path_factory.mktemp("report")
    argv = ["--exp-name", "report"]
    for k, v in [
        ("system.device", "cpu"), ("dataset.name", "synthetic"),
        ("dataset.root", str(root / "data")), ("dataset.synthetic.num_videos", "8"),
        ("dataset.synthetic.num_classes", "6"), ("dataset.synthetic.feat_dim", "16"),
        ("dataset.synthetic.min_len", "120"), ("dataset.synthetic.max_len", "300"),
        ("trainer.root", str(root / "runs")), ("trainer.num_epochs", "2"),
        ("trainer.save_every", "1"), ("trainer.eval_every", "1"),
        ("model.ft.stages", "[1, 2, 4]"), ("model.ft.pooling_layers", "[0, 1]"),
        ("model.ft.hidden_size", "16"), ("model.ft.last_gn_num_groups", "4"),
        ("model.fs.encoder.hidden_size", "16"), ("model.fs.decoder.hidden_size", "16"),
        ("tpu.batch_size", "2"), ("tpu.pad_multiple", "64"),
        ("evaluator.viterbi.frame_sampling", "10"),
    ]:
        argv += ["--set", k, v]
    train_cli.main(argv)
    return root / "runs" / "report" / "0"


def test_render_report_equals_jax(run):
    html = render_report(run)
    assert html == jax_render(run)
    for section in SECTIONS:
        assert section in html, section
    assert "model.pt" not in html and html.count("<div class='video'>") == 2


def _stdout(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    fn(*args, **kwargs)
    return capsys.readouterr().out


@pytest.mark.parametrize("videos", [False, True])
def test_inspect_run_prints_what_jax_prints(run, capsys, videos):
    got = _stdout(capsys, inspect_run.inspect_run, run, show_videos=videos)
    assert got == _stdout(capsys, jax_inspect.inspect_run, run, show_videos=videos)
    for line in ("== config", "== training (events.jsonl)", "== metric series",
                 "== checkpoints", "== evaluator artifacts", "epochs logged: 2",
                 "epoch_1: data_test_eval.pkl, model.pt, optimizer.pt, trainer_state.json"):
        assert line in got, line
    assert ("video 1:" in got) == videos


def test_a_jax_run_folder_and_one_without_artifacts(tmp_path, capsys):
    """A JAX-style folder (YAML config, msgpack checkpoint) and a folder
    with nothing but its config: the port prints and renders what the JAX
    package does."""
    jax_run, bare = tmp_path / "jax", tmp_path / "bare"
    for folder in (jax_run, bare):
        folder.mkdir()
    jax_defaults().dump_to_file(str(jax_run / "config.yaml"))
    ckpt = jax_run / "checkpoints" / "epoch_3"
    ckpt.mkdir(parents=True)
    for name in ("model.msgpack", "optimizer.msgpack", "trainer_state.json"):
        (ckpt / name).write_text("")
    (bare / "config.yaml").write_text((jax_run / "config.yaml").read_text())
    for folder in (jax_run, bare, tmp_path / "empty"):
        folder.mkdir(exist_ok=True)
        assert render_report(folder) == jax_render(folder)
    for folder in (jax_run, bare):
        got = _stdout(capsys, inspect_run.inspect_run, folder)
        assert got == _stdout(capsys, jax_inspect.inspect_run, folder)
    assert "epoch_3: model.msgpack, optimizer.msgpack, trainer_state.json" in \
        _stdout(capsys, inspect_run.inspect_run, jax_run)
    assert "== training" not in got and "== evaluator artifacts" not in got


def test_html_flag_writes_the_report(run, tmp_path, capsys):
    inspect_run.main([str(run), "--html"])
    assert f"report written: {run / 'report.html'}" in capsys.readouterr().out
    html = (run / "report.html").read_text()
    assert html == render_report(run)
    out = tmp_path / "elsewhere.html"
    inspect_run.main([str(run), "--html", str(out)])
    assert out.read_text() == html
    assert write_report(run, tmp_path / "direct.html").read_text() == html
    for section in SECTIONS:
        assert section in html, section
