"""Run-folder inspector (mucon_tpu/cli/inspect_run.py): a terminal summary
of a training run from its artifacts — the config, the losses from
events.jsonl, the metric series, the checkpoints (a port run's
`model.pt` / `optimizer.pt` or a JAX run's `*.msgpack`: each epoch's files
are listed) and a per-video breakdown from the evaluator pickles.

Usage:
    python -m mucon_tpu_torch.cli.inspect_run <root>/<exp>/<run> [--videos]
    python -m mucon_tpu_torch.cli.inspect_run <root>/<exp>/<run> --html [out.html]

`--html` writes the visual report of `mucon_tpu_torch.harness.report`.
For the same folder it prints what the JAX package's inspector prints.
"""

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from mucon_tpu_torch.harness.report import load_run_config, write_report


def _section(title):
    print(f"\n== {title} " + "=" * max(0, 60 - len(title)))


def inspect_run(run_folder: Path, show_videos: bool = False) -> None:
    run_folder = Path(run_folder)
    assert (run_folder / "config.yaml").exists(), f"not a run folder: {run_folder}"

    _section("config")
    cfg = load_run_config(run_folder / "config.yaml")
    print(f"experiment: {cfg.get('experiment_name')}")
    print(f"dataset: {cfg['dataset']['name']} split {cfg['dataset']['split']}")
    print(
        f"trainer: {cfg['trainer']['optimizer']} lr={cfg['trainer']['learning_rate']}"
        f" epochs={cfg['trainer']['num_epochs']} batch={cfg['tpu']['batch_size']}"
    )

    events_path = run_folder / "events.jsonl"
    if events_path.exists():
        _section("training (events.jsonl)")
        epochs = [
            json.loads(l) for l in open(events_path) if '"kind": "epoch"' in l
        ]
        if epochs:
            first, last = epochs[0], epochs[-1]
            print(f"epochs logged: {len(epochs)}")
            print(f"main loss: {first['main']:.4f} -> {last['main']:.4f}")
            for k in ("transcript_loss", "mucon_loss", "length_loss",
                      "smoothing_loss"):
                if k in last:
                    print(f"  {k}: {first.get(k, float('nan')):.4f} -> {last[k]:.4f}")
        trains = [json.loads(l) for l in open(events_path) if '"kind": "train"' in l]
        vps = [e["videos_per_sec"] for e in trains if "videos_per_sec" in e]
        if vps:
            print(f"throughput: median {np.median(vps):.2f} videos/s")

    metrics_dir = run_folder / "metrics"
    if metrics_dir.exists():
        _section("metric series")
        for p in sorted(metrics_dir.glob("*.json")):
            series = json.load(open(p))
            if not series:
                continue
            lastv = series[-1]["value"]
            if isinstance(lastv, dict):
                keys = ("vit_mof", "y_mof", "s_mof", "s_mat_score")
                summary = ", ".join(
                    f"{k}={lastv[k]:.4f}" for k in keys if k in lastv
                )
                print(f"{p.stem} (epoch {series[-1]['epoch']}): {summary}")
            else:
                print(f"{p.stem}: {lastv}")

    ckpts = sorted((run_folder / "checkpoints").glob("epoch_*")) if (
        run_folder / "checkpoints"
    ).exists() else []
    _section("checkpoints")
    for c in ckpts:
        have = [p.name for p in c.iterdir()]
        print(f"{c.name}: {', '.join(sorted(have))}")

    pkls = list(run_folder.rglob("data_*.pkl"))
    if pkls:
        _section("evaluator artifacts")
        for p in sorted(pkls)[-1:]:
            data = pickle.load(open(p, "rb"))
            n = len(data.get("target_segs", []))
            print(f"{p.relative_to(run_folder)}: {n} videos")
            if show_videos:
                for i in range(n):
                    t = data["target_segs"][i]
                    v = data["vit_segs"][i]
                    mof = float(np.mean(np.asarray(t) == np.asarray(v)))
                    tr = data["s_transcript"][i]
                    print(
                        f"  video {i}: {len(t)} frames, vit_mof={mof:.3f}, "
                        f"pred transcript {list(tr)}"
                    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_folder", help="<trainer.root>/<exp_name>/<run_number>")
    p.add_argument("--videos", action="store_true", help="per-video breakdown")
    p.add_argument(
        "--html", nargs="?", const="", metavar="OUT",
        help="write the HTML visual report (default <run>/report.html)",
    )
    args = p.parse_args(argv)
    if args.html is not None:
        out = write_report(
            Path(args.run_folder), Path(args.html) if args.html else None
        )
        print(f"report written: {out}")
        return
    inspect_run(Path(args.run_folder), show_videos=args.videos)


if __name__ == "__main__":
    main()
