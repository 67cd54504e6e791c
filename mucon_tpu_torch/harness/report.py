"""A self-contained HTML report of a run folder (mucon_tpu/harness/report.py).

One static HTML file with inline SVG, from the run folder alone (no model,
no device):

* loss curves per term from `events.jsonl` (the `epoch` lines);
* the eval-metric series (vit_mof / y_mof / s_mof / s_mat_score) from the
  `eval_<i>` lines;
* per-video segmentation timelines (GT against y / s / vit rows of coloured
  spans) from the newest evaluator pickle `data_*.pkl`.

It reads a run folder of either package: the port writes `config.yaml` as
JSON, which is read as JSON first (without pyyaml), a JAX run's YAML
through pyyaml.  For the same folder it renders the JAX package's string.
"""

from __future__ import annotations

import html
import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# 20 visually-distinct colors (Kelly-ish palette), cycled for class ids.
_PALETTE = [
    "#4E79A7", "#F28E2B", "#E15759", "#76B7B2", "#59A14F",
    "#EDC948", "#B07AA1", "#FF9DA7", "#9C755F", "#BAB0AC",
    "#1B9E77", "#D95F02", "#7570B3", "#E7298A", "#66A61E",
    "#E6AB02", "#A6761D", "#386CB0", "#F0027F", "#BF5B17",
]


def _color(cid: int) -> str:
    if cid < 0:
        return "#DDDDDD"  # padding / background sentinel
    return _PALETTE[int(cid) % len(_PALETTE)]


def _svg_line_chart(
    series: Dict[str, List[tuple]],
    width: int = 640,
    height: int = 180,
    title: str = "",
) -> str:
    """series: name -> [(x, y), ...].  Linear axes, auto-scaled."""
    pts = [p for s in series.values() for p in s if np.isfinite(p[1])]
    if not pts:
        return ""
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + 1
    pad_l, pad_b, pad_t = 46, 18, 18
    w, h = width - pad_l - 8, height - pad_b - pad_t

    def sx(x):
        return pad_l + (x - x0) / (x1 - x0) * w

    def sy(y):
        return pad_t + (1.0 - (y - y0) / (y1 - y0)) * h

    out = [
        f'<svg width="{width}" height="{height}" '
        f'font-family="sans-serif" font-size="10">'
    ]
    if title:
        out.append(
            f'<text x="{pad_l}" y="12" font-size="12" font-weight="bold">'
            f"{html.escape(title)}</text>"
        )
    # axes + y labels
    out.append(
        f'<line x1="{pad_l}" y1="{pad_t}" x2="{pad_l}" y2="{pad_t + h}" '
        f'stroke="#999"/>'
        f'<line x1="{pad_l}" y1="{pad_t + h}" x2="{pad_l + w}" '
        f'y2="{pad_t + h}" stroke="#999"/>'
    )
    for frac in (0.0, 0.5, 1.0):
        yv = y0 + frac * (y1 - y0)
        out.append(
            f'<text x="{pad_l - 4}" y="{sy(yv) + 3}" text-anchor="end">'
            f"{yv:.3g}</text>"
        )
    for xv in (x0, x1):
        out.append(
            f'<text x="{sx(xv)}" y="{pad_t + h + 12}" text-anchor="middle">'
            f"{xv:g}</text>"
        )
    legend_y = 12
    for i, (name, s) in enumerate(series.items()):
        s = [p for p in s if np.isfinite(p[1])]
        if not s:
            continue
        color = _PALETTE[i % len(_PALETTE)]
        path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in s)
        out.append(
            f'<polyline points="{path}" fill="none" stroke="{color}" '
            f'stroke-width="1.5"/>'
        )
        lx = pad_l + 90 * i + 60
        out.append(
            f'<rect x="{lx}" y="{legend_y - 8}" width="10" height="10" '
            f'fill="{color}"/><text x="{lx + 13}" y="{legend_y + 1}">'
            f"{html.escape(name)}</text>"
        )
    out.append("</svg>")
    return "".join(out)


def _svg_timeline(rows: Dict[str, np.ndarray], width: int = 760) -> str:
    """rows: name -> per-frame label array; all resampled to `width` px."""
    row_h, gap, label_w = 16, 4, 36
    height = (row_h + gap) * len(rows) + 4
    out = [
        f'<svg width="{width + label_w}" height="{height}" '
        f'font-family="sans-serif" font-size="10">'
    ]
    for r, (name, labels) in enumerate(rows.items()):
        labels = np.asarray(labels)
        y = r * (row_h + gap)
        out.append(
            f'<text x="0" y="{y + row_h - 4}">{html.escape(name)}</text>'
        )
        if labels.size == 0:
            continue
        # resample to pixel columns, then merge equal-color runs
        idx = (np.arange(width) * labels.size // width).clip(0, labels.size - 1)
        cols = labels[idx]
        run_start = 0
        for i in range(1, width + 1):
            if i == width or cols[i] != cols[run_start]:
                out.append(
                    f'<rect x="{label_w + run_start}" y="{y}" '
                    f'width="{i - run_start}" height="{row_h}" '
                    f'fill="{_color(int(cols[run_start]))}"/>'
                )
                run_start = i
    out.append("</svg>")
    return "".join(out)


def load_run_config(path: Path) -> dict:
    """A run folder's `config.yaml` as a dict: JSON (the port's), else YAML
    (the JAX package's, through pyyaml)."""
    text = Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def _load_events(run_folder: Path):
    path = run_folder / "events.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in open(path) if line.strip()]


def render_report(run_folder: Path, max_videos: int = 24) -> str:
    """Render the full HTML report string for a run folder."""
    run_folder = Path(run_folder)
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>mucon-tpu run report: {html.escape(str(run_folder))}</title>",
        "<style>body{font-family:sans-serif;margin:24px;max-width:900px}"
        "h2{border-bottom:1px solid #ccc;padding-bottom:4px}"
        "pre{background:#f6f6f6;padding:8px;overflow-x:auto}"
        ".video{margin-bottom:14px}</style></head><body>",
        f"<h1>mucon-tpu run report</h1><p><code>{html.escape(str(run_folder))}"
        "</code></p>",
    ]

    cfg_path = run_folder / "config.yaml"
    if cfg_path.exists():
        cfg = load_run_config(cfg_path)
        parts.append("<h2>Config</h2><pre>")
        parts.append(html.escape(
            f"experiment: {cfg.get('experiment_name')}\n"
            f"dataset: {cfg['dataset']['name']} split {cfg['dataset']['split']}\n"
            f"trainer: {cfg['trainer']['optimizer']} "
            f"lr={cfg['trainer']['learning_rate']} "
            f"epochs={cfg['trainer']['num_epochs']} "
            f"batch={cfg['tpu']['batch_size']}"
        ))
        parts.append("</pre>")

    events = _load_events(run_folder)
    epoch_events = [e for e in events if e.get("kind") == "epoch"]
    if epoch_events:
        parts.append("<h2>Training losses</h2>")
        terms = [
            k for k in ("main", "transcript_loss", "mucon_loss",
                        "length_loss", "smoothing_loss",
                        "classification_loss", "supervised_length_loss")
            if any(k in e for e in epoch_events)
        ]
        series = {
            t: [(e["step"], e[t]) for e in epoch_events if t in e]
            for t in terms
        }
        parts.append(_svg_line_chart(
            {"main": series.pop("main")}, title="main loss / epoch"
        ))
        if series:
            parts.append(_svg_line_chart(series, title="loss terms / epoch"))

    eval_events = [e for e in events if str(e.get("kind", "")).startswith("eval")]
    if eval_events:
        keys = [k for k in ("vit_mof", "y_mof", "s_mof", "s_mat_score")
                if any(k in e for e in eval_events)]
        series = {
            k: [(e["step"], e[k]) for e in eval_events if k in e] for k in keys
        }
        if series:
            parts.append("<h2>Eval metrics</h2>")
            parts.append(_svg_line_chart(series, title="eval metrics / epoch"))

    pkls = sorted(run_folder.rglob("data_*.pkl"))
    if pkls:
        pkl = pkls[-1]
        data = pickle.load(open(pkl, "rb"))
        n = len(data.get("target_segs", []))
        parts.append(
            f"<h2>Segmentations</h2><p><code>"
            f"{html.escape(str(pkl.relative_to(run_folder)))}</code>: "
            f"{n} videos (showing up to {max_videos})</p>"
        )
        for i in range(min(n, max_videos)):
            rows = {}
            for label, key in (("GT", "target_segs"), ("y", "y_segs"),
                               ("s", "s_segs"), ("vit", "vit_segs")):
                seq = data.get(key)
                if seq is not None and i < len(seq) and len(seq[i]):
                    rows[label] = np.asarray(seq[i])
            if not rows:
                continue
            gt = np.asarray(data["target_segs"][i])
            vit = rows.get("vit")
            mof = (
                float(np.mean(gt == vit[: len(gt)]))
                if vit is not None and len(vit) >= len(gt)
                else float("nan")
            )
            tr = list(data.get("s_transcript", [[]] * n)[i])
            parts.append(
                f"<div class='video'><b>video {i}</b> — {len(gt)} frames, "
                f"vit_mof={mof:.3f}, predicted transcript "
                f"{html.escape(str(tr))}<br>{_svg_timeline(rows)}</div>"
            )

    parts.append("</body></html>")
    return "".join(parts)


def write_report(run_folder: Path, out_path: Optional[Path] = None,
                 max_videos: int = 24) -> Path:
    run_folder = Path(run_folder)
    out_path = Path(out_path) if out_path else run_folder / "report.html"
    out_path.write_text(render_report(run_folder, max_videos=max_videos))
    return out_path
