"""Synthetic dataset with the exact disk contract (mucon_tpu/data/synthetic.py:
the same bytes for the same arguments).

Generates learnable random videos (per-class feature prototypes + noise) and
writes them in the same layout as Breakfast (features/ labels/ transcripts/
lengths/ split1.{train,test} mapping.txt), so every layer above L0 —
including the real `GeneralDataset` file loader — is exercised without the
real dataset on disk.  Used by the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from mucon_tpu_torch.data.general_dataset import (
    GeneralDataset,
    GeneralFullySupervisedDataset,
    GeneralMixedSupervisionDataset,
)


def _write_atomic(path: Path, write) -> None:
    """`write(f)` into a temporary file of its own, renamed over `path`:
    ranks that materialize the same dataset at once never read a file that
    another is still writing (the bytes are the same)."""
    with tempfile.NamedTemporaryFile(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp",
                                     delete=False) as f:
        write(f)
    os.chmod(f.name, 0o644)  # a temporary file is made 0600
    os.replace(f.name, path)


def _write_text(path: Path, text: str) -> None:
    _write_atomic(path, lambda f: f.write(text.encode()))


def materialize_synthetic_dataset(
    root: Path,
    num_videos: int = 32,
    num_classes: int = 48,
    feat_dim: int = 2048,
    min_len: int = 256,
    max_len: int = 2048,
    seed: int = 0,
    train_fraction: float = 0.75,
    noise: float = 1.0,
    n_splits: int = 1,
) -> Path:
    """Write a synthetic dataset to `root` (idempotent). Returns `root`.

    With `n_splits > 1`, writes split{1..n}.{train,test} as rotating
    cross-validation folds (the Breakfast split convention,
    breakfast.py:POSSIBLE_SPLITS); split1 keeps the `train_fraction`
    partition for backward compatibility when n_splits == 1."""
    root = Path(root)
    done_marker = root / ".complete"
    if done_marker.exists():
        return root
    rng = np.random.RandomState(seed)
    for sub in ("features", "labels", "transcripts", "lengths"):
        (root / sub).mkdir(parents=True, exist_ok=True)

    _write_text(root / "mapping.txt", "0 background\n" + "".join(
        f"{c} action_{c}\n" for c in range(1, num_classes)))

    prototypes = rng.randn(num_classes, feat_dim).astype(np.float32)

    names = []
    for v in range(num_videos):
        name = f"vid_{v:04d}"
        names.append(name)
        n_segments = rng.randint(3, 9)
        # background bookends like Breakfast; distinct consecutive actions
        transcript = [0]
        while len(transcript) < n_segments - 1:
            c = rng.randint(1, num_classes)
            if c != transcript[-1]:
                transcript.append(c)
        transcript.append(0)
        transcript = np.array(transcript, dtype=np.int64)

        T = int(rng.randint(min_len, max_len + 1))
        w = rng.dirichlet(np.ones(len(transcript)) * 3.0)
        lengths = np.maximum(1, np.round(w * T).astype(np.int64))
        lengths[-1] += T - lengths.sum()  # exact total
        if lengths[-1] < 1:
            lengths[np.argmax(lengths)] += lengths[-1] - 1
            lengths[-1] = 1

        labels = np.repeat(transcript, lengths)
        feats = prototypes[labels] + noise * rng.randn(T, feat_dim).astype(
            np.float32
        )

        for sub, arr in (("features", feats.astype(np.float32)), ("labels", labels),
                         ("transcripts", transcript), ("lengths", lengths.astype(np.float32))):
            _write_atomic(root / sub / f"{name}.npy", lambda f, a=arr: np.save(f, a))

    if n_splits <= 1:
        n_train = max(1, int(round(train_fraction * num_videos)))
        _write_text(root / "split1.train", "\n".join(names[:n_train]) + "\n")
        _write_text(root / "split1.test", "\n".join(names[n_train:] or names[:1]) + "\n")
    else:
        fold = max(1, num_videos // n_splits)
        for s in range(1, n_splits + 1):
            test = names[(s - 1) * fold : s * fold] or names[:1]
            train = [n for n in names if n not in test] or names[:1]
            _write_text(root / f"split{s}.train", "\n".join(train) + "\n")
            _write_text(root / f"split{s}.test", "\n".join(test) + "\n")
    done_marker.touch()
    return root


def _synthetic_root(cfg) -> Path:
    s = cfg.dataset.synthetic
    tf = float(getattr(s, "train_fraction", 0.75))
    suffix = "" if tf == 0.75 else f"_tf{tf:g}"
    root = Path(cfg.dataset.root) / (
        f"synthetic_v{s.num_videos}_c{s.num_classes}_d{s.feat_dim}"
        f"_l{s.min_len}-{s.max_len}_s{s.seed}{suffix}"
    )
    materialize_synthetic_dataset(
        root,
        num_videos=s.num_videos,
        num_classes=s.num_classes,
        feat_dim=s.feat_dim,
        min_len=s.min_len,
        max_len=s.max_len,
        seed=s.seed,
        train_fraction=tf,
    )
    return root


def _finalize(db, set_name: str, prefix: str = ""):
    db.end_class_id = 0
    db.mof_eval_ignore_classes = []
    db.background_class_ids = [0]
    db.convenient_name = f"{prefix}synthetic_{set_name}"
    db.split = 1
    db.max_transcript_length = 30
    return db


def create_synthetic_dataset(cfg, train: bool = True) -> GeneralDataset:
    root = _synthetic_root(cfg)
    set_name = "train" if train else "test"
    db = GeneralDataset(
        cfg=cfg,
        root=root,
        relative_path_to_list=f"split1.{set_name}",
        relative_path_to_mapping="mapping.txt",
        feat_dim=cfg.dataset.synthetic.feat_dim,
        relative_path_to_train_list="split1.train",
    )
    return _finalize(db, set_name)


def create_fully_supervised_synthetic_dataset(cfg, train: bool = True
                                              ) -> GeneralFullySupervisedDataset:
    """The supervised dataset over the same root (lengths/*.npy are always
    written)."""
    set_name = "train" if train else "test"
    db = GeneralFullySupervisedDataset(
        cfg=cfg,
        root=_synthetic_root(cfg),
        relative_path_to_list=f"split1.{set_name}",
        relative_path_to_mapping="mapping.txt",
        feat_dim=cfg.dataset.synthetic.feat_dim,
    )
    return _finalize(db, set_name, "fully_supervised_")


def create_mixed_supervision_synthetic_dataset(cfg, train: bool = True
                                               ) -> GeneralMixedSupervisionDataset:
    set_name = "train" if train else "test"
    pct = cfg.dataset.mixed.full_supervision_percentage
    db = GeneralMixedSupervisionDataset(
        cfg=cfg,
        root=_synthetic_root(cfg),
        relative_path_to_list=f"split1.{set_name}",
        relative_path_to_mapping="mapping.txt",
        feat_dim=cfg.dataset.synthetic.feat_dim,
        full_supervision_percentage=pct,
    )
    return _finalize(db, set_name, f"mixed_supervision_percentage_{pct}_")
