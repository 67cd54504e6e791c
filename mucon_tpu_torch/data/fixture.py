"""Breakfast-format fixture: the exact disk contract at test scale
(mucon_tpu/data/fixture.py).

Writes `<dataset_root>/breakfast_<feat_name>/` with the layout the real
Breakfast download has (reference src/core/datasets/general_dataset.py:78-101
+ breakfast.py:11-16):

    features/<video>.npy      [T x FEAT_DIM_MAPPING[feat_name]] float32
    labels/<video>.npy        [T]   int64 framewise ids
    transcripts/<video>.npy   [N]   int64 ordered action ids
    lengths/<video>.npy       [N]   segment lengths (supervised variants)
    split{1..4}.{train,test}  newline video-name lists (cross-val folds)
    mapping.txt               "<id> <name>" lines, id 0 = background

so `create_breakfast_dataset` runs end to end in the tests through the
same file-parsing paths real Breakfast would take; pointing `dataset.root`
at the real download is then a drop-in.
"""

from __future__ import annotations

from pathlib import Path

from mucon_tpu_torch.data.breakfast import FEAT_DIM_MAPPING, POSSIBLE_SPLITS
from mucon_tpu_torch.data.synthetic import materialize_synthetic_dataset


def materialize_breakfast_fixture(
    dataset_root: Path,
    feat_name: str = "i3d",
    num_videos: int = 12,
    num_classes: int = 48,
    min_len: int = 120,
    max_len: int = 300,
    seed: int = 0,
) -> Path:
    """Write the fixture under `<dataset_root>/breakfast_<feat_name>/`
    (idempotent) and return that directory."""
    root = Path(dataset_root) / f"breakfast_{feat_name}"
    return materialize_synthetic_dataset(
        root,
        num_videos=num_videos,
        num_classes=num_classes,
        feat_dim=FEAT_DIM_MAPPING[feat_name],
        min_len=min_len,
        max_len=max_len,
        seed=seed,
        n_splits=len(POSSIBLE_SPLITS),
    )
