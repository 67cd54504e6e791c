"""Breakfast dataset factory (mucon_tpu/data/breakfast.py; the reference's
src/core/datasets/breakfast.py)."""

from pathlib import Path

from mucon_tpu_torch.data.general_dataset import GeneralDataset

POSSIBLE_SPLITS = [1, 2, 3, 4]
MAX_TRANSCRIPT_LENGTH = 30
KINETICS_FEAT_NAME = "i3d"
FEAT_DIM_MAPPING = {KINETICS_FEAT_NAME: 2048}


def _db_path(cfg) -> Path:
    return Path(cfg.dataset.root) / f"breakfast_{cfg.dataset.feat_name}"


def _finalize(db, cfg, prefix: str, set_name: str):
    db.end_class_id = 0
    db.mof_eval_ignore_classes = []
    db.background_class_ids = [0]
    db.convenient_name = f"{prefix}breakfast_split{cfg.dataset.split}_{set_name}"
    db.split = cfg.dataset.split
    db.max_transcript_length = MAX_TRANSCRIPT_LENGTH
    return db


def create_breakfast_dataset(cfg, train: bool = True) -> GeneralDataset:
    split = cfg.dataset.split
    assert split in POSSIBLE_SPLITS
    set_name = "train" if train else "test"
    db_path = _db_path(cfg)
    db = GeneralDataset(
        cfg=cfg,
        root=db_path,
        relative_path_to_list=f"split{split}.{set_name}",
        relative_path_to_mapping=cfg.dataset.mapping_file_name,
        feat_dim=FEAT_DIM_MAPPING[cfg.dataset.feat_name],
        relative_path_to_train_list=f"split{split}.train",
    )
    return _finalize(db, cfg, "", set_name)
