"""Host-side data of the port (mucon_tpu/data), in numpy: the datasets on
disk (`GeneralDataset` and its fully and mixed supervised variants, the
Breakfast and synthetic factories and the Breakfast-format fixture),
per-video samples, the padded collate and the length-bucketed batch
loader.

The loader takes any dataset with `len` and indexing that yields
`Sample`-like objects (a `mucon_tpu` dataset works as it is, by duck
typing)."""

from mucon_tpu_torch.data.batching import PaddedBatch, PaddedBatchLoader, collate_padded
from mucon_tpu_torch.data.breakfast import (
    create_breakfast_dataset,
    create_fully_supervised_breakfast_dataset,
    create_mixed_supervision_breakfast_dataset,
)
from mucon_tpu_torch.data.general_dataset import (
    FullySupervisedSample,
    GeneralDataset,
    GeneralFullySupervisedDataset,
    GeneralMixedSupervisionDataset,
    MixedSupervisionSample,
    Sample,
)
from mucon_tpu_torch.data.synthetic import (
    create_fully_supervised_synthetic_dataset,
    create_mixed_supervision_synthetic_dataset,
    create_synthetic_dataset,
    materialize_synthetic_dataset,
)
from mucon_tpu_torch.data.utils import (
    create_tf_input,
    create_tf_target,
    segment_to_labels,
    summarize_list,
    unsummarize_list,
)


def handel_dataset(cfg, train: bool) -> GeneralDataset:
    """Dataset dispatch (the name, typo and all, of the reference API:
    src/core/datasets/__init__.py:16-21)."""
    name = cfg.dataset.name
    if name == "breakfast":
        return create_breakfast_dataset(cfg=cfg, train=train)
    if name == "synthetic":
        return create_synthetic_dataset(cfg=cfg, train=train)
    raise ValueError(f"Invalid dataset name. ({name})")


handle_dataset = handel_dataset


def handel_fully_supervised_dataset(cfg, train: bool) -> GeneralFullySupervisedDataset:
    if cfg.dataset.name == "breakfast":
        return create_fully_supervised_breakfast_dataset(cfg=cfg, train=train)
    if cfg.dataset.name == "synthetic":
        return create_fully_supervised_synthetic_dataset(cfg=cfg, train=train)
    raise ValueError(f"Invalid dataset name. ({cfg.dataset.name})")


def handel_mixed_supervision_dataset(cfg, train: bool) -> GeneralMixedSupervisionDataset:
    if cfg.dataset.name == "breakfast":
        return create_mixed_supervision_breakfast_dataset(cfg=cfg, train=train)
    if cfg.dataset.name == "synthetic":
        return create_mixed_supervision_synthetic_dataset(cfg=cfg, train=train)
    raise ValueError(f"Invalid dataset name. ({cfg.dataset.name})")


__all__ = ["FullySupervisedSample", "GeneralDataset", "GeneralFullySupervisedDataset",
           "GeneralMixedSupervisionDataset", "MixedSupervisionSample", "PaddedBatch",
           "PaddedBatchLoader", "Sample", "collate_padded", "create_breakfast_dataset",
           "create_fully_supervised_breakfast_dataset",
           "create_fully_supervised_synthetic_dataset",
           "create_mixed_supervision_breakfast_dataset",
           "create_mixed_supervision_synthetic_dataset", "create_synthetic_dataset",
           "create_tf_input", "create_tf_target", "handel_dataset",
           "handel_fully_supervised_dataset", "handel_mixed_supervision_dataset",
           "handle_dataset", "materialize_synthetic_dataset", "segment_to_labels",
           "summarize_list", "unsummarize_list"]
