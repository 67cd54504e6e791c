"""Host-side data of the port (mucon_tpu/data), in numpy: the datasets on
disk (`GeneralDataset`, the Breakfast and synthetic factories and the
Breakfast-format fixture), per-video samples, the padded collate and the
length-bucketed batch loader.

The loader takes any dataset with `len` and indexing that yields
`Sample`-like objects (a `mucon_tpu` dataset works as it is, by duck
typing)."""

from mucon_tpu_torch.data.batching import PaddedBatch, PaddedBatchLoader, collate_padded
from mucon_tpu_torch.data.breakfast import create_breakfast_dataset
from mucon_tpu_torch.data.general_dataset import GeneralDataset, Sample
from mucon_tpu_torch.data.synthetic import (
    create_synthetic_dataset,
    materialize_synthetic_dataset,
)
from mucon_tpu_torch.data.utils import create_tf_input, create_tf_target


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

__all__ = ["GeneralDataset", "PaddedBatch", "PaddedBatchLoader", "Sample", "collate_padded",
           "create_breakfast_dataset", "create_synthetic_dataset",
           "create_tf_input", "create_tf_target", "handel_dataset", "handle_dataset",
           "materialize_synthetic_dataset"]
