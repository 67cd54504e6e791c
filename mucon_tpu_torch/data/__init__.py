"""Host-side data helpers of the port: per-video samples, the padded
collate and the length-bucketed batch loader (mucon_tpu/data), in numpy.

The loader takes any dataset with `len` and indexing that yields
`Sample`-like objects (a `mucon_tpu` dataset works as it is, by duck
typing)."""

from mucon_tpu_torch.data.batching import PaddedBatch, PaddedBatchLoader, Sample, collate_padded
from mucon_tpu_torch.data.utils import create_tf_input, create_tf_target

__all__ = ["PaddedBatch", "PaddedBatchLoader", "Sample", "collate_padded",
           "create_tf_input", "create_tf_target"]
