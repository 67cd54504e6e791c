"""Host helpers of the port (mucon_tpu/utils)."""

from mucon_tpu_torch.utils.sizing import make_same_size_interpolate

__all__ = ["make_same_size_interpolate"]
