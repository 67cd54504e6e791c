"""mucon_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of mucon_tpu.

The JAX package `mucon_tpu` stays the reference; this package mirrors its
layout module for module (`data/`, `models/`, `ops/`, `harness/`, `cli/`)
and replaces every Pallas TPU kernel on the serving path and the train
step with a CUDA C++ kernel written by hand for `sm_90a` (`csrc/`, built
and bound by `mucon_tpu_torch.cuda`).  Its entry points run on the card
unless the caller asks for the CPU.

Numerics: everything runs in float32.  TF32 is switched off here, once,
for cuBLAS matmuls and cuDNN, because CPU JAX (the test oracle) runs true
f32 and a TF32 product keeps only ~3 decimal digits.

This package imports torch and numpy and never jax, flax or any module of
`mucon_tpu`: what it needs of that package's host code (the padded
collate, the batch loader, `Segment`) it keeps as its own copy.
"""

import torch

from mucon_tpu_torch.version import __version__

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["__version__", "resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises —
    the port never carries on on the CPU when asked for the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} requested but torch.cuda.is_available() is False"
        )
    return device
