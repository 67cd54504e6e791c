"""mucon_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of mucon_tpu.

The JAX package `mucon_tpu` stays the reference; this package mirrors its
layout module for module (`models/`, `ops/`, `cli/`) and replaces every
Pallas TPU kernel on the serving path with a CUDA C++ kernel written by
hand for `sm_90a` (`csrc/`, built and bound by `mucon_tpu_torch.cuda`).

Numerics: everything runs in float32.  TF32 is switched off here, once,
for cuBLAS matmuls and cuDNN, because CPU JAX (the test oracle) runs true
f32 and a TF32 product keeps only ~3 decimal digits.

This package imports torch and never jax or flax; the only `mucon_tpu`
modules it uses are the jax-free data helpers (`mucon_tpu.data`) and
`mucon_tpu.decode.viterbi_host.Segment`.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without CUDA raises —
    the port never carries on on the CPU when asked for the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} requested but torch.cuda.is_available() is False"
        )
    return device
