"""Prediction/target length reconciliation (mucon_tpu/utils/sizing.py).

`make_same_size_interpolate` reproduces torch's 1-D nearest-neighbor
interpolation exactly: output[i] = input[floor(i * in_len / out_len)].
"""

import numpy as np


def make_same_size_interpolate(
    prediction: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """Nearest-neighbor resize of a label sequence to the target's length."""
    prediction = np.asarray(prediction)
    t_len, p_len = len(target), len(prediction)
    if p_len == t_len:
        return prediction.astype(np.int64)
    idx = (np.arange(t_len) * (p_len / t_len)).astype(np.int64)
    idx = np.clip(idx, 0, p_len - 1)
    return prediction[idx].astype(np.int64)
