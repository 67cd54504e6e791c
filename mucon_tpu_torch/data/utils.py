"""Teacher-forcing sequences (mucon_tpu/data/utils.py:8, 13)."""

from typing import Iterable

import numpy as np


def create_tf_input(transcript: Iterable[int], sos_i: int) -> np.ndarray:
    """SOS + transcript (the teacher-forced decoder input)."""
    return np.array([sos_i] + list(transcript), dtype=np.int64)


def create_tf_target(transcript: Iterable[int], eos_i: int) -> np.ndarray:
    """transcript + EOS (the teacher-forced decoder target)."""
    return np.array(list(transcript) + [eos_i], dtype=np.int64)
