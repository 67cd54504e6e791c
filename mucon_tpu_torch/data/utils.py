"""Teacher-forcing sequences and list helpers (mucon_tpu/data/utils.py)."""

from typing import Any, Iterable, List, Tuple

import numpy as np


def create_tf_input(transcript: Iterable[int], sos_i: int) -> np.ndarray:
    """SOS + transcript (the teacher-forced decoder input)."""
    return np.array([sos_i] + list(transcript), dtype=np.int64)


def create_tf_target(transcript: Iterable[int], eos_i: int) -> np.ndarray:
    """transcript + EOS (the teacher-forced decoder target)."""
    return np.array(list(transcript) + [eos_i], dtype=np.int64)


def summarize_list(the_list: List[Any]) -> Tuple[List[Any], List[int]]:
    """Run-length encode: [4, 5, 5, 6] -> ([4, 5, 6], [1, 2, 1])."""
    summary: List[Any] = []
    lens: List[int] = []
    for item in the_list:
        if summary and item == summary[-1]:
            lens[-1] += 1
        else:
            summary.append(item)
            lens.append(1)
    return summary, lens


def unsummarize_list(labels: List[int], lengths: List[int]) -> List[int]:
    """Inverse of summarize_list."""
    if len(labels) != len(lengths):
        raise ValueError(f"{len(labels)} labels but {len(lengths)} lengths")
    return [label for label, length in zip(labels, lengths) for _ in range(length)]


def segment_to_labels(transcript, lengths) -> np.ndarray:
    """Expand (transcript, per-segment lengths) to frame-level labels (an
    empty transcript gives no labels, where the JAX package's raises)."""
    return np.repeat(np.asarray(transcript), np.asarray(lengths, np.int64))
