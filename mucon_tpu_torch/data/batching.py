"""Padded, length-bucketed, prefetched batching (mucon_tpu/data/batching.py).

Videos are padded into [B x T_pad x D] batches, T_pad rounded up to a
multiple (or one fixed `pad_to` for every batch), transcripts padded to the
dataset's maximum length; the `num_frames` / `transcript_len` vectors say
what is real.  Each epoch the loader shuffles, sorts by frame count inside
a window of 16 batches and shuffles the batches, so a batch holds videos of
similar length.  For the same seed and epoch the plan is the JAX loader's
with its defaults.  A background thread collates the next batches while
the caller trains.

With `fixed_batches` (the device batch cache, `tpu.cache_batches`) the
batches' composition is frozen (runs of the length-sorted videos) and only
their order is shuffled each epoch, so a batch is a stable unit that a
cache can key on; `iter_cached_keys` gives an epoch's plan without
touching the features.  With `batch_divisor` (the mesh's data axis) a batch
whose size it does not divide, the remainder, is dropped with a one-time
warning, and a divisible remainder is kept (batching.py:132, 170-195).
"""

from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class PaddedBatch:
    """A batch of padded videos (host numpy): B videos, T_pad frames, D
    features, N_max transcript slots."""

    feats: np.ndarray  # [B x T_pad x D] float32
    num_frames: np.ndarray  # [B] int32, true T_i
    gt_label: np.ndarray  # [B x T_pad] int32 (0-padded)
    transcript: np.ndarray  # [B x N_max] int32 (0-padded)
    transcript_len: np.ndarray  # [B] int32, true N_i
    tf_input: np.ndarray  # [B x (N_max + 1)] int32, SOS + transcript
    tf_target: np.ndarray  # [B x (N_max + 1)] int32, transcript + EOS
    absolute_lengths: np.ndarray  # [B x N_max] float32 (zeros when weak)
    fully_supervised: np.ndarray  # [B] bool
    video_names: List[str]

    @property
    def batch_size(self) -> int:
        return self.feats.shape[0]


def collate_padded(samples: Sequence, n_max: int, pad_multiple: int = 512,
                   t_pad: Optional[int] = None) -> PaddedBatch:
    """Pad a list of per-video samples into one batch, T_pad the longest
    video rounded up to `pad_multiple`, or `t_pad` (a multiple of 16: the
    encoder pools 16x)."""
    B = len(samples)
    max_t = max(s.feats.shape[0] for s in samples)
    if t_pad is None:
        t_pad = -(-max_t // pad_multiple) * pad_multiple
    if t_pad % 16 or t_pad < max_t:
        raise ValueError(f"T_pad {t_pad} is not a multiple of 16 at least {max_t}")
    D = samples[0].feats.shape[1]

    feats = np.zeros((B, t_pad, D), np.float32)
    gt = np.zeros((B, t_pad), np.int32)
    num_frames = np.zeros(B, np.int32)
    transcript = np.zeros((B, n_max), np.int32)
    n_len = np.zeros(B, np.int32)
    tf_in = np.zeros((B, n_max + 1), np.int32)
    tf_tg = np.zeros((B, n_max + 1), np.int32)
    abs_len = np.zeros((B, n_max), np.float32)
    full_sup = np.zeros(B, bool)
    for i, s in enumerate(samples):
        t, n = s.feats.shape[0], s.transcript.shape[0]
        if n > n_max:
            raise ValueError(f"transcript length {n} exceeds n_max {n_max}")
        feats[i, :t] = s.feats
        gt[i, :t] = s.gt_label
        num_frames[i] = t
        transcript[i, :n] = s.transcript
        n_len[i] = n
        tf_in[i, : n + 1] = s.transcript_tf_input
        tf_tg[i, : n + 1] = s.transcript_tf_target
        if getattr(s, "absolute_lengths", None) is not None:
            abs_len[i, :n] = s.absolute_lengths
        full_sup[i] = bool(getattr(s, "fully_supervised", False))
    return PaddedBatch(
        feats=feats, num_frames=num_frames, gt_label=gt, transcript=transcript,
        transcript_len=n_len, tf_input=tf_in, tf_target=tf_tg,
        absolute_lengths=abs_len, fully_supervised=full_sup,
        video_names=[s.video_name for s in samples],
    )


class PaddedBatchLoader:
    """Length-bucketed batch iterator with optional background prefetch.

    `dataset` needs `len`, indexing that yields `Sample`-like objects and
    `max_transcript_length`; a `num_frames(i)` method, where it has one,
    gives the lengths without loading the features."""

    def __init__(self, dataset, batch_size: int, pad_multiple: int = 512,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 pad_to: Optional[int] = None, fixed_batches: bool = False,
                 batch_divisor: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_multiple = pad_multiple
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.fixed_batches = fixed_batches
        self.pad_to = pad_to  # one T_pad for every batch (single-shape eval)
        # a sharded batch splits evenly over the mesh's data axis; dummy
        # videos would dilute the loss, so a remainder it does not divide
        # is dropped (the same videos every epoch under fixed_batches)
        self.batch_divisor = max(1, batch_divisor)
        self._warned_drop = False
        self.epoch = 0
        self.n_max = dataset.max_transcript_length
        frames = getattr(dataset, "num_frames", None)
        self._lengths = np.array([
            frames(i) if frames is not None else dataset[i].feats.shape[0]
            for i in range(len(dataset))
        ])

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        sizes = [b] * (n // b) + ([n % b] if n % b else [])
        return sum(s % self.batch_divisor == 0 for s in sizes)

    def _filter_batches(self, batches: List[np.ndarray]) -> List[np.ndarray]:
        """The batches whose size `batch_divisor` divides; the first drop
        warns."""
        kept = [b for b in batches if len(b) % self.batch_divisor == 0]
        if len(kept) < len(batches) and not self._warned_drop:
            lost = sum(map(len, batches)) - sum(map(len, kept))
            warnings.warn(
                f"PaddedBatchLoader: dropping {lost} video(s) whose remainder batch is not "
                f"divisible by the mesh data axis ({self.batch_divisor}); with fixed_batches "
                f"these are the SAME videos every epoch -- pick a batch size so that "
                f"len(dataset) % batch_size % {self.batch_divisor} == 0 to train on "
                f"everything", stacklevel=3)
            self._warned_drop = True
        return kept

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.fixed_batches:
            order = np.argsort(self._lengths, kind="stable")
            batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
            batches = self._filter_batches(batches)
            if self.shuffle:
                rng.shuffle(batches)
            return batches
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        # stable sort by length inside windows of the shuffled order
        window = self.batch_size * 16
        chunks = [order[i : i + window] for i in range(0, n, window)]
        order = np.concatenate([c[np.argsort(self._lengths[c], kind="stable")] for c in chunks])
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        batches = self._filter_batches(batches)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def iter_cached_keys(self):
        """One epoch's plan as (video-name tuple, size) pairs, the device
        cache's keys, computed without reading a feature; advances the
        epoch's shuffle state exactly as one `__iter__` pass does."""
        if not self.fixed_batches:
            raise ValueError("cache replay needs fixed_batches")
        batches = self._batch_indices()
        self.epoch += 1
        names = self.dataset.file_names
        for idxs in batches:
            yield tuple(names[int(i)] for i in idxs), len(idxs)

    def _make_batch(self, idxs: np.ndarray) -> PaddedBatch:
        return collate_padded([self.dataset[int(i)] for i in idxs], self.n_max,
                              self.pad_multiple, t_pad=self.pad_to)

    def __iter__(self) -> Iterator[PaddedBatch]:
        batches = self._batch_indices()
        self.epoch += 1
        if self.prefetch <= 0:
            for idxs in batches:
                yield self._make_batch(idxs)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for idxs in batches:
                    q.put(self._make_batch(idxs))
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
