"""Observability (mucon_tpu/harness/logging.py): the run's `events.jsonl`,
step timing and an on-demand profile.

Every run writes machine-readable `events.jsonl` lines with the JAX
package's keys (`kind`, `step`, `time` and the event's scalars).  The JAX
package also mirrors the scalars to TensorBoard where it can; the port does
not.  `profile()` traces with `torch.profiler` (CPU and CUDA activities)
into `<run folder>/profile/` as a Chrome trace, in place of `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Optional

import torch


class RunLogger:
    def __init__(self, folder: Path):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self._f = open(self.folder / "events.jsonl", "a", buffering=1)

    def log(self, kind: str, step: int, **scalars) -> None:
        rec = {"kind": kind, "step": step, "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")

    @contextlib.contextmanager
    def profile(self, enabled: bool = True):
        """torch.profiler trace of the block into <folder>/profile/trace.json."""
        if not enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        out = self.folder / "profile"
        out.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(str(out / "trace.json"))

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Rolling wall-clock throughput meter."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.items = []

    def tick(self, n_items: int = 1) -> None:
        self.times.append(time.perf_counter())
        self.items.append(n_items)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.items.pop(0)

    @property
    def items_per_sec(self) -> Optional[float]:
        if len(self.times) < 2:
            return None
        dt = self.times[-1] - self.times[0]
        return sum(self.items[1:]) / dt if dt > 0 else None
