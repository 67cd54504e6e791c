"""Persisted metric series — the fandak `trainer.metrics` contract
(mucon_tpu/harness/metrics_store.py).

Call-site contract (train_test_mucon.py:68-71): `metrics[name]` supports
`.set_value(value, epoch)` and `.save()`; values can be arbitrary objects
(the reference stores whole MuConEvaluatorResult instances).  Each series
persists as a pickle plus a best-effort JSON mirror for humans.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
from typing import Any, List, Tuple


def _jsonable(v: Any):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {k: _jsonable(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item"):
        try:
            return v.item()
        except Exception:
            pass
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


class MetricSeries:
    def __init__(self, name: str, folder: Path):
        self.name = name
        self.folder = Path(folder)
        self.values: List[Tuple[int, Any]] = []

    def set_value(self, value: Any, epoch: int) -> None:
        self.values.append((epoch, value))

    def last(self):
        return self.values[-1][1] if self.values else None

    def save(self) -> None:
        self.folder.mkdir(parents=True, exist_ok=True)
        with open(self.folder / f"{self.name}.pkl", "wb") as f:
            pickle.dump(self.values, f)
        with open(self.folder / f"{self.name}.json", "w") as f:
            json.dump(
                [{"epoch": e, "value": _jsonable(v)} for e, v in self.values],
                f,
                indent=2,
            )

    def load(self) -> None:
        p = self.folder / f"{self.name}.pkl"
        if p.exists():
            with open(p, "rb") as f:
                self.values = pickle.load(f)


class MetricStore(dict):
    """dict of MetricSeries, auto-creating on first access."""

    def __init__(self, folder: Path):
        super().__init__()
        self.folder = Path(folder)

    def __missing__(self, key: str) -> MetricSeries:
        series = MetricSeries(key, self.folder)
        self[key] = series
        return series
