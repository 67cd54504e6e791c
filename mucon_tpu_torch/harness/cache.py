"""The byte budget of the device batch cache, shared by the trainer and its
evaluators (mucon_tpu/harness/cache.py).

With `tpu.cache_batches` the trainer keeps each fixed batch's tensors on
the card after their first copy, so from epoch 2 on an epoch reads no
file, collates nothing and copies nothing.  `tpu.cache_budget_gb` caps the
bytes so held: batches are cached first come, first served until the
budget is spent, and later batches stream every epoch.  The trainer's loop
fills the budget first; its evaluators share the same budget object, and
`tpu.cache_budget_eval_gb` carves out of it a reserve that only the
evaluators' pool may use.

At Breakfast scale (~1.46k train videos of ~1.5-2k frames x 2048) the
train set is ~20-25 GB as float32 and ~6 GB on the int8 wire, within the
H100's 80 GB.
"""

from __future__ import annotations


class CacheBudget:
    """First-come, first-served byte reservation for device batch caches.

    `budget_bytes <= 0` means unlimited.  `eval_reserve_bytes` is a slice
    the train pool may not take, so the eval set (replayed every eval)
    still caches when the train set alone would fill the budget; the eval
    pool may also use whatever the train pool left.  The first refusal of
    each pool is printed once."""

    def __init__(self, budget_bytes: int = 0, eval_reserve_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self.eval_reserve_bytes = int(eval_reserve_bytes)
        self.reserved_train = 0
        self.reserved_eval = 0
        self._exhausted_logged = set()

    @property
    def reserved_bytes(self) -> int:
        return self.reserved_train + self.reserved_eval

    @classmethod
    def from_config(cls, cfg) -> "CacheBudget":
        gb = float(cfg.tpu.cache_budget_gb or 0.0)
        ev = float(cfg.tpu.cache_budget_eval_gb or 0.0)
        return cls(int(gb * (1 << 30)), int(ev * (1 << 30)))

    def try_reserve(self, nbytes: int, what: str = "batch", pool: str = "train") -> bool:
        if self.budget_bytes <= 0:
            return True
        if pool == "eval":
            # the reserve and whatever the train pool left
            fits = self.reserved_bytes + nbytes <= self.budget_bytes
        else:
            # leave the eval reserve, less what eval already used of it
            headroom = max(self.eval_reserve_bytes - self.reserved_eval, 0)
            fits = self.reserved_bytes + nbytes + headroom <= self.budget_bytes
        if fits:
            if pool == "eval":
                self.reserved_eval += nbytes
            else:
                self.reserved_train += nbytes
            return True
        if pool not in self._exhausted_logged:
            print(
                f"[cache] tpu.cache_budget_gb exhausted for {pool} at "
                f"{self.reserved_bytes / 2**30:.2f} GiB "
                f"(budget {self.budget_bytes / 2**30:.2f} GiB, eval "
                f"reserve {self.eval_reserve_bytes / 2**30:.2f}) — "
                f"further {what}s stream host->device every epoch",
                flush=True,
            )
            self._exhausted_logged.add(pool)
        return False


def arrays_nbytes(arrays: dict) -> int:
    """Total bytes of a batch's tensors (torch tensors or numpy arrays)."""
    return sum(int(v.nbytes) for v in arrays.values())
