#!/usr/bin/env python3
"""Device, wall and host time of the Viterbi DP + walk kernel
(csrc/viterbi.cu) and the flint-loss kernel (csrc/mucon_loss.cu), on one
card.

    python3 scripts/probe_viterbi_flint.py

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  On `chip_smoke.py`'s seeded inputs — the DP at request A's shape
(B=128, K=85, N=30, L=66) and request B's (B=3), the flint loss at the
train batch (B=8, T=2560, N=30, M=48) — it prints the card's name and
power limit, then one JSON line a case: the kernel's device ms a call
(`torch.profiler`, the kernel alone and every kernel the wrapper
launches, its int32 length copies included), the wall ms a call of 50
back-to-back calls by CUDA events, and the wrapper's host ms a call
(enqueue only, 50 calls).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 50


def measure(fn, kernel: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / CALLS
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / CALLS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3 / CALLS
    own = sum(e.self_device_time_total for e in events if kernel in e.key) / 1e3 / CALLS
    return dict(device_ms=own, wrapper_device_ms=total, wall_ms=wall_ms, host_ms=host_ms)


def main() -> int:
    import numpy as np
    import torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.mucon_loss import flint_prep

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    cuda.load()
    with torch.inference_mode():
        for tag, nf in (("A", torch.randint(1500, 2101, (128,), generator=gen)),
                        ("B", torch.tensor([517, 1203, 2100]))):
            args = (*cs.viterbi_tables(gen, nf, 2560, dev), cs.FRAME_SAMPLING, cs.MAX_LEN)
            row = measure(lambda: cuda.dense_viterbi_decode(*args), "viterbi")
            B, K, N = args[0].shape
            print(json.dumps(dict(kernel="dense_viterbi", request=tag, B=B, K=K, N=N,
                                  us_per_window=1e3 * row["device_ms"] / (K - 1), **row,
                                  plan=cuda.viterbi_plan(B, N, args[1].shape[2], K))),
                  flush=True)
        arrays = cs.train_batch(np.random.default_rng(1), dev)
        target, n_len, t_valid = (arrays[k] for k in ("transcript", "transcript_len",
                                                       "num_frames"))
        B, N = target.shape
        T = arrays["feats"].shape[1]
        seg = (2.0 * torch.randn(B, T, cs.M, generator=gen)).to(dev)
        prep = flint_prep((1.5 * torch.randn(B, N, generator=gen)).to(dev), n_len, t_valid, 0.0)
        row = measure(lambda: cuda.mucon_flint(*prep, seg, target, n_len, t_valid),
                      "flint_kernel")
        print(json.dumps(dict(kernel="mucon_flint", B=B, T=T, N=N, M=cs.M, **row,
                              plan=cuda.flint_plan(B, T))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
