#!/usr/bin/env python3
"""Time the trainable WaveNet stack's kernels (csrc/wavenet_train.cu) a
layer at a time, on one card.

    python3 scripts/probe_wavenet_train_tiles.py

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  At the train batch (B=8, T=2560, C=128, the default model's 11
layers and pools, videos of 1500-2100 frames, dropout 0.25, seeded) it
prints the card's name and power limit, then one JSON line: the tiles each
layer takes (forward, sweep; chosen from the shape), the mean time of 20
`mucon_wavenet_train_fwd` calls and of 20 `mucon_wavenet_train_sweep` calls
per layer by CUDA events after a warm-up, the device ms of each kernel in
one forward and one sweep of the whole stack (`torch.profiler`), and each
wrapper's host time a call (enqueue only) beside its wall time.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES, POOLS, B, T, C = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8), 8, 2560, 128


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    L = len(STAGES)
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    x = mask_time(torch.relu(torch.randn(B, T, C, generator=gen)).to(dev), lengths)
    w3 = (torch.randn(L, 3, C, C, generator=gen) / (3 * C) ** 0.5).to(dev)
    w1 = (torch.randn(L, C, C, generator=gen) / C ** 0.5).to(dev)
    b3, b1 = (0.1 * torch.randn(L, C, generator=gen)).to(dev), torch.zeros(L, C, device=dev)
    wl, bl = w1[0].clone(), b1[0].clone()
    t_ins, pooled, shifts, _ = stack_plan(STAGES, POOLS, T)
    mgen = torch.Generator(device=dev).manual_seed(1)
    masks = [dropout_mask(mgen, 0.25, (B, t, C), dev) for t in t_ins]
    kw = dict(stages=STAGES, pooling_layers=POOLS, pooling_type="max", leaky=False)
    _, (xs, hs, us, _) = cuda.wavenet_train_forward(x, lengths, w3, b3, w1, b1, wl, bl, masks,
                                                    **kw)
    lib, stream = cuda.load(), torch.cuda.current_stream().cuda_stream
    lens = lengths.to(torch.int32)
    w3t, w1t = w3.transpose(-1, -2).contiguous(), w1.transpose(-1, -2).contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    dw3, dw1, db = torch.empty(3, C, C, **f32), torch.empty(C, C, **f32), torch.empty(C, **f32)

    def timed(fn) -> float:
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    fwd, sweep, tiles = [], [], []
    for i, d in enumerate(STAGES):
        t, p = t_ins[i], pooled[i]
        out = torch.empty(B, t // 2 if p else t, C, **f32)
        h, u = torch.empty(B, t, C, **f32), torch.empty(B, t, C, **f32)
        g = torch.randn(B, t // 2 if p else t, C, device=dev)
        dy, dz, g_in = (torch.empty(B, t, C, **f32) for _ in range(3))
        work = torch.empty(B * cuda.wavenet_train_plan(B, t)["spans"] * 4 * (C + 1) * C, **f32)
        args = [xs[i].data_ptr(), out.data_ptr(), u.data_ptr(), h.data_ptr(), lens.data_ptr(),
                w3[i].data_ptr(), b3[i].data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
                masks[i].data_ptr(), B, t, C, d, shifts[i], int(p), 0, 0, 0, stream]
        fwd.append(timed(lambda: lib.mucon_wavenet_train_fwd(*args)))
        sargs = [g.data_ptr(), us[i].data_ptr() if p else 0, xs[i].data_ptr(), hs[i].data_ptr(),
                 masks[i].data_ptr(), lens.data_ptr(), w1t[i].data_ptr(), w3t[i].data_ptr(),
                 dy.data_ptr(), dz.data_ptr(), g_in.data_ptr(), work.data_ptr(),
                 dw1.data_ptr(), db.data_ptr(), dw3.data_ptr(), db.data_ptr(), B, t, C, d,
                 shifts[i], int(p), 0, 0, 0, 0, stream]
        sweep.append(timed(lambda: lib.mucon_wavenet_train_sweep(*sargs)))
        plan = cuda.wavenet_train_plan(B, t)
        tiles.append((plan["fwd_tile_rows"], plan["tile_rows"]))
    out = {"tiles": tiles, "fwd_ms": fwd, "sweep_ms": sweep, "fwd_total": sum(fwd),
           "sweep_total": sum(sweep)}
    # device ms per kernel of one forward + sweep
    gz = torch.randn(B, t_ins[-1] // 2 if pooled[-1] else t_ins[-1], C, device=dev)
    stash = cuda.wavenet_train_forward(x, lengths, w3, b3, w1, b1, wl, bl, masks, **kw)[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            cuda.wavenet_train_forward(x, lengths, w3, b3, w1, b1, wl, bl, masks, **kw)
            cuda.wavenet_train_backward(gz, stash, lengths, w3, w1, wl, masks, **kw)
        torch.cuda.synchronize()
    out["kernel_ms"] = {
        e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]:
        e.device_time_total / 1e3 / 10
        for e in prof.key_averages() if e.device_time_total > 0}
    # the wrappers' host time a call (enqueue only) against the call's wall time
    for name, fn in (("forward", lambda: cuda.wavenet_train_forward(
            x, lengths, w3, b3, w1, b1, wl, bl, masks, **kw)),
                     ("sweep", lambda: cuda.wavenet_train_backward(
                         gz, stash, lengths, w3, w1, wl, masks, **kw))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[f"{name}_host_ms"] = 1e3 * (t1 - t0) / 20
        out[f"{name}_wall_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
