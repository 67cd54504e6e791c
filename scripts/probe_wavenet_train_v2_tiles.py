#!/usr/bin/env python3
"""Time the v2 trainable WaveNet stack's cooperative kernels
(csrc/wavenet_train_v2.cu) against the v3 kernels, on one card.

    python3 scripts/probe_wavenet_train_v2_tiles.py [--v3 | --float64]

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  The build ships one grid: the forward on v3's 64-row tiles (167 KiB
a CTA, one CTA of 8 warps an SM), the sweep at two CTAs an SM on v3's
weight chunks with at most 32 rows a tile (84 KiB), weight-gradient items
of half the outputs, each sweep item a call.

At the train batch (B=8, T=2560, C=128, the default model's 11 layers and
pools, videos of 1500-2100 frames, dropout 0.25, 3 chunks, seeded) it
prints the card's name and power limit, then one JSON line: the
cooperative grid, the mean time of 20 v2 forwards and of 20 v2 sweeps by
CUDA events after a warm-up, each in turns with v3's (v2, v3, v3, v2), the
device ms of each kernel in one forward and one sweep (`torch.profiler`),
the wrappers' host time a call, whether z and the seven gradients equal
v3's bit for bit (else the largest difference), and the v2 kernels'
registers and spills from nvcc's log.

With --v3 it times only what v3 and the eval stack run, through wrappers
that every checkout since the eval and v3 kernels were redesigned has (so
that a copy of this script run from an older checkout's root times that
checkout): the device ms of each kernel in one eval stack at B=128 and in
one v3 forward and one v3 sweep at the train batch (`torch.profiler`),
the mean time of 20 calls of each by CUDA events, and the host's time a
call to enqueue them.

With --float64 it prints instead, for the card test's B = 8, T = 2560 case,
how far the v2 kernels, the v3 kernels and the f32 plain twin each lie from
the plain twin in float64 (relative L2 of z and the seven gradients).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES, POOLS, B, T, C = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8), 8, 2560, 128


def train_batch(batch: int = B):
    """Seeded inputs and weights of the stack at `batch` videos."""
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    L = len(STAGES)
    lengths = torch.randint(1500, 2101, (batch,), generator=gen).to(dev)
    x = mask_time(torch.relu(torch.randn(batch, T, C, generator=gen)).to(dev), lengths)
    w3 = (torch.randn(L, 3, C, C, generator=gen) / (3 * C) ** 0.5).to(dev)
    w1 = (torch.randn(L, C, C, generator=gen) / C ** 0.5).to(dev)
    b3, b1 = (0.1 * torch.randn(2, L, C, generator=gen)).to(dev)
    wl, bl = w1[0].clone(), b1[0].clone()
    t_ins, _, _, t_fin = stack_plan(STAGES, POOLS, T)
    mgen = torch.Generator(device=dev).manual_seed(1)
    masks = [dropout_mask(mgen, 0.25, (batch, t, C), dev) for t in t_ins]
    gz = torch.randn(batch, t_fin, C, generator=gen).to(dev)
    return x, lengths, (w3, b3, w1, b1, wl, bl), masks, gz


def timed(fn, reps=20) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=20) -> float:
    """The host's time a call to enqueue fn (the card may still be busy)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def kernel_ms(fns, reps: int = 10) -> dict:
    """Device ms of each kernel in one call of each of fns (`torch.profiler`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]:
            e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def v3() -> None:
    """The eval stack at B=128 and v3's forward and sweep at the train batch."""
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack

    kw = dict(stages=STAGES, pooling_layers=POOLS, pooling_type="max", leaky=False)
    xe, le, we, _, _ = train_batch(128)
    x, lengths, weights, masks, gz = train_batch()
    w3, _, w1, _, wl, _ = weights
    _, stash = cuda.wavenet_train_forward(x, lengths, *weights, masks, **kw)

    def eval_stack():
        with torch.no_grad():
            return wavenet_stack(xe, le, *we, **kw)

    def fwd():
        return cuda.wavenet_train_forward(x, lengths, *weights, masks, **kw)

    def sweep():
        return cuda.wavenet_train_backward(gz, stash, lengths, w3, w1, wl, masks, **kw)

    out = {name: {"kernel_ms": kernel_ms([fn]), "ms": timed(fn), "host_ms": host_ms(fn)}
           for name, fn in (("eval_B128", eval_stack), ("v3_fwd", fwd), ("v3_sweep", sweep))}
    print(json.dumps(out), flush=True)


def v2() -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

    x, lengths, weights, masks, gz = train_batch()
    w3, _, w1, b1, wl, _ = weights
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False)
    v2_kw, v3_kw = dict(kw, bounds=chunk_bounds(len(STAGES), 3)), dict(kw, pooling_type="max")

    def v2_fwd():
        return cuda.wavenet_train_v2_forward(x, lengths, *weights, masks, **v2_kw)

    def v3_fwd():
        return cuda.wavenet_train_forward(x, lengths, *weights, masks, **v3_kw)

    (z2, stash2), (z3, stash3) = v2_fwd(), v3_fwd()

    def v2_sweep():
        return cuda.wavenet_train_v2_backward(gz, stash2, lengths, w3, w1, b1, wl, masks, **v2_kw)

    def v3_sweep():
        return cuda.wavenet_train_backward(gz, stash3, lengths, w3, w1, wl, masks, **v3_kw)

    outs2, outs3 = (z2, *v2_sweep()), (z3, *v3_sweep())
    names = ("z", "dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")
    differ = {n: (a - b).abs().max().item() for n, a, b in zip(names, outs2, outs3)
              if not torch.equal(a, b)}
    out = {"grid": cuda.wavenet_train_v2_grid(), "equal_to_v3": not differ,
           "max_abs_diff_to_v3": differ}
    for name, f2, f3 in (("fwd", v2_fwd, v3_fwd), ("sweep", v2_sweep, v3_sweep)):
        a, b, c, d = timed(f2), timed(f3), timed(f3), timed(f2)
        out[f"{name}_ms"], out[f"v3_{name}_ms"] = [a, d], [b, c]
    out["kernel_ms"] = kernel_ms([v2_fwd, v2_sweep, v3_fwd, v3_sweep])
    for name, fn in (("fwd", v2_fwd), ("sweep", v2_sweep)):
        out[f"{name}_host_ms"] = host_ms(fn)
    print(json.dumps(out), flush=True)
    for log in (ROOT / "build" / "mucon_tpu_torch").glob("*.log"):
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            if "v2_" in line and "Function properties" in line:
                print("   ", line.split("for")[-1].strip(), "|", lines[i + 1].strip(), "|",
                      lines[i + 2].strip(), flush=True)


def float64() -> None:
    """The v2 kernels, the v3 kernels and the plain twin in f32, each against
    the plain twin in float64, at the card test's B = 8, T = 2560 case
    (tests/test_torch_cuda.py test_wavenet_train_v2_kernels_edges): relative
    L2 of z and the seven gradients."""
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch.models.layers import dropout_mask
    from mucon_tpu_torch.models.temporal import WaveNetBlock
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import wavenet_stack_train_v2

    dev = torch.device("cuda")
    pools = (0, 2, 5, 8)
    block = WaveNetBlock(16, STAGES, C, pools, "max", False)
    gen = torch.Generator().manual_seed(9)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    lengths = torch.tensor((2100, 1536, 1500, 2048, 1777, 1600, 1920, 2560), device=dev)
    t_ins, _, _, t_fin = stack_plan(STAGES, pools, T)
    mgen = torch.Generator(device=dev).manual_seed(1)
    masks = [dropout_mask(mgen, 0.25, (B, t, C), dev) for t in t_ins]
    x = torch.relu(torch.randn(B, T, C, generator=gen)).to(dev)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    gz = torch.randn(B, t_fin, C, generator=gen).to(dev)
    kw = dict(stages=STAGES, pooling_layers=pools, leaky=False)

    def run(fn, dt=torch.float32, **extra):
        xs = [t.to(dt).clone().requires_grad_() for t in (x, *weights)]
        z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=[m.to(dt) for m in masks], **kw, **extra)
        z.backward(gz.to(dt))
        return [z.detach().double()] + [t.grad.double() for t in xs]

    ref = run(wavenet_stack_train_plain, torch.float64, pooling_type="max")
    names = ("z", "dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")
    out = {}
    for tag, fn, extra in (("v2", wavenet_stack_train_v2, {}),
                           ("v3", wavenet_stack_train, {"pooling_type": "max"}),
                           ("plain f32", wavenet_stack_train_plain, {"pooling_type": "max"})):
        out[tag] = {n: (torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r)).item()
                    for n, a, r in zip(names, run(fn, **extra), ref)}
    print(json.dumps({"relative_l2_to_float64": out}), flush=True)


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if "--float64" in sys.argv:
        float64()
    elif "--v3" in sys.argv:
        v3()
    else:
        v2()
    return 0


if __name__ == "__main__":
    sys.exit(main())
