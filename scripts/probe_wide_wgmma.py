#!/usr/bin/env python3
"""The eval stacks above 512 channels (rows 1 and 12: the WaveNet eval stack
and the MS-TCN++ stage) on one CUDA card: digests of their outputs and their
device times, to compare two trees.

    python3 scripts/probe_wide_wgmma.py OUT.json [--check] [--shapes 0,2] [--quick]

From the root of a checkout.  Seeded inputs (a CUDA `torch.Generator`, the
shape's index in SHAPES as the seed: B = 128 videos at T_pad = 1280 with
750-1050 frames, as the smoke's widths phase, and at request A's T_pad =
2560 with 1500-2100 frames; the default model's 11 layers, pools after 1,
2, 4, 8) go through the public wrappers `cuda.wavenet_stack` and
`cuda.mstcnpp_stack`, in 3xTF32 and in the bf16-operand mode, the same calls
in every tree.  Writes to OUT.json, per shape and row: the SHA-256 of the
output (equal digests are equal outputs, bit for bit), the device ms of the
stack's kernels (`torch.profiler`, kernels whose name holds "wg_pass" or
"wide_"), the device ms of every kernel the call launches and the
CUDA-event wall ms of back-to-back calls.  Prints the stack kernels'
registers, stack and spill bytes from nvcc's `-Xptxas -v` log and, where the
tree has it (`mucon_wgmma_attrs`), each `wgmma` pass kernel's registers,
local bytes and shared memory.  With `--check`, also each output's max abs
error against its plain twin.  `--shapes` takes the given indices of SHAPES
only; `--quick` runs each row once at B = 3, T_pad = 256, C = 600 and 768
against its twin (a first check of a build) and exits 1 if one is off.
Copy the script into another checkout's `scripts/` to probe that tree with
the same inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (C, T_pad): the widths phase's shapes (C = 600 runs at 640), then request A's T_pad
SHAPES = ((600, 1280), (768, 1280), (1024, 1280), (600, 2560), (768, 2560), (1024, 2560))
STAGES, POOLS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
B = 128
# max abs error against the plain twin, as a share of max|plain|: the smoke's
# FWD_BOUND in 3xTF32; the bf16 mode rounds every operand (2^-8 relative)
QUICK_BOUND = {None: 1e-4, "bf16": 2e-2}


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def measure(fn) -> dict:
    """Device ms a call of the stack's kernels and of every kernel the call
    launches (`torch.profiler`), and the CUDA-event ms a call of back-to-back
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = int(min(10, max(2, 0.5 / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3 / calls
    kernels = {e.key: round(e.self_device_time_total / 1e3 / calls, 4) for e in events
               if "wg_pass" in e.key or "wide_" in e.key}
    return dict(device_ms=round(sum(kernels.values()), 4), call_device_ms=round(total, 4),
                wall_ms=round(wall_ms, 4), calls=calls, kernels=kernels)


def inputs(C: int, T: int, b: int, seed: int, dev, L: int = len(STAGES)):
    """x [b x T x C] (ReLU'd, masked), lengths, and both stacks' weights at
    their init scale, from a CUDA generator seeded with `seed`."""
    import torch
    from mucon_tpu_torch.models.layers import mask_time

    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (750, 1050) if T == 1280 else (T * 1500 // 2560, T * 2100 // 2560)
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
    x = mask_time(torch.relu(0.6 * torch.randn(b, T, C, generator=gen, device=dev)), lengths)

    def seeded(*shapes):
        return [torch.randn(*shape, generator=gen, device=dev) / fan ** 0.5
                for shape, fan in shapes]

    wn = seeded(((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C), ((L, C), 100),
                ((C, C), C), ((C,), 100))
    wm = seeded(((L, 3, C, C), 3 * C), ((L, C), 100), ((L, 3, C, C), 3 * C), ((L, C), 100),
                ((L, C, C), 4 * C), ((L, C, C), 4 * C), ((L, C), 100), ((C, C), C),
                ((C,), 100))
    return x, lengths, wn, wm


def rows(x, lengths, wn, wm, stages=STAGES, pools=POOLS):
    """{row: (kernel call, plain call)} of rows 1 and 12 in both modes."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain

    out = {}
    for tag, mm in (("", None), (" bf16", torch.bfloat16)):
        kw = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False,
                  mm_dtype=mm)
        kwm = dict(pooling_layers=pools, mm_dtype=mm)
        out["1" + tag] = (lambda kw=kw: cuda.wavenet_stack(x, lengths, *wn, **kw)[0],
                          lambda kw=kw: wavenet_stack_plain(x, lengths, *wn, **kw)[0])
        out["12" + tag] = (lambda kwm=kwm: cuda.mstcnpp_stack(x, lengths, *wm, **kwm)[0],
                           lambda kwm=kwm: mstcnpp_stack_plain(x, lengths, *wm, **kwm)[0])
    return out


def build_report(cuda) -> dict:
    """nvcc's seconds, the stack kernels' lines of the `-Xptxas -v` log and,
    where the tree has it, the `wgmma` pass kernels' attributes."""
    import chip_smoke

    t0 = time.perf_counter()
    lib = cuda.load()
    report = {"build_s": round(time.perf_counter() - t0, 1)}
    log = cuda.build().with_suffix(".log").read_text()
    report["ptxas"] = [line for line in chip_smoke.ptxas_summary(log)
                       if "wg_pass" in line or "wide_" in line]
    report["ptxas"] += [line.strip() for line in log.splitlines()
                        if "warning" in line.lower() and "wgmma" in line.lower()]
    if hasattr(lib, "mucon_wgmma_attrs"):
        import ctypes

        kinds = ("conv", "res", "proj", "ms_conv", "ms_res")
        for bf16 in (0, 1):
            got = (ctypes.c_int * 25)()
            if lib.mucon_wgmma_attrs(bf16, got) == 0:
                for k, kind in enumerate(kinds):
                    report[f"wg_pass {kind}{' bf16' if bf16 else ''}"] = dict(
                        registers=got[5 * k], local_bytes=got[5 * k + 1],
                        smem_bytes_b128=got[5 * k + 2], threads=got[5 * k + 3])
    for key, value in report.items():
        print(f"{key}: {value}" if not isinstance(value, list) else
              "\n".join(f"ptxas: {v}" for v in value), flush=True)
    return report


def quick(dev) -> int:
    """Each row once at small shapes against its twin: 0 if all hold."""
    import torch
    from mucon_tpu_torch import cuda

    bad, stages, pools = 0, (1, 2, 4, 8, 16, 128), (0, 2)
    for C in (600, 768):
        x, lengths, wn, wm = inputs(C, 256, 3, C, dev, len(stages))
        lengths[2] = 70  # a short video: one live tile, pairs across videos
        with torch.no_grad():
            for row, (kernel, plain) in rows(x, lengths, wn, wm, stages, pools).items():
                cuda.reset_launch_counts()
                zk, zp = kernel(), plain()
                torch.cuda.synchronize()
                err = (zk - zp).abs().max().item()
                bound = QUICK_BOUND["bf16" if "bf16" in row else None] * zp.abs().max().item()
                ok = err <= bound and bool(torch.isfinite(zk).all())
                bad += not ok
                print(f"row {row} C={C}: max abs err {err:.3e} (bound {bound:.3e}) "
                      f"{'ok' if ok else 'FAIL'}; entries "
                      f"{ {k: v for k, v in getattr(cuda, 'wide_launches', {}).items() if v} }",
                      flush=True)
    return 1 if bad else 0


def main() -> int:
    import torch
    from mucon_tpu_torch import cuda

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    out = {"card": card.strip(), "build": build_report(cuda), "shapes": {}}
    if "--quick" in sys.argv:
        return quick(dev)
    check = "--check" in sys.argv
    pick = (sys.argv[sys.argv.index("--shapes") + 1] if "--shapes" in sys.argv else None)
    pick = None if pick is None else {int(i) for i in pick.split(",")}
    for n, (C, T) in enumerate(SHAPES):
        if pick is not None and n not in pick:
            continue
        tag = f"C={C} B={B} T={T}"
        x, lengths, wn, wm = inputs(C, T, B, n, dev)
        lines = {}
        with torch.no_grad():
            for row, (kernel, plain) in rows(x, lengths, wn, wm).items():
                line = {}
                try:
                    z = kernel()
                    line["digest"] = digest(z)
                    if check:
                        zp = plain()
                        line["err"] = (z - zp).abs().max().item()
                        line["scale"] = zp.abs().max().item()
                        del zp
                    del z
                    line.update(measure(kernel))
                except (RuntimeError, ValueError) as e:
                    line["error"] = f"{type(e).__name__}: {e}"
                lines[row] = line
                print(json.dumps({tag: {row: line}}), flush=True)
                torch.cuda.empty_cache()
        out["shapes"][tag] = lines
        del x, lengths, wn, wm
        torch.cuda.empty_cache()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
