#!/usr/bin/env python3
"""Time build variants of the MS-TCN++ stage's CUDA kernel on one card.

    python3 scripts/probe_mstcnpp_variants.py

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  Each variant is the kernel library built with other -D knobs of
`mucon_tpu_torch/csrc/mstcnpp.cu` and `mma_tf32.cuh` (through the
MUCON_NVCC_FLAGS environment variable that `mucon_tpu_torch.cuda.build`
reads), run in a process of its own: the stage at full width (B=128,
T=2560, C=128, 11 layers, videos of 1500-2100 frames, seeded) against its
plain f32 twin, max abs error over max|plain|, and the mean time of 10
calls by CUDA events after a warm-up.  Prints the card's name and power
limit, then per variant one JSON line and the layer kernel's registers
and spills from nvcc's log.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {
    "as shipped": "",
    "split by cvt.rna.tf32.f32": "-DMMA_TF32_SPLIT=0",
    "lo left unrounded (the tensor core drops its low bits)": "-DMMA_TF32_SPLIT=2",
    "single TF32 product (no f32 parity)": "-DMMA_TF32_PRODUCTS=1",
    "padding tiles multiplied": "-DMSTCNPP_SKIP_PADDING=0",
    "chunks of 32 rows, ring of 3": "-DMSTCNPP_KC=32 -DMSTCNPP_STAGES=3",
    "chunks of 32 rows, ring of 2": "-DMSTCNPP_KC=32",
    "16 warps of 16 x 32": "-DMSTCNPP_MT=1",
    "128-row tiles, 16 warps, chunks of 16, ring of 3":
        "-DMSTCNPP_TM=128 -DMSTCNPP_KC=16 -DMSTCNPP_STAGES=3",
    # 85 KiB of shared memory: two CTAs fit a SM, at twice the weight traffic
    "32-row tiles, 8 warps of 16 x 32, chunks of 32":
        "-DMSTCNPP_TM=32 -DMSTCNPP_MT=1 -DMSTCNPP_KC=32",
}


def one() -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.models.model import create_model
    from mucon_tpu_torch.ops.mstcnpp_stack import (
        mstcnpp_stack, mstcnpp_stack_plain, pack_mstcnpp_params,
    )

    dev = torch.device("cuda")
    ft = create_model(48, 31, 2048, ft_type="mstcnpp", device=dev, seed=0).net.ft
    gen = torch.Generator().manual_seed(1)
    B, T, C = 128, 2560, 128
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    x = (torch.randn(B, T, C, generator=gen) * 0.6).to(dev)
    with torch.inference_mode():
        args = (mask_time(x, lengths), lengths, *pack_mstcnpp_params(ft))
        kw = dict(pooling_layers=ft.pooling_layers)
        zk, _ = mstcnpp_stack(*args, **kw)
        zp, _ = mstcnpp_stack_plain(*args, **kw)
        err = ((zk - zp).abs().max() / zp.abs().max()).item()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            mstcnpp_stack(*args, **kw)
        end.record()
        torch.cuda.synchronize()
    print(json.dumps({"rel_err": err, "ms": start.elapsed_time(end) / 10}), flush=True)


def main() -> int:
    if "--one" in sys.argv:
        one()
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, flags in VARIANTS.items():
        env = dict(os.environ, MUCON_NVCC_FLAGS=flags)
        out = subprocess.run([sys.executable, __file__, "--one"], env=env, cwd=ROOT,
                             capture_output=True, text=True)
        if out.returncode:
            print(json.dumps({"variant": name, "flags": flags, "failed": out.stderr[-2000:]}))
            continue
        print(json.dumps({"variant": name, "flags": flags,
                          **json.loads(out.stdout.strip().splitlines()[-1])}), flush=True)
        for log in (ROOT / "build" / "mucon_tpu_torch").glob("*.log"):
            lines = log.read_text().splitlines()
            for i, line in enumerate(lines):
                if "mstcnpp_layer" in line and "Function properties" in line:
                    print("   ", lines[i + 1].strip(), "|", lines[i + 2].strip(), flush=True)
            log.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
