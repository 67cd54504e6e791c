#!/usr/bin/env python3
"""How close the trainable WaveNet stack's kernels come to exact
arithmetic, on one card.

    python3 scripts/probe_wavenet_train_accuracy.py

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  At the train batch (B=8, T=2560, C=128, the default model's 11
layers and pools, videos of 1500-2100 frames, dropout 0.25, a seeded
`WaveNetBlock`):

1. each layer's stashed nonlin(z) of the v3 forward (`wavenet_train_fwd`,
   3xTF32 tensor cores) and of the v2 forward (`wavenet_train_v2_fwd`, f32
   FMA) against z recomputed in float64 from that kernel's own layer
   input: max abs error over max|z| (a ReLU input this close to 0 may take
   either side);
2. the v3 sweep against the same sweep in float64 from the v3 forward's
   own stash (its ReLU sides and max-pool routing): relative L2 error of
   each gradient, which no kink can move;
3. v3's and v2's gradients against the plain twin under autograd
   (relative L2): what kinks that the kernel and the twin take on
   different sides add to 2.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES, POOLS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
NAMES = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")


def sweep_f64(gz, stash, lengths, w3, w1, wl, masks, leaky):
    """The v3 sweep (csrc/wavenet_train.cu, max pooling) in float64, its
    decisions taken from the stash: (dx, dw3, db3, dw1, db1, dwl, dbl)."""
    import torch
    from mucon_tpu_torch.models.temporal import shift_time
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

    D, dev = torch.float64, gz.device
    xs, hs, us, x_fin = stash
    t_ins, pooled, shifts, t_fin = stack_plan(STAGES, POOLS, xs[0].shape[1])
    slope = 0.01 if leaky else 0.0

    def valid(t, ln):
        return (torch.arange(t, device=dev)[None] < ln[:, None])[..., None]

    def nl_grad(h):
        return torch.where(h > 0, 1.0, slope).to(D)

    vf = valid(t_fin, lengths >> sum(pooled))
    dy = torch.where(vf, gz.to(D), 0)
    xf = x_fin.to(D)
    dwl = torch.einsum("btc,btd->cd", torch.where(xf > 0, xf, slope * xf), dy)
    dbl = dy.sum((0, 1))
    g = torch.where(vf, (dy @ wl.to(D).T) * nl_grad(xf), 0)
    L = len(STAGES)
    dw3 = torch.zeros(L, 3, 128, 128, dtype=D, device=dev)
    dw1 = torch.zeros(L, 128, 128, dtype=D, device=dev)
    db3, db1 = torch.zeros(L, 128, dtype=D, device=dev), torch.zeros(L, 128, dtype=D, device=dev)
    for i in reversed(range(L)):
        t, d, v = t_ins[i], STAGES[i], valid(t_ins[i], lengths >> shifts[i])
        gm = g
        if pooled[i]:  # max: the first of a pair unless the second is larger
            n = t // 2
            gh = torch.where(valid(n, lengths >> (shifts[i] + 1)), g, 0)
            first = ~(us[i][:, 1:2 * n:2] > us[i][:, 0:2 * n:2])
            gm = torch.zeros(g.shape[0], t, 128, dtype=D, device=dev)
            gm[:, 0:2 * n:2] = torch.where(first, gh, 0)
            gm[:, 1:2 * n:2] = torch.where(first, 0, gh)
        gm = torch.where(v, gm, 0)
        dyl = gm * masks[i].to(D)
        h = torch.where(v, hs[i].to(D), 0)
        dz = torch.where(v, (dyl @ w1[i].to(D).T) * nl_grad(h), 0)
        W = w3[i].to(D)
        g = torch.where(v, shift_time(dz, d) @ W[0].T + dz @ W[1].T
                        + shift_time(dz, -d) @ W[2].T + gm, 0)
        x = xs[i].to(D)
        dw1[i], db1[i] = torch.einsum("btc,btd->cd", h, dyl), dyl.sum((0, 1))
        for k in range(3):
            dw3[i, k] = torch.einsum("btc,btd->cd", shift_time(x, (k - 1) * d), dz)
        db3[i] = dz.sum((0, 1))
    return g, dw3, db3, dw1, db1, dwl, dbl


def rel(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.models.temporal import WaveNetBlock, shift_time
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds, wavenet_stack_train_v2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    block = WaveNetBlock(16, STAGES, 128, POOLS, "max", False)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    B, T = 8, 2560
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    x = mask_time(torch.relu(torch.randn(B, T, 128, generator=gen)).to(dev), lengths)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    w3, b3, w1, b1, wl, bl = weights
    t_ins, _, shifts, t_fin = stack_plan(STAGES, POOLS, T)
    mgen = torch.Generator(device=dev).manual_seed(0)
    masks = [dropout_mask(mgen, 0.25, (B, t, 128), dev) for t in t_ins]
    gz = torch.randn(B, t_fin, 128, generator=gen).to(dev)
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False)
    out = {}
    with torch.no_grad():
        _, stash = cuda.wavenet_train_forward(x, lengths, *weights, masks, **kw,
                                              pooling_type="max")
        _, (xs2, hs2) = cuda.wavenet_train_v2_forward(x, lengths, *weights, masks, **kw,
                                                      bounds=chunk_bounds(len(STAGES), 3))
        for name, xs, hs in (("v3", stash[0], stash[1]), ("v2", xs2, hs2)):
            errs = []
            for i, d in enumerate(STAGES):
                xi, W = xs[i].double(), w3[i].double()
                z = (shift_time(xi, -d) @ W[0] + xi @ W[1] + shift_time(xi, d) @ W[2]
                     + b3[i].double())
                v = (torch.arange(t_ins[i], device=dev)[None]
                     < (lengths >> shifts[i])[:, None])[..., None]
                err = torch.where(v, hs[i].double() - z.clamp_min(0), 0).abs().max()
                errs.append((err / z.abs().max()).item())
            out[f"{name} h err / max|z| by layer"] = errs
        got = cuda.wavenet_train_backward(gz, stash, lengths, w3, w1, wl, masks, **kw,
                                          pooling_type="max")
        ref = sweep_f64(gz, stash, lengths, w3, w1, wl, masks, leaky=False)
        out["v3 sweep vs float64 on its stash, rel L2"] = dict(
            zip(NAMES, (rel(a, b) for a, b in zip(got, ref))))

    def grads(fn, **extra):
        ts = [t.clone().requires_grad_() for t in (x, *weights)]
        z, _ = fn(ts[0], lengths, *ts[1:], drop_masks=masks, **kw, **extra)
        z.backward(gz)
        return [t.grad for t in ts]

    plain = grads(wavenet_stack_train_plain, pooling_type="max")
    for name, fn, extra in (("v3", wavenet_stack_train, dict(pooling_type="max")),
                            ("v2", wavenet_stack_train_v2, {})):
        out[f"{name} vs plain twin, rel L2"] = dict(
            zip(NAMES, (rel(a, b) for a, b in zip(grads(fn, **extra), plain))))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
