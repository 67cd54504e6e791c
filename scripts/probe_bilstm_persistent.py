#!/usr/bin/env python3
"""The BiLSTM recurrence's kernels at the widths above H = 256, on one CUDA
card: digests of their outputs and their times, to compare two trees.

    python3 scripts/probe_bilstm_persistent.py OUT.json [--check] [--library]
        [--shapes 0,2]

From the root of a checkout.  Seeded inputs (torch.Generator, the shape's
index in SHAPES as the seed) at each (T, B, H) of SHAPES go through the
public wrappers of `mucon_tpu_torch.cuda` (the eval forward, the train
forward with its cell stash, the coefficient pass and the reverse chain),
the same calls in every tree.  Writes to
OUT.json, per shape: the SHA-256 of each output (equal digests are equal
outputs, bit for bit) and the CUDA-event ms of the eval forward, the train
forward, the reverse chain alone, the coefficient pass alone and the whole
backward, `bilstm_train_backward` (mean of REPS calls after a warm-up).  With
`--check`, also each output's max abs error against its plain twin in the
kernels' sum order and the launch reports; with `--library`, cuDNN's
`nn.LSTM` (input projection included) forward and backward at the same shape,
a yardstick the port never calls (its inputs from a generator of their own,
so the kernels' inputs do not depend on the flag); `--shapes` takes the given
indices of SHAPES only (each shape's inputs are seeded on its own).  Copy
the script into another checkout's `scripts/` to probe that tree with the
same inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (T, B, H): the widths phase's eval (B = 128) and train (B = 8) batches at Tz
# = 160, the longest shape (B = 2 at H = 1447), and ragged ones
SHAPES = ((160, 128, 512), (160, 8, 512), (160, 128, 768), (160, 8, 768), (160, 128, 1024),
          (160, 8, 1024), (40, 2, 1447), (13, 11, 300), (9, 3, 600), (6, 3, 257))
REPS = 3


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def timed(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_ms(T: int, B: int, H: int, tz, gen, backward: bool) -> float:
    import torch

    x = torch.randn(B, T, 2 * H, generator=gen).cuda()
    lstm = torch.nn.LSTM(2 * H, H, bidirectional=True, batch_first=True).cuda()
    xg = x.clone().requires_grad_(backward)
    packed = torch.nn.utils.rnn.pack_padded_sequence(xg, tz, batch_first=True,
                                                     enforce_sorted=False)
    if not backward:
        with torch.no_grad():
            return timed(lambda: lstm(packed))
    out = lstm(packed)[0].data
    g = torch.randn_like(out)
    params = [xg, *lstm.parameters()]
    return timed(lambda: torch.autograd.grad(out, params, g, retain_graph=True))


def main() -> int:
    import torch
    from mucon_tpu_torch import cuda

    check, library = "--check" in sys.argv, "--library" in sys.argv
    pick = (sys.argv[sys.argv.index("--shapes") + 1] if "--shapes" in sys.argv else None)
    pick = None if pick is None else {int(i) for i in pick.split(",")}
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "shapes": {}}
    for n, (T, B, H) in enumerate(SHAPES):
        if pick is not None and n not in pick:
            continue
        gen = torch.Generator().manual_seed(n)
        w_hh = ((2 * torch.rand(2, H, 4 * H, generator=gen) - 1) / H ** 0.5).to(dev)
        xp = torch.randn(T, 2, B, 4 * H, generator=gen).to(dev)
        tz = torch.randint(max(1, T * 1500 // 2560), T * 2100 // 2560 + 1, (B,), generator=gen)
        tz[-1] = min(tz[-1], 0 if B > 2 else tz[-1])  # a fully masked video where B > 2
        m = (torch.arange(T)[:, None] < tz[None, :]).float().to(dev)
        cts = [torch.randn(*s, generator=gen).to(dev) for s in ((T, 2, B, H), (2, B, H),
                                                               (2, B, H))]
        with torch.no_grad():
            ev = cuda.bilstm_recurrence(xp, m, w_hh)
            tr = cuda.bilstm_train_forward(xp, m, w_hh)
            coefs, cell = cuda.bilstm_bwd_coefs(xp, m, w_hh, tr[0], tr[3], cell=True)
            dxp = cuda.bilstm_bwd_chain(coefs, m, w_hh, *cts)
        line = {"digests": {f"eval[{i}]": digest(t) for i, t in enumerate(ev)}}
        line["digests"].update({f"train_fwd[{i}]": digest(t) for i, t in enumerate(tr)})
        line["digests"].update(coefs=digest(coefs), dxp=digest(dxp))
        valid = m[:, None, :, None].expand_as(cell) > 0
        line["cell_is_stash"] = bool(torch.equal(cell[valid], tr[3][valid]))
        with torch.no_grad():
            line["eval_ms"] = timed(lambda: cuda.bilstm_recurrence(xp, m, w_hh))
            line["train_fwd_ms"] = timed(lambda: cuda.bilstm_train_forward(xp, m, w_hh))
            line["chain_ms"] = timed(lambda: cuda.bilstm_bwd_chain(coefs, m, w_hh, *cts))
            line["bwd_ms"] = timed(lambda: cuda.bilstm_train_backward(xp, m, w_hh, tr[0], tr[3],
                                                                      *cts))
            line["coefs_ms"] = timed(lambda: cuda.bilstm_bwd_coefs(xp, m, w_hh, tr[0], tr[3]))
        if check:
            from mucon_tpu_torch.ops.lstm_recurrence import (
                bilstm_bwd_chain_plain, bilstm_recurrence_plain,
            )

            nk, kc = cuda.bilstm_fwd_plan(H)[3:]
            gpq = cuda.bilstm_chain_plan(H)[3]
            with torch.no_grad():
                pe = bilstm_recurrence_plain(xp, m, w_hh, stash=True, k_groups=(nk, kc))
                pd = bilstm_bwd_chain_plain(coefs, m, w_hh, *cts, row_groups=gpq)
            line["eval_err"] = max((a - b).abs().max().item() for a, b in zip(ev, pe))
            line["train_fwd_err"] = max((a - b).abs().max().item() for a, b in zip(tr, pe))
            line["dxp_err"] = (dxp - pd).abs().max().item()
            line["dxp_scale"] = pd.abs().max().item()
            line["launch"] = {"fwd": cuda.bilstm_fwd_launch(B, H),
                              "chain": cuda.bilstm_chain_launch(B, H)}
        if library:
            lgen = torch.Generator().manual_seed(1000 + n)
            line["library_fwd_ms"] = library_ms(T, B, H, tz.clamp(min=1), lgen, False)
            line["library_bwd_ms"] = library_ms(T, B, H, tz.clamp(min=1), lgen, True)
        out["shapes"][f"T={T} B={B} H={H}"] = line
        print(json.dumps({f"T={T} B={B} H={H}": {k: v for k, v in line.items()
                                                 if k != "digests"}}), flush=True)
        del w_hh, xp, ev, tr, coefs, cell, dxp
        torch.cuda.empty_cache()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
