#!/usr/bin/env python3
"""The decoder chain's kernels (rows 9 and 10) at wide H and long Tz, on one
CUDA card: digests of their outputs and their device times, to compare two
trees.

    python3 scripts/probe_decoder_persistent.py OUT.json [--check]
        [--shapes 0,2] [--route cluster|persistent]

From the root of a checkout.  Seeded inputs (torch.Generator, the shape's
index in SHAPES as the seed) at each (H, B, Tz) of SHAPES (S = 31 steps,
E = 2H, the train's lengths scaled to Tz) go through the public wrappers of
`mucon_tpu_torch.cuda`, the same calls in every tree: the forward chain,
the reverse chain's replay pass alone, its sequential chain alone and the
whole backward (`decoder_chain_backward`, both passes).  Writes to OUT.json,
per shape: the SHA-256 of each output (equal digests are equal outputs, bit
for bit), whether the replay's cell and relu(cpre) equal the forward's
stash, and for each call the device ms of the decoder chain's kernels
(`torch.profiler`, kernels whose name holds "chain_"), the device ms of
every kernel the call launches and the CUDA-event wall ms of back-to-back
calls.  With `--check`, also each output's max abs error against its plain
twin and the routes and plans this tree reports; `--shapes` takes the given
indices of SHAPES only; `--route` forces the kernels' route where the tree
takes that keyword (a tree without it records the error).  Copy the script
into another checkout's `scripts/` to probe that tree with the same inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (H, B, Tz): the widths phase's train batch at Tz = 160, the JAX package's
# widest H at B = 2, Tz = 40 and at the train batch, the long-Tz shapes, and
# the cluster kernels' widths from 256 to 512 (where the route is chosen) at
# the smoke's train batch, at one video (the default `tpu.batch_size`) and at
# B = 32 and 128 (the serving phase's batch)
SHAPES = ((512, 8, 160), (768, 8, 160), (1024, 8, 160), (1181, 2, 40), (128, 1, 2048),
          (768, 1, 1536), (1181, 8, 160), (256, 8, 160), (384, 8, 160),
          (256, 1, 160), (384, 1, 160), (512, 1, 160), (256, 32, 160), (384, 32, 160),
          (512, 32, 160), (256, 128, 160), (384, 128, 160), (512, 128, 160))
S = 31


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(fn) -> dict:
    """Device ms a call of the chain's kernels and of every kernel the call
    launches (`torch.profiler`), and the CUDA-event ms a call of back-to-back
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = int(min(20, max(2, 0.3 / max(time.perf_counter() - t0, 1e-6))))
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
               if "chain_" in e.key}
    return dict(device_ms=sum(kernels.values()), call_device_ms=total, wall_ms=wall_ms,
                calls=calls, kernels=kernels)


def inputs(H: int, B: int, Tz: int, seed: int, dev):
    import torch

    gen = torch.Generator().manual_seed(seed)
    E = 2 * H
    tz = torch.randint(max(1, Tz * 1500 // 2560), Tz * 2100 // 2560 + 1, (B,), generator=gen)
    maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float()
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    wt = lambda k, *shape: torch.randn(*shape, generator=gen) / k ** 0.5  # noqa: E731
    args = [t.to(dev) for t in (
        torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
        r(B, H), r(B, H), wt(H, H, H), r(H), r(H), wt(H + E, H, H), wt(H + E, E, H), r(H),
        wt(2 * H, H, 4 * H), wt(2 * H, H, 4 * H), r(4 * H))]
    dcts = [torch.randn(S, B, H, generator=gen).to(dev) for _ in range(3)]
    return args, dcts


def main() -> int:
    import torch
    from mucon_tpu_torch import cuda

    check = "--check" in sys.argv
    pick = (sys.argv[sys.argv.index("--shapes") + 1] if "--shapes" in sys.argv else None)
    pick = None if pick is None else {int(i) for i in pick.split(",")}
    kw = {"route": sys.argv[sys.argv.index("--route") + 1]} if "--route" in sys.argv else {}
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "route": kw.get("route"), "shapes": {}}
    for n, (H, B, Tz) in enumerate(SHAPES):
        if pick is not None and n not in pick:
            continue
        tag = f"H={H} B={B} Tz={Tz}"
        args, dcts = inputs(H, B, Tz, n, dev)
        line = {}
        try:
            with torch.no_grad():
                fwd = cuda.decoder_chain_forward(*args, **kw)
                h_in = torch.cat([args[4][None], fwd[0][:-1]])
                c_in = torch.cat([args[5][None], fwd[1][:-1]])
                bargs = (*args[:4], h_in, c_in, *args[6:], *dcts)
                *replay, cell = cuda.decoder_chain_replay(*bargs[:15], count=False, cell=True,
                                                          **kw)
                chain_args = (c_in, args[1], args[8], args[10], args[12], args[13], args[6],
                              *dcts)
                chain = cuda.decoder_chain_bwd_chain(*replay, *chain_args, **kw)
                bwd = cuda.decoder_chain_backward(*bargs, **kw)
        except (TypeError, RuntimeError, ValueError) as e:
            line["error"] = f"{type(e).__name__}: {e}"
            out["shapes"][tag] = line
            print(json.dumps({tag: line}), flush=True)
            continue
        line["digests"] = {"fwd": digest(fwd), "replay": digest(replay), "chain": digest(chain),
                           "bwd": digest(bwd)}
        line["replay_is_stash"] = bool(torch.equal(cell, fwd[1]) and
                                       torch.equal(torch.relu(replay[1]), fwd[2]))
        line["bwd_is_replay_then_chain"] = all(torch.equal(a, b) for a, b in zip(chain, bwd))
        with torch.no_grad():
            line["fwd"] = measure(lambda: cuda.decoder_chain_forward(*args, **kw))
            line["replay"] = measure(lambda: cuda.decoder_chain_replay(*bargs[:15], count=False,
                                                                       **kw))
            line["chain"] = measure(lambda: cuda.decoder_chain_bwd_chain(*replay, *chain_args,
                                                                         **kw))
            line["bwd"] = measure(lambda: cuda.decoder_chain_backward(*bargs, **kw))
        if check:
            from mucon_tpu_torch.ops.decoder_chain import (
                decoder_chain_bwd_plain, decoder_chain_plain,
            )

            with torch.no_grad():
                pf = decoder_chain_plain(*args)
                pb = decoder_chain_bwd_plain(*bargs)
            line["fwd_err"] = max((a - b).abs().max().item() for a, b in zip(fwd, pf))
            line["bwd_err"] = [(a - b).abs().max().item() for a, b in zip(bwd, pb)]
            line["bwd_scale"] = [b.abs().max().item() for b in pb]
            E = 2 * H
            plans = {"route": ("decoder_chain_route", (B, H, E, Tz)),
                     "fwd_launch": ("decoder_chain_fwd_launch", (B, H, E, Tz)),
                     "persistent_fwd": ("decoder_chain_persistent_launch", (B, H, E, Tz)),
                     "persistent_replay": ("decoder_chain_persistent_launch",
                                           (S * B, H, E, Tz)),
                     "persistent_bwd": ("decoder_chain_persistent_launch",
                                        (B, H, E, Tz, True))}
            for name, (fn, plan_args) in plans.items():
                if hasattr(cuda, fn):
                    try:
                        line[name] = getattr(cuda, fn)(*plan_args)
                    except (TypeError, RuntimeError, ValueError) as e:
                        line[name] = f"{type(e).__name__}: {e}"
        out["shapes"][tag] = line
        print(json.dumps({tag: {k: v for k, v in line.items() if k != "digests"}}), flush=True)
        del args, dcts, fwd, replay, cell, chain, bwd, bargs, chain_args, h_in, c_in
        torch.cuda.empty_cache()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
