#!/usr/bin/env python3
"""Device and wall time, and a digest of the outputs, of the Viterbi DP +
walk kernel (csrc/viterbi.cu), the flint-loss kernel (csrc/mucon_loss.cu)
and the forward decoder chain (csrc/decoder_chain.cu chain_fwd_kernel), on
one card.

    python3 scripts/probe_viterbi_flint.py OUT.json [--only dp,flint,chain] [--bodies] [--grid]

From the root of a checkout, on a machine with one CUDA card (sm_90a) and
nvcc.  It prints the card's name and power limit, then one JSON line a
case, and writes them all to OUT.json.  Each case's inputs are made from
its own seed, so two checkouts get the same ones: copy this script into
another checkout's `scripts/` (a parent commit unpacked with `git
archive`) and run the two in turns (parent, change, change, parent) in one
call to compare their times on one card and their outputs bit for bit
(`digest`: the sha256 of the outputs' bytes).

The cases: the DP at request A's shape (B=128, K=85, N=30, L=66) and
request B's (B=3), at frame_sampling 1 and 3 (L = 2000, 666; 128 videos),
request B at frame_sampling 1, at N = 300 (L = 66, 6 videos) and at N =
300, L = 2000, K = 40 (6 videos), each row naming the body its plan took;
`--bodies` times each DP case again on every body that takes it (the
position body at each of its entries a lane), `--grid` the DP at N = 8,
16, 33, 64, 128, 300 and L = 20, 66, 133, 200, 400 (K = 1.28 L, 6 and 128
videos) on each body (the position body at its planned entries): the
crossings of `cuda.viterbi_route` (a checkout without forced bodies
records an error for those rows); the flint loss at the train batch (B=8,
T=2560, N=30, M=48) and past a CTA's shared memory (M = 600 at B = 1, M =
778 at B = 8, N = 31; N = 482 at B = 2, M = 48); the forward chain (S = 31) at H = 128 (the model),
100, 127, 768, 1024 and 1181 at the train's B = 8, Tz = 160 (E = 2H), and
at H = 1181, B = 2, Tz = 40.  A case's row: the kernel's device ms a call
(`torch.profiler`, the kernel alone, and `wrapper_device_ms`, every kernel
the wrapper launches), the wall ms a call of back-to-back calls by CUDA
events (calls: enough for ~0.3 s, 3 to 50), the host ms a call of issuing
those calls (the wrapper's Python and the launch, before the device has
run them: where it is near the wall ms, the host sets the pace), and its
plan or launch; a shape the checkout refuses records its error.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(fn, kernel: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = int(min(50, max(3, 0.3 / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / calls
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3 / calls
    own = sum(e.self_device_time_total for e in events if kernel in e.key) / 1e3 / calls
    return dict(device_ms=own, wrapper_device_ms=total, wall_ms=wall_ms, host_ms=host_ms,
                calls=calls)


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def plan_of(fn, *args):
    """The plan or launch as this checkout reports it (None where its API
    differs or it refuses the shape)."""
    try:
        return fn(*args)
    except (TypeError, RuntimeError, ValueError):
        return None


def dp_cases(dev):
    import torch

    import chip_smoke as cs
    from mucon_tpu_torch import cuda

    shapes = (("A", 30, torch.randint(1500, 2101, (128,), generator=torch.Generator()
                                      .manual_seed(1))),
              ("B", 30, torch.tensor([517, 1203, 2100])),
              ("frame_sampling=1", 1, torch.randint(1500, 2101, (128,), generator=torch
                                                    .Generator().manual_seed(2))),
              ("frame_sampling=3", 3, torch.randint(1500, 2101, (128,), generator=torch
                                                    .Generator().manual_seed(3))))
    for tag, fs, nf in shapes:
        gen = torch.Generator().manual_seed(len(tag) + fs)
        args = (*cs.viterbi_tables(gen, nf, 2560, dev, fs), fs, cs.MAX_LEN)
        yield tag, args
    gen = torch.Generator().manual_seed(300)
    yield "N=300", cs.viterbi_edge_args(85, 300, 66, cs.FRAME_SAMPLING, cs.MAX_LEN, gen, dev)
    gen = torch.Generator().manual_seed(4)
    yield "B frame_sampling=1", (*cs.viterbi_tables(gen, torch.tensor([517, 1203, 2100]), 2560,
                                                    dev, 1), 1, cs.MAX_LEN)
    gen = torch.Generator().manual_seed(2000)
    yield "N=300 L=2000 K=40", cs.viterbi_edge_args(40, 300, 2000, 1, cs.MAX_LEN, gen, dev)


# the crossings' grid: N transcript positions, L cells, B videos (K = 1.28 L,
# the fused eval's T_pad / max_len)
GRID_N, GRID_L, GRID_B = (8, 16, 33, 64, 128, 300), (20, 66, 133, 200, 400), (6, 128)


def grid_cases(dev):
    import torch

    import chip_smoke as cs

    for B in GRID_B:
        for N in GRID_N:
            for L in GRID_L:
                gen = torch.Generator().manual_seed(B * 100000 + N * 1000 + L)
                args = cs.viterbi_edge_args(-(-128 * L // 100), N, L, cs.FRAME_SAMPLING,
                                            cs.MAX_LEN, gen, dev)
                if B != 6:
                    args = [torch.cat([a] * (B // 6 + 1))[:B] for a in args[:4]] + args[4:]
                yield f"grid B={B} N={N} L={L}", args


def forced(B, N, L, K, every_entries=True):
    """(tag, body, entries) of every body that takes the shape (the position
    body at each of its entries a lane, or at its planned ones)."""
    from mucon_tpu_torch import cuda

    out = []
    for body in ("warp", "cluster", "position"):
        for entries in (cuda.VITERBI_ENTRIES if body == "position" and every_entries
                        else (None,)):
            try:
                cuda.viterbi_plan(B, N, L, K, body=body, entries=entries)
            except ValueError:
                continue
            out.append((f"{body}{entries or ''}", body, entries))
    return out


def flint_cases(dev):
    import numpy as np
    import torch

    import chip_smoke as cs
    from mucon_tpu_torch.ops.mucon_loss import flint_prep

    arrays = cs.train_batch(np.random.default_rng(1), dev)
    target, n_len, t_valid = (arrays[k] for k in ("transcript", "transcript_len", "num_frames"))
    gen = torch.Generator().manual_seed(1)
    B, N = target.shape
    seg = (2.0 * torch.randn(B, 2560, cs.M, generator=gen)).to(dev)
    prep = flint_prep((1.5 * torch.randn(B, N, generator=gen)).to(dev), n_len, t_valid, 0.0)
    yield f"default B={B} N={N} M={cs.M}", (*prep, seg, target, n_len, t_valid)
    for B, M, N in FLINT_SHAPES:
        gen = torch.Generator().manual_seed(M)
        lr = (1.5 * torch.randn(B, N, generator=gen)).to(dev)
        seg = (2.0 * torch.randn(B, 2560, M, generator=gen)).to(dev)
        target = torch.randint(0, M, (B, N), generator=gen).to(dev)
        n_len = torch.randint(1, N + 1, (B,), generator=gen)
        n_len[0] = N
        t_valid = torch.randint(1500, 2561, (B,), generator=gen)
        n_len, t_valid = n_len.to(dev), t_valid.to(dev)
        prep = flint_prep(lr, n_len, t_valid, 0.0)
        yield f"B={B} N={N} M={M}", (*prep, seg, target, n_len, t_valid)


# (B, M, N) past a CTA's shared memory, at T = 2560 (chip_smoke.py LONG_FLINT)
FLINT_SHAPES = ((1, 600, 31), (8, 778, 31), (2, 48, 482))
CHAINS = ((128, 8, 160), (100, 8, 160), (127, 8, 160), (768, 8, 160), (1024, 8, 160),
          (1181, 8, 160), (1181, 2, 40))


def chain_args(H, B, Tz, dev):
    import torch

    gen = torch.Generator().manual_seed(H * 1000 + B)
    S, E = 31, 2 * H
    tz = torch.randint(max(1, Tz * 1500 // 2560), Tz * 2100 // 2560 + 1, (B,), generator=gen)
    maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float()
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    wt = lambda k, *shape: torch.randn(*shape, generator=gen) / k ** 0.5  # noqa: E731
    return [t.to(dev) for t in (
        torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
        r(B, H), r(B, H), wt(H, H, H), r(H), r(H), wt(H + E, H, H), wt(H + E, E, H), r(H),
        wt(2 * H, H, 4 * H), wt(2 * H, H, 4 * H), r(4 * H))]


def main(argv) -> int:
    import torch

    out_path = Path(argv[0])
    only = set(argv[argv.index("--only") + 1].split(",")) if "--only" in argv else {
        "dp", "flint", "chain"}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))
    from mucon_tpu_torch import cuda

    dev = torch.device("cuda")
    cuda.load()
    rows = []

    def emit(row):
        row = dict(row, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def case(kernel, tag, fn, name, **info):
        """A case's row, or its error where this checkout refuses the shape."""
        try:
            row = measure(fn, name)
            outs = fn()
        except (RuntimeError, ValueError, TypeError) as e:
            emit(dict(kernel=kernel, case=tag, **info, error=str(e)[:200]))
            return None
        emit(dict(kernel=kernel, case=tag, **info, **row,
                  digest=digest(outs if isinstance(outs, (tuple, list)) else [outs])))
        return row

    with torch.inference_mode():
        if "dp" in only:
            cases = list(dp_cases(dev)) + (list(grid_cases(dev)) if "--grid" in argv else [])
            for tag, args in cases:
                B, K, N = args[0].shape
                L = args[1].shape[2]
                if not tag.startswith("grid"):
                    case("dense_viterbi", tag, lambda: cuda.dense_viterbi_decode(*args),
                         "viterbi", B=B, K=K, N=N, L=L, plan=cuda.viterbi_plan(B, N, L, K))
                if "--bodies" not in argv and not tag.startswith("grid"):
                    continue
                grid = tag.startswith("grid")
                for name, body, entries in plan_of(forced, B, N, L, K, not grid) or []:
                    case("dense_viterbi", f"{tag} [{name}]",
                         lambda: cuda.dense_viterbi_decode(*args, body=body, entries=entries),
                         "viterbi", B=B, K=K, N=N, L=L,
                         plan=cuda.viterbi_plan(B, N, L, K, body=body, entries=entries))
        if "flint" in only:
            for tag, args in flint_cases(dev):
                B, T, M = args[3].shape
                N = args[0].shape[1]
                case("mucon_flint", tag, lambda: cuda.mucon_flint(*args), "flint_kernel", B=B,
                     T=T, N=N, M=M, plan=plan_of(cuda.flint_plan, B, T, N, M))
        if "chain" in only:
            for H, B, Tz in CHAINS:
                args = chain_args(H, B, Tz, dev)
                case("decoder_chain_fwd", f"H={H} B={B} Tz={Tz}",
                     lambda: cuda.decoder_chain_forward(*args), "chain_fwd_kernel", H=H, B=B,
                     Tz=Tz, launch=plan_of(cuda.decoder_chain_fwd_launch, B, H, 2 * H, Tz))
                del args
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
