#!/usr/bin/env python3
"""Times every hand-written kernel of the port at the default model's widths
(C = 128, H = 128) on one CUDA card, through the `mucon_tpu_torch.cuda`
wrappers that this checkout has.

    python3 scripts/probe_default_widths.py [--reps N] [--out FILE]

Imports the package of the checkout the script lies in (so a copy of the
script in an older checkout's `scripts/` times that checkout's kernels),
builds its kernels, and for each row of PERF.md's kernel table prints the
mean milliseconds a call by CUDA events after a warm-up (`ms`) and the
device milliseconds a call, every kernel summed (`device_ms`,
`torch.profiler`): rows 1 and 12 at the serving batch (B = 128, T_pad =
2560), rows 2-4 at Tz = 160 and K = 85, the train rows at B = 8, T 1500-2100
padded to 2560 with dropout masks, the decoder chain at S = 31, E = 256.
Each row's inputs come from one seeded generator, so two checkouts time the
same data.  A row whose wrapper this checkout lacks (the v2 stack's
bf16-operand mode before it existed) is left out.  Two checkouts are
compared in turns in one call: parent, change, change, parent.

Prints one JSON object on its last line: {"card": ..., "rows": {row: {"ms":
..., "device_ms": ...}}}; with --out also writes it to FILE.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def timed(fn, reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type.name == "CUDA") / 1e3 / reps
    return dict(ms=ms, device_ms=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.mucon_loss import flint_prep
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

    if not torch.cuda.is_available():
        print("probe_default_widths: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cuda.load()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(*s, generator=g)).to(dev)  # noqa: E731
    C, H, L, M, N = 128, 128, 11, 48, 30
    stages, pools = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
    bf16 = torch.bfloat16
    rows = {}

    def weights():
        return [rnd(L, 3, C, C, scale=(3 * C) ** -0.5), rnd(L, C, scale=0.1),
                rnd(L, C, C, scale=(2 * C) ** -0.5), rnd(L, C, scale=0.1),
                rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1)]

    with torch.no_grad():
        # serving rows: B = 128, T_pad = 2560
        B, T = 128, 2560
        lengths = torch.randint(1500, 2101, (B,), generator=g).to(dev)
        x = mask_time(torch.relu(rnd(B, T, C, scale=0.6)), lengths)
        w = weights()
        kw = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False)
        rows["1"] = timed(lambda: cuda.wavenet_stack(x, lengths, *w, **kw), args.reps)
        rows["1 bf16"] = timed(lambda: cuda.wavenet_stack(x, lengths, *w, **kw, mm_dtype=bf16),
                               args.reps)
        wm = [rnd(L, 3, C, C, scale=(3 * C) ** -0.5), rnd(L, C, scale=0.1),
              rnd(L, 3, C, C, scale=(3 * C) ** -0.5), rnd(L, C, scale=0.1),
              rnd(L, C, C, scale=(4 * C) ** -0.5), rnd(L, C, C, scale=(4 * C) ** -0.5),
              rnd(L, C, scale=0.1), rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.1)]
        rows["12"] = timed(lambda: cuda.mstcnpp_stack(x, lengths, *wm, pooling_layers=pools),
                           args.reps)
        rows["12 bf16"] = timed(lambda: cuda.mstcnpp_stack(x, lengths, *wm, pooling_layers=pools,
                                                           mm_dtype=bf16), args.reps)
        del x
        Tz = 160
        tz = torch.randint(1500 // 16, 2100 // 16 + 1, (B,), generator=g)
        m = (torch.arange(Tz)[:, None] < tz[None, :]).float().to(dev)
        xp, w_hh = rnd(Tz, 2, B, 4 * H), rnd(2, H, 4 * H, scale=H ** -0.5)
        rows["2"] = timed(lambda: cuda.bilstm_recurrence(xp, m, w_hh), args.reps)
        K = 85
        W = torch.log_softmax(rnd(B, K, N), dim=-1)
        pois = torch.log_softmax(rnd(B, N, 66), dim=-1)
        kv = torch.full((B,), K, device=dev)
        nv = torch.randint(1, N + 1, (B,), generator=g).to(dev)
        rows["3-4"] = timed(lambda: cuda.dense_viterbi_decode(W, pois, kv, nv, 30, 2000),
                            args.reps)

        # train rows: B = 8, T 1500-2100 padded to 2560, dropout 0.25
        B = 8
        lengths = torch.randint(1500, 2101, (B,), generator=g).to(dev)
        x = mask_time(torch.relu(rnd(B, T, C, scale=0.6)), lengths)
        w = weights()
        w3, b3, w1, b1, wl, bl = w
        t_ins, _, _, t_fin = stack_plan(stages, pools, T)
        mgen = torch.Generator(device=dev).manual_seed(1)
        masks = [dropout_mask(mgen, 0.25, (B, t, C), dev) for t in t_ins]
        gz = rnd(B, t_fin, C)
        v3 = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False)
        v2 = dict(stages=stages, pooling_layers=pools, leaky=False, bounds=chunk_bounds(L, 3))
        for sfx, mm in (("", None), (" bf16", bf16)):
            extra = {} if mm is None else dict(mm_dtype=mm)
            _, stash = cuda.wavenet_train_forward(x, lengths, *w, masks, **v3, **extra)
            rows["5" + sfx] = timed(lambda: cuda.wavenet_train_forward(
                x, lengths, *w, masks, **v3, **extra), args.reps)
            rows["6" + sfx] = timed(lambda: cuda.wavenet_train_backward(
                gz, stash, lengths, w3, w1, wl, masks, **v3, **extra), args.reps)
            if mm is not None and "mm_dtype" not in inspect.signature(
                    cuda.wavenet_train_v2_forward).parameters:
                continue  # this checkout's v2 has no bf16-operand mode
            _, stash2 = cuda.wavenet_train_v2_forward(x, lengths, *w, masks, **v2, **extra)
            rows["13" + sfx] = timed(lambda: cuda.wavenet_train_v2_forward(
                x, lengths, *w, masks, **v2, **extra), args.reps)
            rows["14" + sfx] = timed(lambda: cuda.wavenet_train_v2_backward(
                gz, stash2, lengths, w3, w1, b1, wl, masks, **v2, **extra), args.reps)
        tz = torch.randint(1500 // 16, 2100 // 16 + 1, (B,), generator=g)
        m = (torch.arange(Tz)[:, None] < tz[None, :]).float().to(dev)
        xp = rnd(Tz, 2, B, 4 * H)
        outs, _, _, cs = cuda.bilstm_train_forward(xp, m, w_hh)
        cts = [rnd(Tz, 2, B, H), rnd(2, B, H), rnd(2, B, H)]
        rows["7"] = timed(lambda: cuda.bilstm_train_forward(xp, m, w_hh), args.reps)
        rows["8"] = timed(lambda: cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, *cts),
                          args.reps)
        coefs = cuda.bilstm_bwd_coefs(xp, m, w_hh, outs, cs)  # row 8's two kernels apart
        rows["8 coefs"] = timed(lambda: cuda.bilstm_bwd_coefs(xp, m, w_hh, outs, cs), args.reps)
        rows["8 chain"] = timed(lambda: cuda.bilstm_bwd_chain(coefs, m, w_hh, *cts), args.reps)
        S, E = 31, 2 * H
        maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float().to(dev)
        chain = [torch.relu(rnd(S, B, H, scale=0.4)), rnd(B, Tz, E, scale=0.4) * maskf[:, :, None],
                 rnd(B, Tz, H, scale=0.4), maskf, rnd(B, H, scale=0.4), rnd(B, H, scale=0.4),
                 rnd(H, H, scale=H ** -0.5), rnd(H, scale=0.4), rnd(H, scale=0.4),
                 rnd(H, H, scale=(H + E) ** -0.5), rnd(E, H, scale=(H + E) ** -0.5),
                 rnd(H, scale=0.4), rnd(H, 4 * H, scale=(2 * H) ** -0.5),
                 rnd(H, 4 * H, scale=(2 * H) ** -0.5), rnd(4 * H, scale=0.4)]
        hs, cs_, _ = cuda.decoder_chain_forward(*chain)
        h_in = torch.cat([chain[4][None], hs[:-1]])
        c_in = torch.cat([chain[5][None], cs_[:-1]])
        back = (*chain[:4], h_in, c_in, *chain[6:], *(rnd(S, B, H) for _ in range(3)))
        rows["9"] = timed(lambda: cuda.decoder_chain_forward(*chain), args.reps)
        rows["10"] = timed(lambda: cuda.decoder_chain_backward(*back), args.reps)
        acts, cpre, a, u = cuda.decoder_chain_replay(*back[:15])  # row 10's two kernels apart
        rows["10 replay"] = timed(lambda: cuda.decoder_chain_replay(*back[:15]), args.reps)
        chain_args = (c_in, chain[1], chain[8], chain[10], chain[12], chain[13], chain[6],
                      *back[15:])
        rows["10 chain"] = timed(lambda: cuda.decoder_chain_bwd_chain(acts, cpre, a, u,
                                                                      *chain_args), args.reps)
        target = torch.randint(0, M, (B, N), generator=g).to(dev)
        n_len = torch.randint(1, N + 1, (B,), generator=g).to(dev)
        prep = flint_prep(rnd(B, N, scale=1.5), n_len, lengths, 0.0)
        seg = rnd(B, T, M, scale=2.0)
        rows["11"] = timed(lambda: cuda.mucon_flint(*prep, seg, target, n_len, lengths),
                           args.reps)
    out = dict(card=card, root=str(ROOT), rows=rows)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
