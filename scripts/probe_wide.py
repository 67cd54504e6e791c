#!/usr/bin/env python3
"""Each kernel of the port at the shapes above its narrow instances, once,
against its plain twin, on one CUDA card.

    python3 scripts/probe_wide.py [--quick]

Builds the kernels (printing nvcc's seconds and the wide kernels'
registers, shared memory and spills from `-Xptxas -v`), then holds at small
B and T: the WaveNet eval stack and the MS-TCN++ stage at C = 600 and 768
(the wide bodies, both modes), the trainable stack's v3 forward and sweep at
C = 600 against autograd of the plain twin and v2 equal to v3 bit for bit,
the BiLSTM (eval, train forward and reverse chain) at H = 600 and 1447, the
decoder chain (forward and reverse) at H = 600 and 1181 and at H = 128 with
Tz = 2048 (the reverse chain's tables in device memory), and the Viterbi DP
at frame_sampling 1 and 3 (L = 2000, 666) and N = 300.  Prints one line a
check and a JSON summary last; exits 1 if any check failed.  `--quick`
skips the second width of each.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
import traceback


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.vector_norm((a - b).double())
            / torch.linalg.vector_norm(b.double()).clamp_min(1e-30)).item()


def close(name, got, ref, fwd_bound=1e-4, grad=False):
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rl = rel_l2(got, ref)
    ok = rl <= (cs.GRAD_BOUND if grad else fwd_bound) and err <= (
        cs.GRAD_MAX_BOUND if grad else fwd_bound) * max(scale, 1e-30)
    print(f"  {name}: max abs {err:.3e} of {scale:.3e}, rel L2 {rl:.3e} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} out of bounds")


def stacks(C, dev, gen):
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack, mstcnpp_stack_plain
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain)
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import wavenet_stack_train_v2

    stages, pools, B, T = (1, 2, 4, 8), (0, 2), 3, 256
    lengths = torch.tensor([256, 190, 70]).to(dev)
    x = mask_time(torch.relu(torch.randn(B, T, C, generator=gen)).to(dev), lengths)
    L = len(stages)
    wn = cs.seeded(gen, dev, ((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C),
                   ((L, C), 100), ((C, C), C), ((C,), 100))
    wm = cs.seeded(gen, dev, ((L, 3, C, C), 3 * C), ((L, C), 100), ((L, 3, C, C), 3 * C),
                   ((L, C), 100), ((L, C, C), 4 * C), ((L, C, C), 4 * C), ((L, C), 100),
                   ((C, C), C), ((C,), 100))
    with torch.no_grad():
        for mm in (None, torch.bfloat16):
            kw = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False,
                      mm_dtype=mm)
            zk, _ = wavenet_stack(x, lengths, *wn, **kw)
            zp, _ = wavenet_stack_plain(x, lengths, *wn, **kw)
            close(f"wavenet_layer C={C} mm={mm}", zk, zp, 1e-4 if mm is None else 2e-2)
            kwm = dict(pooling_layers=pools, mm_dtype=mm)
            zk, _ = mstcnpp_stack(x, lengths, *wm, **kwm)
            zp, _ = mstcnpp_stack_plain(x, lengths, *wm, **kwm)
            close(f"mstcnpp_stack C={C} mm={mm}", zk, zp, 1e-4 if mm is None else 2e-2)
    t_ins = stack_plan(stages, pools, T)[0]
    mgen = torch.Generator(device=dev).manual_seed(3)
    masks = [dropout_mask(mgen, 0.25, (B, t, C), dev) for t in t_ins]
    g = torch.randn(B, stack_plan(stages, pools, T)[3], C, generator=gen).to(dev)
    kw = dict(stages=stages, pooling_layers=pools, leaky=False)

    def fwd_bwd(fn, dtype=torch.float32, **extra):
        xs = [t.to(dtype).clone().requires_grad_() for t in (x, *wn)]
        z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=[m.to(dtype) for m in masks], **kw,
                  **extra)
        z.backward(g.to(dtype))
        return [z.detach(), *(t.grad for t in xs)]

    for mm in (None, torch.bfloat16):
        cuda.reset_launch_counts()
        got3 = fwd_bwd(wavenet_stack_train, pooling_type="max", mm_dtype=mm)
        got2 = fwd_bwd(wavenet_stack_train_v2, sweep_chunks=2, mm_dtype=mm)
        torch.cuda.synchronize()
        print(f"  launches {dict((k, v) for k, v in cuda.launch_counts.items() if v)}")
        names = ("z", "dx", "dw3", "db3", "dw1", "db1", "dwl", "dbl")
        differ = [n for n, a, b in zip(names, got2, got3) if not torch.equal(a, b)]
        print(f"  v2 vs v3 C={C} mm={mm}: {'equal' if not differ else differ}", flush=True)
        if differ:
            raise AssertionError(f"v2 differs from v3: {differ}")
        if mm is None:  # against float64 (max-pool near-ties: a loose gradient bound)
            ref = fwd_bwd(wavenet_stack_train_plain, torch.float64, pooling_type="max")
            for n, a, b in zip(names, got3, ref):
                close(f"train C={C} {n} (vs float64)", a.double(), b, 1e-4 if n == "z" else 1e-2)
        else:
            ref = fwd_bwd(wavenet_stack_train_plain, pooling_type="max", mm_dtype=mm,
                          round_proj_grads=True)
            close(f"train C={C} bf16 z (vs its bf16 twin)", got3[0], ref[0], 2e-2)


def lstm(H, dev, gen):
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.lstm_recurrence import (
        BiLSTMRecurrenceTrain, bilstm_recurrence, bilstm_recurrence_plain)

    T, B = 12, 5
    w_hh = ((2 * torch.rand(2, H, 4 * H, generator=gen) - 1) / H ** 0.5).to(dev)
    xp = torch.randn(T, 2, B, 4 * H, generator=gen).to(dev)
    m = (torch.arange(T)[:, None] < torch.tensor([12, 9, 3, 0, 12])[None, :]).float().to(dev)
    print(f"  plans fwd {cuda.bilstm_fwd_plan(H)} chain {cuda.bilstm_chain_plan(H)} launch "
          f"{cuda.bilstm_fwd_launch(B, H)}", flush=True)
    with torch.no_grad():
        for a, b, n in zip(bilstm_recurrence(xp, m, w_hh), bilstm_recurrence_plain(xp, m, w_hh),
                           ("outs", "h", "c")):
            close(f"bilstm_recurrence H={H} {n}", a, b, 1e-5)
    cts = [torch.randn(*s, generator=gen).to(dev) for s in ((T, 2, B, H), (2, B, H), (2, B, H))]

    def fwd_bwd(fn):
        a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
        torch.autograd.backward(fn(a, m, w)[:3], cts)
        return a.grad, w.grad

    for n, a, b in zip(("dxp", "dw_hh"), fwd_bwd(BiLSTMRecurrenceTrain.apply),
                       fwd_bwd(bilstm_recurrence_plain)):
        close(f"bilstm train H={H} {n}", a, b, grad=True)


def chain(H, dev, gen, B=2, S=5, Tz=20, E=None):
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.decoder_chain import DecoderChain, decoder_chain_plain

    E = E or 2 * H
    tz = torch.randint(max(1, Tz // 2), Tz + 1, (B,), generator=gen)
    maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float()
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    wt = lambda k, *shape: torch.randn(*shape, generator=gen) / k ** 0.5  # noqa: E731
    args = [t.to(dev) for t in (
        torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf, r(B, H),
        r(B, H), wt(H, H, H), r(H), r(H), wt(H + E, H, H), wt(H + E, E, H), r(H),
        wt(2 * H, H, 4 * H), wt(2 * H, H, 4 * H), r(4 * H))]
    print(f"  plans fwd {cuda.decoder_chain_fwd_plan(H)} bwd {cuda.decoder_chain_plan(H)} "
          f"routes {cuda.decoder_chain_route(B, H, E, Tz)}", flush=True)
    dcts = [torch.randn(S, B, H, generator=gen).to(dev) for _ in range(3)]
    with torch.no_grad():
        for n, a, b in zip(("hs", "cs", "comb"), cuda.decoder_chain_forward(*args),
                           decoder_chain_plain(*args)):
            close(f"decoder_chain_fwd H={H} Tz={Tz} {n}", a, b)

    def grads(fn):
        xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]
        torch.autograd.backward(fn(*xs), dcts)
        return [t.grad for i, t in enumerate(xs) if i != 3]

    names = ("emb", "enc", "pre", "h0", "c0", "wl2", "bl2", "v", "wc1", "wc2", "bc", "wih",
             "whh", "bl")
    for n, a, b in zip(names, grads(DecoderChain.apply), grads(decoder_chain_plain)):
        close(f"decoder_chain_bwd H={H} Tz={Tz} d{n}", a, b, grad=True)


def viterbi(dev, gen):
    import torch
    from mucon_tpu_torch import cuda

    for fs in (1, 3):
        args = (*cs.viterbi_tables(gen, torch.randint(1500, 2101, (16,), generator=gen), 2560,
                                   dev, frame_sampling=fs), fs, cs.MAX_LEN)
        W, pois = args[0], args[1]
        print(f"  frame_sampling {fs}: plan {cuda.viterbi_plan(*W.shape[::2], pois.shape[2], W.shape[1])}")
        cs.check_decode(f"frame_sampling={fs}", args, reps=1)
    for K, N, L in ((40, 300, 20), (40, 300, 66)):
        args = cs.viterbi_edge_args(K, N, L, 30, cs.MAX_LEN, gen, dev)
        print(f"  N={N} L={L}: plan {cuda.viterbi_plan(6, N, L, K)}")
        cs.check_decode(f"N={N} L={L}", args, reps=1)


def main() -> int:
    import torch
    from mucon_tpu_torch import cuda

    quick = "--quick" in sys.argv
    t0 = time.perf_counter()
    lib = cuda.build()
    print(f"nvcc: {time.perf_counter() - t0:.1f} s", flush=True)
    log = lib.with_suffix(".log").read_text()
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "wide" in fn and ("Used" in line or "spill" in line):
            print(f"  ptxas {fn[:60]}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    failed = []
    checks = [("stacks C=600", lambda: stacks(600, dev, gen)),
              ("lstm H=600", lambda: lstm(600, dev, gen)),
              ("chain H=600", lambda: chain(600, dev, gen)),
              ("chain H=128 Tz=2048 B=1", lambda: chain(128, dev, gen, B=1, S=31, Tz=2048)),
              ("viterbi", lambda: viterbi(dev, gen))]
    if not quick:
        checks += [("stacks C=768", lambda: stacks(768, dev, gen)),
                   ("lstm H=1447", lambda: lstm(1447, dev, gen)),
                   ("chain H=1181", lambda: chain(1181, dev, gen))]
    for name, fn_ in checks:
        print(f"{name}:", flush=True)
        try:
            fn_()
            torch.cuda.synchronize()
        except Exception:  # report every check, then fail
            traceback.print_exc()
            failed.append(name)
    print(json.dumps({"failed": failed, "card": torch.cuda.get_device_name(0)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
