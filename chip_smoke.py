#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mucon_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card (sm_90a):

1. prints the card's name and power limit (nvidia-smi) and the torch / CUDA
   versions;
2. builds the hand-written kernels of mucon_tpu_torch/csrc with nvcc (one
   process per source, all at once);
3. checks each serving kernel against its plain PyTorch twin at the default model's
   full width (B=128, T=2560, C=128, 11 layers; Tz=160, H=128; K=85, N=30,
   L=66) and times both with CUDA events;
4. serves two requests through `predict_videos` (the bench eval batch of 128
   videos of 1500-2100 frames, and 3 videos of 517/1203/2100 frames) with
   the kernels and with the plain path, checks that the kernels were
   launched and that both paths agree, and times both;
5. trains: checks the four train kernels (the WaveNet stack's forward and
   backward sweep, the BiLSTM recurrence with its cell stash and its
   reverse chain) against their plain twins at the default model's width
   (B=8, T=2560, dropout 0.25), takes three `SimpleTrainer.train_step`s with
   the kernels (twice) and three with the plain twins from the same weights,
   masks and batch (8 videos of 1500-2100 frames), checks that the train
   kernels were launched, that the kernel path repeats bit for bit and that
   both paths agree, and times the step and its stages;
6. prints the kernel report JSON, then `{"ok": true, "device": {...}}` as
   the last line.

Weights are random from a seeded torch.Generator and features from a seeded
numpy generator.  Any failure raises and exits non-zero; without a visible
CUDA device the script exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

M, D, N_MAX = 48, 2048, 30  # classes, feature width, max transcript length
FRAME_SAMPLING, MAX_LEN = 30, 2000
TIE = 1e-4  # a kernel/plain mismatch is allowed only at a near tie this close
REPLACES = {
    "wavenet_layer": ("mucon_tpu_torch/csrc/wavenet_stack.cu",
                      "mucon_tpu/ops/wavenet_pallas_v2.py:151"),
    "bilstm_recurrence": ("mucon_tpu_torch/csrc/bilstm.cu",
                          "mucon_tpu/ops/lstm_pallas.py:90"),
    "dense_viterbi": ("mucon_tpu_torch/csrc/viterbi.cu",
                      "mucon_tpu/ops/viterbi_pallas.py:231"),
    "wavenet_train_fwd": ("mucon_tpu_torch/csrc/wavenet_train.cu",
                          "mucon_tpu/ops/wavenet_train_pallas_v3.py:358"),
    "wavenet_train_sweep": ("mucon_tpu_torch/csrc/wavenet_train.cu",
                            "mucon_tpu/ops/wavenet_train_pallas_v3.py:449"),
    "bilstm_train_fwd": ("mucon_tpu_torch/csrc/bilstm.cu",
                         "mucon_tpu/ops/lstm_pallas.py:249"),
    "bilstm_train_bwd": ("mucon_tpu_torch/csrc/bilstm.cu",
                         "mucon_tpu/ops/lstm_pallas.py:275"),
}
SERVING_KERNELS = ("wavenet_layer", "bilstm_recurrence", "dense_viterbi")
# the train path: the stack's out-projection is a `wavenet_layer` launch
TRAIN_KERNELS = ("wavenet_layer", "wavenet_train_fwd", "wavenet_train_sweep",
                 "bilstm_train_fwd", "bilstm_train_bwd")
TRAIN_B, TRAIN_STEPS, DROP = 8, 3, 0.25
# Forward outputs: max abs err <= FWD_BOUND * max|plain|.  Gradients:
# relative L2 err <= GRAD_BOUND and max abs err <= GRAD_MAX_BOUND *
# max|plain|.  The max-abs bound is the looser one: where a ReLU input lies
# within f32 rounding of 0 (or a max-pool pair within rounding of a tie),
# the kernel and the plain twin take the two sides of the kink, and that
# one element's gradient differs by its own size, spread by the layers
# below (on the card, one such flip in layer 7 moved 239 of dW3's 540672
# entries, relative L2 2e-4, max abs 0.15% of max|plain|).  It still fails
# an error confined to a few entries, which relative L2 alone cannot see.
FWD_BOUND, GRAD_BOUND, GRAD_MAX_BOUND = 1e-4, 1e-3, 1e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def vocab() -> SimpleNamespace:
    """The vocabulary `collate_videos` and `predict_videos` read: M actions,
    EOS = M, SOS = M + 1."""
    return SimpleNamespace(
        max_transcript_length=N_MAX, sos_token_id=M + 1, eos_token_id=M,
        action_id_to_name={i: f"action_{i}" for i in range(M)},
    )


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn`, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, reps: int) -> tuple:
    """Kernel and plain timings taken in turns: plain, kernel, kernel, plain."""
    ms = {"k": [], "p": []}
    for order in (("p", "k"), ("k", "p")):
        for side in order:
            ms[side].append(cuda_ms(kernel_fn if side == "k" else plain_fn, reps))
    return float(np.mean(ms["k"])), float(np.mean(ms["p"]))


# -- phase 3: each kernel against its plain twin at full width ---------------

def check_wavenet(model, gen, dev):
    import torch
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.wavenet_stack import (
        pack_wavenet_params, wavenet_stack, wavenet_stack_plain,
    )

    ft = model.net.ft
    B, T, C = 128, 2560, ft.Conv1x1_0.kernel.shape[1]
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    x = torch.relu(torch.randn(B, T, C, generator=gen) * 0.6).to(dev)
    args = (mask_time(x, lengths), lengths, *pack_wavenet_params(ft))
    kw = dict(stages=ft.stages, pooling_layers=ft.pooling_layers,
              pooling_type=ft.pooling_type, leaky=ft.leaky)
    zk, tk = wavenet_stack(*args, **kw)
    zp, tp = wavenet_stack_plain(*args, **kw)
    err = (zk - zp).abs().max().item()
    bound = 1e-4 * zp.abs().max().item()
    if not torch.equal(tk, tp) or not err <= bound:
        raise AssertionError(f"wavenet_layer: max abs err {err} > {bound}")
    ms, plain_ms = paired_ms(lambda: wavenet_stack(*args, **kw),
                             lambda: wavenet_stack_plain(*args, **kw), reps=5)
    say(f"kernel wavenet_layer B={B} T={T} C={C} L={len(ft.stages)}: max abs err "
        f"{err:.3e} <= {bound:.3e} (1e-4 * max|plain|); {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms")
    return err, ms, plain_ms


def check_bilstm(model, gen, dev):
    import torch
    from mucon_tpu_torch.ops.lstm_recurrence import (
        bilstm_recurrence, bilstm_recurrence_plain,
    )

    lstm = model.net.fs_encoder_lstm
    w_hh = torch.stack([lstm.fwd.w_hh, lstm.bwd.w_hh]).contiguous()
    T, B, H = 160, 128, w_hh.shape[1]
    xp = torch.randn(T, 2, B, 4 * H, generator=gen).to(dev)
    tz = torch.randint(1500 // 16, 2100 // 16 + 1, (B,), generator=gen)
    m = (torch.arange(T)[:, None] < tz[None, :]).to(torch.float32).to(dev)
    outk = bilstm_recurrence(xp, m, w_hh)
    outp = bilstm_recurrence_plain(xp, m, w_hh)
    err = max((a - b).abs().max().item() for a, b in zip(outk, outp))
    if not err <= 1e-5:
        raise AssertionError(f"bilstm_recurrence: max abs err {err} > 1e-5")
    ms, plain_ms = paired_ms(lambda: bilstm_recurrence(xp, m, w_hh),
                             lambda: bilstm_recurrence_plain(xp, m, w_hh), reps=5)
    say(f"kernel bilstm_recurrence Tz={T} B={B} H={H}: max abs err {err:.3e} "
        f"<= 1e-5; {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def check_viterbi(gen, dev):
    import torch
    import torch.nn.functional as F
    from mucon_tpu_torch.models.layers import nearest_upsample_indices
    from mucon_tpu_torch.ops.viterbi import dense_viterbi_plain, viterbi_precompute_z
    from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi

    B, T_pad, Tz = 128, 2560, 160
    L = MAX_LEN // FRAME_SAMPLING
    nf = torch.randint(1500, 2101, (B,), generator=gen)
    seg_lp_z = F.log_softmax(torch.randn(B, Tz, M, generator=gen) * 2.0, dim=-1)
    n_valid = torch.randint(1, N_MAX + 1, (B,), generator=gen)
    trs = torch.randint(0, M, (B, N_MAX), generator=gen)
    trs = torch.where(torch.arange(N_MAX)[None, :] < n_valid[:, None], trs, 0)
    lam = 20.0 + 180.0 * torch.rand(B, M, generator=gen)
    nf, seg_lp_z, n_valid, trs, lam = (t.to(dev) for t in (nf, seg_lp_z, n_valid, trs, lam))
    up_idx = nearest_upsample_indices(nf // 16, T_pad, nf)
    W, pois, kv = viterbi_precompute_z(
        seg_lp_z, up_idx, nf, trs, lam,
        frame_sampling=FRAME_SAMPLING, max_len=MAX_LEN, l_max=L,
    )
    args = (W, pois, kv, n_valid, FRAME_SAMPLING, MAX_LEN)
    sk, lk, bk = dense_viterbi(*args)
    sp, lp, bp = dense_viterbi_plain(*args)
    err = (sk - sp).abs().max().item()
    rel = ((sk - sp).abs() / sp.abs()).max().item()
    if not rel <= 1e-5 or not torch.equal(lk, lp) or not torch.equal(bk, bp):
        raise AssertionError(
            f"dense_viterbi: score rel {rel}, best_l equal {torch.equal(lk, lp)}, "
            f"bps equal {torch.equal(bk, bp)}"
        )
    ms, plain_ms = paired_ms(lambda: dense_viterbi(*args),
                             lambda: dense_viterbi_plain(*args), reps=5)
    say(f"kernel dense_viterbi B={B} K={W.shape[1]} N={W.shape[2]} L={L}: score "
        f"max abs err {err:.3e} (rel {rel:.3e} <= 1e-5), best_l and bps exact; "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


# -- phase 4: the serving path end to end ------------------------------------

def top2_margin(row) -> float:
    top = np.sort(np.asarray(row, np.float64))[-2:]
    return float(top[1] - top[0])


def path_score(W, pois, pos, kv: int, n_valid: int) -> float:
    """f32 DP score of a window-position path under tables W [K x N],
    pois [N x L], accumulated in the DP's own order; -inf for a path the
    DP cannot take (it starts at position 0, steps by at most one and ends
    at position n_valid - 1)."""
    f = np.float32
    if pos[0] != 0:
        return -np.inf
    s, n, run = f(W[0, 0]), 0, 1
    for k in range(1, kv):
        if pos[k] == n:
            if (run + 1) * FRAME_SAMPLING > MAX_LEN:
                return -np.inf
            s, run = f(s + f(W[k, n])), run + 1
        elif pos[k] == n + 1:
            s = f(f(s + f(pois[n, run - 1])) + f(W[k, n]))
            n, run = n + 1, 1
        else:
            return -np.inf
    if n != n_valid - 1:
        return -np.inf
    return float(f(s + f(pois[n, run - 1])))


def compare_request(tag, model, arrays, outk, outp, predk, predp):
    """Kernel vs plain on one request: integer outputs equal, vit_score
    within rel 1e-4; a mismatch passes only at a plain-path near tie (top-two
    margin <= TIE for an argmax, or a Viterbi path whose plain-table score is
    within TIE * |score| of the best).  Returns the list of mismatches."""
    from mucon_tpu_torch.ops.eval_fused import eval_tables
    from mucon_tpu_torch.ops.viterbi import NEG

    cache = {}

    def plain_tables():
        if not cache:
            fwd = model.forward(arrays, use_kernels=False)
            cache["fwd"] = fwd
            cache["tb"] = eval_tables(
                fwd, arrays["num_frames"], arrays["feats"].shape[1],
                arrays["transcript"].shape[1], FRAME_SAMPLING, MAX_LEN,
            )
        return cache["fwd"], cache["tb"]

    def allow(what, b, margin, bound):
        line = f"{tag} video {b}: {what} differs; plain margin {margin:.3e} (bound {bound:.3e})"
        if not margin <= bound:
            raise AssertionError(line)
        mismatches.append(line)

    mismatches = []
    for b in range(outp["tokens"].shape[0]):
        tz = int(outp["tz_len"][b])
        yk, yp = outk["y_argmax_z"][b, :tz], outp["y_argmax_z"][b, :tz]
        if not np.array_equal(yk, yp):
            t = int(np.flatnonzero(yk != yp)[0])
            allow(f"y label at Tz position {t}", b,
                  top2_margin(plain_tables()[1].seg_lp_z[b, t].cpu()), TIE)
        elif not np.array_equal(predk[b]["y_labels"], predp[b]["y_labels"]):
            raise AssertionError(f"{tag} video {b}: y labels differ")

        tk, tp = outk["tokens"][b], outp["tokens"][b]
        if not np.array_equal(tk, tp):
            s = int(np.flatnonzero(tk != tp)[0])
            allow(f"token at step {s}", b,
                  top2_margin(plain_tables()[0].transcript[b, s].cpu()), TIE)
            continue  # the transcript and everything after it follow
        for key in ("n_steps", "n_dec", "transcripts", "vit_k_valid"):
            if not np.array_equal(outk[key][b], outp[key][b]):
                raise AssertionError(f"{tag} video {b}: {key} differs with equal tokens")
        if predk[b]["transcript"] != predp[b]["transcript"]:
            raise AssertionError(f"{tag} video {b}: predicted transcript differs")
        sk, sp = float(outk["vit_score"][b]), float(outp["vit_score"][b])
        if not abs(sk - sp) <= 1e-4 * abs(sp):
            raise AssertionError(f"{tag} video {b}: vit_score {sk} vs {sp}")
        if not np.array_equal(outk["vit_pos"][b], outp["vit_pos"][b]):
            tb = plain_tables()[1]
            kv = int(outp["vit_k_valid"][b])
            alt = path_score(tb.W[b].cpu().numpy(), tb.pois[b].cpu().numpy(),
                             outk["vit_pos"][b], kv, int(outp["n_dec"][b]))
            # no tie allowance when the plain DP found no feasible path
            bound = TIE * abs(sp) if sp > NEG / 2 else 0.0
            allow("Viterbi path", b, sp - alt, bound)
        elif not np.array_equal(predk[b]["vit_labels"], predp[b]["vit_labels"]):
            raise AssertionError(f"{tag} video {b}: Viterbi labels differ")
    return mismatches


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def check_outputs(tag, out, preds, lengths):
    """The serving output is well formed: finite, right shapes, relative
    lengths a distribution over the decoded transcript."""
    B = len(lengths)
    expect(out["tokens"].shape == (B, N_MAX + 1), f"{tag}: tokens {out['tokens'].shape}")
    expect(np.isfinite(out["vit_score"]).all() and np.isfinite(out["rel_lengths"]).all(),
           f"{tag}: non-finite scores or lengths")
    for b, (p, t) in enumerate(zip(preds, lengths)):
        n = int(out["n_dec"][b])
        expect(1 <= n <= N_MAX and len(p["transcript"]) == n, f"{tag} {b}: n_dec {n}")
        expect(abs(sum(p["rel_lengths"]) - 1.0) < 1e-4, f"{tag} {b}: rel_lengths sum")
        expect(p["vit_labels"].shape == (t,) and p["y_labels"].shape == (t,),
               f"{tag} {b}: label shapes")
        expect(set(np.unique(p["vit_labels"])) <= set(p["transcript"]),
               f"{tag} {b}: Viterbi labels outside the transcript")


def serve(model, dev, rng, card: str):
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
    from mucon_tpu_torch.models.model import batch_to_tensors
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval

    db = vocab()
    requests = {
        "A": [int(t) for t in rng.integers(1500, 2101, size=128)],  # bench.py eval batch
        "B": [517, 1203, 2100],
    }
    feats = {k: [rng.standard_normal((t, D), dtype=np.float32) for t in v]
             for k, v in requests.items()}
    names = {k: [f"{k}_{i}" for i in range(len(v))] for k, v in requests.items()}

    def predict(k, use_kernels):
        return predict_videos(model, feats[k], names[k], db,
                              frame_sampling=FRAME_SAMPLING,
                              batch_size=len(feats[k]), use_kernels=use_kernels)

    cuda.reset_launch_counts()
    pred_k = {k: predict(k, True) for k in requests}
    launches = dict(cuda.launch_counts)
    say(f"launches on the serving path: {launches}")
    missing = [name for name in SERVING_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    pred_p = {k: predict(k, False) for k in requests}

    run_k = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=True)
    run_p = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=False)
    for k in requests:
        arrays = batch_to_tensors(collate_videos(feats[k], names[k], db), dev)
        outk, outp = run_k(arrays), run_p(arrays)
        check_outputs(k, outk, pred_k[k], requests[k])
        check_outputs(k, outp, pred_p[k], requests[k])
        mism = compare_request(k, model, arrays, outk, outp, pred_k[k], pred_p[k])
        for line in mism:
            say(f"near-tie mismatch (allowed): {line}")
        B = len(requests[k])
        no_eos = int((outk["n_steps"] == N_MAX + 1).sum())
        say(f"request {k}: B={B} T_pad={arrays['feats'].shape[1]} kernel == plain "
            f"({len(mism)} near-tie mismatches); {no_eos}/{B} videos decoded all "
            f"{N_MAX + 1} steps without EOS")
        ms, plain_ms = paired_ms(lambda: run_k(arrays), lambda: run_p(arrays), reps=3)
        say(f"request {k} fused eval (device-resident features): kernels {ms:.2f} "
            f"ms/batch = {1000 * B / ms:.1f} videos/s; plain {plain_ms:.2f} ms/batch "
            f"= {1000 * B / plain_ms:.1f} videos/s [{card}]")
        pk, pp = paired_ms(lambda: predict(k, True), lambda: predict(k, False), reps=1)
        say(f"request {k} predict_videos (host features in, labels out): kernels "
            f"{pk:.1f} ms/batch = {1000 * B / pk:.1f} videos/s; plain {pp:.1f} "
            f"ms/batch = {1000 * B / pp:.1f} videos/s [{card}]")
        del arrays
    return launches


# -- phase 5: the train path -------------------------------------------------

def held(name, pairs, grads: bool) -> float:
    """Every (label, got, ref) pair within its bounds (the max abs err
    within FWD_BOUND * max|ref|; for a gradient, the max abs err within
    GRAD_MAX_BOUND * max|ref| and the relative L2 err within GRAD_BOUND);
    returns the largest absolute error."""
    import torch

    worst, parts = 0.0, []
    for label, got, ref in pairs:
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        bound = (GRAD_MAX_BOUND if grads else FWD_BOUND) * ref.abs().max().item()
        ok, part = err <= bound, f"{label} {err:.2e} <= {bound:.2e}"
        if grads:
            rel = (torch.linalg.vector_norm(got - ref) /
                   torch.linalg.vector_norm(ref).clamp_min(1e-30)).item()
            ok, part = ok and rel <= GRAD_BOUND, f"{part}, rel L2 {rel:.2e}"
        if not ok:
            raise AssertionError(f"{name} {label} out of bounds: {part}")
        parts.append(part)
    bound = (f"max abs <= {GRAD_MAX_BOUND:g} * max|plain|, rel L2 <= {GRAD_BOUND:g}"
             if grads else f"max abs <= {FWD_BOUND:g} * max|plain|")
    say(f"kernel {name}: " + "; ".join(parts) + f" ({bound})")
    return worst


def train_batch(rng, dev):
    """TRAIN_B seeded videos of 1500-2100 frames (padded to 2560) with
    transcripts of 1-30 actions, as the forward and the loss read them."""
    from mucon_tpu_torch.cli.predict import collate_videos
    from mucon_tpu_torch.models.model import batch_to_tensors

    feats, transcripts = [], []
    for t in rng.integers(1500, 2101, size=TRAIN_B):
        transcripts.append(rng.integers(0, M, size=int(rng.integers(1, N_MAX + 1))))
        feats.append(rng.standard_normal((int(t), D), dtype=np.float32))
    names = [f"train_{i}" for i in range(TRAIN_B)]
    return batch_to_tensors(
        collate_videos(feats, names, vocab(), 512, transcripts=transcripts), dev)


def check_wavenet_train(model, arrays, gen, dev):
    """Kernel A: the stack's forward and every gradient against the plain
    twin under autograd, same masks and cotangent."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )

    ft = model.net.ft
    lengths = arrays["num_frames"]
    with torch.no_grad():
        x = ft.in_projection(arrays["feats"], lengths)
    B, T, C = x.shape
    kw = dict(stages=ft.stages, pooling_layers=ft.pooling_layers,
              pooling_type=ft.pooling_type, leaky=ft.leaky)
    t_ins, _, _, t_fin = stack_plan(ft.stages, ft.pooling_layers, T)
    mgen = torch.Generator(device=dev).manual_seed(2)
    masks = [dropout_mask(mgen, DROP, (B, t, C), dev) for t in t_ins]
    g = torch.randn(B, t_fin, C, generator=gen).to(dev)
    weights = [w.detach().clone() for w in pack_wavenet_params(ft)]

    def fwd_bwd(fn):
        xs = [t.clone().requires_grad_() for t in (x, *weights)]
        z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw)
        z.backward(g)
        return z.detach(), [t.grad for t in xs]

    zk, gk = fwd_bwd(wavenet_stack_train)
    zp, gp = fwd_bwd(wavenet_stack_train_plain)
    names = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")
    fwd_err = held("wavenet_train_fwd", [("z", zk, zp)], grads=False)
    bwd_err = held("wavenet_train_sweep", list(zip(names, gk, gp)), grads=True)

    w3, b3, w1, b1, wl, bl = weights
    xm = mask_time(x, lengths)
    _, stash = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **kw)
    # the weight gradients are summed in a fixed order: two sweeps agree bit for bit
    sweeps = [cuda.wavenet_train_backward(g, stash, lengths, w3, w1, wl, masks, **kw)
              for _ in range(2)]
    expect(all(torch.equal(a, b) for a, b in zip(*sweeps)),
           "wavenet_train_sweep: two sweeps of the same inputs differ")
    say("kernel wavenet_train_sweep: two sweeps of the same inputs agree bit for bit")
    xs = [t.clone().requires_grad_() for t in (x, *weights)]
    z_graph, _ = wavenet_stack_train_plain(xs[0], lengths, *xs[1:], drop_masks=masks, **kw)
    with torch.no_grad():
        fwd_ms = paired_ms(
            lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks, **kw),
            lambda: wavenet_stack_train_plain(x, lengths, *weights, drop_masks=masks, **kw),
            reps=5)
    bwd_ms = paired_ms(
        lambda: cuda.wavenet_train_backward(g, stash, lengths, w3, w1, wl, masks, **kw),
        lambda: torch.autograd.grad(z_graph, xs, g, retain_graph=True), reps=5)
    say(f"kernel wavenet_train_fwd B={B} T={T} C={C} L={len(ft.stages)} dropout {DROP}: "
        f"{fwd_ms[0]:.3f} ms vs plain {fwd_ms[1]:.3f} ms; wavenet_train_sweep "
        f"{bwd_ms[0]:.3f} ms vs plain autograd {bwd_ms[1]:.3f} ms")
    return {"wavenet_train_fwd": (fwd_err, *fwd_ms),
            "wavenet_train_sweep": (bwd_err, *bwd_ms)}


def check_bilstm_train(model, gen, dev):
    """Kernel B: the recurrence with its cell stash and the reverse chain
    (dxp, and dw_hh from it) against the plain twin under autograd."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.lstm_recurrence import (
        BiLSTMRecurrenceTrain, bilstm_recurrence_plain,
    )

    lstm = model.net.fs_encoder_lstm
    w_hh = torch.stack([lstm.fwd.w_hh, lstm.bwd.w_hh]).detach().contiguous()
    T, B, H = 160, TRAIN_B, w_hh.shape[1]
    xp = torch.randn(T, 2, B, 4 * H, generator=gen).to(dev)
    tz = torch.randint(1500 // 16, 2100 // 16 + 1, (B,), generator=gen)
    m = (torch.arange(T)[:, None] < tz[None, :]).to(torch.float32).to(dev)
    cts = [torch.randn(*s, generator=gen).to(dev) for s in ((T, 2, B, H), (2, B, H), (2, B, H))]

    with torch.no_grad():
        outk = cuda.bilstm_train_forward(xp, m, w_hh)
        outp = bilstm_recurrence_plain(xp, m, w_hh, stash=True)
    fwd_err = held("bilstm_train_fwd", list(zip(("outs", "h", "c", "cs"), outk, outp)),
                   grads=False)

    def fwd_bwd(fn):
        a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
        torch.autograd.backward(fn(a, m, w)[:3], cts)
        return a.grad, w.grad

    gk = fwd_bwd(BiLSTMRecurrenceTrain.apply)
    gp = fwd_bwd(bilstm_recurrence_plain)
    bwd_err = held("bilstm_train_bwd", list(zip(("dxp", "dw_hh"), gk, gp)), grads=True)

    outs, _, _, cs = outk
    h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])

    def kernel_bwd():
        dxp = cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, *cts)
        return torch.einsum("tdbh,tdbg->dhg", h_prev, dxp)

    a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
    graph = bilstm_recurrence_plain(a, m, w)
    with torch.no_grad():
        fwd_ms = paired_ms(lambda: cuda.bilstm_train_forward(xp, m, w_hh),
                           lambda: bilstm_recurrence_plain(xp, m, w_hh, stash=True), reps=5)
    bwd_ms = paired_ms(kernel_bwd,
                       lambda: torch.autograd.grad(graph, (a, w), cts, retain_graph=True),
                       reps=5)
    say(f"kernel bilstm_train_fwd Tz={T} B={B} H={H}: {fwd_ms[0]:.3f} ms vs plain "
        f"{fwd_ms[1]:.3f} ms; bilstm_train_bwd (chain + dw_hh einsum) {bwd_ms[0]:.3f} ms "
        f"= {1000 * bwd_ms[0] / T:.2f} us/step vs plain autograd {bwd_ms[1]:.3f} ms")
    return {"bilstm_train_fwd": (fwd_err, *fwd_ms), "bilstm_train_bwd": (bwd_err, *bwd_ms)}


def stage_ms(trainer, arrays, reps: int = 3) -> dict:
    """Milliseconds of each stage of one train step on the card, from CUDA
    events recorded by module and gradient hooks (mean of `reps` steps
    after one warm-up).  Each label names the span that ends at its mark."""
    import torch
    from mucon_tpu_torch.harness.optim import clip_grad_norm_partitioned

    net = trainer.model.net
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    def grad_mark(name):
        def hook(_):
            mark(name)
        return hook

    calls = {"decoder": 0}

    def decoder_pre(m, i):
        if calls["decoder"] == 0:
            mark("encoder heads + framewise head")
        calls["decoder"] += 1

    def decoder_post(m, i, o):
        if calls["decoder"] == net.max_decoding_steps:
            mark(f"decoder loop ({net.max_decoding_steps} steps)")

    hooks = [
        net.ft.Conv1x1_0.register_forward_hook(lambda m, i, o: (
            mark("in-projection"), o.register_hook(grad_mark("stack sweep")))[0]),
        net.ft_last_gn.register_forward_pre_hook(lambda m, i: (
            mark("stack forward"), i[0].register_hook(grad_mark("GN + ReLU backward")))[0]),
        net.fs_encoder_lstm.register_forward_pre_hook(lambda m, i: (
            mark("GN + ReLU + dropout"), i[0].register_hook(grad_mark("BiLSTM backward")))[0]),
        net.fs_encoder_lstm.register_forward_hook(lambda m, i, o: (
            mark("BiLSTM forward"),
            o[0].register_hook(grad_mark("loss + heads + decoder backward")))[0]),
        net.decoder.register_forward_pre_hook(decoder_pre),
        net.decoder.register_forward_hook(decoder_post),
    ]
    totals = {}
    try:
        for rep in range(reps + 1):
            marks.clear()
            calls["decoder"] = 0
            gen = trainer.step_generator()
            torch.cuda.synchronize()
            mark("start")
            fwd = trainer.model.forward(arrays, use_kernels=trainer.use_kernels, train=True,
                                        generator=gen)
            loss = trainer.model.loss(fwd, arrays)
            mark("loss")
            trainer.optimizer.zero_grad(set_to_none=True)
            loss.main.backward()
            mark("in-projection backward")
            clip_grad_norm_partitioned(trainer.partition, trainer.config.clip_grad_norm_value)
            mark("partitioned clip")
            trainer.optimizer.step()
            mark("SGD update")
            torch.cuda.synchronize()
            if rep:
                for (_, a), (name, b) in zip(marks, marks[1:]):
                    totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / reps
                totals["step"] = totals.get("step", 0.0) + \
                    marks[0][1].elapsed_time(marks[-1][1]) / reps
    finally:
        for h in hooks:
            h.remove()
    return totals


def train(dev, rng, card: str):
    """Three train steps with the kernels (twice) and three with the plain
    twins from the same weights, masks and batch; returns the kernel checks
    and the train path's launch counts.

    The steps run under `torch.use_deterministic_algorithms`: torch's
    default CUDA backward of its gather / index ops adds with atomics, and
    the length head's gradient is ill-conditioned (the mucon loss cancels
    terms of order T/L), so two plain runs alone differ by up to 2% of that
    head's update.  Deterministic, each path repeats bit for bit and the
    comparison sees the kernels' rounding only."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.harness.trainer import SimpleTrainer, TrainConfig
    from mucon_tpu_torch.models.model import create_model

    arrays = train_batch(rng, dev)
    config = TrainConfig(batch_size=TRAIN_B)
    trainers = {k: SimpleTrainer(None, create_model(M, N_MAX + 1, D, device=dev, seed=0),
                                 config, seed=1, use_kernels=(k != "p"))
                for k in ("k", "k2", "p")}
    results = {}
    gen = torch.Generator().manual_seed(3)
    results.update(check_wavenet_train(trainers["k"].model, arrays, gen, dev))
    results.update(check_bilstm_train(trainers["k"].model, gen, dev))

    def params(k):
        return {n: p.detach().clone() for n, p in trainers[k].model.net.named_parameters()}

    p0 = params("p")
    losses, snaps = {k: [] for k in trainers}, {k: {} for k in trainers}

    def run(k):
        for step in range(TRAIN_STEPS):
            out = trainers[k].train_step(arrays)
            trainers[k].iter_num += 1
            losses[k].append({n: float(v) for n, v in out.items()})
            if step in (0, TRAIN_STEPS - 1):
                snaps[k][step + 1] = params(k)

    torch.use_deterministic_algorithms(True)
    try:
        cuda.reset_launch_counts()
        run("k")
        torch.cuda.synchronize()
        launches = dict(cuda.launch_counts)
        run("k2")
        run("p")
    finally:
        torch.use_deterministic_algorithms(False)
    say(f"launches on the train path ({TRAIN_STEPS} steps): {launches}")
    missing = [name for name in TRAIN_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the train path: {missing}")
    expect(losses["k"] == losses["k2"] and all(
        torch.equal(a, snaps["k2"][step][n])
        for step in snaps["k"] for n, a in snaps["k"][step].items()),
        "two kernel runs of the same steps differ")
    say(f"kernel path run twice: the same losses and parameters bit for bit after "
        f"{TRAIN_STEPS} steps")

    for step, (lk, lp) in enumerate(zip(losses["k"], losses["p"])):
        expect(all(np.isfinite(v) for v in (*lk.values(), *lp.values())),
               f"train step {step}: non-finite loss")
        rel = max(abs(lk[n] - lp[n]) / max(abs(lp[n]), 1e-12) for n in lp)
        expect(rel <= 1e-4, f"train step {step}: loss rel diff {rel} > 1e-4 ({lk} vs {lp})")
        say(f"train step {step + 1}: main loss {lk['main']:.6f} (kernels) vs "
            f"{lp['main']:.6f} (plain), max rel diff over the 5 terms {rel:.2e} <= 1e-4")
    for step in sorted(snaps["p"]):
        worst = (0.0, "")
        for n, pp in snaps["p"][step].items():
            upd = (pp - p0[n]).abs().max().item()
            err = (snaps["k"][step][n] - pp).abs().max().item()
            expect(err <= 1e-2 * upd + 1e-7,
                   f"after step {step}: {n} differs by {err} (update {upd})")
            worst = max(worst, (err / max(upd, 1e-30), n))
        say(f"after step {step}: every parameter within 1e-2 * max|update| of the plain "
            f"path (worst {worst[0]:.2e}, {worst[1]})")

    ms = paired_ms(lambda: trainers["k"].train_step(arrays),
                   lambda: trainers["p"].train_step(arrays), reps=3)
    T = arrays["feats"].shape[1]
    say(f"train step B={TRAIN_B} T_pad={T} dropout {DROP}: kernels {ms[0]:.2f} ms = "
        f"{1000 * TRAIN_B / ms[0]:.2f} videos/s; plain {ms[1]:.2f} ms = "
        f"{1000 * TRAIN_B / ms[1]:.2f} videos/s [{card}]")
    for k, tag in (("k", "kernels"), ("p", "plain")):
        stages = stage_ms(trainers[k], arrays)
        say(f"train step stages ({tag}, ms): " + json.dumps(
            {n: round(v, 3) for n, v in stages.items()}))
    return results, launches


def main() -> int:
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace (the train phase compares runs bit for bit)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.model import create_model

    t0 = time.perf_counter()
    cuda.load()
    lib = cuda.build()  # the path of the library just built and loaded
    say(f"built {lib.name} from mucon_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    model = create_model(M, N_MAX + 1, D, device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        results = {
            "wavenet_layer": check_wavenet(model, gen, dev),
            "bilstm_recurrence": check_bilstm(model, gen, dev),
            "dense_viterbi": check_viterbi(gen, dev),
        }
        launches = serve(model, dev, np.random.default_rng(0), smi)
    del model
    train_results, train_launches = train(dev, np.random.default_rng(1), smi)
    results.update(train_results)
    launches.update({k: train_launches[k] for k in train_results})

    kernels = []
    for name, (err, ms, plain_ms) in results.items():
        source, replaces = REPLACES[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
