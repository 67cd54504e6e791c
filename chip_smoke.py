#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mucon_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card (sm_90a):

1. prints the card's name and power limit (nvidia-smi) and the torch / CUDA
   versions;
2. builds the three hand-written kernels of mucon_tpu_torch/csrc with nvcc;
3. checks each kernel against its plain PyTorch twin at the default model's
   full width (B=128, T=2560, C=128, 11 layers; Tz=160, H=128; K=85, N=30,
   L=66) and times both with CUDA events;
4. serves two requests through `predict_videos` (the bench eval batch of 128
   videos of 1500-2100 frames, and 3 videos of 517/1203/2100 frames) with
   the kernels and with the plain path, checks that the kernels were
   launched and that both paths agree, and times both;
5. prints the kernel report JSON, then `{"ok": true, "device": {...}}` as
   the last line.

Weights are random from a seeded torch.Generator and features from a seeded
numpy generator.  Any failure raises and exits non-zero; without a visible
CUDA device the script exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
}


def say(msg: str) -> None:
    print(msg, flush=True)


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
    from types import SimpleNamespace

    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
    from mucon_tpu_torch.models.model import batch_to_tensors
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval

    db = SimpleNamespace(
        max_transcript_length=N_MAX, sos_token_id=M + 1, eos_token_id=M,
        action_id_to_name={i: f"action_{i}" for i in range(M)},
    )
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
    missing = [name for name, n in launches.items() if n == 0]
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


def main() -> int:
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
