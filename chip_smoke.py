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
   L=66), the WaveNet stack and the MS-TCN++ stage (`ft_type="mstcnpp"`,
   the same widths; both on the tensor cores in 3xTF32, each also with one
   video of length 0 and with no padding, and the share of its row tiles
   that lie past a video's length), and times both with CUDA events; the
   Viterbi DP and its pointer walk (one launch) equal to the plain DP +
   `traceback_positions` in all four outputs, and repeating bit for bit, at
   B=128, at request B's three videos and at edge shapes (K = 1, N = 1,
   k_valid < K, infeasible videos, the block body at N = 40 and L = 133, a
   walk table in device memory at K = 4000), each timed beside the plain
   pair with its plan printed;
4. serves two requests through `predict_videos` (the bench eval batch of 128
   videos of 1500-2100 frames, and 3 videos of 517/1203/2100 frames) with
   the kernels and with the plain path, for the WaveNet model and for the
   MS-TCN++ model, checks that each path launched its kernels (and not the
   other backbone's), that the kernel path's fused eval launches the DP
   once a batch and runs no Python pointer walk, and that both paths agree,
   and times both (and the Viterbi DP + walk span of each);
5. trains: checks the seven train kernels (the WaveNet stack's forward and
   backward sweep — on the tensor cores in 3xTF32, their grid a layer and
   the shares of row tiles and rows skipped printed — the BiLSTM recurrence with its cell stash — on
   thread-block clusters, two calls bit for bit, its time per step, cluster
   width and waves printed — and its reverse chain — the parallel
   coefficient pass against its own plain twin, its replayed cell equal to
   the stash bit for bit, two calls bit for bit, and the cluster chain's
   time per step with and without the dw_hh einsum — the teacher-forced
   decoder chain's forward, on a thread-block cluster a video (its width,
   clusters and waves printed), and reverse chain — the replay pass against
   its plain twin, its relu(cpre) and cell equal to the forward's comb and
   cs bit for bit, the replay and the cluster chain timed apart — the fused
   flint loss, on a thread-block cluster a video, two calls bit for bit)
   against their plain twins at the default
   model's width (B=8, T=2560, dropout 0.25; the decoder chain also at
   B=2, Tz=640), and the v2 trainable stack's two kernels (three chunks;
   their cooperative grid printed) against the plain twin and, bit for bit
   on v3's grid, the v3 kernels with dropout 0.25 and 0, the sweep's
   recomputed u equal to the u the forward pooled (at the train batch and
   at request B's lengths);
   takes three `SimpleTrainer.train_step`s with the kernels and the loss
   kernel (twice) and three with the plain twins and the plain loss from
   the same weights, masks and batch (8 videos of 1500-2100 frames), checks
   that the train kernels were launched, that the kernel path repeats bit
   for bit and that both paths agree, and times the step and its stages;
   then the same three steps for the MS-TCN++ model (its stage's dropout
   0.5, the others 0.25), whose stage trains as plain PyTorch: the BiLSTM,
   decoder-chain and flint kernels must launch and no stack kernel;
6. runs the experiment entry point, `python -m
   mucon_tpu_torch.cli.train_test_mucon`, at full width (`cli_phase`: the
   default model, B=8, the flint loss kernel, 2 epochs of 18 synthetic
   videos of 1500-2100 frames written to a temp dir, an eval and a
   checkpoint after each, the final Viterbi eval of 6 videos) and checks the
   run folder and its 24 finite fields, each kernel's launches against the
   count the train steps and eval batches imply, `test_mucon`'s read-only
   re-evaluation (within 1e-6), a fresh trainer's `resume_latest` and the
   checkpoint's plain-path eval against the kernel eval's pickle (by
   `compare_request`'s near-tie rules), and prints its phases' seconds;
7. runs the other regimes and evaluation modes on that phase's data and
   checkpoint (`variants_phase`): `train_test_mucon_full` and
   `train_test_mucon_mixed` (50% supervised) for an epoch each, with their
   24 finite fields, both supervised loss terms in the train events, the
   mixed subset and each kernel's launches; three train steps of the fully
   supervised model with the kernels (twice) against plain steps from the
   same weights (`compare_steps`); `MuConAlignmentEvaluator` with and
   without the kernels (the decoder chain's forward kernel once an eval
   batch, s_mat_score 1, the two paths by `compare_request`'s rules); and
   the per-batch eval path, the DP kernel on full-T tables
   (`evaluator.viterbi.multi_length`) and the host oracle
   (`evaluator.viterbi.backend="host"`), each against the fused path
   within 2e-3 of the 24 fields, Viterbi labels equal but at near ties;
   it prints each path's seconds;
8. prints the kernel report JSON (each kernel's launches, error, time, the
   plain twin's time, the least time the card could take for the same work
   and, where one PyTorch call computes the same function, that call's
   time), then `{"ok": true, "device": {...}}` as the last line.

Weights are random from a seeded torch.Generator and features from a seeded
numpy generator.  Any failure raises and exits non-zero; without a visible
CUDA device the script exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from unittest import mock

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
    "decoder_chain_fwd": ("mucon_tpu_torch/csrc/decoder_chain.cu",
                          "mucon_tpu/ops/decoder_pallas.py:236"),
    "decoder_chain_bwd": ("mucon_tpu_torch/csrc/decoder_chain.cu",
                          "mucon_tpu/ops/decoder_pallas.py:298"),
    "mucon_flint": ("mucon_tpu_torch/csrc/mucon_loss.cu",
                    "mucon_tpu/ops/mucon_loss_pallas.py:177"),
    "mstcnpp_stack": ("mucon_tpu_torch/csrc/mstcnpp.cu",
                      "mucon_tpu/ops/mstcnpp_pallas.py:151"),
    "wavenet_train_v2_fwd": ("mucon_tpu_torch/csrc/wavenet_train_v2.cu",
                             "mucon_tpu/ops/wavenet_train_pallas_v2.py:430"),
    "wavenet_train_v2_sweep": ("mucon_tpu_torch/csrc/wavenet_train_v2.cu",
                               "mucon_tpu/ops/wavenet_train_pallas_v2.py:557"),
}
SERVING_KERNELS = ("wavenet_layer", "bilstm_recurrence", "dense_viterbi")
MSTCNPP_SERVING_KERNELS = ("mstcnpp_stack", "bilstm_recurrence", "dense_viterbi")
# the train path: the stack's out-projection is a `wavenet_layer` launch
TRAIN_KERNELS = ("wavenet_layer", "wavenet_train_fwd", "wavenet_train_sweep",
                 "bilstm_train_fwd", "bilstm_train_bwd", "decoder_chain_fwd",
                 "decoder_chain_bwd", "mucon_flint")
# the MS-TCN++ train step: its stage trains as plain PyTorch, as in the JAX package
MSTCNPP_TRAIN_KERNELS = ("bilstm_train_fwd", "bilstm_train_bwd", "decoder_chain_fwd",
                         "decoder_chain_bwd", "mucon_flint")
STACK_KERNELS = ("wavenet_layer", "wavenet_train_fwd", "wavenet_train_sweep",
                 "wavenet_train_v2_fwd", "wavenet_train_v2_sweep", "mstcnpp_stack")
TRAIN_B, TRAIN_STEPS, MSTCNPP_STEPS, DROP = 8, 3, 3, 0.25
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
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s, f32
# operations/s outside the tensor cores (f32 FMA code) and dense TF32
# operations/s on them.  A matrix-product kernel with f32 parity on the
# tensor cores pays three TF32 products per f32 product (hi/lo split
# operands, `mucon_tpu_torch/ops/tf32.py`): its least time is its f32
# operations over a third of the TF32 peak, 165 TFLOP/s.
HBM_BYTES_PER_S, F32_OPS_PER_S, TF32_OPS_PER_S = 3.35e12, 67e12, 495e12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def report(err, ms, plain_ms, moved: float, ops: float, library_ms=None,
           tf32x3: bool = False) -> dict:
    """A kernel's line of the report.  bound_ms, the least time the card
    could take for the same work, is the larger of the bytes the function
    must move (its inputs read once, its outputs written once, counting
    only the valid frames and steps of this run's data) over HBM's rate
    and its f32 operations on this data over the f32 peak; with `tf32x3`
    (a matrix-product kernel on the tensor cores) over a third of the TF32
    peak (`ops_type` says which).  A kernel faster than its bound is a
    fault of the bound: fails."""
    ops_rate = TF32_OPS_PER_S / 3 if tf32x3 else F32_OPS_PER_S
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / ops_rate
    bound_ms = max(bytes_ms, ops_ms)
    expect(ms >= bound_ms, f"a kernel's time {ms} ms is below its bound {bound_ms} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, ops_type="3xTF32" if tf32x3 else "f32")


def stack_rows(stages, pooling_layers, lengths) -> tuple:
    """Valid rows (sum over videos of frames) at each WaveNet layer's input
    and after the last pool."""
    lens = lengths.to("cpu").long()
    rows, shift = [], 0
    for i in range(len(stages)):
        rows.append(int((lens >> shift).sum()))
        shift += i in pooling_layers
    return rows, int((lens >> shift).sum())


def lstm_library_ms(x, lengths, H: int, backward: bool) -> float:
    """cuDNN's bidirectional LSTM (torch.nn.LSTM, the input projection
    included) on the packed batch x [B x T x I]: its forward, or with
    `backward` its gradient with respect to the input and the weights.  A
    yardstick only: the port never calls it."""
    import torch

    lstm = torch.nn.LSTM(x.shape[2], H, bidirectional=True, batch_first=True).to(x.device)
    xg = x.clone().requires_grad_(backward)
    packed = torch.nn.utils.rnn.pack_padded_sequence(xg, lengths.cpu(), batch_first=True,
                                                     enforce_sorted=False)
    if not backward:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(packed), reps=5)
    out = lstm(packed)[0].data
    g = torch.randn_like(out)
    params = [xg, *lstm.parameters()]
    return cuda_ms(lambda: torch.autograd.grad(out, params, g, retain_graph=True), reps=5)


def bilstm_launch(B: int, H: int) -> str:
    """The forward recurrence's cluster launch at B videos, as printed."""
    from mucon_tpu_torch import cuda

    p = cuda.bilstm_fwd_launch(B, H)
    waves = -(-p["clusters"] // p["active"])
    return (f"clusters of {p['cl']} CTAs x {p['threads']} threads, 8 videos a cluster: "
            f"{p['clusters']} clusters, the card holds {p['active']} at once: "
            f"{waves} wave{'s' if waves > 1 else ''}")


# -- phase 3: each kernel against its plain twin at full width ---------------

def skipped_tiles(T: int, lengths, pooling_layers, n_layers: int, tm: int) -> tuple:
    """(tiles at or past their video's length, tiles) over a stack's grids:
    its layers and the out-projection, tm rows a tile."""
    import torch

    tiles = skipped = 0
    t, lens = T, lengths.cpu()
    for i in range(n_layers + 1):
        n = -(-t // tm)
        tiles += len(lens) * n
        skipped += int((n - torch.minimum(-(-lens // tm), torch.tensor(n))).sum())
        if i in pooling_layers:
            t, lens = t // 2, lens // 2
    return skipped, tiles


def check_edges(name, stack, plain, x, lengths, rest, kw):
    """A stack kernel with a video of length 0 among the others, and with no
    padding at all: against its plain twin, a padded row exactly 0, timed."""
    import torch
    from mucon_tpu_torch.models.layers import mask_time

    T = x.shape[1]
    for tag, lens in (("one length 0", torch.cat([lengths[:1] * 0, lengths[1:]])),
                      ("all lengths = T", torch.full_like(lengths, T))):
        edge = (mask_time(x, lens), lens, *rest)
        zk, tk = stack(*edge, **kw)
        zp, tp = plain(*edge, **kw)
        e, bd = (zk - zp).abs().max().item(), 1e-4 * zp.abs().max().item()
        ok = torch.equal(tk, tp) and e <= bd and (int(lens[0]) or not zk[0].any().item())
        expect(ok, f"{name}, {tag}: max abs err {e} > {bd}, or a padded row not 0")
        edge_ms = cuda_ms(lambda: stack(*edge, **kw), reps=5)
        say(f"kernel {name}, {tag}: max abs err {e:.3e} <= {bd:.3e}; {edge_ms:.3f} ms")


def check_wavenet(model, gen, dev):
    """The WaveNet eval stack (tensor cores, 3xTF32) against its plain twin
    at full width, also with a video of length 0 and with no padding."""
    import torch
    from mucon_tpu_torch import cuda
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
    tm = cuda.wavenet_tile_rows()
    skipped, tiles = skipped_tiles(T, lengths, ft.pooling_layers, len(ft.stages), tm)
    say(f"kernel wavenet_layer: {skipped} of {tiles} tiles of {tm} rows lie past their "
        f"video's length and are skipped ({100 * skipped / tiles:.1f}%)")
    check_edges("wavenet_layer", wavenet_stack, wavenet_stack_plain, x, lengths, args[2:], kw)
    rows, rows_fin = stack_rows(ft.stages, ft.pooling_layers, lengths)
    # 12 launches: per valid row a k=3 conv (its existing taps) and a 1x1
    # conv, then the out-projection: the trainable stack's forward products
    return report(err, ms, plain_ms, 4 * C * (rows[0] + rows_fin) + nbytes(*args[1:]),
                  stack_ops(C, ft.stages, ft.pooling_layers, lengths)[0], tf32x3=True)


def check_mstcnpp(model, gen, dev):
    """Kernel M: the MS-TCN++ stage after its in-projection, against its
    plain twin at full width."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.mstcnpp_stack import (
        mstcnpp_stack, mstcnpp_stack_plain, pack_mstcnpp_params,
    )

    ft = model.net.ft
    B, T, C, L = 128, 2560, ft.Conv1x1_0.kernel.shape[1], ft.num_layers
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    x = (torch.randn(B, T, C, generator=gen) * 0.6).to(dev)  # no ReLU after the in-projection
    args = (mask_time(x, lengths), lengths, *pack_mstcnpp_params(ft))
    kw = dict(pooling_layers=ft.pooling_layers)
    zk, tk = mstcnpp_stack(*args, **kw)
    zp, tp = mstcnpp_stack_plain(*args, **kw)
    err = (zk - zp).abs().max().item()
    bound = 1e-4 * zp.abs().max().item()
    if not torch.equal(tk, tp) or not err <= bound:
        raise AssertionError(f"mstcnpp_stack: max abs err {err} > {bound}")
    ms, plain_ms = paired_ms(lambda: mstcnpp_stack(*args, **kw),
                             lambda: mstcnpp_stack_plain(*args, **kw), reps=5)
    say(f"kernel mstcnpp_stack B={B} T={T} C={C} L={L}: max abs err {err:.3e} <= "
        f"{bound:.3e} (1e-4 * max|plain|); {ms:.3f} ms vs plain {plain_ms:.3f} ms")
    tm = cuda.mstcnpp_tile_rows()
    skipped, tiles = skipped_tiles(T, lengths, ft.pooling_layers, L, tm)
    say(f"kernel mstcnpp_stack: {skipped} of {tiles} tiles of {tm} rows lie past their "
        f"video's length and are skipped ({100 * skipped / tiles:.1f}%)")
    check_edges("mstcnpp_stack", mstcnpp_stack, mstcnpp_stack_plain, x, lengths, args[2:], kw)
    rows, rows_fin = stack_rows(range(L), ft.pooling_layers, lengths)
    # 12 launches: per valid row two k=3 convs and a 2C -> C 1x1, then the out-projection
    return report(err, ms, plain_ms, 4 * C * (rows[0] + rows_fin) + nbytes(*args[1:]),
                  16 * C * C * sum(rows) + 2 * C * C * rows_fin, tf32x3=True)


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
    expect(all(torch.equal(a, b) for a, b in zip(outk, bilstm_recurrence(xp, m, w_hh))),
           "bilstm_recurrence: two calls of the same inputs differ")
    ms, plain_ms = paired_ms(lambda: bilstm_recurrence(xp, m, w_hh),
                             lambda: bilstm_recurrence_plain(xp, m, w_hh), reps=5)
    lib_ms = lstm_library_ms(torch.randn(B, T, H, generator=gen).to(dev), tz, H, False)
    say(f"kernel bilstm_recurrence Tz={T} B={B} H={H}: max abs err {err:.3e} "
        f"<= 1e-5, two calls bit for bit; {ms:.3f} ms = {1000 * ms / T:.2f} us/step vs plain "
        f"{plain_ms:.3f} ms; cuDNN nn.LSTM (with the input projection) {lib_ms:.3f} ms; "
        f"{bilstm_launch(B, H)}")
    nv = int(m.sum())  # valid steps of one direction
    return report(err, ms, plain_ms, 4 * 2 * nv * 4 * H + nbytes(m, w_hh, *outk),
                  2 * 2 * nv * H * 4 * H, lib_ms)


def viterbi_tables(gen, nf, T_pad: int, dev):
    """DP tables of random log-probs at Tz = T_pad / 16 for videos of nf
    frames with random transcripts of 1-30 actions: (W, pois, k_valid,
    n_valid)."""
    import torch
    import torch.nn.functional as F
    from mucon_tpu_torch.models.layers import nearest_upsample_indices
    from mucon_tpu_torch.ops.viterbi import viterbi_precompute_z

    B, Tz = len(nf), T_pad // 16
    seg_lp_z = F.log_softmax(torch.randn(B, Tz, M, generator=gen) * 2.0, dim=-1)
    n_valid = torch.randint(1, N_MAX + 1, (B,), generator=gen)
    trs = torch.randint(0, M, (B, N_MAX), generator=gen)
    trs = torch.where(torch.arange(N_MAX)[None, :] < n_valid[:, None], trs, 0)
    lam = 20.0 + 180.0 * torch.rand(B, M, generator=gen)
    nf, seg_lp_z, n_valid, trs, lam = (t.to(dev) for t in (nf, seg_lp_z, n_valid, trs, lam))
    up_idx = nearest_upsample_indices(nf // 16, T_pad, nf)
    W, pois, kv = viterbi_precompute_z(
        seg_lp_z, up_idx, nf, trs, lam,
        frame_sampling=FRAME_SAMPLING, max_len=MAX_LEN, l_max=MAX_LEN // FRAME_SAMPLING,
    )
    return W, pois, kv, n_valid


def viterbi_plain_pair(W, pois, k_valid, n_valid, S: int, max_len: int):
    """The kernel's plain twin: `dense_viterbi_plain`, then `traceback_positions`."""
    from mucon_tpu_torch.ops.viterbi import dense_viterbi_plain, traceback_positions

    score, best_l, bps = dense_viterbi_plain(W, pois, k_valid, n_valid, S, max_len)
    return score, best_l, bps, traceback_positions(bps, k_valid, n_valid, best_l)


def check_decode(tag: str, args, reps: int = 5) -> tuple:
    """`dense_viterbi_decode` against the plain pair: score, best_l, bps and
    pos equal, and a second call equal to the first; timed beside the pair.
    Returns (outputs, ms, plain ms)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi_decode

    got = dense_viterbi_decode(*args)
    again = dense_viterbi_decode(*args)
    want = viterbi_plain_pair(*args)
    names = ("score", "best_l", "bps", "pos")
    differ = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
    expect(not differ, f"dense_viterbi {tag}: {differ} differ from the plain DP + walk")
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"dense_viterbi {tag}: two calls of the same inputs differ")
    ms, plain_ms = paired_ms(lambda: dense_viterbi_decode(*args),
                             lambda: viterbi_plain_pair(*args), reps=reps)
    W, pois = args[0], args[1]
    B, K, N = W.shape
    plan = cuda.viterbi_plan(B, N, pois.shape[2], K)
    say(f"kernel dense_viterbi {tag} B={B} K={K} N={N} L={pois.shape[2]}: score, best_l, bps "
        f"and pos equal to the plain DP + walk, two calls bit for bit; {ms:.4f} ms = "
        f"{1000 * ms / max(K - 1, 1):.3f} us/window vs plain DP + walk {plain_ms:.3f} ms; "
        f"{plan['body']} body ({plan['warps']} warp(s) a CTA, {plan['ctas']} CTAs, "
        f"{plan['lc'] or 'no'} cells a lane, {plan['smem']} B shared, walk table in "
        f"{plan['table']} memory)")
    return got, ms, plain_ms


# DP shapes off the serving path, (K, N, L, S, max_len): K = 1; N = 1;
# k_valid < K with more positions than windows (infeasible videos); cells
# l > 8 that may not grow (max_len 300: the warp body's gated shift); the
# block body (N > 32, and L > 72 at frame sampling 15); a walk table too
# large for shared memory
VITERBI_EDGES = ((1, 4, 66, 30, MAX_LEN), (2, 1, 66, 30, MAX_LEN), (40, 9, 66, 30, MAX_LEN),
                 (40, 9, 66, 30, 300), (85, 40, 66, 30, MAX_LEN), (85, 30, 133, 15, MAX_LEN),
                 (4000, 30, 66, 30, MAX_LEN))


def viterbi_edge_args(K: int, N: int, L: int, S: int, max_len: int, gen, dev):
    """Six videos' tables as `tests/test_torch_cuda.py` builds them: W from
    3 labels (exact ties), k_valid in 0..K, video 0 with N positions."""
    import torch
    from mucon_tpu_torch.ops.viterbi import NEG

    B = 6
    labels = torch.randint(0, 3, (B, N), generator=gen)
    per_label = -torch.rand(K, 3, generator=gen) * 60.0
    W = per_label[:, labels].permute(1, 0, 2).contiguous()
    pois = -torch.rand(B, N, L, generator=gen) * 20.0
    pois[:, :, -1] = NEG
    k_valid = torch.randint(0, K + 1, (B,), generator=gen)
    n_valid = torch.randint(1, N + 1, (B,), generator=gen)
    n_valid[0] = N
    return [t.to(dev) for t in (W, pois, k_valid, n_valid)] + [S, max_len]


def check_viterbi(gen, dev):
    """The DP and walk kernel against the plain DP + walk, bit for bit: at
    B=128 (the report's line), at request B's three videos and at
    VITERBI_EDGES."""
    import torch

    B, T_pad = 128, 2560
    args = (*viterbi_tables(gen, torch.randint(1500, 2101, (B,), generator=gen), T_pad, dev),
            FRAME_SAMPLING, MAX_LEN)
    (sk, lk, bk, pk), ms, plain_ms = check_decode("request A's shape", args)
    check_decode("request B's shape",
                 (*viterbi_tables(gen, torch.tensor([517, 1203, 2100]), T_pad, dev),
                  FRAME_SAMPLING, MAX_LEN))
    for K, N, L, S, max_len in VITERBI_EDGES:
        check_decode(f"edge S={S} max_len={max_len}",
                     viterbi_edge_args(K, N, L, S, max_len, gen, dev), reps=2)
    W, pois, kv, n_valid = args[:4]
    L = pois.shape[2]
    cells = int((kv.cpu() * n_valid.cpu()).sum())  # valid (window, position) pairs
    moved = 4 * cells + 4 * int(n_valid.sum()) * L + nbytes(sk, lk, bk, pk)
    return report(0.0, ms, plain_ms, moved, 2 * cells * L)


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


def path_tie_bound(best: float) -> float:
    """How far below the best score another Viterbi path may score and
    still count as a near tie: TIE * |best|, and nothing when the DP found
    no feasible path."""
    from mucon_tpu_torch.ops.viterbi import NEG

    return TIE * abs(best) if best > NEG / 2 else 0.0


def normaliser_step_margin(lam) -> float:
    """Relative distance of the Poisson means to the steps of the
    reference's normaliser (`ops/viterbi.py _poisson_rows`: floor(lam)
    steps at integers, round(lam) at halves), where one ulp of lam moves
    the whole row of the Viterbi length table."""
    lam = np.asarray(lam, np.float64)
    d = np.minimum(np.abs(lam - np.round(lam)), np.abs(lam - np.floor(lam) - 0.5))
    return float((d / lam).min())


def compare_request(tag, model, arrays, outk, outp, predk, predp, teacher_forcing=False):
    """Kernel vs plain on one request: integer outputs equal, vit_score
    within rel 1e-4; a mismatch passes only at a plain-path near tie (top-two
    margin <= TIE for an argmax, a Viterbi path whose plain-table score is
    within TIE * |score| of the best, or a score whose Poisson means lie
    within TIE (relative) of a step of the normaliser).  With
    `teacher_forcing` the outputs are the alignment eval's.  Returns the
    list of mismatches."""
    from mucon_tpu_torch.ops.eval_fused import eval_tables

    cache = {}

    def plain_tables():
        if not cache:
            fwd = model.forward(arrays, use_kernels=False, teacher_forcing=teacher_forcing)
            gt = ((arrays["transcript"], arrays["transcript_len"]) if teacher_forcing
                  else (None, None))
            cache["fwd"] = fwd
            cache["tb"] = eval_tables(
                fwd, arrays["num_frames"], arrays["feats"].shape[1],
                arrays["transcript"].shape[1], FRAME_SAMPLING, MAX_LEN, *gt,
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
            if not teacher_forcing:
                continue  # the transcript and everything after it follow
        for key in ("n_steps", "n_dec", "transcripts", "vit_k_valid"):
            if not np.array_equal(outk[key][b], outp[key][b]):
                raise AssertionError(f"{tag} video {b}: {key} differs with equal tokens")
        if predk[b]["transcript"] != predp[b]["transcript"]:
            raise AssertionError(f"{tag} video {b}: predicted transcript differs")
        sk, sp = float(outk["vit_score"][b]), float(outp["vit_score"][b])
        if not abs(sk - sp) <= 1e-4 * abs(sp):
            tb = plain_tables()[1]
            lam = tb.lam[b, tb.trs[b, :int(outp["n_dec"][b])]].cpu()
            allow(f"vit_score ({sk} vs {sp}) at a Poisson normaliser step", b,
                  normaliser_step_margin(lam), TIE)
            continue
        if not np.array_equal(outk["vit_pos"][b], outp["vit_pos"][b]):
            tb = plain_tables()[1]
            kv = int(outp["vit_k_valid"][b])
            alt = path_score(tb.W[b].cpu().numpy(), tb.pois[b].cpu().numpy(),
                             outk["vit_pos"][b], kv, int(outp["n_dec"][b]))
            allow("Viterbi path", b, sp - alt, path_tie_bound(sp))
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


def viterbi_span(model, arrays, card: str) -> str:
    """CUDA-event ms of the fused eval's Viterbi span on one request's
    tables: the kernel (DP and walk in one launch) and the plain DP + walk."""
    from mucon_tpu_torch.ops.eval_fused import eval_tables
    from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi_decode

    fwd = model.forward(arrays, use_kernels=True)
    tb = eval_tables(fwd, arrays["num_frames"], arrays["feats"].shape[1],
                     arrays["transcript"].shape[1], FRAME_SAMPLING, MAX_LEN)
    args = (tb.W, tb.pois, tb.k_valid, tb.n_dec, FRAME_SAMPLING, MAX_LEN)
    ms, plain_ms = paired_ms(lambda: dense_viterbi_decode(*args),
                             lambda: viterbi_plain_pair(*args), reps=3)
    return f"kernel {ms:.4f} ms, plain DP + walk {plain_ms:.3f} ms [{card}]"


def serve(tag, model, dev, rng, card: str, required, absent=()):
    """Requests A and B through `predict_videos` and the fused eval, with
    the kernels and plain: the kernels in `required` must launch on the
    kernel path, those in `absent` must not.  Returns the launch counts."""
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
    from mucon_tpu_torch.models.model import batch_to_tensors
    from mucon_tpu_torch.ops import eval_fused
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
    say(f"launches on the {tag} serving path: {launches}")
    missing = [name for name in required if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {tag} serving path: {missing}")
    stray = [name for name in absent if launches[name]]
    if stray:
        raise AssertionError(f"kernels of another backbone launched on the {tag} serving "
                             f"path: {stray}")
    pred_p = {k: predict(k, False) for k in requests}

    run_k = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=True)
    run_p = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=False)
    for k in requests:
        arrays = batch_to_tensors(collate_videos(feats[k], names[k], db), dev)
        with mock.patch.object(eval_fused, "traceback_positions",
                               wraps=eval_fused.traceback_positions) as walk:
            before = cuda.launch_counts["dense_viterbi"]
            outk = run_k(arrays)
            dp = cuda.launch_counts["dense_viterbi"] - before
        expect(dp == 1 and walk.call_count == 0,
               f"{tag} request {k}: the kernel path's fused eval launched dense_viterbi "
               f"{dp} times and ran the Python pointer walk {walk.call_count} times "
               f"(want 1, 0)")
        outp = run_p(arrays)
        check_outputs(k, outk, pred_k[k], requests[k])
        check_outputs(k, outp, pred_p[k], requests[k])
        mism = compare_request(f"{tag} {k}", model, arrays, outk, outp, pred_k[k], pred_p[k])
        for line in mism:
            say(f"near-tie mismatch (allowed): {line}")
        B = len(requests[k])
        no_eos = int((outk["n_steps"] == N_MAX + 1).sum())
        say(f"{tag} request {k}: B={B} T_pad={arrays['feats'].shape[1]} kernel == plain "
            f"({len(mism)} near-tie mismatches); {no_eos}/{B} videos decoded all "
            f"{N_MAX + 1} steps without EOS")
        if k == "A":  # the backbone's spans on the kernel path
            import torch

            feats_a, frames_a = arrays["feats"], arrays["num_frames"]
            with torch.no_grad():
                proj_ms = cuda_ms(lambda: model.net.ft.in_projection(feats_a, frames_a), reps=3)
                enc_ms = cuda_ms(lambda: model._encode_kernels(feats_a, frames_a), reps=3)
            say(f"{tag} request A spans: in-projection {proj_ms:.3f} ms, in-projection + "
                f"stack kernel {enc_ms:.3f} ms: the stack {enc_ms - proj_ms:.3f} ms [{card}]")
        say(f"{tag} request {k} Viterbi DP + walk: " + viterbi_span(model, arrays, card))
        ms, plain_ms = paired_ms(lambda: run_k(arrays), lambda: run_p(arrays), reps=3)
        say(f"{tag} request {k} fused eval (device-resident features): kernels {ms:.2f} "
            f"ms/batch = {1000 * B / ms:.1f} videos/s; plain {plain_ms:.2f} ms/batch "
            f"= {1000 * B / plain_ms:.1f} videos/s [{card}]")
        pk, pp = paired_ms(lambda: predict(k, True), lambda: predict(k, False), reps=1)
        say(f"{tag} request {k} predict_videos (host features in, labels out): kernels "
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
    say(f"kernels wavenet_train_fwd / wavenet_train_sweep grid at B={B}: "
        + train_grid(B, T, lengths, ft.stages, ft.pooling_layers))
    rows, rows_fin = stack_rows(ft.stages, ft.pooling_layers, lengths)
    pooled = sum(r for i, r in enumerate(rows) if i in ft.pooling_layers)
    # forward: x, each layer's mask and output (the next layer's input, the
    # last one x_fin), h and, where it pools, u, then z: valid rows only
    fwd_moved = 4 * C * (3 * sum(rows) + 2 * rows_fin + pooled)
    # sweep: gz, x_fin, each layer's input, h, mask and, where it pools, u in; gx out
    bwd_moved = 4 * C * (2 * rows_fin + 3 * sum(rows) + pooled + rows[0])
    fwd_ops, bwd_ops = stack_ops(C, ft.stages, ft.pooling_layers, lengths)
    return {"wavenet_train_fwd": report(fwd_err, *fwd_ms, fwd_moved + nbytes(*weights), fwd_ops,
                                        tf32x3=True),
            "wavenet_train_sweep": report(bwd_err, *bwd_ms, bwd_moved + 2 * nbytes(*weights),
                                          bwd_ops, tf32x3=True)}


def stack_ops(C: int, stages, pooling_layers, lengths) -> tuple:
    """f32 operations of the WaveNet stack's forward (the eval stack's too)
    and of the trainable stack's sweep on this batch's valid rows, counting
    only the taps whose shifted row exists (a row t < d has no x[t-d], a
    row t >= len - d no x[t+d]; the kernels skip such products where a
    whole tile or span lacks them).  A layer's
    forward is a tap product per existing tap and the 1x1 (2 C^2 each per
    row); its sweep the dz product, the dx tap products, dW1 and the dW3
    tap products; the out-projection's forward one product a row, its
    sweep two."""
    lens = lengths.to("cpu").long()
    fwd = bwd = 0
    for i, d in enumerate(stages):
        n = int(lens.sum())
        m = int((lens - d).clamp_min(0).sum())  # rows with x[t-d]; as many with x[t+d]
        fwd += 2 * C * C * (2 * n + 2 * m)
        bwd += 2 * C * C * (4 * n + 4 * m)
        if i in pooling_layers:
            lens = lens >> 1
    n = int(lens.sum())
    return fwd + 2 * C * C * n, bwd + 4 * C * C * n


def train_grid(B: int, T: int, lengths, stages, pooling_layers) -> str:
    """The trainable stack's grid at each layer (`cuda.wavenet_train_plan`):
    the forward's and the sweep's row tiles, their CTAs and how many lie
    past their video's length, and the weight-gradient spans; with the
    shares of tiles (both grids) and of rows skipped."""
    from mucon_tpu_torch import cuda

    lens = lengths.to("cpu").long()
    parts, tiles, skipped, rows, valid = [], 0, 0, 0, 0
    t = T
    for i in range(len(stages) + 1):
        jobs = 1 if i == len(stages) else 4
        p = cuda.wavenet_train_plan(B, t, jobs)
        span, grids = p["span_rows"], []
        # the out-projection's forward is a `wavenet_layer` launch
        for tm in (p["tile_rows"],) if jobs == 1 else (p["fwd_tile_rows"], p["tile_rows"]):
            n = B * -(-t // tm)
            live = int((-(-lens // tm)).clamp(max=-(-t // tm)).sum())
            grids.append(f"{tm}-row tiles {live}/{n} CTAs")
            tiles, skipped = tiles + n, skipped + n - live
        spans = jobs * int((-(-lens // span)).sum())
        grid = f"sweep {grids[0]}" if jobs == 1 else f"forward {grids[0]}, sweep {grids[1]}"
        parts.append(f"{'proj' if jobs == 1 else i} T={t}: {grid}, spans of {span} rows "
                     f"{spans} CTAs")
        rows, valid = rows + B * t, valid + int(lens.sum())
        if i in pooling_layers:
            t, lens = t // 2, lens >> 1
    return ("; ".join(parts) + f". Row tiles skipped {skipped} of {tiles} "
            f"({100 * skipped / tiles:.1f}%); rows skipped {rows - valid} of {rows} "
            f"({100 * (rows - valid) / rows:.1f}%)")


def v2_grid(B: int, T: int, stages, pooling_layers) -> str:
    """The v2 kernels' cooperative grids (`cuda.wavenet_train_v2_grid`) and
    the tiles each layer takes (`cuda.wavenet_train_v2_plan`), as a line."""
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

    grid = cuda.wavenet_train_v2_grid()
    L, parts, t = len(stages), [], T
    for i in range(L + 1):
        p = cuda.wavenet_train_v2_plan(B, t, 1 if i == L else 4)
        sweep = (f"{p['sweep_tile_rows']} rows on {p['sweep_chunk_rows']}-row chunks, spans "
                 f"of {p['span_rows']}")
        if i == L:
            parts.append(f"proj T={t}: forward {grid['fwd_max_tile_rows']} rows, sweep {sweep}")
            break
        recompute = (f", u recomputed on {p['fwd_chunk_rows']}-row chunks"
                     if i in pooling_layers else "")
        parts.append(f"{i} T={t}: forward {p['fwd_tile_rows']} rows on {p['fwd_chunk_rows']}-row "
                     f"chunks, sweep {sweep}{recompute}")
        t //= 2 if i in pooling_layers else 1
    syncs = [(hi - lo - 1 + (hi == L), 2 * (hi - lo) + (hi == L)) for lo, hi in chunk_bounds(L, 3)]
    return (f"forward {grid['fwd_ctas_per_sm']} CTA(s) an SM ({grid['fwd_smem_bytes'] / 1024:.1f} "
            f"KiB), sweep {grid['sweep_ctas_per_sm']} ({grid['sweep_smem_bytes'] / 1024:.1f} KiB) "
            f"x {grid['sms']} SMs; grid.sync() a chunk (forward, sweep) {syncs}; "
            + "; ".join(parts))


def check_v2_u(tag, ft, x, lengths, gen, dev) -> None:
    """The v2 sweep's recomputed pre-pool output u against the u its forward
    pooled and against v3's stashed u, bit for bit, on every pooled layer's
    rows t < length: the copies the wrappers write when asked."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

    B, T, C = x.shape
    L = len(ft.stages)
    kw = dict(stages=ft.stages, pooling_layers=ft.pooling_layers, leaky=ft.leaky)
    t_ins, _, shifts, t_fin = stack_plan(ft.stages, ft.pooling_layers, T)
    mgen = torch.Generator(device=dev).manual_seed(5)
    masks = [dropout_mask(mgen, DROP, (B, t, C), dev) for t in t_ins]
    weights = [w.detach().clone() for w in pack_wavenet_params(ft)]
    w3, b3, w1, b1, wl, bl = weights
    g = torch.randn(B, t_fin, C, generator=gen).to(dev)
    xm = mask_time(x, lengths)
    u_fwd, u_sweep = {}, {}
    with torch.no_grad():
        _, stash = cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, u_out=u_fwd,
                                                 bounds=chunk_bounds(L, 3), **kw)
        cuda.wavenet_train_v2_backward(g, stash, lengths, w3, w1, b1, wl, masks, u_out=u_sweep,
                                       bounds=chunk_bounds(L, 3), **kw)
        _, (_, _, u3, _) = cuda.wavenet_train_forward(xm, lengths, *weights, masks,
                                                      pooling_type="max", **kw)
    torch.cuda.synchronize()
    expect(sorted(u_fwd) == sorted(u_sweep) == sorted(ft.pooling_layers),
           f"v2 u copies of layers {sorted(u_fwd)}, {sorted(u_sweep)}")
    rows = pairs = 0
    for i in sorted(u_fwd):
        lens = lengths >> shifts[i]
        valid = torch.arange(t_ins[i], device=dev)[None, :] < lens[:, None]
        a, b = u_fwd[i][valid], u_sweep[i][valid]
        expect(torch.equal(a, b), f"v2 {tag}: layer {i}'s recomputed u differs from the pooled "
               f"u ({(a != b).sum().item()} entries)")
        expect(torch.equal(a, u3[i][valid]), f"v2 {tag}: layer {i}'s u differs from v3's")
        rows += int(valid.sum())
        pairs += int((lens >> 1).sum())
    say(f"kernel wavenet_train_v2_sweep, {tag} (lengths {lengths.tolist()[:8]}): the recomputed "
        f"u of layers {sorted(u_fwd)} equals the u the forward pooled bit for bit ({rows} rows, "
        f"{pairs} pairs x {C} channels), and v3's stashed u")


def check_wavenet_train_v2(model, arrays, gen, dev):
    """Kernels V-fwd and V-sweep: the v2 stack (max pooling) at the train
    batch, with dropout DROP and with none.  Its path is one differentiable
    call, forward and backward, with the counts reset just before; then its
    forward and every gradient are held against the plain twin and against
    the v3 kernels (bit for bit: v2 runs v3's bodies on v3's weight
    chunks), and a second call must repeat the first bit for bit.  The
    recomputed u must equal the u the forward pooled, at the train batch
    and at request B's lengths.
    Returns (report lines, launches of the dropout run)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import (
        chunk_bounds, wavenet_stack_train_v2,
    )

    ft = model.net.ft
    lengths = arrays["num_frames"]
    with torch.no_grad():
        x = ft.in_projection(arrays["feats"], lengths)
    B, T, C = x.shape
    L = len(ft.stages)
    kw = dict(stages=ft.stages, pooling_layers=ft.pooling_layers, leaky=ft.leaky)
    t_ins, _, _, t_fin = stack_plan(ft.stages, ft.pooling_layers, T)
    g = torch.randn(B, t_fin, C, generator=gen).to(dev)
    weights = [w.detach().clone() for w in pack_wavenet_params(ft)]
    names = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")
    say(f"kernels wavenet_train_v2_fwd / wavenet_train_v2_sweep grid at B={B}: "
        f"{v2_grid(B, T, ft.stages, ft.pooling_layers)}")
    mgen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for drop in (DROP, 0.0):
        masks = None if drop == 0.0 else [dropout_mask(mgen, drop, (B, t, C), dev)
                                          for t in t_ins]

        def fwd_bwd(fn, **extra):
            xs = [t.clone().requires_grad_() for t in (x, *weights)]
            z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw, **extra)
            z.backward(g)
            return z.detach(), [t.grad for t in xs]

        cuda.reset_launch_counts()
        zk, gk = fwd_bwd(wavenet_stack_train_v2)
        torch.cuda.synchronize()
        counts = (cuda.launch_counts["wavenet_train_v2_fwd"],
                  cuda.launch_counts["wavenet_train_v2_sweep"])
        want = (3, 3) if masks is not None else (1, 3)
        expect(counts == want, f"v2 launches (forward, sweep) {counts}, expected {want}")
        say(f"v2 path, dropout {drop}: {counts[0]} forward and {counts[1]} sweep launches "
            f"(chunks {chunk_bounds(L, 3)})")
        if masks is not None:
            launches = {"wavenet_train_v2_fwd": counts[0], "wavenet_train_v2_sweep": counts[1]}
        zk2, gk2 = fwd_bwd(wavenet_stack_train_v2)
        expect(torch.equal(zk, zk2) and all(torch.equal(a, b) for a, b in zip(gk, gk2)),
               f"v2, dropout {drop}: two runs of the same inputs differ")
        for ref, (zr, gr) in (("plain", fwd_bwd(wavenet_stack_train_plain,
                                                pooling_type="max")),
                              ("v3", fwd_bwd(wavenet_stack_train, pooling_type="max"))):
            tag = f"against {ref}, dropout {drop}"
            out[f"fwd {tag}"] = held(f"wavenet_train_v2_fwd {tag}", [("z", zk, zr)],
                                     grads=False)
            out[f"bwd {tag}"] = held(f"wavenet_train_v2_sweep {tag}", list(zip(names, gk, gr)),
                                     grads=True)
        # zr, gr: v3's
        differ = [n for n, a, b in zip(("z", *names), (zk, *gk), (zr, *gr))
                  if not torch.equal(a, b)]
        expect(not differ, f"v2, dropout {drop}: {differ} differ from v3's")
        say(f"kernels wavenet_train_v2_fwd and wavenet_train_v2_sweep, dropout {drop}: two "
            f"runs agree bit for bit, and z and all seven gradients equal v3's bit for bit")

    check_v2_u("train batch", ft, x, lengths, gen, dev)
    lengths_b = torch.tensor([517, 1203, 2100], device=dev)
    feats_b = torch.randn(3, T, arrays["feats"].shape[2], generator=gen).to(dev)
    with torch.no_grad():
        x_b = ft.in_projection(feats_b, lengths_b)
    check_v2_u("request B", ft, x_b, lengths_b, gen, dev)

    masks = [dropout_mask(mgen, DROP, (B, t, C), dev) for t in t_ins]
    w3, b3, w1, b1, wl, bl = weights
    xm = mask_time(x, lengths)
    v2_kw = dict(kw, bounds=chunk_bounds(L, 3))
    v3_kw = dict(kw, pooling_type="max")
    _, stash = cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2_kw)
    _, stash3 = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3_kw)
    xs = [t.clone().requires_grad_() for t in (x, *weights)]
    z_graph, _ = wavenet_stack_train_plain(xs[0], lengths, *xs[1:], drop_masks=masks,
                                           **v3_kw)
    with torch.no_grad():
        fwd_ms = paired_ms(
            lambda: cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2_kw),
            lambda: wavenet_stack_train_plain(x, lengths, *weights, drop_masks=masks, **v3_kw),
            reps=5)
        fwd_v3 = paired_ms(
            lambda: cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2_kw),
            lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3_kw), reps=5)
    bwd_ms = paired_ms(
        lambda: cuda.wavenet_train_v2_backward(g, stash, lengths, w3, w1, b1, wl, masks,
                                               **v2_kw),
        lambda: torch.autograd.grad(z_graph, xs, g, retain_graph=True), reps=5)
    bwd_v3 = paired_ms(
        lambda: cuda.wavenet_train_v2_backward(g, stash, lengths, w3, w1, b1, wl, masks,
                                               **v2_kw),
        lambda: cuda.wavenet_train_backward(g, stash3, lengths, w3, w1, wl, masks, **v3_kw),
        reps=5)
    say(f"kernel wavenet_train_v2_fwd B={B} T={T} C={C} L={L} dropout {DROP} (3 chunks): "
        f"{fwd_ms[0]:.3f} ms vs plain {fwd_ms[1]:.3f} ms; against v3 in turns {fwd_v3[0]:.3f} "
        f"vs {fwd_v3[1]:.3f} ms; wavenet_train_v2_sweep {bwd_ms[0]:.3f} ms vs plain autograd "
        f"{bwd_ms[1]:.3f} ms; against v3 in turns {bwd_v3[0]:.3f} vs {bwd_v3[1]:.3f} ms")
    rows, rows_fin = stack_rows(ft.stages, ft.pooling_layers, lengths)
    # forward: x and the masks in; each layer's h and output and z out (no u stash)
    fwd_moved = 4 * C * (3 * sum(rows) + 2 * rows_fin)
    # sweep: gz, the stash (layer inputs, h, x_fin) and the masks in; gx out
    bwd_moved = 4 * C * (2 * rows_fin + 3 * sum(rows) + rows[0])
    fwd_ops, bwd_ops = stack_ops(C, ft.stages, ft.pooling_layers, lengths)
    # the sweep's u recompute: one [rows x C] x [C x C] product a pooled layer
    recompute_ops = 2 * C * C * sum(r for i, r in enumerate(rows) if i in ft.pooling_layers)
    fwd_err = max(v for k, v in out.items() if k.startswith("fwd"))
    bwd_err = max(v for k, v in out.items() if k.startswith("bwd"))
    return ({"wavenet_train_v2_fwd": report(fwd_err, *fwd_ms, fwd_moved + nbytes(*weights),
                                            fwd_ops, tf32x3=True),
             "wavenet_train_v2_sweep": report(bwd_err, *bwd_ms,
                                              bwd_moved + 2 * nbytes(*weights),
                                              bwd_ops + recompute_ops, tf32x3=True)},
            launches)


def check_bilstm_train(model, gen, dev):
    """Kernel B: the recurrence with its cell stash and the reverse chain
    (dxp, and dw_hh from it) against the plain twin under autograd; the
    chain's parallel coefficient pass against its own plain twin."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.lstm_recurrence import (
        BiLSTMRecurrenceTrain, bilstm_bwd_coefs_plain, bilstm_recurrence_plain,
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
        expect(all(torch.equal(a, b) for a, b in zip(outk, cuda.bilstm_train_forward(xp, m, w_hh))),
               "bilstm_train_fwd: two calls of the same inputs differ")
        # the coefficient pass replays the forward's gates: its cell is the stash bit for bit
        _, cell = cuda.bilstm_bwd_coefs(xp, m, w_hh, outk[0], outk[3], cell=True)
        valid = m[:, None, :, None].expand_as(cell) > 0
        expect(torch.equal(cell[valid], outk[3][valid]),
               "bilstm_train_bwd: the coefficient pass's cell differs from the stash")
    fwd_err = held("bilstm_train_fwd", list(zip(("outs", "h", "c", "cs"), outk, outp)),
                   grads=False)
    say("kernel bilstm_train_fwd: two calls bit for bit; the coefficient pass replays the "
        f"stashed cell bit for bit at all {int(valid.sum())} valid (step, unit) cells")

    def fwd_bwd(fn):
        a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
        torch.autograd.backward(fn(a, m, w)[:3], cts)
        return a.grad, w.grad

    gk = fwd_bwd(BiLSTMRecurrenceTrain.apply)
    gp = fwd_bwd(bilstm_recurrence_plain)
    bwd_err = held("bilstm_train_bwd", list(zip(("dxp", "dw_hh"), gk, gp)), grads=True)

    outs, _, _, cs = outk
    with torch.no_grad():
        coefs = cuda.bilstm_bwd_coefs(xp, m, w_hh, outs, cs)
        held("bilstm_train_bwd coefficient pass",
             list(zip(("A", "Ci", "Cf", "Cg", "Co", "F"), coefs,
                      bilstm_bwd_coefs_plain(xp, m, w_hh, outs, cs))), grads=False)
        twice = [cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, *cts) for _ in range(2)]
        expect(torch.equal(*twice), "bilstm_train_bwd: two calls of the same inputs differ")
        say("kernel bilstm_train_bwd: two calls of the same inputs agree bit for bit")
        coefs_ms = cuda_ms(lambda: cuda.bilstm_bwd_coefs(xp, m, w_hh, outs, cs), reps=10)
        chain_ms = cuda_ms(lambda: cuda.bilstm_bwd_chain(coefs, m, w_hh, *cts), reps=10)
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
    x = torch.randn(B, T, H, generator=gen).to(dev)
    lib_ms = [lstm_library_ms(x, tz, H, backward) for backward in (False, True)]
    say(f"kernel bilstm_train_fwd Tz={T} B={B} H={H}: {fwd_ms[0]:.3f} ms = "
        f"{1000 * fwd_ms[0] / T:.2f} us/step vs plain {fwd_ms[1]:.3f} ms "
        f"({bilstm_launch(B, H)}); bilstm_train_bwd (coefficient pass + chain + dw_hh einsum) "
        f"{bwd_ms[0]:.3f} ms = {1000 * bwd_ms[0] / T:.2f} us/step vs plain autograd "
        f"{bwd_ms[1]:.3f} ms; alone, the coefficient pass {coefs_ms:.3f} ms and the cluster "
        f"chain (width {cuda.load().mucon_bilstm_chain_width(H)}) {chain_ms:.3f} ms = "
        f"{1000 * chain_ms / T:.2f} us/step; "
        f"cuDNN nn.LSTM (with the input projection) forward {lib_ms[0]:.3f} ms, "
        f"backward {lib_ms[1]:.3f} ms")
    nv = int(m.sum())  # valid steps of one direction
    step_ops = 2 * nv * 2 * H * 4 * H  # one [H x 4H] product per valid step and direction
    # backward: xp, outs, cs and douts of the valid steps in; dxp and dw_hh out
    bwd_moved = 4 * 2 * nv * (4 * H + 3 * H) + nbytes(m, w_hh, *cts[1:]) + nbytes(xp, w_hh)
    return {"bilstm_train_fwd": report(fwd_err, *fwd_ms,
                                       4 * 2 * nv * 4 * H + nbytes(m, w_hh, *outk),
                                       step_ops, lib_ms[0]),
            # the gate replay, dgate w_hh^T and the dw_hh contraction
            "bilstm_train_bwd": report(bwd_err, *bwd_ms, bwd_moved, 3 * step_ops, lib_ms[1])}


def chain_inputs(model, tz, Tz: int, S: int, gen, dev):
    """Seeded inputs of the decoder chain for videos of tz valid encoder
    frames padded to Tz, with the packed weights of the model's decoder."""
    import torch
    from mucon_tpu_torch.models.layers import time_mask
    from mucon_tpu_torch.ops.decoder_chain import pack_decoder_chain_params

    dec = model.net.decoder
    H, E = dec.attention_l2.kernel.shape[0], model.net.fs_decoder_attention_W1.shape[0]
    tz = tz.to("cpu")
    B = len(tz)
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    maskf = time_mask(Tz, tz)
    xs = (torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
          r(B, H), r(B, H))
    return [t.to(dev) for t in xs] + [
        w.detach().clone().contiguous() for w in pack_decoder_chain_params(dec, E)]


def check_decoder_chain(model, tz_lengths, Tz: int, gen, dev, timed: bool):
    """Kernels C-fwd and C-bwd: the forward against `decoder_chain_plain`,
    `DecoderChain`'s every input gradient against autograd of the plain
    loop (same random cotangents), and the reverse kernel's raw outputs
    against `decoder_chain_bwd_plain`; each kernel twice, bit for bit."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.decoder_chain import (
        DecoderChain, decoder_chain_bwd_plain, decoder_chain_plain, decoder_chain_replay_plain,
    )

    S = model.max_decoding_steps
    args = chain_inputs(model, tz_lengths, Tz, S, gen, dev)
    emb, enc, pre, maskf, h0, c0 = args[:6]
    B, Tz, E = enc.shape
    H = h0.shape[1]
    tag = f"B={B} S={S} Tz={Tz} H={H} E={E}"
    with torch.no_grad():
        outk = cuda.decoder_chain_forward(*args)
        outp = decoder_chain_plain(*args)
        expect(all(torch.equal(a, b) for a, b in zip(outk, cuda.decoder_chain_forward(*args))),
               "decoder_chain_fwd: two runs of the same inputs differ")
    fwd_err = held(f"decoder_chain_fwd {tag}", list(zip(("hs", "cs", "comb"), outk, outp)),
                   grads=False)
    cts = [torch.randn(S, B, H, generator=gen).to(dev) for _ in range(3)]

    def grads(fn):
        xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]  # not maskf
        torch.autograd.backward(fn(*xs), cts)
        return [t.grad for i, t in enumerate(xs) if i != 3]

    names = ("emb", "enc", "pre", "h0", "c0", "wl2", "bl2", "v", "wc1", "wc2", "bc",
             "wih", "whh", "bl")
    held(f"DecoderChain {tag} (input gradients)",
         list(zip(names, grads(DecoderChain.apply), grads(decoder_chain_plain))), grads=True)
    h_in = torch.cat([h0[None], outk[0][:-1]])
    c_in = torch.cat([c0[None], outk[1][:-1]])
    bargs = (*args[:4], h_in, c_in, *args[6:], *cts)
    with torch.no_grad():
        rawk = cuda.decoder_chain_backward(*bargs)
        rawp = decoder_chain_bwd_plain(*bargs)
        expect(all(torch.equal(a, b) for a, b in zip(rawk, cuda.decoder_chain_backward(*bargs))),
               "decoder_chain_bwd: two runs of the same inputs differ")
        # the replay pass against its twin, and the forward's stash bit for bit
        *replay, cell = cuda.decoder_chain_replay(*bargs[:15], count=False, cell=True)
        held(f"decoder_chain_bwd replay pass {tag}",
             list(zip(("acts", "cpre", "a", "u"), replay, decoder_chain_replay_plain(*bargs[:15]))),
             grads=False)
        expect(torch.equal(torch.relu(replay[1]), outk[2]) and torch.equal(cell, outk[1]),
               "decoder_chain_bwd: the replay pass's relu(cpre) or cell differs from the stash")
    bwd_err = held(f"decoder_chain_bwd {tag}",
                   list(zip(("dgate", "dcpre", "dsc", "dh0", "dc0"), rawk, rawp)), grads=True)
    say(f"kernels decoder_chain_fwd and decoder_chain_bwd {tag}: two runs of each "
        f"agree bit for bit; the replay pass's relu(cpre) and cell equal the stashed comb "
        f"and cs bit for bit")
    launch = cuda.decoder_chain_fwd_launch(B, H, E, Tz)
    waves = -(-launch["clusters"] // launch["active"])
    say(f"kernel decoder_chain_fwd {tag}: clusters of {launch['cl']} CTAs x "
        f"{launch['threads']} threads, one a video: {launch['clusters']} clusters, the card "
        f"holds {launch['active']} at once: {waves} wave{'s' if waves > 1 else ''}; each "
        f"CTA's weights {'in shared memory' if launch['weights'] else 'from L2'}, its rows "
        f"of maskf, pre and enc {'in shared memory' if launch['tables'] else 'from L2'}")
    if not timed:
        return {}
    chain_args = (c_in, args[1], args[8], args[10], args[12], args[13], args[6], *cts)
    with torch.no_grad():
        fwd_ms = paired_ms(lambda: cuda.decoder_chain_forward(*args),
                           lambda: decoder_chain_plain(*args), reps=5)
        bwd_ms = paired_ms(lambda: cuda.decoder_chain_backward(*bargs),
                           lambda: decoder_chain_bwd_plain(*bargs), reps=3)
        replay_ms = cuda_ms(lambda: cuda.decoder_chain_replay(*bargs[:15]), reps=10)
        chain_ms = cuda_ms(lambda: cuda.decoder_chain_bwd_chain(*replay, *chain_args), reps=10)
    say(f"kernel decoder_chain_fwd {tag}: {fwd_ms[0]:.3f} ms = "
        f"{1000 * fwd_ms[0] / S:.2f} us/step on clusters of {launch['cl']} vs plain "
        f"{fwd_ms[1]:.3f} ms; "
        f"decoder_chain_bwd {bwd_ms[0]:.3f} ms = {1000 * bwd_ms[0] / S:.2f} us/step vs "
        f"plain {bwd_ms[1]:.3f} ms; alone, the replay pass {replay_ms:.3f} ms and the "
        f"cluster chain (width {cuda.decoder_chain_plan(H)[0]}, {B} clusters) {chain_ms:.3f} "
        f"ms = {1000 * chain_ms / S:.2f} us/step")
    weights = nbytes(*args[6:])
    tzs = int(tz_lengths.sum())  # valid encoder frames over the videos
    # per step and video: q, the scores over the valid frames (tanh, multiply,
    # add), the context, attn-combine, the gates and the cell
    step_ops = S * (B * (18 * H * H + 2 * (H + E) * H + 10 * H) + tzs * (3 * H + 2 * E))
    tables = 4 * tzs * (E + H) + nbytes(maskf)
    fwd_moved = tables + weights + nbytes(emb, h0, c0, *outk)
    # reverse: the replayed step, the transposed products, da, dsc and dq
    bwd_ops = step_ops + S * (B * (18 * H * H + 2 * H * E + 20 * H) + tzs * (2 * E + 4 * H + 3))
    bwd_moved = tables + weights + nbytes(emb, h_in, c_in, *cts, *rawk)
    check_chain_shapes(S, tz_lengths, Tz, gen, dev)
    return {"decoder_chain_fwd": report(fwd_err, *fwd_ms, fwd_moved, step_ops),
            "decoder_chain_bwd": report(bwd_err, *bwd_ms, bwd_moved, bwd_ops)}


# the forward chain off the model's shape, through its step's generic body:
# the model's width with one context column fewer; H = 256, whose weights
# do not fit a CTA (read from L2); an odd H (a cluster of one CTA, HS = 33
# above a pass's 32 units)
CHAIN_SHAPES = ((128, 255), (256, 512), (33, 66))


def check_chain_shapes(S: int, tz_lengths, Tz: int, gen, dev):
    """`decoder_chain_fwd` at CHAIN_SHAPES (H, E): against the plain twin
    (`held`), two calls bit for bit, and timed beside the twin."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.decoder_chain import decoder_chain_plain

    tz = tz_lengths.to("cpu")
    B = len(tz)
    maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float()
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    # matrices at a model's scale, 1 / sqrt(fan-in): 31 steps through weights
    # of 0.4 would be chaotic and amplify two orders of the same sums
    w = lambda k, *shape: torch.randn(*shape, generator=gen) / k ** 0.5  # noqa: E731
    for H, E in CHAIN_SHAPES:
        args = [t.to(dev) for t in (
            torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
            r(B, H), r(B, H), w(H, H, H), r(H), r(H), w(H + E, H, H), w(H + E, E, H), r(H),
            w(2 * H, H, 4 * H), w(2 * H, H, 4 * H), r(4 * H))]
        tag = f"B={B} S={S} Tz={Tz} H={H} E={E}"
        with torch.no_grad():
            outk = cuda.decoder_chain_forward(*args)
            expect(all(torch.equal(a, b) for a, b in
                       zip(outk, cuda.decoder_chain_forward(*args))),
                   f"decoder_chain_fwd {tag}: two runs of the same inputs differ")
            held(f"decoder_chain_fwd {tag}",
                 list(zip(("hs", "cs", "comb"), outk, decoder_chain_plain(*args))), grads=False)
            ms, plain_ms = paired_ms(lambda: cuda.decoder_chain_forward(*args),
                                     lambda: decoder_chain_plain(*args), reps=3)
        launch = cuda.decoder_chain_fwd_launch(B, H, E, Tz)
        say(f"kernel decoder_chain_fwd {tag} (generic step body): {ms:.3f} ms = "
            f"{1000 * ms / S:.2f} us/step on clusters of {launch['cl']} (HS {launch['hs']}), "
            f"weights {'in shared memory' if launch['weights'] else 'from L2'}, vs plain "
            f"{plain_ms:.3f} ms; two runs agree bit for bit")


def check_flint(arrays, gen, dev):
    """Kernel F at the train batch: values against `mucon_flint_plain` and
    `MuconFlint`'s gradients against autograd of the plain twin, with and
    without the background class weight, at overlap 0 and 0.25."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.mucon_loss import MuconFlint, flint_prep, mucon_flint_plain

    target, n_len, t_valid = arrays["transcript"], arrays["transcript_len"], arrays["num_frames"]
    B, N = target.shape
    T = arrays["feats"].shape[1]
    lengths_raw = (1.5 * torch.randn(B, N, generator=gen)).to(dev)
    seg = (2.0 * torch.randn(B, T, M, generator=gen)).to(dev)
    cw = torch.ones(M, device=dev)
    cw[0] = 0.5  # the background class weight of the default config
    g = torch.randn(B, generator=gen).to(dev)
    worst = 0.0
    for weighted in (False, True):
        for overlap in (0.0, 0.25):
            w = cw if weighted else None
            with torch.no_grad():
                prep = flint_prep(lengths_raw, n_len, t_valid, overlap)
                vk = cuda.mucon_flint(*prep, seg, target, n_len, t_valid, w)
                vp = mucon_flint_plain(lengths_raw, seg, target, n_len, t_valid, overlap, w)
            tag = f"mucon_flint weights {'on' if weighted else 'off'} overlap {overlap}"
            worst = max(worst, held(tag, [("loss", vk, vp)], grads=False))

            def grads(fn):
                xs = [t.clone().requires_grad_() for t in (lengths_raw, seg, cw)]
                fn(xs).backward(g)
                return [t.grad for t in xs[:3 if weighted else 2]]

            gk = grads(lambda xs: MuconFlint.apply(xs[0], xs[1], target, n_len, t_valid,
                                                    overlap, weighted, xs[2]))
            gp = grads(lambda xs: mucon_flint_plain(xs[0], xs[1], target, n_len, t_valid,
                                                    overlap, xs[2] if weighted else None))
            held(f"MuconFlint {tag} (gradients)",
                 list(zip(("lengths_raw", "segmentation", "class_weights"), gk, gp)),
                 grads=True)
    with torch.no_grad():
        prep = flint_prep(lengths_raw, n_len, t_valid, 0.0)
        ms = paired_ms(lambda: cuda.mucon_flint(*prep, seg, target, n_len, t_valid),
                       lambda: mucon_flint_plain(lengths_raw, seg, target, n_len, t_valid),
                       reps=10)
        again = [cuda.mucon_flint(*prep, seg, target, n_len, t_valid, cw) for _ in range(2)]
    expect(torch.equal(*again), "mucon_flint: two calls of the same inputs differ")
    plan = cuda.flint_plan(B, T)
    say(f"kernel mucon_flint B={B} T={T} N={N} M={M}: {ms[0]:.4f} ms vs plain {ms[1]:.3f} ms; "
        f"clusters of {plan['width']} CTAs a video, {plan['ctas']} CTAs, at most "
        f"{plan['frames']} frames a CTA; two calls bit for bit")
    nl, tv = n_len.cpu().long(), t_valid.cpu().long()
    cells = int((nl * tv).sum())  # (valid segment, valid frame) pairs
    # seg's valid frames and the per-segment vectors in, [B] out; per pair a
    # closed-form mask value (~10 operations) and M multiply-adds
    moved = 4 * int(tv.sum()) * M + nbytes(*prep, target, n_len, t_valid) + 4 * B
    return {"mucon_flint": report(worst, *ms, moved, cells * (10 + 2 * M))}


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

    dec = net.decoder
    hooks = [
        net.ft.Conv1x1_0.register_forward_hook(lambda m, i, o: (
            mark("in-projection"), o.register_hook(grad_mark("stack sweep")))[0]),
        net.ft_last_gn.register_forward_pre_hook(lambda m, i: (
            mark("stack forward"), i[0].register_hook(grad_mark("GN + ReLU backward")))[0]),
        net.fs_encoder_lstm.register_forward_pre_hook(lambda m, i: (
            mark("GN + ReLU + dropout"), i[0].register_hook(grad_mark("BiLSTM backward")))[0]),
        net.fs_encoder_lstm.register_forward_hook(lambda m, i, o: (
            mark("BiLSTM forward"),
            o[0].register_hook(grad_mark("attention pre-projection + encoder heads backward")))[0]),
        # the decoder: embedding -> chain -> heads; backward in reverse
        dec.embedding.register_forward_pre_hook(lambda m, i: mark("encoder heads + framewise head")),
        dec.embedding.register_forward_hook(lambda m, i, o: (o.register_hook(
            grad_mark("decoder chain backward + its weight-gradient glue")), None)[1]),
        dec.transcript_fc.register_forward_pre_hook(lambda m, i: (
            mark("embedding + decoder chain forward"),
            i[0].register_hook(grad_mark("loss + decoder heads backward")))[0]),
        dec.length_out.register_forward_hook(lambda m, i, o: mark("decoder heads")),
    ]
    totals = {}
    try:
        for rep in range(reps + 1):
            marks.clear()
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
            clip_grad_norm_partitioned(trainer.partition, trainer.cfg.trainer.clip_grad_norm_value)
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


def train(dev, rng, card: str, root: str):
    """The train kernels' checks, then three train steps of the WaveNet
    model with the kernels (twice: the second run must repeat the first bit
    for bit), and before each of them one plain step from the kernel path's
    weights at that step, with the same masks and batch (`compare_steps`);
    returns the kernel checks, the launch counts (the train path's, and the
    v2 path's for its two kernels) and the batch.

    Each plain step starts from the kernel path's weights, so that the
    comparison sees one step's rounding.  Trajectories would not: the two
    paths round differently by design, a ReLU input or a box-mask edge
    within rounding of its kink then takes the other side in one of them,
    and the length head (whose gradient cancels terms of order T/L) turns
    that into a percent of its update by step 3.  (On the card, the
    encoder kernels alone or the decoder chain alone stayed within 9.2e-4
    of the plain trajectory's update after 3 steps; both together flipped
    a ReLU of layer 6 at step 2 and moved the length head by 1.8% at
    step 3.)

    The steps run under `torch.use_deterministic_algorithms`: torch's
    default CUDA backward of its gather / index ops adds with atomics, and
    the length head's gradient is ill-conditioned (the mucon loss cancels
    terms of order T/L), so two plain runs alone differ by up to 2% of that
    head's update.  Deterministic, each path repeats bit for bit and the
    comparison sees the kernels' rounding only."""
    import torch

    arrays = train_batch(rng, dev)
    trainers = make_trainers(dev, "wavenet", root)
    results = {}
    gen = torch.Generator().manual_seed(3)
    model = trainers["k"].model
    results.update(check_wavenet_train(model, arrays, gen, dev))
    v2_results, v2_launches = check_wavenet_train_v2(model, arrays, gen, dev)
    results.update(v2_results)
    results.update(check_bilstm_train(model, gen, dev))
    T_pad = arrays["feats"].shape[1]
    results.update(check_decoder_chain(model, arrays["num_frames"] >> 4, T_pad >> 4, gen, dev,
                                       timed=True))
    # long videos: T_pad = 10240, Tz = 640
    check_decoder_chain(model, torch.tensor([640, 333]), 640, gen, dev, timed=False)
    results.update(check_flint(arrays, gen, dev))
    launches = compare_steps("WaveNet", trainers, arrays, TRAIN_STEPS, TRAIN_KERNELS,
                             ("mstcnpp_stack", "wavenet_train_v2_fwd", "wavenet_train_v2_sweep"),
                             card, stages=True)
    launches.update(v2_launches)
    return results, launches, arrays


def smoke_cfg(root: str, kernels: bool = True, sets=()):
    """The port's default config with the (dotted key, value string)
    overrides `sets`, its run folders under `root`, and every kernel on
    (and the flint loss kernel) or every kernel off."""
    from mucon_tpu_torch.config import get_cfg_defaults
    from mucon_tpu_torch.config.support import KERNEL_FLAGS

    cfg = get_cfg_defaults()
    cfg.merge_from_list([x for kv in sets for x in kv])
    cfg.trainer.root = root
    cfg.tpu.use_pallas_loss = kernels
    for key in KERNEL_FLAGS:
        cfg.tpu[key.split(".")[1]] = "auto" if kernels else False
    return cfg


def make_trainers(dev, ft_type: str, root: str, model_cls=None) -> dict:
    """Three trainers of the default model with the backbone `ft_type`
    (`model_cls`: `MuConModel` or a supervised variant), from one seed,
    their run folders under `root`: "k" and "k2" with the kernels and the
    loss kernel (tpu.use_pallas_loss), "p" plain (every tpu.use_pallas*
    False)."""
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import MuConModel, create_model

    model_cls = model_cls or MuConModel
    out = {}
    for k in ("k", "k2", "p"):
        cfg = smoke_cfg(root, kernels=k != "p",
                        sets=[("tpu.batch_size", str(TRAIN_B)), ("model.ft.type", ft_type)])
        model = create_model(M, N_MAX + 1, D, device=dev, seed=0, ft_type=ft_type,
                             loss_cfg=loss_config_from_cfg(cfg), model_cls=model_cls)
        out[k] = SimpleTrainer(cfg, f"train_{ft_type}_{model_cls.__name__}_{k}", None, model,
                               seed=1)
    return out


def compare_steps(tag, trainers, arrays, n_steps: int, required, absent, card: str,
                  stages: bool = False) -> dict:
    """`n_steps` kernel steps, twice, and before each of them one plain step
    from the kernel path's weights at that step with the same masks: the
    kernels in `required` must launch in the first kernel run, those in
    `absent` must not; the two kernel runs must agree bit for bit, and each
    plain step within 1e-4 relative of the kernel step's losses and 1e-2 of
    its update.  Times the step (and with `stages` its stages).  Returns
    the first kernel run's launch counts."""
    import torch
    from mucon_tpu_torch import cuda

    def params(k):
        return {n: p.detach().clone() for n, p in trainers[k].model.net.named_parameters()}

    losses, snaps = {k: [] for k in trainers}, {k: [params(k)] for k in trainers}

    def step(k):
        out = trainers[k].train_step(arrays)
        trainers[k].iter_num += 1
        losses[k].append({n: float(v) for n, v in out.items()})
        snaps[k].append(params(k))

    def plain_step_from(weights, at: int):
        with torch.no_grad():
            for n, p in trainers["p"].model.net.named_parameters():
                p.copy_(weights[n])
        trainers["p"].iter_num = at  # the kernel step's masks
        step("p")

    torch.use_deterministic_algorithms(True)
    try:
        cuda.reset_launch_counts()
        for _ in range(n_steps):
            step("k")
        torch.cuda.synchronize()
        launches = dict(cuda.launch_counts)
        for at in range(n_steps):
            step("k2")
            plain_step_from(snaps["k"][at], at)
    finally:
        torch.use_deterministic_algorithms(False)
    say(f"launches on the {tag} train path ({n_steps} steps): {launches}")
    missing = [name for name in required if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {tag} train path: {missing}")
    stray = [name for name in absent if launches[name]]
    if stray:
        raise AssertionError(f"kernels launched on the {tag} train path that it does not "
                             f"run: {stray}")
    expect(losses["k"] == losses["k2"] and all(
        torch.equal(a, b[n]) for s, b in zip(snaps["k"], snaps["k2"]) for n, a in s.items()),
        f"{tag}: two kernel runs of the same steps differ")
    say(f"{tag} kernel path run twice: the same losses and parameters bit for bit after "
        f"{n_steps} steps")

    for at, (lk, lp) in enumerate(zip(losses["k"], losses["p"])):
        expect(all(np.isfinite(v) for v in (*lk.values(), *lp.values())),
               f"{tag} train step {at + 1}: non-finite loss")
        rel = max(abs(lk[n] - lp[n]) / max(abs(lp[n]), 1e-12) for n in lp)
        expect(rel <= 1e-4,
               f"{tag} train step {at + 1}: loss rel diff {rel} > 1e-4 ({lk} vs {lp})")
        worst = (0.0, "")
        for n, before in snaps["k"][at].items():
            after = snaps["p"][at + 1][n]
            upd = (after - before).abs().max().item()
            err = (snaps["k"][at + 1][n] - after).abs().max().item()
            expect(err <= 1e-2 * upd + 1e-7,
                   f"{tag} train step {at + 1}: {n} differs by {err} (update {upd})")
            worst = max(worst, (err / max(upd, 1e-30), n))
        say(f"{tag} train step {at + 1}: main loss {lk['main']:.6f} (kernels) vs "
            f"{lp['main']:.6f} (plain, from the same weights), max rel diff over the {len(lp)} "
            f"terms "
            f"{rel:.2e} <= 1e-4; every parameter within 1e-2 * max|update| (worst "
            f"{worst[0]:.2e}, {worst[1]})")

    ms = paired_ms(lambda: trainers["k"].train_step(arrays),
                   lambda: trainers["p"].train_step(arrays), reps=3)
    T = arrays["feats"].shape[1]
    say(f"{tag} train step B={TRAIN_B} T_pad={T}: kernels {ms[0]:.2f} ms = "
        f"{1000 * TRAIN_B / ms[0]:.2f} videos/s; plain {ms[1]:.2f} ms = "
        f"{1000 * TRAIN_B / ms[1]:.2f} videos/s [{card}]")
    if stages:
        for k, label in (("k", "kernels"), ("p", "plain")):
            spans = stage_ms(trainers[k], arrays)
            say(f"{tag} train step stages ({label}, ms): " + json.dumps(
                {n: round(v, 3) for n, v in spans.items()}))
    return launches


# -- phase 6: the experiment entry point -------------------------------------

# the CLI phase's data: request-A lengths, 18 train and 6 test videos
CLI_SETS = [("dataset.name", "synthetic"), ("dataset.synthetic.num_videos", "24"),
            ("dataset.synthetic.num_classes", str(M)), ("dataset.synthetic.feat_dim", str(D)),
            ("dataset.synthetic.min_len", "1500"), ("dataset.synthetic.max_len", "2100"),
            ("dataset.synthetic.train_fraction", "0.75"), ("trainer.num_epochs", "2"),
            ("trainer.save_every", "1"), ("trainer.eval_every", "1"),
            ("tpu.batch_size", str(TRAIN_B))]
# launches a train step and an eval batch of the default model imply (11
# layers): the trainable stack a layer forward, a layer + the out-projection
# in its sweep, its out-projection as a `wavenet_layer`; the eval stack a
# layer + the out-projection; one launch of each other kernel
N_LAYERS = 11
PER_TRAIN_STEP = dict(wavenet_train_fwd=N_LAYERS, wavenet_train_sweep=N_LAYERS + 1,
                      wavenet_layer=1, bilstm_train_fwd=1, bilstm_train_bwd=1,
                      decoder_chain_fwd=1, decoder_chain_bwd=1, mucon_flint=1)
PER_EVAL_BATCH = dict(wavenet_layer=N_LAYERS + 1, bilstm_recurrence=1, dense_viterbi=1)


def cli_argv(sets, exp: str = "chip_cli") -> list:
    argv = ["--exp-name", exp]
    for k, v in sets:
        argv += ["--set", k, v]
    return argv


def tree_state(root):
    from pathlib import Path

    return sorted((str(p), p.stat().st_mtime_ns) for p in Path(root).rglob("*"))


def cli_phase(dev, card: str, tmp: str) -> None:
    """`python -m mucon_tpu_torch.cli.train_test_mucon` at full width: the
    default model, B=8, the flint loss kernel, 2 epochs of 18 videos with an
    eval and a checkpoint after each, then the final Viterbi eval.  Checks
    (1) the run folder contract and 24 finite fields, (2) each kernel's
    launches against the count the steps and eval batches imply, (3)
    `test_mucon` reproducing the result read-only, (4) a fresh trainer's
    `resume_latest`, and (5) the same checkpoint evaluated on the plain
    path against the kernel eval's pickle, by `compare_request`'s rules."""
    import contextlib
    import dataclasses
    import pickle
    from pathlib import Path

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli import test_mucon, train_test_mucon
    from mucon_tpu_torch.cli.common import create_model_from_cfg
    from mucon_tpu_torch.data import handel_dataset
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator, pad_rows
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.model import batch_to_tensors
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval

    runs, data = str(Path(tmp) / "runs"), str(Path(tmp) / "data")
    sets = CLI_SETS + [("dataset.root", data), ("trainer.root", runs),
                       ("tpu.use_pallas_loss", "True")]
    t0 = time.perf_counter()
    handel_dataset(smoke_cfg(runs, sets=sets), train=True)  # writes the .npy files
    write_s = time.perf_counter() - t0
    log = Path(tmp) / "cli.log"
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        result = train_test_mucon.main(cli_argv(sets))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(cuda.launch_counts)

    # (1) the run folder contract
    run = Path(runs) / "chip_cli" / "0"
    fields = dataclasses.asdict(result)
    expect(len(fields) == 24 and all(np.all(np.isfinite(v)) for v in fields.values()),
           f"cli: the result is not 24 finite fields: {fields}")
    ckpt = run / "checkpoints" / "epoch_1"
    for path in (run / "config.yaml", run / "events.jsonl", ckpt / "model.pt",
                 ckpt / "optimizer.pt", ckpt / "trainer_state.json",
                 ckpt / "data_test_eval.pkl", run / "metrics" / "eval_metric_1.pkl"):
        expect(path.exists(), f"cli: {path} missing")
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    kinds = [e["kind"] for e in events]
    for kind in ("train", "epoch", "eval_0", "train_phases", "final_eval", "run_phases"):
        expect(kind in kinds, f"cli: no {kind} event")
    state = json.loads((ckpt / "trainer_state.json").read_text())

    # (2) every kernel launched as often as the steps and eval batches imply
    steps = state["iter_num"]
    evals = kinds.count("eval_0") + kinds.count("final_eval")
    test_db = handel_dataset(smoke_cfg(runs, sets=sets), train=False)
    eval_batches = evals * -(-len(test_db) // TRAIN_B)
    want = {k: 0 for k in cuda.KERNELS}
    for k, n in PER_TRAIN_STEP.items():
        want[k] += steps * n
    for k, n in PER_EVAL_BATCH.items():
        want[k] += eval_batches * n
    expect(launches == want, f"cli: launches {launches} != {want} implied by {steps} train "
                             f"steps and {eval_batches} eval batches")
    say(f"cli: {steps} train steps and {eval_batches} eval batches launched each kernel as "
        f"often as they imply: {json.dumps({k: v for k, v in launches.items() if v})}")

    # (3) test_mucon reproduces the result from the checkpoint, read-only
    before = tree_state(runs)
    t0 = time.perf_counter()
    with open(log, "a") as f, contextlib.redirect_stdout(f):
        again = test_mucon.single_main("chip_cli/0/1", root=runs)
    reeval_s = time.perf_counter() - t0
    expect(tree_state(runs) == before, "cli: test_mucon changed files under the run root")
    diff = max(float(np.max(np.abs(np.subtract(v, fields[k]))))
               for k, v in dataclasses.asdict(again).items())
    expect(diff <= 1e-6, f"cli: test_mucon differs from the run's result by {diff}")

    # (4) a fresh trainer resumes from the newest checkpoint
    cfg = smoke_cfg(runs, sets=sets)
    train_db = handel_dataset(cfg, train=True)
    fresh = SimpleTrainer(cfg, "chip_cli", train_db, create_model_from_cfg(cfg, train_db),
                          run_number=0)
    expect(fresh.resume_latest() and fresh.epoch_num == 2 and fresh.iter_num == steps,
           f"cli: resume_latest gave epoch {fresh.epoch_num}, iteration {fresh.iter_num}")
    saved = torch.load(ckpt / "model.pt", map_location=dev, weights_only=True)
    expect(all(torch.equal(v, saved[k]) for k, v in fresh.model.net.state_dict().items()),
           "cli: the resumed parameters differ from the checkpoint's")

    # (5) the checkpoint on the plain path against the kernel eval's pickle
    plain_cfg = smoke_cfg(runs, kernels=False, sets=sets)
    model = fresh.model
    plain = MuConEvaluator(plain_cfg, test_db, model)
    plain.viterbi_mode(True)
    cuda.reset_launch_counts()
    plain.evaluate()
    torch.cuda.synchronize()
    stray = {k: n for k, n in cuda.launch_counts.items() if n}
    expect(not stray, f"cli: the plain evaluator launched kernels: {stray}")
    plain.set_name("plain_eval")
    plain.set_checkpointing_folder(Path(tmp) / "plain")
    plain.save_stuff()
    pk = pickle.load(open(ckpt / "data_test_eval.pkl", "rb"))
    pp = pickle.load(open(Path(tmp) / "plain" / "data_plain_eval.pkl", "rb"))
    run_k = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=True)
    run_p = build_fused_eval(model, frame_sampling=FRAME_SAMPLING, use_kernels=False)

    def preds(d, lo, hi):
        return [dict(y_labels=d["y_segs"][i], vit_labels=d["vit_segs"][i],
                     transcript=d["s_transcript"][i]) for i in range(lo, hi)]

    lo, mism = 0, []
    with torch.inference_mode():
        for batch in plain.create_dataloader():
            B = batch.batch_size
            arrays = pad_rows(batch_to_tensors(batch, dev), TRAIN_B)
            outk = {k: v[:B] for k, v in run_k(arrays).items()}
            outp = {k: v[:B] for k, v in run_p(arrays).items()}
            mism += compare_request("cli", model, arrays, outk, outp, preds(pk, lo, lo + B),
                                    preds(pp, lo, lo + B))
            lo += B
    expect(lo == len(pk["y_segs"]) == len(pp["y_segs"]), "cli: pickles do not cover the test set")
    for line in mism:
        say(f"near-tie mismatch (allowed): {line}")
    say(f"cli: the checkpoint's plain-path eval equals the kernel eval on {lo} videos "
        f"({len(mism)} near-tie mismatches)")

    # the times, beside the card's name and power limit
    epochs = [round(e["epoch_seconds"], 3) for e in events if e["kind"] == "epoch"]
    evs = [(round(e["eval_seconds"], 3), e["eval_phases"]) for e in events
           if e["kind"] in ("eval_0", "final_eval")]
    (tp,) = [e for e in events if e["kind"] == "train_phases"]
    (rp,) = [e for e in events if e["kind"] == "run_phases"]
    say(f"cli: dataset write {write_s:.3f} s; run {run_s:.3f} s: setup "
        f"{rp['setup_seconds']} s, epoch_seconds {epochs}, final save "
        f"{rp['final_save_seconds']} s, train {len(train_db)} videos x {len(epochs)} epochs in "
        f"{tp['train_seconds']} s = {len(train_db) * len(epochs) / tp['train_seconds']:.2f} "
        f"videos/s; re-eval (test_mucon) {reeval_s:.3f} s [{card}]")
    for i, (sec, ph) in enumerate(evs):
        say(f"cli: eval {i} ({'final, Viterbi' if i == len(evs) - 1 else 'periodic'}) "
            f"{sec} s, last_eval_phases {ph} [{card}]")
    say(f"cli: {result}")
    return dict(sets=sets, runs=runs, log=log, model=model, test_db=test_db)


# -- phase 7: the supervised regimes and the other evaluation modes ----------

def eval_launches(batches: int, teacher_forcing: bool = False) -> dict:
    """Each kernel's launches in `batches` eval batches of the default model
    (the alignment eval adds the decoder chain's forward, once a batch)."""
    from mucon_tpu_torch import cuda

    want = {k: 0 for k in cuda.KERNELS}
    for k, n in PER_EVAL_BATCH.items():
        want[k] += batches * n
    if teacher_forcing:
        want["decoder_chain_fwd"] += batches
    return want


def finite_fields(tag, result) -> dict:
    import dataclasses

    fields = dataclasses.asdict(result)
    expect(len(fields) == 24 and all(np.all(np.isfinite(v)) for v in fields.values()),
           f"{tag}: the result is not 24 finite fields: {fields}")
    return fields


def supervised_entries(dev, card: str, cli: dict) -> None:
    """`train_test_mucon_full` and `train_test_mucon_mixed` (50% of the
    videos supervised) for 1 epoch at B=8 with the flint loss kernel, each
    with its eval and final Viterbi eval: 24 finite fields, train events
    with both supervised terms, the mixed subset, and each kernel's
    launches as the steps and eval batches imply."""
    import contextlib
    import random
    from pathlib import Path

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli import train_test_mucon_full, train_test_mucon_mixed
    from mucon_tpu_torch.data import handel_mixed_supervision_dataset

    pct = [("dataset.mixed.full_supervision_percentage", "50.0")]
    first = {}
    for regime, entry, extra in (("full", train_test_mucon_full, []),
                                 ("mixed", train_test_mucon_mixed, pct)):
        exp = f"chip_{regime}"
        sets = cli["sets"] + [("trainer.num_epochs", "1")] + extra
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with open(cli["log"], "a") as f, contextlib.redirect_stdout(f):
            result = entry.main(cli_argv(sets, exp))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(cuda.launch_counts)
        finite_fields(regime, result)
        run = Path(cli["runs"]) / exp / "0"
        events = [json.loads(line) for line in open(run / "events.jsonl")]
        train = [e for e in events if e["kind"] == "train"]
        expect(train and all(e["classification_loss"] > 0
                             and np.isfinite(e["supervised_length_loss"]) for e in train),
               f"{regime}: train events without both supervised terms: {train}")
        state = json.loads((run / "checkpoints" / "epoch_0" / "trainer_state.json").read_text())
        steps = state["iter_num"]
        kinds = [e["kind"] for e in events]
        batches = (kinds.count("eval_0") + kinds.count("final_eval")) * \
            -(-len(cli["test_db"]) // TRAIN_B)
        want = eval_launches(batches)
        for k, n in PER_TRAIN_STEP.items():
            want[k] += steps * n
        expect(launches == want, f"{regime}: launches {launches} != {want} implied by {steps} "
                                 f"train steps and {batches} eval batches")
        subset = ""
        if regime == "mixed":
            db = handel_mixed_supervision_dataset(smoke_cfg(cli["runs"], sets=sets), train=True)
            n, count = len(db), max(1, round(len(db) * 0.5))
            ref = [True] * count + [False] * (n - count)
            random.seed(f"{db.cfg.system.seed}-{count}")  # the reference's scheme
            random.shuffle(ref)
            expect(db.is_it_supervised == ref and sum(ref) == count,
                   f"mixed: supervised subset {db.is_it_supervised} != {ref}")
            subset = (f"; supervised subset {count}/{n}: "
                      f"{[db.file_names[i] for i in range(n) if ref[i]]}")
        (epoch,) = [e for e in events if e["kind"] == "epoch"]
        evals = [round(e["eval_seconds"], 3) for e in events
                 if e["kind"] in ("eval_0", "final_eval")]
        say(f"{regime}: {steps} train steps (classification_loss {train[0]['classification_loss']:.4f}, "
            f"supervised_length_loss {train[0]['supervised_length_loss']:.6f} at step 0) and "
            f"{batches} eval batches launched each kernel as often as they imply{subset}; "
            f"run {run_s:.3f} s, epoch {epoch['epoch_seconds']:.3f} s, evals {evals} s "
            f"[{card}]")
        say(f"{regime}: {result}")
        first[regime] = train[0]
    # the same weights, masks and first batch: the same terms, but the mixed
    # gate adds the supervised ones for its supervised videos only
    full, mixed = first["full"], first["mixed"]
    same = [k for k in full if k.endswith("_loss")]
    expect(all(full[k] == mixed[k] for k in same) and mixed["main"] < full["main"],
           f"mixed vs full at step 0: {mixed} vs {full}")
    say(f"step 0: main loss {full['main']:.6f} (full) > {mixed['main']:.6f} (mixed), the "
        f"other {len(same)} terms equal")


def supervised_batch(arrays, rng, dev) -> dict:
    """The train batch with ground truth: each video's frames cut at random
    points into its transcript's segments, their lengths and the framewise
    labels they imply; every video supervised."""
    import torch

    nf, nl = arrays["num_frames"].tolist(), arrays["transcript_len"].tolist()
    tr = arrays["transcript"].cpu().numpy()
    gt = np.zeros(tuple(arrays["feats"].shape[:2]), np.int64)
    lengths = np.zeros(tr.shape, np.float32)
    for b, (t, n) in enumerate(zip(nf, nl)):
        cuts = np.sort(rng.choice(np.arange(1, t), size=n - 1, replace=False))
        seg = np.diff(np.concatenate(([0], cuts, [t])))
        gt[b, :t] = np.repeat(tr[b, :n], seg)
        lengths[b, :n] = seg
    return dict(arrays, gt_label=torch.as_tensor(gt, device=dev),
                absolute_lengths=torch.as_tensor(lengths, device=dev),
                fully_supervised=torch.ones(len(nf), dtype=torch.bool, device=dev))


def supervised_steps(dev, card: str, tmp: str) -> None:
    """Three kernel train steps of the fully supervised model (twice, bit
    for bit) and before each a plain step from the same weights, masks and
    batch (`compare_steps`: 1e-4 relative on all seven loss terms, 1e-2 of
    the update), each train kernel launched as often as three steps imply."""
    from mucon_tpu_torch.models.model import MuConFullySupervisedModel

    rng = np.random.default_rng(1)
    arrays = supervised_batch(train_batch(rng, dev), rng, dev)
    trainers = make_trainers(dev, "wavenet", tmp, model_cls=MuConFullySupervisedModel)
    launches = compare_steps("fully supervised WaveNet", trainers, arrays, TRAIN_STEPS,
                             TRAIN_KERNELS, ("mstcnpp_stack", "wavenet_train_v2_fwd",
                                             "wavenet_train_v2_sweep"), card)
    want = {k: TRAIN_STEPS * n for k, n in PER_TRAIN_STEP.items()}
    got = {k: launches[k] for k in want}
    expect(got == want, f"fully supervised steps launched {got} != {want}")


def alignment_eval(dev, card: str, cli: dict) -> None:
    """`MuConAlignmentEvaluator` on the cli phase's checkpoint, with the
    kernels and plain: the decoder chain's forward kernel once an eval batch
    on the kernel path and no kernel on the plain one, the ground truth's
    transcript decoded (s_mat_score 1, s_len_diff 0), and the two paths'
    outputs equal by `compare_request`'s near-tie rules."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.harness import MuConAlignmentEvaluator
    from mucon_tpu_torch.harness.evaluator import pad_rows
    from mucon_tpu_torch.models.model import batch_to_tensors
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval

    model, test_db = cli["model"], cli["test_db"]
    batches = -(-len(test_db) // TRAIN_B)
    saved, secs = {}, {}
    for kernels in (True, False):
        ev = MuConAlignmentEvaluator(smoke_cfg(cli["runs"], kernels=kernels, sets=cli["sets"]),
                                     test_db, model)
        ev.viterbi_mode(True)
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        result = ev.evaluate()
        torch.cuda.synchronize()
        secs[kernels] = time.perf_counter() - t0
        launches = dict(cuda.launch_counts)
        want = eval_launches(batches, teacher_forcing=True) if kernels else \
            {k: 0 for k in cuda.KERNELS}
        expect(launches == want, f"alignment eval (kernels {kernels}): launches {launches} "
                                 f"!= {want}")
        fields = finite_fields("alignment eval", result)
        expect(fields["s_mat_score"] == 1.0 and fields["s_len_diff"] == 0.0,
               f"alignment eval: s_mat_score {fields['s_mat_score']}, s_len_diff "
               f"{fields['s_len_diff']} (want 1.0, 0.0)")
        expect(model.teacher_forcing, "alignment eval left teacher forcing off")
        saved[kernels] = ev.to_save

    run_k = build_fused_eval(model, teacher_forcing=True, frame_sampling=FRAME_SAMPLING)
    run_p = build_fused_eval(model, teacher_forcing=True, frame_sampling=FRAME_SAMPLING,
                             use_kernels=False)

    def preds(d, lo, hi):
        return [dict(y_labels=d["y_segs"][i], vit_labels=d["vit_segs"][i],
                     transcript=d["s_transcript"][i]) for i in range(lo, hi)]

    lo, mism = 0, []
    with torch.inference_mode():
        for batch in ev.create_dataloader():
            B = batch.batch_size
            arrays = pad_rows(batch_to_tensors(batch, dev), TRAIN_B)
            outk = {k: v[:B] for k, v in run_k(arrays).items()}
            outp = {k: v[:B] for k, v in run_p(arrays).items()}
            mism += compare_request("alignment", model, arrays, outk, outp,
                                    preds(saved[True], lo, lo + B),
                                    preds(saved[False], lo, lo + B), teacher_forcing=True)
            lo += B
    expect(lo == len(test_db), "alignment eval: batches do not cover the test set")
    for line in mism:
        say(f"near-tie mismatch (allowed): {line}")
    say(f"alignment eval of {lo} videos: decoder_chain_fwd launched {batches} times (once a "
        f"batch) with the kernels, no kernel plain; s_mat_score 1.0, s_len_diff 0.0; kernel "
        f"== plain ({len(mism)} near-tie mismatches); {secs[True]:.3f} s with the kernels, "
        f"{secs[False]:.3f} s plain [{card}]")


def segment_positions(segments, kv: int) -> np.ndarray:
    """A decode's transcript position at each of its kv windows, from its
    segments (one a position; the last one holds the remainder frames)."""
    pos = []
    for n, seg in enumerate(segments):
        pos += [n] * (seg.length // FRAME_SAMPLING)
    return np.asarray(pos[:kv])


def per_batch_eval(dev, card: str, cli: dict) -> None:
    """The evaluator's per-batch path on the cli phase's checkpoint, with
    `evaluator.viterbi.multi_length=True` (the DP kernel on full-T tables,
    once a batch, its pointer walk in the launch) and with the host oracle
    (`backend="host"`), each against the fused path on the same batches
    (`eval_single_shape` off: the same forward): every video's Viterbi
    labels equal but at a near tie of the two paths under the full-T
    tables, and the 24 fields within 2e-3, each over every video but those
    that a near tie (vit_* fields) or an EOS-first decode (s_* fields)
    sets apart (`fields_over`)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.harness import evaluator as ev_mod
    from mucon_tpu_torch.ops import viterbi, viterbi_dp
    from mucon_tpu_torch.ops.viterbi import viterbi_precompute

    model, test_db = cli["model"], cli["test_db"]
    batches = -(-len(test_db) // TRAIN_B)
    runs = {}

    def evaluate(name, sets):
        decoded, inputs, host_s = [], [], []
        dense, decode = ev_mod.dense_viterbi_decode_batch, ev_mod.ViterbiDecoder.decode
        to_results = ev_mod.positions_to_results

        def dense_spy(*a, **k):
            inputs.append(a)
            out = dense(*a, **k)
            decoded.extend(out)
            return out

        def host_spy(self, lp):
            t0 = time.perf_counter()
            score, labels, segments = decode(self, lp)
            host_s.append(time.perf_counter() - t0)
            decoded.append(SimpleNamespace(score=score, segments=segments))
            return score, labels, segments

        def fused_spy(*a):
            out = to_results(*a)
            decoded.extend(out)
            return out

        ev = ev_mod.MuConEvaluator(smoke_cfg(cli["runs"], sets=cli["sets"] + sets),
                                   test_db, model)
        ev.viterbi_mode(True)
        with mock.patch.object(ev_mod, "dense_viterbi_decode_batch", dense_spy), \
                mock.patch.object(ev_mod.ViterbiDecoder, "decode", host_spy), \
                mock.patch.object(ev_mod, "positions_to_results", fused_spy), \
                mock.patch.object(viterbi, "traceback_positions",
                                  wraps=viterbi.traceback_positions) as walk, \
                mock.patch.object(viterbi_dp, "traceback_positions",
                                  wraps=viterbi_dp.traceback_positions) as walk_dp:
            cuda.reset_launch_counts()
            t0 = time.perf_counter()
            fields = finite_fields(name, ev.evaluate())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        expect(walk.call_count == walk_dp.call_count == 0,
               f"{name}: the Python pointer walk ran on the kernel path")
        want = eval_launches(batches)
        want["dense_viterbi"] = 0 if name == "host" else batches
        launches = dict(cuda.launch_counts)
        expect(launches == want, f"{name}: launches {launches} != {want}")
        expect(len(decoded) == len(test_db), f"{name}: {len(decoded)} decodes")
        runs[name] = SimpleNamespace(fields=fields, saved=ev.to_save, decoded=decoded,
                                     inputs=inputs, secs=secs, host_s=host_s)

    evaluate("fused", [("tpu.eval_single_shape", "False")])
    evaluate("multi_length", [("evaluator.viterbi.multi_length", "True")])
    evaluate("host", [("evaluator.viterbi.backend", "host")])

    # the full-T tables of every video, from the inputs of the device decode
    tables = []
    for log_probs, t_valid, transcripts, n_valid, lams in runs["multi_length"].inputs:
        W, pois, k_valid = viterbi_precompute(
            torch.as_tensor(log_probs), torch.as_tensor(np.asarray(t_valid, np.int64)),
            torch.as_tensor(np.asarray(transcripts, np.int64)), torch.as_tensor(lams),
            frame_sampling=FRAME_SAMPLING, max_len=MAX_LEN, l_max=MAX_LEN // FRAME_SAMPLING)
        tables += [(W[b].numpy(), pois[b].numpy(), int(k_valid[b]), int(n_valid[b]),
                    lams[b][np.asarray(transcripts)[b, :n_valid[b]]])
                   for b in range(len(t_valid))]
    # each feasible decode's path, rebuilt from its segments, scores its own
    # score under the full-T tables (the host's float64 and the fused path's
    # pre-upsample tables part from them by rounding only)
    for name, r in runs.items():
        for i, d in enumerate(r.decoded):
            if not d.score > viterbi.NEG / 2:
                continue
            W, pois, kv, n, _ = tables[i]
            own = path_score(W, pois, segment_positions(d.segments, kv), kv, n)
            expect(abs(own - d.score) <= path_tie_bound(d.score),
                   f"{name} video {i}: its path scores {own} under the full-T tables, its "
                   f"decode {d.score}")
    fused = runs["fused"]
    for name in ("multi_length", "host"):
        r, ties = runs[name], []
        # a video whose decode emits EOS first: the per-batch path's
        # transcript is empty, the fused path's [0] (its n_dec is at least
        # 1); both decode it against background
        eos_first = [i for i, (a, b) in enumerate(zip(r.saved["s_transcript"],
                                                     fused.saved["s_transcript"])) if a != b]
        expect(all(r.saved["s_transcript"][i] == [] and fused.saved["s_transcript"][i] == [0]
                   for i in eos_first),
               f"{name}: decoded transcripts differ from the fused path's")
        for i, (a, b) in enumerate(zip(r.saved["vit_segs"], fused.saved["vit_segs"])):
            if np.array_equal(a, b):
                continue
            W, pois, kv, n, lam = tables[i]
            s_here, s_fused = (path_score(W, pois, segment_positions(d[i].segments, kv), kv, n)
                               for d in (r.decoded, fused.decoded))
            best = max(s_here, s_fused)
            line = (f"{name} video {i}: Viterbi labels differ from the fused path's; full-T "
                    f"scores {s_here} vs {s_fused} (bound {path_tie_bound(best):.3e}), "
                    f"Poisson step margin {normaliser_step_margin(lam):.3e}")
            expect(abs(s_here - s_fused) <= path_tie_bound(best)
                   or normaliser_step_margin(lam) <= TIE, line)
            ties.append((i, line))
        # the fields again from both passes' saved outputs, each family over
        # the videos that its exemption leaves; over all videos they must
        # give each pass's own result
        metrics = ev_mod.MuConEvaluator(smoke_cfg(cli["runs"], sets=cli["sets"]), test_db, model)
        metrics.viterbi_mode(True)
        videos = range(len(test_db))
        for x in (r, fused):
            again = fields_over(metrics, x.saved, videos)
            expect(all(np.array_equal(again[k], v) for k, v in x.fields.items()),
                   f"{name}: the fields from the saved outputs {again} != {x.fields}")
        apart = {"s_": set(eos_first), "vit_": {i for i, _ in ties}, "y_": set()}
        worst = {}
        for prefix, skip in apart.items():
            keep = [i for i in videos if i not in skip]
            expect(keep, f"{name}: every video set apart from the {prefix}* fields")
            here, there = (fields_over(metrics, x.saved, keep) for x in (r, fused))
            for k in (k for k in here if k.startswith(prefix)):
                worst[k] = float(np.max(np.abs(np.subtract(here[k], there[k]))))
                expect(worst[k] <= 2e-3,
                       f"{name}: {k} {here[k]} differs from the fused path's {there[k]} by "
                       f"{worst[k]} over videos {keep}")
        expect(len(worst) == 24, f"{name}: compared {sorted(worst)}")
        for _, line in ties:
            say(f"near-tie mismatch (allowed): {line}")
        if eos_first:
            say(f"{name}: videos {eos_first} emit EOS first: the s_* fields compared over "
                f"the other videos")
        extra = ""
        if r.host_s:
            extra = (f"; the host decoder {sum(r.host_s):.3f} s for {len(r.host_s)} videos "
                     f"({min(r.host_s):.3f}-{max(r.host_s):.3f} s a video)")
        say(f"per-batch eval, {name}: {len(test_db)} videos in {batches} batch(es), "
            f"{r.secs:.3f} s{extra}; dense_viterbi launched "
            f"{0 if name == 'host' else batches} times, no Python walk; largest field diff "
            f"to the fused path {max(worst.values()):.2e} ({len(ties)} near-tie Viterbi "
            f"mismatches) [{card}]")
    say(f"per-batch eval: the fused path on the same batches {fused.secs:.3f} s [{card}]")


def fields_over(ev, saved: dict, videos) -> dict:
    """The 24 fields of one evaluation pass over `videos` alone: `ev`'s own
    metric objects, emptied, fed that pass's saved per-video outputs (the
    arrays `_feed_all_metrics` gives them), in order."""
    import dataclasses

    ev.on_start_eval()
    metrics = {a: m for a, m in vars(ev).items() if a.endswith("_metric")}
    transcript = ("s_mat_score_metric", "s_abs_len_diff_metric")
    for i in videos:
        for a in transcript:
            metrics[a].add(target_transcript=saved["target_transcripts"][i],
                           predicted_transcript=saved["s_transcript"][i])
        for a, m in metrics.items():
            if a not in transcript:
                m(targets=saved["target_segs"][i],
                  predictions=saved[a.split("_")[0] + "_segs"][i])
    return dataclasses.asdict(ev.on_finish_eval())


def variants_phase(dev, card: str, tmp: str, cli: dict) -> None:
    """The fully and mixed supervised entry points, the supervised train
    step against its plain twin, the alignment evaluator and the per-batch
    evaluation path, at full width on the cli phase's data and checkpoint."""
    supervised_entries(dev, card, cli)
    supervised_steps(dev, card, tmp)
    alignment_eval(dev, card, cli)
    per_batch_eval(dev, card, cli)


def ptxas_summary(log: str) -> list:
    """One line a kernel from nvcc's `-Xptxas -v` log: its name (demangled
    where c++filt exists), its registers and its stack and spill bytes."""
    import re

    out, entry, props, spills = [], None, None, {}
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif "spill" in line:
            spills[props] = line.strip()
        elif "Used" in line and "registers" in line and entry:
            out.append([entry, line.split(":", 1)[-1].strip(), spills.get(entry, "")])
            entry = None
    if shutil.which("c++filt") and out:
        plain = subprocess.run(["c++filt"], input="\n".join(n for n, _, _ in out),
                               capture_output=True, text=True).stdout.splitlines()
        if len(plain) == len(out):
            for kernel, name in zip(out, plain):
                kernel[0] = name.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("(")[0]
    return [f"{name}: {used}; {spill}" for name, used, spill in out]


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
    for line in ptxas_summary(lib.with_suffix(".log").read_text()):
        say(f"  ptxas: {line}")

    dev = torch.device("cuda")
    model = create_model(M, N_MAX + 1, D, device=dev, seed=0)
    model_m = create_model(M, N_MAX + 1, D, ft_type="mstcnpp", device=dev, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        results = {
            "wavenet_layer": check_wavenet(model, gen, dev),
            "mstcnpp_stack": check_mstcnpp(model_m, gen, dev),
            "bilstm_recurrence": check_bilstm(model, gen, dev),
            "dense_viterbi": check_viterbi(gen, dev),
        }
        launches = serve("WaveNet", model, dev, np.random.default_rng(0), smi,
                         SERVING_KERNELS, absent=("mstcnpp_stack",))
        launches["mstcnpp_stack"] = serve(
            "MS-TCN++", model_m, dev, np.random.default_rng(0), smi,
            MSTCNPP_SERVING_KERNELS, absent=("wavenet_layer",))["mstcnpp_stack"]
    del model, model_m
    tmp = tempfile.mkdtemp(prefix="mucon_chip_smoke_")
    try:
        train_results, train_launches, arrays = train(dev, np.random.default_rng(1), smi,
                                                      tmp)
        results.update(train_results)
        launches.update({k: train_launches[k] for k in train_results})
        compare_steps("MS-TCN++", make_trainers(dev, "mstcnpp", tmp), arrays, MSTCNPP_STEPS,
                      MSTCNPP_TRAIN_KERNELS, STACK_KERNELS, smi, stages=True)
        del arrays
        cli = cli_phase(dev, smi, tmp)
        variants_phase(dev, smi, tmp, cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, line in results.items():
        source, replaces = REPLACES[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **line))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
