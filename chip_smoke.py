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
   k_valid < K, infeasible videos, the cluster body at N = 40, the position
   body at L = 133, a walk table in device memory at K = 4000), each timed
   beside the plain pair with its plan and body printed, and the position
   body forced at each shape the route gives another body;
4. serves two requests through `predict_videos` (the bench eval batch of 128
   videos of 1500-2100 frames, and 3 videos of 517/1203/2100 frames) with
   the kernels and with the plain path, for the WaveNet model and for the
   MS-TCN++ model, checks that each path launched its kernels (and not the
   other backbone's), that the kernel path's fused eval launches the DP
   once a batch and runs no Python pointer walk, and that both paths agree,
   and times both (and the Viterbi DP + walk span of each); then exports the
   WaveNet model's serving program (`serving_export_phase`, B=4 at 2560
   frames, the default widths at 5 layers and 8 decoding steps, on the
   float32 and the int8 wire), loads it and serves request B
   through it: bit for bit equal to the live plain program with no kernel
   launched, per-video results agreeing with the kernel path, an artifact
   of the smaller program's weights that emit EOS at step 0 equal to the
   live decode loop, the
   one-video Viterbi decode's kernel equal to its plain DP; export, save
   and load seconds, ms a request and the phase's seconds printed;
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
   then the data-parallel mesh on that phase's data (`mesh_phase`): the
   same entry point under `python -m torch.distributed.run
   --nproc-per-node 1` with `tpu.mesh.enable` and `tpu.mesh.multihost` (a
   mesh of one rank over NCCL: the all-reduce a step and the eval's
   all-gather on the card), its launches equal the cli run's, the regime
   line logged, one checkpoint folder a save, and its results equal bit
   for bit to a plain run of the same flags, both under deterministic
   algorithms (and within 1e-4 / 2e-3 of the cli run's, which used the
   default ones); and two gloo ranks on the one card, each with 4 of the
   train batch's 8 videos, three `make_sharded_train_step` kernel steps
   against single-process steps at B=8 (`check_step`, the update at the
   model's scale), the ranks' weights equal bit for bit, with the DP
   step's and its gradient all-reduce's ms; then the mesh's seq and model
   axes (`mesh_seq_model`): 2, 4 and 8 gloo ranks sharing the card, a
   step each on (data, seq, model) = (1,2,1), (1,1,2) and (1,2,2) at the
   default model on the train batch, on (1,2,1) for a 12,288-frame video,
   and on (2,2,2) at small_cfg's widths, each held to a one-rank step on
   the same routes (`check_step`), the ranks equal bit for bit, the
   kernels after the backbone's gather launched once and no stack kernel,
   with each step's ms, its collectives' ms and the bytes staged through
   the host, and the phase's seconds.  Before it the native host kernels
   (`native_check`): the library loaded, the cli phase's collates and
   metrics counted on it, request A's collate native against numpy (equal
   bytes, both times);
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
8. exercises the trainer's options on that phase's data and run folder
   (`trainer_options_phase`): `train_test_mucon` for 3 epochs with
   `tpu.cache_batches` and `tpu.device_prefetch 2`, against the same fixed
   batches streamed with no cache and no prefetch (no collate in epochs 2-3,
   evals 2-3 and the final eval; every epoch loss and eval field equal bit
   for bit) and against the defaults, with each run's epoch and eval
   `stream` seconds and the cache's bytes; the int8 wire's eval forward and
   train step equal bit for bit to float32 on the dequantized features, an
   epoch on the float16 and bfloat16 wires, each wire's bytes a batch;
   `trainer.accumulate_grad_every=2` at B=4 and one step of each clip mode
   (joint, per-parameter, none), each against plain steps from the same
   weights; three free-decoding (`model.teacher_forcing=False`) kernel
   steps against plain steps, no decoder chain launched, and a
   `TrainerForTFExperiments` run launching the chain in its first epoch
   only; `inspect_run` and `write_report` on the cli run folder;
9. runs the bf16 compute path and the per-kernel routes (`precision_phase`):
   the stack kernels' bf16-operand modes (`tpu.kernel_mm_dtype=bfloat16`:
   the WaveNet eval stack and the MS-TCN++ stage at B=128, T=2560; the
   trainable stack's forward and sweep at the train batch) against their
   bf16 plain twins -- every layer of the forward from its own stash, the
   first two layers with counted rounding flips, all 11 by the JAX
   package's contract -- and against the 3xTF32 kernels, timed in turns
   and by device time; `train_test_mucon --cfg configs/tpu_batched.yaml`
   (bf16 compute, B=16, pad 512) on the cli data with its launches by
   route (rows 9-10 none) and `test_mucon` within 1e-6; three bf16 kernel
   steps against steps of the same routes on the plain twins; the four
   modes through a train step, an eval and an MS-TCN++ request (the
   report's launches); each `tpu.use_pallas*` flag off alone; and a
   unidirectional encoder (no BiLSTM kernel);
10. runs every kernel at the other shapes the JAX kernels take
   (`widths_phase`): rows 1, 5, 6, 12, 13 and 14 at C = 48 (zero-padded to
   the 128 instance), 256, 512 and, on the wide bodies, 600, 768 and 1024
   in 3xTF32 and in the bf16-operand mode (rows 1 and 12 at B = 128,
   T_pad = 1280; above 512 on the `wgmma` bodies, csrc/wavenet_wgmma.cu
   (row 5 too) and for rows 6, 13, 14 csrc/wavenet_wgmma_train.cu, each line
   naming the C entry points it launched; at C = 768 the eval stack equal
   to the trainable forward without dropout), rows 2, 7-10 at H = 100, 127,
   256, 512 (even, ragged and L2-weight splits; the BiLSTM's persistent
   kernels from 512), 768 and 1024 (the wide kernels; the decoder chain's
   persistent kernels, each line with its plan: CTAs, the weight columns
   resident in shared memory and those read from L2, and the forward equal
   to the cluster forward bit for bit), each against its twin
   under the C = 128 / H = 128 bounds (the sweep's gradients against the
   float64 twin) and timed, the BiLSTM rows beside cuDNN's `nn.LSTM`; the BiLSTM at
   H = 1447 and the decoder chain at H = 1181 (B = 2, Tz = 40), the chain
   at Tz = 2048 (H = 128) and 1536 (H = 768), B = 1 (on its persistent
   kernels: its frames' rows and tables past a cluster's shared memory),
   the DP at frame_sampling 1 and 3 (L = 2000, 666: its
   position body), at N = 300 (its cluster body, and the position body
   forced) and at N = 300, L = 2000 (the position body),
   the flint loss at M = 600 and 778 (its window in chunks of classes) and
   at N = 482 (in chunks of segments); the MS-TCN++ model at C = 256
   and both backbones at C = H = 768 through `predict_videos` (request A
   among them; the stacks' `wgmma` entry points by name); and
   `train_test_mucon` at the wide (C = H = 256), ragged
   (C = 48, H = 100) and wide768 (C = H = 768) configurations with their
   launches (the decoder chain's CUDA kernels by name: the cluster kernels
   at H = 100 and 256, the persistent ones at 768; at 768 the eval
   batches' and the train steps' `wgmma` entry points by
   name), `test_mucon` within
   1e-6 and a kernel step against a plain step;
11. prints the kernel report JSON (each kernel's launches, error, time, the
   plain twin's time, the least time the card could take for the same work
   and, where one PyTorch call computes the same function, that call's
   time, and its `widths`: the same for each width the `widths` phase
   ran, the decoder chain's with the CUDA kernels and source of its
   route), then `{"ok": true, "device": {...}}` as the last line.

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
from typing import Optional
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
    # the bf16-operand modes (`tpu.kernel_mm_dtype=bfloat16`) of rows 1, 5, 6, 12
    "wavenet_layer_bf16": ("mucon_tpu_torch/csrc/wavenet_stack.cu",
                           "mucon_tpu/ops/wavenet_pallas_v2.py:151"),
    "wavenet_train_fwd_bf16": ("mucon_tpu_torch/csrc/wavenet_train.cu",
                               "mucon_tpu/ops/wavenet_train_pallas_v3.py:358"),
    "wavenet_train_sweep_bf16": ("mucon_tpu_torch/csrc/wavenet_train.cu",
                                 "mucon_tpu/ops/wavenet_train_pallas_v3.py:449"),
    "mstcnpp_stack_bf16": ("mucon_tpu_torch/csrc/mstcnpp.cu",
                           "mucon_tpu/ops/mstcnpp_pallas.py:151"),
    # and of rows 13, 14 (the v2 stack's `mm_dtype=bfloat16`)
    "wavenet_train_v2_fwd_bf16": ("mucon_tpu_torch/csrc/wavenet_train_v2.cu",
                                  "mucon_tpu/ops/wavenet_train_pallas_v2.py:430"),
    "wavenet_train_v2_sweep_bf16": ("mucon_tpu_torch/csrc/wavenet_train_v2.cu",
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
# the dense bf16 tensor-core peak: the bound of the stack kernels' bf16-operand
# mode (one bf16 product per product)
BF16_OPS_PER_S = 989e12
# The bf16-operand mode against its plain twin: both take exact products of
# the same bf16-rounded operands and sum them in f32, in another order, and
# round the sums to bf16 where the next product reads them.  Where the two
# sums round an activation to the two sides of a bf16 boundary (or of a
# ReLU kink or a max-pool tie), that operand differs by a bf16 ulp, and the
# outputs it feeds by more than the f32 noise.  So the check is in two
# parts.  (1) Exact operands: a layer of the trainable forward, recomputed
# by the twin from the kernel's own stash (its input, and its nonlin(z)
# before the 1x1), is held to BF16_TWIN * max|twin| element by element --
# nonlin(z) and the layer's output, every layer, at full width (the eval
# stack runs the same layer body).  (2) Whole stacks: the first two layers
# and the out-projection against the twin, each element within BF16_TWIN *
# max|twin| but for a counted set (printed with its worst element; at most
# BF16_FLIPS of the elements, the output's relative L2 err within
# BF16_TWIN_L2, gradients by GRAD_BOUND and GRAD_MAX_BOUND as the f32
# kernels); the 11 layers by the JAX package's own contract for the mode
# (tests/test_pallas.py:296-297, tests/test_pallas_train.py:386-397),
# against the twin and the 3xTF32 kernel: relative err < 0.02 and cosine >
# 0.9995, gradients cosine > 0.995 and norms within 5%.  (On the H100 the
# flips reach the bf16 noise level through 11 layers, rel L2 1.8e-3 (PERF.md
# §6); through two, 5.3e-5 with 0.6% of the elements above 1e-5, and
# 1.5e-4 with 4.2% for the MS-TCN++ stage, which rounds four times a layer.
# A wrong rounding mode would move every element and give a rel L2 near
# 2^-9: BF16_FLIPS = 10% and BF16_TWIN_L2 = 5e-4 stay clear of both.)
BF16_TWIN, BF16_FLIPS, BF16_TWIN_L2, BF16_REL, BF16_COS, BF16_GCOS, BF16_GNORM = (
    1e-5, 0.1, 5e-4, 0.02, 0.9995, 0.995, 0.05)


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


def device_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call of `fn`: every CUDA kernel it launches,
    summed (`torch.profiler`), after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / calls


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
           tf32x3: bool = False, bf16: bool = False) -> dict:
    """A kernel's line of the report.  bound_ms, the least time the card
    could take for the same work, is the larger of the bytes the function
    must move (its inputs read once, its outputs written once, counting
    only the valid frames and steps of this run's data) over HBM's rate
    and its f32 operations on this data over the f32 peak; with `tf32x3`
    (a matrix-product kernel on the tensor cores) over a third of the TF32
    peak, with `bf16` (the bf16-operand mode) over the dense bf16 peak
    (`ops_type` says which).  A kernel faster than its bound is a fault of
    the bound: fails."""
    ops_rate = BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S / 3 if tf32x3 else F32_OPS_PER_S
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / ops_rate
    bound_ms = max(bytes_ms, ops_ms)
    expect(ms >= bound_ms, f"a kernel's time {ms} ms is below its bound {bound_ms} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms,
                ops_type="bf16" if bf16 else "3xTF32" if tf32x3 else "f32")


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


def bilstm_launch(B: int, H: int, chain: bool = False) -> str:
    """The BiLSTM forward's (or reverse chain's) launch at B videos, as
    printed: up to H = 256 its clusters and waves; above, the persistent
    kernel's cooperative grid, its units a CTA, where w_hh lives and the
    CTAs the card holds at once."""
    from mucon_tpu_torch import cuda

    p = (cuda.bilstm_chain_launch if chain else cuda.bilstm_fwd_launch)(B, H)
    if p["kind"] == "cluster":
        waves = -(-p["clusters"] // p["active"])
        return (f"clusters of {p['cl']} CTAs x {p['threads']} threads, 8 videos a cluster: "
                f"{p['clusters']} clusters, the card holds {p['active']} at once: "
                f"{waves} wave{'s' if waves > 1 else ''}")
    return (f"persistent: one cooperative grid of 2 x {p['ctas']} CTAs x {p['threads']} "
            f"threads (the card holds {p['co_resident']} at once), at most {p['units']} "
            f"units a CTA for all {B} videos ({p['tiles']} tile{'s' if p['tiles'] > 1 else ''} "
            f"of {p['bv']}, {p['rv']}x{p['rc']} a thread), w_hh in {p['w_hh']} "
            f"({p['resident']} of {p['chunks']} chunks of {p['kch']} rows a group resident, "
            f"{p['stages']} ring slots), {p['smem']} bytes of shared memory a CTA")


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


def viterbi_tables(gen, nf, T_pad: int, dev, frame_sampling: int = FRAME_SAMPLING):
    """DP tables of random log-probs at Tz = T_pad / 16 for videos of nf
    frames with random transcripts of 1-30 actions, windows of
    `frame_sampling` frames (L = MAX_LEN // frame_sampling cells): (W, pois,
    k_valid, n_valid)."""
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
        frame_sampling=frame_sampling, max_len=MAX_LEN, l_max=MAX_LEN // frame_sampling,
    )
    return W, pois, kv, n_valid


def viterbi_plain_pair(W, pois, k_valid, n_valid, S: int, max_len: int):
    """The kernel's plain twin: `dense_viterbi_plain`, then `traceback_positions`."""
    from mucon_tpu_torch.ops.viterbi import dense_viterbi_plain, traceback_positions

    score, best_l, bps = dense_viterbi_plain(W, pois, k_valid, n_valid, S, max_len)
    return score, best_l, bps, traceback_positions(bps, k_valid, n_valid, best_l)


def check_decode(tag: str, args, reps: int = 5, body=None) -> tuple:
    """`dense_viterbi_decode` against the plain pair: score, best_l, bps and
    pos equal, and a second call equal to the first; timed beside the pair
    (`body`: that body forced through `cuda.dense_viterbi_decode`).
    Returns (outputs, ms, plain ms)."""
    from functools import partial

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi_decode

    run = dense_viterbi_decode
    if body is not None:
        tag = f"{tag}, the {body} body forced"
        run = partial(cuda.dense_viterbi_decode, body=body)
    got = run(*args)
    again = run(*args)
    want = viterbi_plain_pair(*args)
    names = ("score", "best_l", "bps", "pos")
    differ = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
    expect(not differ, f"dense_viterbi {tag}: {differ} differ from the plain DP + walk")
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"dense_viterbi {tag}: two calls of the same inputs differ")
    ms, plain_ms = paired_ms(lambda: run(*args),
                             lambda: viterbi_plain_pair(*args), reps=reps)
    W, pois = args[0], args[1]
    B, K, N = W.shape
    plan = cuda.viterbi_plan(B, N, pois.shape[2], K, body=body)
    expect(body is None or plan["body"] == body, f"dense_viterbi {tag}: planned on the "
           f"{plan['body']} body")
    held = (f"{plan['entries']} entry windows a lane, rows in {plan['rows']} memory"
            if plan["body"] == "position" else f"{plan['lc']} cells a lane")
    say(f"kernel dense_viterbi {tag} B={B} K={K} N={N} L={pois.shape[2]}: score, best_l, bps "
        f"and pos equal to the plain DP + walk, two calls bit for bit; {ms:.4f} ms = "
        f"{1000 * ms / max(K - 1, 1):.3f} us/window vs plain DP + walk {plain_ms:.3f} ms; "
        f"{plan['body']} body ({plan['warps']} warp(s) a CTA, {plan['ctas']} CTAs, "
        f"{held}, {plan['smem']} B shared, walk table in {plan['table']} memory)")
    return got, ms, plain_ms


def position_forced(tag: str, args, reps: int = 1) -> None:
    """`check_decode` on the position body where the route gives the shape
    another body (so that the card holds the position body at every shape
    it may take)."""
    from mucon_tpu_torch import cuda

    B, K, N = args[0].shape
    if cuda.viterbi_plan(B, N, args[1].shape[2], K)["body"] != "position":
        check_decode(tag, args, reps=reps, body="position")


# DP shapes off the serving path, (K, N, L, S, max_len): K = 1; N = 1;
# k_valid < K with more positions than windows (infeasible videos); cells
# l > 8 that may not grow (max_len 300: the gated shift); the cluster body
# (N > 32) and the position body (L > 72 at frame sampling 15); a walk table
# too large for shared memory (the warp body)
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
    position_forced("request A's shape", args)
    args_b = (*viterbi_tables(gen, torch.tensor([517, 1203, 2100]), T_pad, dev),
              FRAME_SAMPLING, MAX_LEN)
    check_decode("request B's shape", args_b)
    position_forced("request B's shape", args_b)
    for K, N, L, S, max_len in VITERBI_EDGES:
        edge = viterbi_edge_args(K, N, L, S, max_len, gen, dev)
        check_decode(f"edge S={S} max_len={max_len}", edge, reps=2)
        position_forced(f"edge S={S} max_len={max_len}", edge)
    return dp_report(args, (sk, lk, bk, pk), ms, plain_ms)


def dp_report(args, got, ms: float, plain_ms: float) -> dict:
    """A DP launch's report line from its inputs and its four outputs."""
    W, pois, kv, n_valid = args[:4]
    L = pois.shape[2]
    cells = int((kv.cpu() * n_valid.cpu()).sum())  # valid (window, position) pairs
    moved = 4 * cells + 4 * int(n_valid.sum()) * L + nbytes(*got)
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


def check_outputs(tag, out, preds, lengths, steps: int = N_MAX + 1):
    """The serving output of a model of `steps` decoding steps is well
    formed: finite, right shapes, relative lengths a distribution over the
    decoded transcript."""
    B = len(lengths)
    expect(out["tokens"].shape == (B, steps), f"{tag}: tokens {out['tokens'].shape}")
    expect(np.isfinite(out["vit_score"]).all() and np.isfinite(out["rel_lengths"]).all(),
           f"{tag}: non-finite scores or lengths")
    for b, (p, t) in enumerate(zip(preds, lengths)):
        n = int(out["n_dec"][b])
        expect(1 <= n <= steps - 1 and len(p["transcript"]) == n, f"{tag} {b}: n_dec {n}")
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


def serve(tag, model, dev, rng, card: str, required, absent=(), timed: bool = True):
    """Requests A and B through `predict_videos` and the fused eval, with
    the kernels and plain: the kernels in `required` must launch on the
    kernel path, those in `absent` must not; `timed`: time both paths
    ("A": request A's fused eval alone).  Returns the launch counts."""
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
    # the stacks' C entry points above 512 channels: the eval path's `wgmma`
    # entries only, never the trainable stack's (`mucon_wgt_*`)
    entries = {k: v for k, v in cuda.wide_launches.items() if v}
    if entries:
        say(f"the stack's entry points above 512 channels on the {tag} serving path: "
            f"{entries}")
    expect(all(k.startswith("mucon_wgmma") for k in entries),
           f"{tag}: the eval stack launched a trainable stack's wide entry: {entries}")
    launches.update(entries)
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
        if not timed or (timed == "A" and k != "A"):
            del arrays
            continue
        if timed is True and k == "A":  # the backbone's spans on the kernel path
            import torch

            feats_a, frames_a = arrays["feats"], arrays["num_frames"]
            with torch.no_grad():
                proj_ms = cuda_ms(lambda: model.net.ft.in_projection(feats_a, frames_a), reps=3)
                enc_ms = cuda_ms(lambda: model._encode_kernels(feats_a, frames_a), reps=3)
            say(f"{tag} request A spans: in-projection {proj_ms:.3f} ms, in-projection + "
                f"stack kernel {enc_ms:.3f} ms: the stack {enc_ms - proj_ms:.3f} ms [{card}]")
        if timed is True:
            say(f"{tag} request {k} Viterbi DP + walk: " + viterbi_span(model, arrays, card))
        ms, plain_ms = paired_ms(lambda: run_k(arrays), lambda: run_p(arrays),
                                 reps=3 if timed is True else 1)
        say(f"{tag} request {k} fused eval (device-resident features): kernels {ms:.2f} "
            f"ms/batch = {1000 * B / ms:.1f} videos/s; plain {plain_ms:.2f} ms/batch "
            f"= {1000 * B / plain_ms:.1f} videos/s [{card}]")
        if timed is not True:
            del arrays
            continue
        pk, pp = paired_ms(lambda: predict(k, True), lambda: predict(k, False), reps=1)
        say(f"{tag} request {k} predict_videos (host features in, labels out): kernels "
            f"{pk:.1f} ms/batch = {1000 * B / pk:.1f} videos/s; plain {pp:.1f} "
            f"ms/batch = {1000 * B / pp:.1f} videos/s [{card}]")
        del arrays
    return launches


# -- phase 4b: the serving export --------------------------------------------

EXPORT_B, EXPORT_PAD, EOS_PAD, EXPORT_WIRES = 4, 2560, 512, ("float32", "int8")
# every artifact's model: the default widths (D = 2048, C = H = 128) on 5
# stack layers (pools after layers 1-4, the default's 16x) and 8 decoding
# steps, a fraction of the default's graph: `torch.export` is host-bound in
# the graph's nodes
SMALL_EXPORT, SMALL_EXPORT_S = dict(stages=(1, 2, 4, 8, 16), pooling_layers=(1, 2, 3, 4)), 8


def event_and_host_ms(fn, reps: int) -> tuple:
    """(CUDA-event ms, host-clock ms) a call of `fn` over `reps` calls after
    one warm-up call; the host clock stops after a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * (time.perf_counter() - t0) / reps


def serving_export_phase(dev, card: str, tmp: str) -> None:
    """The serving export (`mucon_tpu_torch/serving.py`) on the card at B=4,
    pad_to=2560, of the default WaveNet model's widths at SMALL_EXPORT's
    depth on the float32 and the int8 wire: export, save and load it,
    and serve request B through
    `ExportedMuCon.predict`.  The artifact's raw outputs must equal the live
    plain program's (`build_serving_fn`, run eagerly on the same wire
    arrays) bit for bit under deterministic algorithms, with no kernel
    launched while it runs; its per-video results must agree with
    `predict_videos` with the kernels on the same wire by
    `compare_request`'s near-tie rules.  An artifact of weights whose EOS
    logit is raised (every video emits EOS at step 0; B=4 at 512 frames;
    the smaller model)
    must equal the live plain program and the live decode loop bit for
    bit, and the one-video `dense_viterbi_decode` with the kernel must
    equal it without.  Prints the export, save and load seconds and the ms
    a request of the artifact and of `predict_videos` with and without the
    kernels."""
    import torch
    import torch.nn.functional as F
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli.predict import collate_videos, predict_videos
    from mucon_tpu_torch.config import get_cfg_defaults
    from mucon_tpu_torch.models.model import FEATS_DTYPES, batch_to_tensors, create_model
    from mucon_tpu_torch.ops.eval_fused import (
        EVAL_OUTPUTS,
        build_eval_device,
        build_fused_eval,
        eval_tables,
        eval_to_host,
    )
    from mucon_tpu_torch.ops.viterbi import dense_viterbi_decode
    from mucon_tpu_torch.serving import (
        TEMPLATE_KEYS,
        build_serving_fn,
        export_serving,
        load_exported,
        same_bits,
    )

    t_phase = time.perf_counter()
    cfg = get_cfg_defaults()  # frame_sampling 30, pad_multiple 512
    db = vocab()
    db.feat_dim, db.get_num_classes = D, lambda: M
    lengths = [517, 1203, 2100]  # request B
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((t, D), dtype=np.float32) for t in lengths]
    names = [f"B_{i}" for i in range(len(lengths))]

    def export(model, wire: str, tag: str, pad_to: int = EXPORT_PAD):
        out = os.path.join(tmp, f"serving_{tag}")
        t0 = time.perf_counter()
        program = export_serving(model, cfg, db, EXPORT_B, pad_to, out, MAX_LEN, wire,
                                 device=dev)
        export_s = time.perf_counter() - t0
        save = ""
        if tag == EXPORT_WIRES[0]:  # the save alone, once
            t0 = time.perf_counter()
            torch.export.save(program, os.path.join(tmp, f"serving_{tag}_again.pt2"))
            save = f"; the save alone {time.perf_counter() - t0:.2f} s"
        t0 = time.perf_counter()
        served = load_exported(out)
        load_s = time.perf_counter() - t0
        mib = os.path.getsize(os.path.join(out, "model.pt2")) / 2**20
        say(f"serving export {tag}: export_serving {export_s:.2f} s (export + save{save}), "
            f"load_exported {load_s:.2f} s, model.pt2 {mib:.1f} MiB [{card}]")
        return served

    def bitwise(tag: str, served, model, wire: str, videos):
        """The artifact against the live plain program on the same wire
        arrays (`videos` padded as `predict` pads them), bit for bit; no
        kernel may launch while the artifact runs."""
        m = served.meta
        live = build_serving_fn(model, cfg, db, m["batch_size"], m["pad_to"], MAX_LEN, wire)
        padded, nf = served.pad_batch(videos)
        wire_arrays = served.to_wire(padded)
        torch.use_deterministic_algorithms(True)
        try:
            cuda.reset_launch_counts()
            got = served(wire_arrays, nf, raw_wire=True)
            torch.cuda.synchronize()
            launched = {k: v for k, v in cuda.launch_counts.items() if v}
            expect(not launched, f"serving {tag}: kernels launched in the artifact: {launched}")
            with torch.no_grad():
                want = live(*(t.to(dev) for t in wire_arrays), torch.from_numpy(nf).to(dev))
        finally:
            torch.use_deterministic_algorithms(False)
        for k, w in zip(m["outputs"], want):
            expect(same_bits(got[k], w), f"serving {tag}: {k} differs from the live plain "
                                         "program")
        return got, live, padded, nf

    model = create_model(M, N_MAX + 1, D, device=dev, seed=0)
    small = lambda: create_model(M, SMALL_EXPORT_S, D, device=dev, seed=0,  # noqa: E731
                                 **SMALL_EXPORT)
    request_ms = {}
    for wire in EXPORT_WIRES:
        m = small()
        served = export(m, wire, wire)
        got, _, _, nf = bitwise(wire, served, m, wire, feats)
        fdt = FEATS_DTYPES[wire]
        arrays = batch_to_tensors(collate_videos(feats, names, db), dev, feats_dtype=fdt)
        with torch.no_grad():
            outk = build_fused_eval(m, frame_sampling=FRAME_SAMPLING)(arrays)

        def live_predict(use_kernels):
            return predict_videos(m, feats, names, db, frame_sampling=FRAME_SAMPLING,
                                  batch_size=len(feats), use_kernels=use_kernels,
                                  feats_dtype=fdt)

        predk = live_predict(True)
        outp = {k: v[:len(feats)] for k, v in
                eval_to_host(got, torch.from_numpy(nf), EXPORT_PAD).items()}
        predp = served.predict(feats, names)
        check_outputs(f"serving {wire}", outp, predp, lengths, m.max_decoding_steps)
        mism = compare_request(f"serving {wire}", m, arrays, outk, outp, predk, predp)
        for line in mism:
            say(f"near-tie mismatch (allowed): {line}")
        say(f"serving {wire}: artifact == live plain program bit for bit (n_steps "
            f"{got['n_steps'].tolist()}), no kernel launched; per-video results == "
            f"predict_videos with the kernels ({len(mism)} near-tie mismatches)")
        request_ms[wire] = (event_and_host_ms(lambda: served.predict(feats, names), 3),
                            event_and_host_ms(lambda: live_predict(True), 3),
                            event_and_host_ms(lambda: live_predict(False), 3))
        del served, arrays, m
    for wire, ((ae, ah), (ke, kh), (pe, ph)) in request_ms.items():
        say(f"serving {wire} request B (3 videos, host features in, labels out), ms a "
            f"request by CUDA events / host clock: artifact {ae:.1f} / {ah:.1f}; "
            f"predict_videos with the kernels {ke:.1f} / {kh:.1f}, plain {pe:.1f} / "
            f"{ph:.1f} [{card}]")

    # every video emits EOS at step 0, so the live loop stops after one step;
    # 4 videos of at most 512 frames (a smaller program to export)
    model_e = small()
    with torch.no_grad():
        model_e.net.decoder.transcript_out.bias[M] += 1e3
    served = export(model_e, "float32", "eos_first", pad_to=EOS_PAD)
    videos = [rng.standard_normal((t, D), dtype=np.float32) for t in (512, 401, 230, 77)]
    got, live, padded, nf = bitwise("EOS-first", served, model_e, "float32", videos)
    expect(got["n_steps"].tolist() == [1] * EXPORT_B,
           f"serving EOS-first: n_steps {got['n_steps'].tolist()}, want all 1")
    loop_arrays = {k: getattr(live, k) for k in TEMPLATE_KEYS}
    loop_arrays.update(feats=torch.from_numpy(padded).to(dev),
                       num_frames=torch.from_numpy(nf).to(dev))
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            loop = build_eval_device(model_e, frame_sampling=FRAME_SAMPLING, max_len=MAX_LEN,
                                     use_kernels=False)(loop_arrays)
    finally:
        torch.use_deterministic_algorithms(False)
    for k in EVAL_OUTPUTS:
        expect(same_bits(got[k], loop[k]), f"serving EOS-first: {k} differs from the live "
                                           "decode loop")
    say("serving EOS-first: artifact == live plain program == live decode loop bit for bit "
        f"(n_steps {got['n_steps'].tolist()})")
    del served, model_e

    # the one-video decode, with the kernel and without, on request B's second video
    arrays = batch_to_tensors(collate_videos(feats, names, db), dev)
    with torch.no_grad():
        fwd = model.forward(arrays, use_kernels=False)
        tb = eval_tables(fwd, arrays["num_frames"], EXPORT_PAD, N_MAX, FRAME_SAMPLING, MAX_LEN)
    b, t = 1, lengths[1]
    n = int(tb.n_dec[b])
    args = (F.log_softmax(fwd.segmentation[b, :t], dim=-1).cpu().numpy(),
            tb.trs[b, :n].cpu().tolist(), tb.lam[b].cpu().numpy(), FRAME_SAMPLING, MAX_LEN)
    cuda.reset_launch_counts()
    rk = dense_viterbi_decode(*args, device=dev, use_kernels=True)
    dp = cuda.launch_counts["dense_viterbi"]
    rp = dense_viterbi_decode(*args, device=dev, use_kernels=False)
    expect(dp == 1, f"one-video dense_viterbi_decode launched dense_viterbi {dp} times")
    expect(rk.score == rp.score and np.array_equal(rk.labels, rp.labels)
           and rk.segments == rp.segments,
           f"one-video dense_viterbi_decode: the kernel ({rk.score}, {len(rk.segments)} "
           f"segments) differs from the plain DP ({rp.score}, {len(rp.segments)})")
    say(f"one-video dense_viterbi_decode (T={t}, N={n}): kernel == plain (score {rk.score}, "
        f"{len(rk.segments)} segments)")
    say(f"serving export phase: {time.perf_counter() - t_phase:.1f} s [{card}]")


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
        f"{bwd_ms[1]:.3f} ms; alone, the coefficient pass {coefs_ms:.3f} ms and the chain "
        f"({bilstm_launch(B, H, chain=True)}) {chain_ms:.3f} ms = "
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
    route = cuda.decoder_chain_route(B, H, E, Tz)
    launch = cuda.decoder_chain_fwd_launch(B, H, E, Tz)
    waves = -(-launch["clusters"] // launch["active"])
    if route["fwd"] == "cluster":
        say(f"kernel decoder_chain_fwd {tag}: clusters of {launch['cl']} CTAs x "
            f"{launch['threads']} threads, one a video: {launch['clusters']} clusters, the card "
            f"holds {launch['active']} at once: {waves} wave{'s' if waves > 1 else ''}; each "
            f"CTA's weights {'in shared memory' if launch['weights'] else 'from L2'}, its rows "
            f"of maskf, pre and enc in shared memory")
    else:  # its frames' rows pass a cluster's shared memory
        say(f"kernel decoder_chain_fwd {tag}: {chain_plan(B, H, E, Tz, 'persistent', False)}")
    say(f"kernel decoder_chain_bwd {tag}: the reverse chain on the {route['bwd']} route: "
        f"{chain_plan(B, H, E, Tz, route['bwd'], True)}")
    if not timed:
        return {}
    expect(route == {"fwd": "cluster", "bwd": "cluster"},
           f"the default shape {tag} is routed to {route}, not the cluster kernels")
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
# do not fit a CTA (read from L2); an odd H (the ragged split: 4 CTAs of 8
# or 9 units)
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
    plan = cuda.flint_plan(B, T, N, M)
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


def make_trainers(dev, ft_type: str, root: str, model_cls=None, sets=(), fields=None) -> dict:
    """Three trainers of the default model with the backbone `ft_type`
    (`model_cls`: `MuConModel` or a supervised variant; `fields`, more
    `build_model` fields such as the widths), from one seed, their run
    folders under `root`: "k" and "k2" with the kernels and the loss kernel
    (tpu.use_pallas_loss), "p" plain (every tpu.use_pallas* False); `sets`
    are more config overrides, and each trainer's model takes its teacher
    forcing from them (`on_start_epoch`)."""
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import MuConModel, create_model

    model_cls = model_cls or MuConModel
    out = {}
    for k in ("k", "k2", "p"):
        cfg = smoke_cfg(root, kernels=k != "p",
                        sets=[("tpu.batch_size", str(TRAIN_B)), ("model.ft.type", ft_type),
                              *sets])
        model = create_model(M, N_MAX + 1, D, device=dev, seed=0, ft_type=ft_type,
                             loss_cfg=loss_config_from_cfg(cfg), model_cls=model_cls,
                             **(fields or {}))
        out[k] = SimpleTrainer(cfg, f"train_{ft_type}_{model_cls.__name__}_{k}", None, model,
                               seed=1)
        out[k].on_start_epoch(0)
    return out


def check_step(tag, lk: dict, lp: dict, before: dict, after_k: dict, after_p: dict,
               model_scale: bool = False) -> None:
    """A kernel step against a plain step from the same weights `before`:
    every loss term within 1e-4 relative, every parameter within 1e-2 of
    the plain step's largest update to it -- with `model_scale` (bf16
    compute) of the largest update of any parameter: a gradient that passes
    bf16 roundings is good to 2^-8 of the largest term that feeds it, and
    a parameter whose terms cancel (the length head's bias) has an update
    far below them."""
    expect(all(np.isfinite(v) for v in (*lk.values(), *lp.values())),
           f"{tag}: non-finite loss")
    rel = max(abs(lk[n] - lp[n]) / max(abs(lp[n]), 1e-12) for n in lp)
    expect(rel <= 1e-4, f"{tag}: loss rel diff {rel} > 1e-4 ({lk} vs {lp})")
    worst = (0.0, "")
    top = max((after_p[n] - b).abs().max().item() for n, b in before.items())
    for n, b in before.items():
        upd = top if model_scale else (after_p[n] - b).abs().max().item()
        err = (after_k[n] - after_p[n]).abs().max().item()
        expect(err <= 1e-2 * upd + 1e-7, f"{tag}: {n} differs by {err} (update {upd})")
        worst = max(worst, (err / max(upd, 1e-30), n))
    say(f"{tag}: main loss {lk['main']:.6f} (kernels) vs {lp['main']:.6f} (plain, from the "
        f"same weights), max rel diff over the {len(lp)} terms {rel:.2e} <= 1e-4; every "
        f"parameter within 1e-2 * max|update{' of the model' if model_scale else ''}| "
        f"(worst {worst[0]:.2e}, {worst[1]})")


def compare_steps(tag, trainers, arrays, n_steps: int, required, absent, card: str,
                  stages: bool = False, model_scale: bool = False) -> dict:
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
        check_step(f"{tag} train step {at + 1}", lk, lp, snaps["k"][at], snaps["k"][at + 1],
                   snaps["p"][at + 1], model_scale)

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
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator
    from mucon_tpu_torch.parallel.mesh import pad_rows
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
    return dict(sets=sets, runs=runs, log=log, model=model, test_db=test_db, fields=fields,
                launches=launches)


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
    from mucon_tpu_torch.parallel.mesh import pad_rows
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


# -- phase 8: the trainer's options and the run-folder report ------------------

# a free-decoding train step launches no decoder chain kernel
PER_FREE_STEP = dict(PER_TRAIN_STEP, decoder_chain_fwd=0, decoder_chain_bwd=0)
WIRES = ("float32", "float16", "bfloat16", "int8")
REPORT_SECTIONS = ("<h2>Config</h2>", "<h2>Training losses</h2>", "<h2>Eval metrics</h2>",
                   "<h2>Segmentations</h2>")


class Collates:
    """Counts the collates (`PaddedBatchLoader._make_batch` calls) of each
    train epoch ("train", epoch) and each evaluation ("eval", i) while
    active, and keeps the trainers whose epochs it saw."""

    def __init__(self):
        self.counts, self.trainers, self.label = {}, [], None

    def __enter__(self):
        from mucon_tpu_torch.data.batching import PaddedBatchLoader
        from mucon_tpu_torch.harness.evaluator import MuConEvaluator
        from mucon_tpu_torch.harness.trainer import SimpleTrainer

        make, epoch = PaddedBatchLoader._make_batch, SimpleTrainer._train_one_epoch
        evaluate = MuConEvaluator.evaluate

        def made(loader, idxs):
            self.counts[self.label] += 1
            return make(loader, idxs)

        def one_epoch(trainer):
            if trainer not in self.trainers:
                self.trainers.append(trainer)
            self.label = ("train", trainer.epoch_num)
            self.counts[self.label] = 0
            return epoch(trainer)

        def evaluated(ev, *args, **kwargs):
            self.label = ("eval", sum(1 for kind, _ in self.counts if kind == "eval"))
            self.counts[self.label] = 0
            return evaluate(ev, *args, **kwargs)

        self._patches = [mock.patch.object(PaddedBatchLoader, "_make_batch", made),
                         mock.patch.object(SimpleTrainer, "_train_one_epoch", one_epoch),
                         mock.patch.object(MuConEvaluator, "evaluate", evaluated)]
        for patch in self._patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self._patches:
            patch.stop()


def cli_run(cli: dict, exp: str, sets) -> SimpleNamespace:
    """`train_test_mucon.main` on the cli phase's data with `sets` more,
    under `torch.use_deterministic_algorithms`: its collates, trainer,
    events and eval_metric series, and its seconds."""
    import ast
    import contextlib
    import pickle
    from pathlib import Path

    import torch
    from mucon_tpu_torch.cli import train_test_mucon

    torch.use_deterministic_algorithms(True)
    try:
        with Collates() as counted, open(cli["log"], "a") as f, \
                contextlib.redirect_stdout(f):
            t0 = time.perf_counter()
            result = train_test_mucon.main(cli_argv(cli["sets"] + sets, exp))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    finite_fields(exp, result)
    run = Path(cli["runs"]) / exp / "0"
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    with open(run / "metrics" / "eval_metric_1.pkl", "rb") as f:
        series = pickle.load(f)
    evals = [e for e in events if e["kind"] in ("eval_0", "final_eval")]
    return SimpleNamespace(
        counts=counted.counts, trainer=counted.trainers[-1], secs=secs,
        epochs=[e for e in events if e["kind"] == "epoch"], series=series,
        stream=[round(ast.literal_eval(e["eval_phases"])["stream"], 4) for e in evals],
        eval_s=[round(e["eval_seconds"], 4) for e in evals])


def same_run(a, b) -> bool:
    """Two runs' epoch losses and eval series equal bit for bit."""
    import dataclasses

    strip = lambda e: {k: v for k, v in e.items() if k not in ("time", "epoch_seconds")}  # noqa: E731
    return ([strip(e) for e in a.epochs] == [strip(e) for e in b.epochs]
            and len(a.series) == len(b.series)
            and all(ea == eb and dataclasses.asdict(ra) == dataclasses.asdict(rb)
                    for (ea, ra), (eb, rb) in zip(a.series, b.series)))


def cache_and_prefetch(card: str, cli: dict) -> None:
    """`train_test_mucon` for 3 epochs with an eval each: with
    `tpu.cache_batches` and `tpu.device_prefetch 2` ("cache"); with the
    same fixed batches and nothing cached (a budget of one byte) and no
    prefetch ("stream"); and with the defaults.  The cached run collates
    nothing in epochs 2-3 and evals 2-3 (nor in the final eval) and equals
    the streamed run bit for bit; the defaults' run equals them only where
    its batch plan does (the fixed batches are drawn in another order)."""
    from mucon_tpu_torch.data import PaddedBatchLoader, handel_dataset
    from mucon_tpu_torch.harness.cache import arrays_nbytes

    epochs = [("trainer.num_epochs", "3")]
    runs = {
        "cache": cli_run(cli, "chip_cache", epochs + [("tpu.cache_batches", "True"),
                                                      ("tpu.device_prefetch", "2")]),
        "stream": cli_run(cli, "chip_stream", epochs + [
            ("tpu.cache_batches", "True"), ("tpu.cache_budget_gb", "1.0e-9"),
            ("tpu.device_prefetch", "0")]),
        "defaults": cli_run(cli, "chip_defaults", epochs),
    }
    n = -(-len(runs["cache"].trainer.train_db) // TRAIN_B)
    want = {("train", 0): n, ("train", 1): 0, ("train", 2): 0, ("eval", 0): 1, ("eval", 1): 0,
            ("eval", 2): 0, ("eval", 3): 0}
    expect(runs["cache"].counts == want,
           f"cache: collates {runs['cache'].counts} != {want} (epochs 2-3, evals 2-3 none)")
    streamed = {k: (n if k[0] == "train" else 1) for k in want}
    expect(runs["stream"].counts == streamed,
           f"stream: collates {runs['stream'].counts} != {streamed}")
    expect(same_run(runs["cache"], runs["stream"]),
           "cache vs stream: the epoch losses or the eval fields differ")
    trainer = runs["cache"].trainer
    cached = (sum(arrays_nbytes(a) for a in trainer._batch_cache.values()),
              sum(arrays_nbytes(a) for a in trainer.evaluators[0]._array_cache.values()))
    say(f"cache: {n} train batches collated in epoch 1 and none after, the eval batch once "
        f"and replayed in evals 2-3 and the final eval; every epoch loss and the 24 fields "
        f"of all 4 evals equal bit for bit to the same fixed batches streamed without a cache "
        f"(device_prefetch 2 against 0)")

    db = handel_dataset(smoke_cfg(cli["runs"], sets=cli["sets"]), train=True)
    plans = {}
    for fixed in (True, False):
        loader = PaddedBatchLoader(db, batch_size=TRAIN_B, pad_multiple=512,
                                   seed=runs["cache"].trainer.seed, fixed_batches=fixed)
        plans[fixed] = []
        for e in range(3):
            loader.epoch = e
            plans[fixed].append([tuple(int(i) for i in b) for b in loader._batch_indices()])
    same = same_run(runs["cache"], runs["defaults"])
    if plans[True] == plans[False]:
        expect(same, "cache vs defaults: the same batch plan, but the runs differ")
    compositions = all(sorted(map(sorted, a)) == sorted(map(sorted, b))
                       for a, b in zip(plans[True], plans[False]))
    say(f"defaults: the run {'equals' if same else 'differs from'} the cached one bit for bit; "
        f"batch plans by epoch: fixed {plans[True]}, default {plans[False]} (the same "
        f"compositions: {compositions})")
    for name, r in runs.items():
        say(f"{name}: run {r.secs:.3f} s, epoch_seconds "
            f"{[round(e['epoch_seconds'], 4) for e in r.epochs]}, eval seconds {r.eval_s}, "
            f"eval stream seconds {r.stream} [{card}]")
    say(f"cache: {cached[0]} bytes of train batches ({len(trainer._batch_cache)}) and "
        f"{cached[1]} of eval batches on the card [{card}]")


def wire_checks(dev, card: str, tmp: str, cli: dict) -> None:
    """The int8 wire's eval forward and train step equal, bit for bit, the
    float32 path fed the dequantized features; an epoch on the float16 and
    the bfloat16 wires gives finite losses; the bytes each wire copies a
    batch."""
    import torch
    from mucon_tpu_torch.cli.common import create_model_from_cfg
    from mucon_tpu_torch.cli.predict import collate_videos
    from mucon_tpu_torch.data import handel_dataset
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.model import (FEATS_DTYPES, batch_to_host_tensors,
                                              batch_to_tensors, dequantize_feats)

    rng = np.random.default_rng(2)
    feats, transcripts = [], []
    for t in rng.integers(1500, 2101, size=TRAIN_B):
        transcripts.append(rng.integers(0, M, size=int(rng.integers(1, N_MAX + 1))))
        feats.append(rng.standard_normal((int(t), D), dtype=np.float32))
    batch = collate_videos(feats, [f"wire_{i}" for i in range(TRAIN_B)], vocab(), 512,
                           transcripts=transcripts)
    sizes = {w: sum(v.nbytes for v in batch_to_host_tensors(batch, feats_dtype=FEATS_DTYPES[w])
                    .values()) for w in WIRES}
    a8 = batch_to_tensors(batch, dev, feats_dtype="int8")
    a32 = dequantize_feats(a8)
    expect(a32["feats"].dtype == torch.float32 and "feats_scale" not in a32, "dequantize")
    model = cli["model"]
    torch.use_deterministic_algorithms(True)
    try:
        with torch.inference_mode():
            f8, f32 = model.forward(a8), model.forward(a32)
        expect(all(torch.equal(getattr(f8, k), getattr(f32, k)) for k in
                   ("transcript", "lengths", "segmentation", "tokens", "n_steps")),
               "int8 wire: the eval forward differs from the float32 one on the dequantized "
               "features")
        trainers = make_trainers(dev, "wavenet", tmp)
        out = [trainers[k].train_step(a) for k, a in (("k", a8), ("k2", a32))]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    expect(all(torch.equal(out[0][k], out[1][k]) for k in out[0]) and all(
        torch.equal(a, b) for a, b in zip(trainers["k"].model.net.parameters(),
                                          trainers["k2"].model.net.parameters())),
        "int8 wire: the train step differs from the float32 one on the dequantized features")
    say("int8 wire: the eval forward and a train step (kernels) equal bit for bit to the "
        "float32 path fed the dequantized features")
    for wire in ("float16", "bfloat16"):
        cfg = smoke_cfg(cli["runs"], sets=cli["sets"] + [
            ("tpu.feats_transfer_dtype", wire), ("trainer.num_epochs", "1"),
            ("trainer.eval_every", "100"), ("trainer.save_every", "100")])
        db = handel_dataset(cfg, train=True)
        trainer = SimpleTrainer(cfg, f"chip_wire_{wire}", db, create_model_from_cfg(cfg, db))
        trainer.train()
        (epoch,) = [json.loads(line) for line in open(trainer.run_folder / "events.jsonl")
                    if '"kind": "epoch"' in line]
        terms = {k: v for k, v in epoch.items() if k.endswith("loss") or k == "main"}
        expect(len(terms) == 5 and all(np.isfinite(v) for v in terms.values()),
               f"{wire} wire: epoch losses {terms}")
        say(f"{wire} wire: an epoch of {len(db)} videos, main loss {epoch['main']:.6f}, "
            f"{epoch['epoch_seconds']:.3f} s [{card}]")
    say(f"bytes a train batch (B={TRAIN_B}, T_pad={batch.feats.shape[1]}) copies to the card: "
        f"{json.dumps(sizes)}")


def accumulation_and_clips(dev, card: str, tmp: str) -> None:
    """`trainer.accumulate_grad_every=2` on two micro-batches of 4 videos:
    the kernel path's two backward passes and the apply against the plain
    path's from the same weights; then one kernel step against a plain
    step (`compare_steps`) for each clip mode: joint, per-parameter, none."""
    import torch
    from mucon_tpu_torch import cuda

    arrays = train_batch(np.random.default_rng(3), dev)
    micro = [{k: v[:4] for k, v in arrays.items()}, {k: v[4:] for k, v in arrays.items()}]
    trainers = make_trainers(dev, "wavenet", tmp, sets=[("trainer.accumulate_grad_every", "2")])
    before = {n: p.detach().clone() for n, p in trainers["k"].model.net.named_parameters()}
    losses, after = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for k in ("k", "p"):
            t = trainers[k]
            cuda.reset_launch_counts()
            losses[k] = []
            for at, a in enumerate(micro):
                t.iter_num = at
                losses[k].append({n: float(v) for n, v in t._backward(a, 2).items()})
            t._apply()
            torch.cuda.synchronize()
            if k == "k":
                launches = dict(cuda.launch_counts)
            after[k] = {n: p.detach().clone() for n, p in t.model.net.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(False)
    want = {name: 0 for name in cuda.KERNELS}
    want.update({name: 2 * n for name, n in PER_TRAIN_STEP.items()})
    expect(launches == want, f"accumulation: launches {launches} != {want}")
    for at in range(2):
        lk, lp = losses["k"][at], losses["p"][at]
        rel = max(abs(lk[n] - lp[n]) / max(abs(lp[n]), 1e-12) for n in lp)
        expect(rel <= 1e-4, f"accumulation micro-step {at + 1}: loss rel diff {rel}")
    check_step("accumulate_grad_every=2 at B=4, 2 micro-steps and the apply", losses["k"][-1],
               losses["p"][-1], before, after["k"], after["p"])
    absent = ("mstcnpp_stack", "wavenet_train_v2_fwd", "wavenet_train_v2_sweep")
    for mode, sets in (("joint", [("trainer.clip_grad_norm_separate", "False")]),
                       ("per-parameter", [("trainer.clip_grad_norm_separate", "False"),
                                          ("trainer.clip_grad_norm_every_param", "True")]),
                       ("none", [("trainer.clip_grad_norm", "False")])):
        compare_steps(f"clip {mode}", make_trainers(dev, "wavenet", tmp, sets=sets), arrays, 1,
                      TRAIN_KERNELS, absent, card)


def free_decode_training(dev, card: str, tmp: str, cli: dict) -> None:
    """`model.teacher_forcing=False`: three kernel steps against plain
    steps (`compare_steps`), each launching every train kernel but the
    decoder chain's; and a `TrainerForTFExperiments(turnoff_tf_after_epoch=1)`
    run of 2 epochs on the cli phase's data, the chain launched in epoch 1
    only."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli.common import create_model_from_cfg
    from mucon_tpu_torch.data import handel_dataset
    from mucon_tpu_torch.harness.trainer import SimpleTrainer, TrainerForTFExperiments

    arrays = train_batch(np.random.default_rng(4), dev)
    trainers = make_trainers(dev, "wavenet", tmp, sets=[("model.teacher_forcing", "False")])
    expect(not any(t.model.teacher_forcing for t in trainers.values()), "teacher forcing on")
    chain = ("decoder_chain_fwd", "decoder_chain_bwd")
    launches = compare_steps("free-decoding", trainers, arrays, TRAIN_STEPS,
                             [k for k in TRAIN_KERNELS if k not in chain],
                             chain + ("mstcnpp_stack", "wavenet_train_v2_fwd",
                                      "wavenet_train_v2_sweep"), card)
    want = {name: 0 for name in cuda.KERNELS}
    want.update({name: TRAIN_STEPS * n for name, n in PER_FREE_STEP.items()})
    expect(launches == want, f"free-decoding steps launched {launches} != {want}")
    say(f"free-decoding step: {json.dumps({k: v // TRAIN_STEPS for k, v in launches.items() if v})}"
        f" launches a step, no decoder chain")

    cfg = smoke_cfg(cli["runs"], sets=cli["sets"] + [
        ("trainer.num_epochs", "2"), ("trainer.eval_every", "100"),
        ("trainer.save_every", "100")])
    db = handel_dataset(cfg, train=True)
    trainer = TrainerForTFExperiments(cfg, "chip_tf", db, create_model_from_cfg(cfg, db),
                                      turnoff_tf_after_epoch=1)
    per_epoch = []
    one_epoch = SimpleTrainer._train_one_epoch

    def counted(self):
        cuda.reset_launch_counts()
        one_epoch(self)
        torch.cuda.synchronize()
        per_epoch.append((self.model.teacher_forcing, dict(cuda.launch_counts)))

    with mock.patch.object(SimpleTrainer, "_train_one_epoch", counted):
        trainer.train()
    steps = -(-len(db) // TRAIN_B)
    (tf0, l0), (tf1, l1) = per_epoch
    expect(tf0 and not tf1, f"TrainerForTFExperiments: teacher forcing {tf0}, {tf1}")
    for name in chain:
        expect(l0[name] == steps and l1[name] == 0,
               f"TrainerForTFExperiments: {name} launched {l0[name]}, {l1[name]} times")
    expect(all(l1[name] == steps * n for name, n in PER_FREE_STEP.items()),
           f"TrainerForTFExperiments: epoch 2 launches {l1}")
    say(f"TrainerForTFExperiments(turnoff_tf_after_epoch=1): the decoder chain launched "
        f"{l0['decoder_chain_fwd']} + {l0['decoder_chain_bwd']} times in epoch 1 "
        f"(teacher-forced) and 0 in epoch 2 (free decoding), {steps} steps each")


def run_report(tmp: str, cli: dict) -> None:
    """`inspect_run` and `write_report` on the cli phase's run folder."""
    import contextlib
    import io
    from pathlib import Path

    from mucon_tpu_torch.cli import inspect_run
    from mucon_tpu_torch.harness import write_report

    run = Path(cli["runs"]) / "chip_cli" / "0"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        inspect_run.inspect_run(run, show_videos=True)
    text = out.getvalue()
    for line in ("== config", "== training (events.jsonl)", "== metric series",
                 "== checkpoints", "== evaluator artifacts", "epochs logged: 2", "model.pt"):
        expect(line in text, f"inspect_run: no {line!r} in its output")
    html = write_report(run, Path(tmp) / "report.html").read_text()
    missing = [s for s in REPORT_SECTIONS if s not in html]
    expect(html and not missing, f"write_report: sections missing {missing}")
    say(f"inspect_run: {len(text.splitlines())} lines; write_report: {len(html)} bytes of "
        f"HTML with every section")


def trainer_options_phase(dev, card: str, tmp: str, cli: dict) -> None:
    """The device batch cache and prefetch, the feature wires, gradient
    accumulation and the clip modes, free-decode training and the run
    report, at full width on the cli phase's data and run folder."""
    t0 = time.perf_counter()
    cache_and_prefetch(card, cli)
    wire_checks(dev, card, tmp, cli)
    accumulation_and_clips(dev, card, tmp)
    free_decode_training(dev, card, tmp, cli)
    run_report(tmp, cli)
    say(f"trainer_options phase: {time.perf_counter() - t0:.1f} s [{card}]")


# -- phase 9: the bf16 compute path and the bf16-operand kernels ------------

def held_tight(name, got, ref) -> float:
    """A bf16-operand output against its bf16 twin: BF16_TWIN * max|twin| for
    all but a counted set (printed with its worst element), relative L2
    within BF16_TWIN_L2.  Returns the max abs err."""
    import torch

    diff = (got - ref).abs()
    err, scale = diff.max().item(), ref.abs().max().item()
    over = int((diff > BF16_TWIN * scale).sum())
    l2 = (torch.linalg.vector_norm(got - ref) /
          torch.linalg.vector_norm(ref).clamp_min(1e-30)).item()
    i = int(diff.argmax())
    expect(l2 <= BF16_TWIN_L2 and over <= BF16_FLIPS * ref.numel(),
           f"{name}: rel L2 {l2} (<= {BF16_TWIN_L2}), {over} elements flipped "
           f"(<= {BF16_FLIPS} of {ref.numel()}) against the bf16 twin")
    say(f"kernel {name}, first two layers: max abs err {err:.3e} ({err / scale:.2e} of "
        f"max|twin|); {over} of {ref.numel()} elements above {BF16_TWIN:g} * max|twin|"
        + (f", the worst {got.flatten()[i].item():.7g} vs {ref.flatten()[i].item():.7g}"
           if over else "") + f"; rel L2 {l2:.2e} <= {BF16_TWIN_L2:g}")
    return err


def held_contract(name, got, ref, what: str, grad: bool = False) -> str:
    """The JAX package's contract for the bf16-operand mode: an output within
    relative err < BF16_REL and cosine > BF16_COS of `ref`, a gradient
    cosine > BF16_GCOS and its norm within BF16_GNORM."""
    import torch

    cos = torch.nn.functional.cosine_similarity(got.flatten().double(),
                                                ref.flatten().double(), dim=0).item()
    if grad:
        na, nb = (torch.linalg.vector_norm(t.double()).item() for t in (got, ref))
        ratio = na / nb if nb > 1e-6 else 1.0
        expect(cos > BF16_GCOS and abs(ratio - 1.0) < BF16_GNORM,
               f"{name}: cosine {cos} / norm ratio {ratio} against {what}")
        return f"cos {cos:.5f}, norm ratio {ratio:.4f}"
    rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
    l2 = (torch.linalg.vector_norm(got - ref) /
          torch.linalg.vector_norm(ref).clamp_min(1e-30)).item()
    expect(rel < BF16_REL and cos > BF16_COS, f"{name}: rel {rel} / cosine {cos} against {what}")
    return f"rel {rel:.2e}, rel L2 {l2:.2e}, cosine {cos:.7f}"


def held_layers(ft, x, lengths, weights, masks, kw) -> float:
    """Each layer of the trainable forward in its bf16-operand mode against
    the twin's arithmetic on the kernel's own stash: nonlin(z) from the
    layer's input, and the layer's output from that input and the stashed
    nonlin(z) (rounded to bf16 as the kernel rounds it), both within
    BF16_TWIN * max|twin| on the valid rows.  Returns the largest err."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time, time_mask
    from mucon_tpu_torch.models.temporal import nonlinearity, pool2_time, shift_time
    from mucon_tpu_torch.ops.bf16 import matmul_bf16_plain as mm

    w3, b3, w1, b1, _, _ = weights

    def valid(t, ln):  # the stashes hold the rows t < length only
        m = time_mask(t.shape[1], ln, torch.bool)[:, :, None]
        return torch.where(m, t, torch.zeros((), device=t.device))

    with torch.no_grad():
        _, (xs, hs, us, x_fin) = cuda.wavenet_train_forward(
            mask_time(x, lengths), lengths, *weights, masks, mm_dtype=torch.bfloat16, **kw)
        outputs = [*xs[1:], x_fin]
        worst = worst_abs = 0.0
        ln = lengths
        for i, d in enumerate(ft.stages):
            xi = xs[i]
            z = (mm(shift_time(xi, -d), w3[i, 0]) + mm(xi, w3[i, 1])
                 + mm(shift_time(xi, d), w3[i, 2]) + b3[i])
            want_h = valid(nonlinearity(z, ft.leaky), ln)
            got_h = valid(hs[i], ln)
            want_u = valid((mm(got_h, w1[i]) + b1[i]) * masks[i] + xi, ln)
            pairs = [("nonlin(z)", got_h, want_h)]
            if i in ft.pooling_layers:
                got_u = valid(us[i], ln)
                ln = ln // 2
                pairs += [("u", got_u, want_u),
                          ("output", outputs[i],
                           valid(pool2_time(got_u, ft.pooling_type), ln))]
            else:
                pairs.append(("output", outputs[i], want_u))
            for what, got, want in pairs:
                err = (got - want).abs().max().item()
                bound = BF16_TWIN * want.abs().max().item()
                expect(err <= bound, f"wavenet_train_fwd_bf16 layer {i} {what}: max abs err "
                                     f"{err} > {bound}")
                worst = max(worst, err / max(want.abs().max().item(), 1e-30))
                worst_abs = max(worst_abs, err)
    say(f"kernel wavenet_train_fwd_bf16: every layer's nonlin(z) and output from its own "
        f"stashed operands within {worst:.2e} <= {BF16_TWIN:g} of max|twin|, element by element")
    return worst_abs


def first_layers(name, args, kw, n: int = 2):
    """The stack's first n layers and its out-projection: (args, kw)."""
    if name.startswith("wavenet"):
        x, lengths, w3, b3, w1, b1, wl, bl = args
        return ((x, lengths, w3[:n], b3[:n], w1[:n], b1[:n], wl, bl),
                dict(kw, stages=tuple(kw["stages"][:n]),
                     pooling_layers=tuple(p for p in kw["pooling_layers"] if p < n)))
    x, lengths, *w, wo, bo = args
    return (x, lengths, *(t[:n] for t in w), wo, bo), dict(
        kw, pooling_layers=tuple(p for p in kw["pooling_layers"] if p < n))


def check_bf16_eval_stacks(model, model_m, gen, dev) -> dict:
    """The eval stacks' bf16-operand mode (rows 1 and 12) at B=128, T=2560:
    the first two layers against the bf16 plain twin (`held_tight`), the
    whole stack against the twin and the 3xTF32 kernel (`held_contract`),
    timed against the 3xTF32 kernel after warm-up (in turns)."""
    import torch
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.mstcnpp_stack import (
        mstcnpp_stack, mstcnpp_stack_plain, pack_mstcnpp_params,
    )
    from mucon_tpu_torch.ops.wavenet_stack import (
        pack_wavenet_params, wavenet_stack, wavenet_stack_plain,
    )

    bf = torch.bfloat16
    out = {}
    for name, m, stack, plain, pack in (
            ("wavenet_layer_bf16", model, wavenet_stack, wavenet_stack_plain,
             pack_wavenet_params),
            ("mstcnpp_stack_bf16", model_m, mstcnpp_stack, mstcnpp_stack_plain,
             pack_mstcnpp_params)):
        ft = m.net.ft
        B, T, C = 128, 2560, ft.Conv1x1_0.kernel.shape[1]
        lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
        x = torch.randn(B, T, C, generator=gen) * 0.6
        x = (torch.relu(x) if name.startswith("wavenet") else x).to(dev)
        args = (mask_time(x, lengths), lengths, *pack(ft))
        if name.startswith("wavenet"):
            kw = dict(stages=ft.stages, pooling_layers=ft.pooling_layers,
                      pooling_type=ft.pooling_type, leaky=ft.leaky)
            n_layers = len(ft.stages)
            ops = stack_ops(C, ft.stages, ft.pooling_layers, lengths)[0]
        else:
            kw = dict(pooling_layers=ft.pooling_layers)
            n_layers = ft.num_layers
            rows, rows_fin = stack_rows(range(n_layers), ft.pooling_layers, lengths)
            ops = 16 * C * C * sum(rows) + 2 * C * C * rows_fin
        sh_args, sh_kw = first_layers(name, args, kw)
        err = held_tight(name, stack(*sh_args, mm_dtype=bf, **sh_kw)[0],
                         plain(*sh_args, mm_dtype=bf, **sh_kw)[0])
        zk, tk = stack(*args, mm_dtype=bf, **kw)
        zp, tp = plain(*args, mm_dtype=bf, **kw)
        z32, _ = stack(*args, **kw)
        expect(torch.equal(tk, tp), f"{name}: output lengths differ")
        vs_twin = held_contract(name, zk, zp, "the bf16 twin")
        vs_32 = held_contract(name, zk, z32, "the 3xTF32 kernel")
        ms, ms32 = paired_ms(lambda: stack(*args, mm_dtype=bf, **kw),
                             lambda: stack(*args, **kw), reps=5)
        plain_ms = cuda_ms(lambda: plain(*args, mm_dtype=bf, **kw), reps=3)
        dev_ms = device_ms(lambda: stack(*args, mm_dtype=bf, **kw))
        dev32 = device_ms(lambda: stack(*args, **kw))
        say(f"kernel {name} B={B} T={T} C={C} L={n_layers}: against the bf16 twin {vs_twin}; "
            f"against the 3xTF32 kernel {vs_32}; {ms:.3f} ms vs the 3xTF32 kernel {ms32:.3f} "
            f"ms (in turns) vs the bf16 twin {plain_ms:.3f} ms; device {dev_ms:.3f} ms vs "
            f"{dev32:.3f} ms")
        rows, rows_fin = stack_rows(range(n_layers), ft.pooling_layers, lengths)
        out[name] = report(err, ms, plain_ms, 4 * C * (rows[0] + rows_fin) + nbytes(*args[1:]),
                           ops, bf16=True)
        out[name].update(tf32x3_ms=ms32, device_ms=dev_ms, tf32x3_device_ms=dev32)
    return out


def check_bf16_train_stack(model, arrays, gen, dev) -> dict:
    """The trainable stack's bf16-operand mode (rows 5 and 6) at the train
    batch (B=8, T 1500-2100 padded to 2560, dropout 0.25), same masks and
    cotangent on every side: the first two layers' z and seven gradients
    against the bf16 plain twin under autograd, the 11 layers' against the
    twin and the 3xTF32 kernels, each kernel timed against its 3xTF32 one."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time
    from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )

    bf = torch.bfloat16
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
    weights = [w.detach().clone() for w in pack_wavenet_params(ft)]
    names = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")

    def fwd_bwd(fn, mm, n=None):
        ws, k, ms = weights, kw, masks
        if n is not None:
            (_, _, *ws), k = first_layers("wavenet", (x, lengths, *weights), kw, n)
            ms = masks[:n]
        g = torch.randn(B, stack_plan(k["stages"], k["pooling_layers"], T)[3], C,
                        generator=torch.Generator().manual_seed(n or 0)).to(dev)
        xs = [t.clone().requires_grad_() for t in (x, *ws)]
        z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=ms, mm_dtype=mm, **k)
        z.backward(g)
        return z.detach(), [t.grad for t in xs]

    fwd_err = held_layers(ft, x, lengths, weights, masks, kw)
    zk, gk = fwd_bwd(wavenet_stack_train, bf, 2)
    zp, gp = fwd_bwd(wavenet_stack_train_plain, bf, 2)
    held_tight("wavenet_train_fwd_bf16", zk, zp)
    bwd_err = held("wavenet_train_sweep_bf16 (first two layers)", list(zip(names, gk, gp)),
                   grads=True)
    over = [f"{n} {int(((a - b).abs() > BF16_TWIN * b.abs().max()).sum())}/{b.numel()}"
            for n, a, b in zip(names, gk, gp)]
    say("kernel wavenet_train_sweep_bf16, first two layers: elements above 1e-5 * max|twin|: "
        + ", ".join(over))
    zk, gk = fwd_bwd(wavenet_stack_train, bf)
    zp, gp = fwd_bwd(wavenet_stack_train_plain, bf)
    z32, g32 = fwd_bwd(wavenet_stack_train, None)
    lines = [f"z: {held_contract('wavenet_train_fwd_bf16', zk, zp, 'the bf16 twin')} / "
             f"{held_contract('wavenet_train_fwd_bf16', zk, z32, 'the 3xTF32 kernel')}"]
    for n, a, b, c in zip(names, gk, gp, g32):
        lines.append(f"{n}: {held_contract('wavenet_train_sweep_bf16 ' + n, a, b, 'the twin', True)}"
                     f" / {held_contract('wavenet_train_sweep_bf16 ' + n, a, c, '3xTF32', True)}")
    say(f"kernels wavenet_train_fwd_bf16 / wavenet_train_sweep_bf16, {len(ft.stages)} layers, "
        "against the bf16 twin / the 3xTF32 kernels: " + "; ".join(lines))

    g = torch.randn(B, t_fin, C, generator=gen).to(dev)
    w3, b3, w1, b1, wl, bl = weights
    xm = mask_time(x, lengths)
    _, stash = cuda.wavenet_train_forward(xm, lengths, *weights, masks, mm_dtype=bf, **kw)
    _, stash32 = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **kw)
    with torch.no_grad():
        fwd_ms = paired_ms(
            lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks, mm_dtype=bf, **kw),
            lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks, **kw), reps=5)
        fwd_plain = cuda_ms(lambda: wavenet_stack_train_plain(
            x, lengths, *weights, drop_masks=masks, mm_dtype=bf, **kw), reps=3)
    bwd_ms = paired_ms(
        lambda: cuda.wavenet_train_backward(g, stash, lengths, w3, w1, wl, masks, mm_dtype=bf,
                                            **kw),
        lambda: cuda.wavenet_train_backward(g, stash32, lengths, w3, w1, wl, masks, **kw),
        reps=5)
    xs = [t.clone().requires_grad_() for t in (x, *weights)]
    z_graph, _ = wavenet_stack_train_plain(xs[0], lengths, *xs[1:], drop_masks=masks,
                                           mm_dtype=bf, **kw)
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(z_graph, xs, g, retain_graph=True), reps=3)
    with torch.no_grad():
        fwd_dev = [device_ms(lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks,
                                                                mm_dtype=mm, **kw))
                   for mm in (bf, None)]
    bwd_dev = [device_ms(lambda: cuda.wavenet_train_backward(g, st, lengths, w3, w1, wl, masks,
                                                             mm_dtype=mm, **kw))
               for mm, st in ((bf, stash), (None, stash32))]
    say(f"kernel wavenet_train_fwd_bf16 B={B} T={T} dropout {DROP}: {fwd_ms[0]:.3f} ms vs the "
        f"3xTF32 kernel {fwd_ms[1]:.3f} ms (in turns) vs the bf16 twin {fwd_plain:.3f} ms, "
        f"device {fwd_dev[0]:.3f} vs {fwd_dev[1]:.3f} ms; wavenet_train_sweep_bf16 "
        f"{bwd_ms[0]:.3f} ms vs {bwd_ms[1]:.3f} ms vs the twin's autograd {bwd_plain:.3f} ms, "
        f"device {bwd_dev[0]:.3f} vs {bwd_dev[1]:.3f} ms")
    rows, rows_fin = stack_rows(ft.stages, ft.pooling_layers, lengths)
    pooled = sum(r for i, r in enumerate(rows) if i in ft.pooling_layers)
    fwd_moved = 4 * C * (3 * sum(rows) + 2 * rows_fin + pooled)
    bwd_moved = 4 * C * (2 * rows_fin + 3 * sum(rows) + pooled + rows[0])
    fwd_ops, bwd_ops = stack_ops(C, ft.stages, ft.pooling_layers, lengths)
    out = {"wavenet_train_fwd_bf16": report(fwd_err, fwd_ms[0], fwd_plain,
                                            fwd_moved + nbytes(*weights), fwd_ops, bf16=True),
           "wavenet_train_sweep_bf16": report(bwd_err, bwd_ms[0], bwd_plain,
                                              bwd_moved + 2 * nbytes(*weights), bwd_ops,
                                              bf16=True)}
    out["wavenet_train_fwd_bf16"].update(tf32x3_ms=fwd_ms[1], device_ms=fwd_dev[0],
                                         tf32x3_device_ms=fwd_dev[1])
    out["wavenet_train_sweep_bf16"].update(tf32x3_ms=bwd_ms[1], device_ms=bwd_dev[0],
                                           tf32x3_device_ms=bwd_dev[1])
    return out


class TwinStacks:
    """Inside: the model's stack, BiLSTM and flint kernels replaced by their
    plain twins on the same (CUDA) tensors, the routes unchanged: a step of
    the kernel path's arithmetic with no kernel (a comparison, not a path of
    the port)."""

    def __enter__(self):
        from mucon_tpu_torch.models import losses, lstm
        from mucon_tpu_torch.models import model as model_mod
        from mucon_tpu_torch.ops.lstm_recurrence import bilstm_recurrence_plain
        from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain
        from mucon_tpu_torch.ops.mucon_loss import mucon_flint_plain
        from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain
        from mucon_tpu_torch.ops.wavenet_stack_train import wavenet_stack_train_plain

        def train(x, lengths, *rest, **kw):
            *w, masks = rest
            return wavenet_stack_train_plain(x, lengths, *w, drop_masks=masks, **kw)

        self._patches = [
            mock.patch.object(model_mod, "wavenet_stack_train", train),
            mock.patch.object(model_mod, "wavenet_stack", wavenet_stack_plain),
            mock.patch.object(model_mod, "mstcnpp_stack", mstcnpp_stack_plain),
            mock.patch.object(lstm, "bilstm_recurrence_train", bilstm_recurrence_plain),
            mock.patch.object(lstm, "bilstm_recurrence", bilstm_recurrence_plain),
            mock.patch.object(losses, "mucon_flint", mucon_flint_plain),
        ]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def precision_trainers(dev, root: str, sets) -> dict:
    """Three trainers of the default model under the config overrides
    `sets`, from one seed, every kernel route on and the flint kernel: "k"
    and "k2" launch the kernels, "p" runs the same routes on the kernels'
    plain twins (`TwinStacks`)."""
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg

    out = {}
    for k in ("k", "k2", "p"):
        cfg = smoke_cfg(root, sets=[("tpu.batch_size", str(TRAIN_B)), *sets])
        cfg.tpu.use_pallas_loss = True
        model = create_model(M, N_MAX + 1, D, device=dev, seed=0,
                             loss_cfg=loss_config_from_cfg(cfg), **model_fields_from_cfg(cfg))
        out[k] = SimpleTrainer(cfg, f"precision_{k}", None, model, seed=1)
        out[k].on_start_epoch(0)
    twin_step = out["p"].train_step

    def step(arrays):
        with TwinStacks():
            return twin_step(arrays)

    out["p"].train_step = step
    return out


def routed_launches(trainer, arrays, evaluator_cfg) -> tuple:
    """One train step of `trainer` and one fused eval batch of its model
    under `evaluator_cfg`'s routes: (the step's launches, the eval's)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.routing import routes_from_cfg
    from mucon_tpu_torch.ops.eval_fused import build_fused_eval

    cuda.reset_launch_counts()
    trainer.train_step(arrays)
    torch.cuda.synchronize()
    step = {k: v for k, v in cuda.launch_counts.items() if v}
    run = build_fused_eval(trainer.model, frame_sampling=FRAME_SAMPLING,
                           use_kernels=routes_from_cfg(evaluator_cfg))
    cuda.reset_launch_counts()
    with torch.inference_mode():
        run(arrays)
    torch.cuda.synchronize()
    return step, {k: v for k, v in cuda.launch_counts.items() if v}


def flag_routes(dev, root: str, arrays) -> None:
    """Each `tpu.use_pallas*` flag off alone (the default f32 model, where
    every kernel has a route): a train step and an eval batch, its kernels
    launch no time and every other kernel as with every flag on."""
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg

    off_kernels = {
        None: (),
        "tpu.use_pallas": ("wavenet_train_fwd", "wavenet_train_sweep", "wavenet_layer",
                           "dense_viterbi"),
        "tpu.use_pallas_train": ("wavenet_train_fwd", "wavenet_train_sweep",
                                 "wavenet_layer:step"),
        "tpu.use_pallas_lstm": ("bilstm_recurrence",),
        "tpu.use_pallas_lstm_train": ("bilstm_train_fwd", "bilstm_train_bwd"),
        "tpu.use_pallas_decoder": ("decoder_chain_fwd", "decoder_chain_bwd"),
        "tpu.use_pallas_loss": ("mucon_flint",),
    }
    base = None
    for flag, gone in off_kernels.items():
        cfg = smoke_cfg(root, sets=[("tpu.batch_size", str(TRAIN_B))])
        cfg.tpu.use_pallas_loss = True
        if flag:  # after smoke_cfg, which sets every kernel flag
            cfg.tpu[flag.split(".")[1]] = False
        model = create_model(M, N_MAX + 1, D, device=dev, seed=0,
                             loss_cfg=loss_config_from_cfg(cfg), **model_fields_from_cfg(cfg))
        trainer = SimpleTrainer(cfg, "flags", None, model, seed=1)
        trainer.on_start_epoch(0)
        step, ev = routed_launches(trainer, arrays, cfg)
        if base is None:
            base = (step, ev)
            say(f"precision: every kernel flag on: a step launches {step}, an eval batch {ev}")
            continue
        want_step, want_ev = dict(base[0]), dict(base[1])
        for name in gone:
            kernel, _, only = name.partition(":")
            want_step.pop(kernel, None)
            if only != "step":
                want_ev.pop(kernel, None)
        expect((step, ev) == (want_step, want_ev),
               f"precision: {flag}=False launched {step} / {ev}, expected {want_step} / "
               f"{want_ev}")
        say(f"precision: {flag}=False alone: a step launches {step}, an eval batch {ev} "
            f"({', '.join(k.partition(':')[0] for k in gone)} no time)")


def precision_phase(dev, card: str, tmp: str, cli: dict) -> dict:
    """The bf16 compute path (`configs/tpu_batched.yaml`), the stack kernels'
    bf16-operand modes and the per-kernel routes: the four modes against
    their bf16 twins and the 3xTF32 kernels at full width, timed;
    `train_test_mucon` on the config (2 epochs with an eval each, the cli
    phase's data) with its launches by route and `test_mucon` within 1e-6;
    three bf16 kernel steps against steps of the same routes on the plain
    twins; the bf16-operand modes through a train step and the evals of
    both backbones (`tpu.kernel_mm_dtype=bfloat16`, their launches the
    kernel report's); each `tpu.use_pallas*` flag off alone; and a
    unidirectional encoder (no BiLSTM kernel).  Returns the report lines
    and the launches of the four modes."""
    import contextlib
    import dataclasses
    from pathlib import Path

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli import test_mucon, train_test_mucon
    from mucon_tpu_torch.cli.predict import predict_videos
    from mucon_tpu_torch.harness.evaluator import MuConEvaluator
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    model = create_model(M, N_MAX + 1, D, device=dev, seed=0)
    model_m = create_model(M, N_MAX + 1, D, ft_type="mstcnpp", device=dev, seed=0)
    with torch.inference_mode():
        results = check_bf16_eval_stacks(model, model_m, gen, dev)
    arrays = train_batch(np.random.default_rng(7), dev)
    results.update(check_bf16_train_stack(model, arrays, gen, dev))
    del model

    # train_test_mucon on configs/tpu_batched.yaml (bf16 compute, B=16, pad 512)
    config = Path(__file__).resolve().parent / "configs" / "tpu_batched.yaml"
    sets = [kv for kv in cli["sets"] if kv[0] != "tpu.batch_size"]
    argv = cli_argv(sets, "chip_bf16") + ["--cfg", str(config)]
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with open(cli["log"], "a") as f, contextlib.redirect_stdout(f):
        result = train_test_mucon.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.launch_counts.items() if v}
    fields = finite_fields("bf16 cli", result)
    run = Path(cli["runs"]) / "chip_bf16" / "0"
    cfg_run = json.loads((run / "config.yaml").read_text())
    expect(cfg_run["tpu"]["compute_dtype"] == "bfloat16" and cfg_run["tpu"]["batch_size"] == 16,
           "bf16 cli: the run's config is not configs/tpu_batched.yaml's")
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    kinds = [e["kind"] for e in events]
    steps = json.loads((run / "checkpoints" / "epoch_1" / "trainer_state.json").read_text())[
        "iter_num"]
    eval_batches = (kinds.count("eval_0") + kinds.count("final_eval")) * -(-len(cli["test_db"]) // 16)
    want = {}
    for k, n in PER_TRAIN_STEP.items():
        if not k.startswith("decoder_chain"):  # off under bf16 compute (model.py:222)
            want[k] = want.get(k, 0) + steps * n
    for k, n in PER_EVAL_BATCH.items():
        want[k] = want.get(k, 0) + eval_batches * n
    expect(launches == want, f"bf16 cli: launches {launches} != {want} implied by {steps} "
                             f"steps and {eval_batches} eval batches")
    say(f"precision: train_test_mucon --cfg configs/tpu_batched.yaml (B=16, pad 512, bf16 "
        f"compute): {steps} steps and {eval_batches} eval batches launched {launches}: the "
        f"stack kernels in 3xTF32 (kernel_mm_dtype auto), the BiLSTM kernels (f32 after the "
        f"GN), the decoder chain no time; run {run_s:.3f} s, epoch_seconds "
        f"{[round(e['epoch_seconds'], 3) for e in events if e['kind'] == 'epoch']} [{card}]")
    with open(cli["log"], "a") as f, contextlib.redirect_stdout(f):
        again = test_mucon.single_main("chip_bf16/0/1", root=cli["runs"])
    diff = max(float(np.max(np.abs(np.subtract(v, fields[k]))))
               for k, v in dataclasses.asdict(again).items())
    expect(diff <= 1e-6, f"bf16 cli: test_mucon differs from the run's result by {diff}")
    say(f"precision: test_mucon reproduces the bf16 run within {diff:.1e} <= 1e-6; {result}")

    # bf16 kernel steps against the same routes on the plain twins
    bf16 = [("tpu.compute_dtype", "bfloat16")]
    compare_steps("bf16", precision_trainers(dev, tmp, bf16), arrays, TRAIN_STEPS,
                  ("wavenet_layer", "wavenet_train_fwd", "wavenet_train_sweep",
                   "bilstm_train_fwd", "bilstm_train_bwd", "mucon_flint"),
                  ("decoder_chain_fwd", "decoder_chain_bwd", "wavenet_layer_bf16",
                   "wavenet_train_fwd_bf16", "wavenet_train_sweep_bf16"), card,
                  model_scale=True)

    # the bf16-operand modes on their paths: a train step and an eval batch
    # of the WaveNet model, a request of the MS-TCN++ model
    kmm = bf16 + [("tpu.kernel_mm_dtype", "bfloat16")]
    cfg = smoke_cfg(tmp, sets=[("tpu.batch_size", str(TRAIN_B)), *kmm])
    trainers = []
    for ft_type in ("wavenet", "mstcnpp"):
        cfg_t = smoke_cfg(tmp, sets=[("tpu.batch_size", str(TRAIN_B)), ("model.ft.type", ft_type),
                                     *kmm])
        m = create_model(M, N_MAX + 1, D, device=dev, seed=0,
                         loss_cfg=loss_config_from_cfg(cfg_t), **model_fields_from_cfg(cfg_t))
        trainers.append(SimpleTrainer(cfg_t, f"kmm_{ft_type}", None, m, seed=1))
    trainers[0].on_start_epoch(0)
    cuda.reset_launch_counts()
    trainers[0].train_step(arrays)
    ev = MuConEvaluator(cfg, cli["test_db"], trainers[0].model)
    ev.viterbi_mode(True)
    finite_fields("kernel_mm_dtype=bfloat16 eval", ev.evaluate())
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((int(t), D), dtype=np.float32) for t in (517, 1203, 2100)]
    with torch.inference_mode():
        predict_videos(trainers[1].model, feats, ["a", "b", "c"], vocab(),
                       frame_sampling=FRAME_SAMPLING, batch_size=3)
    torch.cuda.synchronize()
    modes = {k: v for k, v in cuda.launch_counts.items() if v}
    n_eval = -(-len(cli["test_db"]) // TRAIN_B)
    want = dict(wavenet_train_fwd_bf16=N_LAYERS, wavenet_train_sweep_bf16=N_LAYERS + 1,
                wavenet_layer_bf16=1 + n_eval * (N_LAYERS + 1), bilstm_train_fwd=1,
                bilstm_train_bwd=1, mucon_flint=1, bilstm_recurrence=n_eval + 1,
                dense_viterbi=n_eval + 1, mstcnpp_stack_bf16=N_LAYERS + 1)
    expect(modes == want, f"kernel_mm_dtype=bfloat16: launches {modes} != {want}")
    say(f"precision: tpu.kernel_mm_dtype=bfloat16 (bf16 compute): a train step, an eval of "
        f"{len(cli['test_db'])} videos and an MS-TCN++ request of 3 launched {modes}")

    flag_routes(dev, tmp, arrays)

    # a unidirectional encoder: no BiLSTM kernel, the rest on the kernels
    uni = [("tpu.batch_size", str(TRAIN_B)), ("model.fs.encoder.bidirectional", "False")]
    cfg_u = smoke_cfg(tmp, sets=uni)
    cfg_u.tpu.use_pallas_loss = True
    m = create_model(M, N_MAX + 1, D, device=dev, seed=0, loss_cfg=loss_config_from_cfg(cfg_u),
                     **model_fields_from_cfg(cfg_u))
    trainer = SimpleTrainer(cfg_u, "uni", None, m, seed=1)
    trainer.on_start_epoch(0)
    step, ev_l = routed_launches(trainer, arrays, cfg_u)
    want_step = dict(wavenet_train_fwd=N_LAYERS, wavenet_train_sweep=N_LAYERS + 1,
                     wavenet_layer=1, decoder_chain_fwd=1, decoder_chain_bwd=1, mucon_flint=1)
    want_ev = dict(wavenet_layer=N_LAYERS + 1, dense_viterbi=1)
    expect((step, ev_l) == (want_step, want_ev),
           f"unidirectional encoder: launched {step} / {ev_l}, expected {want_step} / {want_ev}")
    say(f"precision: fs.encoder.bidirectional=False: a step launches {step}, an eval batch "
        f"{ev_l} (no BiLSTM kernel)")
    say(f"precision phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return results, {k: modes[k] for k in results}

# -- phase 10: the kernels at other widths ------------------------------------

# The widths the `widths` phase holds every kernel to its twin at: the stack
# kernels' channels (48 runs zero-padded to the 128 instance; 256 and 512
# have their own tiles; 600, 768 and 1024 run on the wide bodies, 600
# zero-padded to 640) and the recurrences' hidden sizes (100 and 127 split
# unevenly over a cluster; 256 and 512 read some weights from L2 where
# registers and shared memory do not hold them; 768 and 1024 run on the
# wide kernels; the BiLSTM above 256 on its persistent kernels).
WIDTH_CS, WIDTH_HS = (48, 256, 512, 600, 768, 1024), (100, 127, 256, 512, 768, 1024)
# the default model's stack: 11 layers, pools after layers 1, 2, 4, 8 (max)
WIDTH_STAGES, WIDTH_POOLS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
# the two models the phase trains through train_test_mucon: config overrides
# and the same widths as `build_model` fields
WIDTH_CFGS = {
    "wide": ([("model.ft.hidden_size", "256"), ("model.fs.encoder.hidden_size", "256"),
              ("model.fs.decoder.hidden_size", "256")],
             dict(hidden_size=256, lstm_hidden_size=256)),
    "ragged": ([("model.ft.hidden_size", "48"), ("model.ft.last_gn_num_groups", "16"),
                ("model.fs.encoder.hidden_size", "100"), ("model.fs.decoder.hidden_size", "100")],
               dict(hidden_size=48, last_gn_num_groups=16, lstm_hidden_size=100)),
    "wide768": ([("model.ft.hidden_size", "768"), ("model.ft.last_gn_num_groups", "32"),
                 ("model.fs.encoder.hidden_size", "768"),
                 ("model.fs.decoder.hidden_size", "768")],
                dict(hidden_size=768, last_gn_num_groups=32, lstm_hidden_size=768)),
}
# the longest shapes, (H, B, Tz) at S = N_MAX + 1: the BiLSTM and the decoder
# chain at the JAX package's widest H, the reverse chain at long Tz (its
# tables in device memory)
LONG_BILSTM, LONG_CHAINS = (1447, 2, 40), ((1181, 2, 40), (128, 1, 2048), (768, 1, 1536))
# the DP past its warp body: frame_sampling 1 and 3 (L = 2000, 666) at
# request A's batch, and N = 300 positions ((K, N, L) at 6 videos); past a
# 16-CTA cluster, N = 300 at L = 2000 (frame_sampling 1), the shape the
# global body took before the position body replaced it
LONG_DP_SAMPLINGS, LONG_DP_N, LONG_DP_GLOBAL = (1, 3), (85, 300, 66), (40, 300, 2000)
# the flint loss past a CTA's shared memory, (B, M, N) at T = 2560: M = 600
# classes at one video, COIN's 778 step classes at the train batch, and N =
# 482 segments (chunks of segments as well as of classes)
LONG_FLINT = ((1, 600, 31), (8, 778, 31), (2, 48, 482))


def seeded(gen, dev, *shapes, scale: float = 1.0):
    """Seeded f32 tensors of `shapes` ((shape, fan_in) pairs) at scale /
    sqrt(fan_in), on dev: a model's weights at its init scale."""
    import torch

    return [(scale * torch.randn(*shape, generator=gen) / fan ** 0.5).to(dev)
            for shape, fan in shapes]


def wavenet_weights(C: int, gen, dev) -> list:
    """Packed WaveNet stack weights (w3, b3, w1, b1, w_last, b_last) at C."""
    L = len(WIDTH_STAGES)
    return seeded(gen, dev, ((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C),
                  ((L, C), 100), ((C, C), C), ((C,), 100))


def mstcnpp_weights(C: int, gen, dev) -> list:
    """Packed MS-TCN++ stage weights (w3a, b3a, w3b, b3b, w1t, w1b, b1,
    w_out, b_out) at C."""
    L = len(WIDTH_STAGES)
    return seeded(gen, dev, ((L, 3, C, C), 3 * C), ((L, C), 100), ((L, 3, C, C), 3 * C),
                  ((L, C), 100), ((L, C, C), 4 * C), ((L, C, C), 4 * C), ((L, C), 100),
                  ((C, C), C), ((C,), 100))


def width_line(key: str, width: str, line: dict, lines: dict) -> None:
    """A kernel's line at one width; its launches (0 until the phase's main
    path, `width_runs`, adds its own at this width) unless given."""
    lines.setdefault(key, []).append(dict({"width": width, "launches": 0}, **line))


def width_eval_stacks(gen, dev, card: str, lines: dict) -> None:
    """Rows 1 and 12 (the WaveNet eval stack, the MS-TCN++ stage) at each of
    WIDTH_CS, in 3xTF32 and in the bf16-operand mode, at the serving batch's
    B = 128 and half its length (T_pad = 1280, 750-1050 frames, so that the
    phase keeps to the smoke's time with the wide widths): against the
    plain twin at C = 128's bounds (FWD_BOUND; the bf16 mode by the JAX
    package's contract for 11 layers)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack, mstcnpp_stack_plain
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain

    B, T, L = 128, 1280, len(WIDTH_STAGES)
    lengths = torch.randint(750, 1051, (B,), generator=gen).to(dev)
    rows, rows_fin = stack_rows(WIDTH_STAGES, WIDTH_POOLS, lengths)
    for C in WIDTH_CS:
        x = mask_time(torch.relu(torch.randn(B, T, C, generator=gen) * 0.6).to(dev), lengths)
        wn, wm = wavenet_weights(C, gen, dev), mstcnpp_weights(C, gen, dev)
        kw_w = dict(stages=WIDTH_STAGES, pooling_layers=WIDTH_POOLS, pooling_type="max",
                    leaky=False)
        kw_m = dict(pooling_layers=WIDTH_POOLS)
        stacks = (("wavenet_layer", wavenet_stack, wavenet_stack_plain, wn, kw_w,
                   stack_ops(C, WIDTH_STAGES, WIDTH_POOLS, lengths)[0]),
                  ("mstcnpp_stack", mstcnpp_stack, mstcnpp_stack_plain, wm, kw_m,
                   16 * C * C * sum(rows) + 2 * C * C * rows_fin))
        for name, stack, plain, weights, kw, ops in stacks:
            for mm in (None, torch.bfloat16):
                key = name if mm is None else f"{name}_bf16"
                args = (x, lengths, *weights)
                before = dict(cuda.wide_launches)
                zk, tk = stack(*args, **kw, mm_dtype=mm)
                entries = {k: v - before[k] for k, v in cuda.wide_launches.items()
                           if v > before[k]}
                want = {"wavenet_layer": {"mucon_wgmma_layer": L, "mucon_wgmma_proj": 1},
                        "mstcnpp_stack": {"mucon_wgmma_mstcnpp_layer": L,
                                          "mucon_wgmma_proj": 1}}[name]
                expect(entries == (want if cuda.is_wide(cuda.stack_width(C)) else {}),
                       f"{key} C={C}: launched the entry points {entries}")
                zp, tp = plain(*args, **kw, mm_dtype=mm)
                expect(torch.equal(tk, tp) and zk.shape == zp.shape,
                       f"{key} C={C}: lengths or shape differ from the twin's")
                err = (zk - zp).abs().max().item()
                if mm is None:
                    bound = FWD_BOUND * zp.abs().max().item()
                    expect(err <= bound, f"{key} C={C}: max abs err {err} > {bound}")
                    detail = f"max abs err {err:.3e} <= {bound:.3e} ({FWD_BOUND:g} * max|plain|)"
                else:
                    detail = held_contract(f"{key} C={C}", zk, zp, "its bf16 twin")
                ms, plain_ms = paired_ms(lambda: stack(*args, **kw, mm_dtype=mm),
                                         lambda: plain(*args, **kw, mm_dtype=mm), reps=2)
                say(f"widths: kernel {key} B={B} T={T} C={C} (run at "
                    f"{cuda.stack_width(C)}) L={L}: {detail}; {ms:.3f} ms vs plain "
                    f"{plain_ms:.3f} ms; entry points {entries or 'narrow'} [{card}]")
                moved = 4 * C * (rows[0] + rows_fin) + nbytes(lengths, *weights)
                line = report(err, ms, plain_ms, moved, ops, tf32x3=mm is None,
                              bf16=mm is not None)
                if entries:  # the body and its C entry points' launches in one call
                    line.update(body="wgmma", source="mucon_tpu_torch/csrc/wavenet_wgmma.cu",
                                entry_launches=entries)
                width_line(key, f"C={C}", line, lines)
                del zk, zp
        del x


# The trainable stack's gradients through 11 layers at C = 256 and 512: on the
# H100 the f32 twin lay up to 1.2e-3 (relative L2; max abs up to 10%
# of max|dx|) from a float64 twin in dx and the weight gradients, and the
# 3xTF32 kernels as far on other data, where at C <= 128 both stay within
# 2e-6: the two f32 paths take the two sides of max-pool near-ties (the whole
# gradient of a pair sent to the other frame) and of ReLU kinks, more of
# them at a wider C.  Against the twin that compares the kernel's own
# pre-pool values in its max pools (`wavenet_stack_plain(pool_inputs=...)`)
# the kernel's dx still lay 9.3e-2 (max abs, 1.1x the C = 128 bound) and
# 5.8e-4 (relative L2) away.  So the sweep's gradients are held, at every
# width, against the float64 twin on the kernel's pool decisions: the
# kernel's relative L2 error within GRAD_BOUND, or within F64_FACTOR times
# the error of the f32 twin on the same decisions (f32 PyTorch's own
# accuracy on this data); the max abs errors of both are printed.
F64_FACTOR = 2.0


def rel_l2(got, ref) -> float:
    import torch

    return (torch.linalg.vector_norm((got - ref).double()) /
            torch.linalg.vector_norm(ref.double()).clamp_min(1e-30)).item()


def width_train_stacks(gen, dev, card: str, lines: dict) -> dict:
    """Rows 5, 6 (v3) and 13, 14 (v2) at 128 and each of WIDTH_CS, in 3xTF32
    and in the bf16-operand mode, at the train batch (B = 8, T 1500-2100
    padded to 2560, dropout DROP): z against the plain twin (FWD_BOUND), the
    seven gradients against the float64 twin on the kernel's pool decisions
    (the note above) -- the bf16 mode: z and the gradients by the JAX
    package's contract --, v2 equal to v3 bit for bit,
    each kernel timed beside the twin.  v2's path is one differentiable call,
    its counts reset just before.  Returns the report lines of the v2 bf16
    mode at C = 128 and its launches (rows "13 bf16" and "14 bf16")."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import dropout_mask, mask_time, time_mask
    from mucon_tpu_torch.ops.wavenet_stack_train import (
        stack_plan, wavenet_stack_train, wavenet_stack_train_plain,
    )
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import (
        chunk_bounds, wavenet_stack_train_v2,
    )

    B, T, L = TRAIN_B, 2560, len(WIDTH_STAGES)
    lengths = torch.randint(1500, 2101, (B,), generator=gen).to(dev)
    t_ins, _, _, t_fin = stack_plan(WIDTH_STAGES, WIDTH_POOLS, T)
    rows, rows_fin = stack_rows(WIDTH_STAGES, WIDTH_POOLS, lengths)
    pooled = sum(r for i, r in enumerate(rows) if i in WIDTH_POOLS)
    names = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")
    kw = dict(stages=WIDTH_STAGES, pooling_layers=WIDTH_POOLS, leaky=False)
    v3_kw = dict(kw, pooling_type="max")
    v2_kw = dict(kw, bounds=chunk_bounds(L, 3))
    mgen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for C in (128, *WIDTH_CS):
        x = torch.relu(torch.randn(B, T, C, generator=gen) * 0.6).to(dev)
        xm = mask_time(x, lengths)
        weights = wavenet_weights(C, gen, dev)
        w3, b3, w1, b1, wl, bl = weights
        masks = [dropout_mask(mgen, DROP, (B, t, C), dev) for t in t_ins]
        g = torch.randn(B, t_fin, C, generator=gen).to(dev)
        fwd_ops, bwd_ops = stack_ops(C, WIDTH_STAGES, WIDTH_POOLS, lengths)
        recompute_ops = 2 * C * C * pooled
        for mm in (None, torch.bfloat16):
            bf = mm is not None
            sfx = "_bf16" if bf else ""

            def fwd_bwd(fn, dtype=torch.float32, **extra):
                xs = [t.to(dtype).clone().requires_grad_() for t in (x, *weights)]
                z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=[m.to(dtype) for m in masks],
                          **kw, **extra)
                z.backward(g.to(dtype))
                return [z.detach(), *(t.grad for t in xs)]

            cuda.reset_launch_counts()
            got2 = fwd_bwd(wavenet_stack_train_v2, mm_dtype=mm)
            torch.cuda.synchronize()
            v2_launches = {k: cuda.launch_counts[k + sfx] for k in
                           ("wavenet_train_v2_fwd", "wavenet_train_v2_sweep")}
            expect(tuple(v2_launches.values()) == (3, 3),
                   f"v2{sfx} C={C}: launches {v2_launches}, expected 3 and 3")
            v2_entries = {k: v for k, v in cuda.wide_launches.items() if v}
            before = dict(cuda.wide_launches)
            got3 = fwd_bwd(wavenet_stack_train, pooling_type="max", mm_dtype=mm)
            v3_entries = {k: v - before[k] for k, v in cuda.wide_launches.items()
                          if v > before[k]}
            # above 512 channels every row on the `wgmma` entry points
            wide = cuda.is_wide(cuda.stack_width(C))
            want_v2 = {"mucon_wgt_v2_fwd": 3, "mucon_wgt_v2_sweep": 3} if wide else {}
            want_v3 = {"mucon_wgmma_layer": L, "mucon_wgmma_proj": 1,
                       "mucon_wgt_sweep": L + 1} if wide else {}
            expect(v2_entries == want_v2 and v3_entries == want_v3,
                   f"v3/v2{sfx} C={C}: launched the entry points {v3_entries} / {v2_entries}")
            # the v2 twin rounds the out-projection's gradient products in the
            # bf16 mode; v3's does where the last layer does not pool (here)
            ref = fwd_bwd(wavenet_stack_train_plain, pooling_type="max", mm_dtype=mm,
                          round_proj_grads=True if bf else None)
            differ = [n for n, a, b in zip(("z", *names), got2, got3) if not torch.equal(a, b)]
            expect(not differ, f"v2{sfx} C={C}: {differ} differ from v3's")
            tag = f"B={B} T={T} C={C} (run at {cuda.stack_width(C)}) L={L}"
            if bf:
                parts = [f"z {held_contract(f'v3/v2{sfx} z C={C}', got3[0], ref[0], 'twin')}"]
                parts += [f"{n} {held_contract(f'v3/v2{sfx} {n} C={C}', a, b, 'twin', grad=True)}"
                          for n, a, b in zip(names, got3[1:], ref[1:])]
                say(f"widths: kernels wavenet_train_fwd{sfx} / sweep{sfx} and v2 {tag}: "
                    + "; ".join(parts))
                fwd_err = (got3[0] - ref[0]).abs().max().item()
                bwd_err = max((a - b).abs().max().item() for a, b in zip(got3[1:], ref[1:]))
            else:
                fwd_err = held(f"wavenet_train_fwd/v2 {tag}", [("z", got3[0], ref[0])],
                               grads=False)
                _, stash = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3_kw)
                shifts = stack_plan(WIDTH_STAGES, WIDTH_POOLS, T)[2]
                # the stash's rows past a length are undefined (they may hold
                # a nan): selected away, not multiplied by 0
                pool_in = {i: torch.where(time_mask(u.shape[1], lengths >> shifts[i]).bool()[
                    ..., None], u[..., :C], 0.0) for i, u in stash[2].items()}
                del stash
                shared = fwd_bwd(wavenet_stack_train_plain, pooling_type="max",
                                 pool_inputs=pool_in)
                shared64 = fwd_bwd(wavenet_stack_train_plain, torch.float64, pooling_type="max",
                                   pool_inputs={i: u.double() for i, u in pool_in.items()})
                parts = []
                for n, a, b, r64 in zip(names, got3[1:], shared[1:], shared64[1:]):
                    k64, p64 = rel_l2(a, r64), rel_l2(b, r64)
                    expect(k64 <= max(GRAD_BOUND, F64_FACTOR * p64),
                           f"wavenet_train_sweep {tag} {n}: rel L2 {k64} from the float64 twin "
                           f"(the f32 twin's {p64})")
                    parts.append(f"{n} {k64:.2e} (f32 twin {p64:.2e}; max abs "
                                 f"{(a - r64).abs().max().item():.2e} / "
                                 f"{(b - r64).abs().max().item():.2e} of "
                                 f"{r64.abs().max().item():.2e})")
                say(f"widths: kernel wavenet_train_sweep {tag}: rel L2 from the float64 twin on "
                    f"the kernel's pool decisions within max({GRAD_BOUND:g}, {F64_FACTOR:g} x the "
                    f"f32 twin's): " + "; ".join(parts))
                bwd_err = max((a - r64).abs().max().item()
                              for a, r64 in zip(got3[1:], shared64[1:]))
                del shared, shared64, pool_in
            say(f"widths: v2{sfx} {tag}: z and the seven gradients equal v3's bit for bit; "
                f"entry points v3 {v3_entries or 'narrow'}, v2 {v2_entries or 'narrow'}")
            if C == 768:  # row 1 is row 5's forward without dropout, bit for bit
                with torch.no_grad():
                    z_eval, _ = wavenet_stack(xm, lengths, *weights, **v3_kw, mm_dtype=mm)
                    z_train, _ = cuda.wavenet_train_forward(xm, lengths, *weights, None,
                                                            **v3_kw, mm_dtype=mm)
                expect(torch.equal(z_eval, z_train),
                       f"C={C}{sfx}: the eval stack differs from the trainable forward "
                       "without dropout")
                say(f"widths: {tag}{' bf16' if bf else ''}: the eval stack (row 1) equals the "
                    f"trainable forward without dropout (row 5) bit for bit")
                del z_eval, z_train
            _, stash3 = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3_kw,
                                                   mm_dtype=mm)
            _, stash2 = cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2_kw,
                                                      mm_dtype=mm)
            xs = [t.clone().requires_grad_() for t in (x, *weights)]
            z_graph, _ = wavenet_stack_train_plain(xs[0], lengths, *xs[1:], drop_masks=masks,
                                                   **v3_kw, mm_dtype=mm)
            plain_fwd = lambda: wavenet_stack_train_plain(  # noqa: E731
                x, lengths, *weights, drop_masks=masks, **v3_kw, mm_dtype=mm)
            plain_bwd = lambda: torch.autograd.grad(z_graph, xs, g, retain_graph=True)  # noqa: E731
            with torch.no_grad():
                f3 = paired_ms(lambda: cuda.wavenet_train_forward(
                    xm, lengths, *weights, masks, **v3_kw, mm_dtype=mm), plain_fwd, reps=2)
                f2 = paired_ms(lambda: cuda.wavenet_train_v2_forward(
                    xm, lengths, *weights, masks, **v2_kw, mm_dtype=mm), plain_fwd, reps=2)
            s3 = paired_ms(lambda: cuda.wavenet_train_backward(
                g, stash3, lengths, w3, w1, wl, masks, **v3_kw, mm_dtype=mm), plain_bwd, reps=2)
            s2 = paired_ms(lambda: cuda.wavenet_train_v2_backward(
                g, stash2, lengths, w3, w1, b1, wl, masks, **v2_kw, mm_dtype=mm), plain_bwd,
                reps=2)
            say(f"widths: {tag}{' bf16' if bf else ''}: wavenet_train_fwd {f3[0]:.3f} ms, "
                f"v2 {f2[0]:.3f} ms vs plain {f3[1]:.3f} ms; wavenet_train_sweep "
                f"{s3[0]:.3f} ms, v2 {s2[0]:.3f} ms vs plain autograd {s3[1]:.3f} ms [{card}]")
            del xs, z_graph, stash3, stash2
            fwd_moved = 4 * C * (3 * sum(rows) + 2 * rows_fin + pooled) + nbytes(*weights)
            bwd_moved = 4 * C * (2 * rows_fin + 3 * sum(rows) + pooled + rows[0]) \
                + 2 * nbytes(*weights)
            fwd2_moved = 4 * C * (3 * sum(rows) + 2 * rows_fin) + nbytes(*weights)
            bwd2_moved = 4 * C * (2 * rows_fin + 3 * sum(rows) + rows[0]) + 2 * nbytes(*weights)
            rep = dict(tf32x3=not bf, bf16=bf)
            found = {
                f"wavenet_train_fwd{sfx}": report(fwd_err, *f3, fwd_moved, fwd_ops, **rep),
                f"wavenet_train_sweep{sfx}": report(bwd_err, *s3, bwd_moved, bwd_ops, **rep),
                f"wavenet_train_v2_fwd{sfx}": report(fwd_err, *f2, fwd2_moved, fwd_ops, **rep),
                f"wavenet_train_v2_sweep{sfx}": report(bwd_err, *s2, bwd2_moved,
                                                       bwd_ops + recompute_ops, **rep),
            }
            if wide:  # the body and its C entry points' launches in one call (v3's
                # forward on the eval stacks' entry points)
                src = "mucon_tpu_torch/csrc/wavenet_wgmma{}.cu".format
                split = {f"wavenet_train_fwd{sfx}": (("mucon_wgmma_layer", "mucon_wgmma_proj"),
                                                     src("")),
                         f"wavenet_train_sweep{sfx}": (("mucon_wgt_sweep",), src("_train")),
                         f"wavenet_train_v2_fwd{sfx}": (("mucon_wgt_v2_fwd",), src("_train")),
                         f"wavenet_train_v2_sweep{sfx}": (("mucon_wgt_v2_sweep",),
                                                          src("_train"))}
                for k, (names_k, source) in split.items():
                    entries = v2_entries if "v2" in k else v3_entries
                    found[k].update(body="wgmma", source=source,
                                    entry_launches={n: entries[n] for n in names_k})
            if C == 128:
                if bf:  # rows "13 bf16" and "14 bf16": the default width is their own line
                    for k in ("wavenet_train_v2_fwd", "wavenet_train_v2_sweep"):
                        out[k + sfx] = (found[k + sfx], v2_launches[k])
                continue
            for k, line in found.items():
                width_line(k, f"C={C}", dict(line, launches=v2_launches.get(
                    k.removesuffix("_bf16"), 0)) if "v2" in k else line, lines)
        del x, xm, masks, g, weights
    return out


def width_recurrences(gen, dev, card: str, lines: dict) -> None:
    """Rows 2, 7, 8 (the BiLSTM) and 9, 10 (the decoder chain) at each of
    WIDTH_HS: the eval recurrence at the serving batch (B = 128, Tz = 160)
    within 1e-5, as at H = 128; the train recurrence, its reverse chain and
    the decoder chain at the train batch (B = 8, Tz = 160, S = 31, E = 2H)
    against their twins under autograd (`held`), each kernel twice bit for
    bit, the replayed cells equal to the stashes bit for bit."""
    T = 160
    for H in WIDTH_HS:
        tz = bilstm_shape(gen, dev, card, lines, H, T, 128, TRAIN_B, f"H={H}")
        chain_shape(gen, dev, card, lines, H, TRAIN_B, T, tz, f"H={H}")


def bilstm_shape(gen, dev, card: str, lines: dict, H: int, T: int, B_eval: int, B: int,
                 width: str):
    """Rows 2, 7, 8 at hidden size H: the eval recurrence at B_eval videos
    of T steps within 1e-5 and twice bit for bit; the train recurrence and
    its reverse chain at B videos against their twins under autograd, the
    coefficient pass's cell equal to the stash.  Each a `width` line;
    returns the train batch's valid steps [B]."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.lstm_recurrence import (
        BiLSTMRecurrenceTrain, bilstm_recurrence, bilstm_recurrence_plain,
    )

    # w_hh at nn.LSTM's init scale, uniform in +-1/sqrt(H)
    w_hh = ((2 * torch.rand(2, H, 4 * H, generator=gen) - 1) / H ** 0.5).to(dev)
    fwd_plan, chain_plan = cuda.bilstm_fwd_plan(H), cuda.bilstm_chain_plan(H)
    order = (f"forward NK {fwd_plan[3]} x KC {fwd_plan[4]}, chain NQ {chain_plan[2]} x GPQ "
             f"{chain_plan[3]}")
    lo, hi = max(1, T * 1500 // 2560), max(1, T * 2100 // 2560)  # 1500-2100 of 2560 frames
    # eval
    xp = torch.randn(T, 2, B_eval, 4 * H, generator=gen).to(dev)
    tz = torch.randint(lo, hi + 1, (B_eval,), generator=gen)
    m = (torch.arange(T)[:, None] < tz[None, :]).to(torch.float32).to(dev)
    with torch.no_grad():
        outk = bilstm_recurrence(xp, m, w_hh)
        outp = bilstm_recurrence_plain(xp, m, w_hh)
        err = max((a - b).abs().max().item() for a, b in zip(outk, outp))
        expect(err <= 1e-5, f"bilstm_recurrence H={H}: max abs err {err} > 1e-5")
        expect(all(torch.equal(a, b) for a, b in zip(outk, bilstm_recurrence(xp, m, w_hh))),
               f"bilstm_recurrence H={H}: two calls differ")
        ms = paired_ms(lambda: bilstm_recurrence(xp, m, w_hh),
                       lambda: bilstm_recurrence_plain(xp, m, w_hh), reps=2)
    lib_ms = lstm_library_ms(torch.randn(B_eval, T, H, generator=gen).to(dev), tz, H, False)
    nv = int(m.sum())
    say(f"widths: kernel bilstm_recurrence Tz={T} B={B_eval} H={H}: max abs err {err:.3e} <= "
        f"1e-5, two calls bit for bit; {ms[0]:.3f} ms = {1000 * ms[0] / T:.2f} us/step vs "
        f"plain {ms[1]:.3f} ms, cuDNN nn.LSTM (with the input projection) {lib_ms:.3f} ms; "
        f"{order}; {bilstm_launch(B_eval, H)} [{card}]")
    width_line("bilstm_recurrence", width, report(
        err, *ms, 4 * 2 * nv * 4 * H + nbytes(m, w_hh, *outk), 2 * 2 * nv * H * 4 * H,
        lib_ms), lines)
    del xp, outk, outp
    # train
    xp = torch.randn(T, 2, B, 4 * H, generator=gen).to(dev)
    tz = torch.randint(lo, hi + 1, (B,), generator=gen)
    m = (torch.arange(T)[:, None] < tz[None, :]).to(torch.float32).to(dev)
    cts = [torch.randn(*s_, generator=gen).to(dev) for s_ in ((T, 2, B, H), (2, B, H),
                                                             (2, B, H))]
    with torch.no_grad():
        outk = cuda.bilstm_train_forward(xp, m, w_hh)
        outp = bilstm_recurrence_plain(xp, m, w_hh, stash=True)
        expect(all(torch.equal(a, b) for a, b in
                   zip(outk, cuda.bilstm_train_forward(xp, m, w_hh))),
               f"bilstm_train_fwd H={H}: two calls differ")
        _, cell = cuda.bilstm_bwd_coefs(xp, m, w_hh, outk[0], outk[3], cell=True)
        valid = m[:, None, :, None].expand_as(cell) > 0
        expect(torch.equal(cell[valid], outk[3][valid]),
               f"bilstm_train_bwd H={H}: the coefficient pass's cell differs from the stash")
        outs, _, _, cs = outk
        twice = [cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, *cts) for _ in range(2)]
        expect(torch.equal(*twice), f"bilstm_train_bwd H={H}: two calls differ")
    fwd_err = held(f"bilstm_train_fwd H={H}", list(zip(("outs", "h", "c", "cs"), outk, outp)),
                   grads=False)

    def fwd_bwd(fn):
        a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
        torch.autograd.backward(fn(a, m, w)[:3], cts)
        return a.grad, w.grad

    bwd_err = held(f"bilstm_train_bwd H={H}", list(zip(
        ("dxp", "dw_hh"), fwd_bwd(BiLSTMRecurrenceTrain.apply),
        fwd_bwd(bilstm_recurrence_plain))), grads=True)
    h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])
    a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
    graph = bilstm_recurrence_plain(a, m, w)
    with torch.no_grad():
        fms = paired_ms(lambda: cuda.bilstm_train_forward(xp, m, w_hh),
                        lambda: bilstm_recurrence_plain(xp, m, w_hh, stash=True), reps=2)
    bms = paired_ms(lambda: torch.einsum("tdbh,tdbg->dhg", h_prev, cuda.bilstm_train_backward(
        xp, m, w_hh, outs, cs, *cts)),
        lambda: torch.autograd.grad(graph, (a, w), cts, retain_graph=True), reps=2)
    x = torch.randn(B, T, H, generator=gen).to(dev)
    lib_ms = [lstm_library_ms(x, tz, H, backward) for backward in (False, True)]
    say(f"widths: kernels bilstm_train_fwd / bilstm_train_bwd Tz={T} B={B} H={H}: "
        f"{fms[0]:.3f} ms = {1000 * fms[0] / T:.2f} us/step vs plain {fms[1]:.3f} ms, cuDNN "
        f"forward {lib_ms[0]:.3f} ms; {bms[0]:.3f} ms vs plain autograd {bms[1]:.3f} ms, "
        f"cuDNN backward {lib_ms[1]:.3f} ms; the replayed cell equals the stash bit for bit; "
        f"forward {bilstm_launch(B, H)}; chain {bilstm_launch(B, H, chain=True)} [{card}]")
    nv = int(m.sum())
    step_ops = 2 * nv * 2 * H * 4 * H
    width_line("bilstm_train_fwd", width, report(
        fwd_err, *fms, 4 * 2 * nv * 4 * H + nbytes(m, w_hh, *outk), step_ops, lib_ms[0]),
        lines)
    width_line("bilstm_train_bwd", width, report(
        bwd_err, *bms, 4 * 2 * nv * 7 * H + nbytes(m, w_hh, *cts[1:], xp, w_hh),
        3 * step_ops, lib_ms[1]), lines)
    del a, w, graph, xp, outk, outp
    return tz


# the decoder chain's CUDA kernels on each route (`cuda.decoder_chain_route`)
# and their sources
CHAIN_KERNEL_OF = {"cluster": "chain_fwd_kernel", "persistent": "chain_persistent_fwd_kernel"}
CHAIN_REPLAY_OF = {"cluster": "chain_replay_kernel", "persistent": "chain_persistent_fwd_kernel"}
CHAIN_BWD_OF = {"cluster": "chain_bwd_kernel", "persistent": "chain_persistent_bwd_kernel"}
CHAIN_SOURCE = {"cluster": "mucon_tpu_torch/csrc/decoder_chain.cu",
                "persistent": "mucon_tpu_torch/csrc/decoder_persistent.cu"}


def chain_kernels_of(fn):
    """`fn()` and the decoder chain's CUDA kernels it launched, each with its
    launches (`cuda.chain_launches`, set to 0 just before)."""
    from mucon_tpu_torch import cuda

    for k in cuda.chain_launches:
        cuda.chain_launches[k] = 0
    out = fn()
    return out, {k: n for k, n in cuda.chain_launches.items() if n}


def chain_plan(B: int, H: int, E: int, T: int, route: str, reverse: bool) -> str:
    """A decoder chain launch's plan in a line: the cluster kernels' split,
    or the persistent kernel's grid, what its CTAs keep resident in shared
    memory and what they read from L2 every step."""
    from mucon_tpu_torch import cuda

    if route == "cluster":
        if reverse:
            cl, hs, nq, rq = cuda.decoder_chain_plan(H)
            return f"cluster chain of {cl} CTAs a video, HS {hs}, {nq} x {rq} dgate rows"
        launch = cuda.decoder_chain_fwd_launch(B, H, E, T)
        return (f"clusters of {launch['cl']} CTAs a video, weights "
                f"{'in shared memory' if launch['weights'] else 'from L2'}")
    p = cuda.decoder_chain_persistent_launch(B, H, E, T, reverse=reverse)
    if reverse:
        return (f"persistent chain, {p['ctas']} CTAs of {p['units']} units (co-resident "
                f"{p['co_resident']}), [Wih; Whh] rows {p['resident_wg']} of {2 * p['units']} "
                f"and Wl2 rows {p['resident_wl2']} of {p['units']} resident, the rest from L2 "
                f"each step; {p['nq']} x {p['rq']} dgate rows, {p['smem']} B shared")
    rp = cuda.decoder_chain_persistent_launch(31 * B, H, E, T)
    return (f"persistent, {p['ctas']} CTAs of {p['units']} units (co-resident "
            f"{p['co_resident']}), resident columns q {p['resident_q']}/{p['cols_q']}, cpre "
            f"{p['resident_cpre']}/{p['cols_cpre']}, gates {p['resident_gates']}/"
            f"{p['cols_gates']}, the rest from L2 each step; tiles of {p['tile']} items "
            f"({rp['tile']} for the replay's {31 * B}), {p['smem']} B shared; scores in blocks "
            f"of {p['frames_block']} frames, softmax partials in chunks of "
            f"{p['pair_channels']} channels ({rp['pair_channels']} for the replay)")


def chain_shape(gen, dev, card: str, lines: dict, H: int, B: int, T: int, tz, width: str):
    """Rows 9, 10 at hidden size H, B videos of T frames (tz valid), S = 31,
    E = 2H (the bidirectional encoder's states): the forward chain and the
    reverse chain (its replay's cell and relu(cpre) equal to the forward's
    stash) each twice bit for bit, `DecoderChain`'s input gradients against
    autograd of the plain twin, each a `width` line naming the kernels its
    first calls launched (the route's, by `cuda.chain_launches`)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.decoder_chain import DecoderChain, decoder_chain_plain

    S, E = N_MAX + 1, 2 * H
    maskf = (torch.arange(T)[None, :] < tz[:, None]).float()
    r = lambda *shape: 0.4 * torch.randn(*shape, generator=gen)  # noqa: E731
    wt = lambda k, *shape: torch.randn(*shape, generator=gen) / k ** 0.5  # noqa: E731
    args = [t.to(dev) for t in (
        torch.relu(r(S, B, H)), r(B, T, E) * maskf[:, :, None], r(B, T, H), maskf,
        r(B, H), r(B, H), wt(H, H, H), r(H), r(H), wt(H + E, H, H), wt(H + E, E, H), r(H),
        wt(2 * H, H, 4 * H), wt(2 * H, H, 4 * H), r(4 * H))]
    dcts = [torch.randn(S, B, H, generator=gen).to(dev) for _ in range(3)]
    route = cuda.decoder_chain_route(B, H, E, T)
    with torch.no_grad():
        outk, fwd_kernels = chain_kernels_of(lambda: cuda.decoder_chain_forward(*args))
        expect(fwd_kernels == {CHAIN_KERNEL_OF[route["fwd"]]: 1},
               f"decoder_chain_fwd H={H}: launched {fwd_kernels} on the {route['fwd']} route")
        expect(all(torch.equal(a_, b_) for a_, b_ in
                   zip(outk, cuda.decoder_chain_forward(*args))),
               f"decoder_chain_fwd H={H}: two calls differ")
        outp = decoder_chain_plain(*args)
        h_in = torch.cat([args[4][None], outk[0][:-1]])
        c_in = torch.cat([args[5][None], outk[1][:-1]])
        bargs = (*args[:4], h_in, c_in, *args[6:], *dcts)
        *replay, cell = cuda.decoder_chain_replay(*bargs[:15], count=False, cell=True)
        expect(torch.equal(torch.relu(replay[1]), outk[2]) and torch.equal(cell, outk[1]),
               f"decoder_chain_bwd H={H}: the replay's relu(cpre) or cell differs from the "
               f"stash")
        if route["fwd"] == "persistent":
            expect(all(torch.equal(a_, b_) for a_, b_ in zip(
                outk, cuda.decoder_chain_forward(*args, route="cluster"))),
                f"decoder_chain_fwd H={H}: the persistent kernel differs from the cluster one")
        (b1, b2), bwd_kernels = chain_kernels_of(lambda: (cuda.decoder_chain_backward(*bargs),
                                                          cuda.decoder_chain_backward(*bargs)))
        want = {CHAIN_REPLAY_OF[route["fwd"]]: 2}
        want[CHAIN_BWD_OF[route["bwd"]]] = want.get(CHAIN_BWD_OF[route["bwd"]], 0) + 2
        expect(bwd_kernels == want, f"decoder_chain_bwd H={H}: two calls launched "
                                    f"{bwd_kernels} on the route {route}")
        expect(all(torch.equal(a_, b_) for a_, b_ in zip(b1, b2)),
               f"decoder_chain_bwd H={H}: two calls differ")
        del b1, b2
    tag = f"B={B} S={S} Tz={T} H={H} E={E}"
    dfwd_err = held(f"decoder_chain_fwd {tag}", list(zip(("hs", "cs", "comb"), outk, outp)),
                    grads=False)

    def grads(fn):
        xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]  # not maskf
        torch.autograd.backward(fn(*xs), dcts)
        return [t.grad for i, t in enumerate(xs) if i != 3]

    gnames = ("emb", "enc", "pre", "h0", "c0", "wl2", "bl2", "v", "wc1", "wc2", "bc",
              "wih", "whh", "bl")
    dbwd_err = held(f"DecoderChain {tag} (input gradients)", list(zip(
        gnames, grads(DecoderChain.apply), grads(decoder_chain_plain))), grads=True)
    xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]
    graph = decoder_chain_plain(*xs)
    with torch.no_grad():
        dfms = paired_ms(lambda: cuda.decoder_chain_forward(*args),
                         lambda: decoder_chain_plain(*args), reps=2)
        dbk = cuda_ms(lambda: cuda.decoder_chain_backward(*bargs), reps=4)
    dbp = cuda_ms(lambda: torch.autograd.grad(
        graph, [t for i, t in enumerate(xs) if i != 3], dcts, retain_graph=True), reps=2)
    say(f"widths: kernels decoder_chain_fwd / decoder_chain_bwd {tag}: {dfms[0]:.3f} ms vs "
        f"plain {dfms[1]:.3f} ms; reverse chain {dbk:.3f} ms vs plain autograd {dbp:.3f} ms "
        f"(forward and replay: {chain_plan(B, H, E, T, route['fwd'], False)}; reverse chain: "
        f"{chain_plan(B, H, E, T, route['bwd'], True)}); two calls bit for bit, the replay's "
        f"cell and relu(cpre) equal the stash [{card}]")
    tzs = int(tz.sum())
    d_ops = S * (B * (18 * H * H + 2 * (H + E) * H + 10 * H) + tzs * (3 * H + 2 * E))
    d_bwd_ops = d_ops + S * (B * (18 * H * H + 2 * H * E + 20 * H)
                             + tzs * (2 * E + 4 * H + 3))
    tables = 4 * tzs * (E + H) + nbytes(maskf)
    width_line("decoder_chain_fwd", width, dict(report(
        dfwd_err, *dfms, tables + nbytes(*args[6:]) + nbytes(args[0], *args[4:6], *outk),
        d_ops), kernels=sorted(fwd_kernels), source=CHAIN_SOURCE[route["fwd"]]), lines)
    width_line("decoder_chain_bwd", width, dict(report(
        dbwd_err, dbk, dbp, tables + nbytes(*args[6:]) + nbytes(args[0], h_in, c_in, *dcts),
        d_bwd_ops), kernels=sorted(bwd_kernels), source=CHAIN_SOURCE[route["bwd"]]), lines)
    del xs, graph, args, outk, outp


def width_long_shapes(gen, dev, card: str, lines: dict) -> None:
    """The shapes past the narrow kernels' limits that the JAX kernels take:
    the BiLSTM at H = 1447 and the decoder chain at H = 1181 (LONG_BILSTM,
    LONG_CHAINS: a small B and Tz), the reverse chain at Tz = 2048 and 1536
    (B = 1: its tables in device memory), each held as at WIDTH_HS; the DP
    and walk at frame_sampling 1 and 3 (L = 2000, 666; request A's 128
    videos), at N = 300 (and there the position body forced) and at
    LONG_DP_GLOBAL (the position body), equal to the plain DP + walk bit for
    bit, each line naming its body."""
    import torch
    from mucon_tpu_torch import cuda

    H, B, T = LONG_BILSTM
    bilstm_shape(gen, dev, card, lines, H, T, B, B, f"H={H} B={B} Tz={T}")
    for H, B, T in LONG_CHAINS:
        tz = torch.randint(max(1, T * 1500 // 2560), T * 2100 // 2560 + 1, (B,), generator=gen)
        chain_shape(gen, dev, card, lines, H, B, T, tz, f"H={H} B={B} Tz={T}")
    for fs in LONG_DP_SAMPLINGS:
        args = (*viterbi_tables(gen, torch.randint(1500, 2101, (128,), generator=gen), 2560,
                                dev, fs), fs, MAX_LEN)
        dp_line(f"frame_sampling={fs}", args, f"L={MAX_LEN // fs} (frame_sampling {fs})",
                lines)
    K, N, L = LONG_DP_N
    args = viterbi_edge_args(K, N, L, FRAME_SAMPLING, MAX_LEN, gen, dev)
    dp_line(f"N={N}", args, f"N={N} L={L}", lines)
    position_forced(f"N={N}", args)
    K, N, L = LONG_DP_GLOBAL
    body = cuda.viterbi_plan(6, N, L, K)["body"]
    expect(body == "position", f"dense_viterbi N={N} L={L}: planned on the {body} body, not "
           "the position one")
    dp_line(f"N={N} L={L}", viterbi_edge_args(K, N, L, 1, MAX_LEN, gen, dev),
            f"N={N} L={L} K={K}", lines)
    say(f"widths: the DP's plans {[cuda.viterbi_plan(128, N_MAX, MAX_LEN // fs) for fs in LONG_DP_SAMPLINGS]}, "
        f"{cuda.viterbi_plan(6, N, L)} [{card}]")


def width_flint(gen, dev, card: str, lines: dict) -> None:
    """The flint kernel at LONG_FLINT, its window in chunks of classes and,
    at N = 482, of segments (`cuda.flint_plan`, the plan's bytes the kernel
    file's count; a line's chunks as planned): against
    `mucon_flint_plain` within FWD_BOUND, two calls bit for bit, timed
    beside the plain loss; a `width` line each."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.ops.mucon_loss import flint_prep, mucon_flint_plain

    T = 2560
    for B, Mf, N in LONG_FLINT:
        lengths_raw = (1.5 * torch.randn(B, N, generator=gen)).to(dev)
        seg = (2.0 * torch.randn(B, T, Mf, generator=gen)).to(dev)
        target = torch.randint(0, Mf, (B, N), generator=gen).to(dev)
        n_len = torch.randint(1, N + 1, (B,), generator=gen)
        n_len[0] = N
        t_valid = torch.randint(1500, T + 1, (B,), generator=gen)
        n_len, t_valid = n_len.to(dev), t_valid.to(dev)
        cw = torch.ones(Mf, device=dev)
        cw[0] = 0.5  # the background class weight of the default config
        tag = f"B={B} T={T} N={N} M={Mf}"
        with torch.no_grad():
            prep = flint_prep(lengths_raw, n_len, t_valid, 0.0)
            run = lambda: cuda.mucon_flint(*prep, seg, target, n_len, t_valid, cw)  # noqa: E731
            got = run()
            expect(torch.equal(got, run()), f"mucon_flint {tag}: two calls differ")
            want = mucon_flint_plain(lengths_raw, seg, target, n_len, t_valid, 0.0, cw)
            err = held(f"mucon_flint {tag}", [("loss", got, want)], grads=False)
            ms = paired_ms(run, lambda: mucon_flint_plain(lengths_raw, seg, target, n_len,
                                                          t_valid, 0.0, cw), reps=5)
        plan = cuda.flint_plan(B, T, N, Mf)
        expect(plan["smem"] == cuda.flint_smem(plan["nc"], plan["mc"]),
               f"mucon_flint {tag}: the plan's {plan['smem']} bytes are not the kernel's")
        expect(plan["chunks"] > 1 and (plan["nc"] < N) == (N > 31),
               f"mucon_flint {tag}: planned {plan['chunks']} chunks of {plan['nc']} segments")
        say(f"widths: kernel mucon_flint {tag}: {ms[0]:.4f} ms vs plain {ms[1]:.3f} ms; "
            f"{plan['chunks']} chunks of {plan['nc']} segments x {plan['mc']} classes, "
            f"{plan['smem']} B shared a CTA, clusters of {plan['width']}; two calls bit for "
            f"bit [{card}]")
        nl, tv = n_len.cpu().long(), t_valid.cpu().long()
        moved = 4 * int(tv.sum()) * Mf + nbytes(*prep, target, n_len, t_valid, cw) + 4 * B
        width_line("mucon_flint", f"M={Mf} N={N} B={B}",
                   dict(report(err, *ms, moved, int((nl * tv).sum()) * (10 + 2 * Mf)),
                        **{k: plan[k] for k in ("nc", "mc", "chunks")}), lines)


def dp_line(tag: str, args, width: str, lines: dict) -> None:
    """`check_decode` at a DP shape, and its `width` line (naming its body)."""
    from mucon_tpu_torch import cuda

    got, ms, plain_ms = check_decode(tag, args, reps=1)
    B, K, N = args[0].shape
    body = cuda.viterbi_plan(B, N, args[1].shape[2], K)["body"]
    width_line("dense_viterbi", f"{width} ({body} body)", dp_report(args, got, ms, plain_ms),
               lines)


def width_runs(dev, card: str, cli: dict, lines: dict) -> None:
    """`train_test_mucon` for each of WIDTH_CFGS on the cli phase's data,
    with the launches of its rows 1-3 and 5-11 as its steps and eval
    batches imply (the phase's main path: the launch counts of the width
    lines), `test_mucon` within 1e-6, and one kernel train step against a
    plain step from the same weights (`compare_steps`, the losses within
    1e-4, every parameter within 1e-2 of the model's largest update)."""
    import contextlib
    import dataclasses

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli import test_mucon, train_test_mucon
    from mucon_tpu_torch.data import handel_dataset

    test_db = handel_dataset(smoke_cfg(cli["runs"], sets=cli["sets"]), train=False)
    for tag, (sets, fields) in WIDTH_CFGS.items():
        exp = f"chip_widths_{tag}"
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with open(cli["log"], "a") as f, contextlib.redirect_stdout(f):
            result = train_test_mucon.main(cli_argv(cli["sets"] + sets, exp))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, chain_kernels = dict(cuda.launch_counts), dict(cuda.chain_launches)
        wide_entries = {k: v for k, v in cuda.wide_launches.items() if v}
        got = finite_fields(exp, result)
        run = os.path.join(cli["runs"], exp, "0")
        events = [json.loads(line) for line in open(os.path.join(run, "events.jsonl"))]
        kinds = [e["kind"] for e in events]
        steps = json.load(open(os.path.join(run, "checkpoints", "epoch_1",
                                            "trainer_state.json")))["iter_num"]
        batches = (kinds.count("eval_0") + kinds.count("final_eval")) * -(-len(test_db) // TRAIN_B)
        want = {k: 0 for k in cuda.KERNELS}
        for k, n in PER_TRAIN_STEP.items():
            want[k] += steps * n
        for k, n in PER_EVAL_BATCH.items():
            want[k] += batches * n
        expect(launches == want, f"widths {tag}: launches {launches} != {want} implied by "
                                 f"{steps} steps and {batches} eval batches")
        # each step's chain on its route (the cli batches' Tz = 160 at most):
        # the forward kernel, the replay pass on the forward's route, the chain
        H = fields["lstm_hidden_size"]
        route = cuda.decoder_chain_route(TRAIN_B, H, 2 * H, 160)
        want_chain = {k: 0 for k in cuda.CHAIN_KERNELS}
        for k in (CHAIN_KERNEL_OF[route["fwd"]], CHAIN_REPLAY_OF[route["fwd"]],
                  CHAIN_BWD_OF[route["bwd"]]):
            want_chain[k] += steps
        expect(chain_kernels == want_chain, f"widths {tag}: the decoder chain's kernels "
                                            f"{chain_kernels} != {want_chain}")
        # above 512 channels the eval batches' stacks and the train steps' on
        # the `wgmma` entry points (a step's out-projection a `mucon_wgmma_proj`)
        n = N_LAYERS
        want_entries = {} if not cuda.is_wide(cuda.stack_width(fields["hidden_size"])) else {
            "mucon_wgmma_layer": (batches + steps) * n, "mucon_wgmma_proj": batches + steps,
            "mucon_wgt_sweep": steps * (n + 1)}
        expect(wide_entries == want_entries, f"widths {tag}: the stacks' wide entry points "
                                             f"{wide_entries} != {want_entries}")
        with open(cli["log"], "a") as f, contextlib.redirect_stdout(f):
            again = test_mucon.single_main(f"{exp}/0/1", root=cli["runs"])
        diff = max(float(np.max(np.abs(np.subtract(v, got[k]))))
                   for k, v in dataclasses.asdict(again).items())
        expect(diff <= 1e-6, f"widths {tag}: test_mucon differs from the run by {diff}")
        say(f"widths: train_test_mucon {tag} ({', '.join(f'{k}={v}' for k, v in sets)}): "
            f"24 finite fields in {run_s:.1f} s, {steps} steps and {batches} eval batches "
            f"launched each kernel as often as they imply (the decoder chain's: "
            f"{ {k: v for k, v in chain_kernels.items() if v} }; the stacks' entry points "
            f"above 512 channels: {wide_entries or 'none'}); test_mucon within {diff:.1e} "
            f"[{card}]; {result}")
        C, H = fields["hidden_size"], fields["lstm_hidden_size"]
        for key, entries in lines.items():
            for entry in entries:
                if entry["width"] in (f"C={C}", f"H={H}") and "v2" not in key:
                    entry["launches"] = entry.get("launches", 0) + launches.get(key, 0)
        # model scale: on this batch the ragged model's kernel step takes the
        # other side of one ReLU kink of relu(cpre) (unit 59: column 59 of
        # attn_combine and its bias move by 14% of that tensor's largest
        # update, 4.5e-3 of the model's, on an H100), where batches
        # of four other seeds keep every tensor within 1e-2 of its own
        arrays = train_batch(np.random.default_rng(7), dev)
        compare_steps(f"widths {tag}", make_trainers(dev, "wavenet", cli["runs"], sets=sets,
                                                     fields=fields),
                      arrays, 1, TRAIN_KERNELS, STACK_KERNELS[3:], card, model_scale=True)
        del arrays


def widths_phase(dev, card: str, tmp: str, cli: dict) -> dict:
    """Every kernel at the widths the JAX kernels take beyond the default
    model's: the stack kernels at WIDTH_CS channels in both modes, the
    recurrences at WIDTH_HS, MS-TCN++ at C = 256 on the serving path, and
    `train_test_mucon` at the wide and ragged configurations.  Returns
    (the width lines of each kernel, the v2 bf16 mode's report lines and
    launches at the default width)."""
    import torch
    from mucon_tpu_torch.models.model import create_model

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(11)
    lines = {}
    with torch.no_grad():
        width_eval_stacks(gen, dev, card, lines)
    v2_bf16 = width_train_stacks(gen, dev, card, lines)
    width_recurrences(gen, dev, card, lines)
    width_long_shapes(gen, dev, card, lines)
    width_flint(gen, dev, card, lines)
    model_m = create_model(M, N_MAX + 1, D, ft_type="mstcnpp", device=dev, seed=0,
                           hidden_size=256, lstm_hidden_size=256)
    with torch.inference_mode():
        served = serve("MS-TCN++ C=256 H=256", model_m, dev, np.random.default_rng(2), card,
                       MSTCNPP_SERVING_KERNELS, absent=("wavenet_layer",), timed=False)
    del model_m
    for entry in lines["mstcnpp_stack"]:  # the serving path's launches at its width
        if entry["width"] == "C=256":
            entry["launches"] += served["mstcnpp_stack"]
    # requests A and B through both backbones at C = H = 768 (the wide bodies
    # and the wide BiLSTM), kernel against plain
    for name, ft, required, absent in (("WaveNet", "wavenet", SERVING_KERNELS, "mstcnpp_stack"),
                                       ("MS-TCN++", "mstcnpp", MSTCNPP_SERVING_KERNELS,
                                        "wavenet_layer")):
        model_w = create_model(M, N_MAX + 1, D, ft_type=ft, device=dev, seed=0,
                               hidden_size=768, last_gn_num_groups=32, lstm_hidden_size=768)
        with torch.inference_mode():
            served = serve(f"{name} C=768 H=768", model_w, dev, np.random.default_rng(3), card,
                           required, absent=(absent,), timed="A" if ft == "wavenet" else False)
        del model_w
        body = ("mucon_wgmma_layer" if ft == "wavenet" else "mucon_wgmma_mstcnpp_layer",
                "mucon_wgmma_proj")
        expect(all(served.get(k, 0) for k in body),
               f"{name} C=768: the eval stack's wgmma entry points {body} did not launch")
        for key, width in ((required[0], "C=768"), ("bilstm_recurrence", "H=768")):
            for entry in lines[key]:  # the serving path's launches at its width
                if entry["width"] == width:
                    entry["launches"] += served[key]
    width_runs(dev, card, cli, lines)
    say(f"widths phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return lines, v2_bf16


# -- phase 11: the mesh (data, seq and model axes over torch.distributed) -----

MESH_STEPS = 3
LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")
# the events' keys that are clocks, not results
CLOCK_KEYS = ("time", "epoch_seconds", "eval_seconds", "eval_phases", "videos_per_sec")


def run_logged(cmd, log, timeout: float) -> int:
    """Run `cmd` from the checkout's root in a session of its own, output to
    `log`, without the env of an enclosing launch; on a timeout kill the
    whole session and raise.  Returns the exit code."""
    import signal
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, env=env, stdout=f,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise


def mesh_cli_rank(out: str, argv: list) -> None:
    """One run of `train_test_mucon` for the `mesh` phase (under
    `torch.distributed.run` or alone): the entry point with `argv` under
    deterministic algorithms (an op without a deterministic version warns),
    then its 24 fields and the process's kernel launches as JSON in
    `out`."""
    import dataclasses

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.cli import train_test_mucon

    torch.use_deterministic_algorithms(True, warn_only=True)
    cuda.reset_launch_counts()
    result = train_test_mucon.main(argv)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump(dict(fields=dataclasses.asdict(result), launches=dict(cuda.launch_counts)), f)


def run_events(run) -> dict:
    """The results in a run folder's `epoch` and `eval_0` events, clocks
    dropped."""
    events = [json.loads(line) for line in open(run / "events.jsonl")]
    return {kind: [{k: v for k, v in e.items() if k not in CLOCK_KEYS}
                   for e in events if e["kind"] == kind] for kind in ("epoch", "eval_0")}


def max_diff(a, b) -> float:
    """The largest absolute difference of two nests of numbers (inf where
    their structure differs)."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return float("inf")
        return max([max_diff(a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return float("inf")
        return max([max_diff(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, str) or isinstance(b, str):
        return 0.0 if a == b else float("inf")
    return abs(float(a) - float(b))


def mesh_world_one(card: str, tmp: str, cli: dict) -> None:
    """`python -m torch.distributed.run --nproc-per-node 1 -m
    mucon_tpu_torch.cli.train_test_mucon` with the `cli` cell's flags and
    `tpu.mesh.enable`, `tpu.mesh.multihost`: a mesh of one rank over NCCL
    (its all-reduce a step and the eval's all-gather a batch run on the
    card).  Its kernel launches equal the `cli` run's, the regime line is
    logged, and the coordinator writes one checkpoint folder a save.  The
    `cli` run used PyTorch's default CUDA algorithms, which vary from run
    to run, so this run and a plain run of the same flags (no launcher, no
    mesh) both take deterministic algorithms: their epoch losses, evals
    and 24 fields must be equal bit for bit, and each within 1e-4
    (losses, relative) and 2e-3 (fields) of the `cli` run's."""
    from pathlib import Path

    def run(name: str, sets, launcher: bool) -> tuple:
        out, log = Path(tmp) / f"{name}.json", Path(tmp) / f"{name}.log"
        code = f"import chip_smoke; chip_smoke.mesh_cli_rank({str(out)!r}, " \
               f"{cli_argv(sets, name)!r})"
        cmd = [sys.executable, "-c", code]
        if launcher:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "1", "--no-python", *cmd]
        t0 = time.perf_counter()
        rc = run_logged(cmd, log, timeout=300)
        seconds = time.perf_counter() - t0
        text = log.read_text()
        expect(rc == 0, f"mesh: the {name} run exited {rc}:\n{text[-4000:]}")
        got = json.loads(out.read_text())
        got["events"] = run_events(Path(runs) / name / "0")
        return got, text, seconds

    runs = str(Path(tmp) / "mesh_runs")
    base = [kv for kv in cli["sets"] if kv[0] != "trainer.root"] + [("trainer.root", runs)]
    mesh_sets = base + [("tpu.mesh.enable", "True"), ("tpu.mesh.multihost", "True")]
    mesh, log, seconds = run("chip_mesh", mesh_sets, launcher=True)
    for line in ("torch.distributed initialized: rank 0 / 1 on nccl",
                 "sharded train step: data-parallel over the data axis (n_data=1, one "
                 "all-reduce a step on nccl), per-rank kernels active"):
        expect(line in log, f"mesh: {line!r} not logged")
    expect(mesh["launches"] == cli["launches"],
           f"mesh: launches {mesh['launches']} != the cli run's {cli['launches']}")
    ckpts = Path(runs) / "chip_mesh" / "0" / "checkpoints"
    saved = sorted(p.parent.name for p in ckpts.glob("epoch_*/model.pt"))
    expect(saved == ["epoch_0", "epoch_1"], f"mesh: checkpoints {saved}")
    say(f"mesh: torchrun world 1 over NCCL: {seconds:.3f} s (launcher, rank, NCCL init, "
        f"the run); launches equal the cli run's: "
        f"{json.dumps({k: v for k, v in mesh['launches'].items() if v})} [{card}]")
    ops = sorted({line.split("UserWarning: ")[-1].split(" does not have")[0]
                  for line in log.splitlines() if "does not have a deterministic" in line})
    say(f"mesh: ops without a deterministic CUDA version on the path: {ops or 'none'}")

    plain, _, plain_s = run("chip_plain", base, launcher=False)
    diff = max(max_diff(mesh["events"], plain["events"]),
               max_diff(mesh["fields"], plain["fields"]))
    expect(diff == 0.0, f"mesh: world 1 over NCCL differs from a plain run of the same flags "
                        f"by {diff:.3e}")
    say(f"mesh: world 1 over NCCL = a plain run of the same flags ({plain_s:.3f} s) bit for "
        f"bit, both under deterministic algorithms: epoch losses, per-epoch evals, the final "
        f"24 fields [{card}]")
    ref = run_events(Path(cli["runs"]) / "chip_cli" / "0")
    loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(mesh["events"]["epoch"], ref["epoch"]) for k in b
                   if isinstance(b[k], float))
    fields = max(max_diff(mesh["events"]["eval_0"], ref["eval_0"]),
                 max_diff(mesh["fields"], cli["fields"]))
    expect(loss_rel <= 1e-4 and fields <= 2e-3,
           f"mesh: against the cli run: losses {loss_rel:.3e} relative, fields {fields:.3e}")
    say(f"mesh: against the cli run (default algorithms): epoch losses within {loss_rel:.3e} "
        f"relative, eval fields within {fields:.3e}")


def dp_parts(dev):
    """The default model with every dropout rate 0 and the flint loss
    kernel, its SGD and its partitioned clip, as the `mesh` phase's two
    ranks and its single-process reference build them."""
    from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model

    cfg = smoke_cfg(tempfile.gettempdir())
    model = create_model(M, N_MAX + 1, D, device=dev, seed=0, dropout_rate=0.0,
                         last_dropout_rate=0.0, embedding_dropout=0.0,
                         loss_cfg=loss_config_from_cfg(cfg))
    tr = cfg.trainer
    opt = create_optimizer(model.net.parameters(), tr.optimizer, tr.learning_rate, tr.momentum,
                           tr.weight_decay)
    partition = model.param_partition()
    return model, opt, lambda: clip_gradients(tr, partition)


def mesh_dp_rank(rank: int, world: int, rdzv: str, out: str) -> None:
    """One of the `mesh` phase's gloo ranks on the one card: MESH_STEPS
    `make_sharded_train_step` kernel steps on its rows of the train batch,
    its launches, its weights before and after each step, then the ms of
    a step and of the gradient all-reduce alone (CUDA events)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.parallel.mesh import (
        all_reduce_mean_,
        make_mesh,
        make_sharded_train_step,
        shard_batch_arrays,
    )
    from mucon_tpu_torch.parallel.multihost import init_distributed

    init_distributed(rdzv, num_processes=world, process_id=rank, backend="gloo")
    dev = torch.device("cuda", 0)
    cuda.load()
    mesh = make_mesh()
    model, opt, clip = dp_parts(dev)
    step = make_sharded_train_step(model, opt, mesh, use_kernels=True, clip=clip)
    arrays = shard_batch_arrays(mesh, train_batch(np.random.default_rng(1), dev), dev)

    def params():
        return {n: p.detach().cpu().clone() for n, p in model.net.named_parameters()}

    snaps, losses = [params()], []
    torch.use_deterministic_algorithms(True)
    try:
        cuda.reset_launch_counts()
        for _ in range(MESH_STEPS):
            losses.append({k: float(v) for k, v in step(arrays).items()})
            snaps.append(params())
        torch.cuda.synchronize()
        launches = dict(cuda.launch_counts)
    finally:
        torch.use_deterministic_algorithms(False)
    step_ms = cuda_ms(lambda: step(arrays), reps=5)
    opt.zero_grad(set_to_none=True)
    model.loss(model.forward(arrays, train=True), arrays).main.backward()
    grads = [p.grad for p in model.net.parameters() if p.grad is not None]
    ar_ms = cuda_ms(lambda: all_reduce_mean_(grads, mesh), reps=5)
    torch.save(dict(losses=losses, snaps=snaps, launches=launches, step_ms=step_ms,
                    all_reduce_ms=ar_ms, rows=int(arrays["num_frames"].shape[0]),
                    grad_bytes=sum(g.numel() * g.element_size() for g in grads)), out)
    torch.distributed.destroy_process_group()


def mesh_two_ranks(dev, card: str, tmp: str) -> None:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), each with 4 of the train batch's 8 videos, against single-
    process kernel steps at B=8 from the same weights, by `check_step`'s
    rules (the update at the model's scale: the two halves' mean gradient
    sums in another order); the ranks' weights equal bit for bit.  gloo
    all-reduces and broadcasts CUDA tensors but gathers CPU tensors only,
    so the gathered eval runs on the card in `mesh_world_one` (NCCL)."""
    from pathlib import Path

    import torch
    from mucon_tpu_torch.parallel.mesh import make_sharded_train_step

    rdzv = Path(tmp) / "mesh_rdzv"
    outs = [Path(tmp) / f"mesh_rank{r}.pt" for r in range(2)]
    logs = [Path(tmp) / f"mesh_rank{r}.log" for r in range(2)]
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    procs, files = [], []
    try:
        for r in range(2):
            code = f"import chip_smoke; chip_smoke.mesh_dp_rank({r}, 2, " \
                   f"{('file://' + str(rdzv))!r}, {str(outs[r])!r})"
            files.append(open(logs[r], "w"))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          cwd=Path(__file__).resolve().parent,
                                          stdout=files[-1], stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    seconds = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        expect(rc == 0, f"mesh: gloo rank {r} exited {rc}:\n{logs[r].read_text()[-4000:]}")
    res = [torch.load(o, weights_only=True) for o in outs]
    expect(all(all(torch.equal(a[n], b[n]) for n in a)
               for a, b in zip(res[0]["snaps"], res[1]["snaps"])),
           "mesh: the two ranks' weights differ")
    expect(res[0]["losses"] == res[1]["losses"], "mesh: the ranks logged different losses")
    want = {name: MESH_STEPS * n for name, n in PER_TRAIN_STEP.items()}
    for r in res:
        got = {k: v for k, v in r["launches"].items() if v}
        expect(got == want, f"mesh: a rank's launches {got} != {want}")

    model, opt, clip = dp_parts(dev)
    step = make_sharded_train_step(model, opt, None, use_kernels=True, clip=clip)
    arrays = train_batch(np.random.default_rng(1), dev)
    torch.use_deterministic_algorithms(True)
    try:
        for at in range(MESH_STEPS):
            with torch.no_grad():
                for n, p in model.net.named_parameters():
                    p.copy_(res[0]["snaps"][at][n])
            lp = {k: float(v) for k, v in step(arrays).items()}
            after_p = {n: p.detach().cpu() for n, p in model.net.named_parameters()}
            check_step(f"mesh 2 gloo ranks x {res[0]['rows']} rows, step {at + 1}",
                       res[0]["losses"][at], lp, res[0]["snaps"][at], res[0]["snaps"][at + 1],
                       after_p, model_scale=True)
    finally:
        torch.use_deterministic_algorithms(False)
    single_ms = cuda_ms(lambda: step(arrays), reps=5)
    r0 = res[0]
    say(f"mesh: 2 gloo ranks on one card, {MESH_STEPS} kernel steps each: the ranks' weights "
        f"equal bit for bit, launches {json.dumps(want)} a rank; collectives on the card: "
        f"all_reduce (gradients, {r0['grad_bytes']} bytes a step, and the loss terms); the "
        f"eval's all_gather needs NCCL (world 1 above)")
    say(f"mesh: a DP step at {r0['rows']} rows a rank {r0['step_ms']:.3f} ms, of it the gloo "
        f"gradient all-reduce {r0['all_reduce_ms']:.3f} ms "
        f"({100 * r0['all_reduce_ms'] / r0['step_ms']:.1f}%); the single-process step at "
        f"B={TRAIN_B} {single_ms:.3f} ms; the two ranks' wall {seconds:.3f} s (start, build "
        f"load, steps, timing) [{card}]")
    say(f"mesh: BiLSTM forward plan at {r0['rows']} videos a rank: "
        f"{bilstm_launch(r0['rows'], 128)}; at B={TRAIN_B}: {bilstm_launch(TRAIN_B, 128)}")


def mesh_phase(dev, card: str, tmp: str, cli: dict) -> None:
    """The mesh (parallel/): the entry point at world size 1 over NCCL
    against the `cli` run, two gloo ranks' data-parallel train steps on
    the card against single-process steps, then the seq and model axes
    (`mesh_seq_model`); the phase's wall seconds."""
    t0 = time.perf_counter()
    mesh_world_one(card, tmp, cli)
    mesh_two_ranks(dev, card, tmp)
    t1 = time.perf_counter()
    mesh_seq_model(dev, card, tmp)
    say(f"mesh phase: {time.perf_counter() - t0:.3f} s, of it the seq / model meshes "
        f"{time.perf_counter() - t1:.3f} s [{card}]")


# the seq / model meshes of the `mesh` phase: (name, shape, batch) a world size
SP_RUNS = {2: (("1x2x1", (1, 2, 1), "train"), ("1x1x2", (1, 1, 2), "train"),
               ("long 1x2x1", (1, 2, 1), "long")),
           4: (("1x2x2", (1, 2, 2), "train"),),
           8: (("2x2x2 small", (2, 2, 2), "small"),)}
SP_LONG = 12288  # frames, the JAX package's long-video case (tests/test_parallel.py:534)
SMALL = dict(stages=(1, 2, 4), pooling_layers=(0, 1), hidden_size=16, last_gn_num_groups=4,
             lstm_hidden_size=16)  # tests/test_model.py small_cfg's widths
SP_FREE_STEPS = 6  # a rank's steps after the checked one: cuda_ms's 1 + 3, host, collectives
SP_KERNELS = ("bilstm_train_fwd", "bilstm_train_bwd", "decoder_chain_fwd", "decoder_chain_bwd",
              "mucon_flint")


def sp_routes():
    """The routes of a seq / model step: the stack kernels give way to the
    plain sharded stack; the kernels after the gather keep theirs."""
    from mucon_tpu_torch.models.routing import KernelRoutes

    return KernelRoutes(stack=False, stack_train=False)


def sp_parts(dev, small: bool):
    """`dp_parts`' model (every dropout 0, the flint loss kernel) at the
    default widths or, `small`, at small_cfg's; its optimizer config and
    clip groups."""
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model

    cfg = smoke_cfg(tempfile.gettempdir())
    model = create_model(M, N_MAX + 1, D, device=dev, seed=0, dropout_rate=0.0,
                         last_dropout_rate=0.0, embedding_dropout=0.0,
                         loss_cfg=loss_config_from_cfg(cfg), **(SMALL if small else {}))
    return model, cfg.trainer, model.param_partition()


def sp_batch(what: str):
    """Host tensors of a seq / model step's batch: the train batch, or one
    video of SP_LONG - 100 frames padded to SP_LONG."""
    from mucon_tpu_torch.cli.predict import collate_videos
    from mucon_tpu_torch.models.model import batch_to_tensors

    if what != "long":
        return train_batch(np.random.default_rng(1), "cpu")
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((SP_LONG - 100, D), dtype=np.float32)]
    return batch_to_tensors(collate_videos(feats, ["long"], vocab(), 2048,
                                           transcripts=[rng.integers(0, M, size=12)]), "cpu")


class CollectiveClock:
    """Host milliseconds spent in the collectives of the sharded step while
    it is entered, each call bracketed by a device sync: the all-gathers
    and point-to-point shifts (`parallel/transport.py`) and the
    all-reduces."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from mucon_tpu_torch.parallel import transport

        self.ms = {"all_gather": 0.0, "p2p": 0.0, "all_reduce": 0.0}
        self._saved = [(transport, "all_gather"), (transport, "send_recv"),
                       (dist, "all_reduce")]
        self._orig = [getattr(m, n) for m, n in self._saved]

        def clocked(fn, kind):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms[kind] += 1e3 * (time.perf_counter() - t0)
                return out
            return run

        for (m, n), fn, kind in zip(self._saved, self._orig, ("all_gather", "p2p", "all_reduce")):
            setattr(m, n, clocked(fn, kind))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self._saved, self._orig):
            setattr(m, n, fn)


def mesh_sp_rank(rank: int, world: int, rdzv: str, out: str) -> None:
    """One gloo rank on the one card for the seq / model meshes of
    SP_RUNS[world]: per mesh, the one-rank init split over "model" and
    broadcast, one step under deterministic algorithms (its loss terms,
    launches, bytes staged through the host, and the whole weights before
    and after, gathered over "model"), then the step's ms by CUDA events
    and by the host clock, and the collectives' ms within a step.  Those
    SP_FREE_STEPS timing steps run without deterministic algorithms (the
    card's gather / index backward adds with atomics, as a user's run
    does); after them the rank's coordinate and a digest of each of its
    own leaves."""
    import hashlib

    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer, local_norm_sq
    from mucon_tpu_torch.parallel import transport
    from mucon_tpu_torch.parallel.mesh import (
        broadcast_module,
        full_state,
        make_mesh,
        make_sharded_train_step,
        mesh_shape,
        model_norm_sq,
        shard_batch_arrays,
        shard_params,
    )
    from mucon_tpu_torch.parallel.multihost import init_distributed

    init_distributed(rdzv, num_processes=world, process_id=rank, backend="gloo")
    dev = torch.device("cuda", 0)
    cuda.load()
    results = {}
    for name, shape, what in SP_RUNS[world]:
        mesh = make_mesh(*shape)
        model, tr, partition = sp_parts(dev, what == "small")
        before = {n: p.detach().cpu().clone() for n, p in model.net.named_parameters()}
        norm_sq = local_norm_sq
        if mesh_shape(mesh)["model"] > 1:
            shard_params(mesh, model.net)
            norm_sq = model_norm_sq(model.net, mesh)
        broadcast_module(model.net, mesh)
        opt = create_optimizer(model.net.parameters(), tr.optimizer, tr.learning_rate,
                               tr.momentum, tr.weight_decay)
        step = make_sharded_train_step(model, opt, mesh, use_kernels=sp_routes(),
                                       clip=lambda: clip_gradients(tr, partition, norm_sq))
        arrays = shard_batch_arrays(mesh, sp_batch(what), dev)
        torch.use_deterministic_algorithms(True)
        try:
            cuda.reset_launch_counts()
            transport.reset_staged_bytes()
            losses = {k: float(v) for k, v in step(arrays).items()}
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda.launch_counts.items() if v}
            staged = dict(transport.staged_bytes)
        finally:
            torch.use_deterministic_algorithms(False)
        after = {k: v.detach().cpu() for k, v in full_state(model.net, opt, mesh)[0].items()}
        step_ms = cuda_ms(lambda: step(arrays), reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(arrays)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        with CollectiveClock() as clock:
            step(arrays)
        digests = {n: hashlib.sha256(p.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                                     .tobytes()).hexdigest()
                   for n, p in model.net.named_parameters()}
        results[name] = dict(losses=losses, launches=launches, staged=staged, before=before,
                             after=after, step_ms=step_ms, host_ms=host_ms, coll=clock.ms,
                             coord=tuple(mesh.get_coordinate()), digests=digests,
                             rows=int(arrays["num_frames"].shape[0]),
                             t_local=int(arrays["feats"].shape[1]))
    torch.save(results, out)
    torch.distributed.destroy_process_group()


def spawn_smoke_ranks(fn: str, world: int, tmp: str, timeout: float = 300) -> list:
    """`world` processes of `chip_smoke.<fn>(rank, world, rdzv, out)`, one
    gloo group through a file under `tmp`; their saved results in rank
    order, and the wall seconds."""
    from pathlib import Path

    import torch

    rdzv = Path(tmp) / f"{fn}_{world}_rdzv"
    outs = [Path(tmp) / f"{fn}_{world}_rank{r}.pt" for r in range(world)]
    logs = [Path(tmp) / f"{fn}_{world}_rank{r}.log" for r in range(world)]
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            code = f"import chip_smoke; chip_smoke.{fn}({r}, {world}, " \
                   f"{('file://' + str(rdzv))!r}, {str(outs[r])!r})"
            files.append(open(logs[r], "w"))
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          cwd=Path(__file__).resolve().parent,
                                          stdout=files[-1], stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for r, rc in enumerate(rcs):
        expect(rc == 0, f"mesh: gloo rank {r} of {world} exited {rc}:\n"
                        f"{logs[r].read_text()[-4000:]}")
    return [torch.load(o, weights_only=True) for o in outs], time.perf_counter() - t0


def mesh_seq_model(dev, card: str, tmp: str) -> None:
    """The seq and model axes: gloo ranks sharing the card run a step on
    the meshes of SP_RUNS (the default model on the train batch, on the
    long video, and small_cfg's widths on (2,2,2)); each step is held by
    `check_step` (model scale) to a one-rank step on the card from the same
    weights on the same routes (the stack plain, the kernels after the
    gather on), both under deterministic algorithms.  The replicated
    leaves and the gathered weights are equal on every rank; each rank
    launches SP_KERNELS once and no stack kernel.  After SP_FREE_STEPS more
    steps without deterministic algorithms every replicated leaf is still
    equal bit for bit on every rank, and every backbone leaf on every rank
    of its model column (`reduce_gradients` hands each replica the same
    mean).  Prints each step's ms, its collectives' ms and the bytes staged
    through the host."""
    import torch
    from mucon_tpu_torch.harness.optim import clip_gradients, create_optimizer
    from mucon_tpu_torch.parallel.mesh import is_sharded_leaf, make_sharded_train_step

    for world in sorted(SP_RUNS):
        res, seconds = spawn_smoke_ranks("mesh_sp_rank", world, tmp)
        say(f"mesh: {world} gloo ranks on one card: {seconds:.3f} s wall (start, load, "
            f"steps, timing) [{card}]")
        for name, shape, what in SP_RUNS[world]:
            r0 = res[0][name]
            for r in res[1:]:
                expect(r[name]["losses"] == r0["losses"],
                       f"mesh {name}: the ranks logged different losses")
                expect(all(torch.equal(r[name]["after"][n], v) for n, v in r0["after"].items()),
                       f"mesh {name}: the ranks' gathered weights differ")
            cols = {}
            for r in res:
                col = cols.setdefault(r[name]["coord"][2], r[name]["digests"])
                for n, h in r[name]["digests"].items():
                    want_h = col[n] if is_sharded_leaf(n) else r0["digests"][n]
                    expect(h == want_h, f"mesh {name}: after {SP_FREE_STEPS} steps without "
                           f"deterministic algorithms rank {r[name]['coord']}'s {n} differs "
                           "from its replicas'")
            say(f"mesh {name}: after {SP_FREE_STEPS} steps without deterministic algorithms "
                f"the {sum(not is_sharded_leaf(n) for n in r0['digests'])} replicated leaves "
                f"are equal bit for bit on all {len(res)} ranks, the "
                f"{sum(map(is_sharded_leaf, r0['digests']))} backbone leaves on every rank "
                f"of their model column")
            for r in res:
                want = {k: 1 for k in SP_KERNELS}
                expect(r[name]["launches"] == want,
                       f"mesh {name}: a rank's launches {r[name]['launches']} != {want}")
            model, tr, partition = sp_parts(dev, what == "small")
            opt = create_optimizer(model.net.parameters(), tr.optimizer, tr.learning_rate,
                                   tr.momentum, tr.weight_decay)
            step = make_sharded_train_step(model, opt, None, use_kernels=sp_routes(),
                                           clip=lambda: clip_gradients(tr, partition))
            with torch.no_grad():
                for n, p in model.net.named_parameters():
                    p.copy_(r0["before"][n])
            arrays = {k: v.to(dev) for k, v in sp_batch(what).items()}
            torch.use_deterministic_algorithms(True)
            try:
                lp = {k: float(v) for k, v in step(arrays).items()}
            finally:
                torch.use_deterministic_algorithms(False)
            after_p = {n: p.detach().cpu() for n, p in model.net.named_parameters()}
            check_step(f"mesh {name} (data, seq, model) = {shape}, {r0['rows']} rows x "
                       f"{r0['t_local']} frames a rank", r0["losses"], lp, r0["before"],
                       r0["after"], after_p, model_scale=True)
            one_ms = cuda_ms(lambda: step(arrays), reps=3)
            coll = ", ".join(f"{k} {v:.3f}" for k, v in r0["coll"].items())
            say(f"mesh {name}: a step {r0['step_ms']:.3f} ms by events, {r0['host_ms']:.3f} ms "
                f"by the host clock; its collectives (synced) {coll} ms; staged through the "
                f"host {json.dumps(r0['staged'])} bytes a step a rank; the one-rank step "
                f"{one_ms:.3f} ms [{card}]")
            del model, opt, step, arrays
            torch.cuda.empty_cache()


def native_check(card: str, calls: Optional[dict]) -> dict:
    """The native host kernels (mucon_tpu_torch/native): the library built
    and loaded, the `cli` phase's collates and metrics took it (`calls`,
    counted over that phase; None where no cli phase ran), and request A's collate of 128 videos of
    1500-2100 frames with the native pad-copies against numpy's: equal
    bytes, and both times."""
    from mucon_tpu_torch import native
    from mucon_tpu_torch.cli.predict import collate_videos

    expect(native.available(), f"native: the library did not load ({native._failed})")
    for name in ("pad_copy_f32", "pad_copy_i64_to_i32", "overlap_score", "levenshtein_matches",
                 "f_scores_multi", "edit_score_norm") if calls is not None else ():
        expect(calls.get(name, 0) > 0, f"native: the cli phase never called {name} ({calls})")
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((2100, D), dtype=np.float32)  # each video a leading slice
    feats = [pool[:int(t)] for t in rng.integers(1500, 2101, size=128)]
    names = [f"A_{i}" for i in range(128)]
    db = vocab()
    times = {}
    batches = {}
    for mode in ("native", "numpy"):
        if mode == "numpy":
            os.environ["MUCON_TPU_NO_NATIVE"] = "1"
        try:
            before = native.calls["pad_copy_f32"]
            t0 = time.perf_counter()
            batches[mode] = collate_videos(feats, names, db, 512)
            times[mode] = time.perf_counter() - t0
            expect((native.calls["pad_copy_f32"] > before) == (mode == "native"),
                   f"native: the {mode} collate took the wrong path")
        finally:
            os.environ.pop("MUCON_TPU_NO_NATIVE", None)
    a, b = batches["native"], batches["numpy"]
    for key in ("feats", "gt_label", "num_frames", "transcript", "tf_input", "tf_target"):
        x, y = getattr(a, key), getattr(b, key)
        expect(x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)),
               f"native: request A's collate differs from numpy's in {key}")
    counted = "" if calls is None else \
        f"the cli phase's native calls {json.dumps({k: v for k, v in calls.items() if v})}; "
    say(f"native: library {native.library_path().name} built (if not found) and loaded in "
        f"{native.load_seconds:.3f} s at its first use; {counted}request "
        f"A's collate (128 x {a.feats.shape[1]} x {D}, {a.feats.nbytes} bytes) native "
        f"{1e3 * times['native']:.3f} ms, numpy {1e3 * times['numpy']:.3f} ms, equal bytes "
        f"[{card}]")
    return dict(calls=calls, native_ms=1e3 * times["native"], numpy_ms=1e3 * times["numpy"])


def probe_widths() -> None:
    """The `cli` phase, then the `widths` phase alone (a shorter call on the
    card: `python3 -c 'import chip_smoke; chip_smoke.probe_widths()'`)."""
    import torch
    from mucon_tpu_torch import cuda

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    t0 = time.perf_counter()
    cuda.load()
    say(f"built {cuda.build().name} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="mucon_chip_widths_")
    try:
        cli = cli_phase(dev, smi, tmp)
        lines, v2_bf16 = widths_phase(dev, smi, tmp, cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({"widths": lines, "v2_bf16": v2_bf16}))


def probe_serving() -> None:
    """The `serving export` phase alone (a shorter call on the card:
    `python3 -c 'import chip_smoke; chip_smoke.probe_serving()'`)."""
    import torch
    from mucon_tpu_torch import cuda

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda.load()
    say(f"built {cuda.build().name} in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="mucon_chip_serving_")
    try:
        serving_export_phase(torch.device("cuda"), smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe_precision() -> None:
    """The `cli` phase, then the `precision` phase alone (a shorter call on
    the card: `python3 -c 'import chip_smoke; chip_smoke.probe_precision()'`)."""
    import torch
    from mucon_tpu_torch import cuda

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    t0 = time.perf_counter()
    cuda.load()
    say(f"built {cuda.build().name} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="mucon_chip_precision_")
    try:
        cli = cli_phase(dev, smi, tmp)
        results, launches = precision_phase(dev, smi, tmp, cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(json.dumps({k: dict(v, launches=launches[k]) for k, v in results.items()}))


def probe_seq_model() -> None:
    """The seq / model meshes of the `mesh` phase and the native request A
    collate alone (a short call on the card: `python3 -c 'import
    chip_smoke; chip_smoke.probe_seq_model()'`)."""
    import torch
    from mucon_tpu_torch import cuda

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"g++: {shutil.which('g++')}")
    t0 = time.perf_counter()
    cuda.load()
    say(f"built {cuda.build().name} in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="mucon_chip_sp_")
    try:
        t0 = time.perf_counter()
        mesh_seq_model(torch.device("cuda"), smi, tmp)
        say(f"seq / model meshes: {time.perf_counter() - t0:.3f} s [{smi}]")
        native_check(smi, None)  # no cli phase ran: no counts to check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe_mesh() -> None:
    """The `cli` phase, then the `mesh` phase alone (a shorter call on the
    card: `python3 -c 'import chip_smoke; chip_smoke.probe_mesh()'`)."""
    import torch
    from mucon_tpu_torch import cuda

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda.load()
    say(f"built {cuda.build().name} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="mucon_chip_mesh_")
    try:
        cli = cli_phase(dev, smi, tmp)
        mesh_phase(dev, smi, tmp, cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    from mucon_tpu_torch import cuda, native
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
        serving_export_phase(dev, smi, tmp)
        train_results, train_launches, arrays = train(dev, np.random.default_rng(1), smi,
                                                      tmp)
        results.update(train_results)
        launches.update({k: train_launches[k] for k in train_results})
        compare_steps("MS-TCN++", make_trainers(dev, "mstcnpp", tmp), arrays, MSTCNPP_STEPS,
                      MSTCNPP_TRAIN_KERNELS, STACK_KERNELS, smi, stages=True)
        del arrays
        native.reset_calls()
        cli = cli_phase(dev, smi, tmp)
        native_check(smi, dict(native.calls))
        mesh_phase(dev, smi, tmp, cli)
        variants_phase(dev, smi, tmp, cli)
        trainer_options_phase(dev, smi, tmp, cli)
        prec_results, prec_launches = precision_phase(dev, smi, tmp, cli)
        results.update(prec_results)
        launches.update(prec_launches)
        width_lines, v2_bf16 = widths_phase(dev, smi, tmp, cli)
        for name, (line, n) in v2_bf16.items():
            results[name], launches[name] = line, n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, line in results.items():
        source, replaces = REPLACES[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **line, widths=width_lines.get(name, [])))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
