#!/usr/bin/env python3
"""The trainable WaveNet stack above 512 channels (rows 5 and 6: v3's forward
and sweep; rows 13 and 14: v2's chunk launches) on one CUDA card: digests of
their outputs and their device times, to compare two trees.

    python3 scripts/probe_wide_train_wgmma.py OUT.json [--shapes 0,2] [--step]
    python3 scripts/probe_wide_train_wgmma.py OUT.json --errors
    python3 scripts/probe_wide_train_wgmma.py --quick
    python3 scripts/probe_wide_train_wgmma.py --sass
    python3 scripts/probe_wide_train_wgmma.py --bits

From the root of a checkout.  Seeded inputs (a CUDA `torch.Generator`, the
shape's index in SHAPES as the seed): the smoke's widths phase's train
batch, B = 8 videos of 1500-2100 frames at T_pad = 2560, the default
model's 11 layers with pools after 1, 2, 4, 8, dropout 0.25, at C = 600
(run at 640), 768 and 1024, through the public wrappers
(`cuda.wavenet_train_forward` / `_backward`, `cuda.wavenet_train_v2_forward`
/ `_backward` in chunks of 4 layers), in 3xTF32 and in the bf16-operand
mode, the same calls in every tree.  Writes to OUT.json, per shape and row:
the SHA-256 of the outputs (z; the seven gradients), the device ms of the
stack's kernels (`torch.profiler`, kernels whose name holds "wgt_",
"wg_pass" or "wide_"), of every kernel the call launches and the CUDA-event
wall ms of back-to-back calls, with the bound of `chip_smoke.report` (the
tensor cores at a third of the TF32 rate, the bf16 rate) and its share.
With `--step`, also the wide768 model's train step
(`SimpleTrainer.train_step` at C = H = 768, B = 8, T_pad = 2560): its ms and
the share of its device time in the stack's kernels.  `--errors` writes
instead the weight gradients' accuracy at C = 768 and 1024 in 3xTF32: the
relative L2 error against the float64 twin (on the kernel's pool decisions)
of each gradient of row 6, of the f32 twin and of the twin with TF32
matmuls (`torch.backends.cuda.matmul.allow_tf32`, a 1xTF32 control); and
the sum alone, free of the forward's rounding: dWl of a one-layer stack
without pooling (every valid row of B = 8 and 32 videos in one product)
against the float64 product of the same inputs, beside cuBLAS's in f32 and
TF32.
Prints each stack kernel's registers, stack and spill bytes from nvcc's
`-Xptxas -v` log.  Copy the script into another checkout's `scripts/` to
probe that tree with the same inputs.

`--sass`: the stack kernels' SASS (`cuobjdump -sass` of the built library):
a kernel's `HGMMA`s, its local-memory accesses (`LDL`, `STL`) and those
within 8 instructions of an `HGMMA`.

`--quick`: rows 5, 6, 13 and 14 once at small shapes (B = 3, T = 144 and
256, odd pooled lengths and an empty video, C = 640 and 768, both modes,
dropout 0 and 0.25) against their twins (z within FWD_BOUND; the gradients
within max(GRAD_BOUND, F64_FACTOR x the f32 twin's) relative L2 of the
float64 twin on the kernel's pool decisions; bf16: the JAX package's
contract), v2 equal to v3 and two calls equal bit for bit, the eval stack
equal to the forward without dropout; exits 1 if one is off.

`--bits`: does the eval stacks' `mucon_wgmma_layer` give the same h and y
bits as the trainable stack's `mucon_wide_layer` at C = 768 with no
dropout?  For a tree that has both, with their argument lists then: the
parent of the trainable stack's move to `wgmma`.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((600, 2560), (768, 2560), (1024, 2560))
STAGES, POOLS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
B, DROP, CHUNKS = 8, 0.25, 3
KERNEL_NAMES = ("wgt_", "wg_pass", "wide_")
GRAD_NAMES = ("dx", "dw3", "db3", "dw1", "db1", "dw_last", "db_last")


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(fn) -> dict:
    """Device ms a call of the stack's kernels and of every kernel the call
    launches (`torch.profiler`), and the CUDA-event ms a call of back-to-back
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = int(min(10, max(2, 0.5 / max(time.perf_counter() - t0, 1e-6))))
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
    kernels = {e.key[:80]: round(e.self_device_time_total / 1e3 / calls, 4) for e in events
               if any(k in e.key for k in KERNEL_NAMES)}
    return dict(device_ms=round(sum(kernels.values()), 4), call_device_ms=round(total, 4),
                wall_ms=round(wall_ms, 4), calls=calls, kernels=kernels)


def inputs(C: int, T: int, b: int, seed: int, dev, lo: int = 1500, hi: int = 2100,
           drop: float = DROP):
    """x [b x T x C] (ReLU'd), lengths, the stack's weights at their init
    scale, the dropout masks and gz, from a CUDA generator seeded with seed."""
    import torch
    from mucon_tpu_torch.models.layers import dropout_mask
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan

    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen, device=dev)
    x = torch.relu(0.6 * torch.randn(b, T, C, generator=gen, device=dev))
    L = len(STAGES)
    weights = [torch.randn(*shape, generator=gen, device=dev) / fan ** 0.5 for shape, fan in (
        ((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C), ((L, C), 100), ((C, C), C),
        ((C,), 100))]
    t_ins, _, _, t_fin = stack_plan(STAGES, POOLS, T)
    masks = None if not drop else [dropout_mask(gen, drop, (b, t, C), dev) for t in t_ins]
    g = torch.randn(b, t_fin, C, generator=gen, device=dev)
    return x, lengths, weights, masks, g


def rows(x, lengths, weights, masks, g, mm):
    """{row: call} of rows 5, 6, 13, 14 in the mode mm (the sweeps on a stash
    made once)."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

    w3, b3, w1, b1, wl, bl = weights
    xm = mask_time(x, lengths)
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, mm_dtype=mm)
    v3 = dict(kw, pooling_type="max")
    v2 = dict(kw, bounds=chunk_bounds(len(STAGES), CHUNKS))
    with torch.no_grad():
        _, stash3 = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3)
        _, stash2 = cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2)
    return {
        "5": lambda: cuda.wavenet_train_forward(xm, lengths, *weights, masks, **v3)[0],
        "6": lambda: cuda.wavenet_train_backward(g, stash3, lengths, w3, w1, wl, masks, **v3),
        "13": lambda: cuda.wavenet_train_v2_forward(xm, lengths, *weights, masks, **v2)[0],
        "14": lambda: cuda.wavenet_train_v2_backward(g, stash2, lengths, w3, w1, b1, wl, masks,
                                                     **v2),
    }


def outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def bounds(C: int, lengths, bf: bool) -> dict:
    """bound_ms of rows 5, 6, 13, 14 as the smoke's widths phase takes them."""
    import chip_smoke as cs

    fwd_ops, bwd_ops = cs.stack_ops(C, STAGES, POOLS, lengths)
    rows_, rows_fin = cs.stack_rows(STAGES, POOLS, lengths)
    pooled = sum(r for i, r in enumerate(rows_) if i in POOLS)
    rate = cs.BF16_OPS_PER_S if bf else cs.TF32_OPS_PER_S / 3
    ms = lambda ops: 1e3 * ops / rate  # noqa: E731  (the products bound these rows)
    return {"5": ms(fwd_ops), "6": ms(bwd_ops), "13": ms(fwd_ops),
            "14": ms(bwd_ops + 2 * C * C * pooled)}


def ptxas_lines() -> list:
    """nvcc's -Xptxas -v lines of the stack kernels."""
    from mucon_tpu_torch import cuda

    log = cuda.build().with_suffix(".log")
    keep, out = False, []
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("wgt_", "wg_pass", "wide_"))
        if keep and ("registers" in line or "spill" in line or "Compiling" in line):
            out.append(line.strip())
        elif "warning" in line.lower() and ("wgmma" in line or "setmaxnreg" in line):
            out.append(line.strip())
    return out


def attrs() -> dict:
    """The trainable stack's cooperative kernel: CTAs an SM, registers and
    local bytes a thread (`mucon_wgt_grid`)."""
    import ctypes
    from mucon_tpu_torch import cuda

    lib, got = cuda.load(), {}
    if hasattr(lib, "mucon_wgt_grid"):
        for bf16 in (0, 1):
            a = (ctypes.c_int * 5)()
            if lib.mucon_wgt_grid(bf16, a) == 0:
                got["bf16" if bf16 else "3xtf32"] = dict(ctas_per_sm=a[0], regs=a[3],
                                                         local_bytes=a[4])
    return got


def sass() -> dict:
    """{kernel: (HGMMAs, local accesses, local accesses within 8
    instructions of an HGMMA)} of the stack kernels in the built library."""
    import re
    from mucon_tpu_torch import cuda

    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(cuda.build())], capture_output=True,
                          text=True).stdout
    out, name, ins = {}, None, []

    def close():
        if name and any(k in name for k in KERNEL_NAMES):
            mma = [i for i, op in enumerate(ins) if op.startswith("HGMMA")]
            local = [i for i, op in enumerate(ins) if op.startswith(("LDL", "STL"))]
            near = [i for i in local if any(abs(i - j) <= 8 for j in mma)]
            out[name] = (len(mma), len(local), len(near))

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ins.append(m.group(1))
    close()
    return out


def errors(dev) -> dict:
    """Row 6's gradients at C = 768 and 1024 (3xTF32), the f32 twin's and
    the 1xTF32 control's, each as its relative L2 error against the float64
    twin on the kernel's pool decisions: {C: {who: {gradient: error}}}."""
    import torch

    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time, time_mask
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train_plain
    import chip_smoke as cs

    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, pooling_type="max")
    out = {}
    for k in (1, 2):
        C, T = SHAPES[k]
        x, lengths, weights, masks, g = inputs(C, T, B, k, dev)
        w3, _, w1, _, wl, _ = weights
        xm = mask_time(x, lengths)
        with torch.no_grad():
            _, stash = cuda.wavenet_train_forward(xm, lengths, *weights, masks, **kw)
            got = cuda.wavenet_train_backward(g, stash, lengths, w3, w1, wl, masks, **kw)
        shifts = stack_plan(STAGES, POOLS, T)[2]
        pool_in = {i: torch.where(time_mask(u.shape[1], lengths >> shifts[i]).bool()[..., None],
                                  u[..., :C], 0.0) for i, u in stash[2].items()}

        def twin(dtype):
            xs = [t.to(dtype).clone().requires_grad_() for t in (x, *weights)]
            z, _ = wavenet_stack_train_plain(
                xs[0], lengths, *xs[1:], drop_masks=[m.to(dtype) for m in masks],
                pool_inputs={i: u.to(dtype) for i, u in pool_in.items()}, **kw)
            z.backward(g.to(dtype))
            return [t.grad for t in xs]

        ref = twin(torch.float64)
        f32 = twin(torch.float32)
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = twin(torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        out[C] = {who: {n: cs.rel_l2(a, r) for n, a, r in zip(GRAD_NAMES, grads, ref)}
                  for who, grads in (("kernel", got), ("f32 twin", f32), ("1xtf32 twin", tf32))}
        for who, errs in out[C].items():
            print(f"errors C={C} {who}: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()),
                  flush=True)
        del x, weights, masks, g, stash, got, ref, f32, tf32
        torch.cuda.empty_cache()
    out["gemm"] = gemm_errors(dev)
    return out


def gemm_errors(dev) -> dict:
    """The weight gradients' sum alone: dWl = nonlin(x_fin)^T gz of a one-layer
    stack without pooling (every valid row of B x T_pad = 2560 in the sum), the
    kernel's, cuBLAS's in f32 and in TF32, each against the float64 product of
    the same x_fin (the kernel's stash) and gz: {f"C={C} B={b}": {who: error}}."""
    import torch

    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time, time_mask
    import chip_smoke as cs

    T, kw = 2560, dict(stages=(1,), pooling_layers=(), leaky=False, pooling_type="max")
    out = {}
    for C in (768, 1024):
        for b in (B, 4 * B):
            gen = torch.Generator(device=dev).manual_seed(C + b)
            lengths = torch.randint(1500, 2101, (b,), generator=gen, device=dev)
            x = mask_time(torch.relu(0.6 * torch.randn(b, T, C, generator=gen, device=dev)),
                          lengths)
            w = [torch.randn(*shape, generator=gen, device=dev) / fan ** 0.5 for shape, fan in (
                ((1, 3, C, C), 3 * C), ((1, C), 100), ((1, C, C), 2 * C), ((1, C), 100),
                ((C, C), C), ((C,), 100))]
            gz = mask_time(torch.randn(b, T, C, generator=gen, device=dev), lengths)
            with torch.no_grad():
                _, stash = cuda.wavenet_train_forward(x, lengths, *w, None, **kw)
                got = cuda.wavenet_train_backward(gz, stash, lengths, w[0], w[2], w[4], None,
                                                  **kw)[5]
            live = time_mask(T, lengths).bool()[..., None]
            a = torch.where(live, torch.relu(stash[3]), 0.0).reshape(-1, C)
            gv = torch.where(live, gz, 0.0).reshape(-1, C)
            ref = a.double().t() @ gv.double()
            keep = torch.backends.cuda.matmul.allow_tf32
            errs = {"kernel": cs.rel_l2(got, ref)}
            try:
                for who, tf32 in (("f32 cuBLAS", False), ("1xtf32 cuBLAS", True)):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    errs[who] = cs.rel_l2(a.t() @ gv, ref)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = keep
            rows = int(torch.minimum(lengths, torch.tensor(T, device=dev)).sum())
            parts = cuda.wide_parts(C, 1) if hasattr(cuda, "wide_parts") else None  # (a parent)
            out[f"C={C} B={b}"] = dict(errs, rows=rows, parts=parts)
            print(f"errors dWl alone C={C} B={b} ({rows} rows, {out[f'C={C} B={b}']['parts']} "
                  "parts): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
            del x, w, gz, stash, got, a, gv, ref
            torch.cuda.empty_cache()
    return out


def train_step(dev) -> dict:
    """The wide768 model's train step (`SimpleTrainer.train_step`, C = H =
    768 as the smoke's `WIDTH_CFGS["wide768"]`, B = 8 videos at T_pad =
    2560): ms a step (CUDA events, after two warm steps) and its device time
    by kernel, with the share in the stack's kernels."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from mucon_tpu_torch.harness.trainer import SimpleTrainer
    from mucon_tpu_torch.models.losses import loss_config_from_cfg
    from mucon_tpu_torch.models.model import create_model, model_fields_from_cfg

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    sets, _ = cs.WIDTH_CFGS["wide768"]
    cfg = cs.smoke_cfg(tmp, sets=[("tpu.batch_size", str(B)), *sets])
    cfg.tpu.use_pallas_loss = True
    m = create_model(cs.M, cs.N_MAX + 1, cs.D, device=dev, seed=0,
                     loss_cfg=loss_config_from_cfg(cfg), **model_fields_from_cfg(cfg))
    trainer = SimpleTrainer(cfg, "probe", None, m, seed=1)
    trainer.on_start_epoch(0)
    arrays = cs.train_batch(np.random.default_rng(0), dev)
    for _ in range(2):
        trainer.train_step(arrays)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    steps = 5
    start.record()
    for _ in range(steps):
        trainer.train_step(arrays)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(arrays)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3
    stack = sum(e.self_device_time_total for e in events
                if any(k in e.key for k in KERNEL_NAMES)) / 1e3
    return dict(step_ms=round(start.elapsed_time(end) / steps, 3),
                device_ms=round(total, 3), stack_ms=round(stack, 3),
                stack_share=round(stack / total, 4) if total else None)


def bits(C: int = 768, b: int = 8, T: int = 1280) -> dict:
    """`mucon_wgmma_layer` against `mucon_wide_layer` (no dropout), h and y."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(C)
    lengths = torch.randint(T // 2, T + 1, (b,), generator=gen, device=dev)
    x = mask_time(torch.relu(0.6 * torch.randn(b, T, C, generator=gen, device=dev)), lengths)
    w3 = torch.randn(1, 3, C, C, generator=gen, device=dev) / (3 * C) ** 0.5
    w1 = torch.randn(1, C, C, generator=gen, device=dev) / (2 * C) ** 0.5
    b3 = torch.randn(1, C, generator=gen, device=dev) / 10
    b1 = torch.randn(1, C, generator=gen, device=dev) / 10
    wl = torch.randn(C, C, generator=gen, device=dev) / C ** 0.5
    lib, stream = cuda.load(), torch.cuda.current_stream().cuda_stream
    lens = lengths.to(torch.int32)
    out = {}
    for bf16 in (0, 1):
        planes = cuda.wgmma_planes(cuda.wavenet_wgmma_blocks(w3, w1, wl), bool(bf16))
        for d, pool in ((4, 0), (16, 1)):
            got = {}
            for name in ("wgmma", "wide"):
                h = torch.zeros(b, T, C, device=dev)
                y = torch.zeros(b, T // 2 if pool else T, C, device=dev)
                if name == "wgmma":
                    err = lib.mucon_wgmma_layer(x.data_ptr(), y.data_ptr(), h.data_ptr(),
                                                lens.data_ptr(), planes.data_ptr(),
                                                planes.shape[1], 0, b3.data_ptr(),
                                                b1.data_ptr(), b, T, C, d, 0, pool, 0, 0,
                                                bf16, stream)
                else:
                    err = lib.mucon_wide_layer(x.data_ptr(), y.data_ptr(), 0, h.data_ptr(),
                                               lens.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                                               w1.data_ptr(), b1.data_ptr(), 0, b, T, C, d,
                                               0, pool, 0, 0, bf16, stream)
                assert err == 0, err
                torch.cuda.synchronize()
                live = torch.arange(T, device=dev)[None, :] < lengths[:, None]
                got[name] = (h * live[..., None], y)
            (h0, y0), (h1, y1) = got["wgmma"], got["wide"]
            out[f"{'bf16' if bf16 else '3xtf32'} d={d} pool={pool}"] = dict(
                h_equal=bool(torch.equal(h0, h1)), y_equal=bool(torch.equal(y0, y1)),
                h_differ=int((h0 != h1).sum()), y_differ=int((y0 != y1).sum()),
                h_max_abs=float((h0 - h1).abs().max()), y_max_abs=float((y0 - y1).abs().max()),
                h_max=float(h1.abs().max()))
    return out


def held_grads(tag, got, lengths, weights, masks, g, mm, x, stash_us, T) -> list:
    """The gradients against the float64 twin on the kernel's pool decisions
    (the smoke's rule), or in bf16 by the JAX package's contract."""
    import torch

    import chip_smoke as cs
    from mucon_tpu_torch.models.layers import time_mask
    from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train_plain

    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, pooling_type="max")
    C = x.shape[2]

    def fwd_bwd(dtype, **extra):
        xs = [t.to(dtype).clone().requires_grad_() for t in (x, *weights)]
        z, _ = wavenet_stack_train_plain(
            xs[0], lengths, *xs[1:], drop_masks=None if masks is None else
            [m.to(dtype) for m in masks], **kw, **extra)
        z.backward(g.to(dtype))
        return [z.detach(), *(t.grad for t in xs)]

    bad = []
    if mm is not None:
        ref = fwd_bwd(torch.float32, mm_dtype=mm, round_proj_grads=True)
        for n, a, b in zip(("z", *GRAD_NAMES), got, ref):
            cos = torch.nn.functional.cosine_similarity(a.flatten().double(),
                                                        b.flatten().double(), dim=0).item()
            if n == "z":
                rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                ok = rel < cs.BF16_REL and cos > cs.BF16_COS
            else:
                na, nb = (torch.linalg.vector_norm(t.double()).item() for t in (a, b))
                ok = cos > cs.BF16_GCOS and abs((na / nb if nb > 1e-6 else 1.0) - 1) < \
                    cs.BF16_GNORM
            if not ok:
                bad.append(f"{tag} bf16 {n}: cos {cos}")
        return bad
    shifts = stack_plan(STAGES, POOLS, T)[2]
    # the stash's rows past a length are undefined: selected away, not multiplied by 0
    pool_in = {i: torch.where(time_mask(u.shape[1], lengths >> shifts[i]).bool()[..., None],
                              u[..., :C], 0.0) for i, u in stash_us.items()}
    ref = fwd_bwd(torch.float32)
    err = (got[0] - ref[0]).abs().max().item()
    if err > cs.FWD_BOUND * ref[0].abs().max().item():
        bad.append(f"{tag} z: {err}")
    shared = fwd_bwd(torch.float32, pool_inputs=pool_in)
    shared64 = fwd_bwd(torch.float64, pool_inputs={i: u.double() for i, u in pool_in.items()})
    for n, a, b, r64 in zip(GRAD_NAMES, got[1:], shared[1:], shared64[1:]):
        k64, p64 = cs.rel_l2(a, r64), cs.rel_l2(b, r64)
        if k64 > max(cs.GRAD_BOUND, cs.F64_FACTOR * p64):
            bad.append(f"{tag} {n}: rel L2 {k64} (f32 twin {p64})")
    return bad


def quick(dev) -> list:
    """Rows 5, 6, 13, 14 at small shapes against their twins; the faults."""
    import torch
    from mucon_tpu_torch import cuda
    from mucon_tpu_torch.models.layers import mask_time
    from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack
    from mucon_tpu_torch.ops.wavenet_stack_train import wavenet_stack_train
    from mucon_tpu_torch.ops.wavenet_stack_train_v2 import wavenet_stack_train_v2

    bad = []
    for k, (C, T, lens, drop) in enumerate(((640, 256, (256, 131, 0), DROP),
                                            (768, 144, (144, 67, 9), 0.0),
                                            (768, 256, (200, 255, 64), DROP))):
        x, _, weights, masks, g = inputs(C, T, len(lens), 100 + k, dev, drop=drop)
        lengths = torch.tensor(lens, device=dev)
        for mm in (None, torch.bfloat16):
            tag = f"C={C} T={T} drop={drop} {'bf16' if mm is not None else '3xtf32'}"
            kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, mm_dtype=mm)

            def run(fn, **extra):
                xs = [t.clone().requires_grad_() for t in (x, *weights)]
                z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw, **extra)
                z.backward(g)
                torch.cuda.synchronize()
                return [z.detach(), *(t.grad for t in xs)]

            cuda.reset_launch_counts()
            got3 = run(wavenet_stack_train, pooling_type="max")
            entries = {n: v for n, v in cuda.wide_launches.items() if v}
            want = {"mucon_wgmma_layer": len(STAGES), "mucon_wgmma_proj": 1,
                    "mucon_wgt_sweep": len(STAGES) + 1}
            if entries != want:
                bad.append(f"{tag}: entries {entries}")
            again = run(wavenet_stack_train, pooling_type="max")
            if not all(torch.equal(a, b) for a, b in zip(got3, again)):
                bad.append(f"{tag}: two calls differ")
            got2 = run(wavenet_stack_train_v2, sweep_chunks=CHUNKS)
            differ = [i for i, (a, b) in enumerate(zip(got2, got3)) if not torch.equal(a, b)]
            if differ:
                bad.append(f"{tag}: v2 differs from v3 at outputs {differ}")
            for b_, n in enumerate(lens):  # rows past a length: exact zeros in z
                if got3[0][b_, n >> len(POOLS):].any():
                    bad.append(f"{tag}: z past the length of video {b_}")
            with torch.no_grad():
                _, stash = cuda.wavenet_train_forward(
                    mask_time(x, lengths), lengths, *weights, masks, pooling_type="max", **kw)
            bad += held_grads(tag, got3, lengths, weights, masks, g, mm, x, stash[2], T)
            if masks is None:  # the eval stack is the forward without dropout
                with torch.no_grad():
                    ze, _ = wavenet_stack(mask_time(x, lengths), lengths, *weights,
                                          pooling_type="max", **kw)
                if not torch.equal(ze, got3[0]):
                    bad.append(f"{tag}: the eval stack differs from the train forward")
            print(f"quick {tag}: {'ok' if not bad else bad[-1]}", flush=True)
    return bad


def main() -> int:
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if "--bits" in sys.argv:
        print(json.dumps(bits(), indent=1))
        return 0
    t0 = time.perf_counter()
    from mucon_tpu_torch import cuda

    cuda.load()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in ptxas_lines():
        print(line)
    print(json.dumps(attrs()))
    if "--sass" in sys.argv:
        for k, (mma, local, near) in sass().items():
            print(f"sass {k}: {mma} HGMMA, {local} local accesses, {near} within 8 of an HGMMA")
        return 0
    if "--quick" in sys.argv:
        bad = quick(dev)
        print("\n".join(bad) if bad else "quick: all held")
        return 1 if bad else 0
    out_path = sys.argv[1]
    if "--errors" in sys.argv:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(dict(card=card.strip(), errors=errors(dev)), f, indent=1)
        return 0
    picks = range(len(SHAPES))
    if "--shapes" in sys.argv:
        picks = [int(i) for i in sys.argv[sys.argv.index("--shapes") + 1].split(",")]
    res = dict(card=card.strip(), attrs=attrs(), shapes={})
    for k in picks:
        C, T = SHAPES[k]
        x, lengths, weights, masks, g = inputs(C, T, B, k, dev)
        for tag, mm in (("", None), (" bf16", torch.bfloat16)):
            bound = bounds(C, lengths, mm is not None)
            for row, fn in rows(x, lengths, weights, masks, g, mm).items():
                out = outputs(fn())
                torch.cuda.synchronize()
                m = measure(fn)
                m.update(digest=digest(*out), bound_ms=round(bound[row], 4),
                         share=round(bound[row] / m["device_ms"], 4) if m["device_ms"] else None)
                res["shapes"].setdefault(f"C={C} T={T}", {})[row + tag] = m
                print(f"C={C} T={T} row {row}{tag}: {m['device_ms']} ms device (call "
                      f"{m['call_device_ms']}, wall {m['wall_ms']}), bound {m['bound_ms']}, "
                      f"digest {m['digest']}", flush=True)
                del out
        del x, weights, masks, g
        torch.cuda.empty_cache()
    if "--step" in sys.argv:
        res["wide768_step"] = train_step(dev)
        print(f"wide768 step: {res['wide768_step']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
