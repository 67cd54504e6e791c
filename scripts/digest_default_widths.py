#!/usr/bin/env python3
"""SHA-256 digests of every kernel's outputs at the narrow instances' widths,
on one CUDA card, to compare two trees bit for bit.

    python3 scripts/digest_default_widths.py OUT.json [--wide]

From the root of a checkout.  Seeded inputs (torch.Generator, seed 0) go
through each kernel wrapper of `mucon_tpu_torch.cuda` at the shapes its
narrow instances take: the WaveNet eval stack, the MS-TCN++ stage, the v3
trainable stack's forward and sweep and v2's (both modes), at C = 128, 256
and 512 (B = 4, T = 512, 11 layers); the BiLSTM (eval, train forward and
reverse chain) and the decoder chain (forward and reverse) at H = 128,
256, 512 (B = 8, Tz = 160, S = 31); the DP and walk at the serving shape
(K = 85, N = 30, L = 66) and the cluster body (N = 40); the flint loss.
`--wide` adds the trainable stack's rows on the wide bodies (v3's forward
and sweep, v2's, both modes) at C = 600 (run at 640) and 768, after the
rest, whose inputs it leaves as they are.
Writes {name: sha256 of the output's bytes} to OUT.json and prints it.
Copy the script into another checkout's `scripts/` to digest that tree
with the same inputs: equal digests are equal outputs, bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    import torch
    from mucon_tpu_torch import cuda

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}

    def put(name, tensors):
        for i, t in enumerate(tensors):
            out[f"{name}[{i}]"] = digest(t)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    stages, pools = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8)
    B, T, L = 4, 512, len(stages)
    lengths = torch.tensor([512, 400, 257, 96], device=dev)

    def run(C, eval_stacks=True):
        x = torch.relu(rn(B, T, C)) * (torch.arange(T, device=dev)[None, :, None]
                                       < lengths[:, None, None])
        w = [rn(L, 3, C, C, scale=(3 * C) ** -0.5), rn(L, C, scale=0.1),
             rn(L, C, C, scale=C ** -0.5), rn(L, C, scale=0.1), rn(C, C, scale=C ** -0.5),
             rn(C, scale=0.1)]
        wm = [rn(L, 3, C, C, scale=(3 * C) ** -0.5), rn(L, C, scale=0.1),
              rn(L, 3, C, C, scale=(3 * C) ** -0.5), rn(L, C, scale=0.1),
              rn(L, C, C, scale=(2 * C) ** -0.5), rn(L, C, C, scale=(2 * C) ** -0.5),
              rn(L, C, scale=0.1), rn(C, C, scale=C ** -0.5), rn(C, scale=0.1)]
        t_ins = [T >> sum(1 for p in pools if p < i) for i in range(L)]
        masks = [(torch.rand(B, t, C, generator=gen) > 0.25).float().to(dev) / 0.75
                 for t in t_ins]
        from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds

        for mm in (None, torch.bfloat16):
            tag = f"C={C} {'bf16' if mm else 'f32'}"
            kw = dict(stages=stages, pooling_layers=pools, leaky=False, mm_dtype=mm)
            if eval_stacks:
                put(f"wavenet_layer {tag}", cuda.wavenet_stack(x, lengths, *w,
                                                               pooling_type="max", **kw)[:1])
                put(f"mstcnpp_stack {tag}", cuda.mstcnpp_stack(x, lengths, *wm,
                                                               pooling_layers=pools,
                                                               mm_dtype=mm)[:1])
            z, stash = cuda.wavenet_train_forward(x, lengths, *w, masks, pooling_type="max",
                                                  **kw)
            g = rn(*z.shape)
            put(f"wavenet_train_fwd {tag}", [z, *stash[1]])
            put(f"wavenet_train_sweep {tag}", cuda.wavenet_train_backward(
                g, stash, lengths, w[0], w[2], w[4], masks, pooling_type="max", **kw))
            bounds = chunk_bounds(L, 3)
            z2, stash2 = cuda.wavenet_train_v2_forward(x, lengths, *w, masks, bounds=bounds,
                                                       **kw)
            put(f"wavenet_train_v2_fwd {tag}", [z2])
            put(f"wavenet_train_v2_sweep {tag}", cuda.wavenet_train_v2_backward(
                g, stash2, lengths, w[0], w[2], w[3], w[4], masks, bounds=bounds, **kw))

    for C in (128, 256, 512):
        run(C)
    Tz, Bt, S = 160, 8, 31
    tz = torch.tensor([160, 151, 140, 120, 99, 93, 131, 160])
    m = (torch.arange(Tz)[:, None] < tz[None, :]).float().to(dev)
    for H in (128, 256, 512):
        w_hh = rn(2, H, 4 * H, scale=H ** -0.5)
        xp = rn(Tz, 2, Bt, 4 * H)
        put(f"bilstm_recurrence H={H}", cuda.bilstm_recurrence(xp, m, w_hh))
        outs, h, c, cs = cuda.bilstm_train_forward(xp, m, w_hh)
        put(f"bilstm_train_fwd H={H}", [outs, h, c, cs])
        put(f"bilstm_train_bwd H={H}", [cuda.bilstm_train_backward(
            xp, m, w_hh, outs, cs, rn(Tz, 2, Bt, H), rn(2, Bt, H), rn(2, Bt, H))])
        E = 2 * H
        maskf = m.t().contiguous()
        args = [torch.relu(rn(S, Bt, H, scale=0.4)), rn(Bt, Tz, E, scale=0.4) * maskf[..., None],
                rn(Bt, Tz, H, scale=0.4), maskf, rn(Bt, H, scale=0.4), rn(Bt, H, scale=0.4),
                rn(H, H, scale=H ** -0.5), rn(H, scale=0.4), rn(H, scale=0.4),
                rn(H, H, scale=(H + E) ** -0.5), rn(E, H, scale=(H + E) ** -0.5),
                rn(H, scale=0.4), rn(H, 4 * H, scale=(2 * H) ** -0.5),
                rn(H, 4 * H, scale=(2 * H) ** -0.5), rn(4 * H, scale=0.4)]
        hs, cs_, comb = cuda.decoder_chain_forward(*args)
        put(f"decoder_chain_fwd H={H}", [hs, cs_, comb])
        h_in = torch.cat([args[4][None], hs[:-1]])
        c_in = torch.cat([args[5][None], cs_[:-1]])
        put(f"decoder_chain_bwd H={H}", cuda.decoder_chain_backward(
            *args[:4], h_in, c_in, *args[6:], rn(S, Bt, H), rn(S, Bt, H), rn(S, Bt, H)))
    for K, N, Lc, Bv in ((85, 30, 66, 128), (85, 40, 66, 6)):
        labels = torch.randint(0, 3, (Bv, N), generator=gen)
        W = (-torch.rand(K, 3, generator=gen) * 60.0)[:, labels].permute(1, 0, 2).contiguous()
        pois = -torch.rand(Bv, N, Lc, generator=gen) * 20.0
        kv = torch.randint(0, K + 1, (Bv,), generator=gen)
        nv = torch.randint(1, N + 1, (Bv,), generator=gen)
        put(f"dense_viterbi N={N}", cuda.dense_viterbi_decode(
            W.to(dev), pois.to(dev), kv.to(dev), nv.to(dev), 30, 2000))
    Bf, Tf, Mf, Nf = 8, 2560, 48, 30
    from mucon_tpu_torch.ops.mucon_loss import flint_prep

    lens = torch.rand(Bf, Nf, generator=gen).to(dev)
    n_len = torch.randint(1, Nf + 1, (Bf,), generator=gen).to(dev)
    t_valid = torch.randint(1500, 2101, (Bf,), generator=gen).to(dev)
    target = torch.randint(0, Mf, (Bf, Nf), generator=gen).to(dev)
    seg = rn(Bf, Tf, Mf)
    scale, xloc, sdiv = flint_prep(lens, n_len, t_valid, 0.0)
    put("mucon_flint", [cuda.mucon_flint(scale, xloc, sdiv, seg, target, n_len, t_valid)])
    if "--wide" in sys.argv:
        for C in (600, 768):
            run(C, eval_stacks=False)
    torch.cuda.synchronize()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
    print(json.dumps({"outputs": len(out), "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
