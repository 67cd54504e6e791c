"""Export a trained run to a self-contained `torch.export` serving artifact
(mucon_tpu/cli/export_model.py): the weights and the fused inference
program (forward, free decode, Poisson means, dense Viterbi DP, pointer
walk) at fixed (batch, pad_to) shapes, written as `<out>/model.pt2` and
`<out>/meta.json` (`mucon_tpu_torch/serving.py`).

Usage:
    python -m mucon_tpu_torch.cli.export_model my_exp/0/149 \
        --out /models/mucon_v1 --batch-size 16 --pad-to 2048 [--root R]

The run folder may be either package's; the artifact is exported on the
run's `system.device` and runs there.  Then, from any process with torch:
    from mucon_tpu_torch.serving import load_exported
    load_exported("/models/mucon_v1").predict([feats])   # [T x D] float32

The selftest loads the artifact back and holds its outputs bit for bit
against the live program on a seeded random batch (the same wire arrays
for both).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mucon_tpu_torch.cli.predict import model_from_run
from mucon_tpu_torch.serving import (
    FEATS_WIRES,
    build_serving_fn,
    export_serving,
    load_exported,
    same_bits,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("identifier", help="exp-name/run-number/epoch-number")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--pad-to", type=int, default=2048,
                   help="frozen time dim (a multiple of tpu.pad_multiple)")
    p.add_argument("--viterbi-max-len", type=int, default=2000)
    p.add_argument("--feats-wire", default="float32", choices=list(FEATS_WIRES),
                   help="feature input wire frozen into the artifact: float16 and "
                        "bfloat16 halve the feature bytes, int8 (per-frame quantized, "
                        "with a float32 scale a frame) quarters them")
    p.add_argument("--root", default="")
    p.add_argument("--no-selftest", action="store_true",
                   help="skip the load-and-compare check")
    args = p.parse_args(argv)

    cfg, db, model = model_from_run(args.identifier, args.root)
    export_serving(model, cfg, db, args.batch_size, args.pad_to, args.out,
                   viterbi_max_len=args.viterbi_max_len, feats_wire=args.feats_wire,
                   device=model.device)
    print(f"exported {args.identifier} -> {args.out} (B={args.batch_size}, T={args.pad_to}, "
          f"feats_wire={args.feats_wire}, device={model.device.type})")

    if not args.no_selftest:
        served = load_exported(args.out)
        rng = np.random.default_rng(0)
        feats = rng.standard_normal((args.batch_size, args.pad_to, db.feat_dim), np.float32)
        nf = np.full((args.batch_size,), args.pad_to // 2, np.int64)
        wire = served.to_wire(feats)  # the same wire arrays for both sides
        got = served(wire, nf, raw_wire=True)
        live = build_serving_fn(model, cfg, db, args.batch_size, args.pad_to,
                                args.viterbi_max_len, args.feats_wire)
        with torch.no_grad():
            want = live(*(t.to(model.device) for t in wire),
                        torch.from_numpy(nf).to(model.device))
        for k, w in zip(served.meta["outputs"], want):
            if not same_bits(got[k], w):
                raise SystemExit(f"selftest: the artifact's {k} differs from the live program")
        print("selftest: exported == live program (bitwise)")
    return args.out


if __name__ == "__main__":
    main()
