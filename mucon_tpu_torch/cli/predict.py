"""Serving entry point: segment raw feature files with a trained run
(mucon_tpu/cli/predict.py).

`predict_videos` pads the videos into batches, runs the fused eval
(`ops/eval_fused.py`: free decode + dense Viterbi, through the CUDA
kernels when the model lives on the card) and returns one dict per video:
transcript ids and names, relative lengths, framewise Viterbi labels and
framewise y-head labels.

`main()` points a trained `exp/run/epoch` of either package (`model.pt`, or
a JAX run's `model.msgpack`) at a directory of `*.npy` feature files
([T x D] float32) and writes, per video:

    <out>/<video>.labels.npy        framewise Viterbi labels [T] int32
    <out>/<video>.y_labels.npy      framewise y-head argmax  [T] int32
    <out>/<video>.json              transcript ids / names + relative lengths

Usage:
    python -m mucon_tpu_torch.cli.predict my_exp/0/149 \
        --features /path/to/features --out /tmp/preds [--root R]

The features travel on the wire that the run's
`tpu.eval_feats_transfer_dtype` names (mucon_tpu/cli/predict.py:83), or
`--feats-wire` (float32, float16, bfloat16 or int8); "auto" is float32.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.config.support import check_supported
from mucon_tpu_torch.data import (
    Sample,
    collate_padded,
    create_tf_input,
    create_tf_target,
    handel_dataset,
)
from mucon_tpu_torch.harness.checkpoint import load_params
from mucon_tpu_torch.models.model import (
    FEATS_DTYPES,
    batch_to_tensors,
    eval_feats_round_to_bf16,
    resolve_feats_dtype,
)
from mucon_tpu_torch.models.routing import routes_from_cfg
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.viterbi import positions_to_results


def collate_videos(feats_list, names, db, pad_multiple: int = 512, transcripts=None):
    """Pad raw [T x D] feature arrays into one PaddedBatch.  `transcripts`
    (one int array of action ids per video) feed the teacher-forced train
    forward and the loss; at serving time they are unknown and each video
    carries a dummy one."""
    if transcripts is None:
        transcripts = [np.zeros(1, np.int64)] * len(feats_list)
    samples = [
        Sample(
            feats=np.ascontiguousarray(f, np.float32),
            gt_label=np.zeros(f.shape[0], np.int64),
            transcript=tr,
            transcript_tf_input=create_tf_input(tr, sos_i=db.sos_token_id),
            transcript_tf_target=create_tf_target(tr, eos_i=db.eos_token_id),
            video_name=name,
        )
        for f, name, tr in zip(feats_list, names, transcripts)
    ]
    return collate_padded(samples, db.max_transcript_length, pad_multiple)


def predict_videos(model, feats_list, names, db, *, frame_sampling: int = 30,
                   batch_size: int = 1, pad_multiple: int = 512,
                   use_kernels=True, feats_dtype=None):
    """Free decode + Viterbi for raw [T x D] feature arrays.  `db` supplies
    the vocabulary: max_transcript_length, sos_token_id, eos_token_id and
    action_id_to_name (a mucon_tpu dataset, or any object with those).
    `use_kernels` is a `KernelRoutes` or a bool for every kernel;
    `feats_dtype` is the feature wire (`resolve_feats_dtype`)."""
    run = build_fused_eval(model, teacher_forcing=False,
                           frame_sampling=frame_sampling, use_kernels=use_kernels)
    results = []
    bs = max(1, batch_size)
    for lo in range(0, len(feats_list), bs):
        chunk_names = names[lo : lo + bs]
        batch = collate_videos(feats_list[lo : lo + bs], chunk_names, db, pad_multiple)
        out = run(batch_to_tensors(batch, model.device, feats_dtype=feats_dtype))
        traced = positions_to_results(
            batch.num_frames, out["transcripts"], out["n_dec"], out["vit_score"],
            out["vit_pos"], out["vit_k_valid"], frame_sampling,
        )
        for i, name in enumerate(chunk_names):
            n = int(out["n_dec"][i])
            transcript = [int(x) for x in out["transcripts"][i, :n]]
            results.append(
                dict(
                    name=name,
                    transcript=transcript,
                    transcript_names=[db.action_id_to_name[t] for t in transcript],
                    rel_lengths=[float(x) for x in out["rel_lengths"][i, :n]],
                    vit_labels=np.asarray(traced[i].labels, np.int32),
                    y_labels=out["y_argmax"][i, : int(batch.num_frames[i])].astype(np.int32),
                )
            )
    return results


def model_from_run(identifier: str, root: str = "", feats_wire=None):
    """(cfg, db, model) of a trained `exp/run/epoch` of either package,
    read only: its config.yaml (with `feats_wire`, if given, as
    `tpu.eval_feats_transfer_dtype`, mucon_tpu/cli/predict.py:140-141), the
    dataset for the label vocabulary and the feature width, and the
    checkpoint's weights on `system.device`."""
    cfg = get_cfg_defaults()
    root = root or cfg.trainer.root
    exp_name, run_number, epoch_number = identifier.split("/")
    cfg.merge_from_file(str(Path(root) / exp_name / run_number / "config.yaml"))
    cfg.trainer.root = root
    if feats_wire is not None:
        cfg.tpu.eval_feats_transfer_dtype = feats_wire
    cfg.freeze()
    check_supported(cfg)

    db = handel_dataset(cfg, train=False)
    model = create_model_from_cfg(cfg, db)
    model.net.load_state_dict(load_params(root, exp_name, run_number, int(epoch_number),
                                          model.device), strict=True)
    return cfg, db, model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("identifier", help="exp-name/run-number/epoch-number")
    p.add_argument("--features", required=True,
                   help="directory of <video>.npy [T x D] feature files")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--root", default="")
    p.add_argument("--feats-wire", default=None, choices=list(FEATS_DTYPES),
                   help="override tpu.eval_feats_transfer_dtype for this prediction run "
                        "(the host-to-device feature wire)")
    args = p.parse_args(argv)

    cfg, db, model = model_from_run(args.identifier, args.root, args.feats_wire)

    feat_files = sorted(Path(args.features).glob("*.npy"))
    if not feat_files:
        raise SystemExit(f"no .npy feature files in {args.features}")
    feats = [np.load(f) for f in feat_files]
    names = [f.stem for f in feat_files]
    for f, name in zip(feats, names):
        if f.ndim != 2 or f.shape[1] != db.feat_dim:
            raise SystemExit(f"{name}: expected [T x {db.feat_dim}] features, got {f.shape}")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    routes = routes_from_cfg(cfg)
    results = predict_videos(model, feats, names, db,
                             frame_sampling=cfg.evaluator.viterbi.frame_sampling,
                             batch_size=cfg.tpu.batch_size, pad_multiple=cfg.tpu.pad_multiple,
                             use_kernels=routes,
                             feats_dtype=resolve_feats_dtype(cfg, "eval_feats_transfer_dtype",
                                                             eval_feats_round_to_bf16(cfg, routes)))
    for r in results:
        np.save(out_dir / f"{r['name']}.labels.npy", r["vit_labels"])
        np.save(out_dir / f"{r['name']}.y_labels.npy", r["y_labels"])
        with open(out_dir / f"{r['name']}.json", "w") as f:
            json.dump({k: r[k] for k in ("name", "transcript", "transcript_names",
                                         "rel_lengths")}, f, indent=2)
        print(f"{r['name']}: {' '.join(r['transcript_names'])}")
    print(f"wrote {len(results)} predictions to {out_dir}")
    return results


if __name__ == "__main__":
    main()
