"""Serving entry point: segment raw feature arrays (mucon_tpu/cli/predict.py:41).

`predict_videos` pads the videos into batches, runs the fused eval
(`ops/eval_fused.py`: free decode + dense Viterbi, through the CUDA
kernels when the model lives on the card) and returns one dict per video:
transcript ids and names, relative lengths, framewise Viterbi labels and
framewise y-head labels.

The JAX CLI's `main()` (reading a flax `model.msgpack` run folder) is not
ported yet: it waits for the checkpoint reader.  Load JAX weights with
`MuConModel.load_jax_params`.
"""

from __future__ import annotations

import numpy as np

from mucon_tpu.data import collate_padded
from mucon_tpu.data.general_dataset import Sample
from mucon_tpu.data.utils import create_tf_input, create_tf_target
from mucon_tpu_torch.models.model import batch_to_tensors
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
                   use_kernels: bool = True):
    """Free decode + Viterbi for raw [T x D] feature arrays.  `db` supplies
    the vocabulary: max_transcript_length, sos_token_id, eos_token_id and
    action_id_to_name (a mucon_tpu dataset, or any object with those)."""
    run = build_fused_eval(model, teacher_forcing=False,
                           frame_sampling=frame_sampling, use_kernels=use_kernels)
    results = []
    bs = max(1, batch_size)
    for lo in range(0, len(feats_list), bs):
        chunk_names = names[lo : lo + bs]
        batch = collate_videos(feats_list[lo : lo + bs], chunk_names, db, pad_multiple)
        out = run(batch_to_tensors(batch, model.device))
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
