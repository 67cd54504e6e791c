"""MuCon's objective on a padded batch (mucon_tpu/models/losses.py):

    main = mul_transcript * transcript + mul_length * length
         + mul_mucon * mucon + mul_smoothing * smoothing
        [+ mean over videos of gate * (mul_classification * classification
                                       + mul_supervised_length * supervised_length)]

Each term is the reference's per-video value computed over the video's
unpadded extent — the transcript NLL over N_i + 1 teacher-forced steps,
the hinge length loss over N_i steps, the mutual-consistency NLL over N_i
segments, the smoothing MSE over (T_i - 1) * M elements; for the supervised models
the framewise cross-entropy against the ground-truth labels over T_i
frames and the MSE of the softmaxed lengths against the ground truth's
relative lengths over N_i segments — then averaged over the videos.  The
gate is 1 for the fully supervised model and each video's
`fully_supervised` flag for the mixed one (losses.py:287-323), so a batch
with no supervised video adds exactly 0.  Every term is written for the
whole batch at once (no loop over videos).

Routing by config, as in the JAX package (losses.py:241-266): with
`use_loss_kernel` (the JAX `tpu.use_pallas_loss`) and the `flint` loss
with the `box` template, the mucon term is `ops/mucon_loss.py
mucon_flint` — kernel F on the card, its plain twin on the CPU.  Any other
type or template takes the plain term.  The JAX package's VMEM gate has no
counterpart: the kernel walks the frames in tiles.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mucon_tpu_torch.models.masks import create_masks_padded
from mucon_tpu_torch.models.outputs import (
    MuConForwardOut,
    MuConFullySupervisedLoss,
    MuConLoss,
)
from mucon_tpu_torch.ops.mucon_loss import absolute_lengths, mucon_flint, mucon_flint_plain

# the repo's default loss options (mucon_tpu/config/defaults.py:93-117),
# under the keys of the JAX package's `loss_static_config`
LOSS_DEFAULTS = dict(
    mul_mucon=1.0,
    mul_transcript=1.0,
    mul_smoothing=0.1,
    mul_length=0.1,
    length_width=2.0,
    transcript_average=False,
    mucon_weight_background=False,
    mucon_weight_background_value=0.5,
    mucon_weight_background_index=0,
    transcript_weight_background=False,
    transcript_weight_background_value=0.5,
    transcript_weight_background_index=0,
    mucon_type="flint",
    mucon_template="box",
    mucon_overlap=0.0,
    smoothing_log_softmax_before=True,
    smoothing_clamp=True,
    smoothing_clamp_min=0,
    smoothing_clamp_max=16,
    use_loss_kernel=False,
    mul_classification=1.0,
    mul_supervised_length=1.0,
)


def loss_config_from_cfg(cfg) -> dict:
    """The loss options of a mucon_tpu config node (attribute access only)."""
    L = cfg.model.loss
    return dict(
        mul_mucon=L.mul_mucon,
        mul_transcript=L.mul_transcript,
        mul_smoothing=L.mul_smoothing,
        mul_length=L.mul_length,
        length_width=L.length_width,
        transcript_average=L.transcript_average,
        mucon_weight_background=L.mucon_weight_background,
        mucon_weight_background_value=L.mucon_weight_background_value,
        mucon_weight_background_index=L.mucon_weight_background_index,
        transcript_weight_background=L.transcript_weight_background,
        transcript_weight_background_value=L.transcript_weight_background_value,
        transcript_weight_background_index=L.transcript_weight_background_index,
        mucon_type=L.mucon.type,
        mucon_template=L.mucon.template,
        mucon_overlap=L.mucon.overlap,
        smoothing_log_softmax_before=L.smoothing.log_softmax_before,
        smoothing_clamp=L.smoothing.clamp,
        smoothing_clamp_min=L.smoothing.clamp_min,
        smoothing_clamp_max=L.smoothing.clamp_max,
        use_loss_kernel=bool(getattr(cfg.tpu, "use_pallas_loss", False)),
        mul_classification=L.fully_supervised.mul_classification,
        mul_supervised_length=L.fully_supervised.mul_supervised_length,
    )


def _class_weights(num: int, enabled: bool, index: int, value: float, device):
    if not enabled:
        return None
    w = torch.ones(num, device=device)
    w[index] = value
    return w


def _nll(logprobs, targets, valid, weights: Optional[torch.Tensor], average: bool):
    """Per-video (weighted) NLL over valid steps: logprobs [B x K x V],
    targets and valid [B x K].  torch nll_loss semantics: the weighted mean
    divides by the sum of the selected weights."""
    picked = -torch.gather(logprobs, 2, targets[..., None])[..., 0]
    w = valid if weights is None else weights[targets] * valid
    total = torch.sum(picked * w, dim=1)
    if average:
        return total / torch.clamp(torch.sum(w, dim=1), min=1e-12)
    return total


def transcript_loss(cfg, logprobs, tf_target, n_steps):
    """NLL of the teacher-forced targets over the first n_steps steps [B]."""
    B, S, V = logprobs.shape
    valid = (torch.arange(S, device=logprobs.device)[None, :] < n_steps[:, None]).float()
    weights = _class_weights(V, cfg["transcript_weight_background"],
                             cfg["transcript_weight_background_index"],
                             cfg["transcript_weight_background_value"], logprobs.device)
    return _nll(logprobs, tf_target, valid, weights, cfg["transcript_average"])


def length_loss(width: float, lengths_raw, n_len):
    """Hinge keeping the raw length logits of the first n_len steps in
    [-width, width] [B]."""
    S = lengths_raw.shape[1]
    valid = (torch.arange(S, device=lengths_raw.device)[None, :] < n_len[:, None]).float()
    y = torch.relu(lengths_raw - width) + torch.relu(-width - lengths_raw)
    return torch.sum(y * valid, dim=1)


def smoothing_loss(cfg, segmentation, t_valid):
    """T-MSE between consecutive (log-softmaxed) frame logits, the previous
    frame detached; the clamp applies to each video's mean, not to the
    elements [B]."""
    B, T, M = segmentation.shape
    x = F.log_softmax(segmentation, dim=2) if cfg["smoothing_log_softmax_before"] \
        else segmentation
    d = x[:, 1:] - x[:, :-1].detach()
    ids = torch.arange(1, T, device=segmentation.device)
    pair_valid = (ids[None, :] < t_valid[:, None]).float()[:, :, None]
    denom = torch.clamp((t_valid - 1) * M, min=1).float()
    mse = torch.sum(d * d * pair_valid, dim=(1, 2)) / denom
    if cfg["smoothing_clamp"]:
        mse = torch.clamp(mse, cfg["smoothing_clamp_min"], cfg["smoothing_clamp_max"])
    return mse


def mucon_loss(cfg, lengths_raw, segmentation, target_transcript, n_len, t_valid):
    """The mutual-consistency loss [B]: the predicted lengths place soft
    segment masks over the frames, and the framewise head must agree with
    the transcript inside each segment ("flint": NLL of the mask-averaged
    logits; "arithmetic": mask-weighted framewise CE / T_i)."""
    B, T, M = segmentation.shape
    n_max = target_transcript.shape[1]
    weights = _class_weights(M, cfg["mucon_weight_background"],
                             cfg["mucon_weight_background_index"],
                             cfg["mucon_weight_background_value"], segmentation.device)
    if cfg["mucon_type"] == "flint":
        return mucon_flint_plain(lengths_raw[:, :n_max], segmentation, target_transcript,
                                 n_len, t_valid, cfg["mucon_overlap"], weights,
                                 cfg["mucon_template"])
    if cfg["mucon_type"] == "arithmetic":
        abs_lengths, seg_valid = absolute_lengths(lengths_raw[:, :n_max], n_len, t_valid)
        masks = create_masks_padded(T, t_valid, abs_lengths, seg_valid,
                                    overlap=cfg["mucon_overlap"],
                                    template=cfg["mucon_template"])  # [B x N_max x T]
        tgt = torch.clamp(target_transcript, 0, M - 1)
        lp = F.log_softmax(segmentation, dim=2)  # [B x T x M]
        ce = -torch.gather(lp, 2, tgt[:, None, :].expand(B, T, n_max)).transpose(1, 2)
        if weights is not None:
            ce = ce * weights[tgt][:, :, None]
        ce = ce * seg_valid[:, :, None]
        return torch.sum(ce * masks, dim=(1, 2)) / torch.clamp(t_valid.float(), min=1.0)
    raise ValueError(f"Invalid mucon type ({cfg['mucon_type']})")


def classification_loss(segmentation, gt_label, t_valid):
    """Framewise cross-entropy against the ground-truth labels, mean over
    the T_i valid frames [B] (losses.py:151)."""
    B, T, M = segmentation.shape
    lp = F.log_softmax(segmentation, dim=2)
    valid = (torch.arange(T, device=segmentation.device)[None, :] < t_valid[:, None]).float()
    picked = -torch.gather(lp, 2, torch.clamp(gt_label, 0, M - 1)[..., None])[..., 0]
    return torch.sum(picked * valid, dim=1) / torch.clamp(t_valid.float(), min=1.0)


def supervised_length_loss(lengths_raw, absolute_lengths, n_len):
    """MSE between the ground truth's relative lengths and the softmaxed
    length predictions of the first N_i steps, mean over N_i [B]
    (losses.py:160)."""
    n_max = absolute_lengths.shape[1]
    seg_valid = torch.arange(n_max, device=lengths_raw.device)[None, :] < n_len[:, None]
    rel_gt = absolute_lengths / torch.clamp(absolute_lengths.sum(dim=1, keepdim=True),
                                            min=1e-12)
    logits = torch.where(seg_valid, lengths_raw[:, :n_max], float("-inf"))
    d = (rel_gt - torch.softmax(logits, dim=1)) ** 2 * seg_valid
    return torch.sum(d, dim=1) / torch.clamp(n_len.float(), min=1.0)


def compute_loss(cfg: dict, fwd: MuConForwardOut, tf_target, transcript, transcript_len,
                 num_frames, gt_label=None, absolute_lengths=None, fully_supervised=None,
                 supervised: bool = False, teacher_forcing: bool = True) -> MuConLoss:
    """Batch loss: per-video exact values, mean over videos.  `cfg` holds
    the `LOSS_DEFAULTS` keys.  The mucon term's target is the ground
    truth's transcript under teacher forcing, else the decoder's own
    argmax, tokens[:, :N_max] with tokens >= M set to 0 (losses.py:219-226;
    on the flint kernel's route too, which takes the target as an input).
    With `supervised`, the two supervised terms from `gt_label` [B x T]
    and `absolute_lengths` [B x N_max], gated by `fully_supervised` [B]
    where it is given (the mixed model)."""
    target = transcript
    if not teacher_forcing:
        M = fwd.segmentation.shape[-1]
        toks = fwd.tokens[:, :transcript.shape[1]]
        target = torch.where(toks >= M, 0, toks)
    t = transcript_loss(cfg, fwd.transcript, tf_target, fwd.n_steps).mean()
    ln = length_loss(cfg["length_width"], fwd.lengths, transcript_len).mean()
    if cfg["use_loss_kernel"] and cfg["mucon_type"] == "flint" \
            and cfg["mucon_template"] == "box":
        M, n_max = fwd.segmentation.shape[2], transcript.shape[1]
        weights = _class_weights(M, cfg["mucon_weight_background"],
                                 cfg["mucon_weight_background_index"],
                                 cfg["mucon_weight_background_value"], transcript.device)
        mc = mucon_flint(fwd.lengths[:, :n_max], fwd.segmentation, target,
                         transcript_len, num_frames, cfg["mucon_overlap"], weights).mean()
    else:
        mc = mucon_loss(cfg, fwd.lengths, fwd.segmentation, target, transcript_len,
                        num_frames).mean()
    sm = smoothing_loss(cfg, fwd.segmentation, num_frames).mean()
    main = (cfg["mul_transcript"] * t + cfg["mul_length"] * ln
            + cfg["mul_mucon"] * mc + cfg["mul_smoothing"] * sm)
    if not supervised:
        return MuConLoss(main=main, transcript_loss=t, mucon_loss=mc, length_loss=ln,
                         smoothing_loss=sm)

    v_cls = classification_loss(fwd.segmentation, gt_label, num_frames)
    v_len = supervised_length_loss(fwd.lengths, absolute_lengths, transcript_len)
    gate = (torch.ones_like(v_cls) if fully_supervised is None
            else fully_supervised.to(v_cls.dtype))
    main = main + torch.mean(gate * (cfg["mul_classification"] * v_cls
                                     + cfg["mul_supervised_length"] * v_len))
    return MuConFullySupervisedLoss(
        main=main, transcript_loss=t, mucon_loss=mc, length_loss=ln, smoothing_loss=sm,
        classification_loss=v_cls.mean(), supervised_length_loss=v_len.mean())
