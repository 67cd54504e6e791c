"""MuCon's weakly supervised objective on a padded batch
(mucon_tpu/models/losses.py:51-294, the unsupervised terms):

    main = mul_transcript * transcript + mul_length * length
         + mul_mucon * mucon + mul_smoothing * smoothing

Each term is the reference's per-video value computed over the video's
unpadded extent — the transcript NLL over N_i + 1 teacher-forced steps,
the hinge length loss over N_i steps, the mutual-consistency NLL over N_i
segments, the smoothing MSE over (T_i - 1) * M elements — then averaged
over the videos.  Every term is written for the whole batch at once (no
loop over videos).  The supervised variants' terms are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mucon_tpu_torch.models.masks import create_masks_padded
from mucon_tpu_torch.models.outputs import MuConForwardOut, MuConLoss

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
    dev = segmentation.device
    seg_valid = torch.arange(n_max, device=dev)[None, :] < n_len[:, None]
    logits = torch.where(seg_valid, lengths_raw[:, :n_max], float("-inf"))
    abs_lengths = t_valid.float()[:, None] * torch.softmax(logits, dim=1)
    masks = create_masks_padded(T, t_valid, abs_lengths, seg_valid,
                                overlap=cfg["mucon_overlap"],
                                template=cfg["mucon_template"])  # [B x N_max x T]
    weights = _class_weights(M, cfg["mucon_weight_background"],
                             cfg["mucon_weight_background_index"],
                             cfg["mucon_weight_background_value"], dev)
    tgt = torch.clamp(target_transcript, 0, M - 1)

    if cfg["mucon_type"] == "flint":
        widened = abs_lengths * (1.0 + 2.0 * cfg["mucon_overlap"])
        safe_len = torch.where(seg_valid, torch.clamp(widened, min=1e-12), 1.0)
        window = torch.bmm(masks, segmentation) / safe_len[:, :, None]  # [B x N x M]
        return _nll(F.log_softmax(window, dim=2), tgt, seg_valid.float(), weights,
                    average=True)
    if cfg["mucon_type"] == "arithmetic":
        lp = F.log_softmax(segmentation, dim=2)  # [B x T x M]
        ce = -torch.gather(lp, 2, tgt[:, None, :].expand(B, T, n_max)).transpose(1, 2)
        if weights is not None:
            ce = ce * weights[tgt][:, :, None]
        ce = ce * seg_valid[:, :, None]
        return torch.sum(ce * masks, dim=(1, 2)) / torch.clamp(t_valid.float(), min=1.0)
    raise ValueError(f"Invalid mucon type ({cfg['mucon_type']})")


def compute_loss(cfg: dict, fwd: MuConForwardOut, tf_target, transcript, transcript_len,
                 num_frames) -> MuConLoss:
    """Teacher-forced batch loss: per-video exact values, mean over videos.
    `cfg` holds the `LOSS_DEFAULTS` keys."""
    t = transcript_loss(cfg, fwd.transcript, tf_target, fwd.n_steps).mean()
    ln = length_loss(cfg["length_width"], fwd.lengths, transcript_len).mean()
    mc = mucon_loss(cfg, fwd.lengths, fwd.segmentation, transcript, transcript_len,
                    num_frames).mean()
    sm = smoothing_loss(cfg, fwd.segmentation, num_frames).mean()
    main = (cfg["mul_transcript"] * t + cfg["mul_length"] * ln
            + cfg["mul_mucon"] * mc + cfg["mul_smoothing"] * sm)
    return MuConLoss(main=main, transcript_loss=t, mucon_loss=mc, length_loss=ln,
                     smoothing_loss=sm)
