"""Differentiable segment masks of the mutual-consistency loss
(mucon_tpu/models/masks.py:40-157).

The reference warps a 100-wide template through a spatial transformer
(affine_grid + grid_sample, align_corners=True) so that mask placement is
differentiable in the predicted lengths.  The warp has a closed form: for
frame t and segment i the template is sampled, bilinearly, at a pixel
coordinate affine in (t, start_i, len_i).  Computed here for a whole
padded batch at once: [B x N_max x T_pad].
"""

from __future__ import annotations

import numpy as np
import torch

TEMPLATE_WIDTH = 100


def _gaussian_template() -> np.ndarray:
    # scipy.signal.gaussian(M=100, std=M/5), n = k - (M-1)/2
    m = TEMPLATE_WIDTH
    std = m / 5.0
    n = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    return np.exp(-(n ** 2) / (2.0 * std ** 2)).astype(np.float32)


def _trapezoid_template() -> np.ndarray:
    # ramps 0.5 -> 1 over the first 25 pixels and 1 -> 0.5 over the last 25
    m = TEMPLATE_WIDTH
    w1 = m / 2.0
    min_val = 0.5
    tmpl = np.ones(m, dtype=np.float64)
    ramp = int(w1 / 2)
    step = (1.0 - min_val) / (w1 / 2)
    tmpl[:ramp] = np.arange(ramp) * step + min_val
    tmpl[-ramp:] = 1.0 + np.arange(ramp) * (-step)
    return tmpl.astype(np.float32)


def template_values(template: str) -> np.ndarray:
    """The 100-wide 1-D template the spatial transformer would warp."""
    if template == "box":
        return np.ones(TEMPLATE_WIDTH, dtype=np.float32)
    if template == "gaussian":
        return _gaussian_template()
    if template == "trapezoid":
        return _trapezoid_template()
    raise NameError(f"Invalid template name ({template})")


def _sample_template(c: torch.Tensor, template: str) -> torch.Tensor:
    """Bilinear 1-D template lookup at pixel coordinates c (zeros outside)."""
    W = TEMPLATE_WIDTH
    outside = (c <= -1.0) | (c >= W)
    if template == "box":
        # minimum / maximum, not clamp: at a kink (a segment edge on a
        # frame) they split the gradient as jnp.clip does
        out = torch.minimum(torch.maximum(torch.minimum(c + 1.0, W - c), c.new_zeros(())),
                            c.new_ones(()))
        return torch.where(outside, 0.0, out)
    tmpl = torch.as_tensor(template_values(template), device=c.device)
    i0 = torch.floor(c)
    f = c - i0
    i0 = i0.to(torch.int64)

    def lookup(idx):
        v = tmpl[torch.clamp(idx, 0, W - 1)]
        return torch.where((idx < 0) | (idx > W - 1), 0.0, v)

    out = (1.0 - f) * lookup(i0) + f * lookup(i0 + 1)
    return torch.where(outside, 0.0, out)


def mask_placement(t_valid, L, seg_valid, overlap: float = 0.0):
    """Where each segment's template lands: frame t of a video samples the
    template at pixel (scale * g(t) + xloc + 1) * (W - 1) / 2, with g the
    align_corners grid of [-1, 1] over the valid frames.  Returns (scale,
    xloc, widened L) [B x N_max]: the overlap widens the lengths in place
    in the reference, so a caller dividing by them afterwards (the flint
    loss) divides by the widened ones — the reference's quirk."""
    t_valid = t_valid.to(torch.float32)[:, None]  # [B x 1]
    pis = torch.cumsum(L, dim=1) - L
    L = L * (1.0 + 2.0 * overlap)
    pis = pis - L * (overlap / 2.0)
    safe_L = torch.where(seg_valid, torch.clamp(L, min=1e-6), 1.0)
    scale = t_valid / safe_L
    xloc = -(pis + safe_L / 2.0 - t_valid / 2.0) / (safe_L / 2.0)
    return scale, xloc, L


def create_masks_padded(t_pad: int, t_valid, L, seg_valid, overlap: float = 0.0,
                        template: str = "box") -> torch.Tensor:
    """Segment masks [B x N_max x t_pad] from absolute lengths L [B x N_max]
    (0 at padded segments), true frame counts t_valid [B] and the segment
    validity seg_valid [B x N_max] (bool).  Exact zeros at padded segments
    and frames; at valid positions the values of the reference's
    create_masks(T_i, L[:N_i]), placed by `mask_placement`."""
    s, x, _ = mask_placement(t_valid, L, seg_valid, overlap)
    t_valid = t_valid.to(torch.float32)[:, None]  # [B x 1]
    t_ids = torch.arange(t_pad, dtype=torch.float32, device=L.device)
    # align_corners=True output grid over the valid extent
    g = -1.0 + 2.0 * t_ids[None, :] / torch.clamp(t_valid - 1.0, min=1.0)  # [B x T]
    u = s[:, :, None] * g[:, None, :] + x[:, :, None]
    c = (u + 1.0) * 0.5 * (TEMPLATE_WIDTH - 1)
    out = _sample_template(c, template)
    frame_ok = t_ids[None, None, :] < t_valid[:, :, None]
    return torch.where(seg_valid[:, :, None] & frame_ok, out, 0.0)
