"""Initializers and masked building blocks (mucon_tpu/models/layers.py).

Every tensor is channel-last [B x T x C] with per-video lengths [B], as in
the JAX package; padded frames are zeroed so a padded batch computes what
the reference computes on exact-length tensors.

The initializers draw the torch defaults the JAX package reproduces
(layers.py:17-38) from an explicit `torch.Generator`; they give other
numbers than `jax.random` for the same seed — the weight bridge
(`mucon_tpu_torch.convert`) carries JAX weights over exactly.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_linear_init_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """U(+-1/sqrt(fan_in)) — torch Linear/Conv default for weight AND bias
    (LSTM: fan_in = hidden)."""
    bound = 1.0 / math.sqrt(fan_in)
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def scaled_normal_init_(t: torch.Tensor, scale_dim: int, generator: torch.Generator):
    """randn(shape)/sqrt(scale_dim) — the reference's rand_p."""
    t.normal_(0.0, 1.0, generator=generator).div_(math.sqrt(scale_dim))


def time_mask(t_pad: int, lengths: torch.Tensor, dtype=torch.float32):
    """[B x t_pad] validity mask from per-video frame counts."""
    ids = torch.arange(t_pad, device=lengths.device)
    return (ids[None, :] < lengths[:, None]).to(dtype)


def mask_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero a [B x T x C] tensor beyond each video's length."""
    return x * time_mask(x.shape[1], lengths, x.dtype)[:, :, None]


def masked_group_norm(x, lengths, num_groups: int, scale, bias, eps: float = 1e-5):
    """GroupNorm over (channels-in-group x valid-time), per video: the
    statistics cover only the T_i valid frames (layers.py:53-72)."""
    B, T, C = x.shape
    G = num_groups
    m = time_mask(T, lengths, x.dtype)[:, :, None, None]
    xg = x.reshape(B, T, G, C // G)
    count = (lengths.to(x.dtype) * (C // G))[:, None]  # [B x 1]
    mean = torch.sum(xg * m, dim=(1, 3)) / count  # [B x G]
    var = torch.sum((xg - mean[:, None, :, None]) ** 2 * m, dim=(1, 3)) / count
    xn = (xg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + eps)
    return xn.reshape(B, T, C) * scale + bias


def nearest_upsample_indices(src_lengths, dst_len: int, dst_lengths):
    """[B x dst_len] source indices of the per-video nearest upsample,
    idx[b, t] = clip(floor(t * f32(src_b / dst_b))) — the same f32
    arithmetic as the JAX package (layers.py:75-85), not F.interpolate,
    so labels agree bit for bit.  Monotone non-decreasing in t."""
    t_ids = torch.arange(dst_len, device=src_lengths.device, dtype=torch.float32)
    scale = src_lengths.to(torch.float32) / torch.clamp(
        dst_lengths.to(torch.float32), min=1.0
    )
    idx = torch.floor(t_ids[None, :] * scale[:, None]).to(torch.int64)
    hi = torch.clamp(src_lengths.to(torch.int64) - 1, min=0)[:, None]
    return torch.minimum(torch.clamp(idx, min=0), hi)


def interpolate_nearest_time(x, src_lengths, dst_len: int, dst_lengths):
    """Per-video nearest-neighbor upsample along time (layers.py:88-96)."""
    idx = nearest_upsample_indices(src_lengths, dst_len, dst_lengths)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
