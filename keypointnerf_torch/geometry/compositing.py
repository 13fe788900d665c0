"""Alpha compositing of per-sample radiance along rays.

Port of `keypointnerf_tpu/geometry/compositing.py`: contribution weights
are (1 - exp(-alpha * dist)) * transmittance, with a 1e10 tail interval.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeOut(NamedTuple):
    color: torch.Tensor    # (..., 3) composited color
    depth: torch.Tensor    # (...,) expected depth
    acc: torch.Tensor      # (...,) accumulated opacity
    contrib: torch.Tensor  # (..., D) per-sample contribution weights
    sdf: torch.Tensor      # (...,) expected sdf-proxy value


def composite(alpha, sdf, rgb, z) -> CompositeOut:
    """alpha, sdf, z: (..., D); rgb: (..., D, 3); z sorted along D."""
    dist = torch.cat(
        [z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1
    )
    a = 1.0 - torch.exp(-alpha * dist)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(a[..., :1]), 1.0 - a[..., :-1]], dim=-1),
        dim=-1,
    )
    contrib = a * trans

    color = (rgb * contrib[..., None]).sum(dim=-2)
    acc = contrib.sum(dim=-1)
    sdf_out = (sdf * contrib).sum(dim=-1) / (acc + 1e-8)
    depth = (z * contrib).sum(dim=-1) / (acc + 1e-8)
    return CompositeOut(color, depth, acc, contrib, sdf_out)
