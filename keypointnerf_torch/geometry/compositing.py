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


def _reversed_cumsum(t):
    return t.flip(-1).cumsum(-1).flip(-1)


class _Cumprod(torch.autograd.Function):
    """`torch.cumprod` along the last dim whose backward never waits on the
    device: torch's own reads back whether the input holds a zero to pick
    its formula. Without zeros the gradient is torch's, reversed_cumsum(g
    * y) / x; at a row's first zero it is the reversed cumsum of g times
    the product with that entry set to 1, and 0 after it."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        zero = x == 0
        first = zero & (zero.cumsum(-1) == 1)
        y1 = torch.cumprod(torch.where(first, torch.ones_like(x), x), dim=-1)
        at_zero = torch.where(first, _reversed_cumsum(g * y1), torch.zeros_like(x))
        return torch.where(zero, at_zero, _reversed_cumsum(y * g) / x)


def composite(alpha, sdf, rgb, z) -> CompositeOut:
    """alpha, sdf, z: (..., D); rgb: (..., D, 3); z sorted along D."""
    dist = torch.cat(
        [z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1
    )
    a = 1.0 - torch.exp(-alpha * dist)
    trans = _Cumprod.apply(
        torch.cat([torch.ones_like(a[..., :1]), 1.0 - a[..., :-1]], dim=-1))
    contrib = a * trans

    color = (rgb * contrib[..., None]).sum(dim=-2)
    acc = contrib.sum(dim=-1)
    sdf_out = (sdf * contrib).sum(dim=-1) / (acc + 1e-8)
    depth = (z * contrib).sum(dim=-1) / (acc + 1e-8)
    return CompositeOut(color, depth, acc, contrib, sdf_out)
