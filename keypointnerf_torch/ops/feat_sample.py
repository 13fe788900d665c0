"""Bilinear feature sampling at continuous image locations (forward only).

Port of the forward of `keypointnerf_tpu/ops/feat_sample.py`
(`bilinear_sample` / `multiview_bilinear_sample`): torch `grid_sample`
semantics with mode='bilinear', padding_mode='border', align_corners=True.

  * NDC [-1, 1] maps to pixel centers [0, S-1] (align_corners).
  * Coordinates are clamped to the border before the corner/weight split.
  * The 2x2 patch base is clamped to S-2 and the fractional weight is
    re-derived against it (at x = S-1 the weight is 1.0 on the second
    column), which reproduces border padding exactly.

This is plain PyTorch indexing; it serves the coarse 64-ch map and the
packed 12-ch "full" map. The corner weights are built in f32 and cast once
to the map dtype; each weighted corner is rounded to the map dtype and the
4-term sum is taken in f32 and rounded once, which is how the JAX
package's program evaluates the bf16 blend on the CPU (bit-equal there,
tests/test_torch_ops.py).
"""
from __future__ import annotations

import torch


def bilinear_coords(xy, H, W):
    """Border-clamped corner indices and weights of NDC points.

    xy: (..., 2) f32 NDC. Returns (x0, y0) int64 patch bases in
    [0, W-2] x [0, H-2] and the f32 fractional weights (wx, wy).
    """
    x = ((xy[..., 0] + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1.0)
    y = ((xy[..., 1] + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(max=W - 2)
    y0 = torch.floor(y).clamp(max=H - 2)
    return x0.long(), y0.long(), x - x0, y - y0


def gather_corners(feats, x0, y0):
    """The four (V, N, C) corner rows [M00, M01, M10, M11] of a
    (V, H, W, C) map at per-view bases (V, N); M01 is (y0, x0 + 1)."""
    V, H, W, C = feats.shape
    flat = feats.reshape(V * H * W, C)
    view = torch.arange(V, device=feats.device)[:, None]
    base = (view * H + y0) * W + x0
    return [flat[base + off] for off in (0, 1, W, W + 1)]


def multiview_bilinear_sample(feats, xy):
    """Sample V feature maps at per-view locations.

    feats: (V, H, W, C); xy: (V, N, 2) NDC. Returns (V, N, C) in
    feats.dtype.
    """
    V, H, W, C = feats.shape
    x0, y0, wx, wy = bilinear_coords(xy.float(), H, W)
    w00 = (1.0 - wy) * (1.0 - wx)
    w01 = (1.0 - wy) * wx
    w10 = wy * (1.0 - wx)
    w11 = wy * wx
    dt = feats.dtype
    out = None
    for m, w in zip(gather_corners(feats, x0, y0), (w00, w01, w10, w11)):
        term = (m * w.to(dt)[..., None]).float()
        out = term if out is None else out + term
    return out.to(dt)


def bilinear_sample(feat, xy):
    """One (H, W, C) map at (N, 2) NDC points -> (N, C)."""
    return multiview_bilinear_sample(feat[None], xy[None])[0]
