"""Ray / axis-aligned-bounding-box intersection.

Port of `keypointnerf_tpu/geometry/aabb.py`: the reference's six-plane
"exactly two hits" test, fixed-shape and masked.
"""
from __future__ import annotations

import torch

from ..device import constant


def ray_aabb_intersection(bounds, origins, dirs, boffset=(-0.01, 0.01), eps=1e-6):
    """Intersect rays with an AABB.

    A ray hits iff exactly two of its six plane crossings lie on the box.
    Near/far are |t| of those crossings (metric for unit directions).

    bounds: (..., 2, 3) [min_xyz, max_xyz]; origins: (..., 3) or
    (..., N, 3); dirs: (..., N, 3). Returns near, far (..., N, 1), 1.0
    where there is no hit, and the hit mask (..., N, 1) bool.
    """
    off = constant(tuple(boffset), bounds.dtype, bounds.device)
    bounds = bounds + off[:, None]
    if origins.dim() < dirs.dim():
        origins = origins[..., None, :]
    d = torch.where(dirs.abs() < 1e-5, torch.full_like(dirs, 1e-5), dirs)

    # t of the 6 axis-plane crossings: (..., N, 2, 3) -> (..., N, 6)
    tt = (bounds[..., None, :, :] - origins[..., :, None, :]) / d[..., :, None, :]
    t6 = tt.reshape(*tt.shape[:-2], 6)

    p = origins[..., :, None, :] + t6[..., :, None] * d[..., :, None, :]
    lo = bounds[..., None, 0:1, :] - eps
    hi = bounds[..., None, 1:2, :] + eps
    on_box = ((p >= lo) & (p <= hi)).all(dim=-1)  # (..., N, 6)

    hit = on_box.to(torch.int32).sum(dim=-1) == 2

    dist = t6.abs()
    inf = torch.full_like(dist, float("inf"))
    near = torch.where(on_box, dist, inf).amin(dim=-1)
    far = torch.where(on_box, dist, -inf).amax(dim=-1)

    one = torch.ones_like(near)
    near = torch.where(hit, near, one)
    far = torch.where(hit, far, one)
    return near[..., None], far[..., None], hit[..., None]
