"""Relative spatial encoding of 3D keypoints.

Port of `keypointnerf_tpu/models/spatial_encoding.py`, all nine `sp_type`
variants. The zju default is `rel_z_decay`: per-view camera-space depth
deltas to K keypoints, sin/cos positionally encoded at `sp_level` octaves
and weighted by a Gaussian 3D-distance decay exp(-||dxyz||^2 / 2 sigma^2).
That branch and `positional_encoding` live in `ops/rel_z_decay.py`, whose
op's plain version they are.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import constant
from ..ops.rel_z_decay import positional_encoding, rel_z_decay_encode


@dataclasses.dataclass(frozen=True)
class SpatialEncodingConfig:
    sp_level: int = 3
    sp_type: str = "rel_z_decay"
    scale: float = 1.0
    sigma: float = 0.1
    n_kpt: int = 24
    center: tuple = (0.0, 0.0, 0.0)


def spatial_encoding_dim(cfg: SpatialEncodingConfig) -> int:
    """Output feature width."""
    t = cfg.sp_type
    if t in ("z", "rel_z", "rel_z_decay"):
        if "rel" in t:
            return (1 + 2 * cfg.sp_level) * cfg.n_kpt
        return 1 + 2 * cfg.sp_level
    if "xyz" in t:
        if "rel" in t:
            return (1 + 2 * cfg.sp_level) * 3 * cfg.n_kpt
        return (1 + 2 * cfg.sp_level) * 3
    return 0


def spatial_encode(
    cfg: SpatialEncodingConfig,
    pts_world,      # (N, 3) query points in world space
    pts_cam,        # (V, N, 3) query points in each source camera frame
    kpt_world,      # (K, 3) 3D keypoints in world space
    kpt_cam,        # (V, K, 3) keypoints in each source camera frame
    z_ndc=None,     # (V, N, 1) NDC depth (for sp_type == "z"/"ixyz")
    xy_ndc=None,    # (V, N, 2) NDC xy (for sp_type == "ixyz")
    model_T=None,   # (4, 4) world->model transform (for "mxyz"/"rel_mxyz")
):
    """The spatial encoding of every (view, point) pair: (V, N, D) with
    D = spatial_encoding_dim(cfg), or None for an unknown type."""
    t = cfg.sp_type
    L = cfg.sp_level
    s = cfg.scale
    V = pts_cam.shape[0]

    if t == "z":
        return positional_encoding(z_ndc, L)
    if t == "ixyz":
        return positional_encoding(torch.cat([xy_ndc, z_ndc], -1), L)
    if t == "cxyz":
        return positional_encoding(pts_cam, L)
    if t == "wxyz":
        center = constant(tuple(cfg.center), pts_world.dtype, pts_world.device)
        out = positional_encoding(s * (pts_world - center), L)
        return out.expand((V,) + out.shape)
    if t == "mxyz":
        m = pts_world @ model_T[:3, :3].T + model_T[:3, 3]
        out = positional_encoding(s * m, L)
        return out.expand((V,) + out.shape)

    # relative variants need keypoints
    if t == "rel_z":
        dz = s * (pts_cam[:, :, None, 2] - kpt_cam[:, None, :, 2])  # (V, N, K)
        return positional_encoding(dz, L)
    if t == "rel_z_decay":
        return rel_z_decay_encode(pts_cam, kpt_cam, L, cfg.sigma, s)
    if t == "rel_cxyz":
        d = s * (pts_cam[:, :, None, :] - kpt_cam[:, None, :, :])   # (V, N, K, 3)
        return positional_encoding(d.reshape(V, d.shape[1], -1), L)
    if t == "rel_wxyz":
        d = pts_world[None, :, None, :] - kpt_world[None, None, :, :]
        d = d.expand((V,) + d.shape[1:])
        return positional_encoding(d.reshape(V, d.shape[1], -1), L)
    if t == "rel_mxyz":
        m = pts_world @ model_T[:3, :3].T + model_T[:3, 3]
        km = kpt_world @ model_T[:3, :3].T + model_T[:3, 3]
        d = s * (m[:, None, :] - km[None, :, :])                   # (N, K, 3)
        out = positional_encoding(d.reshape(d.shape[0], -1), L)
        return out.expand((V,) + out.shape)

    return None
