"""Pinhole camera math (batch-agnostic via broadcasting).

Port of `keypointnerf_tpu/geometry/cameras.py`, same conventions:

  * world -> camera:  x_c = R @ x_w + t          (R: (...,3,3), t: (...,3))
  * projection:       u_h = K @ x_c,  xy = u_h[:2] / u_h[2],  depth = u_h[2]
  * NDC xy in [-1, 1] with align_corners pixel convention:
        x_ndc = 2 * x_pix / (W - 1) - 1
  * NDC z in [-1, 1]:  z_ndc = 2 (z - znear) / (zfar - znear) - 1

The JAX package forces true f32 products here (`Precision.HIGHEST`). The
3x3/4x4 products below are broadcast multiply-sums, never `matmul`, so no
TF32 setting of the card can round them.
"""
from __future__ import annotations

import torch


def _mm(a, b):
    """(..., n, k) x (..., k, m) in plain f32 arithmetic (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def compose_krt(K, R, t):
    """4x4 composed projection matrix KRT = K4 @ [R|t; 0 0 0 1].

    K: (..., 3, 3), R: (..., 3, 3), t: (..., 3) -> (..., 4, 4).
    """
    batch = torch.broadcast_shapes(K.shape[:-2], R.shape[:-2], t.shape[:-1])
    eye = torch.eye(4, dtype=K.dtype, device=K.device).expand(batch + (4, 4))
    intrin = eye.clone()
    intrin[..., :3, :3] = K
    extrin = eye.clone()
    extrin[..., :3, :3] = R
    extrin[..., :3, 3] = t
    return _mm(intrin, extrin)


def world_to_cam(pts, R, t):
    """(..., N, 3) world points -> camera frame."""
    return _mm(pts, R.transpose(-1, -2)) + t[..., None, :]


def camera_center(R, t):
    """World-space camera origin: -R^T t. R: (...,3,3), t: (...,3)."""
    return -(R * t[..., :, None]).sum(-2)


def project_points(pts, krt):
    """Project world points with a composed KRT matrix.

    pts: (..., N, 3); krt: (..., 4, 4). Returns xy (..., N, 2) pixel
    coordinates and z (..., N, 1) camera-space depth.
    """
    A = krt[..., :3, :3]
    b = krt[..., :3, 3]
    vh = _mm(pts, A.transpose(-1, -2)) + b[..., None, :]
    z = vh[..., 2:3]
    xy = vh[..., :2] / z
    return xy, z


def ndc_xy(xy, width, height):
    """Pixel coords -> [-1, 1] NDC with align_corners convention."""
    sx = 2.0 / (width - 1.0)
    sy = 2.0 / (height - 1.0)
    return torch.stack([xy[..., 0] * sx - 1.0, xy[..., 1] * sy - 1.0], dim=-1)


def ndc_z(z, znear, zfar):
    """Depth -> [-1, 1] relative to the [znear, zfar] slab."""
    return 2.0 * (z - znear) / (zfar - znear) - 1.0


def pixel_grid(height, width, y_stride=1, x_stride=1, device=None):
    """(h*w, 2) int32 (x, y) pixel coordinates, row-major in y."""
    ys = torch.arange(0, height, y_stride, dtype=torch.int32, device=device)
    xs = torch.arange(0, width, x_stride, dtype=torch.int32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(-1, 2)


def camera_rays(pixels, K, R, t, znear, zfar):
    """World-space rays through pixel centers of a target camera.

    pixels: (..., N, 2) float (x, y); K, R: (..., 3, 3); t: (..., 3).
    Returns origins (..., 3), unit dirs (..., N, 3) and the per-ray metric
    near/far (..., N, 1) (the slab depths scaled by the camera-ray norm).
    """
    ones = torch.ones_like(pixels[..., :1])
    pix_h = torch.cat([pixels, ones], dim=-1)  # (..., N, 3)
    # inv_ex: inv's values without its singularity check, which reads a
    # flag back from the device
    inv_K = torch.linalg.inv_ex(K[..., :3, :3]).inverse
    dirs_cam = _mm(pix_h, inv_K.transpose(-1, -2))  # (..., N, 3)
    scale = torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    dirs_world = _mm(dirs_cam, R)  # row-vector form of R^T @ d
    dirs_world = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    origins = camera_center(R, t)
    return origins, dirs_world, znear * scale, zfar * scale
