"""The synthetic rig the traffic is made of: an analytic lambertian sphere
seen by calibrated cameras on a circle, with 24 stand-in keypoints.

The laws are those of the program's `data/synthetic.py` `make_sample`
(view 0 the target, views 1..n the sources, focal 80 px per 64 px of
image, cameras 3.5 from the centre at elevations in [-0.3, 0.3], the
sphere of radius 0.5, keypoints on a sphere of radius 0.3, bounds 1.1 x
the radius), copied here so that a change to the program cannot move the
inputs. A subject's few random numbers come from numpy's generator
seeded by the run's seed; the images are rendered in bulk on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RADIUS, CAM_DIST, FOCAL_PER_64, N_KPT = 0.5, 3.5, 80.0, 24


def look_at(eye, target=None, up=(0.0, -1.0, 0.0)):
    """World->camera (R, t), float64, camera z towards `target` (origin)."""
    eye = torch.as_tensor(eye, dtype=torch.float64)
    target = torch.zeros_like(eye) if target is None else torch.as_tensor(target).to(eye)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    upv = torch.tensor(up, dtype=torch.float64, device=eye.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, upv)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=-2)
    t = -(R @ eye[..., None])[..., 0]
    return R, t


def intrinsics(size: int, device) -> torch.Tensor:
    f = FOCAL_PER_64 * size / 64.0
    return torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], dtype=torch.float64,
                        device=device)


def render_sphere(K, R, t, size):
    """(C, H, W, 3) images in [0, 1] and (C, H, W, 1) masks of the sphere
    for C cameras (float64 geometry)."""
    dev = K.device
    ys, xs = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float64),
                            torch.arange(size, device=dev, dtype=torch.float64), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    d = (pix @ torch.linalg.inv(K).transpose(-1, -2)) @ R                      # (C, P, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    origin = -(R.transpose(-1, -2) @ t[..., None])[..., 0]      # (C, 3)
    b = 2.0 * (d * origin[:, None]).sum(-1)
    c = (origin * origin).sum(-1, keepdim=True) - RADIUS ** 2
    disc = b * b - 4.0 * c
    t_hit = (-b - torch.sqrt(disc.clamp(min=0.0))) / 2.0
    hit = (disc > 0.0) & (t_hit > 0.0)
    n = (origin[:, None] + d * t_hit[..., None]) / RADIUS
    ld = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float64, device=dev)
    lam = ((n @ (ld / torch.linalg.norm(ld))).clamp(0.0, 1.0))[..., None]
    rgb = torch.where(hit[..., None], (0.5 + 0.5 * n) * (0.35 + 0.65 * lam), 0.0)
    C = K.shape[0] if K.dim() == 3 else R.shape[0]
    img = rgb.clamp(0.0, 1.0).reshape(C, size, size, 3).float()
    return img, hit.reshape(C, size, size, 1).float()


def subject_numbers(rs: np.random.Generator, n_views: int):
    """A subject's random numbers, in make_sample's order: the rig's phase,
    the elevations, the keypoint directions."""
    phase = rs.uniform(0, 2 * np.pi) + np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    elev = rs.uniform(-0.3, 0.3, n_views)
    u = rs.normal(size=(N_KPT, 3))
    return phase, elev, u / np.linalg.norm(u, axis=-1, keepdims=True)


def make_subject(rs: np.random.Generator, size: int, n_views: int, device) -> dict:
    """One ViewBatch-shaped dict of float32 tensors on `device`."""
    phase, elev, u = subject_numbers(rs, n_views)
    eye = CAM_DIST * np.stack([np.cos(phase) * np.cos(elev), np.sin(elev),
                               np.sin(phase) * np.cos(elev)], -1)
    R, t = look_at(torch.as_tensor(eye, device=device))
    K = intrinsics(size, device)
    img, mask = render_sphere(K.expand(n_views, 3, 3), R, t, size)
    Kf = K.float()
    bound = 1.1 * RADIUS
    return {
        "src_images": (img[1:] * mask[1:]).contiguous(), "src_masks": mask[1:].contiguous(),
        "src_K": Kf.expand(n_views - 1, 3, 3).contiguous(), "src_R": R[1:].float(),
        "src_t": t[1:].float(), "tar_image": img[0], "tar_mask": mask[0], "tar_K": Kf,
        "tar_R": R[0].float(), "tar_t": t[0].float(),
        "kpt3d": torch.as_tensor(0.6 * RADIUS * u, dtype=torch.float32, device=device),
        "bounds": torch.tensor([[-bound] * 3, [bound] * 3], dtype=torch.float32, device=device),
    }


def orbit_cameras(start: float, n: int, degrees: float, size: int, radius: float,
                  elevation: float, device):
    """(K, R, t) of n cameras on the orbit, `degrees` apart from angle
    `start`, looking at the centre, K for a size x size frame."""
    ang = start + np.arange(n) * math.radians(degrees)
    eye = radius * np.stack([np.cos(ang), np.full(n, elevation), np.sin(ang)], -1)
    R, t = look_at(torch.as_tensor(eye, device=device))
    return intrinsics(size, device).float(), R.float(), t.float()
