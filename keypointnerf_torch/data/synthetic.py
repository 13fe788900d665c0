"""Synthetic micro-dataset: an analytic lambertian sphere viewed by a
calibrated camera rig.

A numpy copy of `keypointnerf_tpu/data/synthetic.py` (`SyntheticConfig`,
`look_at`, `make_sample`, `SyntheticDataset`), kept here so the port builds its scenes without
importing the JAX package. The arrays are bit-identical to the JAX
package's for the same seed (tests/test_torch_geometry.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    image_size: int = 64
    n_views: int = 4           # 1 target + (n_views - 1) sources
    n_kpt: int = 24
    radius: float = 0.5        # sphere radius
    cam_dist: float = 3.5      # camera orbit radius
    focal: float = 80.0        # pixels (scaled with image_size/64)
    znear: float = 2.0
    zfar: float = 5.0


def look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """World->cam [R|t] with the camera z-axis pointing at `target`."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows = cam axes in world
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def render_sphere(K, R, t, size, radius, center, light_dir=(0.3, -0.5, 0.8)):
    """Analytic lambertian render of a sphere: returns (H, W, 3) image in
    [0, 1], (H, W, 1) mask and (H, W) depth."""
    H = W = size
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    dirs_cam = pix @ np.linalg.inv(K).T
    dirs = dirs_cam @ R  # rows: world dirs
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = -R.T @ t

    oc = origin - np.asarray(center)
    b = 2.0 * dirs @ oc
    c = oc @ oc - radius * radius
    disc = b * b - 4.0 * c
    hit = disc > 0.0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t_hit = (-b - sq) / 2.0
    hit &= t_hit > 0.0

    p = origin + dirs * t_hit[:, None]
    n = (p - center) / radius
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    lam = np.clip(n @ ld, 0.0, 1.0)
    # albedo varies with the normal so views are informative
    albedo = 0.5 + 0.5 * np.stack([n[:, 0], n[:, 1], n[:, 2]], -1)
    rgb = albedo * (0.35 + 0.65 * lam[:, None])
    rgb = np.where(hit[:, None], rgb, 0.0)
    depth = np.where(hit, (R @ (p - origin).T)[2], 0.0)

    img = np.clip(rgb, 0.0, 1.0).reshape(H, W, 3).astype(np.float32)
    mask = hit.reshape(H, W, 1).astype(np.float32)
    return img, mask, depth.reshape(H, W).astype(np.float32)


def make_sample(cfg: SyntheticConfig = SyntheticConfig(), seed: int = 0):
    """Build one ViewBatch-shaped dict of numpy arrays.

    View 0 is the target; views 1..n are sources.
    """
    rs = np.random.default_rng(seed)
    size = cfg.image_size
    center = np.zeros(3)
    f = cfg.focal * size / 64.0
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)

    phases = rs.uniform(0, 2 * np.pi) + np.linspace(0, 2 * np.pi, cfg.n_views, endpoint=False)
    elev = rs.uniform(-0.3, 0.3, cfg.n_views)
    images, masks, Rs, ts = [], [], [], []
    for ph, el in zip(phases, elev):
        eye = center + cfg.cam_dist * np.array(
            [np.cos(ph) * np.cos(el), np.sin(el), np.sin(ph) * np.cos(el)]
        )
        R, t = look_at(eye, center)
        img, msk, _ = render_sphere(K, R, t, size, cfg.radius, center)
        images.append(img)
        masks.append(msk)
        Rs.append(R)
        ts.append(t)

    images = np.stack(images)
    masks = np.stack(masks)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # keypoints: points on a small interior sphere (a stand-in skeleton)
    u = rs.normal(size=(cfg.n_kpt, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    kpt3d = (0.6 * cfg.radius * u).astype(np.float32)

    bounds = np.stack(
        [center - 1.1 * cfg.radius, center + 1.1 * cfg.radius]
    ).astype(np.float32)

    Kv = np.broadcast_to(K, (cfg.n_views, 3, 3)).copy()
    return {
        "src_images": images[1:] * masks[1:],
        "src_masks": masks[1:],
        "src_K": Kv[1:],
        "src_R": Rs[1:],
        "src_t": ts[1:],
        "tar_image": images[0],
        "tar_mask": masks[0],
        "tar_K": K,
        "tar_R": Rs[0],
        "tar_t": ts[0],
        "kpt3d": kpt3d,
        "bounds": bounds,
    }


class SyntheticDataset:
    """Indexable dataset of ViewBatch-shaped numpy dicts: sample i is
    `make_sample(cfg, seed=i)`."""

    def __init__(self, cfg: SyntheticConfig = SyntheticConfig(), length: int = 16):
        self.cfg = cfg
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        return make_sample(self.cfg, seed=idx)
