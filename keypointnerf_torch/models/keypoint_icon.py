"""KeypointICON — single-image 3D human reconstruction (PyTorch).

Port of `keypointnerf_tpu/models/keypoint_icon.py`. The reference
reports that the relative keypoint spatial encoding can replace ICON's
SDF feature for monocular reconstruction (reference README.md:104-119:
Chamfer 1.539 / P2S 1.358 cm on CAPE) but ships no ICON code; the JAX
package provides it, and the port follows it line by line:

  * pixel-aligned features from ONE image (the stacked-hourglass
    `HGFilter`),
  * the `rel_z_decay` spatial encoding w.r.t. 3D body keypoints with V=1,
  * an implicit occupancy MLP (weight-normed, leaky ReLU 0.2, the input
    re-injected at layer 2),
  * a chunked occupancy grid on the device, surface samples from it, and
    Chamfer / point-to-surface metrics (numpy, as JAX's).

The map lookups are the plain bilinear gather (`ops.feat_sample.
bilinear_sample`), whose gradient is autograd's scatter, as JAX's ICON
takes the gather's own VJP (not the matmul VJP): no kernel runs on this
path. As in the JAX model, the NDC of a projection is taken against twice
the hires map's size (`img_h = hires height * 2`); the hires map is at the
input resolution, so the pixel-aligned lookups see the image's top-left
quarter (a reference-side quirk the port keeps, ROADMAP Queue 3).

State_dict: `encoder.*` (the reference HGFilter layout) and
`head.layers.{i}.linear.*`; `utils/convert.py:icon_state_dict_from_jax`
carries JAX parameters into it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
from ..geometry.cameras import compose_krt, ndc_xy, ndc_z, project_points, world_to_cam
from ..ops.feat_sample import bilinear_sample
from .cnn import HGFilter
from .mlp import MLP, abs_sel
from .spatial_encoding import SpatialEncodingConfig, spatial_encode, spatial_encoding_dim


@dataclasses.dataclass(frozen=True)
class KeypointICONConfig:
    sp_level: int = 3
    sp_type: str = "rel_z_decay"
    sp_sigma: float = 0.1
    n_kpt: int = 24
    geo_n_stack: int = 1
    geo_n_downsample: int = 4
    geo_out_ch: int = 64
    geo_out_ch_hd: int = 8
    mlp_hidden: Tuple[int, ...] = (512, 256, 128)
    znear: float = 2.0
    zfar: float = 5.0

    @property
    def sp_config(self) -> SpatialEncodingConfig:
        return SpatialEncodingConfig(sp_level=self.sp_level, sp_type=self.sp_type,
                                     sigma=self.sp_sigma, n_kpt=self.n_kpt)


class KeypointICON(nn.Module):
    """The model, built on `device` (CUDA unless named) with weights drawn
    from `seed` by `KeypointNeRF.init_weights`'s scheme."""

    def __init__(self, cfg: KeypointICONConfig, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        from .keypoint_nerf import KeypointNeRF

        self.cfg = c = cfg
        self.encoder = HGFilter(c.geo_n_stack, c.geo_n_downsample, c.geo_out_ch,
                                c.geo_out_ch_hd)
        in_dim = spatial_encoding_dim(c.sp_config) + c.geo_out_ch + c.geo_out_ch_hd
        self.head = MLP((in_dim,) + tuple(c.mlp_hidden) + (1,), skip_layers=(2,),
                        nl_layer="leakyrelu", weight_norm=True)
        KeypointNeRF.init_weights(self, seed)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.head.layers[0].linear.bias.device

    def encode(self, image):
        """image: (H, W, 3) in [0, 1] -> [coarse (1, H/4, W/4, 64), hires
        (1, H, W, 8)], channels last."""
        x = (2.0 * image - 1.0).permute(2, 0, 1)[None]
        return [f.permute(0, 2, 3, 1).contiguous() for f in self.encoder(x)]

    def query_occupancy(self, pts, feats, K, R, t, kpt3d):
        """Occupancy logits at N world points from one view.

        pts: (N, 3); K/R/t: single camera; kpt3d: (Kp, 3). Returns (N, 1)
        logits (sigmoid -> occupancy).
        """
        c = self.cfg
        krt = compose_krt(K, R, t)
        xy_pix, z = project_points(pts[None], krt[None])      # (1, N, 2)
        img_h = feats[1].shape[1] * 2
        img_w = feats[1].shape[2] * 2
        xy = ndc_xy(xy_pix, img_w, img_h)[0]                  # (N, 2)
        zn = ndc_z(z, c.znear, c.zfar)[0]                     # (N, 1)

        f_coarse = bilinear_sample(feats[0][0], xy)           # (N, 64)
        f_hd = bilinear_sample(feats[1][0], xy)               # (N, 8)

        pts_cam = world_to_cam(pts[None], R[None], t[None])   # (1, N, 3)
        kpt_cam = world_to_cam(kpt3d[None], R[None], t[None])
        sp = spatial_encode(c.sp_config, pts, pts_cam, kpt3d, kpt_cam,
                            z_ndc=zn[None], xy_ndc=xy[None])[0]  # (N, D)
        return self.head(torch.cat([sp, f_coarse, f_hd], dim=-1))

    def forward(self, image, pts, K, R, t, kpt3d):
        """Train-time forward: occupancy logits at sampled points."""
        return self.query_occupancy(pts, self.encode(image), K, R, t, kpt3d)


@torch.no_grad()
def occupancy_grid(model: KeypointICON, image, K, R, t, kpt3d, bounds,
                   resolution: int = 128, chunk: int = 65536):
    """Sigmoid occupancy on a dense grid inside `bounds`, on the model's
    device, `chunk` points a query. Inputs are tensors or arrays.

    Returns the (res, res, res) occupancy in [0, 1] (numpy) and the grid
    axes.
    """
    dev = model.device
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    axes = [np.linspace(lo[d], hi[d], resolution, dtype=np.float32) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = as_t(np.stack([gx, gy, gz], -1).reshape(-1, 3))
    image, K, R, t, kpt3d = (x if torch.is_tensor(x) else as_t(x)
                             for x in (image, K, R, t, kpt3d))
    feats = model.encode(image)
    occ = torch.cat([
        torch.sigmoid(model.query_occupancy(pts[s:s + chunk], feats, K, R, t, kpt3d)[..., 0])
        for s in range(0, pts.shape[0], chunk)])
    return occ.cpu().numpy().reshape(resolution, resolution, resolution), axes


def surface_points_from_grid(occ, axes, threshold: float = 0.5, max_points: int = 200000):
    """Extract surface samples at iso-crossings along the three grid axes
    with linear interpolation (marching-cubes-free surface extraction)."""
    pts = []
    occ = np.asarray(occ)
    ax = [np.asarray(a) for a in axes]
    for d in range(3):
        a = np.moveaxis(occ, d, 0)
        lo, hi = a[:-1], a[1:]
        cross = (lo - threshold) * (hi - threshold) < 0
        idx = np.argwhere(cross)
        if len(idx) == 0:
            continue
        i = idx[:, 0]
        frac = (threshold - lo[tuple(idx.T)]) / (hi[tuple(idx.T)] - lo[tuple(idx.T)] + 1e-12)
        coord_d = ax[d][i] + frac * (ax[d][i + 1] - ax[d][i])
        rest_axes = [k for k in range(3) if k != d]   # moveaxis order: d, then the rest
        coords = np.empty((len(idx), 3), np.float32)
        coords[:, d] = coord_d
        coords[:, rest_axes[0]] = ax[rest_axes[0]][idx[:, 1]]
        coords[:, rest_axes[1]] = ax[rest_axes[1]][idx[:, 2]]
        pts.append(coords)
    if not pts:
        return np.zeros((0, 3), np.float32)
    pts = np.concatenate(pts)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
    return pts


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 2048) -> float:
    """Symmetric Chamfer distance (mean of both directed means), in the
    units of the inputs — the CAPE protocol reports cm."""
    return 0.5 * (point_to_surface(a, b, chunk) + point_to_surface(b, a, chunk))


def point_to_surface(a: np.ndarray, b: np.ndarray, chunk: int = 2048) -> float:
    """Mean nearest-neighbor distance from each point of `a` to cloud `b`
    (P2S when `b` densely samples the surface)."""
    if len(a) == 0 or len(b) == 0:
        return float("inf")
    b = np.asarray(b, np.float32)
    total = 0.0
    for i in range(0, len(a), chunk):
        aa = np.asarray(a[i : i + chunk], np.float32)
        d2 = (
            np.sum(aa**2, -1)[:, None]
            - 2.0 * aa @ b.T
            + np.sum(b**2, -1)[None]
        )
        total += float(np.sqrt(np.maximum(d2.min(axis=1), 0.0)).sum())
    return total / len(a)


def bce_occupancy_loss(logits, labels):
    """Binary cross-entropy on occupancy logits (ICON/PIFu training loss),
    with `jnp.maximum`'s 0.5 tie split and `jnp.abs`'s +1 at 0 in its
    gradient."""
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
                      + torch.log1p(torch.exp(-abs_sel(logits))))


def make_icon_train_step(model: KeypointICON, learning_rate: float = 1e-3):
    """The BCE occupancy train step for single-image reconstruction, with
    torch Adam at optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8).

    Returns (optimizer, step_fn): step_fn(image, pts, labels, K, R, t,
    kpt3d) updates `model` in place and returns the loss (a 0-d tensor,
    before the update).
    """
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step_fn(image, pts, labels, K, R, t, kpt3d):
        opt.zero_grad(set_to_none=True)
        loss = bce_occupancy_loss(model(image, pts, K, R, t, kpt3d)[..., 0], labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return opt, step_fn
