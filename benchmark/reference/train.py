"""The zju training step in plain float32: the patch forward with the
step's draws, the loss (coarse and fine L1, the VGG19 feature loss) and
Adam, as functions of a dict of parameters.

The draws (patch centre, stratified and importance uniforms, per-query
view keep and radiance noise) are inputs: the benchmark makes them from
the seed and hands the same tensors to the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .model import (aabb, abs_sel, camera_rays, composite, encode, eval_density, importance_z,
                    pixel_grid, stratified)
from .params import VGG_SLICES
from .precision import Precision

VGG_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def patch_pixels(m, tar_mask, patch_index):
    """The (P*P, 2) (x, y) pixels of the patch centred on flat pixel
    `patch_index`, the window shifted inside the frame."""
    H, W = tar_mask.shape[:2]
    ph, pw = m["patch_h"], m["patch_w"]
    cy, cx = patch_index // W, patch_index % W
    x0 = torch.clamp(cx - pw // 2, 0, max(W - pw, 0))
    y0 = torch.clamp(cy - ph // 2, 0, max(H - ph, 0))
    grid = pixel_grid(ph, pw, tar_mask.device) + torch.stack([x0, y0])
    hi = torch.tensor([W - 1, H - 1], device=tar_mask.device)
    return torch.minimum(grid.clamp(min=0), hi)


def forward(P: Precision, prm, m, vb, draws):
    """The training patch: rgb coarse / fine (P*P, 3) and the target."""
    feats = encode(P, prm, m, vb["src_images"], vb["src_masks"], train=True)
    pix = patch_pixels(m, vb["tar_mask"], draws["patch_index"])
    origin, dirs, near, far = camera_rays(pix.float(), vb["tar_K"], vb["tar_R"], vb["tar_t"],
                                          m["znear"], m["zfar"])
    R = dirs.shape[0]
    nc, nf = m["n_coarse"], m["n_fine"]
    z1, z2, hit = aabb(vb["bounds"], origin, dirs)
    near = torch.where(hit & (z1 > near), z1, near)
    far = torch.where(hit & (z2 < far), z2, far)
    z = stratified(near, far, nc, draws["strat_u"])
    pts = origin + dirs[:, None, :] * z[..., None]
    alpha, sdf, rgb = eval_density(P, prm, m, pts.reshape(-1, 3),
                                   dirs[:, None, :].expand(pts.shape).reshape(-1, 3), feats, vb,
                                   nc, draws["coarse"])
    c = composite(alpha.reshape(R, nc), sdf.reshape(R, nc), rgb.reshape(R, nc, 3), z)
    z_fine = importance_z(c["contrib"][:, 1:-1].detach(), 0.5 * (z[:, 1:] + z[:, :-1]), nf,
                          draws["importance_u"])
    z_all = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1).values
    pts = origin + dirs[:, None, :] * z_all[..., None]
    na = nc + nf
    alpha, sdf, rgb = eval_density(P, prm, m, pts.reshape(-1, 3),
                                   dirs[:, None, :].expand(pts.shape).reshape(-1, 3), feats, vb,
                                   na, draws["fine"])
    f = composite(alpha.reshape(R, na), sdf.reshape(R, na), rgb.reshape(R, na, 3), z_all)
    W = vb["tar_image"].shape[1]
    flat = (pix[:, 1] * W + pix[:, 0]).long()
    return {"rgb_coarse": c["color"], "rgb_fine": f["color"],
            "target_rgb": vb["tar_image"].reshape(-1, 3)[flat]}


def vgg_features(P: Precision, vgg, x):
    """The four VGG19 slices of (B, H, W, 3) images in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x.permute(0, 3, 1, 2) - mean) / std
    outs, prev = [], None
    for si, widths in enumerate(VGG_SLICES):
        for wi, w in enumerate(widths):
            if prev is not None and w != prev:
                x = F.max_pool2d(x, 2)
            name = f"convs.conv_{si}_{wi}"
            x = F.relu(F.conv2d(P.q(x), P.q(vgg[f"{name}.weight"]), vgg[f"{name}.bias"],
                                padding=1))
            prev = w
        outs.append(x)
    return outs


def losses(P: Precision, m, loss_cfg, vgg, out) -> Dict[str, torch.Tensor]:
    """The loss terms by the program's names, and their sum e_all."""
    ph, pw = m["patch_h"], m["patch_w"]
    tar = out["target_rgb"]
    err = {}
    if loss_cfg["lambda_l1_c"] > 0.0:
        err["e_pix_c"] = loss_cfg["lambda_l1_c"] * abs_sel(out["rgb_coarse"] - tar).mean()
    if loss_cfg["lambda_l1"] > 0.0:
        err["e_pix_l1"] = loss_cfg["lambda_l1"] * abs_sel(out["rgb_fine"] - tar).mean()
    if loss_cfg["lambda_vgg"] > 0.0:
        fp = vgg_features(P, vgg, out["rgb_fine"].reshape(1, ph, pw, 3))
        ft = vgg_features(P, vgg, tar.reshape(1, ph, pw, 3).detach())
        loss = 0.0
        for w, a, b in zip(VGG_WEIGHTS, fp, ft):
            loss = loss + w * abs_sel(a - b.detach()).mean()
        err["e_vgg"] = loss_cfg["lambda_vgg"] * loss
    total = torch.zeros((), device=tar.device)
    for v in err.values():
        total = total + v
    err["e_all"] = total
    return err


class Adam:
    """Adam with optax's constants (eps 1e-8 outside the root), constant
    learning rate, no clipping: the zju recipe's optimizer."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1, b2, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def run_steps(P: Precision, prm, vgg, m, loss_cfg, optim, batches: List, draws: List):
    """len(batches) steps from parameters `prm` (updated in place). Returns
    each step's loss terms (floats) and the first step's gradients."""
    params = {k: v.requires_grad_(True) for k, v in prm.items()}
    opt = Adam(params, optim["learning_rate"], optim["beta1"], optim["beta2"])
    terms, first = [], None
    for vb, d in zip(batches, draws, strict=True):
        err = losses(P, m, loss_cfg, vgg, forward(P, params, m, vb, d))
        names = list(params)
        grads = torch.autograd.grad(err["e_all"], [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        terms.append({k: float(v.detach()) for k, v in err.items()})
        del err, grads
    for v in params.values():
        v.requires_grad_(False)
    return terms, first
