"""IBRNet-style color blending head.

Port of `keypointnerf_tpu/models/ibr_head.py` in the original state_dict
layout (`ani_al`, `ray_encoder.{0,2}`, `base_layer.{0,2}`,
`vis_layer1.{0,2}`, `vis_layer2.{0,2}`, `out_layer.{0,2,4}`). It keeps
the renderer's view-major (V, N, C) layout and reduces over axis 0.

Dtypes follow the JAX head: a plain dense layer runs in the compute dtype
(inputs, weight and bias cast, output in the compute dtype); the two
layers whose input is a concat (`base_layer.0` over [mean, var, feats],
`out_layer.0` over [x, vis, ray_diffs]) contract each block separately
with f32 accumulation and an f32 bias, the mean/var blocks before their
broadcast over views.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mlp import dot_f32


def dense(layer: nn.Linear, x, dtype):
    """flax `nn.Dense(dtype=...)`: everything cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def split_dense(layer: nn.Linear, xs, dtype):
    """Dense over a tuple of inputs, the concat folded into the product."""
    out, off = None, 0
    for a in xs:
        d = dot_f32(a, layer.weight[:, off : off + a.shape[-1]], dtype)
        off += a.shape[-1]
        out = d if out is None else out + d
    return out + layer.bias


class IBRRenderingHead(nn.Module):
    """Predict per-point RGB by blending source-view pixels.

    Inputs are view-major (V, N, C); returns (N, 3) f32.
    """

    def __init__(self, in_feat_ch=32, dtype=torch.float32):
        super().__init__()
        width = in_feat_ch + 3
        self.dtype = dtype
        self.ani_al = nn.Parameter(torch.tensor(0.2))
        self.ray_encoder = nn.Sequential(
            nn.Linear(4, 16), nn.ELU(), nn.Linear(16, width), nn.ELU())
        self.base_layer = nn.Sequential(
            nn.Linear(width * 3, 64), nn.ELU(), nn.Linear(64, 32), nn.ELU())
        self.vis_layer1 = nn.Sequential(
            nn.Linear(32, 32), nn.ELU(), nn.Linear(32, 33), nn.ELU())
        self.vis_layer2 = nn.Sequential(
            nn.Linear(32, 32), nn.ELU(), nn.Linear(32, 1), nn.Sigmoid())
        self.out_layer = nn.Sequential(
            nn.Linear(32 + 1 + 4, 16), nn.ELU(), nn.Linear(16, 8), nn.ELU(),
            nn.Linear(8, 1))

    def forward(self, rgb_feats, ray_diffs, proj_mask):
        """rgb_feats (V, N, in_feat_ch + 3) [src RGB | tex feat | geo
        latent]; ray_diffs (V, N, 4); proj_mask (V, N, 1)."""
        dt = self.dtype
        re, bl = self.ray_encoder, self.base_layer
        v1, v2, ol = self.vis_layer1, self.vis_layer2, self.out_layer

        dir_feat = F.elu(dense(re[0], ray_diffs, dt))
        dir_feat = F.elu(dense(re[2], dir_feat, dt))
        src_rgb = rgb_feats[..., :3]
        feats = rgb_feats + dir_feat

        dot = ray_diffs[..., 3:4]
        # f32 as in JAX (f32 param x bf16 array -> f32); torch would keep a
        # 0-dim f32 tensor times a bf16 tensor in bf16
        exp_dot = torch.exp(self.ani_al.abs() * (dot - 1.0).float())
        w = (exp_dot - exp_dot.amin(dim=0, keepdim=True)) * proj_mask
        w = w / (w.sum(dim=0, keepdim=True) + 1e-8)

        mean = (feats * w).sum(dim=0, keepdim=True)               # (1, N, width)
        var = (w * (feats - mean) ** 2).sum(dim=0, keepdim=True)
        x = F.elu(split_dense(bl[0], (mean, var, feats), dt))
        x = F.elu(dense(bl[2], x, dt))

        pred = F.elu(dense(v1[2], F.elu(dense(v1[0], x * w, dt)), dt))
        res, vis = pred[..., :-1], pred[..., -1:]
        x = x + res
        vis = torch.sigmoid(dense(
            v2[2], F.elu(dense(v2[0], x * torch.sigmoid(vis) * proj_mask, dt)), dt))
        vis = vis * proj_mask

        x = split_dense(ol[0], (x, vis, ray_diffs), dt)
        x = dense(ol[4], F.elu(dense(ol[2], F.elu(x), dt)), dt)
        logits = torch.where(proj_mask == 0.0, torch.full_like(x, -1e9, dtype=torch.float32),
                             x.float())
        blend = torch.softmax(logits, dim=0)
        return (src_rgb * blend).sum(dim=0)
