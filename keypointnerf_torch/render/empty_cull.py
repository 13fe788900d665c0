"""Exact empty-ray culling for full-image inference.

Port of `keypointnerf_tpu/render/empty_cull.py`. A ray whose every
sample point fails the all-view foreground test (fg > 0.1 in every
source view) composites to exactly zero, because the model multiplies
the radiance by that validity. This module bounds, per ray, the
foreground value its points can see in their worst view; rays whose
bound stays at or below EMPTY_SCORE_THRESHOLD are provably zero and the
renderer marches only the rest.

Why the bound is conservative:
1. Sample placement is the renderer's own: the same stratified and
   uniform-importance expressions, including the fine depths an all-zero
   ray gets from the +1e-5 importance floor. A culled ray's predicted
   points are its real points.
2. The bound is built from the mask the model samples: `src_masks`, or
   with the fused map its mask channel on its own (possibly half-res,
   fractional-valued) grid. Each view's mask is max-pooled into
   (cell+1)-wide windows strided by `cell` map pixels, so the cell holding
   a clamped map coordinate covers all four bilinear corners:
   bilinear(p) <= max(corners) <= cell max.
3. The cell values are rounded to bf16, as the JAX package's one-hot
   lookup does, so the scores equal JAX's; that rounding and the model's
   bf16 blend stay within the 0.01 margin below the 0.1 validity test.
4. The frustum part of the validity test is ignored: it can only make
   more points invalid.
5. With `gather_lerp` a non-anchor sample sees, per view, a convex mix of
   its segment's two anchor values, so the per-sample all-view bound is
   unsound. Two sound bounds replace it:
   - tight (`reuse_coarse_eval`, no `separate_cf`: the model looks up the
     coarse and the fine depths as two groups, each only at its anchors,
     every stride-th sample and the last): only the anchors are scored.
     A sample of segment j mixes anchors j and j + 1, so per view a
     window-3 max over the anchor axis covers it; the score is the max
     over both groups of (max over anchors of min over views of that);
   - loose (any other decomposition): min over views of the max over
     all the ray's samples, which bounds any mix along the ray.
   The bound follows `cfg.gather_lerp` alone, also where `use_dma_gather`
   turns the lerp off in the query (as the JAX package chooses).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..geometry.aabb import ray_aabb_intersection
from ..geometry.cameras import compose_krt, ndc_xy, project_points
from ..geometry.sampling import importance_z, stratified_z

# Rays with score <= threshold are provably all-invalid.
EMPTY_SCORE_THRESHOLD = 0.09


def conservative_mask_cells(masks, cell):
    """Dilated max-pool of per-view masks onto a coarse cell grid.

    masks: (V, H, W, 1) f32 (>= 0); cell: int cell size in pixels.
    Returns (V, Hc, Wc), Hc = (H-1)//cell + 1: each cell holds the max over
    pixels [cy*cell, cy*cell + cell] x [cx*cell, cx*cell + cell] (the
    inclusive high edge covers the corner x0 + 1 of a clamped coordinate).
    """
    V, H, W = masks.shape[:3]
    hc = (H - 1) // cell + 1
    wc = (W - 1) // cell + 1
    pad_h = (hc - 1) * cell + cell + 1 - H
    pad_w = (wc - 1) * cell + cell + 1 - W
    m = F.pad(masks[..., 0], (0, pad_w, 0, pad_h))  # zero pad: masks are >= 0
    return F.max_pool2d(m[:, None], cell + 1, stride=cell)[:, 0]


def _cell_lookup(cmax, cy, cx):
    """(V, P) bf16-rounded cell values at int cell indices (V, P)."""
    V, hc, wc = cmax.shape
    flat = cmax.to(torch.bfloat16).float().reshape(-1)
    view = torch.arange(V, device=cmax.device)[:, None]
    return flat[(view * hc + cy) * wc + cx]


def empty_ray_scores(cfg, vb, origin, dirs, near, far, cell=8, score_chunk=4096,
                     feats=None):
    """Per-ray conservative foreground scores.

    cfg: KeypointNeRFConfig (n_coarse / n_fine / znear / zfar); vb:
    ViewBatch; origin (3,); dirs (R, 3); near, far (R, 1); `feats` the dict
    from `KeypointNeRF.encode`, required with `cfg.fused_feature_map` (the
    bound is then the fused map's mask channel). Returns (R,) f32;
    score <= EMPTY_SCORE_THRESHOLD => the ray's output is exactly zero.
    Rays are scored `score_chunk` at a time to bound memory; the scores do
    not depend on the chunking.
    """
    H, W = vb.src_masks.shape[1:3]          # the NDC convention of the projection
    if feats is not None and "fused" in feats:
        base = cfg.geo_out_ch + cfg.geo_out_ch_hd + cfg.tex_out_ch
        mask_map = feats["fused"][..., base + 3 : base + 4]
    elif cfg.fused_feature_map:
        raise ValueError(
            "empty_ray_scores: cfg.fused_feature_map requires feats= (the bound "
            "must be built from the fused map's mask channel)")
    else:
        mask_map = vb.src_masks
    V, Hm, Wm = mask_map.shape[:3]
    lerp_mode = (feats is not None and "fused" in feats
                 and cfg.gather_lerp and cfg.gather_lerp_stride >= 2)
    lerp_tight = lerp_mode and cfg.reuse_coarse_eval and not cfg.separate_cf
    if lerp_tight:
        # each group's anchor positions: every stride-th sample and the last
        k = cfg.gather_lerp_stride
        anchors = lambda S: torch.cat([torch.arange(0, S, k), torch.tensor([S - 1])])  # noqa: E731
        ia_c = anchors(cfg.n_coarse).to(dirs.device)
        ia_f = anchors(cfg.n_fine).to(dirs.device)
    cmax = conservative_mask_cells(mask_map.float(), cell)
    krt = compose_krt(vb.src_K, vb.src_R, vb.src_t)

    z1, z2, hit = ray_aabb_intersection(vb.bounds, origin, dirs)
    near = torch.where(hit & (z1 > near), z1, near)
    far = torch.where(hit & (z2 < far), z2, far)

    scores = []
    for s in range(0, dirs.shape[0], score_chunk):
        d, nr, fr = dirs[s:s + score_chunk], near[s:s + score_chunk], far[s:s + score_chunk]
        z = stratified_z(nr, fr, cfg.n_coarse)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        zf = importance_z(torch.zeros_like(z[..., : cfg.n_coarse - 2]), z_mid, cfg.n_fine)
        if lerp_tight:
            z_all = torch.cat([z[:, ia_c], zf[:, ia_f]], dim=-1)
        else:
            z_all = torch.cat([z, zf], dim=-1)                   # (c, S)
        pts = origin + d[:, None, :] * z_all[..., None]
        xy_pix, _ = project_points(pts.reshape(1, -1, 3), krt)   # (V, c*S, 2)
        xy = ndc_xy(xy_pix, W, H)
        # the sampler's NDC -> pixel map and border clamp, onto the map grid
        px = ((xy[..., 0] + 1.0) * 0.5 * (Wm - 1)).clamp(0.0, Wm - 1.0)
        py = ((xy[..., 1] + 1.0) * 0.5 * (Hm - 1)).clamp(0.0, Hm - 1.0)
        cx = torch.floor(px / cell).long()
        cy = torch.floor(py / cell).long()
        vals = _cell_lookup(cmax, cy, cx).reshape(V, -1, z_all.shape[-1])
        if lerp_tight:
            # max_pool1d pads with -inf, as reduce_window's SAME padding does
            group = lambda v: F.max_pool1d(v, 3, stride=1, padding=1).amin(0).amax(-1)  # noqa: E731
            n_c = ia_c.shape[0]
            scores.append(torch.maximum(group(vals[..., :n_c]), group(vals[..., n_c:])))
        elif lerp_mode:
            scores.append(vals.amax(dim=-1).amin(dim=0))
        else:
            scores.append(vals.amin(dim=0).amax(dim=-1))
    return torch.cat(scores)


def suggest_cull_budget(cfg, vb, cameras, height, width, feats=None, margin=1.3,
                        quantum=1 / 64):
    """A scene's safe cull budget from its hull fraction.

    Scores every camera in `cameras` ((K, R, t) tensors) at height x width
    (`feats` as for `empty_ray_scores`, required with the fused map) and
    returns (budget, max_hull_fraction) with
    budget = ceil(max_fraction * margin / quantum) * quantum in (0, 1].
    """
    from ..geometry.cameras import camera_rays, pixel_grid

    pix = pixel_grid(height, width, device=vb.src_masks.device).float()
    worst = 0.0
    for K, R, t in cameras:
        origin, dirs, near, far = camera_rays(pix, K, R, t, cfg.znear, cfg.zfar)
        scores = empty_ray_scores(cfg, vb, origin, dirs, near, far, feats=feats)
        worst = max(worst, float((scores > EMPTY_SCORE_THRESHOLD).float().mean()))
    budget = min(1.0, math.ceil(worst * margin / quantum) * quantum)
    return max(budget, quantum), worst
