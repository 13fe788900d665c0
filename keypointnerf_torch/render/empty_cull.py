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

On the card the scores come from one kernel a frame (`ops/empty_cull.py`,
csrc/empty_cull.cu), which repeats the composition's f32 operations.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..geometry.aabb import ray_aabb_intersection
from ..geometry.cameras import compose_krt
from ..ops import empty_cull as cull_op

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


def empty_ray_scores(cfg, vb, origin, dirs, near, far, cell=8,
                     score_chunk=cull_op.SCORE_CHUNK, feats=None):
    """Per-ray conservative foreground scores.

    cfg: KeypointNeRFConfig (n_coarse / n_fine / znear / zfar); vb:
    ViewBatch; origin (3,); dirs (R, 3); near, far (R, 1); `feats` the dict
    from `KeypointNeRF.encode`, required with `cfg.fused_feature_map` (the
    bound is then the fused map's mask channel). Returns (R,) f32;
    score <= EMPTY_SCORE_THRESHOLD => the ray's output is exactly zero.

    The cell table, the projection matrices and the AABB clamp are made
    once a frame. Rays on the card are then scored by one kernel
    (`fused_empty_ray_scores`), rays on the CPU by the composition
    (`empty_ray_scores_plain`), `score_chunk` rays at a time to bound
    memory. Both give the same bits, whatever the chunking.
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
    Hm, Wm = mask_map.shape[1:3]
    lerp_mode = (feats is not None and "fused" in feats
                 and cfg.gather_lerp and cfg.gather_lerp_stride >= 2)
    if lerp_mode and cfg.reuse_coarse_eval and not cfg.separate_cf:
        mode = cull_op.TIGHT
    else:
        mode = cull_op.LOOSE if lerp_mode else cull_op.PLAIN
    cmax = conservative_mask_cells(mask_map.float(), cell)
    krt = compose_krt(vb.src_K, vb.src_R, vb.src_t)

    z1, z2, hit = ray_aabb_intersection(vb.bounds, origin, dirs)
    near = torch.where(hit & (z1 > near), z1, near)
    far = torch.where(hit & (z2 < far), z2, far)

    args = (cmax, krt, origin, dirs, near, far, mode, cfg.n_coarse, cfg.n_fine,
            cfg.gather_lerp_stride, H, W, Hm, Wm, cell)
    if dirs.is_cuda:
        return cull_op.fused_empty_ray_scores(*args)
    return cull_op.empty_ray_scores_plain(*args, score_chunk)


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
