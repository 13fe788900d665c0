"""Full-image inference rendering.

Port of `keypointnerf_tpu/render/renderer.py`: all H*W rays are
flattened, padded to a multiple of a fixed chunk and marched chunk by
chunk; with `cull_empty_rays_ratio` < 1 only the top rays by the
conservative empty-ray score are marched, and the rest take their exact
value, zero. `render_cameras_scanned` renders several cameras of one
subject from one encoding (orbits, video); `render_images_batched`
renders a batch of subjects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..geometry.cameras import camera_rays, pixel_grid
from ..models.keypoint_nerf import KeypointNeRF, ViewBatch, top_k_indices
from ..utils.profiling import span


@torch.no_grad()
def render_rays_chunked(
    model: KeypointNeRF,
    feats,
    vb: ViewBatch,
    origin,
    dirs,        # (N, 3)
    near,
    far,
    chunk: int = 4096,
    fine: bool = True,
) -> Dict[str, torch.Tensor]:
    """March N rays in fixed-size chunks (eval mode)."""
    n = dirs.shape[0]

    def march(d, nr, fr):
        m = d.shape[0]
        n_pad = (-m) % chunk
        if n_pad:
            # pad the last chunk with COPIES of real rays (wrap-around),
            # never zeros: an all-zero "ray" evaluates the density at the
            # camera origin and can composite to acc ~ 1
            idx = torch.arange(m + n_pad, device=d.device) % m
            d, nr, fr = d[idx], nr[idx], fr[idx]
        outs = []
        for s in range(0, m + n_pad, chunk):
            with span("render.chunk"):
                outs.append(model.render_rays(feats, vb, origin, d[s:s + chunk],
                                              nr[s:s + chunk], fr[s:s + chunk], fine=fine))
        with span("render.writeback"):
            return {k: torch.cat([o[k] for o in outs])[:m] for k in outs[0]}

    cfg = model.cfg
    ratio = cfg.cull_empty_rays_ratio
    if ratio >= 1.0:
        return march(dirs, near, far)

    # Exact empty-ray cull (render/empty_cull.py), global across chunks.
    # Exactness requires #(score > threshold) <= budget: checked at run
    # time and reported as `cull_overflow` (zero everywhere iff it held).
    if cfg.use_pallas_composite and fine:
        raise ValueError(
            "cull_empty_rays_ratio requires the plain importance path: K6's "
            "fine-depth placement for zero rays (use_pallas_composite) is not "
            "what empty_ray_scores replicates")
    if cfg.disable_fg_mask:
        raise ValueError(
            "cull_empty_rays_ratio requires the foreground validity test: "
            "with disable_fg_mask point validity is frustum-only, so rays "
            "the cull proves mask-empty can still composite nonzero"
        )
    from .empty_cull import EMPTY_SCORE_THRESHOLD, empty_ray_scores

    with span("render.cull"):
        scores = empty_ray_scores(cfg, vb, origin, dirs, near, far, feats=feats)
        k = max(1, min(n, -int(-n * ratio // 1)))
        overflow = torch.clamp((scores > EMPTY_SCORE_THRESHOLD).sum() - k, min=0).float()
        # jax.lax.top_k's order: the marched rays fall into the chunks they
        # fall into in JAX, which the per-chunk top-k culls select from
        sel = top_k_indices(scores, k)
    out_m = march(dirs[sel], near[sel], far[sel])
    with span("render.writeback"):
        # ONE packed row-gather; culled rays take the zero row
        inv = torch.full((n,), k, dtype=torch.long, device=dirs.device)
        inv[sel] = torch.arange(k, device=dirs.device)
        keys = sorted(out_m)
        cols = [out_m[kk].reshape(k, -1) for kk in keys]
        packed = torch.cat([c.float() for c in cols], dim=-1)
        packed = torch.cat([packed, packed.new_zeros((1, packed.shape[1]))], dim=0)
        taken = packed[inv]                                   # (n, sum_widths)
        out, off = {}, 0
        for kk, c in zip(keys, cols):
            w = c.shape[1]
            out[kk] = taken[:, off:off + w].to(out_m[kk].dtype).reshape(
                (n,) + out_m[kk].shape[1:])
            off += w
        out["cull_overflow"] = overflow.expand(n)
        return out


@torch.no_grad()
def render_image(
    model: KeypointNeRF,
    vb: ViewBatch,
    *,
    height: int,
    width: int,
    stride: int = 1,
    chunk: int = 4096,
    fine: bool = True,
    feats=None,
) -> Dict[str, torch.Tensor]:
    """Render the target camera of `vb` at (height/stride, width/stride).

    `feats` (the dict from `KeypointNeRF.encode`) reuses encoder output
    across target cameras; when None the source views are encoded here.
    Returns (H', W', C) images: rgb/depth/acc coarse and fine, sdf_fine,
    and cull_overflow when the cull is on. Runs on the model's device.
    """
    cfg = model.cfg
    if feats is None:
        feats = model.encode(vb.src_images, vb.src_masks)
    pix = pixel_grid(height, width, y_stride=stride, x_stride=stride,
                     device=vb.tar_K.device)
    origin, dirs, near, far = camera_rays(
        pix.float(), vb.tar_K, vb.tar_R, vb.tar_t, cfg.znear, cfg.zfar)
    out = render_rays_chunked(model, feats, vb, origin, dirs, near, far,
                              chunk=chunk, fine=fine)
    h, w = -(-height // stride), -(-width // stride)
    return {k: v.reshape((h, w) + v.shape[1:]) for k, v in out.items()}


@torch.no_grad()
def render_cameras_scanned(
    model: KeypointNeRF,
    feats,
    vb: ViewBatch,
    Ks,          # (F, 3, 3)
    Rs,          # (F, 3, 3)
    ts,          # (F, 3)
    *,
    height: int,
    width: int,
    stride: int = 1,
    chunk: int = 4096,
    fine: bool = True,
):
    """Render F target cameras of one subject from one encoding (`feats`,
    from `KeypointNeRF.encode`). Returns the (F, H', W', 3) fine RGB (the
    coarse RGB when not `fine`) and the scalar worst `cull_overflow` of
    the group (0 with the cull off)."""
    frames, worst = [], torch.zeros((), device=Ks.device)
    for K, R, t in zip(Ks, Rs, ts):
        out = render_image(model, dataclasses.replace(vb, tar_K=K, tar_R=R, tar_t=t),
                           height=height, width=width, stride=stride, chunk=chunk,
                           fine=fine, feats=feats)
        if "cull_overflow" in out:
            worst = torch.maximum(worst, out["cull_overflow"].max())
        frames.append(out["rgb_fine" if fine else "rgb_coarse"])
    return torch.stack(frames), worst


@torch.no_grad()
def render_images_batched(
    model: KeypointNeRF,
    vbs: Sequence[ViewBatch],
    *,
    height: int,
    width: int,
    stride: int = 1,
    chunk: int = 4096,
    fine: bool = True,
) -> Dict[str, torch.Tensor]:
    """Render the target cameras of B subjects, one ViewBatch each. Each
    subject is encoded and marched on its own. Returns (B, H', W', C)
    images."""
    outs = [render_image(model, vb, height=height, width=width, stride=stride,
                         chunk=chunk, fine=fine)
            for vb in vbs]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
