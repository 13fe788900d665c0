"""KeypointNeRF — the generalizable volumetric-avatar model (PyTorch).

Port of `keypointnerf_tpu/models/keypoint_nerf.py`, inference and
training:

  * `encode()`       — pixel-aligned CNN features of the V source views,
                       per map plus the packed 12-ch "full" map
                       [geo_hd 8 | src RGB 3 | fg mask 1] at input res, or
                       with `fused_feature_map` the 84-ch "fused"
                       map [coarse 64 | hd 8 | tex 8 | RGB 3 | mask 1] on
                       the input grid (or its half with `fused_map_half`).
  * `query_points()` — per-point evaluation: projection, validity, bilinear
                       lookups (one lookup of the fused map, through kernel
                       K3 with `use_dma_gather` at eval, or at every
                       `gather_lerp_stride`-th sample with the others lerped
                       along the ray with `gather_lerp`; else the tex map
                       through kernel K2 when `tex_onehot_sample` at eval;
                       the matmul-VJP lookup, with K1 for the coarse or the
                       fused map's gradient, when `train_matmul_gather_vjp`),
                       view dropout in
                       training, relative spatial encoding, geometry MLP
                       fusion (one launch of kernel K5 or K4 for the
                       encoding-and-MLP chain with `use_pallas_geo_mlp`;
                       on the module path at inference in bf16 on the card
                       the `rel_z_decay` encoding as one launch,
                       `ops.fused_rel_z_decay`) and the IBR color head.
  * `render_rays()`  — coarse + fine ray march: at eval with uniform
                       importance resampling (with `use_pallas_composite`
                       one launch of kernel K6 for the coarse composite and
                       the fine depths) and the exact coarse-value reuse
                       merge, and the fast preset's top-k culls (the coarse
                       pass on the rays that hit the AABB, the fine pass on
                       the rays of the largest coarse opacity); in training
                       with stratified jitter, random importance samples and
                       the sorted union.
  * `forward()`      — JAX's `__call__`: encode, a training patch (or the
                       full image at eval), the march and the targets.

The JAX model draws its training randomness from Flax's "render" key
inside the module; the port takes every draw as a tensor
(`training.draws.TrainDraws`), so a test can feed both the same numbers.

The modules keep the original KeypointNeRF state_dict layout
(`geo_encoder.*`, `tex_encoder.*`, `mlp_geo.layers{1,2}.*`, `mlp_tex.*`,
`ibr_compress_gfeat.*`), so `utils/convert.py` and the JAX package's
`convert_reference_state_dict` carry weights both ways. Parameters stay
f32; `cfg.compute_dtype` is the dtype the layers compute in. Point layout
is (V, N, C), N = rays * samples flattened.

In training, `remat` recomputes each query's activations in the backward
(`torch.utils.checkpoint`), and with `remat_save_gathers` keeps the query's
map lookups out of that recompute, as the JAX model's remat policy saves its
`kpn_gathered` values.

With `separate_cf` the geometry MLP has a third output, [sdf, rad_c,
rad_f]: the fine pass reads rad_f, and the eval's coarse-value reuse is
off (the fine pass re-evaluates the union). `pool_mode` selects the
attention pools (`models/mlp.py:AttentionPool`). `pallas_interpret` is a
config field the port ignores.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..device import DeviceLike, constant, resolve_device
from ..geometry.aabb import ray_aabb_intersection
from ..geometry.cameras import (
    camera_center,
    camera_rays,
    compose_krt,
    ndc_xy,
    ndc_z,
    pixel_grid,
    project_points,
    world_to_cam,
)
from ..geometry.compositing import CompositeOut, composite
from ..geometry.sampling import (
    importance_z,
    linspace01,
    merge_sorted_payloads,
    stratified_z,
    union_sorted_z,
)
from ..ops import rel_z_decay as rzd
from ..ops.composite_importance import fused_composite_importance
from ..ops.dma_gather import multiview_bilinear_sample_dma
from ..ops.dense import autograd_records
from ..ops.feat_sample import multiview_bilinear_sample, multiview_bilinear_sample_mm
from ..ops.fused_geo_mlp import geo_mlp_apply, sp_geo_mlp_apply
from ..ops.onehot_bilinear import multiview_onehot_bilinear_sample
from ..utils.profiling import span
from .cnn import ConvTranspose2d, HGFilter, ResBlkEncoder, avg_pool2
from .ibr_head import IBRRenderingHead, dense
from .mlp import GeoFusionMLP
from .spatial_encoding import SpatialEncodingConfig, spatial_encode, spatial_encoding_dim


@dataclasses.dataclass(frozen=True)
class KeypointNeRFConfig:
    """Hyperparameters, with the JAX config's field names and defaults
    (the reference zju config). See keypointnerf_tpu's KeypointNeRFConfig
    for what each field means."""

    # spatial encoding
    sp_level: int = 3
    sp_type: str = "rel_z_decay"
    sp_scale: float = 1.0
    sp_sigma: float = 0.1
    n_kpt: int = 24
    # geometry CNN
    geo_n_stack: int = 1
    geo_n_downsample: int = 4
    geo_out_ch: int = 64
    geo_out_ch_hd: int = 8
    # texture CNN
    tex_out_ch: int = 8
    tex_ngf: int = 64
    tex_n_downsample: int = 3
    tex_n_blocks: int = 4
    tex_n_upsample: int = 2
    # geometry MLP; dims1[0] is replaced by the spatial encoding width
    mlp_dims1: Tuple[int, ...] = (168, 128, 128, 120, 64)
    mlp_dims2: Tuple[int, ...] = (128, 64, 64, 2)
    mlp_skip_layers: Tuple[int, ...] = (0, 2)
    mlp_nl: str = "softplus"
    pool_types: Tuple[str, ...] = ("mean", "var")
    pool_mode: str = ""
    # IBR color head
    ibr_in_feat_ch: int = 32
    gcompress_out: int = 24
    # rendering
    n_coarse: int = 64
    n_fine: int = 64
    patch_h: int = 64
    patch_w: int = 64
    rand_noise_std: float = 0.01
    separate_cf: bool = False
    znear: float = 2.0
    zfar: float = 5.0
    bkg_sdf: float = 0.1 / 100.0
    view_dropout: float = 0.5
    disable_fg_mask: bool = False
    ds_geo: int = 0
    ds_tex: int = 0
    # numerics
    compute_dtype: Any = torch.float32
    use_pallas_geo_mlp: bool = False
    pallas_interpret: bool = False
    remat: bool = False
    remat_save_gathers: bool = False
    fused_feature_map: bool = False
    fused_map_half: bool = False
    fused_map_half_min_side: int = 512
    use_dma_gather: bool = False
    use_pallas_composite: bool = False
    fine_topk_ratio: float = 1.0
    coarse_topk_ratio: float = 1.0
    cull_empty_rays_ratio: float = 1.0
    reuse_coarse_eval: bool = True
    nl_relu_approx: bool = False
    gather_lerp: bool = False
    gather_lerp_stride: int = 2
    train_matmul_gather_vjp: bool = False
    # the JAX package's choice of map-gradient kernel, read from its config
    # files; the port's lookups take K1's wrapper for every map either way
    train_pallas_dmap: bool = False
    tex_onehot_sample: bool = False

    @property
    def sp_config(self) -> SpatialEncodingConfig:
        return SpatialEncodingConfig(
            sp_level=self.sp_level,
            sp_type=self.sp_type,
            scale=self.sp_scale,
            sigma=self.sp_sigma,
            n_kpt=self.n_kpt,
        )

    @property
    def sp_dim(self) -> int:
        return spatial_encoding_dim(self.sp_config)


def check_supported(cfg: KeypointNeRFConfig) -> None:
    """Raise ValueError for a combination the model refuses (those the
    JAX model refuses, and a compute dtype other than f32 / bf16)."""
    if cfg.use_pallas_geo_mlp and cfg.pool_mode:
        raise ValueError(
            "use_pallas_geo_mlp supports only the default mean/var pooling"
            f" (pool_mode={cfg.pool_mode!r})")
    if cfg.use_pallas_geo_mlp and cfg.nl_relu_approx:
        # the fused kernels hardcode softplus100
        raise ValueError(
            "nl_relu_approx is not supported with use_pallas_geo_mlp "
            "(the fused kernel applies softplus100)")
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {cfg.compute_dtype!r}")


def top_k_indices(score, k: int):
    """Indices of the k largest entries of the 1-D `score`, largest first
    and, among equal scores, lower index first: `jax.lax.top_k`'s order
    (`torch.topk` promises none), so a cull marches JAX's rays."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def strided_gather_lerp(fmap, xy, n_samples: int, stride: int = 2):
    """The lookup of `fmap` at every `stride`-th sample of each ray (and
    the last), the samples between lerped from their segment's two anchor
    values by the parametric position of their projection on it.

    Port of the JAX model's `_strided_gather_lerp`. xy (V, R*S, 2)
    ray-major, S = `n_samples`; returns (V, R*S, C) in the map's dtype.
    At an anchor t is exactly 0 and the lookup passes through; elsewhere t
    is clipped to [0, 1] and cast to the map's dtype before the lerp.
    """
    V, N, _ = xy.shape
    S, k = n_samples, stride
    R = N // S
    xyr = xy.reshape(V, R, S, 2)
    xa = torch.cat([xyr[:, :, ::k], xyr[:, :, -1:]], dim=2)   # (V, R, G, 2)
    G = xa.shape[2]
    fa = multiview_bilinear_sample(fmap, xa.reshape(V, R * G, 2)).reshape(V, R, G, -1)
    # sample s lies in segment s // k: repeat each segment's ends k times
    # ((G - 1) * k >= S) and cut to S
    rep = lambda a: a.repeat_interleave(k, dim=2)[:, :, :S]   # noqa: E731
    left, right = rep(fa[:, :, :-1]), rep(fa[:, :, 1:])
    xl, xr = rep(xa[:, :, :-1]), rep(xa[:, :, 1:])
    seg = xr - xl
    t = ((xyr - xl) * seg).sum(-1, keepdim=True) / ((seg * seg).sum(-1, keepdim=True) + 1e-12)
    t = t.clamp(0.0, 1.0).to(left.dtype)
    return (left + t * (right - left)).reshape(V, N, -1)


@dataclasses.dataclass
class ViewBatch:
    """One sample: V source views + 1 target view, as tensors."""

    src_images: torch.Tensor   # (V, H, W, 3) in [0, 1], fg-masked
    src_masks: torch.Tensor    # (V, H, W, 1) foreground masks
    src_K: torch.Tensor        # (V, 3, 3)
    src_R: torch.Tensor        # (V, 3, 3) world->cam
    src_t: torch.Tensor        # (V, 3)
    tar_image: torch.Tensor    # (H, W, 3)
    tar_mask: torch.Tensor     # (H, W, 1)
    tar_K: torch.Tensor        # (3, 3)
    tar_R: torch.Tensor        # (3, 3)
    tar_t: torch.Tensor        # (3,)
    kpt3d: torch.Tensor        # (Kp, 3) 3D body keypoints (world)
    bounds: torch.Tensor       # (2, 3) AABB [min, max]

    @classmethod
    def from_numpy(cls, sample, device: DeviceLike = None) -> "ViewBatch":
        """A dict of numpy arrays (e.g. data.make_sample) on `device`; a
        dataset's "meta" entry (ids for the PNG tree) is left out."""
        dev = resolve_device(device)
        return cls(**{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                      for k, v in sample.items() if k != "meta"})

    def to(self, device) -> "ViewBatch":
        return ViewBatch(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


class KeypointNeRF(nn.Module):
    """The model, built on `device` (CUDA unless named) with weights drawn
    from `seed` (see `init_weights`)."""

    def __init__(self, cfg: KeypointNeRFConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        c = self.cfg = cfg
        dt = c.compute_dtype
        self.geo_encoder = HGFilter(c.geo_n_stack, c.geo_n_downsample,
                                    c.geo_out_ch, c.geo_out_ch_hd)
        self.tex_encoder = ResBlkEncoder(c.tex_out_ch, c.tex_ngf, c.tex_n_downsample,
                                         c.tex_n_blocks, c.tex_n_upsample)
        dims1 = (c.sp_dim,) + tuple(c.mlp_dims1[1:])
        dims2 = tuple(c.mlp_dims2)
        if c.separate_cf:
            dims2 = dims2[:-1] + (dims2[-1] + 1,)       # [sdf, rad_c, rad_f]
        nl = "relu" if (c.nl_relu_approx and c.mlp_nl == "softplus") else c.mlp_nl
        self.mlp_geo = GeoFusionMLP(
            dims1, dims2, (c.geo_out_ch, c.geo_out_ch_hd), c.mlp_skip_layers,
            nl, True, c.pool_types, c.pool_mode, dt)
        self.mlp_tex = IBRRenderingHead(c.ibr_in_feat_ch, dt)
        self.ibr_compress_gfeat = nn.Linear(dims2[0], c.gcompress_out)
        self.init_weights(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.ibr_compress_gfeat.weight.device

    def with_config(self, **fields) -> "KeypointNeRF":
        """A shallow copy sharing this model's weights whose config has
        `fields` replaced (render-time fields: the cull budget, znear /
        zfar); the architecture's fields must stay."""
        out = copy.copy(self)
        out.cfg = dataclasses.replace(self.cfg, **fields)
        return out

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Seeded random weights in the JAX model's init scheme: He-normal
        kernels (std sqrt(2 / fan_in)), zero biases, unit norm scales,
        weight-norm gains sqrt(2), ani_al 0.2. One numpy generator walks the
        parameters in registration order, so a seed gives the same weights
        on every device."""
        rs = np.random.default_rng(seed)
        deconvs = {n for n, m in self.named_modules() if isinstance(m, ConvTranspose2d)}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(p.shape)
            if leaf == "ani_al":
                vals = np.full(shape, 0.2)
            elif leaf == "weight_g":
                vals = np.full(shape, math.sqrt(2.0))
            elif leaf == "bias":
                vals = np.zeros(shape)
            elif p.dim() == 1:                      # a norm's scale
                vals = np.ones(shape)
            else:
                # Linear / WN (O, I), Conv2d (O, I, kh, kw), ConvTranspose2d
                # (I, O, kh, kw): fan-in is the input channels x taps
                cin = shape[0] if name.rsplit(".", 1)[0] in deconvs else shape[1]
                fan_in = cin * int(np.prod(shape[2:]))
                vals = rs.normal(0.0, math.sqrt(2.0 / fan_in), shape)
            p.copy_(torch.as_tensor(vals, dtype=p.dtype))

    # ------------------------------------------------------------------ encode
    def encode(self, src_images, src_masks=None, train: bool = False):
        """Run the CNN encoders over the V source views.

        src_images (V, H, W, 3) in [0, 1]. Returns {"geo": [coarse
        (V, H/4, W/4, 64), hires (V, H, W, 8)], "tex": (V, H/2, W/2, 8)}
        in the compute dtype, channels last and contiguous, plus, when
        `src_masks` is given and the hires map is at input resolution:

        * with `fused_feature_map`, "fused" (V, Hm, Wm, 84) = [coarse 64 |
          hires 8 | tex 8 | src RGB 3 | mask 1] in the compute dtype, the
          coarse and tex maps upsampled onto the pixel grid by the bilinear
          lookup; Hm, Wm = H, W, or H // 2, W // 2 with `fused_map_half`
          and min(H, W) >= `fused_map_half_min_side` (hires / RGB / mask
          then resampled onto the half grid by one lookup). The JAX model
          pads it to 128 channels at eval for K3's DMA slices on the TPU;
          the port leaves it at 84 (csrc/dma_gather.cu reads any C). In
          training with `train_matmul_gather_vjp` the upsampling lookups
          take the matmul VJP with the plain map gradient (the JAX model's
          XLA scan; K1 serves only the query's lookups);
        * otherwise "full" (V, H, W, 12) = [hires | src RGB | mask].

        Gradients flow when autograd is on.
        """
        with span("encode"):
            x = (2.0 * src_images - 1.0).to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
            x_geo = x
            for _ in range(self.cfg.ds_geo):
                x_geo = avg_pool2(x_geo)
            x_tex = x
            for _ in range(self.cfg.ds_tex):
                x_tex = avg_pool2(x_tex)
            nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
            coarse, hd = self.geo_encoder(x_geo)
            feats = {"geo": [nhwc(coarse), nhwc(hd)], "tex": nhwc(self.tex_encoder(x_tex))}
            hd = feats["geo"][1]
            if src_masks is None or hd.shape[1:3] != src_images.shape[1:3]:
                return feats
            dt = hd.dtype
            hd_rgb_mask = torch.cat([hd, src_images.to(dt), src_masks.to(dt)], dim=-1)
            if not self.cfg.fused_feature_map:
                feats["full"] = hd_rgb_mask
                return feats
            V, H, W = src_images.shape[:3]
            half = (self.cfg.fused_map_half
                    and min(H, W) >= self.cfg.fused_map_half_min_side)
            Hm, Wm = (H // 2, W // 2) if half else (H, W)
            grid = pixel_grid(Hm, Wm, device=src_images.device).float()
            xy = torch.stack([2.0 * grid[:, 0] / (Wm - 1.0) - 1.0,
                              2.0 * grid[:, 1] / (Hm - 1.0) - 1.0], dim=-1)
            xy = xy[None].expand(V, -1, -1)
            up = (multiview_bilinear_sample_mm if train and self.cfg.train_matmul_gather_vjp
                  else multiview_bilinear_sample)
            up_coarse = up(feats["geo"][0], xy).reshape(V, Hm, Wm, -1)
            up_tex = up(feats["tex"], xy).reshape(V, Hm, Wm, -1)
            if half:
                hd_rgb_mask = up(hd_rgb_mask, xy).reshape(V, Hm, Wm, -1)
            # [coarse | hd | tex | rgb | mask]: query_points slices by this layout
            hd_ch = self.cfg.geo_out_ch_hd
            feats["fused"] = torch.cat(
                [up_coarse.to(dt), hd_rgb_mask[..., :hd_ch], up_tex.to(dt),
                 hd_rgb_mask[..., hd_ch:]], dim=-1)
            return feats

    # ----------------------------------------------------------------- query
    def query_points(self, pts, view_dirs, feats, vb: ViewBatch, n_samples: int,
                     train: bool = False, view_keep=None):
        """Evaluate [sdf, radiance, rgb] at N world points.

        pts, view_dirs (N, 3) ray-major; `n_samples` (samples per ray) is
        what `gather_lerp` groups the points by. `view_keep` (V,)
        is the training view-dropout draw (0/1 per view, one view forced
        kept), applied when `train` and V > 1. Returns f32 sdf (N, 1),
        rads (N, 1), or (N, 2) [coarse, fine] with `separate_cf`, rgb
        (N, 3) and valid (N, 1).
        """
        looked = self.lookup_points(pts, feats, vb, n_samples, train)
        return self.query_head(pts, view_dirs, vb, looked, train, view_keep)

    def lookup_points(self, pts, feats, vb: ViewBatch, n_samples: int, train: bool = False):
        """The query's first half: the points projected into the V source
        views, the frustum mask and every map lookup. Returns a dict of
        (V, N, .) tensors: xy, zn, mask, feat_coarse, feat_hd, feat_xy,
        img_xy, fg (the JAX model's `kpn_gathered` values are the last
        five)."""
        with span("query.lookup"):
            c = self.cfg
            H, W = vb.src_images.shape[1:3]
            N = pts.shape[0]

            krt = compose_krt(vb.src_K, vb.src_R, vb.src_t)   # (V, 4, 4)
            xy_pix, z = project_points(pts[None], krt)         # (V, N, 2), (V, N, 1)
            xy = ndc_xy(xy_pix, W, H)
            zn = ndc_z(z, c.znear, c.zfar)

            # frustum validity
            eps = 1e-2
            in_xy = ((xy >= -1.0 - eps) & (xy <= 1.0 + eps)).all(dim=-1, keepdim=True)
            mask = (in_xy & (zn >= -1.0)).float()               # (V, N, 1)

            # with the matmul VJP, a map's gradient is the JAX package's exact
            # one-hot sum, through K1 for every map (`train_pallas_dmap`, the
            # JAX package's choice of kernel for it, has no counterpart here)
            hd_ch = c.geo_out_ch_hd
            mvbs = (multiview_bilinear_sample_mm if c.train_matmul_gather_vjp
                    else multiview_bilinear_sample)
            feat_coarse = feat_xy = None
            if "fused" in feats:
                # one lookup of the packed map gives every per-point feature;
                # the lerp is off under K3, as in the JAX model (the cull's
                # bound still follows `gather_lerp` alone, render/empty_cull.py).
                # In training the matmul-VJP lookup of all 84 channels sends the
                # map gradient through K1
                dma = c.use_dma_gather and not train
                lerp = (c.gather_lerp and not train and not dma
                        and n_samples > c.gather_lerp_stride >= 2 and N % n_samples == 0)
                if dma:
                    fx = multiview_bilinear_sample_dma(                        # K3
                        feats["fused"], xy.float().contiguous())
                elif lerp:
                    fx = strided_gather_lerp(feats["fused"], xy, n_samples, c.gather_lerp_stride)
                else:
                    fx = mvbs(feats["fused"], xy)
                co_ch, tx_ch = c.geo_out_ch, c.tex_out_ch
                feat_coarse = fx[..., :co_ch]
                feat_hd = fx[..., co_ch : co_ch + hd_ch]
                feat_xy = fx[..., co_ch + hd_ch : co_ch + hd_ch + tx_ch]
                base = co_ch + hd_ch + tx_ch
                img_xy = fx[..., base : base + 3]
                fg = fx[..., base + 3 : base + 4]
            elif "full" in feats:
                if c.train_matmul_gather_vjp:
                    # the RGB / mask channels' gradients die at the input
                    # leaves: only the hd prefix gets a map gradient
                    full_xy = mvbs(feats["full"], xy, grad_channels=hd_ch)  # (V, N, 12)
                else:
                    full_xy = mvbs(feats["full"], xy)
                feat_hd = full_xy[..., :hd_ch]
                img_xy = full_xy[..., hd_ch : hd_ch + 3]
                fg = full_xy[..., hd_ch + 3 : hd_ch + 4]
            else:
                feat_hd = mvbs(feats["geo"][1], xy)
                img_xy = multiview_bilinear_sample(vb.src_images, xy)
                fg = multiview_bilinear_sample(vb.src_masks, xy)
            if feat_coarse is None:
                feat_coarse = mvbs(feats["geo"][0], xy)
            if feat_xy is None and c.tex_onehot_sample and not train:
                feat_xy = multiview_onehot_bilinear_sample(feats["tex"], xy)  # K2
            elif feat_xy is None:
                feat_xy = mvbs(feats["tex"], xy)
            return dict(xy=xy, zn=zn, mask=mask, feat_coarse=feat_coarse, feat_hd=feat_hd,
                        feat_xy=feat_xy, img_xy=img_xy, fg=fg)

    def query_head(self, pts, view_dirs, vb: ViewBatch, looked, train: bool = False,
                   view_keep=None):
        """The query's second half, from the looked-up values (`looked`,
        from `lookup_points`): validity, view dropout, border weights, the
        spatial encoding, the geometry MLP and the IBR color head."""
        c = self.cfg
        V = vb.src_images.shape[0]
        N = pts.shape[0]
        cdt = c.compute_dtype
        xy, zn, mask, fg = looked["xy"], looked["zn"], looked["mask"], looked["fg"]
        feat_coarse, feat_hd = looked["feat_coarse"], looked["feat_hd"]

        with span("query.geo"):
            # all views must land on the foreground
            all_valid = (mask > 0.0).all(dim=0)
            if not c.disable_fg_mask:
                all_valid = all_valid & (fg > 0.1).all(dim=0)
            mask = mask * all_valid[None].float()

            # view dropout: one random view kept, the others with p = 0.5
            if train and V > 1:
                mask = mask * view_keep.to(mask.dtype)[:, None, None]

            # smooth border pixel weights
            xyz01 = 0.5 * torch.cat([xy, zn], dim=-1) + 0.5
            dist_b = torch.minimum(xyz01, 1.0 - xyz01)
            pw = torch.sigmoid(5.0 * (dist_b / 0.1 - 1.0))
            pw = pw[..., 0:1] * pw[..., 1:2] * pw[..., 2:3]
            pw = pw * mask
            pw = (pw / (pw.sum(dim=0, keepdim=True) + 1e-6)).detach()

            out, valid, latent_fused = self._geo_mlp(pts, vb, xy, zn, feat_coarse, feat_hd,
                                                     mask, pw)

        with span("query.ibr"):
            latent24 = dense(self.ibr_compress_gfeat, latent_fused, cdt)
            latent24 = latent24[None].expand(V, N, c.gcompress_out)
            rgb_feat = torch.cat([looked["img_xy"].to(cdt), looked["feat_xy"].to(cdt), latent24],
                                 dim=-1)

            cam_pos = camera_center(vb.src_R, vb.src_t)                 # (V, 3)
            cam_rays = pts[None] - cam_pos[:, None, :]
            cam_rays = cam_rays / (torch.linalg.norm(cam_rays, dim=-1, keepdim=True) + 1e-9)
            rd = view_dirs[None] - cam_rays
            rd_norm = torch.linalg.norm(rd, dim=-1, keepdim=True)
            rd_dir = rd / torch.clamp(rd_norm, min=1e-6)
            rd_dot = (cam_rays * view_dirs[None]).sum(dim=-1, keepdim=True)
            ray_diff = torch.cat([rd_dir, rd_dot], dim=-1)              # (V, N, 4)

            rgb = self.mlp_tex(rgb_feat, ray_diff.to(cdt), mask.to(cdt))  # (N, 3)
        return (out[..., 0:1].float(), out[..., 1:].float(), rgb.float(),
                valid.float())

    def _geo_mlp(self, pts, vb: ViewBatch, xy, zn, feat_coarse, feat_hd, mask, pw):
        """The relative spatial encoding and the geometry MLP of a query:
        K5 (`use_pallas_geo_mlp` with `rel_z_decay`), K4
        (`use_pallas_geo_mlp`), or the module path, whose encoding is one
        launch of `ops.fused_rel_z_decay` where `_fused_encoding` holds and
        is composed elsewhere. Returns out (N, Do), valid (N, 1) and
        latent_fused (N, 2 Dl)."""
        c = self.cfg
        cdt = c.compute_dtype
        pts_cam = world_to_cam(pts[None], vb.src_R, vb.src_t)          # (V, N, 3)
        kpt_cam = world_to_cam(vb.kpt3d[None], vb.src_R, vb.src_t)     # (V, Kp, 3)

        def f32(*ts):
            # the kernels take f32 inputs and round their dot operands to `cdt`
            return [t.float().contiguous() for t in ts]

        if c.use_pallas_geo_mlp and c.sp_type == "rel_z_decay":
            out, valid, _, latent_fused = sp_geo_mlp_apply(               # K5
                self.mlp_geo, *f32(pts_cam, kpt_cam, feat_coarse, feat_hd, mask, pw),
                sp_level=c.sp_level, sp_sigma=c.sp_sigma, sp_scale=c.sp_scale,
                compute_dtype=cdt)
        elif c.use_pallas_geo_mlp:
            sp = spatial_encode(c.sp_config, pts, pts_cam, vb.kpt3d, kpt_cam, z_ndc=zn,
                                xy_ndc=xy)
            out, valid, _, latent_fused = geo_mlp_apply(                  # K4
                self.mlp_geo, *f32(sp, feat_coarse, feat_hd, mask, pw), compute_dtype=cdt)
        else:
            if self._fused_encoding(pts_cam, kpt_cam):
                # one launch, stored as the bf16 operand the first dense
                # layer reads: the bits of the composition and its cast
                sp = rzd.fused_rel_z_decay(pts_cam, kpt_cam, c.sp_level, c.sp_sigma,
                                           c.sp_scale)
            else:
                sp = spatial_encode(c.sp_config, pts, pts_cam, vb.kpt3d, kpt_cam, z_ndc=zn,
                                    xy_ndc=xy)
            out, valid, _, latent_fused = self.mlp_geo(
                sp.to(cdt), [feat_coarse.to(cdt), feat_hd.to(cdt)], mask.to(cdt), pw.to(cdt))
        return out, valid, latent_fused

    def _fused_encoding(self, pts_cam, kpt_cam) -> bool:
        """Whether the module path's encoding runs as one call of
        `ops.fused_rel_z_decay` (on the card its kernel, on the CPU the
        composition): `rel_z_decay` in a bf16 compute dtype, K and L that
        the kernel takes, and autograd recording through neither the
        points nor the geometry MLP."""
        c = self.cfg
        return (c.sp_type == "rel_z_decay" and c.compute_dtype == torch.bfloat16
                and rzd.takes(kpt_cam.shape[1], c.sp_level)
                and not autograd_records(pts_cam, kpt_cam, module=self.mlp_geo))

    def _query(self, pts, view_dirs, feats, vb, n_samples, train, view_keep):
        """`query_points`, or in training with `remat` the same query with
        its activations recomputed in the backward instead of kept (JAX's
        `nn.remat`); with `remat_save_gathers` the lookups run outside the
        recompute, so their outputs are kept (JAX's policy saving the
        `kpn_gathered` values). The draws are tensors, so the recompute
        repeats the forward exactly."""
        c = self.cfg
        kw = dict(train=train, view_keep=view_keep)
        if not (train and c.remat):
            return self.query_points(pts, view_dirs, feats, vb, n_samples, **kw)
        ckpt = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)
        if c.remat_save_gathers:
            looked = self.lookup_points(pts, feats, vb, n_samples, train)
            return ckpt(self.query_head, pts, view_dirs, vb, looked, **kw)
        return ckpt(self.query_points, pts, view_dirs, feats, vb, n_samples, **kw)

    def _eval_density(self, pts, view_dirs, feats, vb, n_samples, draws=None,
                      fine: bool = False):
        """Background sdf substitution, the training radiance noise (the
        query's `noise` draw, already scaled by `rand_noise_std`) and
        alpha = valid * relu(rad). `draws` (a `QueryDraws`) is given in
        training and None at eval. With `separate_cf` the fine pass
        (`fine`) reads the second radiance channel."""
        train = draws is not None
        sdf, rads, rgb, valid = self._query(
            pts, view_dirs, feats, vb, n_samples, train,
            draws.view_keep if train else None)
        rad = rads[..., 1:2] if (self.cfg.separate_cf and fine) else rads[..., 0:1]
        sdf = valid * sdf + (1.0 - valid) * self.cfg.bkg_sdf
        if train and self.cfg.rand_noise_std > 0.0:
            rad = rad + draws.noise
        alpha = valid * torch.relu(rad)
        return alpha[..., 0], sdf[..., 0], rgb

    # ------------------------------------------------------------ ray march
    def render_rays(self, feats, vb: ViewBatch, origin, dirs, near, far,
                    train: bool = False, fine: bool = True, draws=None):
        """Coarse + fine ray march of R rays.

        origin (3,); dirs (R, 3) unit; near, far (R, 1). Rays whose AABB
        intersection misses keep the full [znear, zfar] slab. In training
        (`draws`, a `TrainDraws`, required) the depths are jittered, the
        fine depths drawn from the detached coarse weights and the sorted
        union of both re-evaluated. Returns rgb/depth/acc for coarse and
        (when `fine`) rgb/depth/acc/sdf fine.
        """
        c = self.cfg
        if train and draws is None:
            raise ValueError("render_rays(train=True) needs the step's TrainDraws")
        if not train:
            draws = None
        Rn = dirs.shape[0]

        z1, z2, hit = ray_aabb_intersection(vb.bounds, origin, dirs)
        near = torch.where(hit & (z1 > near), z1, near)
        far = torch.where(hit & (z2 < far), z2, far)

        z = stratified_z(near, far, c.n_coarse,
                         u=None if draws is None else draws.strat_u)     # (R, S)
        S = c.n_coarse
        # coarse-pass cull (eval): march only the top Kc rays by AABB hit;
        # the others take the values of empty space
        ccull = not train and c.coarse_topk_ratio < 1.0
        if ccull:
            csel = top_k_indices(hit[..., 0].float(), max(1, int(Rn * c.coarse_topk_ratio)))
            dirs_c, z_c = dirs[csel], z[csel]
        else:
            dirs_c, z_c = dirs, z
        Rc = dirs_c.shape[0]
        pts = origin + dirs_c[:, None, :] * z_c[..., None]
        view = dirs_c[:, None, :].expand(pts.shape)
        alpha, sdf, rgb = self._eval_density(
            pts.reshape(-1, 3), view.reshape(-1, 3), feats, vb, S,
            None if draws is None else draws.coarse)
        alpha, sdf, rgb = alpha.reshape(Rc, S), sdf.reshape(Rc, S), rgb.reshape(Rc, S, 3)
        if ccull:
            alpha = alpha.new_zeros(Rn, S).index_copy_(0, csel, alpha)
            sdf = sdf.new_full((Rn, S), c.bkg_sdf).index_copy_(0, csel, sdf)
            rgb = rgb.new_zeros(Rn, S, 3).index_copy_(0, csel, rgb)
        use_pc = not train and fine and c.use_pallas_composite
        with span("march.composite"):
            if use_pc:
                # one K6 launch: the coarse composite and the fine depths
                u = linspace01(c.n_fine, z.dtype, z.device)
                color, depth, acc, sdf_c, contrib, z_fine = fused_composite_importance(
                    z.contiguous(), alpha.contiguous(), sdf.contiguous(), rgb.contiguous(),
                    u.expand(Rn, c.n_fine).contiguous())
                coarse = CompositeOut(color, depth, acc, contrib, sdf_c)
            else:
                coarse = composite(alpha, sdf, rgb, z)
            out = {
                "rgb_coarse": coarse.color,
                "depth_coarse": coarse.depth,
                "acc_coarse": coarse.acc,
            }
            if not fine:
                return out

            if not use_pc:
                # importance resampling over interior bins, evenly spaced u at eval
                z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
                z_fine = importance_z(coarse.contrib[..., 1:-1].detach(), z_mid, c.n_fine,
                                      u=None if draws is None else draws.importance_u)

            # fine-pass cull (eval): march only the top K rays by coarse
            # opacity; the others keep their coarse result
            cull = not train and c.fine_topk_ratio < 1.0
            if cull:
                sel = top_k_indices(coarse.acc, max(1, int(Rn * c.fine_topk_ratio)))
                take = lambda x: x[sel]                                    # noqa: E731
            else:
                take = lambda x: x                                         # noqa: E731
            dirs_f = take(dirs)
            Rf = dirs_f.shape[0]
            # the reuse merge is exact only for a deterministic query (eval)
            # that reads the coarse radiance in both passes
            reuse = c.reuse_coarse_eval and not train and not c.separate_cf
            if reuse:
                # the eval query is deterministic: evaluate only the fine
                # depths and merge the cached coarse values (exact)
                z_f = take(z_fine)
            else:
                z_f = take(union_sorted_z(z, z_fine))
        S_f = z_f.shape[-1]
        pts = origin + dirs_f[:, None, :] * z_f[..., None]
        view = dirs_f[:, None, :].expand(pts.shape)
        alpha_f, sdf_f, rgb_f = self._eval_density(
            pts.reshape(-1, 3), view.reshape(-1, 3), feats, vb, S_f,
            None if draws is None else draws.fine, fine=True)
        alpha_f, sdf_f, rgb_f = (alpha_f.reshape(Rf, S_f), sdf_f.reshape(Rf, S_f),
                                 rgb_f.reshape(Rf, S_f, 3))
        with span("march.composite"):
            if reuse:
                v_c = torch.cat([take(alpha)[..., None], take(sdf)[..., None], take(rgb)],
                                dim=-1)
                v_f = torch.cat([alpha_f[..., None], sdf_f[..., None], rgb_f], dim=-1)
                zs, vs = merge_sorted_payloads(take(z), z_f, v_c, v_f)
                fine_out = composite(vs[..., 0], vs[..., 1], vs[..., 2:5], zs)
            else:
                fine_out = composite(alpha_f, sdf_f, rgb_f, z_f)
            if not cull:
                out.update({
                    "rgb_fine": fine_out.color,
                    "depth_fine": fine_out.depth,
                    "acc_fine": fine_out.acc,
                    "sdf_fine": fine_out.sdf,
                })
                return out
            res = torch.cat([fine_out.color, fine_out.depth[:, None], fine_out.acc[:, None],
                             fine_out.sdf[:, None]], dim=-1)                # (Rf, 6)
            fallback = torch.cat([coarse.color, coarse.depth[:, None], coarse.acc[:, None],
                                  coarse.sdf[:, None].to(res.dtype)], dim=-1)
            res = fallback.index_copy(0, sel, res)
            out.update({
                "rgb_fine": res[:, :3],
                "depth_fine": res[:, 3],
                "acc_fine": res[:, 4],
                "sdf_fine": res[:, 5],
            })
            return out

    # ------------------------------------------------------------- training
    def sample_patch_pixels(self, vb: ViewBatch, patch_index):
        """The (P*P, 2) int (x, y) pixels of the training patch centered on
        flat pixel `patch_index` (the `TrainDraws` draw): the window is
        shifted inside the frame, not clamped pixel by pixel."""
        c = self.cfg
        H, W = vb.tar_mask.shape[:2]
        idx = torch.as_tensor(patch_index, device=vb.tar_mask.device).long()
        cy, cx = idx // W, idx % W
        x0 = torch.clamp(cx - c.patch_w // 2, 0, max(W - c.patch_w, 0))
        y0 = torch.clamp(cy - c.patch_h // 2, 0, max(H - c.patch_h, 0))
        grid = pixel_grid(c.patch_h, c.patch_w, device=idx.device) + torch.stack([x0, y0])
        # the degenerate patch > image case: x in [0, W-1], y in [0, H-1]
        hi = constant((W - 1, H - 1), torch.int64, idx.device)
        return torch.minimum(torch.clamp(grid, min=0), hi).to(torch.int32)

    def forward(self, vb: ViewBatch, train: bool = True, draws=None):
        """One full forward (JAX's `__call__`): encode the source views,
        render the training patch of `draws` (a `TrainDraws`; required in
        training) or, at eval, the whole target image, and gather the
        targets. Returns (P, P, ...) images: rgb/depth/acc coarse and fine,
        sdf_fine, target_rgb and target_alpha.
        """
        c = self.cfg
        H, W = vb.tar_image.shape[:2]
        if train and draws is None:
            raise ValueError("forward(train=True) needs the step's TrainDraws")
        feats = self.encode(vb.src_images, vb.src_masks, train)
        if train:
            pix = self.sample_patch_pixels(vb, draws.patch_index)
            ph, pw = c.patch_h, c.patch_w
        else:
            pix = pixel_grid(H, W, device=vb.tar_image.device)
            ph, pw = H, W
        origin, dirs, near, far = camera_rays(
            pix.float(), vb.tar_K, vb.tar_R, vb.tar_t, c.znear, c.zfar)
        out = self.render_rays(feats, vb, origin, dirs, near, far, train=train,
                               draws=draws)
        flat_idx = (pix[:, 1] * W + pix[:, 0]).long()
        images = {k: v.reshape((ph, pw) + v.shape[1:]) for k, v in out.items()}
        images["target_rgb"] = vb.tar_image.reshape(-1, 3)[flat_idx].reshape(ph, pw, 3)
        images["target_alpha"] = vb.tar_mask.reshape(-1, 1)[flat_idx].reshape(ph, pw, 1)
        return images
