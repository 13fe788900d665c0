"""KeypointNeRF — the generalizable volumetric-avatar model (PyTorch).

Port of `keypointnerf_tpu/models/keypoint_nerf.py`, inference and
training:

  * `encode()`       — pixel-aligned CNN features of the V source views,
                       per map plus the packed 12-ch "full" map
                       [geo_hd 8 | src RGB 3 | fg mask 1] at input res.
  * `query_points()` — per-point evaluation: projection, validity, bilinear
                       lookups (the tex map through kernel K2 when
                       `tex_onehot_sample` at eval; the matmul-VJP lookup,
                       with K1 for the coarse map's gradient, when
                       `train_matmul_gather_vjp`), view dropout in
                       training, relative spatial encoding, geometry MLP
                       fusion and the IBR color head.
  * `render_rays()`  — coarse + fine ray march: at eval with uniform
                       importance resampling and the exact coarse-value
                       reuse merge, in training with stratified jitter,
                       random importance samples and the sorted union.
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

The fast-preset flags, the flag-gated kernels and `remat` are later
slices: a config that needs them raises NotImplementedError naming the
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
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
from ..geometry.compositing import composite
from ..geometry.sampling import (
    importance_z,
    merge_sorted_payloads,
    stratified_z,
    union_sorted_z,
)
from ..ops.feat_sample import multiview_bilinear_sample, multiview_bilinear_sample_mm
from ..ops.onehot_bilinear import multiview_onehot_bilinear_sample
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
    """Raise NotImplementedError for a flag this slice does not implement."""
    unported = [
        (cfg.fused_feature_map, "fused_feature_map", "Queue 1 item 3 (fast slice)"),
        (cfg.gather_lerp, "gather_lerp", "Queue 1 item 3 (fast slice)"),
        (cfg.coarse_topk_ratio < 1.0, "coarse_topk_ratio < 1", "Queue 1 item 3 (fast slice)"),
        (cfg.fine_topk_ratio < 1.0, "fine_topk_ratio < 1", "Queue 1 item 3 (fast slice)"),
        (cfg.use_dma_gather, "use_dma_gather", "Queue 2 K3"),
        (cfg.use_pallas_geo_mlp, "use_pallas_geo_mlp", "Queue 2 K4/K5"),
        (cfg.use_pallas_composite, "use_pallas_composite", "Queue 2 K6"),
        (cfg.separate_cf, "separate_cf", "Queue 1 item 2 (model remainder)"),
        (bool(cfg.pool_mode), f"pool_mode={cfg.pool_mode!r}", "Queue 1 item 2 (AttentionPool)"),
        (cfg.remat, "remat", "Queue 1 item 1 (remat)"),
        (cfg.remat_save_gathers, "remat_save_gathers", "Queue 1 item 1 (remat)"),
    ]
    for on, flag, item in unported:
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP {item}")
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {cfg.compute_dtype!r}")


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
        """A dict of numpy arrays (e.g. data.make_sample) on `device`."""
        dev = resolve_device(device)
        return cls(**{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                      for k, v in sample.items()})

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
        in the compute dtype, channels last and contiguous, plus "full"
        (V, H, W, 12) = [hires | src RGB | mask] when `src_masks` is given
        and the hires map is at input resolution. `train` changes nothing
        here (the fused map that it would leave unpadded is not ported);
        gradients flow when autograd is on.
        """
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
        if src_masks is not None and hd.shape[1:3] == src_images.shape[1:3]:
            feats["full"] = torch.cat(
                [hd, src_images.to(hd.dtype), src_masks.to(hd.dtype)], dim=-1)
        return feats

    # ----------------------------------------------------------------- query
    def query_points(self, pts, view_dirs, feats, vb: ViewBatch, n_samples: int,
                     train: bool = False, view_keep=None):
        """Evaluate [sdf, radiance, rgb] at N world points.

        pts, view_dirs (N, 3); `n_samples` (samples per ray) is the JAX
        signature's, read by the fast slice's gather-lerp. `view_keep` (V,)
        is the training view-dropout draw (0/1 per view, one view forced
        kept), applied when `train` and V > 1. Returns f32 sdf (N, 1),
        rad (N, 1), rgb (N, 3) and valid (N, 1).
        """
        c = self.cfg
        V = vb.src_images.shape[0]
        H, W = vb.src_images.shape[1:3]
        N = pts.shape[0]
        cdt = c.compute_dtype

        krt = compose_krt(vb.src_K, vb.src_R, vb.src_t)   # (V, 4, 4)
        xy_pix, z = project_points(pts[None], krt)         # (V, N, 2), (V, N, 1)
        xy = ndc_xy(xy_pix, W, H)
        zn = ndc_z(z, c.znear, c.zfar)

        # frustum validity
        eps = 1e-2
        in_xy = ((xy >= -1.0 - eps) & (xy <= 1.0 + eps)).all(dim=-1, keepdim=True)
        mask = (in_xy & (zn >= -1.0)).float()               # (V, N, 1)

        # with the matmul VJP, a map's gradient is the JAX package's exact
        # one-hot sum, through K1 for maps of >= 32 gradient channels
        hd_ch = c.geo_out_ch_hd
        if c.train_matmul_gather_vjp:
            mvbs = functools.partial(multiview_bilinear_sample_mm,
                                     pallas_dmap=c.train_pallas_dmap)
        else:
            mvbs = multiview_bilinear_sample
        if "full" in feats:
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

        feat_coarse = mvbs(feats["geo"][0], xy)
        if c.tex_onehot_sample and not train:
            feat_xy = multiview_onehot_bilinear_sample(feats["tex"], xy)  # K2
        else:
            feat_xy = mvbs(feats["tex"], xy)

        # relative spatial encoding
        pts_cam = world_to_cam(pts[None], vb.src_R, vb.src_t)       # (V, N, 3)
        kpt_cam = world_to_cam(vb.kpt3d[None], vb.src_R, vb.src_t)  # (V, Kp, 3)
        sp = spatial_encode(c.sp_config, pts, pts_cam, vb.kpt3d, kpt_cam,
                            z_ndc=zn, xy_ndc=xy)
        out, valid, _, latent_fused = self.mlp_geo(
            sp.to(cdt), [feat_coarse.to(cdt), feat_hd.to(cdt)],
            mask.to(cdt), pw.to(cdt))

        # color
        latent24 = dense(self.ibr_compress_gfeat, latent_fused, cdt)
        latent24 = latent24[None].expand(V, N, c.gcompress_out)
        rgb_feat = torch.cat([img_xy.to(cdt), feat_xy.to(cdt), latent24], dim=-1)

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

    def _eval_density(self, pts, view_dirs, feats, vb, n_samples, draws=None):
        """Background sdf substitution, the training radiance noise (the
        query's `noise` draw, already scaled by `rand_noise_std`) and
        alpha = valid * relu(rad). `draws` (a `QueryDraws`) is given in
        training and None at eval."""
        train = draws is not None
        sdf, rads, rgb, valid = self.query_points(
            pts, view_dirs, feats, vb, n_samples, train=train,
            view_keep=draws.view_keep if train else None)
        rad = rads[..., 0:1]
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
        pts = origin + dirs[:, None, :] * z[..., None]
        view = dirs[:, None, :].expand(pts.shape)
        alpha, sdf, rgb = self._eval_density(
            pts.reshape(-1, 3), view.reshape(-1, 3), feats, vb, c.n_coarse,
            None if draws is None else draws.coarse)
        alpha = alpha.reshape(Rn, c.n_coarse)
        sdf = sdf.reshape(Rn, c.n_coarse)
        rgb = rgb.reshape(Rn, c.n_coarse, 3)
        coarse = composite(alpha, sdf, rgb, z)
        out = {
            "rgb_coarse": coarse.color,
            "depth_coarse": coarse.depth,
            "acc_coarse": coarse.acc,
        }
        if not fine:
            return out

        # importance resampling over interior bins, evenly spaced u at eval
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_fine = importance_z(coarse.contrib[..., 1:-1].detach(), z_mid, c.n_fine,
                              u=None if draws is None else draws.importance_u)

        # the reuse merge is exact only for a deterministic query (eval)
        if c.reuse_coarse_eval and not train:
            # the eval query is deterministic: evaluate only the fine depths
            # and merge the cached coarse values (exact)
            pts = origin + dirs[:, None, :] * z_fine[..., None]
            view = dirs[:, None, :].expand(pts.shape)
            alpha_f, sdf_f, rgb_f = self._eval_density(
                pts.reshape(-1, 3), view.reshape(-1, 3), feats, vb, c.n_fine)
            v_c = torch.cat([alpha[..., None], sdf[..., None], rgb], dim=-1)
            v_f = torch.cat([
                alpha_f.reshape(Rn, c.n_fine, 1),
                sdf_f.reshape(Rn, c.n_fine, 1),
                rgb_f.reshape(Rn, c.n_fine, 3),
            ], dim=-1)
            zs, vs = merge_sorted_payloads(z, z_fine, v_c, v_f)
            fine_out = composite(vs[..., 0], vs[..., 1], vs[..., 2:5], zs)
        else:
            n_all = c.n_coarse + c.n_fine
            z_all = union_sorted_z(z, z_fine)
            pts = origin + dirs[:, None, :] * z_all[..., None]
            view = dirs[:, None, :].expand(pts.shape)
            alpha_a, sdf_a, rgb_a = self._eval_density(
                pts.reshape(-1, 3), view.reshape(-1, 3), feats, vb, n_all,
                None if draws is None else draws.fine)
            fine_out = composite(alpha_a.reshape(Rn, n_all), sdf_a.reshape(Rn, n_all),
                                 rgb_a.reshape(Rn, n_all, 3), z_all)
        out.update({
            "rgb_fine": fine_out.color,
            "depth_fine": fine_out.depth,
            "acc_fine": fine_out.acc,
            "sdf_fine": fine_out.sdf,
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
        hi = torch.tensor([W - 1, H - 1], device=idx.device)
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
