"""KeypointNeRF's forward in plain float32 PyTorch: the encoders, the
per-point query and the ray geometry, written from the architecture
(arXiv:2205.04992 and the original code's layout) as functions of a dict
of parameters. Nothing here imports the program under test.

Departures from the program's arithmetic, each with its reason:
  * every product and convolution is one float32 operation (TF32 off,
    `precision.no_tf32`); the program rounds operands to bfloat16 and
    splits skip concatenations into partial products. Same function.
  * GroupNorm / InstanceNorm take torch's two-pass variance; the program
    takes Flax's one-pass E[x^2] - E[x]^2. Equal in exact arithmetic.
  * the 2x bicubic upsample is `F.interpolate(align_corners=True)`, torch's
    a = -0.75 cubic with clamped taps; the program writes the same matrix
    as two dense products.
  * bilinear lookups are `F.grid_sample` (border, align_corners); the
    program gathers four corners. The rel_z_decay encoding takes sin / cos
    of each octave directly; the program's module path uses the
    double-angle recursion.
  * `linspace` is torch's; the program reproduces XLA's folded division.
Where the function itself has a convention (the subgradient of |x| and of
softplus at 0, the 1e-12 / 1e-6 / 1e-8 guards, the 1e10 tail interval) the
reference keeps it: it is part of what the model computes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision


# ---------------------------------------------------------------- layers
def abs_sel(x):
    """|x| whose subgradient at 0 is +1 (the model's loss convention)."""
    return torch.where(x >= 0, x, -x)


def softplus100(x):
    """softplus with beta 100, overflow-safe; subgradient 0 at 0."""
    y = 100.0 * x
    return (torch.relu(y) + torch.log1p(torch.exp(-y.abs()))) * 0.01


def conv(P: Precision, x, prm, name, stride=1, padding=0):
    b = prm.get(f"{name}.bias")
    return P.q(F.conv2d(P.q(x), P.q(prm[f"{name}.weight"]), b, stride, padding))


def conv_t(P: Precision, x, prm, name):
    b = prm.get(f"{name}.bias")
    return P.q(F.conv_transpose2d(P.q(x), P.q(prm[f"{name}.weight"]), b, 2, 1, 1))


def group_norm(P: Precision, x, prm, name):
    c = x.shape[1]
    return P.q(F.group_norm(x, min(32, c), prm[f"{name}.weight"], prm[f"{name}.bias"], 1e-5))


def inorm(P: Precision, x):
    return P.q(F.instance_norm(x))


def linear(P: Precision, x, prm, name):
    if f"{name}.weight_v" in prm:
        v, g = prm[f"{name}.weight_v"], prm[f"{name}.weight_g"]
        w = v * (g / (torch.linalg.norm(v, dim=1, keepdim=True) + 1e-12))
    else:
        w = prm[f"{name}.weight"]
    return P.q(F.linear(P.q(x), P.q(w), prm[f"{name}.bias"]))


# -------------------------------------------------------------- encoders
def conv_block(P, x, prm, p):
    h1 = conv(P, F.relu(group_norm(P, x, prm, f"{p}.bn1")), prm, f"{p}.conv1", padding=1)
    h2 = conv(P, F.relu(group_norm(P, h1, prm, f"{p}.bn2")), prm, f"{p}.conv2", padding=1)
    h3 = conv(P, F.relu(group_norm(P, h2, prm, f"{p}.bn3")), prm, f"{p}.conv3", padding=1)
    if f"{p}.bn4.weight" in prm:
        res = conv(P, F.relu(group_norm(P, x, prm, f"{p}.bn4")), prm, f"{p}.downsample.2")
    else:
        res = x
    return P.q(torch.cat([h1, h2, h3], dim=1) + res)


def hourglass(P, x, prm, p, lvl):
    up1 = conv_block(P, x, prm, f"{p}.b1_{lvl}")
    low = conv_block(P, F.avg_pool2d(x, 2), prm, f"{p}.b2_{lvl}")
    low = hourglass(P, low, prm, p, lvl - 1) if lvl > 1 else conv_block(
        P, low, prm, f"{p}.b2_plus_1")
    low = conv_block(P, low, prm, f"{p}.b3_{lvl}")
    return P.q(up1 + P.q(F.interpolate(low, scale_factor=2, mode="bicubic",
                                       align_corners=True)))


def hg_filter(P, x, prm, m):
    g = "geo_encoder"
    x = F.relu(group_norm(P, conv(P, x, prm, f"{g}.conv1", 2, 3), prm, f"{g}.bn1"))
    x = conv_block(P, x, prm, f"{g}.conv2")
    hd = F.relu(group_norm(P, conv_t(P, x, prm, f"{g}.unpack1.conv"), prm, f"{g}.unpack1.norm"))
    x_hd = conv(P, hd, prm, f"{g}.conv_out", padding=2)
    x = conv_block(P, conv_block(P, F.avg_pool2d(x, 2), prm, f"{g}.conv3"), prm, f"{g}.conv4")
    ll = conv_block(P, hourglass(P, x, prm, f"{g}.m0", m["geo_n_downsample"]), prm,
                    f"{g}.top_m_0")
    ll = F.relu(group_norm(P, conv(P, ll, prm, f"{g}.conv_last0"), prm, f"{g}.bn_end0"))
    return conv(P, ll, prm, f"{g}.l0"), x_hd


def res_blk_encoder(P, x, prm, m):
    t = "tex_encoder.layers"
    nd, nb, nu = m["tex_n_downsample"], m["tex_n_blocks"], m["tex_n_upsample"]
    x = F.relu(inorm(P, conv(P, F.pad(x, (3,) * 4, mode="replicate"), prm, f"{t}.1")))
    idx = 4
    for _ in range(nd):
        x = F.relu(inorm(P, conv(P, x, prm, f"{t}.{idx}", 2, 1)))
        idx += 3
    for _ in range(nb):
        h = conv(P, F.pad(x, (1,) * 4, mode="replicate"), prm, f"{t}.{idx}.layers.1")
        h = F.relu(inorm(P, h))
        h = conv(P, F.pad(h, (1,) * 4, mode="replicate"), prm, f"{t}.{idx}.layers.5")
        x = P.q(x + inorm(P, h))
        idx += 1
    for _ in range(nu):
        x = F.relu(inorm(P, conv_t(P, x, prm, f"{t}.{idx}")))
        idx += 3
    if nu:
        x = conv(P, F.pad(x, (3,) * 4, mode="replicate"), prm, f"{t}.{idx + 1}")
    return x


def lookup(fmap, xy):
    """Bilinear lookup (border, align_corners) of V maps (V, H, W, C) at
    NDC points (V, N, 2): (V, N, C)."""
    out = F.grid_sample(fmap.permute(0, 3, 1, 2), xy[:, None].to(fmap.dtype), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[:, :, 0].permute(0, 2, 1)


def pixel_grid(height, width, device):
    """(h*w, 2) (x, y) integer pixel coordinates, row-major in y."""
    yy, xx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(-1, 2)


def encode(P: Precision, prm, m, src_images, src_masks, train=False):
    """The maps as the query uses them, NHWC float32: "coarse" (V, H/4,
    W/4, 64), "hd" (V, H, W, 8), "tex" (V, H/2, W/2, 8), and "full" (V, H,
    W, 12) = [hd | RGB | mask], or with the fused map "fused" (V, Hm, Wm,
    84) = [coarse | hd | tex | RGB | mask] on the input grid or its half."""
    x = (2.0 * src_images - 1.0).permute(0, 3, 1, 2)
    coarse, hd = hg_filter(P, x, prm, m)
    tex = res_blk_encoder(P, x, prm, m)
    nhwc = lambda t: P.q(t.permute(0, 2, 3, 1).contiguous())  # noqa: E731
    feats = {"coarse": nhwc(coarse), "hd": nhwc(hd), "tex": nhwc(tex)}
    hd_rgb_mask = torch.cat([feats["hd"], src_images, src_masks], dim=-1)
    if not m["fused_feature_map"]:
        feats["full"] = hd_rgb_mask
        return feats
    V, H, W = src_images.shape[:3]
    half = m["fused_map_half"] and min(H, W) >= m["fused_map_half_min_side"]
    Hm, Wm = (H // 2, W // 2) if half else (H, W)
    grid = pixel_grid(Hm, Wm, src_images.device).float()
    xy = torch.stack([2.0 * grid[:, 0] / (Wm - 1.0) - 1.0,
                      2.0 * grid[:, 1] / (Hm - 1.0) - 1.0], dim=-1)[None].expand(V, -1, -1)
    up = lambda f: lookup(f, xy).reshape(V, Hm, Wm, -1)  # noqa: E731
    if half:
        hd_rgb_mask = up(hd_rgb_mask)
    hc = m["geo_out_ch_hd"]
    feats["fused"] = P.q(torch.cat([up(feats["coarse"]), hd_rgb_mask[..., :hc], up(feats["tex"]),
                                    hd_rgb_mask[..., hc:]], dim=-1))
    return feats


# ------------------------------------------------------------------ query
def strided_gather_lerp(fmap, xy, n_samples, stride):
    """The lookup at every `stride`-th sample of each ray and its last; the
    samples between lerped from their segment's anchors by the parametric
    position of their projection on it (the fast preset's lookup)."""
    V, N, _ = xy.shape
    S, k = n_samples, stride
    R = N // S
    xyr = xy.reshape(V, R, S, 2)
    xa = torch.cat([xyr[:, :, ::k], xyr[:, :, -1:]], dim=2)
    G = xa.shape[2]
    fa = lookup(fmap, xa.reshape(V, R * G, 2)).reshape(V, R, G, -1)
    rep = lambda a: a.repeat_interleave(k, dim=2)[:, :, :S]  # noqa: E731
    left, right = rep(fa[:, :, :-1]), rep(fa[:, :, 1:])
    xl, xr = rep(xa[:, :, :-1]), rep(xa[:, :, 1:])
    seg = xr - xl
    t = ((xyr - xl) * seg).sum(-1, keepdim=True) / ((seg * seg).sum(-1, keepdim=True) + 1e-12)
    t = t.clamp(0.0, 1.0)
    return (left + t * (right - left)).reshape(V, N, -1)


def to_cam(pts, R, t):
    """World points (N, 3) into the V camera frames: (V, N, 3)."""
    return torch.einsum("nj,vij->vni", pts, R) + t[:, None, :]


def ndc(vb, pts, m):
    """NDC xy (V, N, 2) and depth (V, N, 1) of world points in the views."""
    H, W = vb["src_images"].shape[1:3]
    cam = to_cam(pts, vb["src_R"], vb["src_t"])
    uvw = torch.einsum("vnj,vij->vni", cam, vb["src_K"])
    xy_pix = uvw[..., :2] / uvw[..., 2:3]
    xy = torch.stack([xy_pix[..., 0] * (2.0 / (W - 1.0)) - 1.0,
                      xy_pix[..., 1] * (2.0 / (H - 1.0)) - 1.0], dim=-1)
    zn = 2.0 * (uvw[..., 2:3] - m["znear"]) / (m["zfar"] - m["znear"]) - 1.0
    return xy, zn


def rel_z_decay(m, pts_cam, kpt_cam):
    """The encoding (V, N, (1 + 2L) K): [dz w, sin(2^l pi dz) w, cos(..) w]."""
    dz = m["sp_scale"] * (pts_cam[:, :, None, 2] - kpt_cam[:, None, :, 2])
    d = pts_cam[:, :, None, :] - kpt_cam[:, None, :, :]
    w = torch.exp(-(d * d).sum(-1) / (2.0 * m["sp_sigma"] ** 2))
    blocks = [dz * w]
    for lvl in range(m["sp_level"]):
        y = (2.0 ** lvl * math.pi) * dz
        blocks += [torch.sin(y) * w, torch.cos(y) * w]
    return torch.cat(blocks, dim=-1)


def geo_mlp(P, prm, m, enc, f_coarse, f_hd, mask, pw):
    """Per-view MLP (coarse features beside the encoding at the first
    layer, hires at the third), weighted mean / var pool over views, fusion
    MLP. Returns out (N, 2) [sdf, radiance], valid (N, 1), latent (N, 128)."""
    skips = dict(zip(m["mlp_skip_layers"], (f_coarse, f_hd)))
    n1 = len(m["mlp_dims1"]) - 1
    x = enc
    for i in range(n1):
        if i in skips:
            x = torch.cat([x, skips[i]], dim=-1)
        x = linear(P, x, prm, f"mlp_geo.layers1.layers.{i}.linear")
        if i < n1 - 1:
            x = P.q(softplus100(x))
    mean = (pw * x).sum(0)
    var = (pw * (x - mean[None]) ** 2).sum(0)
    latent = torch.cat([mean, var], dim=-1)
    valid = mask.sum(0) > 0.0
    y = latent
    n2 = len(m["mlp_dims2"]) - 1
    for i in range(n2):
        y = linear(P, y, prm, f"mlp_geo.layers2.layers.{i}.linear")
        if i < n2 - 1:
            y = P.q(softplus100(y))
    return y, valid, latent


def ibr_head(P, prm, rgb_feats, ray_diffs, proj_mask):
    """The IBRNet-style blend of the source views' colours: (N, 3)."""
    L = lambda x, n: linear(P, x, prm, f"mlp_tex.{n}")  # noqa: E731
    elu = lambda x: P.q(F.elu(x))  # noqa: E731
    dir_feat = elu(L(elu(L(ray_diffs, "ray_encoder.0")), "ray_encoder.2"))
    src_rgb = rgb_feats[..., :3]
    feats = rgb_feats + dir_feat
    exp_dot = P.q(torch.exp(prm["mlp_tex.ani_al"].abs() * (ray_diffs[..., 3:4] - 1.0)))
    w = (exp_dot - exp_dot.amin(dim=0, keepdim=True)) * proj_mask
    w = w / (w.sum(dim=0, keepdim=True) + 1e-8)
    mean = (feats * w).sum(dim=0, keepdim=True)
    var = (w * (feats - mean) ** 2).sum(dim=0, keepdim=True)
    V = feats.shape[0]
    x = torch.cat([mean.expand(V, -1, -1), var.expand(V, -1, -1), feats], dim=-1)
    x = elu(L(elu(L(x, "base_layer.0")), "base_layer.2"))
    pred = elu(L(elu(L(x * w, "vis_layer1.0")), "vis_layer1.2"))
    x = x + pred[..., :-1]
    vis = P.q(torch.sigmoid(pred[..., -1:]))
    vis = P.q(torch.sigmoid(L(elu(L(x * vis * proj_mask, "vis_layer2.0")), "vis_layer2.2")))
    vis = vis * proj_mask
    x = L(torch.cat([x, vis, ray_diffs], dim=-1), "out_layer.0")
    x = L(elu(L(elu(x), "out_layer.2")), "out_layer.4")
    logits = torch.where(proj_mask == 0.0, torch.full_like(x, -1e9), x)
    return (src_rgb * torch.softmax(logits, dim=0)).sum(dim=0)


def query(P, prm, m, pts, view_dirs, feats, vb, n_samples, view_keep=None):
    """[sdf, radiance, rgb, valid] at N world points (N, 3)."""
    xy, zn = ndc(vb, pts, m)
    eps = 1e-2
    in_xy = ((xy >= -1.0 - eps) & (xy <= 1.0 + eps)).all(dim=-1, keepdim=True)
    mask = (in_xy & (zn >= -1.0)).float()
    hc, cc, tc = m["geo_out_ch_hd"], m["geo_out_ch"], m["tex_out_ch"]
    if "fused" in feats:
        N = pts.shape[0]
        lerp = (m["gather_lerp"] and view_keep is None
                and n_samples > m["gather_lerp_stride"] >= 2 and N % n_samples == 0)
        fx = P.q(strided_gather_lerp(feats["fused"], xy, n_samples, m["gather_lerp_stride"])
                 if lerp else lookup(feats["fused"], xy))
        f_coarse, f_hd = fx[..., :cc], fx[..., cc:cc + hc]
        f_tex = fx[..., cc + hc:cc + hc + tc]
        img, fg = fx[..., cc + hc + tc:cc + hc + tc + 3], fx[..., cc + hc + tc + 3:]
    else:
        full = P.q(lookup(feats["full"], xy))
        f_hd, img, fg = full[..., :hc], full[..., hc:hc + 3], full[..., hc + 3:hc + 4]
        f_coarse = P.q(lookup(feats["coarse"], xy))
        f_tex = P.q(lookup(feats["tex"], xy))
    all_valid = (mask > 0.0).all(dim=0) & (fg > 0.1).all(dim=0)
    mask = mask * all_valid[None].float()
    if view_keep is not None and mask.shape[0] > 1:
        mask = mask * view_keep[:, None, None]
    xyz01 = 0.5 * torch.cat([xy, zn], dim=-1) + 0.5
    pw = torch.sigmoid(5.0 * (torch.minimum(xyz01, 1.0 - xyz01) / 0.1 - 1.0))
    pw = pw[..., 0:1] * pw[..., 1:2] * pw[..., 2:3] * mask
    pw = (pw / (pw.sum(dim=0, keepdim=True) + 1e-6)).detach()

    pts_cam = to_cam(pts, vb["src_R"], vb["src_t"])
    kpt_cam = to_cam(vb["kpt3d"], vb["src_R"], vb["src_t"])
    enc = P.q(rel_z_decay(m, pts_cam, kpt_cam))
    out, valid, latent = geo_mlp(P, prm, m, enc, f_coarse, f_hd, mask, pw)
    V, N = mask.shape[:2]
    latent24 = linear(P, latent, prm, "ibr_compress_gfeat")[None].expand(V, N, -1)
    rgb_feat = torch.cat([img, f_tex, latent24], dim=-1)
    cam_pos = -torch.einsum("vji,vj->vi", vb["src_R"], vb["src_t"])
    cam_rays = pts[None] - cam_pos[:, None, :]
    cam_rays = cam_rays / (torch.linalg.norm(cam_rays, dim=-1, keepdim=True) + 1e-9)
    rd = view_dirs[None] - cam_rays
    rd_dir = rd / torch.clamp(torch.linalg.norm(rd, dim=-1, keepdim=True), min=1e-6)
    rd_dot = (cam_rays * view_dirs[None]).sum(dim=-1, keepdim=True)
    rgb = ibr_head(P, prm, rgb_feat, torch.cat([rd_dir, rd_dot], dim=-1), mask)
    return out[..., 0:1], out[..., 1:2], rgb, valid.float()


def eval_density(P, prm, m, pts, view_dirs, feats, vb, n_samples, qdraws=None):
    """alpha (N,), sdf (N,), rgb (N, 3): background sdf off the valid set,
    the training radiance noise, alpha = valid * relu(radiance)."""
    sdf, rad, rgb, valid = query(P, prm, m, pts, view_dirs, feats, vb, n_samples,
                                 None if qdraws is None else qdraws["view_keep"])
    sdf = valid * sdf + (1.0 - valid) * m["bkg_sdf"]
    if qdraws is not None and m["rand_noise_std"] > 0.0:
        rad = rad + qdraws["noise"]
    return (valid * torch.relu(rad))[..., 0], sdf[..., 0], rgb


# --------------------------------------------------------- ray geometry
def camera_rays(pix, K, R, t, znear, zfar):
    """origin (3,), unit world directions (N, 3) and metric near / far
    (N, 1) through integer pixel coordinates (N, 2)."""
    pix_h = torch.cat([pix, torch.ones_like(pix[:, :1])], dim=-1)
    d_cam = pix_h @ torch.linalg.inv(K).T
    scale = torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d = d_cam @ R
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return -R.T @ t, d, znear * scale, zfar * scale


def aabb(bounds, origin, dirs, boffset=(-0.01, 0.01), eps=1e-6):
    """Ray / box: a ray hits when exactly two of its six plane crossings lie
    on the (offset) box; near / far are those crossings' |t|."""
    b = bounds + torch.tensor(boffset, dtype=bounds.dtype, device=bounds.device)[:, None]
    d = torch.where(dirs.abs() < 1e-5, torch.full_like(dirs, 1e-5), dirs)
    # the six crossings in the order (min x, min y, min z, max x, max y, max z)
    t6 = ((b[None] - origin[None, None]) / d[:, None, :]).reshape(-1, 6)
    p = origin[None, None] + t6[..., None] * d[:, None, :]
    on_box = ((p >= b[0] - eps) & (p <= b[1] + eps)).all(dim=-1)
    hit = on_box.sum(dim=-1) == 2
    dist = t6.abs()
    inf = torch.full_like(dist, float("inf"))
    near = torch.where(on_box, dist, inf).amin(dim=-1)
    far = torch.where(on_box, dist, -inf).amax(dim=-1)
    one = torch.ones_like(near)
    return (torch.where(hit, near, one)[:, None], torch.where(hit, far, one)[:, None],
            hit[:, None])


def composite(alpha, sdf, rgb, z):
    """Alpha compositing with a 1e10 tail interval: color, depth, acc,
    per-sample contributions, sdf."""
    dist = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1)
    a = 1.0 - torch.exp(-alpha * dist)
    trans = torch.cumprod(torch.cat([torch.ones_like(a[..., :1]), 1.0 - a[..., :-1]], dim=-1),
                          dim=-1)
    contrib = a * trans
    acc = contrib.sum(-1)
    return {"color": (rgb * contrib[..., None]).sum(-2), "acc": acc, "contrib": contrib,
            "depth": (z * contrib).sum(-1) / (acc + 1e-8),
            "sdf": (sdf * contrib).sum(-1) / (acc + 1e-8)}


def importance_z(contrib, z_bins, n, u):
    """Inverse-CDF samples of the bins' pdf (weights + 1e-5) at u (R, n):
    bin j = #{cdf <= u} - 1, the top edge clamped, den < 1e-5 taken as 1."""
    w = contrib + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    j = (torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1).clamp(min=0)
    pad_cdf = torch.cat([cdf, cdf[..., -1:]], dim=-1)
    pad_z = torch.cat([z_bins, z_bins[..., -1:]], dim=-1)
    c0, c1 = torch.gather(cdf, -1, j), torch.gather(pad_cdf, -1, j + 1)
    z0, z1 = torch.gather(z_bins, -1, j), torch.gather(pad_z, -1, j + 1)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return z0 + (u - c0) / den * (z1 - z0)


def stratified(near, far, n, u=None):
    """Depths in [near, far]: evenly spaced, or jittered in their bins by u."""
    z = torch.linspace(0.0, 1.0, n, device=near.device).expand(near.shape[0], n)
    if u is not None:
        mid = 0.5 * (z[:, 1:] + z[:, :-1])
        lower = torch.cat([z[:, :1], mid], dim=-1)
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        z = lower + u * (upper - lower)
    return near + (far - near) * z
