"""One target camera rendered by the reference: the exact empty-ray cull,
the coarse march, uniform importance resampling, the fine march merged
with the coarse samples, and (fast preset) the per-chunk fine cut.

The cull is part of the configuration's semantics: a ray whose every
sample fails the all-view foreground test composites to exactly zero, and
the configuration marches the top `cull_empty_rays_ratio` of the rays by a
conservative per-ray bound (cell maxima of the foreground mask the query
reads). The reference computes that bound again from the inputs and its
own maps, marches the rays the configuration marches, in the order and
chunks the configuration defines (the fast preset's fine cut picks the
top 0.75 of each chunk's rays by coarse opacity), and gives every other
ray zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import (aabb, camera_rays, composite, encode, eval_density, importance_z,
                    pixel_grid, stratified)
from .precision import Precision

EMPTY_SCORE_THRESHOLD = 0.09


def _mask_cells(masks, cell):
    """(V, Hc, Wc) maxima of (V, H, W) masks over (cell + 1)-wide windows
    strided by `cell` (covering the four corners of a clamped lookup)."""
    V, H, W = masks.shape
    hc, wc = (H - 1) // cell + 1, (W - 1) // cell + 1
    m = F.pad(masks, (0, (wc - 1) * cell + cell + 1 - W, 0, (hc - 1) * cell + cell + 1 - H))
    return F.max_pool2d(m[:, None], cell + 1, stride=cell)[:, 0]


def empty_scores(m, vb, feats, origin, dirs, near, far, cell=8):
    """The per-ray bound: the foreground value a ray's points can see in
    their worst view (cell values rounded to bfloat16, as the
    configuration's bound is defined); <= 0.09 proves the ray empty."""
    H, W = vb["src_masks"].shape[1:3]
    if "fused" in feats:
        base = m["geo_out_ch"] + m["geo_out_ch_hd"] + m["tex_out_ch"] + 3
        mask_map = feats["fused"][..., base]
    else:
        mask_map = vb["src_masks"][..., 0]
    V, Hm, Wm = mask_map.shape
    lerp = "fused" in feats and m["gather_lerp"] and m["gather_lerp_stride"] >= 2
    tight = lerp and m["reuse_coarse_eval"] and not m["separate_cf"]
    cmax = _mask_cells(mask_map.float(), cell).to(torch.bfloat16).float()
    z1, z2, hit = aabb(vb["bounds"], origin, dirs)
    near = torch.where(hit & (z1 > near), z1, near)
    far = torch.where(hit & (z2 < far), z2, far)
    z = stratified(near, far, m["n_coarse"])
    zf = importance_z(torch.zeros_like(z[:, :m["n_coarse"] - 2]), 0.5 * (z[:, 1:] + z[:, :-1]),
                      m["n_fine"], torch.linspace(0, 1, m["n_fine"], device=z.device)
                      .expand(z.shape[0], -1))
    if tight:
        k = m["gather_lerp_stride"]
        anchors = lambda S: torch.cat([torch.arange(0, S, k), torch.tensor([S - 1])])  # noqa
        ia_c, ia_f = anchors(m["n_coarse"]).to(z.device), anchors(m["n_fine"]).to(z.device)
        z_all = torch.cat([z[:, ia_c], zf[:, ia_f]], dim=-1)
    else:
        z_all = torch.cat([z, zf], dim=-1)
    pts = origin + dirs[:, None, :] * z_all[..., None]
    cam = torch.einsum("nj,vij->vni", pts.reshape(-1, 3), vb["src_R"]) + vb["src_t"][:, None]
    uvw = torch.einsum("vnj,vij->vni", cam, vb["src_K"])
    xy = uvw[..., :2] / uvw[..., 2:3]
    x_ndc = xy[..., 0] * (2.0 / (W - 1.0)) - 1.0
    y_ndc = xy[..., 1] * (2.0 / (H - 1.0)) - 1.0
    px = ((x_ndc + 1.0) * 0.5 * (Wm - 1)).clamp(0.0, Wm - 1.0)
    py = ((y_ndc + 1.0) * 0.5 * (Hm - 1)).clamp(0.0, Hm - 1.0)
    cx, cy = torch.floor(px / cell).long(), torch.floor(py / cell).long()
    hc, wc = cmax.shape[1:]
    view = torch.arange(V, device=cmax.device)[:, None]
    vals = cmax.reshape(-1)[(view * hc + cy) * wc + cx].reshape(V, -1, z_all.shape[-1])
    if tight:
        group = lambda v: F.max_pool1d(v, 3, stride=1, padding=1).amin(0).amax(-1)  # noqa
        n_c = ia_c.shape[0]
        return torch.maximum(group(vals[..., :n_c]), group(vals[..., n_c:]))
    if lerp:
        return vals.amax(dim=-1).amin(dim=0)
    return vals.amin(dim=0).amax(dim=-1)


def top_k(score, k):
    """The k largest, largest first, lower index first among equals."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def march(P, prm, m, feats, vb, origin, dirs, near, far):
    """Coarse + fine eval march of R rays: rgb / depth / acc of both
    passes and the fine sdf."""
    R = dirs.shape[0]
    nc, nf = m["n_coarse"], m["n_fine"]
    z1, z2, hit = aabb(vb["bounds"], origin, dirs)
    near = torch.where(hit & (z1 > near), z1, near)
    far = torch.where(hit & (z2 < far), z2, far)
    z = stratified(near, far, nc)
    pts = origin + dirs[:, None, :] * z[..., None]
    view = dirs[:, None, :].expand(pts.shape)
    alpha, sdf, rgb = eval_density(P, prm, m, pts.reshape(-1, 3), view.reshape(-1, 3), feats,
                                   vb, nc)
    alpha, sdf, rgb = alpha.reshape(R, nc), sdf.reshape(R, nc), rgb.reshape(R, nc, 3)
    c = composite(alpha, sdf, rgb, z)
    out = {"rgb_coarse": c["color"], "depth_coarse": c["depth"], "acc_coarse": c["acc"]}
    u = torch.linspace(0, 1, nf, device=z.device).expand(R, nf)
    z_fine = importance_z(c["contrib"][:, 1:-1], 0.5 * (z[:, 1:] + z[:, :-1]), nf, u)
    sel = top_k(c["acc"], max(1, int(R * m["fine_topk_ratio"]))) if m["fine_topk_ratio"] < 1.0 \
        else torch.arange(R, device=z.device)
    Rf = sel.shape[0]
    zf, df = z_fine[sel], dirs[sel]
    pts = origin + df[:, None, :] * zf[..., None]
    alpha_f, sdf_f, rgb_f = eval_density(P, prm, m, pts.reshape(-1, 3),
                                         df[:, None, :].expand(pts.shape).reshape(-1, 3),
                                         feats, vb, nf)
    # the coarse samples' values merged with the fine ones in depth order
    # (ties: coarse first)
    zs = torch.cat([z[sel], zf], dim=-1)
    v_c = torch.cat([alpha[sel][..., None], sdf[sel][..., None], rgb[sel]], dim=-1)
    v_f = torch.cat([alpha_f.reshape(Rf, nf, 1), sdf_f.reshape(Rf, nf, 1),
                     rgb_f.reshape(Rf, nf, 3)], dim=-1)
    order = torch.sort(zs, dim=-1, stable=True).indices
    zs = torch.gather(zs, -1, order)
    vs = torch.gather(torch.cat([v_c, v_f], dim=1), 1, order[..., None].expand(-1, -1, 5))
    f = composite(vs[..., 0], vs[..., 1], vs[..., 2:5], zs)
    res = torch.cat([f["color"], f["depth"][:, None], f["acc"][:, None], f["sdf"][:, None]], -1)
    fallback = torch.cat([c["color"], c["depth"][:, None], c["acc"][:, None],
                          c["sdf"][:, None]], -1)
    res = fallback.index_copy(0, sel, res)
    out.update(rgb_fine=res[:, :3], depth_fine=res[:, 3], acc_fine=res[:, 4], sdf_fine=res[:, 5])
    return out


@torch.no_grad()
def render_frame(P: Precision, prm, m, vb, K, R, t, height, width, chunk, feats=None):
    """The target camera (K, R, t) at height x width: a dict of (H, W, C)
    outputs and the cull's overflow (rays above the bound beyond the
    budget; 0 where the cull is exact). `feats` (from `encode`) is made
    here when None."""
    if feats is None:
        feats = encode(P, prm, m, vb["src_images"], vb["src_masks"])
    dev = K.device
    pix = pixel_grid(height, width, dev).float()
    origin, dirs, near, far = camera_rays(pix, K, R, t, m["znear"], m["zfar"])
    n = dirs.shape[0]
    ratio = m["cull_empty_rays_ratio"]
    if ratio < 1.0:
        scores = empty_scores(m, vb, feats, origin, dirs, near, far)
        k = max(1, min(n, -int(-n * ratio // 1)))
        overflow = max(0, int((scores > EMPTY_SCORE_THRESHOLD).sum()) - k)
        sel = top_k(scores, k)
    else:
        overflow, sel = 0, torch.arange(n, device=dev)
    k = sel.shape[0]
    parts = []
    for s in range(0, k, chunk):
        idx = sel[torch.arange(s, s + chunk, device=dev) % k] if s + chunk > k else sel[s:s + chunk]
        o = march(P, prm, m, feats, vb, origin, dirs[idx], near[idx], far[idx])
        parts.append({key: v[:min(chunk, k - s)] for key, v in o.items()})
    marched = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    out = {}
    for key, v in marched.items():
        full = v.new_zeros((n,) + v.shape[1:])
        full[sel] = v
        out[key] = full.reshape((height, width) + v.shape[1:])
    return out, overflow
