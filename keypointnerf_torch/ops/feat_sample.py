"""Bilinear feature sampling at continuous image locations.

Port of `keypointnerf_tpu/ops/feat_sample.py` (`bilinear_sample`,
`multiview_bilinear_sample` and the matmul-VJP `multiview_bilinear_sample_mm`):
torch `grid_sample` semantics with mode='bilinear', padding_mode='border',
align_corners=True.

  * NDC [-1, 1] maps to pixel centers [0, S-1] (align_corners).
  * Coordinates are clamped to the border before the corner/weight split.
  * The 2x2 patch base is clamped to S-2 and the fractional weight is
    re-derived against it (at x = S-1 the weight is 1.0 on the second
    column), which reproduces border padding exactly.

This is plain PyTorch indexing; it serves the coarse 64-ch map and the
packed 12-ch "full" map. The corner weights are built in f32 and cast once
to the map dtype; each weighted corner is rounded to the map dtype and the
4-term sum is taken in f32 and rounded once, which is how the JAX
package's program evaluates the bf16 blend on the CPU (bit-equal there,
tests/test_torch_ops.py).
"""
from __future__ import annotations

import torch


def bilinear_coords(xy, H, W):
    """Border-clamped corner indices and weights of NDC points.

    xy: (..., 2) f32 NDC. Returns (x0, y0) int64 patch bases in
    [0, W-2] x [0, H-2] and the f32 fractional weights (wx, wy).
    """
    x = ((xy[..., 0] + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1.0)
    y = ((xy[..., 1] + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(max=W - 2)
    y0 = torch.floor(y).clamp(max=H - 2)
    return x0.long(), y0.long(), x - x0, y - y0


def gather_corners(feats, x0, y0):
    """The four (V, N, C) corner rows [M00, M01, M10, M11] of a
    (V, H, W, C) map at per-view bases (V, N); M01 is (y0, x0 + 1)."""
    V, H, W, C = feats.shape
    flat = feats.reshape(V * H * W, C)
    view = torch.arange(V, device=feats.device)[:, None]
    base = (view * H + y0) * W + x0
    return [flat[base + off] for off in (0, 1, W, W + 1)]


def multiview_bilinear_sample(feats, xy):
    """Sample V feature maps at per-view locations.

    feats: (V, H, W, C); xy: (V, N, 2) NDC. Returns (V, N, C) in
    feats.dtype.
    """
    V, H, W, C = feats.shape
    x0, y0, wx, wy = bilinear_coords(xy.float(), H, W)
    w00 = (1.0 - wy) * (1.0 - wx)
    w01 = (1.0 - wy) * wx
    w10 = wy * (1.0 - wx)
    w11 = wy * wx
    dt = feats.dtype
    out = None
    for m, w in zip(gather_corners(feats, x0, y0), (w00, w01, w10, w11)):
        term = (m * w.to(dt)[..., None]).float()
        out = term if out is None else out + term
    return out.to(dt)


def bilinear_sample(feat, xy):
    """One (H, W, C) map at (N, 2) NDC points -> (N, C)."""
    return multiview_bilinear_sample(feat[None], xy[None])[0]


# maps with at least this many gradient channels take K1 (the JAX
# package's default KPN_DMAP_MIN_C; the env override is not ported)
DMAP_KERNEL_MIN_CHANNELS = 32


class _BilinearSampleMM(torch.autograd.Function):
    """`multiview_bilinear_sample` with the JAX package's matmul-VJP
    backward (`_mm_bwd_impl`): the coordinate gradient from one f32
    re-gather of the corners, zeroed where the unclamped coordinate lies
    outside [0, S-1]; the map gradient over the first `grad_channels`
    channels (zeros after them), per-term rounded to the map dtype and
    summed in f32, returned in the map dtype."""

    @staticmethod
    def forward(ctx, feats, xy, grad_channels, pallas_dmap):
        ctx.save_for_backward(feats, xy)
        ctx.grad_channels, ctx.pallas_dmap = grad_channels, pallas_dmap
        return multiview_bilinear_sample(feats, xy)

    @staticmethod
    def backward(ctx, g):
        from .onehot_dmap import multiview_dmap_onehot, onehot_dmap_plain

        feats, xy = ctx.saved_tensors
        V, H, W, C = feats.shape
        gf = g.float()
        dmap = dxy = None
        if ctx.needs_input_grad[1]:
            xs = (xy[..., 0].float() + 1.0) * 0.5 * (W - 1)
            ys = (xy[..., 1].float() + 1.0) * 0.5 * (H - 1)
            in_x = (xs >= 0.0) & (xs <= W - 1.0)
            in_y = (ys >= 0.0) & (ys <= H - 1.0)
            x0, y0, wx, wy = bilinear_coords(xy.float(), H, W)
            m00, m01, m10, m11 = (m.float() for m in gather_corners(feats, x0, y0))
            wx, wy = wx[..., None], wy[..., None]
            d_px = (1.0 - wy) * (m01 - m00) + wy * (m11 - m10)
            d_py = (1.0 - wx) * (m10 - m00) + wx * (m11 - m01)
            dx = (gf * d_px).sum(-1) * (0.5 * (W - 1)) * in_x
            dy = (gf * d_py).sum(-1) * (0.5 * (H - 1)) * in_y
            dxy = torch.stack([dx, dy], dim=-1).to(xy.dtype)
        if ctx.needs_input_grad[0]:
            cg = C if ctx.grad_channels is None else min(ctx.grad_channels, C)
            gc = gf[..., :cg].contiguous()
            xyf = xy.float().contiguous()
            if ctx.pallas_dmap and cg >= DMAP_KERNEL_MIN_CHANNELS:
                dmap = multiview_dmap_onehot(xyf, gc, H, W, feats.dtype)      # K1
            else:
                dmap = onehot_dmap_plain(xyf, gc, H, W, feats.dtype)          # the XLA scan's terms
            if cg < C:
                dmap = torch.cat([dmap, dmap.new_zeros((V, H, W, C - cg))], dim=-1)
            dmap = dmap.to(feats.dtype)
        return dmap, dxy, None, None


def multiview_bilinear_sample_mm(feats, xy, grad_channels=None, pallas_dmap=False):
    """`multiview_bilinear_sample` with the matmul-VJP backward, the
    training-path lookup when `train_matmul_gather_vjp` is on.

    feats (V, H, W, C); xy (V, N, 2). `grad_channels` restricts the map
    gradient to a channel prefix; with `pallas_dmap` a prefix of at least
    DMAP_KERNEL_MIN_CHANNELS channels goes to K1 (ops/onehot_dmap.py).
    """
    return _BilinearSampleMM.apply(feats, xy, grad_channels, bool(pallas_dmap))
