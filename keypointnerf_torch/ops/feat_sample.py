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

import ctypes

import torch

from ._build import DTYPE_CODE, entry, launch


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


def check_lookup(feats, xy):
    """Raise on what the lookup kernels (K2, K3) do not take: maps (V, H,
    W, C) at least 2x2 in f32 or bf16, f32 points (V, N, 2) on the same
    device."""
    fs, xs = feats.shape, xy.shape
    if len(fs) != 4 or len(xs) != 3 or xs[2] != 2:
        raise ValueError(f"expected maps (V, H, W, C) and points (V, N, 2), got "
                         f"{tuple(fs)} and {tuple(xs)}")
    if xs[0] != fs[0]:
        raise ValueError(f"{fs[0]} maps but {xs[0]} point sets")
    if fs[1] < 2 or fs[2] < 2:
        raise ValueError(f"maps must be at least 2x2, got {tuple(fs)}")
    if feats.dtype not in DTYPE_CODE:
        raise TypeError(f"map dtype must be float32 or bfloat16, got {feats.dtype}")
    if xy.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {xy.dtype}")
    if feats.get_device() != xy.get_device() or feats.device.type != xy.device.type:
        raise ValueError(f"maps on {feats.device} but points on {xy.device}")


def piece_bytes(row_bytes: int, esize: int, *ptrs: int) -> int:
    """The bytes a lookup kernel's thread moves at once along a map row: 16
    or 8 where the row's bytes and every pointer allow it, else one element
    (the kernels' scalar variant). Chosen before the launch; the kernels
    refuse a width the row or a pointer does not allow."""
    for width in (16, 8):
        if row_bytes % width == 0 and all(p % width == 0 for p in ptrs):
            return width
    return esize


def launch_lookup(wrapper, name, feats, xy):
    """One launch of lookup kernel `name` (K2 or K3: C function
    `kpn_<name>` of library `name`, taking maps, xy, out, V, N, H, W, C,
    dtype, piece_bytes), counted in `wrapper.launches`; returns the
    output."""
    if not (feats.is_contiguous() and xy.is_contiguous()):
        raise ValueError("the kernel takes contiguous maps and points")
    V, H, W, C = feats.shape
    N = xy.shape[1]
    out = lookup_out(feats, xy)
    esize = feats.element_size()
    ptr, out_ptr = feats.data_ptr(), out.data_ptr()
    piece = piece_bytes(C * esize, esize, ptr, out_ptr)
    fn = entry(name, f"kpn_{name}", *(ctypes.c_void_p,) * 3, *(ctypes.c_int,) * 7)
    launch(wrapper, fn, feats, ptr, xy.data_ptr(), out_ptr, V, N, H, W, C,
           DTYPE_CODE[feats.dtype], piece)
    return out


def lookup_out(feats, xy):
    """A lookup's (V, N, C) output in the maps' dtype, uninitialised: the
    kernels' output buffer, and their ops' shapes under a trace."""
    return feats.new_empty((feats.shape[0], xy.shape[1], feats.shape[3]))


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


class _BilinearSampleMM(torch.autograd.Function):
    """`multiview_bilinear_sample` with the JAX package's matmul-VJP
    backward (`_mm_bwd_impl`): the coordinate gradient from one f32
    re-gather of the corners, zeroed where the unclamped coordinate lies
    outside [0, S-1]; the map gradient over the first `grad_channels`
    channels (zeros after them), per-term rounded to the map dtype and
    summed in f32, returned in the map dtype. The JAX package sends maps of
    at least 32 gradient channels to its Pallas kernel (with its
    `pallas_dmap`) and others to an XLA scan: the same terms either way.
    The port takes K1's wrapper for every map: on the card K1, which sums
    in a fixed order at any width (the plain version's index_add_ adds with
    float atomics there, or sorts in deterministic mode); on the CPU its
    plain version."""

    @staticmethod
    def forward(ctx, feats, xy, grad_channels):
        ctx.save_for_backward(feats, xy)
        ctx.grad_channels = grad_channels
        return multiview_bilinear_sample(feats, xy)

    @staticmethod
    def backward(ctx, g):
        from .onehot_dmap import multiview_dmap_onehot

        feats, xy = ctx.saved_tensors
        V, H, W, C = feats.shape
        dmap = dxy = None
        if ctx.needs_input_grad[1]:
            gf = g.float()
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
            # the cotangent in its own dtype (bf16 for a bf16 map): both
            # routes widen it exactly, so no f32 copy is made here
            gc = g[..., :cg].contiguous()
            xyf = xy.float().contiguous()
            dmap = multiview_dmap_onehot(xyf, gc, H, W, feats.dtype)          # K1
            if cg < C:
                dmap = torch.cat([dmap, dmap.new_zeros((V, H, W, C - cg))], dim=-1)
            dmap = dmap.to(feats.dtype)
        return dmap, dxy, None


def multiview_bilinear_sample_mm(feats, xy, grad_channels=None):
    """`multiview_bilinear_sample` with the matmul-VJP backward, the
    training-path lookup when `train_matmul_gather_vjp` is on.

    feats (V, H, W, C); xy (V, N, 2). `grad_channels` restricts the map
    gradient to a channel prefix, which K1 (ops/onehot_dmap.py) computes
    (`_BilinearSampleMM`).
    """
    return _BilinearSampleMM.apply(feats, xy, grad_channels)
