"""K2: the exact bilinear tex-map lookup of the strict preset.

Replaces the Pallas kernel `keypointnerf_tpu/ops/pallas/onehot_bilinear.py`
(`onehot_bilinear_sample` / `multiview_onehot_bilinear_sample`), which the
JAX model calls for the tex map when `tex_onehot_sample` is set. The TPU
kernel computes the lookup as one-hot MXU contractions; their zero terms
are exact zeros, so the same values come from the four corners with the
TPU kernel's rounding order (see csrc/onehot_bilinear.cu):

  yw, xw  rounded to the map dtype
  t_x  = rnd(yw0 * M[y0, x] + yw1 * M[y0+1, x])     x in {x0, x0+1}
  g_x  = rnd(xw_x * t_x)
  out  = rnd(g_x0 + g_x1)

with every product and sum in f32 and rnd() the round to the map dtype.

The wrapper calls the registered op `kpnerf::onehot_bilinear`: on a CUDA
tensor it launches the hand-written kernel (one launch for all views; a
thread a point, moving its row in pieces of `feat_sample.piece_bytes`) or
raises; on a CPU tensor it runs `onehot_bilinear_plain`, the same five
steps as tensor ops.
"""
from __future__ import annotations

from ._build import check_device, define_op
from .feat_sample import bilinear_coords, check_lookup, gather_corners, launch_lookup, lookup_out


def onehot_bilinear_plain(feats, xy):
    """The plain PyTorch version of the kernel.

    feats: (V, H, W, C) f32 or bf16; xy: (V, N, 2) f32 NDC. Returns
    (V, N, C) in feats.dtype.
    """
    dt = feats.dtype
    V, H, W, C = feats.shape
    x0, y0, wx, wy = bilinear_coords(xy, H, W)

    def rnd(t):
        return t.to(dt).float()

    yw0, yw1 = rnd(1.0 - wy)[..., None], rnd(wy)[..., None]
    xw0, xw1 = rnd(1.0 - wx)[..., None], rnd(wx)[..., None]
    m00, m01, m10, m11 = (m.float() for m in gather_corners(feats, x0, y0))
    t0 = rnd(yw0 * m00 + yw1 * m10)
    t1 = rnd(yw0 * m01 + yw1 * m11)
    return (rnd(xw0 * t0) + rnd(xw1 * t1)).to(dt)


def _launch(feats, xy):
    return launch_lookup(multiview_onehot_bilinear_sample, "onehot_bilinear", feats, xy)


_OP = define_op("onehot_bilinear(Tensor feats, Tensor xy) -> Tensor", _launch,
                onehot_bilinear_plain, lookup_out)


def multiview_onehot_bilinear_sample(feats, xy):
    """Exact bilinear lookup of V maps at per-view NDC points.

    feats: (V, H, W, C) f32 or bf16; xy: (V, N, 2) f32. Returns (V, N, C)
    in feats.dtype. CUDA tensors go to the kernel (counted in
    `multiview_onehot_bilinear_sample.launches`), CPU tensors to the plain
    version, both through the registered op.
    """
    check_lookup(feats, xy)
    check_device(feats)
    return _OP(feats, xy)


multiview_onehot_bilinear_sample.launches = 0
