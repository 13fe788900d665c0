"""K3: the patch-gather bilinear lookup of the fused feature map.

Replaces the Pallas kernel `keypointnerf_tpu/ops/pallas/dma_gather.py`
(`dma_bilinear_sample`, reached through
`ops/feat_sample.py:multiview_bilinear_sample_dma`), which the JAX model
calls for the fused map when `use_dma_gather` is set at eval. The TPU
kernel streams each point's (2, 2, C) patch from HBM with a ring of async
copies and blends it with three lerps:

  wx, wy  rounded to the map dtype
  top  = p00 + wx * (p01 - p00)
  bot  = p10 + wx * (p11 - p10)
  out  = top + wy * (bot - top)

which is not `multiview_bilinear_sample`'s four-term weighted sum: the two
differ in the last bits, in f32 too. How each lerp rounds follows what the
JAX package's program computes on the CPU (tests/test_torch_fused_map.py):

  * bf16 maps: every difference, product and sum is rounded to bf16;
  * f32 maps: `a + w * d` is one fused multiply-add (the difference `d`
    rounded to f32 first). Both versions form it in f64 (the product of
    two f32 values is exact there) and round once to f32; this equals the
    FMA except where the f64 sum's own rounding lands on an f32 tie.

Channels need no padding: the TPU kernel's 128-lane pad is a layout of
its DMA slices, not part of the function, so the map may keep its 84
channels. The wrapper calls the registered op `kpnerf::dma_gather`: on a
CUDA tensor it launches the hand-written kernel (csrc/dma_gather.cu, one
launch for all views; its threads move a row in pieces of
`feat_sample.piece_bytes`) or raises; on a CPU tensor it runs
`dma_gather_plain`.
"""
from __future__ import annotations

import torch

from ._build import check_device, define_op
from .feat_sample import bilinear_coords, check_lookup, gather_corners, launch_lookup, lookup_out


def _lerp(a, w, b):
    """a + w * (b - a) with K3's rounding in a's dtype (see the module
    docstring)."""
    d = b - a
    if a.dtype == torch.float32:
        return (a.double() + w.double() * d.double()).float()
    return a + w * d


def dma_gather_plain(feats, xy):
    """The plain PyTorch version of the kernel.

    feats: (V, H, W, C) f32 or bf16; xy: (V, N, 2) f32 NDC. Returns
    (V, N, C) in feats.dtype.
    """
    V, H, W, C = feats.shape
    x0, y0, wx, wy = bilinear_coords(xy, H, W)
    wx = wx.to(feats.dtype)[..., None]
    wy = wy.to(feats.dtype)[..., None]
    p00, p01, p10, p11 = gather_corners(feats, x0, y0)
    top = _lerp(p00, wx, p01)
    bot = _lerp(p10, wx, p11)
    return _lerp(top, wy, bot)


def _launch(feats, xy):
    return launch_lookup(multiview_bilinear_sample_dma, "dma_gather", feats, xy)


_OP = define_op("dma_gather(Tensor feats, Tensor xy) -> Tensor", _launch, dma_gather_plain,
                lookup_out)


def multiview_bilinear_sample_dma(feats, xy):
    """K3's bilinear lookup of V maps at per-view NDC points.

    feats: (V, H, W, C) f32 or bf16; xy: (V, N, 2) f32. Returns (V, N, C)
    in feats.dtype. CUDA tensors go to the kernel (counted in
    `multiview_bilinear_sample_dma.launches`), CPU tensors to the plain
    version, both through the registered op.
    """
    check_lookup(feats, xy)
    check_device(feats)
    return _OP(feats, xy)


multiview_bilinear_sample_dma.launches = 0
