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

import ctypes
import functools

import torch

from .feat_sample import bilinear_coords, check_lookup, gather_corners, launch_lookup

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _kernel():
    from ._build import load

    fn = load("onehot_bilinear").kpn_onehot_bilinear
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(feats, xy):
    out, err = launch_lookup(_kernel(), feats, xy, _DTYPE_CODE[feats.dtype])
    if err != 0:
        raise RuntimeError(f"onehot_bilinear kernel launch failed: CUDA error {err}")
    multiview_onehot_bilinear_sample.launches += 1
    return out


@torch.library.custom_op("kpnerf::onehot_bilinear", mutates_args=(), device_types="cuda")
def onehot_bilinear_op(feats: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """K2 as a registered op (`torch.ops.kpnerf.onehot_bilinear`): the
    kernel on CUDA, `onehot_bilinear_plain` on the CPU, shapes alone under
    a trace, so an exported program carries it."""
    return _launch(feats, xy)


onehot_bilinear_op.register_kernel("cpu")(onehot_bilinear_plain)


@onehot_bilinear_op.register_fake
def _(feats, xy):
    return feats.new_empty((feats.shape[0], xy.shape[1], feats.shape[3]))


_OP = torch.ops.kpnerf.onehot_bilinear.default


def multiview_onehot_bilinear_sample(feats, xy):
    """Exact bilinear lookup of V maps at per-view NDC points.

    feats: (V, H, W, C) f32 or bf16; xy: (V, N, 2) f32. Returns (V, N, C)
    in feats.dtype. CUDA tensors go to the kernel (counted in
    `multiview_onehot_bilinear_sample.launches`), CPU tensors to the plain
    version, both through the registered op.
    """
    check_lookup(feats, xy, _DTYPE_CODE)
    if feats.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {feats.device}")
    return _OP(feats, xy)


multiview_onehot_bilinear_sample.launches = 0
