"""The relative spatial encoding `rel_z_decay` at inference as one launch:
the (V, N, (1 + 2 L) K) bf16 operand of the geometry MLP's first dense
layer, built in registers and stored once.

Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
JAX model's module-path encoding, which the port composes from ~29
elementwise launches and a concatenation in f32, then casts to bf16.
`models/keypoint_nerf.py` (`_geo_mlp`) calls it (`fused_rel_z_decay`) on
the module path when `sp_type` is `rel_z_decay`, the compute dtype is
bf16, `takes` accepts K and L and autograd does not record; otherwise it
composes `spatial_encode` and the cast, as it always has. K5
(`ops/fused_geo_mlp.py`) builds its own encoding, with each level's sin
and cos taken directly.

The composition (`rel_z_decay_encode`, over `positional_encoding`) lives
here, and `models/spatial_encoding.py` imports it, so that the op's plain
version imports nothing of `models/`.

The wrapper calls the registered op `kpnerf::rel_z_decay`: on CUDA tensors
it launches the hand-written kernel (csrc/rel_z_decay.cu, counted in
`fused_rel_z_decay.launches`), which gives the composition's bf16 bits; on
CPU tensors it runs `rel_z_decay_plain`, the composition itself; under a
trace (`torch.export`) the fake implementation gives the output's shape
and dtype.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ._build import check_device, define_op, entry, launch

# The kernel's limits, mirrored from csrc/rel_z_decay.cu (`kMaxK`, `kMaxL`):
# K a multiple of 8 (each output row a whole number of 16-byte pieces), at
# most 64; at most 5 levels.
MAX_K = 64
MAX_L = 5


def takes(n_kpt: int, sp_level: int) -> bool:
    """Whether the kernel takes K = n_kpt keypoints and L = sp_level levels."""
    return 8 <= n_kpt <= MAX_K and n_kpt % 8 == 0 and 0 <= sp_level <= MAX_L


def positional_encoding(x, n_levels, scale=1.0, weight=None):
    """[x, sin(pi x), cos(pi x), sin(2 pi x), cos(2 pi x), ...].

    Levels > 0 come from the double-angle recursion (sin 2y = 2 sin y cos y,
    cos 2y = 1 - 2 sin^2 y), as in the JAX package. `weight` (..., C), when
    given, multiplies x and every sin/cos block.

    x: (..., C) -> (..., (1 + 2 * n_levels) * C).
    """
    if n_levels <= 0:
        return x if weight is None else x * weight
    w = weight
    wx = x if w is None else x * w
    y = (scale * math.pi) * x
    s, c = torch.sin(y), torch.cos(y)
    blocks = [wx]
    for lvl in range(n_levels):
        if lvl:
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        blocks.append(s if w is None else s * w)
        blocks.append(c if w is None else c * w)
    return torch.cat(blocks, dim=-1)


def rel_z_decay_encode(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    """`spatial_encode`'s `rel_z_decay` branch: per-view depth deltas to
    the K keypoints, positionally encoded at `sp_level` octaves and weighted
    by exp(-||dxyz||^2 / 2 sigma^2). pts_cam (V, N, 3), kpt_cam (V, K, 3)
    -> (V, N, (1 + 2 L) K) in their dtype."""
    dz = sp_scale * (pts_cam[:, :, None, 2] - kpt_cam[:, None, :, 2])  # (V, N, K)
    dxyz = pts_cam[:, :, None, :] - kpt_cam[:, None, :, :]             # (V, N, K, 3)
    w = torch.exp(-(dxyz * dxyz).sum(-1) / (2.0 * sp_sigma**2))
    return positional_encoding(dz, sp_level, weight=w)


def rel_z_decay_plain(pts_cam: torch.Tensor, kpt_cam: torch.Tensor, sp_level: int,
                      sp_sigma: float, sp_scale: float) -> torch.Tensor:
    """The plain PyTorch version: the composition, then the cast to bf16,
    as the module path composes them."""
    return rel_z_decay_encode(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale).to(torch.bfloat16)


def _check(pts_cam, kpt_cam):
    if pts_cam.dim() != 3 or pts_cam.shape[-1] != 3 or kpt_cam.dim() != 3 \
            or kpt_cam.shape[-1] != 3 or kpt_cam.shape[0] != pts_cam.shape[0]:
        raise ValueError(f"expected pts_cam (V, N, 3) and kpt_cam (V, K, 3), got "
                         f"{tuple(pts_cam.shape)} and {tuple(kpt_cam.shape)}")
    if pts_cam.dtype != torch.float32 or kpt_cam.dtype != torch.float32:
        raise TypeError(f"pts_cam and kpt_cam must be float32, got {pts_cam.dtype} and "
                        f"{kpt_cam.dtype}")
    if pts_cam.device != kpt_cam.device:
        raise ValueError(f"pts_cam on {pts_cam.device}, kpt_cam on {kpt_cam.device}")


def _launch(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    V, N, _ = pts_cam.shape
    K = kpt_cam.shape[1]
    if not takes(K, sp_level):
        raise ValueError(f"the rel_z_decay kernel does not take {K} keypoints and "
                         f"{sp_level} levels (see ops.rel_z_decay.takes)")
    out = _new_out(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale)
    if out.numel() == 0:
        return out
    pts_cam, kpt_cam = pts_cam.contiguous(), kpt_cam.contiguous()
    # the f32 values torch's kernels multiply by: the host scalar `scale`
    # rounded to f32, and the f32 reciprocal of 2 sigma^2 (torch divides a
    # tensor by a host scalar as the product with that reciprocal)
    scale = np.float32(sp_scale)
    inv = np.float32(1.0) / np.float32(2.0 * sp_sigma**2)
    fn = entry("rel_z_decay", "kpn_rel_z_decay", *(ctypes.c_void_p,) * 3,
               *(ctypes.c_longlong,) * 2, *(ctypes.c_int,) * 2, *(ctypes.c_float,) * 2)
    launch(fused_rel_z_decay, fn, pts_cam, pts_cam.data_ptr(), kpt_cam.data_ptr(),
           out.data_ptr(), V, N, K, sp_level, float(scale), float(inv))
    return out


def _new_out(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    """The uninitialised output: the kernel's, and the op's under a trace."""
    V, N, _ = pts_cam.shape
    return pts_cam.new_empty((V, N, (1 + 2 * sp_level) * kpt_cam.shape[1]),
                             dtype=torch.bfloat16)


_OP = define_op("rel_z_decay(Tensor pts_cam, Tensor kpt_cam, int sp_level, float sp_sigma, "
                "float sp_scale) -> Tensor", _launch, rel_z_decay_plain, _new_out)


def fused_rel_z_decay(pts_cam: torch.Tensor, kpt_cam: torch.Tensor, sp_level: int,
                      sp_sigma: float, sp_scale: float) -> torch.Tensor:
    """The `rel_z_decay` encoding at inference: pts_cam (V, N, 3) and
    kpt_cam (V, K, 3) f32 in each view's camera frame; the output
    (V, N, (1 + 2 sp_level) K) bf16. CUDA tensors go to the kernel (counted
    in `fused_rel_z_decay.launches`; K and L that `takes` refuses raise),
    CPU tensors to `rel_z_decay_plain`, both through the registered op. Not
    differentiable: the module path calls it only where no gradient is
    needed."""
    _check(pts_cam, kpt_cam)
    check_device(pts_cam)
    return _OP(pts_cam, kpt_cam, int(sp_level), float(sp_sigma), float(sp_scale))


fused_rel_z_decay.launches = 0
