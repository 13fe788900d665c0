"""The relative spatial encoding `rel_z_decay` at inference as one launch:
the (V, N, (1 + 2 L) K) bf16 operand of the geometry MLP's first dense
layer, built in registers and stored once.

Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
JAX model's module-path encoding, which the port composes from ~29
elementwise launches and a concatenation in f32, then casts to bf16.
`models/keypoint_nerf.py` (`query_head`) calls it (`fused_rel_z_decay`) on
the module path when `sp_type` is `rel_z_decay`, no gradient is needed,
the compute dtype is bf16, the tensors lie on a device of `DEVICES` and
`takes` accepts K and L; otherwise it composes `spatial_encode` and the
cast, as it always has. K5 (`ops/fused_geo_mlp.py`) builds its own
encoding, with each level's sin and cos taken directly.

The wrapper calls the registered op `kpnerf::rel_z_decay`: on CUDA tensors
it launches the hand-written kernel (csrc/rel_z_decay.cu, counted in
`fused_rel_z_decay.launches`), which gives the composition's bf16 bits; on
CPU tensors it runs `rel_z_decay_plain`, the composition itself; under a
trace (`torch.export`) the fake implementation gives the output's shape
and dtype.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# The devices whose tensors `query_head` hands to the op rather than
# composing (the kernel's; the CPU keeps the composition it always ran).
DEVICES = ("cuda",)
# The kernel's limits, mirrored from csrc/rel_z_decay.cu (`kMaxK`, `kMaxL`):
# K a multiple of 8 (each output row a whole number of 16-byte pieces), at
# most 64; at most 5 levels.
MAX_K = 64
MAX_L = 5


def takes(n_kpt: int, sp_level: int) -> bool:
    """Whether the kernel takes K = n_kpt keypoints and L = sp_level levels."""
    return 8 <= n_kpt <= MAX_K and n_kpt % 8 == 0 and 0 <= sp_level <= MAX_L


def rel_z_decay_plain(pts_cam: torch.Tensor, kpt_cam: torch.Tensor, sp_level: int,
                      sp_sigma: float, sp_scale: float) -> torch.Tensor:
    """The plain PyTorch version: `spatial_encode`'s `rel_z_decay` branch,
    then the cast to bf16, as the module path composes them."""
    # imported here: the models import the ops
    from ..models.spatial_encoding import SpatialEncodingConfig, spatial_encode

    cfg = SpatialEncodingConfig(sp_level=sp_level, sp_type="rel_z_decay", scale=sp_scale,
                                sigma=sp_sigma, n_kpt=kpt_cam.shape[1])
    return spatial_encode(cfg, None, pts_cam, None, kpt_cam).to(torch.bfloat16)


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


@functools.cache
def _kernel():
    from ._build import load

    fn = load("rel_z_decay").kpn_rel_z_decay
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    V, N, _ = pts_cam.shape
    K = kpt_cam.shape[1]
    if not takes(K, sp_level):
        raise ValueError(f"the rel_z_decay kernel does not take {K} keypoints and "
                         f"{sp_level} levels (see ops.rel_z_decay.takes)")
    out = torch.empty((V, N, (1 + 2 * sp_level) * K), dtype=torch.bfloat16,
                      device=pts_cam.device)
    if out.numel() == 0:
        return out
    pts_cam, kpt_cam = pts_cam.contiguous(), kpt_cam.contiguous()
    # the f32 values torch's kernels multiply by: the host scalar `scale`
    # rounded to f32, and the f32 reciprocal of 2 sigma^2 (torch divides a
    # tensor by a host scalar as the product with that reciprocal)
    scale = np.float32(sp_scale)
    inv = np.float32(1.0) / np.float32(2.0 * sp_sigma**2)
    with torch.cuda.device(pts_cam.device):
        stream = torch.cuda.current_stream(pts_cam.device).cuda_stream
        err = _kernel()(pts_cam.data_ptr(), kpt_cam.data_ptr(), out.data_ptr(), V, N, K,
                        sp_level, float(scale), float(inv), stream)
    if err != 0:
        raise RuntimeError(f"rel_z_decay kernel launch failed: CUDA error {err}")
    fused_rel_z_decay.launches += 1
    return out


# Registered as `kpnerf::dense_act` is (ops/dense_act.py), through
# `torch.library.Library` rather than `custom_op`, whose first call imports
# torch._dynamo; no autograd kernel: the module path calls it only where no
# gradient is needed.
_LIB = torch.library.Library("kpnerf", "FRAGMENT")
_LIB.define("rel_z_decay(Tensor pts_cam, Tensor kpt_cam, int sp_level, float sp_sigma, "
            "float sp_scale) -> Tensor")
_LIB.impl("rel_z_decay", _launch, "CUDA")
_LIB.impl("rel_z_decay", rel_z_decay_plain, "CPU")


@torch.library.register_fake("kpnerf::rel_z_decay", lib=_LIB)
def _(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    V, N, _ = pts_cam.shape
    return pts_cam.new_empty((V, N, (1 + 2 * sp_level) * kpt_cam.shape[1]),
                             dtype=torch.bfloat16)


_OP = torch.ops.kpnerf.rel_z_decay.default


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
    if pts_cam.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {pts_cam.device}")
    return _OP(pts_cam, kpt_cam, int(sp_level), float(sp_sigma), float(sp_scale))


fused_rel_z_decay.launches = 0
