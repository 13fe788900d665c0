"""K6: the fused coarse composite and inverse-CDF importance placement.

Replaces the Pallas kernel `keypointnerf_tpu/ops/pallas/composite_kernel.py`
(`composite_importance_pallas`, math in `_body`), which the JAX model runs
after the coarse query at eval when `use_pallas_composite` and `fine` are
set. Per ray of S coarse samples and F fine depths:

  dist     = [z[1:] - z[:-1], 1e10]
  a        = 1 - exp(-alpha * dist)
  trans    = exp(exclusive cumsum of max(log1p(-a), -80))
  contrib  = a * trans; acc, color, depth and sdf from it (depth and sdf
             divided by acc + 1e-8)
  pdf      = (contrib[1:-1] + 1e-5) normalized; cdf = [0, cumsum(pdf)]
  z_fine_k = inverse CDF at u_k over the bin edges z_mid, where the
             enclosing interval is (max of {cdf_j <= u_k}, min of
             {cdf_j > u_k}), u beyond the last edge takes the top bin, and
             an interval narrower than 1e-5 takes den = 1.

The transmittance floor and the masked max / min are K6's own: the plain
`geometry.compositing.composite` (a cumprod) and
`geometry.sampling.importance_z` (searchsorted) give exp(-80) where it
gives 0 and may pick the other bin where a u lands on an edge, so neither
is used here. The TPU kernel's triangular-matmul cumsums are how the MXU
scans along lanes; only the values matter.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/composite_importance.cu) or raises; on a CPU tensor it runs
`composite_importance_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_BIG = 1e30
_LOG_FLOOR = -80.0
# the kernel holds a ray's samples in one warp's registers, <= 8 a lane
MAX_SAMPLES = 256


def composite_importance_plain(z, alpha, sdf, rgb, u):
    """The plain PyTorch version of the kernel.

    z, alpha, sdf: (R, S) f32, z sorted; rgb: (R, S, 3) f32; u: (R, F) f32
    in [0, 1]. Returns f32 color (R, 3), depth, acc, sdf (R,), contrib
    (R, S) and z_fine (R, F).
    """
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    a = 1.0 - torch.exp(-alpha * dist)
    la = torch.clamp(torch.log1p(-a), min=_LOG_FLOOR)
    csum = torch.cat([torch.zeros_like(la[:, :1]), torch.cumsum(la, dim=-1)[:, :-1]], dim=-1)
    contrib = a * torch.exp(csum)

    acc = contrib.sum(dim=-1)
    color = (rgb * contrib[..., None]).sum(dim=1)
    depth = (z * contrib).sum(dim=-1) / (acc + 1e-8)
    sdf_out = (sdf * contrib).sum(dim=-1) / (acc + 1e-8)

    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])                         # (R, S-1) edges
    cint = contrib[:, 1:-1] + 1e-5
    pdf = cint / cint.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)

    cdf3, zm3, u3 = cdf[:, None, :], z_mid[:, None, :], u[..., None]  # (R, F, S-1)
    cmp = cdf3 <= u3
    big = torch.tensor(_BIG, dtype=z.dtype, device=z.device)
    cdf_prev = torch.where(cmp, cdf3, -big).amax(dim=-1)
    z_prev = torch.where(cmp, zm3, -big).amax(dim=-1)
    cdf_next = torch.where(cmp, big, cdf3).amin(dim=-1)
    z_next = torch.where(cmp, big, zm3).amin(dim=-1)
    over = cdf_next >= 0.5 * _BIG
    cdf_next = torch.where(over, cdf[:, -1:], cdf_next)
    z_next = torch.where(over, z_mid[:, -1:], z_next)
    den = cdf_next - cdf_prev
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    z_fine = z_prev + (u - cdf_prev) / den * (z_next - z_prev)
    return color, depth, acc, sdf_out, contrib, z_fine


def _check(z, alpha, sdf, rgb, u):
    shape = z.shape
    # the accepted case first, in few operations (a render calls this a chunk)
    if (len(shape) == 2 and shape[1] >= 3 and alpha.shape == shape and sdf.shape == shape
            and rgb.shape == (*shape, 3) and u.dim() == 2 and u.shape[0] == shape[0]
            and z.dtype == alpha.dtype == sdf.dtype == rgb.dtype == u.dtype == torch.float32
            and z.device == alpha.device == sdf.device == rgb.device == u.device):
        return
    if z.dim() != 2 or u.dim() != 2 or rgb.shape != z.shape + (3,):
        raise ValueError(
            f"expected z (R, S), rgb (R, S, 3) and u (R, F), got {tuple(z.shape)}, "
            f"{tuple(rgb.shape)} and {tuple(u.shape)}")
    if alpha.shape != z.shape or sdf.shape != z.shape or u.shape[0] != z.shape[0]:
        raise ValueError(
            f"alpha {tuple(alpha.shape)} and sdf {tuple(sdf.shape)} must match z "
            f"{tuple(z.shape)}, u {tuple(u.shape)} its rays")
    if z.shape[1] < 3:
        raise ValueError(f"need at least 3 samples a ray (one interior bin), got {z.shape[1]}")
    for name, t in (("z", z), ("alpha", alpha), ("sdf", sdf), ("rgb", rgb), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != z.device:
            raise ValueError(f"{name} on {t.device} but z on {z.device}")


@functools.cache
def _kernel():
    from ._build import load

    fn = load("composite_importance").kpn_composite_importance
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(z, alpha, sdf, rgb, u):
    R, S = z.shape
    F = u.shape[1]
    if S > MAX_SAMPLES:
        raise ValueError(f"the kernel takes at most {MAX_SAMPLES} samples a ray, got {S}")
    if not all(t.is_contiguous() for t in (z, alpha, sdf, rgb, u)):
        raise ValueError("the kernel takes contiguous inputs")
    # A chunk's call is short, so its host work counts: the six outputs are
    # views of one allocation, made by as_strided and passed as offsets of
    # its base; the stream is the raw handle, and the device is switched
    # only when it must be.
    buf = torch.empty(R * (S + F + 6), dtype=torch.float32, device=z.device)
    at = R * (S + F)                              # color, then depth, acc, sdf
    view = buf.as_strided
    outs = (view((R, 3), (3, 1), at), view((R,), (1,), at + 3 * R),
            view((R,), (1,), at + 4 * R), view((R,), (1,), at + 5 * R),
            view((R, S), (S, 1), 0), view((R, F), (F, 1), R * S))
    base = buf.data_ptr()
    args = (z.data_ptr(), alpha.data_ptr(), sdf.data_ptr(), rgb.data_ptr(), u.data_ptr(),
            base + 4 * at, base + 4 * (at + 3 * R), base + 4 * (at + 4 * R),
            base + 4 * (at + 5 * R), base, base + 4 * R * S, R, S, F)
    index = z.get_device()
    if index == torch.cuda.current_device():
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"composite_importance kernel launch failed: CUDA error {err}")
    fused_composite_importance.launches += 1
    return outs


def fused_composite_importance(z, alpha, sdf, rgb, u):
    """K6: the coarse composite and the fine depths of R rays.

    z, alpha, sdf: (R, S) f32; rgb: (R, S, 3) f32; u: (R, F) f32. Returns
    (color (R, 3), depth (R,), acc (R,), sdf (R,), contrib (R, S), z_fine
    (R, F)), all f32. CUDA tensors go to the kernel (counted in
    `fused_composite_importance.launches`), CPU tensors to the plain
    version.
    """
    _check(z, alpha, sdf, rgb, u)
    if z.is_cuda:
        return _launch(z, alpha, sdf, rgb, u)
    if z.device.type != "cpu":
        raise ValueError(f"no kernel for device {z.device}")
    return composite_importance_plain(z, alpha, sdf, rgb, u)


fused_composite_importance.launches = 0
