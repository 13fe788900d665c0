"""K4 and K5: the fused geometry MLP, one launch per query.

Replaces the Pallas kernels of `keypointnerf_tpu/ops/pallas/fused_geo_mlp.py`:
`geo_mlp_apply` (K4: MLPUNet -> masked mean/var pool -> fusion MLP on a
given spatial encoding) and `sp_geo_mlp_apply` (K5: the same with the
rel_z_decay encoding built inside the kernel from camera-frame points and
keypoints, so the (V, N, 168) encoding never reaches device memory). The
model takes them with `use_pallas_geo_mlp` (K5 when `sp_type` is
rel_z_decay, K4 otherwise).

`mlp_stack_plain` and `sp_mlp_stack_plain` are the plain PyTorch versions,
following the JAX `_mlp_stack` / `_sp_mlp_stack` line by line: concat then
one product per layer, `sin` / `cos` of each level taken directly (not by
`spatial_encode`'s double-angle recursion), f32 pooling. `dot` rounds both
operands to `compute_dtype` and keeps the sum in f32 (`models.mlp.dot_f32`,
whose autograd form rounds each operand gradient once, as JAX's does).

On CUDA tensors the wrappers launch the hand-written kernel
(csrc/fused_geo_mlp.cu; counted in `.launches`) or raise; on CPU tensors
they run the plain version. With bf16 products the kernel keeps every
layer's weights in shared memory and is built for the zju layer widths:
`_check_kernel` raises, before any launch, on other widths, on more than
four views, on more than 256 layer-0 inputs or 16 f1 channels, on K5
keypoints or levels other than the zju recipe's 24 and 3, and on weights
that do not fit. Either way the call is a `torch.autograd.Function` that
saves only its inputs: its backward re-runs the plain stack under autograd
and differentiates that. This recompute is
the ported semantics of the JAX kernels' `custom_vjp` (whose backward is
the XLA recompute of the same stack), not a fallback; the forward of a
training step on the card always goes through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from ..models.mlp import dot_f32, softplus100

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fold_weight_norm(mlp_geo) -> Tuple[torch.Tensor, ...]:
    """The GeoFusionMLP's effective dense weights, weight norm folded in:
    (W0, b0, W1, b1, W2, b2, W3, b3, F0, fb0, F1, fb1, F2, fb2), each W
    (in, out) and contiguous, differentiable back to `weight_v`, `weight_g`
    and `bias` of every layer."""
    ws = []
    for stack in (mlp_geo.layers1, mlp_geo.layers2):
        for slot in stack.layers:
            ws += [slot.linear.weight.T.contiguous(), slot.linear.bias]
    return tuple(ws)


def mlp_stack_plain(sp, f0, f1, mask, weight, ws, compute_dtype=torch.float32):
    """The plain PyTorch version of K4.

    sp (V, N, Dsp), f0 (V, N, C0), f1 (V, N, C1), mask / weight (V, N, 1),
    all f32; `ws` the 14 folded weights. Returns f32 out (N, Do), valid
    (N, 1), latent_view (V, N, Dl), latent_fused (N, 2 Dl).
    """
    W0, b0, W1, b1, W2, b2, W3, b3, F0, fb0, F1, fb1, F2, fb2 = ws

    def dot(a, w):
        return dot_f32(a, w.T, compute_dtype)

    x = torch.cat([sp, f0], dim=-1)
    x = softplus100(dot(x, W0) + b0)
    x = softplus100(dot(x, W1) + b1)
    x = torch.cat([x, f1], dim=-1)
    x = softplus100(dot(x, W2) + b2)
    lv = dot(x, W3) + b3                                  # (V, N, Dl)

    a_sum = mask.sum(dim=0)                               # (N, 1)
    mean = (weight * lv).sum(dim=0)
    var = (weight * (lv - mean[None]) ** 2).sum(dim=0)
    lf = torch.cat([mean, var], dim=-1)                   # (N, 2 Dl)

    y = softplus100(dot(lf, F0) + fb0)
    y = softplus100(dot(y, F1) + fb1)
    out = dot(y, F2) + fb2
    valid = (a_sum > 0.0).to(out.dtype)
    return out, valid, lv, lf


def rel_z_decay_encoding(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale):
    """The encoding as the K5 kernel builds it, (V, N, (1 + 2 L) K): blocks
    [dz w, sin(dz pi) w, cos(dz pi) w, sin(dz 2 pi) w, ...], each K wide."""
    pz = pts_cam[..., 2:3]                                # (V, N, 1)
    kz = kpt_cam[..., 2][:, None, :]                      # (V, 1, K)
    dz = sp_scale * (pz - kz)                             # (V, N, K)
    d2 = torch.zeros_like(dz)
    for ax in range(3):
        da = pts_cam[..., ax : ax + 1] - kpt_cam[..., ax][:, None, :]
        d2 = d2 + da * da
    w_decay = torch.exp(-d2 / (2.0 * sp_sigma**2))
    parts = [dz * w_decay]
    for lvl in range(sp_level):
        yl = dz * float(math.pi * (2.0**lvl))
        parts.append(torch.sin(yl) * w_decay)
        parts.append(torch.cos(yl) * w_decay)
    return torch.cat(parts, dim=-1)


def sp_mlp_stack_plain(pts_cam, kpt_cam, f0, f1, mask, weight, ws, sp_level=3,
                       sp_sigma=0.1, sp_scale=1.0, compute_dtype=torch.float32):
    """The plain PyTorch version of K5: pts_cam (V, N, 3) and kpt_cam
    (V, K, 3) in place of `sp`; the rest as `mlp_stack_plain`."""
    sp = rel_z_decay_encoding(pts_cam, kpt_cam, sp_level, sp_sigma, sp_scale)
    return mlp_stack_plain(sp, f0, f1, mask, weight, ws, compute_dtype)


# ------------------------------------------------------------------ checks
def _check(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args):
    """Raise on what the kernel does not take; returns the widths
    (c0, c1, h1, h2, h3, dl, g1, g2, dout)."""
    if compute_dtype not in _DTYPE_CODE:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if len(ws) != 14:
        raise ValueError(f"expected 14 folded weights, got {len(ws)}")
    first = lead[0]
    if first.dim() != 3:
        raise ValueError(f"expected a (V, N, C) leading input, got {tuple(first.shape)}")
    V, N = first.shape[:2]
    if sp_args is None:
        dsp = first.shape[-1]
    else:
        pts_cam, kpt_cam = lead
        if pts_cam.shape != (V, N, 3) or kpt_cam.dim() != 3 or kpt_cam.shape[0] != V \
                or kpt_cam.shape[2] != 3:
            raise ValueError(f"expected pts_cam (V, N, 3) and kpt_cam (V, K, 3), got "
                             f"{tuple(pts_cam.shape)} and {tuple(kpt_cam.shape)}")
        dsp = (1 + 2 * sp_args[0]) * kpt_cam.shape[1]
    for name, t in (("f0", f0), ("f1", f1)):
        if t.dim() != 3 or t.shape[:2] != (V, N):
            raise ValueError(f"{name} must be (V, N, C) = ({V}, {N}, C), got {tuple(t.shape)}")
    for name, t in (("mask", mask), ("weight", weight)):
        if t.shape != (V, N, 1):
            raise ValueError(f"{name} must be ({V}, {N}, 1), got {tuple(t.shape)}")
    c0, c1 = f0.shape[-1], f1.shape[-1]
    outs = [w.shape[-1] for w in ws[0::2]]
    h1, h2, h3, dl, g1, g2, dout = outs
    ins = (dsp + c0, h1, h2 + c1, h3, 2 * dl, g1, g2)
    for i, (w, b, n_in, n_out) in enumerate(zip(ws[0::2], ws[1::2], ins, outs)):
        if w.shape != (n_in, n_out) or b.shape != (n_out,):
            raise ValueError(f"layer {i}: expected weight ({n_in}, {n_out}) and bias "
                             f"({n_out},), got {tuple(w.shape)} and {tuple(b.shape)}")
    for t in (*lead, f0, f1, mask, weight, *ws):
        if t.dtype != torch.float32:
            raise TypeError(f"the fused geometry MLP takes float32 tensors, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"tensors on {first.device} and {t.device}")
    return c0, c1, h1, h2, h3, dl, g1, g2, dout


# The bf16 kernel: the layer out widths it is compiled for (the zju
# architecture), the most views its pool unrolls, the layer-0 inputs whose A
# fragments it holds at once, K5's keypoints and levels (its encoding is
# unrolled) and the shared memory one block may use (csrc/fused_geo_mlp.cu
# `kN`, `kMaxViews`, `kMaxKb0`, `kK5Keypoints`, `kK5Levels`). These copies
# let `_check_kernel` refuse with a reason before any build or launch (and
# on any device); the kernel checks the same limits again, and that its
# packed layout fits the scratch sized here, and refuses a launch that
# breaks them (invalid-value).
KERNEL_WIDTHS = (128, 128, 120, 64, 64, 64)
KERNEL_MAX_VIEWS = 4
KERNEL_MAX_DOUT = 8
KERNEL_MAX_LAYER0_INPUTS = 256
KERNEL_SP_ARGS = (24, 3)          # K5: keypoints, levels
SMEM_BYTES = 232_448


def _pad(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def packed_shapes(widths, dsp):
    """The bf16 kernel's packed layers, (rows, cols) each: K padded to 16,
    N to 8."""
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    ins = (dsp + c0, h1, h2 + c1, h3, 2 * dl, g1, g2)
    outs = (h1, h2, h3, dl, g1, g2, dout)
    return [(_pad(i, 16), _pad(o, 8)) for i, o in zip(ins, outs)]


def smem_bytes(shapes, V, K, sp_args) -> int:
    """Shared memory of one block of the bf16 kernel: the packed bf16
    weights, the f32 biases, every view's keypoints (K5), the mbarrier."""
    weights = 2 * sum(k * n for k, n in shapes)
    extra = 4 * (sum(n for _, n in shapes) + (V * K * 3 if sp_args is not None else 0))
    return _pad(weights + extra, 8) + 8


def _check_kernel(V, K, dsp, widths, compute_dtype, sp_args):
    """Raise on what the CUDA kernel does not take, before any launch;
    returns the bf16 kernel's packed layer shapes (None for f32 products)."""
    if compute_dtype != torch.bfloat16:
        return None
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    if (h1, h2, h3, dl, g1, g2) != KERNEL_WIDTHS or not 1 <= dout <= KERNEL_MAX_DOUT:
        raise ValueError(f"the bf16 kernel is built for layer widths {KERNEL_WIDTHS} and "
                         f"1..{KERNEL_MAX_DOUT} outputs, got {(h1, h2, h3, dl, g1, g2)} and {dout}")
    if V > KERNEL_MAX_VIEWS:
        raise ValueError(f"the bf16 kernel takes at most {KERNEL_MAX_VIEWS} views, got {V}")
    shapes = packed_shapes(widths, dsp)
    need = smem_bytes(shapes, V, K, sp_args)
    if need > SMEM_BYTES:
        raise ValueError(f"the bf16 kernel's weights do not fit in shared memory: {need} "
                         f"bytes of {SMEM_BYTES}")
    if c1 > 16:
        raise ValueError(f"the bf16 kernel takes at most 16 f1 channels, got {c1}")
    if shapes[0][0] > KERNEL_MAX_LAYER0_INPUTS:
        raise ValueError(f"the bf16 kernel takes at most {KERNEL_MAX_LAYER0_INPUTS} layer-0 "
                         f"inputs, got {dsp + c0}")
    if sp_args is not None and (K, sp_args[0]) != KERNEL_SP_ARGS:
        raise ValueError(f"the bf16 K5 kernel is built for (keypoints, levels) = "
                         f"{KERNEL_SP_ARGS}, got {(K, sp_args[0])}")
    return shapes


def _launch(wrapper, lead, f0, f1, mask, weight, ws, compute_dtype, sp_args, widths):
    """One launch of the CUDA kernel (K5 when `sp_args`, else K4)."""
    V, N = lead[0].shape[:2]
    K = lead[1].shape[1] if sp_args is not None else 0
    dsp = (1 + 2 * sp_args[0]) * K if sp_args is not None else lead[0].shape[-1]
    shapes = _check_kernel(V, K, dsp, widths, compute_dtype, sp_args)
    tensors = (*lead, f0, f1, mask, weight, *ws)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    from ._build import load

    lib = load("fused_geo_mlp")
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    dev = f0.device
    out = torch.empty((N, dout), dtype=torch.float32, device=dev)
    valid = torch.empty((N, 1), dtype=torch.float32, device=dev)
    lv = torch.empty((V, N, dl), dtype=torch.float32, device=dev)
    lf = torch.empty((N, 2 * dl), dtype=torch.float32, device=dev)
    packed, n_packed = None, 0
    if shapes is not None:
        # scratch for the kernel's own bf16 rounding and packing of the
        # weights (the kernel checks that its layout fits it)
        n_packed = sum(k * n for k, n in shapes)
        packed = torch.empty(n_packed, dtype=torch.bfloat16, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [packed.data_ptr() if packed is not None else None]
    ptrs += [t.data_ptr() for t in (out, valid, lv, lf)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    code = _DTYPE_CODE[compute_dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sp_args is None:
            fn = lib.kpn_geo_mlp
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            dims = (V, N, lead[0].shape[-1], *widths, n_packed)
            err = fn(c_ptrs, (ctypes.c_int * len(dims))(*dims), code, stream)
        else:
            fn = lib.kpn_sp_geo_mlp
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                           ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            level, sigma, scale = sp_args
            dims = (V, N, lead[1].shape[1], level, *widths, n_packed)
            err = fn(c_ptrs, (ctypes.c_int * len(dims))(*dims), float(sigma), float(scale),
                     code, stream)
    if err != 0:
        raise RuntimeError(f"fused_geo_mlp kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out, valid, lv, lf


def _plain(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args):
    if sp_args is None:
        return mlp_stack_plain(*lead, f0, f1, mask, weight, ws, compute_dtype)
    return sp_mlp_stack_plain(*lead, f0, f1, mask, weight, ws, *sp_args, compute_dtype)


class _FusedGeoMLP(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain stack (CPU). Backward: the
    plain stack re-run from the saved inputs and differentiated, which is
    what the JAX kernels' custom VJP does."""

    @staticmethod
    def forward(ctx, wrapper, compute_dtype, sp_args, n_lead, *tensors):
        lead, (f0, f1, mask, weight), ws = tensors[:n_lead], tensors[n_lead:n_lead + 4], \
            tensors[n_lead + 4:]
        widths = _check(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args)
        if f0.is_cuda:
            outs = _launch(wrapper, lead, f0, f1, mask, weight, ws, compute_dtype, sp_args,
                           widths)
        elif f0.device.type == "cpu":
            outs = _plain(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args)
        else:
            raise ValueError(f"no kernel for device {f0.device}")
        ctx.save_for_backward(*tensors)
        ctx.config = (compute_dtype, sp_args, n_lead)
        ctx.mark_non_differentiable(outs[1])              # valid: a comparison
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, _g_valid, g_lv, g_lf):
        compute_dtype, sp_args, n_lead = ctx.config
        needs = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out, _, lv, lf = _plain(ins[:n_lead], *ins[n_lead:n_lead + 4], ins[n_lead + 4:],
                                    compute_dtype, sp_args)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad((out, lv, lf), wanted, (g_out, g_lv, g_lf),
                                             allow_unused=True))
        return (None, None, None, None,
                *(next(grads) if need else None for need in needs))


def _folded(params) -> Sequence[torch.Tensor]:
    return tuple(params) if isinstance(params, (tuple, list)) else fold_weight_norm(params)


def geo_mlp_apply(params, sp, f0, f1, mask, weight, compute_dtype=torch.float32):
    """K4, differentiable. `params` is a `GeoFusionMLP` or its 14 folded
    weights; sp (V, N, Dsp), f0 (V, N, C0), f1 (V, N, C1), mask / weight
    (V, N, 1), all f32. Returns out (N, Do), valid (N, 1), latent_view
    (V, N, Dl), latent_fused (N, 2 Dl), f32. CUDA tensors go to the kernel
    (counted in `geo_mlp_apply.launches`), CPU tensors to the plain version;
    N is any size."""
    return _FusedGeoMLP.apply(geo_mlp_apply, compute_dtype, None, 1,
                              sp, f0, f1, mask, weight, *_folded(params))


def sp_geo_mlp_apply(params, pts_cam, kpt_cam, f0, f1, mask, weight, sp_level=3,
                     sp_sigma=0.1, sp_scale=1.0, compute_dtype=torch.float32):
    """K5, differentiable: K4 with the rel_z_decay encoding built in the
    kernel from pts_cam (V, N, 3) and kpt_cam (V, K, 3). Launches are
    counted in `sp_geo_mlp_apply.launches`."""
    return _FusedGeoMLP.apply(sp_geo_mlp_apply, compute_dtype,
                              (int(sp_level), float(sp_sigma), float(sp_scale)), 2,
                              pts_cam, kpt_cam, f0, f1, mask, weight, *_folded(params))


geo_mlp_apply.launches = 0
sp_geo_mlp_apply.launches = 0
