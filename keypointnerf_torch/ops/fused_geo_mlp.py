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
operands to `compute_dtype` and keeps the sum in f32 (`ops.dense.dot_f32`,
whose autograd form rounds each operand gradient once, as JAX's does).

The wrappers call the registered ops `kpnerf::geo_mlp` / `sp_geo_mlp`: on
CUDA tensors they launch a hand-written kernel (csrc/fused_geo_mlp.cu;
counted in `.launches` and, by route, in `.launches_by_route`) or raise;
on CPU tensors they run the plain version.
`kernel_route` picks the kernel from the shapes before any launch: with
bf16 products the wgmma kernel (every layer's weights resident in shared
memory, built for the zju widths) where it takes them, else the wmma
kernel (any widths, weights read from L2); f32 products take the f32
kernel. It raises only where no kernel takes the shapes (a tile over one
block's shared memory, more than 12 encoding levels). Where autograd
records, the call is a `torch.autograd.Function` that saves only its
inputs (elsewhere the op is called directly): its backward
re-runs the plain stack under autograd and differentiates that. This
recompute is the ported semantics of the JAX kernels' `custom_vjp` (whose
backward is the XLA recompute of the same stack), not a fallback; the
forward of a training step on the card always goes through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from ._build import DTYPE_CODE, check_device, define_op, entry, launch
from .dense import autograd_records, dot_f32, softplus100


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
    if compute_dtype not in DTYPE_CODE:
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
    c0, c1, h1, h2, h3, dl, g1, g2, dout = _widths(f0, f1, ws)
    outs = (h1, h2, h3, dl, g1, g2, dout)
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
    return _widths(f0, f1, ws)


def _widths(f0, f1, ws):
    """(c0, c1, h1, h2, h3, dl, g1, g2, dout) of checked inputs."""
    return (f0.shape[-1], f1.shape[-1], *(w.shape[-1] for w in ws[0::2]))


# The kernels' limits, mirrored from csrc/fused_geo_mlp.cu so that
# `kernel_route` can choose and refuse before any build or launch (and on any
# device); the kernels check the same limits again and refuse a launch that
# breaks them (invalid-value). The wgmma kernel: the layer out widths it is
# compiled for (the zju architecture), the most views its pool unrolls, the
# layer-0 inputs whose A fragments it holds at once, K5's keypoints and
# levels (`kN`, `kMaxViews`, `kMaxKb0`, `kK5Keypoints`, `kK5Levels`). The
# wmma and f32 kernels: a 32-point tile (`kTileN`) of 256 threads, the levels
# their frequency table holds (`kMaxLevels`). All: the shared memory one
# block may use (`kMaxSmem`).
KERNEL_WIDTHS = (128, 128, 120, 64, 64, 64)
KERNEL_MAX_VIEWS = 4
KERNEL_MAX_DOUT = 8
KERNEL_MAX_LAYER0_INPUTS = 256
KERNEL_SP_ARGS = (24, 3)          # K5: keypoints, levels
KERNEL_MAX_LEVELS = 12
TILE_N = 32
N_WARPS = 8
SMEM_BYTES = 232_448
ROUTES = ("wgmma", "wmma", "f32")
_ROUTE_CODE = {"f32": 0, "wgmma": 1, "wmma": 2}


def _pad(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _layers(widths, dsp):
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    return (dsp + c0, h1, h2 + c1, h3, 2 * dl, g1, g2), (h1, h2, h3, dl, g1, g2, dout)


def packed_shapes(widths, dsp, route="wgmma"):
    """A bf16 route's packed layers, (rows, cols) each: K padded to 16, N
    to 8 (wgmma) or 16 (wmma)."""
    n_pad = 8 if route == "wgmma" else 16
    return [(_pad(i, 16), _pad(o, n_pad)) for i, o in zip(*_layers(widths, dsp))]


def smem_bytes(shapes, V, K, sp_args) -> int:
    """Shared memory of one block of the wgmma kernel: the packed bf16
    weights, the f32 biases, every view's keypoints (K5), the mbarrier."""
    weights = 2 * sum(k * n for k, n in shapes)
    extra = 4 * (sum(n for _, n in shapes) + (V * K * 3 if sp_args is not None else 0))
    return _pad(weights + extra, 8) + 8


def tile_smem_bytes(V, K, dsp, widths, sp_args, esize) -> int:
    """Shared memory of one block of the wmma (esize 2) or f32 (esize 4)
    kernel: two activation buffers of a 32-point tile, every view's
    latents, the wmma kernel's staging tiles, the keypoints (K5)."""
    stride = max(_pad(i, 16) for i in _layers(widths, dsp)[0]) + 8
    n = _pad(2 * TILE_N * stride * esize, 128) + 4 * V * TILE_N * widths[5]
    n += 4 * N_WARPS * 256 if esize == 2 else 0
    return n + (4 * K * 3 if sp_args is not None else 0)


def _wgmma_misfit(V, K, dsp, widths, sp_args):
    """Why the wgmma kernel does not take these shapes (None if it does)."""
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    if (h1, h2, h3, dl, g1, g2) != KERNEL_WIDTHS or not 1 <= dout <= KERNEL_MAX_DOUT:
        return (f"it is built for layer widths {KERNEL_WIDTHS} and 1..{KERNEL_MAX_DOUT} "
                f"outputs, not {(h1, h2, h3, dl, g1, g2)} and {dout}")
    if V > KERNEL_MAX_VIEWS:
        return f"it takes at most {KERNEL_MAX_VIEWS} views, not {V}"
    if not 1 <= c1 <= 16:
        return f"it takes 1..16 f1 channels, not {c1}"
    if _pad(dsp + c0, 16) > KERNEL_MAX_LAYER0_INPUTS:
        return f"it takes at most {KERNEL_MAX_LAYER0_INPUTS} layer-0 inputs, not {dsp + c0}"
    if sp_args is not None and (K, sp_args[0]) != KERNEL_SP_ARGS:
        return f"its K5 is built for (keypoints, levels) = {KERNEL_SP_ARGS}, not {(K, sp_args[0])}"
    need = smem_bytes(packed_shapes(widths, dsp), V, K, sp_args)
    if need > SMEM_BYTES:
        return f"its weights need {need} bytes of shared memory, over {SMEM_BYTES}"
    return None


def kernel_route(V, K, dsp, widths, compute_dtype, sp_args) -> str:
    """The CUDA kernel a call with these shapes takes, chosen before any
    build or launch: "f32" for f32 products; for bf16, "wgmma" (weights
    resident in shared memory, built for the zju widths) where it takes the
    shapes, else "wmma" (any widths). Raises ValueError, with the reason,
    on what no kernel takes: a tile over the shared memory of one block, or
    more spatial-encoding levels than the kernels' frequency table."""
    if sp_args is not None and not 0 <= sp_args[0] <= KERNEL_MAX_LEVELS:
        raise ValueError(f"the kernels take 0..{KERNEL_MAX_LEVELS} encoding levels, "
                         f"got {sp_args[0]}")
    if compute_dtype == torch.bfloat16 and _wgmma_misfit(V, K, dsp, widths, sp_args) is None:
        return "wgmma"
    route = "f32" if compute_dtype == torch.float32 else "wmma"
    need = tile_smem_bytes(V, K, dsp, widths, sp_args, 4 if route == "f32" else 2)
    if need > SMEM_BYTES:
        why = "" if route == "f32" else f" (the wgmma kernel refuses them: " \
            f"{_wgmma_misfit(V, K, dsp, widths, sp_args)})"
        raise ValueError(f"the {route} kernel's tile does not fit in shared memory: {need} "
                         f"bytes of {SMEM_BYTES}{why}")
    return route


def _launch(wrapper, lead, f0, f1, mask, weight, ws, compute_dtype, sp_args, widths):
    """One launch of the CUDA kernel (K5 when `sp_args`, else K4) on the
    route `kernel_route` picks."""
    V, N = lead[0].shape[:2]
    K = lead[1].shape[1] if sp_args is not None else 0
    dsp = (1 + 2 * sp_args[0]) * K if sp_args is not None else lead[0].shape[-1]
    route = kernel_route(V, K, dsp, widths, compute_dtype, sp_args)
    tensors = (*lead, f0, f1, mask, weight, *ws)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    c0, c1, h1, h2, h3, dl, g1, g2, dout = widths
    dev = f0.device
    out = torch.empty((N, dout), dtype=torch.float32, device=dev)
    valid = torch.empty((N, 1), dtype=torch.float32, device=dev)
    lv = torch.empty((V, N, dl), dtype=torch.float32, device=dev)
    lf = torch.empty((N, 2 * dl), dtype=torch.float32, device=dev)
    packed, n_packed = None, 0
    if route != "f32":
        # scratch for the kernel's own bf16 rounding and packing of the
        # weights (the kernel checks that its layout fits it)
        n_packed = sum(k * n for k, n in packed_shapes(widths, dsp, route))
        packed = torch.empty(n_packed, dtype=torch.bfloat16, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [packed.data_ptr() if packed is not None else None]
    ptrs += [t.data_ptr() for t in (out, valid, lv, lf)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    code = _ROUTE_CODE[route]
    arrays = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int))
    if sp_args is None:
        fn = entry("fused_geo_mlp", "kpn_geo_mlp", *arrays, ctypes.c_int)
        dims = (V, N, lead[0].shape[-1], *widths, n_packed)
        launch(wrapper, fn, f0, c_ptrs, (ctypes.c_int * len(dims))(*dims), code)
    else:
        fn = entry("fused_geo_mlp", "kpn_sp_geo_mlp", *arrays, ctypes.c_double,
                   ctypes.c_double, ctypes.c_int)
        level, sigma, scale = sp_args
        dims = (V, N, K, level, *widths, n_packed)
        launch(wrapper, fn, f0, c_ptrs, (ctypes.c_int * len(dims))(*dims), float(sigma),
               float(scale), code)
    wrapper.launches_by_route[route] += 1
    return out, valid, lv, lf


def _plain(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args):
    if sp_args is None:
        return mlp_stack_plain(*lead, f0, f1, mask, weight, ws, compute_dtype)
    return sp_mlp_stack_plain(*lead, f0, f1, mask, weight, ws, *sp_args, compute_dtype)


def _launch_k4(sp, f0, f1, mask, weight, ws, compute_dtype):
    return _launch(geo_mlp_apply, (sp,), f0, f1, mask, weight, ws, compute_dtype, None,
                   _widths(f0, f1, ws))


def _launch_k5(pts_cam, kpt_cam, f0, f1, mask, weight, ws, sp_level, sp_sigma, sp_scale,
               compute_dtype):
    return _launch(sp_geo_mlp_apply, (pts_cam, kpt_cam), f0, f1, mask, weight, ws,
                   compute_dtype, (sp_level, sp_sigma, sp_scale), _widths(f0, f1, ws))


def _fake_outs(f0, ws):
    V, N = f0.shape[:2]
    dl, dout = ws[6].shape[-1], ws[12].shape[-1]
    empty = lambda *shape: f0.new_empty(shape, dtype=torch.float32)  # noqa: E731
    return empty(N, dout), empty(N, 1), empty(V, N, dl), empty(N, 2 * dl)


# K4 and K5 as registered ops: the kernel on CUDA (counted on the public
# wrapper), the plain stack on the CPU, the output shapes alone under a
# trace. Inputs are checked before the op is called.
_OUTS = "(Tensor, Tensor, Tensor, Tensor)"
_GEO_MLP = define_op(
    "geo_mlp(Tensor sp, Tensor f0, Tensor f1, Tensor mask, Tensor weight, Tensor[] ws, "
    f"ScalarType compute_dtype) -> {_OUTS}", _launch_k4, mlp_stack_plain,
    lambda sp, f0, f1, mask, weight, ws, dt: _fake_outs(f0, ws))
_SP_GEO_MLP = define_op(
    "sp_geo_mlp(Tensor pts_cam, Tensor kpt_cam, Tensor f0, Tensor f1, Tensor mask, "
    "Tensor weight, Tensor[] ws, SymInt sp_level, float sp_sigma, float sp_scale, "
    f"ScalarType compute_dtype) -> {_OUTS}", _launch_k5, sp_mlp_stack_plain,
    lambda pts_cam, kpt_cam, f0, f1, mask, weight, ws, lvl, sigma, scale, dt:
    _fake_outs(f0, ws))


def _call_op(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args):
    check_device(f0)
    if sp_args is None:
        return _GEO_MLP(*lead, f0, f1, mask, weight, list(ws), compute_dtype)
    return _SP_GEO_MLP(*lead, f0, f1, mask, weight, list(ws), *sp_args, compute_dtype)


class _FusedGeoMLP(torch.autograd.Function):
    """Forward: the registered op (the kernel on CUDA, the plain stack on
    the CPU). Backward: the plain stack re-run from the saved inputs and
    differentiated, which is what the JAX kernels' custom VJP does."""

    @staticmethod
    def forward(ctx, compute_dtype, sp_args, n_lead, *tensors):
        lead, (f0, f1, mask, weight), ws = tensors[:n_lead], tensors[n_lead:n_lead + 4], \
            tensors[n_lead + 4:]
        outs = _call_op(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args)
        ctx.save_for_backward(*tensors)
        ctx.config = (compute_dtype, sp_args, n_lead)
        ctx.mark_non_differentiable(outs[1])              # valid: a comparison
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, _g_valid, g_lv, g_lf):
        compute_dtype, sp_args, n_lead = ctx.config
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            out, _, lv, lf = _plain(ins[:n_lead], *ins[n_lead:n_lead + 4], ins[n_lead + 4:],
                                    compute_dtype, sp_args)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad((out, lv, lf), wanted, (g_out, g_lv, g_lf),
                                             allow_unused=True))
        return (None, None, None,
                *(next(grads) if need else None for need in needs))


def _apply(compute_dtype, sp_args, lead, f0, f1, mask, weight, ws):
    """Check, then the op: through `_FusedGeoMLP` where autograd records,
    directly where it does not (inference, an export trace)."""
    _check(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args)
    tensors = (*lead, f0, f1, mask, weight, *ws)
    if autograd_records(*tensors):
        return _FusedGeoMLP.apply(compute_dtype, sp_args, len(lead), *tensors)
    return _call_op(lead, f0, f1, mask, weight, ws, compute_dtype, sp_args)


def _folded(params) -> Sequence[torch.Tensor]:
    return tuple(params) if isinstance(params, (tuple, list)) else fold_weight_norm(params)


def geo_mlp_apply(params, sp, f0, f1, mask, weight, compute_dtype=torch.float32):
    """K4, differentiable. `params` is a `GeoFusionMLP` or its 14 folded
    weights; sp (V, N, Dsp), f0 (V, N, C0), f1 (V, N, C1), mask / weight
    (V, N, 1), all f32. Returns out (N, Do), valid (N, 1), latent_view
    (V, N, Dl), latent_fused (N, 2 Dl), f32. CUDA tensors go to the kernel
    (counted in `geo_mlp_apply.launches`), CPU tensors to the plain version;
    N is any size."""
    return _apply(compute_dtype, None, (sp,), f0, f1, mask, weight, _folded(params))


def sp_geo_mlp_apply(params, pts_cam, kpt_cam, f0, f1, mask, weight, sp_level=3,
                     sp_sigma=0.1, sp_scale=1.0, compute_dtype=torch.float32):
    """K5, differentiable: K4 with the rel_z_decay encoding built in the
    kernel from pts_cam (V, N, 3) and kpt_cam (V, K, 3). Launches are
    counted in `sp_geo_mlp_apply.launches`."""
    return _apply(compute_dtype, (int(sp_level), float(sp_sigma), float(sp_scale)),
                  (pts_cam, kpt_cam), f0, f1, mask, weight, _folded(params))


geo_mlp_apply.launches = 0
sp_geo_mlp_apply.launches = 0
geo_mlp_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
sp_geo_mlp_apply.launches_by_route = dict.fromkeys(ROUTES, 0)
