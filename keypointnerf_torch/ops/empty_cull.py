"""The empty-ray cull's scores at inference as one launch: every ray's
conservative foreground score (`render/empty_cull.py`) computed in
registers, from the frame's cell table, projections and rays.

Replaces no Pallas kernel: it is the counterpart of XLA's fusion of the
JAX package's `empty_ray_scores`, which the port composes from ~130
PyTorch calls a 4,096-ray score chunk. `render/empty_cull.py`
(`empty_ray_scores`) computes the cell table, the projection matrices and
the AABB-clamped near / far once a frame and calls the wrapper
(`fused_empty_ray_scores`) for rays on the card, whatever the frame's
views, samples or cell table; rays on the CPU it scores with the
composition (`empty_ray_scores_plain`), as it always has.

The composition lives here, so that the op's plain version imports
nothing of `render/` or `models/`. Its three reductions follow what the
model looks the map up at (render/empty_cull.py's docstring): TIGHT, the
gather-lerp's anchors of the coarse and the fine group; LOOSE, the min
over views of each view's max over all the ray's samples; PLAIN, the max
over samples of the min over views.

The wrapper calls the registered op `kpnerf::empty_ray_scores`: on CUDA
tensors it launches the hand-written kernel (csrc/empty_cull.cu, counted
in `fused_empty_ray_scores.launches`), which gives the composition's
bits; on CPU tensors it runs the composition; under a trace
(`torch.export`) the fake implementation gives the output's shape.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..device import cached
from ..geometry.cameras import ndc_xy, project_points
from ..geometry.sampling import inverse_cdf, stratified_z
from ._build import check_device, define_op, entry, launch

# the reductions (render/empty_cull.py chooses one from the model's fields)
PLAIN, LOOSE, TIGHT = 0, 1, 2
# the composition's rays a step, which bound its memory
SCORE_CHUNK = 4096


def anchors(n_samples: int, stride: int) -> torch.Tensor:
    """The gather-lerp's anchors of a group: every stride-th sample and the
    last."""
    return torch.cat([torch.arange(0, n_samples, stride), torch.tensor([n_samples - 1])])


def _cell_lookup(cmax, cy, cx):
    """(V, P) bf16-rounded cell values at int cell indices (V, P)."""
    V, hc, wc = cmax.shape
    flat = cmax.to(torch.bfloat16).float().reshape(-1)
    view = torch.arange(V, device=cmax.device)[:, None]
    return flat[(view * hc + cy) * wc + cx]


@cached
def _fine_bins(n_bins: int, n_fine: int, device):
    """The fine depths' edge indices (n_fine,) int32 and in-bin fractions
    (n_fine,) f32 that every all-zero-weight ray shares, by `importance_z`'s
    own ops (`inverse_cdf`) on one such ray's n_bins weights. Made at one
    row: torch's CUDA cumsum adds in an order that depends on the number of
    rows, so the table, which the kernel and the composition both read, is
    made once and not per chunk."""
    j, hit, frac = inverse_cdf(torch.zeros(1, n_bins, device=device), n_fine)
    # no edge at or below u: both edges the last one, as importance_z takes it
    j = torch.where(hit, j, n_bins)
    return j[0].to(torch.int32).contiguous(), frac[0].contiguous()


def empty_ray_scores_plain(cmax, krt, origin, dirs, near, far, mode: int, n_coarse: int,
                           n_fine: int, stride: int, height: int, width: int,
                           map_height: int, map_width: int, cell: int,
                           score_chunk: int = SCORE_CHUNK) -> torch.Tensor:
    """The plain PyTorch version: the composition, `score_chunk` rays at a
    time. cmax (V, Hc, Wc) the cell maxima; krt (V, 4, 4); origin (3,);
    dirs (R, 3); near, far (R, 1) after the AABB clamp; height x width the
    projection's NDC convention, map_height x map_width the mask map's
    grid. Returns (R,) f32, the same whatever `score_chunk`."""
    V = cmax.shape[0]
    Hm, Wm = map_height, map_width
    if mode == TIGHT:
        ia_c = anchors(n_coarse, stride).to(dirs.device)
        ia_f = anchors(n_fine, stride).to(dirs.device)
    j, frac = _fine_bins(n_coarse - 2, n_fine, dirs.device)
    j = j.long()
    scores = []
    for s in range(0, dirs.shape[0], score_chunk):
        d, nr, fr = dirs[s:s + score_chunk], near[s:s + score_chunk], far[s:s + score_chunk]
        z = stratified_z(nr, fr, n_coarse)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        # importance_z's depths of the zero-weight ray, over the shared bins
        pad = torch.cat([z_mid, z_mid[..., -1:]], dim=-1)
        z_prev, z_next = pad[:, j], pad[:, j + 1]
        zf = z_prev + frac * (z_next - z_prev)
        if mode == TIGHT:
            z_all = torch.cat([z[:, ia_c], zf[:, ia_f]], dim=-1)
        else:
            z_all = torch.cat([z, zf], dim=-1)                   # (c, S)
        pts = origin + d[:, None, :] * z_all[..., None]
        xy_pix, _ = project_points(pts.reshape(1, -1, 3), krt)   # (V, c*S, 2)
        xy = ndc_xy(xy_pix, width, height)
        # the sampler's NDC -> pixel map and border clamp, onto the map grid
        px = ((xy[..., 0] + 1.0) * 0.5 * (Wm - 1)).clamp(0.0, Wm - 1.0)
        py = ((xy[..., 1] + 1.0) * 0.5 * (Hm - 1)).clamp(0.0, Hm - 1.0)
        cx = torch.floor(px / cell).long()
        cy = torch.floor(py / cell).long()
        vals = _cell_lookup(cmax, cy, cx).reshape(V, -1, z_all.shape[-1])
        if mode == TIGHT:
            # max_pool1d pads with -inf, as reduce_window's SAME padding does
            group = lambda v: F.max_pool1d(v, 3, stride=1, padding=1).amin(0).amax(-1)  # noqa: E731
            n_c = ia_c.shape[0]
            scores.append(torch.maximum(group(vals[..., :n_c]), group(vals[..., n_c:])))
        elif mode == LOOSE:
            scores.append(vals.amax(dim=-1).amin(dim=0))
        else:
            scores.append(vals.amin(dim=0).amax(dim=-1))
    return torch.cat(scores)


def _check(cmax, krt, origin, dirs, near, far, mode, n_coarse, n_fine, stride):
    R = dirs.shape[0]
    if cmax.dim() != 3 or krt.shape != (cmax.shape[0], 4, 4) or origin.shape != (3,) \
            or dirs.shape != (R, 3) or near.shape != (R, 1) or far.shape != (R, 1):
        raise ValueError(
            f"expected cmax (V, Hc, Wc), krt (V, 4, 4), origin (3,), dirs (R, 3), near and far "
            f"(R, 1), got {tuple(cmax.shape)}, {tuple(krt.shape)}, {tuple(origin.shape)}, "
            f"{tuple(dirs.shape)}, {tuple(near.shape)}, {tuple(far.shape)}")
    ts = (cmax, krt, origin, dirs, near, far)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the cull's tensors must be float32, got {[t.dtype for t in ts]}")
    if any(t.device != dirs.device for t in ts):
        raise ValueError(f"the cull's tensors lie on {[str(t.device) for t in ts]}")
    if mode not in (PLAIN, LOOSE, TIGHT):
        raise ValueError(f"unknown cull mode {mode}")
    # what a ray's samples need: a bin between the coarse midpoints' ends,
    # a fine sample, and the gather-lerp's anchors at least 2 apart
    if n_coarse < 3 or n_fine < 1 or (mode == TIGHT and stride < 2):
        raise ValueError(f"the cull takes at least 3 coarse and 1 fine samples a ray and, "
                         f"when tight, a stride of 2 or more; got {n_coarse}, {n_fine} and "
                         f"stride {stride}")


def _launch(cmax, krt, origin, dirs, near, far, mode, n_coarse, n_fine, stride, height, width,
            map_height, map_width, cell):
    V, hc, wc = cmax.shape
    out = _new_out(cmax, krt, origin, dirs, near, far)
    R = dirs.shape[0]
    if R == 0:
        return out
    j, frac = _fine_bins(n_coarse - 2, n_fine, dirs.device)
    cmax, krt, origin, dirs, near, far = (t.contiguous() for t in (cmax, krt, origin, dirs,
                                                                    near, far))
    f32 = np.float32
    # the f32 values torch's kernels compute with: linspace01's reciprocal,
    # the host scalars rounded to f32, the division by `cell` as the product
    # with its f32 reciprocal (torch divides by a host scalar so)
    scalars = (f32(1.0 / (n_coarse - 1)), f32(2.0 / (width - 1.0)), f32(2.0 / (height - 1.0)),
               f32(map_width - 1), f32(map_height - 1), f32(1.0) / f32(cell))
    fn = entry("empty_cull", "kpn_empty_ray_scores", *(ctypes.c_void_p,) * 9, ctypes.c_longlong,
               *(ctypes.c_int,) * 7, *(ctypes.c_float,) * 6)
    launch(fused_empty_ray_scores, fn, dirs,
           *(t.data_ptr() for t in (cmax, krt, origin, dirs, near, far, j, frac, out)),
           R, V, hc, wc, n_coarse, n_fine, stride, mode, *(float(x) for x in scalars))
    return out


def _new_out(cmax, krt, origin, dirs, near, far, *args):
    """The uninitialised scores: the kernel's, and the op's under a trace."""
    return dirs.new_empty((dirs.shape[0],), dtype=torch.float32)


_OP = define_op("empty_ray_scores(Tensor cmax, Tensor krt, Tensor origin, Tensor dirs, "
                "Tensor near, Tensor far, int mode, int n_coarse, int n_fine, int stride, "
                "int height, int width, int map_height, int map_width, int cell) -> Tensor",
                _launch, empty_ray_scores_plain, _new_out)


def fused_empty_ray_scores(cmax, krt, origin, dirs, near, far, mode: int, n_coarse: int,
                           n_fine: int, stride: int, height: int, width: int, map_height: int,
                           map_width: int, cell: int) -> torch.Tensor:
    """Every ray's cull score in one launch (arguments as for
    `empty_ray_scores_plain`). CUDA tensors go to the kernel (counted in
    `fused_empty_ray_scores.launches`), CPU tensors to the composition,
    both through the registered op."""
    _check(cmax, krt, origin, dirs, near, far, mode, n_coarse, n_fine, stride)
    check_device(dirs)
    return _OP(cmax, krt, origin, dirs, near, far, int(mode), int(n_coarse), int(n_fine),
               int(stride), int(height), int(width), int(map_height), int(map_width), int(cell))


fused_empty_ray_scores.launches = 0
