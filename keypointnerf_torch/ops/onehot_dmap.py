"""K1: the map gradient of the bilinear lookup, for the training step.

Replaces the Pallas kernel `keypointnerf_tpu/ops/pallas/onehot_dmap.py`
(`bilinear_dmap_onehot`), which the JAX training step calls for maps with
at least 32 gradient channels (the 64-channel coarse geometry map) when
`train_pallas_dmap` is set. The TPU kernel accumulates the one-hot
contraction Yw^T @ (XwE * tile(g)) in VMEM; each point has two nonzero
rows and two nonzero columns, so the same sum is, per point and corner
(y, x) in {y0, y0+1} x {x0, x0+1}:

  dmap[y, x, c] += f32(rnd(yw_y)) * f32(rnd(xw_x * g[c]))

with the clamp and weights of `feat_sample.bilinear_coords`, the xw * g
product formed in f32 and rounded once to the map dtype, and an f32 sum.
The XLA scan that the JAX package uses for narrower maps rounds each term
the same way (`feat_sample.py:_mm_bwd_impl`), so the port takes this
wrapper for every map gradient of the training lookups.

The cotangent may be f32 or bf16 (a bf16 lookup's, as autograd hands it
over): widening bf16 to f32 is exact, so both give the same terms.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/onehot_dmap.cu: points sorted stably by map cell, summed in
registers a cell at a time, each texel combined from its cells in a fixed
order, so two launches on the same inputs give the same bits; one C call
for all views and passes) or raises; on a CPU tensor it runs
`onehot_dmap_plain`, the same terms summed with `index_add_` (in index
order on the CPU).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from ._build import DTYPE_CODE, entry, launch
from .feat_sample import bilinear_coords


def onehot_dmap_plain(xy, g, H, W, map_dtype=torch.bfloat16):
    """The plain PyTorch version of the kernel.

    xy: (V, N, 2) f32 NDC; g: (V, N, C) f32 or bf16 cotangent of the
    lookup; `map_dtype` the dtype each term is rounded to (f32 or bf16).
    Returns the (V, H, W, C) f32 map gradient.
    """
    V, N, C = g.shape
    x0, y0, wx, wy = bilinear_coords(xy.float(), H, W)

    def rnd(t):
        return t.to(map_dtype).float()

    gf = g.float()
    base = (torch.arange(V, device=g.device)[:, None] * H + y0) * W + x0
    rows, terms = [], []
    for yw, dy in ((rnd(1.0 - wy), 0), (rnd(wy), 1)):
        for xw, dx in ((1.0 - wx, 0), (wx, 1)):
            rows.append((base + dy * W + dx).reshape(-1))
            terms.append((yw[..., None] * rnd(xw[..., None] * gf)).reshape(-1, C))
    dmap = torch.zeros(V * H * W, C, dtype=torch.float32, device=g.device)
    dmap.index_add_(0, torch.cat(rows), torch.cat(terms))
    return dmap.reshape(V, H, W, C)


def _check(xy, g, H, W, map_dtype):
    if xy.dim() != 3 or xy.shape[-1] != 2 or g.dim() != 3 or g.shape[:2] != xy.shape[:2]:
        raise ValueError(
            f"expected points (V, N, 2) and cotangent (V, N, C), got "
            f"{tuple(xy.shape)} and {tuple(g.shape)}"
        )
    if H < 2 or W < 2:
        raise ValueError(f"maps must be at least 2x2, got {H}x{W}")
    if map_dtype not in DTYPE_CODE:
        raise TypeError(f"map dtype must be float32 or bfloat16, got {map_dtype}")
    if xy.dtype != torch.float32 or g.dtype not in DTYPE_CODE:
        raise TypeError(f"points must be float32 and the cotangent float32 or bfloat16, "
                        f"got {xy.dtype}, {g.dtype}")
    if xy.device != g.device:
        raise ValueError(f"points on {xy.device} but cotangent on {g.device}")


# the kernel's constants that size its scratch (csrc/onehot_dmap.cu)
_TILE, _RADIX_BITS, _BINS, _MAX_PASSES, _SEGMENT = 2048, 8, 256, 4, 128


def scratch_bytes(V, N, H, W, C):
    """Bytes of scratch the kernel takes (`kpn_onehot_dmap_scratch_bytes`,
    its `layout_of`): the sort's two (key, index) buffers, each cell's run
    (a texel's worth of cells), the zeroed histograms and per-tile digit
    counts, three corner planes of dmap's size and two pieces of (4, C)
    floats a segment of sorted points."""
    total, cells = V * N, V * H * W
    tiles = -(-total // _TILE)
    segments = -(-total // _SEGMENT)
    key_bits = max(1, (cells - 1).bit_length())
    passes = -(-key_bits // _RADIX_BITS)
    ints = 4 * total + 2 * cells + _MAX_PASSES * _BINS + passes * _BINS * tiles
    return -(-4 * ints // 16) * 16 + 4 * 3 * cells * C + 4 * 2 * segments * 4 * C


def _launch(xy, g, H, W, map_dtype):
    if not (xy.is_contiguous() and g.is_contiguous()):
        raise ValueError("the kernel takes contiguous points and cotangent")
    if xy.data_ptr() % 8:
        xy = xy.clone()                       # the kernel reads a point as a float2
    V, N, C = g.shape
    # one C call writes every texel of the output and launches every pass
    dmap = torch.empty((V, H, W, C), dtype=torch.float32, device=g.device)
    size = scratch_bytes(V, N, H, W, C)
    scratch = torch.empty(size, dtype=torch.uint8, device=g.device)
    fn = entry("onehot_dmap", "kpn_onehot_dmap", *(ctypes.c_void_p,) * 4, ctypes.c_int64,
               *(ctypes.c_int,) * 7)
    launch(multiview_dmap_onehot, fn, g, xy.data_ptr(), g.data_ptr(), dmap.data_ptr(),
           scratch.data_ptr(), size, V, N, H, W, C, DTYPE_CODE[map_dtype], DTYPE_CODE[g.dtype])
    return dmap


def multiview_dmap_onehot(xy, g, H, W, map_dtype=torch.bfloat16):
    """Map gradient of the lookup of V (H, W, C) maps at per-view points.

    xy: (V, N, 2) f32 NDC; g: (V, N, C) f32 or bf16. Returns (V, H, W, C)
    f32 (the caller casts to the map dtype). CUDA tensors go to the kernel (counted
    in `multiview_dmap_onehot.launches`), CPU tensors to the plain version.
    """
    _check(xy, g, H, W, map_dtype)
    with span("onehot_dmap"):
        if g.is_cuda:
            return _launch(xy, g, H, W, map_dtype)
        if g.device.type != "cpu":
            raise ValueError(f"no kernel for device {g.device}")
        return onehot_dmap_plain(xy, g, H, W, map_dtype)


multiview_dmap_onehot.launches = 0
