#!/usr/bin/env python3
"""Smoke run of the PyTorch port (keypointnerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, TF32 switched off for matmuls and cuDNN convs;
  2. build: nvcc compiles every kernel of keypointnerf_torch/csrc/ (one
     process per source, all at once) into build/kernels/, and beside
     them fused_geo_mlp.cu with -Xptxas -v for K4 / K5's registers and
     spills;
  3. kernels: each kernel (K2 the tex lookup, K1 the coarse map's
     gradient, K4 / K5 the fused geometry MLP without / with the in-kernel
     spatial encoding, K3 the fused map's patch-gather lookup, K6 the fused
     composite + importance placement) against its plain PyTorch version
     on the card at
     the main paths' shapes (render query and, for K5, the training
     step's two queries; and an odd or ragged shape), with its time,
     the plain version's time, one PyTorch library call's time where there
     is one (for K4 / K5 the module path they replace instead) and the
     bound (for K4 / K5 the largest of bytes, products, the f32 issue
     time of every instruction the kernel's per-value code compiles to
     (read from its SASS) and the MUFU / conversion pipe's share of it; a
     probe's times of the library's softplus100 / expf / sinf / cosf
     printed beside, for comparison); K2 and K3 timed by profiled device
     time and by CUDA events per call, beside F.grid_sample's
     grid_sampler_2d kernel timed both ways on the same inputs (K2 at
     uniform and at ray-coherent points); the K4 / K5 autograd.Function's
     gradients (kernel forward, recompute backward) against autograd
     through the plain version; K4 and K5 at widths the wgmma kernel
     refuses (5 views, layer widths 96, 96, 80, 48 | 48, 48, K5 with 16
     keypoints and 2 levels) on the wmma route, outputs and gradients; and
     both forms of `models/mlp.py:dot_f32` in bf16 (inference: torch.mm
     with out_dtype=float32; autograd: the f32 product of bf16-rounded
     operands) against an f64 product, with their times; K1 with f32 and
     bf16 cotangents, timed at the fine and the coarse query's N with each
     pass's device time; K6 beside the device time and a call's time of an
     empty kernel, the floor under both, and again with falling cdfs (its
     warp-reduction path);
  4. render: one 512² camera of the strict preset at full width (the zju
     architecture, bf16, cull budget 0.1875, seeded random weights) on the
     synthetic 512² scene with 3 source views; checks finite outputs,
     cull_overflow == 0 and each kernel's launch count in that render, and
     that the culled render is bit-equal to marching every ray; prints
     wall-clock rays/s (beside the same render with dot_f32's earlier bf16
     product) and the render's top CUDA kernels by device time; then the
     same camera with `use_pallas_geo_mlp` (K5), a 256² `rel_z` camera
     (K4), the camera with the fused feature map and K3 (cull on its mask
     channel: overflow 0, culled == unculled bit for bit, K2 never
     launched; held against the plain lookup of the fused map) and, at
     stride 2 with the cull off, the fused map with K3 and K6 (held
     against composite + importance_z); and a 128² camera of a model at
     those non-zju widths with `use_pallas_geo_mlp` (K5 on the wmma
     route, every query) against the flag-off render;
  5. agreement: toy-size f32 renders on the card against the same renders
     on the CPU (the paths the CPU tests hold against the JAX package),
     with each kernel's flag off and on;
  6. train: optimizer steps of the configs/zju.json recipe at full width
     (bf16, 64x64 patch, 64+64 samples, matmul VJP with K1, VGG loss on
     random frozen VGG19, Adam 5e-4) on the synthetic 512² scene: 2
     warm-up and 5 timed steps, finite losses, K1 launched twice a step,
     parameters changed and finite; s/step, rays/s, peak memory and one
     step's top CUDA kernels; K1 at the first step's own (xy, cotangent)
     of both its calls (captured by wrapping the wrapper): how the points
     fall on the map's cells, K1 against its plain version and its time
     with the cotangent as the step hands it over (bf16) and widened, and
     the two launches' sum; then the same steps with
     `use_pallas_geo_mlp` (K5 twice a step, its backward the recompute),
     the first step's loss terms and gradient norm held against the
     flag-off run's;
  7. train agreement: one toy f32 step on the card against the same step
     on the CPU (loss, every gradient, the updated parameters), with
     `use_pallas_geo_mlp` off and on;
  8. prints the kernels line, the card line and, last, the result line.

`--phases kernels,render,...` runs a subset while developing (the result
line is printed only by a full run).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): HBM rate, f32 non-tensor rate, bf16
# tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# f32 instructions a second (132 SMs x 128 lanes at 1.98 GHz: the f32 rate
# with an FMA counted once) and the rate of the MUFU / conversion pipe (16
# a cycle an SM: the CUDA programming guide's rate for special functions
# and for type conversions)
F32_ISSUE_PER_S = F32_FLOPS_PER_S / 2
MUFU_PER_S = 132 * 16 * 1.98e9
ZJU_CONFIG = Path(__file__).resolve().parent / "configs" / "zju.json"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, name, iters=20) -> float:
    """Mean device time in ms, per call of fn(), of the CUDA kernels whose
    name contains `name` (from the profiler: a call's CUDA-event time also
    holds the host's work when the kernel is shorter than it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profile now and then comes back without the device's events: three
    # tries before giving up
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # kernels only: an aten op's event (aten::grid_sampler_2d) carries
        # its kernels' device time again
        us = sum(device_us(e) for e in prof.key_averages()
                 if name in e.key and not e.key.startswith("aten::"))
        if us > 0:
            return us / 1e3 / iters
    raise SystemExit(f"the profile shows no device time for a kernel named {name}")


_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def device_us(e):
    """A profiler event's own device time in us (the name moved in torch 2.x)."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def time_lookup(call, kernel_name, library_call) -> dict:
    """A lookup kernel's and grid_sample's times on the same inputs: device
    time from the profile (ms, library_ms) and a call's time by CUDA events
    (call_ms, library_call_ms: for a short kernel mostly host work)."""
    return {"ms": kernel_device_ms(call, kernel_name),
            "call_ms": cuda_ms(call, iters=100),
            "library_ms": kernel_device_ms(library_call, "grid_sampler_2d"),
            "library_call_ms": cuda_ms(library_call, iters=100)}


def check_onehot_bilinear(dev) -> dict:
    """K2 against its plain version; returns its kernels-line entry, timed
    at uniform points (as in earlier runs) with the times at ray-coherent
    points (as the render gives them) beside."""
    from keypointnerf_torch.ops import onehot_bilinear as k2

    rs = np.random.default_rng(0)
    entry = None
    # main-path shapes: 3 source views, 256² x 8 tex map, 2048 rays x 64
    # samples per query chunk (uniform and ray-coherent points); plus odd
    # map shapes, one with a channel count no vector load divides
    for (V, H, W, C, N, what) in ((3, 256, 256, 8, 2048 * 64, "uniform"),
                                  (3, 256, 256, 8, 2048 * 64, "render"),
                                  (3, 33, 17, 8, 5000, "uniform"),
                                  (3, 33, 17, 5, 5003, "uniform")):
        maps32 = torch.as_tensor(rs.normal(size=(V, H, W, C)).astype(np.float32), device=dev)
        xy_np = (ray_like_xy(rs, V, 2048, 64) if what == "render"
                 else rs.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32))
        xy = torch.as_tensor(xy_np, device=dev)
        N = xy.shape[1]
        for dt, tol in ((torch.bfloat16, 0.0), (torch.float32, 1e-6)):
            maps = maps32.to(dt).contiguous()
            got = k2.multiview_onehot_bilinear_sample(maps, xy)
            ref = k2.onehot_bilinear_plain(maps, xy)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got.float()).all())
            err = (got.float() - ref.float()).abs().max().item()
            ok = finite and err <= tol and got.shape == (V, N, C) and got.dtype == dt
            print(f"K2 onehot_bilinear {V}x{H}x{W}x{C} {str(dt)[6:]} N={N} ({what}): "
                  f"max_abs_err={err} (bound {tol}), finite {finite} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version: {err}")
            if (H, W, dt) == (256, 256, torch.bfloat16):
                # grid_sample takes the grid in the map's dtype: the
                # yardstick reads bf16-rounded coordinates (cast untimed)
                nchw = maps.permute(0, 3, 1, 2)      # a view of the same map
                grid = xy[:, None].to(dt)             # (V, 1, N, 2)
                t = time_lookup(lambda: k2.multiview_onehot_bilinear_sample(maps, xy),
                                "onehot_bilinear_kernel",
                                lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                      padding_mode="border", align_corners=True))
                esize = maps.element_size()
                n_bytes = maps.numel() * esize + xy.numel() * 4 + V * N * C * esize
                # per point: ~14 flops of coordinates and weights; per
                # output value: 4 mul + 2 add (rows) + 2 mul + 1 add (cols)
                n_ops = V * N * (14 + 9 * C)
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / F32_FLOPS_PER_S * 1e3
                print(f"K2 timing (bf16, 3x256x256x8, N={N}, {what} points): kernel "
                      f"{t['ms']:.5f} ms of device time ({t['call_ms']:.5f} ms a call by CUDA "
                      f"events), grid_sample {t['library_ms']:.5f} ms of device time "
                      f"({t['library_call_ms']:.5f} ms a call by CUDA events), bound "
                      f"{max(t_bytes, t_ops):.5f} ms ({n_bytes} bytes, {n_ops} flops)",
                      flush=True)
                if what == "uniform":
                    entry = {
                        "name": "onehot_bilinear", "route": "cuda",
                        "source": "keypointnerf_torch/csrc/onehot_bilinear.cu",
                        "replaces": "keypointnerf_tpu/ops/pallas/onehot_bilinear.py:83",
                        "max_abs_err": err, **t,
                        "plain_ms": cuda_ms(lambda: k2.onehot_bilinear_plain(maps, xy),
                                            iters=10),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    }
                else:
                    entry["render_points"] = t
    return entry


def ray_like_xy(rs, V, n_rays, n_samples, spread=0.6, length=0.3):
    """(V, n_rays * n_samples, 2) f32 NDC points as a render query gives
    them: each ray's samples on a short segment of an epipolar line, so
    neighbouring points read neighbouring patches."""
    start = rs.uniform(-spread, spread, (V, n_rays, 1, 2))
    ang = rs.uniform(0.0, 2.0 * np.pi, (V, n_rays, 1))
    step = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * length / n_samples
    xy = start + step * np.arange(n_samples)[None, None, :, None]
    return xy.reshape(V, -1, 2).astype(np.float32)


def touched_map_bytes(maps, xy):
    """Bytes of the distinct map pixels whose rows a bilinear lookup of xy
    reads (the four corners of each point): what this run's data needs."""
    from keypointnerf_torch.ops.feat_sample import bilinear_coords

    V, H, W, C = maps.shape
    x0, y0, _, _ = bilinear_coords(xy, H, W)
    base = (torch.arange(V, device=xy.device)[:, None] * H + y0) * W + x0
    corners = torch.cat([base + off for off in (0, 1, W, W + 1)], dim=1)
    return int(torch.unique(corners).numel()) * C * maps.element_size()


def check_dma_gather(dev) -> dict:
    """K3 against its plain version; returns its kernels-line entry. Both
    round each lerp the same way (bf16: every step; f32: one rounding of
    the f64 a + w * d), so they are held bit for bit."""
    from keypointnerf_torch.ops import dma_gather as k3

    rs = np.random.default_rng(4)
    V = 3
    # the fused 512² map at the render query's shape (2048 rays x 64
    # samples, ray-coherent) and at a ragged N of uniform points reaching
    # outside [-1, 1]; an odd map whose 37 channels allow no vector load
    uniform = lambda n: rs.uniform(-1.3, 1.3, (V, n, 2)).astype(np.float32)  # noqa: E731
    cases = (("render", (512, 512, 84), ray_like_xy(rs, V, 2048, 64)),
             ("ragged", (512, 512, 84), uniform(100_003)),
             ("odd", (33, 17, 37), uniform(5003)))
    entry = None
    for what, (H, W, C), xy_np in cases:
        if what != "ragged":
            maps32 = torch.as_tensor(rs.normal(size=(V, H, W, C)).astype(np.float32),
                                     device=dev)
        xy = torch.as_tensor(xy_np, device=dev)
        N = xy.shape[1]
        for dt in (torch.bfloat16, torch.float32):
            maps = maps32.to(dt).contiguous()
            got = k3.multiview_bilinear_sample_dma(maps, xy)
            ref = k3.dma_gather_plain(maps, xy)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got.float()).all())
            err = (got.float() - ref.float()).abs().max().item()
            ok = finite and err == 0.0 and got.shape == (V, N, C) and got.dtype == dt
            print(f"K3 dma_gather {V}x{H}x{W}x{C} {str(dt)[6:]} N={N} ({what}): "
                  f"max_abs_err={err} (bound 0.0), finite {finite} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"K3 disagrees with its plain version: {err}")
            if what == "render" and dt == torch.bfloat16:
                nchw = maps.permute(0, 3, 1, 2).contiguous()   # the yardstick's layout
                grid = xy[:, None].to(dt)                       # (V, 1, N, 2)
                t = time_lookup(lambda: k3.multiview_bilinear_sample_dma(maps, xy),
                                "dma_gather_kernel",
                                lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                                      padding_mode="border", align_corners=True))
                plain_ms = cuda_ms(lambda: k3.dma_gather_plain(maps, xy), iters=10)
                esize = maps.element_size()
                map_bytes = touched_map_bytes(maps, xy)
                n_bytes = map_bytes + xy.numel() * 4 + V * N * C * esize
                # per point ~14 flops of coordinates and weights; per output
                # value three lerps of 3 operations each
                n_ops = V * N * (14 + 9 * C)
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / F32_FLOPS_PER_S * 1e3
                entry = {
                    "name": "dma_gather", "route": "cuda",
                    "source": "keypointnerf_torch/csrc/dma_gather.cu",
                    "replaces": "keypointnerf_tpu/ops/pallas/dma_gather.py:80",
                    "max_abs_err": err, **t, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                }
                print(f"K3 timing (bf16, {V}x{H}x{W}x{C}, N={N}, ray-coherent points): kernel "
                      f"{t['ms']:.5f} ms of device time ({t['call_ms']:.5f} ms a call by CUDA "
                      f"events), plain {plain_ms:.4f} ms, grid_sample (NCHW copy) "
                      f"{t['library_ms']:.5f} ms of device time ({t['library_call_ms']:.5f} ms "
                      f"a call by CUDA events), bound {entry['bound_ms']:.5f} ms "
                      f"({entry['bound_by']}: {n_bytes} bytes, of them {map_bytes} of the "
                      f"{maps.numel() * esize} map bytes this query touches; {n_ops} flops)",
                      flush=True)
    return entry


# K6 against its plain version: the scans and sums run in another order (a
# warp's shuffles against torch's cumsum / sum). Absolute bounds, the
# outputs O(1) (color, acc, contrib, sdf) and O(5) (depth): measured 2.4e-7
# and 9.5e-7 worst, pinned at 1e-6 and 5e-6 (the JAX package holds its K6
# against the XLA composite at 2e-5 / 2e-4, tests/test_pallas.py:348-357).
# z_fine cannot be held by a small max: in a bin the coarse pass left
# empty, den = 1e-5 / sum(cint) sits at the den < 1e-5 switch when the ray
# is opaque, and the inverse CDF there divides cdf rounding by ~1e-5. A
# fine depth then moves within its bin, or across two if an edge flips
# too: "z_fine" is the move as a share of the ray's widest bin (measured
# 0.955, bound 2); its mean measured 3.7e-6, pinned at 2e-5.
K6_BOUNDS = {"color": 1e-6, "depth": 5e-6, "acc": 1e-6, "sdf": 5e-6, "contrib": 1e-6,
             "z_fine": 2.0, "z_fine_mean": 2e-5}


def k6_held_depths(contrib, u):
    """For rays whose cdf falls somewhere, {cdf_j <= u} is no interval, and
    an edge within rounding of u (the kernel's cdf and the plain version's
    sum in other orders) moves the depth across bins: the fine depths held
    to K6_BOUNDS are those with every edge at least 1e-5 from u, by the
    plain version's cdf. Returns that (R, F) mask and the falling rays'
    count."""
    cint = contrib[:, 1:-1] + 1e-5
    cdf = torch.cumsum(cint / cint.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)       # (R, S-1) edges
    falls = int((torch.diff(cdf, dim=-1) < 0).any(dim=-1).sum())
    return ((cdf[:, None, :] - u[:, :, None]).abs() >= 1e-5).all(dim=-1), falls


def composite_inputs(rs, R, S, F, dev):
    """Ray-shaped K6 inputs: stratified depths in [2, 5] with jitter, random
    densities with 64 all-zero and 64 opaque rays, random sdf and colors,
    u = linspace(0, 1, F) as the render passes it."""
    from keypointnerf_torch.geometry.sampling import linspace01

    near = rs.uniform(2.0, 3.0, (R, 1))
    far = near + rs.uniform(1.0, 2.0, (R, 1))
    t = (np.arange(S) + rs.uniform(0.0, 0.9, (R, S))) / S
    z = near + (far - near) * t
    alpha = np.maximum(rs.normal(size=(R, S)), 0.0) * rs.uniform(0.0, 20.0, (R, 1))
    alpha[:64] = 0.0
    alpha[64:128] = 1e3
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    u = linspace01(F, torch.float32, dev).expand(R, F).contiguous()
    return (f32(z), f32(alpha), f32(rs.normal(size=(R, S))), f32(rs.uniform(size=(R, S, 3))), u)


# The floor under any short kernel's device time: an empty kernel, one warp,
# launched by the same kind of ctypes call as the port's kernels.
LAUNCH_FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void kpn_empty_kernel() {}
extern "C" int kpn_empty_launch(void* s) {
  kpn_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(s)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(dev) -> dict:
    """Device time (profiled) and a call's time (events) of an empty kernel."""
    import ctypes

    fn = build_probe(LAUNCH_FLOOR_SRC).kpn_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    index = dev.index or 0

    def call():
        if fn(torch._C._cuda_getCurrentRawStream(index)) != 0:
            raise SystemExit("the empty kernel failed to launch")

    return {"ms": kernel_device_ms(call, "kpn_empty_kernel"), "call_ms": cuda_ms(call, iters=100)}


def check_composite_importance(dev) -> dict:
    """K6 against its plain version; returns its kernels-line entry."""
    from keypointnerf_torch.ops import composite_importance as k6

    rs = np.random.default_rng(6)
    names = ("color", "depth", "acc", "sdf", "contrib", "z_fine")
    entry = None
    # the render's shape (one 2048-ray chunk, 64 + 64 samples), a ragged R,
    # and the render's shape with a negative density at every ray's second
    # sample: its cdf falls there wherever light reaches it, and such rays
    # take the kernel's warp reductions instead of its binary search
    for R, S, F, falling in ((2048, 64, 64, False), (1237, 64, 64, False),
                             (2048, 64, 64, True)):
        ins = composite_inputs(rs, R, S, F, dev)
        if falling:
            ins[1][:, 1] = -0.5
        got = k6.fused_composite_importance(*ins)
        ref = k6.composite_importance_plain(*ins)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(names, ref, got):
            if a.shape != b.shape or not bool(torch.isfinite(b).all()):
                raise SystemExit(f"K6 {name}: shape differs or not finite")
            errs[name] = (a - b).abs().max().item()
        z_mid = 0.5 * (ins[0][:, 1:] + ins[0][:, :-1])
        widest = (z_mid[:, 1:] - z_mid[:, :-1]).amax(dim=-1, keepdim=True)
        dz = (ref[5] - got[5]).abs()
        held, what = torch.ones_like(dz, dtype=torch.bool), ""
        if falling:
            held, falls = k6_held_depths(ref[4], ins[4])
            what = (f" (falling cdfs: {falls} of {R} rays; {int((~held).sum())} fine depths "
                    f"with an edge within 1e-5 of u not held)")
        errs["z_fine_abs"] = dz[held].max().item()
        errs["z_fine"] = (dz / widest)[held].max().item()
        errs["z_fine_mean"] = dz[held].mean().item()
        moved = int((dz > 1e-4).sum())
        ok = all(errs[k] <= K6_BOUNDS[k] for k in K6_BOUNDS)
        print(f"K6 composite_importance R={R} S={S} F={F}{what}: max abs errors "
              f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (bounds {K6_BOUNDS}); "
              f"{moved} of {R * F} fine depths moved by > 1e-4 {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit("K6 disagrees with its plain version")
        if falling:
            falling_ms = kernel_device_ms(lambda: k6.fused_composite_importance(*ins),
                                          "composite_importance_kernel")
            entry["falling_ms"] = falling_ms
            print(f"K6 timing with falling cdfs (R={R}, S={S}, F={F}): {falling_ms:.5f} ms of "
                  f"device time", flush=True)
        elif R == 2048:
            call_ms = cuda_ms(lambda: k6.fused_composite_importance(*ins), iters=100)
            ms = kernel_device_ms(lambda: k6.fused_composite_importance(*ins),
                                  "composite_importance_kernel")
            plain_ms = cuda_ms(lambda: k6.composite_importance_plain(*ins), iters=10)
            n_bytes = 4 * R * (6 * S + F) + 4 * R * (S + F + 6)
            # per sample ~20 (alpha, log1p, exp, five products and sums);
            # per fine depth (S-1) edges x ~6 compare-and-select, ~10 after
            n_ops = R * (20 * S + F * (6 * (S - 1) + 10))
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / F32_FLOPS_PER_S * 1e3
            floor = launch_floor(dev)
            entry = {
                "name": "composite_importance", "route": "cuda",
                "source": "keypointnerf_torch/csrc/composite_importance.cu",
                "replaces": "keypointnerf_tpu/ops/pallas/composite_kernel.py:133",
                "max_abs_err": max(errs[k] for k in names[:5] + ("z_fine_abs",)),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "call_ms": call_ms, "empty_launch_ms": floor["ms"],
            }
            print(f"K6 timing (R={R}, S={S}, F={F}): kernel {ms:.5f} ms of device time "
                  f"({call_ms:.5f} ms a call by CUDA events: the wrapper's host work), plain "
                  f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}: "
                  f"{n_bytes} bytes = {t_bytes:.5f} ms, {n_ops} flops = {t_ops:.5f} ms); an "
                  f"empty kernel, the floor under both: {floor['ms']:.5f} ms of device time, "
                  f"{floor['call_ms']:.5f} ms a call; no single PyTorch call computes this "
                  f"function (library_ms null)", flush=True)
    return entry


def _bf16_ulps_apart(a, b):
    """Per entry, whether bf16 a and b lie more than one bf16 ulp apart."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)      # 8 significand bits
    return (a - b).abs() > ulp


K1_PASSES = ("count_kernel", "scan_kernel", "scatter_kernel", "accumulate_kernel")


def k1_cotangent_dtypes(k1):
    """The cotangent dtypes the K1 wrapper takes: f32 and bf16 (an earlier
    K1, timed beside this one in before-and-after runs, took f32 only)."""
    xy, g = torch.zeros(1, 1, 2), torch.zeros(1, 1, 1, dtype=torch.bfloat16)
    try:
        k1._check(xy, g, 2, 2, torch.bfloat16)
    except TypeError:
        return (torch.float32,)
    return (torch.float32, torch.bfloat16)


def check_k1(k1, xy, g, H, W, dt, what) -> float:
    """K1 against its plain version on (xy, g) with terms rounded to `dt`;
    returns the max abs error, exits on disagreement."""
    V, _, C = g.shape
    got = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    ref = k1.onehot_dmap_plain(xy, g, H, W, dt)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item() if finite else math.inf
    tol = 1e-5 * ref.abs().max().item()
    # as bf16 (the map dtype the gradient is cast to): at most one ulp
    # apart, except near zero, where the f32 sum-order error (within `tol`)
    # alone can exceed a bf16 ulp
    gb, rb = got.to(torch.bfloat16), ref.to(torch.bfloat16)
    apart = _bf16_ulps_apart(gb, rb)
    near_zero = (gb.float() - rb.float()).abs() <= tol
    differ = (gb != rb).float().mean().item()
    ok = (err <= tol and not bool((apart & ~near_zero).any())
          and got.shape == (V, H, W, C) and got.dtype == torch.float32)
    print(f"K1 onehot_dmap {what} {V}x{H}x{W}x{C} terms {str(dt)[6:]} cotangent "
          f"{str(g.dtype)[6:]} N={xy.shape[1]}: max_abs_err={err} (bound {tol}: 1e-5 of "
          f"max|dmap|, sum order); as bf16 {differ:.6f} of entries differ, "
          f"{int(apart.sum())} by more than 1 ulp (all within the f32 bound: "
          f"{not bool((apart & ~near_zero).any())}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version: {err}")
    return err


def k1_bound(V, N, H, W, C, g_esize) -> dict:
    """K1's least time: each input read once (8 bytes of coordinates and the
    cotangent row a point), the f32 dmap written once; per point ~14 flops
    of coordinates and weights, per channel and corner xw*g, yw*t and the
    add."""
    n_bytes = V * N * (2 * 4 + C * g_esize) + V * H * W * C * 4
    n_ops = V * N * (14 + 4 * 3 * C)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "n_bytes": n_bytes, "n_ops": n_ops}


def time_k1(k1, xy, g, H, W, dt) -> dict:
    """K1's time on (xy, g) by CUDA events (a call; every pass), with the
    profiled device time of each pass beside."""
    call = lambda: k1.multiview_dmap_onehot(xy, g, H, W, dt)  # noqa: E731
    ms = cuda_ms(call, iters=20)
    passes = {}
    if hasattr(k1, "scratch_bytes"):               # the binned design's passes
        passes = {name: kernel_device_ms(call, name, iters=5) for name in K1_PASSES}
    return {"ms": ms, "passes": passes, **k1_bound(*g.shape[:2], H, W, g.shape[2],
                                                   g.element_size())}


def k1_yardsticks(k1, xy, g, H, W, dt, what):
    """The plain version's time on (xy, g) and the yardstick's: torch's
    grid_sample backward (bilinear, border, align_corners), map gradient
    only, on an f32 map with the cotangent widened to f32."""
    V, N, C = g.shape
    plain_ms = cuda_ms(lambda: k1.onehot_dmap_plain(xy, g, H, W, dt), iters=5)
    fmap = torch.zeros((V, C, H, W), device=xy.device)
    grid = xy[:, None]                                              # (V, 1, N, 2)
    g_nchw = g.float().permute(0, 2, 1)[:, :, None].contiguous()    # (V, C, 1, N)
    library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, fmap, grid, 0, 1, True, [True, False]), iters=20)
    print(f"K1 yardsticks at {what} (N={N}, cotangent {str(g.dtype)[6:]}): plain "
          f"{plain_ms:.4f} ms, grid_sampler_2d_backward (f32) {library_ms:.4f} ms", flush=True)
    return plain_ms, library_ms


def check_onehot_dmap(dev) -> dict:
    """K1 against its plain version at uniform points; returns its
    kernels-line entry, timed here at uniform points (the main path's
    numbers, at the training step's own points, replace them in phase 6)."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    rs = np.random.default_rng(1)
    g_dtypes = k1_cotangent_dtypes(k1)
    errs = []
    # main-path shapes: the fine query of a zju step (3 source views,
    # 4096 rays x 128 samples) on the 128² x 64 coarse map; an odd shape
    for (V, H, W, C, N) in ((3, 128, 128, 64, 4096 * 128), (3, 33, 17, 40, 5000)):
        xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32), device=dev)
        g = torch.as_tensor(rs.normal(size=(V, N, C)).astype(np.float32), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            for gt in g_dtypes:
                errs.append(check_k1(k1, xy, g.to(gt), H, W, dt, "uniform"))
    # timed with bf16 terms at the fine and the coarse query's N (4096 rays
    # x 64 samples), f32 and bf16 cotangents
    V, H, W, C = 3, 128, 128, 64
    dt = torch.bfloat16
    times = {}
    for N in (4096 * 128, 4096 * 64):
        xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32), device=dev)
        g = torch.as_tensor(rs.normal(size=(V, N, C)).astype(np.float32), device=dev)
        for gt in g_dtypes:
            t = times[(N, str(gt)[6:])] = time_k1(k1, xy, g.to(gt), H, W, dt)
            print(f"K1 timing, uniform points (bf16 terms, 3x128x128x64, N={N}, cotangent "
                  f"{str(gt)[6:]}): {t['ms']:.4f} ms by events; passes (device) "
                  f"{ {k: round(v, 5) for k, v in t['passes'].items()} }; bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['n_bytes']} bytes, "
                  f"{t['n_ops']} flops)", flush=True)
        if N == 4096 * 128:
            plain_ms, library_ms = k1_yardsticks(k1, xy, g, H, W, dt, "uniform points")
    fine = times[(4096 * 128, "float32")]
    return {
        "name": "onehot_dmap", "route": "cuda",
        "source": "keypointnerf_torch/csrc/onehot_dmap.cu",
        "replaces": "keypointnerf_tpu/ops/pallas/onehot_dmap.py:109",
        "max_abs_err": max(errs), "ms": fine["ms"], "plain_ms": plain_ms,
        "bound_ms": fine["bound_ms"], "bound_by": fine["bound_by"],
        "library_ms": library_ms,
        "uniform_ms": {f"N={n} {d}": round(t["ms"], 5) for (n, d), t in times.items()},
    }


def cell_spread(xy, H, W) -> str:
    """How a point set falls on the map's cells: distinct base cells, points
    a touched cell (mean, largest), points clamped at the border."""
    from keypointnerf_torch.ops.feat_sample import bilinear_coords

    V, N, _ = xy.shape
    x0, y0, _, _ = bilinear_coords(xy, H, W)
    keys = (torch.arange(V, device=xy.device)[:, None] * H + y0) * W + x0
    counts = torch.bincount(keys.reshape(-1), minlength=V * H * W)
    touched = int((counts > 0).sum())
    clamped = int(((xy < -1.0) | (xy > 1.0)).any(dim=-1).sum())
    return (f"{touched} of {V * (H - 1) * (W - 1)} base cells touched, {V * N / touched:.1f} "
            f"points a touched cell (largest {int(counts.max())}), {clamped} of {V * N} "
            f"points clamped at the border")


def k1_at_step_points(dev, captured) -> dict:
    """K1 at the (xy, cotangent) of one zju step's two calls (coarse and
    fine query): the points' spread on the map, K1 against its plain
    version with the cotangent as the step hands it over and widened to
    f32, and K1's time on both. Returns the fine query's kernels-line
    numbers and the step's K1 time (the two launches summed)."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    out, errs, step_ms = {}, [], 0.0
    for (xy, g, H, W, dt), what in zip(sorted(captured, key=lambda c: c[0].shape[1]),
                                       ("coarse", "fine")):
        xy, g = xy.to(dev), g.to(dev)
        V, N, C = g.shape
        print(f"K1 at the zju step's {what} query (V={V}, N={N}, C={C}, {H}x{W} map, "
              f"terms {str(dt)[6:]}, cotangent {str(g.dtype)[6:]}): {cell_spread(xy, H, W)}",
              flush=True)
        gs = [g] if g.dtype == torch.float32 else [g, g.float()]
        for gg in gs:
            errs.append(check_k1(k1, xy, gg, H, W, dt, f"step {what}"))
            t = time_k1(k1, xy, gg, H, W, dt)
            print(f"K1 timing at the step's {what} query, cotangent {str(gg.dtype)[6:]}: "
                  f"{t['ms']:.4f} ms by events; passes (device) "
                  f"{ {k: round(v, 5) for k, v in t['passes'].items()} }; bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['n_bytes']} bytes)", flush=True)
            if gg is g:
                step_ms += t["ms"]
                if what == "fine":
                    plain_ms, library_ms = k1_yardsticks(k1, xy, g, H, W, dt, "the step's points")
                    out = {"ms": t["ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                           "plain_ms": plain_ms, "library_ms": library_ms}
    print(f"K1 a zju training step (coarse + fine launch, as the step runs them): "
          f"{step_ms:.4f} ms", flush=True)
    return dict(out, max_abs_err=max(errs), step_ms=step_ms)


GEO_DIMS1, GEO_DIMS2, GEO_SKIP = (168, 128, 128, 120, 64), (128, 64, 64, 2), (64, 8)


def seeded_geo_mlp(dev, seed=3, dims1=GEO_DIMS1, dims2=GEO_DIMS2):
    """A GeoFusionMLP (full width unless `dims1` / `dims2` say otherwise)
    with numpy-seeded weights (He-normal directions, gains around sqrt(2),
    small biases)."""
    from keypointnerf_torch.models.mlp import GeoFusionMLP

    rs = np.random.default_rng(seed)
    mlp = GeoFusionMLP(dims1, dims2, GEO_SKIP, (0, 2), dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if name.endswith("weight_g"):
                vals = math.sqrt(2.0) * (1.0 + 0.1 * rs.normal(size=p.shape))
            elif name.endswith("bias"):
                vals = 0.05 * rs.normal(size=p.shape)
            else:
                vals = rs.normal(0.0, math.sqrt(2.0 / p.shape[1]), p.shape)
            p.copy_(torch.as_tensor(vals, dtype=p.dtype))
    return mlp.to(dev)


def geo_mlp_inputs(dev, N, seed, V=3, K=24):
    """Query-shaped inputs: keypoints around z = 3, every point within ~0.3
    of some keypoint (so the Gaussian decay is not all zeros), random image
    features, ~30% of the (view, point) pairs masked."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    kpt = rs.normal(size=(V, K, 3)) * 0.4 + [0.0, 0.0, 3.0]
    pts = kpt[:, rs.integers(0, K, N)] + rs.normal(size=(V, N, 3)) * 0.15
    mask = (rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32)
    weight = mask / (mask.sum(0, keepdims=True) + 1e-6)
    return dict(pts_cam=f32(pts), kpt_cam=f32(kpt), f0=f32(rs.normal(size=(V, N, 64))),
                f1=f32(rs.normal(size=(V, N, 8))), mask=f32(mask), weight=f32(weight))


# A probe of what the library's accurate softplus100 (with its log1pf),
# expf, sinf and cosf cost at full occupancy, for comparison with K4 / K5's
# bound (which counts the kernel's own branch-free code instead): each
# function applied 64 times to 4 independent values a thread, each time
# followed by one FMA that keeps its argument in [-1, 1]; a baseline with
# the FMA alone is subtracted.
PROBE_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float softplus100(float x) {
  const float y = __fmul_rn(100.0f, x);
  return __fmul_rn(__fadd_rn(fmaxf(y, 0.0f), log1pf(expf(-fabsf(y)))), 0.01f);
}
template <int F> __device__ __forceinline__ float fn(float x) {
  if constexpr (F == 1) return softplus100(x);
  else if constexpr (F == 2) return expf(x);
  else if constexpr (F == 3) return sinf(x);
  else if constexpr (F == 4) return cosf(x);
  else return x;
}
template <int F> __global__ void __launch_bounds__(256) probe(const float* x, float* y, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = x[4 * i + j];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = fmaf(fn<F>(a[j]), 0.5f, -0.25f);
  }
  y[i] = a[0] + a[1] + a[2] + a[3];
}
extern "C" int probe_launch(int f, const float* x, float* y, int threads, int reps, void* s) {
  cudaStream_t st = static_cast<cudaStream_t>(s);
  const int blocks = threads / 256;
  switch (f) {
    case 0: probe<0><<<blocks, 256, 0, st>>>(x, y, reps); break;
    case 1: probe<1><<<blocks, 256, 0, st>>>(x, y, reps); break;
    case 2: probe<2><<<blocks, 256, 0, st>>>(x, y, reps); break;
    case 3: probe<3><<<blocks, 256, 0, st>>>(x, y, reps); break;
    default: probe<4><<<blocks, 256, 0, st>>>(x, y, reps); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_FUNCS = ("softplus100", "expf", "sinf", "cosf")


def build_probe(source):
    """nvcc a probe's source (a plain C interface) into build/kernels/,
    named by its hash, and load it with ctypes."""
    import ctypes
    import hashlib

    from keypointnerf_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(source.encode()).hexdigest()[:12]
    src, lib_path = BUILD_DIR / f"probe-{digest}.cu", BUILD_DIR / f"libprobe-{digest}.so"
    if not lib_path.exists():
        src.write_text(source)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


def library_function_times(dev) -> None:
    """Prints the seconds per evaluation, at full occupancy, of the
    library's softplus100, expf, sinf and cosf, and what they come to in
    f32 issue slots."""
    import ctypes

    lib = build_probe(PROBE_SRC)
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    threads, reps = 132 * 2048 * 4, 64
    x = torch.rand(4 * threads, device=dev) * 2.0 - 1.0
    y = torch.empty(threads, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(f):
        if lib.probe_launch(f, x.data_ptr(), y.data_ptr(), threads, reps, stream) != 0:
            raise SystemExit("the transcendental probe failed to launch")

    evals = 4 * threads * reps
    base = cuda_ms(lambda: run(0), iters=10)
    for f, name in enumerate(PROBE_FUNCS, start=1):
        t = (cuda_ms(lambda: run(f), iters=10) - base) * 1e-3 / evals
        print(f"probe of the library's {name}: {t:.4e} s per evaluation at full occupancy = "
              f"{t * F32_ISSUE_PER_S:.1f} f32 issue slots", flush=True)


def start_ptxas_report(name):
    """Starts `nvcc -Xptxas -v` on csrc/<name>.cu (a cubin beside the
    build, in parallel with it) for its kernels' registers and spills."""
    from keypointnerf_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
           str(BUILD_DIR / f"{name}-ptxas.cubin"), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def print_ptxas_report(proc) -> None:
    """Prints ptxas's registers and spill bytes of the K4 / K5 kernels and
    its warnings that wgmma instructions were serialized."""
    import re

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc -Xptxas -v failed:\n{log}")
    names = {"geo_mlp_wgmmaILb0": "K4 bf16 (geo_mlp_wgmma<false>)",
             "geo_mlp_wgmmaILb1": "K5 bf16 (geo_mlp_wgmma<true>)",
             "geo_mlp_f32ILi32ELb0": "K4 f32 (geo_mlp_f32)", "geo_mlp_f32ILi32ELb1": "K5 f32"}
    fn, spills = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = next((v for k, v in names.items() if k in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)} / {m.group(2)} bytes of spill stores / loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            print(f"ptxas: {fn}: {m.group(1)} registers, {spills}", flush=True)
        if "C7512" in line:
            print("ptxas: " + line.split("ptxas info    : ")[-1][:160], flush=True)


def check_exact_replicas(dev) -> None:
    """The bf16 K4 / K5 kernel computes softplus100's log1pf and the
    encoding's sinf / cosf with branch-free copies of the library's code:
    each held against the library function bit for bit, log1pf on every
    float in [0, 1], sinf and cosf on every float of magnitude below their
    fast-reduction limit."""
    import ctypes

    from keypointnerf_torch.ops._build import load

    lib = load("fused_geo_mlp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for fn, what in ((lib.kpn_log1pf_check, "log1pf on [0, 1]"),
                     (lib.kpn_trig_check, "sinf and cosf on |x| < 105615")):
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        if fn(count.data_ptr(), stream) != 0:
            raise SystemExit(f"the check of {what} failed to launch")
        bad = int(count.item())
        print(f"branch-free copy of {what}: {bad} results differ from the library's "
              f"(bound 0) {'ok' if bad == 0 else 'FAIL'}", flush=True)
        if bad:
            raise SystemExit(f"the kernel's copy of {what} is not the library's")


# SASS opcodes that move data or steer control: not counted as the
# function's operations; and those of the MUFU / conversion pipe
SASS_NOT_WORK = {"LDC", "ULDC", "LDG", "STG", "LDS", "STS", "EXIT", "BRA", "NOP", "CALL", "RET",
                 "S2R", "S2UR", "BSSY", "BSYNC"}
SASS_MUFU_CONV = {"MUFU", "F2F", "F2FP", "F2I", "I2F"}


def sass_counts(lib_path, names) -> dict:
    """{name: (operations, of them MUFU / conversions, branches and calls)}
    of each named kernel in a built library, from `cuobjdump -sass`: its
    instructions up to the first unconditional EXIT (the path a call takes
    when no slow path is needed; a slow path's subroutine lies past the
    EXIT), less loads, stores and control."""
    import re

    from keypointnerf_torch.ops._build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for part in text.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if name not in names:
            continue
        work = mufu_conv = branches = 0
        for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", part):
            tokens = ins.split()
            predicated = tokens[0].startswith("@")
            op = tokens[1 if predicated else 0].split(".")[0]
            if op == "EXIT" and not predicated:
                break
            branches += op in ("BRA", "CALL")
            if op in SASS_NOT_WORK:
                continue
            work += 1
            mufu_conv += op in SASS_MUFU_CONV
        counts[name] = (work, mufu_conv, branches)
    missing = set(names) - set(counts)
    if missing:
        raise SystemExit(f"no SASS for {sorted(missing)} in {lib_path}")
    return counts


def geo_mlp_op_counts() -> dict:
    """The instructions of the bf16 K4 / K5 kernel's per-value work as nvcc
    compiled it: {"act": (operations, MUFU / conversions) per softplus100
    value of an epilogue (bias, softplus100 with the branch-free log1pf,
    its half of a bf16 pair), "enc": the same per (view, point, keypoint)
    of K5's encoding (differences, the division, expf, 3 sin / cos pairs
    from one argument reduction each, products by the decay, bf16 pairs)},
    read from the library's `kpn_count_act_pair` and
    `kpn_count_encoding_pair`, each of which does the work for two."""
    from keypointnerf_torch.ops._build import library_path, load

    load("fused_geo_mlp")
    c = sass_counts(library_path("fused_geo_mlp"),
                    ("kpn_count_act_pair", "kpn_count_encoding_pair"))
    out = {"act": c["kpn_count_act_pair"], "enc": c["kpn_count_encoding_pair"]}
    for key, (work, conv, branches) in out.items():
        print(f"K4 / K5 {key} work on a pair of values, SASS: {work} operations, of them "
              f"{conv} on the MUFU / conversion pipe; {branches} branches or calls",
              flush=True)
    return {k: (w / 2, m / 2) for k, (w, m, _) in out.items()}


def geo_mlp_bound(N, V, K, with_enc, ops, n_bytes) -> dict:
    """The least time of one K4 / K5 call at the zju widths: the largest of
    its bytes at the HBM rate, its products at the bf16 tensor rate, its
    f32 work at the f32 issue rate (every instruction of the code the
    kernel runs for each value, `geo_mlp_op_counts`, plus the plain
    operations) and the part of it on the MUFU / conversion pipe at that
    pipe's rate."""
    d = dict(zip(("dsp", "h1", "h2", "h3", "dl"), GEO_DIMS1))
    g0, g1, g2, do = GEO_DIMS2
    c0, c1 = GEO_SKIP
    per_vp = (d["dsp"] + c0) * d["h1"] + d["h1"] * d["h2"] + (d["h2"] + c1) * d["h3"] \
        + d["h3"] * d["dl"]
    mm_flops = 2 * N * (V * per_vp + g0 * g1 + g1 * g2 + g2 * do)
    n_soft = N * (V * (d["h1"] + d["h2"] + d["h3"]) + g1 + g2)
    triples = V * N * K if with_enc else 0
    # dot operands rounded to bf16 outside the epilogues, two to an
    # instruction: the layer-0 inputs read (K4: sp and f0; K5: f0), f1 and
    # the pooled [mean | var]
    packs = (V * N * ((0 if with_enc else d["dsp"]) + c0 + c1) + 2 * N * d["dl"]) / 2
    # plain f32 operations: the latent's bias and the pool (mean: a product
    # and a sum; var: a difference, two products, a sum) per (view, point,
    # latent channel), the mask sum, the output's bias
    plain = 7 * V * N * d["dl"] + V * N + N * do
    issue = n_soft * ops["act"][0] + triples * ops["enc"][0] + packs + plain
    conv = n_soft * ops["act"][1] + triples * ops["enc"][1] + packs
    t = {
        "bytes": n_bytes / HBM_BYTES_PER_S,
        "products": mm_flops / BF16_FLOPS_PER_S,
        "f32 issue": issue / F32_ISSUE_PER_S,
        "MUFU / conversions": conv / MUFU_PER_S,
    }
    by = max(t, key=t.get)
    return dict(bound_ms=t[by] * 1e3, bound_by="bytes" if by == "bytes" else "operations",
                binds=by, t_ms={k: v * 1e3 for k, v in t.items()}, mm_flops=mm_flops,
                n_soft=n_soft, triples=triples, n_bytes=n_bytes, issue=issue, conv=conv)


def check_fused_geo_mlp(dev) -> dict:
    """K4 and K5 against their plain versions; returns their kernels-line
    entries. Tolerances, as a share of each output's largest entry. With
    f32 products only the order of the sums and the last bits of sin / cos
    / exp differ: measured 5.3e-7 worst and 2.9e-8 mean for K5 (K4, whose
    FMA order is the library product's, is bit-equal), pinned at 5e-6 and
    2e-7. With bf16 products an f32 activation near a bf16 rounding
    boundary now and then rounds the other way before the next product and
    the flip spreads: measured 1.8e-3 worst and 8.5e-8 mean (K5; K4
    bit-equal), pinned at 5e-3 and 1e-6. K5 in bf16 is held at the zju
    training step's coarse and fine query sizes too: measured 2.5e-3 and
    2.4e-3 worst, 6.9e-8 and 5.1e-8 mean, inside the same bounds."""
    from keypointnerf_torch.models.spatial_encoding import SpatialEncodingConfig, spatial_encode
    from keypointnerf_torch.ops import fused_geo_mlp as fg

    mlp = seeded_geo_mlp(dev)
    with torch.no_grad():
        ws = [w.clone() for w in fg.fold_weight_norm(mlp)]
    V, K, L = 3, 24, 3
    names = ("out", "valid", "latent_view", "latent_fused")
    entries, train_ms, train_bound = {}, {}, {}
    library_function_times(dev)
    ops = geo_mlp_op_counts()
    check_exact_replicas(dev)
    bf16_case, f32_case = (torch.bfloat16, 5e-3, 1e-6), (torch.float32, 5e-6, 2e-7)
    # the render query's shape (2048 rays x 64 samples) and a ragged N, both
    # kernels and both product types; then the shapes the zju step gives K5
    # (4096 rays x 64 coarse and x 128 fine samples, bf16 products)
    for N, train_shape in ((2048 * 64, False), (100_003, False),
                           (4096 * 64, True), (4096 * 128, True)):
        x = geo_mlp_inputs(dev, N, seed=N)
        rest = (x["f0"], x["f1"], x["mask"], x["weight"])
        variants = {"sp_fused_geo_mlp": (fg.sp_geo_mlp_apply, fg.sp_mlp_stack_plain,
                                         (x["pts_cam"], x["kpt_cam"]))}
        if not train_shape:
            sp = fg.rel_z_decay_encoding(x["pts_cam"], x["kpt_cam"], L, 0.1, 1.0)
            variants["fused_geo_mlp"] = (fg.geo_mlp_apply, fg.mlp_stack_plain, (sp,))
        for kname, (apply, plain, lead) in sorted(variants.items()):
            for dt, worst_tol, mean_tol in ((bf16_case,) if train_shape
                                            else (bf16_case, f32_case)):
                with torch.no_grad():
                    got = apply(ws, *lead, *rest, compute_dtype=dt)
                    ref = plain(*lead, *rest, ws, compute_dtype=dt)
                torch.cuda.synchronize()
                worst = mean = abs_err = 0.0
                for name, a, b in zip(names, ref, got):
                    if a.shape != b.shape or b.dtype != torch.float32:
                        raise SystemExit(f"{kname} {name}: shape or dtype differs")
                    if name == "valid":
                        if not torch.equal(a, b):
                            raise SystemExit(f"{kname}: valid differs from the plain version")
                        continue
                    if not bool((torch.isfinite(a) & torch.isfinite(b)).all()):
                        raise SystemExit(f"{kname} {name}: not finite")
                    scale = a.abs().max().item()
                    worst = max(worst, (a - b).abs().max().item() / scale)
                    mean = max(mean, (a - b).abs().mean().item() / scale)
                    abs_err = max(abs_err, (a - b).abs().max().item())
                ok = worst <= worst_tol and mean <= mean_tol
                print(f"{kname} V={V} N={N} {str(dt)[6:]}: worst error {worst:.3e} of an "
                      f"output's max (bound {worst_tol}), mean {mean:.3e} (bound {mean_tol}), "
                      f"valid exact {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit(f"{kname} disagrees with its plain version")
                if N == 2048 * 64 and dt == torch.bfloat16:
                    entries[kname] = dict(lead=lead, rest=rest, max_abs_err=abs_err,
                                          apply=apply, plain=plain)
                if train_shape:
                    # the training step's query shapes: the kernel's time
                    with torch.no_grad():
                        train_ms[N] = cuda_ms(lambda: apply(ws, *lead, *rest, compute_dtype=dt),
                                              iters=10)
                    nb = 4 * (sum(t.numel() for t in (*lead, *rest)) + sum(w.numel() for w in ws)
                              + N * (V * GEO_DIMS1[4] + 2 * GEO_DIMS1[4] + GEO_DIMS2[3] + 1))
                    train_bound[N] = geo_mlp_bound(N, V, K, True, ops, nb)
                    b = train_bound[N]
                    print(f"{kname} timing (bf16 products, V={V}, N={N}, the training step's "
                          f"query): kernel {train_ms[N]:.4f} ms, bound {b['bound_ms']:.4f} ms "
                          f"({b['binds']}; bytes {b['t_ms']['bytes']:.4f} ms)", flush=True)

    # gradients: kernel forward and recompute backward against autograd
    # straight through the plain version, f32, a loss that is not linear
    # in the outputs (so the cotangents carry the kernel's forward values)
    x = geo_mlp_inputs(dev, 5000, seed=11)
    sp = fg.rel_z_decay_encoding(x["pts_cam"], x["kpt_cam"], L, 0.1, 1.0)
    for kname, keys in (("fused_geo_mlp", ("sp", "f0", "f1")),
                        ("sp_fused_geo_mlp", ("pts_cam", "kpt_cam", "f0", "f1"))):
        res = []
        for through_kernel in (True, False):
            ins = dict(x, sp=sp)
            ins.update({k: ins[k].clone().requires_grad_(True) for k in keys})
            wl = [w.clone().requires_grad_(True) for w in ws]
            lead = (ins["sp"],) if kname == "fused_geo_mlp" else (ins["pts_cam"], ins["kpt_cam"])
            rest = (ins["f0"], ins["f1"], ins["mask"], ins["weight"])
            if through_kernel:
                apply = fg.geo_mlp_apply if kname == "fused_geo_mlp" else fg.sp_geo_mlp_apply
                out, _, lv, lf = apply(wl, *lead, *rest)
            else:
                plain = fg.mlp_stack_plain if kname == "fused_geo_mlp" else fg.sp_mlp_stack_plain
                out, _, lv, lf = plain(*lead, *rest, wl)
            loss = (out ** 2).mean() + (lv ** 2).mean() + (lf ** 2).mean()
            res.append(torch.autograd.grad(loss, [ins[k] for k in keys] + wl))
        if not all(bool(torch.isfinite(a).all()) for a in res[0]):
            raise SystemExit(f"{kname}: a gradient is not finite")
        worst = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*res))
        print(f"{kname} gradients (kernel forward + recompute backward vs autograd through "
              f"the plain version, f32, N=5000): worst {worst:.3e} of a leaf's max "
              f"(bound 1e-4)", flush=True)
        if not worst <= 1e-4:
            raise SystemExit(f"{kname}: gradients disagree with the plain version's")

    # times at the render query's shape, bf16; the module path is what the
    # kernels replace in query_points: spatial_encode + GeoFusionMLP.forward
    N = 2048 * 64
    x = geo_mlp_inputs(dev, N, seed=N)
    enc = SpatialEncodingConfig()
    bf = torch.bfloat16

    def module_path(with_encoding):
        with torch.no_grad():
            s = (spatial_encode(enc, None, x["pts_cam"], None, x["kpt_cam"])
                 if with_encoding else sp_big)
            return mlp(s.to(bf), [x["f0"].to(bf), x["f1"].to(bf)], x["mask"].to(bf),
                       x["weight"].to(bf))

    sp_big = entries["fused_geo_mlp"]["lead"][0]
    result = {}
    for kname, with_enc in (("fused_geo_mlp", False), ("sp_fused_geo_mlp", True)):
        e = entries[kname]
        lead, rest, apply, plain = e["lead"], e["rest"], e["apply"], e["plain"]
        with torch.no_grad():
            ms = cuda_ms(lambda: apply(ws, *lead, *rest, compute_dtype=bf), iters=20)
            plain_ms = cuda_ms(lambda: plain(*lead, *rest, ws, compute_dtype=bf), iters=5,
                               warmup=2)
            module_ms = cuda_ms(lambda: module_path(with_enc), iters=5, warmup=2)
            f32_ms = cuda_ms(lambda: apply(ws, *lead, *rest, compute_dtype=torch.float32),
                             iters=5, warmup=2)
            if with_enc:
                # a bf16 call is two launches: the weights' repack into the
                # layout wgmma reads (every call: they change each training
                # step) and the kernel; the profile shows each one's time
                print("one sp_fused_geo_mlp call, bf16 products:", flush=True)
                profile_kernels(lambda: apply(ws, *lead, *rest, compute_dtype=bf), 4)
        in_bytes = 4 * (sum(t.numel() for t in lead) + sum(t.numel() for t in rest))
        out_bytes = 4 * N * (V * GEO_DIMS1[4] + 2 * GEO_DIMS1[4] + GEO_DIMS2[3] + 1)
        n_bytes = in_bytes + 4 * sum(w.numel() for w in ws) + out_bytes
        b = geo_mlp_bound(N, V, K, with_enc, ops, n_bytes)
        line = 164 if kname == "fused_geo_mlp" else 374
        result[kname] = {
            "name": kname, "route": "cuda",
            "source": "keypointnerf_torch/csrc/fused_geo_mlp.cu",
            "replaces": f"keypointnerf_tpu/ops/pallas/fused_geo_mlp.py:{line}",
            "max_abs_err": e["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "module_path_ms": module_ms, "f32_ms": f32_ms,
        }
        if with_enc:
            result[kname]["train_ms"] = {str(n): t for n, t in train_ms.items()}
            result[kname]["train_bound_ms"] = {str(n): tb["bound_ms"]
                                               for n, tb in train_bound.items()}
        t = b["t_ms"]
        print(f"{kname} timing (bf16 products, V={V}, N={N}, K={K}): kernel {ms:.4f} ms "
              f"(f32 products {f32_ms:.4f} ms), plain {plain_ms:.4f} ms, module path "
              f"({'spatial_encode + ' if with_enc else ''}GeoFusionMLP.forward, bf16, no_grad) "
              f"{module_ms:.4f} ms, bound {b['bound_ms']:.4f} ms, bound by {b['binds']} "
              f"(bytes {n_bytes} = {t['bytes']:.4f} ms; {b['mm_flops']} product flops at the "
              f"bf16 tensor rate = {t['products']:.4f} ms; {b['issue']:.0f} instructions at "
              f"the f32 issue rate = {t['f32 issue']:.4f} ms: {b['n_soft']} softplus100 at "
              f"{ops['act'][0]} and {b['triples']} encodings at {ops['enc'][0]}, plus "
              f"bf16 rounding of inputs and plain operations; {b['conv']:.0f} of them on the "
              f"MUFU / conversion pipe = {t['MUFU / conversions']:.4f} ms); no single "
              f"PyTorch call computes this function (library_ms null)", flush=True)
    return result


# A width set the wgmma kernel refuses: layer widths 96, 96, 80, 48 | 48, 48,
# 5 views, K5 with 16 keypoints and 2 levels (an 80-wide encoding, K4's sp
# too). K4 and K5 take the wmma route there, held at the bf16 bounds above
# (worst 5e-3, mean 1e-6 of an output's max) and, through the Function in
# bf16 with the quadratic loss, the gradients at 1e-2 of a leaf's max (the
# cotangents carry the forward's bf16 flips; the bf16 bound of
# tests/test_torch_fused_geo_mlp.py's card test).
WMMA_DIMS1, WMMA_DIMS2, WMMA_VKL = (80, 96, 96, 80, 48), (96, 48, 48, 2), (5, 16, 2)


def check_geo_mlp_wmma(dev) -> None:
    """K4 and K5 on the wmma route against their plain versions."""
    from keypointnerf_torch.ops import fused_geo_mlp as fg

    V, K, L = WMMA_VKL
    bf = torch.bfloat16
    mlp = seeded_geo_mlp(dev, seed=5, dims1=WMMA_DIMS1, dims2=WMMA_DIMS2)
    with torch.no_grad():
        ws = [w.clone() for w in fg.fold_weight_norm(mlp)]
    names = ("out", "valid", "latent_view", "latent_fused")

    def variants(x, sp):
        return (("fused_geo_mlp", fg.geo_mlp_apply, fg.mlp_stack_plain, (sp,), {}),
                ("sp_fused_geo_mlp", fg.sp_geo_mlp_apply, fg.sp_mlp_stack_plain,
                 (x["pts_cam"], x["kpt_cam"]), dict(sp_level=L)))

    for N in (2048 * 64, 100_003):
        x = geo_mlp_inputs(dev, N, seed=N + 1, V=V, K=K)
        rest = (x["f0"], x["f1"], x["mask"], x["weight"])
        sp = fg.rel_z_decay_encoding(x["pts_cam"], x["kpt_cam"], L, 0.1, 1.0)
        for kname, apply, plain, lead, kw in variants(x, sp):
            before = dict(apply.launches_by_route)
            with torch.no_grad():
                got = apply(ws, *lead, *rest, compute_dtype=bf, **kw)
                ref = plain(*lead, *rest, ws, compute_dtype=bf, **kw)
            torch.cuda.synchronize()
            took = {r: apply.launches_by_route[r] - before[r] for r in before}
            if took != {"wgmma": 0, "wmma": 1, "f32": 0}:
                raise SystemExit(f"{kname} at V={V}, widths {WMMA_DIMS1}: routes {took}, "
                                 f"not one wmma launch")
            worst = mean = 0.0
            for name, a, b in zip(names, ref, got):
                if a.shape != b.shape or not bool(torch.isfinite(b).all()):
                    raise SystemExit(f"{kname} (wmma) {name}: shape differs or not finite")
                if name == "valid":
                    if not torch.equal(a, b):
                        raise SystemExit(f"{kname} (wmma): valid differs")
                    continue
                scale = a.abs().max().item()
                worst = max(worst, (a - b).abs().max().item() / scale)
                mean = max(mean, (a - b).abs().mean().item() / scale)
            ok = worst <= 5e-3 and mean <= 1e-6
            print(f"{kname} wmma route V={V} K={K} L={L} widths {WMMA_DIMS1[1:]} | "
                  f"{WMMA_DIMS2[1:]} N={N} bf16: worst error {worst:.3e} of an output's max "
                  f"(bound 5e-3), mean {mean:.3e} (bound 1e-6), valid exact, launches by "
                  f"route {took} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"{kname} (wmma route) disagrees with its plain version")
            if N == 2048 * 64:
                with torch.no_grad():
                    ms = cuda_ms(lambda: apply(ws, *lead, *rest, compute_dtype=bf, **kw),
                                 iters=10)
                print(f"{kname} wmma route timing (V={V}, N={N}): {ms:.4f} ms a call by CUDA "
                      f"events", flush=True)

    x = geo_mlp_inputs(dev, 5000, seed=12, V=V, K=K)
    sp = fg.rel_z_decay_encoding(x["pts_cam"], x["kpt_cam"], L, 0.1, 1.0)
    for kname, apply, plain, lead, kw in variants(x, sp):
        res = []
        for through_kernel in (True, False):
            lead_g = [t.clone().requires_grad_(True) for t in lead]
            f0 = x["f0"].clone().requires_grad_(True)
            wl = [w.clone().requires_grad_(True) for w in ws]
            rest = (f0, x["f1"], x["mask"], x["weight"])
            if through_kernel:
                out, _, lv, lf = apply(wl, *lead_g, *rest, compute_dtype=bf, **kw)
            else:
                out, _, lv, lf = plain(*lead_g, *rest, wl, compute_dtype=bf, **kw)
            loss = (out ** 2).mean() + (lv ** 2).mean() + (lf ** 2).mean()
            res.append(torch.autograd.grad(loss, [*lead_g, f0, *wl]))
        if not all(bool(torch.isfinite(a).all()) for a in res[0]):
            raise SystemExit(f"{kname} (wmma): a gradient is not finite")
        worst = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*res))
        print(f"{kname} wmma route gradients (kernel forward + recompute backward vs autograd "
              f"through the plain version, bf16, N=5000): worst {worst:.3e} of a leaf's max "
              f"(bound 1e-2)", flush=True)
        if not worst <= 1e-2:
            raise SystemExit(f"{kname} (wmma route): gradients disagree")
    print(f"launches by route: K4 {fg.geo_mlp_apply.launches_by_route}, K5 "
          f"{fg.sp_geo_mlp_apply.launches_by_route}", flush=True)


def earlier_dot_f32(x, w, dtype):
    """dot_f32 before the f32 sum was kept: the bf16 product's f32 sum
    rounded to bf16, then upcast (timed for comparison only)."""
    return F.linear(x.to(dtype), w.to(dtype)).float()


def check_dot_f32(dev) -> None:
    """The two forms models/mlp.py:dot_f32 runs in bf16 on the card (with
    autograd: the f32 product of the bf16-rounded operands; without:
    torch.mm with out_dtype=float32), each against an f64 product of the
    same bf16 operands, and their times beside the earlier form's."""
    from keypointnerf_torch.models.mlp import dot_f32

    rs = np.random.default_rng(2)
    x = torch.as_tensor(rs.normal(size=(786_432, 168)).astype(np.float32), device=dev)
    w = torch.as_tensor(rs.normal(size=(128, 168)).astype(np.float32) * 0.1, device=dev)
    wg = w.clone().requires_grad_(True)
    ref = x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double().T
    scale = ref.abs().max().item()
    with torch.no_grad():
        infer = dot_f32(x, w, torch.bfloat16)
        infer_ms = cuda_ms(lambda: dot_f32(x, w, torch.bfloat16), iters=20)
    train = dot_f32(x, wg, torch.bfloat16)
    train_ms = cuda_ms(lambda: dot_f32(x, wg, torch.bfloat16), iters=20)
    old_ms = cuda_ms(lambda: earlier_dot_f32(x, w, torch.bfloat16), iters=20)
    errs = [(t.detach().double() - ref).abs().max().item() / scale for t in (infer, train)]
    print(f"dot_f32, bf16 ({tuple(x.shape)} x {tuple(w.T.shape)}): inference form "
          f"torch.mm(out_dtype=float32) {infer_ms:.4f} ms, max error {errs[0]:.3e} of scale; "
          f"autograd form F.linear on f32 upcasts {train_ms:.4f} ms, {errs[1]:.3e}; "
          f"(earlier bf16-sum form {old_ms:.4f} ms); errors against an f64 product of the "
          f"same bf16 operands (bound 1e-5)", flush=True)
    if not max(errs) <= 1e-5:
        raise SystemExit("dot_f32 does not keep the f32 sum")


def orbit_camera(ang):
    from keypointnerf_torch.data import look_at

    eye = 3.5 * np.array([np.cos(ang), 0.05, np.sin(ang)])
    return look_at(eye, np.zeros(3))


def profile_kernels(fn, top):
    """Run fn() under the profiler; print and return the device time (ms)
    of its CUDA kernels (an aten op's device time is its kernels' again)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    total = sum(device_us(e) for e in events) / 1e3
    print(f"profile: device time {total:.3f} ms in {sum(e.count for e in events)} kernel "
          f"launches", flush=True)
    for e in sorted(events, key=lambda e: -device_us(e))[:top]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)
    return total


def render_full_width(dev):
    """The strict 512² camera with the flag off; returns K2's launch count
    and what the flag-on render reuses (model, batch, image)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.render import render_image

    size, chunk = 512, 2048
    cfg = strict_preset(KeypointNeRFConfig())
    sample = make_sample(SyntheticConfig(image_size=size, n_views=4), seed=0)
    R, t = orbit_camera(0.0)
    sample = dict(sample, tar_R=R, tar_t=t)
    vb = ViewBatch.from_numpy(sample, device=dev)
    t0 = time.perf_counter()
    model = KeypointNeRF(cfg, device=dev, seed=0)
    # seeded random weights give negative radiance at every point of this
    # scene (an all-zero image); raise the radiance bias so the render is
    # nonzero and its values exercise every lookup
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0
    print(f"model built in {time.perf_counter() - t0:.2f} s; "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)

    feats = model.encode(vb.src_images, vb.src_masks)
    render = lambda: render_image(model, vb, height=size, width=size, chunk=chunk)  # noqa: E731
    t0 = time.perf_counter()
    render()                                              # warm-up
    torch.cuda.synchronize()
    print(f"warm-up render {time.perf_counter() - t0:.3f} s", flush=True)

    k2.launches = 0                                       # counts of this render only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"onehot_bilinear": k2.launches}

    # the same render with dot_f32's earlier form (the bf16 product's f32
    # sum rounded to bf16 before the upcast), then the current one again
    import keypointnerf_torch.models.ibr_head as ibr_mod
    import keypointnerf_torch.models.mlp as mlp_mod

    current = mlp_mod.dot_f32
    timed = {}
    for name, fn in (("earlier", earlier_dot_f32), ("current", current)):
        mlp_mod.dot_f32 = ibr_mod.dot_f32 = fn
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t1
    mlp_mod.dot_f32 = ibr_mod.dot_f32 = current
    size2 = size * size
    print(f"dot_f32 forms, same render: earlier bf16-sum product {timed['earlier']:.4f} s = "
          f"{size2 / timed['earlier']:.1f} rays/s; current (f32 sum, torch.mm out_dtype) "
          f"{timed['current']:.4f} s = {size2 / timed['current']:.1f} rays/s", flush=True)

    n_rays = size * size
    marched = max(1, min(n_rays, -int(-n_rays * cfg.cull_empty_rays_ratio // 1)))
    expected = 2 * math.ceil(marched / chunk)             # coarse + fine query per chunk
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise SystemExit(f"render output {k} is not finite")
    overflow = float(out["cull_overflow"].max())
    acc = out["acc_fine"]
    print(f"render 512² strict bf16: {seconds:.4f} s, {n_rays / seconds:.1f} rays/s; "
          f"cull_overflow={overflow}; marched {marched} rays in {math.ceil(marched / chunk)} "
          f"chunks; K2 launches {launches['onehot_bilinear']} (expected {expected}); "
          f"rgb_fine {tuple(out['rgb_fine'].shape)} mean {out['rgb_fine'].float().mean().item():.6f}; "
          f"acc_fine>0 rays {int((acc > 0).sum())}", flush=True)
    if overflow != 0.0:
        raise SystemExit("empty-ray cull budget exceeded: cull_overflow != 0")
    if launches["onehot_bilinear"] != expected or expected == 0:
        raise SystemExit("K2 launch count differs from the main path's query count")
    if out["rgb_fine"].shape != (size, size, 3):
        raise SystemExit(f"unexpected rgb_fine shape {tuple(out['rgb_fine'].shape)}")

    # the cull is exact on the card too: bit-equal to marching every ray
    full_model = KeypointNeRF(dataclasses.replace(cfg, cull_empty_rays_ratio=1.0),
                              device=dev, seed=0)
    full_model.load_state_dict(model.state_dict())
    culled = render_image(model, vb, height=size, width=size, chunk=chunk, feats=feats)
    full = render_image(full_model, vb, height=size, width=size, chunk=chunk, feats=feats)
    differ = [k for k in full if not torch.equal(full[k], culled[k])]
    print(f"culled vs unculled 512² render: {'bit-equal' if not differ else 'DIFFER ' + str(differ)}",
          flush=True)
    if differ:
        raise SystemExit("the culled render differs from the unculled render")

    # where the render's device time goes
    print(f"one render, flag off (wall {seconds * 1e3:.3f} ms):", flush=True)
    profile_kernels(render, 12)
    return launches, dict(cfg=cfg, model=model, vb=vb, out=out, seconds=seconds,
                          size=size, chunk=chunk, expected=expected)


# The flag-on render against the flag-off one. The two bf16 programs round
# `pw` and the encoding at other places (the module casts them to bf16, the
# kernel builds them in f32 and rounds at the dot) and take sin / cos of each
# level directly rather than by the double-angle recursion. A ray's opacity
# is a step function of its last sample's radiance (the compositing's 1e10
# tail interval turns any positive radiance there into alpha 1), so with
# random weights a few rays flip whole between the two programs: the bound
# is on each output's mean deviation and on the share of its entries that
# deviate by more than 1%, both as shares of the output's largest entry.
# The bounds are each render's own: (mean, share), measured and doubled.
K5_RENDER_BOUNDS = (3e-4, 4e-4)      # 512² K5: measured 1.15e-4, 1.64e-4 (acc_fine)
K4_RENDER_BOUNDS = (1.5e-4, 6e-5)    # 256² rel_z K4: 6.89e-5 (acc_fine), 2.54e-5 (rgb_fine)


def compare_renders(ref, got, what, bounds):
    """Every output of `got` finite and within `bounds` (mean, share) of `ref`.
    depth and sdf are ratios of two near-zero sums on rays that hit almost
    nothing, where rounding alone moves them by their whole range: their
    numerators x (acc + 1e-8) are held instead."""
    worst_mean = worst_share = 0.0
    rows = []
    for k, a in ref.items():
        b = got[k]
        if not bool(torch.isfinite(b).all()):
            raise SystemExit(f"{what}: output {k} is not finite")
        if k == "cull_overflow":
            continue
        a, b = a.float(), b.float()
        if k.startswith(("sdf_", "depth_")):
            acc = "acc_" + k.split("_")[1]
            a = a * (ref[acc].float().reshape(a.shape) + 1e-8)
            b = b * (got[acc].float().reshape(b.shape) + 1e-8)
        scale = a.abs().max().clamp(min=1e-12)
        dev = (a - b).abs() / scale
        mean, share = dev.mean().item(), (dev > 0.01).float().mean().item()
        rows.append(f"{k} mean {mean:.3e}, {share:.3e} of entries off by > 1%, worst "
                    f"{dev.max().item():.3e}")
        worst_mean, worst_share = max(worst_mean, mean), max(worst_share, share)
    print(f"{what}, deviation as a share of each output's max: {'; '.join(rows)}; worst mean "
          f"{worst_mean:.3e} (bound {bounds[0]}), worst share {worst_share:.3e} (bound "
          f"{bounds[1]}); depth and sdf as their numerators", flush=True)
    if not (worst_mean <= bounds[0] and worst_share <= bounds[1]):
        raise SystemExit(f"{what}: the flag-on render deviates from the flag-off render")


def render_fused(dev, ctx) -> dict:
    """The same 512² strict camera with use_pallas_geo_mlp (K5 + K2 + the
    cull); returns the launch counts of the timed render."""
    from keypointnerf_torch.models import KeypointNeRF
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.ops import geo_mlp_apply as k4
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.render import render_image

    size, chunk, vb = ctx["size"], ctx["chunk"], ctx["vb"]
    model = KeypointNeRF(dataclasses.replace(ctx["cfg"], use_pallas_geo_mlp=True),
                         device=dev, seed=0)
    model.load_state_dict(ctx["model"].state_dict())
    render = lambda: render_image(model, vb, height=size, width=size, chunk=chunk)  # noqa: E731
    render()                                              # warm-up
    torch.cuda.synchronize()
    k2.launches = k4.launches = k5.launches = 0           # counts of this render only
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"sp_fused_geo_mlp": k5.launches, "onehot_bilinear": k2.launches,
                "fused_geo_mlp": k4.launches}
    # flag off, on, on, off within this call
    times = {"off": [ctx["seconds"]], "on": [seconds]}
    off_render = lambda: render_image(ctx["model"], vb, height=size, width=size,  # noqa: E731
                                      chunk=chunk)
    for name, fn in (("on", render), ("off", off_render)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t1)
    n_rays = size * size
    overflow = float(out["cull_overflow"].max())
    print(f"render 512² strict bf16, use_pallas_geo_mlp: {seconds:.4f} s, "
          f"{n_rays / seconds:.1f} rays/s; cull_overflow={overflow}; K5 launches "
          f"{launches['sp_fused_geo_mlp']} (expected {ctx['expected']}), K2 "
          f"{launches['onehot_bilinear']}, K4 {launches['fused_geo_mlp']}; wall clock "
          f"flag off {[round(t, 4) for t in times['off']]} s, flag on "
          f"{[round(t, 4) for t in times['on']]} s", flush=True)
    if overflow != 0.0:
        raise SystemExit("empty-ray cull budget exceeded with the flag on")
    if launches["sp_fused_geo_mlp"] != ctx["expected"] or launches["fused_geo_mlp"] != 0 \
            or launches["onehot_bilinear"] != ctx["expected"]:
        raise SystemExit("K5 / K2 must each run once per query of the flag-on render")
    compare_renders(ctx["out"], out, "512² render, K5 on vs off", K5_RENDER_BOUNDS)
    print("one render, flag on:", flush=True)
    profile_kernels(render, 8)
    return launches


def render_rel_z(dev) -> int:
    """K4 on a path: a 256² strict camera with sp_type rel_z, flag on, held
    against the same camera with the flag off; returns K4's launches."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset
    from keypointnerf_torch.ops import geo_mlp_apply as k4
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.render import render_image

    size, chunk = 256, 2048
    cfg = strict_preset(KeypointNeRFConfig(sp_type="rel_z"))
    sample = make_sample(SyntheticConfig(image_size=size, n_views=4), seed=0)
    R, t = orbit_camera(0.0)
    vb = ViewBatch.from_numpy(dict(sample, tar_R=R, tar_t=t), device=dev)
    outs = {}
    for flag in (False, True):
        model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=flag),
                             device=dev, seed=0)
        model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0
        k4.launches = k5.launches = 0
        outs[flag] = render_image(model, vb, height=size, width=size, chunk=chunk)
        torch.cuda.synchronize()
    launches = k4.launches
    n_rays = size * size
    marched = max(1, min(n_rays, -int(-n_rays * cfg.cull_empty_rays_ratio // 1)))
    expected = 2 * math.ceil(marched / chunk)
    overflow = float(outs[True]["cull_overflow"].max())
    print(f"render 256² strict bf16, sp_type rel_z, use_pallas_geo_mlp: K4 launches "
          f"{launches} (expected {expected}), K5 {k5.launches}; cull_overflow={overflow}; "
          f"acc_fine>0 rays {int((outs[True]['acc_fine'] > 0).sum())}", flush=True)
    if launches != expected or expected == 0 or k5.launches != 0 or overflow != 0.0:
        raise SystemExit("K4 must run once per query of the rel_z render")
    compare_renders(outs[False], outs[True], "256² rel_z render, K4 on vs off",
                    K4_RENDER_BOUNDS)
    return launches


def render_wmma_widths(dev) -> None:
    """A bf16 model at WMMA_DIMS (5 source views, 16 keypoints, 2 levels)
    renders a 128² camera with use_pallas_geo_mlp, every query on the wmma
    route, held against the flag-off render by K5_RENDER_BOUNDS (no cull:
    every ray marched)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset
    from keypointnerf_torch.ops import geo_mlp_apply as k4
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.render import render_image

    size, chunk = 128, 2048
    V, K, L = WMMA_VKL
    base = KeypointNeRFConfig(n_kpt=K, sp_level=L, mlp_dims1=WMMA_DIMS1, mlp_dims2=WMMA_DIMS2)
    cfg = strict_preset(base, cull_budget=1.0)
    sample = make_sample(SyntheticConfig(image_size=size, n_views=V + 1, n_kpt=K), seed=0)
    R, t = orbit_camera(0.0)
    vb = ViewBatch.from_numpy(dict(sample, tar_R=R, tar_t=t), device=dev)
    outs = {}
    for flag in (False, True):
        model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=flag),
                             device=dev, seed=0)
        model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0
        k4.launches = k5.launches = 0
        k5.launches_by_route = dict.fromkeys(k5.launches_by_route, 0)
        outs[flag] = render_image(model, vb, height=size, width=size, chunk=chunk)
        torch.cuda.synchronize()
    expected = 2 * math.ceil(size * size / chunk)
    print(f"render {size}² strict bf16, V={V}, K={K}, L={L}, widths {WMMA_DIMS1[1:]} | "
          f"{WMMA_DIMS2[1:]}, use_pallas_geo_mlp: K5 launches by route "
          f"{k5.launches_by_route} (expected {expected} wmma), K4 {k4.launches}; acc_fine>0 "
          f"rays {int((outs[True]['acc_fine'] > 0).sum())}", flush=True)
    if k5.launches_by_route != {"wgmma": 0, "wmma": expected, "f32": 0} or k4.launches != 0:
        raise SystemExit("every query of the non-zju render must take K5's wmma route")
    compare_renders(outs[False], outs[True], f"{size}² render at non-zju widths, K5 (wmma) "
                    f"on vs off", K5_RENDER_BOUNDS)


# The fused-map render with K3 against the same render with the plain
# lookup of the fused map (use_dma_gather off): K3's three lerps and the
# lookup's four-term sum round bf16 at other places, so as for K5 a few rays
# flip whole; held by (mean, share) as in compare_renders: measured 1.54e-4
# (acc_fine) and 2.25e-4, pinned at 3e-4 and 5e-4.
K3_RENDER_BOUNDS = (3e-4, 5e-4)
# The K6 render against the same render through composite + importance_z:
# the coarse outputs differ by the sums' order only (max bound, as a share
# of each output's max, depth as its numerator: measured 3.6e-7, pinned at
# 1e-6), the fine ones through the fine depths the den switch or an edge
# flip moves (mean measured 1.8e-7, no entry off by 1%; pinned at 5e-7 and
# a share of 1e-5). Both renders are deterministic.
K6_COARSE_BOUND = 1e-6
K6_RENDER_BOUNDS = (5e-7, 1e-5)


def render_fused_map(dev, ctx) -> dict:
    """The 512² strict camera with the fused feature map and K3 (K2 must not
    run), the cull on; returns the launch counts of the timed render and
    the config the K6 render builds on."""
    from keypointnerf_torch.models import KeypointNeRF
    from keypointnerf_torch.ops import multiview_bilinear_sample_dma as k3
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.render import render_image

    size, chunk, vb = ctx["size"], ctx["chunk"], ctx["vb"]
    cfg = dataclasses.replace(ctx["cfg"], fused_feature_map=True, use_dma_gather=True)
    models = {}
    for name, over in (("dma", {}), ("plain", dict(use_dma_gather=False)),
                       ("unculled", dict(cull_empty_rays_ratio=1.0))):
        models[name] = KeypointNeRF(dataclasses.replace(cfg, **over), device=dev, seed=0)
        models[name].load_state_dict(ctx["model"].state_dict())
    model = models["dma"]
    feats = model.encode(vb.src_images, vb.src_masks)
    print(f"fused map {tuple(feats['fused'].shape)} {feats['fused'].dtype}", flush=True)
    render = lambda: render_image(model, vb, height=size, width=size, chunk=chunk)  # noqa: E731
    render()                                              # warm-up
    torch.cuda.synchronize()
    k2.launches = k3.launches = 0                         # counts of this render only
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"dma_gather": k3.launches, "onehot_bilinear": k2.launches}
    n_rays = size * size
    overflow = float(out["cull_overflow"].max())
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise SystemExit(f"fused-map render output {k} is not finite")
    print(f"render 512² strict bf16, fused map + K3: {seconds:.4f} s, {n_rays / seconds:.1f} "
          f"rays/s; cull_overflow={overflow}; K3 launches {launches['dma_gather']} (expected "
          f"{ctx['expected']}), K2 {launches['onehot_bilinear']} (expected 0); acc_fine>0 rays "
          f"{int((out['acc_fine'] > 0).sum())}", flush=True)
    if overflow != 0.0:
        raise SystemExit("empty-ray cull budget exceeded on the fused-map render")
    if launches["dma_gather"] != ctx["expected"] or launches["onehot_bilinear"] != 0:
        raise SystemExit("K3 must run once per query of the fused-map render, K2 never")

    # the cull on the fused map's mask channel is exact: bit-equal to
    # marching every ray
    culled = render_image(model, vb, height=size, width=size, chunk=chunk, feats=feats)
    full = render_image(models["unculled"], vb, height=size, width=size, chunk=chunk,
                        feats=feats)
    differ = [k for k in full if not torch.equal(full[k], culled[k])]
    print(f"fused map: culled vs unculled 512² render: "
          f"{'bit-equal' if not differ else 'DIFFER ' + str(differ)}", flush=True)
    if differ:
        raise SystemExit("the culled fused-map render differs from the unculled render")

    plain = functools.partial(render_image, models["plain"], vb, height=size, width=size,
                              chunk=chunk)
    plain()                                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out = plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print(f"render 512² strict bf16, fused map, plain lookup: {plain_s:.4f} s, "
          f"{n_rays / plain_s:.1f} rays/s", flush=True)
    compare_renders(plain_out, out, "512² fused-map render, K3 vs the plain lookup",
                    K3_RENDER_BOUNDS)
    print(f"one render, fused map + K3 (wall {seconds * 1e3:.3f} ms):", flush=True)
    profile_kernels(render, 10)
    return dict(launches, cfg=cfg)


def render_composite(dev, ctx, fused_cfg) -> dict:
    """The fused-map + K3 config with use_pallas_composite (K6), the cull
    off (the renderer refuses K6 with it): the 512² camera at stride 2,
    65,536 rays. Returns the launch counts of the timed render."""
    from keypointnerf_torch.models import KeypointNeRF
    from keypointnerf_torch.ops import fused_composite_importance as k6
    from keypointnerf_torch.ops import multiview_bilinear_sample_dma as k3
    from keypointnerf_torch.render import render_image

    size, chunk, vb = ctx["size"], ctx["chunk"], ctx["vb"]
    stride = 2
    cfg = dataclasses.replace(fused_cfg, cull_empty_rays_ratio=1.0)
    outs, secs, launches, renders = {}, {}, {}, {}
    for flag in (True, False):
        model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_composite=flag),
                             device=dev, seed=0)
        model.load_state_dict(ctx["model"].state_dict())
        renders[flag] = functools.partial(render_image, model, vb, height=size, width=size,
                                          stride=stride, chunk=chunk)
        renders[flag]()                                   # warm-up
        torch.cuda.synchronize()
        k3.launches = k6.launches = 0                     # counts of this render only
        t0 = time.perf_counter()
        outs[flag] = renders[flag]()
        torch.cuda.synchronize()
        secs[flag] = time.perf_counter() - t0
        launches[flag] = {"composite_importance": k6.launches, "dma_gather": k3.launches}
    n_rays = (size // stride) ** 2
    n_chunks = math.ceil(n_rays / chunk)
    on = launches[True]
    print(f"render 512² stride {stride} ({n_rays} rays) strict bf16, fused map + K3 + K6: "
          f"{secs[True]:.4f} s, {n_rays / secs[True]:.1f} rays/s; K6 launches "
          f"{on['composite_importance']} (expected {n_chunks}), K3 {on['dma_gather']} (expected "
          f"{2 * n_chunks}); the same without K6: {secs[False]:.4f} s, "
          f"{n_rays / secs[False]:.1f} rays/s, K6 {launches[False]['composite_importance']}",
          flush=True)
    if on["composite_importance"] != n_chunks or on["dma_gather"] != 2 * n_chunks \
            or launches[False]["composite_importance"] != 0:
        raise SystemExit("K6 must run once per chunk of the K6 render, K3 once per query")
    ref, got = outs[False], outs[True]
    worst = 0.0
    for k in ("rgb_coarse", "acc_coarse", "depth_coarse"):
        a, b = ref[k].float(), got[k].float()
        if not bool(torch.isfinite(b).all()):
            raise SystemExit(f"K6 render: output {k} is not finite")
        if k == "depth_coarse":
            a = a * (ref["acc_coarse"].float() + 1e-8)
            b = b * (got["acc_coarse"].float() + 1e-8)
        worst = max(worst, ((a - b).abs().max() / a.abs().max().clamp(min=1e-12)).item())
    print(f"K6 render, coarse outputs against composite: worst {worst:.3e} of an output's max "
          f"(bound {K6_COARSE_BOUND}; depth as its numerator)", flush=True)
    if not worst <= K6_COARSE_BOUND:
        raise SystemExit("K6's coarse outputs deviate from the plain composite's")
    compare_renders({k: v for k, v in ref.items() if k.endswith("_fine")},
                    {k: v for k, v in got.items() if k.endswith("_fine")},
                    "512² stride-2 render, K6 vs composite + importance_z (fine outputs)",
                    K6_RENDER_BOUNDS)
    print(f"one render, fused map + K3 + K6 (wall {secs[True] * 1e3:.3f} ms):", flush=True)
    profile_kernels(renders[True], 10)
    print(f"one render, fused map + K3, composite + importance_z (wall "
          f"{secs[False] * 1e3:.3f} ms):", flush=True)
    profile_kernels(renders[False], 3)
    return on


def agreement_small(dev, **overrides) -> None:
    """Toy f32 strict render on the card vs the same render on the CPU
    (`overrides` are config fields, e.g. use_pallas_geo_mlp=True)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset
    from keypointnerf_torch.render import render_image

    base = KeypointNeRFConfig(n_coarse=4, n_fine=4, geo_n_downsample=2)
    cfg = dataclasses.replace(strict_preset(base, cull_budget=0.6), compute_dtype=torch.float32,
                              **overrides)
    sample = make_sample(SyntheticConfig(image_size=32), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    outs = {}
    for d in (dev, torch.device("cpu")):
        model = KeypointNeRF(cfg, device=d, seed=0)
        outs[d.type] = render_image(model, ViewBatch.from_numpy(sample, device=d),
                                    height=32, width=32, chunk=256)
    worst = 0.0
    for k, ref in outs["cpu"].items():
        got = outs["cuda"][k].cpu()
        worst = max(worst, ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-12)).item())
    print(f"toy f32 render {overrides or ''}, card vs CPU: max relative error {worst:.3e} "
          f"(bound 1e-4)", flush=True)
    if not worst <= 1e-4:
        raise SystemExit("card render disagrees with the CPU render")


def zju_config(**overrides):
    """KeypointNeRFConfig from the "model" section of configs/zju.json."""
    from keypointnerf_torch.models import KeypointNeRFConfig

    dtypes = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "f32": torch.float32, "float32": torch.float32}
    model = json.loads(ZJU_CONFIG.read_text())["model"]
    if "compute_dtype" in model:
        model["compute_dtype"] = dtypes[model["compute_dtype"]]
    return dataclasses.replace(KeypointNeRFConfig(**model), **overrides)


def train_full_width(dev, fused=False, warmup=2, steps=5, capture_k1=False) -> dict:
    """Optimizer steps of the zju recipe at full width, with
    use_pallas_geo_mlp when `fused`; returns the kernels' launch counts of
    one step and the step's numbers, and with `capture_k1` the inputs of
    the first step's K1 calls (host copies, as (xy, g, H, W, map dtype))."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.ops import multiview_dmap_onehot as k1
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.ops import geo_mlp_apply as k4
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.training import (
        LossConfig, OptimConfig, TrainDraws, create_train_state, train_step_fn)

    cfg = zju_config(use_pallas_geo_mlp=fused)
    print(f"train config (configs/zju.json model section): n_coarse={cfg.n_coarse} "
          f"n_fine={cfg.n_fine} patch={cfg.patch_h}x{cfg.patch_w} dtype={cfg.compute_dtype} "
          f"matmul_vjp={cfg.train_matmul_gather_vjp} pallas_dmap={cfg.train_pallas_dmap} "
          f"remat={cfg.remat} use_pallas_geo_mlp={cfg.use_pallas_geo_mlp}", flush=True)
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=512, n_views=4), seed=0),
                              device=dev)
    model = KeypointNeRF(cfg, device=dev, seed=0)
    # as in the render phase: radiance > 0 somewhere, so every term trains
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0
    vgg = VGG19Features(device=dev, seed=42)                 # full width, random, frozen
    loss_cfg = LossConfig(lambda_vgg=0.5)
    state = create_train_state(model, OptimConfig(learning_rate=5e-4), vgg)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = [p.detach().clone() for p in model.parameters()]
    rays = cfg.patch_h * cfg.patch_w

    def step():
        return train_step_fn(model, loss_cfg, state, vb, TrainDraws.sample(cfg, vb, gen))

    t0 = time.perf_counter()
    # the first step starts from the seeded weights and draws: its numbers
    # are comparable between the flag-off and the flag-on run
    k1_inputs = []
    if capture_k1:
        # the backward looks K1 up in its module at each call
        from keypointnerf_torch.ops import onehot_dmap as k1_module

        def capturing(xy, g, H, W, map_dtype=torch.bfloat16):
            # kept on the host, so the timed steps' peak memory is unchanged
            k1_inputs.append((xy.cpu(), g.cpu(), H, W, map_dtype))
            return k1(xy, g, H, W, map_dtype)

        # the wrapper counts its launches on the module's name for it
        capturing.launches = 0
        k1_module.multiview_dmap_onehot = capturing
    try:
        first = {k: v.item() for k, v in step().items()}
    finally:
        if capture_k1:
            k1_module.multiview_dmap_onehot = k1
    for _ in range(warmup - 1):
        step()
    torch.cuda.synchronize()
    print(f"{warmup} warm-up steps {time.perf_counter() - t0:.3f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    per_step, errs = [], []
    for i in range(steps):
        k1.launches = k2.launches = k4.launches = k5.launches = 0   # this step only
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        err = step()
        torch.cuda.synchronize()
        per_step.append(time.perf_counter() - t1)
        launches = {"onehot_dmap": k1.launches, "onehot_bilinear": k2.launches,
                    "fused_geo_mlp": k4.launches, "sp_fused_geo_mlp": k5.launches}
        errs.append({k: v.item() for k, v in err.items()})
        print(f"step {i}: {per_step[-1]:.4f} s; e_all={errs[-1]['e_all']:.6f} "
              f"grad_norm={errs[-1]['grad_norm']:.6f} "
              f"terms={ {k: round(v, 6) for k, v in errs[-1].items()} }; "
              f"K1 launches {launches['onehot_dmap']}, K2 {launches['onehot_bilinear']}, "
              f"K4 {launches['fused_geo_mlp']}, K5 {launches['sp_fused_geo_mlp']}", flush=True)
        if launches["onehot_dmap"] != 2:
            raise SystemExit("K1 must run twice a step (coarse and fine query)")
        if launches["sp_fused_geo_mlp"] != (2 if fused else 0) or launches["fused_geo_mlp"]:
            raise SystemExit("K5 must run twice a step with the flag on, never with it off")
        if not all(math.isfinite(v) for v in errs[-1].values()):
            raise SystemExit("a loss or the gradient norm is not finite")
    seconds = sum(per_step) / steps
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int(not torch.equal(b, p)) for b, p in zip(before, model.parameters()))
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    print(f"train zju full width{', use_pallas_geo_mlp' if fused else ''}: "
          f"{seconds:.4f} s/step (mean of {steps}), {rays / seconds:.1f} "
          f"rays/s; peak memory {peak} bytes ({peak / 2**30:.2f} GiB); {changed} of "
          f"{len(before)} parameter tensors changed, all finite: {finite}", flush=True)
    if changed == 0 or not finite:
        raise SystemExit("the parameters did not change or are not finite")
    # the geometry MLP's parameters get their gradients through the fused
    # call's recompute backward when the flag is on
    stuck = [n for (n, p), b in zip(model.named_parameters(), before)
             if n.startswith("mlp_geo.") and torch.equal(b, p)]
    if stuck:
        raise SystemExit(f"geometry MLP parameters did not change: {stuck}")
    print("one step:", flush=True)
    device_ms = profile_kernels(step, 8 if fused else 15)
    return dict(launches, s_per_step=seconds, peak_bytes=peak, device_ms=device_ms, first=first,
                k1_inputs=k1_inputs)


# The first full-width step with the flag on against the one with it off:
# the same weights, draws and batch. The two bf16 programs round `pw` and the
# encoding at other places and take sin / cos another way (see the render
# bounds above). With seeded random weights the rendered patch is almost
# black, so the loss terms hardly feel it (a few f32 ulps); the gradient
# norm does. The bounds are relative, measured and about doubled.
FUSED_STEP_LOSS_BOUND = 2e-6         # measured 6.24e-7 (e_pix_l1)
FUSED_STEP_GRAD_NORM_BOUND = 1.5e-3  # measured 5.79e-4


def compare_first_steps(off, on) -> None:
    rel = {k: abs(on[k] - v) / max(abs(v), 1e-12) for k, v in off.items()}
    loss = max(v for k, v in rel.items() if k != "grad_norm")
    print(f"first training step, flag on vs off, relative: "
          f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} }; off {off}; on {on} "
          f"(bounds: loss terms {FUSED_STEP_LOSS_BOUND}, grad_norm "
          f"{FUSED_STEP_GRAD_NORM_BOUND})", flush=True)
    if not (loss <= FUSED_STEP_LOSS_BOUND and rel["grad_norm"] <= FUSED_STEP_GRAD_NORM_BOUND):
        raise SystemExit("the flag-on training step deviates from the flag-off step")


def train_agreement_small(dev, **overrides) -> None:
    """One toy f32 zju-recipe step on the card against the same step on the
    CPU (the path the CPU tests hold against the JAX package); `overrides`
    are config fields, e.g. use_pallas_geo_mlp=True."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.training import (
        LossConfig, OptimConfig, TrainDraws, compute_losses, create_train_state, train_step_fn)

    cfg = zju_config(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2,
                     compute_dtype=torch.float32, **overrides)
    sample = make_sample(SyntheticConfig(image_size=32), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    cpu = torch.device("cpu")
    draws = TrainDraws.sample(cfg, ViewBatch.from_numpy(sample, device=cpu),
                              torch.Generator().manual_seed(5))
    res = {}
    for d in (dev, cpu):
        vb = ViewBatch.from_numpy(sample, device=d)
        model = KeypointNeRF(cfg, device=d, seed=0)
        vgg = VGG19Features(((4,), (4, 8), (8, 8), (8, 8, 8, 16)), device=d)
        dr = draws.to(d)
        total, err = compute_losses(model(vb, train=True, draws=dr), LossConfig(), vgg)
        grads = torch.autograd.grad(total, list(model.parameters()))
        state = create_train_state(model, OptimConfig(), vgg)
        train_step_fn(model, LossConfig(), state, vb, dr)
        res[d.type] = dict(err={k: v.item() for k, v in err.items()},
                           grads=[g.cpu() for g in grads],
                           params=[p.detach().cpu() for p in model.parameters()])
        names = [n for n, _ in model.named_parameters()]
    c, g = res["cpu"], res["cuda"]
    loss_err = max(abs(g["err"][k] - v) / max(abs(v), 1e-12) for k, v in c["err"].items())
    top = max(x.abs().max().item() for x in c["grads"])
    grad_err = noise = 0.0
    rows = []
    ani_al = 0.0
    for name, a, b in zip(names, g["grads"], c["grads"]):
        scale = b.abs().max().item()
        if scale < 1e-6 * top:        # a bias feeding a norm: rounding noise
            noise = max(noise, a.abs().max().item() / top)
            continue
        rel = (a - b).abs().max().item() / scale
        rows.append((rel, name, scale / top))
        if name == "mlp_tex.ani_al":
            # one sum over every (view, point) of largely cancelling terms
            # (tests/test_torch_train_ops.py::test_ibr_head_grads)
            ani_al = rel
        else:
            grad_err = max(grad_err, rel)
    for rel, name, share in sorted(rows, reverse=True)[:6]:
        print(f"  gradient {name}: {rel:.3e} of its max, which is {share:.3e} of the top entry",
              flush=True)
    # Adam's first update is ~lr * sign(g): where |g| >= 100 eps the two
    # updates agree to PARAM_BOUND absolute (tests/test_torch_train_step.py
    # measures 2.6e-7 against JAX); entries with rounding-noise gradients
    # may move apart by up to 2 lr
    lr = OptimConfig().learning_rate
    param_err = small = 0.0
    for a, b, gb in zip(g["params"], c["params"], c["grads"]):
        big = gb.abs() >= 1e-6
        diff = (a - b).abs()
        param_err = max(param_err, diff[big].max().item() if big.any() else 0.0)
        small = max(small, diff[~big].max().item() if (~big).any() else 0.0)
    print(f"toy f32 train step {overrides or ''}, card vs CPU: loss terms {loss_err:.3e} relative (bound 1e-4); "
          f"gradients {grad_err:.3e} of each leaf's max (bound 1e-4), ani_al {ani_al:.3e} "
          f"(bound 5e-3), noise leaves {noise:.3e} of the top entry (bound 1e-6); updated "
          f"params {param_err:.3e} absolute where |g| >= 1e-6 (bound 2e-6), {small:.3e} "
          f"elsewhere (bound 2 lr = {2 * lr})", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and ani_al <= 5e-3 and noise <= 1e-6
            and param_err <= 2e-6 and small <= 2 * lr):
        raise SystemExit("the card's training step disagrees with the CPU's")


PHASES = ("kernels", "render", "agreement", "train", "train_agreement")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    todo = parser.parse_args().phases.split(",")
    if not set(todo) <= set(PHASES):
        parser.error(f"unknown phase in {todo}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    phase("environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    phase("build")
    from keypointnerf_torch.ops._build import KERNELS, build_all

    t0 = time.perf_counter()
    ptxas = start_ptxas_report("fused_geo_mlp")
    built = build_all(KERNELS)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"({ {k: round(v, 2) for k, v in built.items()} })", flush=True)
    print_ptxas_report(ptxas)

    entries, launches = {}, {}
    if "kernels" in todo:
        phase("kernels against their plain versions")
        entries = {"onehot_bilinear": check_onehot_bilinear(dev)}
        phase("K1")
        entries["onehot_dmap"] = check_onehot_dmap(dev)
        phase("K4 / K5")
        entries.update(check_fused_geo_mlp(dev))
        phase("K3")
        entries["dma_gather"] = check_dma_gather(dev)
        phase("K6")
        entries["composite_importance"] = check_composite_importance(dev)
        phase("K4 / K5 on the wmma route")
        check_geo_mlp_wmma(dev)
        check_dot_f32(dev)

    if "render" in todo:
        phase("full-width strict render")
        k2_launches, ctx = render_full_width(dev)
        launches.update(k2_launches)
        phase("full-width strict render with use_pallas_geo_mlp (K5)")
        launches["sp_fused_geo_mlp"] = render_fused(dev, ctx)["sp_fused_geo_mlp"]
        phase("full-width strict render with the fused feature map (K3)")
        fused = render_fused_map(dev, ctx)
        launches["dma_gather"] = fused["dma_gather"]
        phase("full-width strict render with the fused map, K3 and K6, stride 2")
        launches["composite_importance"] = render_composite(
            dev, ctx, fused["cfg"])["composite_importance"]
        del ctx
        phase("strict render with sp_type rel_z and use_pallas_geo_mlp (K4)")
        launches["fused_geo_mlp"] = render_rel_z(dev)
        phase("strict render at widths the wgmma kernel refuses, use_pallas_geo_mlp (wmma K5)")
        render_wmma_widths(dev)

    if "agreement" in todo:
        phase("small-input agreement")
        agreement_small(dev)
        agreement_small(dev, use_pallas_geo_mlp=True)
        agreement_small(dev, use_pallas_geo_mlp=True, sp_type="rel_z")
        agreement_small(dev, fused_feature_map=True, use_dma_gather=True)
        agreement_small(dev, fused_feature_map=True, use_dma_gather=True,
                        use_pallas_composite=True, cull_empty_rays_ratio=1.0)

    if "train" in todo:
        phase("full-width zju training steps")
        off = train_full_width(dev, capture_k1=True)
        launches["onehot_dmap"] = off["onehot_dmap"]
        if len(off["k1_inputs"]) != 2:
            raise SystemExit(f"captured {len(off['k1_inputs'])} K1 calls of a step, not 2")
        phase("K1 at the training step's own points")
        step_k1 = k1_at_step_points(dev, off.pop("k1_inputs"))
        if "onehot_dmap" in entries:
            # the kernels line times K1 where the main path runs it
            entry = entries["onehot_dmap"]
            entry["max_abs_err"] = max(entry["max_abs_err"], step_k1["max_abs_err"])
            entry.update({k: step_k1[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                  "library_ms", "step_ms")})
        phase("full-width zju training steps with use_pallas_geo_mlp (K5)")
        on = train_full_width(dev, fused=True)
        compare_first_steps(off["first"], on["first"])
        print(f"training step, flag off vs on: {off['s_per_step']:.4f} vs "
              f"{on['s_per_step']:.4f} s/step; kernel time of one step {off['device_ms']:.3f} "
              f"vs {on['device_ms']:.3f} ms; peak memory {off['peak_bytes']} vs "
              f"{on['peak_bytes']} bytes; K5 launches per step {on['sp_fused_geo_mlp']}, "
              f"K1 {on['onehot_dmap']}", flush=True)

    if "train_agreement" in todo:
        phase("small-input training agreement")
        train_agreement_small(dev)
        train_agreement_small(dev, use_pallas_geo_mlp=True)

    if set(todo) != set(PHASES):
        print(f"partial run ({todo}): no result line", flush=True)
        return 2
    for name, entry in entries.items():
        entry["launches"] = launches[name]
    print(f"whole run {time.perf_counter() - _START:.1f} s", flush=True)
    print(json.dumps({"kernels": list(entries.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
