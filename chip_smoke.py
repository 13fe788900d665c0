#!/usr/bin/env python3
"""Smoke run of the PyTorch port (keypointnerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, TF32 switched off for matmuls and cuDNN convs, and
     CUBLAS_WORKSPACE_CONFIG as the process sees it before its first work
     on the card (importing the port puts it in place; training's
     deterministic mode needs it);
  2. build: nvcc compiles every kernel of keypointnerf_torch/csrc/ and
     the earlier K1 (yardsticks/onehot_dmap_atomic.cu, the yardstick of
     K1's time; one process per source, all at once) into build/kernels/,
     and beside them fused_geo_mlp.cu with -Xptxas -v for K4 / K5's
     registers and spills;
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
     operands) against an f64 product, with their times; dense_act (the
     module path's dense layer in one launch) at each of a coarse render
     query's seven layers against its plain version, timed beside its byte
     bound, and the whole dense stack beside its bound, the plain versions
     and the stack as the module path composed it before; K1 with f32 and
     bf16 cotangents, timed at the fine and the coarse query's N with each
     pass's device time; K6 beside the device time and a call's time of an
     empty kernel, the floor under both, and again with falling cdfs (its
     warp-reduction path); every K1 check also launches K1 twice on the
     same inputs and holds the two bit-equal, and K1 runs at a hot-cell
     input too (the fine query's points in three cells a view);
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
  5. fast (needs render): the model of configs/zju_fast.json, built by the
     port's load_config / get_model (its model section checked equal to
     fast_preset(), its seeded weights to the strict camera's), renders the
     same 512² camera at chunk 8192: the fused map halved to 3 x 256² x 84
     bf16, finite outputs, cull_overflow == 0, none of K1-K6 launched and
     dense_act 7 times a query (112),
     each query's points (the fine cut's int(8192 * 0.75) rays x 64) and
     fused-map lookup points (the lerp's 33 anchors of 64 samples)
     counted, culled == unculled bit for bit with the top-k cuts off;
     rays/s and kernel time beside the strict camera's, the fast image's
     deviation from the strict one (a record), the bf16 render held against
     the same preset and weights in f32 by mean deviation and share off
     (FAST_BF16_BOUNDS), its top CUDA kernels; then render_cameras_scanned
     over 4 cameras of the bench orbit at 256² (finite, worst overflow 0;
     each frame equal to render_image of its camera, which checks the
     frames' order only: the scanned renderer loops over render_image) and
     run_eval on 2 synthetic 512² samples with auto_cull_budget=1 (finite
     PSNR / SSIM, PNGs under build/chip_smoke_eval/);
  6. agreement: toy-size f32 renders on the card against the same renders
     on the CPU (the paths the CPU tests hold against the JAX package),
     with each kernel's flag off and on, and the toy fast render (cull,
     coarse 0.5, fine 0.75): the rays each program's cull and cuts marched
     are recorded, at most 2 rays may differ in that status, every other
     ray is held at 1e-4 of each output's max as the strict renders are;
  7. train: optimizer steps of the configs/zju.json recipe at full width,
     read by the port's load_config (bf16, 64x64 patch, 64+64 samples,
     matmul VJP with K1, VGG loss on random frozen VGG19, Adam 5e-4) on
     the synthetic 512² scene: 2
     warm-up and 5 timed steps, finite losses, K1 launched six times a
     step (every map gradient, k1_per_step),
     parameters changed and finite; s/step, rays/s, peak memory, one
     step's top CUDA kernels and the device's idle share; K1 at the first
     step's own (xy, cotangent)
     of both its calls (captured by wrapping the wrapper): how the points
     fall on the map's cells, K1 against its plain version and its time
     with the cotangent as the step hands it over (bf16) and widened, and
     the two launches' sum, beside the earlier K1's time on the same
     inputs (at most K1_TIME_RATIO_BOUND of it); K1 at every one of the
     step's six calls (check_k1 and its time, beside what the parent ran
     for that map: the earlier K1 for the coarse map, the plain version's
     index_add_ for the others); the same step three times more, each
     bit-equal to the first (every loss term, every gradient leaf, the
     parameters after Adam); one step checked to run in strict
     deterministic mode (read in its forward; an op with no deterministic
     implementation would raise) and to leave the process in torch's
     defaults; the encoders' replication padding against the formulation
     torch takes in the mode (gradient bit-equal, times); s/step and kernel
     time in deterministic mode against torch's defaults, in turns on one
     model (DETERMINISTIC_COST_BOUND); then
     the same steps with `use_pallas_geo_mlp` (K5 twice a step, its
     backward the recompute), the first step's loss terms and gradient
     norm held against the flag-off run's; with `remat` and with
     `remat_save_gathers` (first steps bit-equal to the remat-off run's;
     peak memory and s/step beside it); and with the fused feature map
     (K1 at the 3 x 512² x 84 map twice a step, held against its plain
     version and the earlier K1 and timed at the step's own points, its
     byte bound and grid_sampler_2d_backward's time beside; K1 at all
     four of its calls as above; the step twice, bit for bit);
  8. train agreement: one toy f32 step on the card against the same step
     on the CPU (loss, every gradient, the updated parameters), with
     `use_pallas_geo_mlp`, `fused_feature_map` and `remat` off and on;
  9. trainer: the port's training CLI (`python -m keypointnerf_torch.train`,
     its main()) at full width on the synthetic 512² rig: 8 steps (finite
     train/ rows at 2, 4, 6, 8 and val/ rows at 4, 8 in metrics.jsonl,
     checkpoints 4 and 8, the best at the lower val loss), a second call
     that resumes step 8 bit for bit and ends at 10, --run_val on the best
     step (2 samples, finite PSNR / SSIM) and eval_zju on its PNG tree
     (within PNG rounding); the loop's s/step and the host's share making
     samples printed beside the bare step's;
 10. model_rest: the rest of the model at full width: K5 at separate_cf's
     3 outputs against its plain version at the strict render's coarse and
     fine (union) queries, on the wgmma route, timed with its bound; the
     512² strict camera with pool_mode attention_v0 and attention_v1, with
     separate_cf (culled == unculled bit for bit) and with separate_cf and
     use_pallas_geo_mlp (K5 48 launches at 3 outputs, held against the
     flag-off render by compare_renders' bounds); 1 + 2 zju steps with
     attention_v1 and separate_cf (finite, s/step); toy f32 renders and a
     step card vs CPU with both flags;
 11. parallel: the zju step in a one-rank NCCL group (the all-reduced
     gradients and terms bit-equal to the step's own, the parameters to
     the update without a group; s/step with and without); the
     one-process step on a global batch of 2, twice, bit for bit;
     then 2 ranks (torch.multiprocessing; gloo on one card, chosen and
     printed, NCCL where there are two cards): 2 + 3 data-parallel zju
     steps at local batch 1 (one gradient all-reduce of the parameter
     bytes and one of the loss terms a step, K1 six times a sample, the
     parameters bit-equal across ranks after every step, s/step and peak
     memory, the first step held against the one-process global batch by
     bounds: another program), the 512² strict camera sharded over the ranks
     (against the single-process render, one gather, K2 48 launches in
     all, cull_overflow 0 in each rank's rays), the Trainer (2 steps with
     a val and a checkpoint, a resume bit-equal to the saved state, to 4;
     rank 0 alone writes) and run_eval(sharded=True) on 2 samples (scores
     equal to the unsharded run's); each phase's seconds printed;
 12. gate: the gate's step twice from its seed for GATE_REPEAT_STEPS
     steps, bit for bit, K1 at all six calls of its first step as in the
     train phase, and its step in deterministic mode against torch's
     defaults in turns (what the mode and K1 add to a gate step); the
     port's training-quality gate (`python -m
     keypointnerf_torch.quality_gate`'s main()) at gate geometry for 150
     steps with one evaluation, recorded into build/chip_smoke_gate/:
     s/step, K1 six times a step, the host's waits on the device in a chunk
     (torch.cuda's sync debug mode), the loss of the first and last chunk,
     finite seen / unseen PSNR / SSIM and the fast preset's cull overflow 0
     (the gate exits 1 otherwise);
 13. data: a fake ZJU-MoCap tree at the dataset's geometry (1024² PNG
     images and the two grey masks a view, mask/ and mask_cihp/, their rows
     filtered as camera PNGs are, 21 cameras, every subject of both splits
     sharing files by symlink, 313 / 315 with empty image lists) under
     build/chip_smoke_data/: the native library built from
     native/kpnerf_data.cc, the loader's samples/s inline and with 4
     prefetcher threads (bit-equal samples), the train CLI fed from the tree
     (`--set data.dataset=zju data.num_workers=4`, and 0, 8 steps each,
     K1 six times a step; s/step and the host's share), --run_val on the val
     split, and render_dynamic for 2 orbit frames with configs/zju_fast.json
     (cull_overflow 0);
 14. export: the serving export (keypointnerf_torch/export.py, the kernels
     as registered ops): the 512² strict camera with use_pallas_geo_mlp
     exported at chunk 2048 into build/chip_smoke_export/, loaded and run
     in a fresh process that imports only load_render (frames and overflow
     bit-equal to the eager render, overflow 0, K2 and K5 48 launches each,
     a wrong input shape raises); an artifact with a cull budget of 0.01 at
     256² (overflow > 0, equal to the eager render's); a multi-camera
     artifact (F = 2, 256²) equal to its cameras' renders; a 128² artifact
     with the fused map + K3, rel_z + K4 and K6 equal to its eager render,
     each kernel's launches counted; the eager render before and after the
     exports bit-equal; export seconds, artifact bytes, load seconds and the
     loaded program's rays/s beside eager's;
 15. reference_ckpt: a fake reference Lightning checkpoint of the seeded
     full-width model (model.*, vgg_loss.*, Lightning's keys) imported by
     utils/import_reference.py into a fresh model: its 512² strict render
     bit-equal to the source model's;
 16. icon: the port's ICON CLI (`python -m keypointnerf_torch.train_icon`,
     its main()) at ICON's full widths on 512² blob scenes (200 steps, 8
     scenes, 2 eval scenes, 128³ grids): finite Chamfer / P2S, the OBJ
     files and icon_metrics.json; s/step, grid points/s, meshing seconds;
     then a toy f32 ICON step card vs CPU;
 17. prints the kernels line, the card line and, last, the result line.

Every training step runs in the port's deterministic mode
(keypointnerf_torch/device.py deterministic_training, a context around
the step's body) and nothing else does: the render phase renders the 512²
strict camera once more after the process has entered and left the mode
(torch's defaults in its encoders and queries, bit-equal, rays/s beside
the first render's). The trainer phase
also runs the first call with 4 loader workers; model_rest also times
K5's 3-output module path and renders the 2-output camera with
reuse_coarse_eval=False (the 128-depth union), a separate_cf model
with rad_f tied to rad_c, the 2-output union with its radiance bias
raised until as many rays are opaque as separate_cf's fine pass makes,
and separate_cf with rad_c's bias raised until its coarse pass is as
opaque as its fine pass, each K5 on against off (union_k5_render).

`--phases kernels,render,...` runs a subset while developing (the result
line is printed only by a full run).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
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
FAST_CONFIG = ZJU_CONFIG.with_name("zju_fast.json")
EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"


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


# K2's call by CUDA events as a ctypes call, before the kernels were
# registered ops, at uniform and ray-coherent points (PERF.md §6)
K2_CTYPES_CALL_MS = {"uniform": 0.02480, "render": 0.01860}


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
                      f"{max(t_bytes, t_ops):.5f} ms ({n_bytes} bytes, {n_ops} flops); a call "
                      f"through the registered op {t['call_ms']:.5f} ms against the ctypes "
                      f"call {K2_CTYPES_CALL_MS[what]:.5f} ms", flush=True)
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
                  f"function (library_ms null); a call through the registered op "
                  f"{call_ms:.5f} ms against the ctypes call's 0.02398 ms (PERF.md §6)",
                  flush=True)
    return entry


def _bf16_ulps_apart(a, b):
    """Per entry, whether bf16 a and b lie more than one bf16 ulp apart."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)      # 8 significand bits
    return (a - b).abs() > ulp


# K1's kernels, and those of its earlier design (yardsticks/onehot_dmap_atomic.cu)
K1_PASSES = ("keys_kernel", "sort_pass_kernel", "accumulate_kernel", "pieces_kernel",
             "combine_kernel")
ATOMIC_K1_PASSES = ("count_kernel", "scan_kernel", "scatter_kernel", "accumulate_kernel")
# K1 against the earlier design at the training steps' own points, both timed
# here: the fixed order may cost at most this much more
K1_TIME_RATIO_BOUND = 1.25
YARDSTICKS = Path(__file__).resolve().parent / "yardsticks"


def yardstick_path(name) -> Path:
    from keypointnerf_torch.ops._build import BUILD_DIR

    digest = hashlib.sha1((YARDSTICKS / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start_yardstick_build(name):
    """nvcc of yardsticks/<name>.cu with the port's flags, started now
    (beside the port's own builds); `finish_build` waits for it."""
    from keypointnerf_torch.ops._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = yardstick_path(name)
    if out.exists():
        return out, None
    return out, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(YARDSTICKS / f"{name}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(started) -> None:
    out, proc = started
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {out.name}:\n{log}")


@functools.cache
def atomic_k1_lib():
    """The earlier K1 (float atomics at each cell run's end), loaded with
    ctypes: the yardstick of K1's time, never part of the port."""
    import ctypes

    lib = ctypes.CDLL(str(yardstick_path("onehot_dmap_atomic")))
    lib.kpn_onehot_dmap_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.kpn_onehot_dmap_scratch_bytes.restype = ctypes.c_int64
    lib.kpn_onehot_dmap.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.kpn_onehot_dmap.restype = ctypes.c_int
    return lib


def atomic_k1(xy, g, H, W, dt):
    """The earlier K1 on (xy, g): the (V, H, W, C) f32 map gradient."""
    lib = atomic_k1_lib()
    V, N, C = g.shape
    codes = {torch.float32: 0, torch.bfloat16: 1}
    dmap = torch.empty((V, H, W, C), dtype=torch.float32, device=g.device)
    size = lib.kpn_onehot_dmap_scratch_bytes(V, N, H, W)
    scratch = torch.empty(size, dtype=torch.uint8, device=g.device)
    err = lib.kpn_onehot_dmap(xy.data_ptr(), g.data_ptr(), dmap.data_ptr(), scratch.data_ptr(),
                              size, V, N, H, W, C, codes[dt], codes[g.dtype],
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"the earlier K1 failed to launch: CUDA error {err}")
    return dmap


def k1_cotangent_dtypes(k1):
    """The cotangent dtypes the K1 wrapper takes: f32 and bf16 (an earlier
    K1, timed beside this one in before-and-after runs, took f32 only)."""
    xy, g = torch.zeros(1, 1, 2), torch.zeros(1, 1, 1, dtype=torch.bfloat16)
    try:
        k1._check(xy, g, 2, 2, torch.bfloat16)
    except TypeError:
        return (torch.float32,)
    return (torch.float32, torch.bfloat16)


def plain_f64(xy, g, H, W, dt):
    """The plain version's terms (rounded to `dt` as it rounds them) summed
    in f64: the reference where a cell holds ~10^5 points and any f32 sum
    order, the plain version's too, rounds by more than K1's bound."""
    from keypointnerf_torch.ops.feat_sample import bilinear_coords

    V, N, C = g.shape
    x0, y0, wx, wy = bilinear_coords(xy, H, W)
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    base = (torch.arange(V, device=g.device)[:, None] * H + y0) * W + x0
    out = torch.zeros(V * H * W, C, dtype=torch.float64, device=g.device)
    for yw, dy in ((rnd(1.0 - wy), 0), (rnd(wy), 1)):
        for xw, dx in ((1.0 - wx, 0), (wx, 1)):
            out.index_add_(0, (base + dy * W + dx).reshape(-1),
                           (yw[..., None] * rnd(xw[..., None] * g.float())).double()
                           .reshape(-1, C))
    return out.reshape(V, H, W, C)


def check_k1(k1, xy, g, H, W, dt, what, f64=False) -> float:
    """K1 against its plain version on (xy, g) with terms rounded to `dt`
    (with `f64`, against its terms summed in f64, the plain version's own
    distance from that printed beside), and a second launch on the same
    inputs bit-equal to the first; returns the max abs error, exits on
    disagreement."""
    V, _, C = g.shape
    got = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    again = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    ref = k1.onehot_dmap_plain(xy, g, H, W, dt)
    if f64:
        exact = plain_f64(xy, g, H, W, dt)
        plain_err = (ref.double() - exact).abs().max().item()
        ref = exact.float()
        print(f"K1 {what}: the plain version (f32 sums) is {plain_err} from the f64 sum",
              flush=True)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
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
          f"{not bool((apart & ~near_zero).any())}); two launches bit-equal {same} "
          f"{'ok' if ok and same else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version: {err}")
    if not same:
        raise SystemExit("two K1 launches on the same inputs differ")
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
    profiled device time of each pass beside (under programmatic dependent
    launch a pass's device time includes its wait for the pass before)."""
    call = lambda: k1.multiview_dmap_onehot(xy, g, H, W, dt)  # noqa: E731
    ms = cuda_ms(call, iters=20)
    passes = {name: kernel_device_ms(call, name, iters=5) for name in K1_PASSES}
    return {"ms": ms, "passes": passes, **k1_bound(*g.shape[:2], H, W, g.shape[2],
                                                   g.element_size())}


def time_k1_against_atomic(k1, xy, g, H, W, dt) -> dict:
    """K1 and the earlier design (yardsticks/onehot_dmap_atomic.cu) on the
    same inputs, by CUDA events in turns (earlier, K1, K1, earlier), each
    pass of the earlier one profiled beside."""
    ours = lambda: k1.multiview_dmap_onehot(xy, g, H, W, dt)  # noqa: E731
    theirs = lambda: atomic_k1(xy, g, H, W, dt)  # noqa: E731
    t = [cuda_ms(f, iters=20) for f in (theirs, ours, ours, theirs)]
    return {"ms": (t[1] + t[2]) / 2, "atomic_ms": (t[0] + t[3]) / 2, "turns": t,
            "atomic_passes": {name: kernel_device_ms(theirs, name, iters=5)
                              for name in ATOMIC_K1_PASSES}}


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
    # hot cells: the fine query's points all in three cells a view (two of
    # one parity class), so each cell's run crosses ~1,365 of the 128-point
    # segments a warp sums, and its pieces are summed in segment order
    V, H, W, C, N = 3, 128, 128, 64, 4096 * 128
    cells = np.array([[-0.5, 0.2], [0.1, 0.2], [0.7, -0.3]], np.float32) + 1e-3
    xy = torch.as_tensor(cells[rs.integers(0, 3, (V, N))], device=dev)
    g = torch.as_tensor(rs.normal(size=(V, N, C)).astype(np.float32), device=dev)
    print(f"K1 hot-cell input: {cell_spread(xy, H, W)}", flush=True)
    for gt in g_dtypes:
        errs.append(check_k1(k1, xy, g.to(gt), H, W, torch.bfloat16, "hot cells", f64=True))
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


def k1_at_step_points(dev, captured, step="zju") -> dict:
    """K1 at the (xy, cotangent) of one training step's two calls (coarse
    and fine query) of the `step` named: the points' spread on the map, K1
    against its plain version with the cotangent as the step hands it over
    and widened to f32, and K1's time on both; with the cotangent as the
    step hands it over, K1 against the earlier design on the same inputs
    (at most K1_TIME_RATIO_BOUND of its time, the two launches summed).
    Returns the fine query's kernels-line numbers and the step's K1 time
    (the two launches summed)."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    out, errs, step_ms, pair = {}, [], 0.0, [0.0, 0.0]
    for (xy, g, H, W, dt), what in zip(sorted(captured, key=lambda c: c[0].shape[1]),
                                       ("coarse", "fine")):
        xy, g = xy.to(dev), g.to(dev)
        V, N, C = g.shape
        print(f"K1 at the {step} step's {what} query (V={V}, N={N}, C={C}, {H}x{W} map, "
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
                vs = time_k1_against_atomic(k1, xy, g, H, W, dt)
                pair[0] += vs["ms"]
                pair[1] += vs["atomic_ms"]
                print(f"K1 against the earlier design (float atomics) at the step's {what} "
                      f"query, in turns (earlier, K1, K1, earlier) {[round(x, 4) for x in vs['turns']]} "
                      f"ms: K1 {vs['ms']:.4f}, earlier {vs['atomic_ms']:.4f} ms "
                      f"({vs['ms'] / vs['atomic_ms']:.3f}x); the earlier design's passes (device) "
                      f"{ {k: round(v, 5) for k, v in vs['atomic_passes'].items()} }; bound "
                      f"{t['bound_ms']:.4f} ms", flush=True)
                if what == "fine":
                    plain_ms, library_ms = k1_yardsticks(k1, xy, g, H, W, dt, "the step's points")
                    out = {"ms": t["ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                           "plain_ms": plain_ms, "library_ms": library_ms}
    ratio = pair[0] / pair[1]
    print(f"K1 a {step} training step (coarse + fine launch, as the step runs them): "
          f"{step_ms:.4f} ms; in turns with the earlier design {pair[0]:.4f} against "
          f"{pair[1]:.4f} ms = {ratio:.3f}x (bound {K1_TIME_RATIO_BOUND}x)", flush=True)
    if not ratio <= K1_TIME_RATIO_BOUND:
        raise SystemExit(f"K1 takes {ratio:.3f}x the earlier design's time at the {step} "
                         f"step's points (bound {K1_TIME_RATIO_BOUND}x)")
    return dict(out, max_abs_err=max(errs), step_ms=step_ms, atomic_step_ms=pair[1],
                vs_atomic=ratio)


def k1_capture(into, limit):
    """Keep host copies of the inputs of the next `limit` K1 calls, as (xy,
    g, H, W, map dtype), in `into` (the backward looks the wrapper up in its
    module at each call; host copies leave the device's peak memory as it
    is); returns the function that puts the wrapper back."""
    from keypointnerf_torch.ops import onehot_dmap as k1_module

    k1 = k1_module.multiview_dmap_onehot

    def capturing(xy, g, H, W, map_dtype=torch.bfloat16):
        if len(into) < limit:
            into.append((xy.cpu(), g.cpu(), H, W, map_dtype))
        return k1(xy, g, H, W, map_dtype)

    # the wrapper counts its launches on the module's name for it
    capturing.launches = 0
    k1_module.multiview_dmap_onehot = capturing

    def restore():
        k1_module.multiview_dmap_onehot = k1

    return restore


def k1_calls(dev, captured, step) -> dict:
    """K1 at every captured call of one `step` (its maps' gradients, as the
    step hands them over): K1 against its plain version and two launches
    bit-equal (check_k1), K1's time by CUDA events and its bound, beside
    the time of what the parent ran for that map with torch's defaults:
    the earlier K1 (yardsticks/onehot_dmap_atomic.cu) for the widest map,
    the one the Pallas kernel served (main_map_calls), and the plain
    version (index_add_ with float atomics) for the others. Returns the
    max abs error and the step's K1 and parent times, summed."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    widest = max(g.shape[2] for _, g, _, _, _ in captured)
    errs, ours, parents = [], 0.0, 0.0
    for xy, g, H, W, dt in sorted(captured, key=lambda c: (c[1].shape[2], c[2], c[1].shape[1])):
        xy, g = xy.to(dev), g.to(dev)
        V, N, C = g.shape
        errs.append(check_k1(k1, xy, g, H, W, dt, f"{step} step, {H}x{W}x{C} map"))
        ms = cuda_ms(lambda: k1.multiview_dmap_onehot(xy, g, H, W, dt), iters=20)
        if C == widest:
            how = "the earlier K1"
            parent = cuda_ms(lambda: atomic_k1(xy, g, H, W, dt), iters=20)
        else:
            how = "the plain version (index_add_)"
            parent = cuda_ms(lambda: k1.onehot_dmap_plain(xy, g, H, W, dt), iters=20)
        b = k1_bound(V, N, H, W, C, g.element_size())
        print(f"K1 at the {step} step's {V}x{H}x{W}x{C} map (N={N}, cotangent "
              f"{str(g.dtype)[6:]}; {cell_spread(xy, H, W)}): {ms:.4f} ms by events, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); the parent ran {how}: {parent:.4f} ms",
              flush=True)
        ours += ms
        parents += parent
    print(f"K1 a {step} step, all {len(captured)} launches: {ours:.4f} ms; what the parent ran "
          f"for the same maps: {parents:.4f} ms ({ours / parents:.3f}x)", flush=True)
    return dict(max_abs_err=max(errs), ms=ours, parent_ms=parents)


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


def geo_mlp_bound(N, V, K, with_enc, ops, n_bytes, dims2=GEO_DIMS2) -> dict:
    """The least time of one K4 / K5 call at the zju widths: the largest of
    its bytes at the HBM rate, its products at the bf16 tensor rate, its
    f32 work at the f32 issue rate (every instruction of the code the
    kernel runs for each value, `geo_mlp_op_counts`, plus the plain
    operations) and the part of it on the MUFU / conversion pipe at that
    pipe's rate."""
    d = dict(zip(("dsp", "h1", "h2", "h3", "dl"), GEO_DIMS1))
    g0, g1, g2, do = dims2
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



def composed_stack(mlp, sp, feats, mask, weight):
    """The geometry MLP as the module path composed it before `dense_act`:
    each layer's `LinearSlot` (dot_f32 per input block, the partial sums,
    the bias) and softplus100 as separate passes, f32 between layers; a
    yardstick the port no longer calls."""
    from keypointnerf_torch.models.mlp import masked_pool, softplus100

    def stack(layers, x, skips):
        n = len(layers)
        for i, slot in enumerate(layers):
            if i in skips:
                x = (x, skips[i])
            x = slot(x)
            x = x if i == n - 1 else softplus100(x)
        return x

    l1 = mlp.layers1
    lv = stack(l1.layers, sp, {i: feats[j] for i, j in l1.skip_idx.items()})
    lf, valid = masked_pool(lv, mask, weight, mlp.pool_types)
    return stack(mlp.layers2.layers, lf, {}), valid, lv, lf


def _bf16_steps(a, b):
    """Per entry, how many bf16 values apart a and b lie (a subnormal's
    step counts as one ulp too)."""
    def ordered(t):
        bits = t.view(torch.int16).int() & 0xFFFF
        mag = bits & 0x7FFF
        return torch.where(bits >= 0x8000, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def check_dense_act(dev) -> dict:
    """`dense_act` (one dense layer of the module path's geometry MLP in one
    launch) at a coarse render query of the zju_fast configuration: V = 3,
    N = 8192 rays x 64 samples; the encoding from query-shaped points, the
    image features slices of an 84-channel bf16 map row as the fused map
    hands them over. Each of the seven layers' own inputs (captured from
    the module path's forward) through the kernel against the plain
    version (bf16 outputs within one ulp, f32 within K 2^-23 of
    sum |x| |w| + |b|, two launches bit-equal), with its time, the plain
    version's and the byte bound (its inputs as handed over read once, its
    output written once); then the whole stack: the seven kernels' sum
    against the sum of their bounds, the module path's forward (the seven
    kernels, the casts, the weight-norm folds and the pool) beside the
    same stack composed as before (`composed_stack`, the yardstick) and the
    plain versions. Returns the kernels-line entry."""
    import keypointnerf_torch.models.mlp as mlp_mod
    from keypointnerf_torch.ops import dense_act as da
    from keypointnerf_torch.ops.fused_geo_mlp import rel_z_decay_encoding

    V, N = 3, 8192 * 64
    bf = torch.bfloat16
    mlp = seeded_geo_mlp(dev)
    ins = geo_mlp_inputs(dev, N, seed=11)
    sp = rel_z_decay_encoding(ins["pts_cam"], ins["kpt_cam"], 3, 0.1, 1.0).to(bf)
    fmap = torch.cat([ins["f0"], ins["f1"], torch.zeros(V, N, 12, device=dev)], -1).to(bf)
    feats = [fmap[..., :64], fmap[..., 64:72]]
    mask, weight = ins["mask"].to(bf), ins["weight"].to(bf)
    calls, real = [], mlp_mod.fused_dense_act

    def capturing(xs, w, b, softplus, out_dtype):
        calls.append((xs, w, b, softplus, out_dtype))
        return real(xs, w, b, softplus, out_dtype)

    mlp_mod.fused_dense_act = capturing
    try:
        with torch.no_grad():
            got = mlp(sp, feats, mask, weight)
    finally:
        mlp_mod.fused_dense_act = real
    names = ("l1.0", "l1.1", "l1.2", "l1.3", "l2.0", "l2.1", "l2.2")
    if len(calls) != len(names):
        raise SystemExit(f"the module path called dense_act {len(calls)} times, not 7")
    layers, worst = {}, 0.0
    for name, (xs, w, b, act, odt) in zip(names, calls):
        k1 = da.fused_dense_act(xs, w, b, act, odt)
        k2 = da.fused_dense_act(xs, w, b, act, odt)
        ref = da.dense_act_plain(xs, w, b, act, odt)
        torch.cuda.synchronize()
        K = w.shape[1]
        if odt == bf:
            err = float(_bf16_steps(k1, ref).max())
            ok = err <= 1
            what = f"{int(err)} bf16 ulp at most (bound 1)"
        else:
            x = torch.cat([a.to(bf).float() for a in xs], -1)
            scale = x.abs() @ w.to(bf).float().abs().T + b.abs()
            err = float(((k1 - ref).abs() / scale).max())
            ok = err <= K * 2.0 ** -23
            what = f"{err:.3e} of sum |x||w| + |b| at most (bound K 2^-23 = {K * 2.0 ** -23:.3e})"
        same = torch.equal(k1, k2)
        ms = cuda_ms(lambda: da.fused_dense_act(xs, w, b, act, odt), iters=20)
        plain_ms = cuda_ms(lambda: da.dense_act_plain(xs, w, b, act, odt), iters=5)
        rows = k1.numel() // k1.shape[-1]
        n_bytes = rows * (sum(a.shape[-1] * a.element_size() for a in xs)
                          + w.shape[0] * k1.element_size())
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        layers[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "err": err}
        print(f"dense_act {name} ({rows} rows, inputs {[a.shape[-1] for a in xs]} "
              f"{[str(a.dtype)[6:] for a in xs]}, {w.shape[0]} outputs "
              f"{str(odt)[6:]}, {'softplus100' if act else 'no activation'}): {what}; two "
              f"launches bit-equal {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({n_bytes} bytes; {ms / bound:.2f}x)", flush=True)
        if not (ok and same and bool(torch.isfinite(k1).all())):
            raise SystemExit(f"dense_act disagrees with its plain version at {name}")
        worst = max(worst, err if odt == bf else 0.0)
    stack_ms = sum(v["ms"] for v in layers.values())
    stack_bound = sum(v["bound_ms"] for v in layers.values())
    with torch.no_grad():
        module_ms = cuda_ms(lambda: mlp(sp, feats, mask, weight), iters=10)
        composed_ms = cuda_ms(lambda: composed_stack(mlp, sp, feats, mask, weight), iters=5)
        ref = composed_stack(mlp, sp, feats, mask, weight)
    plain_ms = sum(v["plain_ms"] for v in layers.values())
    dev_out = float((got[0] - ref[0]).abs().max()) / float(ref[0].abs().max())
    print(f"dense_act, one coarse query's whole dense stack (V = {V}, N = {N}): the seven "
          f"kernels {stack_ms:.4f} ms against their bound {stack_bound:.4f} ms "
          f"({stack_ms / stack_bound:.2f}x; at most 3x), the plain versions {plain_ms:.4f} ms; "
          f"the module path's forward (kernels, casts, weight-norm folds, pool) "
          f"{module_ms:.4f} ms against the stack composed as before {composed_ms:.4f} ms "
          f"(yardstick; the port no longer calls it); out against the composed stack "
          f"{dev_out:.3e} of its largest entry", flush=True)
    if stack_ms > 3 * stack_bound:
        raise SystemExit("the dense stack takes more than 3x its byte bound")
    return {
        "name": "dense_act", "route": "cuda", "source": "keypointnerf_torch/csrc/dense_act.cu",
        "replaces": None, "max_abs_err": worst, "ms": stack_ms, "plain_ms": plain_ms,
        "bound_ms": stack_bound, "bound_by": "bytes", "library_ms": composed_ms,
        "module_path_ms": module_ms, "layers": layers,
    }

def orbit_camera(ang):
    from keypointnerf_torch.data import look_at

    eye = 3.5 * np.array([np.cos(ang), 0.05, np.sin(ang)])
    return look_at(eye, np.zeros(3))


def is_kernel_event(e) -> bool:
    """Whether a profiler (kineto) event is a CUDA kernel's run: on the
    device, and not the device-side copy of a host range (a `kpnerf::`
    span, a registered op, `record_function`), a copy or a fill."""
    if not str(e.device_type()).endswith("CUDA") or e.duration_ns() <= 0:
        return False
    try:
        act = str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        act = ""
    return not (e.is_user_annotation() or "annotation" in act or "memcpy" in act
                or "memset" in act or e.name().startswith(("Memcpy", "Memset", "kpnerf::")))


def profile_kernels(fn, top):
    """Run fn() under the profiler; print and return the device time (ms)
    of its CUDA kernels, each run counted once (`is_kernel_event`: no aten
    op's or range's device time, which repeats its kernels')."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if is_kernel_event(e):
            n, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (n + 1, ns + e.duration_ns())
    total = sum(ns for _, ns in by_name.values()) / 1e6
    print(f"profile: device time {total:.3f} ms in {sum(n for n, _ in by_name.values())} "
          f"kernel launches", flush=True)
    for name, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ns / 1e6:10.3f} ms  {n:6d}x  {name[:90]}", flush=True)
    return total


def aten_device_ms(fn) -> dict:
    """fn() under the profiler: each aten op's device time (its kernels', ms)
    and calls, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: ((getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                    / 1e3, e.count)
            for e in prof.key_averages() if e.key.startswith("aten::")}


def render_after_training_mode(model, render, out, n_rays) -> None:
    """The render again after the process has entered and left training's
    deterministic mode (device.deterministic_training, the context of every
    training step): the mode as the encoders and the queries see it (off:
    torch's defaults), the render bit-equal to `out`, and its rays/s."""
    from keypointnerf_torch.device import deterministic_training

    with deterministic_training():
        pass
    seen = []

    def spying(real):
        def call(*args, **kwargs):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return real(*args, **kwargs)
        return call

    model.encode, model.query_points = spying(model.encode), spying(model.query_points)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = render()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        del model.encode, model.query_points
    differ = [k for k in out if not torch.equal(out[k], got[k])]
    print(f"the 512² render after the process entered and left training's deterministic mode: "
          f"{seconds:.4f} s = {n_rays / seconds:.1f} rays/s; deterministic algorithms on in "
          f"{sum(seen)} of its {len(seen)} encoder and query calls; bit-equal to the first "
          f"render {not differ}", flush=True)
    if any(seen) or not seen:
        raise SystemExit("the renderer ran in training's deterministic mode")
    if differ:
        raise SystemExit(f"the 512² render after training's mode differs in {differ}")


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
    render_after_training_mode(model, render, out, size2)

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
    device_ms = profile_kernels(render, 12)
    return launches, dict(cfg=cfg, model=model, vb=vb, out=out, seconds=seconds,
                          device_ms=device_ms, size=size, chunk=chunk, expected=expected)


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
# 512² separate_cf K5 (3 outputs): measured 1.56e-4 (sdf_fine), 5.38e-4
# (rgb_fine). Its own rays, not the 3-output path (union_k5_render): 284 of
# the 303 rays off by > 1% are left transparent by the coarse pass (rad_c)
# and made opaque by the fine pass (rad_f), so their fine samples are drawn
# from a near-empty coarse pdf that rounding moves; with rad_c's bias raised
# until the coarse pass is as opaque as the fine, the same model deviates
# 1.20e-4 / 2.29e-5, inside K5_RENDER_BOUNDS. Neither the 128-depth union
# (1.15e-4 / 1.64e-4), the 3-output path with rad_f tied to rad_c
# (bit-equal to 2 outputs) nor the opaque area alone (a 2-output union as
# opaque as rad_f: 7.01e-5 / 3.43e-5) leaves K5_RENDER_BOUNDS.
K5_SEPARATE_CF_RENDER_BOUNDS = (3.5e-4, 1.1e-3)


def compare_renders(ref, got, what, bounds):
    """Every output of `got` finite and within `bounds` (mean, share) of
    `ref` (render_deviation)."""
    worst_mean, worst_share = render_deviation(ref, got, what)
    print(f"{what}: worst mean {worst_mean:.3e} (bound {bounds[0]}), worst share "
          f"{worst_share:.3e} (bound {bounds[1]})", flush=True)
    if not (worst_mean <= bounds[0] and worst_share <= bounds[1]):
        raise SystemExit(f"{what}: the flag-on render deviates from the flag-off render")
    return worst_mean, worst_share


def render_deviation(ref, got, what):
    """(worst mean, worst share off by > 1%) of `got`'s outputs against
    `ref`'s, each as a share of the output's max; every output of `got`
    must be finite. depth and sdf are ratios of two near-zero sums on rays
    that hit almost nothing, where rounding alone moves them by their whole
    range: their numerators x (acc + 1e-8) are held instead."""
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
    print(f"{what}, deviation as a share of each output's max: {'; '.join(rows)}; depth and "
          f"sdf as their numerators", flush=True)
    return worst_mean, worst_share


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


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its kernels-line name (each has
    a `.launches` count)."""
    from keypointnerf_torch import ops

    return {"onehot_dmap": ops.multiview_dmap_onehot,
            "onehot_bilinear": ops.multiview_onehot_bilinear_sample,
            "fused_geo_mlp": ops.geo_mlp_apply,
            "sp_fused_geo_mlp": ops.sp_geo_mlp_apply,
            "dma_gather": ops.multiview_bilinear_sample_dma,
            "composite_importance": ops.fused_composite_importance,
            "dense_act": ops.fused_dense_act}


@contextlib.contextmanager
def counted_queries(model):
    """Record each `query_points` call of `model` as {"points", "samples",
    "lookups"}, "lookups" the point count of every fused-map lookup the
    query makes (`models.keypoint_nerf.multiview_bilinear_sample`)."""
    import keypointnerf_torch.models.keypoint_nerf as knerf

    calls, lookup, query = [], knerf.multiview_bilinear_sample, model.query_points

    def counted_lookup(fmap, xy, *args, **kwargs):
        if calls and calls[-1]["open"]:
            calls[-1]["lookups"].append(xy.shape[1])
        return lookup(fmap, xy, *args, **kwargs)

    def counted_query(pts, view_dirs, feats, vb, n_samples, **kwargs):
        calls.append({"points": pts.shape[0], "samples": n_samples, "lookups": [],
                      "open": True})
        try:
            return query(pts, view_dirs, feats, vb, n_samples, **kwargs)
        finally:
            calls[-1]["open"] = False

    knerf.multiview_bilinear_sample = counted_lookup
    model.query_points = counted_query
    try:
        yield calls
    finally:
        knerf.multiview_bilinear_sample = lookup
        del model.query_points


# The bf16 fast render against the same preset in f32, held as the flag-on
# renders are (compare_renders). Besides the bf16 rounding of every layer,
# the lerp `left + t * (right - left)` rounds at each step in bf16, and the
# fine cut ranks rays by a coarse opacity that the rounding moves, so rays
# at its boundary switch whole between marched and kept-coarse. (mean,
# share), measured and doubled: 1.705e-4 (acc_fine), 6.47e-4 (rgb_fine).
FAST_BF16_BOUNDS = (3.5e-4, 1.3e-3)


def render_fast(dev, strict) -> dict:
    """One 512² camera of the fast preset built from configs/zju_fast.json
    (the strict camera's scene, weights and image in `strict`); returns
    what the orbit and the evaluation reuse."""
    from keypointnerf_torch.models import fast_preset
    from keypointnerf_torch.render import render_image
    from keypointnerf_torch.utils import get_model, load_config

    exp = load_config(str(FAST_CONFIG))
    if exp.model != fast_preset():
        raise SystemExit("configs/zju_fast.json's model section is not fast_preset()")
    cfg, size, chunk, vb = exp.model, strict["size"], 8192, strict["vb"]
    model = get_model(exp, device=dev)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0     # as the strict camera's
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 strict["model"].state_dict().values()))
    print(f"config {FAST_CONFIG.name}: model == fast_preset(); weights equal to the strict "
          f"camera's: {same}", flush=True)
    if not same:
        raise SystemExit("the fast model's seeded weights differ from the strict model's")
    feats = model.encode(vb.src_images, vb.src_masks)
    fused = feats["fused"]
    print(f"fused map {tuple(fused.shape)} {fused.dtype}", flush=True)
    if tuple(fused.shape) != (3, size // 2, size // 2, 84) or fused.dtype != torch.bfloat16:
        raise SystemExit("the fast preset's fused map is not the halved 84-channel bf16 map")

    render = lambda: render_image(model, vb, height=size, width=size, chunk=chunk)  # noqa: E731
    render()                                              # warm-up
    torch.cuda.synchronize()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0                                    # counts of this render only
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    n_rays = size * size
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise SystemExit(f"fast render output {k} is not finite")
    overflow = float(out["cull_overflow"].max())
    marched = -int(-n_rays * cfg.cull_empty_rays_ratio // 1)
    n_chunks = math.ceil(marched / chunk)
    print(f"render 512² fast bf16 (chunk {chunk}): {seconds:.4f} s, {n_rays / seconds:.1f} "
          f"rays/s; strict camera of this run {strict['seconds']:.4f} s, "
          f"{n_rays / strict['seconds']:.1f} rays/s; cull_overflow={overflow}; marched {marched} "
          f"rays in {n_chunks} chunks; kernel launches {launched or 'none'}", flush=True)
    if overflow != 0.0:
        raise SystemExit("empty-ray cull budget exceeded on the fast render")
    # every layer of the geometry MLP as one dense_act launch: 7 a query,
    # coarse and fine in every chunk; none of K1-K6
    want = {"dense_act": 7 * 2 * n_chunks}
    if launched != want:
        raise SystemExit(f"the fast path launched {launched}, not {want}")

    # the fine cut marches int(chunk * 0.75) rays of each chunk, and every
    # query looks the fused map up at the 33 anchors of its 64 samples
    with torch.no_grad(), counted_queries(model) as calls:
        render_image(model, vb, height=size, width=size, chunk=chunk, feats=feats)
    anchors = lambda S: len(range(0, S, cfg.gather_lerp_stride)) + 1   # noqa: E731
    n_fine = int(chunk * cfg.fine_topk_ratio)
    want = [(chunk * cfg.n_coarse, cfg.n_coarse, [chunk * anchors(cfg.n_coarse)]),
            (n_fine * cfg.n_fine, cfg.n_fine, [n_fine * anchors(cfg.n_fine)])] * n_chunks
    got = [(c["points"], c["samples"], c["lookups"]) for c in calls]
    print(f"queries of the fast render: {len(got)} (expected {len(want)}); per chunk "
          f"{got[:2]} (points, samples per ray, fused-map lookup points; expected "
          f"{want[:2]})", flush=True)
    if got != want:
        raise SystemExit("the fast render's queries are not the fine cut's and the lerp's")

    # the fast image against the strict camera's: a record, not a gate
    diff = (out["rgb_fine"].float() - strict["out"]["rgb_fine"].float()).abs()
    print(f"fast vs strict image (rgb_fine): mean |diff| {diff.mean().item():.6f}, "
          f"{(diff > 0.01).any(-1).float().mean().item():.6f} of pixels off by > 0.01 in some "
          f"channel, max {diff.max().item():.4f}", flush=True)

    # the bf16 fast render against the same preset and weights in f32
    ref = get_model(dataclasses.replace(exp, model=dataclasses.replace(
        cfg, compute_dtype=torch.float32)), device=dev)
    ref.load_state_dict(model.state_dict())
    ref_out = render_image(ref, vb, height=size, width=size, chunk=chunk)
    del ref
    if float(ref_out["cull_overflow"].max()) != 0.0:
        raise SystemExit("empty-ray cull budget exceeded on the f32 fast render")
    compare_renders(ref_out, out, "512² fast render, bf16 vs f32", FAST_BF16_BOUNDS)
    del ref_out

    # with the top-k cuts off the cull is exact under the lerp bound
    exact = dataclasses.replace(cfg, fine_topk_ratio=1.0, coarse_topk_ratio=1.0)
    renders = {}
    for name, ratio in (("culled", cfg.cull_empty_rays_ratio), ("unculled", 1.0)):
        m = get_model(dataclasses.replace(exp, model=dataclasses.replace(
            exact, cull_empty_rays_ratio=ratio)), device=dev)
        m.load_state_dict(model.state_dict())
        renders[name] = render_image(m, vb, height=size, width=size, chunk=chunk, feats=feats)
    if float(renders["culled"].pop("cull_overflow").max()) != 0.0:
        raise SystemExit("empty-ray cull budget exceeded with the top-k cuts off")
    differ = [k for k in renders["unculled"]
              if not torch.equal(renders["unculled"][k], renders["culled"][k])]
    print(f"fast preset, top-k cuts off: culled vs unculled 512² render: "
          f"{'bit-equal' if not differ else 'DIFFER ' + str(differ)}", flush=True)
    if differ:
        raise SystemExit("the culled render under the lerp bound differs from the unculled")

    print(f"one render, fast preset (wall {seconds * 1e3:.3f} ms; the strict camera: "
          f"{strict['device_ms']:.3f} ms of kernel time):", flush=True)
    device_ms = profile_kernels(render, 10)
    print(f"fast vs strict 512² camera, same run: {n_rays / seconds:.1f} vs "
          f"{n_rays / strict['seconds']:.1f} rays/s, {device_ms:.3f} vs "
          f"{strict['device_ms']:.3f} ms of kernel time", flush=True)
    return dict(exp=exp, model=model, feats=feats, vb=vb, dense_act=launched["dense_act"])


def render_fast_orbit(dev, ctx) -> None:
    """render_cameras_scanned over 4 cameras of the bench orbit (radius 3.5,
    0.7 rad apart) at 256² from one encoding of the 512² inputs: finite,
    worst overflow 0, and each frame render_image of its own camera (the
    frames' order; the scanned renderer is a loop over render_image, so
    this is no check of the render itself)."""
    from keypointnerf_torch.render import render_cameras_scanned, render_image

    model, feats, vb, size, chunk = ctx["model"], ctx["feats"], ctx["vb"], 256, 8192
    cams = [orbit_camera(0.7 * i) for i in range(4)]
    Ks = vb.tar_K[None].expand(4, 3, 3)
    Rs = torch.as_tensor(np.stack([R for R, _ in cams]), device=dev)
    ts = torch.as_tensor(np.stack([t for _, t in cams]), device=dev)
    orbit = lambda: render_cameras_scanned(model, feats, vb, Ks, Rs, ts, height=size,  # noqa: E731
                                           width=size, chunk=chunk)
    orbit()                                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, worst = orbit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    differ = []
    for f in range(4):
        single = render_image(model, dataclasses.replace(vb, tar_K=Ks[f], tar_R=Rs[f],
                                                         tar_t=ts[f]),
                              height=size, width=size, chunk=chunk, feats=feats)
        if not torch.equal(single["rgb_fine"], rgb[f]):
            differ.append(f)
    print(f"orbit of 4 cameras at 256², fast preset, one encoding: {tuple(rgb.shape)} in "
          f"{seconds:.4f} s = {4 * size * size / seconds:.1f} rays/s; worst cull_overflow "
          f"{float(worst)}; frames equal to render_image: "
          f"{'all' if not differ else 'NOT ' + str(differ)}; mean rgb "
          f"{rgb.float().mean().item():.6f}", flush=True)
    if float(worst) != 0.0 or differ or not bool(torch.isfinite(rgb).all()):
        raise SystemExit("the scanned orbit overflowed, is not finite or differs from "
                         "render_image")


def eval_fast(ctx) -> None:
    """run_eval of the fast model on a 2-sample SyntheticDataset at 512²,
    the cull budget probed on the first sample; PNGs and the YAML under
    build/."""
    from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset
    from keypointnerf_torch.evaluation import run_eval

    exp = dataclasses.replace(ctx["exp"], out_dir=str(EVAL_DIR))
    data = SyntheticDataset(SyntheticConfig(image_size=512, n_views=4), length=2)
    t0 = time.perf_counter()
    scores = run_eval(exp, ctx["model"], data, auto_cull_budget=1)
    print(f"run_eval, fast preset, 2 samples at 512²: {scores} in "
          f"{time.perf_counter() - t0:.2f} s; PNGs under {EVAL_DIR / exp.name}", flush=True)
    if not (np.isfinite(scores.get("psnr", np.nan)) and np.isfinite(scores.get("ssim", np.nan))):
        raise SystemExit("run_eval's PSNR / SSIM are not finite")


@contextlib.contextmanager
def recorded_selections():
    """Record every top-k selection a render makes: the empty-ray cull's
    over all rays (`render.renderer.top_k_indices`) and each chunk's coarse
    and fine cuts (`models.keypoint_nerf.top_k_indices`), as index tensors
    on the CPU, in call order."""
    import keypointnerf_torch.models.keypoint_nerf as knerf
    import keypointnerf_torch.render.renderer as rmod

    rec = {"cull": [], "cuts": []}
    topk_m, topk_r = knerf.top_k_indices, rmod.top_k_indices

    def recording(topk, into):
        def f(score, k):
            idx = topk(score, k)
            into.append(idx.cpu())
            return idx
        return f

    knerf.top_k_indices = recording(topk_m, rec["cuts"])
    rmod.top_k_indices = recording(topk_r, rec["cull"])
    try:
        yield rec
    finally:
        knerf.top_k_indices, rmod.top_k_indices = topk_m, topk_r


def ray_status(rec, n_rays, chunk):
    """(n_rays, 3) bool: each ray's [kept by the empty-ray cull, marched by
    its chunk's coarse cut, marched by its chunk's fine cut], from the
    selections of `recorded_selections` (one cull, then a coarse and a fine
    cut per chunk). A ray's outputs are those of its first place in the
    marched order; the padding copies after the k-th place are ignored."""
    (order,), cuts = rec["cull"], rec["cuts"]
    k = order.numel()
    status = torch.zeros(n_rays, 3, dtype=torch.bool)
    status[order, 0] = True
    if len(cuts) != 2 * -(-k // chunk):
        raise SystemExit(f"{len(cuts)} chunk cuts recorded for {-(-k // chunk)} chunks")
    for c in range(len(cuts) // 2):
        pos = c * chunk + torch.arange(chunk)
        real = pos < k
        for j, sel in enumerate(cuts[2 * c:2 * c + 2]):
            marched = torch.zeros(chunk, dtype=torch.bool)
            marched[sel] = True
            status[order[pos[real]], 1 + j] = marched[real]
    return status


# Toy f32 fast render, card against CPU. A ray at a top-k boundary (the
# fine cut ranks rays by coarse opacity, whose last bits differ between
# the two programs) can flip whole between marched and kept-coarse. The
# check records which rays each program's cull and cuts marched, allows
# at most FAST_AGREEMENT_FLIPS rays whose status differs, and holds every
# other ray at agreement_small's bound, 1e-4 of each output's max.
FAST_AGREEMENT_FLIPS = 2


def agreement_fast(dev) -> None:
    """The toy fast render (fused map, gather-lerp, cull, coarse 0.5, fine
    0.75) in f32 on the card against the CPU."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, fast_preset
    from keypointnerf_torch.render import render_image

    base = KeypointNeRFConfig(n_coarse=4, n_fine=4, geo_n_downsample=2)
    cfg = dataclasses.replace(fast_preset(base, cull_budget=0.6), compute_dtype=torch.float32,
                              coarse_topk_ratio=0.5, fine_topk_ratio=0.75)
    size, chunk = 32, 256
    sample = make_sample(SyntheticConfig(image_size=size), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    outs, status = {}, {}
    for d in (dev, torch.device("cpu")):
        model = KeypointNeRF(cfg, device=d, seed=0)
        with recorded_selections() as rec:
            out = render_image(model, ViewBatch.from_numpy(sample, device=d), height=size,
                               width=size, chunk=chunk)
        outs[d.type] = {k: v.cpu() for k, v in out.items()}
        status[d.type] = ray_status(rec, size * size, chunk)
    if float(outs["cuda"]["cull_overflow"].max()) != 0.0:
        raise SystemExit("toy fast render: cull budget exceeded on the card")
    flipped = (status["cuda"] != status["cpu"]).any(-1)
    same = ~flipped
    worst, rows = 0.0, []
    for k, ref in outs["cpu"].items():
        if k == "cull_overflow":
            continue
        got = outs["cuda"][k].reshape(size * size, -1)
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"toy fast render: output {k} is not finite on the card")
        ref = ref.reshape(size * size, -1)
        err = ((got - ref).abs()[same].max() / ref.abs().max().clamp(min=1e-12)).item()
        rows.append(f"{k} {err:.3e}")
        worst = max(worst, err)
    print(f"toy f32 fast render, card vs CPU: rays marched by the cull / coarse cut / fine "
          f"cut {status['cuda'].sum(0).tolist()} on the card, {status['cpu'].sum(0).tolist()} "
          f"on the CPU; {int(flipped.sum())} rays of {size * size} differ in status (bound "
          f"{FAST_AGREEMENT_FLIPS}); the others, max relative error {'; '.join(rows)}; worst "
          f"{worst:.3e} (bound 1e-4)", flush=True)
    if int(flipped.sum()) > FAST_AGREEMENT_FLIPS or not worst <= 1e-4:
        raise SystemExit("toy fast render on the card disagrees with the CPU render")


def agreement_small(dev, radiance_bias=0.0, **overrides) -> None:
    """Toy f32 strict render on the card vs the same render on the CPU
    (`overrides` are config fields, e.g. use_pallas_geo_mlp=True;
    `radiance_bias` is added to every radiance channel's bias)."""
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
        model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += radiance_bias
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


def k1_per_step(cfg) -> int:
    """K1's launches in one training step of `cfg` (on the card every map
    gradient of the matmul-VJP lookups is K1's): each query's lookups (the
    fused map; or the coarse map, the hd map's prefix and the texture map),
    for the coarse and the fine query, and with the fused map the two
    upsampling lookups that build it in training."""
    return 2 + 2 if cfg.fused_feature_map else 2 * 3


def main_map_calls(captured):
    """The captured K1 calls of the map the Pallas kernel served in the
    JAX step (the coarse geometry map, or the fused map): the widest ones,
    one a query."""
    widest = max(g.shape[2] for _, g, _, _, _ in captured)
    return [c for c in captured if c[1].shape[2] == widest]


def zju_config(**overrides):
    """KeypointNeRFConfig of configs/zju.json's "model" section, read by the
    port's load_config."""
    from keypointnerf_torch.utils import load_config

    return dataclasses.replace(load_config(str(ZJU_CONFIG)).model, **overrides)


def train_full_width(dev, warmup=2, steps=5, capture_k1=False, capture_grads=False,
                     **overrides) -> dict:
    """Optimizer steps of the zju recipe at full width with config fields
    `overrides` (use_pallas_geo_mlp, fused_feature_map, remat, ...);
    returns the kernels' launch counts of one step and the step's numbers
    (s/step, peak memory, kernel time, the first step's loss terms), with
    `capture_k1` the inputs of the first step's K1 calls (host copies, as
    (xy, g, H, W, map dtype)) and with `capture_grads` the first step's
    gradients (host copies, by parameter name) and the parameters after
    its update (host copies, in order)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.ops import multiview_dmap_onehot as k1
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.ops import geo_mlp_apply as k4
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn
    from keypointnerf_torch.training import train as train_module
    from keypointnerf_torch.utils import load_config

    cfg = zju_config(**overrides)
    label = ", ".join(f"{k}={v}" for k, v in overrides.items()) or "as it ships"
    print(f"train config (configs/zju.json model section, {label}): n_coarse={cfg.n_coarse} "
          f"n_fine={cfg.n_fine} patch={cfg.patch_h}x{cfg.patch_w} dtype={cfg.compute_dtype} "
          f"matmul_vjp={cfg.train_matmul_gather_vjp} pallas_dmap={cfg.train_pallas_dmap} "
          f"remat={cfg.remat} remat_save_gathers={cfg.remat_save_gathers} "
          f"use_pallas_geo_mlp={cfg.use_pallas_geo_mlp} "
          f"fused_feature_map={cfg.fused_feature_map}", flush=True)
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=512, n_views=4), seed=0),
                              device=dev)
    model = KeypointNeRF(cfg, device=dev, seed=0)
    # as in the render phase: radiance > 0 somewhere, so every term trains
    # (with separate_cf both radiance channels, coarse and fine)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0
    vgg = VGG19Features(device=dev, seed=42)                 # full width, random, frozen
    recipe = load_config(str(ZJU_CONFIG))                 # its loss and optim sections
    loss_cfg = recipe.loss
    state = create_train_state(model, recipe.optim, vgg)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = [p.detach().clone() for p in model.parameters()]
    rays = cfg.patch_h * cfg.patch_w

    def step():
        return train_step_fn(model, loss_cfg, state, vb, TrainDraws.sample(cfg, vb, gen))

    t0 = time.perf_counter()
    # the first step starts from the seeded weights and draws: its numbers
    # are comparable between runs with other flags
    k1_inputs, grads, updated = [], {}, []
    apply = train_module.apply_gradients
    restore_k1 = k1_capture(k1_inputs, k1_per_step(cfg)) if capture_k1 else None
    if capture_grads:
        names = [n for n, _ in model.named_parameters()]

        def keeping(st, params, gs):
            grads.update((n, g.cpu()) for n, g in zip(names, gs))
            apply(st, params, gs)
            updated.extend(p.detach().cpu() for p in params)

        train_module.apply_gradients = keeping
    try:
        first = {k: v.item() for k, v in step().items()}
    finally:
        if restore_k1:
            restore_k1()
        train_module.apply_gradients = apply
    for _ in range(warmup - 1):
        step()
    torch.cuda.synchronize()
    print(f"{warmup} warm-up steps {time.perf_counter() - t0:.3f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    per_step, errs = [], []
    k5_want = 2 if cfg.use_pallas_geo_mlp else 0
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
        if launches["onehot_dmap"] != k1_per_step(cfg):
            raise SystemExit(f"K1 must run {k1_per_step(cfg)} times a step: every map "
                             f"gradient of the coarse and the fine query")
        if launches["sp_fused_geo_mlp"] != k5_want or launches["fused_geo_mlp"]:
            raise SystemExit("K5 must run twice a step with the flag on, never with it off")
        if launches["onehot_bilinear"]:
            raise SystemExit("K2 (an eval lookup) ran in a training step")
        if not all(math.isfinite(v) for v in errs[-1].values()):
            raise SystemExit("a loss or the gradient norm is not finite")
    seconds = sum(per_step) / steps
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int(not torch.equal(b, p)) for b, p in zip(before, model.parameters()))
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    print(f"train zju full width ({label}): "
          f"{seconds:.4f} s/step (mean of {steps}), {rays / seconds:.1f} "
          f"rays/s; peak memory {peak} bytes ({peak / 2**30:.2f} GiB); {changed} of "
          f"{len(before)} parameter tensors changed, all finite: {finite}", flush=True)
    if changed == 0 or not finite:
        raise SystemExit("the parameters did not change or are not finite")
    # the geometry MLP's parameters get their gradients through the fused
    # call's recompute backward when use_pallas_geo_mlp is on; both
    # encoders train (through the upsampling lookups with the fused map)
    # (attention_v1's key bias shifts every view's logit alike, which the
    # renormalisation cancels: its gradient is zero in exact arithmetic)
    stuck = [n for (n, p), b in zip(model.named_parameters(), before)
             if n.startswith("mlp_geo.") and n != "mlp_geo.pool.k_proj.bias"
             and torch.equal(b, p)]
    if stuck:
        raise SystemExit(f"geometry MLP parameters did not change: {stuck}")
    for prefix in ("geo_encoder.", "tex_encoder."):
        if all(torch.equal(b, p) for (n, p), b in zip(model.named_parameters(), before)
               if n.startswith(prefix)):
            raise SystemExit(f"no {prefix[:-1]} parameter changed")
    print("one step:", flush=True)
    device_ms = profile_kernels(step, 10)
    print(f"one step's kernel time {device_ms:.3f} ms of the {seconds * 1e3:.3f} ms a step "
          f"takes unprofiled: the device idles {1 - device_ms / (seconds * 1e3):.3f} of the "
          f"step", flush=True)
    return dict(launches, s_per_step=seconds, peak_bytes=peak, device_ms=device_ms, first=first,
                k1_inputs=k1_inputs, grads=grads, params=updated)


def same_first_step(ref, run, what) -> None:
    """`run`'s first step bit for bit `ref`'s (the same program, weights,
    batch and draws): every loss term and grad_norm, every gradient leaf
    and every parameter after the update `torch.equal`."""
    terms = [k for k, v in ref["first"].items() if run["first"][k] != v]
    leaves = [n for n, g in ref["grads"].items() if not torch.equal(g, run["grads"][n])]
    params = [i for i, (a, b) in enumerate(zip(ref["params"], run["params"]))
              if not torch.equal(a, b)]
    print(f"{what}, first step against the first run's: loss terms and grad_norm equal "
          f"{not terms} {run['first']}; {len(ref['grads']) - len(leaves)} of "
          f"{len(ref['grads'])} gradient leaves bit-equal; {len(ref['params']) - len(params)} of "
          f"{len(ref['params'])} parameters bit-equal after the update", flush=True)
    if (terms or leaves or params or len(ref["params"]) != len(run["params"])
            or not ref["params"]):
        raise SystemExit(f"{what} is not bit-equal to the first run: terms {terms}, gradient "
                         f"leaves {leaves[:5]}, parameters {params[:5]}")


def mode_state() -> dict:
    """The deterministic mode as the process is in it now."""
    return dict(deterministic=torch.are_deterministic_algorithms_enabled(),
                warn_only=torch.is_deterministic_algorithms_warn_only_enabled(),
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark,
                CUBLAS_WORKSPACE_CONFIG=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


STRICT_MODE = dict(deterministic=True, warn_only=False, cudnn_deterministic=True,
                   cudnn_benchmark=False, CUBLAS_WORKSPACE_CONFIG=":4096:8")


def steps_in_turns(fns, turns=4, per_turn=3) -> dict:
    """Each of `fns` (name -> one step) run `per_turn` steps at a time in
    `turns` turns, the order reversed every other turn (a, b, b, a, ...),
    after two warm-up steps each; the median of each one's per-turn
    s/step."""
    names = list(fns)
    for name in names:
        for _ in range(2):
            fns[name]()
    times = {name: [] for name in names}
    for turn in range(turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(per_turn):
                fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / per_turn)
    return {name: (float(np.median(t)), t) for name, t in times.items()}


# the zju step in deterministic mode against the same step with torch's
# defaults (training.train.step_without_mode), in turns on one model in one
# call: the mode may cost at most 10% of the step, by the median wall clock
# of the turns and by kernel time, plus what torch's sorted index_put_ costs
# more in the mode (the formulation PERF.md names for the ops that have no
# other; the encoders' replication padding, which took it, no longer does).
# Readings on an NVIDIA H100 80GB HBM3 (700 W), wall clock / kernel time:
# 0.983x / 0.986x, 1.021x / 0.998x; before the padding's own backward, from
# separate runs, kernel time 1.062-1.090x, wall clock 1.030x and 1.147x
DETERMINISTIC_COST_BOUND = 1.10
DETERMINISTIC_COST_OPS = ("aten::index_put_", "aten::_index_put_impl_", "aten::index_put",
                          "aten::_unsafe_index_put")


def deterministic_cost(dev) -> dict:
    """The zju step (the recipe of train_full_width, one batch and one set
    of draws) in deterministic mode and with torch's defaults, in turns:
    median s/step of each, kernel time of one step of each, and the aten
    ops that cost more in the mode."""
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn
    from keypointnerf_torch.training.train import step_without_mode

    cfg, model, vgg, recipe = zju_step_parts(dev)
    state = create_train_state(model, recipe.optim, vgg)
    vb = rig_sample(dev, 0)
    draws = TrainDraws.sample(cfg, vb, torch.Generator(device=dev).manual_seed(0))
    fns = {"deterministic": lambda: train_step_fn(model, recipe.loss, state, vb, draws),
           "defaults": lambda: step_without_mode(model, recipe.loss, state, [vb], [draws])}
    turns = steps_in_turns(fns)
    (det_s, det_t), (free_s, free_t) = turns["deterministic"], turns["defaults"]
    print("one step in deterministic mode:", flush=True)
    det_ms = profile_kernels(fns["deterministic"], 10)
    print("one step with torch's defaults:", flush=True)
    free_ms = profile_kernels(fns["defaults"], 10)
    det_ops, free_ops = aten_device_ms(fns["deterministic"]), aten_device_ms(fns["defaults"])
    ops = {k: (det_ops.get(k, (0.0, 0)), free_ops.get(k, (0.0, 0)))
           for k in set(det_ops) | set(free_ops)}
    dearer = sorted(ops.items(), key=lambda kv: kv[1][1][0] - kv[1][0][0])[:8]
    print("aten ops that cost more in deterministic mode (one step; device ms and calls, "
          "deterministic against defaults): " + "; ".join(
              f"{k} {a[0]:.3f} ({a[1]}) vs {b[0]:.3f} ({b[1]})" for k, (a, b) in dearer),
          flush=True)
    # the family's ops nest (index_put calls _index_put_impl_): the largest
    # is the family's extra time
    sorted_extra = max((max(0.0, ops[k][0][0] - ops[k][1][0])
                        for k in DETERMINISTIC_COST_OPS if k in ops), default=0.0)
    wall_ok = det_s <= DETERMINISTIC_COST_BOUND * free_s + sorted_extra / 1e3
    kernel_ok = det_ms <= DETERMINISTIC_COST_BOUND * free_ms + sorted_extra
    print(f"zju step in deterministic mode {det_s:.4f} s/step (median of turns "
          f"{[round(x, 4) for x in det_t]}), kernel time {det_ms:.3f} ms; with torch's defaults "
          f"{free_s:.4f} s/step ({[round(x, 4) for x in free_t]}), {free_ms:.3f} ms: "
          f"{det_s / free_s:.3f}x the wall clock, {det_ms / free_ms:.3f}x the kernel time "
          f"(bound {DETERMINISTIC_COST_BOUND}x plus the sorted index_put_'s extra "
          f"{sorted_extra:.3f} ms) {'ok' if wall_ok and kernel_ok else 'FAIL'}", flush=True)
    if not (wall_ok and kernel_ok):
        raise SystemExit(f"the zju step in deterministic mode takes {det_s / free_s:.3f}x the "
                         f"wall clock and {det_ms / free_ms:.3f}x the kernel time of torch's "
                         f"defaults (bound {DETERMINISTIC_COST_BOUND}x + {sorted_extra:.3f} ms)")
    return dict(det_s=det_s, free_s=free_s, det_ms=det_ms, free_ms=free_ms,
                sorted_extra_ms=sorted_extra)


def strict_mode_step(dev) -> None:
    """One zju step as the training path runs it, checked to run in strict
    deterministic mode (read in its forward): torch's deterministic
    algorithms with no warn-only (an op without a deterministic
    implementation raises, and nothing here catches it), cuDNN
    deterministic without autotuning, and CUBLAS_WORKSPACE_CONFIG as this
    process saw it; and the process back in torch's defaults after it."""
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn

    cfg, model, vgg, recipe = zju_step_parts(dev)
    state = create_train_state(model, recipe.optim, vgg)
    vb = rig_sample(dev, 0)
    draws = TrainDraws.sample(cfg, vb, torch.Generator(device=dev).manual_seed(0))
    seen = []
    hook = model.register_forward_pre_hook(lambda module, args: seen.append(mode_state()))
    try:
        err = train_step_fn(model, recipe.loss, state, vb, draws)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    after = mode_state()
    print(f"zju step in strict deterministic mode, no op raised (e_all "
          f"{err['e_all'].item():.6f}); the mode in its forward: {seen}; after it: {after}",
          flush=True)
    if seen != [STRICT_MODE]:
        raise SystemExit(f"the training step did not run in strict deterministic mode: {seen}")
    if after["deterministic"] or after["cudnn_deterministic"]:
        raise SystemExit(f"the training step left the process in deterministic mode: {after}")


def check_replication_pad(dev) -> None:
    """The encoders' replication padding (models/cnn.ReplicationPad2d) at
    the texture encoder's bf16 shapes of the zju step: its output equal to
    torch's padding, its gradient bit-equal to that of the formulation
    torch takes in deterministic mode (`_replication_pad`, a sorting
    index_put_ in its backward); the backward's time beside that one's and
    torch's own (atomics, outside the mode)."""
    from torch._decomp.decompositions import _replication_pad

    from keypointnerf_torch.device import deterministic_training
    from keypointnerf_torch.models.cnn import ReplicationPad2d

    gen = torch.Generator(device=dev).manual_seed(5)
    for shape, pad in (((3, 512, 64, 64), 1), ((3, 128, 256, 256), 3)):
        x = torch.randn(shape, device=dev, generator=gen).bfloat16()
        padded = [s + 2 * pad for s in shape[2:]]
        g = torch.randn((*shape[:2], *padded), device=dev, generator=gen).bfloat16()
        ours = x.clone().requires_grad_(True)
        y = ReplicationPad2d(pad)(ours)
        y.backward(g)
        with deterministic_training():
            theirs = x.clone().requires_grad_(True)
            _replication_pad(theirs, (pad,) * 4).backward(g)
        same_fwd = torch.equal(y, torch.nn.functional.pad(x, (pad,) * 4, mode="replicate"))
        same = torch.equal(ours.grad, theirs.grad)

        def fwd_bwd(fn):
            xx = x.clone().requires_grad_(True)
            return lambda: torch.autograd.grad(fn(xx), xx, g)

        ours_ms = cuda_ms(fwd_bwd(ReplicationPad2d(pad)), iters=10)
        with deterministic_training():
            sorted_ms = cuda_ms(fwd_bwd(lambda t: _replication_pad(t, (pad,) * 4)), iters=10)
        atomic_ms = cuda_ms(fwd_bwd(lambda t: torch.nn.functional.pad(t, (pad,) * 4,
                                                                       mode="replicate")),
                            iters=10)
        print(f"replication padding {tuple(shape)} by {pad} (bf16): output equal to torch's "
              f"{same_fwd}, gradient bit-equal to the mode's formulation {same}; forward + "
              f"backward {ours_ms:.4f} ms, the mode's formulation (sorted index_put_) "
              f"{sorted_ms:.4f} ms, torch's own (atomics) {atomic_ms:.4f} ms", flush=True)
        if not (same_fwd and same):
            raise SystemExit("the encoders' replication padding differs from torch's")


# The first full-width step with the flag on against the one with it off:
# the same weights, draws and batch. The two bf16 programs round `pw` and the
# encoding at other places and take sin / cos another way (see the render
# bounds above). With seeded random weights the rendered patch is almost
# black, so the loss terms hardly feel it (a few f32 ulps); the gradient
# norm does. Each program is deterministic, so the difference is one
# reading, not a spread (before the step was deterministic, float atomics
# moved the flag-off step's grad_norm by 1.1e-3 between runs and the bounds
# were 2e-6 and 3.5e-3). Readings on an NVIDIA H100 80GB HBM3 (700 W),
# about doubled; relative:
FUSED_STEP_LOSS_BOUND = 1e-6         # measured 3.12e-7 (e_pix_l1)
FUSED_STEP_GRAD_NORM_BOUND = 1.75e-3  # measured 8.62e-4


def compare_first_steps(off, on) -> None:
    rel = {k: abs(on[k] - v) / max(abs(v), 1e-12) for k, v in off.items()}
    loss = max(v for k, v in rel.items() if k != "grad_norm")
    print(f"first training step, flag on vs off, relative: "
          f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} }; off {off}; on {on} "
          f"(bounds: loss terms {FUSED_STEP_LOSS_BOUND}, grad_norm "
          f"{FUSED_STEP_GRAD_NORM_BOUND})", flush=True)
    if not (loss <= FUSED_STEP_LOSS_BOUND and rel["grad_norm"] <= FUSED_STEP_GRAD_NORM_BOUND):
        raise SystemExit("the flag-on training step deviates from the flag-off step")


# The first zju step of two ranks (local batch 1, gloo on one card) against
# one process on their global batch of 2: the same weights, draws and
# samples, another program (each rank's gradient all-reduced and halved,
# against autograd's sum of the two samples' halves), so the last bits of
# some leaves differ, the same in every run. Gradients are held by the
# relative L2 distance of the whole gradient, grad_norm, and the worst leaf
# among those whose largest entry is at least 1e-3 of the top one (below
# that, a leaf is the rounding noise of a bias feeding a norm). Readings on
# an NVIDIA H100 80GB HBM3 (700 W), about doubled, with an f32 ulp's room
# where the reading is 0 (before the step was deterministic these bounds,
# shared with remat, were 0.0, 7e-3, 2.5e-3 and 3.5e-2):
TWO_RANK_LOSS_BOUND = 0.0           # measured 0 (loss terms bit-equal)
TWO_RANK_GRAD_L2_BOUND = 3e-8       # measured 1.29e-8 (230 of 248 leaves bit-equal)
TWO_RANK_GRAD_NORM_BOUND = 1.2e-7   # measured 0
TWO_RANK_LEAF_BOUND = 2e-7          # measured 8.80e-8


def compare_first_step_grads(off, run, what) -> None:
    """`run`'s first step (loss terms, the gradient) against the reference
    run `off`'s (one process), by the TWO_RANK bounds."""
    loss = max(abs(run["first"][k] - v) / max(abs(v), 1e-12)
               for k, v in off["first"].items() if k != "grad_norm")
    top = max(g.abs().max().item() for g in off["grads"].values())
    num = den = 0.0
    rows = []
    for name, b in off["grads"].items():
        a = run["grads"][name]
        if not bool(torch.isfinite(a).all()):
            raise SystemExit(f"{what}: gradient {name} is not finite")
        num += float(((a.double() - b.double()) ** 2).sum())
        den += float((b.double() ** 2).sum())
        scale = b.abs().max().item()
        if scale >= 1e-3 * top:
            rows.append(((a - b).abs().max().item() / scale, name))
    l2 = math.sqrt(num / den)
    gn = abs(run["first"]["grad_norm"] - off["first"]["grad_norm"]) / off["first"]["grad_norm"]
    worst = max(rows)[0]
    same = sum(int(torch.equal(b, run["grads"][n])) for n, b in off["grads"].items())
    print(f"first zju step, {what} vs the reference run: {same} of {len(off['grads'])} gradient "
          f"leaves bit-equal, loss terms equal {run['first'] == off['first']}", flush=True)
    print(f"first zju step, {what} vs the reference run: loss terms {loss:.3e} relative "
          f"(bound {TWO_RANK_LOSS_BOUND}); gradient relative L2 {l2:.3e} (bound "
          f"{TWO_RANK_GRAD_L2_BOUND}), grad_norm {gn:.3e} (bound {TWO_RANK_GRAD_NORM_BOUND}), "
          f"worst of {len(rows)} leaves {worst:.3e} of its max (bound {TWO_RANK_LEAF_BOUND}): "
          f"{[(f'{r:.2e}', n) for r, n in sorted(rows, reverse=True)[:3]]}", flush=True)
    if not (loss <= TWO_RANK_LOSS_BOUND and l2 <= TWO_RANK_GRAD_L2_BOUND
            and gn <= TWO_RANK_GRAD_NORM_BOUND and worst <= TWO_RANK_LEAF_BOUND):
        raise SystemExit(f"{what} deviates from the reference step")


TRAINER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"
TRAINER_DIR_WORKERS = TRAINER_DIR.with_name("chip_smoke_trainer_workers")
TRAINER_ARGS = ["--config", str(ZJU_CONFIG), "--allow_random_vgg", "--out_dir", str(TRAINER_DIR),
                "--set", "data.dataset=synthetic", "data.image_size=512", "max_epochs=1",
                "log_every_steps=2", "val_every_steps=4", "ckpt_every_steps=4"]
# the re-scored PNG tree against run_eval's scores: both images are rounded
# to 8 bits in the PNGs (the CPU test measures 0.024 dB / 9e-5 at 32²)
RESCORE_PSNR_BOUND, RESCORE_SSIM_BOUND = 0.1, 2e-3


def state_on_host(state) -> dict:
    """A TrainState's model and optimizer tensors, copied to the host."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x
    return host({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                 "counters": (state.step, state.updates, state.mini_step)})


def same_tree(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def trainer_cli(bare_s_per_step) -> None:
    """The port's CLI, `python -m keypointnerf_torch.train`'s main(), at
    full width on the synthetic 512² rig: 8 steps (logs every 2, val and a
    checkpoint every 4), a second call that resumes at 8 and ends at 10,
    --run_val on the best step, and eval_zju on its PNG tree."""
    import shutil

    from keypointnerf_torch import eval_zju
    from keypointnerf_torch import train as cli
    from keypointnerf_torch.training import TrainState

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    run = TRAINER_DIR / "zju"
    t0 = time.perf_counter()
    first = cli.main(TRAINER_ARGS + ["--max_steps", "8"])
    wall = time.perf_counter() - t0
    saved = state_on_host(first.state)
    best = first.ckpt.best_step()
    del first
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = {r["step"]: r for r in rows if "train/e_all" in r}
    val = {r["step"]: r for r in rows if "val/total_loss" in r}
    ckpts = sorted(int(p.name) for p in (run / "ckpts").iterdir() if p.name.isdigit())
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    want_best = min((r["val/total_loss"], s) for s, r in val.items())[1] if val else None
    print(f"trainer, first call (--max_steps 8): {wall:.2f} s wall; train/ rows at "
          f"{sorted(train)}, val/ rows at {sorted(val)} (val/total_loss "
          f"{ {s: r['val/total_loss'] for s, r in val.items()} }), all finite: {finite}; "
          f"checkpoints {ckpts}, best step {best} (lower val loss at {want_best})", flush=True)
    if sorted(train) != [2, 4, 6, 8] or sorted(val) != [4, 8] or not finite:
        raise SystemExit("metrics.jsonl lacks finite train/ rows at 2, 4, 6, 8 and val/ at 4, 8")
    if ckpts != [4, 8] or best != want_best:
        raise SystemExit("checkpoints 4 and 8 with the best at the lower val loss are missing")

    restored = []
    load = TrainState.load_state_dict

    def keeping(self, d):
        load(self, d)
        restored.append(state_on_host(self))

    TrainState.load_state_dict = keeping
    try:
        second = cli.main(TRAINER_ARGS + ["--max_steps", "10"])
    finally:
        TrainState.load_state_dict = load
    exact = len(restored) == 1 and same_tree(restored[0], saved)
    print(f"trainer, second call (--max_steps 10): resumed {len(restored)} time(s), restored "
          f"state (counters {restored[0]['counters'] if restored else None}) equal to the "
          f"saved step 8 bit for bit: {exact}; ends at step {second.state.step}", flush=True)
    if not exact or second.state.step != 10:
        raise SystemExit("the second call did not resume step 8 exactly and end at 10")
    del second, restored, saved

    third = cli.main(TRAINER_ARGS + ["--run_val"])
    yml = dict(line.split(": ") for line in
               open(run / f"test_v3_{third.state.step}.yml").read().splitlines())
    scored = sum(1 for _ in (run / "images_v3").glob("*/pred/*.png"))
    psnr, ssim = float(yml["psnr"]), float(yml["ssim"])
    rescored = eval_zju.main(["--src_dir", str(run / "images_v3")])
    d_psnr, d_ssim = abs(rescored["psnr"] - psnr), abs(rescored["ssim"] - ssim)
    print(f"trainer, --run_val: restored step {third.state.step} (best {best}), {scored} "
          f"samples scored, PSNR {psnr} / SSIM {ssim}; eval_zju re-scores the PNG tree: "
          f"PSNR {rescored['psnr']} / SSIM {rescored['ssim']} (|diff| {d_psnr:.4f} dB, "
          f"{d_ssim:.2e}; bounds {RESCORE_PSNR_BOUND}, {RESCORE_SSIM_BOUND})", flush=True)
    if (third.state.step != best or scored != 2 or not (math.isfinite(psnr)
                                                          and math.isfinite(ssim))):
        raise SystemExit("--run_val did not score 2 samples of the best step with finite scores")
    if not (d_psnr <= RESCORE_PSNR_BOUND and d_ssim <= RESCORE_SSIM_BOUND):
        raise SystemExit("eval_zju's re-scored tree disagrees with run_eval's scores")
    del third

    loop = [train[s]["train/step_time_s"] for s in (4, 6, 8)]
    data = [train[s]["train/data_time_s"] for s in (4, 6, 8)]
    print(f"trainer loop (StepTimer, log windows at 4, 6, 8): {loop} s/step, mean "
          f"{sum(loop) / 3:.4f} (the window at 6 holds the val and the save at 4); the bare "
          f"step of the train phase {bare_s_per_step} s/step; "
          f"host making samples {data} s/step, {sum(data) / sum(loop):.3f} of the loop's wall "
          f"clock", flush=True)

    # the same first call with 4 loader workers (the native prefetcher)
    shutil.rmtree(TRAINER_DIR_WORKERS, ignore_errors=True)
    pooled = cli.main(TRAINER_ARGS + ["data.num_workers=4", "--out_dir",
                                      str(TRAINER_DIR_WORKERS), "--max_steps", "8"])
    rows = [json.loads(line) for line in open(TRAINER_DIR_WORKERS / "zju" / "metrics.jsonl")]
    train_w = {r["step"]: r for r in rows if "train/e_all" in r}
    loop_w = [train_w[s]["train/step_time_s"] for s in (4, 6, 8)]
    data_w = [train_w[s]["train/data_time_s"] for s in (4, 6, 8)]
    print(f"trainer loop with data.num_workers=4: {loop_w} s/step, mean {sum(loop_w) / 3:.4f} "
          f"(inline {sum(loop) / 3:.4f}); host making samples {data_w} s/step, "
          f"{sum(data_w) / sum(loop_w):.3f} of the loop (inline {sum(data) / sum(loop):.3f})",
          flush=True)
    if pooled.state.step != 8 or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise SystemExit("the trainer with 4 loader workers did not train 8 finite steps")


def train_agreement_small(dev, radiance_bias=0.0, **overrides) -> None:
    """One toy f32 zju-recipe step on the card against the same step on the
    CPU (the path the CPU tests hold against the JAX package); `overrides`
    are config fields, e.g. use_pallas_geo_mlp=True; `radiance_bias` is
    added to every radiance channel's bias."""
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
        model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += radiance_bias
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


# ------------------------------------------------- the rest of the model
# the synthetic rig's image size for the new phases' renders, steps, the
# Trainer and the eval
RIG = 512


def strict_query_launches(n_rays, ratio=0.1875, chunk=2048) -> int:
    """A query kernel's launches in the strict render of `n_rays` rays
    culled to `ratio`: two queries (coarse, fine) a chunk of the marched
    rays (the renderer's budget arithmetic; chunks of min(chunk, n_rays),
    as a sharded render's share takes them)."""
    marched = max(1, min(n_rays, -int(-n_rays * ratio // 1)))
    return 2 * math.ceil(marched / min(chunk, n_rays))
# K5 with separate_cf's three outputs [sdf, rad_c, rad_f] at the strict
# render's query: the coarse query (2048 rays x 64 samples) and, since the
# coarse-value reuse is off under separate_cf, the fine query over the
# union (2048 x 128); the bf16 bounds of check_fused_geo_mlp (worst 5e-3,
# mean 1e-6 of an output's max).
DOUT3_DIMS2 = GEO_DIMS2[:-1] + (GEO_DIMS2[-1] + 1,)


def check_k5_three_outputs(dev) -> dict:
    """K5 at 3 outputs against its plain version, bf16 products, with its
    time, the plain version's and the bound; returns those numbers."""
    from keypointnerf_torch.models.spatial_encoding import SpatialEncodingConfig, spatial_encode
    from keypointnerf_torch.ops import fused_geo_mlp as fg

    mlp = seeded_geo_mlp(dev, seed=5, dims2=DOUT3_DIMS2)
    enc = SpatialEncodingConfig()
    with torch.no_grad():
        ws = [w.clone() for w in fg.fold_weight_norm(mlp)]
    V, K, bf = 3, 24, torch.bfloat16
    names = ("out", "valid", "latent_view", "latent_fused")
    res = {}
    for N in (2048 * 64, 2048 * 128):
        x = geo_mlp_inputs(dev, N, seed=N + 3)
        lead, rest = (x["pts_cam"], x["kpt_cam"]), (x["f0"], x["f1"], x["mask"], x["weight"])
        by_route = fg.sp_geo_mlp_apply.launches_by_route
        by_route.update(dict.fromkeys(by_route, 0))
        with torch.no_grad():
            got = fg.sp_geo_mlp_apply(ws, *lead, *rest, compute_dtype=bf)
            ref = fg.sp_mlp_stack_plain(*lead, *rest, ws, compute_dtype=bf)
        torch.cuda.synchronize()
        routes = {k: v for k, v in by_route.items() if v}
        worst = mean = abs_err = 0.0
        for name, a, b in zip(names, ref, got):
            if a.shape != b.shape:
                raise SystemExit(f"K5 at 3 outputs, {name}: shape differs")
            if name == "valid":
                if not torch.equal(a, b):
                    raise SystemExit("K5 at 3 outputs: valid differs from the plain version")
                continue
            if not bool((torch.isfinite(a) & torch.isfinite(b)).all()):
                raise SystemExit(f"K5 at 3 outputs, {name}: not finite")
            scale = a.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / scale)
            mean = max(mean, (a - b).abs().mean().item() / scale)
            abs_err = max(abs_err, (a - b).abs().max().item())
        with torch.no_grad():
            ms = cuda_ms(lambda: fg.sp_geo_mlp_apply(ws, *lead, *rest, compute_dtype=bf),
                         iters=10)
            plain_ms = cuda_ms(lambda: fg.sp_mlp_stack_plain(*lead, *rest, ws, compute_dtype=bf),
                               iters=3, warmup=1)

            def module_path():
                # what the kernel replaces in query_points: spatial_encode +
                # GeoFusionMLP.forward in bf16 (check_fused_geo_mlp's module path)
                sp = spatial_encode(enc, None, x["pts_cam"], None, x["kpt_cam"])
                return mlp(sp.to(bf), [x["f0"].to(bf), x["f1"].to(bf)], x["mask"].to(bf),
                           x["weight"].to(bf))

            module_ms = cuda_ms(module_path, iters=3, warmup=1)
        n_bytes = 4 * (sum(t.numel() for t in (*lead, *rest)) + sum(w.numel() for w in ws)
                       + N * (V * GEO_DIMS1[4] + 2 * GEO_DIMS1[4] + DOUT3_DIMS2[3] + 1))
        b = geo_mlp_bound(N, V, K, True, geo_mlp_op_counts(), n_bytes, dims2=DOUT3_DIMS2)
        print(f"K5 at 3 outputs (separate_cf), V={V} N={N} bf16, routes {routes}: worst error "
              f"{worst:.3e} of an output's max (bound 5e-3), mean {mean:.3e} (bound 1e-6); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, module path (spatial_encode + "
              f"GeoFusionMLP.forward, bf16, no_grad) {module_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['binds']})", flush=True)
        if routes != {"wgmma": 1}:
            raise SystemExit("K5 at 3 outputs did not take the wgmma route")
        if not (worst <= 5e-3 and mean <= 1e-6):
            raise SystemExit("K5 at 3 outputs disagrees with its plain version")
        res[str(N)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                           bound_by=b["bound_by"], max_abs_err=abs_err,
                           module_path_ms=module_ms)
    return res


def strict_camera(dev, **flags):
    """The render phase's 512² strict camera (orbit angle 0, 3 views of the
    synthetic rig, chunk 2048) with config fields `flags`, seeded weights
    with every radiance channel's bias raised by 2.0; (cfg, model, vb)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset

    cfg = dataclasses.replace(strict_preset(KeypointNeRFConfig()), **flags)
    R, t = orbit_camera(0.0)
    sample = dict(make_sample(SyntheticConfig(image_size=RIG, n_views=4), seed=0), tar_R=R,
                  tar_t=t)
    vb = ViewBatch.from_numpy(sample, device=dev)
    model = KeypointNeRF(cfg, device=dev, seed=0)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0
    return cfg, model, vb


def render_model_rest(dev) -> dict:
    """The rest of the model at full width on the 512² strict camera: each
    attention pool, separate_cf (culled == unculled bit for bit), and
    separate_cf with use_pallas_geo_mlp (K5 at 3 outputs, 48 launches)
    against separate_cf without it; returns K5's and K2's launches."""
    from keypointnerf_torch.models import KeypointNeRF
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.ops import sp_geo_mlp_apply as k5
    from keypointnerf_torch.render import render_image

    size, chunk = RIG, 2048

    def timed(model, vb, what):
        render_image(model, vb, height=size, width=size, chunk=chunk)      # warm-up
        k2.launches = k5.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(model, vb, height=size, width=size, chunk=chunk)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        overflow = float(out["cull_overflow"].max())
        print(f"render 512² strict bf16, {what}: {seconds:.4f} s, {size * size / seconds:.1f} "
              f"rays/s; cull_overflow={overflow}; K2 launches {k2.launches}, K5 "
              f"{k5.launches}; all finite {finite}; acc_fine>0 rays "
              f"{int((out['acc_fine'] > 0).sum())}", flush=True)
        if not finite or overflow != 0.0:
            raise SystemExit(f"{what}: outputs not finite or cull_overflow != 0")
        return out, dict(k2=k2.launches, k5=k5.launches, seconds=seconds)

    launches, want = {}, strict_query_launches(size * size)
    for mode in ("attention_v0", "attention_v1"):
        _, model, vb = strict_camera(dev, pool_mode=mode)
        _, n = timed(model, vb, f"pool_mode={mode}")
        if n["k2"] != want:
            raise SystemExit(f"K2 must run once a query ({want} a camera)")
        del model
    cfg, model, vb = strict_camera(dev, separate_cf=True)
    out, n = timed(model, vb, "separate_cf")
    full = KeypointNeRF(dataclasses.replace(cfg, cull_empty_rays_ratio=1.0), device=dev, seed=0)
    full.load_state_dict(model.state_dict())
    feats = model.encode(vb.src_images, vb.src_masks)
    culled = render_image(model, vb, height=size, width=size, chunk=chunk, feats=feats)
    unculled = render_image(full, vb, height=size, width=size, chunk=chunk, feats=feats)
    differ = [k for k in unculled if not torch.equal(unculled[k], culled[k])]
    print(f"separate_cf: culled vs unculled 512² render "
          f"{'bit-equal' if not differ else 'DIFFER ' + str(differ)}", flush=True)
    if differ:
        raise SystemExit("separate_cf: the culled render differs from the unculled render")
    del full, feats, culled, unculled
    k5_model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=True), device=dev,
                            seed=0)
    k5_model.load_state_dict(model.state_dict())
    k5_out, n5 = timed(k5_model, vb, "separate_cf + use_pallas_geo_mlp (K5 at 3 outputs)")
    if n5["k5"] != want or n5["k2"] != want:
        raise SystemExit(f"K5 and K2 must each run once a query ({want} a camera)")
    sep = compare_renders(out, k5_out, "512² separate_cf render, K5 on vs off",
                          K5_SEPARATE_CF_RENDER_BOUNDS)
    launches["sp_fused_geo_mlp"] = n5["k5"]
    print(f"separate_cf render {n['seconds']:.4f} s, with K5 {n5['seconds']:.4f} s", flush=True)
    mismatched_rays(out, k5_out)
    sep_opaque = (opaque_rays(out), opaque_rays(k5_out))
    del model, k5_model, out, k5_out
    union_k5_render(dev, timed, sep, sep_opaque)
    return launches


def tied_separate_cf(model, cfg):
    """A separate_cf model with `model`'s weights (2 outputs) and the third
    output's row of the last geometry layer a copy of the second's: rad_f ==
    rad_c, so it renders what `model` renders with reuse_coarse_eval off."""
    from keypointnerf_torch.models import KeypointNeRF

    tied = KeypointNeRF(dataclasses.replace(cfg, separate_cf=True), device=model.device)
    state = {}
    for k, v in model.state_dict().items():
        want = tied.state_dict()[k].shape
        state[k] = v if v.shape == want else torch.cat([v, v[1:2]], dim=0)
    tied.load_state_dict(state)
    return tied


def opaque_rays(out, which="fine") -> int:
    """Rays a pass makes opaque: acc > 0.5."""
    return int((out[f"acc_{which}"] > 0.5).sum())


def mismatched_rays(ref, got) -> None:
    """Where separate_cf's K5 render deviates: its rays whose rgb_fine is
    off by more than 1% of the output's max, and how many of them the
    coarse pass leaves transparent (acc_coarse <= 0.5) while the fine pass
    makes them opaque (acc_fine > 0.5)."""
    a, b = ref["rgb_fine"].float(), got["rgb_fine"].float()
    off = ((a - b).abs() / a.abs().max()).reshape(-1, a.shape[-1]).amax(-1) > 0.01
    split = ((ref["acc_coarse"] <= 0.5) & (ref["acc_fine"] > 0.5)).reshape(-1)
    print(f"separate_cf, K5 on vs off: {int(off.sum())} rays off by > 1% in rgb_fine, "
          f"{int((off & split).sum())} of them transparent in the coarse pass and opaque in "
          f"the fine ({int(split.sum())} such rays of {split.numel()})", flush=True)


def raise_bias_until(model, vb, channel, count, target) -> float:
    """Raise the last geometry layer's bias of output `channel` by the least
    amount (within 1/8, at most 8) at which `count(render)` of the flag-off
    render reaches `target`; leaves it raised and returns the amount."""
    from keypointnerf_torch.render import render_image

    bias = model.mlp_geo.layers2.layers[-1].linear.bias
    base = bias.detach().clone()
    feats = model.encode(vb.src_images, vb.src_masks)

    def reached(extra):
        with torch.no_grad():
            bias.copy_(base)
            bias[channel] += extra
        return count(render_image(model, vb, height=RIG, width=RIG, chunk=2048,
                                  feats=feats)) >= target

    lo, hi = 0.0, 8.0
    if not reached(hi):
        raise SystemExit(f"raising output {channel}'s bias by {hi} does not reach {target}")
    if reached(lo):
        hi = lo
    while hi - lo > 1 / 8:
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if reached(mid) else (mid, hi)
    reached(hi)
    return hi


def within(dev, bounds) -> bool:
    return dev[0] <= bounds[0] and dev[1] <= bounds[1]


def union_k5_render(dev, timed, sep, sep_opaque) -> None:
    """Why the separate_cf K5 render (its deviation `sep`; `sep_opaque` the
    opaque rays of its fine pass, K5 off and on) sits above
    K5_RENDER_BOUNDS. Each render K5 on against off:
    (1) the same camera with 2 outputs and reuse_coarse_eval=False (the fine
    pass evaluates the 128-depth union, as separate_cf's does);
    (2) the separate_cf model with rad_f's row tied to rad_c's
    (tied_separate_cf): (1)'s scene through the 3-output path, so its
    deviation against (1)'s tests that path, and the flag-off tied render
    against (1)'s flag-off render tests the modules';
    (3) (1) with its radiance bias raised (raise_bias_until) until its fine
    pass makes as many rays opaque as separate_cf's: the opaque area alone;
    (4) separate_cf with rad_c's bias raised until its coarse pass makes as
    many rays opaque as its fine pass: the same 3-output path, rad_f as it
    is, without the rays the coarse pass leaves transparent and the fine
    pass makes opaque (their fine samples are drawn from a near-empty
    coarse pdf, which rounding moves).
    (3) is printed; separate_cf may sit above K5_RENDER_BOUNDS only where
    (4) holds inside them, which shows the deviation to be those
    rays', not the 3-output path's. All are held at
    K5_SEPARATE_CF_RENDER_BOUNDS."""
    from keypointnerf_torch.models import KeypointNeRF

    cfg, model, vb = strict_camera(dev, reuse_coarse_eval=False)
    off, _ = timed(model, vb, "reuse_coarse_eval=False (2 outputs)")
    k5_model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=True), device=dev,
                            seed=0)
    k5_model.load_state_dict(model.state_dict())
    on, n5 = timed(k5_model, vb, "reuse_coarse_eval=False + use_pallas_geo_mlp (K5, 2 outputs)")
    del k5_model
    tied = tied_separate_cf(model, cfg)
    tied_off, _ = timed(tied, vb, "separate_cf with rad_f tied to rad_c")
    tied_k5 = tied_separate_cf(model, dataclasses.replace(cfg, use_pallas_geo_mlp=True))
    tied_on, n3 = timed(tied_k5, vb, "separate_cf with rad_f tied to rad_c + K5 at 3 outputs")
    del tied, tied_k5

    hi = raise_bias_until(model, vb, 1, opaque_rays, sep_opaque[0])
    area_off, _ = timed(model, vb, f"2 outputs, union, radiance bias +{hi:.4f} more")
    k5_model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=True), device=dev,
                            seed=0)
    k5_model.load_state_dict(model.state_dict())
    area_on, _ = timed(k5_model, vb, f"2 outputs, union, radiance bias +{hi:.4f} more + K5")
    del k5_model, model
    cfg, model, vb = strict_camera(dev, separate_cf=True)
    c_hi = raise_bias_until(model, vb, 1, functools.partial(opaque_rays, which="coarse"),
                            sep_opaque[0])
    matched_off, _ = timed(model, vb, f"separate_cf, rad_c's bias +{c_hi:.4f} more")
    k5_model = KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=True), device=dev,
                            seed=0)
    k5_model.load_state_dict(model.state_dict())
    matched_on, _ = timed(k5_model, vb, f"separate_cf, rad_c's bias +{c_hi:.4f} more + K5")
    del model, k5_model
    print(f"separate_cf with rad_c's bias raised: opaque rays coarse "
          f"{opaque_rays(matched_off, 'coarse')}, fine {opaque_rays(matched_off)}", flush=True)
    print(f"fine-pass opaque rays (acc_fine > 0.5), K5 off / on: separate_cf {sep_opaque}, "
          f"2 outputs union {opaque_rays(off), opaque_rays(on)}, 3 outputs tied "
          f"{opaque_rays(tied_off), opaque_rays(tied_on)}, opaque area matched "
          f"{opaque_rays(area_off), opaque_rays(area_on)}", flush=True)
    rows = {}
    for what, ref, got in (
            ("2 outputs, the 128-depth union, K5 on vs off", off, on),
            ("3 outputs tied, K5 on vs off", tied_off, tied_on),
            ("3 outputs tied vs 2 outputs, flag off", off, tied_off),
            ("3 outputs tied vs 2 outputs, K5", on, tied_on),
            ("2 outputs, opaque area matched, K5 on vs off", area_off, area_on),
            ("separate_cf, coarse opacity matched, K5 on vs off", matched_off, matched_on)):
        same = all(torch.equal(ref[k], got[k]) for k in ref)
        rows[what] = (0.0, 0.0) if same else render_deviation(ref, got, f"512² {what}")
        print(f"512² {what}: {'bit-equal' if same else 'worst mean %.3e, worst share %.3e' % rows[what]}",
              flush=True)
    rows["separate_cf, K5 on vs off"] = sep
    for what in ("2 outputs, the 128-depth union, K5 on vs off", "3 outputs tied, K5 on vs off",
                 "2 outputs, opaque area matched, K5 on vs off",
                 "separate_cf, coarse opacity matched, K5 on vs off", "separate_cf, K5 on vs off"):
        print(f"{what}: K5_RENDER_BOUNDS {K5_RENDER_BOUNDS} "
              f"{'held' if within(rows[what], K5_RENDER_BOUNDS) else 'exceeded'}", flush=True)
        if not within(rows[what], K5_SEPARATE_CF_RENDER_BOUNDS):
            raise SystemExit(f"{what}: beyond K5_SEPARATE_CF_RENDER_BOUNDS "
                             f"{K5_SEPARATE_CF_RENDER_BOUNDS}")
    matched = rows["separate_cf, coarse opacity matched, K5 on vs off"]
    if not within(sep, K5_RENDER_BOUNDS) and not within(matched, K5_RENDER_BOUNDS):
        raise SystemExit("separate_cf's K5 render exceeds K5_RENDER_BOUNDS with its coarse pass "
                         "as opaque as its fine pass too: the cause is not shown")
    print(f"K5 launches: 2 outputs {n5['k5']}, 3 outputs tied {n3['k5']}", flush=True)


# ------------------------------------------------------ more than one device
PARALLEL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_parallel"
PARALLEL_TRAINER_SET = {"data.dataset": "synthetic", "max_epochs": 1,
                        "val_every_steps": 2, "ckpt_every_steps": 2, "log_every_steps": 2,
                        "data.max_len_val": 2}


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def zju_step_parts(dev):
    """The zju recipe's step at full width: the config, a seeded model with
    the radiance bias raised (as train_full_width), the random frozen VGG19
    and the recipe's loss and optimizer sections."""
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features
    from keypointnerf_torch.utils import load_config

    cfg = zju_config()
    model = KeypointNeRF(cfg, device=dev, seed=0)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0
    return cfg, model, VGG19Features(device=dev, seed=42), load_config(str(ZJU_CONFIG))


def rig_sample(dev, seed):
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import ViewBatch

    return ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=RIG, n_views=4),
                                            seed=seed), device=dev)


def one_rank_nccl_step(dev) -> None:
    """The zju step at full width in a one-rank NCCL group: the gradients
    and loss terms after the all-reduce are bit-equal to the step's own
    (the reduction is the identity), and the parameters to those of the
    update made without a group from the same gradients;
    then s/step with and without the group."""
    import torch.distributed as dist

    from keypointnerf_torch.ops import multiview_dmap_onehot as k1
    from keypointnerf_torch.parallel import AUDIT, format_inventory, free_port, train_parallel
    from keypointnerf_torch.training import (TrainDraws, apply_gradients, create_train_state,
                                             global_norm, train_batch_step_fn)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0, device_id=dev)
    print(f"one-rank group: backend {dist.get_backend()}, world {dist.get_world_size()}",
          flush=True)
    try:
        cfg, model, vgg, recipe = zju_step_parts(dev)
        _, twin, _, _ = zju_step_parts(dev)
        state = create_train_state(model, recipe.optim, vgg)
        twin_state = create_train_state(twin, recipe.optim, vgg)
        vb = rig_sample(dev, 0)
        draws = [TrainDraws.sample(cfg, vb, torch.Generator(device=dev).manual_seed(0))]
        seen = {}
        reduce = train_parallel.reduce_step

        def capturing(grads, err, group):
            seen["in"] = ([g.clone() for g in grads], {k: v.clone() for k, v in err.items()})
            out = reduce(grads, err, group)
            seen["out"] = ([g.clone() for g in out[0]], dict(out[1]))
            return out

        train_parallel.reduce_step = capturing
        AUDIT.reset()
        k1.launches = 0
        try:
            err = train_batch_step_fn(model, recipe.loss, state, [vb], draws,
                                      group=dist.group.WORLD)
        finally:
            train_parallel.reduce_step = reduce
        inv = AUDIT.inventory()
        (g_in, e_in), (g_out, e_out) = seen["in"], seen["out"]
        grads_equal = all(torch.equal(a, b) for a, b in zip(g_in, g_out))
        terms_equal = all(torch.equal(e_in[k].float(), e_out[k]) for k in e_in)
        norm_equal = torch.equal(err["grad_norm"], global_norm(g_in))
        apply_gradients(twin_state, list(twin.parameters()), g_in)
        params_equal = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                              twin.parameters()))
        param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"one-rank NCCL step: reduced gradients bit-equal to the step's own "
              f"{grads_equal}, loss terms {terms_equal}, grad_norm {norm_equal}, parameters "
              f"bit-equal to the update without a group {params_equal}; K1 launches "
              f"{k1.launches}; collectives:\n{format_inventory(inv)}", flush=True)
        want = {"grads": {"op": "all_reduce", "calls": 1, "bytes": param_bytes},
                "loss_terms": {"op": "all_reduce", "calls": 1, "bytes": 16}}
        if not (grads_equal and terms_equal and norm_equal and params_equal):
            raise SystemExit("the one-rank NCCL step differs from the step without a group")
        if inv != want or k1.launches != k1_per_step(cfg):
            raise SystemExit("the one-rank step's collectives or K1 launches are not the "
                             "expected ones")
        times = {}
        for name, group in (("with the group", dist.group.WORLD), ("without", None)):
            per = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_batch_step_fn(model, recipe.loss, state, [vb], draws, group=group)
                torch.cuda.synchronize()
                per.append(time.perf_counter() - t0)
            times[name] = per
        print(f"zju step s/step, one-rank NCCL group {[round(t, 4) for t in times['with the group']]}"
              f", no group {[round(t, 4) for t in times['without']]}", flush=True)
    finally:
        dist.destroy_process_group()


def global_batch_step(dev) -> dict:
    """The first zju step of one process on the global batch of the two
    ranks' samples (rig seeds 0 and 1), draws by slot from the step's
    generator: loss terms, the gradient (host, by name), the parameters
    after the update (host), s/step, peak."""
    from keypointnerf_torch.parallel import slot_draws
    from keypointnerf_torch.training import create_train_state, step_generator, train_batch_step_fn
    from keypointnerf_torch.training import train as train_module

    cfg, model, vgg, recipe = zju_step_parts(dev)
    state = create_train_state(model, recipe.optim, vgg)
    batch = [rig_sample(dev, 0), rig_sample(dev, 1)]
    draws = slot_draws(cfg, batch, step_generator(0, 0, dev), 2, 0)
    names = [n for n, _ in model.named_parameters()]
    grads, updated = {}, []
    apply = train_module.apply_gradients

    def keeping(st, params, gs):
        grads.update((n, g.cpu()) for n, g in zip(names, gs))
        apply(st, params, gs)
        updated.extend(p.detach().cpu() for p in params)

    train_module.apply_gradients = keeping
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        err = train_batch_step_fn(model, recipe.loss, state, batch, draws)
    finally:
        train_module.apply_gradients = apply
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(first={k: v.item() for k, v in err.items()}, grads=grads, params=updated,
                s_per_step=seconds, peak_bytes=torch.cuda.max_memory_allocated())


def rank_steps(dev, group, r, world) -> dict:
    """2 warm-up and 3 timed data-parallel zju steps on this rank's slot of
    the global batch (local batch 1): per step its time, loss terms, K1
    launches, collectives and a digest of the parameters; the first step's
    reduced gradient (rank 0, host), the timed steps' peak memory, and K1's
    time at the first step's own two calls, timed by both ranks at once
    (after a barrier) as they share the card."""
    from keypointnerf_torch.ops import multiview_dmap_onehot as k1
    from keypointnerf_torch.ops import onehot_dmap as k1_module
    from keypointnerf_torch.parallel import AUDIT, barrier, make_global_batch, slot_draws
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.training import create_train_state, step_generator, train_batch_step_fn
    from keypointnerf_torch.training import train as train_module

    cfg, model, vgg, recipe = zju_step_parts(dev)
    state = create_train_state(model, recipe.optim, vgg)
    batch = make_global_batch([make_sample(SyntheticConfig(image_size=RIG, n_views=4), seed=r)],
                              dev)
    names = [n for n, _ in model.named_parameters()]
    res = {"steps": []}
    apply = train_module.apply_gradients

    def keeping(st, params, gs):
        if r == 0 and "grads" not in res:
            res["grads"] = {n: g.cpu() for n, g in zip(names, gs)}
        apply(st, params, gs)

    k1_inputs = []

    def capturing(xy, g, H, W, map_dtype=torch.bfloat16):
        k1_inputs.append((xy.cpu(), g.cpu(), H, W, map_dtype))
        return k1(xy, g, H, W, map_dtype)

    # the wrapper counts its launches on the module's name for it: while
    # `capturing` holds that name, K1's launches count on it
    capturing.launches = 0
    train_module.apply_gradients = keeping
    try:
        for step in range(5):
            # the backward looks K1 up in its module: the first step's calls
            k1_module.multiview_dmap_onehot = capturing if step == 0 else k1
            if step == 2:
                torch.cuda.reset_peak_memory_stats()
            draws = slot_draws(cfg, batch, step_generator(0, step, dev), world, r)
            AUDIT.reset()
            k1.launches = capturing.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            err = train_batch_step_fn(model, recipe.loss, state, batch, draws, group=group)
            torch.cuda.synchronize()
            res["steps"].append(dict(seconds=time.perf_counter() - t0,
                                     terms={k: v.item() for k, v in err.items()},
                                     k1=k1.launches + capturing.launches,
                                     inventory=AUDIT.inventory(),
                                     digest=params_digest(model)))
    finally:
        train_module.apply_gradients = apply
        k1_module.multiview_dmap_onehot = k1
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    calls = [(xy.to(dev), g.to(dev), H, W, dt) for xy, g, H, W, dt in k1_inputs]
    barrier("k1_timing", group)
    res["k1_ms"] = [cuda_ms(lambda c=c: k1(*c), iters=20) for c in calls]
    return res


def rank_render(dev, group, r, world) -> dict:
    """The 512² strict camera sharded over the ranks: its time after a
    warm-up, K2's launches in this rank, the collectives, this rank's rays'
    cull_overflow, and (rank 0) the image."""
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.parallel import AUDIT, make_sharded_render

    _, model, vb = strict_camera(dev)
    render = make_sharded_render(model, group, chunk=2048)
    render(vb, height=RIG, width=RIG)
    k2.launches = 0
    AUDIT.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(vb, height=RIG, width=RIG)
    torch.cuda.synchronize()
    res = dict(seconds=time.perf_counter() - t0, k2=k2.launches, inventory=AUDIT.inventory(),
               overflow=float(out["cull_overflow"].reshape(-1)[r::world].max()))
    if r == 0:
        res["image"] = {k: v.cpu() for k, v in out.items()}
    return res


def rank_trainer(dev, group, r) -> dict:
    """The Trainer at full width on the synthetic 512² rig: 2 steps (a val
    and a checkpoint at 2), then a new Trainer that resumes step 2 and
    trains to 4; whether the restored state is the saved one bit for bit,
    and which writers this rank has."""
    from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset
    from keypointnerf_torch.models import VGG19Features
    from keypointnerf_torch.training import TrainState
    from keypointnerf_torch.training.loop import Trainer
    from keypointnerf_torch.utils import get_model, load_config

    cfg = load_config(str(ZJU_CONFIG), dict(PARALLEL_TRAINER_SET, **{"data.image_size": RIG},
                                             out_dir=str(PARALLEL_DIR / "trainer")))
    vgg = VGG19Features(device=dev)

    def trainer():
        sc = SyntheticConfig(image_size=RIG)
        return Trainer(cfg, get_model(cfg, device=dev), SyntheticDataset(sc, length=64),
                       SyntheticDataset(sc, length=2), vgg=vgg, group=group, tensorboard=False)

    t0 = time.perf_counter()
    first = trainer()
    first.fit(max_steps=2)
    res = dict(first_s=time.perf_counter() - t0, writers=(first.metrics.main, first.ckpt._writes))
    saved = state_on_host(first.state)
    del first
    restored = []
    load = TrainState.load_state_dict

    def keeping(self, d):
        load(self, d)
        restored.append(state_on_host(self))

    TrainState.load_state_dict = keeping
    try:
        second = trainer()
    finally:
        TrainState.load_state_dict = load
    res["exact"] = len(restored) == 1 and same_tree(restored[0], saved)
    res["resume"] = (second.state.step, second._resume_epoch, second._resume_pos)
    del restored, saved
    t0 = time.perf_counter()
    second.fit(max_steps=4)
    res.update(second_s=time.perf_counter() - t0, step=second.state.step,
               digest=params_digest(second.model))
    return res


def eval_config(name):
    from keypointnerf_torch.utils import load_config

    return load_config(str(ZJU_CONFIG), {"data.dataset": "synthetic", "data.image_size": RIG,
                                         "out_dir": str(PARALLEL_DIR), "name": name})


def eval_scores(dev, sharded, group=None):
    """run_eval on 2 synthetic 512² samples (configs/zju.json's model,
    seeded, radiance bias raised), sharded over `group` or not."""
    from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset
    from keypointnerf_torch.evaluation import run_eval
    from keypointnerf_torch.parallel import AUDIT
    from keypointnerf_torch.utils import get_model

    cfg = eval_config("sharded" if sharded else "unsharded")
    model = get_model(cfg, device=dev)
    model.mlp_geo.layers2.layers[-1].linear.bias.data[1:] += 2.0
    AUDIT.reset()
    t0 = time.perf_counter()
    mean = run_eval(cfg, model, SyntheticDataset(SyntheticConfig(image_size=RIG), length=2),
                    sharded=sharded, group=group)
    return dict(mean=mean, seconds=time.perf_counter() - t0, inventory=AUDIT.inventory())


def parallel_rank(r, world, port, backend, out_dir) -> None:
    """One rank of the parallel phase (torch.multiprocessing.spawn): joins
    the group and writes what it measured to out_dir/rank{r}.pt."""
    import torch.distributed as dist

    from keypointnerf_torch.parallel import destroy, initialize_distributed, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(r)
    torch.cuda.set_device(dev)
    initialize_distributed(f"localhost:{port}", world, r, backend, dev)
    group = dist.group.WORLD
    res = {"rank": r, "device": str(dev), "backend": dist.get_backend()}
    try:
        res["step"] = rank_steps(dev, group, r, world)
        torch.cuda.empty_cache()
        res["render"] = rank_render(dev, group, r, world)
        torch.cuda.empty_cache()
        res["trainer"] = rank_trainer(dev, group, r)
        torch.cuda.empty_cache()
        res["eval"] = eval_scores(dev, True, group)
    finally:
        torch.save(res, Path(out_dir) / f"rank{r}.pt")
        destroy()


def parallel_phase(dev) -> dict:
    """The data-parallel paths on the card: the one-rank NCCL step, the
    one-process global-batch step (twice, bit for bit), then two
    ranks (gloo on one card, chosen here and printed; NCCL on two cards
    where there are two) running the step, the sharded render, the
    Trainer and the sharded eval, each held against one process."""
    import shutil

    import torch.multiprocessing as mp

    from keypointnerf_torch.parallel import format_inventory, free_port
    from keypointnerf_torch.render import render_image

    phase("parallel: the zju step in a one-rank NCCL group")
    one_rank_nccl_step(dev)
    torch.cuda.empty_cache()
    phase("parallel: one process at global batch 2, twice, bit for bit")
    ref = global_batch_step(dev)
    again = global_batch_step(dev)
    same_first_step(ref, again, "the one-process global-batch-2 step, run 2")
    print(f"one process, global batch 2: {ref['s_per_step']:.4f} s (first step), peak "
          f"{ref['peak_bytes']} bytes ({ref['peak_bytes'] / 2**30:.2f} GiB)", flush=True)
    del again
    torch.cuda.empty_cache()
    _, model, vb = strict_camera(dev)
    render_image(model, vb, height=RIG, width=RIG, chunk=2048)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = render_image(model, vb, height=RIG, width=RIG, chunk=2048)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single = {k: v.cpu() for k, v in single.items()}
    del model, vb
    torch.cuda.empty_cache()

    world = 2
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    phase(f"parallel: {world} ranks, backend {backend} on "
          f"{'one card each' if backend == 'nccl' else 'one card'}")
    print(f"backend {backend}, chosen for {torch.cuda.device_count()} card(s): two NCCL ranks "
          "cannot share one card; gloo takes CUDA tensors for all-reduce, broadcast and "
          "barrier. Two ranks on one card measure correctness and overhead, not scaling",
          flush=True)
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(parallel_rank, args=(world, free_port(), backend, str(PARALLEL_DIR)),
             nprocs=world, join=True)
    print(f"{world} ranks ran in {time.perf_counter() - t0:.1f} s", flush=True)
    res = [torch.load(PARALLEL_DIR / f"rank{r}.pt", weights_only=False) for r in range(world)]

    # the step
    steps = [x["step"] for x in res]
    for r, st in enumerate(steps):
        timed = [s["seconds"] for s in st["steps"][2:]]
        print(f"rank {r} ({res[r]['device']}, {res[r]['backend']}): s/step "
              f"{[round(s['seconds'], 4) for s in st['steps']]} (timed mean "
              f"{sum(timed) / len(timed):.4f}), peak {st['peak_bytes']} bytes "
              f"({st['peak_bytes'] / 2**30:.2f} GiB), K1 launches a step "
              f"{[s['k1'] for s in st['steps']]}, K1 at the first step's two calls "
              f"{[round(t, 4) for t in st['k1_ms']]} ms (both ranks timing at once); "
              f"step 0 collectives:\n"
              f"{format_inventory(st['steps'][0]['inventory'])}", flush=True)
        want = {"grads": {"op": "all_reduce", "calls": 1, "bytes": st["param_bytes"]},
                "loss_terms": {"op": "all_reduce", "calls": 1, "bytes": 16}}
        if any(s["inventory"] != want for s in st["steps"]):
            raise SystemExit("a data-parallel step's collectives are not one gradient "
                             "all-reduce of the parameter bytes and one of the loss terms")
        if any(s["k1"] != k1_per_step(zju_config()) for s in st["steps"]):
            raise SystemExit(f"K1 must run {k1_per_step(zju_config())} times a sample on "
                             f"each rank")
        if not all(math.isfinite(v) for s in st["steps"] for v in s["terms"].values()):
            raise SystemExit("a data-parallel step's loss is not finite")
    same = [a["digest"] == b["digest"] and a["terms"] == b["terms"]
            for a, b in zip(*(st["steps"] for st in steps))]
    print(f"parameters and loss terms bit-equal across the ranks after each step: {same}",
          flush=True)
    if not all(same):
        raise SystemExit("the ranks' parameters differ")
    two = dict(first=steps[0]["steps"][0]["terms"], grads=steps[0]["grads"],
               s_per_step=steps[0]["steps"][0]["seconds"], peak_bytes=steps[0]["peak_bytes"])
    # the loss terms: each rank's mean all-reduced and halved, against the
    # mean of the two in one process (the same sum, in another program)
    compare_first_step_grads(ref, two, "the two-rank step (local batch 1)")
    del ref, two

    # the render
    ren = [x["render"] for x in res]
    image = ren[0]["image"]
    differ = [k for k in single if not torch.equal(single[k], image[k])]
    print(f"sharded 512² strict render: {[round(x['seconds'], 4) for x in ren]} s a rank = "
          f"{RIG * RIG / max(x['seconds'] for x in ren):.1f} rays/s (one process, before the "
          f"ranks: {single_s:.4f} s = {RIG * RIG / single_s:.1f} rays/s); K2 launches a rank "
          f"{[x['k2'] for x in ren]}; "
          f"cull_overflow of each rank's rays {[x['overflow'] for x in ren]}; against the "
          f"single-process render: {'bit-equal' if not differ else 'differs in ' + str(differ)}"
          f"; collectives a rank: {[x['inventory'] for x in ren]}", flush=True)
    want = strict_query_launches(-(-RIG * RIG // world))
    if any(x["overflow"] != 0.0 for x in ren) or any(x["k2"] != want for x in ren):
        raise SystemExit(f"sharded render: a rank overflowed its cull or K2 did not run "
                         f"{want} times in each")
    if any(x["inventory"] != {"image": {"op": "all_reduce", "calls": 1,
                                        "bytes": x["inventory"]["image"]["bytes"]}}
           for x in ren):
        raise SystemExit("the sharded render's collectives are not one image gather")
    if differ:
        compare_renders(single, image, "sharded vs single-process 512² render",
                        K5_RENDER_BOUNDS)

    # the Trainer
    tr = [x["trainer"] for x in res]
    rows = [json.loads(line) for line in open(PARALLEL_DIR / "trainer" / "zju" / "metrics.jsonl")]
    train = sorted(r_["step"] for r_ in rows if "train/e_all" in r_)
    val = sorted(r_["step"] for r_ in rows if "val/total_loss" in r_)
    ckpts = sorted(int(p.name) for p in (PARALLEL_DIR / "trainer" / "zju" / "ckpts").iterdir()
                   if p.name.isdigit())
    print(f"Trainer on {world} ranks: first 2 steps {[round(x['first_s'], 2) for x in tr]} s, "
          f"resumed to {[x['step'] for x in tr]} in {[round(x['second_s'], 2) for x in tr]} s "
          f"(resumed at step, epoch, place {[x['resume'] for x in tr]}); restored state "
          f"bit-equal to "
          f"the saved one {[x['exact'] for x in tr]}; final parameters equal across ranks "
          f"{tr[0]['digest'] == tr[1]['digest']}; writers (metrics, checkpoints) "
          f"{[x['writers'] for x in tr]}; metrics.jsonl train/ rows {train}, val/ rows {val}; "
          f"checkpoints {ckpts}", flush=True)
    if not (all(x["exact"] and x["step"] == 4 and x["resume"] == (2, 0, 2) for x in tr)
            and tr[0]["digest"] == tr[1]["digest"]
            and tr[0]["writers"] == (True, True) and tr[1]["writers"] == (False, False)
            and train == [2, 4] and val == [2, 4] and ckpts == [2, 4]):
        raise SystemExit("the two-rank Trainer did not resume exactly, write from rank 0 only "
                         "or log and save at 2 and 4")

    # the sharded eval
    ev = [x["eval"] for x in res]
    one = eval_scores(dev, False)
    print(f"run_eval(sharded=True), 2 samples at 512²: rank 0 {ev[0]['mean']} in "
          f"{ev[0]['seconds']:.2f} s (rank 1 returns {ev[1]['mean']}; gathers a rank "
          f"{[x['inventory'].get('image', {}).get('calls') for x in ev]}); unsharded "
          f"{one['mean']} in {one['seconds']:.2f} s", flush=True)
    if ev[1]["mean"] != {} or set(ev[0]["mean"]) != {"mse", "psnr", "ssim"}:
        raise SystemExit("sharded eval: rank 0 must score and rank 1 return nothing")
    for k, v in one["mean"].items():
        if not (math.isfinite(v) and abs(ev[0]["mean"][k] - v) <= 1e-6 * abs(v)):
            raise SystemExit(f"sharded eval's {k} differs from the unsharded run's")
    return dict(k1_launches=[s["k1"] for s in steps[0]["steps"]],
                k1_ms=[st["k1_ms"] for st in steps], k2_launches=[x["k2"] for x in ren])

# ------------------------------------- the quality gate and the ZJU data path
GATE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_gate"
# three chunks of 50: the first warms up, the second is timed, the third
# runs under torch.cuda's sync debug mode (each wait on the device warns)
GATE_STEPS, GATE_CHUNK = 150, 50


GATE_REPEAT_STEPS = 20


def gate_steps_twice(dev) -> dict:
    """The gate's training (quality_gate.train_gate at gate geometry, its
    seed, model, optimizer and draws as its main() makes them) for
    GATE_REPEAT_STEPS steps, twice from the start: the chunk's readings
    (last loss, largest grad norm and its step) and every parameter after
    the steps bit-equal. Then K1 at every call of the first run's first
    step (k1_calls), and the gate's step in deterministic mode against the
    same step with torch's defaults, in turns: what the mode and what K1
    (against what the parent ran for the same maps) add to a gate step.
    Returns K1's numbers."""
    from keypointnerf_torch import quality_gate as qg
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, ViewBatch
    from keypointnerf_torch.training import (LossConfig, OptimConfig, TrainDraws,
                                             create_train_state, patch_pool, step_generator,
                                             train_step_fn)
    from keypointnerf_torch.training.train import step_without_mode

    args = qg.create_parser().parse_args([])
    scfg = SyntheticConfig(image_size=qg.IMAGE, n_views=4)
    stack = qg.stack_samples([make_sample(scfg, seed=i) for i in range(qg.N_TRAIN)], dev)
    pools = [patch_pool(ViewBatch(**{f: t[i] for f, t in stack.items()}))
             for i in range(qg.N_TRAIN)]
    loss_cfg = LossConfig(lambda_vgg=0.0)
    runs, captured = [], []
    for i in range(2):
        model = KeypointNeRF(qg.gate_config(), device=dev, seed=args.seed)
        state = create_train_state(model, OptimConfig(learning_rate=args.lr))
        restore = k1_capture(captured, k1_per_step(model.cfg)) if i == 0 else None
        try:
            rows = list(qg.train_gate(model, loss_cfg, state, stack, pools, args.seed,
                                      GATE_REPEAT_STEPS, GATE_REPEAT_STEPS))
        finally:
            if restore:
                restore()
        runs.append((rows, [p.detach().cpu() for p in model.parameters()]))
        del model, state
    (rows_a, params_a), (rows_b, params_b) = runs
    same = sum(int(torch.equal(a, b)) for a, b in zip(params_a, params_b))
    print(f"the gate's step, {GATE_REPEAT_STEPS} steps from seed {args.seed} twice: readings "
          f"{rows_a} and {rows_b}; {same} of {len(params_a)} parameters bit-equal", flush=True)
    if rows_a != rows_b or same != len(params_a):
        raise SystemExit("two runs of the gate's steps from one seed differ")
    if len(captured) != k1_per_step(qg.gate_config()):
        raise SystemExit(f"captured {len(captured)} K1 calls of a gate step, not "
                         f"{k1_per_step(qg.gate_config())}")
    gate_k1 = k1_calls(dev, captured, "gate")
    model = KeypointNeRF(qg.gate_config(), device=dev, seed=args.seed)
    state = create_train_state(model, OptimConfig(learning_rate=args.lr))
    vb = ViewBatch(**{f: t[0] for f, t in stack.items()})
    draws = TrainDraws.sample(model.cfg, vb, step_generator(args.seed, 0, dev), pool=pools[0])
    turns = steps_in_turns({
        "deterministic": lambda: train_step_fn(model, loss_cfg, state, vb, draws),
        "defaults": lambda: step_without_mode(model, loss_cfg, state, [vb], [draws])})
    (det_s, det_t), (free_s, free_t) = turns["deterministic"], turns["defaults"]
    k1_s = (gate_k1["ms"] - gate_k1["parent_ms"]) / 1e3
    print(f"the gate's step in deterministic mode {det_s:.4f} s/step (median of turns "
          f"{[round(x, 4) for x in det_t]}), with torch's defaults {free_s:.4f} "
          f"({[round(x, 4) for x in free_t]}): the mode adds {det_s - free_s:+.4f} s a step "
          f"({det_s / free_s:.3f}x); K1's {len(captured)} launches add {k1_s:+.6f} s a step "
          f"against what the parent ran for the same maps", flush=True)
    return dict(gate_k1, det_s=det_s, free_s=free_s)


def gate_phase(dev) -> dict:
    """The port's training-quality gate (`python -m
    keypointnerf_torch.quality_gate`'s main()) at gate geometry for
    GATE_STEPS steps with one evaluation, its run recorded into a file of
    its own under build/: s/step, K1 launches a step (6), the host's waits
    in a chunk (1: the chunk's fetch), the loss of the first and last
    chunk, seen / unseen PSNR / SSIM, the fast preset's delta (the gate
    exits 1 on a cull overflow). The training step makes no host sync, so
    the one wait a chunk is its fetch. Returns K1's launches a step."""
    import shutil
    import warnings

    from keypointnerf_torch import quality_gate as qg
    from keypointnerf_torch.ops import multiview_dmap_onehot as k1

    shutil.rmtree(GATE_DIR, ignore_errors=True)
    GATE_DIR.mkdir(parents=True)
    chunks, train = [], qg.train_gate

    def observed(*args, **kwargs):
        it = train(*args, **kwargs)
        while True:
            before, t0 = k1.launches, time.perf_counter()
            syncs = None
            if len(chunks) == 2:
                # each wait, by the line of Python that made it
                syncs = {}

                def record(message, category, filename, lineno, file=None, line=None):
                    if "synchronizing CUDA operation" in str(message):
                        where = f"{Path(filename).name}:{lineno}"
                        syncs[where] = syncs.get(where, 0) + 1

                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.showwarning = record
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        row = next(it, None)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
            else:
                row = next(it, None)
            if row is None:
                return
            chunks.append(dict(step=row[0], loss=row[1], gn_max=row[2], gn_at=row[3],
                               seconds=time.perf_counter() - t0,
                               k1=k1.launches - before,
                               syncs=syncs))
            yield row

    qg.train_gate = observed
    k1.launches = 0
    t0 = time.perf_counter()
    try:
        res = qg.main(["--steps", str(GATE_STEPS), "--steps-chunk", str(GATE_CHUNK),
                       "--write-thresholds", "--thresholds", str(GATE_DIR / "gate.json")])
    finally:
        qg.train_gate = train
    wall = time.perf_counter() - t0
    for c in chunks:
        print(f"gate chunk to step {c['step']}: {c['seconds']:.2f} s = "
              f"{c['seconds'] / GATE_CHUNK:.4f} s/step, loss {c['loss']:.5f}, grad norm max "
              f"{c['gn_max']:.4e} at step {c['gn_at']}, K1 launches {c['k1']} = "
              f"{c['k1'] / GATE_CHUNK} a step", flush=True)
    syncs = chunks[2]["syncs"]
    print(f"gate: {GATE_STEPS} steps + one evaluation in {wall:.1f} s; s/step (the second "
          f"chunk) {chunks[1]['seconds'] / GATE_CHUNK:.4f}; loss first chunk "
          f"{chunks[0]['loss']:.5f}, last {chunks[-1]['loss']:.5f}; host waits on the device in "
          f"the third chunk (sync debug mode), by line: {syncs}; results {res}", flush=True)
    if sum(syncs.values()) != 1:
        raise SystemExit(f"the gate's chunk waited on the device {syncs}: once, its fetch, "
                         "is all it may")
    want = k1_per_step(qg.gate_config())
    per_step = {c["k1"] / GATE_CHUNK for c in chunks}
    if per_step != {float(want)}:
        raise SystemExit(f"K1 must run {want} times a gate step: {per_step}")
    for split in ("seen", "unseen"):
        if not all(math.isfinite(v) for v in res[split].values()):
            raise SystemExit(f"gate: {split} scores not finite: {res[split]}")
    if not all(math.isfinite(c["loss"]) for c in chunks):
        raise SystemExit("gate: a chunk's loss is not finite")
    return {"k1_per_step": want}


DATA_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
# ZJU-MoCap's own geometry: 1024² images (the 0.5 ratio makes them 512²), 21
# cameras (the val split's sources 0, 7, 15 and SAMPLE_CAM_DEFAULT's 20)
ZJU_IMAGE, ZJU_CAMS, LOADER_SAMPLES = 1024, 21, 16


def zju_tree() -> str:
    """A fake ZJU-MoCap tree under build/ at the dataset's geometry, every
    subject of the train and test splits sharing the files by symlink,
    313 / 315 with empty `ims` lists (their paths are forced to .jpg)."""
    import shutil

    from keypointnerf_torch.data.fake_zju import write_fake_tree
    from keypointnerf_torch.data.image_io import read_png_rows
    from keypointnerf_torch.data.zju import get_human_split

    root = DATA_DIR / "zju_tree"
    shutil.rmtree(root, ignore_errors=True)
    humans = list(get_human_split("train")) + list(get_human_split("test"))
    t0 = time.perf_counter()
    write_fake_tree(str(root), humans, size=ZJU_IMAGE, n_cams=ZJU_CAMS)
    seconds = time.perf_counter() - t0
    kinds = {}
    for sub in ("Camera_B1", "mask/Camera_B1", "mask_cihp/Camera_B1"):
        rows, _, _ = read_png_rows(str(root / "_shared" / sub / "000000.png"))
        kinds[sub] = np.bincount(rows[:, 0], minlength=5).tolist()
    print(f"fake ZJU-MoCap tree: {len(humans)} subjects, {ZJU_CAMS} cameras, {ZJU_IMAGE}² PNG "
          f"images and grey masks (mask/, mask_cihp/), frames 0 and 30, written in "
          f"{seconds:.1f} s; rows of filter types 0-4 in camera 1's files: {kinds}", flush=True)
    if 0 in kinds["Camera_B1"][1:] or not all(sum(k[1:]) for k in kinds.values()):
        raise SystemExit("the fake tree's images must use every filter type, its masks "
                         "filters other than None")
    return str(root)


def loader_rates(root) -> None:
    """The native library's build, then ZJU train samples/s inline and with
    4 prefetcher threads (the same samples, bit-equal)."""
    from keypointnerf_torch.data import ZJUDataset, native_loader

    t0 = time.perf_counter()
    built = native_loader.LIB_PATH.exists()
    native_loader.load()
    print(f"native library {native_loader.LIB_PATH} "
          f"{'was there' if built else 'built from native/kpnerf_data.cc'} in "
          f"{time.perf_counter() - t0:.2f} s with {native_loader.compiler()}, OpenMP "
          f"{native_loader.links_openmp()}", flush=True)
    ds = ZJUDataset(root, "train")
    order = np.random.default_rng(125).permutation(len(ds))[:LOADER_SAMPLES]
    t0 = time.perf_counter()
    inline = [ds[int(i)] for i in order]
    t_inline = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = list(native_loader.ordered(ds.__getitem__, order, 4))
    t_pool = time.perf_counter() - t0
    same = all(a is not None and all(np.array_equal(a[k], b[k]) for k in a if k != "meta")
               for a, b in zip(inline, pooled))
    shape = inline[0]["src_images"].shape
    print(f"ZJU loader, {len(ds)} train samples, {LOADER_SAMPLES} loaded (src_images {shape}): "
          f"inline {LOADER_SAMPLES / t_inline:.2f} samples/s, 4 workers "
          f"{LOADER_SAMPLES / t_pool:.2f} samples/s; the same samples bit for bit: {same}",
          flush=True)
    side = ZJU_IMAGE // 2
    if not same or shape != (3, side, side, 3):
        raise SystemExit(f"the ZJU loader's samples differ with workers or are not {side}²")


def zju_trainer(root, workers, steps=8) -> dict:
    """`python -m keypointnerf_torch.train --config configs/zju.json --set
    data.dataset=zju data.data_root=<tree> data.num_workers=N` for `steps`
    steps; the loop's s/step and the host's share (log windows at 4, 6,
    8)."""
    import shutil

    from keypointnerf_torch import train as cli

    from keypointnerf_torch.ops import multiview_dmap_onehot as k1

    out = DATA_DIR / f"w{workers}"
    shutil.rmtree(out, ignore_errors=True)
    k1.launches = 0
    t0 = time.perf_counter()
    trainer = cli.main(zju_cli_args(root, out) + ["--max_steps", str(steps), "--set",
                                                  "data.dataset=zju", f"data.data_root={root}",
                                                  f"data.num_workers={workers}",
                                                  "log_every_steps=2", "val_every_steps=1000",
                                                  "ckpt_every_steps=1000"])
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(out / "zju" / "metrics.jsonl")]
    train = {r["step"]: r for r in rows if "train/e_all" in r}
    loop = [train[s]["train/step_time_s"] for s in (4, 6, 8)]
    data = [train[s]["train/data_time_s"] for s in (4, 6, 8)]
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    share = sum(data) / sum(loop)
    launches = k1.launches
    print(f"train CLI on the ZJU tree, data.num_workers={workers}: {wall:.1f} s wall for "
          f"{steps} steps; loop {loop} s/step (mean {sum(loop) / 3:.4f}), host making samples "
          f"{data} s/step = {share:.3f} of the loop; all metrics finite: {finite}; K1 "
          f"launches {launches}", flush=True)
    if trainer.state.step != steps or not finite or len(trainer.train_data) == 0:
        raise SystemExit(f"the ZJU-fed trainer (num_workers={workers}) did not train "
                         f"{steps} finite steps")
    want = k1_per_step(zju_config()) * steps
    if launches != want:
        raise SystemExit(f"K1 must run {want} times in {steps} steps of the ZJU-fed trainer: "
                         f"{launches}")
    return dict(s_per_step=sum(loop) / 3, host_share=share, out=out, k1=launches)


def zju_cli_args(root, out):
    return ["--config", str(ZJU_CONFIG), "--allow_random_vgg", "--no_tensorboard",
            "--out_dir", str(out), "--data_root", root]


def data_phase(dev) -> int:
    """The ZJU-MoCap data path on a fake tree at the dataset's geometry:
    the native build and loader rates, the train CLI fed from the tree with
    4 workers beside none (a few steps each), --run_val on the val split,
    and render_dynamic for 2 orbit frames of the test split from the
    trained checkpoint with configs/zju_fast.json (cull_overflow 0)."""
    from keypointnerf_torch import render_dynamic
    from keypointnerf_torch import train as cli

    root = zju_tree()
    loader_rates(root)
    inline = zju_trainer(root, 0)
    pooled = zju_trainer(root, 4)
    print(f"the ZJU-fed trainer loop: {inline['s_per_step']:.4f} s/step inline (host share "
          f"{inline['host_share']:.3f}), {pooled['s_per_step']:.4f} with 4 workers (host share "
          f"{pooled['host_share']:.3f})", flush=True)
    out = pooled["out"]
    third = cli.main(zju_cli_args(root, out) + ["--run_val", "--set", "data.dataset=zju",
                                                f"data.data_root={root}"])
    yml = dict(line.split(": ") for line in
               open(out / "zju" / f"test_v3_{third.state.step}.yml").read().splitlines())
    scored = sorted(p.name for p in (out / "zju" / "images_v3").glob("*/pred/*.png"))
    print(f"--run_val on the ZJU val split: {len(scored)} samples {scored}, PSNR {yml['psnr']} "
          f"/ SSIM {yml['ssim']}", flush=True)
    if len(scored) != 2 or not all(math.isfinite(float(yml[k])) for k in ("psnr", "ssim")):
        raise SystemExit("--run_val on the ZJU tree did not score 2 samples finitely")
    del third
    t0 = time.perf_counter()
    res = render_dynamic.main(["--config", str(FAST_CONFIG), "--data_root", root,
                               "--model_ckpt", str(out / "zju" / "ckpts"),
                               "--out_dir", str(DATA_DIR / "video"), "--max_samples", "2",
                               "--auto_cull_budget", "2"])
    from keypointnerf_torch.data.image_io import read_png

    shapes = [read_png(p).shape for p in res["frames"]]
    print(f"render_dynamic (configs/zju_fast.json, 2 test samples): {len(res['frames'])} orbit "
          f"frames {[Path(p).name for p in res['frames']]} {shapes} in "
          f"{time.perf_counter() - t0:.1f} s, worst cull_overflow {res['cull_overflow']}",
          flush=True)
    if len(res["frames"]) != 2 or res["cull_overflow"] != 0.0 or \
            any(sh != (512, 512, 3) for sh in shapes):
        raise SystemExit("render_dynamic did not write 2 exact 512² orbit frames")
    return pooled["k1"]


# ------------------------------------------------ export, checkpoints, ICON
EXPORT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_export"
EXPORT_SIZES = {"main": RIG, "under": 256, "multicam": 256, "flags": 64}
EXPORT_CHUNK = 2048
# The consumer of the full-width artifact, in a fresh process: it imports
# load_render (and through it the op registrations) and nothing of the
# model. It waits for the artifact, loads it, waits for the go file (the
# export phase, so that its run shares the card with nothing), runs it
# once (kernel libraries loaded), then counts the kernels' launches and
# times a second run; tries a wrong input shape; writes the frames, the
# overflow and one JSON line of what it saw.
EXPORT_CONSUMER = r"""
import json, os, sys, time
d, wait = sys.argv[1], float(sys.argv[2])

def await_file(name):
    t0 = time.perf_counter()
    while not os.path.exists(f"{d}/{name}"):
        if time.perf_counter() - t0 > wait:
            sys.exit(f"no {name} after {wait} s")
        time.sleep(0.2)

import torch
from keypointnerf_torch.export import load_render
from keypointnerf_torch import ops
await_file("main.done")
t0 = time.perf_counter()
serve = load_render(open(f"{d}/main.pt2", "rb").read())
load_s = time.perf_counter() - t0
params = torch.load(f"{d}/main.params.pt")
args = torch.load(f"{d}/main.args.pt")
await_file("go")
sync = torch.cuda.synchronize if args[0].is_cuda else (lambda: None)
serve(params, *args)
sync()
wrappers = {"onehot_bilinear": ops.multiview_onehot_bilinear_sample,
            "fused_geo_mlp": ops.geo_mlp_apply, "sp_fused_geo_mlp": ops.sp_geo_mlp_apply,
            "dma_gather": ops.multiview_bilinear_sample_dma,
            "composite_importance": ops.fused_composite_importance,
            "dense_act": ops.fused_dense_act}
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
rgb, overflow = serve(params, *args)
sync()
run_s = time.perf_counter() - t0
torch.save({"rgb": rgb.cpu(), "overflow": overflow.cpu()}, f"{d}/main.out.pt")
launches = {k: w.launches for k, w in wrappers.items()}
try:
    serve(params, args[0][:, :-1], *args[1:])
    raised = False
except Exception:
    raised = True
print(json.dumps({"load_s": load_s, "run_s": run_s, "launches": launches, "raised": raised,
                  "models": sorted(m for m in sys.modules if m.startswith("keypointnerf_torch.models")),
                  "jax": "jax" in sys.modules}), flush=True)
"""


def export_args(vb, Ks=None, Rs=None, ts=None):
    """The exported signature's flat tensors of a ViewBatch (the camera
    stacks of a multi-camera artifact when given)."""
    cams = (vb.tar_K, vb.tar_R, vb.tar_t) if Ks is None else (Ks, Rs, ts)
    return (vb.src_images, vb.src_masks, vb.src_K, vb.src_R, vb.src_t, vb.kpt3d, vb.bounds,
            *cams)


def export_cameras(dev, vb):
    """The smaller artifacts' cameras: the strict camera at 256² (its
    intrinsics scaled to the frame) and the two-camera stack of the
    multi-camera artifact (orbit angles 0 and 0.9)."""
    half = EXPORT_SIZES["under"]
    K_half = vb.tar_K * torch.tensor([[half / RIG], [half / RIG], [1.0]], device=dev)
    cams = [orbit_camera(0.0), orbit_camera(0.9)]
    Rs = torch.as_tensor(np.stack([c[0] for c in cams]), dtype=torch.float32, device=dev)
    ts = torch.as_tensor(np.stack([c[1] for c in cams]), dtype=torch.float32, device=dev)
    return dataclasses.replace(vb, tar_K=K_half), (torch.stack([K_half, K_half]), Rs, ts)


def export_artifacts(dev) -> None:
    """The export phase's artifacts of the 512² strict camera's model with
    use_pallas_geo_mlp, written under EXPORT_DIR with their inputs and
    export seconds: the 512² camera ("main", its `main.done` written after
    it), a 256² camera with a cull budget of 0.01 ("under") and the F = 2
    256² multi-camera artifact ("multicam"); `exports.json` last. Run in a
    process of its own while the earlier phases run (`start_exports`): an
    export is host work in one thread, minutes at full width."""
    from keypointnerf_torch.export import export_render

    cfg, model, vb = strict_camera(dev, use_pallas_geo_mlp=True)
    params = model.state_dict()
    vb_half, (Ks, Rs, ts) = export_cameras(dev, vb)
    torch.save(params, EXPORT_DIR / "main.params.pt")
    timings = {}
    for name, m, args, kw in (
            ("main", model, export_args(vb), {}),
            ("under", model.with_config(cull_empty_rays_ratio=0.01), export_args(vb_half), {}),
            ("multicam", model, export_args(vb, Ks, Rs, ts), {"multicam": True})):
        size = EXPORT_SIZES[name]
        t0 = time.perf_counter()
        blob = export_render(m, params, args, height=size, width=size, chunk=EXPORT_CHUNK,
                             device=dev, **kw)
        timings[name] = {"export_s": time.perf_counter() - t0, "bytes": len(blob)}
        (EXPORT_DIR / f"{name}.pt2").write_bytes(blob)
        torch.save(args, EXPORT_DIR / f"{name}.args.pt")
        if name == "main":
            (EXPORT_DIR / "main.done").write_text("")
        print(f"exported {name}: {timings[name]}", flush=True)
    (EXPORT_DIR / "exports.json").write_text(json.dumps(timings))


EXPORT_PRODUCER = "import sys, torch, chip_smoke; chip_smoke.export_artifacts(torch.device(sys.argv[1]))"


def start_exports(dev) -> list:
    """Start the export phase's background processes right after the
    build: one exporting its artifacts (`export_artifacts`) and the fresh
    consumer of the full-width one (EXPORT_CONSUMER), which loads it as
    soon as it is written and waits for the export phase to run it. They
    share the host's cores with the phases before it, and its card only
    for building the model. Returns the processes (stopped at exit)."""
    import atexit
    import shutil

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    root = Path(__file__).resolve().parent
    procs = []
    for name, cmd in (("producer", [EXPORT_PRODUCER, str(dev)]),
                      ("consumer", [EXPORT_CONSUMER, str(EXPORT_DIR), "1800"])):
        out = open(EXPORT_DIR / f"{name}.log", "w")
        procs.append(subprocess.Popen([sys.executable, "-c", *cmd], stdout=out,
                                      stderr=subprocess.STDOUT, cwd=root))
        out.close()
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def waited(proc, name, timeout=1200) -> str:
    """Wait for a background process of the export phase; its log, or a
    failure naming it."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = "killed at its timeout"
    log = (EXPORT_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise SystemExit(f"the export phase's {name} failed ({rc}):\n{log[-4000:]}")
    return log


def export_phase(dev, procs) -> dict:
    """The serving export at full width (the artifacts from the background
    processes of `start_exports`): the 512² strict camera with
    use_pallas_geo_mlp exported at chunk 2048, loaded and run in a fresh
    process (bit-equal to the eager render, overflow 0, K2 and K5 48
    launches each), an under-budgeted artifact whose overflow is > 0, a
    multi-camera artifact (F = 2, 256²) equal to its cameras' renders; and,
    exported in this process between two eager renders that must be
    bit-equal, a 64² artifact with K3, K4 and K6 (fused map, rel_z, the
    fused composite) equal to its eager render. Returns each kernel's
    launches in the artifacts and the timings."""
    from keypointnerf_torch.export import export_render, load_render
    from keypointnerf_torch.render import render_image

    producer, consumer = procs
    size = EXPORT_SIZES["main"]
    cfg, model, vb = strict_camera(dev, use_pallas_geo_mlp=True)
    params = model.state_dict()
    render = lambda m, v, s: render_image(m, v, height=s, width=s,  # noqa: E731
                                          chunk=EXPORT_CHUNK)
    render(model, vb, size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = render(model, vb, size)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    waited(producer, "producer")
    timings = json.loads((EXPORT_DIR / "exports.json").read_text())
    saved = torch.load(EXPORT_DIR / "main.params.pt")
    if not all(torch.equal(saved[k], v) for k, v in params.items()):
        raise SystemExit("the exported model's weights are not this phase's")
    print(f"waited {time.perf_counter() - t0:.1f} s for the background exports: "
          f"{timings}", flush=True)
    (EXPORT_DIR / "go").write_text("")
    log = waited(consumer, "consumer", timeout=600)
    res = json.loads(log.strip().splitlines()[-1])
    got = torch.load(EXPORT_DIR / "main.out.pt")
    equal = torch.equal(got["rgb"], eager["rgb_fine"].cpu())
    overflow = float(got["overflow"])
    print(f"512² strict camera with use_pallas_geo_mlp (chunk {EXPORT_CHUNK}): export "
          f"{timings['main']['export_s']:.1f} s, {timings['main']['bytes']} bytes; fresh "
          f"process: load {res['load_s']:.1f} s, run {res['run_s']:.4f} s = "
          f"{size * size / res['run_s']:.1f} rays/s (eager {eager_s:.4f} s = "
          f"{size * size / eager_s:.1f} rays/s); frames "
          f"{'bit-equal to' if equal else 'DIFFER from'} the eager render; overflow "
          f"{overflow}; launches {res['launches']}; wrong shape raised {res['raised']}; "
          f"model modules imported {res['models']}, jax {res['jax']}", flush=True)
    expected = strict_query_launches(size * size)
    k = res["launches"]
    if not (equal and overflow == 0.0 and res["raised"] and not res["models"]
            and not res["jax"] and k["onehot_bilinear"] == expected
            and k["sp_fused_geo_mlp"] == expected
            and k["fused_geo_mlp"] == k["dma_gather"] == k["composite_importance"] == 0):
        raise SystemExit("the loaded artifact does not reproduce the eager render")
    artifact_launches = {"onehot_bilinear": expected, "sp_fused_geo_mlp": expected}

    wrappers = kernel_wrappers()
    half = EXPORT_SIZES["under"]
    vb_half, (Ks, Rs, ts) = export_cameras(dev, vb)
    tiny = model.with_config(cull_empty_rays_ratio=0.01)
    t0 = time.perf_counter()
    serve = load_render((EXPORT_DIR / "under.pt2").read_bytes())
    load_s = time.perf_counter() - t0
    _, ov = serve(params, *export_args(vb_half))
    eager_ov = float(render(tiny, vb_half, half)["cull_overflow"].max())
    print(f"under-budgeted artifact (256², cull 0.01): overflow {float(ov)} (eager "
          f"{eager_ov}); export {timings['under']['export_s']:.1f} s, "
          f"{timings['under']['bytes']} bytes, load {load_s:.1f} s", flush=True)
    if not (float(ov) > 0.0 and float(ov) == eager_ov):
        raise SystemExit("the under-budgeted artifact does not report its overflow")

    t0 = time.perf_counter()
    serve = load_render((EXPORT_DIR / "multicam.pt2").read_bytes())
    load_s = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    frames, ov = serve(params, *export_args(vb, Ks, Rs, ts))
    torch.cuda.synchronize()
    mc_launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    singles = [render(model, dataclasses.replace(vb_half, tar_R=Rs[f], tar_t=ts[f]),
                      half)["rgb_fine"] for f in range(2)]
    equal = all(torch.equal(frames[f], singles[f]) for f in range(2))
    print(f"multi-camera artifact (F = 2, 256²): frames {'bit-equal to' if equal else 'DIFFER from'} "
          f"the single-camera renders, worst overflow {float(ov)}; launches {mc_launches}; "
          f"export {timings['multicam']['export_s']:.1f} s, {timings['multicam']['bytes']} "
          f"bytes, load {load_s:.1f} s", flush=True)
    if not (equal and float(ov) == 0.0 and frames.shape == (2, half, half, 3)
            and not torch.equal(frames[0], frames[1])):
        raise SystemExit("the multi-camera artifact disagrees with the single-camera renders")

    # K3, K4 and K6 in an artifact: a 64² camera of the fused map with K3,
    # rel_z with use_pallas_geo_mlp (K4) and the fused composite (K6; the
    # cull off, as K6 requires), exported here between two eager renders
    small = EXPORT_SIZES["flags"]
    vb_small = dataclasses.replace(
        vb, tar_K=vb.tar_K * torch.tensor([[small / RIG], [small / RIG], [1.0]], device=dev))
    _, model3, _ = strict_camera(dev, use_pallas_geo_mlp=True, sp_type="rel_z",
                                 fused_feature_map=True, use_dma_gather=True,
                                 use_pallas_composite=True, cull_empty_rays_ratio=1.0)
    params3 = model3.state_dict()
    before = render(model3, vb_small, small)
    t0 = time.perf_counter()
    blob = export_render(model3, params3, export_args(vb_small), height=small, width=small,
                         chunk=EXPORT_CHUNK, device=dev)
    export_s = time.perf_counter() - t0
    after = render(model3, vb_small, small)
    unchanged = all(type(after[k]) is torch.Tensor and torch.equal(before[k], after[k])
                    for k in before)
    serve = load_render(blob)
    serve(params3, *export_args(vb_small))
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    rgb, _ = serve(params3, *export_args(vb_small))
    torch.cuda.synchronize()
    flag_launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    equal = torch.equal(rgb, before["rgb_fine"])
    n_chunks = small * small // EXPORT_CHUNK
    print(f"{small}² artifact with the fused map + K3, rel_z + K4 and K6 (exported here: "
          f"{export_s:.1f} s, {len(blob)} bytes): frames {'bit-equal to' if equal else 'DIFFER from'} "
          f"the eager render; launches {flag_launches} ({n_chunks} chunks); the eager render "
          f"after the export {'real tensors, bit-equal to before' if unchanged else 'CHANGED'}",
          flush=True)
    if not unchanged:
        raise SystemExit("an export changed the eager render (a trace's tensor was cached)")
    if not (equal and flag_launches == {"dma_gather": 2 * n_chunks,
                                        "fused_geo_mlp": 2 * n_chunks,
                                        "composite_importance": n_chunks}):
        raise SystemExit("the K3 / K4 / K6 artifact disagrees with its eager render")
    artifact_launches.update(flag_launches)
    return dict(launches=artifact_launches, eager_s=eager_s, load_s=res["load_s"],
                run_s=res["run_s"])


REFERENCE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_reference"


def reference_ckpt_phase(dev) -> None:
    """A fake reference Lightning checkpoint of the seeded full-width model
    (its tensors under `model.`, random VGG19 `vgg_loss.*` tensors,
    Lightning's other keys), imported by utils/import_reference.py into a
    fresh model on the card: the 512² strict render bit-equal to the source
    model's."""
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features
    from keypointnerf_torch.render import render_image
    from keypointnerf_torch.utils import load_reference_checkpoint

    cfg, model, vb = strict_camera(dev)
    n_params = sum(p.numel() for p in model.parameters())
    vgg = VGG19Features(device="cpu").state_dict()
    sd = {f"model.{k}": v.cpu() for k, v in model.state_dict().items()}
    sd.update({f"model.vgg_loss.{k}": v for k, v in vgg.items()})
    REFERENCE_DIR.mkdir(parents=True, exist_ok=True)
    path = REFERENCE_DIR / "last.ckpt"
    torch.save({"state_dict": sd, "epoch": 11, "global_step": 123456,
                "pytorch-lightning_version": "1.5.10", "optimizer_states": [{"state": {}}],
                "lr_schedulers": [], "callbacks": {}, "hyper_parameters": {"lr": 5e-4}}, path)
    t0 = time.perf_counter()
    fresh = load_reference_checkpoint(str(path), KeypointNeRF(cfg, device=dev, seed=7))
    load_s = time.perf_counter() - t0
    a = render_image(model, vb, height=RIG, width=RIG, chunk=2048)
    b = render_image(fresh, vb, height=RIG, width=RIG, chunk=2048)
    equal = all(torch.equal(a[k], b[k]) for k in a)
    print(f"reference checkpoint: {n_params} parameters under model., {len(vgg)} vgg_loss "
          f"tensors, {path.stat().st_size} bytes; imported in {load_s:.2f} s; {RIG}² strict "
          f"render {'bit-equal to' if equal else 'DIFFERS from'} the source model's", flush=True)
    if n_params != 28_354_417 or not equal:
        raise SystemExit("the imported reference checkpoint does not render as its source")


ICON_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_icon"
ICON_ARGS = ["--image_size", "512", "--steps", "200", "--n_scenes", "8", "--eval_scenes", "2",
             "--resolution", "128"]


def icon_phase(dev) -> None:
    """The port's ICON CLI (`python -m keypointnerf_torch.train_icon`, its
    main()) at ICON's full widths (the default KeypointICONConfig,
    geo_n_downsample 4 above 64²) on 512² blob scenes with 128³ grids, then
    a toy f32 ICON step card vs CPU."""
    import shutil

    from keypointnerf_torch import train_icon

    shutil.rmtree(ICON_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    res = train_icon.main(["--out_dir", str(ICON_DIR), *ICON_ARGS])
    metrics = json.loads((ICON_DIR / "icon_metrics.json").read_text())
    objs = sorted(p.name for p in ICON_DIR.glob("eval_*.obj"))
    finite = all(np.isfinite(s[k]) for s in metrics["scenes"] for k in ("chamfer", "p2s"))
    print(f"ICON CLI ({' '.join(ICON_ARGS)}): {time.perf_counter() - t0:.1f} s; "
          f"{res['s_per_step']:.4f} s/step, {res['grid_points_per_s']:.1f} grid points/s, "
          f"meshing {res['mesh_s_per_scene']:.2f} s a scene; Chamfer {metrics['mean']['chamfer']:.4f}, "
          f"P2S {metrics['mean']['p2s']:.4f} (scene units), voxel {metrics['mean']['voxel']:.4f}; "
          f"vertices {[s['n_verts'] for s in metrics['scenes']]}; {objs}", flush=True)
    if not finite or objs != ["eval_0.obj", "eval_1.obj"]:
        raise SystemExit("the ICON CLI did not reconstruct finite surfaces")
    icon_agreement_small(dev)


def icon_agreement_small(dev) -> None:
    """One toy f32 ICON step (BCE + Adam) on the card against the same step
    on the CPU: the loss, every gradient and the updated parameters, at
    train_agreement_small's bounds."""
    from keypointnerf_torch.models.keypoint_icon import (
        KeypointICON, KeypointICONConfig, make_icon_train_step)
    from keypointnerf_torch.train_icon import make_blob_scene, sample_training_points

    cfg = KeypointICONConfig(geo_n_downsample=2, mlp_hidden=(128, 128, 128))
    sc = make_blob_scene(3, size=32)
    pts, labels = sample_training_points(sc, rs=np.random.default_rng(0))
    res = {}
    for d in (dev, torch.device("cpu")):
        model = KeypointICON(cfg, device=d, seed=0)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=d)  # noqa: E731
        grads = {}
        for name, p in model.named_parameters():
            p.register_hook(lambda g, name=name: grads.__setitem__(name, g.detach().cpu()))
        _, step = make_icon_train_step(model, 1e-3)
        loss = step(t(sc["image"]), t(pts), t(labels), t(sc["K"]), t(sc["R"]), t(sc["t"]),
                    t(sc["kpt3d"]))
        res[d.type] = dict(loss=float(loss), grads=grads,
                           params={k: p.detach().cpu() for k, p in model.named_parameters()})
    c, g = res["cpu"], res["cuda"]
    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    top = max(x.abs().max().item() for x in c["grads"].values())
    grad_err = noise = param_err = small = 0.0
    for k, b in c["grads"].items():
        a, scale = g["grads"][k], b.abs().max().item()
        if scale < 1e-6 * top:
            noise = max(noise, a.abs().max().item() / top)
        else:
            grad_err = max(grad_err, (a - b).abs().max().item() / scale)
        big = b.abs() >= 1e-6
        diff = (g["params"][k] - c["params"][k]).abs()
        param_err = max(param_err, diff[big].max().item() if big.any() else 0.0)
        small = max(small, diff[~big].max().item() if (~big).any() else 0.0)
    print(f"toy f32 ICON step, card vs CPU: loss {loss_err:.3e} relative (bound 1e-4); "
          f"gradients {grad_err:.3e} of each leaf's max (bound 1e-4), noise leaves {noise:.3e} "
          f"of the top entry (bound 1e-6); updated params {param_err:.3e} absolute where "
          f"|g| >= 1e-6 (bound 2e-6), {small:.3e} elsewhere (bound 2 lr = 2e-3)", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and noise <= 1e-6 and param_err <= 2e-6
            and small <= 2e-3):
        raise SystemExit("the card's ICON step disagrees with the CPU's")


PHASES = ("kernels", "render", "fast", "agreement", "train", "train_agreement", "trainer",
          "model_rest", "parallel", "gate", "data", "export", "reference_ckpt", "icon")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    todo = parser.parse_args().phases.split(",")
    if not set(todo) <= set(PHASES):
        parser.error(f"unknown phase in {todo}")
    if "fast" in todo and "render" not in todo:
        parser.error("the fast phase compares with the strict camera: add render")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    phase("environment")
    # importing the port puts CUBLAS_WORKSPACE_CONFIG in place (device.py)
    # before this process's first cuBLAS call: training's deterministic mode
    # needs it there
    import keypointnerf_torch  # noqa: F401

    print(f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r} before the "
          f"first work on the card; deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()} (each training step turns them on "
          f"for its body)")
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
    yardstick = start_yardstick_build("onehot_dmap_atomic")
    built = build_all(KERNELS)
    finish_build(yardstick)
    print(f"built {sorted(built)} and yardsticks/onehot_dmap_atomic.cu (the earlier K1, "
          f"timed beside K1) in {time.perf_counter() - t0:.2f} s "
          f"({ {k: round(v, 2) for k, v in built.items()} })", flush=True)
    print_ptxas_report(ptxas)

    # the export phase's artifacts are exported in the background meanwhile
    export_procs = start_exports(dev) if "export" in todo else None

    entries, launches = {}, {}
    if "kernels" in todo:
        t0 = time.perf_counter()
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
        phase("dense_act: the module path's dense layers, one launch each")
        entries["dense_act"] = check_dense_act(dev)
        print(f"phase kernels {time.perf_counter() - t0:.1f} s", flush=True)

    if "render" in todo:
        t0 = time.perf_counter()
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
        strict = {k: ctx[k] for k in ("model", "vb", "out", "seconds", "device_ms", "size")}
        del ctx
        phase("strict render with sp_type rel_z and use_pallas_geo_mlp (K4)")
        launches["fused_geo_mlp"] = render_rel_z(dev)
        phase("strict render at widths the wgmma kernel refuses, use_pallas_geo_mlp (wmma K5)")
        render_wmma_widths(dev)
        print(f"phase render {time.perf_counter() - t0:.1f} s", flush=True)

    if "fast" in todo:
        t0 = time.perf_counter()
        phase("full-width fast render (configs/zju_fast.json)")
        fast = render_fast(dev, strict)
        launches["dense_act"] = fast["dense_act"]
        del strict
        phase("fast preset: orbit of 4 cameras at 256² (render_cameras_scanned)")
        render_fast_orbit(dev, fast)
        phase("fast preset: run_eval on the synthetic dataset")
        eval_fast(fast)
        del fast
        print(f"phase fast {time.perf_counter() - t0:.1f} s", flush=True)

    if "agreement" in todo:
        t0 = time.perf_counter()
        phase("small-input agreement")
        agreement_small(dev)
        agreement_small(dev, use_pallas_geo_mlp=True)
        agreement_small(dev, use_pallas_geo_mlp=True, sp_type="rel_z")
        agreement_small(dev, fused_feature_map=True, use_dma_gather=True)
        agreement_small(dev, fused_feature_map=True, use_dma_gather=True,
                        use_pallas_composite=True, cull_empty_rays_ratio=1.0)
        agreement_fast(dev)
        print(f"phase agreement {time.perf_counter() - t0:.1f} s", flush=True)

    bare_s_per_step = None
    if "train" in todo:
        t0 = time.perf_counter()
        phase("full-width zju training steps")
        off = train_full_width(dev, capture_k1=True, capture_grads=True)
        launches["onehot_dmap"] = off["onehot_dmap"]
        bare_s_per_step = off["s_per_step"]
        captured = off.pop("k1_inputs")
        if len(captured) != k1_per_step(zju_config()):
            raise SystemExit(f"captured {len(captured)} K1 calls of a step, not "
                             f"{k1_per_step(zju_config())}")
        print(f"the zju step's K1 calls (cotangent shape, map H, W): "
              f"{sorted((tuple(g.shape), H, W) for _, g, H, W, _ in captured)}", flush=True)
        phase("K1 at the training step's own points")
        step_k1 = k1_at_step_points(dev, main_map_calls(captured))
        phase("K1 at every call of the zju step, beside what the parent ran there")
        all_k1 = k1_calls(dev, captured, "zju")
        if "onehot_dmap" in entries:
            # the kernels line times K1 where the main path runs it
            entry = entries["onehot_dmap"]
            entry["max_abs_err"] = max(entry["max_abs_err"], step_k1["max_abs_err"])
            entry["max_abs_err"] = max(entry["max_abs_err"], all_k1["max_abs_err"])
            entry.update({k: step_k1[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                  "library_ms", "step_ms", "atomic_step_ms",
                                                  "vs_atomic")})
            entry["zju_step_all_calls"] = {k: all_k1[k] for k in ("ms", "parent_ms")}
        phase("the zju step three times more, bit for bit")
        for i in range(3):
            again = train_full_width(dev, warmup=1, steps=1, capture_grads=True)
            same_first_step(off, again, f"the zju step, run {i + 2}")
            del again
        phase("the zju step in strict deterministic mode")
        strict_mode_step(dev)
        phase("the encoders' replication padding against torch's")
        check_replication_pad(dev)
        phase("the zju step in deterministic mode against torch's defaults, in turns")
        deterministic_cost(dev)
        phase("full-width zju training steps with use_pallas_geo_mlp (K5)")
        on = train_full_width(dev, use_pallas_geo_mlp=True)
        compare_first_steps(off["first"], on["first"])
        print(f"training step, flag off vs on: {off['s_per_step']:.4f} vs "
              f"{on['s_per_step']:.4f} s/step; kernel time of one step {off['device_ms']:.3f} "
              f"vs {on['device_ms']:.3f} ms; peak memory {off['peak_bytes']} vs "
              f"{on['peak_bytes']} bytes; K5 launches per step {on['sp_fused_geo_mlp']}, "
              f"K1 {on['onehot_dmap']}", flush=True)
        del on
        for flags in (dict(remat=True), dict(remat=True, remat_save_gathers=True)):
            what = " + ".join(flags)
            phase(f"full-width zju training steps with {what}")
            # the recompute changes no value and each leaf's gradient sums
            # the same terms in the same order: bit-equal to remat off
            run = train_full_width(dev, capture_grads=True, **flags)
            same_first_step(off, run, f"the zju step with {what} against remat off")
            print(f"{what}: {run['s_per_step']:.4f} s/step, peak {run['peak_bytes']} bytes "
                  f"({run['peak_bytes'] / 2**30:.2f} GiB), {run['device_ms']:.3f} ms of kernel "
                  f"time; remat off {off['s_per_step']:.4f} s/step, {off['peak_bytes']} bytes "
                  f"({off['peak_bytes'] / 2**30:.2f} GiB), {off['device_ms']:.3f} ms", flush=True)
            del run
        del off
        phase("full-width training steps with the fused feature map (K1 at 84 channels)")
        fused = train_full_width(dev, capture_k1=True, capture_grads=True, fused_feature_map=True)
        same_first_step(fused, train_full_width(dev, warmup=1, steps=1, capture_grads=True,
                                                fused_feature_map=True),
                        "the fused-map step, run 2")
        captured = fused.pop("k1_inputs")
        shapes = sorted((tuple(g.shape), H, W) for _, g, H, W, _ in main_map_calls(captured))
        print(f"fused-map step: K1 launches per step {fused['onehot_dmap']}; captured K1 calls "
              f"(cotangent shape, map H, W): "
              f"{sorted((tuple(g.shape), H, W) for _, g, H, W, _ in captured)}", flush=True)
        if shapes != [((3, 4096 * 64, 84), 512, 512), ((3, 4096 * 128, 84), 512, 512)]:
            raise SystemExit("the fused-map step's K1 calls are not the 3 x 512² x 84 map's")
        phase("K1 at the fused-map step's own points")
        fused_k1 = k1_at_step_points(dev, main_map_calls(captured), step="fused-map")
        phase("K1 at every call of the fused-map step, beside what the parent ran there")
        fused_all = k1_calls(dev, captured, "fused-map")
        if "onehot_dmap" in entries:
            entry = entries["onehot_dmap"]
            entry["max_abs_err"] = max(entry["max_abs_err"], fused_k1["max_abs_err"],
                                       fused_all["max_abs_err"])
            entry["fused_map_step"] = dict(
                {k: fused_k1[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                          "library_ms", "step_ms", "atomic_step_ms",
                                          "vs_atomic", "max_abs_err")},
                launches=fused["onehot_dmap"],
                all_calls={k: fused_all[k] for k in ("ms", "parent_ms")})
        print(f"fused-map training step: {fused['s_per_step']:.4f} s/step against the zju "
              f"step's {bare_s_per_step:.4f}; peak {fused['peak_bytes']} bytes "
              f"({fused['peak_bytes'] / 2**30:.2f} GiB); {fused['device_ms']:.3f} ms of kernel "
              f"time; K1 {fused_k1['step_ms']:.4f} ms a step", flush=True)
        del fused
        print(f"phase train {time.perf_counter() - t0:.1f} s", flush=True)

    if "train_agreement" in todo:
        t0 = time.perf_counter()
        phase("small-input training agreement")
        train_agreement_small(dev)
        train_agreement_small(dev, use_pallas_geo_mlp=True)
        train_agreement_small(dev, fused_feature_map=True)
        train_agreement_small(dev, remat=True)
        print(f"phase train_agreement {time.perf_counter() - t0:.1f} s", flush=True)

    if "trainer" in todo:
        t0 = time.perf_counter()
        phase("the trainer CLI at full width (python -m keypointnerf_torch.train)")
        trainer_cli(bare_s_per_step)
        print(f"phase trainer {time.perf_counter() - t0:.1f} s", flush=True)

    if "model_rest" in todo:
        t0 = time.perf_counter()
        phase("the rest of the model: K5 at 3 outputs (separate_cf) against its plain version")
        dout3 = check_k5_three_outputs(dev)
        phase("the rest of the model: 512² strict renders, attention pools and separate_cf")
        rest_launches = render_model_rest(dev)
        if "sp_fused_geo_mlp" in entries:
            entries["sp_fused_geo_mlp"]["separate_cf_3_outputs"] = dict(
                dout3[str(2048 * 64)], fine_query=dout3[str(2048 * 128)],
                launches=rest_launches["sp_fused_geo_mlp"])
        phase("the rest of the model: full-width zju steps with attention_v1 and separate_cf")
        rest_step = train_full_width(dev, warmup=1, steps=2, pool_mode="attention_v1",
                                     separate_cf=True)
        print(f"zju step with attention_v1 + separate_cf: {rest_step['s_per_step']:.4f} s/step, "
              f"peak {rest_step['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        del rest_step
        phase("the rest of the model: small-input agreement, card vs CPU")
        # with seeded weights the toy scene's rad_c and rad_f are negative
        # everywhere (a black image, zero gradients): both biases raised by
        # 1.5, as tests/test_torch_model_rest.py raises them
        agreement_small(dev, 1.5, pool_mode="attention_v1", separate_cf=True)
        agreement_small(dev, 1.5, pool_mode="attention_v0")
        agreement_small(dev, 1.5, separate_cf=True, use_pallas_geo_mlp=True)
        train_agreement_small(dev, 1.5, pool_mode="attention_v1", separate_cf=True)
        print(f"phase model_rest {time.perf_counter() - t0:.1f} s", flush=True)

    if "gate" in todo:
        t0 = time.perf_counter()
        phase(f"the gate's step, {GATE_REPEAT_STEPS} steps twice, bit for bit")
        gate_twice = gate_steps_twice(dev)
        phase("the training-quality gate (python -m keypointnerf_torch.quality_gate), "
              f"{GATE_STEPS} steps")
        gate = gate_phase(dev)
        if "onehot_dmap" in entries:
            entries["onehot_dmap"]["gate_launches_per_step"] = gate["k1_per_step"]
            entries["onehot_dmap"]["gate_step_all_calls"] = {
                k: gate_twice[k] for k in ("ms", "parent_ms", "max_abs_err")}
        print(f"phase gate {time.perf_counter() - t0:.1f} s", flush=True)

    if "data" in todo:
        t0 = time.perf_counter()
        phase("the ZJU-MoCap data path on a fake tree at the dataset's geometry")
        zju_k1 = data_phase(dev)
        if "onehot_dmap" in entries:
            entries["onehot_dmap"]["zju_trainer_launches"] = zju_k1
        print(f"phase data {time.perf_counter() - t0:.1f} s", flush=True)

    if "parallel" in todo:
        t0 = time.perf_counter()
        par = parallel_phase(dev)
        if "onehot_dmap" in entries:
            entries["onehot_dmap"]["parallel"] = dict(launches_per_rank_step=par["k1_launches"],
                                                      ms_per_rank=par["k1_ms"])
        if "onehot_bilinear" in entries:
            entries["onehot_bilinear"]["parallel_rank_launches"] = par["k2_launches"]
        print(f"phase parallel {time.perf_counter() - t0:.1f} s", flush=True)

    if "export" in todo:
        t0 = time.perf_counter()
        phase("the serving export (torch.export with the kernels as registered ops)")
        exp = export_phase(dev, export_procs)
        for name, n in exp["launches"].items():
            if name in entries:
                entries[name]["export_launches"] = n
        print(f"phase export {time.perf_counter() - t0:.1f} s", flush=True)

    if "reference_ckpt" in todo:
        t0 = time.perf_counter()
        phase("the reference-checkpoint import (utils/import_reference.py)")
        reference_ckpt_phase(dev)
        print(f"phase reference_ckpt {time.perf_counter() - t0:.1f} s", flush=True)

    if "icon" in todo:
        t0 = time.perf_counter()
        phase("KeypointICON: the CLI at full widths (python -m keypointnerf_torch.train_icon)")
        icon_phase(dev)
        print(f"phase icon {time.perf_counter() - t0:.1f} s", flush=True)

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
