#!/usr/bin/env python3
"""Smoke run of the PyTorch port (keypointnerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, TF32 switched off for matmuls and cuDNN convs;
  2. build: nvcc compiles every kernel of keypointnerf_torch/csrc/ (one
     process per source, all at once) into build/kernels/;
  3. kernels: each kernel (K2 the tex lookup, K1 the coarse map's
     gradient) against its plain PyTorch version on the card at the main
     paths' shapes (and an odd map shape), with its time, the plain
     version's time, one PyTorch library call's time and the bound; and
     both forms of `models/mlp.py:dot_f32` in bf16 (inference: torch.mm
     with out_dtype=float32; autograd: the f32 product of bf16-rounded
     operands) against an f64 product, with their times;
  4. render: one 512² camera of the strict preset at full width (the zju
     architecture, bf16, cull budget 0.1875, seeded random weights) on the
     synthetic 512² scene with 3 source views; checks finite outputs,
     cull_overflow == 0 and each kernel's launch count in that render, and
     that the culled render is bit-equal to marching every ray; prints
     wall-clock rays/s (beside the same render with dot_f32's earlier bf16
     product) and the render's top CUDA kernels by device time;
  5. agreement: a toy-size f32 render on the card against the same render
     on the CPU (the path the CPU tests hold against the JAX package);
  6. train: optimizer steps of the configs/zju.json recipe at full width
     (bf16, 64x64 patch, 64+64 samples, matmul VJP with K1, VGG loss on
     random frozen VGG19, Adam 5e-4) on the synthetic 512² scene: 2
     warm-up and 5 timed steps, finite losses, K1 launched twice a step,
     parameters changed and finite; s/step, rays/s, peak memory and one
     step's top CUDA kernels;
  7. train agreement: one toy f32 step on the card against the same step
     on the CPU (loss, every gradient, the updated parameters);
  8. prints the kernels line, the card line and, last, the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): HBM rate and f32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
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


def phase(name):
    print(f"== {name}", flush=True)


def device_us(e):
    """A profiler event's own device time in us (the name moved in torch 2.x)."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def check_onehot_bilinear(dev) -> dict:
    """K2 against its plain version; returns its kernels-line entry."""
    from keypointnerf_torch.ops import onehot_bilinear as k2

    rs = np.random.default_rng(0)
    entry = None
    # main-path shapes: 3 source views, 256² x 8 tex map, 2048 rays x 64
    # samples per query chunk; plus an odd map shape
    for (V, H, W, C, N) in ((3, 256, 256, 8, 2048 * 64), (3, 33, 17, 8, 5000)):
        maps32 = torch.as_tensor(rs.normal(size=(V, H, W, C)).astype(np.float32), device=dev)
        xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32), device=dev)
        for dt, tol in ((torch.bfloat16, 0.0), (torch.float32, 1e-6)):
            maps = maps32.to(dt).contiguous()
            got = k2.multiview_onehot_bilinear_sample(maps, xy)
            ref = k2.onehot_bilinear_plain(maps, xy)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= tol and got.shape == (V, N, C) and got.dtype == dt
            print(f"K2 onehot_bilinear {V}x{H}x{W}x{C} {str(dt)[6:]} N={N}: "
                  f"max_abs_err={err} (bound {tol}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version: {err}")
            if (H, W, dt) == (256, 256, torch.bfloat16):
                # grid_sample takes the grid in the map's dtype: the
                # yardstick reads bf16-rounded coordinates (cast untimed)
                nchw = maps.permute(0, 3, 1, 2)      # a view of the same map
                grid = xy[:, None].to(dt)             # (V, 1, N, 2)
                ms = cuda_ms(lambda: k2.multiview_onehot_bilinear_sample(maps, xy))
                plain_ms = cuda_ms(lambda: k2.onehot_bilinear_plain(maps, xy), iters=10)
                library_ms = cuda_ms(lambda: F.grid_sample(
                    nchw, grid, mode="bilinear", padding_mode="border",
                    align_corners=True))
                esize = maps.element_size()
                n_bytes = maps.numel() * esize + xy.numel() * 4 + V * N * C * esize
                # per point: ~14 flops of coordinates and weights; per
                # output value: 4 mul + 2 add (rows) + 2 mul + 1 add (cols)
                n_ops = V * N * (14 + 9 * C)
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / F32_FLOPS_PER_S * 1e3
                entry = {
                    "name": "onehot_bilinear", "route": "cuda",
                    "source": "keypointnerf_torch/csrc/onehot_bilinear.cu",
                    "replaces": "keypointnerf_tpu/ops/pallas/onehot_bilinear.py:83",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                }
                print(f"K2 timing (bf16, 3x256x256x8, N=131072): kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, "
                      f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
                      f"{n_bytes} bytes, {n_ops} flops)", flush=True)
    return entry


def _bf16_ulps_apart(a, b):
    """Per entry, whether bf16 a and b lie more than one bf16 ulp apart."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)      # 8 significand bits
    return (a - b).abs() > ulp


def check_onehot_dmap(dev) -> dict:
    """K1 against its plain version; returns its kernels-line entry."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    rs = np.random.default_rng(1)
    entry = None
    # main-path shapes: the fine query of a zju step (3 source views,
    # 4096 rays x 128 samples) on the 128² x 64 coarse map; an odd shape
    for (V, H, W, C, N) in ((3, 128, 128, 64, 4096 * 128), (3, 33, 17, 40, 5000)):
        xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (V, N, 2)).astype(np.float32), device=dev)
        g = torch.as_tensor(rs.normal(size=(V, N, C)).astype(np.float32), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            got = k1.multiview_dmap_onehot(xy, g, H, W, dt)
            ref = k1.onehot_dmap_plain(xy, g, H, W, dt)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            # as bf16 (the map dtype the gradient is cast to): at most one
            # ulp apart, except near zero, where the f32 sum-order error
            # (within `tol`) alone can exceed a bf16 ulp
            gb, rb = got.to(torch.bfloat16), ref.to(torch.bfloat16)
            apart = _bf16_ulps_apart(gb, rb)
            near_zero = (gb.float() - rb.float()).abs() <= tol
            differ = (gb != rb).float().mean().item()
            ok = (err <= tol and not bool((apart & ~near_zero).any())
                  and got.shape == (V, H, W, C) and got.dtype == torch.float32)
            print(f"K1 onehot_dmap {V}x{H}x{W}x{C} terms {str(dt)[6:]} N={N}: "
                  f"max_abs_err={err} (bound {tol}: 1e-5 of max|dmap|, atomic sum order); "
                  f"as bf16 {differ:.6f} of entries differ, {int(apart.sum())} by more than "
                  f"1 ulp (all within the f32 bound: {not bool((apart & ~near_zero).any())}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"K1 disagrees with its plain version: {err}")
            if (H, dt) == (128, torch.bfloat16):
                ms = cuda_ms(lambda: k1.multiview_dmap_onehot(xy, g, H, W, dt), iters=20)
                plain_ms = cuda_ms(lambda: k1.onehot_dmap_plain(xy, g, H, W, dt), iters=5)
                # the yardstick: torch's grid_sample backward (bilinear,
                # border, align_corners), map gradient only, on an f32 map
                fmap = torch.zeros((V, C, H, W), device=dev)
                grid = xy[:, None]                                  # (V, 1, N, 2)
                g_nchw = g.permute(0, 2, 1)[:, :, None].contiguous()  # (V, C, 1, N)
                library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                    g_nchw, fmap, grid, 0, 1, True, [True, False]), iters=20)
                n_bytes = V * N * (2 * 4 + C * 4) + V * H * W * C * 4
                # per point ~14 flops of coordinates and weights; per channel
                # and corner xw*g, yw*t and the add
                n_ops = V * N * (14 + 4 * 3 * C)
                atomics = 4 * C * V * N
                t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
                t_ops = n_ops / F32_FLOPS_PER_S * 1e3
                entry = {
                    "name": "onehot_dmap", "route": "cuda",
                    "source": "keypointnerf_torch/csrc/onehot_dmap.cu",
                    "replaces": "keypointnerf_tpu/ops/pallas/onehot_dmap.py:109",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": library_ms,
                }
                print(f"K1 timing (bf16 terms, 3x128x128x64, N={N}): kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, grid_sampler_2d_backward (f32) "
                      f"{library_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
                      f"({entry['bound_by']}, {n_bytes} bytes, {n_ops} flops); "
                      f"{atomics} f32 atomic adds ({atomics // 4} as float4), "
                      f"{atomics / (ms * 1e-3):.4e} adds/s", flush=True)
    return entry


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


def render_full_width(dev) -> dict:
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    # kernels only: an aten op's device time is its kernels' time again
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    print(f"profile: device time {total / 1e3:.3f} ms in one render "
          f"(wall {seconds * 1e3:.3f} ms)", flush=True)
    for e in sorted(events, key=lambda e: -device_us(e))[:12]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)
    return launches


def agreement_small(dev) -> None:
    """Toy f32 strict render on the card vs the same render on the CPU."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch, strict_preset
    from keypointnerf_torch.render import render_image

    base = KeypointNeRFConfig(n_coarse=4, n_fine=4, geo_n_downsample=2)
    cfg = dataclasses.replace(strict_preset(base, cull_budget=0.6), compute_dtype=torch.float32)
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
    print(f"toy f32 render, card vs CPU: max relative error {worst:.3e} (bound 1e-4)",
          flush=True)
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


def train_full_width(dev, warmup=2, steps=5) -> dict:
    """Optimizer steps of the zju recipe at full width; returns the K1
    launch count of one step."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.ops import multiview_dmap_onehot as k1
    from keypointnerf_torch.ops import multiview_onehot_bilinear_sample as k2
    from keypointnerf_torch.training import (
        LossConfig, OptimConfig, TrainDraws, create_train_state, train_step_fn)

    cfg = zju_config()
    print(f"train config (configs/zju.json model section): n_coarse={cfg.n_coarse} "
          f"n_fine={cfg.n_fine} patch={cfg.patch_h}x{cfg.patch_w} dtype={cfg.compute_dtype} "
          f"matmul_vjp={cfg.train_matmul_gather_vjp} pallas_dmap={cfg.train_pallas_dmap} "
          f"remat={cfg.remat}", flush=True)
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
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    print(f"{warmup} warm-up steps {time.perf_counter() - t0:.3f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    per_step, errs = [], []
    for i in range(steps):
        k1.launches = k2.launches = 0                    # counts of this step only
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        err = step()
        torch.cuda.synchronize()
        per_step.append(time.perf_counter() - t1)
        launches = {"onehot_dmap": k1.launches, "onehot_bilinear": k2.launches}
        errs.append({k: v.item() for k, v in err.items()})
        print(f"step {i}: {per_step[-1]:.4f} s; e_all={errs[-1]['e_all']:.6f} "
              f"grad_norm={errs[-1]['grad_norm']:.6f} "
              f"terms={ {k: round(v, 6) for k, v in errs[-1].items()} }; "
              f"K1 launches {launches['onehot_dmap']}, K2 {launches['onehot_bilinear']}",
              flush=True)
        if launches["onehot_dmap"] != 2:
            raise SystemExit("K1 must run twice a step (coarse and fine query)")
        if not all(math.isfinite(v) for v in errs[-1].values()):
            raise SystemExit("a loss or the gradient norm is not finite")
    seconds = sum(per_step) / steps
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int(not torch.equal(b, p)) for b, p in zip(before, model.parameters()))
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    print(f"train zju full width: {seconds:.4f} s/step (mean of {steps}), {rays / seconds:.1f} "
          f"rays/s; peak memory {peak} bytes ({peak / 2**30:.2f} GiB); {changed} of "
          f"{len(before)} parameter tensors changed, all finite: {finite}", flush=True)
    if changed == 0 or not finite:
        raise SystemExit("the parameters did not change or are not finite")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    total = sum(device_us(e) for e in events)
    print(f"profile: device time {total / 1e3:.3f} ms in one step", flush=True)
    for e in sorted(events, key=lambda e: -device_us(e))[:15]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}", flush=True)
    return launches


def train_agreement_small(dev) -> None:
    """One toy f32 zju-recipe step on the card against the same step on the
    CPU (the path the CPU tests hold against the JAX package)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.training import (
        LossConfig, OptimConfig, TrainDraws, compute_losses, create_train_state, train_step_fn)

    cfg = zju_config(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2,
                     compute_dtype=torch.float32)
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
    print(f"toy f32 train step, card vs CPU: loss terms {loss_err:.3e} relative (bound 1e-4); "
          f"gradients {grad_err:.3e} of each leaf's max (bound 1e-4), ani_al {ani_al:.3e} "
          f"(bound 5e-3), noise leaves {noise:.3e} of the top entry (bound 1e-6); updated "
          f"params {param_err:.3e} absolute where |g| >= 1e-6 (bound 2e-6), {small:.3e} "
          f"elsewhere (bound 2 lr = {2 * lr})", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4 and ani_al <= 5e-3 and noise <= 1e-6
            and param_err <= 2e-6 and small <= 2 * lr):
        raise SystemExit("the card's training step disagrees with the CPU's")


def main() -> int:
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
    built = build_all(KERNELS)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s", flush=True)

    phase("kernels against their plain versions")
    entries = {"onehot_bilinear": check_onehot_bilinear(dev),
               "onehot_dmap": check_onehot_dmap(dev)}
    check_dot_f32(dev)

    phase("full-width strict render")
    launches = render_full_width(dev)

    phase("small-input agreement")
    agreement_small(dev)

    phase("full-width zju training steps")
    launches["onehot_dmap"] = train_full_width(dev)["onehot_dmap"]

    phase("small-input training agreement")
    train_agreement_small(dev)

    for name, entry in entries.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(entries.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
