#!/usr/bin/env python3
"""Smoke run of the PyTorch port (keypointnerf_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, TF32 switched off for matmuls and cuDNN convs;
  2. build: nvcc compiles every kernel of keypointnerf_torch/csrc/ (one
     process per source, all at once) into build/kernels/;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (and an odd map shape), with its time, the
     plain version's time, one PyTorch library call's time and the bound;
  4. render: one 512² camera of the strict preset at full width (the zju
     architecture, bf16, cull budget 0.1875, seeded random weights) on the
     synthetic 512² scene with 3 source views; checks finite outputs,
     cull_overflow == 0 and each kernel's launch count in that render, and
     that the culled render is bit-equal to marching every ray; prints
     wall-clock rays/s and the render's top CUDA kernels by device time;
  5. agreement: a toy-size f32 render on the card against the same render
     on the CPU (the path the CPU tests hold against the JAX package);
  6. prints the kernels line, the card line and, last, the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): HBM rate and f32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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
    def device_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0) or 0)

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
    entries = {"onehot_bilinear": check_onehot_bilinear(dev)}

    phase("full-width strict render")
    launches = render_full_width(dev)

    phase("small-input agreement")
    agreement_small(dev)

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
