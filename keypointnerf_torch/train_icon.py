"""KeypointICON training CLI of the port: single-image 3D reconstruction.

    python -m keypointnerf_torch.train_icon --out_dir /tmp/icon --steps 2000
    python -m keypointnerf_torch.train_icon --out_dir /tmp/icon --device cpu \
        --steps 5 --n_scenes 2 --eval_scenes 1 --resolution 16 --image_size 32

Port of the JAX package's `train_icon.py`, with its flags (and `--device`;
the card unless named) and its outputs: trains `models.keypoint_icon.
KeypointICON` on an analytic keypoint-conditioned shape family and
evaluates the CAPE-style protocol (Chamfer + point-to-surface on UNSEEN
scenes), writing `eval_{i}.obj`, `icon_metrics.json` ({"mean", "scenes"})
and a final JSON line. The scene helpers below are the JAX CLI's own, in
numpy with the same seeds.

Shape family: each scene is a union of spheres centered on a random
subset of the scene's 3D keypoints (radii seeded per scene). Occupancy is
closed-form, images are ray-traced lambertian renders, and — because the
shape is a function of the keypoints — generalization across scenes
exercises exactly the paper's claim that keypoint-relative encodings
carry the geometry.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .data.synthetic import look_at


def make_blob_scene(seed, size=64, n_kpt=24, n_blobs=6, cam_dist=3.5, focal=80.0):
    """One scene: keypoints, blob-union shape, a calibrated camera, and a
    lambertian ray-traced image of the union."""
    rs = np.random.default_rng(seed)
    # keypoint rig: points in a ball (stand-in skeleton)
    u = rs.normal(size=(n_kpt, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    kpt3d = (0.35 * u * rs.uniform(0.3, 1.0, (n_kpt, 1))).astype(np.float32)

    sel = rs.choice(n_kpt, size=n_blobs, replace=False)
    centers = kpt3d[sel].astype(np.float64)
    radii = rs.uniform(0.15, 0.28, n_blobs)

    f = focal * size / 64.0
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    ph = rs.uniform(0, 2 * np.pi)
    el = rs.uniform(-0.3, 0.3)
    eye = cam_dist * np.array(
        [np.cos(ph) * np.cos(el), np.sin(el), np.sin(ph) * np.cos(el)]
    )
    R, t = look_at(eye, np.zeros(3))

    # ray-trace the union: nearest positive hit over all spheres
    H = W = size
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    dirs = (pix @ np.linalg.inv(K).T) @ R
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = -R.T @ t

    t_best = np.full(len(dirs), np.inf)
    n_best = np.zeros((len(dirs), 3))
    for c, r in zip(centers, radii):
        oc = origin - c
        b = 2.0 * dirs @ oc
        cc = oc @ oc - r * r
        disc = b * b - 4.0 * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        th = (-b - sq) / 2.0
        ok = (disc > 0) & (th > 0) & (th < t_best)
        t_best = np.where(ok, th, t_best)
        p = origin + dirs * th[:, None]
        n_best = np.where(ok[:, None], (p - c) / r, n_best)

    hit = np.isfinite(t_best)
    ld = np.array([0.3, -0.5, 0.8])
    ld /= np.linalg.norm(ld)
    lam = np.clip(n_best @ ld, 0.0, 1.0)
    albedo = 0.5 + 0.5 * n_best
    rgb = np.where(hit[:, None], albedo * (0.35 + 0.65 * lam[:, None]), 0.0)
    image = np.clip(rgb, 0, 1).reshape(H, W, 3).astype(np.float32)

    lo = centers.min(0) - radii.max() - 0.1
    hi = centers.max(0) + radii.max() + 0.1
    return {
        "image": image, "K": K, "R": R, "t": t, "kpt3d": kpt3d,
        "centers": centers, "radii": radii,
        "bounds": np.stack([lo, hi]).astype(np.float32),
    }


def blob_occupancy(pts, centers, radii):
    d = np.stack(
        [np.linalg.norm(pts - c, axis=-1) - r for c, r in zip(centers, radii)]
    )
    return (d.min(0) < 0).astype("float32")


def blob_surface_points(centers, radii, n=4000, seed=0):
    """Dense GT surface samples: per-sphere samples, rejecting points
    inside any other sphere."""
    rs = np.random.default_rng(seed)
    pts = []
    per = n // len(centers) * 3
    for i, (c, r) in enumerate(zip(centers, radii)):
        u = rs.normal(size=(per, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        p = c + r * u
        inside_other = np.zeros(per, bool)
        for j, (c2, r2) in enumerate(zip(centers, radii)):
            if j != i:
                inside_other |= np.linalg.norm(p - c2, axis=-1) < r2
        pts.append(p[~inside_other])
    pts = np.concatenate(pts)
    if len(pts) > n:
        pts = pts[rs.choice(len(pts), n, replace=False)]
    return pts.astype(np.float32)


def sample_training_points(scene, n_near=256, n_unif=256, rs=None):
    lo, hi = scene["bounds"]
    centers, radii = scene["centers"], scene["radii"]
    k = rs.integers(0, len(centers), n_near)
    u = rs.normal(size=(n_near, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    near = centers[k] + u * (radii[k] + rs.normal(0, 0.05, n_near))[:, None]
    unif = rs.uniform(lo, hi, (n_unif, 3))
    pts = np.concatenate([near, unif]).astype(np.float32)
    return pts, blob_occupancy(pts, centers, radii)


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KeypointICON training (PyTorch port)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--n_scenes", type=int, default=32, help="training scenes")
    p.add_argument("--eval_scenes", type=int, default=4, help="UNSEEN eval scenes")
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--resolution", type=int, default=64, help="occupancy grid")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns icon_metrics.json's content plus the run's
    timings: seconds a step (the steps after the first), grid points a
    second of `occupancy_grid` and seconds of meshing, each over the eval
    scenes."""
    args = create_parser().parse_args(argv)

    import torch

    from .device import resolve_device
    from .evaluation import extract_mesh, save_obj
    from .models.keypoint_icon import (
        KeypointICON, KeypointICONConfig, chamfer_distance, make_icon_train_step,
        occupancy_grid, point_to_surface, surface_points_from_grid,
    )

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = KeypointICONConfig(geo_n_downsample=2 if args.image_size <= 64 else 4)
    model = KeypointICON(cfg, device=dev, seed=args.seed)

    scenes = [
        make_blob_scene(args.seed + i, size=args.image_size, n_kpt=cfg.n_kpt)
        for i in range(args.n_scenes)
    ]
    eval_scenes = [
        make_blob_scene(args.seed + 10_000 + i, size=args.image_size, n_kpt=cfg.n_kpt)
        for i in range(args.eval_scenes)
    ]
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    # each scene's image and camera on the device once
    on_dev = [{k: as_t(sc[k]) for k in ("image", "K", "R", "t", "kpt3d")} for sc in scenes]

    _, step = make_icon_train_step(model, args.lr)
    rs = np.random.default_rng(args.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_first = None
    for i in range(args.steps):
        j = int(rs.integers(0, len(scenes)))
        sc, d = scenes[j], on_dev[j]
        pts, labels = sample_training_points(sc, rs=rs)
        loss = step(d["image"], as_t(pts), as_t(labels), d["K"], d["R"], d["t"], d["kpt3d"])
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"[{i + 1}/{args.steps}] bce={float(loss):.4f}", flush=True)
        if i == 0:
            sync()
            t_first = time.perf_counter()
    sync()
    s_per_step = (time.perf_counter() - t_first) / max(args.steps - 1, 1)

    # CAPE-style eval on unseen scenes: Chamfer + P2S (scene units)
    results, grid_s, mesh_s = [], 0.0, 0.0
    for i, sc in enumerate(eval_scenes):
        t0 = time.perf_counter()
        occ, axes = occupancy_grid(
            model, sc["image"], sc["K"], sc["R"], sc["t"], sc["kpt3d"], sc["bounds"],
            resolution=args.resolution, chunk=16384,
        )
        grid_s += time.perf_counter() - t0
        pred = surface_points_from_grid(occ, axes)
        gt = blob_surface_points(sc["centers"], sc["radii"], seed=i)
        cd = chamfer_distance(pred, gt)
        p2s = point_to_surface(pred, gt)
        t0 = time.perf_counter()
        verts, faces = extract_mesh(occ, axes)
        obj = os.path.join(args.out_dir, f"eval_{i}.obj")
        save_obj(obj, verts, faces)
        mesh_s += time.perf_counter() - t0
        results.append({"scene": i, "chamfer": cd, "p2s": p2s,
                        "n_verts": int(len(verts))})
        print(f"eval[{i}] chamfer={cd:.4f} p2s={p2s:.4f} -> {obj}", flush=True)

    mean = {
        "chamfer": float(np.mean([r["chamfer"] for r in results])),
        "p2s": float(np.mean([r["p2s"] for r in results])),
        "voxel": float((scenes[0]["bounds"][1][0] - scenes[0]["bounds"][0][0])
                       / (args.resolution - 1)),
    }
    with open(os.path.join(args.out_dir, "icon_metrics.json"), "w") as f:
        json.dump({"mean": mean, "scenes": results}, f, indent=2)
    n_eval = max(len(eval_scenes), 1)
    timing = {"s_per_step": s_per_step,
              "grid_points_per_s": n_eval * args.resolution**3 / max(grid_s, 1e-9),
              "mesh_s_per_scene": mesh_s / n_eval}
    print(f"timing: {json.dumps(timing)}", flush=True)
    print(json.dumps({"metric": "icon_unseen_chamfer", "value": round(mean["chamfer"], 4),
                      "unit": "scene-units", "p2s": round(mean["p2s"], 4)}))
    return dict(mean=mean, scenes=results, **timing)


if __name__ == "__main__":
    main()
