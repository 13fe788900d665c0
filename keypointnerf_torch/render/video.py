"""360-degree orbit-camera paths and orbit rendering.

Port of `keypointnerf_tpu/render/video.py` (reference src/utils.py:23-72
`get_360cameras` + src/model.py:178-235 `render_video_zju`): orbit
extrinsics are built from the SMPL root pose ("headpose"), flipped by a
pi x-rotation, swept by a y-rotation, pushed back trans=5.0 along z; the
focal schedule is fstart + 0.9 (fend - fstart) with fstart = 25 W,
fend = W/8. Frames are rendered from one encoding of the source views,
written as PNGs by the port's writer, and assembled into an mp4 by
ffmpeg where it is installed.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.image_io import write_png
from ..data.zju import rodrigues as _rodrigues


def orbit_cameras(
    headpose: np.ndarray,   # (4, 4) SMPL root pose (rotation + pelvis)
    focal: float,
    trans: float,
    im_w: int,
    im_h: int,
    n_frames: int = 90,
    sc_factor: float = 1.0,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-frame (K (3,3), R (3,3), t (3,)) world->cam cameras, float32."""
    T_i = np.eye(4)
    T_i[:3, :3] = headpose[:3, :3].T
    T_i[:3, 3] = -T_i[:3, :3] @ headpose[:3, 3]

    dR1 = _rodrigues(np.array([np.pi, 0.0, 0.0]))
    K = np.array(
        [[focal, 0, im_w / 2], [0, focal, im_h / 2], [0, 0, 1]], dtype=np.float32
    )
    cams = []
    for idx in range(n_frames):
        theta = 2.0 * np.pi * idx / n_frames
        dR2 = _rodrigues(np.array([0.0, theta, 0.0]))
        ext = np.eye(4)
        ext[:3, :3] = dR1 @ dR2
        ext[:3, 3] = np.array([0.0, 0.0, trans])
        ext = ext @ T_i
        ext[:3, 3] *= sc_factor
        cams.append((K.copy(), ext[:3, :3].astype(np.float32), ext[:3, 3].astype(np.float32)))
    return cams


def zju_orbit_schedule(im_w: int = 512, im_h: int = 512) -> dict:
    """The focal / trans / near / far schedule of render_video_zju
    (reference model.py:178-187)."""
    trans = 5.0
    fstart, fend = im_w * 25.0, im_w * 0.125
    focal = fstart + 0.9 * (fend - fstart)
    return {"focal": focal, "trans": trans, "znear": trans - 3.0, "zfar": trans + 3.0,
            "im_w": im_w, "im_h": im_h}


def write_video(frame_dir: str, video_path: str, fps: int = 30) -> bool:
    """Assemble `frame_dir/%06d.png` into an mp4 with ffmpeg (reference
    model.py:231). Without ffmpeg it prints a line and returns False."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        print(f"write_video: ffmpeg is not installed; the frames stay in {frame_dir}")
        return False
    subprocess.call(
        [ffmpeg, "-y", "-framerate", str(fps), "-i", os.path.join(frame_dir, "%06d.png"),
         "-c:v", "libx264", "-g", "10", "-pix_fmt", "yuv420p",
         "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", video_path],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    return os.path.exists(video_path)


def arc_indices(n_frames: int, arc: str = "full") -> List[int]:
    """Camera subsets of the orbit (reference render_video kwargs
    back_cameras / front_cameras, src/model.py:143-147)."""
    if arc == "back":
        return list(range(n_frames // 4, n_frames - n_frames // 4))
    if arc == "front":
        q = 40 // 4
        return list(range(n_frames - q, n_frames)) + list(range(q))
    return list(range(n_frames))


@torch.no_grad()
def render_orbit(
    model,
    vb,
    headpose: np.ndarray,
    out_dir: str,
    n_frames: int = 90,
    im_size: int = 512,
    stride: int = 1,
    frame_indices: Optional[List[int]] = None,
    make_video: bool = True,
    arc: str = "full",
    frame_group: int = 10,
    auto_cull_budget: int = 0,
    chunk: int = 4096,
) -> Tuple[List[str], float]:
    """Render an orbit around the subject of `vb` (a ViewBatch on the
    model's device) and write `{out_dir}/{index:06d}.png` frames (and the
    mp4 with `make_video`). Returns the written frame paths and the worst
    `cull_overflow` of any frame (0 with the cull off).

    The source views are encoded once; the frames are rendered
    `frame_group` at a time by `render_cameras_scanned`, each group's
    worst `cull_overflow` reported. `auto_cull_budget=N` (with a culling
    model config) probes N cameras spread over the orbit with
    `suggest_cull_budget` and raises the cull budget to cover them before
    any frame renders, as `run_eval` does."""
    from .empty_cull import suggest_cull_budget
    from .renderer import render_cameras_scanned

    sched = zju_orbit_schedule(im_size, im_size)
    # orbit cameras sit at trans=5.0 with a +-3.0 slab
    model = model.with_config(znear=sched["znear"], zfar=sched["zfar"])
    cams = orbit_cameras(headpose, sched["focal"], sched["trans"], sched["im_w"],
                         sched["im_h"], n_frames)
    dev = vb.tar_K.device

    def on_device(i):
        return tuple(torch.as_tensor(a, device=dev) for a in cams[i % n_frames])

    os.makedirs(out_dir, exist_ok=True)
    indices = frame_indices if frame_indices is not None else arc_indices(n_frames, arc)
    # the reference's attach_im_feat caching across the orbit's frames
    # (src/model.py:642-688)
    feats = model.encode(vb.src_images, vb.src_masks)
    if auto_cull_budget and model.cfg.cull_empty_rays_ratio < 1.0:
        step = max(1, len(indices) // auto_cull_budget)
        probe = [on_device(i) for i in indices[::step][:auto_cull_budget]]
        budget, hull = suggest_cull_budget(
            model.cfg, vb, probe, im_size, im_size,
            feats=feats if model.cfg.fused_feature_map else None)
        if budget > model.cfg.cull_empty_rays_ratio:
            print(f"auto_cull_budget: raising cull budget {model.cfg.cull_empty_rays_ratio} "
                  f"-> {budget} (probed {len(probe)} orbit cameras, worst hull {hull:.3f})")
            model = model.with_config(cull_empty_rays_ratio=budget)
    written, worst = [], 0.0
    g = max(1, frame_group)
    for start in range(0, len(indices), g):
        group = indices[start:start + g]
        K, R, t = (torch.stack(x) for x in zip(*(on_device(i) for i in group)))
        rgb, overflow = render_cameras_scanned(model, feats, vb, K, R, t, height=im_size,
                                               width=im_size, stride=stride, chunk=chunk)
        worst = max(worst, float(overflow))
        if float(overflow) > 0:
            print(f"WARNING: frames {group}: empty-ray cull budget exceeded by up to "
                  f"{float(overflow):.0f} rays — these frames are NOT exact; raise "
                  "cull_empty_rays_ratio (size it with render.suggest_cull_budget)")
        imgs = np.clip(rgb.float().cpu().numpy(), 0.0, 1.0)
        for idx, img in zip(group, imgs):
            path = os.path.join(out_dir, f"{idx:06d}.png")
            write_png(path, (img * 255).astype(np.uint8))
            written.append(path)
    if make_video:
        write_video(out_dir, f"{out_dir}_nvs.mp4")
    return written, worst
