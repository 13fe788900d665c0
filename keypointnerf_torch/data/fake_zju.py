"""A fake ZJU-MoCap tree: the dataset's layout around a rendered sphere.

Exercises the ZJU loader, its workers and the CLIs that read a tree
without the dataset. Every subject gets `annots.npy` (n_cams cameras on a
ring at 3 m, K / D / R / T in the dataset's units, T in millimetres) and
an `ims` list of `n_ims` entries cycling over `frames`; the frames'
images `Camera_B{c}/{frame:06d}{ext}`, the two masks the loader ORs,
`mask/` and `mask_cihp/Camera_B{c}/{frame:06d}.png` (grey, 0 / 1 as the
dataset's; the second is the first moved 2 pixels right, so their OR is
wider than either), `joints3d/`, `vertices/`
and `params/` (with `Rh`) are written once and shared by symlink. PNGs are
written as camera and mask PNGs are, every row with the filter type of
least cost (`write_png`), so their reads take the decoder's
filtered-row reconstruction (the images' rows use all four filters, the
binary masks' Sub and Up). Subjects CoreView_313 / 315,
whose paths the loader forces to `Camera (i)/*.jpg`, get an empty `ims`
list.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Optional, Sequence

import numpy as np

from .image_io import write_png
from .synthetic import look_at, render_sphere

FORCED_JPG = ("CoreView_313", "CoreView_315")


MASK_SHIFT = {"mask": 0, "mask_cihp": 2}     # pixels to the right


def write_fake_tree(root: str, humans: Sequence[str], *, size: int = 64, n_cams: int = 21,
                    frames: Sequence[int] = (0, 30), n_ims: int = 1100,
                    image_exts: Sequence[str] = (".png",), seed: int = 0,
                    write_image: Optional[Callable[[str, np.ndarray], None]] = None) -> None:
    """Write the tree under `root` for `humans`. Frame j's images take
    extension image_exts[j % len] (every view of a frame shares its file
    name, as the loader expects); `write_image(path, uint8 array)` writes
    every image and mask (default: the port's PNG writer); a camera's
    files are written for the first frame and copied for the others."""
    write = write_image or write_png
    rng = np.random.default_rng(seed)
    shared = os.path.join(root, "_shared")
    f = 80.0 * size / 64.0
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float64)
    cams = {"K": [], "D": [], "R": [], "T": []}
    exts = [image_exts[j % len(image_exts)] for j in range(len(frames))]
    for c in range(n_cams):
        ang = 2 * np.pi * c / n_cams
        R, t = look_at(3.0 * np.array([np.cos(ang), 0.1, np.sin(ang)]), np.zeros(3))
        cams["K"].append(K)
        cams["D"].append(np.array([[-0.02], [0.01], [0.001], [-0.001], [0.0]]))
        cams["R"].append(R.astype(np.float64))
        cams["T"].append(t.astype(np.float64).reshape(3, 1) * 1000.0)
        cam_dir = f"Camera_B{c + 1}"
        img, msk, _ = render_sphere(K, R, t, size, 0.5, np.zeros(3))
        files = [(os.path.join(shared, cam_dir), (img * 255).astype(np.uint8), exts)]
        for sub, shift in MASK_SHIFT.items():
            files.append((os.path.join(shared, sub, cam_dir),
                          np.roll(msk[..., 0].astype(np.uint8), shift, axis=1),
                          [".png"] * len(frames)))
        for folder, pixels, file_exts in files:
            os.makedirs(folder, exist_ok=True)
            written = {}
            for fi, ext in zip(frames, file_exts):
                path = os.path.join(folder, f"{fi:06d}{ext}")
                if ext in written:
                    shutil.copyfile(written[ext], path)
                else:
                    write(path, pixels)
                    written[ext] = path
    for sub in ("joints3d", "vertices", "params"):
        os.makedirs(os.path.join(shared, sub), exist_ok=True)
    for fi in frames:
        kpt = (0.3 * rng.standard_normal((24, 3))).clip(-0.45, 0.45).astype(np.float32)
        np.save(os.path.join(shared, "joints3d", f"{fi}.npy"), kpt)
        pts = rng.standard_normal((100, 3))
        pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
        np.save(os.path.join(shared, "vertices", f"{fi}.npy"), pts.astype(np.float32))
        np.save(os.path.join(shared, "params", f"{fi}.npy"),
                {"Rh": rng.uniform(-0.5, 0.5, (1, 3)), "Th": np.zeros((1, 3))},
                allow_pickle=True)
    cam_dirs = [f"Camera_B{c + 1}" for c in range(n_cams)]
    entries = [{"ims": [f"{d}/{fi:06d}{ext}" for d in cam_dirs]} for fi, ext in zip(frames, exts)]
    ims = [entries[i % len(entries)] for i in range(n_ims)]
    for human in humans:
        hdir = os.path.join(root, human)
        os.makedirs(hdir, exist_ok=True)
        if human not in FORCED_JPG:
            for link in cam_dirs + [*MASK_SHIFT, "joints3d", "vertices", "params"]:
                dst = os.path.join(hdir, link)
                if not os.path.lexists(dst):
                    os.symlink(os.path.join("..", "_shared", link), dst)
        annots = {"cams": cams, "ims": [] if human in FORCED_JPG else ims}
        np.save(os.path.join(hdir, "annots.npy"), annots, allow_pickle=True)
