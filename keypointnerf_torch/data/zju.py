"""ZJU-MoCap dataset loader (host-side numpy).

The port's own copy of `keypointnerf_tpu/data/zju.py`. It produces
ViewBatch-shaped dicts of numpy arrays with the exact preprocessing of the
reference loader (reference src/zju_dataset.py:36-474): annots.npy camera
parsing, undistortion, 0.5x INTER_AREA resize,
foreground masking (mask | mask_cihp), intrinsics scaling, SMPL joints3d
keypoints, SMPL-vertex AABB bounds (z +- 0.05) and the per-pixel
mask_at_box ray/AABB test. View selection policy is identical: train
shuffles all cameras and takes 3 sources + 1 disjoint target; test uses
fixed sources [0, 7, 15] with the indexed camera as target.

Images and masks are read by `data/image_io.py`: PNG by the port's own
decoder, JPEG by imageio (an ImportError where it is missing). The image
operations run in the native library built from `native/kpnerf_data.cc`
(`data/native_loader.py`); the JAX loader's cv2 fallback is not ported.
The head pose takes a numpy Rodrigues where JAX calls cv2.Rodrigues.
Given the same tree, a sample equals the JAX loader's bit for bit.

Deliberate fix vs the reference: `data_root` is immutable here — the
reference cumulatively re-joins it per human (zju_dataset.py:71), a latent
path bug (SURVEY.md §7 quirks).
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from . import native_loader as nl
from .image_io import imread

TEST_INPUT_VIEWS = [0, 7, 15]
SAMPLE_CAM_313_315 = [3, 5, 10, 12, 18, 21]
SAMPLE_CAM_DEFAULT = [3, 5, 10, 12, 18, 20]
# cameras 19/20 are missing from 313/315 (reference zju_dataset.py:233)
CAM_IDX_313_315 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 21, 22]


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (cv2.Rodrigues), in float64."""
    r = np.asarray(r, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = r / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def get_human_split(split: str) -> Dict[str, Dict[str, int]]:
    """Per-subject frame ranges (reference zju_dataset.py:18-34)."""
    if split == "train":
        return {
            "CoreView_313": {"begin_i": 0, "i_intv": 1, "ni": 60},
            "CoreView_315": {"begin_i": 0, "i_intv": 6, "ni": 400},
            "CoreView_377": {"begin_i": 0, "i_intv": 30, "ni": 300},
            "CoreView_386": {"begin_i": 0, "i_intv": 6, "ni": 300},
            "CoreView_390": {"begin_i": 700, "i_intv": 6, "ni": 300},
            "CoreView_392": {"begin_i": 0, "i_intv": 6, "ni": 300},
            "CoreView_396": {"begin_i": 810, "i_intv": 5, "ni": 270},
        }
    return {
        "CoreView_387": {"begin_i": 0, "i_intv": 1, "ni": 654},
        "CoreView_393": {"begin_i": 0, "i_intv": 1, "ni": 658},
        "CoreView_394": {"begin_i": 0, "i_intv": 1, "ni": 859},
    }


def get_rays_np(H, W, K, R, T):
    """Numpy pinhole rays (reference zju_dataset.py:373-387)."""
    rays_o = -R.T @ T.ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None, None]
    return np.broadcast_to(rays_o, rays_d.shape), rays_d


def get_near_far_np(bounds, ray_o, ray_d, boffset=(-0.01, 0.01)):
    """Slab ray/AABB with the exactly-two-hits rule
    (reference zju_dataset.py:389-422). Returns (near, far, hit_mask).

    Distances are UNSIGNED (abs) on purpose: the reference computes
    d0/d1 = ||p_intersect - ray_o|| / ||ray_d|| (zju_dataset.py:416-418),
    which equals |t| — intersections behind the camera fold to positive
    depths there too. ZJU cameras always sit outside the subject box, so
    the quirk is inert for the dataset, but it is kept for parity; use
    geometry.ray_aabb_intersection for signed free-view clipping."""
    bounds = bounds + np.asarray(boffset)[:, None]
    ray_d = np.where(np.abs(ray_d) < 1e-5, 1e-5, ray_d)
    d_intersect = ((bounds[None] - ray_o[:, None]) / ray_d[:, None]).reshape(-1, 6)
    p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    eps = 1e-6
    lo, hi = bounds[0] - eps, bounds[1] + eps
    ok = np.all((p_intersect >= lo) & (p_intersect <= hi), axis=-1)
    hit = ok.sum(-1) == 2
    dist = np.where(ok, np.abs(d_intersect), np.inf) / np.linalg.norm(ray_d, axis=-1, keepdims=True)
    near = np.min(dist, axis=-1)
    dist_far = np.where(ok, np.abs(d_intersect), -np.inf) / np.linalg.norm(ray_d, axis=-1, keepdims=True)
    far = np.max(dist_far, axis=-1)
    return near, far, hit


def get_mask_at_box(bounds, K, R, T, H, W):
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    _, _, hit = get_near_far_np(
        bounds, ray_o.reshape(-1, 3).astype(np.float32), ray_d.reshape(-1, 3).astype(np.float32)
    )
    return hit.reshape(H, W)


class ZJUDataset:
    """Train/val/test loader. `__getitem__` returns a dict with the
    ViewBatch fields plus a 'meta' dict, or None when files are missing
    (the None-dropping collate of the reference, model.py:102-111)."""

    def __init__(
        self,
        data_root: str,
        split: str,
        max_len: int = -1,
        image_ratio: float = 0.5,
        n_source_views: int = 3,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.split = split
        self.max_len = max_len
        self.ratio = image_ratio
        self.n_src = n_source_views
        self._seed = seed if seed is not None else 0
        self._epoch = 0

        human_info = get_human_split(split)
        self.cams: Dict[str, dict] = {}
        self.ims: List[str] = []
        self.cam_inds: List[int] = []
        self.humans: List[str] = []
        self.human_idx_name = {h: i for i, h in enumerate(human_info)}

        for human, info in human_info.items():
            ann_file = os.path.join(data_root, human, "annots.npy")
            annots = np.load(ann_file, allow_pickle=True).item()
            self.cams[human] = annots["cams"]
            num_cams = len(self.cams[human]["K"])

            if split == "train":
                test_view = list(range(num_cams))
            elif human in ("CoreView_313", "CoreView_315"):
                test_view = SAMPLE_CAM_313_315
            else:
                test_view = SAMPLE_CAM_DEFAULT

            i0, intv, ni = info["begin_i"], info["i_intv"], info["ni"]
            for ims_data in annots["ims"][i0 : i0 + ni][::intv]:
                names = np.array(ims_data["ims"])[test_view]
                for cam_i, name in zip(test_view, names):
                    # 313/315 store "Camera (i)/..._{frame}_..." names
                    if human in ("CoreView_313", "CoreView_315"):
                        frame = name.split("/")[1].split("_")[4]
                        path = os.path.join(data_root, human, name.split("/")[0], f"{frame}.jpg")
                    else:
                        path = os.path.join(data_root, human, name)
                    self.ims.append(path)
                    self.cam_inds.append(cam_i)
                    self.humans.append(human)

    def __len__(self):
        n = len(self.ims)
        return n if self.max_len < 0 else min(n, self.max_len)

    # ----------------------------------------------------------- mask/io
    def _read_mask(self, human: str, cam_dir: str, filename: str):
        base = filename.rsplit(".", 1)[0] + ".png"
        mask = None
        for sub in ("mask", "mask_cihp"):
            p = os.path.join(self.data_root, human, sub, cam_dir, base)
            if os.path.exists(p):
                m = (imread(p) != 0).astype(np.uint8)
                if m.ndim == 3:
                    m = m[..., 0]
                mask = m if mask is None else (mask | m)
        return mask

    def _cam_dir(self, human: str, cam_idx_1based: int) -> str:
        if human in ("CoreView_313", "CoreView_315"):
            return f"Camera ({cam_idx_1based})"
        return f"Camera_B{cam_idx_1based}"

    def _load_view(self, human: str, view_idx: int, filename: str):
        """Load one undistorted, resized, fg-masked view. Returns
        (img, msk, K, R, t) or None if files are missing. The image ops
        run in the native C++ core (OpenMP; native/kpnerf_data.cc)."""
        cams = self.cams[human]
        if human in ("CoreView_313", "CoreView_315"):
            cam_idx = CAM_IDX_313_315[view_idx]
        else:
            cam_idx = view_idx
        cam_dir = self._cam_dir(human, cam_idx + 1)
        img_path = os.path.join(self.data_root, human, cam_dir, filename)
        if not os.path.exists(img_path):
            return None
        msk = self._read_mask(human, cam_dir, filename)
        if msk is None:
            return None

        K = np.array(cams["K"][view_idx], np.float32).reshape(3, 3)
        D = np.array(cams["D"][view_idx], np.float32)
        R = np.array(cams["R"][view_idx], np.float32).reshape(3, 3)
        t = (np.array(cams["T"][view_idx], np.float32) / 1000.0).reshape(3)

        img = imread(img_path).astype(np.float32) / 255.0
        H, W = int(img.shape[0] * self.ratio), int(img.shape[1] * self.ratio)

        img = nl.undistort(img, K, D)
        msk = nl.undistort(msk.astype(np.float32), K, D)
        img = nl.resize_area(img, H, W)
        msk = nl.resize_nearest(msk, H, W)
        img, msk = nl.mask_apply(img, msk)
        K = K.copy()
        K[:2] *= self.ratio
        return img, msk, K, R, t

    # ----------------------------------------------------------- getitem
    def set_epoch(self, epoch: int):
        """Advance the per-epoch view-sampling seed (DistributedSampler
        pattern); thread-safe because __getitem__ derives a fresh RNG from
        (seed, epoch, index)."""
        self._epoch = int(epoch)

    def __getitem__(self, index: int):
        img_path = self.ims[index]
        human = self.humans[index]
        filename = os.path.basename(img_path)
        frame_index = int(filename.rsplit(".", 1)[0])

        if human in ("CoreView_313", "CoreView_315"):
            all_views = list(range(len(CAM_IDX_313_315)))
        else:
            all_views = list(range(len(self.cams[human]["K"])))

        if self.split == "train":
            # per-(seed, epoch, index) RNG: a shared random.Random mutated
            # from the prefetcher's threads would make seeded view
            # selection depend on thread completion order. set_epoch()
            # (called by the Trainer each epoch) restores cross-epoch
            # variety, like the reference's evolving global RNG state.
            # str seeds hash deterministically (random.Random version=2)
            rng = random.Random(f"{self._seed}-{self._epoch}-{index}")
            pool = list(all_views)
            rng.shuffle(pool)
            input_view = pool[: self.n_src]
            tar_pool = [v for v in all_views if v not in input_view]
            tar_view = rng.choice(tar_pool)
        else:
            input_view = list(TEST_INPUT_VIEWS)
            tar_view = self.cam_inds[index]

        views = []
        for v in [tar_view] + input_view:
            loaded = self._load_view(human, v, filename)
            if loaded is None:
                return None
            views.append(loaded)

        imgs = np.stack([v[0] for v in views])
        msks = np.stack([v[1] for v in views])
        Ks = np.stack([v[2] for v in views])
        Rs = np.stack([v[3] for v in views])
        ts = np.stack([v[4] for v in views])

        joints_path = os.path.join(self.data_root, human, "joints3d", f"{frame_index}.npy")
        if not os.path.exists(joints_path):
            return None
        kpt3d = np.load(joints_path).astype(np.float32)

        bounds = self.load_human_bounds(human, frame_index)
        H, W = imgs.shape[1:3]
        mask_at_box = get_mask_at_box(bounds, Ks[0], Rs[0], ts[0], H, W)

        sample = {
            "src_images": imgs[1:],
            "src_masks": msks[1:],
            "src_K": Ks[1:],
            "src_R": Rs[1:],
            "src_t": ts[1:],
            "tar_image": imgs[0],
            "tar_mask": msks[0],
            "tar_K": Ks[0],
            "tar_R": Rs[0],
            "tar_t": ts[0],
            "kpt3d": kpt3d,
            "bounds": bounds,
        }
        meta = {
            "human": human,
            "human_idx": self.human_idx_name.get(human, 0),
            "frame_index": frame_index,
            "tar_cam_id": tar_view,
            "mask_at_box": mask_at_box,
        }
        if self.split in ("test", "val"):
            meta["headpose"] = self._load_headpose(human, frame_index, kpt3d)
        sample["meta"] = meta
        return sample

    def _load_headpose(self, human, frame_index, kpt3d):
        """4x4 root pose for orbit cameras (reference zju_dataset.py:313-330)."""
        params_path = os.path.join(self.data_root, human, "params", f"{frame_index}.npy")
        headpose = np.eye(4, dtype=np.float32)
        if os.path.exists(params_path):
            rh = np.load(params_path, allow_pickle=True).item()["Rh"].reshape(-1)
            headpose[:3, :3] = rodrigues(rh).astype(np.float32)
        headpose[:3, 3] = kpt3d[0]
        return headpose

    def load_human_bounds(self, human, i):
        """SMPL-vertex AABB, z padded +-0.05 (reference zju_dataset.py:354-362)."""
        vertices_path = os.path.join(self.data_root, human, "vertices", f"{i}.npy")
        xyz = np.load(vertices_path).astype(np.float32)
        min_xyz, max_xyz = xyz.min(0), xyz.max(0)
        min_xyz[2] -= 0.05
        max_xyz[2] += 0.05
        return np.stack([min_xyz, max_xyz], axis=0)


class ZJUTestDataset(ZJUDataset):
    """Eval subsampling: every `sample_frame` frames / `sample_camera`
    cameras (reference zju_dataset.py:431-474)."""

    def __init__(self, data_root, split="test", sample_frame=30, sample_camera=1, **kw):
        super().__init__(data_root, split, **kw)
        human_info = get_human_split(self.split)
        keep = []
        start = 0
        for human, info in human_info.items():
            if human in ("CoreView_313", "CoreView_315"):
                num_cams = len(SAMPLE_CAM_313_315)
            else:
                num_cams = len(SAMPLE_CAM_DEFAULT)
            sub_len = info["ni"] * num_cams
            inds = np.arange(start, start + sub_len)
            inds = inds.reshape(info["ni"], -1)[::sample_frame, ::sample_camera]
            keep.extend(inds.ravel().tolist())
            start += sub_len
        self.ims = [self.ims[i] for i in keep]
        self.cam_inds = [self.cam_inds[i] for i in keep]
        self.humans = [self.humans[i] for i in keep]
