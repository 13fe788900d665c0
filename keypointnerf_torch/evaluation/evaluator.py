"""ZJU evaluation with the reference's protocol.

Port of `keypointnerf_tpu/evaluation/evaluator.py`: full-image PSNR, SSIM
on the mask_at_box bounding-rect crop, and the pred / gt / input PNG trees
under `{result_dir}/{human}/{pred,gt,input}` that `eval_saved_images`
re-scores offline.

The PNGs are written by `data/image_io.py`'s `write_png` (zlib + struct,
8-bit, rows filtered as libpng does), which needs no image library; the
pixels are the ones the JAX package's imageio writer stores.
`eval_saved_images` reads them back with the same module's `read_png`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..data.image_io import read_png, write_png
from .metrics import bounding_rect, psnr, structural_similarity


def _write_png(path: str, img01: np.ndarray) -> None:
    write_png(path, (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8))


class Evaluator:
    def __init__(self, result_dir: Optional[str] = None):
        self.result_dir = result_dir

    def compute_score(
        self,
        rgb_pred: np.ndarray,     # (H, W, 3) in [0, 1]
        rgb_gt: np.ndarray,       # (H, W, 3) in [0, 1]
        mask_at_box: np.ndarray,  # (H, W) bool/0-1
        input_imgs: Optional[np.ndarray] = None,  # (V, H, W, 3)
        human_idx: str = "",
        frame_index: int = 0,
        view_index: int = 0,
    ) -> Dict[str, float]:
        """{"mse", "psnr", "ssim"}; writes the crops (and the inputs) as
        PNGs when the evaluator has a result_dir."""
        rgb_pred = np.asarray(rgb_pred, np.float32)
        rgb_gt = np.asarray(rgb_gt, np.float32)

        mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
        p = psnr(rgb_pred, rgb_gt)

        x, y, w, h = bounding_rect(mask_at_box)
        # widen a rect narrower than the SSIM window (7) so that a subject
        # nearly out of frame does not make structural_similarity raise
        H_img, W_img = rgb_pred.shape[:2]
        if w < 7:
            x = max(0, min(x, W_img - 7))
            w = min(7, W_img)
        if h < 7:
            y = max(0, min(y, H_img - 7))
            h = min(7, H_img)
        crop_pred = rgb_pred[y : y + h, x : x + w]
        crop_gt = rgb_gt[y : y + h, x : x + w]
        s = structural_similarity(crop_pred, crop_gt, multichannel=True)

        if self.result_dir:
            human_dir = os.path.join(self.result_dir, str(human_idx))
            for sub in ("pred", "gt", "input"):
                os.makedirs(os.path.join(human_dir, sub), exist_ok=True)
            _write_png(
                os.path.join(human_dir, "pred", f"frame{frame_index}_view{view_index}.png"),
                crop_pred)
            _write_png(
                os.path.join(human_dir, "gt", f"frame{frame_index}_view{view_index}_gt.png"),
                crop_gt)
            if input_imgs is not None:
                for v in range(len(input_imgs)):
                    _write_png(
                        os.path.join(human_dir, "input", f"frame{frame_index}_t_0_view_{v}.png"),
                        np.asarray(input_imgs[v]))
        return {"mse": mse, "psnr": p, "ssim": s}


def eval_saved_images(src_dir: str) -> Dict[str, float]:
    """Mean PSNR / SSIM of the saved pred / gt PNG pairs under `src_dir`
    (the reference's eval_zju.py). The saved PNGs are the mask_at_box
    crops, so this PSNR is over the crop, while `compute_score`'s is over
    the full image, as in the reference tool."""
    import glob

    gt_files = sorted(glob.glob(os.path.join(src_dir, "*", "gt", "*")))
    scores: Dict[str, list] = {"psnr": [], "ssim": []}
    for gt_file in gt_files:
        pred_file = gt_file.replace(f"{os.path.sep}gt{os.path.sep}",
                                    f"{os.path.sep}pred{os.path.sep}")
        pred_file = pred_file.replace("_gt.png", ".png")
        img_gt = read_png(gt_file).astype(np.float32) / 255.0
        img_pred = read_png(pred_file).astype(np.float32) / 255.0
        scores["psnr"].append(psnr(img_pred, img_gt))
        scores["ssim"].append(structural_similarity(img_pred, img_gt, multichannel=True))
    return {k: float(np.mean(v)) for k, v in scores.items() if v}
