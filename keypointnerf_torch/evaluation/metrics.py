"""Image quality metrics with exact reference parity.

A numpy / scipy copy of `keypointnerf_tpu/evaluation/metrics.py`, kept
here so the port imports nothing of the JAX package.

The reference's numbers (PSNR 25.86 / SSIM 91.07) are defined by:
  * PSNR = -10 * log10(MSE) over the FULL image
    (reference src/zju_evaluator.py:16-19);
  * SSIM = skimage.metrics.structural_similarity(pred, gt,
    multichannel=True) on the mask_at_box bounding-rect crop
    (reference src/zju_evaluator.py:21-45).

skimage is not available in this environment, so `structural_similarity`
is reimplemented here to skimage's exact spec — including the float-input
quirk the reference relies on: with data_range unset and float images,
skimage assumes dtype range (-1, 1), i.e. data_range = 2.0. Defaults:
win_size=7, uniform (non-gaussian) window, K1=0.01, K2=0.03, sample
covariance normalization N/(N-1). Matching these exactly is required for
comparability with the published 25.86/91.07.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    """-10*log10(MSE), full image (reference zju_evaluator.py:16-19)."""
    mse = np.mean((np.asarray(img_pred, np.float64) - np.asarray(img_gt, np.float64)) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _ssim_map(x, y, win_size, data_range, K1, K2):
    """Edge-cropped per-pixel SSIM map (single channel). The ONE place the
    7x7 uniform-window formula lives — both the skimage-parity metric and
    the masked kornia-style metric consume it."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if min(x.shape[:2]) < win_size:
        # skimage raises here too; returning the NaN of an empty crop
        # would silently poison run-level metric aggregates
        raise ValueError(
            f"image {x.shape[:2]} smaller than win_size={win_size}"
        )
    NP = win_size**2
    cov_norm = NP / (NP - 1.0)  # skimage use_sample_covariance=True

    filt = lambda a: uniform_filter(a, size=win_size, mode="reflect")
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux**2 + uy**2 + C1) * (vx + vy + C2)
    )
    # skimage crops the filter's edge effects: pad = (win_size - 1) // 2
    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad] if pad > 0 else S


def _ssim_single(x, y, win_size, data_range, K1, K2):
    return _ssim_map(x, y, win_size, data_range, K1, K2).mean()


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    multichannel: bool = False,
    win_size: int = 7,
    data_range: float | None = None,
    K1: float = 0.01,
    K2: float = 0.03,
) -> float:
    """skimage-compatible SSIM (uniform window, sample covariance).

    With float inputs and data_range=None this uses 2.0 — skimage's dtype
    range for floats — because the reference's published numbers were
    computed that way (zju_evaluator.py:44 passes no data_range).
    """
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if data_range is None:
        if np.issubdtype(im1.dtype, np.floating):
            data_range = 2.0
        else:
            data_range = 255.0
    if multichannel or (im1.ndim == 3 and im1.shape[-1] in (3, 4)):
        vals = [
            _ssim_single(im1[..., c], im2[..., c], win_size, data_range, K1, K2)
            for c in range(im1.shape[-1])
        ]
        return float(np.mean(vals))
    return float(_ssim_single(im1, im2, win_size, data_range, K1, K2))


def bounding_rect(mask: np.ndarray):
    """cv2.boundingRect equivalent: (x, y, w, h) of the mask's nonzero
    region (reference zju_evaluator.py:23)."""
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return 0, 0, mask.shape[1], mask.shape[0]
    x, y = int(xs.min()), int(ys.min())
    return x, y, int(xs.max()) - x + 1, int(ys.max()) - y + 1


def compute_test_metric(pred, gt, mask=None, max_val: float = 1.0):
    """Masked SSIM/PSNR pair (reference src/model.py:237-263
    `compute_test_metric`, which uses kornia SSIM window 7 / PSNR).

    pred/gt: (H, W, 3) in [0, max_val]; mask: optional (H, W) bool weights.
    Returns {"ssim": ..., "psnr": ...}; SSIM uses the 7x7 uniform-window
    map, masked-averaged when a mask is given.
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    win = 7
    pad = (win - 1) // 2

    vals = []
    for c in range(pred.shape[-1]):
        S = _ssim_map(pred[..., c], gt[..., c], win, max_val, 0.01, 0.03)
        if mask is not None:
            m = np.asarray(mask, np.float64)[pad:-pad, pad:-pad]
            vals.append(float((S * m).sum() / (m.sum() + 1e-12)))
        else:
            vals.append(float(S.mean()))
    ssim_val = float(np.mean(vals))

    if mask is not None:
        m = np.asarray(mask, bool)
        diff2 = ((pred - gt) ** 2)[m]
    else:
        diff2 = (pred - gt) ** 2
    mse = float(np.mean(diff2))
    psnr_val = float(10.0 * np.log10(max_val**2 / mse)) if mse > 0 else float("inf")
    return {"ssim": ssim_val, "psnr": psnr_val}
