"""Training loss stack.

Port of `keypointnerf_tpu/training/losses.py` with the same term names:
coarse L1 (`e_pix_c`), fine L1 / L2 / Lp (`e_pix_l1`, `e_pix_l2`,
`e_pix_lp`), the top-k% hardest-pixel terms, the fine VGG term (`e_vgg`),
the mask MSE terms (`mask_loss_c`, `mask_loss_f`) and their sum `e_all`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.mlp import abs_sel
from ..models.vgg import vgg_loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Defaults reproduce configs/zju.json's loss section."""

    lambda_l1_c: float = 1.0
    lambda_l1: float = 10.0
    lambda_l2: float = 0.0
    lambda_lp: float = 0.0
    lambda_vgg: float = 0.5
    lambda_mloss: float = 0.0
    # "l1top25"-style importance terms: (kind, percent, weight)
    top_losses: Tuple[Tuple[str, float, float], ...] = ()


def _clip(x, lo, hi):
    """`jnp.clip`: maximum then minimum, whose gradients split 0.5 / 0.5 at
    a bound (an opaque ray's acc is exactly 1.0); `clamp` would pass 1."""
    x = torch.maximum(x, torch.full_like(x, lo))
    return torch.minimum(x, torch.full_like(x, hi))


def pix_loss(pred, target, kind: str, top_percent: Optional[float] = None):
    """Per-pixel photometric loss, averaged, or over the top `top_percent`
    of channel-summed pixel losses."""
    diff = pred - target
    if kind == "l1":
        per_pix = abs_sel(diff)
    elif kind == "l2":
        per_pix = diff * diff
    elif kind == "lp":
        per_pix = (abs_sel(diff) + 1e-4) ** 0.4
    else:
        raise ValueError(f"unknown pixel loss {kind}")
    if top_percent is None:
        return per_pix.mean()
    per = per_pix.sum(dim=-1).reshape(-1)
    k = max(1, int(per.shape[0] * top_percent / 100.0))
    return torch.topk(per, k).values.mean()


def compute_losses(out: Dict[str, torch.Tensor], cfg: LossConfig,
                   vgg=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the per-term dict for the model's forward output
    (rgb_coarse / rgb_fine (P, P, 3), acc_* (P, P), target_rgb (P, P, 3),
    target_alpha (P, P, 1)); `vgg` a `VGG19Features` or None."""
    tar = out["target_rgb"]
    err = {}
    if cfg.lambda_l1_c > 0.0 and "rgb_coarse" in out:
        err["e_pix_c"] = cfg.lambda_l1_c * pix_loss(out["rgb_coarse"], tar, "l1")

    fine = out.get("rgb_fine")
    if fine is not None:
        if cfg.lambda_l1 > 0.0:
            err["e_pix_l1"] = cfg.lambda_l1 * pix_loss(fine, tar, "l1")
        if cfg.lambda_l2 > 0.0:
            err["e_pix_l2"] = cfg.lambda_l2 * pix_loss(fine, tar, "l2")
        if cfg.lambda_lp > 0.0:
            err["e_pix_lp"] = cfg.lambda_lp * pix_loss(fine, tar, "lp")
        for kind, pct, w in cfg.top_losses:
            err[f"e_pix_{kind}top{int(pct)}"] = w * pix_loss(fine, tar, kind, pct)
        if cfg.lambda_vgg > 0.0 and vgg is not None:
            err["e_vgg"] = cfg.lambda_vgg * vgg_loss(vgg, fine, tar)

    if cfg.lambda_mloss > 0.0 and "target_alpha" in out:
        ta = out["target_alpha"][..., 0]
        for key, name in (("acc_coarse", "mask_loss_c"), ("acc_fine", "mask_loss_f")):
            if key in out:
                a = _clip(out[key], 1e-3, 1.0)
                err[name] = cfg.lambda_mloss * ((a - ta) ** 2).mean()

    total = torch.zeros((), device=tar.device)
    for v in err.values():
        total = total + v
    err["e_all"] = total
    return total, err
