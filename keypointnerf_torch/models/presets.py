"""The inference presets — port of `keypointnerf_tpu/models/presets.py`.

* `fast_preset`: the serving path of `configs/zju_fast.json`: bf16, one
  fused feature map (halved for inputs of at least
  `fused_map_half_min_side`), the stride-2 gather-lerp along each ray,
  the exact empty-ray cull (budget 0.25 on the bench orbit) and a mild
  fine cut (the top 0.75 of each chunk's rays by coarse opacity) inside
  the culled set; no coarse cut.
* `strict_preset`: strict reference semantics: the full 128-depth
  coarse+fine union composited, exact per-map bilinear lookups,
  softplus100, every ray marched or provably zero. The only optimizations
  on are exact ones: the coarse-value reuse merge, the tex lookup through
  kernel K2 (same bilinear function), and the empty-ray cull with its
  runtime `cull_overflow` guard.

Both force the training-only flags off: they describe eval programs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .keypoint_nerf import KeypointNeRFConfig

# Exact-cull budgets for the bench orbit scene (512² inputs, 3.5-radius
# cameras): the JAX package's values, kept so the two render the same rays.
FAST_CULL_BUDGET = 0.25
STRICT_CULL_BUDGET = 0.1875

# eval presets never carry training-path flags
_TRAIN_FLAGS_OFF = dict(
    remat=False,
    remat_save_gathers=False,
    train_matmul_gather_vjp=False,
    train_pallas_dmap=False,
)


def fast_preset(
    base: Optional[KeypointNeRFConfig] = None,
    *,
    cull_budget: float = FAST_CULL_BUDGET,
) -> KeypointNeRFConfig:
    """The fast inference configuration in bf16; `base` supplies the
    architecture (the zju defaults when None)."""
    base = KeypointNeRFConfig() if base is None else base
    return dataclasses.replace(
        base,
        compute_dtype=torch.bfloat16,
        fused_feature_map=True,
        fused_map_half=True,
        gather_lerp=True,
        gather_lerp_stride=2,
        nl_relu_approx=False,
        tex_onehot_sample=False,
        cull_empty_rays_ratio=cull_budget,
        fine_topk_ratio=0.75,
        coarse_topk_ratio=1.0,
        **_TRAIN_FLAGS_OFF,
    )


def strict_preset(
    base: Optional[KeypointNeRFConfig] = None,
    *,
    cull_budget: float = STRICT_CULL_BUDGET,
) -> KeypointNeRFConfig:
    """Strict reference semantics in bf16; `base` supplies the architecture
    (the zju defaults when None)."""
    base = KeypointNeRFConfig() if base is None else base
    return dataclasses.replace(
        base,
        compute_dtype=torch.bfloat16,
        fused_feature_map=False,
        fused_map_half=False,
        gather_lerp=False,
        nl_relu_approx=False,
        fine_topk_ratio=1.0,
        coarse_topk_ratio=1.0,
        tex_onehot_sample=True,
        cull_empty_rays_ratio=cull_budget,
        **_TRAIN_FLAGS_OFF,
    )
