"""The strict inference preset — port of `strict_preset` in
`keypointnerf_tpu/models/presets.py`.

Strict reference semantics: the full 128-depth coarse+fine union
composited, exact per-map bilinear lookups, softplus100, every ray marched
or provably zero. The only optimizations on are exact ones: the coarse-value
reuse merge, the tex lookup through kernel K2 (same bilinear function), and
the empty-ray cull with its runtime `cull_overflow` guard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .keypoint_nerf import KeypointNeRFConfig

# Exact-cull budget for the bench orbit scene (512² inputs, 3.5-radius
# cameras): the JAX package's value, kept so the two render the same rays.
STRICT_CULL_BUDGET = 0.1875

# eval presets never carry training-path flags
_TRAIN_FLAGS_OFF = dict(
    remat=False,
    remat_save_gathers=False,
    train_matmul_gather_vjp=False,
    train_pallas_dmap=False,
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
