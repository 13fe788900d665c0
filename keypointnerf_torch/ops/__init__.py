from .composite_importance import composite_importance_plain, fused_composite_importance
from .dense_act import dense_act_plain, fused_dense_act
from .dma_gather import dma_gather_plain, multiview_bilinear_sample_dma
from .empty_cull import empty_ray_scores_plain, fused_empty_ray_scores
from .feat_sample import (
    bilinear_sample,
    multiview_bilinear_sample,
    multiview_bilinear_sample_mm,
)
from .fused_geo_mlp import (
    fold_weight_norm,
    geo_mlp_apply,
    mlp_stack_plain,
    sp_geo_mlp_apply,
    sp_mlp_stack_plain,
)
from .onehot_bilinear import multiview_onehot_bilinear_sample, onehot_bilinear_plain
from .onehot_dmap import multiview_dmap_onehot, onehot_dmap_plain
from .rel_z_decay import fused_rel_z_decay, rel_z_decay_plain

__all__ = [
    "bilinear_sample",
    "composite_importance_plain",
    "dense_act_plain",
    "dma_gather_plain",
    "empty_ray_scores_plain",
    "fold_weight_norm",
    "fused_composite_importance",
    "fused_dense_act",
    "fused_empty_ray_scores",
    "fused_rel_z_decay",
    "geo_mlp_apply",
    "mlp_stack_plain",
    "multiview_bilinear_sample",
    "multiview_bilinear_sample_dma",
    "multiview_bilinear_sample_mm",
    "multiview_dmap_onehot",
    "multiview_onehot_bilinear_sample",
    "onehot_bilinear_plain",
    "onehot_dmap_plain",
    "rel_z_decay_plain",
    "sp_geo_mlp_apply",
    "sp_mlp_stack_plain",
]
