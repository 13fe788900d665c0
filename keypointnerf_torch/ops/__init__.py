from .feat_sample import (
    DMAP_KERNEL_MIN_CHANNELS,
    bilinear_sample,
    multiview_bilinear_sample,
    multiview_bilinear_sample_mm,
)
from .onehot_bilinear import multiview_onehot_bilinear_sample, onehot_bilinear_plain
from .onehot_dmap import multiview_dmap_onehot, onehot_dmap_plain

__all__ = [
    "DMAP_KERNEL_MIN_CHANNELS",
    "bilinear_sample",
    "multiview_bilinear_sample",
    "multiview_bilinear_sample_mm",
    "multiview_dmap_onehot",
    "multiview_onehot_bilinear_sample",
    "onehot_bilinear_plain",
    "onehot_dmap_plain",
]
