from .feat_sample import bilinear_sample, multiview_bilinear_sample
from .onehot_bilinear import multiview_onehot_bilinear_sample, onehot_bilinear_plain

__all__ = [
    "bilinear_sample",
    "multiview_bilinear_sample",
    "multiview_onehot_bilinear_sample",
    "onehot_bilinear_plain",
]
