from .keypoint_nerf import KeypointNeRF, KeypointNeRFConfig, ViewBatch, check_supported
from .presets import FAST_CULL_BUDGET, STRICT_CULL_BUDGET, fast_preset, strict_preset
from .vgg import VGG19Features, load_torch_vgg19, vgg_loss
from .spatial_encoding import (
    SpatialEncodingConfig,
    positional_encoding,
    spatial_encode,
    spatial_encoding_dim,
)

__all__ = [
    "KeypointNeRF",
    "KeypointNeRFConfig",
    "ViewBatch",
    "check_supported",
    "FAST_CULL_BUDGET",
    "STRICT_CULL_BUDGET",
    "fast_preset",
    "strict_preset",
    "SpatialEncodingConfig",
    "positional_encoding",
    "spatial_encode",
    "spatial_encoding_dim",
    "VGG19Features",
    "load_torch_vgg19",
    "vgg_loss",
]
