from .keypoint_nerf import KeypointNeRF, KeypointNeRFConfig, ViewBatch, check_supported
from .presets import STRICT_CULL_BUDGET, strict_preset
from .vgg import VGG19Features, vgg_loss
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
    "STRICT_CULL_BUDGET",
    "strict_preset",
    "SpatialEncodingConfig",
    "positional_encoding",
    "spatial_encode",
    "spatial_encoding_dim",
    "VGG19Features",
    "vgg_loss",
]
