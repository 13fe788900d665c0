from .synthetic import SyntheticConfig, SyntheticDataset, look_at, make_sample
from .zju import (
    ZJUDataset,
    ZJUTestDataset,
    get_human_split,
    get_mask_at_box,
    get_near_far_np,
    get_rays_np,
)

__all__ = [
    "SyntheticConfig",
    "SyntheticDataset",
    "look_at",
    "make_sample",
    "ZJUDataset",
    "ZJUTestDataset",
    "get_human_split",
    "get_mask_at_box",
    "get_near_far_np",
    "get_rays_np",
]
