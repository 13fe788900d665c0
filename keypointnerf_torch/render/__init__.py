from .empty_cull import (
    EMPTY_SCORE_THRESHOLD,
    conservative_mask_cells,
    empty_ray_scores,
    suggest_cull_budget,
)
from .renderer import (
    render_cameras_scanned,
    render_image,
    render_images_batched,
    render_rays_chunked,
)

__all__ = [
    "EMPTY_SCORE_THRESHOLD",
    "conservative_mask_cells",
    "empty_ray_scores",
    "suggest_cull_budget",
    "render_cameras_scanned",
    "render_image",
    "render_images_batched",
    "render_rays_chunked",
]
