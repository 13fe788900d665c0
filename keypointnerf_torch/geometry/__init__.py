from .aabb import ray_aabb_intersection
from .cameras import (
    camera_center,
    camera_rays,
    compose_krt,
    ndc_xy,
    ndc_z,
    pixel_grid,
    project_points,
    world_to_cam,
)
from .compositing import CompositeOut, composite
from .sampling import (
    importance_z,
    linspace01,
    merge_sorted_payloads,
    stratified_z,
    union_sorted_z,
)

__all__ = [
    "ray_aabb_intersection",
    "camera_center",
    "camera_rays",
    "compose_krt",
    "ndc_xy",
    "ndc_z",
    "pixel_grid",
    "project_points",
    "world_to_cam",
    "CompositeOut",
    "composite",
    "importance_z",
    "linspace01",
    "merge_sorted_payloads",
    "stratified_z",
    "union_sorted_z",
]
