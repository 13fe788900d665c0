"""A toy size of each cell for the CPU tests: the configurations' widths
as they are, small images, few samples and rays."""
import torch


def shrink(cell):
    m = cell.cfg["model"]
    m.update(patch_h=8, patch_w=8, n_coarse=8, n_fine=8, geo_n_downsample=2,
             fused_map_half_min_side=64)
    if m["cull_empty_rays_ratio"] < 1.0:
        # the cull's 8-pixel cells are coarse on a 64-pixel image
        m["cull_empty_rays_ratio"] = 0.5
    cell.mix.update(image_size=64, subjects=2)
    if "frame_size" in cell.mix:
        cell.mix["frame_size"] = 64 if cell.mix["frame_size"] == 512 else 32
    if "frames_per_subject" in cell.mix:
        cell.mix["frames_per_subject"] = 4
    if "render" in cell.cfg:
        cell.cfg["render"]["chunk"] = 256
    cell.wl["check"].pop("reference_chunk", None)
    if "within" in cell.wl["check"]:
        cell.wl["check"]["within"] = 3
    cell.wl["trace"] = {"at": 0, "items": 1}


def shrink_f32(cell):
    shrink(cell)
    cell.cfg["model"]["compute_dtype"] = "f32"


def cpu():
    torch.set_num_threads(4)
    return torch.device("cpu")
