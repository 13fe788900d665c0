"""The work a step or a frame needs, from the configuration and the traffic
alone: rays marched after the cull, chunks, query points, map shapes.
The FLOP counts (flops/) and the kernels' work counts (rooflines/) are
written on these."""
from __future__ import annotations


def marched_rays(m: dict, size: int) -> int:
    """Rays the exact cull leaves of a size x size frame (all without it)."""
    n = size * size
    r = m["cull_empty_rays_ratio"]
    return max(1, min(n, -int(-n * r // 1))) if r < 1.0 else n


def frame_chunks(m: dict, size: int, chunk: int):
    """Per chunk: (rays marched coarse, rays marched fine); padding copies
    of the last chunk are not work the frame needs."""
    k = marched_rays(m, size)
    out = []
    for s in range(0, k, chunk):
        c = min(chunk, k - s)
        f = max(1, int(c * m["fine_topk_ratio"])) if m["fine_topk_ratio"] < 1.0 else c
        out.append((c, f))
    return out


def frame_queries(m: dict, size: int, chunk: int):
    """Per query of a frame: points (the coarse query of a chunk marches
    n_coarse samples a ray; the fine, with the coarse values reused,
    n_fine)."""
    q = []
    for c, f in frame_chunks(m, size, chunk):
        q += [c * m["n_coarse"], f * m["n_fine"]]
    return q


def train_queries(m: dict):
    """Points of the training step's coarse and fine query (the fine query
    re-evaluates the sorted union of both depth sets)."""
    r = m["patch_h"] * m["patch_w"]
    return [r * m["n_coarse"], r * (m["n_coarse"] + m["n_fine"])]


def map_shapes(m: dict, size: int):
    """(H, W, C) of each map the query looks up, by name, for size x size
    source images: the coarse geometry map, the hires map's gradient
    channels (the packed full map's prefix), the texture map."""
    return {"coarse": (size // 4, size // 4, m["geo_out_ch"]),
            "hd": (size, size, m["geo_out_ch_hd"]),
            "tex": (size // 2, size // 2, m["tex_out_ch"])}
