"""K2, the texture map's bilinear lookup at eval
(keypointnerf_torch/csrc/onehot_bilinear.cu): V maps of H x W x C in
bfloat16 looked up at V x N points.

Work, each input read once and the output written once: the map (2 bytes
a value), 8 bytes of coordinates a point, the C-wide bfloat16 row out.
Operations: per point 14 for coordinates and weights and 8 a channel for
the four weighted corners, at the float32 rate. The bytes bound it.

A strict frame makes one launch a query: two a chunk of marched rays
(n_coarse points a ray, then n_fine with the coarse values reused)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import peaks, work  # noqa: E402



def bound(V, N, H, W, C, esize=2):
    n_bytes = V * H * W * C * esize + V * N * (8 + C * esize)
    ops = V * N * (14 + 8 * C)
    return peaks.least_time(ops_f32=ops, n_bytes=n_bytes)


def frame_launches(m, views, image_size, frame_size, chunk):
    H, W, C = work.map_shapes(m, image_size)["tex"]
    return [(views, n, H, W, C) for n in work.frame_queries(m, frame_size, chunk)]
