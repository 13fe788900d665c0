"""K1, the map gradient of a bilinear lookup (keypointnerf_torch/csrc/
onehot_dmap.cu): for V maps of H x W x C and V x N points with their
cotangent rows, dmap[v, texel] = sum of each point's corner weight times
its cotangent row, over the points whose four corners touch the texel.

Work, each input read once and the output written once: 8 bytes of
coordinates and the C-wide cotangent row a point (bfloat16 in the zju
step: 2 bytes a value), the float32 dmap written once. Operations: per
point 14 for its coordinates and corner weights, per channel and corner
a multiply and an add for the weighted row and one add into the sum (12
a channel), at the float32 rate (no tensor cores). At the zju step's
shapes the bytes bound it.

A zju step makes 6 launches: the coarse and the fine query each send the
gradient of three maps through K1 (the coarse geometry map, the packed
full map's 8 hires channels, the texture map)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import peaks, work  # noqa: E402

KERNELS = ("keys_kernel", "scan_kernel", "sort_pass_kernel", "accumulate_kernel",
           "pieces_kernel", "combine_kernel")
# the kernel each launch of K1 runs exactly once: its launches count K1's
ONCE_A_LAUNCH = ("keys_kernel",)


def bound(V, N, H, W, C, g_bytes=2):
    n_bytes = V * N * (8 + C * g_bytes) + V * H * W * C * 4
    ops = V * N * (14 + 12 * C)
    return peaks.least_time(ops_f32=ops, n_bytes=n_bytes)


def step_launches(m, views, image_size):
    """(V, N, H, W, C) of each launch of one training step."""
    maps = work.map_shapes(m, image_size)
    return [(views, n) + maps[k] for n in work.train_queries(m) for k in ("coarse", "hd", "tex")]
