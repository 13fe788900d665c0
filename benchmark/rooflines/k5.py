"""K5, the rel_z_decay encoding and the geometry MLP in one kernel
(keypointnerf_torch/csrc/fused_geo_mlp.cu, kpn_sp_geo_mlp): for V x N
(view, point) pairs and K keypoints, the encoding, the per-view MLP with
its two feature skips, the masked mean / var pool over views and the
fusion MLP.

Work, counted from the algorithm and the shapes:
* products, at the bfloat16 tensor rate: 2 FLOPs a multiply-add of every
  layer, per (view, point) for the per-view MLP, per point for the
  fusion MLP;
* per-value operations, at the float32 rate, a fixed count each:
  - 27 per (view, point, keypoint) for the encoding: 3 subtractions for
    the offset, 5 for its squared norm, 2 to scale it, 1 exponential, per
    octave 1 multiply and a sine and a cosine (9 for 3 octaves), and 7
    multiplies by the decay weight;
  - 8 per activation value of softplus100 (scale, |y|, negate, exp,
    log1p, max, add, rescale), on every hidden layer's outputs;
  - 6 per (view, point, channel) for the pool (mean: multiply, add; var:
    subtract, square, multiply, add);
* bytes, each input read once and each output written once: the float32
  camera-frame points, keypoints, coarse and hires features, mask and
  pixel weights, the float32 weights; out, valid, the per-view latent and
  the pooled latent written in float32.
The least time is the largest of the three rates' times."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import peaks, work  # noqa: E402
from reference.params import mlp_geo_dims  # noqa: E402

ENCODING_OPS, SOFTPLUS_OPS, POOL_OPS = 27, 8, 6


def bound(m, V, N):
    l1, l2 = mlp_geo_dims(m)
    K = m["n_kpt"]
    tensor = V * N * sum(2 * a * b for a, b in l1) + N * sum(2 * a * b for a, b in l2)
    hidden1 = sum(b for _, b in l1[:-1])
    hidden2 = sum(b for _, b in l2[:-1])
    dl = l1[-1][1]
    f32 = (V * N * K * ENCODING_OPS + SOFTPLUS_OPS * (V * N * hidden1 + N * hidden2)
           + POOL_OPS * V * N * dl)
    weights = sum(a * b + 2 * b for a, b in l1 + l2)
    n_bytes = 4 * (V * N * (3 + m["geo_out_ch"] + m["geo_out_ch_hd"] + 2) + V * K * 3 + weights
                   + N * (l2[-1][1] + 1 + 2 * dl) + V * N * dl)
    return peaks.least_time(ops_tensor=tensor, ops_f32=f32, n_bytes=n_bytes)


def frame_launches(m, views, image_size, frame_size, chunk):
    return [(views, n) for n in work.frame_queries(m, frame_size, chunk)]
