"""The work counts that rooflines and mfu divide by, against hand counts
at toy shapes, and the FLOP count of the encoders against torch's own
counter run on the reference at a toy size."""
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import peaks, spec, work
from reference import model as ref
from reference.precision import F32

M = spec.data("configs", "zju")["model"]
STRICT = spec.data("configs", "zju_strict")["model"]
FAST = spec.data("configs", "zju_fast")["model"]


def test_k1_bound_by_hand():
    k1 = spec.module("rooflines", "k1")
    V, N, H, W, C = 3, 1000, 16, 32, 8
    t, by = k1.bound(V, N, H, W, C)
    n_bytes = 3 * 1000 * (8 + 8 * 2) + 3 * 16 * 32 * 8 * 4
    assert by == "bytes" and math.isclose(t, n_bytes / 3.35e12)
    shapes = k1.step_launches(M, 3, 512)
    assert shapes == [(3, 4096 * 64, 128, 128, 64), (3, 4096 * 64, 512, 512, 8),
                      (3, 4096 * 64, 256, 256, 8), (3, 4096 * 128, 128, 128, 64),
                      (3, 4096 * 128, 512, 512, 8), (3, 4096 * 128, 256, 256, 8)]


def test_k2_and_k5_by_hand():
    k2, k5 = spec.module("rooflines", "k2"), spec.module("rooflines", "k5")
    t, by = k2.bound(3, 100, 4, 4, 8)
    assert by == "bytes" and math.isclose(t, (3 * 16 * 8 * 2 + 300 * (8 + 16)) / 3.35e12)
    launches = k5.frame_launches(STRICT, 3, 512, 512, 2048)
    assert len(launches) == 48 and launches[0] == (3, 2048 * 64)
    assert k2.frame_launches(STRICT, 3, 512, 512, 2048)[0] == (3, 2048 * 64, 256, 256, 8)
    # one (view, point): 232x128 + 128x128 + 136x120 + 120x64 multiply-adds
    # per view, 128x64 + 64x64 + 64x2 per point
    t, by = k5.bound(STRICT, 1, 1)
    tensor = 2 * (232 * 128 + 128 * 128 + 136 * 120 + 120 * 64) + 2 * (128 * 64 + 64 * 64 + 64 * 2)
    f32 = 24 * 27 + 8 * (128 + 128 + 120 + 64 + 64) + 6 * 64
    assert by in ("bytes", "f32", "tensor")
    assert math.isclose(peaks.least_time(ops_tensor=tensor)[0], tensor / 989e12)
    assert t >= max(tensor / 989e12, f32 / 67e12)


def test_frame_plan():
    assert work.marched_rays(STRICT, 512) == 49152
    assert work.frame_chunks(FAST, 512, 8192) == [(8192, 6144)] * 8
    assert work.frame_chunks(FAST, 256, 8192) == [(8192, 6144)] * 2
    assert sum(work.frame_queries(STRICT, 512, 2048)) == 49152 * 128


def test_encoder_flops_match_torch_counter():
    fl = spec.module("flops", "keypointnerf")
    from harness import weights

    m = dict(M, geo_n_downsample=2)
    prm = weights.model_weights(m, 3, torch.device("cpu"))
    x = torch.rand(2, 32, 32, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.hg_filter(F32, (2 * x - 1).permute(0, 3, 1, 2), prm, m)
        ref.res_blk_encoder(F32, (2 * x - 1).permute(0, 3, 1, 2), prm, m)
    assert fl.encoder(m, 32, 2)[0] == fc.get_total_flops()


def test_query_flops_match_torch_counter():
    fl = spec.module("flops", "keypointnerf")
    from harness import weights

    prm = weights.model_weights(M, 3, torch.device("cpu"))
    V, N = 3, 10
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        enc = torch.rand(V, N, 168)
        out, valid, latent = ref.geo_mlp(F32, prm, M, enc, torch.rand(V, N, 64),
                                         torch.rand(V, N, 8), torch.ones(V, N, 1),
                                         torch.full((V, N, 1), 1 / 3))
        ref.linear(F32, latent, prm, "ibr_compress_gfeat")
        ref.ibr_head(F32, prm, torch.rand(V, N, 35), torch.rand(V, N, 4), torch.ones(V, N, 1))
    assert fl.query_point(M, V) * N == fc.get_total_flops()
