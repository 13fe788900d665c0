"""The kernels as registered ops (`torch.ops.kpnerf.*`): K2, K3, K4, K5
and K6 each have a CUDA implementation (the kernel), a CPU one (its plain
version) and a fake one (shapes and dtypes), which is what lets
`torch.export` carry them (keypointnerf_torch/export.py). K1 is training
only and stays a ctypes call.

On the CPU, `torch.library.opcheck` checks each op's schema and that its
fake implementation gives the CPU implementation's shapes, dtypes and
strides; each public wrapper returns the plain version's values through
its op. The CUDA implementations are the kernels: their card tests are
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keypointnerf_torch import ops  # noqa: E402
from keypointnerf_torch.ops import fused_geo_mlp as fg  # noqa: E402

UTILS = ("test_schema", "test_faketensor")
V, N, K = 3, 40, 24


def _lookup_args(dt):
    rs = np.random.default_rng(0)
    feats = torch.from_numpy(rs.normal(size=(V, 9, 7, 5)).astype(np.float32)).to(dt)
    xy = torch.from_numpy(rs.uniform(-1.2, 1.2, (V, N, 2)).astype(np.float32))
    return feats, xy


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,wrapper,plain", [
    ("onehot_bilinear", ops.multiview_onehot_bilinear_sample, ops.onehot_bilinear_plain),
    ("dma_gather", ops.multiview_bilinear_sample_dma, ops.dma_gather_plain),
])
def test_lookup_ops(name, wrapper, plain, dt):
    args = _lookup_args(dt)
    torch.library.opcheck(getattr(torch.ops.kpnerf, name).default, args, test_utils=UTILS)
    assert torch.equal(wrapper(*args), plain(*args))


def test_composite_importance_op():
    rs = np.random.default_rng(1)
    R, S, F = 17, 9, 5
    z = torch.from_numpy(np.sort(rs.uniform(2, 5, (R, S)), -1).astype(np.float32))
    alpha, sdf = (torch.from_numpy(rs.uniform(0, 3, (R, S)).astype(np.float32)) for _ in "ab")
    rgb = torch.from_numpy(rs.uniform(0, 1, (R, S, 3)).astype(np.float32))
    u = torch.from_numpy(rs.uniform(0, 1, (R, F)).astype(np.float32))
    args = (z, alpha, sdf, rgb, u)
    torch.library.opcheck(torch.ops.kpnerf.composite_importance.default, args,
                          test_utils=UTILS)
    for got, ref in zip(ops.fused_composite_importance(*args),
                        ops.composite_importance_plain(*args)):
        assert got.shape == ref.shape and torch.equal(got, ref)


def _geo_mlp_inputs(sp_level):
    rs = np.random.default_rng(2)
    t = lambda *shape: torch.from_numpy(rs.normal(size=shape).astype(np.float32))  # noqa: E731
    dsp = (1 + 2 * sp_level) * K
    widths = ((dsp + 64, 32), (32, 32), (32 + 8, 24), (24, 16), (32, 16), (16, 16), (16, 2))
    ws = [x for i, o in widths for x in (0.1 * t(i, o), 0.1 * t(o))]
    mask = torch.from_numpy((rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32))
    weight = mask / (mask.sum(0, keepdim=True) + 1e-6)
    return t(V, N, dsp), t(V, N, 3), t(V, K, 3), t(V, N, 64), t(V, N, 8), mask, weight, ws


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_geo_mlp_ops(dt):
    sp, pts_cam, kpt_cam, f0, f1, mask, weight, ws = _geo_mlp_inputs(3)
    torch.library.opcheck(torch.ops.kpnerf.geo_mlp.default,
                          (sp, f0, f1, mask, weight, ws, dt), test_utils=UTILS)
    torch.library.opcheck(torch.ops.kpnerf.sp_geo_mlp.default,
                          (pts_cam, kpt_cam, f0, f1, mask, weight, ws, 3, 0.1, 1.0, dt),
                          test_utils=UTILS)
    for got, ref in zip(fg.geo_mlp_apply(ws, sp, f0, f1, mask, weight, compute_dtype=dt),
                        fg.mlp_stack_plain(sp, f0, f1, mask, weight, ws, dt)):
        assert torch.equal(got, ref)
    for got, ref in zip(fg.sp_geo_mlp_apply(ws, pts_cam, kpt_cam, f0, f1, mask, weight,
                                            compute_dtype=dt),
                        fg.sp_mlp_stack_plain(pts_cam, kpt_cam, f0, f1, mask, weight, ws,
                                              compute_dtype=dt)):
        assert torch.equal(got, ref)


def test_dmap_is_not_registered():
    """K1 (the map gradient, training only) is never exported."""
    assert not hasattr(torch.ops.kpnerf, "onehot_dmap")
