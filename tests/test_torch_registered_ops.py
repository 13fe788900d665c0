"""The kernels as registered ops (`torch.ops.kpnerf.*`): K2, K3, K4, K5,
K6, dense_act, rel_z_decay and empty_ray_scores each have a CUDA implementation (the
kernel), a CPU one (its plain version) and a fake one (shapes and dtypes),
which is what lets `torch.export` carry them (keypointnerf_torch/export.py).
K1 is training only and stays a ctypes call.

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


@pytest.mark.parametrize("softplus,out_dtype", [(True, torch.bfloat16), (False, torch.float32)])
def test_dense_act_op(softplus, out_dtype):
    """dense_act: a bf16 block and an f32 one (rounded to bf16 by the op),
    a hidden layer's epilogue (softplus100, bf16 out) and a last layer's."""
    rs = np.random.default_rng(3)
    t = lambda *shape: torch.from_numpy(rs.normal(size=shape).astype(np.float32))  # noqa: E731
    args = ([t(V, N, 24).to(torch.bfloat16), t(V, N, 8)], 0.2 * t(16, 32), 0.1 * t(16),
            softplus, out_dtype)
    torch.library.opcheck(torch.ops.kpnerf.dense_act.default, args, test_utils=UTILS)
    got = ops.fused_dense_act(*args)
    assert got.shape == (V, N, 16) and got.dtype == out_dtype
    assert torch.equal(got, ops.dense_act_plain(*args))


def test_dense_act_exports():
    """A bf16 geometry MLP exported at inference holds the op once a layer
    (the fake implementation's shapes and dtypes carry the trace), and the
    exported program gives the eager module's bits."""
    from keypointnerf_torch.models.mlp import GeoFusionMLP

    mlp = GeoFusionMLP((48, 32, 32, 24, 16), (32, 16, 16, 2), (16, 8), (0, 2),
                       dtype=torch.bfloat16)
    rs = np.random.default_rng(4)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.from_numpy(rs.normal(0.0, 0.3, p.shape).astype(np.float32)))

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = mlp

        def forward(self, sp, f0, f1, mask, weight):
            return self.mlp(sp, [f0, f1], mask, weight)[0]

    t = lambda *shape: torch.from_numpy(rs.normal(size=shape).astype(np.float32))  # noqa: E731
    mask = torch.ones(V, N, 1)
    args = tuple(a.to(torch.bfloat16) for a in (t(V, N, 48), t(V, N, 16), t(V, N, 8), mask,
                                                mask / V))
    with torch.no_grad():
        ep = torch.export.export(Head(), args)
        want = Head()(*args)
    ops_called = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops_called.count(torch.ops.kpnerf.dense_act.default) == 7
    assert torch.equal(ep.module()(*args), want)


@pytest.mark.parametrize("sp_level,n_kpt", [(3, 24), (0, 8)])
def test_rel_z_decay_op(sp_level, n_kpt):
    """rel_z_decay: the op's schema and fake implementation against the CPU
    one (the composition), and the wrapper's values through the op."""
    rs = np.random.default_rng(5)
    pts = torch.from_numpy((rs.normal(size=(V, N, 3)) * 0.3 + [0, 0, 3]).astype(np.float32))
    kpt = torch.from_numpy((rs.normal(size=(V, n_kpt, 3)) * 0.3 + [0, 0, 3]).astype(np.float32))
    args = (pts, kpt, sp_level, 0.1, 1.0)
    torch.library.opcheck(torch.ops.kpnerf.rel_z_decay.default, args, test_utils=UTILS)
    got = ops.fused_rel_z_decay(*args)
    assert got.shape == (V, N, (1 + 2 * sp_level) * n_kpt) and got.dtype == torch.bfloat16
    assert torch.equal(got, ops.rel_z_decay_plain(*args))


def test_rel_z_decay_exports():
    """An encoding exported with the op holds it once (the fake
    implementation's shape and dtype carry the trace into the first dense
    layer), and the exported program gives the eager bits."""
    from keypointnerf_torch.models.mlp import MLP

    mlp = MLP((168, 16, 2), dtype=torch.bfloat16)

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = mlp

        def forward(self, pts, kpt):
            return self.mlp(ops.fused_rel_z_decay(pts, kpt, 3, 0.1, 1.0))

    rs = np.random.default_rng(6)
    args = (torch.from_numpy((rs.normal(size=(V, N, 3)) * 0.3 + [0, 0, 3]).astype(np.float32)),
            torch.from_numpy((rs.normal(size=(V, K, 3)) * 0.3 + [0, 0, 3]).astype(np.float32)))
    with torch.no_grad():
        ep = torch.export.export(Head(), args)
        want = Head()(*args)
    ops_called = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops_called.count(torch.ops.kpnerf.rel_z_decay.default) == 1
    enc = [n for n in ep.graph.nodes if n.target == torch.ops.kpnerf.rel_z_decay.default][0]
    assert enc.meta["val"].shape == (V, N, 168) and enc.meta["val"].dtype == torch.bfloat16
    assert torch.equal(ep.module()(*args), want)


def _cull_args(mode):
    """A cull's per-frame inputs on the synthetic 32² scene: its cell
    table, projection matrices and 50 rays (near / far from the camera's
    slab)."""
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.geometry import camera_rays, compose_krt
    from keypointnerf_torch.models import ViewBatch
    from keypointnerf_torch.render.empty_cull import conservative_mask_cells

    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), "cpu")
    rs = np.random.default_rng(7)
    pix = torch.from_numpy(rs.uniform(0, 32, (50, 2)).astype(np.float32))
    origin, dirs, near, far = camera_rays(pix, vb.tar_K, vb.tar_R, vb.tar_t, 0.5, 8.0)
    cmax = conservative_mask_cells(vb.src_masks, 8)
    krt = compose_krt(vb.src_K, vb.src_R, vb.src_t)
    return (cmax, krt, origin, dirs, near, far, mode, 9, 7, 3, 32, 32, 32, 32, 8)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_empty_ray_scores_op(mode):
    """empty_ray_scores: the op's schema and fake implementation against
    the CPU one (the composition) in each reduction, and the wrapper's
    values through the op."""
    args = _cull_args(mode)
    torch.library.opcheck(torch.ops.kpnerf.empty_ray_scores.default, args, test_utils=UTILS)
    got = ops.fused_empty_ray_scores(*args)
    assert got.shape == (50,) and got.dtype == torch.float32
    assert torch.equal(got, ops.empty_ray_scores_plain(*args))


def test_empty_ray_scores_exports():
    """A cull exported with the op holds it once (the fake implementation
    gives the scores' shape to the threshold after it), and the exported
    program gives the eager bits."""
    args = _cull_args(2)

    class Cull(torch.nn.Module):
        def forward(self, cmax, krt, origin, dirs, near, far):
            scores = ops.fused_empty_ray_scores(cmax, krt, origin, dirs, near, far, *args[6:])
            return scores, (scores > 0.09).sum()

    with torch.no_grad():
        ep = torch.export.export(Cull(), args[:6])
        want = Cull()(*args[:6])
    ops_called = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops_called.count(torch.ops.kpnerf.empty_ray_scores.default) == 1
    node = [n for n in ep.graph.nodes if n.target == torch.ops.kpnerf.empty_ray_scores.default][0]
    assert node.meta["val"].shape == (50,) and node.meta["val"].dtype == torch.float32
    got = ep.module()(*args[:6])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dmap_is_not_registered():
    """K1 (the map gradient, training only) is never exported."""
    assert not hasattr(torch.ops.kpnerf, "onehot_dmap")
