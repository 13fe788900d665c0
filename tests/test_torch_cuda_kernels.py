"""The port's lookup kernels (K2, K3) and the fused geometry MLP's bf16
routes (K4 / K5, wgmma and wmma) against their plain versions on a CUDA
card. Every test here needs the card (marker `cuda`) and skips without one.

This file imports nothing of JAX or Flax, so it runs where the JAX
package's test dependencies are missing:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Bounds are chip_smoke.py's: K2 bit-equal in bf16 and within 1e-6 in f32
(the TPU kernel's rounding order kept per channel), K3 bit-equal in both
(each lerp rounded as the plain version rounds it); K4 / K5 with bf16
products within 5e-3 (worst) and 1e-6 (mean) of each output's largest
entry, `valid` exact. The channel counts reach every piece width of the
lookup kernels (`feat_sample.piece_bytes`): 16 bytes (8 bf16, 84 or 8
f32), 8 bytes (84 bf16, 6 f32) and single channels (37, 5); a map offset
by one element takes the single-channel variant too, and points offset by
one float read their xy as two floats.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keypointnerf_torch.models.mlp import GeoFusionMLP  # noqa: E402
from keypointnerf_torch.ops import dma_gather as k3  # noqa: E402
from keypointnerf_torch.ops import fused_geo_mlp as fg  # noqa: E402
from keypointnerf_torch.ops import onehot_bilinear as k2  # noqa: E402
from keypointnerf_torch.ops.feat_sample import piece_bytes  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _lookup_inputs(dev, C, dtype, N, offset_map=False, offset_xy=False, seed=0):
    """A (3, 33, 17, C) map and (3, N, 2) uniform points reaching outside
    [-1, 1]; either may sit one element past an aligned address."""
    rs = np.random.default_rng(seed + C)
    V, H, W = 3, 33, 17
    maps = torch.as_tensor(rs.normal(size=(V * H * W * C + 1,)).astype(np.float32),
                           device=dev).to(dtype)
    maps = maps[1:] if offset_map else maps[:-1]
    xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (V * N * 2 + 1,)).astype(np.float32),
                         device=dev)
    xy = xy[1:] if offset_xy else xy[:-1]
    return maps.view(V, H, W, C), xy.view(V, N, 2)


LOOKUPS = {"K2": (k2.multiview_onehot_bilinear_sample, k2.onehot_bilinear_plain, 1e-6),
           "K3": (k3.multiview_bilinear_sample_dma, k3.dma_gather_plain, 0.0)}


@pytest.mark.parametrize("offsets", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("C", [84, 37, 8, 6, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_lookup_kernel_matches_plain(dev, kernel, dtype, C, offsets):
    dt = getattr(torch, dtype)
    apply, plain, f32_tol = LOOKUPS[kernel]
    maps, xy = _lookup_inputs(dev, C, dt, 5003, *offsets)
    esize = maps.element_size()
    width = piece_bytes(C * esize, esize, maps.data_ptr())
    assert width == esize or not offsets[0]
    before = apply.launches
    got = apply(maps, xy)
    ref = plain(maps, xy)
    torch.cuda.synchronize()
    assert apply.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dt
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= (f32_tol if dt == torch.float32 else 0.0), (width, err)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_lookup_kernel_at_render_shape(dev, kernel):
    """The render query's map size and 3 x 131,072 points, bf16."""
    apply, plain, _ = LOOKUPS[kernel]
    rs = np.random.default_rng(1)
    shape = (3, 256, 256, 8) if kernel == "K2" else (3, 512, 512, 84)
    maps = torch.as_tensor(rs.normal(size=shape).astype(np.float32), device=dev).bfloat16()
    xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (3, 131_072, 2)).astype(np.float32),
                         device=dev)
    got, ref = apply(maps, xy), plain(maps, xy)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


ZJU = ((168, 128, 128, 120, 64), (128, 64, 64, 2), 3, 24, 3, "wgmma")
NARROW = ((80, 96, 96, 80, 48), (96, 48, 48, 2), 5, 16, 2, "wmma")


def _geo_mlp(dev, dims1, dims2, seed=3):
    rs = np.random.default_rng(seed)
    mlp = GeoFusionMLP(dims1, dims2, (64, 8), (0, 2), dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if name.endswith("weight_g"):
                vals = np.sqrt(2.0) * (1.0 + 0.1 * rs.normal(size=p.shape))
            elif name.endswith("bias"):
                vals = 0.05 * rs.normal(size=p.shape)
            else:
                vals = rs.normal(0.0, np.sqrt(2.0 / p.shape[1]), p.shape)
            p.copy_(torch.as_tensor(vals, dtype=p.dtype))
        return [w.detach().clone() for w in fg.fold_weight_norm(mlp.to(dev))]


@pytest.mark.parametrize("N", [65_536, 65_539])
@pytest.mark.parametrize("kind", ["k4", "k5"])
@pytest.mark.parametrize("config", [ZJU, NARROW], ids=["zju", "narrow"])
def test_geo_mlp_bf16_route_matches_plain(dev, config, kind, N):
    dims1, dims2, V, K, L, route = config
    ws = _geo_mlp(dev, dims1, dims2)
    rs = np.random.default_rng(N)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    kpt = rs.normal(size=(V, K, 3)) * 0.4 + [0.0, 0.0, 3.0]
    pts = kpt[:, rs.integers(0, K, N)] + rs.normal(size=(V, N, 3)) * 0.15
    mask = (rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32)
    rest = (f32(rs.normal(size=(V, N, 64))), f32(rs.normal(size=(V, N, 8))), f32(mask),
            f32(mask / (mask.sum(0, keepdims=True) + 1e-6)))
    pts, kpt = f32(pts), f32(kpt)
    if kind == "k4":
        apply, plain, kw = fg.geo_mlp_apply, fg.mlp_stack_plain, {}
        lead = (fg.rel_z_decay_encoding(pts, kpt, L, 0.1, 1.0),)
    else:
        apply, plain, kw = fg.sp_geo_mlp_apply, fg.sp_mlp_stack_plain, dict(sp_level=L)
        lead = (pts, kpt)
    before = dict(apply.launches_by_route)
    with torch.no_grad():
        got = apply(ws, *lead, *rest, compute_dtype=torch.bfloat16, **kw)
        ref = plain(*lead, *rest, ws, compute_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert {r: apply.launches_by_route[r] - before[r] for r in before} == \
        {r: int(r == route) for r in before}
    for name, a, b in zip(("out", "valid", "latent_view", "latent_fused"), ref, got):
        assert a.shape == b.shape and bool(torch.isfinite(b).all()), name
        if name == "valid":
            assert torch.equal(a, b)
            continue
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 5e-3 * scale, name
        assert float((a - b).abs().mean()) <= 1e-6 * scale, name
