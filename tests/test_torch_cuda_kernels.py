"""The port's lookup kernels (K2, K3), the fused geometry MLP's bf16
routes (K4 / K5, wgmma and wmma), the map gradient K1, the fused
composite K6 and the module path's dense layer (`dense_act`) against their
plain versions on a CUDA card, and the one launch they share
(`ops._build.launch`: its error check and count). Every test here
needs the card (marker `cuda`) and skips without one.

This file imports nothing of JAX or Flax, so it runs where the JAX
package's test dependencies are missing:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Bounds are chip_smoke.py's: K2 bit-equal in bf16 and within 1e-6 in f32
(the TPU kernel's rounding order kept per channel), K3 bit-equal in both
(each lerp rounded as the plain version rounds it); K4 / K5 with bf16
products within 5e-3 (worst) and 1e-6 (mean) of each output's largest
entry, `valid` exact; K1 within 1e-5 of max|dmap| and, as bf16, one ulp
except near zero (also at the fused map's 512² x 84 training shape), and
two launches on the same inputs bit-equal (at the training steps' shapes
and at a hot-cell input, held there against an f64 sum); K6 1e-6 (depth
and sdf 5e-6), z_fine within two bins; dense_act's bf16 outputs within one
bf16 ulp (the two sum the same terms in other orders), its f32 outputs within K 2^-23 (sum |x| |w| + |b|) (two f32
sums of the same K terms in different orders), two launches bit-equal.
The channel counts reach every piece width of the
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
from keypointnerf_torch.ops._build import launch  # noqa: E402
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel,shape,n", [
    ("K2", (3, 256, 256, 8), 131_072),    # the render query's map and points
    ("K3", (3, 512, 512, 84), 131_072),
    ("K3", (3, 256, 256, 84), 20_001),    # the fused map at half size, a ragged N
    ("K3", (2, 33, 17, 37), 20_001),      # two views, odd rows
], ids=["K2-render", "K3-render", "K3-256", "K3-2views"])
def test_lookup_kernel_at_render_shape(dev, kernel, shape, n, dtype):
    """Map sizes and point counts of the render query and beyond, bf16
    and f32, at the bounds of test_lookup_kernel_matches_plain."""
    apply, plain, f32_tol = LOOKUPS[kernel]
    dt = getattr(torch, dtype)
    rs = np.random.default_rng(1)
    maps = torch.as_tensor(rs.normal(size=shape).astype(np.float32), device=dev).to(dt)
    xy = torch.as_tensor(rs.uniform(-1.3, 1.3, (shape[0], n, 2)).astype(np.float32),
                         device=dev)
    before = apply.launches
    got, ref = apply(maps, xy), plain(maps, xy)
    torch.cuda.synchronize()
    assert apply.launches == before + 1
    assert got.dtype == dt
    err = float((got.float() - ref.float()).abs().max())
    assert err <= (f32_tol if dt == torch.float32 else 0.0), err


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


# (config, views (None: the config's), N, products' dtype, bound on the
# worst and on the mean deviation, as shares of each output's largest entry)
GEO_CASES = [
    *[(config, None, n, "bfloat16", 5e-3, 1e-6) for config in (ZJU, NARROW)
      for n in (65_536, 65_539)],
    # fewer views and N a multiple of the bf16 kernel's 64-point tile or not,
    # with a point masked in every view: 1e-4 in f32 (sum order), 1e-2 in
    # bf16 (the rare bf16 flip of an activation)
    *[(ZJU, v, n, dt, 1e-4 if dt == "float32" else 1e-2, None)
      for v, n in ((3, 700), (2, 700), (3, 131), (1, 64)) for dt in ("float32", "bfloat16")],
]


@pytest.mark.parametrize("kind", ["k4", "k5"])
@pytest.mark.parametrize("config,views,N,dtype,worst,mean", GEO_CASES,
                         ids=[f"{'zju' if c is ZJU else 'narrow'}-V{v or c[2]}-N{n}-{d}"
                              for c, v, n, d, _, _ in GEO_CASES])
def test_geo_mlp_bf16_route_matches_plain(dev, config, views, N, dtype, worst, mean, kind):
    dims1, dims2, V, K, L, route = config
    V = views or V
    dt = getattr(torch, dtype)
    # f32 products take the f32 kernel; bf16 the config's route at its own
    # views, one of the bf16 routes at fewer
    routes = {"f32"} if dt == torch.float32 else {route} if views is None else {"wgmma", "wmma"}
    ws = _geo_mlp(dev, dims1, dims2)
    rs = np.random.default_rng(N)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    kpt = rs.normal(size=(V, K, 3)) * 0.4 + [0.0, 0.0, 3.0]
    pts = kpt[:, rs.integers(0, K, N)] + rs.normal(size=(V, N, 3)) * 0.15
    mask = (rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32)
    mask[:, 5] = 0.0
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
        got = apply(ws, *lead, *rest, compute_dtype=dt, **kw)
        ref = plain(*lead, *rest, ws, compute_dtype=dt, **kw)
    torch.cuda.synchronize()
    ran = {r for r in before if apply.launches_by_route[r] - before[r]}
    assert sum(apply.launches_by_route[r] - before[r] for r in before) == 1
    assert ran <= routes, ran
    for name, a, b in zip(("out", "valid", "latent_view", "latent_fused"), ref, got):
        assert a.shape == b.shape and bool(torch.isfinite(b).all()), name
        if name == "valid":
            assert torch.equal(a, b)
            continue
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= worst * scale, name
        if mean is not None:
            assert float((a - b).abs().mean()) <= mean * scale, name


# ------------------------------------------------------------------ K1
def _bf16_ulps_apart(a, b):
    """Per entry, whether a and b lie more than one bf16 ulp apart."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() > torch.ldexp(torch.ones_like(a), e - 8)   # 8 significand bits


def _dmap_points(rs, V, N, spread):
    """(V, N, 2) NDC points. "uniform": over [-1.3, 1.3]², a sixth clamped.
    "clustered": as a training patch's samples fall, most in four tight
    clusters a view (thousands of points a cell), a tenth far outside the
    map (clamped to its border rows and columns) and some exactly on it."""
    if spread == "uniform":
        return rs.uniform(-1.3, 1.3, (V, N, 2))
    centers = rs.uniform(-0.9, 0.9, (V, 4, 2))
    xy = centers[np.arange(V)[:, None], rs.integers(0, 4, (V, N))]
    xy = xy + rs.normal(scale=0.004, size=(V, N, 2))
    out = rs.random((V, N)) < 0.1
    xy[out] = rs.choice([-1.0, 1.0], size=(int(out.sum()), 2)) * rs.uniform(1.0, 2.0, (int(out.sum()), 2))
    edge = rs.random((V, N)) < 0.02
    xy[edge, rs.integers(0, 2)] = 1.0
    return xy


def _check_dmap(dev, H, W, C, N, spread, dtype, g_dtype):
    """K1 against its plain version, chip_smoke.py's bounds: within 1e-5 of
    max|dmap| (the kernel sums each cell's terms in another order), and as
    bf16 at most one ulp apart except where that difference is itself
    within the f32 bound (near zero)."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    rs = np.random.default_rng(N + C)
    xy = torch.as_tensor(_dmap_points(rs, 3, N, spread).astype(np.float32), device=dev)
    g = torch.as_tensor(rs.normal(size=(3, N, C)).astype(np.float32), device=dev)
    g = g.to(getattr(torch, g_dtype))
    dt = getattr(torch, dtype)
    before = k1.multiview_dmap_onehot.launches
    got = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    ref = k1.onehot_dmap_plain(xy, g, H, W, dt)
    torch.cuda.synchronize()
    assert k1.multiview_dmap_onehot.launches == before + 1
    assert got.shape == (3, H, W, C) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    tol = 1e-5 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol
    gb, rb = got.to(torch.bfloat16), ref.to(torch.bfloat16)
    near_zero = (gb.float() - rb.float()).abs() <= tol
    assert not bool((_bf16_ulps_apart(gb, rb) & ~near_zero).any())


@pytest.mark.parametrize("shape", [(128, 128, 64, 50_000), (33, 17, 40, 5_000)],
                         ids=["128x128x64", "33x17x40"])
@pytest.mark.parametrize("spread", ["uniform", "clustered"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dmap_kernel_matches_plain_on_card(dev, dtype, g_dtype, spread, shape):
    _check_dmap(dev, *shape, spread, dtype, g_dtype)


@pytest.mark.parametrize("spread", ["uniform", "clustered"])
def test_dmap_kernel_at_fused_map_shape(dev, spread):
    """K1 where the fused map in training sends it: the 3 x 512² x 84 map
    of the synthetic 512² rig, bf16 terms and cotangent, the coarse query's
    262,144 points a view (64 channels in one chunk, 20 in the tail)."""
    _check_dmap(dev, 512, 512, 84, 262_144, spread, "bfloat16", "bfloat16")


def _dmap_f64(xy, g, H, W, dt):
    """onehot_dmap_plain's terms (rounded to `dt` as it rounds them), summed
    in f64: the reference where runs of ~10^5 terms make any f32 order's
    rounding larger than K1's bound."""
    from keypointnerf_torch.ops.feat_sample import bilinear_coords

    V, N, C = g.shape
    x0, y0, wx, wy = bilinear_coords(xy, H, W)
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    base = (torch.arange(V, device=g.device)[:, None] * H + y0) * W + x0
    out = torch.zeros(V * H * W, C, dtype=torch.float64, device=g.device)
    for yw, dy in ((rnd(1.0 - wy), 0), (rnd(wy), 1)):
        for xw, dx in ((1.0 - wx, 0), (wx, 1)):
            out.index_add_(0, (base + dy * W + dx).reshape(-1),
                           (yw[..., None] * rnd(xw[..., None] * g.float())).double().reshape(-1, C))
    return out.reshape(V, H, W, C)


def _patch_points(rs, V, n_rays, n_samples):
    """(V, n_rays * n_samples, 2) NDC points as a training patch's rays
    give them: each ray's samples along a short segment, the rays' segments
    starting within a small square, so a few thousand cells hold them."""
    start = rs.uniform(-0.12, 0.12, (V, n_rays, 1, 2))
    ang = rs.uniform(0.0, 2.0 * np.pi, (V, n_rays, 1))
    step = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * 0.3 / n_samples
    return (start + step * np.arange(n_samples)[None, None, :, None]).reshape(V, -1, 2)


@pytest.mark.parametrize("H,W,C,n_samples,points", [
    (128, 128, 64, 64, "patch"),      # the zju step's coarse query on the 64-channel map
    (128, 128, 64, 128, "patch"),     # its fine query
    (512, 512, 84, 64, "patch"),      # the fused map's coarse query
    (128, 128, 64, 128, "hot"),       # every point in three cells a view
], ids=["zju-coarse", "zju-fine", "fused", "hot-cells"])
def test_dmap_kernel_twice_bit_equal(dev, H, W, C, n_samples, points):
    """Two K1 launches on the same inputs give the same bits, at the
    training steps' shapes (4096 rays a view, the cotangent in bf16 as the
    step hands it over) and at a hot-cell input (each cell's run crosses
    ~1,365 of the segments a warp sums); each within 1e-5 of max|dmap| of
    the plain version's terms summed in f64."""
    from keypointnerf_torch.ops import onehot_dmap as k1

    rs = np.random.default_rng(n_samples + C)
    if points == "hot":
        cells = np.array([[-0.5, 0.2], [0.1, 0.2], [0.7, -0.3]]) + 1e-3
        xy = cells[rs.integers(0, 3, (3, 4096 * n_samples))]
    else:
        xy = _patch_points(rs, 3, 4096, n_samples)
    xy = torch.as_tensor(xy.astype(np.float32), device=dev)
    g = torch.as_tensor(rs.normal(size=(*xy.shape[:2], C)).astype(np.float32),
                        device=dev).bfloat16()
    dt = torch.bfloat16
    first = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    second = k1.multiview_dmap_onehot(xy, g, H, W, dt)
    ref = _dmap_f64(xy, g, H, W, dt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert float((first.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# ------------------------------------------------------------------ K6
K6_NAMES = ("color", "depth", "acc", "sdf", "contrib", "z_fine")


def _composite_inputs(rs, R, S, F, kind):
    """chip_smoke.py's ray-shaped K6 inputs (stratified jittered depths in
    [2, 5], or in [-5, -2] for kind "negative"; 64 all-zero and 64 opaque
    rays) with u = linspace(0, 1, F) as the render passes it. Kind
    "falling": a negative density at the second sample of every ray, so
    the cdf falls there wherever light reaches it (those rays take the
    kernel's warp reductions, the others its binary search)."""
    near = rs.uniform(2.0, 3.0, (R, 1)) - (7.0 if kind == "negative" else 0.0)
    far = near + rs.uniform(1.0, 2.0, (R, 1))
    z = near + (far - near) * (np.arange(S) + rs.uniform(0.0, 0.9, (R, S))) / S
    alpha = np.maximum(rs.normal(size=(R, S)), 0.0) * rs.uniform(0.0, 20.0, (R, 1))
    alpha[:64] = 0.0
    alpha[64:128] = 1e3
    if kind == "falling":
        alpha[:, 1] = -0.5
    u = np.broadcast_to(np.linspace(0.0, 1.0, F), (R, F))
    return [np.asarray(a, np.float32) for a in
            (z, alpha, rs.normal(size=(R, S)), rs.uniform(size=(R, S, 3)), u)]


@pytest.mark.parametrize("R,S,F,kind,offset", [
    (2048, 64, 64, "", False), (1237, 64, 64, "", False),
    (2048, 64, 64, "negative", False), (1237, 3, 16, "", False),
    (512, 256, 64, "", False), (777, 33, 70, "negative", False),
    (640, 100, 48, "", False), (640, 96, 48, "", False),
    (1237, 64, 64, "", True), (2048, 64, 64, "falling", False),
    (640, 100, 48, "falling", False)])
def test_k6_kernel_matches_plain_on_card(dev, R, S, F, kind, offset):
    """K6 against its plain version at chip_smoke.py's bounds: the sums'
    order (1e-6, depth and sdf 5e-6); z_fine within two of its ray's widest
    bins, mean 2e-5. Covers the render's shape, a ragged R, negative
    depths, 3 and 256 samples (1 and 8 a lane), odd S and lanes left
    without samples, F not a multiple of 32, inputs one float off an
    aligned address (no vector loads), and falling cdfs (the warp
    reductions beside the binary search)."""
    from keypointnerf_torch.ops import composite_importance as k6

    rs = np.random.default_rng(R + S)
    ins = []
    for a in _composite_inputs(rs, R, S, F, kind):
        t = torch.empty(a.size + 1, device=dev)
        t = t[1:] if offset else t[:-1]
        ins.append(t.view(a.shape).copy_(torch.from_numpy(a)))
    fn = k6.fused_composite_importance
    before = fn.launches
    got = fn(*ins)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = k6.composite_importance_plain(*ins)
    for name, a, b in zip(K6_NAMES[:5], ref, got):
        assert a.shape == b.shape and bool(torch.isfinite(b).all()), name
        tol = 5e-6 if name in ("depth", "sdf") else 1e-6
        assert (a - b).abs().max().item() <= tol, name
    z_mid = 0.5 * (ins[0][:, 1:] + ins[0][:, :-1])
    widest = (z_mid[:, 1:] - z_mid[:, :-1]).amax(dim=-1, keepdim=True)
    dz = (ref[5] - got[5]).abs()
    assert bool(torch.isfinite(got[5]).all())
    held = torch.ones_like(dz, dtype=torch.bool)
    if kind == "falling":
        # where the cdf falls, {cdf <= u} is no interval, and an edge within
        # rounding of u moves the depth across bins: held where every edge
        # (the plain version's cdf) is at least 1e-5 from u
        cint = ref[4][:, 1:-1] + 1e-5
        cdf = torch.cumsum(cint / cint.sum(dim=-1, keepdim=True), dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
        assert bool((torch.diff(cdf, dim=-1) < 0).any(dim=-1).float().mean() > 0.5)
        held = ((cdf[:, None, :] - ins[4][:, :, None]).abs() >= 1e-5).all(dim=-1)
        assert held.float().mean().item() > 0.9
    assert (dz / widest)[held].max().item() <= 2.0 and dz[held].mean().item() <= 2e-5


# ------------------------------------------------------------------ dense_act
# the render's seven dense layers (input blocks, outputs, softplus100, output
# dtype): layers1 232 -> 128 in two blocks (the encoding, then the fused
# map's coarse feature), 128 -> 128, 136 -> 120 (the hidden state, then the
# hd feature), 120 -> 64 f32 (the latent the pool reads); layers2 128 -> 64
# (the f32 pooled latent), 64 -> 64, 64 -> 2 f32
DENSE_LAYERS = {
    "l1.0": ((168, 64), 128, True, torch.bfloat16),
    "l1.1": ((128,), 128, True, torch.bfloat16),
    "l1.2": ((128, 8), 120, True, torch.bfloat16),
    "l1.3": ((120,), 64, False, torch.float32),
    "l2.0": ((128,), 64, True, torch.bfloat16),
    "l2.1": ((64,), 64, True, torch.bfloat16),
    "l2.2": ((64,), 2, False, torch.float32),
}


def _bf16_steps(a, b):
    """Per entry, how many bf16 values apart a and b (both bf16) lie: one
    step is one ulp, a subnormal's too."""
    def ordered(t):
        bits = t.view(torch.int16).int() & 0xFFFF
        mag = bits & 0x7FFF
        return torch.where(bits >= 0x8000, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def _dense_inputs(dev, widths, n_out, rows, seed=5):
    """He-scaled f32 weights, small biases, and the blocks as the render
    hands them over: a second block a slice of an 84-channel bf16 row, as
    the fused feature map's are (rows only 8-byte aligned); the pooled
    latent (l2.0's input) in f32; the rest contiguous bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = sum(widths)
    w = torch.randn(n_out, K, generator=gen, device=dev) * (2.0 / K) ** 0.5
    bias = 0.05 * torch.randn(n_out, generator=gen, device=dev)
    x = torch.randn(rows, widths[0], generator=gen, device=dev)
    xs = [x if (widths, n_out) == ((128,), 64) else x.to(torch.bfloat16)]
    if len(widths) > 1:
        fmap = torch.randn(rows, 84, generator=gen, device=dev).to(torch.bfloat16)
        off = 0 if widths[1] == 64 else 64
        xs.append(fmap[:, off:off + widths[1]])
    return xs, w, bias


@pytest.mark.parametrize("rows", [1_572_864, 100_003])
@pytest.mark.parametrize("layer", list(DENSE_LAYERS))
def test_dense_act_kernel_matches_plain(dev, layer, rows):
    from keypointnerf_torch.ops import dense_act as da

    widths, n_out, softplus, out_dtype = DENSE_LAYERS[layer]
    xs, w, bias = _dense_inputs(dev, widths, n_out, rows)
    before = da.fused_dense_act.launches
    got = da.fused_dense_act(xs, w, bias, softplus, out_dtype)
    again = da.fused_dense_act(xs, w, bias, softplus, out_dtype)
    ref = da.dense_act_plain(xs, w, bias, softplus, out_dtype)
    torch.cuda.synchronize()
    assert da.fused_dense_act.launches == before + 2
    assert got.shape == ref.shape == (rows, n_out) and got.dtype == out_dtype
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    if out_dtype == torch.bfloat16:
        assert int(_bf16_steps(got, ref).max()) <= 1
    else:
        K = sum(widths)
        x = torch.cat([a.to(torch.bfloat16).float() for a in xs], -1)
        scale = x.abs() @ w.to(torch.bfloat16).float().abs().T + bias.abs()
        assert bool(((got - ref).abs() <= K * 2.0 ** -23 * scale).all())


def test_dense_act_launches_per_frame_and_step(dev):
    """7 launches a query, coarse and fine, in every chunk of a fast render:
    28 for a 256² orbit frame (2 chunks of 8192 rays after the 0.25 cull),
    112 for a 512² frame (8); none in a training step (autograd)."""
    from pathlib import Path

    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.models import KeypointNeRF, VGG19Features, ViewBatch
    from keypointnerf_torch.ops import dense_act as da
    from keypointnerf_torch.render import render_image
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn
    from keypointnerf_torch.utils import load_config

    configs = Path(__file__).resolve().parents[1] / "configs"
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=512, n_views=4), seed=0),
                              device=dev)
    model = KeypointNeRF(load_config(str(configs / "zju_fast.json")).model, device=dev, seed=0)
    for size, want in ((256, 28), (512, 112)):
        before = da.fused_dense_act.launches
        render_image(model, vb, height=size, width=size, chunk=8192)
        assert da.fused_dense_act.launches - before == want, size
    del model
    recipe = load_config(str(configs / "zju.json"))
    model = KeypointNeRF(recipe.model, device=dev, seed=0)
    state = create_train_state(model, recipe.optim, VGG19Features(device=dev, seed=42))
    gen = torch.Generator(device=dev).manual_seed(0)
    before = da.fused_dense_act.launches
    train_step_fn(model, recipe.loss, state, vb, TrainDraws.sample(recipe.model, vb, gen))
    torch.cuda.synchronize()
    assert da.fused_dense_act.launches == before


def test_launch_checks_the_error_code_and_counts(dev):
    """The one launch every wrapper takes (`_build.launch`): the entry point
    gets its arguments and the raw current stream last; a nonzero CUDA
    error code raises RuntimeError naming the kernel and counts nothing, a
    zero one counts one launch."""
    calls = []

    def kpn_stub(*args):
        calls.append(args)
        return calls[-1][0]

    def wrapper():
        pass

    wrapper.launches = 0
    on = torch.empty(1, device=dev)
    with pytest.raises(RuntimeError, match="kpn_stub kernel launch failed: CUDA error 719"):
        launch(wrapper, kpn_stub, on, 719)
    assert wrapper.launches == 0
    launch(wrapper, kpn_stub, on, 0)
    assert wrapper.launches == 1
    assert calls[-1] == (0, torch.cuda.current_stream(dev).cuda_stream)
