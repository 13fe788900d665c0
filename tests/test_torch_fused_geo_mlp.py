"""Port parity for the fused geometry MLP (kernels K4 and K5): the port's
`ops/fused_geo_mlp.py` against `keypointnerf_tpu/ops/pallas/fused_geo_mlp.py`
with the Pallas kernels in interpret mode.

Full widths (168 + 64 -> 128 -> 128 [+ 8] -> 120 -> 64, pool, 128 -> 64 ->
64 -> 2), V = 3, N = 700 (not a tile multiple). Inputs come from one seeded
numpy generator and go to both sides; the Flax parameter tree is filled from
a numpy seed and carried to the port's `GeoFusionMLP` by `utils/convert.py`.
On the CPU the port's wrappers run their plain versions (the CUDA kernel is
held against them on the card by chip_smoke.py and the `cuda` test below).

Tolerances: f32 values atol 2e-5 (K4) and 3e-5 (K5), as tests/test_pallas.py
holds the kernels against the Flax module; `valid` exact; gradients within
1e-4 of each leaf's largest entry; the bf16 bounds are measured and pinned
below with their reason.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.models import mlp as jmlp  # noqa: E402
from keypointnerf_tpu.ops.pallas import fused_geo_mlp as jfused  # noqa: E402
from keypointnerf_torch.models import mlp as tmlp  # noqa: E402
from keypointnerf_torch.ops import fused_geo_mlp as tfused  # noqa: E402
from keypointnerf_torch.utils import convert  # noqa: E402

DIMS1, DIMS2 = (168, 128, 128, 120, 64), (128, 64, 64, 2)
V, N, K = 3, 700, 24
DEAD = 5          # a point masked in every view
SP = dict(sp_level=3, sp_sigma=0.1, sp_scale=1.0)
NAMES = ("out", "valid", "latent_view", "latent_fused")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _layers(sd, p):
    convert._mlp_layers(sd, "layers1", len(DIMS1) - 1, p["MLPUNet_0"])
    convert._mlp_layers(sd, "layers2", len(DIMS2) - 1, p["MLP_0"])
    return sd


@pytest.fixture(scope="module")
def case():
    rs = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    kpt_cam = f32(rs.normal(size=(V, K, 3)) * 0.4 + [0.0, 0.0, 3.0])
    # each point within ~0.3 of some keypoint, so the decay is not all zeros
    near = kpt_cam[:, rs.integers(0, K, N)]
    pts_cam = f32(near + rs.normal(size=(V, N, 3)) * 0.15)
    mask = f32(rs.uniform(size=(V, N, 1)) > 0.3)
    mask[:, DEAD] = 0.0
    weight = f32(mask / (mask.sum(0, keepdims=True) + 1e-6))
    arrs = dict(
        sp=f32(rs.normal(size=(V, N, DIMS1[0]))), pts_cam=pts_cam, kpt_cam=kpt_cam,
        f0=f32(rs.normal(size=(V, N, 64))), f1=f32(rs.normal(size=(V, N, 8))),
        mask=mask, weight=weight)
    jm = jmlp.GeoFusionMLP(DIMS1, DIMS2, (64, 8), (0, 2))
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), j["sp"], [j["f0"], j["f1"]], j["mask"], j["weight"]))

    def fill(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return f32(rs.normal(0, np.sqrt(2.0 / s.shape[0]), s.shape))
        if name == "gain":
            return f32(np.sqrt(2.0) * (1.0 + 0.1 * rs.normal(size=s.shape)))
        return f32(0.05 * rs.normal(size=s.shape))

    params = jax.tree_util.tree_map_with_path(fill, shapes)["params"]
    tm = tmlp.GeoFusionMLP(DIMS1, DIMS2, (64, 8), (0, 2))
    tm.load_state_dict(_layers({}, params), strict=True)
    t = {k: _t(v) for k, v in arrs.items()}
    # random cotangents for the three differentiable outputs
    cot = dict(out=f32(rs.normal(size=(N, 2))), lv=f32(rs.normal(size=(V, N, 64))),
               lf=f32(rs.normal(size=(N, 128))))
    return dict(params=params, tm=tm, j=j, t=t, cot=cot)


def _jax_call(case, kind, params=None, compute_dtype=jnp.float32, **over):
    j = dict(case["j"], **over)
    params = case["params"] if params is None else params
    if kind == "k4":
        return jfused.geo_mlp_apply(params, j["sp"], j["f0"], j["f1"], j["mask"], j["weight"],
                                    interpret=True, compute_dtype=compute_dtype)
    return jfused.sp_geo_mlp_apply(params, j["pts_cam"], j["kpt_cam"], j["f0"], j["f1"],
                                   j["mask"], j["weight"], interpret=True,
                                   compute_dtype=compute_dtype, **SP)


def _torch_plain(case, kind, compute_dtype=torch.float32):
    t, ws = case["t"], tfused.fold_weight_norm(case["tm"])
    with torch.no_grad():
        if kind == "k4":
            return tfused.mlp_stack_plain(t["sp"], t["f0"], t["f1"], t["mask"], t["weight"],
                                          ws, compute_dtype)
        return tfused.sp_mlp_stack_plain(t["pts_cam"], t["kpt_cam"], t["f0"], t["f1"],
                                         t["mask"], t["weight"], ws,
                                         compute_dtype=compute_dtype, **SP)


def _torch_apply(case, kind, params=None, compute_dtype=torch.float32, **over):
    t = dict(case["t"], **over)
    params = case["tm"] if params is None else params
    if kind == "k4":
        return tfused.geo_mlp_apply(params, t["sp"], t["f0"], t["f1"], t["mask"], t["weight"],
                                    compute_dtype=compute_dtype)
    return tfused.sp_geo_mlp_apply(params, t["pts_cam"], t["kpt_cam"], t["f0"], t["f1"],
                                   t["mask"], t["weight"], compute_dtype=compute_dtype, **SP)


def test_fold_weight_norm_matches_jax(case):
    ref = jfused.fold_weight_norm(case["params"])
    got = tfused.fold_weight_norm(case["tm"])
    assert len(ref) == len(got) == 14
    for a, b in zip(ref, got):
        assert tuple(b.shape) == a.shape and b.is_contiguous()
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_encoding_takes_each_level_directly(case):
    """The K5 encoding equals `spatial_encode`'s rel_z_decay up to the
    rounding of the double-angle recursion the latter uses."""
    from keypointnerf_torch.models.spatial_encoding import SpatialEncodingConfig, spatial_encode

    t = case["t"]
    got = tfused.rel_z_decay_encoding(t["pts_cam"], t["kpt_cam"], 3, 0.1, 1.0)
    ref = spatial_encode(SpatialEncodingConfig(), None, t["pts_cam"], None, t["kpt_cam"])
    assert got.shape == (V, N, 168)
    assert float(got.abs().max()) > 0.05          # the decay is not all zeros
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("kind,atol", [("k4", 2e-5), ("k5", 3e-5)])
def test_plain_matches_pallas_f32(case, kind, atol):
    ref = _jax_call(case, kind)
    got = _torch_plain(case, kind)
    for name, a, b in zip(NAMES, ref, got):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, name
        if name == "valid":
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_plain_matches_pallas_bf16(case, kind):
    """bf16 operands, f32 sums, on both sides. The sums run in another
    order, so an f32 activation that lies near a bf16 rounding boundary
    now and then rounds to the neighbouring bf16 value before the next
    product; the flips spread through the later layers. Measured worst, as
    a share of each output's largest entry: K4 out 0.47%, latent_view
    0.066%, latent_fused 0.060%; K5 0.16%, 0.10%, 0.053%; the mean error is
    below 0.001% everywhere (most entries are bit-equal). Pinned at 1%
    (max) and 0.01% (mean)."""
    ref = _jax_call(case, kind, compute_dtype=jnp.bfloat16)
    got = _torch_plain(case, kind, torch.bfloat16)
    for name, a, b in zip(NAMES, ref, got):
        a = np.asarray(a, np.float32)
        if name == "valid":
            np.testing.assert_array_equal(b.numpy(), a)
            continue
        err = np.abs(b.numpy() - a)
        scale = np.abs(a).max()
        assert err.max() <= 0.01 * scale, (name, err.max() / scale)
        assert err.mean() <= 1e-4 * scale, (name, err.mean() / scale)


def _loss_jax(case, kind):
    cot = {k: jnp.asarray(v) for k, v in case["cot"].items()}

    def loss(params, pts_cam, sp, f0, f1):
        out, _, lv, lf = _jax_call(case, kind, params, pts_cam=pts_cam, sp=sp, f0=f0, f1=f1)
        return jnp.sum(out * cot["out"]) + jnp.sum(lv * cot["lv"]) + jnp.sum(lf * cot["lf"])

    return loss


def _loss_torch(case, outs):
    out, _, lv, lf = outs
    cot = {k: _t(v) for k, v in case["cot"].items()}
    return (out * cot["out"]).sum() + (lv * cot["lv"]).sum() + (lf * cot["lf"]).sum()


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_function_gradients_match_jax(case, kind):
    """The autograd.Function (forward, then the recompute backward) against
    jax.grad through the Pallas function's custom VJP, f32: the gradient of
    every weight leaf, of the leading input (sp or pts_cam), f0 and f1
    within 1e-4 of its largest entry. JAX's weight gradients ride onto the
    port's parameter names through the converter (renames and transposes)."""
    j = case["j"]
    lead = "sp" if kind == "k4" else "pts_cam"
    jg = jax.grad(_loss_jax(case, kind), argnums=(0, 1, 2, 3, 4))(
        case["params"], j["pts_cam"], j["sp"], j["f0"], j["f1"])
    jg_w = _layers({}, jax.tree.map(np.asarray, jg[0]))
    jg_in = {"pts_cam": jg[1], "sp": jg[2], "f0": jg[3], "f1": jg[4]}

    tm = case["tm"]
    tm.zero_grad()
    ins = {k: case["t"][k].clone().requires_grad_(True) for k in (lead, "f0", "f1")}
    before = (tfused.geo_mlp_apply.launches, tfused.sp_geo_mlp_apply.launches)
    _loss_torch(case, _torch_apply(case, kind, **ins)).backward()
    assert (tfused.geo_mlp_apply.launches, tfused.sp_geo_mlp_apply.launches) == before
    named = dict(tm.named_parameters())
    assert set(named) == set(jg_w)
    for name, p in named.items():
        ref = jg_w[name].numpy()
        assert p.grad is not None, name
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), name
    for name, x in ins.items():
        ref = np.asarray(jg_in[name])
        assert np.abs(ref).max() > 0.0, name
        assert np.abs(x.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), name


@pytest.mark.parametrize("kind", ["k4", "k5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_backward_is_autograd_of_plain(case, kind, dtype):
    """The Function's backward (recompute from the saved inputs) gives what
    autograd gives straight through the plain version, for every input
    that can carry a gradient (kpt_cam and the pool weights included)."""
    t, dt = case["t"], getattr(torch, dtype)
    keys = (["sp"] if kind == "k4" else ["pts_cam", "kpt_cam"]) + ["f0", "f1", "weight"]

    def grads(through_function):
        ins = {k: t[k].clone().requires_grad_(True) for k in keys}
        ws = [w.detach().clone().requires_grad_(True)
              for w in tfused.fold_weight_norm(case["tm"])]
        if through_function:
            outs = _torch_apply(case, kind, ws, dt, **ins)
        else:
            full = dict(t, **ins)
            lead = [full["sp"]] if kind == "k4" else [full["pts_cam"], full["kpt_cam"]]
            outs = tfused._plain(lead, full["f0"], full["f1"], full["mask"], full["weight"],
                                 ws, dt, None if kind == "k4" else (3, 0.1, 1.0))
        leaves = list(ins.values()) + ws
        return outs, torch.autograd.grad(_loss_torch(case, outs), leaves)

    (outs_f, g_f), (outs_p, g_p) = grads(True), grads(False)
    for a, b in zip(outs_f, outs_p):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert not outs_f[1].requires_grad
    for a, b in zip(g_f, g_p):
        scale = float(b.abs().max())
        assert scale > 0.0
        assert float((a - b).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_all_masked_point(case, kind):
    """A point masked in every view is still computed: valid 0, a zero
    latent_fused, and out = fusion(0), the value JAX gives it."""
    ref = _jax_call(case, kind)
    out, valid, _, lf = _torch_apply(case, kind)
    assert float(valid[DEAD, 0]) == 0.0 and float(np.asarray(ref[1])[DEAD, 0]) == 0.0
    assert float(valid.sum()) > 0.5 * N
    np.testing.assert_array_equal(lf[DEAD].detach().numpy(), np.zeros(128, np.float32))
    np.testing.assert_allclose(out[DEAD].detach().numpy(), np.asarray(ref[0])[DEAD],
                               atol=2e-5, rtol=0)
    assert float(out[DEAD].detach().abs().max()) > 0.0


def _with_w0_rows(case, dsp):
    """The folded weights with a zero W0 for a `dsp`-wide encoding."""
    ws = list(tfused.fold_weight_norm(case["tm"]))
    ws[0] = torch.zeros((dsp + 64, DIMS1[1]))
    return ws


def test_wrappers_refuse_bad_inputs(case):
    t = case["t"]
    with pytest.raises(TypeError, match="float32"):
        _torch_apply(case, "k4", f0=t["f0"].double())
    with pytest.raises(TypeError, match="float32"):
        _torch_apply(case, "k5", pts_cam=t["pts_cam"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="compute_dtype"):
        _torch_apply(case, "k4", compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="f1 must be"):
        _torch_apply(case, "k4", f1=t["f1"][:, :-1])
    with pytest.raises(ValueError, match="mask must be"):
        _torch_apply(case, "k5", mask=t["mask"][..., 0])
    with pytest.raises(ValueError, match="pts_cam"):
        _torch_apply(case, "k5", pts_cam=t["pts_cam"][..., :2])
    with pytest.raises(ValueError, match="layer 0"):
        _torch_apply(case, "k4", sp=t["sp"][..., :-8])
    with pytest.raises(ValueError, match="14 folded weights"):
        _torch_apply(case, "k4", params=tfused.fold_weight_norm(case["tm"])[:-2])
    with pytest.raises(ValueError, match="tensors on"):
        _torch_apply(case, "k4", f0=t["f0"].to("meta"))
    # a device with neither the kernel nor the plain route
    meta = {k: v.to("meta") for k, v in t.items()}
    ws = [w.to("meta") for w in tfused.fold_weight_norm(case["tm"])]
    with pytest.raises(ValueError, match="no kernel for device"):
        tfused.geo_mlp_apply(ws, meta["sp"], meta["f0"], meta["f1"], meta["mask"],
                             meta["weight"])

    # what no kernel takes (a tile over one block's shared memory, more
    # levels than the frequency table) is refused on the route before any
    # build or launch, so CPU tensors reach the check
    def launch(kind, ws=None, compute_dtype=torch.bfloat16, sp_args=(3, 0.1, 1.0), **over):
        x = dict(t, **over)
        ws = tfused.fold_weight_norm(case["tm"]) if ws is None else ws
        lead = (x["sp"],) if kind == "k4" else (x["pts_cam"], x["kpt_cam"])
        sp_args = None if kind == "k4" else sp_args
        rest = (x["f0"], x["f1"], x["mask"], x["weight"])
        widths = tfused._check(lead, *rest, ws, compute_dtype, sp_args)
        before = (tfused.geo_mlp_apply.launches, tfused.sp_geo_mlp_apply.launches)
        try:
            tfused._launch(tfused.geo_mlp_apply if kind == "k4" else tfused.sp_geo_mlp_apply,
                           lead, *rest, ws, compute_dtype, sp_args, widths)
        finally:
            assert (tfused.geo_mlp_apply.launches, tfused.sp_geo_mlp_apply.launches) == before

    wide = torch.zeros((V, N, 3000))    # c0 = 3000: a 32-point tile needs 406,528 bytes
    ws_wide = list(tfused.fold_weight_norm(case["tm"]))
    ws_wide[0] = torch.zeros((DIMS1[0] + 3000, DIMS1[1]))
    for kind in ("k4", "k5"):
        for dt in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="tile does not fit in shared memory"):
                launch(kind, ws_wide, dt, f0=wide)
    ws_13 = _with_w0_rows(case, 27 * K)
    with pytest.raises(ValueError, match="0..12 encoding levels"):
        launch("k5", ws_13, sp_args=(13, 0.1, 1.0))

    # what only the wgmma kernel refuses goes to the wmma kernel: more views
    # than its pool keeps, weights over its shared memory, other layer
    # widths, other K5 keypoints, more than 256 layer-0 inputs
    def route(kind, ws=None, **over):
        x = dict(t, **over)
        ws = tfused.fold_weight_norm(case["tm"]) if ws is None else ws
        lead = (x["sp"],) if kind == "k4" else (x["pts_cam"], x["kpt_cam"])
        sp_args = None if kind == "k4" else (3, 0.1, 1.0)
        widths = tfused._check(lead, x["f0"], x["f1"], x["mask"], x["weight"], ws,
                               torch.bfloat16, sp_args)
        Vx, Kx = lead[0].shape[0], (lead[1].shape[1] if sp_args else 0)
        dsp = 7 * Kx if sp_args else lead[0].shape[-1]
        return tfused.kernel_route(Vx, Kx, dsp, widths, torch.bfloat16, sp_args)

    five = {k: torch.cat([v, v[:2]]) for k, v in t.items() if k != "kpt_cam"}
    five["kpt_cam"] = torch.cat([t["kpt_cam"], t["kpt_cam"][:2]])
    wide = torch.zeros((V, N, 400))     # c0 = 400: W0 needs 145 KB alone
    ws_wide = list(tfused.fold_weight_norm(case["tm"]))
    ws_wide[0] = torch.zeros((DIMS1[0] + 400, DIMS1[1]))
    for kind in ("k4", "k5"):
        assert route(kind) == "wgmma"
        assert route(kind, **five) == "wmma"
        assert route(kind, ws_wide, f0=wide) == "wmma"
    ws_narrow = list(tfused.fold_weight_norm(case["tm"]))
    ws_narrow[-2], ws_narrow[-1] = torch.zeros((64, 9)), torch.zeros(9)
    assert route("k5", ws_narrow) == "wmma"
    for k_other in (8, 16):
        assert route("k5", kpt_cam=torch.cat([t["kpt_cam"]] * 2, 1)[:, :k_other],
                     ws=_with_w0_rows(case, 7 * k_other)) == "wmma"
    assert route("k4", _with_w0_rows(case, 200), sp=torch.zeros((V, N, 200))) == "wmma"
    # the zju widths fit the wgmma kernel: 85,376 packed bf16 weights,
    # 173,928 bytes with K5
    shapes = tfused.packed_shapes((64, 8, *DIMS1[1:], *DIMS2[1:]), 168)
    assert sum(k * n for k, n in shapes) == 85_376
    assert tfused.smem_bytes(shapes, V, K, (3, 0.1, 1.0)) == 173_928 <= tfused.SMEM_BYTES


ZJU_WIDTHS = (64, 8, 128, 128, 120, 64, 64, 64, 2)      # c0, c1, h1, h2, h3, dl, g1, g2, dout
NARROW_WIDTHS = (64, 8, 96, 96, 80, 48, 48, 48, 2)


@pytest.mark.parametrize("kind", ["k4", "k5"])
@pytest.mark.parametrize("V_,K_,levels,widths,dtype,want", [
    (3, 24, 3, ZJU_WIDTHS, "bfloat16", "wgmma"),          # the zju render and step
    (2, 24, 3, ZJU_WIDTHS, "bfloat16", "wgmma"),
    (3, 24, 3, ZJU_WIDTHS, "float32", "f32"),
    (5, 16, 2, NARROW_WIDTHS, "bfloat16", "wmma"),        # non-zju widths, V = 5
    (3, 16, 2, NARROW_WIDTHS, "bfloat16", "wmma"),
    (5, 24, 3, ZJU_WIDTHS, "bfloat16", "wmma"),           # V = 5 at the zju widths
    (3, 24, 3, (64, 0, *ZJU_WIDTHS[2:]), "bfloat16", "wmma"),   # no f1 channels
    (3, 24, 3, (3000, 8, *ZJU_WIDTHS[2:]), "bfloat16", None),   # too wide for any tile
    (3, 24, 3, (1500, 8, *ZJU_WIDTHS[2:]), "float32", None),
    (64, 24, 3, ZJU_WIDTHS, "bfloat16", None),            # 64 views' latents
])
def test_kernel_route(kind, V_, K_, levels, widths, dtype, want):
    """`kernel_route` picks the kernel from the shapes alone, before any
    build or launch: wgmma for the zju widths in bf16, wmma for any other
    bf16 shape whose 32-point tile fits in shared memory, f32 for f32
    products; it refuses, with the size, only a tile that does not fit."""
    sp_args = (levels, 0.1, 1.0) if kind == "k5" else None
    K_ = K_ if kind == "k5" else 0
    dsp = (1 + 2 * levels) * 24 if kind == "k4" else (1 + 2 * levels) * K_
    args = (V_, K_, dsp, widths, getattr(torch, dtype), sp_args)
    if want is None:
        with pytest.raises(ValueError, match="tile does not fit in shared memory"):
            tfused.kernel_route(*args)
        return
    assert tfused.kernel_route(*args) == want
    # the route's scratch and shared memory are what the kernel lays out
    if want == "wmma":
        assert tfused.tile_smem_bytes(V_, K_, dsp, widths, sp_args, 2) <= tfused.SMEM_BYTES
    if want != "f32":
        shapes = tfused.packed_shapes(widths, dsp, want)
        assert all(k % 16 == 0 and n % (8 if want == "wgmma" else 16) == 0 for k, n in shapes)


def test_non_zju_width_render_with_flag():
    """A bf16 model at widths the wgmma kernel refuses (5 source views, 16
    keypoints, 2 encoding levels, layer widths 96, 96, 80, 48 | 48, 48)
    renders a toy camera with use_pallas_geo_mlp: its queries' shapes take
    the wmma route, and the flag-on render (on the CPU, the plain K5 behind
    the Function) equals the flag-off render (the modules) within
    tests/test_torch_render.py's bf16 bound, 1% of each output's scale
    (measured 0.47%, rgb_fine)."""
    import dataclasses

    from keypointnerf_torch import models as tm
    from keypointnerf_torch.data import SyntheticConfig, make_sample
    from keypointnerf_torch.render import render_image

    base = tm.KeypointNeRFConfig(n_coarse=4, n_fine=4, patch_h=4, patch_w=4,
                                 geo_n_downsample=2, n_kpt=16, sp_level=2,
                                 mlp_dims1=(80, 96, 96, 80, 48), mlp_dims2=(96, 48, 48, 2))
    cfg = tm.strict_preset(base, cull_budget=0.6)
    sample = make_sample(SyntheticConfig(image_size=32, n_views=6, n_kpt=16), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    outs = {}
    for flag in (False, True):
        model = tm.KeypointNeRF(dataclasses.replace(cfg, use_pallas_geo_mlp=flag),
                                device="cpu", seed=0)
        model.mlp_geo.layers2.layers[-1].linear.bias.data[1] += 2.0   # radiance > 0
        before = tfused.sp_geo_mlp_apply.launches
        outs[flag] = render_image(model, vb, height=32, width=32, chunk=256)
        assert tfused.sp_geo_mlp_apply.launches == before              # CPU: plain
    ws = tfused.fold_weight_norm(model.mlp_geo)
    outs_w = tuple(w.shape[1] for w in ws[0::2])
    widths = (ws[0].shape[0] - 80, ws[4].shape[0] - outs_w[1], *outs_w)
    assert widths[2:8] == (96, 96, 80, 48, 48, 48)
    sp_args = (cfg.sp_level, cfg.sp_sigma, cfg.sp_scale)
    assert tfused.kernel_route(5, 16, 80, widths, torch.bfloat16, sp_args) == "wmma"
    assert float(outs[True]["cull_overflow"].max()) == 0.0
    assert float(outs[False]["acc_fine"].max()) > 0.5
    for k in ("rgb_fine", "depth_fine", "acc_fine", "rgb_coarse", "acc_coarse"):
        a, b = outs[False][k].float(), outs[True][k].float()
        assert bool(torch.isfinite(b).all()), k
        assert float((a - b).abs().max() / a.abs().max()) <= 0.01, k
