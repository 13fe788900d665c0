"""Port parity for the training slice's ops: K1's plain version, the
matmul-VJP lookup's autograd Function, and the gradients of the modules
the training step differentiates, against the JAX package.

Inputs are numpy draws. K1's plain version is held against the Pallas
kernel called directly in interpret mode at C >= 32 (the width at which
the JAX training step reaches it), f32 at atol 2e-5 / rtol 1e-5 (as
tests/test_pallas.py holds the kernel against the XLA VJP); the bf16 map
dtype rounds the same terms, so it is held at rtol 1e-5 on the f32 result.
Module gradients are f32 against `jax.grad` at 2e-5 of each leaf's scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.ops.feat_sample import (  # noqa: E402
    bilinear_sample_mm,
    bilinear_sample_mm_partial,
)
from keypointnerf_tpu.ops.pallas.onehot_dmap import bilinear_dmap_onehot  # noqa: E402
from keypointnerf_torch.utils import convert  # noqa: E402
from keypointnerf_torch.ops import (  # noqa: E402
    multiview_bilinear_sample_mm,
    multiview_dmap_onehot,
    onehot_dmap_plain,
)

F32_TOL = dict(atol=2e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _dmap_case(H, W, C, N=700, seed=0):
    rs = np.random.default_rng(seed)
    xy = rs.uniform(-1.2, 1.2, (N, 2)).astype(np.float32)
    g = rs.normal(size=(N, C)).astype(np.float32)
    return xy, g


# --------------------------------------------------------------------- K1
@pytest.mark.parametrize("hwc", [(16, 16, 64), (33, 17, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dmap_plain_matches_pallas(hwc, dtype):
    """K1's plain version against `bilinear_dmap_onehot(interpret=True)`
    called directly, at the widths that reach the kernel in training."""
    H, W, C = hwc
    xy, g = _dmap_case(H, W, C)
    ref = np.asarray(bilinear_dmap_onehot(jnp.asarray(xy), jnp.asarray(g), H, W,
                                          map_dtype=getattr(jnp, dtype), interpret=True))
    got = onehot_dmap_plain(_t(xy)[None], _t(g)[None], H, W, getattr(torch, dtype))[0]
    assert got.dtype == torch.float32 and got.shape == (H, W, C)
    tol = F32_TOL if dtype == "float32" else dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, **tol)
    # the CPU wrapper runs the plain version and launches nothing
    before = multiview_dmap_onehot.launches
    wrapped = multiview_dmap_onehot(_t(xy)[None], _t(g)[None], H, W, getattr(torch, dtype))
    assert torch.equal(wrapped, got[None]) and multiview_dmap_onehot.launches == before


def test_dmap_wrapper_checks_inputs():
    xy, g = _t(np.zeros((1, 5, 2))), _t(np.zeros((1, 5, 8)))
    with pytest.raises(ValueError, match="expected points"):
        multiview_dmap_onehot(xy[0], g, 4, 4)
    with pytest.raises(ValueError, match="at least 2x2"):
        multiview_dmap_onehot(xy, g, 1, 4)
    with pytest.raises(TypeError, match="float32"):
        multiview_dmap_onehot(xy, g.double(), 4, 4)
    with pytest.raises(TypeError, match="map dtype"):
        multiview_dmap_onehot(xy, g, 4, 4, torch.float16)


def _clustered_case(H, W, C, N, seed):
    """A training patch's kind of points: most in three tight clusters
    (hundreds a map cell), a tenth far outside the map (clamped to its
    border) and some exactly on it."""
    rs = np.random.default_rng(seed)
    xy = rs.uniform(-0.9, 0.9, (3, 2))[rs.integers(0, 3, N)]
    xy = xy + rs.normal(scale=0.01, size=(N, 2))
    out = rs.random(N) < 0.1
    xy[out] = rs.choice([-1.0, 1.0], size=(int(out.sum()), 2)) * rs.uniform(1.0, 2.0, (int(out.sum()), 2))
    xy[rs.random(N) < 0.02, 1] = 1.0
    return xy.astype(np.float32), rs.normal(size=(N, C)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dmap_plain_matches_pallas_clustered(dtype):
    """K1's plain version against `bilinear_dmap_onehot(interpret=True)` at
    clustered points with border clamps (the sums of a hot cell run long)."""
    H, W, C = 16, 16, 64
    xy, g = _clustered_case(H, W, C, 2000, seed=11)
    ref = np.asarray(bilinear_dmap_onehot(jnp.asarray(xy), jnp.asarray(g), H, W,
                                          map_dtype=getattr(jnp, dtype), interpret=True))
    got = onehot_dmap_plain(_t(xy)[None], _t(g)[None], H, W, getattr(torch, dtype))[0]
    tol = F32_TOL if dtype == "float32" else dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


def test_dmap_plain_takes_bf16_cotangent_exactly():
    """A bf16 cotangent gives the same map gradient, bit for bit, as the
    same cotangent widened to f32 (the widening is exact), for both map
    dtypes; the CPU wrapper takes it too."""
    xy, g = _clustered_case(16, 16, 64, 2000, seed=12)
    xy, gb = _t(xy)[None], _t(g)[None].bfloat16()
    for dt in (torch.float32, torch.bfloat16):
        wide = onehot_dmap_plain(xy, gb.float(), 16, 16, dt)
        assert torch.equal(onehot_dmap_plain(xy, gb, 16, 16, dt), wide)
        assert torch.equal(multiview_dmap_onehot(xy, gb, 16, 16, dt), wide)


def test_bilinear_sample_mm_bf16_cotangent():
    """The Function on a bf16 64-channel map (the route to K1) with the bf16
    cotangent a bf16 lookup hands back, against `bilinear_sample_mm_partial`
    with the Pallas kernel in interpret mode: dmap (bf16) within one bf16
    ulp or the f32 sum-order bound; dxy within 2e-5
    of its scale (a 64-channel dot in another order); and the map gradient
    equals the plain version's on the widened cotangent."""
    rs = np.random.default_rng(6)
    V, H, W, C, N = 2, 16, 12, 64, 600
    feats = jnp.asarray(rs.normal(size=(V, H, W, C)).astype(np.float32)).astype(jnp.bfloat16)
    xy = rs.uniform(-1.2, 1.2, (V, N, 2)).astype(np.float32)
    g = jnp.asarray(rs.normal(size=(V, N, C)).astype(np.float32)).astype(jnp.bfloat16)

    def one(f, x, gg):
        out = bilinear_sample_mm_partial(f, x, None, "interpret")
        return jnp.sum(out.astype(jnp.float32) * gg.astype(jnp.float32))

    grad = jax.grad(one, argnums=(0, 1))
    refs = [grad(feats[v], jnp.asarray(xy[v]), g[v]) for v in range(V)]
    ft = _t(feats.astype(jnp.float32)).bfloat16().requires_grad_(True)
    xt = _t(xy).requires_grad_(True)
    gt = _t(g.astype(jnp.float32)).bfloat16()
    out = multiview_bilinear_sample_mm(ft, xt, None)
    out.backward(gt)
    assert ft.grad.dtype == torch.bfloat16
    wide = onehot_dmap_plain(xt.detach(), gt.float(), H, W, torch.bfloat16).bfloat16()
    assert torch.equal(ft.grad, wide)
    for v in range(V):
        # dxy: a 64-channel dot summed in another order, 2e-5 of its scale
        assert _rel_err(xt.grad[v].numpy(), refs[v][1]) <= 2e-5
        a = ft.grad[v].float().numpy()
        b = np.asarray(refs[v][0].astype(jnp.float32))
        ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), np.abs(b)))[1] - 8)
        assert (np.abs(a - b) <= ulp + 1e-5 * np.abs(b).max()).all()


# ------------------------------------------------------ the autograd Function
@pytest.mark.parametrize("grad_channels", [None, 8])
@pytest.mark.parametrize("pallas_dmap", [False, True])
def test_bilinear_sample_mm_grads(grad_channels, pallas_dmap):
    """The port's matmul-VJP Function against `bilinear_sample_mm` /
    `bilinear_sample_mm_partial` (dmap and dxy) on a 12-channel map, with
    the JAX package's map gradient by its Pallas kernel or its XLA scan
    (`pallas_dmap`): the port computes it one way, K1's wrapper."""
    rs = np.random.default_rng(5)
    V, H, W, C, N = 2, 16, 12, 12, 600
    feats = rs.normal(size=(V, H, W, C)).astype(np.float32)
    xy = rs.uniform(-1.2, 1.2, (V, N, 2)).astype(np.float32)
    g = rs.normal(size=(V, N, C)).astype(np.float32)
    pd = "interpret" if pallas_dmap else False

    def one(f, x, gg):
        if grad_channels is None and not pallas_dmap:
            return jnp.sum(bilinear_sample_mm(f, x) * gg)
        return jnp.sum(bilinear_sample_mm_partial(f, x, grad_channels, pd) * gg)

    grad = jax.grad(one, argnums=(0, 1))
    refs = [grad(jnp.asarray(feats[v]), jnp.asarray(xy[v]), jnp.asarray(g[v])) for v in range(V)]
    ft, xt = _t(feats).requires_grad_(True), _t(xy).requires_grad_(True)
    out = multiview_bilinear_sample_mm(ft, xt, grad_channels)
    (out * _t(g)).sum().backward()
    for v in range(V):
        np.testing.assert_allclose(ft.grad[v].numpy(), np.asarray(refs[v][0]), **F32_TOL)
        np.testing.assert_allclose(xt.grad[v].numpy(), np.asarray(refs[v][1]), **F32_TOL)
    if grad_channels is not None:
        assert not ft.grad[..., grad_channels:].any()


# ------------------------------------------------------ module gradients
def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def test_softplus100_grad_matches():
    """Including y == 0, where jnp.maximum splits the gradient 0.5 / 0.5
    and jnp.abs passes +1."""
    from keypointnerf_tpu.models import mlp as jmlp
    from keypointnerf_torch.models import mlp as tmlp

    x = np.concatenate([np.linspace(-0.2, 0.2, 401), [0.0, 0.0]]).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jmlp.softplus100(v)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tmlp.softplus100(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-7, rtol=1e-6)
    assert xt.grad[-1].item() == 0.0        # JAX: 0.5 from the max, -0.5 from |y|


@pytest.mark.parametrize("use_wn", [True, False])
def test_wn_linear_grads(use_wn):
    """WNDense over a split input (the skip concat folded into the
    product) against LinearSlot: input, kernel/weight_v, gain/weight_g and
    bias gradients, f32."""
    from keypointnerf_tpu.models import mlp as jmlp
    from keypointnerf_torch.models import mlp as tmlp

    rs = np.random.default_rng(8)
    a, b = rs.normal(size=(40, 12)).astype(np.float32), rs.normal(size=(40, 5)).astype(np.float32)
    g = rs.normal(size=(40, 7)).astype(np.float32)
    params = {"kernel": rs.normal(size=(17, 7)).astype(np.float32) * 0.3,
              "bias": rs.normal(size=(7,)).astype(np.float32)}
    if use_wn:
        params["gain"] = (1 + 0.1 * rs.normal(size=(7,))).astype(np.float32)
    jm = jmlp.WNDense(7, use_wn=use_wn)
    f = lambda p, x, y: jnp.sum(jm.apply({"params": p}, (x, y)) * g)  # noqa: E731
    ref = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(a), jnp.asarray(b))
    slot = tmlp.LinearSlot(17, 7, use_wn)
    sd = {}
    (convert._wn_dense if use_wn else convert._dense)(sd, "linear", params)
    slot.load_state_dict(sd)
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (slot((at, bt)) * _t(g)).sum().backward()
    lin = slot.linear
    got = {"kernel": (lin.weight_v if use_wn else lin.weight).grad.T, "bias": lin.bias.grad}
    if use_wn:
        got["gain"] = lin.weight_g.grad[:, 0]
    for k in params:
        assert _rel_err(got[k], ref[0][k]) <= 2e-5, k
    assert _rel_err(at.grad, ref[1]) <= 2e-5 and _rel_err(bt.grad, ref[2]) <= 2e-5


def test_group_norm_grads():
    """Flax GroupNorm (one-pass variance) against the port's, input /
    scale / bias gradients; one constant group puts var at exactly 0."""
    import flax.linen as fnn
    from keypointnerf_torch.models import cnn as tcnn

    rs = np.random.default_rng(9)
    x = rs.normal(size=(2, 6, 5, 64)).astype(np.float32)
    x[0, ..., :2] = 0.5                                   # a constant group
    g = rs.normal(size=x.shape).astype(np.float32)
    scale = (1 + 0.1 * rs.normal(size=(64,))).astype(np.float32)
    bias = (0.1 * rs.normal(size=(64,))).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=32, epsilon=1e-5)
    f = lambda p, v: jnp.sum(jm.apply({"params": p}, v) * g)  # noqa: E731
    ref = jax.grad(f, argnums=(0, 1))({"scale": scale, "bias": bias}, jnp.asarray(x))
    gn = tcnn.group_norm(64)
    gn.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    (gn(xt) * _t(g).permute(0, 3, 1, 2)).sum().backward()
    assert _rel_err(xt.grad.permute(0, 2, 3, 1), ref[1]) <= 2e-5
    assert _rel_err(gn.weight.grad, ref[0]["scale"]) <= 2e-5
    assert _rel_err(gn.bias.grad, ref[0]["bias"]) <= 2e-5


def test_ibr_head_grads():
    """The IBR head's parameter and input gradients against jax.grad, f32."""
    from keypointnerf_tpu.models import ibr_head as jibr
    from keypointnerf_torch.models import ibr_head as tibr

    rs = np.random.default_rng(10)
    V, N = 3, 64
    rgbf = rs.uniform(size=(V, N, 35)).astype(np.float32)
    rdiff = (rs.normal(size=(V, N, 4)) * 0.3).astype(np.float32)
    pmask = (rs.uniform(size=(V, N, 1)) > 0.2).astype(np.float32)
    g = rs.normal(size=(N, 3)).astype(np.float32)
    jm = jibr.IBRRenderingHead()
    args = [jnp.asarray(a) for a in (rgbf, rdiff, pmask)]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))

    def fill(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return rs.normal(0, np.sqrt(2.0 / s.shape[0]), s.shape).astype(np.float32)
        return (0.1 * rs.normal(size=s.shape) + (0.2 if name == "ani_al" else 0.0)).astype(
            np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    ref_p, ref_x = jax.grad(lambda p, x: jnp.sum(jm.apply(p, x, args[1], args[2]) * g),
                            argnums=(0, 1))(params, args[0])
    tmod = tibr.IBRRenderingHead()
    sd = {"ani_al": _t(params["params"]["ani_al"])}
    for name, flax_name in convert._IBR_DENSE.items():
        convert._dense(sd, name, params["params"][flax_name])
    tmod.load_state_dict(sd)
    xt = _t(rgbf).requires_grad_(True)
    (tmod(xt, _t(rdiff), _t(pmask)) * _t(g)).sum().backward()
    assert _rel_err(xt.grad, ref_x) <= 2e-5
    # ani_al's gradient is one sum over every (view, point) of terms that
    # largely cancel: in f64 the port's f32 value is 0.7e-4 and JAX's
    # 2.3e-4 off the exact sum (1.6e-4 apart); held at 5e-4
    assert _rel_err(tmod.ani_al.grad, ref_p["params"]["ani_al"]) <= 5e-4
    top = max(float(np.abs(v).max()) for v in jax.tree.leaves(ref_p))
    for name, flax_name in convert._IBR_DENSE.items():
        layer = tmod.get_submodule(name)
        ref = ref_p["params"][flax_name]
        assert _rel_err(layer.weight.grad.T, ref["kernel"]) <= 2e-5, name
        if name == "out_layer.4":
            # the logit bias shifts every view's logit alike: the softmax
            # over views makes its gradient exactly 0, rounding noise here
            assert max(abs(layer.bias.grad.item()), abs(float(ref["bias"][0]))) <= 1e-5 * top
        else:
            assert _rel_err(layer.bias.grad, ref["bias"]) <= 2e-5, name


def test_spatial_encoding_grads():
    """rel_z_decay (the zju encoding): gradients with respect to the
    camera-frame points and keypoints, f32."""
    from keypointnerf_tpu.models import spatial_encoding as jsp
    from keypointnerf_torch.models import spatial_encoding as tsp

    rs = np.random.default_rng(12)
    V, N, K = 3, 30, 24
    pts_w = rs.normal(size=(N, 3)).astype(np.float32)
    pts_c = (rs.normal(size=(V, N, 3)) * 0.2).astype(np.float32)
    kpt_w = rs.normal(size=(K, 3)).astype(np.float32)
    kpt_c = (rs.normal(size=(V, K, 3)) * 0.2).astype(np.float32)
    jc, tc = jsp.SpatialEncodingConfig(), tsp.SpatialEncodingConfig()
    g = rs.normal(size=(V, N, tsp.spatial_encoding_dim(tc))).astype(np.float32)
    f = lambda pc, kc: jnp.sum(jsp.spatial_encode(jc, jnp.asarray(pts_w), pc, jnp.asarray(kpt_w),  # noqa: E731
                                                  kc) * g)
    ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts_c), jnp.asarray(kpt_c))
    pc, kc = _t(pts_c).requires_grad_(True), _t(kpt_c).requires_grad_(True)
    (tsp.spatial_encode(tc, _t(pts_w), pc, _t(kpt_w), kc) * _t(g)).sum().backward()
    assert _rel_err(pc.grad, ref[0]) <= 2e-5 and _rel_err(kc.grad, ref[1]) <= 2e-5


# ------------------------------------------------------------------- VGG
VGG_SLICES = ((4,), (4, 8), (8, 16), (16, 16, 16, 32))


def _vgg_pair():
    from keypointnerf_tpu.models.vgg import init_vgg_params
    from keypointnerf_torch.models import VGG19Features
    from keypointnerf_torch.utils import vgg_params_from_jax

    params = init_vgg_params(jax.random.key(3), VGG_SLICES)
    vgg = VGG19Features(VGG_SLICES, device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    return params, vgg


def test_vgg_loss_matches():
    """vgg_loss and its gradient with respect to the prediction, f32 within
    1e-5 relative; the frozen features carry no gradient."""
    from keypointnerf_tpu.models.vgg import vgg_loss as jvgg_loss
    from keypointnerf_torch.models import vgg_loss

    params, vgg = _vgg_pair()
    rs = np.random.default_rng(13)
    pred = rs.uniform(size=(16, 16, 3)).astype(np.float32)
    tar = rs.uniform(size=(16, 16, 3)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda p: jvgg_loss(params, p, jnp.asarray(tar)))(
        jnp.asarray(pred))
    pt = _t(pred).requires_grad_(True)
    loss = vgg_loss(vgg, pt, _t(tar))
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert _rel_err(pt.grad, ref_g) <= 1e-5
    assert all(not p.requires_grad for p in vgg.parameters())
    assert len(vgg(pt[None])) == 4


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("kind,top", [("l1", None), ("l2", None), ("lp", None),
                                      ("l1", 25.0), ("l2", 10.0)])
def test_pix_loss_matches(kind, top):
    from keypointnerf_tpu.training.losses import pix_loss as jpix
    from keypointnerf_torch.training import pix_loss

    rs = np.random.default_rng(14)
    a, b = rs.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(lambda x: jpix(x, jnp.asarray(b), kind, top))(jnp.asarray(a))
    at = _t(a).requires_grad_(True)
    got = pix_loss(at, _t(b), kind, top)
    got.backward()
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))
    assert _rel_err(at.grad, ref_g) <= 1e-6


def test_compute_losses_all_terms():
    """Every term of compute_losses (coarse and fine L1, L2, Lp, a top-k
    term, VGG, both mask terms with an opaque acc of exactly 1.0) and the
    gradients of e_all against JAX."""
    from keypointnerf_tpu.training.losses import LossConfig as JLossConfig
    from keypointnerf_tpu.training.losses import compute_losses as jcompute
    from keypointnerf_torch.training import LossConfig, compute_losses

    params, vgg = _vgg_pair()
    rs = np.random.default_rng(15)
    P = 16
    out = {"rgb_coarse": rs.uniform(size=(P, P, 3)), "rgb_fine": rs.uniform(size=(P, P, 3)),
           "acc_coarse": rs.uniform(size=(P, P)), "acc_fine": rs.uniform(size=(P, P)),
           "target_rgb": rs.uniform(size=(P, P, 3)),
           "target_alpha": (rs.uniform(size=(P, P, 1)) > 0.5)}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    out["acc_fine"][0, :4] = 1.0
    kw = dict(lambda_l2=0.3, lambda_lp=0.2, lambda_mloss=0.7, top_losses=(("l1", 25.0, 2.0),))
    grads_of = ("rgb_coarse", "rgb_fine", "acc_coarse", "acc_fine")

    def jf(x):
        return jcompute(dict(out, **x), JLossConfig(**kw), params)

    (jtotal, jerr), jgrad = jax.value_and_grad(jf, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in grads_of})
    tin = {k: _t(v).requires_grad_(k in grads_of) for k, v in out.items()}
    total, err = compute_losses(tin, LossConfig(**kw), vgg)
    total.backward()
    assert set(err) == set(jerr) == {"e_pix_c", "e_pix_l1", "e_pix_l2", "e_pix_lp",
                                     "e_pix_l1top25", "e_vgg", "mask_loss_c",
                                     "mask_loss_f", "e_all"}
    for k in err:
        assert abs(err[k].item() - float(jerr[k])) <= 1e-5 * abs(float(jerr[k])), k
    for k in grads_of:
        assert _rel_err(tin[k].grad, jgrad[k]) <= 1e-5, k


# -------------------------------------------------------------- optimizer
def _tree(rs, scale=1.0):
    return {"a": (scale * rs.normal(size=(5, 7))).astype(np.float32),
            "b": (scale * rs.normal(size=(11,))).astype(np.float32)}


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 10),
                                             ("cosine", 0), ("cosine", 10),
                                             ("exponential", 10)])
def test_make_lr_matches_optax(schedule, warmup):
    from keypointnerf_tpu.training.train import OptimConfig as JOptim
    from keypointnerf_tpu.training.train import make_lr as jmake_lr
    from keypointnerf_torch.training import OptimConfig, make_lr

    kw = dict(lr_schedule=schedule, warmup_steps=warmup, decay_steps=100)
    ref, got = jmake_lr(JOptim(**kw)), make_lr(OptimConfig(**kw))
    for step in (0, 1, warmup, warmup + 50, warmup + 110):
        want = float(ref(step)) if callable(ref) else float(ref)
        assert got(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step
    if warmup:
        assert got(0) == 0.0


def test_clip_by_global_norm_matches_optax():
    from keypointnerf_torch.training import clip_by_global_norm, global_norm

    rs = np.random.default_rng(16)
    tree = _tree(rs)
    norm = float(optax.global_norm(tree))
    assert global_norm([_t(v) for v in tree.values()]).item() == pytest.approx(norm, rel=1e-6)
    for max_norm in (0.5 * norm, 2.0 * norm):
        ref, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
        got = clip_by_global_norm([_t(v) for v in tree.values()], max_norm)
        for g, k in zip(got, tree):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("weight_decay,clip,accumulate",
                         [(0.0, None, 1), (0.01, None, 1), (0.0, 1.0, 2)])
def test_optimizer_steps_match_optax(weight_decay, clip, accumulate):
    """Adam, AdamW (clipped and accumulated over 2 mini-steps in the last
    case) against the JAX package's `make_optimizer`, within 1e-6 of each
    parameter's scale over two updates (elements with |g| near eps would
    differ more; these draws have none)."""
    from keypointnerf_tpu.training.train import OptimConfig as JOptim
    from keypointnerf_tpu.training.train import make_optimizer as jmake
    from keypointnerf_torch.training import OptimConfig
    from keypointnerf_torch.training.train import (
        TrainState, apply_gradients, make_lr, make_optimizer)

    kw = dict(weight_decay=weight_decay, grad_clip=clip, accumulate_steps=accumulate,
              warmup_steps=1, learning_rate=1e-2)
    rs = np.random.default_rng(17)
    params = _tree(rs)
    grads = [_tree(rs, 0.5) for _ in range(2 * accumulate)]
    tx = jmake(JOptim(**kw))
    jp, st = jax.tree.map(jnp.asarray, params), tx.init(params)
    for g in grads:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(_t(v)) for v in params.values()]
    cfg = OptimConfig(**kw)
    state = TrainState(model=None, optimizer=make_optimizer(cfg, tp), optim_cfg=cfg,
                       lr_fn=make_lr(cfg))
    for g in grads:
        apply_gradients(state, tp, [_t(v) for v in g.values()])
    assert state.updates == 2
    for p, k in zip(tp, params):
        ref = np.asarray(jp[k])
        assert np.abs(p.detach().numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), k
