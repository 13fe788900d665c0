"""Port parity: keypointnerf_torch leaf modules against the JAX package.

The Flax modules' parameter trees come from `jax.eval_shape` of their init
(no compile), filled from numpy seeds; the port's modules load them
through `utils/convert.py`'s per-module converters. Inputs are numpy
draws. Tolerances: f32 <= 2e-5 for the MLPs, the head and the spatial
encoding, 5e-5 for the CNN encoders (as tests/test_import_torch.py holds
the same architectures); the bf16 bounds are measured and pinned below
with their reason.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.models import cnn as jcnn  # noqa: E402
from keypointnerf_tpu.models import ibr_head as jibr  # noqa: E402
from keypointnerf_tpu.models import mlp as jmlp  # noqa: E402
from keypointnerf_tpu.models import spatial_encoding as jsp  # noqa: E402
from keypointnerf_torch.models import cnn as tcnn  # noqa: E402
from keypointnerf_torch.models import ibr_head as tibr  # noqa: E402
from keypointnerf_torch.models import mlp as tmlp  # noqa: E402
from keypointnerf_torch.models import spatial_encoding as tsp  # noqa: E402
from keypointnerf_torch.utils import convert  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _fill(shapes, seed):
    """Random values for a Flax parameter tree of ShapeDtypeStructs."""
    rs = np.random.default_rng(seed)

    def one(path, s):
        name = str(path[-1].key)
        if name in ("kernel",):
            fan_in = int(np.prod(s.shape[:-1]))
            return rs.normal(0, np.sqrt(2.0 / fan_in), s.shape).astype(np.float32)
        if name in ("scale", "gain"):
            return (1.0 + 0.1 * rs.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rs.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _flax_params(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return _fill(shapes, seed)


def _load(module, fill, params, *args):
    """Load `params` into a port module through a converter `fill(sd, key, p)`."""
    sd = {}
    fill(sd, "m", params["params"])
    module.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return module


# ------------------------------------------------------------ spatial encoding
@pytest.mark.parametrize("sp_type", ["z", "ixyz", "cxyz", "wxyz", "mxyz", "rel_z",
                                     "rel_z_decay", "rel_cxyz", "rel_wxyz", "rel_mxyz"])
def test_spatial_encoding(sp_type):
    rs = np.random.default_rng(0)
    V, N, K = 3, 40, 24
    arrs = dict(
        pts_world=rs.normal(size=(N, 3)), pts_cam=rs.normal(size=(V, N, 3)),
        kpt_world=rs.normal(size=(K, 3)) * 0.3, kpt_cam=rs.normal(size=(V, K, 3)),
        z_ndc=rs.uniform(-1, 1, (V, N, 1)), xy_ndc=rs.uniform(-1, 1, (V, N, 2)),
        model_T=np.concatenate([rs.normal(size=(3, 4)), [[0, 0, 0, 1]]]),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    jc = jsp.SpatialEncodingConfig(sp_type=sp_type, sigma=0.3, scale=0.7)
    tc = tsp.SpatialEncodingConfig(sp_type=sp_type, sigma=0.3, scale=0.7)
    assert tsp.spatial_encoding_dim(tc) == jsp.spatial_encoding_dim(jc)
    ref = jsp.spatial_encode(jc, **{k: jnp.asarray(v) for k, v in arrs.items()})
    got = tsp.spatial_encode(tc, **{k: _t(v) for k, v in arrs.items()})
    assert got.shape[-1] == tsp.spatial_encoding_dim(tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_softplus100_matches():
    x = np.linspace(-5, 5, 2001).astype(np.float32)
    np.testing.assert_allclose(tmlp.softplus100(_t(x)).numpy(),
                               np.asarray(jmlp.softplus100(jnp.asarray(x))),
                               atol=1e-7, rtol=1e-6)


# --------------------------------------------------------------------- MLPs
DIMS1, DIMS2 = (168, 128, 128, 120, 64), (128, 64, 64, 2)


def _mlp_case(dtype, seed=1):
    rs = np.random.default_rng(seed)
    V, N = 3, 64
    sp = rs.normal(size=(V, N, 168)).astype(np.float32)
    f0 = rs.normal(size=(V, N, 64)).astype(np.float32)
    f1 = rs.normal(size=(V, N, 8)).astype(np.float32)
    mask = (rs.uniform(size=(V, N, 1)) > 0.3).astype(np.float32)
    w = mask / (mask.sum(0, keepdims=True) + 1e-6)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jm = jmlp.GeoFusionMLP(DIMS1, DIMS2, (64, 8), (0, 2), dtype=jdt)
    args = [jnp.asarray(sp), [jnp.asarray(f0), jnp.asarray(f1)], jnp.asarray(mask), jnp.asarray(w)]
    params = _flax_params(jm, seed, *args)
    if jdt is not None:
        args = [args[0].astype(jdt), [a.astype(jdt) for a in args[1]],
                args[2].astype(jdt), args[3].astype(jdt)]
    ref = jm.apply(params, *args)
    tm = tmlp.GeoFusionMLP(DIMS1, DIMS2, (64, 8), (0, 2), dtype=getattr(torch, dtype))

    def fill(sd, key, p):
        convert._mlp_layers(sd, f"{key}.layers1", len(DIMS1) - 1, p["MLPUNet_0"])
        convert._mlp_layers(sd, f"{key}.layers2", len(DIMS2) - 1, p["MLP_0"])

    _load(tm, fill, params)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = tm(_t(sp).to(tdt), [_t(f0).to(tdt), _t(f1).to(tdt)], _t(mask).to(tdt),
                 _t(w).to(tdt))
    return ref, got


def test_geo_fusion_mlp_f32():
    ref, got = _mlp_case("float32")
    for name, a, b in zip(("out", "valid", "latent_view", "latent_fused"), ref, got):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=2e-5, rtol=2e-5, err_msg=name)


def test_geo_fusion_mlp_bf16_bound():
    """bf16: both programs round the layer inputs and weights to bf16 and
    keep each product's sum in f32 (mlp.dot_f32); the sums run in another
    order, so an activation now and then rounds to the neighbouring bf16
    value (2^-8 relative) at the next layer's input. Measured at most 0.79%
    of the output's scale over seeds 1-5 (1.8% before the sums were kept
    in f32), pinned at 1.6%."""
    ref, got = _mlp_case("bfloat16")
    out_j, out_t = np.asarray(ref[0], np.float32), got[0].float().numpy()
    scale = np.abs(out_j).max()
    assert np.abs(out_t - out_j).max() <= 0.016 * scale
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# --------------------------------------------------------------- IBR head
def _ibr_case(dtype, seed=2):
    rs = np.random.default_rng(seed)
    V, N = 3, 96
    rgbf = rs.uniform(size=(V, N, 35)).astype(np.float32)
    rdiff = (rs.normal(size=(V, N, 4)) * 0.3).astype(np.float32)
    pmask = (rs.uniform(size=(V, N, 1)) > 0.2).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jm = jibr.IBRRenderingHead(dtype=jdt)
    args = [jnp.asarray(a) for a in (rgbf, rdiff, pmask)]
    params = _flax_params(jm, seed, *args)
    if jdt is not None:
        args = [a.astype(jdt) for a in args]
    ref = np.asarray(jm.apply(params, *args), np.float32)
    tm = tibr.IBRRenderingHead(dtype=getattr(torch, dtype))

    def fill(sd, key, p):
        sd[f"{key}.ani_al"] = _t(p["ani_al"])
        for name, flax_name in convert._IBR_DENSE.items():
            convert._dense(sd, f"{key}.{name}", p[flax_name])

    _load(tm, fill, params)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = tm(*(_t(a).to(tdt) for a in (rgbf, rdiff, pmask))).float().numpy()
    return ref, got


def test_ibr_head_f32():
    ref, got = _ibr_case("float32")
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_ibr_head_bf16_bound():
    """bf16: the blend weights come out of a softmax over bf16 logits, so
    one bf16 rounding of a logit (2^-8 relative) moves a weight by up to
    that much; measured at most 0.0067 absolute on [0, 1] colors over
    seeds 1-5, pinned at 0.02. (A 0-dim f32 parameter times a bf16 tensor
    stays bf16 in torch; the head casts that product to f32 as JAX
    promotes it, without which this bound fails at 0.12.)"""
    ref, got = _ibr_case("bfloat16")
    assert np.abs(got - ref).max() <= 0.02


# ------------------------------------------------------------------- CNNs
def test_bicubic_upsample_matches():
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 4)).astype(np.float32)
    ref = jcnn.upsample2x_bicubic_align_corners(jnp.asarray(x))
    got = tcnn.upsample2x_bicubic_align_corners(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_bicubic_upsample_grad_matches():
    """The upsample's input gradient (two products, no atomics) against
    jax.vjp of JAX's function, at the same 1e-5."""
    rs = np.random.default_rng(4)
    x = rs.normal(size=(2, 5, 7, 4)).astype(np.float32)
    g = rs.normal(size=(2, 10, 14, 4)).astype(np.float32)
    _, vjp = jax.vjp(jcnn.upsample2x_bicubic_align_corners, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    tcnn.upsample2x_bicubic_align_corners(xt).backward(_t(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_stack,n_down", [(1, 2), (2, 1)])
def test_hgfilter_matches(n_stack, n_down):
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jcnn.HGFilter(n_stack=n_stack, n_downsample=n_down)
    params = _flax_params(jm, 5, jnp.asarray(x))
    coarse_j, hd_j = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = tcnn.HGFilter(n_stack=n_stack, n_downsample=n_down)
    _load(tm, lambda sd, k, p: convert._hgfilter(sd, k, n_stack, n_down, p), params)
    with torch.no_grad():
        coarse_t, hd_t = tm(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(coarse_t.permute(0, 2, 3, 1).numpy(), np.asarray(coarse_j),
                               atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(hd_t.permute(0, 2, 3, 1).numpy(), np.asarray(hd_j),
                               atol=5e-5, rtol=5e-5)


def test_resblk_encoder_matches():
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jcnn.ResBlkEncoder(out_ch=8, ngf=16, n_downsample=3, n_blocks=2, n_upsample=2)
    params = _flax_params(jm, 7, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = tcnn.ResBlkEncoder(out_ch=8, ngf=16, n_downsample=3, n_blocks=2, n_upsample=2)
    _load(tm, lambda sd, k, p: convert._resblk_encoder(sd, k, 3, 2, 2, p), params)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=5e-5, rtol=5e-5)
