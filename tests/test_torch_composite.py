"""Port parity for kernel K6, the fused coarse composite and inverse-CDF
importance placement: `ops/composite_importance.py` and the
`use_pallas_composite` route of `render_rays`, against the JAX package
with `composite_importance_pallas` in interpret mode.

Tolerances:
* K6's plain version against the Pallas kernel: color, acc and contrib
  within 1e-6, depth and sdf within 1e-5 (the JAX package holds its kernel
  against the XLA composite at 2e-5 / 2e-4, tests/test_pallas.py:348-357):
  the plain version's cumsum is sequential, the kernel's a triangular
  matmul. z_fine as the JAX package holds it, worst 5e-3 and mean 2e-5
  (JAX's mean bound is 2e-4): in a bin the coarse pass left empty the
  inverse CDF divides the cdf's rounding by ~1e-5, and a u on an edge may
  take the neighbouring bin.
* The toy render (f32, fused map + K3 + K6, no cull): coarse outputs within
  1e-4 of each output's scale; fine outputs by max 5e-3 and mean 2e-4, as
  tests/test_model.py:594-595 holds the JAX package's own K6 render.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.presets import strict_preset as jax_strict  # noqa: E402
from keypointnerf_tpu.ops.pallas.composite_kernel import composite_importance_pallas  # noqa: E402
from keypointnerf_tpu.render.renderer import render_image as jax_render  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.geometry import linspace01  # noqa: E402
from keypointnerf_torch.ops import composite_importance as k6  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
SIZE, CHUNK = 32, 256
FLAGS = dict(fused_feature_map=True, use_dma_gather=True, use_pallas_composite=True,
             cull_empty_rays_ratio=1.0)
NAMES = ("color", "depth", "acc", "sdf", "contrib", "z_fine")
ATOL = dict(color=1e-6, depth=1e-5, acc=1e-6, sdf=1e-5, contrib=1e-6, z_fine=5e-3)


def _inputs(R, S, F, seed):
    """Sorted depths in [2, 5], random densities with 4 all-zero and 4
    opaque rays, random sdf and colors, u = linspace(0, 1, F)."""
    rs = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    z = np.sort(rs.uniform(2.0, 5.0, (R, S)), axis=-1)
    alpha = np.maximum(rs.normal(size=(R, S)), 0.0) * 3.0
    alpha[:4] = 0.0
    alpha[4:8] = 1e3
    u = np.broadcast_to(linspace01(F).numpy(), (R, F))
    return [f32(x) for x in (z, alpha, rs.normal(size=(R, S)), rs.uniform(size=(R, S, 3)), u)]


@pytest.mark.parametrize("R,S,F", [(64, 16, 8), (64, 64, 64)])
def test_k6_plain_matches_pallas(R, S, F):
    ins = _inputs(R, S, F, seed=S)
    ref = [np.asarray(x) for x in composite_importance_pallas(*map(jnp.asarray, ins),
                                                              interpret=True)]
    fn = k6.fused_composite_importance
    before = fn.launches
    got = [x.numpy() for x in fn(*(torch.from_numpy(x.copy()) for x in ins))]
    assert fn.launches == before                      # CPU: the plain version
    for name, a, b in zip(NAMES, ref, got):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL[name], err_msg=name)
    assert float(np.abs(got[5] - ref[5]).mean()) < 2e-5
    # zero-alpha rays composite to exactly zero; opaque rays stop at their
    # first sample (exp(-80) after it, where a cumprod gives 0)
    assert not got[2][:4].any() and not got[0][:4].any()
    np.testing.assert_allclose(got[2][4:8], 1.0, rtol=0, atol=1e-6)


def test_k6_wrapper_checks():
    """The wrapper refuses what the kernel does not take."""
    z, alpha, sdf, rgb, u = (torch.from_numpy(x.copy()) for x in _inputs(8, 16, 4, seed=0))
    fn = k6.fused_composite_importance
    with pytest.raises(TypeError, match="alpha must be float32"):
        fn(z, alpha.double(), sdf, rgb, u)
    with pytest.raises(ValueError, match="rgb"):
        fn(z, alpha, sdf, rgb[..., :2], u)
    with pytest.raises(ValueError, match="its rays"):
        fn(z, alpha, sdf, rgb, u[:4])
    with pytest.raises(ValueError, match="at least 3 samples"):
        fn(z[:, :2], alpha[:, :2], sdf[:, :2], rgb[:, :2], u)


@pytest.fixture(scope="module")
def world():
    """The toy scene and seeded weights on both sides; the f32 fused-map +
    K3 + K6 render of each package, no cull (built once)."""
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    jc = dataclasses.replace(jax_strict(JaxConfig(**TINY)), compute_dtype=jnp.float32,
                             pallas_interpret=True, **FLAGS)
    tc = dataclasses.replace(tm.strict_preset(tm.KeypointNeRFConfig(**TINY)),
                             compute_dtype=torch.float32, **FLAGS)
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = convert_reference_state_dict(seeded.state_dict(), jc, strict=True)
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), tc))
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), params, jvb, height=SIZE,
                                               width=SIZE, chunk=CHUNK))
    tout = render_image(model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    return dict(jc=jc, tc=tc, params=params, model=model, jvb=jvb, tvb=tvb, jout=jout,
                tout=tout)


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


def test_k6_render_matches_jax(world):
    """Coarse outputs within 1e-4 of their scale; fine outputs by max and
    mean as the JAX package holds its own K6 render against its plain
    composite (tests/test_model.py:594-595)."""
    jout, tout = world["jout"], world["tout"]
    assert set(jout) == set(tout) and "cull_overflow" not in tout
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5    # not an empty image
    for k in ("rgb_coarse", "depth_coarse", "acc_coarse"):
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k
    for k in ("rgb_fine", "depth_fine", "acc_fine", "sdf_fine"):
        d = np.abs(np.asarray(jout[k], np.float64) - tout[k].numpy())
        scale = max(1.0, float(np.abs(jout[k]).max()))
        assert d.max() < 5e-3 * scale and d.mean() < 2e-4 * scale, (k, d.max(), d.mean())


def test_k6_route_against_plain_composite(world):
    """With the flag off the same model composites with `composite` and
    places the fine depths with `importance_z`: K6's route gives the coarse
    outputs to rounding and the fine ones within the same max / mean; at
    fine=False K6 is not taken (the outputs are the flag-off ones)."""
    tc, tvb = world["tc"], world["tvb"]
    off = tm.KeypointNeRF(dataclasses.replace(tc, use_pallas_composite=False), device="cpu")
    off.load_state_dict(world["model"].state_dict())
    ref = render_image(off, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    got = world["tout"]
    for k in ("rgb_coarse", "depth_coarse", "acc_coarse"):
        assert _max_rel(ref[k].numpy(), got[k].numpy()) <= 1e-5, k
    for k in ("rgb_fine", "depth_fine", "acc_fine", "sdf_fine"):
        d = (ref[k] - got[k]).abs()
        assert d.max() < 5e-3 and d.mean() < 2e-4, k
    coarse_only = render_image(world["model"], tvb, height=SIZE, width=SIZE, chunk=CHUNK,
                               fine=False)
    ref_coarse = render_image(off, tvb, height=SIZE, width=SIZE, chunk=CHUNK, fine=False)
    for k, v in ref_coarse.items():
        np.testing.assert_array_equal(coarse_only[k].numpy(), v.numpy(), err_msg=k)


def test_k6_with_cull_refused_in_both_packages(world):
    """K6 places a zero ray's fine depths its own way, which the cull's
    scores do not replicate: both renderers refuse the combination."""
    jc = dataclasses.replace(world["jc"], cull_empty_rays_ratio=0.6)
    tc = dataclasses.replace(world["tc"], cull_empty_rays_ratio=0.6)
    with pytest.raises(ValueError, match="cull_empty_rays_ratio"):
        jax_render(JaxModel(jc), world["params"], world["jvb"], height=8, width=8, chunk=32)
    model = tm.KeypointNeRF(tc, device="cpu")
    with pytest.raises(ValueError, match="cull_empty_rays_ratio"):
        render_image(model, world["tvb"], height=8, width=8, chunk=32)
    # without the fine pass K6 is not taken, so the cull is allowed
    out = render_image(model, world["tvb"], height=8, width=8, chunk=32, fine=False)
    assert float(out["cull_overflow"].max()) == 0.0


@pytest.mark.cuda
def test_k6_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, at the
    render's shape (one 2048-ray chunk, 64 + 64 samples) and a ragged R:
    the bounds of chip_smoke.py (the sums' order; z_fine within two of its
    ray's widest bins, mean 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = k6.fused_composite_importance
    for R in (2048, 1237):
        ins = [torch.from_numpy(x.copy()).cuda() for x in _inputs(R, 64, 64, seed=R)]
        before = fn.launches
        got = fn(*ins)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = k6.composite_importance_plain(*ins)
        for name, a, b in zip(NAMES[:5], ref, got):
            tol = 5e-6 if name in ("depth", "sdf") else 1e-6
            assert (a - b).abs().max().item() <= tol, name
        z_mid = 0.5 * (ins[0][:, 1:] + ins[0][:, :-1])
        widest = (z_mid[:, 1:] - z_mid[:, :-1]).amax(dim=-1, keepdim=True)
        dz = (ref[5] - got[5]).abs()
        assert (dz / widest).max().item() <= 2.0 and dz.mean().item() <= 2e-5
