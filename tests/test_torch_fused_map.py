"""Port parity for the fused feature map and kernel K3 (the patch-gather
lookup): `ops/dma_gather.py`, the fused `encode`, the `"fused"` query
branch and the empty-ray cull on the fused map's mask channel, against the
JAX package with its Pallas kernels in interpret mode.

Tolerances:
* K3's plain version against `dma_bilinear_sample(interpret=True)`: bf16
  bit for bit (every difference, product and sum rounded to bf16, as JAX's
  CPU program rounds them); f32 within 2^-22 of the map's largest entry
  (JAX's CPU program fuses each `a + w * d` into one FMA, which the plain
  version reproduces through f64: bit-equal here, one rounding apart
  where the f64 sum's own rounding lands on an f32 tie).
* The fused map, given the same CNN maps (the port's encoders are held
  against JAX's in tests/test_torch_modules.py): bf16 bit for bit, f32
  within 1e-6 of its largest entry.
* The toy render (f32, fused map + K3 + cull): within 1e-4 of each output's
  scale, as the strict render in tests/test_torch_render.py; the cull
  bit-exact.
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
from keypointnerf_tpu.ops.pallas.dma_gather import dma_bilinear_sample  # noqa: E402
from keypointnerf_tpu.render.empty_cull import empty_ray_scores as jax_scores  # noqa: E402
from keypointnerf_tpu.render.renderer import render_image as jax_render  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.geometry import camera_rays, pixel_grid  # noqa: E402
from keypointnerf_torch.ops import dma_gather  # noqa: E402
from keypointnerf_torch.ops import multiview_bilinear_sample  # noqa: E402
from keypointnerf_torch.ops import multiview_onehot_bilinear_sample  # noqa: E402
from keypointnerf_torch.render import (  # noqa: E402
    EMPTY_SCORE_THRESHOLD, empty_ray_scores, render_image, suggest_cull_budget)
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
SIZE, CHUNK, BUDGET = 32, 256, 0.6
FUSED = dict(fused_feature_map=True, use_dma_gather=True)
KEYS = ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine", "acc_fine",
        "sdf_fine")


def _sample():
    # numpy-seeded texture (see tests/test_torch_render.py: the fg-masked
    # synthetic images make the encoders' one-pass variance cancel)
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def _configs(dtype="float32", **flags):
    jc = dataclasses.replace(jax_strict(JaxConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=getattr(jnp, dtype), pallas_interpret=True, **flags)
    tc = dataclasses.replace(tm.strict_preset(tm.KeypointNeRFConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=getattr(torch, dtype), **flags)
    return jc, tc


def _jax_encode(jc, params, jvb):
    return jax.jit(lambda p, i, m: JaxModel(jc).apply(p, i, m, False, method=JaxModel.encode))(
        params, jvb.src_images, jvb.src_masks)


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


@pytest.fixture(scope="module")
def world():
    """The toy scene, seeded weights on both sides, and the f32 fused-map +
    K3 + cull render of each package (built once: the JAX render runs K3
    in interpret mode)."""
    jc, tc = _configs(**FUSED)
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = convert_reference_state_dict(seeded.state_dict(), jc, strict=True)
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), tc))
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), params, jvb, height=SIZE,
                                               width=SIZE, chunk=CHUNK))
    before = (dma_gather.multiview_bilinear_sample_dma.launches,
              multiview_onehot_bilinear_sample.launches)
    tout = render_image(model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    launched = (dma_gather.multiview_bilinear_sample_dma.launches,
                multiview_onehot_bilinear_sample.launches) != before
    return dict(jc=jc, tc=tc, params=params, model=model, jvb=jvb, tvb=tvb, jout=jout,
                tout=tout, launched=launched)


def _k3_inputs(shape, n, seed):
    rs = np.random.default_rng(seed)
    maps = rs.normal(size=shape).astype(np.float32)
    xy = rs.uniform(-1.3, 1.3, (shape[0], n, 2)).astype(np.float32)  # incl. outside
    xy[:, :4] = np.array([[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [0.0, 0.0]], np.float32)
    return maps, xy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [84, 37])
def test_k3_plain_matches_pallas(dtype, channels):
    """K3's plain version against the Pallas kernel in interpret mode (one
    call per view, as `multiview_bilinear_sample_dma` makes them), at the
    fused map's 84 channels and an odd count, with points outside [-1, 1]
    and on the border; N = 700 is not a multiple of the TPU tile."""
    maps, xy = _k3_inputs((2, 17, 23, channels), 700, seed=channels)
    jmaps = jnp.asarray(maps).astype(getattr(jnp, dtype))
    ref = np.stack([np.asarray(dma_bilinear_sample(jmaps[v], jnp.asarray(xy[v]), interpret=True)
                               .astype(jnp.float32)) for v in range(2)])
    tmaps = torch.from_numpy(np.asarray(jmaps.astype(jnp.float32))).to(getattr(torch, dtype))
    fn = dma_gather.multiview_bilinear_sample_dma
    before = fn.launches
    got = fn(tmaps, torch.from_numpy(xy))
    assert fn.launches == before                       # CPU: the plain version
    assert got.dtype == tmaps.dtype and got.shape == (2, 700, channels)
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -22 * np.abs(maps).max())
    # the three lerps are not the plain lookup's four-term weighted sum:
    # the two round differently, in f32 too
    alt = multiview_bilinear_sample(tmaps, torch.from_numpy(xy)).float().numpy()
    assert not np.array_equal(got, alt)
    np.testing.assert_allclose(got, alt, rtol=0, atol=0.02 * np.abs(maps).max())


def test_k3_wrapper_checks():
    """The wrapper refuses what the kernel does not take."""
    fn = dma_gather.multiview_bilinear_sample_dma
    m = torch.zeros((2, 4, 4, 3))
    p = torch.zeros((2, 5, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(m.double(), p)
    with pytest.raises(TypeError, match="points must be float32"):
        fn(m, p.double())
    with pytest.raises(ValueError, match="2 maps but 1"):
        fn(m, p[:1])
    with pytest.raises(ValueError, match="at least 2x2"):
        fn(m[:, :1], p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half", [False, True])
def test_fused_encode_matches_jax(world, monkeypatch, dtype, half):
    """The fused map, full grid and half grid (`fused_map_half` with
    `fused_map_half_min_side=0`): both encoders return the same seeded
    maps (the CNNs are held against each other in
    tests/test_torch_modules.py), and JAX's `encode` runs op by op, each
    function as the package writes it (under jit XLA reassociates the
    lookup's blend). bf16 bit for bit; f32 within 1e-6 of the map's
    largest entry (the lookup's f32 sum rounds once in the port, XLA's
    CPU program fuses its products: one ulp apart, as in
    tests/test_torch_ops.py). JAX pads the 84 channels to 128 for the
    TPU's DMA slices with zeros; the port does not."""
    from keypointnerf_tpu.models import cnn as jcnn

    flags = dict(FUSED, fused_map_half=half, fused_map_half_min_side=0)
    jc, tc = _configs(dtype, **flags)
    rs = np.random.default_rng(11)
    V = world["tvb"].src_images.shape[0]
    maps = [rs.normal(size=(V,) + s).astype(np.float32)
            for s in ((SIZE // 4, SIZE // 4, 64), (SIZE, SIZE, 8), (SIZE // 2, SIZE // 2, 8))]
    jmaps = [jnp.asarray(m).astype(jc.compute_dtype) for m in maps]
    monkeypatch.setattr(jcnn.HGFilter, "__call__", lambda self, x: jmaps[:2])
    monkeypatch.setattr(jcnn.ResBlkEncoder, "__call__", lambda self, x: jmaps[2])
    jvb = world["jvb"]
    jfeats = JaxModel(jc).apply(world["params"], jvb.src_images, jvb.src_masks, False,
                                method=JaxModel.encode)
    ref = np.asarray(jfeats["fused"].astype(jnp.float32))
    assert ref.shape[-1] == 128 and not ref[..., 84:].any()

    model = tm.KeypointNeRF(tc, device="cpu")
    tmaps = [torch.from_numpy(m).to(tc.compute_dtype).permute(0, 3, 1, 2) for m in maps]
    model.geo_encoder.forward = lambda x: tmaps[:2]
    model.tex_encoder.forward = lambda x: tmaps[2]
    tvb = world["tvb"]
    with torch.no_grad():
        feats = model.encode(tvb.src_images, tvb.src_masks)
    fused = feats["fused"]
    assert "full" not in feats and fused.dtype == tc.compute_dtype
    assert fused.shape == ref.shape[:-1] + (84,)
    assert fused.shape[1:3] == ((SIZE // 2, SIZE // 2) if half else (SIZE, SIZE))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(fused.float().numpy(), ref[..., :84])
    else:
        np.testing.assert_allclose(fused.numpy(), ref[..., :84], rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def test_fused_render_matches_jax(world):
    """f32 fused map + K3 (JAX: the Pallas kernel in interpret mode; the
    port on the CPU: its plain version, so no kernel launches) + the cull:
    every output within 1e-4 of its scale, both overflow guards 0."""
    jout, tout = world["jout"], world["tout"]
    assert not world["launched"]
    assert float(jout["cull_overflow"].max()) == float(tout["cull_overflow"].max()) == 0.0
    assert set(jout) == set(tout)
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5     # not an empty image
    for k in KEYS:
        assert tout[k].shape == jout[k].shape, k
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k


def test_fused_cull_exact_and_scores_match_jax(world):
    """The cull on the fused map's mask channel: the culled render is bit
    for bit the unculled one, every nonzero ray scores above the
    threshold, the scores equal JAX's (both read the map's mask channel),
    and suggest_cull_budget takes the same `feats`."""
    model, tvb, tc = world["model"], world["tvb"], world["tc"]
    full_model = tm.KeypointNeRF(dataclasses.replace(tc, cull_empty_rays_ratio=1.0),
                                 device="cpu")
    full_model.load_state_dict(model.state_dict())
    full = render_image(full_model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    culled = dict(world["tout"])
    assert float(culled.pop("cull_overflow").max()) == 0.0
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), culled[k].numpy(), err_msg=k)

    with torch.no_grad():
        feats = model.encode(tvb.src_images, tvb.src_masks)
    pix = pixel_grid(SIZE, SIZE).float()
    o, d, n, f = camera_rays(pix, tvb.tar_K, tvb.tar_R, tvb.tar_t, tc.znear, tc.zfar)
    scores = empty_ray_scores(tc, tvb, o, d, n, f, feats=feats)
    hull = (scores > EMPTY_SCORE_THRESHOLD).numpy()
    assert not ((full["acc_fine"].reshape(-1).numpy() != 0) & ~hull).any()
    assert 0.0 < hull.mean() <= BUDGET

    jc, jvb = world["jc"], world["jvb"]
    jfeats = _jax_encode(jc, world["params"], jvb)
    ref = np.asarray(jax.jit(lambda *r: jax_scores(jc, jvb, *r, feats=jfeats))(
        *(jnp.asarray(x.numpy()) for x in (o, d, n, f))))
    np.testing.assert_array_equal(scores.numpy(), ref)

    budget, worst = suggest_cull_budget(tc, tvb, [(tvb.tar_K, tvb.tar_R, tvb.tar_t)], SIZE,
                                        SIZE, feats=feats)
    assert worst == pytest.approx(hull.mean()) and worst * 1.3 <= budget <= 1.0


def test_fused_map_guards(world):
    """Scores without `feats` under `fused_feature_map` are a ValueError in
    both packages; in training (ported since, held against JAX by
    tests/test_torch_fused_train.py) encode builds the same fused map as at
    eval, with a gradient path to the encoders."""
    tc, tvb, jc, jvb = world["tc"], world["tvb"], world["jc"], world["jvb"]
    pix = pixel_grid(SIZE, SIZE).float()
    rays = camera_rays(pix, tvb.tar_K, tvb.tar_R, tvb.tar_t, tc.znear, tc.zfar)
    with pytest.raises(ValueError, match="feats"):
        empty_ray_scores(tc, tvb, *rays)
    with pytest.raises(ValueError, match="feats"):
        jax_scores(jc, jvb, *(jnp.asarray(x.numpy()) for x in rays))
    with pytest.raises(ValueError, match="feats"):
        suggest_cull_budget(tc, tvb, [(tvb.tar_K, tvb.tar_R, tvb.tar_t)], SIZE, SIZE)
    model = world["model"]
    train = model.encode(tvb.src_images, tvb.src_masks, train=True)["fused"]
    with torch.no_grad():
        assert torch.equal(train, model.encode(tvb.src_images, tvb.src_masks)["fused"])
    assert train.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k3_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card, bit for bit
    (the same rounding at every step), at the fused 84-ch map and an odd
    channel count, with a ragged N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    fn = dma_gather.multiview_bilinear_sample_dma
    for shape in [(3, 256, 256, 84), (2, 33, 17, 37)]:
        maps, xy = _k3_inputs(shape, 20001, seed=5)
        m = torch.from_numpy(maps).cuda().to(dt)
        p = torch.from_numpy(xy).cuda()
        before = fn.launches
        got = fn(m, p)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = dma_gather.dma_gather_plain(m, p)
        assert torch.equal(got, ref)
