"""Port parity for the fast serving path (`fast_preset`,
configs/zju_fast.json): the strided gather-lerp, the lerp bounds of the
empty-ray cull, the coarse and fine top-k culls, against the JAX package.

The toy model is tests/test_torch_render.py's (n_coarse = n_fine = 4,
geo_n_downsample = 2, 32² textured source images), in f32: in bf16 the
lerp's `left + t * (right - left)` rounds at each step on the card, where
XLA's CPU program may fuse it, so the bf16 fast render is held on the card
(chip_smoke.py) and not here.

Tolerances:
* `strided_gather_lerp` against JAX's `_strided_gather_lerp`: 1e-6 of the
  map's largest entry.
* The lerp cull scores: equal to 1e-6 (both round the cell values to
  bf16), and the same rays over the threshold.
* The toy fast render (fused map, lerp, cull, coarse 0.5, fine 0.75):
  within 1e-4 of each output's scale, as the strict render; the culls'
  ties (every ray that hits the AABB scores 1 in the coarse cut, every
  empty ray 0 in the fine cut) select JAX's rays.
* Culled against unculled under `gather_lerp` with the top-k ratios at
  1.0: bit for bit.
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
from keypointnerf_tpu.models.keypoint_nerf import _strided_gather_lerp  # noqa: E402
from keypointnerf_tpu.models.presets import fast_preset as jax_fast  # noqa: E402
from keypointnerf_tpu.render.empty_cull import empty_ray_scores as jax_scores  # noqa: E402
from keypointnerf_tpu.render.renderer import render_image as jax_render  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.geometry import camera_rays, pixel_grid, ray_aabb_intersection  # noqa: E402
from keypointnerf_torch.models.keypoint_nerf import strided_gather_lerp, top_k_indices  # noqa: E402
from keypointnerf_torch.ops import multiview_bilinear_sample  # noqa: E402
from keypointnerf_torch.render import (  # noqa: E402
    EMPTY_SCORE_THRESHOLD, empty_ray_scores, render_image)
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
SIZE, CHUNK, BUDGET = 32, 256, 0.6
# coarse 0.5 so that the coarse cut's 0/1 ties decide which rays it marches
TOPK = dict(coarse_topk_ratio=0.5, fine_topk_ratio=0.75)
KEYS = ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine", "acc_fine",
        "sdf_fine")


def _sample():
    # numpy-seeded texture (see tests/test_torch_render.py)
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def _configs(**flags):
    jc = dataclasses.replace(jax_fast(JaxConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=jnp.float32, **TOPK, **flags)
    tc = dataclasses.replace(tm.fast_preset(tm.KeypointNeRFConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=torch.float32, **TOPK, **flags)
    return jc, tc


def _port_model(tc, state_dict):
    model = tm.KeypointNeRF(tc, device="cpu")
    model.load_state_dict(state_dict)
    return model


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


@pytest.fixture(scope="module")
def world():
    """The toy scene, seeded weights on both sides, the toy fast render of
    each package and the rays of the target camera."""
    jc, tc = _configs()
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = convert_reference_state_dict(seeded.state_dict(), jc, strict=True)
    model = _port_model(tc, state_dict_from_jax(jax.tree.map(np.asarray, params), tc))
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), params, jvb, height=SIZE,
                                               width=SIZE, chunk=CHUNK))
    tout = render_image(model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    with torch.no_grad():
        feats = model.encode(tvb.src_images, tvb.src_masks)
    pix = pixel_grid(SIZE, SIZE).float()
    rays = camera_rays(pix, tvb.tar_K, tvb.tar_R, tvb.tar_t, tc.znear, tc.zfar)
    return dict(jc=jc, tc=tc, model=model, jvb=jvb, tvb=tvb, jout=jout, tout=tout,
                feats=feats, rays=rays)


@pytest.mark.parametrize("n_samples,stride", [(8, 2), (7, 2), (9, 3), (8, 3)])
def test_strided_gather_lerp_matches_jax(n_samples, stride):
    """S divisible and not divisible by the stride: the port's lerp is
    JAX's to 1e-6 of the map's scale, and the plain lookup at every
    stride-th sample (t = 0 there; the last sample is the end of its
    segment, t = 1 up to rounding)."""
    rs = np.random.default_rng(n_samples * 10 + stride)
    V, R, C = 2, 5, 6
    fmap = rs.normal(size=(V, 9, 11, C)).astype(np.float32)
    # each ray a straight segment of NDC points, as a camera ray projects
    start = rs.uniform(-0.9, 0.9, (V, R, 1, 2))
    step = rs.uniform(-0.2, 0.2, (V, R, 1, 2))
    xy = (start + step * np.arange(n_samples)[None, None, :, None]).astype(np.float32)
    xy = xy.reshape(V, R * n_samples, 2)
    ref = np.asarray(_strided_gather_lerp(jnp.asarray(fmap), jnp.asarray(xy), n_samples, stride))
    got = strided_gather_lerp(torch.from_numpy(fmap), torch.from_numpy(xy), n_samples, stride)
    assert got.shape == ref.shape == (V, R * n_samples, C)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(fmap).max())
    anchors = list(range(0, n_samples, stride))
    exact = multiview_bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(xy))
    idx = (np.arange(R)[:, None] * n_samples + np.array(anchors)[None]).reshape(-1)
    np.testing.assert_array_equal(got[:, idx].numpy(), exact[:, idx].numpy())


def test_top_k_indices_break_ties_as_jax():
    """Among equal scores the lower index comes first, as in jax.lax.top_k."""
    score = np.array([0, 1, 1, 0, 1, 0.5, 0, 1], np.float32)
    for k in (1, 3, 5, 8):
        ref = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
        np.testing.assert_array_equal(top_k_indices(torch.from_numpy(score), k).numpy(), ref)


@pytest.mark.parametrize("mode", ["tight", "loose"])
def test_lerp_scores_match_jax(world, mode):
    """The lerp bounds of the empty-ray cull on the fused map's mask
    channel: tight (coarse-value reuse: only the anchors, window-3 max)
    and loose (no reuse: min over views of the max over samples) equal
    JAX's `empty_ray_scores` given the same map, with the same rays over
    the threshold; the tight bound is the tighter."""
    flags = {} if mode == "tight" else dict(reuse_coarse_eval=False)
    jc, tc = (dataclasses.replace(c, **flags) for c in (world["jc"], world["tc"]))
    feats = world["feats"]
    got = empty_ray_scores(tc, world["tvb"], *world["rays"], feats=feats, score_chunk=300)
    jfeats = {"fused": jnp.asarray(feats["fused"].numpy())}
    ref = np.asarray(jax.jit(lambda *r: jax_scores(jc, world["jvb"], *r, feats=jfeats))(
        *(jnp.asarray(x.numpy()) for x in world["rays"])))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() > EMPTY_SCORE_THRESHOLD,
                                  ref > EMPTY_SCORE_THRESHOLD)
    assert 0.0 < (ref > EMPTY_SCORE_THRESHOLD).mean() <= BUDGET
    plain = empty_ray_scores(dataclasses.replace(tc, gather_lerp=False), world["tvb"],
                             *world["rays"], feats=feats)
    if mode == "tight":
        loose = empty_ray_scores(dataclasses.replace(tc, reuse_coarse_eval=False),
                                 world["tvb"], *world["rays"], feats=feats)
        assert bool((got <= loose).all()) and bool((got < loose).any())
    else:
        assert bool((got >= plain).all())


def test_fast_render_matches_jax(world):
    """f32 toy fast render (fused map, gather-lerp, cull, coarse 0.5, fine
    0.75), port against JAX from the same weights: every output within
    1e-4 of its scale, both overflow guards 0."""
    jout, tout = world["jout"], world["tout"]
    assert float(jout["cull_overflow"].max()) == float(tout["cull_overflow"].max()) == 0.0
    assert set(jout) == set(tout)
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5     # not an empty image
    for k in KEYS:
        assert tout[k].shape == jout[k].shape, k
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k


def test_topk_culls_select_jax_rays(world):
    """One chunk of the toy camera's rays through `render_rays`: the coarse
    cut marches the first half of the rays by AABB hit (ties: lower index
    first) and the others take empty space's values; the fine cut keeps
    the coarse result on the rays it does not march."""
    model, tvb, tc = world["model"], world["tvb"], world["tc"]
    o, d, n, f = world["rays"]
    sel = slice(256, 256 + CHUNK)          # a chunk of 108 hits and 148 misses
    with torch.no_grad():
        out = model.render_rays(world["feats"], tvb, o, d[sel], n[sel], f[sel])
        no_cut = _port_model(dataclasses.replace(tc, coarse_topk_ratio=1.0,
                                                 fine_topk_ratio=1.0), model.state_dict())
        ref = no_cut.render_rays(world["feats"], tvb, o, d[sel], n[sel], f[sel])
    hit = ray_aabb_intersection(tvb.bounds, o, d[sel])[2][:, 0]
    assert int(hit.sum()) == 108           # every hit is marched, and 20 misses
    marched = top_k_indices(hit.float(), CHUNK // 2)
    unmarched = torch.ones(CHUNK, dtype=torch.bool)
    unmarched[marched] = False
    assert int(unmarched.sum()) == CHUNK // 2 and not bool(hit[unmarched].any())
    assert bool((out["acc_coarse"][unmarched] == 0).all())
    # the rays the fine cut skips keep their coarse values
    kept = top_k_indices(out["acc_coarse"], int(CHUNK * 0.75))
    skipped = torch.ones(CHUNK, dtype=torch.bool)
    skipped[kept] = False
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_array_equal(out[f"{k}_fine"][skipped].numpy(),
                                      out[f"{k}_coarse"][skipped].numpy())
    # marched rays of both cuts see the uncut values
    both = torch.zeros(CHUNK, dtype=torch.bool)
    both[kept] = True
    both &= hit
    for k in ("acc_coarse", "acc_fine", "rgb_fine"):
        np.testing.assert_allclose(out[k][both].numpy(), ref[k][both].numpy(), rtol=0,
                                   atol=1e-6)


def test_lerp_culled_equals_unculled(world):
    """Under gather_lerp (tight bound) with the top-k ratios at 1.0, the
    culled render is the unculled one bit for bit, and every nonzero ray
    of it scores over the threshold (JAX tests/test_model.py:276)."""
    tc = dataclasses.replace(world["tc"], coarse_topk_ratio=1.0, fine_topk_ratio=1.0)
    sd = world["model"].state_dict()
    culled = render_image(_port_model(tc, sd), world["tvb"], height=SIZE, width=SIZE,
                          chunk=CHUNK)
    full = render_image(_port_model(dataclasses.replace(tc, cull_empty_rays_ratio=1.0), sd),
                        world["tvb"], height=SIZE, width=SIZE, chunk=CHUNK)
    assert float(culled.pop("cull_overflow").max()) == 0.0
    assert set(full) == set(culled)
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), culled[k].numpy(), err_msg=k)
    scores = empty_ray_scores(tc, world["tvb"], *world["rays"], feats=world["feats"])
    nonzero = full["acc_fine"].reshape(-1).numpy() != 0
    assert nonzero.any() and not (nonzero & (scores <= EMPTY_SCORE_THRESHOLD).numpy()).any()


def test_dma_turns_lerp_off_but_not_its_bound(world):
    """With use_dma_gather and gather_lerp the query takes K3's lookup
    without the lerp (bit-equal to the query with the lerp off), while
    the cull scores keep the lerp bound, as the JAX package chooses."""
    tc, tvb, feats = world["tc"], world["tvb"], world["feats"]
    sd = world["model"].state_dict()
    dma = dataclasses.replace(tc, use_dma_gather=True)
    o, d, _, _ = world["rays"]
    z = torch.linspace(2.5, 4.5, tc.n_coarse)
    pts = (o + d[300:364, None, :] * z[:, None]).reshape(-1, 3)
    view = d[300:364, None, :].expand(-1, tc.n_coarse, -1).reshape(-1, 3)
    with torch.no_grad():
        q = {name: _port_model(c, sd).query_points(pts, view, feats, tvb, tc.n_coarse)
             for name, c in (("dma_lerp", dma),
                             ("dma", dataclasses.replace(dma, gather_lerp=False)),
                             ("lerp", tc))}
    for a, b in zip(q["dma_lerp"], q["dma"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert any(not torch.equal(a, b) for a, b in zip(q["dma_lerp"], q["lerp"]))

    got = empty_ray_scores(dma, tvb, *world["rays"], feats=feats)
    lerp_bound = empty_ray_scores(tc, tvb, *world["rays"], feats=feats)
    plain = empty_ray_scores(dataclasses.replace(dma, gather_lerp=False), tvb, *world["rays"],
                             feats=feats)
    np.testing.assert_array_equal(got.numpy(), lerp_bound.numpy())
    assert not torch.equal(got, plain)
    jc = dataclasses.replace(world["jc"], use_dma_gather=True)
    jfeats = {"fused": jnp.asarray(feats["fused"].numpy())}
    ref = np.asarray(jax.jit(lambda *r: jax_scores(jc, world["jvb"], *r, feats=jfeats))(
        *(jnp.asarray(x.numpy()) for x in world["rays"])))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
