"""Port parity for the slice as a whole: weights, the strict render, the
exact empty-ray cull, and the port's guards.

The toy model is tests/test_pallas.py's (n_coarse = n_fine = 4,
geo_n_downsample = 2, 32² images). Weights are drawn by the port from a
seed, carried to the JAX model with `convert_reference_state_dict` and
back into a second port model through `state_dict_from_jax`. The source
images are numpy-seeded texture: on the fg-masked synthetic images
(constant black background) the encoders' one-pass instance-norm variance
cancels catastrophically in f32, and XLA's sequential CPU sums then put
the JAX program itself ~2e-2 off the exact statistics (ROADMAP Queue 3),
which would swamp the parity bar.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_tpu.geometry.cameras import camera_rays as jax_camera_rays  # noqa: E402
from keypointnerf_tpu.geometry.cameras import pixel_grid as jax_pixel_grid  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.presets import strict_preset as jax_strict  # noqa: E402
from keypointnerf_tpu.render.empty_cull import empty_ray_scores as jax_scores  # noqa: E402
from keypointnerf_tpu.render.renderer import render_image as jax_render  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.geometry import camera_rays, pixel_grid  # noqa: E402
from keypointnerf_torch.ops import multiview_onehot_bilinear_sample  # noqa: E402
from keypointnerf_torch.render import EMPTY_SCORE_THRESHOLD, empty_ray_scores, render_image  # noqa: E402
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
SIZE, CHUNK = 32, 256
# the toy scene's hull fraction is larger than the bench scene's 0.1875
# budget (the JAX package's tests/test_model.py culls it at 0.6 too)
BUDGET = 0.6


def _sample():
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def _configs(dtype="float32"):
    jc = dataclasses.replace(jax_strict(JaxConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=getattr(jnp, dtype), pallas_interpret=True)
    tc = dataclasses.replace(tm.strict_preset(tm.KeypointNeRFConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=getattr(torch, dtype))
    return jc, tc


@pytest.fixture(scope="module")
def world():
    jc, tc = _configs()
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = convert_reference_state_dict(seeded.state_dict(), jc, strict=True)
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), tc))
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), params, jvb, height=SIZE,
                                               width=SIZE, chunk=CHUNK))
    tout = render_image(model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    return dict(jc=jc, tc=tc, sample=sample, params=params, model=model, jvb=jvb,
                tvb=tvb, jout=jout, tout=tout)


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


def test_weight_round_trip_bitwise():
    """JAX params (the tree Flax itself builds, filled from a seed) ->
    state_dict_from_jax -> convert_reference_state_dict(strict=True) gives
    the same params bit for bit, and the port loads the state_dict with no
    key missing or left over."""
    jc, tc = _configs()
    vb = JaxViewBatch(**jax.tree.map(jnp.asarray, make_sample(SyntheticConfig(image_size=32))))
    shapes = jax.eval_shape(lambda: JaxModel(jc).init(
        {"params": jax.random.key(0), "render": jax.random.key(1)}, vb, True))
    rs = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rs.normal(size=s.shape).astype(np.float32), shapes)
    sd = state_dict_from_jax(params, tc)
    back = convert_reference_state_dict(sd, jc, strict=True)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = tm.KeypointNeRF(tc, device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    # and the port's own state_dict converts with nothing unconverted
    convert_reference_state_dict(model.state_dict(), jc, strict=True)


def test_strict_render_matches_jax(world):
    """f32 strict preset, port against JAX (Pallas K2 in interpret mode):
    rgb/depth/acc coarse and fine within 1e-4 of each output's scale."""
    jout, tout = world["jout"], world["tout"]
    assert float(jout["cull_overflow"].max()) == 0.0
    assert float(tout["cull_overflow"].max()) == 0.0
    assert set(jout) == set(tout)
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5    # not an empty image
    for k in ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine",
              "acc_fine", "sdf_fine"):
        assert tout[k].shape == jout[k].shape, k
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k


def test_strict_render_matches_jax_ds1(world):
    """ds_geo = ds_tex = 1 (the original reference's encoder inputs,
    avg-pooled once): the hires map is then at half resolution, so no
    "full" map is packed and the query takes its separate hd / RGB / mask
    lookups; same bar as the ds 0 render."""
    jc, tc = (dataclasses.replace(c, ds_geo=1, ds_tex=1) for c in (world["jc"], world["tc"]))
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), world["params"], world["jvb"],
                                               height=SIZE, width=SIZE, chunk=CHUNK))
    model = tm.KeypointNeRF(tc, device="cpu")
    model.load_state_dict(world["model"].state_dict())
    assert "full" not in model.encode(world["tvb"].src_images, world["tvb"].src_masks)
    tout = render_image(model, world["tvb"], height=SIZE, width=SIZE, chunk=CHUNK)
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5
    for k in ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine",
              "acc_fine", "sdf_fine"):
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k


@pytest.mark.parametrize("sp_type", ["rel_z_decay", "rel_z"])
def test_strict_render_fused_geo_mlp_matches_jax(world, sp_type):
    """use_pallas_geo_mlp on both sides (JAX: the Pallas kernels in
    interpret mode; the port on the CPU: their plain versions behind the
    same autograd.Function): rel_z_decay routes to the sp-fused K5, rel_z
    to K4 on `spatial_encode`'s output. Same bar as the flag-off render,
    and the flag changes the port's own image by rounding only."""
    from keypointnerf_torch.ops import geo_mlp_apply, sp_geo_mlp_apply

    flags = dict(use_pallas_geo_mlp=True, sp_type=sp_type)
    jc, tc = (dataclasses.replace(c, **flags) for c in (world["jc"], world["tc"]))
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), world["params"], world["jvb"],
                                               height=SIZE, width=SIZE, chunk=CHUNK))
    model = tm.KeypointNeRF(tc, device="cpu")
    model.load_state_dict(world["model"].state_dict())
    before = (geo_mlp_apply.launches, sp_geo_mlp_apply.launches)
    tout = render_image(model, world["tvb"], height=SIZE, width=SIZE, chunk=CHUNK)
    assert (geo_mlp_apply.launches, sp_geo_mlp_apply.launches) == before   # CPU: plain
    assert float(np.asarray(jout["acc_fine"]).max()) > 0.5
    assert float(tout["cull_overflow"].max()) == 0.0
    for k in ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine",
              "acc_fine", "sdf_fine"):
        assert tout[k].shape == jout[k].shape, k
        assert _max_rel(jout[k], tout[k].numpy()) <= 1e-4, k
    off = tm.KeypointNeRF(dataclasses.replace(tc, use_pallas_geo_mlp=False), device="cpu")
    off.load_state_dict(world["model"].state_dict())
    ref = render_image(off, world["tvb"], height=SIZE, width=SIZE, chunk=CHUNK)
    for k, v in ref.items():
        assert _max_rel(v.numpy(), tout[k].numpy()) <= 1e-4, k


def test_culled_render_bitwise_equals_unculled(world):
    """The port's empty-ray cull is exact: bit-equal to marching every ray
    (mirrors tests/test_model.py::test_cull_empty_rays_exact)."""
    model, tvb = world["model"], world["tvb"]
    full_model = tm.KeypointNeRF(dataclasses.replace(world["tc"], cull_empty_rays_ratio=1.0),
                                 device="cpu")
    full_model.load_state_dict(model.state_dict())
    full = render_image(full_model, tvb, height=SIZE, width=SIZE, chunk=CHUNK)
    culled = dict(world["tout"])
    assert float(culled.pop("cull_overflow").max()) == 0.0
    assert set(full) == set(culled)
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), culled[k].numpy(), err_msg=k)

    # conservativeness: every nonzero ray of the full render scores above
    # the threshold, and the cull is not vacuous
    tc = world["tc"]
    pix = pixel_grid(SIZE, SIZE).float()
    o, d, n, f = camera_rays(pix, tvb.tar_K, tvb.tar_R, tvb.tar_t, tc.znear, tc.zfar)
    hull = (empty_ray_scores(tc, tvb, o, d, n, f) > EMPTY_SCORE_THRESHOLD).numpy()
    nonzero = full["acc_fine"].reshape(-1).numpy() != 0
    assert not (nonzero & ~hull).any()
    assert 0.0 < hull.mean() <= BUDGET


def test_empty_ray_scores_match_jax(world):
    jc, tc, jvb, tvb = world["jc"], world["tc"], world["jvb"], world["tvb"]
    pix = np.asarray(jax_pixel_grid(SIZE, SIZE)).astype(np.float32)
    o, d, n, f = jax_camera_rays(jnp.asarray(pix), jvb.tar_K, jvb.tar_R, jvb.tar_t,
                                 jc.znear, jc.zfar)
    ref = np.asarray(jax_scores(jc, jvb, o, d, n, f))
    got = empty_ray_scores(tc, tvb, *(torch.from_numpy(np.array(x)) for x in (o, d, n, f)),
                           score_chunk=300)   # chunking does not change a score
    np.testing.assert_array_equal(got.numpy(), ref)


def test_strict_render_bf16_bound(world):
    """bf16 strict preset, port against JAX: the sums of the bf16 convs
    and products run in another order, so a bf16 rounding now and then
    lands on the neighbouring value; hold it at a measured bound: worst
    0.51% of an output's scale on this scene (rgb_fine; 0.48% before
    mlp.dot_f32 kept its sums in f32: the convs dominate), pinned at 1%;
    both overflow guards read 0."""
    jc, tc = _configs("bfloat16")
    jout = jax.tree.map(np.asarray, jax_render(JaxModel(jc), world["params"], world["jvb"],
                                               height=SIZE, width=SIZE, chunk=CHUNK))
    model = tm.KeypointNeRF(tc, device="cpu")
    model.load_state_dict(world["model"].state_dict())
    tout = render_image(model, world["tvb"], height=SIZE, width=SIZE, chunk=CHUNK)
    assert float(jout["cull_overflow"].max()) == float(tout["cull_overflow"].max()) == 0.0
    for k in ("rgb_fine", "depth_fine", "acc_fine", "rgb_coarse", "acc_coarse"):
        assert _max_rel(jout[k], tout[k].numpy()) <= 0.01, k


def test_render_feats_reuse_and_ragged_chunks(world):
    """Precomputed feats give the same image bit for bit; a chunk that does
    not divide the ray count (wrap-around padding) gives it to float
    rounding (a matmul's blocking, hence its last bit, depends on the row
    count); on CPU tensors the K2 wrapper runs its plain version and
    launches nothing."""
    model, tvb = world["model"], world["tvb"]
    before = multiview_onehot_bilinear_sample.launches
    feats = model.encode(tvb.src_images, tvb.src_masks)
    out = render_image(model, tvb, height=SIZE, width=SIZE, chunk=CHUNK, feats=feats)
    ragged = render_image(model, tvb, height=SIZE, width=SIZE, chunk=100)
    for k, v in world["tout"].items():
        np.testing.assert_array_equal(out[k].numpy(), v.numpy(), err_msg=k)
        assert _max_rel(v.numpy(), ragged[k].numpy()) <= 1e-6, k
    assert multiview_onehot_bilinear_sample.launches == before
    half = render_image(model, tvb, height=SIZE, width=SIZE, stride=3, chunk=CHUNK, fine=False)
    assert half["rgb_coarse"].shape == (11, 11, 3) and "rgb_fine" not in half


def test_union_path_and_cull_guards(world):
    """reuse_coarse_eval=False re-evaluates the sorted union (the
    reference's path) and gives the merged render to float rounding; the
    cull refuses disable_fg_mask; suggest_cull_budget covers the hull."""
    from keypointnerf_torch.render import suggest_cull_budget

    model, tvb, tc = world["model"], world["tvb"], world["tc"]
    union = tm.KeypointNeRF(dataclasses.replace(tc, reuse_coarse_eval=False), device="cpu")
    union.load_state_dict(model.state_dict())
    out = render_image(union, tvb.to("cpu"), height=SIZE, width=SIZE, chunk=CHUNK)
    for k, v in world["tout"].items():
        assert _max_rel(v.numpy(), out[k].numpy()) <= 1e-5, k

    nofg = tm.KeypointNeRF(dataclasses.replace(tc, disable_fg_mask=True), device="cpu")
    with pytest.raises(ValueError, match="disable_fg_mask"):
        render_image(nofg, tvb, height=SIZE, width=SIZE, chunk=CHUNK)

    budget, hull = suggest_cull_budget(tc, tvb, [(tvb.tar_K, tvb.tar_R, tvb.tar_t)], SIZE, SIZE)
    assert 0.0 < hull < 1.0 and hull * 1.3 <= budget <= 1.0 and budget % (1 / 64) == 0


@pytest.mark.parametrize("flag", [dict(separate_cf=True), dict(pool_mode="attention_v0")])
def test_model_rest_flags_build_and_render(world, flag):
    """`separate_cf` and the attention pools are ported: each builds (the
    fusion MLP's third output, the pool's layers) and renders the toy
    strict camera with finite outputs and the overflow guard at 0 (held
    against the JAX package in tests/test_torch_model_rest.py)."""
    model = tm.KeypointNeRF(dataclasses.replace(world["tc"], **flag), device="cpu")
    sd = model.state_dict()
    sd.update({k: v for k, v in world["model"].state_dict().items() if sd[k].shape == v.shape})
    model.load_state_dict(sd)
    extra = {k for k in sd if k.startswith("mlp_geo.pool.")}
    assert bool(extra) == ("pool_mode" in flag)
    assert sd["mlp_geo.layers2.layers.2.linear.weight"].shape[0] == (3 if "separate_cf" in flag
                                                                    else 2)
    out = render_image(model, world["tvb"], height=SIZE, width=SIZE, stride=2, chunk=CHUNK)
    assert out["rgb_fine"].shape == (SIZE // 2, SIZE // 2, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert float(out.pop("cull_overflow").max()) == 0.0


@pytest.mark.parametrize("flag", [
    dict(gather_lerp=True, fused_feature_map=True),
    dict(coarse_topk_ratio=0.5), dict(fine_topk_ratio=0.75),
])
def test_fast_flags_build_and_render(world, flag):
    """The fast preset's flags are ported: each builds and renders a toy
    camera with finite outputs and the overflow guard at 0 (held against
    the JAX package in tests/test_torch_fast.py)."""
    model = tm.KeypointNeRF(dataclasses.replace(world["tc"], **flag), device="cpu")
    model.load_state_dict(world["model"].state_dict())
    out = render_image(model, world["tvb"], height=SIZE, width=SIZE, stride=2, chunk=CHUNK)
    assert out["rgb_fine"].shape == (SIZE // 2, SIZE // 2, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert float(out.pop("cull_overflow").max()) == 0.0
    assert float(out["acc_fine"].max()) > 0.5


@pytest.mark.parametrize("flag,match", [
    (dict(pool_mode="attention_v0"), "mean/var pooling"),
    (dict(nl_relu_approx=True), "softplus100"),
])
def test_fused_geo_mlp_refuses_what_jax_refuses(flag, match):
    """use_pallas_geo_mlp with pool_mode or nl_relu_approx is a ValueError,
    as in the JAX model's setup; alone it builds."""
    cfg = dataclasses.replace(tm.KeypointNeRFConfig(**TINY), use_pallas_geo_mlp=True)
    tm.KeypointNeRF(cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        tm.KeypointNeRF(dataclasses.replace(cfg, **flag), device="cpu")
    jcfg = JaxConfig(**TINY, use_pallas_geo_mlp=True, **flag)
    vb = JaxViewBatch(**jax.tree.map(jnp.asarray, make_sample(SyntheticConfig(image_size=16))))
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(lambda: JaxModel(jcfg).init(
            {"params": jax.random.key(0), "render": jax.random.key(1)}, vb, True))


def test_training_calls_raise(world):
    """Training is ported with rematerialization: a config with remat or
    remat_save_gathers builds (held against the step without them by
    tests/test_torch_fused_train.py); a training forward without its draws
    raises rather than drawing on its own."""
    for flag in ("remat", "remat_save_gathers"):
        cfg = dataclasses.replace(tm.KeypointNeRFConfig(**TINY), **{flag: True})
        assert getattr(tm.KeypointNeRF(cfg, device="cpu").cfg, flag)
    with pytest.raises(ValueError, match="TrainDraws"):
        world["model"](world["tvb"], train=True)


def test_default_device_is_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    cfg = tm.KeypointNeRFConfig(**TINY)
    sample = make_sample(SyntheticConfig(image_size=16), seed=0)
    if torch.cuda.is_available():
        assert tm.KeypointNeRF(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.KeypointNeRF(cfg)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tm.ViewBatch.from_numpy(sample)


def test_port_imports_no_jax():
    """With jax and flax made unimportable, the whole port imports and
    neither the JAX package nor an image or YAML library enters
    sys.modules."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import keypointnerf_torch, keypointnerf_torch.data, keypointnerf_torch.geometry\n"
        "import keypointnerf_torch.ops, keypointnerf_torch.models, keypointnerf_torch.render\n"
        "import keypointnerf_torch.utils, keypointnerf_torch.ops._build\n"
        "import keypointnerf_torch.training, keypointnerf_torch.models.vgg\n"
        "import keypointnerf_torch.ops.dma_gather, keypointnerf_torch.ops.composite_importance\n"
        "import keypointnerf_torch.utils.config, keypointnerf_torch.evaluation\n"
        "import keypointnerf_torch.evaluation.run_eval\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'keypointnerf_tpu', 'imageio', 'yaml', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
