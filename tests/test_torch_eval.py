"""Port parity for the evaluation layer and the multi-camera renderers:
`keypointnerf_torch/evaluation/` (metrics, the Evaluator and its PNG
trees, `run_eval`) and `render_cameras_scanned` / `render_images_batched`,
against the JAX package.

Tolerances: the metrics are the same numpy / scipy code, so they are equal;
the Evaluator's PNGs hold the same pixels as the JAX package's (imageio
reads both); the renderers' frames are within 1e-4 of each output's scale
of JAX's (f32 toy model of tests/test_torch_render.py), and equal to the
port's own `render_image` of each camera / subject bit for bit.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.data import SyntheticConfig as JaxSyntheticConfig  # noqa: E402
from keypointnerf_tpu.data import SyntheticDataset as JaxSyntheticDataset  # noqa: E402
from keypointnerf_tpu.data import make_sample  # noqa: E402
from keypointnerf_tpu.evaluation import Evaluator as JaxEvaluator  # noqa: E402
from keypointnerf_tpu.evaluation import eval_saved_images as jax_eval_saved  # noqa: E402
from keypointnerf_tpu.evaluation import metrics as jm  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.presets import strict_preset as jax_strict  # noqa: E402
from keypointnerf_tpu.parallel import stack_batch  # noqa: E402
from keypointnerf_tpu.render import render_cameras_scanned as jax_scanned  # noqa: E402
from keypointnerf_tpu.render import render_images_batched as jax_batched  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, SyntheticDataset, look_at  # noqa: E402
from keypointnerf_torch.evaluation import (  # noqa: E402
    Evaluator, bounding_rect, compute_test_metric, eval_saved_images, psnr, read_png, run_eval,
    structural_similarity, write_png)
from keypointnerf_torch.render import (  # noqa: E402
    render_cameras_scanned, render_image, render_images_batched)
from keypointnerf_torch.utils import load_config, state_dict_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
SIZE, STRIDE, CHUNK, BUDGET = 32, 4, 64, 0.6


def _textured(seed):
    # numpy-seeded texture (see tests/test_torch_render.py)
    sample = make_sample(JaxSyntheticConfig(image_size=SIZE), seed=seed)
    sample["src_images"] = np.random.default_rng(seed + 4).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


@pytest.fixture(scope="module")
def world():
    # the strict preset with the plain tex lookup: the renderers do not
    # depend on it, and JAX's Pallas lookup in interpret mode compiles slowly
    flags = dict(tex_onehot_sample=False)
    jc = dataclasses.replace(jax_strict(JaxConfig(**TINY), cull_budget=BUDGET),
                             compute_dtype=jnp.float32, **flags)
    tc = dataclasses.replace(tm.strict_preset(tm.KeypointNeRFConfig(**TINY),
                                              cull_budget=BUDGET), compute_dtype=torch.float32,
                             **flags)
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = convert_reference_state_dict(seeded.state_dict(), jc, strict=True)
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), tc))
    samples = [_textured(3), _textured(11)]
    return dict(jc=jc, tc=tc, params=params, model=model, samples=samples)


def _images(seed, shape=(40, 40, 3)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return x, y


def test_metrics_match_jax():
    """psnr, the skimage-spec SSIM (float and uint8 inputs, grey and
    multichannel), bounding_rect and compute_test_metric equal JAX's."""
    x, y = _images(7)
    mask = np.zeros((40, 40), bool)
    mask[10:30, 5:33] = True
    assert psnr(x, y) == jm.psnr(x, y)
    for a, b, kw in ((x, y, dict(multichannel=True)), (x[..., 0], y[..., 0], {}),
                     ((x * 255).astype(np.uint8), (y * 255).astype(np.uint8), {}),
                     (x, y, dict(win_size=5, data_range=1.0))):
        assert structural_similarity(a, b, **kw) == jm.structural_similarity(a, b, **kw)
    for m in (mask, np.zeros((40, 40), bool)):
        assert bounding_rect(m) == jm.bounding_rect(m)
    for m in (None, mask):
        assert compute_test_metric(x, y, m) == jm.compute_test_metric(x, y, m)
    with pytest.raises(ValueError, match="win_size"):
        structural_similarity(x[:5, :5], y[:5, :5])


def test_png_writer_round_trip(tmp_path):
    """write_png / read_png round-trip RGB; imageio reads the same pixels;
    imageio's own PNGs (its filtered rows, grey) read as imageio reads them (data/image_io.py's reader; tests/test_torch_image_io.py
    holds every filter and colour type), a 16-bit PNG is refused by
    read_png, arrays that are not uint8 with 1-4 channels by write_png."""
    import imageio.v2 as imageio

    img = np.random.default_rng(2).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    for name, foreign in (("filtered", np.tile(np.arange(64, dtype=np.uint8)[:, None], (8, 1, 3))),
                          ("grey", img[..., 0])):
        imageio.imwrite(str(tmp_path / f"{name}.png"), foreign)
        np.testing.assert_array_equal(read_png(str(tmp_path / f"{name}.png")), foreign)
    imageio.imwrite(str(tmp_path / "deep.png"), img[..., 0].astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="8-bit"):
        read_png(str(tmp_path / "deep.png"))
    for other in (img.astype(np.float32), np.zeros((4, 4, 5), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            write_png(path, other)


def test_evaluator_matches_jax(tmp_path):
    """compute_score's numbers equal JAX's, the two PNG trees hold the same
    files with the same pixels, and eval_saved_images re-scores the port's
    tree as JAX's re-scores its own."""
    import imageio.v2 as imageio

    pred, gt = _images(3, (48, 40, 3))
    inputs = np.random.default_rng(4).random((3, 48, 40, 3)).astype(np.float32)
    mab = np.zeros((48, 40), bool)
    mab[8:40, 4:30] = True
    trees = {}
    for name, ev in (("port", Evaluator(str(tmp_path / "port"))),
                     ("jax", JaxEvaluator(str(tmp_path / "jax")))):
        s1 = ev.compute_score(pred, gt, mab, input_imgs=inputs, human_idx="h", frame_index=2)
        s2 = ev.compute_score(pred[:, :, ::-1], gt, np.zeros((48, 40)), human_idx="h",
                              frame_index=3, view_index=1)   # empty mask: the full frame
        trees[name] = (s1, s2, sorted(os.path.relpath(p, tmp_path / name) for p in
                                      glob.glob(str(tmp_path / name / "*" / "*" / "*.png"))))
    assert trees["port"][:2] == trees["jax"][:2]
    assert trees["port"][2] == trees["jax"][2] and len(trees["port"][2]) == 7
    for rel in trees["port"][2]:
        ours = imageio.imread(str(tmp_path / "port" / rel))
        np.testing.assert_array_equal(ours, imageio.imread(str(tmp_path / "jax" / rel)), rel)
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / rel)), ours)
    assert eval_saved_images(str(tmp_path / "port")) == jax_eval_saved(str(tmp_path / "jax"))


def test_run_eval_auto_cull_budget(tmp_path, capsys):
    """run_eval(auto_cull_budget=1) raises an under-sized cull budget to the
    probed hull and keeps the overflow at 0 (JAX tests/test_metrics.py:101);
    without the probe the same budget overflows and the sample is
    reported. The means land in test_v3_{step}.yml, the PNGs in the tree."""
    cfg = load_config(None, overrides={
        "out_dir": str(tmp_path), "name": "auto_cull",
        "model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 4, "model.patch_w": 4,
        "model.geo_n_downsample": 2, "model.compute_dtype": "f32",
        "model.cull_empty_rays_ratio": 0.02})
    model = tm.KeypointNeRF(cfg.model, device="cpu", seed=0)
    data = SyntheticDataset(SyntheticConfig(image_size=32, focal=40.0), length=2)
    assert set(data[1]) == set(JaxSyntheticDataset(length=2)[1])
    for k, v in JaxSyntheticDataset(JaxSyntheticConfig(image_size=32, focal=40.0), 2)[1].items():
        np.testing.assert_array_equal(data[1][k], v, k)

    scores = run_eval(cfg, model, data, max_samples=1, auto_cull_budget=1, step=7)
    log = capsys.readouterr().out
    assert "raising cull budget 0.02 ->" in log and "WARNING" not in log
    assert set(scores) == {"mse", "psnr", "ssim"} and np.isfinite(scores["psnr"])
    assert np.isfinite(scores["ssim"])
    yml = (tmp_path / "auto_cull" / "test_v3_7.yml").read_text()
    assert f"psnr: {scores['psnr']}" in yml
    assert len(glob.glob(str(tmp_path / "auto_cull" / "images_v3" / "h" / "*" / "*.png"))) == 5
    assert model.cfg.cull_empty_rays_ratio == 0.02      # the caller's model is untouched

    plain = run_eval(cfg, model, data, result_dir=str(tmp_path / "plain"), max_samples=1)
    assert "WARNING: sample 0: empty-ray cull budget exceeded" in capsys.readouterr().out
    # one process: sharded=True is the unsharded render, as in JAX
    # (multi-rank runs: tests/test_torch_parallel.py)
    assert run_eval(cfg, model, data, result_dir=str(tmp_path / "sharded"), max_samples=1,
                    sharded=True) == plain


def test_render_cameras_scanned_matches_jax(world):
    """Two cameras of one subject from one encoding (the sample's target
    and an orbit camera: a source camera would make every ray's
    direction difference to that view ~0, whose normalised direction is
    rounding noise): the frames are JAX's render_cameras_scanned's within
    1e-4 of their scale, and each is the port's render_image of that
    camera bit for bit; the worst overflow is 0 in both (JAX
    tests/test_model.py:680)."""
    model, sample, jc = world["model"], world["samples"][0], world["jc"]
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    R1, t1 = look_at(3.5 * np.array([np.cos(0.7), 0.05, np.sin(0.7)]), np.zeros(3))
    Ks = torch.stack([tvb.tar_K, tvb.tar_K])
    Rs = torch.stack([tvb.tar_R, torch.from_numpy(R1)])
    ts = torch.stack([tvb.tar_t, torch.from_numpy(t1)])
    feats = model.encode(tvb.src_images, tvb.src_masks)
    kw = dict(height=SIZE, width=SIZE, stride=STRIDE, chunk=CHUNK)
    rgb, ov = render_cameras_scanned(model, feats, tvb, Ks, Rs, ts, **kw)
    assert rgb.shape == (2, 8, 8, 3) and float(ov) == 0.0

    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    jfeats = jax.jit(lambda p, i, m: JaxModel(jc).apply(p, i, m, method=JaxModel.encode))(
        world["params"], jvb.src_images, jvb.src_masks)
    ref, jov = jax_scanned(JaxModel(jc), world["params"], jfeats, jvb,
                           *(jnp.asarray(x.numpy()) for x in (Ks, Rs, ts)), **kw)
    assert float(jov) == 0.0 and float(np.abs(np.asarray(ref)).max()) > 0.05
    assert _max_rel(ref, rgb.numpy()) <= 1e-4
    for f in range(2):
        vb_f = dataclasses.replace(tvb, tar_K=Ks[f], tar_R=Rs[f], tar_t=ts[f])
        single = render_image(model, vb_f, feats=feats, **kw)
        np.testing.assert_array_equal(rgb[f].numpy(), single["rgb_fine"].numpy())
    coarse, _ = render_cameras_scanned(model, feats, tvb, Ks[:1], Rs[:1], ts[:1], fine=False,
                                       **kw)
    np.testing.assert_array_equal(coarse[0].numpy(), render_image(
        model, tvb, feats=feats, fine=False, **kw)["rgb_coarse"].numpy())


def test_render_images_batched_matches_jax(world):
    """Two subjects: every output is JAX's render_images_batched's within
    1e-4 of its scale, and each subject's is the port's render_image of
    it bit for bit (JAX tests/test_model.py:660)."""
    model, samples, jc = world["model"], world["samples"], world["jc"]
    vbs = [tm.ViewBatch.from_numpy(s, device="cpu") for s in samples]
    kw = dict(height=SIZE, width=SIZE, stride=STRIDE, chunk=CHUNK)
    out = render_images_batched(model, vbs, **kw)
    assert out["rgb_fine"].shape == (2, 8, 8, 3)
    ref = jax_batched(JaxModel(jc), world["params"],
                      stack_batch([JaxViewBatch(**jax.tree.map(jnp.asarray, s)) for s in samples]),
                      **kw)
    assert set(ref) == set(out)
    assert float(np.asarray(ref["acc_fine"]).max()) > 0.5
    for k in ("rgb_coarse", "acc_coarse", "rgb_fine", "depth_fine", "acc_fine"):
        assert _max_rel(ref[k], out[k].numpy()) <= 1e-4, k
    for b, vb in enumerate(vbs):
        single = render_image(model, vb, **kw)
        for k, v in single.items():
            np.testing.assert_array_equal(out[k][b].numpy(), v.numpy(), k)
