"""Orbit cameras, orbit rendering and the render_dynamic CLI of the port
(`keypointnerf_torch/render/video.py`, `render_dynamic.py`), CPU f32 at
toy size (4 + 4 samples, geo_n_downsample 2, tex_ngf 16).

  * `orbit_cameras`, `zju_orbit_schedule` and `arc_indices` equal the JAX
    package's (numpy there too: no JAX program is compiled);
  * `render_orbit` writes the frames it names, each equal to the port's
    own `render_image` of that orbit camera, rounded as the writer rounds;
  * `auto_cull_budget` raises an under-sized cull budget (overflow 0 after)
    where the budget as given overflows;
  * `write_video` without ffmpeg prints a line and returns False;
  * `python -m keypointnerf_torch.render_dynamic --device cpu` renders the
    test frames of a fake ZJU-MoCap tree from a toy checkpoint.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_tpu.render import video as jvideo  # noqa: E402

from keypointnerf_torch import render_dynamic  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, make_sample, zju  # noqa: E402
from keypointnerf_torch.data.fake_zju import write_fake_tree  # noqa: E402
from keypointnerf_torch.data.image_io import read_png  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402
from keypointnerf_torch.render import video  # noqa: E402
from keypointnerf_torch.training import create_train_state  # noqa: E402
from keypointnerf_torch.utils import CheckpointManager  # noqa: E402

TOY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2, tex_ngf=16,
           compute_dtype=torch.float32)


def _model(**kw):
    return KeypointNeRF(KeypointNeRFConfig(**{**TOY, **kw}), device="cpu", seed=1)


def _vb(size):
    s = make_sample(SyntheticConfig(image_size=size, focal=80.0 * size / 64), seed=0)
    return ViewBatch.from_numpy(s, "cpu")


def test_orbit_helpers_equal_jax():
    rng = np.random.default_rng(0)
    headpose = np.eye(4, dtype=np.float32)
    headpose[:3, :3] = video._rodrigues(rng.uniform(-1, 1, 3))
    headpose[:3, 3] = [0.1, -0.2, 0.3]
    for size in (64, 512):
        assert video.zju_orbit_schedule(size, size) == jvideo.zju_orbit_schedule(size, size)
        s = video.zju_orbit_schedule(size, size)
        for n in (8, 90):
            got = video.orbit_cameras(headpose, s["focal"], s["trans"], size, size, n)
            want = jvideo.orbit_cameras(headpose, s["focal"], s["trans"], size, size, n)
            assert len(got) == n
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    for n in (8, 40, 90):
        for arc in ("full", "back", "front"):
            assert video.arc_indices(n, arc) == jvideo.arc_indices(n, arc)


def test_render_orbit_frames_equal_render_image(tmp_path):
    model, vb = _model(), _vb(32)
    headpose = np.eye(4, dtype=np.float32)
    headpose[:3, 3] = [0.0, 0.05, 0.0]
    written, worst = video.render_orbit(model, vb, headpose, str(tmp_path / "orbit"),
                                        n_frames=8, im_size=32, frame_indices=[0, 3, 5],
                                        frame_group=2, make_video=False, chunk=1024)
    assert [os.path.basename(p) for p in written] == ["000000.png", "000003.png", "000005.png"]
    assert worst == 0.0
    s = video.zju_orbit_schedule(32, 32)
    cams = video.orbit_cameras(headpose, s["focal"], s["trans"], 32, 32, 8)
    orbit_model = model.with_config(znear=s["znear"], zfar=s["zfar"])
    for path, i in zip(written, (0, 3, 5)):
        K, R, t = (torch.as_tensor(a) for a in cams[i])
        out = render_image(orbit_model, dataclasses.replace(vb, tar_K=K, tar_R=R, tar_t=t),
                           height=32, width=32, chunk=1024)
        want = (np.clip(out["rgb_fine"].numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        np.testing.assert_array_equal(read_png(path), want)
    assert read_png(written[0]).std() > 0       # something was rendered


def test_auto_cull_budget_raises_the_budget(tmp_path, capsys):
    model, vb = _model(cull_empty_rays_ratio=1 / 64), _vb(64)
    headpose = np.eye(4, dtype=np.float32)
    kw = dict(n_frames=2, im_size=64, stride=2, frame_indices=[0], make_video=False)
    _, worst = video.render_orbit(model, vb, headpose, str(tmp_path / "as_given"), **kw)
    out = capsys.readouterr().out
    assert worst > 0 and "cull budget exceeded" in out
    _, worst = video.render_orbit(model, vb, headpose, str(tmp_path / "auto"),
                                  auto_cull_budget=2, **kw)
    out = capsys.readouterr().out
    assert "raising cull budget" in out and "cull budget exceeded" not in out
    assert worst == 0.0 and float(out.split("-> ")[1].split(" ")[0]) < 1.0


def test_write_video_without_ffmpeg(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(video.shutil, "which", lambda name: None)
    assert video.write_video(str(tmp_path), str(tmp_path / "out.mp4")) is False
    assert "ffmpeg is not installed" in capsys.readouterr().out


def test_render_dynamic_cli_on_a_fake_tree(tmp_path, monkeypatch):
    human = "CoreView_387"
    root = str(tmp_path / "zju")
    write_fake_tree(root, [human], size=32, n_ims=4)
    monkeypatch.setattr(zju, "get_human_split",
                        lambda split: {human: {"begin_i": 0, "i_intv": 1, "ni": 2}})
    model_cfg = {k: v for k, v in TOY.items() if k != "compute_dtype"}
    config = {"name": "toy", "model": {**model_cfg, "compute_dtype": "float32"},
              "data": {"dataset": "zju", "data_root": root}}
    with open(tmp_path / "toy.json", "w") as f:
        json.dump(config, f)
    model = _model()
    ckpt = str(tmp_path / "ckpts")
    CheckpointManager(ckpt).save(7, create_train_state(model))
    out = render_dynamic.main(["--config", str(tmp_path / "toy.json"), "--model_ckpt", ckpt,
                               "--out_dir", str(tmp_path / "out"), "--n_frames", "8",
                               "--im_size", "32", "--device", "cpu"])
    frame_dir = os.path.join(str(tmp_path / "out"), "toy", "video", "zju", human)
    # the test split's frames 0 and 30: orbit cameras 0 and 30 % 8
    assert sorted(out["frames"]) == [os.path.join(frame_dir, f"{i:06d}.png") for i in (0, 6)]
    assert out["cull_overflow"] == 0.0 and list(out["videos"]) == [frame_dir]
    for p in out["frames"]:
        assert read_png(p).shape == (32, 32, 3)
