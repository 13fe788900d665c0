"""The port's multi-camera serving artifact (`export_render(...,
multicam=True)`): the source views encoded once, F = 2 target cameras
marched, ((F, H, W, 3), worst cull overflow) out.

The model is tests/test_torch_export_cull.py's (the strict preset at toy
widths in f32, K2 and K5 as registered ops) with a covering cull budget;
the two cameras are the sample's target and a second orbit camera. Each
frame equals the port's eager single-camera render of its camera bit for
bit, and the worst overflow is 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.data.synthetic import look_at  # noqa: E402
from keypointnerf_torch.export import export_render, load_render  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402

from test_torch_export_cull import ARGS, CHUNK, H, W, strict  # noqa: E402

F = 2


def test_multicam_artifact_equals_single_camera_renders():
    sample = make_sample(SyntheticConfig(image_size=64), seed=0)
    sample["tar_K"] = (np.diag([H / 64.0, W / 64.0, 1.0]) @ sample["tar_K"]).astype(np.float32)
    model = tm.KeypointNeRF(strict(0.9), device="cpu", seed=0)
    with torch.no_grad():
        model.mlp_geo.layers2.layers[-1].linear.bias[1] += 2.0
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    R2, t2 = look_at(np.array([0.0, -0.6, 3.4]), np.zeros(3))
    Ks = torch.stack([vb.tar_K, vb.tar_K])
    Rs = torch.stack([vb.tar_R, torch.as_tensor(R2, dtype=torch.float32)])
    ts = torch.stack([vb.tar_t, torch.as_tensor(t2, dtype=torch.float32)])
    args = tuple(getattr(vb, k) for k in ARGS[:7]) + (Ks, Rs, ts)
    params = model.state_dict()
    serve = load_render(export_render(model, params, args, height=H, width=W, chunk=CHUNK,
                                      device="cpu", multicam=True))
    frames, overflow = serve(params, *args)
    assert frames.shape == (F, H, W, 3) and float(overflow) == 0.0
    for f in range(F):
        vb_f = tm.ViewBatch(**dict(vars(vb), tar_K=Ks[f], tar_R=Rs[f], tar_t=ts[f]))
        single = render_image(model, vb_f, height=H, width=W, chunk=CHUNK)
        assert float(single["cull_overflow"].max()) == 0.0
        assert torch.equal(frames[f], single["rgb_fine"]), f
    assert not torch.equal(frames[0], frames[1])
