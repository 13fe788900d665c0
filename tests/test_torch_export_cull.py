"""The serving contract of the port's exported artifact: the cull overflow
guard, read from the artifact's outputs alone (docs/API.md "Serving
contract"; the JAX package's tests/test_export.py holds its own).

The model is the strict preset (K2 for the tex lookups, K5 for the
geometry MLP, both as registered ops whose plain versions run on the
CPU) at toy widths, in f32, with small encoders: the artifacts here are
held against the port's eager renders, not against JAX, and a program's
export, save and load cost ~1-3 ms a graph node on this CPU (an encoder
is a third of a one-chunk toy program). The sample is the JAX test's 64²
synthetic scene with the target intrinsics scaled to the 16² render, so
the subject covers far more of the frame than a 2% budget.

* A budget of 0.02 (6 rays): the artifact reports an overflow > 0, equal
  to the port's eager render's.
* A covering budget of 0.9: the overflow is 0 and the frames equal the
  render without the cull bit for bit (the cull is exact whenever the
  guard is zero).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.export import export_render, load_render  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402

H = W = 16
CHUNK = H * W
SMALL = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=1, tex_ngf=16,
             tex_n_downsample=2, tex_n_blocks=1, tex_n_upsample=1)
ARGS = ("src_images", "src_masks", "src_K", "src_R", "src_t", "kpt3d", "bounds", "tar_K",
        "tar_R", "tar_t")


def strict(budget):
    return dataclasses.replace(
        tm.strict_preset(tm.KeypointNeRFConfig(**SMALL), cull_budget=budget),
        compute_dtype=torch.float32, use_pallas_geo_mlp=True)


@pytest.fixture(scope="module")
def world():
    sample = make_sample(SyntheticConfig(image_size=64), seed=0)
    sample["tar_K"] = (np.diag([H / 64.0, W / 64.0, 1.0]) @ sample["tar_K"]).astype(np.float32)
    model = tm.KeypointNeRF(strict(1.0), device="cpu", seed=0)
    with torch.no_grad():
        model.mlp_geo.layers2.layers[-1].linear.bias[1] += 2.0   # a visible subject
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    args = tuple(getattr(vb, k) for k in ARGS)
    return dict(model=model, vb=vb, args=args, params=model.state_dict())


def artifact(world, budget):
    model = world["model"].with_config(cull_empty_rays_ratio=budget)
    serve = load_render(export_render(model, world["params"], world["args"], height=H,
                                      width=W, chunk=CHUNK, device="cpu"))
    ops = {str(n.target) for n in serve.program.graph.nodes if "kpnerf" in str(n.target)}
    assert ops == {"kpnerf.onehot_bilinear.default", "kpnerf.sp_geo_mlp.default"}, ops
    rgb, overflow = serve(world["params"], *world["args"])
    eager = render_image(model, world["vb"], height=H, width=W, chunk=CHUNK)
    return rgb, overflow, eager


def test_under_budget_artifact_reports_overflow(world):
    rgb, overflow, eager = artifact(world, 0.02)
    assert float(overflow) > 0.0
    assert float(overflow) == float(eager["cull_overflow"].max())
    assert torch.equal(rgb, eager["rgb_fine"])


def test_covering_budget_artifact_is_exact(world):
    rgb, overflow, _ = artifact(world, 0.9)
    assert float(overflow) == 0.0
    uncalled = render_image(world["model"], world["vb"], height=H, width=W, chunk=CHUNK)
    assert "cull_overflow" not in uncalled
    assert float((uncalled["acc_fine"] > 0.5).float().mean()) > 0.02
    assert torch.equal(rgb, uncalled["rgb_fine"])
