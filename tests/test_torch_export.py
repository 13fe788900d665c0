"""The port's serving export (`keypointnerf_torch/export.py`) on the CPU.

Config: tests/test_export.py's (n_coarse = n_fine = 4, geo_n_downsample
= 2, the 64² synthetic sample, a 16² render). Weights are drawn by the
port from a seed and carried to the JAX model with
`convert_reference_state_dict`. The source images are numpy-seeded
texture, as in tests/test_torch_render.py (on the fg-masked sphere the
encoders' one-pass instance-norm variance cancels in f32 and puts JAX's
own program ~2e-2 off, ROADMAP Queue 3).

The JAX side runs its live `jax.jit(make_serving_fn(..., chunk=64))`, as
tests/test_export.py does. The port's artifact marches the 256 rays as
one chunk: a program unrolls the chunk loop, and exporting, saving and
loading each cost ~1-3 ms a graph node on this CPU (a toy chunk is ~1,700
nodes), so one chunk keeps this file inside its time. The port's eager
render gives the same values at either chunk.

One export serves every check here: the artifact, saved to a file, is
loaded and run in a fresh process that imports only `load_render` (never
`keypointnerf_torch.models`); its frames are held against JAX's at the
toy render's 1e-4 of the max (tests/test_torch_render.py) and against
the port's eager render bit for bit; a wrong input shape raises there. The
same process renders eagerly before and after the export: the second
render returns real tensors, bit-equal to the first (`device.cached`).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_tpu.export import make_serving_fn as jax_serving_fn  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.export import export_render  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
H = W = 16
ARTIFACT_CHUNK = H * W
JAX_CHUNK = 64


def flat_args(sample):
    """(src_images, ..., tar_t), the exported signature's order."""
    return tuple(sample[k] for k in ("src_images", "src_masks", "src_K", "src_R", "src_t",
                                     "kpt3d", "bounds", "tar_K", "tar_R", "tar_t"))


def textured_sample():
    sample = make_sample(SyntheticConfig(image_size=64), seed=0)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


# The fresh process: the artifact and its inputs from files, only
# load_render imported; writes the frames, the overflow, whether a wrong
# shape raised and which of the port's modules it imported.
CONSUMER = r"""
import json, sys
import torch
from keypointnerf_torch.export import load_render
d = sys.argv[1]
serve = load_render(open(f"{d}/render.pt2", "rb").read())
params = torch.load(f"{d}/params.pt")
args = torch.load(f"{d}/args.pt")
rgb, overflow = serve(params, *args)
torch.save({"rgb": rgb, "overflow": overflow}, f"{d}/out.pt")
try:
    serve(params, torch.zeros((2, 8, 8, 3)), *args[1:])
    raised = False
except Exception:
    raised = True
targets = {str(n.target) for n in serve.program.graph.nodes}
ops = sorted(t for t in targets if "kpnerf" in t)
print(json.dumps({"raised": raised, "ops": ops,
                  "profiler": sorted(t for t in targets if "profiler" in t),
                  "models": [m for m in sys.modules if m.startswith("keypointnerf_torch.models")],
                  "jax": "jax" in sys.modules}))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = tm.KeypointNeRFConfig(**TINY)
    jc = JaxConfig(**TINY)
    model = tm.KeypointNeRF(cfg, device="cpu", seed=0)
    jparams = convert_reference_state_dict(model.state_dict(), jc, strict=True)
    sample = textured_sample()
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    args = tuple(torch.from_numpy(a) for a in flat_args(sample))
    before = render_image(model, vb, height=H, width=W, chunk=ARTIFACT_CHUNK)["rgb_fine"]
    blob = export_render(model, model.state_dict(), args, height=H, width=W,
                         chunk=ARTIFACT_CHUNK, device="cpu")
    after = render_image(model, vb, height=H, width=W, chunk=ARTIFACT_CHUNK)["rgb_fine"]
    d = tmp_path_factory.mktemp("artifact")
    (d / "render.pt2").write_bytes(blob)
    torch.save(model.state_dict(), d / "params.pt")
    torch.save(args, d / "args.pt")
    run = subprocess.run([sys.executable, "-c", CONSUMER, str(d)], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(model=model, jc=jc, jparams=jparams, sample=sample, before=before,
                after=after, blob=blob, consumer=json.loads(run.stdout.strip().splitlines()[-1]),
                out=torch.load(d / "out.pt"))


def test_artifact_matches_jax_live(world):
    """The port's loaded artifact against JAX's live serving function on
    the same weights: frames within the toy render's 1e-4 of the max, the
    overflow guard a constant 0 (this config does not cull)."""
    live = jax.jit(jax_serving_fn(JaxModel(world["jc"]), H, W, chunk=JAX_CHUNK))
    rgb, overflow = live(world["jparams"], *(jnp.asarray(a) for a in flat_args(world["sample"])))
    rgb = np.asarray(rgb)
    got = world["out"]["rgb"].numpy()
    assert got.shape == rgb.shape == (H, W, 3) and np.all(np.isfinite(got))
    err = np.abs(got.astype(np.float64) - rgb).max() / max(np.abs(rgb).max(), 1e-12)
    assert err <= 1e-4, err
    assert float(overflow) == 0.0 and float(world["out"]["overflow"]) == 0.0


def test_artifact_bit_equal_to_eager_render(world):
    assert isinstance(world["blob"], bytes) and len(world["blob"]) > 1000
    assert torch.equal(world["out"]["rgb"], world["before"])


def test_fresh_process_needs_only_the_ops(world):
    """The consumer imported load_render and the ops, never the model nor
    JAX; a wrong input shape raised there. The graph holds no profiler op
    (the program's spans are no-ops in an export's trace)."""
    c = world["consumer"]
    assert c["models"] == [] and not c["jax"]
    assert c["profiler"] == []
    assert c["raised"]


def test_eager_render_after_export_is_unchanged(world):
    """An export traces through `device.constant` and the upsample's
    matrix; the eager render after it returns real tensors, bit-equal to
    the one before."""
    from torch._subclasses.fake_tensor import FakeTensor

    assert type(world["after"]) is torch.Tensor and not isinstance(world["after"], FakeTensor)
    assert torch.equal(world["after"], world["before"])
    assert all(type(p) is torch.nn.Parameter or type(p) is torch.Tensor
               for p in world["model"].state_dict().values())
