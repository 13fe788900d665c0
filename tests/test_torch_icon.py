"""Port parity: KeypointICON, its train step, the occupancy grid, the
mesher, the metrics and the ICON CLI (`keypointnerf_torch/models/
keypoint_icon.py`, `evaluation/meshing.py`, `train_icon.py`) against the
JAX package.

The model is tests/test_icon.py's (geo_n_downsample 2, MLP (128, 128,
128)) on a 32² blob scene of the root train_icon.py. The JAX parameter
tree comes from `jax.eval_shape` of its init, filled from a numpy seed;
the port loads it through `icon_state_dict_from_jax`. One jitted JAX
program gives the logits, the BCE loss, its gradient, one optax.adam step
and the sigmoid occupancy at every point of a 16³ grid (JAX's
`occupancy_grid` is that function chunked by `lax.map`). Tolerances,
measured and held with margin: logits and the grid at 2e-5 of the max,
the loss at 1e-6 relative, every gradient at 2e-4 of its leaf's max, the
updated parameters at 2e-5 (one Adam step moves a parameter by ~lr =
1e-3) where the gradient is at least 1e-7 (see the step's test). The numpy helpers (surface samples, marching tetrahedra, OBJ, the
metrics, the blob scenes) are copies of JAX's and are held bit for bit.
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
import optax  # noqa: E402

from keypointnerf_tpu.evaluation import meshing as jmesh  # noqa: E402
from keypointnerf_tpu.models import keypoint_icon as jicon  # noqa: E402
from keypointnerf_torch.evaluation import meshing as tmesh  # noqa: E402
from keypointnerf_torch.models import keypoint_icon as ticon  # noqa: E402
from keypointnerf_torch import train_icon as tcli  # noqa: E402
from keypointnerf_torch.utils import icon_state_dict_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import train_icon as jcli  # noqa: E402  (the JAX package's CLI, numpy helpers only)

JCFG = jicon.KeypointICONConfig(geo_n_downsample=2, mlp_hidden=(128, 128, 128))
TCFG = ticon.KeypointICONConfig(geo_n_downsample=2, mlp_hidden=(128, 128, 128))
RES = 16
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _fill(shapes, seed):
    rs = np.random.default_rng(seed)

    def one(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rs.normal(0, np.sqrt(2.0 / fan_in), s.shape).astype(np.float32)
        if name in ("scale", "gain"):
            return (1.0 + 0.1 * rs.normal(size=s.shape)).astype(np.float32)
        return (0.1 * rs.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _grid(bounds):
    lo, hi = bounds
    axes = [np.linspace(lo[d], hi[d], RES, dtype=np.float32) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)


@pytest.fixture(scope="module")
def world():
    sc = jcli.make_blob_scene(3, size=32, n_kpt=JCFG.n_kpt)
    pts, labels = jcli.sample_training_points(sc, rs=np.random.default_rng(0))
    cam = tuple(jnp.asarray(sc[k]) for k in ("K", "R", "t", "kpt3d"))
    jm = jicon.KeypointICON(JCFG)
    image = jnp.asarray(sc["image"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), image, jnp.zeros((8, 3)), *cam))
    params = _fill(shapes, 5)
    tx = optax.adam(LR)

    @jax.jit
    def program(params, pts, labels, grid):
        def loss_fn(p):
            logits = jm.apply(p, image, pts, *cam)
            return jicon.bce_occupancy_loss(logits[..., 0], labels), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params))
        feats = jm.apply(params, image, method=jicon.KeypointICON.encode)
        occ = jax.nn.sigmoid(jm.apply(params, grid, feats, *cam,
                                      method=jicon.KeypointICON.query_occupancy)[..., 0])
        return logits, loss, grads, optax.apply_updates(params, updates), occ

    out = jax.tree.map(np.asarray, program(params, jnp.asarray(pts), jnp.asarray(labels),
                                           jnp.asarray(_grid(sc["bounds"]))))
    model = ticon.KeypointICON(TCFG, device="cpu", seed=1)
    model.load_state_dict(icon_state_dict_from_jax(jax.tree.map(np.asarray, params), TCFG),
                          strict=True)
    return dict(sc=sc, pts=pts, labels=labels, params=params, model=model,
                jax=dict(zip(("logits", "loss", "grads", "updated", "occ"), out)))


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-12)


def _cam(sc):
    return tuple(_t(sc[k]) for k in ("K", "R", "t", "kpt3d"))


def test_logits_match_jax(world):
    sc = world["sc"]
    with torch.no_grad():
        logits = world["model"](_t(sc["image"]), _t(world["pts"]), *_cam(sc))
    assert logits.shape == (len(world["pts"]), 1)
    assert _rel(logits.numpy(), world["jax"]["logits"]) <= 2e-5


def test_train_step_matches_jax(world):
    """One BCE + Adam step: the loss, every gradient (carried onto the
    port's names by icon_state_dict_from_jax) and the updated parameters."""
    sc, model = world["sc"], world["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, step = ticon.make_icon_train_step(model, LR)
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    try:
        loss = step(_t(sc["image"]), _t(world["pts"]), _t(world["labels"]), *_cam(sc))
        ref = world["jax"]
        assert abs(float(loss) - float(ref["loss"])) <= 1e-6 * abs(float(ref["loss"]))
        jg = icon_state_dict_from_jax(ref["grads"], TCFG)
        # every parameter once (a ConvBlock's bn4 is also downsample.0)
        assert set(grads) == {k for k, _ in model.named_parameters()} and set(grads) <= set(jg)
        for k in grads:
            assert _rel(grads[k].numpy(), jg[k].numpy()) <= 2e-4, k
        ju = icon_state_dict_from_jax(ref["updated"], TCFG)
        for k, v in model.named_parameters():
            v, g, g_jax = v.detach().numpy(), grads[k].numpy(), jg[k].numpy()
            # Adam's first step is -lr g / (|g| + eps): where |g| nears eps
            # (1e-8) it magnifies the gradients' rounding difference (~1e-9
            # there); such elements are held to that formula of the port's
            # own gradient, the rest to JAX's updated parameters
            steady = np.abs(g_jax) >= 1e-7
            np.testing.assert_allclose(v[steady], ju[k].numpy()[steady], rtol=0, atol=2e-5,
                                       err_msg=k)
            np.testing.assert_allclose(
                v, before[k].numpy() - LR * g / (np.abs(g) + 1e-8), rtol=0, atol=2.5e-7,
                err_msg=k)      # two f32 ulps of a unit-size parameter
            assert steady.mean() > 0.5 and not np.array_equal(v, before[k].numpy()), k
    finally:
        model.load_state_dict(before)


def test_occupancy_grid_matches_jax(world):
    sc = world["sc"]
    occ, axes = ticon.occupancy_grid(world["model"], sc["image"], sc["K"], sc["R"], sc["t"],
                                     sc["kpt3d"], sc["bounds"], resolution=RES, chunk=1000)
    assert occ.shape == (RES, RES, RES)
    assert _rel(occ.reshape(-1), world["jax"]["occ"]) <= 2e-5
    lo, hi = sc["bounds"]
    for d in range(3):
        np.testing.assert_array_equal(axes[d], np.linspace(lo[d], hi[d], RES, dtype=np.float32))


def _sphere_grid(res, smooth):
    axes = [np.linspace(-0.8, 0.8, res, dtype=np.float32)] * 3
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt(gx**2 + gy**2 + gz**2)
    occ = np.clip(0.5 + (0.5 - d) * 10.0, 0.0, 1.0) if smooth else (d < 0.5).astype(np.float32)
    return occ, axes


@pytest.mark.parametrize("res,smooth", [(48, False), (40, True), (24, False)])
def test_mesher_and_surface_samples_bit_equal(res, smooth, tmp_path):
    """tests/test_icon.py's three sphere grids: surface samples, the
    marching-tetrahedra soup and the OBJ text equal JAX's bit for bit."""
    occ, axes = _sphere_grid(res, smooth)
    np.testing.assert_array_equal(ticon.surface_points_from_grid(occ, axes),
                                  jicon.surface_points_from_grid(occ, axes))
    tv, tf = tmesh.marching_tetrahedra(occ, axes, iso=0.5)
    jv, jf = jmesh.marching_tetrahedra(occ, axes, iso=0.5)
    assert len(tv) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    tmesh.extract_mesh(occ, axes, path=str(tmp_path / "t.obj"))
    jmesh.extract_mesh(occ, axes, path=str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_metrics_match_jax():
    rs = np.random.default_rng(0)
    a = rs.standard_normal((700, 3)).astype(np.float32)
    b = (a[:500] + 0.05 * rs.standard_normal((500, 3))).astype(np.float32)
    for f in ("chamfer_distance", "point_to_surface"):
        got, ref = getattr(ticon, f)(a, b, chunk=256), getattr(jicon, f)(a, b, chunk=256)
        assert abs(got - ref) <= 1e-6 * abs(ref)
    assert ticon.point_to_surface(a[:0], b) == float("inf")


def test_blob_scene_helpers_bit_equal():
    for seed, size in ((3, 32), (10_001, 48)):
        t, j = tcli.make_blob_scene(seed, size=size), jcli.make_blob_scene(seed, size=size)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_array_equal(tcli.blob_surface_points(j["centers"], j["radii"], seed=2),
                                  jcli.blob_surface_points(j["centers"], j["radii"], seed=2))
    tp, tl = tcli.sample_training_points(j, rs=np.random.default_rng(4))
    jp, jl = jcli.sample_training_points(j, rs=np.random.default_rng(4))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)


def test_cli_end_to_end(tmp_path):
    """The port's CLI at tests/test_train_icon_cli.py's sizes on the CPU:
    the OBJ, icon_metrics.json and the final JSON line. After 5 steps the
    port's grid may hold no 0.5 crossing (the untrained occupancy of its
    seeded init is 0.56-0.82 everywhere on this scene): an empty surface
    gives Chamfer inf, as JAX's point_to_surface defines it."""
    out = tmp_path / "icon"
    r = subprocess.run(
        [sys.executable, "-m", "keypointnerf_torch.train_icon", "--out_dir", str(out),
         "--device", "cpu", "--steps", "5", "--n_scenes", "2", "--eval_scenes", "1",
         "--resolution", "16", "--image_size", "32"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    metrics = json.loads((out / "icon_metrics.json").read_text())
    assert set(metrics) == {"mean", "scenes"} and len(metrics["scenes"]) == 1
    scene = metrics["scenes"][0]
    assert (out / "eval_0.obj").exists()
    assert np.isfinite(scene["chamfer"]) == (scene["n_verts"] > 0)
    assert np.isfinite(metrics["mean"]["voxel"])
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["metric"] == "icon_unseen_chamfer"
