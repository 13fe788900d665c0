"""The `rel_z_decay` spatial encoding at inference (`ops.rel_z_decay`).

On the CPU the registered op runs its plain version, which is the module
path's composition itself (`spatial_encode`, then the cast to bf16), so
every CPU bit is unchanged; the query takes the op only where `sp_type`
is `rel_z_decay`, the compute dtype is bf16 and no gradient is needed.

On the card (marker `cuda`; this file imports nothing of JAX, so it runs
there: `python -m pytest tests/test_torch_rel_z_decay.py -q`) the kernel
gives the composition's bf16 bits, at a coarse render query's shape and
ragged ones, for points on and far from the keypoints, and at other K and
L; a bf16 inference query launches it once, a frame once a query, a
training step never.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, ViewBatch  # noqa: E402
from keypointnerf_torch.models.spatial_encoding import (  # noqa: E402
    SpatialEncodingConfig,
    spatial_encode,
)
from keypointnerf_torch.ops import rel_z_decay as rzd  # noqa: E402
from keypointnerf_torch.utils import load_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {"model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 8, "model.patch_w": 8,
       "model.geo_n_downsample": 2, "model.tex_ngf": 16, "data.image_size": 32}
# (K, L, sigma, scale): the zju encoding, then others the kernel takes
SHAPES = [(24, 3, 0.1, 1.0), (16, 2, 0.05, 1.7), (64, 5, 0.3, 0.5), (8, 0, 0.1, 1.0)]


def _inputs(V, N, K, seed, device="cpu"):
    """Keypoints around z = 3; 70% of the points within ~0.15 of a keypoint
    (decay weights near 1), the rest spread ~2 away (weights down to
    subnormals and exact zeros)."""
    rs = np.random.default_rng(seed)
    kpt = rs.normal(size=(V, K, 3)) * 0.4 + [0.0, 0.0, 3.0]
    near = kpt[:, rs.integers(0, K, N)] + rs.normal(size=(V, N, 3)) * 0.15
    far = rs.normal(size=(V, N, 3)) * 2.0 + [0.0, 0.0, 3.0]
    pts = np.where(rs.uniform(size=(1, N, 1)) < 0.7, near, far)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return f32(pts), f32(kpt)


def _composed(pts, kpt, L, sigma, scale):
    cfg = SpatialEncodingConfig(sp_level=L, sp_type="rel_z_decay", scale=scale, sigma=sigma,
                                n_kpt=kpt.shape[1])
    return spatial_encode(cfg, None, pts, None, kpt).to(torch.bfloat16)


@pytest.mark.parametrize("K,L,sigma,scale", SHAPES)
def test_cpu_op_is_the_composition(K, L, sigma, scale):
    pts, kpt = _inputs(3, 257, K, seed=K + L)
    before = rzd.fused_rel_z_decay.launches
    got = rzd.fused_rel_z_decay(pts, kpt, L, sigma, scale)
    want = _composed(pts, kpt, L, sigma, scale)
    assert got.shape == (3, 257, (1 + 2 * L) * K) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert rzd.fused_rel_z_decay.launches == before        # counts kernel launches only


def test_takes_mirrors_the_kernel_limits():
    assert all(rzd.takes(K, L) for K, L, _, _ in SHAPES)
    for K, L in ((20, 3), (4, 3), (72, 3), (24, 6), (24, -1)):
        assert not rzd.takes(K, L), (K, L)


def test_wrapper_refuses_what_the_op_does_not_take():
    pts, kpt = _inputs(3, 5, 24, seed=0)
    with pytest.raises(TypeError):
        rzd.fused_rel_z_decay(pts.double(), kpt, 3, 0.1, 1.0)
    with pytest.raises(ValueError):
        rzd.fused_rel_z_decay(pts, kpt[:2], 3, 0.1, 1.0)


# --------------------------------------------------------------- the route
@pytest.fixture(scope="module")
def fast():
    """configs/zju_fast.json's model (bf16, module path) at toy geometry,
    its encoded maps and a coarse query's points."""
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json"), TOY)
    model = KeypointNeRF(cfg.model, device="cpu", seed=0)
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), "cpu")
    with torch.no_grad():
        feats = model.encode(vb.src_images, vb.src_masks)
    rs = np.random.default_rng(1)
    kpt = vb.kpt3d.numpy()
    S = cfg.model.n_coarse
    pts = kpt[rs.integers(0, kpt.shape[0], 16 * S)] + rs.normal(size=(16 * S, 3)) * 0.1
    dirs = rs.normal(size=(16 * S, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return model, vb, feats, f32(pts), f32(dirs), S


@pytest.fixture
def spied(monkeypatch):
    """The op's calls from the query."""
    calls, real = [], rzd.fused_rel_z_decay

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(rzd, "fused_rel_z_decay", spy)
    return calls


def _query(model, fast):
    _, vb, feats, pts, dirs, S = fast
    return model.query_points(pts, dirs, feats, vb, S)


def test_route_engages_once_a_bf16_inference_query(fast, spied, monkeypatch):
    model = fast[0]
    with torch.no_grad():
        got = _query(model, fast)
    assert spied == [(3, fast[3].shape[0], 3)]
    monkeypatch.setattr(rzd, "fused_rel_z_decay", _composed)
    with torch.no_grad():
        want = _query(model, fast)
    assert len(spied) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_route_composes_under_autograd_and_in_f32(fast, spied):
    model = fast[0]
    out = _query(model, fast)
    assert out[0].requires_grad and spied == []
    f32 = model.with_config(compute_dtype=torch.float32)
    with torch.no_grad():
        _query(f32, fast)
    assert spied == []


def test_route_composes_where_the_kernel_does_not_take_the_encoding(fast, spied):
    model = fast[0]
    for fields in (dict(sp_type="rel_z"), dict(sp_level=6)):
        m = model.with_config(**fields)
        assert not m._fused_encoding(*_inputs(3, 4, 24, seed=0))
    with torch.no_grad():
        _query(model.with_config(use_pallas_geo_mlp=True), fast)
    assert spied == []


# ----------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _bf16_steps(a, b):
    """Per entry, how many bf16 values apart a and b lie."""
    def ordered(t):
        bits = t.view(torch.int16).int() & 0xFFFF
        mag = bits & 0x7FFF
        return torch.where(bits >= 0x8000, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 8191, 524_288 + 5])
def test_kernel_equals_the_composition_at_the_render_query(dev, N):
    pts, kpt = _inputs(3, N, 24, seed=N, device=dev)
    before = rzd.fused_rel_z_decay.launches
    got = rzd.fused_rel_z_decay(pts, kpt, 3, 0.1, 1.0)
    want = _composed(pts, kpt, 3, 0.1, 1.0)
    torch.cuda.synchronize()
    assert rzd.fused_rel_z_decay.launches == before + 1
    assert got.shape == want.shape == (3, N, 168) and got.dtype == torch.bfloat16
    assert int(_bf16_steps(got, want).max()) == 0
    w = want[..., :24].float()
    if N > 1:
        assert bool((w == 0).any()) and bool((w != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("K,L,sigma,scale", SHAPES[1:])
def test_kernel_equals_the_composition_at_other_shapes(dev, K, L, sigma, scale):
    pts, kpt = _inputs(2, 3001, K, seed=K, device=dev)
    got = rzd.fused_rel_z_decay(pts, kpt, L, sigma, scale)
    want = _composed(pts, kpt, L, sigma, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and int(_bf16_steps(got, want).max()) == 0


@pytest.mark.cuda
def test_route_on_the_card(dev):
    """A bf16 inference query adds exactly 1 to the counter; under autograd
    and in f32 the query composes; a 256² and a 512² frame of the fast
    preset launch it once a query (4 and 16), a training step never."""
    from keypointnerf_torch.models import VGG19Features
    from keypointnerf_torch.render import render_image
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn

    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=512, n_views=4), seed=0),
                              device=dev)
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json")).model
    model = KeypointNeRF(cfg, device=dev, seed=0)
    with torch.no_grad():
        feats = model.encode(vb.src_images, vb.src_masks)
    pts = (vb.kpt3d[torch.arange(64, device=dev) % vb.kpt3d.shape[0]]
           + 0.05 * torch.randn(64, 3, device=dev))
    dirs = torch.nn.functional.normalize(torch.randn(64, 3, device=dev), dim=-1)
    for m, grad, want in ((model, False, 1), (model, True, 0),
                          (model.with_config(compute_dtype=torch.float32), False, 0)):
        before = rzd.fused_rel_z_decay.launches
        with torch.set_grad_enabled(grad):
            m.query_points(pts, dirs, feats, vb, 64)
        assert rzd.fused_rel_z_decay.launches - before == want, (grad, m.cfg.compute_dtype)
    for size, want in ((256, 4), (512, 16)):
        before = rzd.fused_rel_z_decay.launches
        render_image(model, vb, height=size, width=size, chunk=8192)
        assert rzd.fused_rel_z_decay.launches - before == want, size
    del model, feats
    recipe = load_config(os.path.join(ROOT, "configs", "zju.json"))
    model = KeypointNeRF(recipe.model, device=dev, seed=0)
    state = create_train_state(model, recipe.optim, VGG19Features(device=dev, seed=42))
    gen = torch.Generator(device=dev).manual_seed(0)
    before = rzd.fused_rel_z_decay.launches
    train_step_fn(model, recipe.loss, state, vb, TrainDraws.sample(recipe.model, vb, gen))
    torch.cuda.synchronize()
    assert rzd.fused_rel_z_decay.launches == before

