"""The empty-ray cull's scores at inference (`ops.empty_cull`).

On the CPU the registered op runs its plain version, which is the
composition itself (`empty_ray_scores_plain`, `score_chunk` rays at a
time), so every CPU bit is unchanged; `render.empty_ray_scores` takes the
op for every frame of rays on the card, and composes rays on the CPU.

On the card (marker `cuda`; this file imports nothing of JAX, so it runs
there: `python -m pytest tests/test_torch_empty_cull.py -q`) the kernel
gives the composition's scores bit for bit in its three reductions, over
the source masks' cell table and the fused map's mask channel, at 1 to
262,144 rays, some of which miss the AABB, and at frames of up to 10
views, 1,024² masks and over a thousand samples a group; a fast frame
launches it once, a training step never, and a 512² fast frame is
bit-equal to the same frame scored by the composition.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.geometry import camera_rays  # noqa: E402
from keypointnerf_torch.geometry.sampling import importance_z, stratified_z  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, ViewBatch  # noqa: E402
from keypointnerf_torch.ops import empty_cull as cull_op  # noqa: E402
from keypointnerf_torch.render import empty_cull as ec  # noqa: E402
from keypointnerf_torch.utils import load_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "configs", "zju_fast.json")
TOY = {"model.n_coarse": 4, "model.n_fine": 4, "model.patch_h": 8, "model.patch_w": 8,
       "model.geo_n_downsample": 2, "model.tex_ngf": 16, "data.image_size": 32}
# each reduction by the fields that choose it, and the mask table it reads
CASES = {
    "tight_fused": ({}, True),
    "loose_fused": ({"reuse_coarse_eval": False}, True),
    "plain_fused": ({"gather_lerp": False}, True),
    "plain_masks": ({"fused_feature_map": False, "gather_lerp": False}, False),
}
MODE = {"tight_fused": cull_op.TIGHT, "loose_fused": cull_op.LOOSE,
        "plain_fused": cull_op.PLAIN, "plain_masks": cull_op.PLAIN}


def _frame(case, size, n_rays, seed, device, cfg, n_views=4):
    """A cull's inputs: the config of `case`, a synthetic scene at size²
    with n_views - 1 source views, `feats` holding a fractional half-size
    mask channel for the fused cases, and n_rays rays through pixels drawn
    over 1.5x the image (those off it and near its border miss the AABB)."""
    fields, fused = CASES[case]
    cfg = dataclasses.replace(cfg, **fields)
    vb = ViewBatch.from_numpy(
        make_sample(SyntheticConfig(image_size=size, n_views=n_views), seed=seed), device)
    feats = None
    if fused:
        base = cfg.geo_out_ch + cfg.geo_out_ch_hd + cfg.tex_out_ch
        m = torch.nn.functional.avg_pool2d(vb.src_masks[..., 0][:, None], 2)[:, 0]
        m = m * torch.rand(m.shape, generator=torch.Generator().manual_seed(seed)).to(device)
        fmap = torch.zeros(m.shape + (base + 4,), device=device, dtype=torch.bfloat16)
        fmap[..., base + 3] = m.to(torch.bfloat16)
        feats = {"fused": fmap}
    rs = np.random.default_rng(seed)
    pix = torch.as_tensor(rs.uniform(-0.25 * size, 1.25 * size, (n_rays, 2)),
                          dtype=torch.float32, device=device)
    rays = camera_rays(pix, vb.tar_K, vb.tar_R, vb.tar_t, cfg.znear, cfg.zfar)
    return cfg, vb, feats, rays


@pytest.fixture
def captured(monkeypatch):
    """The op's arguments of every composition the route runs (its
    `score_chunk` left out)."""
    calls, real = [], cull_op.empty_ray_scores_plain

    def spy(*args):
        calls.append(args[:15])
        return real(*args)

    monkeypatch.setattr(cull_op, "empty_ray_scores_plain", spy)
    return calls


@pytest.fixture(scope="module")
def toy_cfg():
    return dataclasses.replace(load_config(FAST, TOY).model, n_coarse=9, n_fine=7,
                               gather_lerp_stride=3)


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_op_is_the_composition(case, toy_cfg, captured):
    cfg, vb, feats, rays = _frame(case, 128, 700, seed=1, device="cpu", cfg=toy_cfg)
    want = ec.empty_ray_scores(cfg, vb, *rays, feats=feats, score_chunk=256)
    (args,) = captured
    assert args[6] == MODE[case]
    before = cull_op.fused_empty_ray_scores.launches
    got = cull_op.fused_empty_ray_scores(*args)
    assert got.shape == (700,) and got.dtype == torch.float32
    assert torch.equal(got, want) and bool((want > ec.EMPTY_SCORE_THRESHOLD).any())
    assert bool((want <= ec.EMPTY_SCORE_THRESHOLD).any())
    assert cull_op.fused_empty_ray_scores.launches == before   # counts kernel launches only


@pytest.mark.parametrize("rows", [1, 5, 300])
def test_fine_bins_give_importance_z_depths(rows):
    """The per-sample table that the kernel and the composition share,
    made at one row and applied as they apply it, gives importance_z's fine
    depths of an all-zero-weight chunk of that many rays."""
    rs = np.random.default_rng(rows)
    n_coarse, n_fine = 64, 64
    near = torch.as_tensor(rs.uniform(1.0, 3.0, (rows, 1)), dtype=torch.float32)
    far = near + torch.as_tensor(rs.uniform(0.5, 4.0, (rows, 1)), dtype=torch.float32)
    z = stratified_z(near, far, n_coarse)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    want = importance_z(torch.zeros_like(z[..., : n_coarse - 2]), z_mid, n_fine)
    j, frac = cull_op._fine_bins(n_coarse - 2, n_fine, torch.device("cpu"))
    assert j.dtype == torch.int32 and frac.dtype == torch.float32
    assert int(j.min()) >= 0 and int(j.max()) <= n_coarse - 2
    jl = j.long()
    z_prev = z_mid[:, jl]
    z_next = z_mid[:, (jl + 1).clamp(max=n_coarse - 2)]
    assert torch.equal(z_prev + frac * (z_next - z_prev), want)


@pytest.mark.parametrize("case", list(CASES))
def test_scores_do_not_depend_on_the_chunking(case, toy_cfg):
    cfg, vb, feats, rays = _frame(case, 64, 300, seed=3, device="cpu", cfg=toy_cfg)
    want = ec.empty_ray_scores(cfg, vb, *rays, feats=feats)
    for chunk in (7, 128, 299):
        assert torch.equal(ec.empty_ray_scores(cfg, vb, *rays, feats=feats, score_chunk=chunk),
                           want), chunk


def test_wrapper_refuses_what_the_op_does_not_take(toy_cfg, captured):
    cfg, vb, feats, rays = _frame("tight_fused", 32, 20, seed=2, device="cpu", cfg=toy_cfg)
    ec.empty_ray_scores(cfg, vb, *rays, feats=feats)
    (args,) = captured
    with pytest.raises(TypeError):
        cull_op.fused_empty_ray_scores(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        cull_op.fused_empty_ray_scores(*args[:3], args[3][:, :2], *args[4:])
    with pytest.raises(ValueError):
        cull_op.fused_empty_ray_scores(*args[:4], args[4][:, 0], *args[5:])
    with pytest.raises(ValueError):
        cull_op.fused_empty_ray_scores(*args[:6], 3, *args[7:])
    for n_coarse, n_fine, stride in ((2, 7, 3), (9, 0, 3), (9, 7, 1)):
        with pytest.raises(ValueError, match="at least 3 coarse"):
            cull_op.fused_empty_ray_scores(*args[:7], n_coarse, n_fine, stride, *args[10:])


# --------------------------------------------------------------- the route
@pytest.fixture(scope="module")
def fast():
    """configs/zju_fast.json's model at toy geometry and a 32² scene."""
    cfg = load_config(FAST, TOY)
    model = KeypointNeRF(cfg.model, device="cpu", seed=0)
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), "cpu")
    return model, vb


@pytest.fixture
def spied(monkeypatch):
    """The op's calls from the route (rays, reduction)."""
    calls, real = [], cull_op.fused_empty_ray_scores

    def spy(*args):
        calls.append((args[3].shape[0], args[6]))
        return real(*args)

    monkeypatch.setattr(cull_op, "fused_empty_ray_scores", spy)
    return calls


def test_route_composes_on_the_cpu(fast, spied, captured):
    from keypointnerf_torch.render import render_image

    model, vb = fast
    render_image(model, vb, height=32, width=32, chunk=256)
    assert spied == [] and len(captured) == 1


def test_route_composes_once_a_camera_on_the_cpu(fast, spied, captured):
    from keypointnerf_torch.render import render_cameras_scanned

    model, vb = fast
    Ks = vb.tar_K[None].expand(2, 3, 3)
    Rs = torch.stack([vb.tar_R, vb.tar_R])
    ts = torch.stack([vb.tar_t, vb.tar_t * 1.1])
    with torch.no_grad():
        feats = model.encode(vb.src_images, vb.src_masks)
    render_cameras_scanned(model, feats, vb, Ks, Rs, ts, height=16, width=16, chunk=256)
    assert spied == [] and [a[3].shape[0] for a in captured] == [256, 256]
    assert {a[6] for a in captured} == {cull_op.TIGHT}


# ----------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card_cfg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return load_config(FAST).model


def _composed(monkeypatch, fn, *args, **kwargs):
    """fn(*args, **kwargs) with the cull's op turned to the composition on
    the card too."""
    with monkeypatch.context() as m:
        m.setattr(cull_op, "fused_empty_ray_scores", cull_op.empty_ray_scores_plain)
        return fn(*args, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 4095, 4097, 65_536, 262_144])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_the_composition(card_cfg, case, n_rays, monkeypatch):
    cfg, vb, feats, rays = _frame(case, 512, n_rays, seed=n_rays % 1000, device="cuda",
                                  cfg=card_cfg)
    before = cull_op.fused_empty_ray_scores.launches
    got = ec.empty_ray_scores(cfg, vb, *rays, feats=feats)
    again = ec.empty_ray_scores(cfg, vb, *rays, feats=feats)
    assert cull_op.fused_empty_ray_scores.launches == before + 2
    want = _composed(monkeypatch, ec.empty_ray_scores, cfg, vb, *rays, feats=feats)
    torch.cuda.synchronize()
    assert cull_op.fused_empty_ray_scores.launches == before + 2
    assert got.shape == want.shape == (n_rays,) and got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(got, again)
    if n_rays >= 4095:
        over = want > ec.EMPTY_SCORE_THRESHOLD
        assert bool(over.any()) and bool((~over).any())


# (case, source views, image size, coarse and fine samples): frames past
# one block of 8 views in the kernel, cell tables of 24,576 (6 views of
# 64 x 64 cells) to 49,152 (3 of 128 x 128) f32 cells, groups of over a
# thousand samples, and the fewest samples a cull takes
LARGE = [
    ("plain_masks", 6, 512, None), ("plain_masks", 3, 1024, None),
    ("plain_masks", 10, 512, None), ("loose_fused", 10, 512, None),
    ("tight_fused", 8, 512, None), ("tight_fused", 9, 512, None),
    ("tight_fused", 10, 1024, None), ("tight_fused", 3, 256, (1100, 1030)),
    ("plain_masks", 3, 256, (1100, 1030)), ("tight_fused", 3, 256, (3, 1)),
    ("loose_fused", 3, 256, (3, 1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,n_src,size,samples", LARGE)
def test_kernel_takes_every_frame(card_cfg, case, n_src, size, samples, monkeypatch):
    cfg = card_cfg
    if samples is not None:
        cfg = dataclasses.replace(cfg, n_coarse=samples[0], n_fine=samples[1])
    n_rays = 4097 if samples else 65_536
    cfg, vb, feats, rays = _frame(case, size, n_rays, seed=n_src * size, device="cuda",
                                  cfg=cfg, n_views=n_src + 1)
    assert vb.src_masks.shape[0] == n_src
    before = cull_op.fused_empty_ray_scores.launches
    got = ec.empty_ray_scores(cfg, vb, *rays, feats=feats)
    assert cull_op.fused_empty_ray_scores.launches == before + 1
    want = _composed(monkeypatch, ec.empty_ray_scores, cfg, vb, *rays, feats=feats)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    over = want > ec.EMPTY_SCORE_THRESHOLD
    assert bool(over.any()) and bool((~over).any())


@pytest.mark.cuda
def test_route_on_the_card(card_cfg, monkeypatch):
    """A 256² and a 512² fast frame launch the kernel once each, a zju
    training step never; the 512² frame is bit-equal to the same frame
    scored by the composition."""
    from keypointnerf_torch.models import VGG19Features
    from keypointnerf_torch.render import render_image
    from keypointnerf_torch.training import TrainDraws, create_train_state, train_step_fn

    dev = torch.device("cuda")
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=512, n_views=4), seed=0),
                              device=dev)
    model = KeypointNeRF(card_cfg, device=dev, seed=0)
    frames = {}
    for size in (256, 512):
        before = cull_op.fused_empty_ray_scores.launches
        frames[size] = render_image(model, vb, height=size, width=size, chunk=8192)
        assert cull_op.fused_empty_ray_scores.launches - before == 1, size
    before = cull_op.fused_empty_ray_scores.launches
    composed = _composed(monkeypatch, render_image, model, vb, height=512, width=512,
                         chunk=8192)
    assert cull_op.fused_empty_ray_scores.launches == before
    for k in composed:
        assert torch.equal(frames[512][k], composed[k]), k
    del model
    recipe = load_config(os.path.join(ROOT, "configs", "zju.json"))
    model = KeypointNeRF(recipe.model, device=dev, seed=0)
    state = create_train_state(model, recipe.optim, VGG19Features(device=dev, seed=42))
    gen = torch.Generator(device=dev).manual_seed(0)
    before = cull_op.fused_empty_ray_scores.launches
    train_step_fn(model, recipe.loss, state, vb, TrainDraws.sample(recipe.model, vb, gen))
    torch.cuda.synchronize()
    assert cull_op.fused_empty_ray_scores.launches == before
