"""Port parity for the rest of the model: the attention pools (`pool_mode`)
and `separate_cf`.

  * `AttentionPool` v0 / v1 against the JAX module (f32, numpy-seeded
    weights and inputs): 1 and 2 heads, V = 1 (no reweighting) and V = 3,
    pool_types ("var",) (valid needs two views), no pixel weights;
  * the weight carry: the Flax scope names of the pool read from a built
    JAX model, the port's `state_dict_from_jax` onto `mlp_geo.pool.*`;
  * one toy f32 zju-recipe training step with `attention_v1` and
    `separate_cf` against the JAX package's jitted `train_step_fn` (loss,
    every gradient, the updated parameters; the bars and the draw fakes of
    tests/test_torch_train_step.py), and the eval render of the same model
    (the fine pass reads rad_f, the coarse-value reuse is off) at the
    render parity tests' bar, both from ONE jitted JAX program;
  * the fast preset's lerp cull bound under `separate_cf` (loose, as in
    JAX) against JAX's `empty_ray_scores`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_fused_train import check_params, jax_vgg_params  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    TINY,
    VGG_SLICES,
    ZJU,
    _InjectedDraws,
    _numpy_draws,
    _sample,
)
from test_torch_train_step import test_train_step_grads as check_grads  # noqa: E402
from test_torch_train_step import test_train_step_losses as check_losses  # noqa: E402

from keypointnerf_tpu.geometry.cameras import camera_rays as jax_camera_rays  # noqa: E402
from keypointnerf_tpu.geometry.cameras import pixel_grid as jax_pixel_grid  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.mlp import AttentionPool as JaxPool  # noqa: E402
from keypointnerf_tpu.models.presets import fast_preset as jax_fast  # noqa: E402
from keypointnerf_tpu.render.empty_cull import empty_ray_scores as jax_scores  # noqa: E402
from keypointnerf_tpu.render.renderer import render_image as jax_render  # noqa: E402
from keypointnerf_tpu.training import LossConfig as JaxLossConfig  # noqa: E402
from keypointnerf_tpu.training import TrainState as JaxTrainState  # noqa: E402
from keypointnerf_tpu.training import train_step_fn as jax_train_step  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.geometry import camera_rays, pixel_grid  # noqa: E402
from keypointnerf_torch.models.mlp import AttentionPool  # noqa: E402
from keypointnerf_torch.render import empty_ray_scores, render_image  # noqa: E402
from keypointnerf_torch.training import LossConfig, OptimConfig, create_train_state  # noqa: E402
from keypointnerf_torch.training import train as port_train  # noqa: E402
from keypointnerf_torch.training import train_step_fn  # noqa: E402
from keypointnerf_torch.utils import state_dict_from_jax  # noqa: E402
from keypointnerf_torch.utils.convert import POOL_DENSE  # noqa: E402

REST = dict(pool_mode="attention_v1", separate_cf=True)
STRIDE, CHUNK = 2, 256
RENDER_KEYS = ("rgb_coarse", "depth_coarse", "acc_coarse", "rgb_fine", "depth_fine",
               "acc_fine", "sdf_fine")


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(a)).max(), 1e-12)


# ------------------------------------------------------------ the pool alone
@pytest.mark.parametrize("mode,heads,V,pool_types,with_weight", [
    ("attention_v0", 1, 3, ("mean", "var"), True),
    ("attention_v0", 1, 1, ("mean", "var"), True),
    ("attention_v0", 1, 3, ("var",), False),
    ("attention_v1", 1, 3, ("mean", "var"), True),
    ("attention_v1", 2, 3, ("mean", "var"), True),
    ("attention_v1", 2, 3, ("max", "mean", "var"), False),
    ("attention_v1", 1, 1, ("mean", "var"), True),
    ("attention_v1", 2, 3, ("var",), True),
])
def test_attention_pool_matches_jax(mode, heads, V, pool_types, with_weight):
    """Pooled features within 1e-5 of their scale and `valid` equal; the
    masks leave some points with no view and some with one (where the
    ("var",) pool is not valid)."""
    N, C = 40, 16
    rs = np.random.default_rng(V * 10 + heads)
    x = rs.normal(size=(V, N, C)).astype(np.float32)
    mask = (rs.uniform(size=(V, N, 1)) > 0.4).astype(np.float32)
    mask[:, :4] = 0.0
    mask[:, 4:8] = 0.0
    mask[0, 4:8] = 1.0
    weight = None
    if with_weight:
        w = rs.uniform(0.1, 1.0, size=(V, N, 1)).astype(np.float32) * mask
        weight = w / (w.sum(0, keepdims=True) + 1e-6)
    dense = [(2 * C, C), (C, C)] if mode == "attention_v1" else [(C, 1)]
    params = {f"Dense_{i}": {"kernel": (rs.normal(size=s) / np.sqrt(s[0])).astype(np.float32),
                             "bias": rs.normal(size=s[1:]).astype(np.float32) * 0.1}
              for i, s in enumerate(dense)}
    jpool = JaxPool(pool_types=pool_types, pool_mode=mode, n_heads=heads)
    shapes = jax.eval_shape(lambda: jpool.init(jax.random.key(0), x, mask, weight))
    if V == 1:                    # the Dense layers are built only for V > 1
        params = {}
    assert (jax.tree.map(lambda s: s.shape, dict(shapes.get("params", {})))
            == jax.tree.map(np.shape, params))
    jout, jvalid = jpool.apply({"params": params} if params else {}, x, mask, weight)

    pool = AttentionPool(C, pool_types, mode, n_heads=heads)
    with torch.no_grad():
        for i, name in enumerate(POOL_DENSE[mode] if params else ()):
            getattr(pool, name).weight.copy_(torch.from_numpy(params[f"Dense_{i}"]["kernel"].T))
            getattr(pool, name).bias.copy_(torch.from_numpy(params[f"Dense_{i}"]["bias"]))
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        out, valid = pool(t(x), t(mask), t(weight))
    assert out.shape == jout.shape == (N, len(pool_types) * C)
    assert _max_rel(jout, out.numpy()) <= 1e-5
    np.testing.assert_array_equal(np.asarray(jvalid), valid.numpy())
    if pool_types == ("var",):
        assert not valid[4:8].any() and not valid[:4].any()
    if V == 1:
        # one view: the plain weighted pool, no reweighting
        from keypointnerf_torch.models.mlp import masked_pool

        ref, _ = masked_pool(t(x), t(mask), t(weight), pool_types)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_pool_mode_refused_with_use_pallas_geo_mlp():
    """use_pallas_geo_mlp with a pool_mode is a ValueError, as in JAX; an
    unknown mode is refused by the pool."""
    cfg = tm.KeypointNeRFConfig(**TINY, pool_mode="attention_v1", use_pallas_geo_mlp=True)
    with pytest.raises(ValueError, match="mean/var pooling"):
        tm.KeypointNeRF(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown pool_mode"):
        AttentionPool(8, pool_mode="attention_v2")


# ------------------------------------------------- the model: step and render
def _pool_to_flax(sd, mode):
    """The Flax AttentionPool_0 tree of the port's `mlp_geo.pool.*` (the
    inverse of `state_dict_from_jax`'s pool carry)."""
    return {f"Dense_{i}": {"kernel": sd[f"mlp_geo.pool.{n}.weight"].numpy().T.copy(),
                           "bias": sd[f"mlp_geo.pool.{n}.bias"].numpy().copy()}
            for i, n in enumerate(POOL_DENSE[mode])}


@pytest.fixture(scope="module")
def rest():
    """One jitted JAX program: the training step and the stride-2 eval
    render of the toy zju model with attention_v1 and separate_cf."""
    flags = dict(ZJU, **REST)
    jc = JaxConfig(**TINY, **flags, pallas_interpret=True)
    tc = tm.KeypointNeRFConfig(**TINY, **flags)
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    with torch.no_grad():
        # rad_c and rad_f > 0 somewhere: both radiance channels shape the
        # image (at +1.0 the coarse pass is black; at +2.0 one updated entry,
        # |g| 1.1e-6 in JAX and 1.2e-6 here, 8e-6 of its leaf's max, moves
        # 5.1e-7 apart: Adam near its eps, above PARAM_BOUND's 5e-7)
        seeded.mlp_geo.layers2.layers[-1].linear.bias[1:] += 1.5
    sd0 = {k: v for k, v in seeded.state_dict().items()}
    rest_sd = {k: v for k, v in sd0.items() if not k.startswith("mlp_geo.pool.")}
    params = jax.tree.map(np.asarray, convert_reference_state_dict(rest_sd, jc, strict=True))
    params["params"]["mlp_geo"]["AttentionPool_0"] = _pool_to_flax(sd0, tc.pool_mode)
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    shapes = jax.eval_shape(lambda: JaxModel(jc).init(
        {"params": jax.random.key(0), "render": jax.random.key(1)}, jvb, True))
    assert (jax.tree_util.tree_structure(jax.tree.map(np.shape, shapes))
            == jax.tree_util.tree_structure(jax.tree.map(np.shape, params)))
    vgg = tm.VGG19Features(VGG_SLICES, device="cpu")
    queue, draws = _numpy_draws(tc, sample)

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    jmodel = JaxModel(jc)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, vgg_params=jax_vgg_params(vgg),
        tx=optax.chain(capture, optax.adam(OptimConfig().learning_rate)))
    h = w = sample["tar_image"].shape[0]

    def program(s, b, k):
        image = jax_render(jmodel, s.params, b, height=h, width=w, stride=STRIDE, chunk=CHUNK)
        return jax_train_step(jmodel, JaxLossConfig(), s, b, k), image

    with _InjectedDraws(queue):
        (jstate, jerr), jimage = jax.jit(program)(jstate, jvb, jax.random.key(0))

    sd = state_dict_from_jax(params, tc)
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(sd, strict=True)
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    timage = render_image(model, vb, height=h, width=w, stride=STRIDE, chunk=CHUNK)
    state = create_train_state(model, OptimConfig(), vgg)
    captured = []
    apply = port_train.apply_gradients
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_train, "apply_gradients",
                   lambda s, p, g: (captured.append([x.clone() for x in g]), apply(s, p, g)))
        with torch.no_grad():
            out = model(vb, train=True, draws=draws)
        terr = train_step_fn(model, LossConfig(), state, vb, draws)
    names = [n for n, _ in model.named_parameters()]
    from keypointnerf_torch.training import compute_losses

    eerr = compute_losses(out, LossConfig(), vgg)[1]
    return dict(
        tc=tc, sd0=sd0, sd=sd, sample=sample, jimage=jax.tree.map(np.asarray, jimage),
        timage=timage, jerr={k: float(v) for k, v in jerr.items()},
        terr={k: float(v) for k, v in terr.items()},
        eerr={k: float(v) for k, v in eerr.items()},
        jgrads=state_dict_from_jax(jax.tree.map(np.asarray, jstate.opt_state[0]), tc),
        tgrads=dict(zip(names, captured[0])),
        jparams=state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tc),
        tparams=dict(model.named_parameters()),
        acc=float(out["acc_fine"].max()),
    )


def test_pool_weights_carry(rest):
    """The Flax tree with the pool has the structure of the JAX model's
    own (checked in the fixture) and `state_dict_from_jax` gives the
    port's weights back bit for bit, the pool's `q_proj` / `k_proj` and
    the third output row of the fusion MLP's last layer included."""
    sd0, sd = rest["sd0"], rest["sd"]
    assert set(sd) == set(sd0)
    assert {k for k in sd if k.startswith("mlp_geo.pool.")} == {
        f"mlp_geo.pool.{n}.{p}" for n in ("q_proj", "k_proj") for p in ("weight", "bias")}
    assert sd["mlp_geo.layers2.layers.2.linear.weight"].shape[0] == 3
    for k in sd0:
        torch.testing.assert_close(sd[k], sd0[k], rtol=0, atol=0)


def test_rest_train_step_matches_jax(rest):
    """attention_v1 + separate_cf: loss terms within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest entry, the updated parameters
    at the pinned bound (the key's bias, a rounding-noise leaf by
    construction, aside); the pool's and the rad_f channel's parameters
    get a gradient (the fine pass reads rad_f, the coarse pass rad_c)."""
    check_losses(rest)
    tg = rest["tgrads"]
    top = max(float(g.abs().max()) for g in tg.values())
    # the key's bias adds q . b_k to every view's logit alike, which the
    # renormalisation over views cancels: its gradient is 0 in exact
    # arithmetic and rounding noise in both programs
    kb = "mlp_geo.pool.k_proj.bias"
    assert max(float(tg[kb].abs().max()), float(rest["jgrads"][kb].abs().max())) < 1e-6 * top
    check_grads(dict(rest, tgrads={k: v for k, v in tg.items() if k != kb}))
    check_params(rest)
    for leaf in ("mlp_geo.pool.q_proj.weight", "mlp_geo.pool.k_proj.weight"):
        assert float(tg[leaf].abs().max()) > 1e-6 * top, leaf
    last = tg["mlp_geo.layers2.layers.2.linear.weight"]
    assert float(last[1].abs().max()) > 0.0 and float(last[2].abs().max()) > 0.0


def test_rest_eval_render_matches_jax(rest):
    """The eval render of the same model: every output within 1e-4 of its
    scale (the render parity tests' bar); with separate_cf the fine image
    differs from a render that reads rad_c in the fine pass."""
    jimage, timage = rest["jimage"], rest["timage"]
    assert float(jimage["acc_fine"].max()) > 0.5
    for k in RENDER_KEYS:
        assert timage[k].shape == jimage[k].shape, k
        assert _max_rel(jimage[k], timage[k].numpy()) <= 1e-4, k
    model = tm.KeypointNeRF(dataclasses.replace(rest["tc"], separate_cf=False), device="cpu")
    sd = dict(rest["sd"])
    for p in ("weight", "bias"):
        key = f"mlp_geo.layers2.layers.2.linear.{p}"
        sd[key] = sd[key][:2]
    model.load_state_dict(sd)
    h = rest["sample"]["tar_image"].shape[0]
    coarse_read = render_image(model, tm.ViewBatch.from_numpy(rest["sample"], device="cpu"),
                               height=h, width=h, stride=STRIDE, chunk=CHUNK)
    torch.testing.assert_close(coarse_read["rgb_coarse"], timage["rgb_coarse"],
                               rtol=0, atol=1e-6)
    assert float((coarse_read["rgb_fine"] - timage["rgb_fine"]).abs().max()) > 1e-3


@pytest.mark.parametrize("separate_cf", [True, False])
def test_fast_lerp_cull_bound_with_separate_cf(separate_cf):
    """fast_preset's empty-ray scores (the fused map's mask channel, the
    gather-lerp bound) against JAX's: with separate_cf the bound is the
    loose one, as in JAX, and scores no lower than the tight one."""
    sample = _sample()
    size = sample["src_images"].shape[1]
    kw = dict(TINY, separate_cf=separate_cf)
    jc = dataclasses.replace(jax_fast(JaxConfig(**kw)), fused_map_half=False)
    tc = dataclasses.replace(tm.fast_preset(tm.KeypointNeRFConfig(**kw)), fused_map_half=False)
    rs = np.random.default_rng(5)
    fused = rs.uniform(size=sample["src_images"].shape[:3] + (84,)).astype(np.float32)
    fused[..., -1] = sample["src_masks"][..., 0]
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    tvb = tm.ViewBatch.from_numpy(sample, device="cpu")
    pix = jax_pixel_grid(size, size)
    o, d, n, f = jax_camera_rays(pix.astype(jnp.float32), jvb.tar_K, jvb.tar_R, jvb.tar_t,
                                 jc.znear, jc.zfar)
    jpad = np.zeros(fused.shape[:3] + (128,), np.float32)
    jpad[..., :84] = fused
    js = np.asarray(jax_scores(jc, jvb, o, d, n, f, feats={"fused": jnp.asarray(jpad)}))
    to, td, tn, tf = camera_rays(pixel_grid(size, size).float(), tvb.tar_K, tvb.tar_R,
                                 tvb.tar_t, tc.znear, tc.zfar)
    feats = {"fused": torch.from_numpy(fused)}
    ts = empty_ray_scores(tc, tvb, to, td, tn, tf, feats=feats).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    if separate_cf:
        tight = empty_ray_scores(dataclasses.replace(tc, separate_cf=False), tvb, to, td, tn,
                                 tf, feats=feats).numpy()
        assert (ts >= tight).all() and (ts > tight).any()
