"""Port parity for the training slice as a whole: one f32 toy step of the
configs/zju.json recipe (matmul VJP, the dmap kernel K1 for the coarse
map, VGG loss) against the JAX package's `train_step_fn`.

Both sides get the same weights (drawn by the port from a seed, carried
to the JAX model with `convert_reference_state_dict` and back with
`state_dict_from_jax`) and the same random draws: numpy makes them, the
port takes them as a `TrainDraws`, and the JAX step gets them from fakes
of `jax.random.categorical / uniform / permutation / normal` that pop the
next draw in call order and check its shape (Flax's key chain cannot be
replayed). The JAX step is jitted, with the Pallas kernel in interpret
mode. JAX's gradient tree is captured by an identity transformation in
front of Adam and carried onto the port's parameter names through
`state_dict_from_jax` (renames and transposes only).

Bars: loss terms within 1e-5 relative; every gradient leaf within 1e-4 of
its largest entry; the parameters after one Adam step within the pinned
bound below. A conv bias that feeds a normalization has a gradient of
exactly zero in exact arithmetic; both programs give it rounding noise
(below 1e-6 of the step's largest gradient entry, where every other leaf's
largest entry is above 5e-3 of it), so those leaves are held to that
noise level instead.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from keypointnerf_tpu.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRF as JaxModel  # noqa: E402
from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.models import ViewBatch as JaxViewBatch  # noqa: E402
from keypointnerf_tpu.models.vgg import init_vgg_params  # noqa: E402
from keypointnerf_tpu.training import LossConfig as JaxLossConfig  # noqa: E402
from keypointnerf_tpu.training import TrainState as JaxTrainState  # noqa: E402
from keypointnerf_tpu.training import train_step_fn as jax_train_step  # noqa: E402
from keypointnerf_tpu.utils.import_torch import convert_reference_state_dict  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.ops import multiview_dmap_onehot  # noqa: E402
from keypointnerf_torch.training import (  # noqa: E402
    LossConfig,
    OptimConfig,
    QueryDraws,
    TrainDraws,
    compute_losses,
    create_train_state,
    eval_step_fn,
    train_step_fn,
)
from keypointnerf_torch.utils import state_dict_from_jax, vgg_params_from_jax  # noqa: E402

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)
ZJU = dict(train_matmul_gather_vjp=True, train_pallas_dmap=True)
SIZE = 32
VGG_SLICES = ((4,), (4, 8), (8, 8), (8, 8, 8, 16))
# Adam's first update is lr * g / (|g| + eps), ~lr * sign(g): an entry
# whose gradient is rounding noise (|g| near eps = 1e-8) moves by up to lr
# in either direction. Entries with |g| >= 100 eps are held to PARAM_BOUND
# (measured 2.6e-7 with the matmul VJP, 1.9e-7 without; 1e-3 of lr); the
# others (2.6% of the toy model's 25.9M entries, mostly rounding-noise
# gradients of conv biases and near-zero weights) to 2 lr, the most one
# step can move them apart.
LR = OptimConfig().learning_rate
PARAM_BOUND = 5e-7
NOISE_LEAF = 1e-6


def _sample():
    sample = make_sample(SyntheticConfig(image_size=SIZE), seed=3)
    sample["src_images"] = np.random.default_rng(7).uniform(
        0, 1, sample["src_images"].shape).astype(np.float32)
    return sample


def _numpy_draws(cfg, sample, seed=11):
    """The draws in JAX call order, as (kind, value) pairs, and the same
    draws as the port's TrainDraws."""
    rs = np.random.default_rng(seed)
    V = sample["src_images"].shape[0]
    R = cfg.patch_h * cfg.patch_w
    fg = np.flatnonzero(sample["tar_mask"].reshape(-1) > 0.5)
    patch = np.int32(rs.choice(fg))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    queue = [("categorical", patch)]
    strat = f32(rs.uniform(size=(R, cfg.n_coarse)))
    queue.append(("uniform", strat))

    def query(n_points):
        u = f32(rs.uniform(size=(V - 1,)))
        perm = rs.permutation(V)
        z = f32(rs.normal(size=(n_points, 1)))
        queue.extend([("uniform", u), ("permutation", perm), ("normal", z)])
        keep = np.concatenate([[1.0], (u > cfg.view_dropout)]).astype(np.float32)[perm]
        return QueryDraws(torch.from_numpy(keep), torch.from_numpy(z) * cfg.rand_noise_std)

    coarse = query(R * cfg.n_coarse)
    imp = f32(rs.uniform(size=(R, cfg.n_fine)))
    queue.append(("uniform", imp))
    fine = query(R * (cfg.n_coarse + cfg.n_fine))
    draws = TrainDraws(torch.tensor(int(patch)), torch.from_numpy(strat), coarse,
                       torch.from_numpy(imp), fine)
    return queue, draws


class _InjectedDraws:
    """Fakes of the jax.random samplers that pop the queued draws."""

    def __init__(self, queue):
        self.queue = list(queue)

    def _pop(self, kind, shape=None):
        assert self.queue, f"unexpected extra jax.random.{kind} call"
        k, v = self.queue.pop(0)
        assert k == kind, f"expected jax.random.{k}, got {kind}"
        if shape is not None:
            assert tuple(shape) == v.shape, (kind, shape, v.shape)
        return v

    def __enter__(self):
        mp = self.mp = pytest.MonkeyPatch()
        mp.setattr(jax.random, "categorical",
                   lambda key, logits, axis=-1, shape=None: jnp.asarray(self._pop("categorical")))
        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                   jnp.asarray(self._pop("uniform", shape), dtype))
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(self._pop("normal", shape), dtype))
        mp.setattr(jax.random, "permutation",
                   lambda key, x, axis=0, independent=False:
                   jnp.asarray(x)[jnp.asarray(self._pop("permutation", np.shape(x)))])
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        if exc[0] is None:
            assert not self.queue, f"{len(self.queue)} draws left unused"


def _run(vjp: bool, dtype: str = "float32", **flags):
    extra = dict(ZJU if vjp else dict(ZJU, train_matmul_gather_vjp=False), **flags)
    jc = JaxConfig(**TINY, **extra, pallas_interpret=True, compute_dtype=getattr(jnp, dtype))
    tc = tm.KeypointNeRFConfig(**TINY, **extra, compute_dtype=getattr(torch, dtype))
    sample = _sample()
    seeded = tm.KeypointNeRF(tc, device="cpu", seed=0)
    params = jax.tree.map(np.asarray,
                          convert_reference_state_dict(seeded.state_dict(), jc, strict=True))
    vgg_params = init_vgg_params(jax.random.key(42), VGG_SLICES)
    queue, draws = _numpy_draws(tc, sample)

    # JAX: its own train_step_fn, jitted (the fakes run while it traces),
    # with an identity transformation in front of Adam that keeps the
    # gradient it is given as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    tx = optax.chain(capture, optax.adam(OptimConfig().learning_rate))
    jmodel = JaxModel(jc)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                                  vgg_params=vgg_params)
    jvb = JaxViewBatch(**jax.tree.map(jnp.asarray, sample))
    step = jax.jit(lambda s, b, k: jax_train_step(jmodel, JaxLossConfig(), s, b, k))
    with _InjectedDraws(queue):
        jstate, jerr = step(jstate, jvb, jax.random.key(0))
    captured = jstate.opt_state[0]

    # the port: the same weights, draws and loss
    model = tm.KeypointNeRF(tc, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(params, tc))
    vgg = tm.VGG19Features(VGG_SLICES, device="cpu")
    vgg.load_state_dict(vgg_params_from_jax(jax.tree.map(np.asarray, vgg_params)), strict=False)
    vb = tm.ViewBatch.from_numpy(sample, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    out = model(vb, train=True, draws=draws)
    grads = torch.autograd.grad(compute_losses(out, LossConfig(), vgg)[0],
                                list(model.parameters()))
    state = create_train_state(model, OptimConfig(), vgg)
    eerr = eval_step_fn(model, LossConfig(), state, vb, draws)
    before = multiview_dmap_onehot.launches
    terr = train_step_fn(model, LossConfig(), state, vb, draws)
    assert multiview_dmap_onehot.launches == before     # CPU: the plain version
    return dict(
        jerr={k: float(v) for k, v in jerr.items()},
        terr={k: float(v) for k, v in terr.items()},
        eerr={k: float(v) for k, v in eerr.items()},
        jgrads=state_dict_from_jax(jax.tree.map(np.asarray, captured), tc),
        tgrads=dict(zip(names, grads)),
        jparams=state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), tc),
        tparams=dict(model.named_parameters()),
        acc=float(out["acc_fine"].detach().max()),
    )


@pytest.fixture(scope="module", params=["matmul_vjp", "gather_vjp", "fused_geo_mlp"])
def step(request):
    """The zju recipe; without the matmul VJP; and with use_pallas_geo_mlp
    on both sides (JAX: the sp-fused Pallas kernel in interpret mode and
    its recompute VJP; the port: the same autograd.Function, whose forward
    is the plain version on the CPU)."""
    if request.param == "fused_geo_mlp":
        return _run(True, use_pallas_geo_mlp=True)
    return _run(request.param == "matmul_vjp")


def test_train_step_losses(step):
    """Loss terms and grad_norm within 1e-5 relative; eval_step_fn (the
    same forward, no update) gives the same terms."""
    jerr, terr, eerr = step["jerr"], step["terr"], step["eerr"]
    assert set(jerr) == set(terr) == {"e_pix_c", "e_pix_l1", "e_vgg", "e_all", "grad_norm"}
    assert set(eerr) == set(terr) - {"grad_norm"}
    assert step["acc"] > 0.0          # the patch is not empty: radiance flows
    for k in jerr:
        assert abs(terr[k] - jerr[k]) <= 1e-5 * abs(jerr[k]), (k, terr[k], jerr[k])
        if k in eerr:
            assert eerr[k] == terr[k], k


def test_train_step_grads(step):
    """Every gradient leaf within 1e-4 of its largest entry (rounding-noise
    leaves: both below NOISE_LEAF of the largest gradient entry); the
    coarse map's gradient (K1's path) reaches the geometry encoder."""
    jg, tg = step["jgrads"], step["tgrads"]
    top = max(np.abs(g.numpy()).max() for g in jg.values())
    n_noise = 0
    for name, g in tg.items():
        ref, got = jg[name].numpy(), g.numpy()
        scale = np.abs(ref).max()
        if scale < NOISE_LEAF * top:
            n_noise += 1
            assert np.abs(got).max() < NOISE_LEAF * top, name
            continue
        err = np.abs(got - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    assert n_noise <= 16, n_noise
    assert np.abs(tg["geo_encoder.l0.weight"].numpy()).max() > 1e-3 * top


def test_train_step_updated_params(step):
    jg, jp, tp = step["jgrads"], step["jparams"], step["tparams"]
    worst = worst_small = n_small = 0
    for n in tp:
        diff = np.abs(tp[n].detach().numpy() - jp[n].numpy())
        big = np.abs(jg[n].numpy()) >= 100 * 1e-8
        worst = max(worst, diff[big].max(initial=0.0))
        worst_small = max(worst_small, diff[~big].max(initial=0.0))
        n_small += int((~big).sum())
    assert worst <= PARAM_BOUND, worst
    assert worst_small <= 2 * LR, worst_small
    assert n_small <= 0.03 * sum(p.numel() for p in tp.values()), n_small


def test_train_step_bf16_bound():
    """The bf16 recipe (as configs/zju.json ships it) at a measured bound:
    the two programs round to bf16 at other places (the convs' sums, the
    casts around the lookups' backward), and the backward carries those
    roundings into every leaf. Measured: loss terms 0.13% apart (e_pix_c),
    grad_norm 0.50%, the whole gradient 13.8% (relative L2 over all
    leaves); pinned at 0.5%, 2% and 30%."""
    r = _run(True, "bfloat16")
    jerr, terr = r["jerr"], r["terr"]
    for k in ("e_pix_c", "e_pix_l1", "e_vgg", "e_all"):
        assert abs(terr[k] - jerr[k]) <= 5e-3 * abs(jerr[k]), (k, terr[k], jerr[k])
    assert abs(terr["grad_norm"] - jerr["grad_norm"]) <= 0.02 * jerr["grad_norm"]
    jg, tg = r["jgrads"], r["tgrads"]
    num = sum(float(((g.numpy() - jg[n].numpy()) ** 2).sum()) for n, g in tg.items())
    den = sum(float((jg[n].numpy() ** 2).sum()) for n in tg)
    assert np.sqrt(num / den) <= 0.3, np.sqrt(num / den)


def test_train_draws_laws():
    """TrainDraws.sample: the patch center lies on the foreground (any
    pixel when the mask is empty); the first view of the keep vector is
    forced, so with view_dropout 1 exactly one view is kept and with 0 all
    are; noise has std rand_noise_std; the uniforms lie in [0, 1)."""
    cfg = tm.KeypointNeRFConfig(**TINY)
    vb = tm.ViewBatch.from_numpy(_sample(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    mask = vb.tar_mask.reshape(-1)
    for _ in range(20):
        d = TrainDraws.sample(cfg, vb, gen)
        assert mask[d.patch_index] > 0.5
        for q, n in ((d.coarse, 16 * 4), (d.fine, 16 * 8)):
            assert q.view_keep.shape == (3,) and q.view_keep.sum() >= 1
            assert q.noise.shape == (n, 1)
        for u, shape in ((d.strat_u, (16, 4)), (d.importance_u, (16, 4))):
            assert u.shape == shape and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    for p, kept in ((1.0, 1), (0.0, 3)):
        d = TrainDraws.sample(dataclasses.replace(cfg, view_dropout=p), vb, gen)
        assert int(d.coarse.view_keep.sum()) == kept and int(d.fine.view_keep.sum()) == kept
    big = TrainDraws.sample(dataclasses.replace(cfg, patch_h=64, patch_w=64), vb, gen)
    assert abs(float(big.fine.noise.std()) - cfg.rand_noise_std) < 0.05 * cfg.rand_noise_std
    empty = dataclasses.replace(vb, tar_mask=torch.zeros_like(vb.tar_mask))
    assert 0 <= int(TrainDraws.sample(cfg, empty, gen).patch_index) < SIZE * SIZE
